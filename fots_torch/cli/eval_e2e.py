"""ICDAR-style end-to-end evaluation CLI, the counterpart of
``fots/cli/eval_e2e.py``.

Runs the pipeline over annotated images and reports detection and
end-to-end precision / recall / hmean.  The images are the files of
``-images_list`` (read with :func:`fots_torch.imageio.imread`, each with the
``gt_<name>.txt`` or ``<name>.txt`` beside it, as ``fots`` reads them; a file
that reads as nothing is skipped), or decoded pixels from ``-images_npz``:
an archive with ``images`` u8 [N, h, w, 3] (BGR), ``names`` (the image
paths), ``gt_names`` and ``gt_texts`` (each image's annotation file name and
content), as ``tools/make_torch_eval_asset.py`` writes it.  ``-h5`` serves
the reference's torch weights.

Usage:
  python -m fots_torch.cli.eval_e2e -model artifacts/serving_params.npz \\
      -images_list fots_torch/assets/heldout_eval_jpg/eval.txt
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from fots_torch.cli.detect import load_engine
from fots_torch.data.annotations import (load_image_list, parse_annotation_text,
                                         read_annotation_file)
from fots_torch.evaluate import E2EMetrics


def load_images_npz(path: str):
    """(images u8 [N, h, w, 3], names, annotation file names, annotation
    texts) of an evaluation archive."""
    with np.load(path) as z:
        images = z["images"]
        names, gt_names, gt_texts = ([str(v) for v in z[k]]
                                     for k in ("names", "gt_names", "gt_texts"))
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"{path}: images must be u8 [N, h, w, 3], got "
                         f"{images.dtype} {images.shape}")
    if not len(images) == len(names) == len(gt_names) == len(gt_texts):
        raise ValueError(f"{path}: images, names and annotations differ in count")
    return images, names, gt_names, gt_texts


def load_images_list(list_path: str):
    """(images, names, annotation file names, annotation texts) of an image
    list's files; ``images`` is a lazy iterator of :func:`fots_torch.
    imageio.imread` results, decoded as the evaluation reaches them (None for
    a file that reads as nothing)."""
    from fots_torch.imageio import imread

    names = load_image_list(list_path)
    gt_names, gt_texts = zip(*(read_annotation_file(p) for p in names)) if names else ((), ())
    return (imread(p) for p in names), names, list(gt_names), list(gt_texts)


def evaluate(engine, images, names, gt_names, gt_texts, *, eval_text_length=3,
             conf_gate=False, ignore_dontcare=False, scale_up=False, serve_hw=None,
             split_words=False, log_every=10):
    """Evaluate ``engine`` over decoded images (an image that is None is
    skipped, as ``fots`` skips a file ``cv2.imread`` cannot read).  Returns
    (summary dict, the running :class:`E2EMetrics`, per-image dump, seconds
    spent in the engine).  The filtering is ``fots.cli.eval_e2e``'s."""
    metrics = E2EMetrics(ignore_dontcare=ignore_dontcare)
    dump = []
    engine_s = 0.0
    for i, (im, name, gt_name, gt_text) in enumerate(zip(images, names, gt_names, gt_texts)):
        if im is None:
            continue
        polys, _tags, labels = parse_annotation_text(gt_text, gt_name, im.shape)
        t0 = time.perf_counter()
        if serve_hw:
            # batched letterbox path: boxes come back in source-image pixels
            results = engine.batch_call([im], serve_hw=serve_hw, split_words=split_words)[0]
            sy = sx = 1.0
        else:
            results, im_resized = engine(im, scale_up=scale_up, split_words=split_words)
            sy = im_resized.shape[0] / im.shape[0]
            sx = im_resized.shape[1] / im.shape[1]
        engine_s += time.perf_counter() - t0
        gt_rect = ((polys * np.array([sx, sy])).reshape(-1, 8) if len(polys)
                   else np.zeros((0, 8)))
        # only transcriptions of at least eval_text_length characters are
        # emitted: shorter reads never enter the precision denominator
        results = [r for r in results if len(r["text"].strip()) >= eval_text_length]
        if conf_gate:  # the reference's gate: conf < 0.01 and exactly 3 characters
            results = [r for r in results
                       if not (r.get("conf", 1.0) < 0.01 and len(r["text"].strip()) == 3)]
        if split_words:
            dets = []
            for r in results:
                if r.get("words"):
                    dets.extend((np.concatenate([w["quad"].reshape(8), r["box"][8:9]]),
                                 w["text"], r.get("conf"))
                                for w in r["words"]
                                if len(w["text"].strip()) >= eval_text_length)
                else:
                    dets.append((r["box"], r["text"], r.get("conf")))
        else:
            dets = [(r["box"], r["text"], r.get("conf")) for r in results]
        confs = [c for *_x, c in dets]
        dets = [(b, t) for b, t, _c in dets]
        metrics.add_image(dets, gt_rect, labels, eval_text_length=eval_text_length)
        dump.append({
            "image": name,
            "detections": [{"box": np.asarray(b)[:8].tolist(), "text": t,
                            "conf": None if c is None else float(c)}
                           for (b, t), c in zip(dets, confs)],
            "gt": [{"box": np.asarray(q).reshape(-1)[:8].tolist(), "text": l}
                   for q, l in zip(gt_rect, labels)],
        })
        if log_every and i % log_every == 0:
            s = metrics.summary()
            print(f"[{i}] det hmean {s['detection_hmean']:.3f} "
                  f"e2e hmean {s['e2e_hmean']:.3f}", flush=True)
    return metrics.summary(), metrics, dump, engine_s


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-model", default=None,
                        help=".npz serving snapshot, or a fots_torch.cli.train_joint "
                             "checkpoint directory (step_N or the run directory)")
    parser.add_argument("-h5", default=None, help="reference torch weights (.h5)")
    parser.add_argument("-images_list", default=None,
                        help="list of image files, each with its annotation file beside it")
    parser.add_argument("-images_npz", default=None,
                        help="or: archive of decoded images with their annotations")
    parser.add_argument("-segm_thresh", type=float, default=0.5)
    parser.add_argument("-expand_w", type=float, default=0.0,
                        help="optional crop-width margin as a fraction of box height")
    parser.add_argument("-eval_text_length", type=int, default=3)
    parser.add_argument("-beam", type=int, default=0,
                        help="prefix beam search width for recognition (0 = greedy argmax)")
    parser.add_argument("-conf_gate", action="store_true",
                        help="skip detections with mean CTC confidence < 0.01 whose "
                             "transcription is exactly 3 chars")
    parser.add_argument("-ignore_dontcare", action="store_true",
                        help="ICDAR don't-care rule: detections overlapping ###/short GT "
                             "leave the precision denominator")
    parser.add_argument("-scale_up", action="store_true")
    parser.add_argument("-serve_hw", default=None, metavar="HxW",
                        help="evaluate through the fixed-shape batched letterbox serving "
                             "path (e.g. 704x1280) instead of the per-image path")
    parser.add_argument("-split_words", action="store_true",
                        help="emit per-word split boxes as detections")
    parser.add_argument("-out_json", default=None)
    parser.add_argument("-dump_json", default=None,
                        help="also write per-image detections + GT")
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    args = parser.parse_args(argv)
    if bool(args.images_list) == bool(args.images_npz):
        parser.error("give one of -images_list and -images_npz")

    engine = load_engine(args.model, args.h5, segm_thresh=args.segm_thresh,
                         expand_w_frac=args.expand_w, beam=args.beam, device=args.device)
    hw = (tuple(int(v) for v in args.serve_hw.lower().split("x")) if args.serve_hw else None)
    data = (load_images_list(args.images_list) if args.images_list
            else load_images_npz(args.images_npz))
    with engine:
        summary, _metrics, dump, _s = evaluate(
            engine, *data,
            eval_text_length=args.eval_text_length, conf_gate=args.conf_gate,
            ignore_dontcare=args.ignore_dontcare, scale_up=args.scale_up, serve_hw=hw,
            split_words=args.split_words)
    print(json.dumps(summary, indent=2))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(summary, f, indent=2)
    if args.dump_json:
        with open(args.dump_json, "w") as f:
            json.dump(dump, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
