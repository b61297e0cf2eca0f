"""Batched throughput serving CLI, the counterpart of ``fots/cli/serve.py``.

Serves the ``*.jpg`` files of ``-test_folder`` (sorted, read with
:func:`fots_torch.imageio.imread` as each batch is reached; a file that
reads as nothing is skipped), or an archive of decoded images
(``-images_npz``: ``images`` u8 [N, h, w, 3] BGR and ``names``), in
fixed-shape letterboxed batches through ``FOTSInference.stream`` and writes
``<name>.json`` per image (its boxes in source-image pixels and texts).
``-h5`` serves the reference's torch weights.

Usage:
  python -m fots_torch.cli.serve -model artifacts/serving_params.npz \\
      -test_folder data/synth/ -output out/ -batch 16
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-model", default=None,
                        help=".npz serving snapshot, or a fots_torch.cli.train_joint "
                             "checkpoint directory (step_N or the run directory)")
    parser.add_argument("-h5", default=None, help="reference torch weights (.h5)")
    parser.add_argument("-segm_thresh", type=float, default=0.5)
    parser.add_argument("-test_folder", default=None, help="folder of *.jpg images")
    parser.add_argument("-images_npz", default=None,
                        help="instead of -test_folder: archive of decoded images (images, "
                             "names)")
    parser.add_argument("-output", default="./out")
    parser.add_argument("-batch", type=int, default=8)
    parser.add_argument("-height", type=int, default=704)
    parser.add_argument("-width", type=int, default=1280)
    parser.add_argument("-mixed_precision", action="store_true", default=True)
    parser.add_argument("-f32", dest="mixed_precision", action="store_false",
                        help="disable bf16 inference")
    parser.add_argument("-n_data", type=int, default=None,
                        help="not ported: the serving mesh")
    parser.add_argument("-n_model", type=int, default=1, help="not ported: the serving mesh")
    parser.add_argument("-split_words", action="store_true")
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    args = parser.parse_args(argv)
    if (args.n_data or 1) > 1 or args.n_model > 1:
        parser.error("-n_data / -n_model: the serving mesh is not ported yet; fots_torch "
                     "serves on one card")
    if bool(args.test_folder) == bool(args.images_npz):
        parser.error("give one of -test_folder and -images_npz")

    from fots_torch.cli.detect import folder_images, load_engine
    from fots_torch.imageio import imread

    engine = load_engine(args.model, args.h5, segm_thresh=args.segm_thresh,
                         mixed_precision=args.mixed_precision, device=args.device)
    os.makedirs(args.output, exist_ok=True)

    def stem(path):
        return os.path.splitext(os.path.basename(str(path)))[0]

    if args.images_npz:
        with np.load(args.images_npz) as z:
            images = z["images"]
            names = [stem(n) for n in z["names"]]

        def batches():
            for i in range(0, len(names), args.batch):
                yield names[i:i + args.batch], list(images[i:i + args.batch])
    else:
        paths = folder_images(args.test_folder)

        def batches():
            """Each chunk's files decoded as ``stream`` reaches it, so the
            decoding overlaps the card's work on the previous chunk."""
            for i in range(0, len(paths), args.batch):
                keep = [(stem(p), im) for p, im in
                        ((p, imread(p)) for p in paths[i:i + args.batch]) if im is not None]
                if keep:
                    yield [n for n, _ in keep], [im for _, im in keep]

    total = 0
    t0 = time.perf_counter()
    with engine:
        for chunk, res_batch in engine.stream(batches(), serve_hw=(args.height, args.width),
                                              split_words=args.split_words,
                                              with_context=True):
            for name, res in zip(chunk, res_batch):
                out = [{"box": r["box"].tolist(), "text": r["text"]} for r in res]
                with open(os.path.join(args.output, name + ".json"), "w") as f:
                    json.dump(out, f)
                total += 1
    dt = time.perf_counter() - t0
    print(f"{total} images in {dt:.2f}s = {total / max(dt, 1e-9):.2f} images/sec")
    return total


if __name__ == "__main__":
    main()
