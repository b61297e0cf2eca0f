"""E2E inference CLI, the counterpart of ``fots/cli/detect.py``: detect +
recognize over a folder of images, on the card unless given ``-device cpu``.

Loads a serving snapshot (``.npz``), a port checkpoint directory or the
reference's torch weights (``-h5``), runs the per-image pipeline on every
``*.jpg`` of ``-test_folder`` (sorted; read with :func:`fots_torch.imageio.
imread`), prints each image's texts and writes ``<name>.txt`` of
``x1,y1,...,x4,y4,score,text`` rows and ``<name>.jpg``: the letterboxed
image the engine ran on with each box drawn in green and its text above it
(:func:`fots_torch.imgproc.polylines` and :func:`fots_torch.imgproc.put_text`,
written by :func:`fots_torch.imageio.imwrite`; each byte for byte with
OpenCV 5).

Usage:
  python -m fots_torch.cli.detect -model artifacts/serving_params.npz \\
      -test_folder data/synth/ -output out/
  python -m fots_torch.cli.detect -h5 weights/FOTS_280000.h5 ...   (torch weights)
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from fots_torch.checkpoint import detector_from_checkpoint, load_detector
from fots_torch.pipeline import FOTSInference


def load_engine(model_path=None, h5_path=None, nclass=87, segm_thresh=0.5,
                mixed_precision=False, expand_w_frac=0.0, masked_norm=None, beam=0,
                device=None, n_data=None, n_model=1) -> FOTSInference:
    """A :class:`FOTSInference` around ``h5_path`` (the reference's torch
    weights, imported onto a detector initialised from seed 0 by
    :func:`fots_torch.models.detector.init_detector`, as ``fots`` does) or
    else ``model_path``: a serving snapshot (``.npz``) or a port checkpoint
    directory; with neither, the initialised detector.  ``masked_norm`` None
    reads the config embedded in the snapshot, or the ``train_config.json``
    that ``fots_torch.cli.train_joint`` writes beside a run's checkpoints;
    torch weights carry none (unmasked unless given).  The engine letterboxes
    on the host, as ``fots``'s CLIs do.  ``device`` None is the card (raises
    without CUDA); ``"cpu"`` runs the kernels' plain versions.  ``n_data``
    or ``n_model`` above 1 serves on an ``n_data`` x ``n_model`` mesh (as
    ``fots`` does for ``n_data``; None: the world over ``n_model``): one
    process a card, started by torchrun (each rank then loads the weights
    onto its own card)."""
    mesh = None
    if (n_data or 1) > 1 or n_model > 1:
        from fots_torch.parallel import init_from_env, make_mesh

        if init_from_env(device) == 1:
            raise ValueError(f"a {n_data or 1}x{n_model} serving mesh needs one process a "
                             f"card: run under torchrun --nproc-per-node "
                             f"{(n_data or 1) * n_model}")
        mesh = make_mesh(n_data=n_data, n_model=n_model)
    if h5_path or not model_path:
        import torch

        from fots_torch.checkpoint import import_torch_state_dict, load_torch_h5
        from fots_torch.device import resolve_device
        from fots_torch.models.detector import FOTSDetector, init_detector

        dev = resolve_device(device)
        model = init_detector(FOTSDetector(nclass=nclass), torch.Generator().manual_seed(0))
        if h5_path:
            imported, skipped = import_torch_state_dict(load_torch_h5(h5_path), model)
            print(f"imported {len(imported)} tensors from {h5_path} ({len(skipped)} skipped)")
        model = model.eval().to(device=dev, memory_format=torch.channels_last)
    elif model_path.endswith(".npz") and os.path.isfile(model_path):
        model, step, config = load_detector(model_path, device)
        print(f"loaded serving snapshot {model_path} (step {step})")
        if masked_norm is None:
            masked_norm = config.get("masked_norm", False)
    elif os.path.isdir(model_path):
        model, step, path = detector_from_checkpoint(model_path, device)
        print(f"restored checkpoint {path} (step {step})")
        if masked_norm is None:
            cfg = os.path.join(os.path.dirname(os.path.abspath(path)), "train_config.json")
            if os.path.exists(cfg):
                with open(cfg) as f:
                    masked_norm = json.load(f).get("masked_norm", False)
    else:
        raise ValueError(f"fots_torch loads .npz serving snapshots (tools/"
                         f"export_serving_params.py writes them), its own checkpoint "
                         f"directories and torch weights (-h5); got {model_path!r}")
    return FOTSInference(model, segm_thresh=segm_thresh, mixed_precision=mixed_precision,
                         expand_w_frac=expand_w_frac, masked_norm=bool(masked_norm),
                         beam=beam, device=device, device_letterbox=False, mesh=mesh)


def folder_images(folder: str):
    """The sorted ``*.jpg`` paths of ``folder``, as ``fots``'s CLIs list them."""
    return sorted(glob.glob(os.path.join(os.path.realpath(folder), "*.jpg")))


def result_rows(results) -> list:
    """``fots``'s ``.txt`` rows of one image's results."""
    rows = []
    for r in results:
        b = r["box"]
        rows.append(",".join(f"{v:.1f}" for v in b[:8]) + f",{b[8]:.3f},{r['text']}")
    return rows


def draw_results(im_resized, results) -> np.ndarray:
    """A copy of the engine's letterboxed image with each result drawn as
    ``fots`` draws it, in its order: the box (green, 1 px, ``LINE_8``), then
    its text in green at ``(int(x1), int(y1) - 3)``."""
    from fots_torch.imgproc import polylines, put_text

    draw = np.array(im_resized, np.uint8, copy=True)
    for r in results:
        b = r["box"]
        polylines(draw, b[:8].reshape(4, 2).astype(np.int32), (0, 255, 0))
        put_text(draw, r["text"], (int(b[0]), int(b[1]) - 3), (0, 255, 0))
    return draw


def main(argv=None):
    """Returns {image basename: its rows}."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-model", default=None,
                        help=".npz serving snapshot, or a fots_torch.cli.train_joint "
                             "checkpoint directory (step_N or the run directory)")
    parser.add_argument("-h5", default=None, help="reference torch weights (.h5)")
    parser.add_argument("-segm_thresh", type=float, default=0.5)
    parser.add_argument("-test_folder", required=True, help="folder of *.jpg images")
    parser.add_argument("-output", default="./out",
                        help="where <name>.txt rows and the annotated <name>.jpg go")
    parser.add_argument("-scale_up", action="store_true")
    parser.add_argument("-split_words", action="store_true",
                        help="split multi-word lines into word boxes")
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    args = parser.parse_args(argv)

    from fots_torch.imageio import imread, imwrite

    engine = load_engine(args.model, args.h5, segm_thresh=args.segm_thresh, device=args.device)
    os.makedirs(args.output, exist_ok=True)
    out = {}
    with engine:
        for path in folder_images(args.test_folder):
            im = imread(path)
            if im is None:
                continue
            results, im_resized = engine(im, scale_up=args.scale_up,
                                         split_words=args.split_words)
            for r in results:
                print(r["text"])
            base = os.path.basename(path)
            imwrite(os.path.join(args.output, base), draw_results(im_resized, results))
            rows = result_rows(results)
            with open(os.path.join(args.output, os.path.splitext(base)[0] + ".txt"), "w") as f:
                f.write("\n".join(rows))
            print(f"{base}: {len(results)} boxes")
            out[base] = rows
    return out


if __name__ == "__main__":
    main()
