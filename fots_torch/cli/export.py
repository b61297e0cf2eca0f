"""Export the serving programs to a fixed-shape bundle, the counterpart of
``fots/cli/export.py``.

Writes the detection program and one recognition program per strip bucket
(``torch.export``), each traced once for every device type of
``-platforms`` (default ``cuda,cpu``; ``cuda`` needs a card), plus the
weights once, into a directory that :class:`fots_torch.export.ExportedEngine`
serves on each of those device types without the model code (see
``fots_torch/export.py``).

Usage:
  python -m fots_torch.cli.export -model artifacts/serving_params.npz -out bundle/ \\
      -batch 16 -height 704 -width 1280
  # check the bundle on each of its device types against the in-process
  # engine there, on the first batch of a folder's *.jpg files, or of an
  # archive of decoded images (``images`` u8 [N, h, w, 3] BGR):
  python -m fots_torch.cli.export -model artifacts/serving_params.npz -out bundle/ \\
      -selftest data/synth/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def selftest_images(source: str, batch: int):
    """The first ``batch`` images of an ``.npz`` archive, or of a folder's
    sorted ``*.jpg`` files that read as images (``fots``'s selftest)."""
    if source.endswith(".npz") and os.path.isfile(source):
        with np.load(source) as z:
            return list(z["images"][:batch])
    from fots_torch.cli.detect import folder_images
    from fots_torch.imageio import imread

    return [im for im in (imread(p) for p in folder_images(source)[:batch]) if im is not None]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-model", default=None,
                        help=".npz serving snapshot, or a fots_torch.cli.train_joint "
                             "checkpoint directory (step_N or the run directory)")
    parser.add_argument("-h5", default=None, help="reference torch weights (.h5)")
    parser.add_argument("-out", required=True, help="bundle directory")
    parser.add_argument("-batch", type=int, default=16)
    parser.add_argument("-height", type=int, default=704)
    parser.add_argument("-width", type=int, default=1280)
    parser.add_argument("-segm_thresh", type=float, default=0.5)
    parser.add_argument("-max_candidates", type=int, default=1024)
    parser.add_argument("-max_boxes", type=int, default=None,
                        help="per-image recognition cap baked into the bundle manifest")
    parser.add_argument("-roi_pad", type=int, default=32)
    parser.add_argument("-mixed_precision", action="store_true", default=True)
    parser.add_argument("-f32", dest="mixed_precision", action="store_false")
    parser.add_argument("-platforms", default="cuda,cpu",
                        help="comma-separated device types the bundle serves on (cuda, "
                             "cpu); listing cuda needs a card")
    parser.add_argument("-selftest", default=None, metavar="FOLDER_OR_NPZ",
                        help="after exporting, reload the bundle on each of its device types "
                             "and check that its results match the in-process engine there on "
                             "the first batch of the folder's *.jpg files (or of the images "
                             "of an .npz archive)")
    args = parser.parse_args(argv)

    from fots_torch.cli.detect import load_engine
    from fots_torch.export import ExportedEngine, export_serving

    platforms = tuple(p for p in args.platforms.split(",") if p)
    engine = load_engine(args.model, args.h5, segm_thresh=args.segm_thresh,
                         mixed_precision=args.mixed_precision,
                         device="cuda" if "cuda" in platforms else "cpu")
    engine.max_candidates = args.max_candidates
    engine.max_boxes = args.max_boxes
    with engine:
        manifest = export_serving(engine, args.out, batch=args.batch, height=args.height,
                                  width=args.width, roi_pad=args.roi_pad, platforms=platforms)
        total = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
        print(f"exported {len(manifest['programs'])} programs (buckets "
              f"{manifest['strip_buckets']}) + params to {args.out} ({total / 1e6:.1f} MB) "
              f"for platforms {manifest['platforms']}")
        if not args.selftest:
            return manifest
        images = selftest_images(args.selftest, args.batch)
        if not images:
            raise SystemExit(f"selftest: no readable images in {args.selftest}")
        for platform in platforms:
            with ExportedEngine(args.out, device=platform) as exported:
                got = exported.batch_call(images)
            if platform == engine.device.type:
                want = engine.batch_call(images, serve_hw=(args.height, args.width))
            else:
                with engine.copy_to(platform) as other:
                    want = other.batch_call(images, serve_hw=(args.height, args.width))
            n_boxes = _selftest(got, want)
            print(f"selftest ok: {n_boxes} boxes identical across {len(images)} images "
                  f"on {platform}")
    return manifest


def _selftest(got, want) -> int:
    """The number of boxes of ``got``, which must equal ``want``: the same
    count per image, texts, and boxes within 1e-4 px."""
    n_boxes = 0
    for g_img, w_img in zip(got, want):
        if len(g_img) != len(w_img):
            raise SystemExit(f"selftest: result count mismatch {len(g_img)} vs {len(w_img)}")
        for g, w in zip(g_img, w_img):
            if g["text"] != w["text"]:
                raise SystemExit(f"selftest: texts differ: {g['text']!r} vs {w['text']!r}")
            if not np.allclose(g["box"], w["box"], rtol=0.0, atol=1e-4):
                raise SystemExit(f"selftest: boxes differ: {g['box']} vs {w['box']}")
            n_boxes += 1
    return n_boxes


if __name__ == "__main__":
    main()
