"""Write the image files the PyTorch port's file entry points are checked on.

    PYTHONPATH=. python tools/make_torch_file_assets.py

Needs OpenCV (the port's GPU machine has none; there the port reads these
files with its own decoder, ``fots_torch.imageio.imread``, and must get the
pixels of the decoded assets byte for byte):

- ``fots_torch/assets/heldout_eval_jpg/``: the 16 held-out scenes of
  ``data/synth_big_eval.txt`` as the jpg files themselves, their
  ``gt_*.txt`` annotations, and ``eval.txt`` listing the scenes by relative
  name (``fots_torch.cli.eval_e2e -images_list`` reads it).
  ``data/synth_big`` is regenerated from its seed when missing.  Checked:
  ``cv2.imread`` of every copied file equals its row of
  ``fots_torch/assets/heldout_eval_u8.npz`` and the annotations equal the
  archive's.
- ``fots_torch/assets/ocr_eval_png/``: the 58 eval crops of
  ``fots_torch/assets/ocr_crops_u8.npz`` written with ``cv2.imwrite`` as
  ``crop_NNNN.png`` with a ``gt.txt`` of ``name, "text"`` lines: the files
  ``tools/make_torch_ocr_asset.py`` writes for ``fots`` and from which
  ``ocr_eval_fots_cpu.json`` is computed.  Checked: ``cv2.imread`` of each
  equals its archive crop.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_torch_eval_asset import ensure_synth_big, scene_paths  # noqa: E402

ASSETS = os.path.join(REPO, "fots_torch", "assets")
HELDOUT = os.path.join(ASSETS, "heldout_eval_u8.npz")
CROPS = os.path.join(ASSETS, "ocr_crops_u8.npz")


def write_heldout(out_dir: str) -> int:
    import cv2

    from fots.data.annotations import gt_path_for_image

    paths = scene_paths()
    ensure_synth_big(paths)
    with np.load(HELDOUT) as z:
        images, names, gt_texts = z["images"], [str(n) for n in z["names"]], z["gt_texts"]
    os.makedirs(out_dir, exist_ok=True)
    listed = []
    for p, im, name, text in zip(paths, images, names, gt_texts):
        if os.path.basename(p) != os.path.basename(name):
            raise RuntimeError(f"{p}: the archive's row holds {name}")
        gt = gt_path_for_image(p)[1]
        with open(gt, encoding="utf-8") as f:
            if f.read() != str(text):
                raise RuntimeError(f"{gt} differs from the archive's annotation")
        for src in (p, gt):
            shutil.copyfile(src, os.path.join(out_dir, os.path.basename(src)))
        copied = cv2.imread(os.path.join(out_dir, os.path.basename(p)))
        if copied is None or not np.array_equal(copied, im):
            raise RuntimeError(f"cv2.imread of {p} differs from its row of {HELDOUT}")
        listed.append(os.path.basename(p))
    with open(os.path.join(out_dir, "eval.txt"), "w") as f:
        f.writelines(n + "\n" for n in listed)
    return len(listed)


def write_ocr_crops(out_dir: str) -> int:
    import cv2

    with np.load(CROPS) as z:
        pixels, shapes, offsets = z["pixels"], z["shapes"], z["offsets"]
        texts, split = [str(t) for t in z["texts"]], [str(s) for s in z["split"]]
    os.makedirs(out_dir, exist_ok=True)
    lines = []
    for shape, off, txt, sp in zip(shapes, offsets, texts, split):
        if sp != "eval":
            continue
        crop = pixels[int(off):int(off) + int(np.prod(shape))].reshape(tuple(int(v) for v in shape))
        name = f"crop_{len(lines):04d}.png"
        path = os.path.join(out_dir, name)
        cv2.imwrite(path, crop)
        if not np.array_equal(cv2.imread(path), crop):
            raise RuntimeError(f"cv2.imread of {path} differs from its archive crop")
        lines.append(f'{name}, "{txt}"\n')
    with open(os.path.join(out_dir, "gt.txt"), "w", encoding="utf-8") as f:
        f.writelines(lines)
    return len(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default=ASSETS)
    args = ap.parse_args(argv)
    jpg_dir = os.path.join(args.out_dir, "heldout_eval_jpg")
    png_dir = os.path.join(args.out_dir, "ocr_eval_png")
    for d in (jpg_dir, png_dir):
        shutil.rmtree(d, ignore_errors=True)
    n = write_heldout(jpg_dir)
    print(f"wrote {n} scenes, their annotations and eval.txt to {jpg_dir}")
    n = write_ocr_crops(png_dir)
    print(f"wrote {n} crops and gt.txt to {png_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
