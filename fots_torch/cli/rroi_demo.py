"""RRoIAlign demo, the counterpart of ``fots/cli/rroi_demo.py``: crops and
the input image's gradient heat map; runs on the card unless given
``-device cpu``.

Rotated rois are built from the ground-truth quads
(:func:`fots_torch.geometry.quads_to_rrois`), the crops are pooled by
:func:`fots_torch.ops.rroi_align.rroi_align` over the 3-channel f32 image,
and the pooled energy ``sum(crops**2)`` is differentiated back to the image
with ``torch.autograd``: on the card through K4' (the neighbour pack) and
K4'-bwd (its gradient), one launch each, at C = 3.  The gradient's channel
sum is scaled by its 95th percentile, coloured with JET and blended over the
image (0.6 / 0.4), as ``fots`` does; the files (``crop<i>.jpg``,
``grad.jpg``, ``grad_overlay.jpg``) are written with the port's JPEG encoder.

Usage:
  python -m fots_torch.cli.rroi_demo -image img.jpg [-gt gt_img.txt] \\
      [-out_dir rroi_demo_out] [-pooled_height 44] [-max_rois 8] [-device cpu]

Without ``-gt`` the gt file is looked up next to the image (``gt_<name>.txt``,
ICDAR comma format).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    """Returns (energy, crops [N, ph, pw, 3], gradient [H, W, 3]) as NumPy."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-image", required=True)
    parser.add_argument("-gt", default=None, help="ICDAR gt txt (default: gt_<image>.txt)")
    parser.add_argument("-out_dir", default="rroi_demo_out")
    parser.add_argument("-pooled_height", type=int, default=44)
    parser.add_argument("-max_rois", type=int, default=8)
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    args = parser.parse_args(argv)

    import torch

    from fots_torch.data.annotations import load_annotation, parse_icdar_lines
    from fots_torch.device import resolve_device
    from fots_torch.geometry import quads_to_rrois
    from fots_torch.imageio import imread, imwrite
    from fots_torch.imgproc import add_weighted_u8, apply_color_map_jet
    from fots_torch.ops.rroi_align import pooled_width_for, rroi_align

    dev = resolve_device(args.device)
    im = imread(args.image)
    if im is None:
        raise SystemExit(f"cannot read {args.image}")
    if args.gt:
        with open(args.gt, encoding="utf-8") as f:
            lines = f.readlines()
        polys, tags, _ = parse_icdar_lines(lines, roll_icdar="icdar-2015" in args.gt.lower())
    else:
        polys, tags, _ = load_annotation(args.image, im.shape)
    keep = [i for i, t in enumerate(tags) if not t]
    if not keep:
        raise SystemExit("no usable (non-###) GT quads")
    quads = np.asarray(polys)[keep][: args.max_rois]
    rois = quads_to_rrois(quads)

    ph = args.pooled_height
    pw = pooled_width_for(rois, ph)
    images = torch.from_numpy(im[None].astype(np.float32)).to(dev).requires_grad_(True)
    crops_t = rroi_align(images, torch.from_numpy(np.asarray(rois, np.float32)).to(dev),
                         ph, pw, 1.0)
    energy_t = (crops_t * crops_t).sum()
    energy_t.backward()
    energy = float(energy_t.detach())
    crops = crops_t.detach().cpu().numpy()
    grad = images.grad[0].cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(crops.shape[0]):
        imwrite(os.path.join(args.out_dir, f"crop{i}.jpg"),
                np.clip(crops[i], 0, 255).astype(np.uint8))
    g = np.abs(grad).sum(-1)
    # percentile scaling: the energy gradient is 2x at sampled taps, so a
    # handful of bright pixels would wash out a max-normalised map
    hi = max(float(np.percentile(g[g > 0], 95)) if (g > 0).any() else 0.0, 1e-6)
    g = np.clip(255.0 * g / hi, 0, 255).astype(np.uint8)
    heat = apply_color_map_jet(g)
    imwrite(os.path.join(args.out_dir, "grad.jpg"), heat)
    imwrite(os.path.join(args.out_dir, "grad_overlay.jpg"), add_weighted_u8(im, 0.6, heat, 0.4))
    print(f"energy {energy:.3e}; wrote {crops.shape[0]} crops + grad.jpg + grad_overlay.jpg "
          f"to {args.out_dir} (pooled {ph}x{pw}, {dev.type})")
    return energy, crops, grad


if __name__ == "__main__":
    main()
