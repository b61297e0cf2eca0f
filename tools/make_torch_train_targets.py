"""Write ``fots_torch/assets/train_targets.npz``: the training targets of the
four scenes in ``fots_torch/assets/smoke_images_u8.npz``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/make_torch_train_targets.py [--out PATH]

The targets come from the JAX package's own pipeline,
``fots.data.detection.detection_generator(..., input_size=-1,
augment=False)``: native 640x960 input, no augmentation, one pass in list
order.  The GPU machine has no OpenCV: its training phase from the
snapshot reads them beside the pre-decoded images, and the port's own
targets (``fots_torch.data.detection``) are held to them byte for byte
there (``chip_smoke.py`` phase 7) and here
(``tests/test_torch_port_train_data.py``).
``tests/test_torch_port_train_step.py`` regenerates them and requires
equality.

Arrays: ``names`` [4]; ``score_maps`` [4, 160, 240] f32;
``training_masks`` [4, 160, 240] u8; ``geo_maps`` [4, 160, 240, 5] f32;
``gt_idxs`` [4, 160, 240] i64; ``gt_quads`` [N, 4, 2] f32 and ``gt_labels``
[N] (all scenes' words, in order) with ``gt_counts`` [4] words per scene.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")
OUT = os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")


def make_targets() -> dict:
    """The asset's arrays, computed by ``fots`` from the jpgs in data/synth."""
    from fots.data.detection import detection_generator

    with np.load(SMOKE_IMAGES) as z:
        names = [str(n) for n in z["names"]]
    with tempfile.TemporaryDirectory() as tmp:
        list_path = os.path.join(tmp, "smoke.txt")
        with open(list_path, "w") as f:
            f.writelines(os.path.join(REPO, "data", "synth", n) + "\n" for n in names)
        batch = next(detection_generator(list_path, input_size=-1, batch_size=len(names),
                                         seed=0, in_train=False, augment=False))
    quads = [np.asarray(q, np.float32) for scene in batch.gt_quads for q in scene]
    return {
        "names": np.asarray(names),
        "score_maps": batch.score_maps.astype(np.float32),
        "training_masks": batch.training_masks.astype(np.uint8),
        "geo_maps": batch.geo_maps.astype(np.float32),
        "gt_idxs": batch.gt_idxs.astype(np.int64),
        "gt_quads": np.stack(quads).reshape(-1, 4, 2),
        "gt_labels": np.asarray([t for scene in batch.labels for t in scene]),
        "gt_counts": np.asarray([len(s) for s in batch.gt_quads], np.int64),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    arrays = make_targets()
    with open(args.out, "wb") as f:
        np.savez_compressed(f, **arrays)
    print(f"wrote {args.out}: " + ", ".join(f"{k} {v.shape}" for k, v in arrays.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
