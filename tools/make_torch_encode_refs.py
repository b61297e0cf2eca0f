"""Write the JPEG references the PyTorch port's encoder is held to on the card.

    PYTHONPATH=. python tools/make_torch_encode_refs.py

Needs OpenCV (the port's GPU machine has none; there
``fots_torch.imageio.imencode_jpg`` must reproduce these bytes).  Writes
``fots_torch/assets/encode_ref/``:

- ``sources.npz``: the pixels encoded besides ``img_112`` (the first
  held-out scene, 640x960 BGR, which is row 0 of
  ``fots_torch/assets/heldout_eval_u8.npz``'s ``images``):
  ``noise_37x53``, seeded BGR noise of an odd size (partial MCUs on both
  edges), and ``grey_44x173``, a seeded window of that scene in grey (one
  component, partial blocks);
- ``<name>.jpg``: ``cv2.imwrite``'s file of each source at its defaults;
- ``manifest.json``: each source's file, shape and the file's SHA-256.
"""

from __future__ import annotations

import hashlib
import json
import os

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "fots_torch", "assets", "encode_ref")
SEED = 11


def sources() -> dict:
    with np.load(os.path.join(REPO, "fots_torch", "assets", "heldout_eval_u8.npz")) as z:
        scene = z["images"][0]
    rng = np.random.default_rng(SEED)
    noise = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    y, x = int(rng.integers(0, 640 - 44)), int(rng.integers(0, 960 - 173))
    grey = cv2.cvtColor(np.ascontiguousarray(scene[y:y + 44, x:x + 173]), cv2.COLOR_BGR2GRAY)
    return {"img_112": scene, "noise_37x53": noise, "grey_44x173": grey}


def main():
    os.makedirs(OUT, exist_ok=True)
    src = sources()
    np.savez_compressed(os.path.join(OUT, "sources.npz"),
                        **{k: v for k, v in src.items() if k != "img_112"})
    manifest = {}
    for name, im in src.items():
        path = os.path.join(OUT, f"{name}.jpg")
        if not cv2.imwrite(path, im):
            raise RuntimeError(f"cv2.imwrite failed for {path}")
        with open(path, "rb") as f:
            data = f.read()
        assert data == cv2.imencode(".jpg", im)[1].tobytes()
        manifest[name] = {"file": f"{name}.jpg", "shape": list(im.shape),
                          "sha256": hashlib.sha256(data).hexdigest()}
        print(f"{name}: {im.shape} -> {len(data)} bytes")
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
