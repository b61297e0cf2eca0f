"""The benchmark's inputs: the 20 committed 640x960 scenes with their
words, and everything drawn from them by a seed (serving frames and
mosaics, training crops and whole frames with their targets).

Pixels are read as data with ``np.load`` and checked against the hashes
in ``gpubench/scenes.json``, so the yardstick's inputs cannot move under
it.  Nothing here imports the program under test.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gpubench import targets

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Scene:
    pixels: np.ndarray      # [640, 960, 3] u8 BGR
    quads: np.ndarray       # [n, 4, 2] f64 corner points
    tags: np.ndarray        # [n] bool: ignored words ('###' or '*')
    labels: List[str]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def parse_gt(text: str):
    """Comma-separated ground truth: 8 corner coordinates, a class, the
    word.  Returns (quads [n, 4, 2], tags [n], words)."""
    quads, tags, labels = [], [], []
    for line in text.splitlines():
        line = line.replace("﻿", "").strip()
        if not line:
            continue
        s = line.split(",")
        word = ",".join(s[9:]).strip()
        quads.append(np.asarray(list(map(float, s[:8]))).reshape(4, 2))
        labels.append(word)
        tags.append(word == "*" or word.startswith("###"))
    return (np.asarray(quads, np.float64).reshape(-1, 4, 2), np.asarray(tags, bool), labels)


def load_scenes() -> List[Scene]:
    """The 16 held-out scenes, then the 4 smoke scenes, with their words;
    raises if a file differs from the hash the benchmark was made with."""
    with open(os.path.join(HERE, "scenes.json")) as f:
        spec = json.load(f)
    for rel, digest in spec["sha256"].items():
        got = _sha256(os.path.join(ROOT, rel))
        if got != digest:
            raise RuntimeError(f"input {rel} changed: sha256 {got}, expected {digest}")
    scenes = []
    with np.load(os.path.join(ROOT, spec["heldout"])) as z:
        for pixels, text in zip(z["images"], z["gt_texts"]):
            scenes.append(Scene(np.ascontiguousarray(pixels), *parse_gt(str(text))))
    with np.load(os.path.join(ROOT, spec["smoke"])) as z:
        for pixels, name in zip(z["images"], z["names"]):
            gt = os.path.join(ROOT, spec["smoke_gt_dir"], "gt_" + os.path.splitext(str(name))[0]
                              + ".txt")
            with open(gt, encoding="utf-8") as f:
                scenes.append(Scene(np.ascontiguousarray(pixels), *parse_gt(f.read())))
    return scenes


def seed_rng(seed: int, stream: str) -> np.random.Generator:
    """A NumPy generator for one named use of ``seed`` (any whole number)."""
    return np.random.default_rng([abs(int(seed)) % (1 << 63), int(seed < 0),
                                  int.from_bytes(stream.encode()[:8], "little")])


def mosaic(scenes: Sequence[Scene], idx: Sequence[int]) -> Scene:
    """A 2x2 mosaic of four scenes (row-major), with their words moved."""
    h, w = scenes[0].pixels.shape[:2]
    pix = np.zeros((2 * h, 2 * w, 3), np.uint8)
    quads, tags, labels = [], [], []
    for k, i in enumerate(idx):
        oy, ox = (k // 2) * h, (k % 2) * w
        pix[oy:oy + h, ox:ox + w] = scenes[i].pixels
        quads.append(scenes[i].quads + np.asarray([ox, oy], np.float64))
        tags.append(scenes[i].tags)
        labels += scenes[i].labels
    return Scene(pix, np.concatenate(quads), np.concatenate(tags), labels)


# --------------------------------------------------------------------------
# training batches
# --------------------------------------------------------------------------

@dataclass
class TrainSample:
    image: np.ndarray       # [H, W, 3] u8
    score: np.ndarray       # [H/4, W/4] f32
    geo: np.ndarray         # [H/4, W/4, 5] f32
    mask: np.ndarray        # [H/4, W/4] u8
    gt_idx: np.ndarray      # [H/4, W/4] i64
    gt_quads: list
    labels: List[str]


def native_sample(scene: Scene) -> TrainSample:
    """A whole frame at its own size with its targets (no augmentation)."""
    score, geo, mask, gt_idx, gt_out, labels = targets.generate_rbox(
        scene.pixels.shape[:2], scene.quads, scene.tags, scene.labels)
    return TrainSample(scene.pixels, score, geo, mask, gt_idx, gt_out, labels)


def crop_samples(scenes: Sequence[Scene], rng: np.random.Generator, n: int, size: int,
                 scale=(0.5, 2.0)) -> List[TrainSample]:
    """``n`` crops of ``size`` x ``size``: each of a scene drawn from ``rng``
    at a scale drawn from ``scale`` (bilinear), cut around a word drawn from
    it at a drawn offset and clamped inside the scaled scene (zero past its
    edge), with the targets of the crop."""
    picks = []
    for _ in range(n):
        i = int(rng.integers(len(scenes)))
        s = float(rng.uniform(*scale))
        sc = scenes[i]
        words = np.nonzero(~sc.tags)[0]
        wi = int(rng.choice(words)) if len(words) else 0
        cx, cy = (sc.quads[wi].mean(axis=0) * s) if len(sc.quads) else (0.0, 0.0)
        ox, oy = rng.uniform(-0.35, 0.35, size=2) * size
        hs, ws = sc.pixels.shape[0] * s, sc.pixels.shape[1] * s
        x0 = int(np.clip(cx + ox - size / 2, 0, max(ws - size, 0)))
        y0 = int(np.clip(cy + oy - size / 2, 0, max(hs - size, 0)))
        picks.append((i, s, x0, y0))
    # one bilinear gather for every crop (half-pixel centres, zero outside)
    src = torch.from_numpy(np.stack([scenes[i].pixels for i, *_ in picks])).permute(0, 3, 1, 2)
    h0, w0 = src.shape[2:]
    grid = torch.empty((n, size, size, 2), dtype=torch.float64)
    u = torch.arange(size, dtype=torch.float64) + 0.5
    for k, (_, s, x0, y0) in enumerate(picks):
        gx = (u + x0) / s / w0 * 2 - 1
        gy = (u + y0) / s / h0 * 2 - 1
        grid[k, :, :, 0] = gx[None, :]
        grid[k, :, :, 1] = gy[:, None]
    out = F.grid_sample(src.float(), grid.float(), mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    crops = out.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    samples = []
    for k, (i, s, x0, y0) in enumerate(picks):
        sc = scenes[i]
        quads = sc.quads * s - np.asarray([x0, y0], np.float64)
        score, geo, mask, gt_idx, gt_out, labels = targets.generate_rbox(
            (size, size), quads, sc.tags, sc.labels)
        samples.append(TrainSample(np.ascontiguousarray(crops[k]), score, geo, mask, gt_idx,
                                   gt_out, labels))
    return samples
