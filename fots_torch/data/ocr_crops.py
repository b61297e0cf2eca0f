"""Recognition-only crop pipeline with width bucketing (host, NumPy), the
port of ``fots/data/ocr_crops.py``.

Each word image is height-normalised and snapped to the ``8 + 4 i`` bucket
grid, with per-bucket batch sizes halving every 10 buckets; a bucket is
emitted as a batch when it fills.  The draws from ``rng``, the skips
(vertical text) and the Arabic reversal are ``fots``'s, in its order.

The word images are the files of a crop list (``train_list``: ``gt.txt``
of ``file, "text"`` lines, :func:`parse_crop_list`), read as ``fots`` reads
them (``cv2.imread`` -> :func:`fots_torch.imageio.imread`, the same bytes,
grey crops with ``grayscale=True``; a missing or unreadable file is
skipped), or come from a decoded crop archive (``crops_npz``, written by
``tools/make_torch_ocr_asset.py``):

- ``pixels``: one flat u8 buffer of every crop, BGR, row-major;
- ``shapes`` [N, 3] (h, w, c) and ``offsets`` [N] into ``pixels``;
- ``texts`` [N] (transcriptions) and ``split`` [N] (``"train"`` / ``"eval"``).

An archive's split stands for a crop list.  OpenCV's calls have NumPy
counterparts: ``cv2.resize`` -> :func:`fots_torch.geometry.
resize_bilinear_u8` (byte-exact), ``cv2.blur`` -> :func:`fots_torch.imgproc.
blur3_u8` (byte-exact), ``getRotationMatrix2D`` + ``warpAffine`` ->
:func:`fots_torch.imgproc.warp_affine_u8` (byte-exact); a grey crop
(``rgb=False``) of an archive is :func:`fots_torch.imgproc.bgr2gray_u8` of
its BGR pixels (within one level of ``cv2.imread``'s).
"""

from __future__ import annotations

import os
import unicodedata as ud
from typing import Iterator, List, Optional, Tuple

import numpy as np

from fots_torch.codec import LabelCodec
from fots_torch.data import augment as aug
from fots_torch.data.prefetch import PrefetchPool
from fots_torch.geometry import resize_bilinear_u8
from fots_torch.imageio import imread
from fots_torch.imgproc import bgr2gray_u8, blur3_u8, warp_affine_u8
from fots_torch.kernels import build

BUCKETS = tuple(8 + 4 * i for i in range(1, 100))
MAX_LABEL_LEN = 64
SPLITS = ("train", "eval")


def parse_crop_list(list_path: str) -> List[Tuple[str, str]]:
    """Parse ``file, "text"`` / ``file text`` lines into (path, text)."""
    base_dir = os.path.dirname(list_path)
    out = []
    with open(list_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            delim = " " if " " in line.split(",")[0] else ","
            spl = line.split(delim)
            name = spl[0].strip()
            if name.endswith(","):
                name = name[:-1]
            txt = delim.join(spl[1:]).strip()
            if len(txt) > 1 and txt[0] == '"' and txt[-1] == '"':
                txt = txt[1:-1]
            if not txt:
                continue
            if not name.startswith("/"):
                name = os.path.join(base_dir, name)
            out.append((name, txt))
    return out


def batch_sizes_per_bucket(batch_size: int) -> List[int]:
    """Per-bucket batch size, halving every 10 buckets down to 1."""
    sizes = []
    cb = batch_size
    for i in range(len(BUCKETS)):
        sizes.append(max(1, int(cb)))
        if i % 10 == 0 and cb > 2:
            cb /= 2
    return sizes


def best_bucket(width: int) -> int:
    diffs = [abs(width - b) for b in BUCKETS]
    return int(np.argmin(diffs))


def load_crops(crops_npz: str, split: str = "train") -> List[Tuple[np.ndarray, str]]:
    """(u8 [h, w, c] BGR crop, text) of every archive entry of ``split``,
    in archive order; the crops are views of one buffer."""
    if split not in SPLITS:
        raise ValueError(f"split must be one of {SPLITS}, got {split!r}")
    with np.load(crops_npz) as z:
        pixels, shapes, offsets = z["pixels"], z["shapes"], z["offsets"]
        texts, splits = [str(t) for t in z["texts"]], [str(s) for s in z["split"]]
    out = []
    for i, (shape, off) in enumerate(zip(shapes, offsets)):
        if splits[i] != split:
            continue
        n = int(np.prod(shape))
        out.append((pixels[int(off):int(off) + n].reshape(tuple(int(v) for v in shape)),
                    texts[i]))
    if not out:
        raise ValueError(f"{crops_npz}: no crop in split {split!r}")
    return out


def crop_samples(crops_npz: Optional[str], split: str = "train",
                 train_list: Optional[str] = None) -> list:
    """(image file path, text) of every entry of ``train_list`` when given,
    else (u8 [h, w, c] BGR crop, text) of the archive's ``split``."""
    if train_list:
        samples = parse_crop_list(train_list)
        if not samples:
            raise ValueError(f"{train_list}: no crop")
        return samples
    return load_crops(crops_npz, split)


def _read_crop(src, rgb: bool) -> Optional[np.ndarray]:
    """A sample's u8 [h, w, c] image: a file read as ``fots`` reads it
    (None when missing or unreadable), or an archive crop."""
    if isinstance(src, str):
        if not os.path.exists(src):
            return None
        im = imread(src, grayscale=not rgb)
        return None if im is None else (im if rgb else im[:, :, None])
    return src if rgb else bgr2gray_u8(src)


def ocr_crop_generator(
    crops_npz: Optional[str],
    codec: Optional[LabelCodec] = None,
    batch_size: int = 8,
    norm_height: int = 32,
    rgb: bool = True,
    in_train: bool = True,
    seed: int = 0,
    split: str = "train",
    train_list: Optional[str] = None,
) -> Iterator[dict]:
    """Yields dicts: images [N, h, wb, C] normalised (x / 128 - 1, f32),
    labels [N, L] padded, label_lengths [N], texts (host list).  The crops
    are ``train_list``'s files when given, else the archive's ``split``."""
    codec = codec or LabelCodec()
    samples = crop_samples(crops_npz, split, train_list)
    rng = np.random.default_rng(seed)
    index = np.arange(len(samples))
    sizes = batch_sizes_per_bucket(batch_size)
    bucket_items: List[List] = [[] for _ in BUCKETS]

    while True:
        if in_train:
            rng.shuffle(index)
        for i in index:
            src, txt = samples[i]
            im = _read_crop(src, rgb)
            if im is None:
                continue
            if im.shape[0] > im.shape[1] and len(txt) > 4:
                continue  # vertical text is skipped
            scale = norm_height / float(im.shape[0])
            width = int(im.shape[1] * scale)
            if in_train:
                width += int(rng.integers(-2 * norm_height, 2 * norm_height + 1))
            b = best_bucket(width)
            if in_train and rng.integers(0, 101) < 10:
                b = int(np.clip(b + rng.integers(-1, 2), 0, len(BUCKETS) - 1))
            im = resize_bilinear_u8(im, (BUCKETS[b], norm_height))
            if in_train:
                if rng.integers(0, 101) < 10:
                    im = np.invert(im)
                if rng.integers(0, 101) < 10:
                    im = blur3_u8(im)
                if rng.integers(0, 101) < 10:
                    # getRotationMatrix2D(centre, 0, 1) is the identity; then
                    # a horizontal shear
                    warp = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
                    warp[0, 1] = rng.uniform(-0.1, 0.1)
                    im = warp_affine_u8(im, warp, (im.shape[1], im.shape[0]))
                if im.shape[2] == 3:
                    im = aug.color_jitter(rng, im)

            label_txt = txt
            try:
                if txt and "ARABIC" in ud.name(txt[0]):
                    label_txt = txt[::-1]  # Arabic is labelled right to left
            except ValueError:
                pass

            bucket_items[b].append((im.astype(np.float32), label_txt, txt))
            if len(bucket_items[b]) == sizes[b]:
                yield _collate_bucket(bucket_items[b], codec)
                bucket_items[b] = []
        if not in_train:
            for b, items in enumerate(bucket_items):
                if items:
                    yield _collate_bucket(items, codec)
            return


def _collate_bucket(items, codec: LabelCodec) -> dict:
    images = np.stack([it[0] for it in items]) / 128.0 - 1.0
    texts = [it[1] for it in items]
    labels, lengths = codec.encode_padded(texts, MAX_LABEL_LEN)
    return {
        "images": images.astype(np.float32),
        "labels": labels,
        "label_lengths": lengths,
        "texts": [it[2] for it in items],
    }


class _OcrCropFactory:
    """Picklable per-worker generator factory (spawn-safe)."""

    def __init__(self, crops_npz, seed, kwargs):
        self.crops_npz = crops_npz
        self.seed = seed
        self.kwargs = kwargs

    def __call__(self, worker_id: int):
        return ocr_crop_generator(self.crops_npz, seed=self.seed + 7919 * worker_id,
                                  **self.kwargs)


def ocr_crop_batches(crops_npz: Optional[str], num_workers: int = 2, seed: int = 0,
                     **kwargs) -> PrefetchPool:
    """Batches of :func:`ocr_crop_generator` from ``num_workers`` spawned
    workers (worker k seeded ``seed + 7919 k``).  The archive's split or the
    crop list is read here first, so a missing or empty one raises before
    any worker starts; for a list, the decoder is built here once."""
    crop_samples(crops_npz, kwargs.get("split", "train"), kwargs.get("train_list"))
    if kwargs.get("train_list"):
        build.build(["image_decode"])
    return PrefetchPool(_OcrCropFactory(crops_npz, seed, kwargs), num_workers=num_workers)
