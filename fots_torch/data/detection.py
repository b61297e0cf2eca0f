"""Detection training data pipeline (host, NumPy), the port of
``fots/data/detection.py``: load a scene and its ground truth, augment
(pad, shear, scale, invert), crop a square around a word, jitter colours,
compute the EAST targets at 1/4 scale, batch.

The pixels come from the list's image files, read on the workers by
:func:`fots_torch.imageio.imread` (``fots`` reads them with ``cv2.imread``;
the bytes are the same), or from an ``images_npz`` archive (``images`` u8
[N, h, w, 3] BGR and ``names``) matched to the list's entries by basename;
the ground truth comes from the annotation file beside each list entry.  A
listed file that does not exist or reads as nothing is skipped, as ``fots``
skips it; an entry with no pixels in an archive raises when the generator is
built, before any worker starts.  The augmented chain is
computed only over the window the crop keeps (:class:`fots_torch.data.
augment.LazyImage`): the same pixels as the whole chain, far less work.

A sample whose loading raises is reported and dropped, as ``fots`` does;
each batch carries the count of such drops since its worker's previous
batch (``DetectionBatch.dropped``).
"""

from __future__ import annotations

import os
import time
import traceback
import zipfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
from numpy.lib import format as npformat

from fots_torch.data import augment as aug
from fots_torch.data.annotations import load_annotation, load_image_list
from fots_torch.data.prefetch import PrefetchPool
from fots_torch.geometry import generate_rbox, generate_rbox2
from fots_torch.imageio import imread
from fots_torch.kernels import build


@dataclass
class DetectionBatch:
    """A host training batch, with the fields of ``fots.data.detection.
    DetectionBatch``."""

    images: np.ndarray          # [B, H, W, 3] float32, x / 128 - 1
    score_maps: np.ndarray      # [B, H/4, W/4] float32
    geo_maps: np.ndarray        # [B, H/4, W/4, 5] float32 (4 distances, angle)
    training_masks: np.ndarray  # [B, H/4, W/4] uint8
    gt_idxs: np.ndarray         # [B, H/4, W/4] int64, pixel -> word index
    gt_quads: List[List[np.ndarray]]
    labels: List[List[str]] = field(default_factory=list)
    image_fns: List[str] = field(default_factory=list)
    #: samples dropped by an exception since the previous batch
    dropped: int = 0
    #: host seconds its generator spent making it (loading, augmenting,
    #: targets, collating; time suspended between batches excluded)
    make_s: float = 0.0
    #: ``time.time()`` when it was made
    made_at: float = 0.0
    #: of ``make_s``, the seconds spent reading and decoding image files, and
    #: how many files were decoded for it (dropped samples included; 0 from an
    #: archive)
    decode_s: float = 0.0
    decoded: int = 0
    #: of ``make_s``, the seconds of the augmentation chain through the
    #: resized, jittered crop (an archive's page reads included) and of the
    #: targets (score, geometry, mask, word index)
    augment_s: float = 0.0
    targets_s: float = 0.0


def _archive_rows(images_npz: str, image_list: List[str]) -> Dict[str, int]:
    """Each list entry's row in the archive, from its ``names`` alone;
    raises for an entry whose basename the archive does not hold."""
    with np.load(images_npz) as z:
        names = [os.path.basename(str(n)) for n in z["names"]]
    index = dict(zip(names, range(len(names))))
    missing = [p for p in image_list if os.path.basename(p) not in index]
    if missing:
        raise FileNotFoundError(
            f"{images_npz} holds no pixels for {len(missing)} list entries, e.g. "
            f"{missing[:3]}: with an archive, every listed image must be in it")
    return {p: index[os.path.basename(p)] for p in image_list}


def _images_member(images_npz: str):
    """(shape, stored, offset) of the archive's ``images`` array: ``stored``
    when the member is not compressed, ``offset`` where its data starts in
    the member.  Reads the member's header only."""
    with zipfile.ZipFile(images_npz) as zf:
        info = zf.getinfo("images.npy")
        with zf.open(info) as f:
            version = npformat.read_magic(f)
            read_header = (npformat.read_array_header_1_0 if version == (1, 0)
                           else npformat.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
    if dtype != np.uint8 or fortran or len(shape) != 4 or shape[-1] != 3:
        raise ValueError(f"{images_npz}: images must be u8 [N, h, w, 3], got {dtype} {shape}")
    return shape, info.compress_type == zipfile.ZIP_STORED, offset


def load_pixels(images_npz: str, image_list: List[str]) -> Dict[str, np.ndarray]:
    """The archive's u8 image of every list entry, keyed by the entry,
    without decoding the whole archive: an ``images`` member stored
    uncompressed (``np.savez``) is memory-mapped, so a sample reads only the
    pages it touches and readers share them through the page cache; a
    compressed one (``np.savez_compressed``) is streamed once, keeping the
    list's rows only.  Raises for an entry the archive does not hold."""
    rows = _archive_rows(images_npz, image_list)
    shape, stored, offset = _images_member(images_npz)
    with zipfile.ZipFile(images_npz) as zf:
        info = zf.getinfo("images.npy")
        if stored:
            with open(images_npz, "rb") as raw:  # the member's local header
                raw.seek(info.header_offset)
                head = raw.read(30)
            start = (info.header_offset + 30 + int.from_bytes(head[26:28], "little")
                     + int.from_bytes(head[28:30], "little") + offset)
            images = np.memmap(images_npz, np.uint8, "r", offset=start, shape=shape)
            return {p: images[r] for p, r in rows.items()}
        row_bytes = int(np.prod(shape[1:]))
        wanted, kept = set(rows.values()), {}
        with zf.open(info) as f:
            f.seek(offset)
            for r in range(max(wanted) + 1):
                buf = f.read(row_bytes)
                if r in wanted:
                    kept[r] = np.frombuffer(buf, np.uint8).reshape(shape[1:])
    return {p: kept[r] for p, r in rows.items()}


def check_archive(images_npz: str, image_list: List[str], readers: int):
    """What :func:`detection_batches` checks before any reader starts,
    from the archive's names and its images' header: every list entry has
    pixels, and the list's images of a compressed archive, which each
    reader keeps, fit ``readers`` times in half the host's memory."""
    rows = _archive_rows(images_npz, image_list)
    shape, stored, _ = _images_member(images_npz)
    need = readers * len(set(rows.values())) * int(np.prod(shape[1:]))
    have = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    if not stored and need > have // 2:
        raise MemoryError(
            f"{images_npz} is compressed, so each of {readers} readers would keep "
            f"{need // readers / 2 ** 30:.1f} GiB of its images ({need / 2 ** 30:.1f} GiB "
            f"on a host of {have / 2 ** 30:.1f} GiB): write it with np.savez, "
            "which the readers memory-map and share")


def detection_generator(train_list: str, images_npz: Optional[str] = None, input_size: int = 512,
                        batch_size: int = 4, seed: int = 0, in_train: bool = True,
                        allow_empty_frac: float = 0.4, geo_type: int = 0,
                        augment: bool = True) -> Iterator[DetectionBatch]:
    """Infinite (``in_train``) or single-pass batch generator, with
    ``fots``'s draws from ``np.random.default_rng(seed)``.  ``geo_type``: 0
    edge distances, 1 the row / column-scan variant.  ``augment=False``
    skips the pad / shear / scale / invert / jitter chain and crops the top
    left; with ``input_size=-1`` each sample is then the whole image at its
    /32 size.  Pixels come from ``images_npz`` when given (raises at once
    for a list entry without pixels there), else from the files."""
    image_list = load_image_list(train_list)
    pixels = load_pixels(images_npz, image_list) if images_npz else None
    return _batches(np.asarray(image_list), pixels, input_size, batch_size, seed, in_train,
                    allow_empty_frac, geo_type, augment)


def _batches(image_list, pixels, input_size, batch_size, seed, in_train, allow_empty_frac,
             geo_type, augment):
    rng = np.random.default_rng(seed)
    index = np.arange(image_list.shape[0])
    # accumulates across passes: with fewer images than batch_size a
    # per-pass reset would never yield
    batch_items = []
    # samples dropped on an exception, seconds spent decoding files, files
    # decoded, seconds augmenting, seconds making targets
    counts = [0, 0.0, 0, 0.0, 0.0]
    t0 = time.perf_counter()
    while True:
        if in_train:
            rng.shuffle(index)
        for i in index:
            name = str(image_list[i])
            item = _load_one(rng, name, None if pixels is None else pixels[name], input_size,
                             in_train, allow_empty_frac, geo_type, augment, counts)
            if item is None:
                continue
            batch_items.append(item)
            if len(batch_items) == batch_size:
                yield _collate(batch_items, counts, t0)
                batch_items = []
                t0 = time.perf_counter()
        if not in_train:
            if batch_items:
                yield _collate(batch_items, counts, t0)
            return


def _read_file(im_name, counts):
    """``fots``'s read of a list entry: None when the file is missing or
    reads as nothing; the decode is timed into ``counts``."""
    if not os.path.exists(im_name):
        return None
    t0 = time.perf_counter()
    try:
        return imread(im_name)
    finally:
        counts[1] += time.perf_counter() - t0
        counts[2] += 1


def _load_one(rng, im_name, pixels, input_size, in_train, allow_empty_frac, geo_type=0,
              augment=True, counts=None):
    try:
        if pixels is None:
            pixels = _read_file(im_name, counts if counts is not None else [0, 0.0, 0])
            if pixels is None:
                return None
        polys, tags, labels = load_annotation(im_name, pixels.shape)
        allow_empty = rng.uniform() < allow_empty_frac
        t0 = time.perf_counter()
        im = aug.Source(pixels)

        if in_train and augment:
            if rng.uniform(0, 100) < 50 or im.shape[0] < 600 or im.shape[1] < 600:
                im, polys = aug.random_border_pad(rng, im, polys)
            if rng.uniform(0, 100) < 30:
                im, polys = aug.random_shear(rng, im, polys)
            im, polys = aug.random_scale(rng, im, polys)
            im = aug.random_invert(rng, im)

        resize_h = resize_w = input_size
        if input_size == -1:
            # native-size mode: the image's /32 size under a 1 Mpx cap
            size = [im.shape[1] // 32 * 32, im.shape[0] // 32 * 32]
            while size[0] * size[1] > 1024 * 1024:
                size[0] = int(size[0] / 1.2 // 32) * 32
                size[1] = int(size[1] / 1.2 // 32) * 32
            resize_w, resize_h = size

        if augment:
            im, polys = aug.word_centered_crop(rng, im, (resize_h, resize_w), polys)
        else:
            im = aug.Crop(im, 0, resize_h, 0, resize_w)  # deterministic top-left crop
        if im.shape[0] == 0 or im.shape[1] == 0:
            return None
        if im.shape[1] != resize_w or im.shape[0] != resize_h:
            sx = im.shape[1] / resize_w
            sy = im.shape[0] / resize_h
            if sx < 0.5 or sy < 0.5:
                return None
            im = aug.resize(im, (resize_w, resize_h))
            if len(polys) > 0:
                polys[:, :, 0] /= sx
                polys[:, :, 1] /= sy
        im = aug.materialise(im)

        if in_train and augment:
            # jitter after the crop, as the reference does
            im = aug.color_jitter(rng, im)
        t1 = time.perf_counter()

        gen_fn = generate_rbox2 if geo_type == 1 else generate_rbox
        score, geo, mask, gt_idx, gt_out, labels_out = gen_fn(im.shape[:2], polys, tags, labels)
        if counts is not None:
            counts[3] += t1 - t0
            counts[4] += time.perf_counter() - t1
        if score.sum() == 0 and not allow_empty:
            return None
        return (im_name, im.astype(np.float32), score, geo, mask, gt_idx, gt_out, labels_out)
    except Exception:
        traceback.print_exc()
        if counts is not None:
            counts[0] += 1
        return None


def _collate(items, counts, t0) -> DetectionBatch:
    """The batch of ``items``, with the drops, decoded files and stage
    seconds counted in ``counts`` (then reset) and its making timed from
    ``t0``."""
    images = np.stack([it[1] for it in items]).astype(np.float32)
    n_dropped, decode_s, decoded, augment_s, targets_s = counts
    counts[:] = [0, 0.0, 0, 0.0, 0.0]
    return DetectionBatch(
        images=images / 128.0 - 1.0,
        score_maps=np.stack([it[2] for it in items]),
        geo_maps=np.stack([it[3] for it in items]),
        training_masks=np.stack([it[4] for it in items]),
        gt_idxs=np.stack([it[5] for it in items]),
        gt_quads=[it[6] for it in items],
        labels=[it[7] for it in items],
        image_fns=[it[0] for it in items],
        dropped=n_dropped, make_s=time.perf_counter() - t0, made_at=time.time(),
        decode_s=decode_s, decoded=decoded, augment_s=augment_s, targets_s=targets_s)


class _DetectionFactory:
    """Picklable per-worker generator factory (spawn-safe)."""

    def __init__(self, train_list, images_npz, seed, kwargs):
        self.train_list = train_list
        self.images_npz = images_npz
        self.seed = seed
        self.kwargs = kwargs

    def __call__(self, worker_id: int):
        return detection_generator(self.train_list, self.images_npz,
                                   seed=self.seed + 1000 * worker_id + worker_id, **self.kwargs)


def detection_batches(train_list: str, images_npz: Optional[str] = None, num_workers: int = 4,
                      seed: int = 0, **kwargs) -> PrefetchPool:
    """Multiprocess-prefetched batches.  With an archive, :func:`check_archive`
    runs in this process first, so a missing entry raises before any worker
    starts; from files, the decoder is built here once (the workers load
    it) and a list none of whose files exists raises."""
    image_list = load_image_list(train_list)
    if images_npz:
        check_archive(images_npz, image_list, num_workers)
    else:
        if not any(os.path.exists(p) for p in image_list):
            raise FileNotFoundError(f"{train_list}: none of its {len(image_list)} image files "
                                    "exists")
        build.build(["image_decode"])
    return PrefetchPool(_DetectionFactory(train_list, images_npz, seed, kwargs),
                        num_workers=num_workers)
