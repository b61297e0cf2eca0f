"""Image augmentation for detection training (host, NumPy), the port of
``fots/data/augment.py``.

The same functions with the same defaults take the same draws from the same
``np.random.Generator`` methods in the same order (``color_jitter``'s hue
and grey draws and ``word_centered_crop``'s 31 tries included), so a seed
picks the same pads, shears, scales, crops and jitters as ``fots``: the
polygons are equal in float64 and the pixels byte for byte
(:mod:`fots_torch.imgproc` reproduces OpenCV's rounding).

Each function takes a u8 image array, or a :class:`LazyImage`.  The
augmented chain pads a scene by 300-500 px a side and scales it up to 2x
(about 3400 x 4000 x 3) before the crop keeps 512 x 512 of it; every output
pixel of the pad, the warp and the resize depends only on its own taps and
the crop's draws only on shapes and polygons.  So on a :class:`LazyImage`
the functions record each step, and :meth:`LazyImage.region` computes the
chain only over the window that is asked for, with pixels equal bit for
bit to the whole chain's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fots_torch.geometry import resize_bilinear_u8, resize_window_u8
from fots_torch.imgproc import (bgr2hsv_u8, bilinear_sample_u8, hsv2bgr_u8, pad_constant,
                                warp_affine_u8, warp_source_coords)


class LazyImage:
    """A u8 [h, w, c] image known by its shape and the steps that make it;
    :meth:`region` computes a rectangle of it, zeros outside the image."""

    shape: Tuple[int, ...]

    def region(self, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
        raise NotImplementedError

    def array(self) -> np.ndarray:
        return self.region(0, self.shape[0], 0, self.shape[1])


class Source(LazyImage):
    def __init__(self, im: np.ndarray):
        self.im = im
        self.shape = im.shape

    def region(self, y0, y1, x0, x1):
        h, w = self.shape[:2]
        out = np.zeros((y1 - y0, x1 - x0) + self.shape[2:], np.uint8)
        ya, yb, xa, xb = max(y0, 0), min(y1, h), max(x0, 0), min(x1, w)
        if ya < yb and xa < xb:
            out[ya - y0:yb - y0, xa - x0:xb - x0] = self.im[ya:yb, xa:xb]
        return out


class Pad(LazyImage):
    def __init__(self, src: LazyImage, top: int, bottom: int, left: int, right: int):
        self.src, self.top, self.left = src, top, left
        h, w = src.shape[:2]
        self.shape = (h + top + bottom, w + left + right) + src.shape[2:]

    def region(self, y0, y1, x0, x1):
        return self.src.region(y0 - self.top, y1 - self.top, x0 - self.left, x1 - self.left)


class Warp(LazyImage):
    """``cv2.warpAffine(src, m, (w, h))`` of the source's own size."""

    def __init__(self, src: LazyImage, m):
        self.src, self.m = src, m
        self.shape = src.shape

    def region(self, y0, y1, x0, x1):
        sx, sy = warp_source_coords(self.m, np.arange(y0, y1), np.arange(x0, x1),
                                    self.shape[1])
        ry0, ry1 = int(np.floor(sy.min())), int(np.floor(sy.max())) + 2
        rx0, rx1 = int(np.floor(sx.min())), int(np.floor(sx.max())) + 2
        # every tap lies in the rectangle, which reads 0 outside the source
        rect = self.src.region(ry0, ry1, rx0, rx1)
        return bilinear_sample_u8(lambda ys, xs: rect[ys - ry0, xs - rx0], sx, sy)


class Resize(LazyImage):
    """``cv2.resize(src, dsize)`` (``INTER_LINEAR``); dsize is (w, h)."""

    def __init__(self, src: LazyImage, dsize: Tuple[int, int]):
        self.src, self.dsize = src, (int(dsize[0]), int(dsize[1]))
        self.shape = (self.dsize[1], self.dsize[0]) + src.shape[2:]

    def region(self, y0, y1, x0, x1):
        return resize_window_u8(self.src.region, self.src.shape[:2], self.dsize,
                                (y0, y1), (x0, x1))


class Invert(LazyImage):
    def __init__(self, src: LazyImage):
        self.src, self.shape = src, src.shape

    def region(self, y0, y1, x0, x1):
        return np.invert(self.src.region(y0, y1, x0, x1))


class Crop(LazyImage):
    """``src[y0:y1, x0:x1]`` with NumPy's slicing of non-negative bounds."""

    def __init__(self, src: LazyImage, y0: int, y1: int, x0: int, x1: int):
        h, w = src.shape[:2]
        self.src = src
        self.y0, self.x0 = min(y0, h), min(x0, w)
        self.shape = (max(0, min(y1, h) - self.y0), max(0, min(x1, w) - self.x0)) + src.shape[2:]

    def region(self, y0, y1, x0, x1):
        return self.src.region(y0 + self.y0, y1 + self.y0, x0 + self.x0, x1 + self.x0)


def materialise(im) -> np.ndarray:
    return im.array() if isinstance(im, LazyImage) else im


def resize(im, dsize: Tuple[int, int]):
    """``cv2.resize(im, dsize)`` of an array, or its lazy step."""
    if isinstance(im, LazyImage):
        return Resize(im, dsize)
    return resize_bilinear_u8(im, dsize)


def random_border_pad(rng, im, polys, lo=300, hi=500):
    """Pad all four borders by U(lo, hi) px."""
    top = int(rng.uniform(lo, hi))
    bottom = int(rng.uniform(lo, hi))
    left = int(rng.uniform(lo, hi))
    right = int(rng.uniform(lo, hi))
    if isinstance(im, LazyImage):
        im = Pad(im, top, bottom, left, right)
    else:
        im = pad_constant(im, top, bottom, left, right)
    if len(polys) > 0:
        polys[:, :, 0] += left
        polys[:, :, 1] += top
    return im, polys


def random_shear(rng, im, polys, max_shear=0.2):
    """Horizontal shear x' = x + s*y (the effective transform of the
    reference's random_perspective)."""
    s = rng.uniform(-max_shear, max_shear)
    m = np.float32([[1, s, 0], [0, 1, 0]])
    if isinstance(im, LazyImage):
        im = Warp(im, m)
    else:
        im = warp_affine_u8(im, m, (im.shape[1], im.shape[0]))
    if len(polys) > 0:
        polys[:, :, 0] = polys[:, :, 0] + s * polys[:, :, 1]
    return im, polys


def random_scale(rng, im, polys, lo=0.5, hi=2.0, aniso=(0.8, 1.2)):
    """Random scale, y additionally jittered."""
    sx = rng.uniform(lo, hi)
    sy = sx * rng.uniform(*aniso)
    im = resize(im, (int(im.shape[1] * sx), int(im.shape[0] * sy)))
    if len(polys) > 0:
        polys[:, :, 0] *= sx
        polys[:, :, 1] *= sy
    return im, polys


def color_jitter(rng, im, brightness=0.3, contrast=0.3, saturation=0.3, hue=0.3,
                 gray_p=0.1):
    """Brightness / contrast / saturation / hue jitter and random greyscale
    (torchvision's ColorJitter(.3, .3, .3, .3) + RandomGrayscale(0.1) in the
    reference) of a u8 array."""
    im = im.astype(np.float32)
    b = rng.uniform(1 - brightness, 1 + brightness)
    c = rng.uniform(1 - contrast, 1 + contrast)
    im = im * b
    mean = im.mean()
    im = (im - mean) * c + mean
    if im.ndim == 3 and im.shape[2] == 3:
        s = rng.uniform(1 - saturation, 1 + saturation)
        gray = im.mean(axis=2, keepdims=True)
        im = gray + (im - gray) * s
        h = rng.uniform(-hue, hue)
        if abs(h) > 1e-3:
            hsv = bgr2hsv_u8(np.clip(im, 0, 255).astype(np.uint8))
            hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(h * 90)) % 180
            im = hsv2bgr_u8(hsv).astype(np.float32)
        if rng.uniform() < gray_p:
            gray = im.mean(axis=2, keepdims=True)
            im = np.repeat(gray, 3, axis=2)
    return np.clip(im, 0, 255).astype(np.uint8)


def random_invert(rng, im, p=0.1):
    if rng.integers(0, 101) < p * 100:
        return Invert(im) if isinstance(im, LazyImage) else np.invert(im)
    return im


def _crop(im, ys, ye, xs, xe):
    return Crop(im, ys, ye, xs, xe) if isinstance(im, LazyImage) else im[ys:ye, xs:xe]


def word_centered_crop(rng, im, crop_hw: Tuple[int, int], polys):
    """Square crop centred near a random word (the reference's cut_image),
    shifting polys into crop coordinates; after 31 tries that give no
    square crop, the image and polys as they are."""
    ch, cw = crop_hw
    if len(polys) > 0:
        for _cnt in range(31):
            poly = polys[int(rng.integers(0, len(polys)))]
            center = poly.sum(0) / 4
            xs = max(int(center[0] - rng.uniform(-100, 100) - cw / 2), 1)
            ys = max(int(center[1] - rng.uniform(-100, 100) - ch / 2), 1)
            crop = _crop(im, ys, ys + ch, xs, xs + cw)
            if crop.shape[0] == crop.shape[1]:
                break
        else:
            return im, polys
    else:
        xs = int(rng.uniform(0, im.shape[1]))
        ys = int(rng.uniform(0, im.shape[0]))
        crop = _crop(im, ys, ys + ch, xs, xs + cw)
    if len(polys) > 0:
        polys[:, :, 0] -= xs
        polys[:, :, 1] -= ys
    return crop, polys
