"""TIFF's last codings ``cv2.imread`` reads, against it byte for byte in
colour (BGR) and grayscale, read by ``fots_torch.imageio.imread`` as OpenCV
5.0 reads them through libtiff 4.7's RGBA reader:

- old-style LZW (LZWDecodeCompat: LSB-first codes whose width grows one
  code later) of this package's writer (``lzw_tiff(..., old_style=True)``):
  grey, RGB, the predictor, strips, tiles, planes, 16 bits, fill order 2,
  cut and damaged strips, strips of both styles in one file;
- CIELab (putcontig8bitCIELab8 / 16): every 8-bit L*a*b* triple, 16-bit
  samples, WhitePoint tags, Pillow's LAB files, strips, tiles, LZW;
- SGILog (compression 34676, tif_luv.c into 8-bit samples): ``cv2.imwrite``'s
  float files (LogLuv colour, LogL grey) and files of this module's run-length
  writer (``sgilog_rows``) in strips and tiles, cut and damaged;
- SGILog24 (34677): every 24-bit LogLuv24 value (16,777,216 pixels, the
  14-bit uv index through libtiff's uvcode.h table), ``cv2.imwrite``'s
  files, strips, tiles, cut and damaged rows;
- the combinations ``cv2`` reads as None: old-style JPEG (compression 6, not
  configured in OpenCV's libtiff), ICCLab and ITULab, LogL or LogLuv without
  SGILog or at other sample layouts, CIELab of 1 or 4 samples or in planes,
  SGILog of another photometric, SGILog24 of LogL, a WhitePoint of y = 0.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene
from tests.test_torch_port_imageio_bmp_gif import assert_cuts, assert_same
from tests.test_torch_port_imageio_tiff import tiff_bytes
from tests.test_torch_port_imageio_tiff_codings import raw_tiff

_SHORT, _LONG, _RATIONAL = 3, 4, 5


def _write(tmp_path, data, name="x.tif"):
    path = tmp_path / name
    path.write_bytes(data)
    return path


def _none_both(path):
    assert cv2.imread(str(path)) is None and cv2.imread(str(path), 0) is None
    assert imread(str(path)) is None and imread(str(path), grayscale=True) is None


# --------------------------------------------------------------------------
# None: what cv2's libtiff does not read
# --------------------------------------------------------------------------

def _jpeg(im):
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("k", range(5))
def test_tiff_old_style_jpeg_is_none(tmp_path, k):
    """Old-style JPEG (compression 6) with its JPEG stream as the strip, of
    RGB, YCbCr and grey samples, with and without JPEGInterchangeFormat:
    libtiff in OpenCV has no old-style JPEG support, so None in both modes."""
    h, w = 13, 17
    rng = np.random.default_rng(k)
    grey = k == 4
    stream = _jpeg(rng.integers(0, 256, (h, w) if grey else (h, w, 3), np.uint8))
    tags = {258: (_SHORT, [8] * (1 if grey else 3)), 259: (_SHORT, [6]),
            262: (_SHORT, [1 if grey else (2, 6)[k % 2]]), 277: (_SHORT, [1 if grey else 3]),
            278: (_LONG, [h])}
    if k in (2, 3):
        tags.update({513: (_LONG, [8]), 514: (_LONG, [len(stream)])})
    _none_both(_write(tmp_path, raw_tiff(w, h, [stream], tags)))


@pytest.mark.parametrize("photometric", [9, 10])
def test_tiff_icclab_itulab_is_none(tmp_path, photometric):
    """ICCLab (9) and ITULab (10), 8-bit, 3 samples, uncompressed: libtiff's
    RGBA reader has no routine for them, so None in both modes."""
    h, w = 13, 17
    px = np.random.default_rng(photometric).integers(0, 256, (h, w, 3), np.uint8)
    _none_both(_write(tmp_path, raw_tiff(w, h, [px.tobytes()], {
        258: (_SHORT, [8] * 3), 259: (_SHORT, [1]), 262: (_SHORT, [photometric]),
        277: (_SHORT, [3]), 278: (_LONG, [h])})))


# (photometric, compression, samples, bits, planar): probed against cv2, all None
_UNREAD = [(p, 1, s, b, 1) for p in (9, 10) for s in (1, 3, 4) for b in (8, 16)] + [
    (8, 1, 1, 8, 1), (8, 1, 4, 8, 1), (8, 1, 4, 16, 1), (8, 1, 3, 8, 2), (8, 1, 1, 16, 1)] + [
    (p, c, s, b, 1) for p in (32844, 32845) for c in (1, 5) for s in (1, 3)
    for b in (8, 16)] + [
    (32844, 34676, 3, 8, 1), (32844, 34676, 3, 16, 1), (32845, 34676, 1, 8, 1),
    (32845, 34676, 1, 16, 1), (32844, 34677, 1, 8, 1), (32844, 34677, 1, 16, 1),
    (32844, 34677, 3, 8, 1), (32845, 34677, 1, 8, 1), (32845, 34676, 3, 8, 2),
    (1, 34676, 1, 8, 1), (2, 34676, 3, 8, 1), (2, 34677, 3, 8, 1), (32844, 34676, 1, 32, 1),
    (32845, 34676, 3, 32, 1)]


@pytest.mark.parametrize("k", range(len(_UNREAD)))
def test_tiff_unread_combinations_are_none(tmp_path, k):
    """The sample layouts and codings of the Lab and log photometrics that
    cv2 reads as None (ICCLab, ITULab, CIELab of other than 3 contiguous
    samples, LogL / LogLuv without SGILog or at the other sample count,
    SGILog of another photometric, SGILog24 of LogL): None in both modes."""
    photometric, compression, spp, bps, planar = _UNREAD[k]
    h, w = 9, 11
    rng = np.random.default_rng(k)
    px = rng.integers(0, 256, (h, w * spp * bps // 8), np.uint8)
    chunks = [px.tobytes()] if planar == 1 else [p.tobytes() for p in np.array_split(
        px, spp, axis=1)]
    tags = {258: (_SHORT, [bps] * spp), 259: (_SHORT, [compression]),
            262: (_SHORT, [photometric]), 277: (_SHORT, [spp]), 278: (_LONG, [h]),
            284: (_SHORT, [planar])}
    _none_both(_write(tmp_path, raw_tiff(w, h, chunks, tags)))


# --------------------------------------------------------------------------
# old-style LZW
# --------------------------------------------------------------------------

_OLD_LZW = [dict(), dict(grey=True), dict(predictor=2), dict(rows_per_strip=5),
            dict(tile=(16, 16)), dict(planar=2), dict(bps=16), dict(fillorder=2),
            dict(bps=16, predictor=2, big_endian=True), dict(big=True)]


@pytest.mark.parametrize("k", range(len(_OLD_LZW)))
def test_tiff_old_style_lzw_decodes_as_cv2(tmp_path, k):
    """Old-style LZW strips and tiles (the clear code first, LSB-first codes,
    the late width change) read as cv2 reads them, in both modes."""
    kw = dict(_OLD_LZW[k])
    im = scene(300, 400, seed=k) if kw.pop("big", False) else scene(29, 37, seed=k)
    if kw.pop("grey", False):
        im = im[..., 1]
    if kw.get("bps") == 16:
        im = im.astype(np.int64) * 257 + k
    data = tiff_bytes(im, compression=5, old_lzw=True, **kw)
    path = _write(tmp_path, data)
    assert cv2.imread(str(path)) is not None
    assert_same(path)


def test_tiff_old_style_lzw_damaged_as_cv2(tmp_path):
    """Old-style strips cut short or with bytes replaced: what libtiff's
    compat decoder leaves (a failed strip keeps what it wrote)."""
    im = scene(40, 52, seed=9)
    data = tiff_bytes(im, compression=5, old_lzw=True, rows_per_strip=8)
    assert_cuts(tmp_path / "cut.tif", data, points=16)
    rng = np.random.default_rng(3)
    start, end = 8, len(data) - 200
    for _ in range(24):
        d = bytearray(data)
        for at in rng.integers(start, end, rng.integers(1, 4)):
            d[at] = int(rng.integers(256))
        assert_same(_write(tmp_path, bytes(d)))


@pytest.mark.parametrize("first_old", [True, False])
def test_tiff_lzw_mixed_styles_as_cv2(tmp_path, first_old):
    """Strips of both LZW styles in one file: the first strip decoded picks
    the decoder for every strip (LZWPreDecode switches to LZWDecodeCompat
    only while no strip has been decoded), so the other style's strips read
    as what the wrong decoder makes of them, as cv2."""
    from tests.test_torch_port_imageio_tiff import lzw_tiff

    im = scene(24, 30, seed=11)
    rows = [im[y:y + 8].tobytes() for y in range(0, 24, 8)]
    styles = [first_old, not first_old, first_old]
    path = _write(tmp_path, raw_tiff(30, 24, [lzw_tiff(r, s) for r, s in zip(rows, styles)], {
        258: (_SHORT, [8] * 3), 259: (_SHORT, [5]), 262: (_SHORT, [2]), 277: (_SHORT, [3]),
        278: (_LONG, [8])}))
    assert_same(path)


# --------------------------------------------------------------------------
# CIELab
# --------------------------------------------------------------------------

def _lab_tiff(px, bps, white=None, **kw):
    """CIELab samples as a TIFF: with a WhitePoint (two rationals) one
    little-endian strip, else through ``tiff_bytes`` and its options."""
    if white is None:
        return tiff_bytes(px, bps=bps, photometric=8, **kw)
    h, w = px.shape[:2]
    return raw_tiff(w, h, [px.astype("<u1" if bps == 8 else "<u2").tobytes()], {
        258: (_SHORT, [bps] * 3), 259: (_SHORT, [1]), 262: (_SHORT, [8]), 277: (_SHORT, [3]),
        278: (_LONG, [h]), 318: (_RATIONAL, list(white))})


def test_tiff_cielab8_every_triple_as_cv2(tmp_path):
    """Every 8-bit (L*, a*, b*) triple (16,777,216 pixels) under the default
    D50 white point: the same RGB as cv2, colour and grey."""
    lab = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    path = _write(tmp_path, raw_tiff(4096, 4096, [lab.tobytes()], {
        258: (_SHORT, [8] * 3), 259: (_SHORT, [1]), 262: (_SHORT, [8]), 277: (_SHORT, [3]),
        278: (_LONG, [4096])}))
    assert_same(path)


_LAB = [dict(bps=8), dict(bps=16), dict(bps=8, white=(3127, 10000, 3290, 10000)),
        dict(bps=16, white=(3457, 10000, 3585, 10000)), dict(bps=8, white=(1, 3, 1, 3)),
        dict(bps=8, tile=(16, 16)), dict(bps=16, tile=(16, 32)), dict(bps=8, rows_per_strip=4),
        dict(bps=8, compression=5), dict(bps=16, compression=8, predictor=2),
        dict(bps=16, big_endian=True), dict(bps=8, orientation=3),
        dict(bps=8, white=(3127, 10000, 0, 10000)), dict(bps=16, white=(0, 1, 1, 1))]


@pytest.mark.parametrize("k", range(len(_LAB)))
def test_tiff_cielab_decodes_as_cv2(tmp_path, k):
    """8- and 16-bit CIELab (random samples) with WhitePoint tags (y = 0:
    None), in strips and clipped tiles, LZW and Deflate, big-endian, flipped."""
    kw = dict(_LAB[k])
    bps = kw.pop("bps")
    px = np.random.default_rng(k).integers(0, 1 << bps, (27, 35, 3))
    assert_same(_write(tmp_path, _lab_tiff(px, bps, **kw)))


def test_tiff_pillow_lab_decodes_as_cv2(tmp_path):
    """Pillow's LAB TIFFs of scenes, raw and LZW."""
    for seed, compression in ((1, "raw"), (2, "tiff_lzw")):
        buf = io.BytesIO()
        Image.fromarray(scene(31, 45, seed=seed)).convert("LAB").save(
            buf, "TIFF", compression=compression)
        assert_same(_write(tmp_path, buf.getvalue()))


# --------------------------------------------------------------------------
# SGILog
# --------------------------------------------------------------------------

def _plane_runs(plane):
    """One byte plane of a row as tif_luv.c's encoder writes it: runs of 3
    or more equal bytes (128 + count - 2, the byte), else literal spans."""
    out, i, n = bytearray(), 0, len(plane)
    while i < n:
        j = i
        while j + 1 < n and plane[j + 1] == plane[i] and j - i < 128:
            j += 1
        if j - i >= 2:
            out += bytes([128 + j - i + 1 - 2, plane[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and plane[j] == plane[j + 1] == plane[j + 2]):
            j += 1
        out += bytes([j - i]) + bytes(plane[i:j])
        i = j
    return bytes(out)


def sgilog_rows(values, luv):
    """SGILog rows of 16-bit LogL or 32-bit LogLuv values [rows, width]."""
    nbytes = 4 if luv else 2
    out = b""
    for row in np.asarray(values, np.uint64):
        for k in range(nbytes - 1, -1, -1):
            out += _plane_runs((row >> np.uint64(8 * k) & np.uint64(255)).astype(np.uint8))
    return out


def sgilog_tiff(values, luv, rows_per_strip=None, tile=None, orientation=None):
    """A LogLuv (``luv``) or LogL TIFF in SGILog of ``values`` [h, w]."""
    h, w = values.shape
    tags = {258: (_SHORT, [16] * (3 if luv else 1)), 259: (_SHORT, [34676]),
            262: (_SHORT, [32845 if luv else 32844]), 277: (_SHORT, [3 if luv else 1]),
            339: (_SHORT, [2] * (3 if luv else 1))}
    if orientation:
        tags[274] = (_SHORT, [orientation])
    if tile:
        tw, th = tile
        tags.update({322: (_LONG, [tw]), 323: (_LONG, [th])})
        chunks = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                part = np.zeros((th, tw), np.uint64)
                v = values[y:y + th, x:x + tw]
                part[:v.shape[0], :v.shape[1]] = v
                chunks.append(sgilog_rows(part, luv))
        return raw_tiff(w, h, chunks, tags, tiled=True)
    rps = rows_per_strip or h
    tags[278] = (_LONG, [rps])
    return raw_tiff(w, h, [sgilog_rows(values[y:y + rps], luv) for y in range(0, h, rps)], tags)


def _log_values(rng, shape, luv):
    le = rng.integers(0x3000, 0x4400, shape).astype(np.uint64)  # luminances near 1
    sign = (rng.random(shape) < 0.05).astype(np.uint64) << np.uint64(15)
    le[rng.random(shape) < 0.05] = 0
    v = le | sign
    if luv:
        uv = rng.integers(60, 200, shape + (2,)).astype(np.uint64)
        v = v << np.uint64(16) | uv[..., 0] << np.uint64(8) | uv[..., 1]
    return v


@pytest.mark.parametrize("k", range(6))
def test_tiff_cv2_sgilog_decodes_as_cv2(tmp_path, k):
    """cv2.imwrite's SGILog TIFFs (IMWRITE_TIFF_COMPRESSION 34676) of float
    colour (LogLuv) and grey (LogL): scenes, random luminances, negatives."""
    rng = np.random.default_rng(k)
    f = [scene(40, 52, seed=k).astype(np.float32) / 200,
         np.exp(rng.normal(-1, 1.5, (23, 31, 3))).astype(np.float32),
         rng.normal(0, 1, (23, 31, 3)).astype(np.float32),
         scene(40, 52, seed=k)[..., 0].astype(np.float32) / 255,
         np.exp(rng.normal(0, 3, (17, 19))).astype(np.float32),
         (rng.random((64, 80, 3)) * 4).astype(np.float32)][k]
    path = tmp_path / "x.tif"
    assert cv2.imwrite(str(path), f, [cv2.IMWRITE_TIFF_COMPRESSION, 34676])
    assert cv2.imread(str(path)) is not None
    assert_same(path)


_SGILOG = [dict(luv=True), dict(luv=False), dict(luv=True, rows_per_strip=3),
           dict(luv=False, rows_per_strip=4), dict(luv=True, tile=(16, 16)),
           dict(luv=False, tile=(32, 16)), dict(luv=True, orientation=2)]


@pytest.mark.parametrize("k", range(len(_SGILOG)))
def test_tiff_sgilog_writer_decodes_as_cv2(tmp_path, k):
    """LogLuv and LogL of this module's run-length writer in strips and
    clipped tiles, signs and zero luminances included."""
    kw = dict(_SGILOG[k])
    luv = kw.pop("luv")
    values = _log_values(np.random.default_rng(k), (27, 37), luv)
    assert_same(_write(tmp_path, sgilog_tiff(values, luv, **kw)))


def sgilog24_tiff(values, rows_per_strip=None, tile=None):
    """A LogLuv TIFF in SGILog24 (3 bytes a pixel: 10-bit log luminance,
    14-bit uv index) of ``values`` [h, w] < 2^24."""
    h, w = values.shape
    tags = {258: (_SHORT, [16] * 3), 259: (_SHORT, [34677]), 262: (_SHORT, [32845]),
            277: (_SHORT, [3]), 339: (_SHORT, [2] * 3)}

    def raw(v):
        v = np.asarray(v, np.uint32)
        return np.stack([v >> 16 & 255, v >> 8 & 255, v & 255], -1).astype(np.uint8).tobytes()
    if tile:
        tw, th = tile
        tags.update({322: (_LONG, [tw]), 323: (_LONG, [th])})
        chunks = []
        for y in range(0, h, th):
            for x in range(0, w, tw):
                part = np.zeros((th, tw), np.uint32)
                v = values[y:y + th, x:x + tw]
                part[:v.shape[0], :v.shape[1]] = v
                chunks.append(raw(part))
        return raw_tiff(w, h, chunks, tags, tiled=True)
    rps = rows_per_strip or h
    tags[278] = (_LONG, [rps])
    return raw_tiff(w, h, [raw(values[y:y + rps]) for y in range(0, h, rps)], tags)


def test_tiff_sgilog24_every_value_as_cv2(tmp_path):
    """Every 24-bit LogLuv24 value (4096 x 4096 pixels: each luminance with
    each uv index, the 95 indices past the table's end included)."""
    values = np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096)
    assert_same(_write(tmp_path, sgilog24_tiff(values)))


def test_tiff_sgilog24_decodes_as_cv2(tmp_path):
    """SGILog24 in strips and clipped tiles, cv2.imwrite's files, and files
    cut short or with bytes replaced (a row short of data leaves it and the
    strip's later rows unwritten)."""
    rng = np.random.default_rng(24)
    values = rng.integers(0, 1 << 24, (27, 37)).astype(np.uint32)
    for kw in (dict(rows_per_strip=5), dict(tile=(16, 16))):
        data = sgilog24_tiff(values, **kw)
        assert_same(_write(tmp_path, data))
        assert_cuts(tmp_path / "cut.tif", data, points=8)
    data = sgilog24_tiff(values, rows_per_strip=4)
    for _ in range(8):
        d = bytearray(data)
        for at in rng.integers(8, len(d) - 200, rng.integers(1, 4)):
            d[at] = int(rng.integers(256))
        assert_same(_write(tmp_path, bytes(d)))
    for f in (scene(23, 31, seed=2).astype(np.float32) / 150,
              np.exp(rng.normal(0, 2, (19, 29, 3))).astype(np.float32)):
        path = tmp_path / "w.tif"
        assert cv2.imwrite(str(path), f, [cv2.IMWRITE_TIFF_COMPRESSION, 34677])
        assert_same(path)


def test_tiff_sgilog_damaged_as_cv2(tmp_path):
    """SGILog strips cut short or with bytes replaced: a row short of data
    leaves it and the strip's later rows unwritten, as tif_luv.c."""
    rng = np.random.default_rng(5)
    for luv in (True, False):
        data = sgilog_tiff(_log_values(rng, (24, 30), luv), luv, rows_per_strip=6)
        assert_cuts(tmp_path / "cut.tif", data, points=10)
        for _ in range(12):
            d = bytearray(data)
            for at in rng.integers(8, len(d) - 200, rng.integers(1, 4)):
                d[at] = int(rng.integers(256))
            assert_same(_write(tmp_path, bytes(d)))
