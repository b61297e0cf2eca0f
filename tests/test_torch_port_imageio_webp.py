"""WebP files against ``cv2.imread``, byte for byte in colour (BGR) and
grayscale, read by ``fots_torch.imageio.imread`` (OpenCV 5.0's WebPDecoder
over libwebp 1.5):

- lossy (VP8) and lossless (VP8L) files of ``cv2.imencode`` at qualities
  1-101 and of Pillow's libwebp (methods 0-6, ``exact``, palettes of 2 to 256
  colours for pixel bundling at 1, 2 and 4 bits, many colours for the colour
  cache, a window that uses every predictor mode, the cross-colour and
  subtract-green transforms and a meta prefix image), odd sizes and single
  rows and columns (the upsampler's edges);
- VP8 key frames of this module's own writer (``vp8_frame``) for what no
  encoder here writes: the simple loop filter, every sharpness, segment maps
  with absolute and delta quantisers and filter levels, mode / ref filter
  deltas, 2, 4 and 8 token partitions, skipped macroblocks;
- alpha (VP8X + ALPH): Pillow's lossless-coded planes, their filter and
  pre-processing bits edited, and raw planes under each filter written
  here; the decoded alpha plane against ``cv2.IMREAD_UNCHANGED``'s;
- animations: ``cv2.imwriteanimation``'s (frame 0, which ``cv2.imread``
  reads) and frames written here at offsets on a canvas with an ANIM
  background colour (outside the frame: zeros);
- the EXIF orientation cv2 applies (VP8X EXIF flag, first EXIF chunk);
- raw VP8 and VP8L streams (cv2 reads them), files cut short and bit flips
  (a fixed seeded sample): None exactly where ``cv2`` gives None.

The port's ``eval_e2e -images_list`` over a lossless WebP and a PPM copy of
a scene gives the jpg's results, and ``fots.data.detection``'s reader and
the port's give byte-equal samples over a list of WebP, PPM and PAM files.
"""

import io
import json
import os
import shutil
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from fots_torch import imageio
from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELDOUT_JPG = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_jpg")


def assert_same(path, unchanged=False):
    """imread equals cv2.imread in both modes, None included; with
    ``unchanged``, the decoded BGRA equals cv2.IMREAD_UNCHANGED's where cv2
    gives four channels."""
    for gray in (False, True):
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        got = imread(str(path), grayscale=gray)
        if want is None or got is None:
            assert want is None and got is None, (path, gray, want is None)
            continue
        assert got.dtype == np.uint8 and got.shape == want.shape, (path, gray, got.shape)
        assert np.array_equal(got, want), (path, gray, int((got != want).sum()))
    if unchanged:
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert want is not None and want.ndim == 3 and want.shape[2] == 4, path
        got, _ = imageio._decode_webp(path.read_bytes(), False, str(path), bgra=True)
        assert np.array_equal(got, want), (path, int((got != want).sum()))


def write(tmp_path, data, name="x.webp"):
    path = tmp_path / name
    path.write_bytes(data)
    return path


def window(h, w, y=120, x=200, k=0):
    """A window of a held-out scene (BGR)."""
    im = cv2.imread(os.path.join(HELDOUT_JPG, f"img_11{2 + k}.jpg"))
    return np.ascontiguousarray(im[y:y + h, x:x + w])


def pil_webp(bgr_or_bgra, **kw) -> bytes:
    im = np.ascontiguousarray(bgr_or_bgra[..., [2, 1, 0, 3][:bgr_or_bgra.shape[2]]])
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, "WEBP", **kw)
    return buf.getvalue()


def cv2_webp(im, quality) -> bytes:
    ok, enc = cv2.imencode(".webp", im, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return enc.tobytes()


# --------------------------------------------------------------------------
# the container
# --------------------------------------------------------------------------

def chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def vp8x(flags: int, w: int, h: int) -> bytes:
    """flags: 0x02 animation, 0x04 XMP, 0x08 EXIF, 0x10 alpha, 0x20 ICC."""
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + u24(w - 1) + u24(h - 1))


def anim(bgra=(10, 20, 30, 255), loops=0) -> bytes:
    return chunk(b"ANIM", bytes(bgra) + struct.pack("<H", loops))


def anmf(x, y, w, h, payload, duration=100, flags=0) -> bytes:
    return chunk(b"ANMF", u24(x // 2) + u24(y // 2) + u24(w - 1) + u24(h - 1) + u24(duration)
                 + bytes([flags]) + payload)


def chunks_of(data: bytes):
    """[(tag, body)] after a RIFF header."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def exif_orientation(o: int, big_endian=False) -> bytes:
    e = ">" if big_endian else "<"
    return ((b"MM\0*" if big_endian else b"II*\0") + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x112, 3, 1, o, 0) + struct.pack(e + "I", 0))


# --------------------------------------------------------------------------
# a VP8 key-frame writer (RFC 6386): the boolean encoder of section 7.3,
# every token probability set by an update, 16x16 modes and all-DC 4x4
# macroblocks (whose mode contexts stay at DC), random coefficients
# --------------------------------------------------------------------------

class BoolWriter:
    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xffffffff
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1, 128)

    def signed(self, v, n):
        self.value(abs(v), n)
        self.put(int(v < 0), 128)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xffffffff
        for _ in range(c >> 3):
            v = (v << 8) & 0xffffffff
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xffffffff
        return bytes(self.out)


#: RFC 6386 13.4, the coefficient update probabilities: {first index: run}
#: of the entries other than 255
_UPDATE_RUNS = {
    33: (176, 246), 44: (223, 241, 252), 55: (249, 253, 253), 67: (244, 252),
    77: (234, 254, 254), 88: (253,), 100: (246, 254), 110: (239, 253, 254), 121: (254,),
    123: (254,), 133: (248, 254), 143: (251,), 145: (254,), 166: (253, 254),
    176: (251, 254, 254), 187: (254,), 189: (254,), 199: (254, 253), 202: (254,), 209: (250,),
    211: (254,), 213: (254,), 220: (254,), 264: (217,), 275: (225, 252, 241, 253), 281: (254,),
    286: (234, 250, 241, 250, 253), 292: (253, 254), 298: (254,), 308: (223, 254, 254),
    319: (238, 253, 254, 254), 331: (248, 254), 341: (249, 254), 364: (253,), 374: (247, 254),
    397: (253, 254), 407: (252,), 430: (254, 254), 440: (253,), 463: (254, 253), 473: (250,),
    484: (254,), 528: (186, 251, 250), 539: (234, 251, 244, 254),
    550: (251, 251, 243, 253, 254), 556: (254,), 562: (253, 254), 572: (236, 253, 254),
    583: (251, 253, 253, 254, 254), 595: (254, 254), 605: (254, 254, 254), 628: (254,),
    638: (254, 254), 649: (254,), 671: (254,), 792: (248,), 803: (250, 254, 252, 254),
    814: (248, 254, 249, 253), 826: (253, 253), 836: (246, 253, 253),
    847: (252, 254, 251, 254, 254), 859: (254, 252), 869: (248, 254, 253), 880: (253,),
    882: (254, 254), 892: (251, 254), 902: (245, 251, 254), 913: (253, 253, 254),
    925: (251, 253), 935: (252, 253, 254), 947: (254,), 958: (252,), 968: (249,), 970: (254,),
    981: (254,), 992: (253,), 1001: (250,), 1034: (254,)}
UPDATE_PROBA = [255] * 1056
for _start, _run in _UPDATE_RUNS.items():
    UPDATE_PROBA[_start:_start + len(_run)] = _run
#: the categories 3-6 of large coefficients: extra-bit probabilities
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _write_large(e, a, p):
    if a == 2:
        e.put(0, p[3]), e.put(0, p[4])
    elif a <= 4:
        e.put(0, p[3]), e.put(1, p[4]), e.put(a - 3, p[5])
    elif a <= 6:
        e.put(1, p[3]), e.put(0, p[6]), e.put(0, p[7]), e.put(a - 5, 159)
    elif a <= 10:
        e.put(1, p[3]), e.put(0, p[6]), e.put(1, p[7])
        e.put((a - 7) >> 1, 165), e.put((a - 7) & 1, 145)
    else:
        cat = 0 if a < 19 else 1 if a < 35 else 2 if a < 67 else 3
        e.put(1, p[3]), e.put(1, p[6]), e.put(cat >> 1, p[8]), e.put(cat & 1, p[9 + (cat >> 1)])
        v, probs = a - (3 + (8 << cat)), _CATS[cat]
        for i, prob in enumerate(probs):
            e.put((v >> (len(probs) - 1 - i)) & 1, prob)


def _write_block(e, coeffs, first, p):
    """The tokens of one block's coefficients (zigzag order) from ``first``."""
    nz = [i for i in range(first, 16) if coeffs[i]]
    last = nz[-1] if nz else -1
    n, eob_ok = first, True
    while n < 16:
        if eob_ok:
            if n > last:
                e.put(0, p[0])
                return
            e.put(1, p[0])
        v = coeffs[n]
        if v == 0:
            e.put(0, p[1])
            n, eob_ok = n + 1, False
            continue
        e.put(1, p[1])
        if abs(v) == 1:
            e.put(0, p[2])
        else:
            e.put(1, p[2])
            _write_large(e, abs(v), p)
        e.put(int(v < 0), 128)
        n, eob_ok = n + 1, True


def vp8_frame(w, h, seed, *, simple=0, level=24, sharpness=0, segments=None, lf_delta=None,
              parts_log2=0, skip_prob=None, q=40, dq=(0, 0, 0, 0, 0), i4x4_share=0.0,
              amplitude=24) -> bytes:
    """A VP8 key frame of random modes and coefficients.  ``segments``:
    dict(update_map, absolute, quant[4], strength[4], probs[3]);
    ``lf_delta``: dict(ref[4], mode[4])."""
    rng = np.random.default_rng(seed)
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    token_p = [int(v) for v in rng.integers(90, 250, 11)]
    e = BoolWriter()
    e.put(0, 128), e.put(0, 128)  # colour space, clamping type
    e.put(int(segments is not None), 128)
    if segments is not None:
        e.put(int(segments["update_map"]), 128)
        e.put(1, 128)
        e.put(int(segments["absolute"]), 128)
        for v in segments["quant"]:
            e.put(1, 128), e.signed(v, 7)
        for v in segments["strength"]:
            e.put(1, 128), e.signed(v, 6)
        if segments["update_map"]:
            for prob in segments["probs"]:
                e.put(1, 128), e.value(prob, 8)
    e.put(simple, 128), e.value(level, 6), e.value(sharpness, 3)
    e.put(int(lf_delta is not None), 128)
    if lf_delta is not None:
        e.put(1, 128)
        for v in list(lf_delta["ref"]) + list(lf_delta["mode"]):
            e.put(1, 128), e.signed(v, 6)
    e.value(parts_log2, 2)
    e.value(q, 7)
    for d in dq:
        e.put(int(d != 0), 128)
        if d:
            e.signed(d, 4)
    e.put(0, 128)  # refresh entropy probabilities
    for i in range(1056):
        e.put(1, UPDATE_PROBA[i]), e.value(token_p[i % 11], 8)
    e.put(int(skip_prob is not None), 128)
    if skip_prob is not None:
        e.value(skip_prob, 8)
    parts = [BoolWriter() for _ in range(1 << parts_log2)]
    any_i4x4 = i4x4_share > 0
    for mb_y in range(mbh):
        tokens = parts[mb_y & ((1 << parts_log2) - 1)]
        for _ in range(mbw):
            if segments is not None and segments["update_map"]:
                s = int(rng.integers(0, 4))
                pr = segments["probs"]
                e.put(s >> 1, pr[0])
                e.put(s & 1, pr[1] if s < 2 else pr[2])
            skip = skip_prob is not None and rng.random() < 0.3
            if skip_prob is not None:
                e.put(int(skip), skip_prob)
            i4x4 = rng.random() < i4x4_share
            e.put(int(not i4x4), 145)
            if i4x4:
                for _ in range(16):
                    e.put(0, 231)  # B_DC_PRED under DC contexts
            else:
                ymode = int(rng.integers(0, 4)) if not any_i4x4 else 0  # DC, V, H, TM
                e.put(ymode >> 1, 156)
                e.put(ymode & 1, 128 if ymode >> 1 else 163)
            uvmode = int(rng.integers(0, 4))  # DC, V, H, TM
            e.put(int(uvmode > 0), 142)
            if uvmode:
                e.put(int(uvmode > 1), 114)
                if uvmode > 1:
                    e.put(int(uvmode == 3), 183)
            if skip:
                continue
            blocks = ([] if i4x4 else [0]) + [0 if not i4x4 else 3] * 16 + [2] * 8
            for k, _t in enumerate(blocks):
                sparse = rng.random(16) < 0.35
                c = np.where(sparse, rng.integers(-amplitude, amplitude + 1, 16), 0)
                c[rng.random(16) < 0.01] = int(rng.integers(60, 900))
                first = 1 if (not i4x4 and 0 < k <= 16) else 0
                _write_block(tokens, [int(v) for v in c], first, token_p)
    first_part = e.flush()
    token_parts = [t.flush() for t in parts]
    tag = (0 | (0 << 1) | (1 << 4) | (len(first_part) << 5))
    head = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", w, h)
    sizes = b"".join(struct.pack("<I", len(t))[:3] for t in token_parts[:-1])
    return head + first_part + sizes + b"".join(token_parts)


# --------------------------------------------------------------------------
# lossy and lossless files of the encoders here
# --------------------------------------------------------------------------

QUALITIES = (1, 5, 10, 20, 30, 40, 50, 60, 70, 75, 80, 85, 90, 95, 98, 100, 101)


@pytest.mark.parametrize("quality", QUALITIES)
def test_cv2_webp_reads_as_cv2(tmp_path, quality):
    """cv2.imencode at qualities 1-100 (VP8) and 101 (VP8L) of a 53x37
    scene window and a 37x53 synthetic one."""
    for k, im in enumerate((window(53, 37, k=1), scene(37, 53, seed=quality))):
        assert_same(write(tmp_path, cv2_webp(im, quality), f"q{k}.webp"))


@pytest.mark.parametrize("size", [(1, 1), (1, 37), (37, 1), (2, 3), (17, 33), (31, 2), (64, 96)])
def test_odd_sizes_read_as_cv2(tmp_path, size):
    """The upsampler's edges: single rows and columns, odd sides, lossy and
    lossless."""
    h, w = size
    im = window(h, w, k=2)
    for quality in (30, 90, 101):
        assert_same(write(tmp_path, cv2_webp(im, quality), f"s{quality}.webp"))


@pytest.mark.parametrize("method", range(7))
def test_pillow_methods_read_as_cv2(tmp_path, method):
    """Pillow's libwebp 1.6 at each method, lossy and lossless, with and
    without alpha (lossless-coded alpha at a few alpha qualities)."""
    rng = np.random.default_rng(method)
    bgr = window(45, 61, k=method % 4)
    alpha = rng.integers(0, 256, bgr.shape[:2], np.uint8)
    alpha[::3] = 255
    bgra = np.dstack([bgr, alpha])
    for k, kw in enumerate((dict(quality=12 * method + 5), dict(lossless=True, quality=15 * method),
                            dict(quality=80, alpha_quality=15 * method + 5))):
        for src in (bgr, bgra):
            path = write(tmp_path, pil_webp(src, method=method, **kw), f"m{k}{src.shape[2]}.webp")
            assert_same(path, unchanged=src.shape[2] == 4)


def test_exact_keeps_colour_under_transparent_alpha(tmp_path):
    """``exact``: the RGB under alpha 0 is stored and read back as stored;
    colour equals IMREAD_UNCHANGED's first three channels."""
    bgr = window(30, 40)
    alpha = np.zeros(bgr.shape[:2], np.uint8)
    alpha[:, 20:] = 255
    path = write(tmp_path, pil_webp(np.dstack([bgr, alpha]), lossless=True, exact=True))
    assert_same(path, unchanged=True)
    assert np.array_equal(imread(str(path)), bgr)
    assert np.array_equal(imread(str(path)), cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., :3])


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 11, 16, 17, 256])
def test_palettes_read_as_cv2(tmp_path, colours):
    """Colour indexing: pixels bundled 8, 4 and 2 to a byte for 2, 4 and 16
    colours, none past 16."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 3), np.uint8)
    for h, w in ((29, 43), (8, 128)):
        im = pal[rng.integers(0, colours, (h, w))]
        assert_same(write(tmp_path, pil_webp(im, lossless=True), f"p{w}.webp"))
        blocky = pal[np.repeat(np.repeat(rng.integers(0, colours, (h // 4 + 1, w // 4 + 1)), 4, 0),
                               4, 1)[:h, :w]]
        assert_same(write(tmp_path, pil_webp(blocky, lossless=True, method=3), f"b{w}.webp"))


@pytest.mark.parametrize("case", ["predictors", "colour_cache", "meta_codes"])
def test_vp8l_transforms_and_cache_read_as_cv2(tmp_path, case):
    """A 128x192 scene window at method 6 (predictor modes 1-13,
    cross-colour, subtract-green, a meta prefix image), 300 colours at random
    (a 10-bit colour cache), and a 256x384 window at method 4 (a meta image
    of 8-pixel tiles)."""
    rng = np.random.default_rng(3)
    if case == "predictors":
        data = pil_webp(window(128, 192, y=100), lossless=True, method=6, quality=100)
    elif case == "colour_cache":
        pal = rng.integers(0, 256, (300, 3), np.uint8)
        data = pil_webp(pal[rng.integers(0, 300, (48, 64))], lossless=True, method=6, quality=100)
    else:
        data = pil_webp(window(256, 384, y=100), lossless=True, method=4, quality=50)
    assert_same(write(tmp_path, data))


# --------------------------------------------------------------------------
# VP8 features no encoder here writes
# --------------------------------------------------------------------------

VP8_CASES = {
    "simple_filter": dict(simple=1, level=30),
    "simple_filter_i4x4": dict(simple=1, level=45, i4x4_share=0.5, sharpness=3),
    "normal_filter_i4x4": dict(level=40, i4x4_share=0.4),
    "no_filter": dict(level=0),
    "strong_filter": dict(level=63, amplitude=60),
    "segments_absolute": dict(segments=dict(update_map=1, absolute=1, quant=(5, 40, 80, 127),
                                            strength=(0, 20, 40, 63), probs=(120, 60, 200))),
    "segments_delta": dict(segments=dict(update_map=1, absolute=0, quant=(-20, -5, 10, 30),
                                         strength=(-10, 5, 0, 20), probs=(90, 170, 30)),
                           simple=1, level=20),
    "segments_no_map": dict(segments=dict(update_map=0, absolute=0, quant=(7, 0, 0, 0),
                                          strength=(9, 0, 0, 0), probs=())),
    "lf_deltas": dict(lf_delta=dict(ref=(12, -3, 5, 0), mode=(-20, 4, 0, 9)), i4x4_share=0.3),
    "lf_deltas_simple": dict(simple=1, lf_delta=dict(ref=(-30, 0, 0, 0), mode=(25, 0, 0, 0)),
                             i4x4_share=0.3, level=35),
    "partitions_2": dict(parts_log2=1),
    "partitions_4_skip": dict(parts_log2=2, skip_prob=90),
    "partitions_8_skip_simple": dict(parts_log2=3, skip_prob=200, simple=1),
    "quant_deltas": dict(q=90, dq=(-3, 5, -7, 2, 6)),
    "quant_extremes": dict(q=127, dq=(7, 7, 7, 7, 7), amplitude=120),
}
VP8_CASES.update({f"sharpness_{s}": dict(sharpness=s, level=20 + 6 * s, simple=s % 2,
                                         i4x4_share=0.25) for s in range(8)})


@pytest.mark.parametrize("case", sorted(VP8_CASES))
def test_vp8_written_here_reads_as_cv2(tmp_path, case):
    """Key frames of ``vp8_frame``: the simple and normal loop filters at
    every sharpness, segment maps with absolute and delta quantisers and
    levels, mode / ref deltas, 2-8 token partitions, skipped macroblocks; at
    odd sizes."""
    for k, (w, h) in enumerate(((45, 37), (64, 33))):
        data = riff([chunk(b"VP8 ", vp8_frame(w, h, seed=k + len(case), **VP8_CASES[case]))])
        path = write(tmp_path, data, f"{k}.webp")
        assert cv2.imread(str(path)) is not None, case
        assert_same(path)


def test_vp8_written_here_damaged_as_cv2(tmp_path):
    """Frames of ``vp8_frame`` cut in partition 0 and in each token
    partition, and with bad partition sizes: None where cv2 gives None."""
    frame = vp8_frame(48, 40, seed=7, parts_log2=2, skip_prob=120)
    first = struct.unpack("<I", frame[:3] + b"\0")[0] >> 5
    cuts = [14, 10 + first // 2, 10 + first, 10 + first + 9] + [
        int(len(frame) * f) for f in (0.7, 0.85, 0.95, 0.99)]
    for k, cut in enumerate(cuts):
        assert_same(write(tmp_path, riff([chunk(b"VP8 ", frame[:cut])]), f"c{k}.webp"))
    bad = bytearray(frame)
    bad[10 + first:13 + first] = b"\xff\xff\x0f"  # partition 1 past the end
    assert_same(write(tmp_path, riff([chunk(b"VP8 ", bytes(bad))]), "p.webp"))
    too_long = bytearray(frame)
    too_long[:3] = struct.pack("<I", (len(frame) << 5) | (1 << 4))[:3]  # partition 0 too long
    assert_same(write(tmp_path, riff([chunk(b"VP8 ", bytes(too_long))]), "l.webp"))


# --------------------------------------------------------------------------
# alpha
# --------------------------------------------------------------------------

def _filtered(alpha, method):
    """The deltas of libwebp's alpha filters (0 none, 1 horizontal, 2
    vertical, 3 gradient) of a u8 plane."""
    a = alpha.astype(np.int32)
    if method == 0:
        return alpha.copy()
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:] = a[:-1]
    else:
        pred[1:, 0] = a[:-1, 0]
        g = a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1]
        pred[1:, 1:] = np.clip(g, 0, 255)
    return ((a - pred) & 0xff).astype(np.uint8)


def _alpha_file(bgr, header_byte, plane_bytes, lossy_quality=70):
    h, w = bgr.shape[:2]
    vp8 = dict(chunks_of(cv2_webp(bgr, lossy_quality)))[b"VP8 "]
    return riff([vp8x(0x10, w, h), chunk(b"ALPH", bytes([header_byte]) + plane_bytes),
                 chunk(b"VP8 ", vp8)])


@pytest.mark.parametrize("filt", range(4))
def test_raw_alpha_filters_read_as_cv2(tmp_path, filt):
    """Raw (uncompressed) ALPH planes under each filter, with and without the
    level-reduction bit: colour as cv2, alpha as IMREAD_UNCHANGED's."""
    bgr = window(27, 35, k=filt)
    rng = np.random.default_rng(filt)
    alpha = np.clip(np.add.outer(np.arange(27) * 9, np.arange(35) * 7) % 256
                    + rng.integers(-20, 20, (27, 35)), 0, 255).astype(np.uint8)
    for pre in (0, 1):
        data = _alpha_file(bgr, filt << 2 | pre << 4, _filtered(alpha, filt).tobytes())
        path = write(tmp_path, data, f"a{pre}.webp")
        assert_same(path, unchanged=True)
        assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., 3], alpha)


@pytest.mark.parametrize("filt", range(4))
def test_lossless_alpha_filter_bits_read_as_cv2(tmp_path, filt):
    """Pillow's VP8L-coded ALPH plane with its filter and pre-processing
    bits rewritten: the same deltas read under each filter."""
    rng = np.random.default_rng(filt)
    bgra = np.dstack([window(33, 47, k=1), rng.integers(0, 256, (33, 47), np.uint8)])
    data = pil_webp(bgra, quality=75, alpha_quality=100)
    at = data.index(b"ALPH") + 8
    for pre in (0, 1):
        d = bytearray(data)
        d[at] = (d[at] & 0x03) | filt << 2 | pre << 4
        assert_same(write(tmp_path, bytes(d), f"f{pre}.webp"), unchanged=True)


def test_damaged_alpha_is_none_as_cv2(tmp_path):
    """An ALPH chunk cut short, with a bad method, reserved bits or
    pre-processing value, or a raw plane too short, fails the image in
    colour and grey as libwebp fails it; a plane with trailing bytes reads."""
    bgr = window(20, 24)
    bgra = np.dstack([bgr, np.arange(480, dtype=np.uint8).reshape(20, 24)])
    good = pil_webp(bgra, quality=60)
    at = good.index(b"ALPH")
    n = struct.unpack("<I", good[at + 4:at + 8])[0]
    body = good[at + 8:at + 8 + n]
    rest = [(t, b) for t, b in chunks_of(good) if t == b"VP8 "]
    variants = {"cut": body[:len(body) // 2], "one_byte": body[:1],
                "method_2": bytes([body[0] | 2]) + body[1:],
                "reserved": bytes([body[0] | 0x40]) + body[1:],
                "pre_2": bytes([body[0] | 0x20]) + body[1:],
                "raw_short": bytes([0]) + bytes(479), "raw_long": bytes([0]) + bytes(490),
                "flipped": body[:5] + bytes([body[5] ^ 0x10]) + body[6:]}
    for name, alph in variants.items():
        data = riff([vp8x(0x10, 24, 20), chunk(b"ALPH", alph)] + [chunk(t, b) for t, b in rest])
        assert_same(write(tmp_path, data, f"{name}.webp"))


# --------------------------------------------------------------------------
# animations
# --------------------------------------------------------------------------

def test_cv2_animation_first_frame_as_imreadanimation(tmp_path):
    """cv2.imread of a three-frame cv2.imwriteanimation WebP is frame 0 of
    cv2.imreadanimation, and no other frame; the port reads the same."""
    rng = np.random.default_rng(0)
    frames = [scene(23, 37, seed=k) for k in range(3)]
    frames[1][:] = rng.integers(0, 256, frames[1].shape, np.uint8)
    for quality in (80, 101):
        a = cv2.Animation()
        a.frames, a.durations = frames, [100, 100, 100]
        path = tmp_path / f"a{quality}.webp"
        assert cv2.imwriteanimation(str(path), a, [cv2.IMWRITE_WEBP_QUALITY, quality])
        ok, read = cv2.imreadanimation(str(path))
        assert ok and len(read.frames) == 3
        first = cv2.imread(str(path))
        assert np.array_equal(first, read.frames[0][..., :3])
        assert not np.array_equal(first, read.frames[1][..., :3])
        assert_same(path)


def test_pillow_animations_read_as_cv2(tmp_path):
    rng = np.random.default_rng(2)
    ims = [Image.fromarray(rng.integers(0, 256, (31, 45, 4), np.uint8)) for _ in range(3)]
    for k, kw in enumerate((dict(lossless=True), dict(quality=70), dict(quality=60,
                                                                          minimize_size=True))):
        buf = io.BytesIO()
        ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:], duration=50, **kw)
        assert_same(write(tmp_path, buf.getvalue(), f"{k}.webp"))


@pytest.mark.parametrize("offset", [(0, 0), (4, 2), (16, 10), (0, 10)])
def test_animation_frame_at_offset_reads_as_cv2(tmp_path, offset):
    """A first frame (lossy + ALPH, or lossless) smaller than the canvas at
    an offset, under an ANIM background colour: the canvas outside the frame
    reads as zeros (the background colour does not enter), inside it the
    frame's BGR, alpha dropped."""
    x, y = offset
    rng = np.random.default_rng(x + y)
    bgra = np.dstack([window(10, 14), rng.integers(0, 256, (10, 14), np.uint8)])
    lossy = pil_webp(bgra, quality=70)
    frames = {"lossy": b"".join(chunk(t, b) for t, b in chunks_of(lossy)
                                if t in (b"ALPH", b"VP8 ")),
              "lossless": chunk(b"VP8L", dict(chunks_of(pil_webp(bgra, lossless=True)))[b"VP8L"])}
    for name, payload in frames.items():
        data = riff([vp8x(0x12, 30, 20), anim((10, 20, 30, 255)), anmf(x, y, 14, 10, payload),
                     anmf(0, 0, 14, 10, payload)])
        path = write(tmp_path, data, f"{name}.webp")
        assert_same(path)
        got = imread(str(path))
        outside = np.ones((20, 30), bool)
        outside[y:y + 10, x:x + 14] = False
        assert not got[outside].any()
        single = write(tmp_path, riff([chunk(t, b) for t, b in chunks_of(
            lossy if name == "lossy" else pil_webp(bgra, lossless=True))]), "single.webp")
        assert np.array_equal(got[y:y + 10, x:x + 14], imread(str(single)))


def test_animation_damaged_as_cv2(tmp_path):
    """A first frame cut short, frames past the canvas, ANMF before ANIM, no
    frame, an image chunk beside the frames: None where cv2 gives None."""
    bgr = window(10, 14)
    vp8 = chunk(b"VP8 ", dict(chunks_of(cv2_webp(bgr, 80)))[b"VP8 "])
    head = [vp8x(0x02, 30, 20), anim()]
    cases = {"cut_frame": head + [anmf(0, 0, 14, 10, vp8[:len(vp8) // 2])],
             "past_canvas": head + [anmf(20, 12, 14, 10, vp8)],
             "anmf_first": [vp8x(0x02, 30, 20), anmf(0, 0, 14, 10, vp8), anim()],
             "no_frame": head,
             "image_beside": head + [anmf(0, 0, 14, 10, vp8), vp8],
             "second_bad": head + [anmf(0, 0, 14, 10, vp8), anmf(0, 0, 14, 10, vp8[:30])]}
    for name, chunks in cases.items():
        assert_same(write(tmp_path, riff(chunks), f"{name}.webp"))


# --------------------------------------------------------------------------
# the container, EXIF, raw streams
# --------------------------------------------------------------------------

def test_exif_orientation_applied_as_cv2(tmp_path):
    """cv2 applies the orientation of the first EXIF chunk of a VP8X file
    whose EXIF flag is set (and that WebPDemux accepts), in either byte
    order, wherever the chunk lies; not without the flag, not in a file the
    demuxer rejects."""
    bgr = window(20, 30)
    vp8 = chunk(b"VP8 ", dict(chunks_of(cv2_webp(bgr, 90)))[b"VP8 "])
    cases = {f"o{o}": [vp8x(0x08, 30, 20), vp8, chunk(b"EXIF", exif_orientation(o))]
             for o in range(1, 9)}
    cases.update({
        "big_endian": [vp8x(0x08, 30, 20), vp8, chunk(b"EXIF", exif_orientation(6, True))],
        "before_image": [vp8x(0x08, 30, 20), chunk(b"EXIF", exif_orientation(8)), vp8],
        "no_flag": [vp8x(0x00, 30, 20), vp8, chunk(b"EXIF", exif_orientation(6))],
        "first_wins": [vp8x(0x08, 30, 20), vp8, chunk(b"EXIF", exif_orientation(1)),
                       chunk(b"EXIF", exif_orientation(6))],
        "demux_rejects": [vp8x(0x08 | 0x80, 30, 20), vp8, chunk(b"EXIF", exif_orientation(6))],
        "two_vp8x": [vp8x(0x08, 30, 20), vp8x(0x08, 30, 20), vp8,
                     chunk(b"EXIF", exif_orientation(6))],
        "exif_header": [vp8x(0x08, 30, 20), vp8, chunk(b"EXIF", b"Exif\0\0" + exif_orientation(6))],
    })
    for name, chunks in cases.items():
        path = write(tmp_path, riff(chunks), f"{name}.webp")
        assert_same(path)
    assert imread(str(tmp_path / "o6.webp")).shape == (30, 20, 3)
    assert imread(str(tmp_path / "no_flag.webp")).shape == (20, 30, 3)


def test_container_variants_as_cv2(tmp_path):
    """Trailing bytes, odd chunk padding, ICCP / XMP / unknown chunks, a
    canvas that differs from the image, RIFF sizes past the file or below 12,
    files under 32 bytes, and raw VP8 and VP8L streams (which cv2 reads)."""
    bgr = window(21, 33)
    lossy, lossless = cv2_webp(bgr, 60), cv2_webp(bgr, 101)
    vp8 = dict(chunks_of(lossy))[b"VP8 "]
    vp8l = dict(chunks_of(lossless))[b"VP8L"]
    cases = {
        "trailing": lossy + b"trailing bytes",
        "extended": riff([vp8x(0x24, 33, 21), chunk(b"ICCP", b"icc"), chunk(b"ABCD", b"x"),
                          chunk(b"VP8L", vp8l), chunk(b"XMP ", b"<x/>")]),
        "canvas_differs": riff([vp8x(0, 34, 21), chunk(b"VP8 ", vp8)]),
        "riff_past_end": lossy[:4] + struct.pack("<I", len(lossy)) + lossy[8:],
        "riff_small": lossy[:4] + struct.pack("<I", 11) + lossy[8:],
        "chunk_past_riff": riff([chunk(b"VP8 ", vp8)])[:-10],
        "short": lossy[:31],
        "raw_vp8": vp8,
        "raw_vp8l": vp8l,
        "vp8l_version": riff([chunk(b"VP8L", vp8l[:4] + bytes([vp8l[4] | 0x20]) + vp8l[5:])]),
        "not_key_frame": riff([chunk(b"VP8 ", bytes([vp8[0] | 1]) + vp8[1:])]),
        "vp8x_no_image": riff([vp8x(0, 33, 21), chunk(b"ABCD", b"1234")]),
    }
    for name, data in cases.items():
        assert_same(write(tmp_path, data, f"{name}.jpg"))
    assert imread(str(tmp_path / "raw_vp8l.jpg")) is not None


# --------------------------------------------------------------------------
# cut and damaged files (a fixed seeded sample)
# --------------------------------------------------------------------------

def _damage_bases():
    bgr = window(41, 57, k=3)
    rng = np.random.default_rng(11)
    bgra = np.dstack([bgr, rng.integers(0, 256, bgr.shape[:2], np.uint8)])
    frames = [Image.fromarray(np.ascontiguousarray(f[..., ::-1])) for f in
              (bgr, window(41, 57, k=1), window(41, 57, k=2))]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40, quality=60)
    return {"lossy": cv2_webp(bgr, 75), "lossless": cv2_webp(bgr, 101),
            "lossy_alpha": pil_webp(bgra, quality=50),
            "lossless_alpha": pil_webp(bgra, lossless=True),
            "palette": pil_webp(bgr // 64 * 64, lossless=True),
            "written_here": riff([chunk(b"VP8 ", vp8_frame(40, 36, 5, parts_log2=1, simple=1,
                                                           skip_prob=100))]),
            "animation": buf.getvalue()}


@pytest.mark.parametrize("base", ["lossy", "lossless", "lossy_alpha", "lossless_alpha", "palette",
                                  "written_here", "animation"])
def test_cut_and_flipped_as_cv2(tmp_path, base):
    """Each base file cut at 24 seeded points and with 24 seeded sets of bit
    flips (past the RIFF header): None exactly where cv2 gives None, the
    same pixels elsewhere."""
    data = _damage_bases()[base]
    rng = np.random.default_rng(sum(map(ord, base)))
    for k in range(24):
        cut = data[:int(rng.integers(12, len(data)))]
        assert_same(write(tmp_path, cut, f"c{k}.webp"))
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(12, len(d)))
            d[i] ^= 1 << int(rng.integers(0, 8))
        assert_same(write(tmp_path, bytes(d), f"f{k}.webp"))


# --------------------------------------------------------------------------
# an entry point over WebP and PPM files
# --------------------------------------------------------------------------

def test_eval_e2e_over_webp_and_ppm_copies_gives_the_jpgs_results(tmp_path):
    """The port's ``eval_e2e -images_list`` over a scene's lossless WebP
    (named .jpg) and its PPM: the summary and per-image detections of the
    jpg itself, since both decode to its pixels."""
    from fots_torch.cli import eval_e2e

    snapshot = os.path.join(REPO, "artifacts", "serving_params.npz")
    src = os.path.join(REPO, "data", "synth", "img_000.jpg")
    gt = os.path.join(REPO, "data", "synth", "gt_img_000.txt")
    im = cv2.imread(src)
    runs = {}
    for form in ("jpg", "webp", "ppm"):
        folder = tmp_path / form
        folder.mkdir()
        shutil.copy(gt, folder)
        path = folder / ("img_000.ppm" if form == "ppm" else "img_000.jpg")
        if form == "jpg":
            shutil.copy(src, path)
        elif form == "webp":
            path.write_bytes(cv2_webp(im, 101))
        else:
            assert cv2.imwrite(str(path), im)
        assert np.array_equal(imread(str(path)), im)
        lst = folder / "eval.txt"
        lst.write_text(str(path) + "\n")
        dump = folder / "dump.json"
        summary = eval_e2e.main(["-model", snapshot, "-images_list", str(lst), "-device", "cpu",
                                 "-dump_json", str(dump)])
        runs[form] = summary, json.loads(dump.read_text())[0]["detections"]
    assert runs["jpg"][1], "no detections in the jpg"
    for form in ("webp", "ppm"):
        assert runs[form][0] == runs["jpg"][0]
        assert runs[form][1] == runs["jpg"][1]


def test_detection_readers_over_webp_and_netpbm_equal_fots(tmp_path):
    """``fots.data.detection`` (cv2.imread) and the port's reader over three
    scenes as lossy WebP, lossless WebP under a .jpg name and PPM / PAM:
    byte-equal samples."""
    from fots.data.detection import detection_generator as fots_generator
    from fots_torch.data.detection import detection_generator

    synth = os.path.join(REPO, "data", "synth")
    paths = []
    for k, form in enumerate(("webp", "jpg", "ppm", "pam")):
        stem = f"img_00{k}"
        im = cv2.imread(os.path.join(synth, f"{stem}.jpg"))[:320, :448]
        path = tmp_path / f"{stem}.{form}"
        if form in ("webp", "jpg"):
            path.write_bytes(cv2_webp(im, 80 if form == "webp" else 101))
        else:
            assert cv2.imwrite(str(path), im)
        shutil.copy(os.path.join(synth, f"gt_{stem}.txt"), tmp_path)
        paths.append(str(path))
    lst = tmp_path / "l.txt"
    lst.write_text("".join(p + "\n" for p in paths))
    kw = dict(input_size=-1, batch_size=4, in_train=False, augment=False)
    got = next(detection_generator(str(lst), None, **kw))
    want = next(fots_generator(str(lst), **kw))
    assert len(got.image_fns) == 4
    for k in ("images", "score_maps", "geo_maps", "training_masks"):
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.shape == b.shape and np.array_equal(a, b), k
