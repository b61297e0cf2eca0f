"""Sun raster, PFM and Radiance HDR files against ``cv2.imread``, byte for
byte in colour (BGR) and grayscale, read by ``fots_torch.imageio.imread`` as
OpenCV 5.0's own decoders read them:

- Sun raster (``SunRasterDecoder``): ``cv2.imwrite``'s files and this
  module's writer (``sunras_bytes``) at every type (old and standard read;
  byte-encoded and RGB refused by the decoder: None) and depth (1, 8, 24,
  32), without a map, with an RGB map (full, short, grey), rows padded to
  16 bits; cut and header-damaged copies;
- PFM (``PFMDecoder``): ``cv2.imwrite``'s files and ``pfm_bytes``' at both
  byte orders and several scales, NaN, infinities, negative values and
  values past 1 (the float times 1 / |scale|, rounded half to even and
  saturated; 0 where cvRound overflows), headers of one whitespace byte
  between fields, a 3-channel file in grey and a 1-channel one in colour
  (None), sizes past OpenCV's limits (raise), cuts;
- Radiance HDR (``HdrDecoder``, ``rgbe.cpp``): ``cv2.imwrite``'s files
  (run-length scanlines) and ``hdr_bytes``' flat, new-style run-length and
  old-style run-length (read as the pixels they are written as) scanlines,
  the ``#?RGBE`` signature, header lines before FORMAT, ``xyze`` and other
  resolution lines (None), cut and bit-flipped copies.
"""

import struct

import cv2
import numpy as np
import pytest

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene
from tests.test_torch_port_imageio_bmp_gif import assert_cuts, assert_same
from tests.test_torch_port_imageio_tiff_codings import read_cases

# --------------------------------------------------------------------------
# writers
# --------------------------------------------------------------------------


def sunras_bytes(w, h, depth, body, typ=1, maptype=0, colour_map=b"", maplength=None):
    """A Sun raster: the 32-byte big-endian header, the map, then ``body``."""
    ml = len(colour_map) if maplength is None else maplength
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), typ, maptype, ml) + (
        colour_map + body)


def sunras_rows(pixels, depth):
    """Rows of ``pixels`` ([h, w] indices or bits, [h, w, 3] B, G, R or
    [h, w, 4] pad, B, G, R) padded to 16 bits."""
    pixels = np.asarray(pixels, np.uint8)
    out = b""
    for row in pixels:
        r = np.packbits(row).tobytes() if depth == 1 else row.tobytes()
        out += r + b"\0" * (len(r) & 1)
    return out


def pfm_bytes(img, scale=-1.0, header=None):
    """A PFM of float ``img`` ([h, w] grey or [h, w, 3] R, G, B), rows bottom
    to top, little-endian for a negative scale."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    head = header or (b"PF" if img.ndim == 3 else b"Pf") + b"\n%d %d\n%r\n" % (w, h, scale)
    return head + img[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


def rgbe(img):
    """RGBE bytes [h, w, 4] of non-negative float R, G, B (rgbe.cpp's
    float2rgbe)."""
    img = np.asarray(img, np.float64)
    v = img.max(-1)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0, m * 256.0 / np.where(v < 1e-32, 1, v))
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = (img * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128)
    return out


def _rle_channel(c):
    out, i = b"", 0
    while i < len(c):
        j = i
        while j + 1 < len(c) and c[j + 1] == c[i] and j - i < 126:
            j += 1
        if j - i >= 2:
            out += bytes([128 + j - i + 1, c[i]])
            i = j + 1
            continue
        j = i
        while j + 1 < len(c) and j - i < 127 and not (j + 2 < len(c) and c[j + 1] == c[j + 2]):
            j += 1
        out += bytes([j - i + 1]) + bytes(c[i:j + 1])
        i = j + 1
    return out


def hdr_bytes(pixels, mode="rle", lines=(b"FORMAT=32-bit_rle_rgbe",), magic=b"#?RADIANCE",
              size=None):
    """A Radiance HDR of RGBE ``pixels`` ([h, w, 4]): scanlines ``flat``,
    ``rle`` (new style: 2, 2, the width, four run-length channels) or
    ``old_rle`` (old style: a pixel repeated by 1, 1, 1, n pixels)."""
    h, w = pixels.shape[:2]
    head = magic + b"\n" + b"".join(x + b"\n" for x in lines) + b"\n" + (
        size or b"-Y %d +X %d" % (h, w)) + b"\n"
    body = b""
    for row in pixels:
        if mode == "flat":
            body += row.tobytes()
        elif mode == "rle":
            body += bytes([2, 2, w >> 8, w & 255]) + b"".join(
                _rle_channel(row[:, c].tolist()) for c in range(4))
        else:
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 255 and (row[x + n] == row[x]).all():
                    n += 1
                body += row[x].tobytes() + (bytes([1, 1, 1, n - 1]) if n > 1 else b"")
                x += n
    return head + body


# --------------------------------------------------------------------------
# Sun raster
# --------------------------------------------------------------------------

def test_sunras_of_cv2_reads_as_cv2(tmp_path):
    """cv2.imwrite's 24-bit colour and 8-bit grey files (the grey one reads
    as 0 in grey mode: the decoder's grey palette comes from a map only),
    named .jpg too."""
    for k, (h, w) in enumerate(((21, 37), (8, 1), (33, 64))):
        im = scene(h, w, seed=k)
        for img in (im, im[..., 0]):
            path = tmp_path / "x.ras"
            assert cv2.imwrite(str(path), img)
            assert_same(path)
    named = tmp_path / "sunras_named.jpg"
    named.write_bytes(path.read_bytes())
    assert_same(named)


def _sunras_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for w in (1, 7, 16):
        h = 5
        idx = rng.integers(0, 256, (h, w))
        bits = rng.integers(0, 2, (h, w))
        bgr = rng.integers(0, 256, (h, w, 3))
        xbgr = rng.integers(0, 256, (h, w, 4))
        cmap = rng.integers(0, 256, 768, np.uint8).tobytes()
        for typ in (0, 1, 2, 3):
            t = f"w{w}_type{typ}"
            cases[f"{t}_8bit"] = sunras_bytes(w, h, 8, sunras_rows(idx, 8), typ)
            cases[f"{t}_8bit_map"] = sunras_bytes(w, h, 8, sunras_rows(idx, 8), typ, 1, cmap)
            cases[f"{t}_1bit"] = sunras_bytes(w, h, 1, sunras_rows(bits, 1), typ)
            cases[f"{t}_1bit_map"] = sunras_bytes(w, h, 1, sunras_rows(bits, 1), typ, 1,
                                                  cmap[:6])
            cases[f"{t}_24bit"] = sunras_bytes(w, h, 24, sunras_rows(bgr, 24), typ)
            cases[f"{t}_32bit"] = sunras_bytes(w, h, 32, sunras_rows(xbgr, 32), typ)
        cases[f"w{w}_8bit_short_map"] = sunras_bytes(w, h, 8, sunras_rows(idx, 8), 1, 1,
                                                     cmap[:100])
        cases[f"w{w}_8bit_grey_map"] = sunras_bytes(w, h, 8, sunras_rows(idx, 8), 1, 1,
                                                    bytes(range(256)) * 3)
    body = sunras_rows(rng.integers(0, 256, (4, 6)), 8)
    cases.update({
        "depth4": sunras_bytes(6, 4, 4, body), "depth16": sunras_bytes(3, 4, 16, body),
        "map_type2": sunras_bytes(6, 4, 8, body, 1, 2, bytes(6)),
        "map_without_type": sunras_bytes(6, 4, 8, body, 1, 0, bytes(6)),
        "map_type_without_map": sunras_bytes(6, 4, 8, body, 1, 1, b""),
        "map_too_long_1bit": sunras_bytes(6, 4, 1, sunras_rows(np.ones((4, 6)), 1), 1, 1,
                                          bytes(9)),
        "map_24bit": sunras_bytes(2, 4, 24, sunras_rows(np.ones((4, 2, 3)), 24), 1, 1, bytes(6)),
        "map_past_end": sunras_bytes(6, 4, 8, b"", 1, 1, bytes(30), maplength=768),
        "zero_width": sunras_bytes(0, 4, 8, body),
        "negative_height": sunras_bytes(6, 0x80000000, 8, body),
        "rows_short_of_padding": sunras_bytes(3, 1, 8, bytes([5, 6, 7])),
    })
    return cases


_SUNRAS = _sunras_cases()


def test_sunras_written_here_reads_as_cv2(tmp_path):
    """Types 0-3 at depths 1, 8, 24 and 32, widths 1, 7 and 16, with and
    without a map: old and standard read, byte-encoded and RGB None (as
    cv2), and the headers the decoder refuses."""
    read = set()
    for name, data in _SUNRAS.items():
        (tmp_path / "p.ras").write_bytes(data)
        if cv2.imread(str(tmp_path / "p.ras")) is not None:
            read.add(name)
    assert "w7_type0_1bit_map" in read and "w16_type1_32bit" in read
    assert not any("type2" in n or "type3" in n for n in read)
    read_cases(tmp_path, _SUNRAS, ".ras")


def test_sunras_past_limits_raises(tmp_path):
    path = tmp_path / "x.ras"
    path.write_bytes(sunras_bytes(1 << 21, 1, 8, b""))
    with pytest.raises(cv2.error):
        cv2.imread(str(path))
    for gray in (False, True):
        with pytest.raises(ValueError):
            imread(str(path), grayscale=gray)


@pytest.mark.parametrize("name", ["w7_type1_1bit_map", "w16_type0_24bit", "w7_type1_32bit",
                                  "w16_8bit_short_map"])
def test_sunras_cut_as_cv2(tmp_path, name):
    assert_cuts(tmp_path / "x.ras", _SUNRAS[name], points=16)


# --------------------------------------------------------------------------
# PFM
# --------------------------------------------------------------------------

def test_pfm_of_cv2_reads_as_cv2(tmp_path):
    """cv2.imwrite's colour and grey PFMs of floats in 0..1 and past it
    (a colour file reads only in colour, a grey one only in grey)."""
    rng = np.random.default_rng(2)
    for k, (h, w) in enumerate(((13, 29), (1, 1), (40, 3))):
        for img in (rng.random((h, w, 3)).astype(np.float32),
                    (rng.random((h, w)) * 300 - 20).astype(np.float32)):
            path = tmp_path / "x.pfm"
            assert cv2.imwrite(str(path), img)
            assert_same(path)


def _pfm_cases():
    rng = np.random.default_rng(3)
    special = np.array([0, 0.5, 1.5, 2.5, 254.5, 255.5, 255.49, -0.5, -0.51, -1, 1e10, 3e9,
                        2e9, 2147483520, 2147483648, np.nan, np.inf, -np.inf], np.float32)
    grey = np.stack([special, special[::-1]])
    colour = rng.random((6, 9, 3)).astype(np.float32) * 260
    two = np.array([[1, 2], [3, 4]], np.float32)
    cases = {}
    for scale in (-1.0, 1.0, -2.0, 0.7, -1 / 255, 13.37, -np.inf):
        cases[f"grey_scale_{scale:g}"] = pfm_bytes(grey * (1 if abs(scale) >= 1 else 0.01),
                                                   scale)
        cases[f"colour_scale_{scale:g}"] = pfm_bytes(colour, scale)
    raw = two.astype("<f4").tobytes()
    for name, head in {"space_separated": b"Pf\n2 2 -1\n", "tab": b"Pf\n2\t2\n-1\n",
                       "width_junk": b"Pf\n2x 2\n-1\n", "scale_exponent": b"Pf\n2 2\n-1e0\n",
                       "scale_hex": b"Pf\n2 2\n-0x1p1\n", "plus_sign": b"Pf\n+2 2\n-1\n",
                       "width_wraps": b"Pf\n4294967298 2\n-1\n", "crlf": b"Pf\r\n2 2\n-1\n",
                       "no_line_break": b"Pf 2 2\n-1\n", "scale_zero": b"Pf\n2 2\n0\n",
                       "scale_junk": b"Pf\n2 2\nabc\n", "scale_nan": b"Pf\n2 2\nnan\n",
                       "byte_past_127": b"Pf\n2 2\n-1\x80\n"}.items():
        cases[name] = head + raw
    cases["trailing_bytes"] = b"Pf\n2 2\n-1\n" + raw + b"xyz"
    cases["header_only"] = b"Pf\n2 2\n-1"
    cases["data_short"] = b"Pf\n2 2\n-1\n" + raw[:-1]
    return cases


_PFM = _pfm_cases()


def test_pfm_written_here_reads_as_cv2(tmp_path):
    """Both byte orders, scales of 1, 2, 0.7, 1/255, 13.37 and -inf, the
    special values, headers of one whitespace byte between fields (atoi /
    atof of each), and None where cv2 gives None."""
    read_cases(tmp_path, _PFM, ".pfm")


@pytest.mark.parametrize("header", [b"Pf\n0 2\n-1\n", b"Pf\n2  2\n-1\n", b"Pf\n 2 2\n-1\n",
                                    b"Pf\n3000000000 2\n-1\n", b"PF\n100000 100000\n0\n"])
def test_pfm_bad_size_raises(tmp_path, header):
    """A width or height of 0 (an empty field reads as 0), negative, or past
    OpenCV's limits: imread raises, before the scale or the data count."""
    path = tmp_path / "x.pfm"
    path.write_bytes(header + bytes(16))
    with pytest.raises(cv2.error):
        cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    for gray in (False, True):
        with pytest.raises(ValueError):
            imread(str(path), grayscale=gray)


def test_pfm_cut_as_cv2(tmp_path):
    assert_cuts(tmp_path / "x.pfm", _PFM["colour_scale_-1"], points=12)
    assert_cuts(tmp_path / "x.pfm", _PFM["grey_scale_1"], points=12)


# --------------------------------------------------------------------------
# Radiance HDR
# --------------------------------------------------------------------------

def test_hdr_of_cv2_reads_as_cv2(tmp_path):
    """cv2.imwrite's HDRs (run-length scanlines from 8 pixels wide, flat
    below), of floats in 0..1 and past it, named .jpg too."""
    rng = np.random.default_rng(4)
    for k, (h, w) in enumerate(((9, 31), (4, 5), (2, 300))):
        img = (rng.random((h, w, 3)) * [1.2, 3, 0.01][k]).astype(np.float32)
        path = tmp_path / "x.hdr"
        assert cv2.imwrite(str(path), img)
        assert_same(path)
    named = tmp_path / "hdr_named.jpg"
    named.write_bytes(path.read_bytes())
    assert_same(named)


def _hdr_cases():
    rng = np.random.default_rng(6)
    img = rng.random((7, 40, 3)) * 2
    img[2:4, 5:30] = 0.25  # runs
    img[5, :] = 0
    px = rgbe(img)
    px[1, 3, 3] = 255  # values that overflow 8 bits, and past float
    px[1, 4] = [1, 1, 1, 3]  # an old-style run marker in a flat file
    small = rgbe(rng.random((3, 5, 3)))
    cases = {"flat": hdr_bytes(px, "flat"), "rle": hdr_bytes(px, "rle"),
             "old_rle": hdr_bytes(px, "old_rle"), "flat_narrow": hdr_bytes(small, "flat"),
             "old_rle_padded": hdr_bytes(px, "old_rle") + bytes(px.size),
             "rgbe_magic": hdr_bytes(px, magic=b"#?RGBE"),
             "header_lines": hdr_bytes(px, lines=(b"# made by hand", b"GAMMA=2.2",
                                                  b"EXPOSURE=1.0", b"FORMAT=32-bit_rle_rgbe")),
             "format_on_first_line": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 7 +X 40\n"
                                     + hdr_bytes(px)[41:],
             "size_spaces": hdr_bytes(px, size=b"-Y  7  +X  40"),
             "xyze": hdr_bytes(px, lines=(b"FORMAT=32-bit_rle_xyze",)),
             "no_format": hdr_bytes(px, lines=(b"GAMMA=1",)),
             "plus_y": hdr_bytes(px, size=b"+Y 7 +X 40"),
             "minus_x": hdr_bytes(px, size=b"-Y 7 -X 40"),
             "x_first": hdr_bytes(px, size=b"+X 40 -Y 7"),
             "zero_height": hdr_bytes(px, size=b"-Y 0 +X 40"),
             "no_blank_line": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n-Y 7 +X 40\n" + px.tobytes()}
    rle = hdr_bytes(px, "rle")
    head = rle.index(b"+X 40\n") + 6
    line = rle[head:head + 4] + rle[head + 4:].split(b"\x02\x02\x00\x28")[0]
    cases["rle_then_flat"] = rle[:head] + line + px[1:].tobytes()
    cases["wrong_scanline_width"] = rle[:head] + b"\x02\x02\x00\x29" + rle[head + 4:]
    cases["zero_count"] = rle[:head + 4] + b"\x00\x05" + rle[head + 4:]
    cases["run_past_plane"] = rle[:head + 4] + b"\xff\x05" + rle[head + 4:]
    return cases


_HDR = _hdr_cases()


def test_hdr_written_here_reads_as_cv2(tmp_path):
    """Flat, new-style and old-style run-length scanlines (the old style read
    flat: a file of them is short of its pixels, None, unless bytes follow),
    run-length lines then flat pixels, both signatures, header lines; None for xyze, another
    resolution line, a missing FORMAT or blank line, a wrong scanline width,
    counts of 0 or past the plane."""
    read = set()
    for name, data in _HDR.items():
        (tmp_path / "p.hdr").write_bytes(data)
        if cv2.imread(str(tmp_path / "p.hdr")) is not None:
            read.add(name)
    assert {"flat", "rle", "old_rle_padded", "rle_then_flat", "header_lines"} <= read
    assert not {"old_rle", "xyze", "plus_y", "zero_count", "wrong_scanline_width"} & read
    read_cases(tmp_path, _HDR, ".hdr")


@pytest.mark.parametrize("name", ["flat", "rle", "old_rle"])
def test_hdr_damaged_as_cv2(tmp_path, name):
    data = _HDR[name]
    rng = np.random.default_rng(len(name))
    path = tmp_path / "x.hdr"
    for _ in range(25):
        d = bytearray(data)
        for at in rng.integers(0, len(d), 2):
            d[at] ^= 1 << int(rng.integers(0, 8))
        path.write_bytes(bytes(d))
        assert_same(path)
    assert_cuts(path, data, points=12)
