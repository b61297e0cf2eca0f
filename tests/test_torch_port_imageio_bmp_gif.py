"""BMP and GIF files against ``cv2.imread``, byte for byte in colour (BGR)
and grayscale, read by ``fots_torch.imageio.imread``:

- BMP as OpenCV 5.0's own ``BmpDecoder`` reads it: files of ``cv2.imwrite``
  (24-bit, 8-bit grey palette, 32-bit V5 with bit fields) and Pillow (1, 8,
  24 and 32 bits), and files of this module's writer for what neither
  writes: OS/2 headers, V4 / V5 headers, short palettes, 16-bit BI_RGB and
  bit fields, 32-bit masks of other widths, top-down rows, RLE8 and RLE4
  with every escape;
- GIF as OpenCV's own ``GifDecoder`` reads it: files of ``cv2.imwrite`` and
  Pillow, and of this module's GIF writer and LZW encoder: frames offset in
  the screen, transparent indices, local tables over the global one,
  interlaced rows, minimum code sizes 2-8, a full table without a clear
  code, clear codes every few codes, data without its end code;
- cut files (a bounded number of cut points each) and damaged headers: None
  exactly where ``cv2`` gives None.

The readers: ``fots.data.detection`` and ``fots.data.ocr_crops`` (colour and
grey) against the port's over a list mixing BMP, GIF and TIFF files, some
under ``.jpg`` names: byte-equal samples.
"""

import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(path):
    """imread equals cv2.imread in both modes, None included."""
    for gray in (False, True):
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        got = imread(str(path), grayscale=gray)
        if want is None or got is None:
            assert want is None and got is None, (path, gray, want is None)
            continue
        assert got.dtype == np.uint8 and got.shape == want.shape, (path, gray, got.shape)
        assert np.array_equal(got, want), (path, gray)


def assert_cuts(path, data, points=12):
    """Cut at ``points`` places spread over the file: the same as cv2."""
    for cut in sorted({int(len(data) * k / points) for k in range(1, points)}):
        path.write_bytes(data[:cut])
        assert_same(path)


# --------------------------------------------------------------------------
# BMP
# --------------------------------------------------------------------------

def bmp_bytes(w, h, bpp, compression, pixels, palette=None, header=40, clr_used=0,
              masks=None, offset=None):
    """A BMP: ``header`` 12 (OS/2, 3-byte palette entries), 40 (masks after
    it) or 56 and more (masks inside it); ``h`` < 0 for top-down rows."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(list(p[:3]) + ([] if header == 12 else [0])) for p in palette)
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        hdr = struct.pack("<IiiHHIIiiII", header, w, h, 1, bpp, compression, len(pixels),
                          2835, 2835, clr_used, 0)
        if header > 40:
            hdr += struct.pack("<IIII", *(tuple(masks or ()) + (0,) * 4)[:4])
            hdr += b"\0" * (header - 56)
    after = struct.pack("<III", *masks[:3]) if masks is not None and header == 40 else b""
    body = hdr + after + pal
    off = 14 + len(body) if offset is None else offset
    data = body + pixels
    return b"BM" + struct.pack("<IHHI", 14 + len(data), 0, 0, off) + data


def _rows(samples, bpp):
    """Rows of samples packed MSB first and padded to 4 bytes, bottom-up."""
    out = []
    for r in samples[::-1]:
        if bpp >= 8:
            b = np.asarray(r, np.uint8).tobytes()
        else:
            bits = np.unpackbits(np.asarray(r, np.uint8)[:, None], axis=1)[:, 8 - bpp:]
            b = np.packbits(bits.ravel()).tobytes()
        out.append(b + b"\0" * (-len(b) % 4))
    return b"".join(out)


def rle_bytes(indices, rle8=True):
    """BI_RLE8 (or BI_RLE4: two indices a byte) of palette indices [h, w],
    bottom-up: runs of equal indices, absolute spans of 3 or more mixed
    ones, an end of line after each row and an end of bitmap."""
    out = bytearray()
    most = 255 if rle8 else 254
    for row in np.asarray(indices)[::-1]:
        row, x = [int(v) for v in row], 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < most and row[x + n] == row[x]:
                n += 1
            if n >= 3 or len(row) - x < 3:
                out += bytes([n, row[x] if rle8 else row[x] * 17])
            else:
                n = 3
                while x + n < len(row) and n < most and row[x + n] != row[x + n - 1]:
                    n += 1
                span = row[x:x + n]
                if rle8:
                    body = bytes(span) + b"\0" * (n & 1)
                else:
                    span += [0] * (n & 1)
                    body = bytes(a << 4 | b for a, b in zip(span[::2], span[1::2]))
                    body += b"\0" * (len(body) & 1)
                out += bytes([0, n]) + body
            x += n
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def _palette(n, seed, grey=False):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, (n, 3))
    return [(v, v, v) for v in p[:, 0]] if grey else [tuple(int(c) for c in v) for v in p]


def _bmp_cases():
    """(name, bytes) of each BMP case this module writes itself."""
    rng = np.random.default_rng(7)
    h, w = 9, 13
    out = []
    for bpp in (1, 4, 8):
        idx = rng.integers(0, 1 << bpp, (h, w))
        out.append((f"os2_{bpp}bit", bmp_bytes(w, h, bpp, 0, _rows(idx, bpp),
                                               _palette(1 << bpp, bpp), header=12)))
        out.append((f"v4_{bpp}bit_short_palette", bmp_bytes(
            w, h, bpp, 0, _rows(idx, bpp), _palette(max(2, (1 << bpp) // 2 + 1), bpp),
            header=108, clr_used=max(2, (1 << bpp) // 2 + 1))))
    idx = rng.integers(0, 256, (h, w))
    out.append(("8bit_grey_palette_top_down", bmp_bytes(
        w, -h, 8, 0, _rows(idx[::-1], 8), _palette(256, 3, grey=True))))
    px16 = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    rows16 = _rows(px16.view(np.uint8).reshape(h, -1), 8)
    out.append(("16bit_rgb_555", bmp_bytes(w, h, 16, 0, rows16)))
    out.append(("16bit_bitfields_565", bmp_bytes(w, h, 16, 3, rows16,
                                                 masks=(0xf800, 0x7e0, 0x1f))))
    out.append(("16bit_bitfields_555_v5", bmp_bytes(w, -h, 16, 3, rows16, header=124,
                                                    masks=(0xff, 0xff, 0xff, 0))[:-len(rows16)]
                + struct.pack("<III", 0x7c00, 0x3e0, 0x1f) + rows16))
    px32 = rng.integers(0, 1 << 32, (h, w), dtype=np.uint64).astype("<u4")
    rows32 = _rows(px32.view(np.uint8).reshape(h, -1), 8)
    out.append(("32bit_rgb", bmp_bytes(w, h, 32, 0, rows32)))
    out.append(("32bit_bitfields_after_header", bmp_bytes(w, h, 32, 3, rows32,
                                                          masks=(0xff, 0xff00, 0xff0000))))
    for name, m in (("32bit_masks_rgba", (0xff, 0xff00, 0xff0000, 0xff000000)),
                    ("32bit_masks_10bit", (0x3ff00000, 0xffc00, 0x3ff, 0)),
                    ("32bit_masks_5bit", (0x7c00, 0x3e0, 0x1f, 0)),
                    ("32bit_masks_one_zero", (0xff0000, 0xff00, 0, 0))):
        out.append((name, bmp_bytes(w, h, 32, 3, rows32, header=108, masks=m)))
    pal = _palette(256, 11)
    # RLE8: runs, absolute spans (odd and even), end of line after a run that
    # ended a row, a delta across rows, end of bitmap before the last row
    rle8 = bytes([5, 7, 0, 3, 1, 2, 3, 0, 5, 9]) + bytes([0, 4, 4, 5, 6, 7, 3, 8, 0, 0])
    rle8 += bytes([13, 2, 0, 0, 4, 1, 0, 2, 3, 2, 6, 200, 0, 0, 0, 5, 1, 2, 3, 4, 5, 0])
    rle8 += bytes([2, 9, 0, 1])
    out.append(("rle8", bmp_bytes(w, h, 8, 1, rle8, pal, clr_used=256)))
    rle4 = bytes([5, 0x12, 0, 3, 0x34, 0x50, 0, 0, 8, 0x67, 0, 2, 2, 3, 3, 0x89])
    rle4 += bytes([0, 0, 0, 5, 0xab, 0xcd, 0xe0, 0, 0, 0, 0, 1, 2, 0x33, 0, 0, 0, 1])
    rle4 += bytes([0, 0] * 4) + bytes([0, 1])
    out.append(("rle4", bmp_bytes(w, h, 4, 2, rle4, _palette(16, 12), header=124)))
    q = scene(17, 29, seed=8)[..., 1]
    out.append(("rle8_encoded_scene", bmp_bytes(29, 17, 8, 1, rle_bytes(q >> 3), pal)))
    out.append(("rle4_encoded_scene", bmp_bytes(29, 17, 4, 2, rle_bytes(q >> 4, False),
                                                _palette(16, 13))))
    return out


_BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("name", [n for n, _ in _BMP_CASES])
def test_bmp_written_here_reads_as_cv2(tmp_path, name):
    data = dict(_BMP_CASES)[name]
    path = tmp_path / "x.bmp"
    path.write_bytes(data)
    assert cv2.imread(str(path)) is not None, name
    assert_same(path)


@pytest.mark.parametrize("writer", ["cv2_bgr", "cv2_grey", "cv2_bgra", "pil_1", "pil_p",
                                    "pil_rgb", "pil_rgba"])
def test_bmp_of_cv2_and_pillow_reads_as_cv2(tmp_path, writer):
    im = scene(21, 34, seed=4)
    path = tmp_path / "x.bmp"
    if writer.startswith("cv2"):
        img = {"cv2_bgr": im, "cv2_grey": im[..., 1],
               "cv2_bgra": np.dstack([im, im[..., :1]])}[writer]
        assert cv2.imwrite(str(path), img)
    else:
        rgb = Image.fromarray(im[..., ::-1].copy())
        img = {"pil_1": rgb.convert("1"), "pil_p": rgb.convert("P"), "pil_rgb": rgb,
               "pil_rgba": Image.fromarray(np.dstack([im[..., ::-1], im[..., :1]]))}[writer]
        img.save(path, "BMP")
    assert_same(path)
    # named .jpg, it is still a BMP
    named = tmp_path / "bmp_named.jpg"
    named.write_bytes(path.read_bytes())
    assert np.array_equal(imread(str(named)), cv2.imread(str(path)))


def _bmp_damaged():
    im = scene(8, 11, seed=5)
    good = bmp_bytes(11, 8, 24, 0, _rows(im.reshape(8, -1), 8))
    out = {}
    for name, at, value in (("bi_jpeg", 30, 4), ("bi_png", 30, 5), ("compression_7", 30, 7),
                            ("header_size_20", 14, 20), ("width_0", 18, 0),
                            ("bpp_24_as_rle8", 30, 1), ("offset_past_end", 10, 9999)):
        d = bytearray(good)
        d[at:at + 4] = struct.pack("<I", value)
        out[name] = bytes(d)
    rows16 = _rows(np.zeros((3, 4), np.uint16).view(np.uint8).reshape(3, -1), 8)
    out["masks_444"] = bmp_bytes(4, 3, 16, 3, rows16, masks=(0xf00, 0xf0, 0xf))
    out["clr_used_300"] = bmp_bytes(4, 3, 8, 0, _rows(np.zeros((3, 4)), 8), _palette(256, 1),
                                    clr_used=300)
    out["rle8_run_past_row"] = bmp_bytes(4, 2, 8, 1, bytes([0, 0, 5, 1, 0, 1]), _palette(4, 1),
                                         clr_used=4)
    out["rle4_no_end"] = bmp_bytes(4, 2, 4, 2, bytes([4, 0x12, 0, 0]), _palette(16, 1))
    return out


_BMP_DAMAGED = _bmp_damaged()


@pytest.mark.parametrize("name", sorted(_BMP_DAMAGED))
def test_bmp_damaged_none_as_cv2(tmp_path, name):
    path = tmp_path / "x.bmp"
    path.write_bytes(_BMP_DAMAGED[name])
    assert cv2.imread(str(path)) is None
    assert imread(str(path)) is None and imread(str(path), grayscale=True) is None


@pytest.mark.parametrize("name", ["os2_4bit", "rle8", "rle4", "32bit_masks_rgba"])
def test_bmp_cut_as_cv2(tmp_path, name):
    assert_cuts(tmp_path / "x.bmp", dict(_BMP_CASES)[name])


# --------------------------------------------------------------------------
# GIF
# --------------------------------------------------------------------------

def lzw_codes(indices, min_size, clear_first=True, clear_every=None, defer=False, eoi=True):
    """GIF LZW: [(code, width)] of ``indices``.  ``defer``: a full table takes
    no clear code (the deferred clear); ``clear_every``: a clear code after
    every so many codes."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, table = [], {}
    state = {}

    def reset():
        table.clear()
        table.update({(i,): i for i in range(clear)})
        state.update(nxt=end + 1, width=min_size + 1)
    reset()
    if clear_first:
        out.append((clear, state["width"]))
    w, count = (), 0
    for k in indices:
        if w + (k,) in table:
            w += (k,)
            continue
        out.append((table[w], state["width"]))
        count += 1
        if state["nxt"] < 4096:
            table[w + (k,)] = state["nxt"]
            state["nxt"] += 1
            if state["nxt"] > 1 << state["width"] and state["width"] < 12:
                state["width"] += 1
        elif not defer:
            out.append((clear, state["width"]))
            reset()
        if clear_every and count % clear_every == 0 and state["nxt"] < 4096:
            out.append((clear, state["width"]))
            reset()
        w = (k,)
    if w:
        out.append((table[w], state["width"]))
    if eoi:
        out.append((end, state["width"]))
    return out


def _pack(codes):
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data, size=255):
    out = bytearray()
    for i in range(0, len(data), size):
        out += bytes([len(data[i:i + size])]) + data[i:i + size]
    return bytes(out) + b"\0"


def _table(colours):
    return b"".join(bytes(c) for c in colours)


def gif_bytes(sw, sh, frames, table=None, bg=0, version=b"GIF89a"):
    """A GIF of ``frames`` (bytes of extensions and images) on an sw x sh
    screen with the global ``table`` (a power of 2 of RGB triplets)."""
    flags = 0
    if table is not None:
        flags = 0x80 | 0x70 | ((len(table) - 1).bit_length() - 1)
    return (version + struct.pack("<HHBBB", sw, sh, flags, bg, 0)
            + (_table(table) if table is not None else b"") + b"".join(frames) + b";")


def gce(transparent=None, disposal=0):
    flags = disposal << 2 | (transparent is not None)
    return b"\x21\xf9\x04" + struct.pack("<BHB", flags, 0, transparent or 0) + b"\0"


def gif_frame(x, y, w, h, indices, min_size=2, table=None, interlace=False, codes=None,
              block=255, **kw):
    flags = 0x40 if interlace else 0
    if table is not None:
        flags |= 0x80 | ((len(table) - 1).bit_length() - 1)
    idx = np.asarray(indices).reshape(h, w)
    if interlace:
        idx = idx[list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4))
                  + list(range(1, h, 2))]
    if codes is None:
        codes = lzw_codes([int(v) for v in idx.ravel()], min_size, **kw)
    return (b"\x2c" + struct.pack("<HHHHB", x, y, w, h, flags)
            + (_table(table) if table is not None else b"") + bytes([min_size])
            + _sub_blocks(_pack(codes), block))


def _colours(n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(c) for c in v) for v in rng.integers(0, 256, (n, 3))]


def _gif_cases():
    rng = np.random.default_rng(3)
    g4, g16, g256 = _colours(4, 1), _colours(16, 2), _colours(256, 3)
    idx = lambda k, h, w: rng.integers(0, k, h * w)  # noqa: E731
    big = rng.integers(0, 256, 150 * 140)
    big[::3] = 7  # runs: long strings in the table
    return [
        ("87a", gif_bytes(7, 5, [gif_frame(0, 0, 7, 5, idx(4, 5, 7))], g4, version=b"GIF87a")),
        ("offset_background", gif_bytes(9, 7, [gif_frame(2, 3, 4, 3, idx(4, 3, 4))], g4, bg=2)),
        ("transparent", gif_bytes(9, 7, [gce(1), gif_frame(1, 1, 6, 5, idx(4, 5, 6))], g4,
                                  bg=3)),
        ("transparent_is_background", gif_bytes(
            6, 4, [gce(2, disposal=2), gif_frame(0, 1, 6, 3, idx(4, 3, 6))], g4, bg=2)),
        ("local_table_no_global", gif_bytes(8, 6, [gif_frame(1, 1, 5, 4, idx(16, 4, 5),
                                                             min_size=4, table=g16)])),
        ("local_smaller_than_global", gif_bytes(
            8, 6, [gif_frame(0, 0, 8, 6, idx(16, 6, 8), min_size=4, table=g4)], g16, bg=9)),
        ("interlaced_h10", gif_bytes(6, 10, [gif_frame(0, 0, 6, 10, idx(16, 10, 6),
                                                       min_size=4, interlace=True)], g16)),
        ("interlaced_h3_offset", gif_bytes(5, 6, [gif_frame(1, 2, 4, 3, idx(4, 3, 4),
                                                            interlace=True)], g4)),
        ("min_code_size_8", gif_bytes(23, 19, [gif_frame(0, 0, 23, 19, idx(256, 19, 23),
                                                         min_size=8)], g256)),
        ("min_code_size_5_of_4_colours", gif_bytes(
            9, 9, [gif_frame(0, 0, 9, 9, idx(4, 9, 9), min_size=5)], g4)),
        ("full_table_deferred_clear", gif_bytes(
            140, 150, [gif_frame(0, 0, 140, 150, big, min_size=8, defer=True)], g256)),
        ("full_table_cleared", gif_bytes(
            140, 150, [gif_frame(0, 0, 140, 150, big, min_size=8)], g256)),
        ("clear_every_5_codes", gif_bytes(12, 9, [gif_frame(0, 0, 12, 9, idx(4, 9, 12),
                                                            clear_every=5)], g4)),
        ("no_end_code", gif_bytes(12, 9, [gif_frame(0, 0, 12, 9, idx(4, 9, 12), eoi=False)],
                                  g4)),
        ("no_first_clear", gif_bytes(12, 9, [gif_frame(0, 0, 12, 9, idx(4, 9, 12),
                                                       clear_first=False)], g4)),
        ("one_byte_sub_blocks", gif_bytes(12, 9, [gif_frame(0, 0, 12, 9, idx(16, 9, 12),
                                                            min_size=4, block=1)], g16)),
        ("extensions_and_second_frame", gif_bytes(8, 6, [
            b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00", b"\x21\xfe\x05hello\x00",
            gce(None, disposal=1), gif_frame(0, 0, 8, 6, idx(4, 6, 8)),
            gce(0), gif_frame(2, 2, 3, 3, idx(4, 3, 3))], g4)),
    ]


_GIF_CASES = _gif_cases()


@pytest.mark.parametrize("name", [n for n, _ in _GIF_CASES])
def test_gif_written_here_reads_as_cv2(tmp_path, name):
    path = tmp_path / "x.gif"
    path.write_bytes(dict(_GIF_CASES)[name])
    assert cv2.imread(str(path)) is not None, name
    assert_same(path)


@pytest.mark.parametrize("writer", ["cv2", "pil_p", "pil_interlaced_transparent"])
def test_gif_of_cv2_and_pillow_reads_as_cv2(tmp_path, writer):
    im = scene(37, 52, seed=6)
    path = tmp_path / "x.gif"
    if writer == "cv2":
        assert cv2.imwrite(str(path), im)
    else:
        p = Image.fromarray(im[..., ::-1].copy()).convert("P")
        extra = dict(interlace=True, transparency=3) if "transparent" in writer else {}
        p.save(path, "GIF", **extra)
    assert_same(path)


def _gif_damaged():
    g4 = _colours(4, 1)
    idx = np.arange(20) % 4
    ok = gif_frame(0, 0, 5, 4, idx)
    cs = lzw_codes([int(v) for v in idx], 2)
    return {
        "no_trailer": gif_bytes(5, 4, [ok], g4)[:-1],
        "background_past_table": gif_bytes(5, 4, [ok], g4, bg=4),
        "index_past_tables": gif_bytes(5, 4, [ok], g4[:2]),
        "data_short_of_frame": gif_bytes(5, 4, [gif_frame(0, 0, 5, 4, idx, codes=lzw_codes(
            [int(v) for v in idx[:13]], 2))], g4),
        "data_past_frame": gif_bytes(5, 4, [gif_frame(0, 0, 5, 4, idx, codes=cs[:-1] + [
            (1, 5)] * 8 + cs[-1:])], g4),
        "code_past_table": gif_bytes(5, 4, [gif_frame(0, 0, 5, 4, idx, codes=cs[:3] + [
            (30, 5)] + cs[3:])], g4),
        "disposal_4": gif_bytes(5, 4, [gce(None, disposal=4), ok], g4),
        "gce_size_5": gif_bytes(5, 4, [b"\x21\xf9\x05\x01\x00\x00\x01\x00\x00", ok], g4),
        "frame_outside_screen": gif_bytes(4, 4, [ok], g4),
        "min_code_size_1": gif_bytes(5, 4, [gif_frame(0, 0, 5, 4, idx % 2, min_size=1)], g4),
        "no_image": gif_bytes(5, 4, [b"\x21\xfe\x01x\x00"], g4),
        "screen_0_wide": gif_bytes(0, 4, [ok], g4),
        "version_88a": gif_bytes(5, 4, [ok], g4, version=b"GIF88a"),
    }


_GIF_DAMAGED = _gif_damaged()


@pytest.mark.parametrize("name", sorted(_GIF_DAMAGED))
def test_gif_damaged_none_as_cv2(tmp_path, name):
    path = tmp_path / "x.gif"
    path.write_bytes(_GIF_DAMAGED[name])
    assert cv2.imread(str(path)) is None and cv2.imread(str(path), 0) is None
    assert imread(str(path)) is None and imread(str(path), grayscale=True) is None


@pytest.mark.parametrize("name", ["offset_background", "interlaced_h10", "min_code_size_8"])
def test_gif_cut_as_cv2(tmp_path, name):
    assert_cuts(tmp_path / "x.gif", dict(_GIF_CASES)[name])


# --------------------------------------------------------------------------
# the readers over BMP, GIF and TIFF files
# --------------------------------------------------------------------------

def _mixed_files(tmp_path, images, stems, gt_dir=None):
    """Each image written as BMP, GIF and TIFF in turn (every other one
    under a .jpg name); the gt files copied beside them."""
    paths = []
    for k, (im, stem) in enumerate(zip(images, stems)):
        ext = ("bmp", "gif", "tif")[k % 3]
        path = tmp_path / f"{stem}.{ext}"
        params = [cv2.IMWRITE_TIFF_COMPRESSION, 5] if ext == "tif" else []
        assert cv2.imwrite(str(path), im, params)
        if k % 2:
            path = path.rename(tmp_path / f"{stem}.jpg")
        if gt_dir is not None:
            (tmp_path / f"gt_{stem}.txt").write_bytes(
                open(os.path.join(gt_dir, f"gt_{stem}.txt"), "rb").read())
        paths.append(str(path))
    return paths


def test_detection_readers_over_bmp_gif_tiff_equal_fots(tmp_path):
    from fots.data.detection import detection_generator as fots_generator
    from fots_torch.data.detection import detection_generator

    synth = os.path.join(REPO, "data", "synth")
    stems = [f"img_00{i}" for i in range(3)]
    images = [cv2.imread(os.path.join(synth, f"{s}.jpg"))[:320, :448] for s in stems]
    lst = tmp_path / "l.txt"
    lst.write_text("".join(p + "\n" for p in _mixed_files(tmp_path, images, stems, synth)))
    kw = dict(input_size=-1, batch_size=3, in_train=False, augment=False)
    got = next(detection_generator(str(lst), None, **kw))
    want = next(fots_generator(str(lst), **kw))
    assert len(got.image_fns) == 3
    for k in ("images", "score_maps", "geo_maps", "training_masks"):
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.shape == b.shape and np.array_equal(a, b), k


@pytest.mark.parametrize("rgb", [True, False])
def test_ocr_crop_readers_over_bmp_gif_tiff_equal_fots(tmp_path, rgb):
    from fots.codec import LabelCodec as JaxLabelCodec
    from fots.data import ocr_crops as jcrops
    from fots_torch.data import ocr_crops as tcrops

    src = os.path.join(REPO, "fots_torch", "assets", "ocr_eval_png")
    entries = [ln.split(",", 1) for ln in open(os.path.join(src, "gt.txt")).read().splitlines()[:6]]
    images = [cv2.imread(os.path.join(src, name.strip())) for name, _ in entries]
    paths = _mixed_files(tmp_path, images, [f"c{k}" for k in range(len(entries))])
    lst = tmp_path / "gt.txt"
    lst.write_text("".join(f"{os.path.basename(p)},{text}\n" for p, (_, text) in
                           zip(paths, entries)))
    kw = dict(batch_size=3, norm_height=32, rgb=rgb, in_train=False)
    got = list(tcrops.ocr_crop_generator(None, train_list=str(lst), **kw))
    want = list(jcrops.ocr_crop_generator(str(lst), codec=JaxLabelCodec(), **kw))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"]
        for k in ("images", "labels", "label_lengths"):
            assert np.array_equal(g[k], np.asarray(w[k])), k
