"""TIFF's JPEG, CCITT, YCbCr and CMYK codings against ``cv2.imread``, byte
for byte in colour (BGR) and grayscale, read by ``fots_torch.imageio.imread``
as OpenCV 5.0 reads them through libtiff 4.7's RGBA reader:

- JPEG (compression 7) of ``cv2.imwrite`` (``IMWRITE_TIFF_COMPRESSION`` 7,
  colour and grey) and Pillow (RGB and YCbCr photometric), and files of this
  module's writer: strips of abbreviated streams after a ``JPEGTables``
  table specification, YCbCr sampled 1x1, 2x1 and 2x2 decoded to RGB by the
  JPEG decoder, grey, a last strip whose stream keeps the full strip
  height, tiles, fill order 2 (no bit reversal for JPEG), streams whose
  size, components or sampling disagree with the directory (None, as
  JPEGPreDecode fails), bogus tables;
- CCITT: Pillow's ``tiff_ccitt``, ``group3`` and ``group4``, and files of
  this module's T.4 / T.6 encoder (``fax_rows``): Modified Huffman RLE,
  RLE-word at even and odd strip offsets, Group 3 1-D and 2-D (T4Options
  bit 0) with and without fill bits, Group 4, fill order 2, MinIsWhite and
  MinIsBlack, runs past 2560 pixels, tiles; cut and bit-flipped copies
  (what libtiff writes into a row where a code is bad or the data ends);
- uncompressed (and LZW) YCbCr at every YCbCrSubsampling libtiff's RGBA
  reader has a routine for, at widths and heights that are not multiples of
  it, with YCbCrCoefficients and ReferenceBlackWhite, in strips and tiles,
  planar 1x1;
- CMYK (Separated, InkSet 1), contiguous and planar, and the separated
  files cv2 reads as None (5 samples, 16 bits, another ink set);
- PixarLog (compression 32909), which OpenCV's libtiff build does not
  decode: None in both modes.
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene
from tests.test_torch_port_imageio_bmp_gif import assert_cuts, assert_same
from tests.test_torch_port_imageio_tiff import _REVERSE, lzw_tiff, tiff_bytes

# --------------------------------------------------------------------------
# writers
# --------------------------------------------------------------------------

_SHORT, _LONG, _RATIONAL, _UNDEFINED = 3, 4, 5, 7


def raw_tiff(w, h, chunks, tags, tiled=False, lead=0):
    """A little-endian classic TIFF of the given strips or tiles (already
    coded), the directory last; ``lead`` bytes before the first chunk (an
    odd ``lead`` puts the data at odd offsets).  ``tags``: tag -> (type,
    values) beside the size and chunk tags."""
    body, offsets, at = b"\0" * lead, [], 8 + lead
    for c in chunks:
        offsets.append(at)
        body += c
        at += len(c)
    t = {256: (_LONG, [w]), 257: (_LONG, [h])}
    t[324 if tiled else 273] = (_LONG, offsets)
    t[325 if tiled else 279] = (_LONG, [len(c) for c in chunks])
    t.update(tags)
    ifd = at + (at & 1)
    values_at = ifd + 2 + 12 * len(t) + 4
    entries, values = b"", b""
    for tag in sorted(t):
        typ, vals = t[tag]
        raw = (bytes(vals) if typ == _UNDEFINED else
               struct.pack("<" + {_SHORT: "H", _LONG: "I", _RATIONAL: "II"}[typ] * (
                   len(vals) // (2 if typ == _RATIONAL else 1)), *vals))
        count = len(vals) // (2 if typ == _RATIONAL else 1)
        entries += struct.pack("<HHI", tag, typ, count)
        if len(raw) <= 4:
            entries += raw + b"\0" * (4 - len(raw))
        else:
            entries += struct.pack("<I", values_at + len(values))
            values += raw + b"\0" * (len(raw) & 1)
    return (b"II*\0" + struct.pack("<I", ifd) + body + b"\0" * (ifd - at)
            + struct.pack("<H", len(t)) + entries + b"\0\0\0\0" + values)


# T.4 codes, first bit first: white and black terminating codes 0-63, make-up
# codes 64-1728, and the make-up codes both colours share (1792-2560)
_WT = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
       "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
       "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
       "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
       "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
       "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
       "00110011 00110100").split()
_WM = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
       "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
       "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
       "010011011").split()
_BT = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
       "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 "
       "00001101100 00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 "
       "000011001100 000011001101 000001101000 000001101001 000001101010 000001101011 "
       "000011010010 000011010011 000011010100 000011010101 000011010110 000011010111 "
       "000001101100 000001101101 000011011010 000011011011 000001010100 000001010101 "
       "000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
       "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
       "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_BM = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
       "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 "
       "0000001001101 0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 "
       "0000001110111 0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 "
       "0000001011011 0000001100100 0000001100101").split()
_XM = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
       "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
       "000000011111").split()
_EOL = "000000000001"
_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
             -3: "0000010"}


def _run_code(run, black):
    term, makeup = (_BT, _BM) if black else (_WT, _WM)
    out = ""
    while run > 2560:
        out += _XM[-1]
        run -= 2560
    if run >= 1792:
        out += _XM[(run - 1792) // 64]
        run %= 64
    elif run >= 64:
        out += makeup[run // 64 - 1]
        run %= 64
    return out + term[run]


def _changes(row):
    """Changing elements of a row of 0 (white) / 1 (black), then the width
    twice (T.4's imaginary changes past the end)."""
    prev = np.concatenate([[0], row[:-1]])
    return list(np.flatnonzero(row != prev)) + [len(row), len(row)]


def _code_1d(row):
    out, x, black = "", 0, False
    for c in _changes(row)[:-1]:
        out += _run_code(c - x, black)
        x, black = c, not black
    return out


def _code_2d(row, ref):
    w = len(row)
    cur, refc = _changes(row), _changes(ref)
    out, a0, colour = "", -1, 0
    while a0 < w:
        a1 = next(c for c in cur if c > a0 or (a0 < 0 and c >= 0))
        b1 = next(c for c in refc if (c > a0 or (a0 < 0 and c >= 0)) and (
            c >= w or ref[c] != colour))
        b2 = next(c for c in refc if c > b1) if b1 < w else w
        if b2 < a1:
            out += "0001"
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += _VERTICAL[a1 - b1]
            a0, colour = a1, 1 - colour
        else:
            a2 = next(c for c in cur if c > a1) if a1 < w else w
            out += "001" + _run_code(a1 - max(a0, 0), colour) + _run_code(a2 - a1, 1 - colour)
            a0 = a2
    return out


def _bytes(bits):
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def fax_rows(rows, compression, two_d=False, fill_bits=False, k=4, rtc=False, eofb=True):
    """The coded bits of ``rows`` ([h, w] of 0 white / 1 black): compression
    2 (each row byte-aligned), 32771 (each row 16-bit aligned within the
    strip), 3 (an EOL before each row; ``two_d``: a tag bit after it and
    every ``k``-th row 1-D; ``fill_bits``: zeros before each EOL so that it
    ends a byte; ``rtc``: six EOLs after the last row) or 4 (2-D rows
    against the row above, ``eofb``: two EOLs after the last)."""
    rows = np.asarray(rows, np.uint8)
    ref = np.zeros(rows.shape[1], np.uint8)
    bits = ""
    for i, row in enumerate(rows):
        if compression in (2, 32771):
            bits += _code_1d(row)
            bits += "0" * (-len(bits) % (8 if compression == 2 else 16))
            continue
        if compression == 3:
            if fill_bits:
                bits += "0" * ((4 - len(bits)) % 8)
            bits += _EOL
            if two_d:
                bits += "1" if i % k == 0 else "0"
            bits += _code_1d(row) if not two_d or i % k == 0 else _code_2d(row, ref)
        else:
            bits += _code_2d(row, ref)
        ref = row
    if compression == 3 and rtc:
        bits += (_EOL + ("1" if two_d else "")) * 6
    if compression == 4 and eofb:
        bits += _EOL * 2
    return _bytes(bits)


def fax_tiff(rows, compression, rows_per_strip=None, photometric=0, fillorder=1, two_d=False,
             fill_bits=False, lead=0, tile=None, **kw):
    """A 1-bit TIFF of ``rows`` in a CCITT coding, by strips (or tiles of
    ``tile`` = (width, height), clipped rows padded white)."""
    rows = np.asarray(rows, np.uint8)
    h, w = rows.shape
    chunks = []
    if tile:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                part = np.zeros((th, tw), np.uint8)
                sub = rows[y:y + th, x:x + tw]
                part[:sub.shape[0], :sub.shape[1]] = sub
                chunks.append(fax_rows(part, compression, two_d, fill_bits, **kw))
    else:
        rps = rows_per_strip or h
        chunks = [fax_rows(rows[y:y + rps], compression, two_d, fill_bits, **kw)
                  for y in range(0, h, rps)]
    if fillorder == 2:
        chunks = [c.translate(_REVERSE) for c in chunks]
    tags = {258: (_SHORT, [1]), 259: (_SHORT, [compression]), 262: (_SHORT, [photometric]),
            277: (_SHORT, [1])}
    if tile:
        tags[322], tags[323] = (_LONG, [tile[0]]), (_LONG, [tile[1]])
    else:
        tags[278] = (_LONG, [rows_per_strip or h])
    if fillorder != 1:
        tags[266] = (_SHORT, [fillorder])
    if compression == 3 and (two_d or fill_bits):
        tags[292] = (_LONG, [int(two_d) | 4 * int(fill_bits)])
    return raw_tiff(w, h, chunks, tags, tiled=bool(tile), lead=lead)


def bilevel(h, w, seed=0):
    """Text-like rows: blocks and strokes of black on white, with noise."""
    rng = np.random.default_rng(seed)
    im = np.zeros((h, w), np.uint8)
    for _ in range(max(1, h * w // 400)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        im[y:y + rng.integers(1, 9), x:x + rng.integers(1, 40)] = 1
    flip = rng.random((h, w)) < 0.02
    return im ^ flip.astype(np.uint8)


def _segments(jpeg):
    """(marker, segment bytes) of a JPEG up to its first scan, then the
    scan's header and data to EOI as one segment."""
    out, i = [], 2
    while i < len(jpeg):
        m = jpeg[i + 1]
        if m == 0xDA:
            return out + [(m, jpeg[i:])]
        n = struct.unpack(">H", jpeg[i + 2:i + 4])[0]
        out.append((m, jpeg[i:i + 2 + n]))
        i += 2 + n
    return out


def pil_jpeg(rgb, quality=90, subsampling=0, grey=False, **kw):
    """Pillow's baseline JPEG of ``rgb`` ([h, w, 3] R, G, B, or [h, w])."""
    buf = io.BytesIO()
    img = Image.fromarray(np.ascontiguousarray(rgb))
    img.save(buf, "JPEG", quality=quality, subsampling=subsampling, **kw)
    return buf.getvalue()


def abbreviate(jpeg):
    """(tables, stream): the JPEGTables of a complete JPEG (SOI, its DQT and
    DHT segments, EOI) and its abbreviated stream (the rest, without APPn)."""
    segs = _segments(jpeg)
    tables = b"\xff\xd8" + b"".join(s for m, s in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
    stream = b"\xff\xd8" + b"".join(s for m, s in segs if m not in (0xDB, 0xC4)
                                    and not 0xE0 <= m <= 0xEF)
    return tables, stream


def jpeg_tiff(img, rows_per_strip=None, subsampling=0, photometric=6, tile=None, fillorder=1,
              quality=90, ycbcr_tag=True, tables=True, strip_height=None, chunks=None):
    """A TIFF in compression 7 of ``img`` ([h, w, 3] R, G, B, or [h, w]
    grey): each strip (or tile) Pillow's JPEG of its pixels, its tables
    moved to JPEGTables (``tables``) or left in each stream.  Photometric 6
    (YCbCr, with YCbCrSubsampling of Pillow's ``subsampling`` where
    ``ycbcr_tag``), 2 (RGB: the streams are still YCbCr) or 1 (grey).
    ``strip_height``: the height written into each strip's stream (the last
    strip keeps the full height when it is the strip height)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    parts = []
    if tile:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                part = np.zeros((th, tw) + img.shape[2:], np.uint8)
                sub = img[y:y + th, x:x + tw]
                part[:sub.shape[0], :sub.shape[1]] = sub
                parts.append(part)
    else:
        rps = rows_per_strip or h
        for y in range(0, h, rps):
            part = img[y:y + rps]
            if strip_height and part.shape[0] < strip_height:
                part = np.concatenate([part, np.zeros((strip_height - part.shape[0],)
                                                      + part.shape[1:], np.uint8)])
            parts.append(part)
    coded = chunks or [pil_jpeg(p, quality, subsampling) for p in parts]
    table_bytes = abbreviate(coded[0])[0]
    coded = [abbreviate(c)[1] if tables else c for c in coded]
    if fillorder == 2:
        coded = [c.translate(_REVERSE) for c in coded]
    tags = {258: (_SHORT, [8] * spp), 259: (_SHORT, [7]),
            262: (_SHORT, [photometric if spp == 3 else 1]), 277: (_SHORT, [spp]),
            284: (_SHORT, [1])}
    if tables:
        tags[347] = (_UNDEFINED, list(table_bytes))
    if spp == 3 and photometric == 6 and ycbcr_tag:
        tags[530] = (_SHORT, {0: [1, 1], 1: [2, 1], 2: [2, 2]}[subsampling])
    if tile:
        tags[322], tags[323] = (_LONG, [tile[0]]), (_LONG, [tile[1]])
    else:
        tags[278] = (_LONG, [rows_per_strip or h])
    if fillorder != 1:
        tags[266] = (_SHORT, [fillorder])
    return raw_tiff(w, h, coded, tags, tiled=bool(tile))


def ycbcr_tiff(w, h, hs, vs, seed=0, rows_per_strip=None, tile=None, compression=1,
               coefficients=None, refbw=None, planar=1, short=0):
    """An uncompressed (or LZW) YCbCr TIFF of random samples: blocks of hs *
    vs Y samples then Cb and Cr, each strip or tile holding whole block rows
    of whole blocks (TIFFVStripSize); ``coefficients`` / ``refbw``: the
    YCbCrCoefficients / ReferenceBlackWhite rationals; ``short``: bytes cut
    off each chunk."""
    rng = np.random.default_rng(seed)
    tw, th = tile or (w, rows_per_strip or h)
    n = (-(-h // th)) * (-(-w // tw) if tile else 1)
    if planar == 2:
        size = tw * th
        chunks = [rng.integers(0, 256, size, np.uint8).tobytes() for _ in range(3 * n)]
    else:
        chunks = []
        for k in range(n):
            rows = th if tile else min(th, h - k * th)
            size = -(-rows // vs) * -(-tw // hs) * (hs * vs + 2)
            chunks.append(rng.integers(0, 256, size, np.uint8).tobytes())
    if short:
        chunks = [c[:len(c) - short] for c in chunks]
    if compression == 5:
        chunks = [lzw_tiff(c) for c in chunks]
    tags = {258: (_SHORT, [8, 8, 8]), 259: (_SHORT, [compression]), 262: (_SHORT, [6]),
            277: (_SHORT, [3]), 284: (_SHORT, [planar]), 530: (_SHORT, [hs, vs])}
    if coefficients:
        tags[529] = (_RATIONAL, list(coefficients))
    if refbw:
        tags[532] = (_RATIONAL, list(refbw))
    if tile:
        tags[322], tags[323] = (_LONG, [tw]), (_LONG, [th])
    else:
        tags[278] = (_LONG, [th])
    return raw_tiff(w, h, chunks, tags, tiled=bool(tile))


def cmyk_tiff(samples, planar=1, compression=1, extrasamples=None, inkset=None, bps=8,
              tile=None):
    """A separated (CMYK) TIFF of ``samples`` ([h, w, 4 or 5])."""
    extra = [] if inkset is None else [(332, (_SHORT, [inkset]))]
    return tiff_bytes(samples, bps=bps, photometric=5, compression=compression, planar=planar,
                      extrasamples=extrasamples, extra_tags=extra, tile=tile,
                      rows_per_strip=None if tile else 7)


def read_cases(tmp_path, cases, suffix=".tif"):
    """Each file of ``cases`` (name -> bytes) reads as cv2 reads it."""
    for name, data in sorted(cases.items()):
        path = tmp_path / f"{name}{suffix}"
        path.write_bytes(data)
        assert_same(path)


# --------------------------------------------------------------------------
# JPEG (compression 7)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grey", [False, True])
def test_tiff_jpeg_of_cv2_reads_as_cv2(tmp_path, grey):
    """cv2.imwrite's JPEG TIFFs (YCbCr 2x2 strips, or grey) at sizes that are
    not multiples of the MCU, named .jpg too (found by content)."""
    for k, (h, w) in enumerate(((23, 41), (40, 48), (17, 130))):
        im = scene(h, w, seed=k)
        path = tmp_path / f"x{k}.tif"
        assert cv2.imwrite(str(path), im[..., 1] if grey else im,
                           [cv2.IMWRITE_TIFF_COMPRESSION, 7])
        assert cv2.imread(str(path)) is not None
        assert_same(path)
    named = tmp_path / "tiff_named.jpg"
    named.write_bytes(path.read_bytes())
    assert_same(named)


def _jpeg_cases():
    im = scene(37, 53, seed=3)[..., ::-1]
    grey = im[..., 1]
    cases = {f"ycbcr_{s}": jpeg_tiff(im, 16, s) for s in (0, 1, 2)}
    cases.update({
        "ycbcr_2x2_one_strip": jpeg_tiff(im, None, 2),
        "ycbcr_2x2_strips_of_8": jpeg_tiff(im, 8, 2, quality=40),
        "ycbcr_untagged_2x2": jpeg_tiff(im, 16, 2, ycbcr_tag=False),
        "ycbcr_untagged_1x1": jpeg_tiff(im, 16, 0, ycbcr_tag=False),
        "rgb_photometric": jpeg_tiff(im, 16, 0, photometric=2),
        "grey": jpeg_tiff(grey, 16),
        "grey_tiles": jpeg_tiff(grey, tile=(16, 32)),
        "ycbcr_tiles": jpeg_tiff(im, tile=(32, 16), subsampling=2),
        "ycbcr_tiles_1x1": jpeg_tiff(im, tile=(16, 16), subsampling=0),
        "tables_in_each_stream": jpeg_tiff(im, 16, 2, tables=False),
        "last_strip_full_height": jpeg_tiff(im, 16, 2, strip_height=16),
        "last_strip_full_height_1x1": jpeg_tiff(im, 16, 0, strip_height=16),
        # None: what JPEGPreDecode refuses, or fill order 2 (no bit reversal)
        "fill_order_2": jpeg_tiff(im, 16, 2, fillorder=2),
        "rgb_photometric_sampled_2x2": jpeg_tiff(im, 16, 2, photometric=2),
        "stream_wider_than_strip": jpeg_tiff(im, 16, 0, chunks=[
            pil_jpeg(np.zeros((16, 60, 3), np.uint8))] * 3),
        "stream_taller_mid_strip": jpeg_tiff(im, 16, 0, chunks=[
            pil_jpeg(np.zeros((20, 53, 3), np.uint8))] * 3),
        "grey_stream_in_ycbcr": jpeg_tiff(im, 16, 0, chunks=[
            pil_jpeg(np.zeros((16, 53), np.uint8))] * 3),
        "stream_narrower_than_strip": jpeg_tiff(im, 16, 0, chunks=[
            pil_jpeg(np.full((16, 40, 3), 200, np.uint8))] * 3),
        "stream_shorter_than_strip": jpeg_tiff(im, 16, 0, chunks=[
            pil_jpeg(np.full((9, 53, 3), 90, np.uint8))] * 3),
    })
    tagged = jpeg_tiff(im, 16, 0)
    cases["tag_2x2_stream_1x1"] = tagged.replace(struct.pack("<HHIHH", 530, 3, 2, 1, 1),
                                                 struct.pack("<HHIHH", 530, 3, 2, 2, 2))
    tables = abbreviate(pil_jpeg(im[:16]))[0]
    cases["bogus_tables_with_a_scan"] = tagged.replace(tables, abbreviate(
        pil_jpeg(im[:16]))[0][:-2] + b"\xff\xda\x00\x02\xff\xd9")
    return cases


_JPEG_CASES = _jpeg_cases()


def test_tiff_jpeg_written_here_reads_as_cv2(tmp_path):
    """Strips and tiles of abbreviated streams after JPEGTables: YCbCr at
    1x1, 2x1 and 2x2 (tagged, or found in the first stream), RGB and grey
    photometric, tables in each stream, a last strip whose stream keeps the
    strip height; and None where JPEGPreDecode fails (a stream wider than
    its strip, taller in a middle strip, of other components or sampling,
    bogus tables, and a stream narrower than its strip: libjpeg's output
    rows are shorter than libtiff's) or the bits are in fill order 2."""
    read = {n for n, d in _JPEG_CASES.items()
            if (tmp_path / "p.tif").write_bytes(d) and cv2.imread(str(tmp_path / "p.tif"))
            is not None}
    assert {"ycbcr_2", "grey_tiles", "last_strip_full_height"} <= read
    assert not {"fill_order_2", "stream_wider_than_strip", "tag_2x2_stream_1x1"} & read
    read_cases(tmp_path, _JPEG_CASES)


def test_tiff_jpeg_damaged_as_cv2(tmp_path):
    """Bit flips in the streams and cuts of the file: what libjpeg makes of
    the data under libtiff, or None."""
    rng = np.random.default_rng(7)
    path = tmp_path / "x.tif"
    for name in ("ycbcr_2", "ycbcr_tiles", "grey"):
        data = _JPEG_CASES[name]
        for _ in range(12):
            d = bytearray(data)
            for at in rng.integers(8, len(d) - 300, 2):
                d[at] ^= 1 << int(rng.integers(0, 8))
            path.write_bytes(bytes(d))
            assert_same(path)
        assert_cuts(path, data, points=6)


# --------------------------------------------------------------------------
# CCITT (compressions 2, 3, 4, 32771)
# --------------------------------------------------------------------------

def _fax_cases():
    page = bilevel(45, 203, seed=1)
    wide = bilevel(3, 5300, seed=2)
    wide[1, 100:3000] = 1  # runs past 2560
    noise = (np.random.default_rng(3).random((9, 77)) < 0.5).astype(np.uint8)
    cases = {}
    for comp, name in ((2, "rle"), (32771, "rle_word"), (3, "g3"), (4, "g4")):
        for pm in (0, 1):
            cases[f"{name}_photometric{pm}"] = fax_tiff(page, comp, photometric=pm)
        cases[f"{name}_strips_of_7"] = fax_tiff(page, comp, rows_per_strip=7)
        cases[f"{name}_fill_order_2"] = fax_tiff(page, comp, fillorder=2, rows_per_strip=16)
        cases[f"{name}_wide_runs"] = fax_tiff(wide, comp)
        cases[f"{name}_noise"] = fax_tiff(noise, comp)
        cases[f"{name}_tiles"] = fax_tiff(page[:40, :60], comp, tile=(32, 16))
    cases["rle_word_odd_offset"] = fax_tiff(page, 32771, rows_per_strip=5, lead=1)
    cases["g3_fill_bits"] = fax_tiff(page, 3, fill_bits=True, rows_per_strip=9)
    cases["g3_rtc"] = fax_tiff(page, 3, rtc=True)
    cases["g3_2d"] = fax_tiff(page, 3, two_d=True)
    cases["g3_2d_k2_fill_bits"] = fax_tiff(page, 3, two_d=True, fill_bits=True, k=2,
                                           rows_per_strip=11)
    cases["g3_2d_noise_rtc"] = fax_tiff(noise, 3, two_d=True, rtc=True)
    cases["g4_no_eofb"] = fax_tiff(page, 4, eofb=False)
    cases["g4_tiles_fill_order_2"] = fax_tiff(page[:40, :60], 4, tile=(16, 16), fillorder=2)
    return cases


_FAX_CASES = _fax_cases()


def test_tiff_ccitt_written_here_reads_as_cv2(tmp_path):
    """Modified Huffman RLE, RLE-word (even and odd strip offsets), Group 3
    1-D and 2-D (fill bits, RTC, K of 2 and 4), Group 4 (with and without
    EOFB) in strips and tiles, fill order 2, MinIsWhite and MinIsBlack, runs
    past 2560 pixels."""
    for name, data in _FAX_CASES.items():
        path = tmp_path / f"{name}.tif"
        path.write_bytes(data)
        assert cv2.imread(str(path)) is not None, name
    read_cases(tmp_path, _FAX_CASES)


@pytest.mark.parametrize("name", ["rle_strips_of_7", "rle_word_odd_offset", "g3_strips_of_7",
                                  "g3_2d_k2_fill_bits", "g4_strips_of_7", "g4_tiles"])
def test_tiff_ccitt_damaged_as_cv2(tmp_path, name):
    """Bits flipped and bytes zeroed in the coded rows (bad codes, EOLs lost
    or found mid-row, Group 3 falling back to rows without EOLs, pass codes
    reading past the reference row), and cuts of the file: what libtiff's
    decoder writes, row by row."""
    data = _FAX_CASES[name]
    ifd = struct.unpack("<I", data[4:8])[0]
    rng = np.random.default_rng(sum(map(ord, name)))
    path = tmp_path / "x.tif"
    for k in range(30):
        d = bytearray(data)
        if k % 3 == 2:
            at = int(rng.integers(8, ifd - 1))
            d[at:ifd] = bytes(ifd - at)
        else:
            for at in rng.integers(8, ifd, 1 + k % 3):
                d[at] ^= 1 << int(rng.integers(0, 8))
        path.write_bytes(bytes(d))
        assert_same(path)
    assert_cuts(path, data, points=5)


# --------------------------------------------------------------------------
# YCbCr and CMYK
# --------------------------------------------------------------------------

_SAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("hs,vs", _SAMPLINGS)
def test_tiff_ycbcr_reads_as_cv2(tmp_path, hs, vs):
    """Every subsampling with a put routine, at sizes that are not multiples
    of it, in one strip, in strips, in tiles (the 4x4 routine's skew of 10
    bytes a skipped block), under LZW, with YCbCrCoefficients and
    ReferenceBlackWhite."""
    cases = {}
    for k, (w, h) in enumerate(((13, 11), (1, 7), (22, 3), (37, 26))):
        cases[f"one_strip_{k}"] = ycbcr_tiff(w, h, hs, vs, seed=k)
        cases[f"strips_{k}"] = ycbcr_tiff(w, h, hs, vs, seed=10 + k, rows_per_strip=vs * 2 + 1)
        cases[f"tiles_{k}"] = ycbcr_tiff(w, h, hs, vs, seed=20 + k, tile=(16, 16))
    cases["lzw"] = ycbcr_tiff(29, 19, hs, vs, seed=5, compression=5, rows_per_strip=8)
    cases["coefficients"] = ycbcr_tiff(29, 19, hs, vs, seed=6, coefficients=(2990, 10000, 5870,
                                                                              10000, 1140, 10000))
    cases["odd_coefficients"] = ycbcr_tiff(29, 19, hs, vs, seed=7, coefficients=(
        2126, 10000, 7152, 10000, 722, 10000))
    cases["reference_black_white"] = ycbcr_tiff(29, 19, hs, vs, seed=8, refbw=(
        16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1))
    cases["wide_tiles"] = ycbcr_tiff(45, 20, hs, vs, seed=9, tile=(32, 16))
    read_cases(tmp_path, cases)


def test_tiff_ycbcr_other_layouts_as_cv2(tmp_path):
    """Planar YCbCr (1x1 only), subsamplings without a put routine (None),
    a short single strip (libtiff estimates its byte count), and Pillow's
    and the refusal list's YCbCr files."""
    cases = {"planar_1x1": ycbcr_tiff(21, 13, 1, 1, planar=2, rows_per_strip=5),
             "planar_2x2": ycbcr_tiff(21, 13, 2, 2, planar=2),
             "sampling_1x4": ycbcr_tiff(21, 13, 1, 4),
             "sampling_2x4": ycbcr_tiff(21, 13, 2, 4),
             "sampling_3x1": ycbcr_tiff(21, 13, 3, 1),
             "short_single_strip": ycbcr_tiff(21, 7, 1, 1, short=4),
             "short_single_strip_4x4": ycbcr_tiff(38, 12, 4, 4, short=4)}
    buf = io.BytesIO()
    Image.fromarray(scene(24, 31, seed=4)[..., ::-1].copy()).convert("YCbCr").save(
        buf, "TIFF", compression="tiff_lzw")
    cases["pillow_lzw"] = buf.getvalue()
    read_cases(tmp_path, cases)


def test_tiff_cmyk_as_cv2(tmp_path):
    """Separated 8-bit InkSet 1: contiguous and planar, LZW, tiles; None for
    5 samples (with or without an extra sample), 16 bits, 3 samples and
    another ink set, as cv2."""
    rng = np.random.default_rng(11)
    c4, c5 = rng.integers(0, 256, (19, 23, 4)), rng.integers(0, 256, (19, 23, 5))
    cases = {"contiguous": cmyk_tiff(c4), "planar": cmyk_tiff(c4, planar=2),
             "lzw": cmyk_tiff(c4, compression=5), "tiles": cmyk_tiff(c4, tile=(16, 16)),
             "five_samples_extra": cmyk_tiff(c5, extrasamples=[0]),
             "five_samples": cmyk_tiff(c5), "five_samples_planar": cmyk_tiff(c5, planar=2,
                                                                             extrasamples=[0]),
             "sixteen_bits": cmyk_tiff(c4 * 257, bps=16), "three_samples": cmyk_tiff(c4[..., :3]),
             "ink_set_2": cmyk_tiff(c4, inkset=2)}
    read = set()
    for name, data in cases.items():
        (tmp_path / "p.tif").write_bytes(data)
        if cv2.imread(str(tmp_path / "p.tif")) is not None:
            read.add(name)
    assert read == {"contiguous", "planar", "lzw", "tiles"}
    read_cases(tmp_path, cases)


def test_tiff_pixarlog_is_none(tmp_path):
    """A PixarLog TIFF (an uncompressed cv2.imwrite file with compression
    32909): OpenCV's libtiff lacks the codec, so None in both modes."""
    path = tmp_path / "x.tif"
    assert cv2.imwrite(str(path), scene(12, 17), [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    data = path.read_bytes()
    at = data.index(struct.pack("<HHIH", 259, 3, 1, 1))
    path.write_bytes(data[:at] + struct.pack("<HHIH", 259, 3, 1, 32909) + data[at + 10:])
    assert cv2.imread(str(path)) is None and cv2.imread(str(path), 0) is None
    assert imread(str(path)) is None and imread(str(path), grayscale=True) is None
