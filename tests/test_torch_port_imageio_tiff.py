"""TIFF files against ``cv2.imread``, byte for byte in colour (BGR) and
grayscale, read by ``fots_torch.imageio.imread`` as OpenCV 5.0 reads them
through libtiff 4.7's RGBA reader:

- files of ``cv2.imwrite`` (every ``IMWRITE_TIFF_COMPRESSION`` the port
  decodes, 8 and 16 bits) and Pillow (bilevel, grey, palette, grey + alpha,
  RGBA, 16-bit grey);
- files of this module's TIFF writer for the rest: classic and BigTIFF in
  both byte orders, the directory before or after the data, uncompressed,
  PackBits, LZW (its own encoder) and Deflate, the horizontal predictor at
  8 and 16 bits, strips of any height, tiles clipped at the right and bottom
  (the grey put routines' clipped-tile stride included), planar
  configuration 2, MinIsWhite and MinIsBlack at 1, 8 and 16 bits, palettes
  at 1, 4 and 8 bits with 8- and 16-bit colour maps, RGB and RGBA at 8 and
  16 bits with every ExtraSamples value, FillOrder 2, orientations 1-4 in
  strips and tiles, signed samples, a palette without its colour map, a
  coding libtiff does not know;
- None exactly where ``cv2`` gives None: orientations 5-8, depths OpenCV
  refuses (2 and 4-bit grey, 2-bit palette, 32-bit and float samples), files
  cut short, strips past the end of the file, damaged directories;
- Pillow's JPEG (RGB and YCbCr), CCITT RLE, Group 3 and Group 4, YCbCr and
  Separated (CMYK) files read as cv2 reads them (the rest of those codings
  is in tests/test_torch_port_imageio_tiff_codings.py);
- ``ValueError`` naming the coding or photometric for each TIFF ``cv2``
  reads that the port does not decode: CIELab, old-style LZW.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene
from tests.test_torch_port_imageio_bmp_gif import assert_cuts, assert_same

_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def lzw_tiff(data, old_style=False):
    """TIFF LZW of ``data`` from a clear code: MSB-first codes that widen one
    code early (new style), or LSB-first codes that widen on time (the
    old-style codes libtiff still reads)."""
    codes, width = [(256, 9)], 9
    table, nxt, w = {bytes([i]): i for i in range(256)}, 258, b""
    early = 0 if old_style else 1
    for byte in data:
        if w + bytes([byte]) in table:
            w += bytes([byte])
            continue
        codes.append((table[w], width))
        table[w + bytes([byte])] = nxt
        nxt += 1
        if nxt == (1 << width) - early and width < 12:
            width += 1
        if nxt >= 4093:
            codes.append((256, width))
            table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
        w = bytes([byte])
    codes.append((table[w], width))
    if not old_style and nxt == (1 << width) - 2 and width < 12:
        width += 1  # the decoder's table grows by the last code too
    codes.append((257, width))
    acc = nbits = 0
    out = bytearray()
    for code, wd in codes:
        if old_style:
            acc |= code << nbits
            nbits += wd
            while nbits >= 8:
                out.append(acc & 255)
                acc >>= 8
                nbits -= 8
        else:
            acc = acc << wd | code
            nbits += wd
            while nbits >= 8:
                nbits -= 8
                out.append(acc >> nbits & 255)
    if nbits:
        out.append(acc & 255 if old_style else acc << (8 - nbits) & 255)
    return bytes(out)


def packbits(data):
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
        else:
            while j + 1 < len(data) and j - i < 127 and not (
                    j + 2 < len(data) and data[j + 1] == data[j + 2]):
                j += 1
            out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


def _pack_rows(samples, bps, big_endian):
    rows = []
    for r in samples:
        if bps == 8:
            rows.append(np.asarray(r, np.uint8).tobytes())
        elif bps in (16, 32):
            rows.append(np.asarray(r, (">" if big_endian else "<") + f"u{bps // 8}").tobytes())
        else:
            bits = np.unpackbits(np.asarray(r, np.uint8)[:, None], axis=1)[:, 8 - bps:]
            rows.append(np.packbits(bits.ravel()).tobytes())
    return rows


def _difference(rows, bps, spp, big_endian):
    dt = np.uint8 if bps == 8 else np.dtype(">u2" if big_endian else "<u2")
    out = []
    for r in rows:
        a = np.frombuffer(r, dt).reshape(-1, spp).astype(np.int64)
        d = a.copy()
        d[1:] -= a[:-1]
        out.append((d % (1 << bps)).astype(dt).tobytes())
    return out


def tiff_bytes(img, bps=8, photometric=None, compression=1, predictor=1, planar=1,
               rows_per_strip=None, tile=None, fillorder=1, orientation=None,
               colormap=None, extrasamples=None, sampleformat=None, big_endian=False,
               bigtiff=False, ifd_first=True, extra_tags=(), omit=(), old_lzw=False):
    """A TIFF of ``img`` ([h, w] or [h, w, samples] integers) with one
    directory; ``compression`` 1, 5 (LZW), 8 / 32946 (Deflate) or 32773
    (PackBits), any other code leaves the data raw."""
    img = np.asarray(img)
    img = img[:, :, None] if img.ndim == 2 else img
    h, w, n = img.shape
    photometric = (2 if n >= 3 else 1) if photometric is None else photometric
    e = ">" if big_endian else "<"

    def encode(raw):
        data = {5: lambda r: lzw_tiff(r, old_lzw), 8: zlib.compress, 32946: zlib.compress,
                32773: packbits}.get(compression, lambda r: r)(raw)
        return data.translate(_REVERSE) if fillorder == 2 else data
    planes = [img] if planar == 1 else [img[:, :, k:k + 1] for k in range(n)]
    chunks = []
    tw, th = tile or (w, rows_per_strip or h)
    for pl in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw) if tile else [0]:
                part = pl[y:y + th, x:x + tw]
                if tile:
                    full = np.zeros((th, tw, pl.shape[2]), np.int64)
                    full[:part.shape[0], :part.shape[1]] = part
                    part = full
                rows = _pack_rows(part.reshape(part.shape[0], -1), bps, big_endian)
                if predictor == 2:
                    rows = _difference(rows, bps, pl.shape[2], big_endian)
                chunks.append(encode(b"".join(rows)))
    short, long_, long8 = 3, 4, 16
    tags = {256: (long_, [w]), 257: (long_, [h]), 258: (short, [bps] * n),
            259: (short, [compression]), 262: (short, [photometric]), 277: (short, [n])}
    for tag, value, default in ((266, fillorder, 1), (274, orientation, None),
                                (284, planar, 1), (317, predictor, 1)):
        if value != default and value is not None:
            tags[tag] = (short, [value])
    if colormap is not None:
        tags[320] = (short, list(colormap))
    if extrasamples is not None:
        tags[338] = (short, list(extrasamples))
    if sampleformat is not None:
        tags[339] = (short, [sampleformat] * n)
    offset_tag, count_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags[322], tags[323] = (long_, [tw]), (long_, [th])
    else:
        tags[278] = (long_, [th])
    tags[count_tag] = (long8 if bigtiff else long_, [len(c) for c in chunks])
    tags.update(dict(extra_tags))
    fmt = {3: "H", 4: "I", 16: "Q"}
    inline, entry_size, head = (8, 20, 16) if bigtiff else (4, 12, 8)

    def directory(at, offsets):
        t = dict(tags)
        t[offset_tag] = (long8 if bigtiff else long_, offsets)
        for k in omit:
            t.pop(k, None)
        count = struct.pack(e + ("Q" if bigtiff else "H"), len(t))
        values_at = at + len(count) + len(t) * entry_size + inline
        entries, values = b"", b""
        for tag in sorted(t):
            typ, vals = t[tag]
            raw = struct.pack(e + fmt[typ] * len(vals), *vals)
            entries += struct.pack(e + ("HHQ" if bigtiff else "HHI"), tag, typ, len(vals))
            if len(raw) <= inline:
                entries += raw + b"\0" * (inline - len(raw))
            else:
                entries += struct.pack(e + ("Q" if bigtiff else "I"), values_at + len(values))
                values += raw + b"\0" * (len(raw) & 1)
        return count + entries + b"\0" * inline + values
    body = b"".join(c + b"\0" * (len(c) & 1) for c in chunks)

    def data_offsets(start):
        out = []
        for c in chunks:
            out.append(start)
            start += len(c) + (len(c) & 1)
        return out
    if ifd_first:
        size = len(directory(head, data_offsets(0)))
        content = directory(head, data_offsets(head + size)) + body
        at = head
    else:
        at = head + len(body)
        content = body + directory(at, data_offsets(head))
    order = b"MM" if big_endian else b"II"
    if bigtiff:
        return order + struct.pack(e + "HHHQ", 43, 8, 0, at) + content
    return order + struct.pack(e + "HI", 42, at) + content


def _samples(h, w, n, bps, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bps, (h, w, n))


def _cmap(bps, seed, sixteen):
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 65536 if sixteen else 256, 3 << bps))


def _tiff_cases():
    h, w = 21, 37
    rgb8, rgb16 = _samples(h, w, 3, 8, 1), _samples(h, w, 3, 16, 2)
    rgba8, rgba16 = _samples(h, w, 4, 8, 3), _samples(h, w, 4, 16, 4)
    g8, g16, g1 = _samples(h, w, 1, 8, 5), _samples(h, w, 1, 16, 6), _samples(h, w, 1, 1, 7)
    ga8, ga16 = _samples(h, w, 2, 8, 8), _samples(h, w, 2, 16, 9)
    cases = {}
    for comp, name in ((1, "raw"), (32773, "packbits"), (5, "lzw"), (8, "deflate"),
                       (32946, "deflate_old_code")):
        cases[f"rgb8_{name}_strips_of_4"] = tiff_bytes(rgb8, compression=comp, rows_per_strip=4)
        cases[f"rgb16_{name}_tiles_clipped"] = tiff_bytes(rgb16, bps=16, compression=comp,
                                                          tile=(16, 16))
        cases[f"grey8_{name}_tiles_clipped"] = tiff_bytes(g8, compression=comp, tile=(32, 16))
    for comp in (5, 8):
        for bps, im in ((8, rgb8), (16, rgb16)):
            cases[f"predictor_{bps}bit_{comp}"] = tiff_bytes(im, bps=bps, compression=comp,
                                                             predictor=2, rows_per_strip=7)
        cases[f"predictor_grey16_big_endian_{comp}"] = tiff_bytes(
            g16, bps=16, compression=comp, predictor=2, big_endian=True)
    for pm in (0, 1):
        for bps, im in ((1, g1), (8, g8), (16, g16)):
            cases[f"photometric{pm}_{bps}bit"] = tiff_bytes(im, bps=bps, photometric=pm,
                                                            compression=5)
    cases["grey16_tiles_clipped_stride"] = tiff_bytes(g16, bps=16, tile=(48, 16))
    cases["grey_alpha8_tiles_clipped_stride"] = tiff_bytes(ga8, extrasamples=[2], tile=(16, 32))
    cases["grey_alpha16_strips"] = tiff_bytes(ga16, bps=16, extrasamples=[1])
    cases["grey_alpha8_planar_unassociated"] = tiff_bytes(ga8, extrasamples=[2], planar=2,
                                                          rows_per_strip=5)
    for bps in (1, 4, 8):
        for sixteen in (False, True):
            cases[f"palette_{bps}bit_{16 if sixteen else 8}bit_map"] = tiff_bytes(
                _samples(h, w, 1, bps, 10 + bps), bps=bps, photometric=3, compression=32773,
                colormap=_cmap(bps, bps, sixteen))
    cases["palette_without_colour_map"] = tiff_bytes(g8, photometric=3)
    for es in (None, [0], [1], [2]):
        for bps, im in ((8, rgba8), (16, rgba16)):
            cases[f"rgba{bps}_extrasamples_{es and es[0]}"] = tiff_bytes(
                im, bps=bps, extrasamples=es, compression=8)
    cases["rgba8_planar_unassociated_tiles"] = tiff_bytes(rgba8, extrasamples=[2], planar=2,
                                                          tile=(16, 16), compression=5)
    cases["rgb16_planar_big_endian"] = tiff_bytes(rgb16, bps=16, planar=2, big_endian=True)
    cases["bigtiff_little_endian"] = tiff_bytes(rgb8, bigtiff=True, compression=5)
    cases["bigtiff_big_endian_ifd_last"] = tiff_bytes(rgb16, bps=16, bigtiff=True,
                                                      big_endian=True, ifd_first=False)
    cases["fillorder2_lzw"] = tiff_bytes(rgb8, fillorder=2, compression=5)
    cases["fillorder2_raw_1bit"] = tiff_bytes(g1, bps=1, fillorder=2)
    cases["fillorder2_raw_tiles_1024_bytes"] = tiff_bytes(rgba8, fillorder=2, tile=(16, 16))
    for o in (1, 2, 3, 4):
        cases[f"orientation{o}_strips"] = tiff_bytes(rgb8, orientation=o, rows_per_strip=6)
        cases[f"orientation{o}_tiles"] = tiff_bytes(rgb8, orientation=o, tile=(16, 16))
    cases["signed_16bit"] = tiff_bytes(rgb16, bps=16, sampleformat=2)
    cases["unknown_coding_reads_zero"] = tiff_bytes(rgb8, compression=34712)
    return cases


_TIFF_CASES = _tiff_cases()


@pytest.mark.parametrize("name", sorted(_TIFF_CASES))
def test_tiff_written_here_reads_as_cv2(tmp_path, name):
    path = tmp_path / "x.tif"
    path.write_bytes(_TIFF_CASES[name])
    assert cv2.imread(str(path)) is not None, name
    assert_same(path)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
def test_tiff_of_cv2_reads_as_cv2(tmp_path, compression):
    im = scene(23, 41, seed=compression)
    for k, img in enumerate((im, im[..., 2], im.astype(np.uint16) * 257 + 3,
                             im[..., 0].astype(np.uint16) * 251)):
        path = tmp_path / f"x{k}.tif"
        assert cv2.imwrite(str(path), img, [cv2.IMWRITE_TIFF_COMPRESSION, compression])
        assert_same(path)


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "RGBA", "I;16"])
def test_tiff_of_pillow_reads_as_cv2(tmp_path, mode):
    im = scene(19, 27, seed=2)
    rgb = Image.fromarray(im[..., ::-1].copy())
    img = {"1": rgb.convert("1"), "L": rgb.convert("L"), "P": rgb.convert("P"),
           "LA": rgb.convert("LA"),
           "RGBA": Image.fromarray(np.dstack([im[..., ::-1], im[..., :1]])),
           "I;16": Image.fromarray(im[..., 0].astype(np.uint16) * 257)}[mode]
    path = tmp_path / "x.tif"
    img.save(path, compression="tiff_lzw" if mode != "1" else "raw")
    assert_same(path)
    named = tmp_path / "tiff_named.jpg"  # found by content, not by name
    named.write_bytes(path.read_bytes())
    assert np.array_equal(imread(str(named)), cv2.imread(str(path)))


def _tiff_unread():
    """Files cv2.imread reads as None, and the port too."""
    rgb8 = _samples(9, 14, 3, 8, 1)
    g = _samples(9, 14, 1, 8, 2)
    out = {f"orientation{o}": tiff_bytes(rgb8, orientation=o) for o in (5, 6, 7, 8)}
    out["grey_2bit"] = tiff_bytes(g >> 6, bps=2)
    out["grey_4bit"] = tiff_bytes(g >> 4, bps=4, compression=5)
    out["palette_2bit"] = tiff_bytes(g >> 6, bps=2, photometric=3, colormap=_cmap(2, 1, False))
    out["rgb_32bit"] = tiff_bytes(rgb8, bps=32)
    out["float_32bit"] = tiff_bytes(np.float32(rgb8 / 255).view(np.uint32), bps=32,
                                    sampleformat=3)
    out["rgb_4bit"] = tiff_bytes(rgb8 >> 4, bps=4)
    out["photometric_mask"] = tiff_bytes(g >> 7, bps=1, photometric=4)
    out["zstd_not_built"] = tiff_bytes(rgb8, compression=50000)
    out["fillorder2_raw_tiles_512_bytes"] = tiff_bytes(g, fillorder=2, tile=(16, 32))
    good = tiff_bytes(rgb8, compression=5, rows_per_strip=3)
    out["strip_past_end"] = tiff_bytes(rgb8, ifd_first=True)[:-30]
    out["directory_past_end"] = good[:4] + struct.pack("<I", len(good) + 8) + good[8:]
    out["no_image_width"] = tiff_bytes(rgb8, omit=(256,))
    out["no_strip_offsets"] = tiff_bytes(rgb8, omit=(273,))
    out["compression_of_two_values"] = tiff_bytes(rgb8, extra_tags=[(259, (4, [5, 1]))])
    out["bad_magic_read_as_nothing"] = b"II\x2b\x00" + good[4:]
    return out


_TIFF_UNREAD = _tiff_unread()


@pytest.mark.parametrize("name", sorted(_TIFF_UNREAD))
def test_tiff_none_as_cv2(tmp_path, name):
    path = tmp_path / "x.tif"
    path.write_bytes(_TIFF_UNREAD[name])
    assert cv2.imread(str(path)) is None and cv2.imread(str(path), 0) is None
    assert imread(str(path)) is None and imread(str(path), grayscale=True) is None


@pytest.mark.parametrize("name", ["rgb8_lzw_strips_of_4", "grey8_deflate_tiles_clipped",
                                  "bigtiff_big_endian_ifd_last",
                                  "rgba8_planar_unassociated_tiles", "palette_8bit_16bit_map"])
def test_tiff_cut_as_cv2(tmp_path, name):
    assert_cuts(tmp_path / "x.tif", _TIFF_CASES[name])


@pytest.mark.parametrize("compression", [5, 8, 32773])
def test_tiff_damaged_data_as_cv2(tmp_path, compression):
    """Strip data damaged in a few bytes: libtiff's decoder stops, the rows it
    wrote stay, the rest of the strip is 0, and no predictor runs."""
    im = _samples(30, 40, 3, 8, 5)
    data = bytearray(tiff_bytes(im, compression=compression, rows_per_strip=10,
                                predictor=2 if compression != 32773 else 1))
    start = data.index(b"\x78") if compression == 8 else 8 + 1000
    rng = np.random.default_rng(compression)
    path = tmp_path / "x.tif"
    for _ in range(4):
        d = bytearray(data)
        for at in rng.integers(start, min(start + 600, len(d) - 200), 2):
            d[at] ^= 0x5a
        path.write_bytes(bytes(d))
        assert_same(path)


def _codings():
    """(coding, file bytes) of the TIFF codings Pillow writes that the port
    once refused by name: JPEG (RGB and YCbCr), CCITT RLE, Group 3 and
    Group 4, YCbCr, Separated (CMYK), CIELab and old-style LZW, all decoded
    now."""
    import io

    im = scene(24, 32, seed=3)
    rgb = Image.fromarray(im[..., ::-1].copy())
    bw = rgb.convert("1")
    out = []
    for what, img, kw in (("JPEG", rgb, dict(compression="jpeg")),
                          ("JPEG", rgb.convert("YCbCr"), dict(compression="jpeg")),
                          ("CCITT RLE", bw, dict(compression="tiff_ccitt")),
                          ("CCITT Group 3", bw, dict(compression="group3")),
                          ("CCITT Group 4", bw, dict(compression="group4")),
                          ("YCbCr", rgb.convert("YCbCr"), dict(compression="raw")),
                          ("Separated (CMYK)", rgb.convert("CMYK"), dict(compression="raw")),
                          ("CIELab", rgb.convert("LAB"), dict(compression="raw"))):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **kw)
        out.append((what, buf.getvalue()))
    out.append(("old-style LZW", tiff_bytes(im, compression=5, old_lzw=True)))
    return out


@pytest.mark.parametrize("k", range(9))
def test_tiff_codings_decoded_as_cv2(tmp_path, k):
    """Pillow's JPEG (from RGB and from YCbCr), CCITT RLE, Group 3, Group 4,
    YCbCr, CMYK and CIELab TIFFs and old-style LZW strips read as cv2 reads
    them, in both modes."""
    what, data = _codings()[k]
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    assert cv2.imread(str(path)) is not None and cv2.imread(str(path), 0) is not None, what
    assert_same(path)


def _sgilog24(k):
    """Float colour for cv2.imwrite's SGILog24 TIFF (IMWRITE_TIFF_COMPRESSION
    34677): a scene, or random luminances."""
    im = scene(24, 32, seed=3).astype(np.float32) / 200
    if k:
        im = np.exp(np.random.default_rng(k).normal(-1, 1.5, im.shape)).astype(np.float32)
    return im


@pytest.mark.parametrize("k", range(2))
def test_tiff_codings_refused_by_name(tmp_path, k):
    """No TIFF coding cv2 reads is refused by name any more: the last one,
    cv2's SGILog24 (its uv index through libtiff's uvcode.h table), reads as
    cv2 reads it in both modes, without raising."""
    path = tmp_path / "x.tif"
    assert cv2.imwrite(str(path), _sgilog24(k), [cv2.IMWRITE_TIFF_COMPRESSION, 34677])
    assert cv2.imread(str(path)) is not None and cv2.imread(str(path), 0) is not None
    assert_same(path)
