"""The port's image reader (``fots_torch.imageio.imread``, the host decoder of
``fots_torch/csrc/image_decode.cpp``) against ``cv2.imread``, byte for byte,
in colour (BGR) and grayscale:

- the committed jpgs (``data/synth``, ``data/synth_small``) and the
  held-out scenes of ``fots_torch/assets/heldout_eval_jpg``;
- ``cv2.imwrite`` outputs at quality 50/75/95/100 under every
  ``IMWRITE_JPEG_SAMPLING_FACTOR`` (4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1:
  the decoder reads all five, 4:1:1 through box replication as libjpeg's
  generic upsampler does), restart intervals 0, 1 and 7, sides 1x1, 2x3,
  7x9, 17x33 and 641x959;
- grayscale JPEGs and the EXIF orientations 1-8 (an APP1 segment spliced
  in, both byte orders; 0 and 9 leave the image as it is);
- 8-bit PNGs of every supported colour type (gray, RGB, palette, gray +
  alpha, RGBA) through each of the five scanline filters, and
  ``cv2.imwrite``'s own PNGs.

Also byte for byte:

- progressive JPEGs of ``cv2``'s writer (``IMWRITE_JPEG_PROGRESSIVE``:
  libjpeg's ``jpeg_simple_progression``) at every quality, sampling,
  restart interval and side above, grey, and with the EXIF orientations 1-8
  spliced in; and files of a scan script of this module's own writer
  (non-interleaved DC scans, spectral bands split as mozjpeg splits them,
  successive approximation from ``Al`` = 2, EOB runs across blocks within
  restart intervals, Huffman tables redefined before every scan, and a DQT
  between scans that the latched tables ignore);
- sequential JPEGs cut anywhere, from inside the headers to two bytes before
  the end (``None`` exactly where ``cv2.imread`` gives None);
- PNGs of every colour type at depths 1, 2, 4, 8 and 16, Adam7-interlaced
  or not (sides below 8 pixels, where passes are empty), with ``tRNS``, and
  with an ``eXIf`` orientation;
- truncated or corrupt PNGs read as ``None``, as ``cv2`` reads them.

Frame headers against ``cv2`` (``FRAME_CASES``): ``None`` exactly where
``cv2.imread`` gives None (2 or 5-10 components, 12- and 16-bit samples, an
MCU of more than 10 blocks, non-integral sampling of a component the output
needs, a missing Huffman table other than a sequential frame's 0 and 1,
lossless frames libjpeg cannot convert or decode), and ``ValueError`` only
where it reads the file: a progressive JPEG that libjpeg would block-smooth
(one cut short, unless a zero among the quantizers Q00..Q30 stops the
smoothing), arithmetic coding, lossless frames, 4 components, RGB-coded
frames, and a gamma-tagged colour PNG read as grayscale.  A missing file and
one that is neither JPEG nor PNG give ``None``.
"""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from fots_torch.imageio import imread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIDES = ((1, 1), (2, 3), (7, 9), (17, 33), (641, 959))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def assert_reads_as_cv2(path):
    for gray in (False, True):
        got = imread(str(path), grayscale=gray)
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        assert want is not None and got is not None, path
        assert got.dtype == np.uint8 and got.shape == want.shape, (path, gray, got.shape)
        assert np.array_equal(got, want), (path, gray, int(np.abs(
            got.astype(int) - want.astype(int)).max()))


def scene(h, w, seed=0):
    """Smooth gradients with noise: every DCT band and chroma edge in play."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    im = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 7 % 256], -1)
    return (im + rng.integers(-40, 40, im.shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("folder", ["data/synth", "data/synth_small",
                                    "fots_torch/assets/heldout_eval_jpg"])
def test_committed_jpgs_read_as_cv2(folder):
    files = sorted(glob.glob(os.path.join(REPO, folder, "*.jpg")))
    assert len(files) >= 6
    for f in files:
        assert_reads_as_cv2(f)


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_cv2_encodes_read_as_cv2(tmp_path, quality, sampling):
    for h, w in SIDES:
        im = scene(h, w, seed=quality)
        for rst in (0, 1, 7):
            path = tmp_path / f"{h}x{w}_{rst}.jpg"
            assert cv2.imwrite(str(path), im, [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            assert_reads_as_cv2(path)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_grayscale_jpegs_read_as_cv2(tmp_path, quality):
    for h, w in SIDES:
        path = tmp_path / f"g{h}x{w}.jpg"
        assert cv2.imwrite(str(path), scene(h, w, seed=3)[..., 1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert_reads_as_cv2(path)


def _tiff_orientation(orientation, intel):
    e = "<" if intel else ">"
    return ((b"II*\x00" if intel else b"MM\x00*") + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4)


@pytest.mark.parametrize("intel", [True, False])
@pytest.mark.parametrize("orientation", range(10))
def test_exif_orientation_applied_as_cv2(tmp_path, orientation, intel):
    ok, enc = cv2.imencode(".jpg", scene(37, 53), [cv2.IMWRITE_JPEG_QUALITY, 90])
    payload = b"Exif\x00\x00" + _tiff_orientation(orientation, intel)
    app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    path = tmp_path / "o.jpg"
    path.write_bytes(enc.tobytes()[:2] + app1 + enc.tobytes()[2:])
    assert_reads_as_cv2(path)
    if orientation in (5, 6, 7, 8):
        assert imread(str(path)).shape[:2] == (53, 37)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered(rows, bpp, filters):
    """The scanlines with filter ``filters[y % n]`` applied, as an encoder
    writes them."""
    out, prev = b"", bytes(len(rows[0]))
    for y, row in enumerate(rows):
        f = filters[y % len(filters)]
        enc = bytearray(len(row))
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            p = a + b - c
            paeth = a if abs(p - a) <= min(abs(p - b), abs(p - c)) else (
                b if abs(p - b) <= abs(p - c) else c)
            pred = (0, a, b, (a + b) // 2, paeth)[f]
            enc[i] = (row[i] - pred) & 255
        out += bytes([f]) + bytes(enc)
        prev = row
    return out


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # first column, first row, column step, row step of each pass


def _scanlines(samples, depth):
    """Rows of ``samples`` packed at ``depth``: sub-byte samples from the most
    significant bit, rows padded to whole bytes; 16 bits big-endian."""
    rows = []
    for r in samples.reshape(samples.shape[0], -1):
        if depth < 8:
            per, packed = 8 // depth, bytearray((len(r) * depth + 7) // 8)
            for i, v in enumerate(r):
                packed[i // per] |= int(v) << (8 - depth * (i % per + 1))
            rows.append(bytes(packed))
        else:
            rows.append(r.astype(">u2" if depth == 16 else np.uint8).tobytes())
    return rows


def png_bytes(samples, depth, color_type, palette=None, filters=(0,), extra=b"", interlace=0):
    """A PNG of ``samples`` ([H, W] or [H, W, channels]); with ``interlace``
    the seven Adam7 passes, each filtered on its own, an empty pass left out."""
    h, w = samples.shape[:2]
    bpp = max(1, PNG_CHANNELS[color_type] * depth // 8)
    passes = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace
              else [samples])
    raw = b"".join(_filtered(_scanlines(p, depth), bpp, filters) for p in passes
                   if p.shape[0] and p.shape[1])
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                               color_type, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    return data + extra + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def write_png(path, samples, depth, color_type, palette=None, filters=(0,), extra=b"",
              interlace=0):
    path.write_bytes(png_bytes(samples, depth, color_type, palette, filters, extra, interlace))


def png_samples(color_type, depth, h=13, w=19):
    """(samples, palette) of a random image of ``color_type`` at ``depth``."""
    rng = np.random.default_rng(color_type * 10 + depth)
    palette = None
    if color_type in (0, 3):
        samples = rng.integers(0, 2 ** depth, (h, w))
        if color_type == 3:  # a short palette: indices past it read as black
            palette = rng.integers(0, 256, (min(2 ** depth, 200), 3)).astype(np.uint8)
    else:
        samples = rng.integers(0, 2 ** depth, (h, w, PNG_CHANNELS[color_type]))
        samples[:3, :, 1:3] = samples[:3, :, :1]  # gray pixels in colour rows
    return samples, palette


@pytest.mark.parametrize("color_type", [0, 2, 3, 4, 6])
def test_png_types_and_filters_read_as_cv2(tmp_path, color_type):
    samples, palette = png_samples(color_type, 8)
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        path = tmp_path / f"f{''.join(map(str, filters))}.png"
        write_png(path, samples, 8, color_type, palette, filters)
        assert_reads_as_cv2(path)


@pytest.mark.parametrize("color_type,depth", [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4)])
def test_png_below_8_bits_read_as_cv2(tmp_path, color_type, depth):
    """Gray and palette PNGs below 8 bits."""
    samples, palette = png_samples(color_type, depth)
    path = tmp_path / "low.png"
    write_png(path, samples, depth, color_type, palette, (0, 1, 2, 3, 4))
    assert_reads_as_cv2(path)
    if color_type == 0:  # png_set_expand_gray_1_2_4_to_8
        assert np.array_equal(imread(str(path), grayscale=True),
                              samples * (255 // (2 ** depth - 1)))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_written_pngs_read_as_cv2(tmp_path, channels):
    im = np.random.default_rng(channels).integers(0, 256, (21, 17, channels)).astype(np.uint8)
    path = tmp_path / "cv.png"
    assert cv2.imwrite(str(path), im)
    assert_reads_as_cv2(path)


def test_png_exif_orientation_read_as_cv2(tmp_path):
    """An eXIf orientation, applied as cv2 applies it: before and after
    IDAT, the first of two, and none from a chunk with a CRC error or
    without the TIFF header."""
    im = np.random.default_rng(6).integers(0, 256, (5, 7, 3))
    path = tmp_path / "o.png"
    write_png(path, im, 8, 2, extra=_chunk(b"eXIf", _tiff_orientation(6, False)))
    assert cv2.imread(str(path)).shape[:2] == (7, 5)  # cv2 applies the orientation
    assert_reads_as_cv2(path)
    data = png_bytes(im, 8, 2)
    iend = data.rindex(b"IEND") - 4
    bad_crc = bytearray(_chunk(b"eXIf", _tiff_orientation(6, True)))
    bad_crc[-1] ^= 1
    for extra in (_chunk(b"eXIf", _tiff_orientation(8, True)),
                  _chunk(b"eXIf", _tiff_orientation(3, False))
                  + _chunk(b"eXIf", _tiff_orientation(6, False)),
                  bytes(bad_crc), _chunk(b"eXIf", b"Exif\x00\x00" + _tiff_orientation(6, True))):
        path.write_bytes(data[:iend] + extra + data[iend:])
        assert_reads_as_cv2(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientations_read_as_cv2(tmp_path, orientation):
    samples, palette = png_samples(3, 4, h=6, w=11)
    path = tmp_path / "o.png"
    write_png(path, samples, 4, 3, palette, (0, 4), interlace=1,
              extra=_chunk(b"eXIf", _tiff_orientation(orientation, orientation % 2 == 0)))
    assert_reads_as_cv2(path)


PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


@pytest.mark.parametrize("color_type,depth", [(c, d) for c, ds in PNG_DEPTHS.items()
                                              for d in ds])
def test_png_adam7_read_as_cv2(tmp_path, color_type, depth):
    """Adam7 at every colour type and depth, at sides where passes are
    empty (1x1 has one pass) and at sides past one 8x8 tile, with every
    filter; the same image without interlacing reads the same."""
    for h, w in ((1, 1), (1, 5), (3, 2), (5, 7), (13, 19)):
        samples, palette = png_samples(color_type, depth, h, w)
        path, flat = tmp_path / f"i{h}x{w}.png", tmp_path / f"f{h}x{w}.png"
        write_png(path, samples, depth, color_type, palette, (0, 1, 2, 3, 4), interlace=1)
        write_png(flat, samples, depth, color_type, palette, (4, 3, 2, 1, 0))
        assert_reads_as_cv2(path)
        assert np.array_equal(imread(str(path)), imread(str(flat)))


@pytest.mark.parametrize("color_type", [0, 2, 4, 6])
def test_png_16_bits_read_as_cv2(tmp_path, color_type):
    """16-bit samples: the high byte (png_set_strip_16), and for grey output
    of colour libpng's rgb_to_gray at 16 bits, rounded, before the strip."""
    samples, _ = png_samples(color_type, 16, h=37, w=41)
    path = tmp_path / "deep.png"
    write_png(path, samples, 16, color_type, filters=(0, 1, 2, 3, 4))
    assert_reads_as_cv2(path)
    if color_type in (2, 6):
        r, g, b = (samples[..., i].astype(np.int64) for i in range(3))
        assert np.array_equal(imread(str(path), grayscale=True),
                              ((9797 * r + 19234 * g + 3737 * b + 16384) >> 15) >> 8)


@pytest.mark.parametrize("color_type,depth,trns", [
    (0, 2, struct.pack(">H", 2)), (0, 16, struct.pack(">H", 517)),
    (2, 8, struct.pack(">HHH", 1, 2, 3)), (3, 8, bytes([0, 128, 255]))])
def test_png_trns_read_as_cv2(tmp_path, color_type, depth, trns):
    samples, palette = png_samples(color_type, depth, h=9, w=10)
    path = tmp_path / "t.png"
    write_png(path, samples, depth, color_type, palette, (1,), extra=_chunk(b"tRNS", trns))
    assert_reads_as_cv2(path)


def _png_damages(data):
    """(name, bytes) of damaged copies of a PNG of one IDAT chunk."""
    i = data.index(b"IDAT") - 4
    n = struct.unpack(">I", data[i:i + 4])[0]
    z = data[i + 8:i + 8 + n]
    raw = zlib.decompress(z)
    head, tail = data[:i], data[i + 12 + n:]
    flip = bytearray(data)
    flip[i + 8 + n + 3] ^= 1
    flush = zlib.compressobj()
    return {
        "idat_crc": bytes(flip),
        "zlib_cut": head + _chunk(b"IDAT", z[:-6]) + tail,
        "zlib_not_ended": head + _chunk(b"IDAT", flush.compress(raw)
                                        + flush.flush(zlib.Z_SYNC_FLUSH)) + tail,
        "adler": head + _chunk(b"IDAT", z[:-1] + bytes([z[-1] ^ 1])) + tail,
        "short_rows": head + _chunk(b"IDAT", zlib.compress(raw[:-3])) + tail,
        "bad_filter": head + _chunk(b"IDAT", zlib.compress(bytes([9]) + raw[1:])) + tail,
        "idat_split": head + _chunk(b"IDAT", z[:9]) + _chunk(b"tEXt", b"a\x00b")
        + _chunk(b"IDAT", z[9:]) + tail,
        "unknown_critical": head + _chunk(b"ABCD", b"x") + data[i:],
        "ihdr_not_first": data[:8] + _chunk(b"tEXt", b"a\x00b") + data[8:],
        "no_plte": data.replace(b"PLTE", b"PLTf", 1),
    }


@pytest.mark.parametrize("damage", sorted(_png_damages(png_bytes(
    np.zeros((2, 2), np.uint8), 8, 3, np.zeros((1, 3), np.uint8)))))
def test_damaged_pngs_read_as_nothing_as_cv2(tmp_path, damage):
    samples, palette = png_samples(3, 8, h=11, w=12)
    data = png_bytes(samples, 8, 3, palette, (0, 1, 2, 3, 4))
    path = tmp_path / "d.png"
    path.write_bytes(_png_damages(data)[damage])
    for gray in (False, True):
        assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR) is None
        assert imread(str(path), grayscale=gray) is None


def test_cut_pngs_read_as_nothing_as_cv2(tmp_path):
    path = tmp_path / "cut.png"
    data = png_bytes(*png_samples(2, 16, h=7, w=9)[:1], 16, 2, filters=(1,), interlace=1)
    ok = tmp_path / "ok.png"
    ok.write_bytes(data[:-12] + _chunk(b"tEXt", b"a\x00b") + data[-12:])
    assert_reads_as_cv2(ok)  # an ancillary chunk after IDAT
    for cut in list(range(8, len(data), 7)) + [len(data) - 4, len(data) - 1]:
        path.write_bytes(data[:cut])
        assert cv2.imread(str(path)) is None and imread(str(path)) is None, cut


# --------------------------------------------------------------------------
# progressive JPEG
# --------------------------------------------------------------------------

def _progressive(path, im, **params):
    flags = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    for k, v in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    assert cv2.imwrite(str(path), im, flags)
    assert b"\xff\xc2" in path.read_bytes()


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_progressive_cv2_encodes_read_as_cv2(tmp_path, quality, sampling):
    """cv2's progressive writer (libjpeg's jpeg_simple_progression: 10 scans
    of colour), every sampling, restart intervals 0, 1 and 7."""
    for h, w in SIDES[:-1]:
        im = scene(h, w, seed=quality + 1)
        for rst in (0, 1, 7):
            path = tmp_path / f"{h}x{w}_{rst}.jpg"
            _progressive(path, im, quality=quality, sampling_factor=SAMPLING[sampling],
                         rst_interval=rst)
            assert_reads_as_cv2(path)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_progressive_grayscale_jpegs_read_as_cv2(tmp_path, quality):
    """One component: 6 scans."""
    for h, w in SIDES[:-1]:
        path = tmp_path / f"g{h}x{w}.jpg"
        _progressive(path, scene(h, w, seed=5)[..., 2], quality=quality, rst_interval=h % 3)
        assert_reads_as_cv2(path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_progressive_exif_orientation_applied_as_cv2(tmp_path, orientation):
    path = tmp_path / "p.jpg"
    _progressive(path, scene(29, 43, seed=orientation), quality=90)
    payload = b"Exif\x00\x00" + _tiff_orientation(orientation, orientation > 4)
    data = path.read_bytes()
    path.write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
                     + data[2:])
    assert_reads_as_cv2(path)


# The entropy coding of jcphuff.c, for scan scripts cv2's writer does not write.

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
    56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
    113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])  # natural


def _huffman_table(symbols, lengths):
    """{symbol: (code, length)} of a canonical table and its DHT counts."""
    counts = [0] * 16
    for n in lengths:
        counts[n - 1] += 1
    codes, code, prev = {}, 0, lengths[0]
    for sym, n in zip(symbols, lengths):
        code <<= n - prev
        prev = n
        codes[sym] = (code, n)
        code += 1
    return codes, bytes(counts) + bytes(symbols)


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, n):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 255
            self.out += bytes([byte, 0]) if byte == 255 else bytes([byte])
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self):  # pad with one bits, as libjpeg does
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v):
    n = abs(v).bit_length()
    return n, (v if v >= 0 else v - 1) & ((1 << n) - 1)


def _scan_data(blocks, comps, mcu, kind, ss, se, ah, al, restart, dc_codes, ac_codes):
    """One scan's entropy-coded bytes (with its restart markers).
    ``blocks[c]``: [rows, cols, 64] natural-order coefficients of component
    ``c``; ``comps``: (index, h, v, width_in_blocks, height_in_blocks)."""
    bits = _Bits()
    state = {"eobrun": 0, "be": [], "last": [0] * len(comps)}

    def sym(codes, s):
        bits.put(*codes[s])

    def flush_eobrun():
        if state["eobrun"]:
            n = state["eobrun"].bit_length() - 1
            sym(ac_codes, n << 4)
            if n:
                bits.put(state["eobrun"], n)
            state["eobrun"] = 0
        for b in state["be"]:
            bits.put(b, 1)
        state["be"] = []

    def block(ci, coef):
        if kind == "dc_first":
            v = int(coef[0]) >> al
            n, m = _magnitude(v - state["last"][ci])
            state["last"][ci] = v
            sym(dc_codes, n)
            bits.put(m, n)
        elif kind == "dc_refine":
            bits.put((int(coef[0]) >> al) & 1, 1)
        elif kind == "ac_first":
            r = 0
            for k in range(ss, se + 1):
                c = int(coef[ZIGZAG[k]])
                t = abs(c) >> al
                if t == 0:
                    r += 1
                    continue
                flush_eobrun()
                while r > 15:
                    sym(ac_codes, 0xF0)
                    r -= 16
                n = t.bit_length()
                sym(ac_codes, (r << 4) + n)
                bits.put(t if c >= 0 else ~t, n)
                r = 0
            if r:
                state["eobrun"] += 1
                if state["eobrun"] == 0x7FFF:
                    flush_eobrun()
        else:  # ac_refine
            absv = {k: abs(int(coef[ZIGZAG[k]])) >> al for k in range(ss, se + 1)}
            eob = max([k for k, t in absv.items() if t == 1], default=0)
            r, br = 0, []
            for k in range(ss, se + 1):
                t = absv[k]
                if t == 0:
                    r += 1
                    continue
                while r > 15 and k <= eob:
                    flush_eobrun()
                    sym(ac_codes, 0xF0)
                    r -= 16
                    for b in br:
                        bits.put(b, 1)
                    br = []
                if t > 1:
                    br.append(t & 1)
                    continue
                flush_eobrun()
                sym(ac_codes, (r << 4) + 1)
                bits.put(int(coef[ZIGZAG[k]]) >= 0, 1)
                for b in br:
                    bits.put(b, 1)
                br, r = [], 0
            if r or br:
                state["eobrun"] += 1
                state["be"] += br
                if state["eobrun"] == 0x7FFF or len(state["be"]) > 1000 - 63:
                    flush_eobrun()

    if len(comps) == 1:
        ci, _, _, wb, hb = comps[0]
        units = [[(0, by, bx)] for by in range(hb) for bx in range(wb)]
    else:
        units = [[(i, my * v + y, mx * h + x) for i, (_, h, v, _, _) in enumerate(comps)
                  for y in range(v) for x in range(h)]
                 for my in range(mcu[0]) for mx in range(mcu[1])]
    out = bytearray()
    for m, unit in enumerate(units):
        if restart and m and m % restart == 0:
            flush_eobrun()
            bits.flush()
            out += bits.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            bits.out = bytearray()
            state["last"] = [0] * len(comps)
        for i, by, bx in unit:
            block(i, blocks[comps[i][0]][by, bx])
    flush_eobrun()
    bits.flush()
    return bytes(out + bits.out)


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def hand_scripted_progressive(im, restart=5):
    """A progressive JPEG of ``im`` (BGR or grey) with a scan script of its
    own: a non-interleaved DC scan of Y, an interleaved one of Cb and Cr, Y's
    AC split into bands 1-2, 3-9 and 10-63 at Al = 2 (as mozjpeg splits them),
    refined to Al = 1 and 0, the chroma AC at Al = 1 then 0, DC refined from
    Al = 1, restart markers every ``restart`` MCUs, Huffman tables redefined
    before every scan, and a DQT between scans that libjpeg's latched tables
    ignore.  4:2:0 for colour."""
    colour = im.ndim == 3
    planes = [cv2.cvtColor(im, cv2.COLOR_BGR2YCrCb)[..., i] for i in (0, 2, 1)] if colour \
        else [im]
    hv = [(2, 2), (1, 1), (1, 1)] if colour else [(1, 1)]
    hmax, vmax = hv[0]
    H, W = im.shape[:2]
    mcu = (-(-H // (8 * vmax)), -(-W // (8 * hmax)))
    quant = [np.clip(LUMA_Q * 3 // 4, 1, 255), np.clip(LUMA_Q, 1, 255)]
    dct = np.array([[np.cos((2 * x + 1) * u * np.pi / 16) * (0.5 if u else 0.5 ** 1.5)
                     for x in range(8)] for u in range(8)])
    blocks, comps = [], []
    for ci, (plane, (h, v)) in enumerate(zip(planes, hv)):
        if (h, v) != (hmax, vmax):  # 2x2 averages
            plane = cv2.resize(plane, (-(-W // 2), -(-H // 2)), interpolation=cv2.INTER_AREA)
        ph, pw = mcu[0] * 8 * v, mcu[1] * 8 * h
        p = np.pad(plane.astype(np.float64) - 128, ((0, ph - plane.shape[0]),
                                                    (0, pw - plane.shape[1])), mode="edge")
        t = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", dct, t, dct).reshape(ph // 8, pw // 8, 64)
        blocks.append(np.round(coef / quant[min(ci, 1)]).astype(np.int64))
        comps.append((ci, h, v, -(-plane.shape[1] // 8), -(-plane.shape[0] // 8)))
    dc_codes, dc_dht = _huffman_table(list(range(12)), [4] * 12)
    ac_syms = list(range(256))
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, b"".join(bytes([i]) + bytes(q[ZIGZAG].astype(np.uint8))
                                   for i, q in enumerate(quant)))
    out += _segment(0xC2, struct.pack(">BHHB", 8, H, W, len(planes)) + b"".join(
        bytes([ci + 1, (h << 4) | v, min(ci, 1)]) for ci, (h, v) in enumerate(hv)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    y, chroma = [comps[0]], comps[1:]
    script = [("dc_first", y, 0, 0, 0, 1), ("dc_first", chroma, 0, 0, 0, 1),
              ("ac_first", y, 1, 2, 0, 2), ("ac_first", y, 3, 9, 0, 2),
              ("ac_first", y, 10, 63, 0, 2)]
    script += [("ac_first", [c], 1, 63, 0, 1) for c in chroma] + ["dqt"]
    script += [("ac_refine", y, 1, 63, 2, 1), ("dc_refine", y, 0, 0, 1, 0),
               ("dc_refine", chroma, 0, 0, 1, 0), ("ac_refine", y, 1, 63, 1, 0)]
    script += [("ac_refine", [c], 1, 63, 1, 0) for c in chroma]
    for n, scan in enumerate(s for s in script if s == "dqt" or s[1]):
        if scan == "dqt":  # table 0 redefined: no effect on a latched component
            out += _segment(0xDB, b"\x00" + bytes(np.full(64, 3, np.uint8)))
            continue
        kind, sc, ss, se, ah, al = scan
        ac_syms = ac_syms[::-1] if n % 2 else ac_syms  # a new table every scan
        ac_codes, ac_dht = _huffman_table(ac_syms, [8] * 254 + [9] * 2)
        tid = n % 2
        out += _segment(0xC4, bytes([tid]) + dc_dht + bytes([0x10 | tid]) + ac_dht)
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(
            bytes([c[0] + 1, (tid << 4) | tid]) for c in sc) + bytes([ss, se, (ah << 4) | al]))
        out += _scan_data(blocks, sc, mcu, kind, ss, se, ah, al, restart, dc_codes, ac_codes)
    return out + b"\xff\xd9"


@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("colour", [True, False])
def test_hand_scripted_progressive_read_as_cv2(tmp_path, colour, restart):
    im = scene(37, 53, seed=21)
    path = tmp_path / "hand.jpg"
    path.write_bytes(hand_scripted_progressive(im if colour else im[..., 0], restart))
    assert_reads_as_cv2(path)


@pytest.mark.parametrize("natural,smoothed", [(16, False), (24, False), (4, True), (32, True)])
def test_incomplete_progressive_zero_quantizer(tmp_path, natural, smoothed):
    """libjpeg block-smooths only where the ten quantizers Q00..Q30 (the first
    ten in zigzag order: natural positions 0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
    are non-zero.  Y's latched table gets a zero at one natural position and
    the file stops before its last four scans: a zero among the ten means no
    smoothing (read as cv2 reads it), one elsewhere leaves the file refused."""
    data = bytearray(hand_scripted_progressive(scene(37, 53, seed=22), restart=0))
    dqt = data.index(b"\xff\xdb")
    data[dqt + 5 + list(ZIGZAG).index(natural)] = 0  # table 0, zigzag order
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    path = tmp_path / "q.jpg"
    path.write_bytes(bytes(data[:scans[-4]]))
    if smoothed:
        assert cv2.imread(str(path)) is not None
        with pytest.raises(ValueError, match="incomplete progressive JPEG"):
            imread(str(path))
    else:
        assert_reads_as_cv2(path)


# --------------------------------------------------------------------------
# frame headers: None exactly where cv2 gives None
# --------------------------------------------------------------------------

def dc_only_jpeg(hv, sof=0xC0, precision=8, ids=None, app=b"", scans=None, dht=True, tid=0,
                 params=None, h=16, w=24):
    """A JPEG whose blocks hold DC values only, of components sampled ``hv``,
    each scan of ``scans`` (default: one of every component) coded in one
    interleaved or non-interleaved pass; ``params``: (Ss, Se, Ah << 4 | Al)
    (default: sequential, or a lossless frame's predictor 1)."""
    lossless = sof in (0xC3, 0xCB)
    ids = ids or list(range(1, len(hv) + 1))
    hmax, vmax = max(a for a, _ in hv), max(b for _, b in hv)
    dc_codes, dc_dht = _huffman_table(list(range(12)), [4] * 12)
    ac_codes, ac_dht = _huffman_table([0], [1])
    out = b"\xff\xd8" + app + (b"" if lossless else _segment(0xDB, b"\x00" + bytes([2] * 64)))
    out += _segment(sof, struct.pack(">BHHB", precision, h, w, len(hv)) + b"".join(
        bytes([i, (a << 4) | b, 0]) for i, (a, b) in zip(ids, hv)))
    if dht:
        out += _segment(0xC4, bytes([tid]) + dc_dht + (b"" if lossless else bytes([0x10 | tid])
                                                       + ac_dht))
    params = params or ((1, 0, 0) if lossless else (0, 63, 0))
    for sc in scans or [list(range(len(hv)))]:
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(bytes([ids[c], tid * 17]) for c in sc)
                        + bytes(params))
        bits, last = _Bits(), dict.fromkeys(sc, 0)
        mcu = [[(c, k) for c in sc for k in range(hv[c][0] * hv[c][1])]
               for _ in range(-(-h // (8 * vmax)) * -(-w // (8 * hmax)))]
        if len(sc) == 1:
            a, b = hv[sc[0]]
            mcu = [[(sc[0], 0)]] * (-(-w * a // (8 * hmax)) * -(-h * b // (8 * vmax)))
        for m, unit in enumerate(mcu):
            for c, k in unit:
                v = (m * 7 + k * 5 + c * 3) % 40 - 20
                n, bits_v = _magnitude(v - last[c])
                last[c] = v
                bits.put(*dc_codes[n])
                bits.put(bits_v, n)
                if params[:2] == (0, 63):
                    bits.put(*ac_codes[0])
        bits.flush()
        out += bytes(bits.out)
    return out + b"\xff\xd9"


_JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _adobe(transform):
    return _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


_420 = [(2, 2), (1, 1), (1, 1)]
# name -> (file, (colour, grey)): "same" = read byte for byte as cv2 reads it,
# None = cv2 gives None, else the ValueError's reason (cv2 reads the file)
FRAME_CASES = {
    "420": (dc_only_jpeg(_420), ("same", "same")),
    "2 components": (dc_only_jpeg([(1, 1)] * 2), (None, None)),
    "5 components": (dc_only_jpeg([(1, 1)] * 5), (None, None)),
    "10 components": (dc_only_jpeg([(1, 1)] * 10, scans=[[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]),
                      (None, None)),
    "4 components (CMYK)": (dc_only_jpeg([(1, 1)] * 4), ("4 components",) * 2),
    "4 components (YCCK)": (dc_only_jpeg([(1, 1)] * 4, app=_adobe(2)), ("4 components",) * 2),
    "12-bit": (dc_only_jpeg(_420, sof=0xC1, precision=12), (None, None)),
    "12-bit grey": (dc_only_jpeg([(1, 1)], sof=0xC1, precision=12), (None, None)),
    "16-bit": (dc_only_jpeg([(1, 1)], sof=0xC1, precision=16), (None, None)),
    "16-bit progressive": (dc_only_jpeg([(1, 1)], sof=0xC2, precision=16, params=(0, 0, 0)),
                           (None, None)),
    "MCU of 10 blocks": (dc_only_jpeg([(2, 4), (1, 1), (1, 1)]), ("same", "same")),
    "MCU of 11 blocks": (dc_only_jpeg([(3, 3), (1, 1), (1, 1)]), (None, None)),
    "MCU of 18 blocks": (dc_only_jpeg([(4, 4), (1, 1), (1, 1)]), (None, None)),
    "Y 4x4, scans of one component": (dc_only_jpeg([(4, 4), (1, 1), (1, 1)],
                                                   scans=[[0], [1], [2]]), ("same", "same")),
    # Cb 2 of 3: only grey output, which needs Y alone, is read
    "fractional chroma": (dc_only_jpeg([(3, 1), (2, 1), (1, 1)]), (None, "same")),
    "fractional chroma, scans of one": (dc_only_jpeg([(3, 1), (2, 1), (1, 1)],
                                                     scans=[[0], [1], [2]]), (None, "same")),
    "fractional Y": (dc_only_jpeg([(2, 1), (3, 1), (1, 1)]), (None, None)),
    "fractional RGB": (dc_only_jpeg([(3, 1), (2, 1), (1, 1)], ids=[82, 71, 66]), (None, None)),
    "ids 4, 5, 6 (YCbCr)": (dc_only_jpeg(_420, ids=[4, 5, 6]), ("same", "same")),
    "ids R, G, B": (dc_only_jpeg(_420, ids=[82, 71, 66]), ("RGB-coded",) * 2),
    "Adobe transform 0": (dc_only_jpeg(_420, app=_adobe(0)), ("RGB-coded",) * 2),
    # jdhuff.c supplies the standard tables 0 and 1 of a sequential frame
    "no DHT, tables 0": (dc_only_jpeg(_420, dht=False), ("same", "same")),
    "no DHT, tables 1": (dc_only_jpeg(_420, dht=False, tid=1, sof=0xC1), ("same", "same")),
    "no DHT, tables 2": (dc_only_jpeg(_420, dht=False, tid=2), (None, None)),
    "no DHT, progressive": (dc_only_jpeg(_420, dht=False, sof=0xC2, params=(0, 0, 0)),
                            (None, None)),
    "arithmetic": (dc_only_jpeg(_420, sof=0xC9), ("arithmetic",) * 2),
    "arithmetic progressive": (dc_only_jpeg(_420, sof=0xCA, params=(0, 0, 0)),
                               ("arithmetic",) * 2),
    "arithmetic 12-bit": (dc_only_jpeg(_420, sof=0xC9, precision=12), (None, None)),
    "arithmetic progression Se 63": (dc_only_jpeg(_420, sof=0xCA), (None, None)),
    # lossless: no colour conversion, 2-8 bits, Huffman only
    "lossless grey": (dc_only_jpeg([(1, 1)], sof=0xC3), (None, "lossless")),
    "lossless 2-bit grey": (dc_only_jpeg([(1, 1)], sof=0xC3, precision=2), (None, "lossless")),
    "lossless 12-bit grey": (dc_only_jpeg([(1, 1)], sof=0xC3, precision=12), (None, None)),
    "lossless RGB": (dc_only_jpeg(_420, sof=0xC3), ("lossless", None)),
    "lossless YCbCr (JFIF)": (dc_only_jpeg(_420, sof=0xC3, app=_JFIF), (None, None)),
    "lossless CMYK": (dc_only_jpeg([(1, 1)] * 4, sof=0xC3), ("lossless",) * 2),
    "lossless YCCK": (dc_only_jpeg([(1, 1)] * 4, sof=0xC3, app=_adobe(2)), (None, None)),
    "lossless predictor 0": (dc_only_jpeg([(1, 1)], sof=0xC3, params=(0, 0, 0)), (None, None)),
    "lossless point transform 8": (dc_only_jpeg([(1, 1)], sof=0xC3, params=(1, 0, 8)),
                                   (None, None)),
    "lossless arithmetic": (dc_only_jpeg([(1, 1)], sof=0xCB), (None, None)),
}


@pytest.mark.parametrize("name", sorted(FRAME_CASES))
def test_frame_headers_as_cv2(tmp_path, name):
    data, expected = FRAME_CASES[name]
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    for gray, want in zip((False, True), expected):
        cv = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if want is None:
            assert cv is None and imread(str(path), grayscale=gray) is None, gray
        elif want == "same":
            got = imread(str(path), grayscale=gray)
            assert cv is not None and got is not None and np.array_equal(got, cv), gray
        else:
            assert cv is not None, gray
            with pytest.raises(ValueError, match=f"f.jpg: .*{want}"):
                imread(str(path), grayscale=gray)


def test_sequential_without_dht_read_as_cv2(tmp_path):
    """cv2 writes Annex K's tables, which are libjpeg's standard ones: the
    same file without its DHT segments reads the same."""
    data = cv2.imencode(".jpg", scene(33, 47, seed=4))[1].tobytes()
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    path = tmp_path / "nodht.jpg"
    path.write_bytes(bytes(out + data[pos:]))
    assert b"\xff\xc4" not in path.read_bytes()
    assert_reads_as_cv2(path)
    assert np.array_equal(imread(str(path)), cv2.imdecode(np.frombuffer(data, np.uint8), 1))


# --------------------------------------------------------------------------
# files that end early
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rst", [0, 1, 3])
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_truncated_sequential_jpegs_read_as_cv2(tmp_path, sampling, rst):
    """Cut inside the headers (None), inside or right after the first scan
    header (an image: libjpeg's fake EOI bytes stand for what is missing),
    and at 30 points of the scan data up to two bytes before the end: the
    MCU where the data ends decodes from zero bits, the rest of its restart
    interval is grey, and every later interval's marker is missing."""
    ok, enc = cv2.imencode(".jpg", scene(45, 70, seed=rst), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling], cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
    data = enc.tobytes()
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    cuts = sorted({2, 3, 20, sos - 1, sos + 3, start - 3, start - 2, start - 1, start,
                   start + 1} | set(np.linspace(start + 2, len(data) - 2, 30).astype(int)))
    path = tmp_path / "cut.jpg"
    nothing = 0
    for cut in cuts:
        path.write_bytes(data[:cut])
        if cut < start - 3:
            assert cv2.imread(str(path)) is None and imread(str(path)) is None, cut
            nothing += 1
        else:
            assert_reads_as_cv2(path)
    assert nothing >= 5


@pytest.mark.parametrize("kind", ["progressive", "truncated"])
def test_641x959_read_as_cv2(tmp_path, kind):
    im = scene(641, 959, seed=7)
    path = tmp_path / "big.jpg"
    if kind == "progressive":
        _progressive(path, im)
    else:
        path.write_bytes(cv2.imencode(".jpg", im)[1].tobytes()[:40000])
    assert_reads_as_cv2(path)


def test_truncated_progressive_refused(tmp_path):
    """Cut before its last scan, a progressive file is one libjpeg
    block-smooths: refused.  Cut inside the last scan (every coefficient 1-9
    refined to Al = 0) it is read without smoothing, as cv2 reads it."""
    path = tmp_path / "p.jpg"
    _progressive(path, scene(45, 70, seed=3), rst_interval=2)
    data = path.read_bytes()
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(scans) == 10
    for cut in (scans[1] + 40, scans[4] + 1, (scans[4] + scans[5]) // 2,
                (scans[8] + scans[9]) // 2, scans[9] - 1):
        path.write_bytes(data[:cut])
        assert cv2.imread(str(path)) is not None
        with pytest.raises(ValueError, match=r"p\.jpg: incomplete progressive JPEG"):
            imread(str(path))
    for cut in (scans[9] + 14, (scans[9] + len(data)) // 2, len(data) - 2):
        path.write_bytes(data[:cut])
        assert_reads_as_cv2(path)
    for cut in (scans[0] + 4, scans[9] + 5):  # inside a scan header: libjpeg fails
        path.write_bytes(data[:cut])
        assert cv2.imread(str(path)) is None and imread(str(path)) is None


def test_refusals_and_nothing_to_read(tmp_path):
    im = cv2.imread(os.path.join(REPO, "data", "synth", "img_000.jpg"))
    prog = tmp_path / "prog.jpg"
    cv2.imwrite(str(prog), im, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert_reads_as_cv2(prog)
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), im[:8, :8].astype(np.uint16) * 257)
    assert_reads_as_cv2(deep)
    laced = tmp_path / "laced.png"
    write_png(laced, im[:4, :4], 8, 2, interlace=1)
    assert_reads_as_cv2(laced)
    data = open(os.path.join(REPO, "data", "synth", "img_000.jpg"), "rb").read()
    cut = tmp_path / "cut.jpg"
    for frac in (0.3, 0.99):
        cut.write_bytes(data[:int(len(data) * frac)])
        assert_reads_as_cv2(cut)  # libjpeg fills the rest with grey
    cut.write_bytes(data[:-2])  # every block present, no EOI: read as cv2 reads it
    assert_reads_as_cv2(cut)
    png = (tmp_path / "cut.png")
    cv2.imwrite(str(png), im[:16, :16])
    png.write_bytes(png.read_bytes()[:60])
    assert cv2.imread(str(png)) is None and imread(str(png)) is None
    sof = data.index(b"\xff\xc0")  # the baseline frame header, altered in place
    length = struct.unpack(">H", data[sof + 2:sof + 4])[0]
    cmyk = (data[:sof + 2] + struct.pack(">H", length + 3) + data[sof + 4:sof + 9] + b"\x04"
            + data[sof + 10:sof + 2 + length] + b"\x04\x11\x01" + data[sof + 2 + length:])
    for patch, what in (((sof + 1, 0xC9), "arithmetic"), (cmyk, "4 components")):
        bad = bytearray(data)
        if isinstance(patch, bytes):
            bad = patch
        else:
            bad[patch[0]] = patch[1]
        cut.write_bytes(bytes(bad))
        assert cv2.imread(str(cut)) is not None  # 4 components: cv2 reads them as CMYK
        with pytest.raises(ValueError, match=f"cut.jpg: .*{what}"):
            imread(str(cut))
    bad = bytearray(data)
    bad[sof + 4] = 12  # 12-bit: OpenCV's 8-bit jpeg_read_scanlines fails
    cut.write_bytes(bytes(bad))
    assert cv2.imread(str(cut)) is None and imread(str(cut)) is None
    for code in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):  # hierarchical: libjpeg fails
        bad = bytearray(data)
        bad[sof + 1] = code
        cut.write_bytes(bytes(bad))
        assert cv2.imread(str(cut)) is None and imread(str(cut)) is None
    tagged = tmp_path / "gamma.png"
    write_png(tagged, im[:4, :4], 8, 2, extra=_chunk(b"gAMA", struct.pack(">I", 45455)))
    assert np.array_equal(imread(str(tagged)), cv2.imread(str(tagged)))
    assert cv2.imread(str(tagged), cv2.IMREAD_GRAYSCALE) is not None
    with pytest.raises(ValueError, match="gamma"):
        imread(str(tagged), grayscale=True)
    assert imread(str(tmp_path / "missing.jpg")) is None
    assert imread(str(tmp_path)) is None
    assert imread(os.path.join(REPO, "README.md")) is None
