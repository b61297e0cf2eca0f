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

A progressive JPEG, an arithmetic-coded, 12-bit or 4-component frame
header, a 1/2/4-bit or 16-bit PNG, an interlaced PNG, a PNG with an eXIf
chunk, a gamma-tagged colour PNG read as grayscale and truncated files raise
``ValueError``; a missing file or one that is neither JPEG nor PNG gives
``None``.
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


def write_png(path, samples, depth, color_type, palette=None, filters=(0,), extra=b"",
              interlace=0):
    h, w = samples.shape[:2]
    rows = []
    for r in samples.reshape(h, -1):
        if depth < 8:
            per, packed = 8 // depth, bytearray((len(r) * depth + 7) // 8)
            for i, v in enumerate(r):
                packed[i // per] |= int(v) << (8 - depth * (i % per + 1))
            rows.append(bytes(packed))
        else:
            rows.append(bytes(r.astype(np.uint8)))
    bpp = max(1, PNG_CHANNELS[color_type] * depth // 8)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                               color_type, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    data += extra + _chunk(b"IDAT", zlib.compress(_filtered(rows, bpp, filters)))
    path.write_bytes(data + _chunk(b"IEND", b""))


def png_samples(color_type, depth, h=13, w=19):
    """(samples, palette) of a random image of ``color_type`` at ``depth``."""
    rng = np.random.default_rng(color_type * 10 + depth)
    palette = None
    if color_type in (0, 3):
        samples = rng.integers(0, 2 ** depth, (h, w))
        if color_type == 3:  # a short palette: indices past it read as black
            palette = rng.integers(0, 256, (min(2 ** depth, 200), 3)).astype(np.uint8)
    else:
        samples = rng.integers(0, 256, (h, w, PNG_CHANNELS[color_type]))
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
def test_png_below_8_bits_refused(tmp_path, color_type, depth):
    samples, palette = png_samples(color_type, depth)
    path = tmp_path / "low.png"
    write_png(path, samples, depth, color_type, palette, (0, 1, 2, 3, 4))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(ValueError, match=f"{depth}-bit PNG"):
        imread(str(path))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_written_pngs_read_as_cv2(tmp_path, channels):
    im = np.random.default_rng(channels).integers(0, 256, (21, 17, channels)).astype(np.uint8)
    path = tmp_path / "cv.png"
    assert cv2.imwrite(str(path), im)
    assert_reads_as_cv2(path)


def test_png_exif_refused(tmp_path):
    im = np.random.default_rng(6).integers(0, 256, (5, 7, 3))
    path = tmp_path / "o.png"
    write_png(path, im, 8, 2, extra=_chunk(b"eXIf", _tiff_orientation(6, False)))
    assert cv2.imread(str(path)).shape[:2] == (7, 5)  # cv2 applies the orientation
    with pytest.raises(ValueError, match="eXIf"):
        imread(str(path))


def test_refusals_and_nothing_to_read(tmp_path):
    im = cv2.imread(os.path.join(REPO, "data", "synth", "img_000.jpg"))
    prog = tmp_path / "prog.jpg"
    cv2.imwrite(str(prog), im, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        imread(str(prog))
    deep = tmp_path / "deep.png"
    cv2.imwrite(str(deep), im[:8, :8].astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="16-bit"):
        imread(str(deep))
    laced = tmp_path / "laced.png"
    write_png(laced, im[:4, :4], 8, 2, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        imread(str(laced))
    data = open(os.path.join(REPO, "data", "synth", "img_000.jpg"), "rb").read()
    cut = tmp_path / "cut.jpg"
    for frac in (0.3, 0.99):
        cut.write_bytes(data[:int(len(data) * frac)])
        assert cv2.imread(str(cut)) is not None  # libjpeg fills the rest with grey
        with pytest.raises(ValueError, match="truncated"):
            imread(str(cut))
    cut.write_bytes(data[:-2])  # every block present, no EOI: read as cv2 reads it
    assert_reads_as_cv2(cut)
    png = (tmp_path / "cut.png")
    cv2.imwrite(str(png), im[:16, :16])
    png.write_bytes(png.read_bytes()[:60])
    with pytest.raises(ValueError, match="truncated"):
        imread(str(png))
    sof = data.index(b"\xff\xc0")  # the baseline frame header, altered in place
    for patch, what in (((sof + 1, 0xC9), "arithmetic"), ((sof + 4, 12), "12-bit"),
                        ((sof + 9, 4), "4 components")):
        bad = bytearray(data)
        bad[patch[0]] = patch[1]
        cut.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=what):
            imread(str(cut))
    tagged = tmp_path / "gamma.png"
    write_png(tagged, im[:4, :4], 8, 2, extra=_chunk(b"gAMA", struct.pack(">I", 45455)))
    assert np.array_equal(imread(str(tagged)), cv2.imread(str(tagged)))
    with pytest.raises(ValueError, match="gamma"):
        imread(str(tagged), grayscale=True)
    assert imread(str(tmp_path / "missing.jpg")) is None
    assert imread(str(tmp_path)) is None
    assert imread(os.path.join(REPO, "README.md")) is None
