"""Netpbm files against ``cv2.imread``, byte for byte in colour (BGR) and
grayscale, read by ``fots_torch.imageio.imread``: PBM / PGM / PPM (P1-P6,
ASCII and binary) as OpenCV 5.0's PxMDecoder reads them and PAM (P7) as its
PAMDecoder does, quirks included:

- binary samples of a maxval below 256 are not scaled (P5 maxval 100: 0 1 50
  99 100 read as 0 1 50 99 100), ASCII ones are (P2 maxval 7: 0 3 7 read as
  0 109 255), 16-bit samples are shifted, not scaled (maxval 1000: 500 -> 1,
  1000 -> 3), P4's bit 1 is black;
- a PAM RGB_ALPHA pixel [10, 20, 30, 255] reads in colour as [30, 20, 10]
  and only the first ceil(width / 4) pixels of a row are converted: OpenCV
  leaves the rest of the row as the memory it was given (seen here as
  [10, 68, 69] in one run and header text in another; the port writes
  zeros), so those bytes are left out of the comparison (as are the grey
  bytes past 3 * ceil(width / 4) of a row);
- every maxval class (below 255, 255, 256-65535, 65535), every TUPLTYPE,
  headers with comments, numbers ended by any byte, files cut short:
  None exactly where ``cv2`` gives None (or raising where it raises, for a
  size past its limits).
"""

import cv2
import numpy as np
import pytest

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene


def read_both(tmp_path, data, name="x.pnm"):
    """[(cv2's, the port's)] for colour and grey: arrays, None or "raise"."""
    path = tmp_path / name
    path.write_bytes(data)
    out = []
    for gray in (False, True):
        pair = []
        for reader in (lambda: cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else
                                          cv2.IMREAD_COLOR),
                       lambda: imread(str(path), grayscale=gray)):
            try:
                pair.append(reader())
            except (cv2.error, ValueError):
                pair.append("raise")
        out.append(tuple(pair))
    return out


def assert_same(tmp_path, data, name="x.pnm", written=None):
    """Both modes as cv2; ``written`` maps a shape to the mask of the bytes
    OpenCV writes (the rest are its uninitialised memory)."""
    for k, (want, got) in enumerate(read_both(tmp_path, data, name)):
        if not isinstance(want, np.ndarray) or not isinstance(got, np.ndarray):
            assert (want is None and got is None) or (isinstance(want, str) and
                                                      isinstance(got, str)), (data[:40], k,
                                                                              want, got)
            continue
        assert got.dtype == np.uint8 and got.shape == want.shape, (data[:40], k, got.shape)
        mask = written(want.shape) if written is not None else np.ones(want.shape, bool)
        assert np.array_equal(got[mask], want[mask]), (data[:40], k)
        assert not got[~mask].any()


def pnm(magic, w, h, maxval, body, sep=b"\n"):
    head = b"P%d%s%d %d%s" % (magic, sep, w, h, sep)
    if magic not in (1, 4):
        head += b"%d%s" % (maxval, sep)
    return head + body


def ascii_body(samples, per_line=17):
    flat = [str(int(v)).encode() for v in np.asarray(samples).ravel()]
    lines = (b" ".join(flat[i:i + per_line]) for i in range(0, len(flat), per_line))
    return b"\n".join(lines) + b"\n"


def pam(w, h, depth, maxval, tupltype, body, extra=b""):
    head = b"P7\n" + extra + b"WIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, depth, maxval)
    if tupltype is not None:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + b"ENDHDR\n" + body


# --------------------------------------------------------------------------
# the five quirks, by name
# --------------------------------------------------------------------------

def test_binary_maxval_100_not_scaled(tmp_path):
    pairs = read_both(tmp_path, pnm(5, 5, 1, 100, bytes([0, 1, 50, 99, 100])))
    assert pairs[1][0].tolist() == pairs[1][1].tolist() == [[0, 1, 50, 99, 100]]
    assert np.array_equal(pairs[0][0], pairs[0][1])


def test_ascii_maxval_7_scaled(tmp_path):
    pairs = read_both(tmp_path, pnm(2, 3, 1, 7, b"0 3 7\n"))
    assert pairs[1][0].tolist() == pairs[1][1].tolist() == [[0, 109, 255]]


@pytest.mark.parametrize("magic", [2, 5])
def test_16_bit_shifted_not_scaled(tmp_path, magic):
    body = b"500 1000\n" if magic == 2 else bytes([1, 244, 3, 232])
    pairs = read_both(tmp_path, pnm(magic, 2, 1, 1000, body))
    assert pairs[1][0].tolist() == pairs[1][1].tolist() == [[1, 3]]


def test_p4_bit_one_is_black(tmp_path):
    pairs = read_both(tmp_path, pnm(4, 5, 1, 1, bytes([0b01101000])))
    assert pairs[1][0].tolist() == pairs[1][1].tolist() == [[255, 0, 0, 255, 0]]


def test_pam_rgb_alpha_converts_a_quarter_of_each_row(tmp_path):
    data = pam(2, 1, 4, 255, b"RGB_ALPHA", bytes([10, 20, 30, 255, 40, 50, 60, 255]))
    (want, got), (gwant, ggot) = read_both(tmp_path, data)
    assert want[0, 0].tolist() == got[0, 0].tolist() == [30, 20, 10]
    assert got[0, 1].tolist() == [0, 0, 0]  # OpenCV's is memory it never wrote
    assert gwant.tolist() == ggot.tolist() == [[10, 10]]


# --------------------------------------------------------------------------
# P1-P6
# --------------------------------------------------------------------------

MAXVALS = (1, 7, 100, 255, 256, 1000, 65535)


@pytest.mark.parametrize("magic", [2, 3, 5, 6])
@pytest.mark.parametrize("maxval", MAXVALS[1:])
def test_grey_and_colour_samples_as_cv2(tmp_path, magic, maxval):
    """P2 / P3 (ASCII) and P5 / P6 (binary) at each maxval class, samples up
    to and past maxval, at odd sizes."""
    rng = np.random.default_rng(magic * maxval)
    ch = 3 if magic in (3, 6) else 1
    h, w = 7, 11
    samples = rng.integers(0, min(maxval + 3, 65535) + 1, (h, w, ch))
    if magic in (2, 3):
        body = ascii_body(samples)
    elif maxval > 255:
        body = samples.astype(">u2").tobytes()
    else:
        body = (samples & 0xff).astype(np.uint8).tobytes()
    assert_same(tmp_path, pnm(magic, w, h, maxval, body))


@pytest.mark.parametrize("magic", [1, 4])
def test_bitmaps_as_cv2(tmp_path, magic):
    rng = np.random.default_rng(magic)
    for h, w in ((5, 9), (3, 16), (1, 1), (4, 17)):
        bits = rng.integers(0, 2, (h, w))
        if magic == 1:
            body = ascii_body(bits) if w % 2 else b"".join(
                b"".join(b"%d" % b for b in row) + b"\n" for row in bits)  # no separators
        else:
            body = np.packbits(bits.astype(np.uint8), axis=1).tobytes()
        assert_same(tmp_path, pnm(magic, w, h, 1, body))


def test_cv2_written_netpbm_reads_as_cv2(tmp_path):
    """cv2.imwrite's .ppm / .pgm / .pbm / .pnm, binary and ASCII."""
    im = scene(30, 41, seed=3)
    grey = im[..., 1]
    for k, (ext, src, params) in enumerate((
            ("ppm", im, ()), ("pgm", grey, ()), ("pbm", (grey > 128).astype(np.uint8), ()),
            ("ppm", im, (cv2.IMWRITE_PXM_BINARY, 0)), ("pgm", grey, (cv2.IMWRITE_PXM_BINARY, 0)),
            ("pgm", grey.astype(np.uint16) * 257, ()), ("ppm", im.astype(np.uint16) * 300, ()))):
        path = tmp_path / f"w{k}.{ext}"
        assert cv2.imwrite(str(path), src, list(params))
        assert_same(tmp_path, path.read_bytes(), f"r{k}.{ext}")


HEADERS = {
    "comments": b"P5 #c\n2 #x\n1 255\n\x07\x08",
    "comment_cr": b"P5\n#c\r2 1\n255\n\x07\x08",
    "tabs": b"P5\t2\t1\t255\t\x07\x08",
    "one_per_line": b"P5\n2\n1\n255\n\x01\x02",
    "maxval_cr_lf": b"P5\n2 1\n255\r\n\x07\x08",
    "maxval_then_hash": b"P5\n2 1\n255#c\n\x07\x08",
    "maxval_then_data": b"P5\n2 1\n255\x07\x08",
    "maxval_0": b"P5\n2 1\n0\n\x07\x08",
    "maxval_65536": b"P5\n2 1\n65536\n" + bytes(4),
    "width_0": b"P5\n0 1\n255\n",
    "negative": b"P5\n2 1\n-1\n\x00\x00",
    "past_int_max": b"P5\n99999999999 1\n255\n",
    "past_opencv_limits": b"P5\n2000000 1\n255\n" + bytes(10),
    "letters": b"P5\n2 x\n255\n\x00\x00",
    "leading_zeros": b"P2\n2 1\n255\n0001 2\n",
    "number_ended_by_x": b"P2\n3 1\n255\n1x 2#3\n4 ",
    "number_ended_by_hash": b"P2\n2 1\n255\n12#34\n",
    "comment_in_data": b"P2\n2 1\n255\n1 #c\n 2\n",
    "letter_in_data": b"P2\n2 1\n255\n1 x 2\n",
    "sample_past_int_max": b"P2\n2 1\n255\n 12 99999999999\n",
    "sample_int_max": b"P2\n2 1\n255\n1 2147483647\n",
    "p1_other_digits": b"P1\n5 1\n01102\n",
    "p3_past_maxval": b"P3\n1 1\n255\n300 20 10\n",
    "p7_is_not_pxm": b"P8\n2 1\n255\n\x07\x08",
}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_headers_and_numbers_as_cv2(tmp_path, name):
    assert_same(tmp_path, HEADERS[name])


@pytest.mark.parametrize("magic", [1, 2, 3, 4, 5, 6])
def test_cut_short_as_cv2(tmp_path, magic):
    """Every cut of a small file (the ASCII ones must go on a byte past their
    last number, P1 excepted)."""
    rng = np.random.default_rng(magic)
    ch = 3 if magic in (3, 6) else 1
    samples = rng.integers(0, 256 if magic != 1 and magic != 4 else 2, (3, 5, ch))
    body = (ascii_body(samples) if magic in (1, 2, 3) else
            np.packbits(samples[..., 0].astype(np.uint8), axis=1).tobytes() if magic == 4 else
            samples.astype(np.uint8).tobytes())
    data = pnm(magic, 5, 3, 200, body)
    for cut in range(2, len(data) + 1):
        assert_same(tmp_path, data[:cut])


# --------------------------------------------------------------------------
# PAM
# --------------------------------------------------------------------------

def _quarter(depth):
    """The bytes OpenCV's PAM reader writes for a depth 2 or 4 tuple type:
    the first ceil(width / depth) pixels of each row in colour, and in grey
    (three bytes a pixel) the first 3 * ceil(width / depth) of the row."""
    def mask(shape):
        m = np.zeros(shape, bool)
        n = -(-shape[1] // depth)
        m[:, :n if len(shape) == 3 else 3 * n] = True
        return m
    return mask


@pytest.mark.parametrize("tupltype,depth", [(b"BLACKANDWHITE", 1), (b"GRAYSCALE", 1),
                                            (b"GRAYSCALE_ALPHA", 2), (b"RGB", 3),
                                            (b"RGB_ALPHA", 4), (None, 1), (None, 3)])
@pytest.mark.parametrize("maxval", [1, 100, 255, 1000, 65535])
def test_pam_tuple_types_as_cv2(tmp_path, tupltype, depth, maxval):
    """Each TUPLTYPE (and none) at each maxval class: MAXVAL 1 reads packed
    bits from each row's first bytes, RGB reads in colour as stored,
    GRAYSCALE_ALPHA and RGB_ALPHA convert the first ceil(width / depth)
    pixels of a row (in grey, three bytes each: RGB_ALPHA 7 pixels wide
    leaves its last byte unwritten)."""
    rng = np.random.default_rng(depth * maxval)
    h, w = 3, 9 if maxval % 2 else 7
    samples = rng.integers(0, maxval + 1, (h, w, depth))
    body = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    written = _quarter(depth) if depth in (2, 4) and maxval != 1 else None
    assert_same(tmp_path, pam(w, h, depth, maxval, tupltype, body), written=written)


def test_cv2_written_pam_reads_as_cv2(tmp_path):
    im = scene(20, 27, seed=4)
    for k, src in enumerate((im, im[..., 0], im.astype(np.uint16) * 257)):
        path = tmp_path / f"w{k}.pam"
        assert cv2.imwrite(str(path), src)
        assert_same(tmp_path, path.read_bytes(), f"r{k}.pam")


PAM_HEADERS = {
    "comment_and_blank_lines": pam(2, 1, 1, 255, None, b"\x0a\x0b", extra=b"# c\n\n #c2\n"),
    "endhdr_crlf": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\r\n\x0a\x0b",
    "endhdr_cr": b"P7\rWIDTH 3\rHEIGHT 2\rDEPTH 1\rMAXVAL 255\rENDHDR\r" + bytes(range(6)),
    "endhdr_space": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR \n\x0a\x0b",
    "endhdr_junk": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR junk\n\x0a\x0b",
    "endhdr_then_data": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\x0c\x01\x02\n\x0a\x0b",
    "value_blanks": b"P7\nWIDTH  2 \t\nHEIGHT\t1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "octal_looking": b"P7\nWIDTH 010\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n" + bytes(10),
    "hex": b"P7\nWIDTH 0x2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "plus": b"P7\nWIDTH +2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "trailing_letters": b"P7\nWIDTH 2x\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "comment_after_value": b"P7\nWIDTH 2 # c\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "no_value": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "blank_value": b"P7\nWIDTH \nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "maxval_empty": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL\nENDHDR\n\x0a\x0b",
    "maxval_negative": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL -3\nENDHDR\n\x0a\x0b",
    "maxval_0": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 0\nENDHDR\n\x0a\x0b",
    "maxval_65536": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 65536\nENDHDR\n\x0a\x0b",
    "maxval_past_int": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 2147483648\nENDHDR\n\x0a\x0b",
    "width_negative": b"P7\nWIDTH -2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "width_0": b"P7\nWIDTH 0\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n",
    "height_missing": b"P7\nWIDTH 2\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "width_twice": b"P7\nWIDTH 2\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "tupltype_twice": pam(2, 1, 1, 255, b"GRAYSCALE\nTUPLTYPE GRAYSCALE", b"\x0a\x0b"),
    "tupltype_empty": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE\nENDHDR\n\x0a\x0b",
    "tupltype_blank": pam(2, 1, 1, 255, b"", b"\x0a\x0b"),
    "tupltype_trailing_blank": pam(2, 1, 1, 255, b"GRAYSCALE\t", b"\x0a\x0b"),
    "tupltype_unknown": pam(2, 1, 3, 255, b"FOO", bytes(6)),
    "tupltype_depth_mismatch": pam(2, 1, 3, 255, b"GRAYSCALE", bytes(6)),
    "depth_2_untyped": pam(2, 1, 2, 255, None, bytes(4)),
    "depth_5": pam(2, 1, 5, 255, None, bytes(10)),
    "wide_untyped": pam(2, 1, 1, 1000, None, bytes(4)),
    "lowercase": b"P7\nwidth 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "long_identifier": b"P7\nWIDTHXYZW 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "unknown_field": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nFOO 3\nENDHDR\n\x0a\x0b",
    "magic_space": b"P7 \nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x0a\x0b",
    "cut_in_data": pam(2, 1, 1, 255, None, b"\x0a"),
    "no_endhdr": b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\n",
}


@pytest.mark.parametrize("name", sorted(PAM_HEADERS))
def test_pam_headers_as_cv2(tmp_path, name):
    assert_same(tmp_path, PAM_HEADERS[name], "x.pam")
