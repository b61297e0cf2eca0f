"""The rest of what ``cv2.imread`` reads, against ``fots_torch.imageio.imread``
byte for byte in colour (BGR) and grayscale:

- progressive JPEGs that libjpeg-turbo block-smooths
  (``jdcoefct.c:decompress_smooth_data``): ``cv2``'s progressive writer cut
  at every scan boundary and inside scans, scan scripts of this package's
  own progressive writer that stop early (DC only, successive approximation
  ending at ``Al`` > 0), complete files that are never refined;
- 4-component JPEG (CMYK, Adobe-inverted CMYK as Pillow writes it, YCCK) and
  RGB-coded 3-component JPEG (Adobe transform 0, component ids R, G, B);
- gamma-tagged colour PNGs (``gAMA`` 45455, 50000, 220000 and a few inside
  libpng's threshold, ``sRGB``; 8 and 16 bits, palette, RGB, RGBA, ``sBIT``)
  read as grey through libpng's gamma tables;
- arithmetic-coded JPEG (SOF9 and SOF10) written by a T.81 Annex D encoder of
  this module (``jcarith.c``'s), with restarts and ``DAC`` conditioning;
- lossless JPEG (SOF3, Huffman) of an encoder of this module: predictors 1-7,
  point transforms, restart intervals of whole MCU rows, grey, RGB and CMYK;

and, for the other formats ``cv2.imread`` reads (BMP, Netpbm, PAM, PFM, Sun
raster, TIFF, WebP, JPEG 2000, AVIF, GIF, Radiance HDR), a ``ValueError``
naming the file and the format where ``cv2`` reads the file.
"""

import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import (_JFIF, LUMA_Q, SAMPLING, ZIGZAG, _adobe, _Bits,
                                           _chunk, _huffman_table, _progressive, _segment,
                                           assert_reads_as_cv2, dc_only_jpeg,
                                           hand_scripted_progressive, png_bytes, png_samples,
                                           scene)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan_starts(data):
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


# --------------------------------------------------------------------------
# block smoothing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_cut_progressive_block_smoothed_as_cv2(tmp_path, sampling):
    """cv2's progressive writer (10 scans of colour), cut at every scan
    boundary and at three points inside every scan, restart intervals 0 and
    2: every cut cv2 reads, read the same (a cut inside a scan header is
    None for both)."""
    path = tmp_path / "p.jpg"
    read = 0
    for seed, (h, w) in enumerate(((45, 70), (17, 33))):
        for rst in (0, 2):
            _progressive(path, scene(h, w, seed=seed), rst_interval=rst,
                         sampling_factor=SAMPLING[sampling])
            data = path.read_bytes()
            scans = _scan_starts(data)
            assert len(scans) == 10
            cuts = sorted({s + k for s in scans for k in (20, 60, 200)} | set(scans[1:]))
            for cut in (c for c in cuts if c < len(data)):
                path.write_bytes(data[:cut])
                if cv2.imread(str(path)) is None:
                    assert imread(str(path)) is None and imread(str(path), True) is None, cut
                else:
                    assert_reads_as_cv2(path)
                    read += 1
    assert read >= 60


@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("colour", [True, False])
def test_early_stopping_scripts_block_smoothed_as_cv2(tmp_path, colour, restart):
    """The hand-scripted progressive file stopped before each of its scans
    and closed with EOI: complete files whose script ends early (after the
    DC scans only, or at Al = 2 and Al = 1), and the same cut 30 bytes into
    each scan."""
    im = scene(37, 53, seed=21)
    data = hand_scripted_progressive(im if colour else im[..., 0], restart)
    path = tmp_path / "s.jpg"
    scans = _scan_starts(data)
    for k, start in enumerate(scans):
        for stop in (data[:start] + b"\xff\xd9", data[:start + 30]):
            path.write_bytes(stop)
            if k == 0 and len(stop) == start + 2:
                assert cv2.imread(str(path)) is None and imread(str(path)) is None
            elif cv2.imread(str(path)) is None:
                assert imread(str(path)) is None
            else:
                assert_reads_as_cv2(path)


@pytest.mark.parametrize("natural", [4, 16, 24, 32])
def test_zero_quantizer_and_smoothing_as_cv2(tmp_path, natural):
    """A zero among the quantizers Q00..Q30 (natural positions 0, 1, 8, 16,
    9, 2, 3, 10, 17, 24) stops libjpeg's smoothing; one elsewhere does not:
    either way the file stopped before its last four scans reads as cv2."""
    data = bytearray(hand_scripted_progressive(scene(37, 53, seed=22), restart=0))
    dqt = data.index(b"\xff\xdb")
    data[dqt + 5 + list(ZIGZAG).index(natural)] = 0
    path = tmp_path / "q.jpg"
    path.write_bytes(bytes(data[:_scan_starts(data)[-4]]))
    assert_reads_as_cv2(path)


def test_smoothing_changes_pixels(tmp_path):
    """A DC-only file smoothed differs from its plain IDCT (each block
    flat): the smoothing path is the one being compared."""
    path = tmp_path / "dc.jpg"
    data = hand_scripted_progressive(scene(40, 48, seed=3)[..., 1], restart=0)
    path.write_bytes(data[:_scan_starts(data)[1]] + b"\xff\xd9")
    got = imread(str(path), grayscale=True)
    assert_reads_as_cv2(path)
    blocks = got.reshape(5, 8, 6, 8).transpose(0, 2, 1, 3).reshape(30, 64)
    assert (blocks.max(1) != blocks.min(1)).sum() > 20  # not flat: estimated AC terms


# --------------------------------------------------------------------------
# 4 components and RGB-coded colour
# --------------------------------------------------------------------------

def _pillow_jpeg(path, array, mode, **kw):
    Image.fromarray(array, mode).save(str(path), "JPEG", **kw)
    return path.read_bytes()


@pytest.mark.parametrize("kw", [{}, {"quality": 50}, {"subsampling": 2}, {"progressive": True}],
                         ids=["q75", "q50", "420", "progressive"])
def test_cmyk_and_ycck_read_as_cv2(tmp_path, kw):
    """Pillow's CMYK JPEG (Adobe transform 0, inverted as Photoshop writes
    it), and the same file marked YCCK (transform 2: its samples taken as
    Y, Cb, Cr, K); grey from OpenCV's CMYK -> grey."""
    im = scene(37, 53, seed=3)
    cmyk = np.concatenate([im, (im[..., :1] // 2)], -1)
    path = tmp_path / "cmyk.jpg"
    data = _pillow_jpeg(path, cmyk, "CMYK", **kw)
    assert b"Adobe" in data
    assert_reads_as_cv2(path)
    ycck = bytearray(data)
    ycck[data.index(b"Adobe") + 11] = 2
    path.write_bytes(bytes(ycck))
    assert_reads_as_cv2(path)
    # no Adobe marker at all: CMYK
    path.write_bytes(dc_only_jpeg([(1, 1)] * 4, h=24, w=40))
    assert_reads_as_cv2(path)


@pytest.mark.parametrize("case", ["keep_rgb", "keep_rgb progressive", "ids RGB", "adobe 0 420",
                                  "adobe 1"])
def test_rgb_coded_read_as_cv2(tmp_path, case):
    """3 components coded as RGB: Pillow's keep_rgb files (Adobe transform
    0), component ids R, G, B without JFIF, Adobe transform 0 at 4:2:0;
    Adobe transform 1 is YCbCr.  Grey is libjpeg's rgb_gray_convert."""
    path = tmp_path / "rgb.jpg"
    im = scene(29, 47, seed=8)
    if case.startswith("keep_rgb"):
        _pillow_jpeg(path, im[..., ::-1].copy(), "RGB", keep_rgb=True,
                     progressive=case.endswith("progressive"))
    elif case == "ids RGB":
        path.write_bytes(dc_only_jpeg([(1, 1)] * 3, ids=[82, 71, 66], h=24, w=40))
    else:
        path.write_bytes(dc_only_jpeg([(2, 2), (1, 1), (1, 1)],
                                      app=_adobe(0 if "0" in case else 1), h=24, w=40))
    assert_reads_as_cv2(path)


# --------------------------------------------------------------------------
# gamma-tagged PNG read as grey
# --------------------------------------------------------------------------

GAMMA_TAGS = ["gAMA 45455", "gAMA 50000", "gAMA 220000", "gAMA 96000", "gAMA 94000", "sRGB",
              "gAMA 45455 + sBIT"]


def _gamma_chunks(tag, color_type, depth):
    out = b""
    if tag.startswith("gAMA"):
        out += _chunk(b"gAMA", struct.pack(">I", int(tag.split()[1])))
    if tag == "sRGB":
        out += _chunk(b"sRGB", b"\x00")
    if tag.endswith("sBIT"):
        channels = {2: 3, 3: 3, 6: 4}[color_type]
        out += _chunk(b"sBIT", bytes([min(depth, 12)] * channels))
    return out


@pytest.mark.parametrize("color_type,depth", [(2, 8), (2, 16), (6, 8), (6, 16), (3, 1), (3, 4),
                                              (3, 8)])
def test_gamma_tagged_png_grey_as_cv2(tmp_path, color_type, depth):
    """gAMA / sRGB before PLTE and IDAT: libpng's rgb_to_gray in linear
    light (gamma_to_1, the rounded fixed-point sum, gamma_from_1; at 16 bits
    the shifted 16-bit tables and the 16-to-8 table of grey pixels), a
    gamma within 5% of 1 not at all; colour unchanged."""
    samples, palette = png_samples(color_type, depth, h=23, w=29)
    path = tmp_path / "g.png"
    plain = png_bytes(samples, depth, color_type, palette, (0, 1, 2, 3, 4))
    changed = 0
    for tag in GAMMA_TAGS:
        at = plain.index(b"PLTE" if palette is not None else b"IDAT") - 4
        path.write_bytes(plain[:at] + _gamma_chunks(tag, color_type, depth) + plain[at:])
        assert_reads_as_cv2(path)
        tagged_grey = imread(str(path), grayscale=True)
        path.write_bytes(plain)
        changed += not np.array_equal(tagged_grey, imread(str(path), grayscale=True))
    assert changed >= 4  # the tables move the grey values


def test_gamma_chunks_out_of_place_as_cv2(tmp_path):
    """libpng ignores a gAMA after PLTE or IDAT, keeps the first of two, and
    takes sRGB's gamma over gAMA's."""
    samples, palette = png_samples(3, 8, h=11, w=13)
    pal = png_bytes(samples, 8, 3, palette)
    rgb = png_bytes(png_samples(2, 8, h=11, w=13)[0], 8, 2)
    g = _chunk(b"gAMA", struct.pack(">I", 45455))
    g2 = _chunk(b"gAMA", struct.pack(">I", 220000))
    s = _chunk(b"sRGB", b"\x00")
    idat, plte = rgb.index(b"IDAT") - 4, pal.index(b"IDAT") - 4
    path = tmp_path / "o.png"
    for data in (pal[:plte] + g + pal[plte:], rgb[:-12] + g + rgb[-12:],
                 rgb[:idat] + g + g2 + rgb[idat:], rgb[:idat] + g2 + s + rgb[idat:],
                 rgb[:idat] + _chunk(b"gAMA", b"\x00" * 4) + rgb[idat:]):
        path.write_bytes(data)
        assert_reads_as_cv2(path)


# --------------------------------------------------------------------------
# arithmetic coding (T.81 Annex D, jcarith.c)
# --------------------------------------------------------------------------

# Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS)
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]  # the last: the fixed 0.5 estimate


class ArithEncoder:
    """The QM coder of jcarith.c: ``encode(stats, i, bit)`` with the
    statistics bin ``stats[i]`` (state index | MPS << 7), ``finish`` at the
    end of a scan or a restart interval."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit_zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _emit(self, byte):
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush_stacked(self, temp):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._emit_zeros()
            self._emit(self.buffer)
        if self.sc:
            self._emit_zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0
        self.buffer = temp

    def _carry(self):
        if self.buffer >= 0:
            self._emit_zeros()
            self._emit(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ (switch << 7) ^ nlps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nmps
        while True:  # renormalization and output, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked(temp & 0xFF)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):  # D.1.8
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stacked(self.buffer)
            self.buffer = -1
        if self.c & 0x7FFF800:
            self._emit_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        self.zc = 0


def _arith_scan(blocks, sc, mcu, kind, ss, se, ah, al, restart, dac):
    """One arithmetic-coded scan's bytes (jcarith.c encode_mcu*), with its
    restart markers; ``dac``: table -> (L, U, Kx)."""
    enc = ArithEncoder()
    dc_stats = {t: bytearray(64) for t in range(2)}
    ac_stats = {t: bytearray(256) for t in range(2)}
    fixed = bytearray([113])
    last, ctx = [0] * len(sc), [0] * len(sc)
    progressive = kind != "sequential"

    def reset_stats():
        for i, comp in enumerate(sc):
            t = min(comp[0], 1)
            if not progressive or (ss == 0 and ah == 0):
                dc_stats[t][:] = bytes(64)
                last[i] = ctx[i] = 0
            if not progressive or se:
                ac_stats[t][:] = bytes(256)

    def magnitude(st, s, v, x1=None, k=0, kx=5):
        """Figures F.8 and F.9 of |v| >= 1 from bin ``s``: the magnitude
        category (a DC value's from X1 = 20, an AC value's from bin 189 or
        217 after its second decision), then the bits below its top one."""
        m, v = 0, v - 1
        if v:
            enc.encode(st, s, 1)
            m, v2 = 1, v >> 1
            if x1 is None and v2:  # AC: a second decision in the same bin
                enc.encode(st, s, 1)
                m <<= 1
                v2 >>= 1
                s = 189 if k <= kx else 217
            elif x1 is not None:
                s = x1
            while v2:
                enc.encode(st, s, 1)
                m <<= 1
                s += 1
                v2 >>= 1
        enc.encode(st, s, 0)
        s += 14
        m >>= 1
        while m:
            enc.encode(st, s, 1 if m & v else 0)
            m >>= 1

    def dc(i, t, value):
        st, s = dc_stats[t], ctx[i]
        v = value - last[i]
        if v == 0:
            enc.encode(st, s, 0)
            ctx[i] = 0
            return
        last[i] = value
        enc.encode(st, s, 1)
        enc.encode(st, s + 1, int(v < 0))
        low, high, _ = dac.get(t, (0, 1, 5))
        m = 0 if abs(v) == 1 else 1 << ((abs(v) - 1).bit_length() - 1)
        ctx[i] = 0 if m < (1 << low) >> 1 else (8 if v < 0 else 4) + (8 if m > (1 << high) >> 1
                                                                      else 0)
        magnitude(st, s + (3 if v < 0 else 2), abs(v), x1=20)

    def ac(t, values, k0, k1):
        """values[k]: the (point-transformed) coefficient at zigzag k."""
        st, kx = ac_stats[t], dac.get(t, (0, 1, 5))[2]
        ke = max([k for k in range(k0, k1 + 1) if values[k]], default=k0 - 1)
        k = k0
        while k <= ke:
            s = 3 * (k - 1)
            enc.encode(st, s, 0)
            while values[k] == 0:
                enc.encode(st, s + 1, 0)
                s += 3
                k += 1
            enc.encode(st, s + 1, 1)
            enc.encode(fixed, 0, int(values[k] < 0))
            magnitude(st, s + 2, abs(values[k]), k=k, kx=kx)
            k += 1
        if k <= k1:
            enc.encode(st, 3 * (k - 1), 1)

    def ac_refine(t, coef):
        st = ac_stats[t]
        mag = [abs(int(coef[ZIGZAG[k]])) for k in range(64)]
        ke = max([k for k in range(1, se + 1) if mag[k] >> al], default=0)
        kex = max([k for k in range(1, ke + 1) if mag[k] >> ah], default=0)
        k = ss
        while k <= ke:
            s = 3 * (k - 1)
            if k > kex:
                enc.encode(st, s, 0)
            while True:
                v = mag[k] >> al
                if v:
                    if v >> 1:
                        enc.encode(st, s + 2, v & 1)
                    else:
                        enc.encode(st, s + 1, 1)
                        enc.encode(fixed, 0, int(coef[ZIGZAG[k]] < 0))
                    break
                enc.encode(st, s + 1, 0)
                s += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def block(i, comp, coef):
        t = min(comp[0], 1)
        zz = [int(coef[ZIGZAG[k]]) for k in range(64)]
        if kind == "sequential":
            dc(i, t, zz[0])
            ac(t, zz, 1, 63)
        elif kind == "dc_first":
            dc(i, t, zz[0] >> al)
        elif kind == "dc_refine":
            enc.encode(fixed, 0, (zz[0] >> al) & 1)
        elif kind == "ac_first":
            ac(t, [(abs(v) >> al) * (1 if v >= 0 else -1) for v in zz], ss, se)
        else:
            ac_refine(t, coef)

    if len(sc) == 1:
        ci, _, _, wb, hb = sc[0]
        units = [[(0, by, bx)] for by in range(hb) for bx in range(wb)]
    else:
        units = [[(i, my * v + y, mx * h + x) for i, (_, h, v, _, _) in enumerate(sc)
                  for y in range(v) for x in range(h)]
                 for my in range(mcu[0]) for mx in range(mcu[1])]
    reset_stats()
    for m, unit in enumerate(units):
        if restart and m and m % restart == 0:
            enc.finish()
            enc.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            reset_stats()
            enc.reset()
        for i, by, bx in unit:
            block(i, sc[i], blocks[sc[i][0]][by, bx])
    enc.finish()
    return bytes(enc.out)


def coefficients(im, hv0=(2, 2), quality_scale=(3, 4)):
    """(blocks, comps, mcu, quant) of ``im`` as an encoder quantizes it:
    YCbCr with Y sampled ``hv0`` against 1 x 1 chroma (grey: one plane),
    blocks[c]: [rows, cols, 64] natural order over the MCU grid (edges
    replicated), comps: (index, h, v, width_in_blocks, height_in_blocks)."""
    colour = im.ndim == 3
    planes = [cv2.cvtColor(im, cv2.COLOR_BGR2YCrCb)[..., i] for i in (0, 2, 1)] if colour \
        else [im]
    hv = [hv0, (1, 1), (1, 1)] if colour else [(1, 1)]
    hmax, vmax = hv[0]
    H, W = im.shape[:2]
    mcu = (-(-H // (8 * vmax)), -(-W // (8 * hmax)))
    n, d = quality_scale
    quant = [np.clip(LUMA_Q * n // d, 1, 255), np.clip(LUMA_Q, 1, 255)]
    dct = np.array([[np.cos((2 * x + 1) * u * np.pi / 16) * (0.5 if u else 0.5 ** 1.5)
                     for x in range(8)] for u in range(8)])
    blocks, comps = [], []
    for ci, (plane, (h, v)) in enumerate(zip(planes, hv)):
        if (h, v) != (hmax, vmax):
            plane = cv2.resize(plane, (-(-W * h // hmax), -(-H * v // vmax)),
                               interpolation=cv2.INTER_AREA)
        ph, pw = mcu[0] * 8 * v, mcu[1] * 8 * h
        p = np.pad(plane.astype(np.float64) - 128, ((0, ph - plane.shape[0]),
                                                    (0, pw - plane.shape[1])), mode="edge")
        t = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", dct, t, dct).reshape(ph // 8, pw // 8, 64)
        blocks.append(np.round(coef / quant[min(ci, 1)]).astype(np.int64))
        comps.append((ci, h, v, -(-plane.shape[1] // 8), -(-plane.shape[0] // 8)))
    return blocks, comps, mcu, quant, hv


# DC at Al 1, Y's AC in two bands at Al 2, the chroma's at Al 1, then every
# refinement to Al 0 (scans of a component the image lacks are skipped)
SIMPLE_SCRIPT = [("dc_first", "all", 0, 0, 0, 1), ("ac_first", 0, 1, 5, 0, 2),
                 ("ac_first", 0, 6, 63, 0, 2), ("ac_first", 1, 1, 63, 0, 1),
                 ("ac_first", 2, 1, 63, 0, 1), ("ac_refine", 0, 1, 63, 2, 1),
                 ("dc_refine", "all", 0, 0, 1, 0), ("ac_refine", 0, 1, 63, 1, 0),
                 ("ac_refine", 1, 1, 63, 1, 0), ("ac_refine", 2, 1, 63, 1, 0)]


def arith_jpeg(im, progressive=False, restart=0, dac=None, hv0=(2, 2), script=SIMPLE_SCRIPT):
    """An arithmetic-coded JPEG of ``im`` (BGR or grey): SOF9, one
    interleaved scan, or SOF10 with ``script`` (scans of (kind, component or
    "all", Ss, Se, Ah, Al)); ``dac``: {table: (L, U, Kx)} as a DAC segment."""
    dac = dac or {}
    blocks, comps, mcu, quant, hv = coefficients(im, hv0)
    H, W = im.shape[:2]
    out = b"\xff\xd8" + (_JFIF if len(comps) == 3 else b"")
    out += _segment(0xDB, b"".join(bytes([i]) + bytes(q[ZIGZAG].astype(np.uint8))
                                   for i, q in enumerate(quant)))
    out += _segment(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, H, W, len(comps))
                    + b"".join(bytes([ci + 1, (h << 4) | v, min(ci, 1)])
                               for ci, (h, v) in enumerate(hv)))
    if dac:
        out += _segment(0xCC, b"".join(bytes([t, (u << 4) | l, 16 + t, k])
                                       for t, (l, u, k) in dac.items()))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = script if progressive else [("sequential", "all", 0, 63, 0, 0)]
    for kind, which, ss, se, ah, al in scans:
        if which != "all" and which >= len(comps):
            continue
        sc = comps if which == "all" else [comps[which]]
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(
            bytes([c[0] + 1, min(c[0], 1) * 17]) for c in sc) + bytes([ss, se, (ah << 4) | al]))
        out += _arith_scan(blocks, sc, mcu, kind, ss, se, ah, al, restart, dac)
    return out + b"\xff\xd9"


@pytest.mark.parametrize("colour", [True, False])
def test_arithmetic_encoder_codes_the_coefficients(tmp_path, colour):
    """The encoder is right: cv2 reads its SOF9 and SOF10 files as it reads
    the Huffman-coded progressive file of the same coefficients."""
    im = scene(37, 53, seed=17)
    im = im if colour else im[..., 1]
    path = tmp_path / "h.jpg"
    path.write_bytes(hand_scripted_progressive(im, restart=0))
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    for progressive in (False, True):
        path.write_bytes(arith_jpeg(im, progressive=progressive, restart=3))
        assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), want)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("form", ["sequential", "progressive", "sequential grey",
                                  "progressive grey", "sequential 444 DAC",
                                  "progressive DAC"])
def test_arithmetic_coding_read_as_cv2(tmp_path, form, restart):
    """SOF9 / SOF10 of this module's encoder, 4:2:0 or 4:4:4, with DAC
    conditioning (DC L and U, AC Kx) or the defaults, with restart
    intervals or none: the port reads each as cv2."""
    im = scene(37, 53, seed=17)
    if "grey" in form:
        im = im[..., 1]
    dac = {0: (2, 5, 3), 1: (1, 1, 40)} if "DAC" in form else None
    data = arith_jpeg(im, progressive=form.startswith("progressive"), restart=restart, dac=dac,
                      hv0=(1, 1) if "444" in form else (2, 2))
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    assert data[2:].count(b"\xff\xc9") + data[2:].count(b"\xff\xca") == 1
    assert_reads_as_cv2(path)


def test_arithmetic_progressive_cut_and_smoothed_as_cv2(tmp_path):
    """An SOF10 file cut at every scan boundary (block-smoothed where the
    DC or AC bands stop early) and inside scans, where the decoder reads
    zero bytes past the end as the arithmetic decoder does."""
    data = arith_jpeg(scene(37, 53, seed=19), progressive=True, restart=2)
    path = tmp_path / "a.jpg"
    for start in _scan_starts(data)[1:]:
        for cut in (start, start + 25):
            path.write_bytes(data[:cut])
            if cv2.imread(str(path)) is None:
                assert imread(str(path)) is None
            else:
                assert_reads_as_cv2(path)


# --------------------------------------------------------------------------
# lossless JPEG (SOF3, Huffman)
# --------------------------------------------------------------------------

def lossless_jpeg(planes, hv, psv, pt, restart_rows=0, app=b"", ids=None, separate=False):
    """A lossless Huffman-coded JPEG of the u8 ``planes`` (each at its
    component's own resolution, sampled ``hv``), predictor ``psv``, point
    transform ``pt``, a restart every ``restart_rows`` MCU rows; one
    interleaved scan, or (``separate``, 1 x 1 sampling) one scan per
    component.  Samples past a component's edge (dummy ones of the MCU
    grid) code 0."""
    hmax, vmax = max(h for h, _ in hv), max(v for _, v in hv)
    H, W = planes[0].shape[0] * vmax // hv[0][1], planes[0].shape[1] * hmax // hv[0][0]
    mcu_rows, mcu_cols = -(-H // vmax), -(-W // hmax)
    ids = ids or list(range(1, len(planes) + 1))
    diffs = []
    for p, (h, v) in zip(planes, hv):
        x = p.astype(np.int64) >> pt
        d = np.zeros((mcu_rows * v, mcu_cols * h), np.int64)
        for y in range(x.shape[0]):
            first = y == 0 or (restart_rows and y % (restart_rows * v) == 0)
            for c in range(x.shape[1]):
                ra = x[y, c - 1] if c else None
                if first:
                    pred = ra if c else 1 << (8 - pt - 1)
                elif c == 0:
                    pred = x[y - 1, 0]
                else:
                    rb, rc = x[y - 1, c], x[y - 1, c - 1]
                    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
                diff = (x[y, c] - pred) & 0xFFFF
                d[y, c] = diff - 65536 if diff >= 32768 else diff
        diffs.append(d)
    codes, dht = _huffman_table(list(range(17)), [5] * 17)
    out = b"\xff\xd8" + app + _segment(0xC3, struct.pack(">BHHB", 8, H, W, len(planes)) + b"".join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, hv)))
    out += _segment(0xC4, b"\x00" + dht)
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * mcu_cols))
    scans = [[c] for c in range(len(planes))] if separate else [list(range(len(planes)))]
    for sc in scans:
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(bytes([ids[c], 0]) for c in sc)
                        + bytes([psv, 0, pt]))
        bits = _Bits()
        data = bytearray()
        for my in range(mcu_rows):
            if restart_rows and my and my % restart_rows == 0:
                bits.flush()
                data += bits.out + bytes([0xFF, 0xD0 + (my // restart_rows - 1) % 8])
                bits.out = bytearray()
            for mx in range(mcu_cols):
                for c in sc:
                    h, v = hv[c]
                    for y in range(v):
                        for x in range(h):
                            s = int(diffs[c][my * v + y, mx * h + x])
                            n = 16 if s == -32768 else abs(s).bit_length()
                            bits.put(*codes[n])
                            if 0 < n < 16:
                                bits.put(s if s > 0 else s - 1, n)
        bits.flush()
        out += bytes(data + bits.out)
    return out + b"\xff\xd9"


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_grey_read_as_cv2(tmp_path, psv):
    """One component, every predictor, point transforms 0 and 2, restarts
    every 0, 1 and 3 rows: grey reads as cv2 (and, for pt 0, is the source
    exactly); colour output of it is None for both (no conversion in
    lossless mode)."""
    im = scene(19, 23, seed=psv)[..., 0]
    path = tmp_path / "l.jpg"
    for pt in (0, 2):
        for rows in (0, 1, 3):
            path.write_bytes(lossless_jpeg([im], [(1, 1)], psv, pt, rows))
            got = imread(str(path), grayscale=True)
            assert np.array_equal(got, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
            assert np.array_equal(got, (im >> pt) << pt)
            assert cv2.imread(str(path)) is None and imread(str(path)) is None


@pytest.mark.parametrize("case", ["RGB", "RGB 2x2 box", "CMYK", "cut", "scan per component",
                                  "scan per component, cut in the last",
                                  "scan per component, cut before the last"])
def test_lossless_colour_read_as_cv2(tmp_path, case):
    """Three components coded RGB (ids 1, 2, 3 and no JFIF: RGB in a
    lossless frame), one of them sampled 2 x 2 (upsampled by replication,
    libjpeg's only upsampling of one-sample blocks), four as CMYK, a file
    cut inside its scan (the rest of each row from the predictor's reset,
    as jdlhuff.c fills it), and one scan per component, whole, cut inside
    its last scan and cut before it (None for both: libjpeg's samples of a
    component no scan wrote are an error, not grey)."""
    im = scene(18, 22, seed=5)
    path = tmp_path / "l.jpg"
    if case == "CMYK":
        planes, hv = [im[..., 0], im[..., 1], im[..., 2], im[..., 0] // 3], [(1, 1)] * 4
    elif case == "RGB 2x2 box":
        planes = [im[..., 2], im[::2, ::2, 1].copy(), im[::2, ::2, 0].copy()]
        hv = [(2, 2), (1, 1), (1, 1)]
    else:
        planes, hv = [im[..., 2], im[..., 1], im[..., 0]], [(1, 1)] * 3
    data = lossless_jpeg(planes, hv, 4, 1, restart_rows=2, separate=case.startswith("scan"))
    last = data.rindex(b"\xff\xda")
    cut = {"cut": len(data) * 2 // 3, "scan per component, cut in the last": last + 60,
           "scan per component, cut before the last": last - 30}.get(case, len(data))
    path.write_bytes(data[:cut])
    if case.endswith("before the last"):
        assert cv2.imread(str(path)) is None and imread(str(path)) is None
        return
    want = cv2.imread(str(path))
    assert np.array_equal(imread(str(path)), want)
    if case == "RGB":
        assert np.array_equal(want, (im >> 1) << 1)
    grey = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = imread(str(path), grayscale=True)
    assert (grey is None and got is None) if case != "CMYK" else np.array_equal(got, grey)


# --------------------------------------------------------------------------
# the other formats cv2.imread reads: a loud refusal
# --------------------------------------------------------------------------

def _written(tmp_path, ext, im, params=()):
    path = tmp_path / f"x.{ext}"
    assert cv2.imwrite(str(path), im, list(params))
    return path


def _format_files(tmp_path):
    """(name the ValueError gives, path) of a file of each of the other
    formats, written by cv2 (or, where cv2 writes none, derived from one)."""
    im = scene(40, 60, seed=9)
    grey = im[..., 1]
    f32 = im.astype(np.float32) / 255
    files = [("BMP", _written(tmp_path, "bmp", im)),
             ("PBM/PGM/PPM", _written(tmp_path, "ppm", im)),
             ("PBM/PGM/PPM", _written(tmp_path, "pgm", grey)),
             ("PBM/PGM/PPM", _written(tmp_path, "pbm", (grey > 128).astype(np.uint8))),
             ("PBM/PGM/PPM", _written(tmp_path, "pnm", im, (cv2.IMWRITE_PXM_BINARY, 0))),
             ("PAM", _written(tmp_path, "pam", im)),
             ("PFM", _written(tmp_path, "pfm", f32)),
             ("Sun raster", _written(tmp_path, "ras", im)),
             ("TIFF", _written(tmp_path, "tiff", im)),
             ("WebP", _written(tmp_path, "webp", im)),
             ("JPEG 2000", _written(tmp_path, "jp2", im)),
             ("AVIF", _written(tmp_path, "avif", im)),
             ("GIF", _written(tmp_path, "gif", im)),
             ("Radiance HDR", _written(tmp_path, "hdr", f32))]
    jp2 = files[10][1].read_bytes()
    box = jp2.index(b"jp2c")
    codestream = tmp_path / "x.j2k"
    codestream.write_bytes(jp2[box + 4:box - 4 + struct.unpack(">I", jp2[box - 4:box])[0]])
    gif87 = tmp_path / "x87.gif"
    gif87.write_bytes(b"GIF87a" + files[12][1].read_bytes()[6:])
    rgbe = tmp_path / "rgbe.hdr"
    rgbe.write_bytes(files[13][1].read_bytes().replace(b"#?RADIANCE", b"#?RGBE", 1))
    # a format is found by content: a BMP named .jpg is still a BMP
    named = tmp_path / "bmp_named.jpg"
    named.write_bytes(files[0][1].read_bytes())
    return files + [("JPEG 2000", codestream), ("GIF", gif87), ("Radiance HDR", rgbe),
                    ("BMP", named)]


def test_other_formats_refused_by_name(tmp_path):
    """Each file cv2.imread reads (in colour or grey: cv2 5.0 reads a
    3-channel PFM only in colour and a 1-channel one only in grey) raises
    ValueError naming the file and the format, in both modes."""
    files = _format_files(tmp_path)
    assert len({name for name, _ in files}) == 11
    for name, path in files:
        assert (cv2.imread(str(path)) is not None
                or cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is not None), path
        for gray in (False, True):
            with pytest.raises(ValueError) as e:
                imread(str(path), grayscale=gray)
            assert str(path) in str(e.value) and name in str(e.value), (name, str(e.value))


def test_nothing_read_stays_none(tmp_path):
    """A missing file, a directory, text, an empty file and a short
    signature-less one are None, as before."""
    (tmp_path / "empty.jpg").write_bytes(b"")
    (tmp_path / "text.jpg").write_bytes(b"not an image at all")
    (tmp_path / "riff.jpg").write_bytes(b"RIFF\x00\x00\x00\x00WAVEfmt ")
    for path in (tmp_path / "missing.png", tmp_path, os.path.join(REPO, "README.md"),
                 tmp_path / "empty.jpg", tmp_path / "text.jpg", tmp_path / "riff.jpg"):
        assert cv2.imread(str(path)) is None and imread(str(path)) is None, path
        assert imread(str(path), grayscale=True) is None
