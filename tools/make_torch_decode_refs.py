"""Write the image files the PyTorch port's decoder is held to on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/make_torch_decode_refs.py

Needs OpenCV and JAX on the CPU (the port's GPU machine has neither; there
``fots_torch.imageio.imread`` must decode these files to the hashes of
``cv2.imread``'s bytes).  Each file is checked against ``cv2`` and the port's
reader here first.  Writes ``fots_torch/assets/decode_ref/``:

- ``prog/img_112.jpg`` ... ``img_115.jpg``: the first four held-out scenes
  (rows 0-3 of ``fots_torch/assets/heldout_eval_u8.npz``) through ``cv2``'s
  progressive writer at quality 95 (libjpeg's ``jpeg_simple_progression``),
  their ``gt_*.txt`` and ``eval.txt`` listing them by relative name;
- ``hand_scripted.jpg``: a 64x96 window of ``img_112`` through the scan
  script of ``tests/test_torch_port_imageio.py``'s own progressive writer
  (non-interleaved DC scans, bands split as mozjpeg splits them, successive
  approximation from ``Al`` = 2, restart markers, a DQT between scans);
- ``cut_sequential.jpg``: a 160x240 window of ``img_113`` through
  ``cv2.imwrite`` (restart interval 4), cut at 60% of its bytes;
- small PNGs: Adam7 RGB, 1-bit grey, 2-bit palette, Adam7 4-bit grey,
  16-bit RGBA, and a palette PNG with an ``eXIf`` orientation (6);
- what libjpeg-turbo and libpng read beyond those, each decoded through its
  own path: ``scene_smoothed.jpg`` (``prog/img_112.jpg`` cut halfway into its
  second scan: block-smoothed, the rows past the cut with the DC scan's
  state), ``scene_cmyk.jpg`` (``img_112`` as Pillow's Adobe-inverted CMYK at
  quality 50, C sampled 2x2) and ``scene_arith.jpg`` (``img_112`` through
  ``tests/test_torch_port_imageio_formats.py``'s arithmetic encoder, SOF9):
  640x960 each, the forms phase 12 of ``chip_smoke.py`` times; on a 64x96
  window of ``img_115``, ``unrefined.jpg`` and ``dc_only.jpg`` (the
  hand-scripted file ended with EOI before its refinement scans, and after
  its DC scans), ``ycck.jpg``, ``rgb_coded.jpg`` (Pillow's ``keep_rgb``),
  ``arith_progressive.jpg`` (SOF10 with restarts and DAC conditioning),
  ``lossless_grey.jpg`` (predictor 4, point transform 1, restarts) and
  ``lossless_rgb.jpg`` (predictor 7); gamma-tagged PNGs (``gAMA`` 45455
  RGB, ``sRGB`` 16-bit RGBA, ``gAMA`` 220000 palette) that grey output reads
  through libpng's gamma tables;
- ``bmp/``, ``gif/``, ``tiff/``: a file for each route of the BMP, GIF and
  TIFF decoders (written by ``cv2.imencode``, Pillow, or the writers of
  ``tests/test_torch_port_imageio_bmp_gif.py`` and ``_tiff.py``) on a 64x96
  window of ``img_112``: 24-bit and V5 BGRA BMP, OS/2 4-bit, 5-6-5 bit
  fields, RLE8, RLE4; an interlaced transparent GIF, a frame offset on its
  screen with a local table; planar tiled 16-bit RGBA LZW, 4-bit palette
  with a 16-bit map, BigTIFF big-endian 16-bit grey with the predictor,
  MinIsWhite 1-bit PackBits in fill order 2, orientation 3 in tiles, grey +
  alpha in clipped tiles.  ``gif/img_112.gif`` is the whole scene through
  ``cv2.imwrite`` (with its gt and ``eval.txt``), and
  ``tiff/img_112_lzw.tif`` / ``_deflate.tif`` 256x384 windows of it through
  ``cv2.imwrite``: the forms phase 12 of ``chip_smoke.py`` times;
- ``webp/`` and ``pnm/``: a file for each route of the WebP decoder (on
  windows of ``img_112``: lossy at an odd size, lossless through every
  predictor, a colour cache, palettes bundled 8, 4 and 2 to a byte, lossy
  with lossless-coded alpha, a raw gradient-filtered alpha plane, the simple
  loop filter with segments, deltas and four partitions from
  ``tests/test_torch_port_imageio_webp.py``'s ``vp8_frame``, an animation's
  first frame at an offset, an EXIF orientation 6, a lossy file cut short)
  and of the Netpbm readers (P1 ASCII without separators, P2 at maxval 7, P3
  ASCII and P5 16-bit, P4, P5 at maxval 100, P6, PAM RGB, 16-bit RGB and
  black-and-white bits, a P6 cut short); ``webp/lossless/img_112.webp`` (the
  progressive ``img_112``'s pixels through ``cv2.imencode`` at quality 101,
  with its gt and ``eval.txt``) and ``webp/lossy/img_112.webp`` ...
  ``img_115.webp`` (the four progressive scenes' pixels at quality 90, with
  their gt, ``eval.txt`` and ``eval_fots_cpu.json``): the forms phase 12 of
  ``chip_smoke.py`` times and runs ``eval_e2e`` over;
- ``tiff_jpeg/``, ``ccitt/``, ``tiff/`` (YCbCr, CMYK, PixarLog),
  ``sunras/``, ``pfm/`` and ``hdr/``: ``tiff_jpeg/img_112.tif`` ...
  ``img_115.tif`` (the four progressive scenes' pixels through
  ``cv2.imwrite`` in TIFF-JPEG, 16 rows a strip) and ``ccitt/img_112.tif``
  ... (their grey binarised by ``cv2.adaptiveThreshold`` (mean of 31x31,
  C 10), through Pillow's Group 4), each set with its gt, ``eval.txt`` and
  ``eval_fots_cpu.json``; on windows of ``img_112``, a file for each route:
  JPEG YCbCr 2x2 in tiles, grey, untagged 2x1 whose last strip's stream
  keeps the strip height; CCITT RLE, RLE-word at an odd offset, Group 3 1-D
  with fill bits, 2-D, a damaged Group 3 2-D strip, Group 4 in tiles in
  fill order 2 (``tests/test_torch_port_imageio_tiff_codings.py``'s
  encoder); YCbCr 4x2 at an odd size, YCbCr with YCbCrCoefficients, planar
  and LZW CMYK, a PixarLog file (None); Sun raster 1-bit and 8-bit with
  maps, 32-bit, ``cv2``'s 24-bit, a byte-encoded one (None); ``cv2``'s
  colour PFM (None in grey) and a grey big-endian one with NaN and
  infinities; ``cv2``'s HDR, flat, old-style run-length and ``#?RGBE``
  files;
- ``jp2/`` and ``tiff/`` (old-style LZW, CIELab, SGILog(24) and the None
  files): ``jp2/lossless/img_112.jp2`` ... (the four progressive scenes'
  pixels through Pillow's lossless 5/3 with RCT) and ``jp2/lossy/`` (9/7
  with ICT at a compression ratio of 12), each set with its gt, ``eval.txt``
  and ``eval_fots_cpu.json`` (greedy and beam 8); on windows of ``img_112``,
  a file for each route of the JPEG 2000 decoder (``cv2``'s lossy JP2, a
  raw RPCL codestream with precincts and layers, every code-block style
  with SOP / EPH in CPRL, ROI and POC over 9/7, tiles in tile-parts, 12-bit
  grey (None in colour, as a one-component codestream), packet headers in
  PPT and in PPM, a palette, sYCC with channel
  definitions, signed components (None), a cut file (None)) and of the
  TIFF codings (old-style LZW with the predictor, Pillow's CIELab, 16-bit
  CIELab tiles, ``cv2``'s SGILog LogLuv and SGILog24, LogL tiles; old-style
  JPEG, ICCLab and ITULab files read as None);
- ``tiff/counts_*`` and ``tiff/directory_*``: a file for each rule of
  libtiff's handling of strip and tile byte counts (missing, zero, wrong,
  equal to the offsets, short, in fill order 2) and of a damaged directory
  field (a signed Photometric, a colour map before BitsPerSample, a tile
  width of no whole bytes, ExtraSamples 999, no Photometric: None) on a
  64x96 window of ``img_112``, and ``tiff/img_113_deflate_no_counts.tif``,
  the progressive ``img_113``'s pixels as one Deflate strip (predictor 2)
  without StripByteCounts;
- ``manifest.json``: for each file its SHA-256 and the shape and SHA-256 of
  ``cv2.imread``'s colour and grey bytes (null where ``cv2`` reads nothing:
  a lossless frame's output in another colour space, a WebP or Netpbm file
  cut short, the files named ``*_none.*``, a PFM in its other mode);
- ``eval_fots_cpu.json``: ``fots.cli.eval_e2e -images_list prog/eval.txt``
  with the shipped snapshot (f32, CPU): summary and match counts;
  ``gif/eval_fots_cpu.json``, the same over ``gif/eval.txt``,
  ``webp/lossy/eval_fots_cpu.json`` over ``webp/lossy/eval.txt``, and
  ``tiff_jpeg/``, ``ccitt/``, ``jp2/lossless/`` and ``jp2/lossy/`` over
  theirs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_torch_eval_asset import run_fots  # noqa: E402

ASSETS = os.path.join(REPO, "fots_torch", "assets")
OUT = os.path.join(ASSETS, "decode_ref")
HELDOUT = os.path.join(ASSETS, "heldout_eval_u8.npz")
HELDOUT_JPG = os.path.join(ASSETS, "heldout_eval_jpg")
SCENES = 4
QUALITY = 95
CUT_FRACTION = 0.6


def _test_writers():
    """The PNG and progressive JPEG writers of the decoder's CPU tests."""
    path = os.path.join(REPO, "tests", "test_torch_port_imageio.py")
    spec = importlib.util.spec_from_file_location("test_torch_port_imageio", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _formats_module():
    """The arithmetic and lossless encoders of the decoder's format tests."""
    sys.path.insert(0, REPO)
    return importlib.import_module("tests.test_torch_port_imageio_formats")


def _cmyk(im):
    """Pillow's CMYK JPEG at quality 50 of a BGR image (K = 255 - max)."""
    import io

    from PIL import Image

    rgb = im[..., ::-1].astype(np.int32)
    k = 255 - rgb.max(-1, keepdims=True)
    cmy = (255 - rgb - k) * 255 // np.maximum(255 - k, 1)
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([cmy, k], -1).astype(np.uint8), "CMYK").save(
        buf, "JPEG", quality=50, subsampling=2)
    return buf.getvalue()


def _scans(data):
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


def format_files(images, names, prog) -> dict:
    """{relative path: bytes} of the files read by the decoder's paths
    beyond baseline, progressive, cut JPEG and plain PNG."""
    import io

    from PIL import Image

    t, f = _test_writers(), _formats_module()
    out = {}
    scans = _scans(prog)
    out["scene_smoothed.jpg"] = prog[:(scans[1] + scans[2]) // 2]
    out["scene_cmyk.jpg"] = _cmyk(images[0])
    out["scene_arith.jpg"] = f.arith_jpeg(images[0])
    win = np.ascontiguousarray(images[3][120:184, 200:296])
    hand = t.hand_scripted_progressive(win, 5)
    scans = _scans(hand)
    out["unrefined.jpg"] = hand[:scans[-4]] + b"\xff\xd9"
    out["dc_only.jpg"] = hand[:scans[2]] + b"\xff\xd9"
    ycck = bytearray(_cmyk(win))
    ycck[ycck.index(b"Adobe") + 11] = 2
    out["ycck.jpg"] = bytes(ycck)
    buf = io.BytesIO()
    Image.fromarray(win[..., ::-1].copy(), "RGB").save(buf, "JPEG", keep_rgb=True)
    out["rgb_coded.jpg"] = buf.getvalue()
    out["arith_progressive.jpg"] = f.arith_jpeg(win, progressive=True, restart=3,
                                                dac={0: (1, 3, 10), 1: (0, 2, 2)})
    grey = np.ascontiguousarray(win[..., 1])
    out["lossless_grey.jpg"] = f.lossless_jpeg([grey], [(1, 1)], 4, 1, restart_rows=2)
    out["lossless_rgb.jpg"] = f.lossless_jpeg([win[..., 2], win[..., 1], win[..., 0]],
                                              [(1, 1)] * 3, 7, 0)
    small = win[:23, :29]

    def tagged(data, chunk, before):
        at = data.index(before) - 4
        return data[:at] + chunk + data[at:]
    out["gamma_rgb.png"] = tagged(t.png_bytes(small[..., ::-1], 8, 2, filters=(0, 1, 4)),
                                  t._chunk(b"gAMA", (45455).to_bytes(4, "big")), b"IDAT")
    rgba = np.concatenate([small[..., ::-1], small[..., :1]], -1).astype(np.uint16) * 257
    rgba += np.arange(rgba.size, dtype=np.uint16).reshape(rgba.shape) % 241
    out["srgb_rgba_16bit.png"] = tagged(t.png_bytes(rgba, 16, 6, filters=(4,)),
                                        t._chunk(b"sRGB", b"\x00"), b"IDAT")
    s4, pal4 = t.png_samples(3, 4, h=23, w=29)
    out["gamma_palette.png"] = tagged(t.png_bytes(s4, 4, 3, pal4, filters=(2,)),
                                      t._chunk(b"gAMA", (220000).to_bytes(4, "big")), b"PLTE")
    return out


def _bmp_gif_tiff_modules():
    sys.path.insert(0, REPO)
    return (importlib.import_module("tests.test_torch_port_imageio_bmp_gif"),
            importlib.import_module("tests.test_torch_port_imageio_tiff"))


def bmp_gif_tiff_files(images) -> dict:
    """{relative path: bytes} of the BMP, GIF and TIFF files: one for each of
    the decoders' routes, on windows of ``img_112`` (``img_112`` whole as a
    GIF, and 256x384 windows as TIFF-LZW and TIFF-Deflate for the timing)."""
    import io

    import cv2
    from PIL import Image

    b, t = _bmp_gif_tiff_modules()
    scene = images[0]
    win = np.ascontiguousarray(scene[200:264, 300:396])
    grey = cv2.cvtColor(win, cv2.COLOR_BGR2GRAY)
    pal16 = [tuple(int(c) for c in v) for v in np.random.default_rng(1).integers(0, 256, (16, 3))]
    out = {}
    for rel, im, params in (("bmp/bgr_24bit.bmp", win, ()),
                            ("bmp/bgra_v5_masks.bmp", np.dstack([win, grey]), ()),
                            ("gif/img_112.gif", scene, ()),
                            ("tiff/img_112_lzw.tif", scene[160:416, 288:672],
                             (cv2.IMWRITE_TIFF_COMPRESSION, 5)),
                            ("tiff/img_112_deflate.tif", scene[160:416, 288:672],
                             (cv2.IMWRITE_TIFF_COMPRESSION, 8))):
        ok, enc = cv2.imencode(os.path.splitext(rel)[1], im, list(params))
        out[rel] = enc.tobytes()
    out["bmp/os2_4bit.bmp"] = b.bmp_bytes(96, 64, 4, 0, b._rows(grey >> 4, 4), pal16, header=12)
    px = ((win[..., 2].astype(np.uint16) >> 3 << 11) | (win[..., 1].astype(np.uint16) >> 2 << 5)
          | (win[..., 0] >> 3)).astype("<u2")
    out["bmp/bitfields_565.bmp"] = b.bmp_bytes(96, 64, 16, 3, b._rows(
        px.view(np.uint8).reshape(64, -1), 8), masks=(0xf800, 0x7e0, 0x1f))
    out["bmp/rle8.bmp"] = b.bmp_bytes(96, 64, 8, 1, b.rle_bytes(grey >> 2),
                                      [(v * 4, v * 4, v * 4) for v in range(64)], clr_used=64)
    out["bmp/rle4.bmp"] = b.bmp_bytes(96, 64, 4, 2, b.rle_bytes(grey >> 4, False), pal16,
                                      header=124)
    p = Image.fromarray(win[..., ::-1].copy()).convert("P")
    buf = io.BytesIO()
    p.save(buf, "GIF", interlace=True, transparency=5)
    out["gif/interlaced_transparent.gif"] = buf.getvalue()
    idx = (grey[:40, :60] >> 4).ravel()
    out["gif/offset_local_table.gif"] = b.gif_bytes(
        96, 64, [b.gce(3), b.gif_frame(20, 12, 60, 40, idx, min_size=4, table=pal16)],
        b._colours(4, 2), bg=1)
    rgba16 = np.dstack([win, grey]).astype(np.int64) * 257
    out["tiff/rgba16_planar_tiles.tif"] = t.tiff_bytes(rgba16, bps=16, planar=2, tile=(32, 48),
                                                       extrasamples=[2], compression=5)
    out["tiff/palette_4bit_16bit_map.tif"] = t.tiff_bytes(
        grey >> 4, bps=4, photometric=3, compression=32773,
        colormap=[c * 257 for v in zip(*pal16) for c in v])
    out["tiff/grey16_bigtiff_big_endian.tif"] = t.tiff_bytes(
        grey.astype(np.int64) * 257 + 100, bps=16, bigtiff=True, big_endian=True,
        compression=8, predictor=2, rows_per_strip=7)
    out["tiff/miniswhite_1bit_fillorder2.tif"] = t.tiff_bytes(grey >> 7, bps=1, photometric=0,
                                                              fillorder=2, compression=32773)
    out["tiff/orientation3_tiles.tif"] = t.tiff_bytes(win, orientation=3, tile=(64, 48),
                                                      compression=8)
    out["tiff/grey_alpha_clipped_tiles.tif"] = t.tiff_bytes(np.dstack([grey, grey[::-1]]),
                                                            extrasamples=[1], tile=(80, 48))
    return out


WEBP_LOSSY_QUALITY = 90


def webp_pnm_files(images, prog_images, prog_names) -> dict:
    """{relative path: bytes} of ``webp/`` and ``pnm/``."""
    import cv2

    sys.path.insert(0, REPO)
    w = importlib.import_module("tests.test_torch_port_imageio_webp")
    rng = np.random.default_rng(18)
    scene = images[0]
    win = np.ascontiguousarray(scene[200:264, 300:396])
    small = np.ascontiguousarray(scene[200:224, 300:332])
    out = {"webp/lossy_37x53.webp": w.cv2_webp(np.ascontiguousarray(scene[210:247, 320:373]),
                                                 75),
           "webp/lossless_predictors.webp": w.pil_webp(win, lossless=True, method=6,
                                                       quality=100)}
    pal = rng.integers(0, 256, (300, 3), np.uint8)
    out["webp/lossless_colour_cache.webp"] = w.pil_webp(pal[rng.integers(0, 300, (48, 64))],
                                                        lossless=True, method=6, quality=100)
    for n in (2, 4, 16):
        pal = rng.integers(0, 256, (n, 3), np.uint8)
        out[f"webp/palette_{n}.webp"] = w.pil_webp(pal[rng.integers(0, n, (29, 43))],
                                                   lossless=True)
    alpha = np.add.outer(np.arange(64) * 3, np.arange(96) * 2).astype(np.uint8)
    out["webp/lossy_alpha.webp"] = w.pil_webp(np.dstack([win, alpha]), quality=70)
    out["webp/raw_alpha_gradient.webp"] = w._alpha_file(win, 3 << 2,
                                                        w._filtered(alpha, 3).tobytes())
    out["webp/simple_filter_segments.webp"] = w.riff([w.chunk(b"VP8 ", w.vp8_frame(
        53, 37, 18, simple=1, level=30, sharpness=2, parts_log2=2, skip_prob=150,
        segments=dict(update_map=1, absolute=0, quant=(-10, 0, 12, 30), strength=(-8, 0, 6, 20),
                      probs=(100, 150, 60)),
        lf_delta=dict(ref=(6, 0, 0, 0), mode=(-4, 0, 0, 0)), i4x4_share=0.3))])
    frame = w.chunk(b"VP8L", dict(w.chunks_of(w.pil_webp(small, lossless=True)))[b"VP8L"])
    out["webp/animation_offset.webp"] = w.riff([w.vp8x(0x02, 48, 40), w.anim((10, 20, 30, 255)),
                                                w.anmf(6, 8, 32, 24, frame),
                                                w.anmf(0, 0, 32, 24, frame)])
    vp8 = w.chunk(b"VP8 ", dict(w.chunks_of(w.cv2_webp(win, 80)))[b"VP8 "])
    out["webp/exif_orientation_6.webp"] = w.riff([w.vp8x(0x08, 96, 64), vp8,
                                                  w.chunk(b"EXIF", w.exif_orientation(6))])
    lossy = w.cv2_webp(win, 60)
    out["webp/lossy_cut.webp"] = lossy[:len(lossy) * 2 // 3]
    out["webp/lossless/img_112.webp"] = w.cv2_webp(prog_images[0], 101)
    for im, name in zip(prog_images, prog_names):
        out[f"webp/lossy/{os.path.splitext(name)[0]}.webp"] = w.cv2_webp(im, WEBP_LOSSY_QUALITY)
    # Netpbm
    grey = cv2.cvtColor(win, cv2.COLOR_BGR2GRAY)
    sgrey = grey[:24, :32]

    def head(magic, wd, ht, maxval=None):
        return b"P%d\n# fots_torch decode_ref\n%d %d\n" % (magic, wd, ht) + (
            b"" if maxval is None else b"%d\n" % maxval)

    out["pnm/p1_no_separators.pbm"] = head(1, 32, 24) + b"".join(
        b"".join(b"1" if v > 128 else b"0" for v in row) + b"\n" for row in sgrey)
    out["pnm/p2_maxval_7.pgm"] = head(2, 32, 24, 7) + b"\n".join(
        b" ".join(b"%d" % (v >> 5) for v in row) for row in sgrey) + b"\n"
    rgb16 = small[..., ::-1].astype(np.int64) * 200
    out["pnm/p3_16bit.ppm"] = head(3, 32, 24, 51000) + b"\n".join(
        b" ".join(b"%d" % v for v in row.ravel()) for row in rgb16) + b"\n"
    out["pnm/p4.pbm"] = head(4, 96, 64) + np.packbits(grey < 100, axis=1).tobytes()
    out["pnm/p5_maxval_100.pgm"] = head(5, 96, 64, 100) + (grey * 100 // 255).tobytes()
    out["pnm/p5_16bit.pgm"] = head(5, 96, 64, 65535) + (grey.astype(">u2") * 257).tobytes()
    out["pnm/p6.ppm"] = head(6, 96, 64, 255) + np.ascontiguousarray(win[..., ::-1]).tobytes()
    out["pnm/p6_cut.ppm"] = out["pnm/p6.ppm"][:9000]

    def pam(wd, ht, depth, maxval, tupltype, body):
        return (b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\nTUPLTYPE %s\nENDHDR\n"
                % (wd, ht, depth, maxval, tupltype) + body)

    out["pnm/pam_rgb.pam"] = pam(96, 64, 3, 255, b"RGB", win[..., ::-1].tobytes())
    out["pnm/pam_rgb_16bit.pam"] = pam(32, 24, 3, 4000, b"RGB",
                                       (small[..., ::-1].astype(">u2") * 15).tobytes())
    out["pnm/pam_blackandwhite.pam"] = pam(96, 64, 1, 1, b"BLACKANDWHITE",
                                           (grey > 128).astype(np.uint8).tobytes())
    return out


BINARISE = (31, 10)  # cv2.adaptiveThreshold's block size and C for the Group 4 scenes


def binarised(im):
    """A scene's grey through cv2.adaptiveThreshold (mean): 0 or 255."""
    import cv2

    grey = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
    return cv2.adaptiveThreshold(grey, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY,
                                 *BINARISE)


def codings_files(prog_images, prog_names) -> dict:
    """{relative path: bytes} of ``tiff_jpeg/``, ``ccitt/``, the new files
    of ``tiff/``, ``sunras/``, ``pfm/`` and ``hdr/``."""
    import io

    import cv2
    from PIL import Image

    sys.path.insert(0, REPO)
    c = importlib.import_module("tests.test_torch_port_imageio_tiff_codings")
    f = importlib.import_module("tests.test_torch_port_imageio_sunras_pfm_hdr")
    out = {}
    for im, name in zip(prog_images, prog_names):
        stem = os.path.splitext(name)[0]
        ok, enc = cv2.imencode(".tif", im, [cv2.IMWRITE_TIFF_COMPRESSION, 7,
                                            cv2.IMWRITE_TIFF_ROWSPERSTRIP, 16])
        out[f"tiff_jpeg/{stem}.tif"] = enc.tobytes()
        buf = io.BytesIO()
        Image.fromarray(binarised(im)).convert("1").save(buf, "TIFF", compression="group4")
        out[f"ccitt/{stem}.tif"] = buf.getvalue()
    win = np.ascontiguousarray(prog_images[0][200:264, 300:396])
    rgb = np.ascontiguousarray(win[..., ::-1])
    out["tiff_jpeg/ycbcr_2x2_tiles.tif"] = c.jpeg_tiff(rgb, tile=(32, 16), subsampling=2)
    out["tiff_jpeg/grey_strips.tif"] = c.jpeg_tiff(rgb[..., 1], 16)
    out["tiff_jpeg/ycbcr_2x1_untagged_full_last_strip.tif"] = c.jpeg_tiff(
        rgb[:56], 16, 1, ycbcr_tag=False, strip_height=16)
    bits = (binarised(win) == 0).astype(np.uint8)
    out["ccitt/rle.tif"] = c.fax_tiff(bits, 2, rows_per_strip=16)
    out["ccitt/rle_word_odd_offset.tif"] = c.fax_tiff(bits, 32771, rows_per_strip=16, lead=1)
    out["ccitt/g3_1d_fill_bits.tif"] = c.fax_tiff(bits, 3, fill_bits=True, photometric=1)
    out["ccitt/g3_2d.tif"] = c.fax_tiff(bits, 3, two_d=True, rtc=True)
    damaged = bytearray(out["ccitt/g3_2d.tif"])
    coded = struct.unpack("<I", damaged[4:8])[0] - 8  # the rows' bytes, before the directory
    for k in (1, 4, 5, 8):
        damaged[8 + coded * k // 10] ^= 0x24
    out["ccitt/g3_2d_damaged.tif"] = bytes(damaged)
    out["ccitt/g4_tiles_fill_order_2.tif"] = c.fax_tiff(bits, 4, tile=(32, 32), fillorder=2)
    out["tiff/ycbcr_4x2_odd_size.tif"] = c.ycbcr_tiff(45, 29, 4, 2, seed=1, rows_per_strip=6)
    out["tiff/ycbcr_1x1_coefficients.tif"] = c.ycbcr_tiff(33, 21, 1, 1, seed=2, coefficients=(
        2126, 10000, 7152, 10000, 722, 10000), refbw=(16, 1, 235, 1, 128, 1, 240, 1, 128, 1,
                                                       240, 1))
    k = 255 - rgb.max(-1, keepdims=True)
    cmyk = np.concatenate([255 - rgb - k, k], -1)
    out["tiff/cmyk_planar.tif"] = c.cmyk_tiff(cmyk, planar=2)
    out["tiff/cmyk_lzw_tiles.tif"] = c.cmyk_tiff(cmyk, compression=5, tile=(32, 32))
    ok, enc = cv2.imencode(".tif", win[:12, :17], [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    raw = enc.tobytes()
    at = raw.index(struct.pack("<HHIH", 259, 3, 1, 1))
    out["tiff/pixarlog_none.tif"] = raw[:at] + struct.pack("<HHIH", 259, 3, 1, 32909) + raw[
        at + 10:]
    grey = cv2.cvtColor(win, cv2.COLOR_BGR2GRAY)
    pal = np.random.default_rng(3).integers(0, 256, 768, np.uint8).tobytes()
    out["sunras/1bit_map.ras"] = f.sunras_bytes(96, 64, 1, f.sunras_rows(grey < 100, 1), 1, 1,
                                                pal[:6])
    out["sunras/8bit_map_old.ras"] = f.sunras_bytes(96, 64, 8, f.sunras_rows(grey, 8), 0, 1, pal)
    out["sunras/32bit.ras"] = f.sunras_bytes(96, 64, 32, f.sunras_rows(
        np.concatenate([grey[..., None], win], -1), 32))
    out["sunras/24bit_cv2.ras"] = cv2.imencode(".ras", win)[1].tobytes()
    out["sunras/byte_encoded_none.ras"] = f.sunras_bytes(96, 64, 8, f.sunras_rows(grey, 8), 2)
    out["pfm/colour_cv2.pfm"] = cv2.imencode(".pfm", win.astype(np.float32) / 100)[1].tobytes()
    special = (grey[:16, :24].astype(np.float32) * 1.5 - 20)
    special[0, :4] = [np.nan, np.inf, -np.inf, 3e9]
    out["pfm/grey_big_endian.pfm"] = f.pfm_bytes(special, 1.5)
    out["hdr/rle_cv2.hdr"] = cv2.imencode(".hdr", win.astype(np.float32) / 200)[1].tobytes()
    px = f.rgbe(win[:16, :24, ::-1].astype(np.float64) / 90)
    out["hdr/flat.hdr"] = f.hdr_bytes(px, "flat")
    out["hdr/old_rle_padded.hdr"] = f.hdr_bytes(px, "old_rle") + bytes(px.size)
    out["hdr/rgbe_magic.hdr"] = f.hdr_bytes(px, magic=b"#?RGBE")
    return out


JP2_LOSSY_RATE = 12  # compression ratio of the irreversible JP2 scenes (Pillow's "rates")
JP2_BEAM = 8  # the recognition beam of the JP2 scenes' second evaluation


def jp2_lab_log_files(prog_images, prog_names) -> dict:
    """{relative path: bytes} of ``jp2/`` and the old-style LZW, CIELab,
    SGILog, old-style JPEG, ICCLab and ITULab files of ``tiff/``."""
    import io

    import cv2
    from PIL import Image

    sys.path.insert(0, REPO)
    j = importlib.import_module("tests.test_torch_port_imageio_jp2")
    t = importlib.import_module("tests.test_torch_port_imageio_tiff")
    c = importlib.import_module("tests.test_torch_port_imageio_tiff_codings")
    lab = importlib.import_module("tests.test_torch_port_imageio_tiff_lab_log")
    out = {}
    for im, name in zip(prog_images, prog_names):
        stem = os.path.splitext(name)[0]
        out[f"jp2/lossless/{stem}.jp2"] = j.pil_jp2(im, mct=1)
        out[f"jp2/lossy/{stem}.jp2"] = j.pil_jp2(im, irreversible=True, mct=1,
                                                 quality_mode="rates",
                                                 quality_layers=[JP2_LOSSY_RATE])
    win = np.ascontiguousarray(prog_images[0][200:264, 300:396])
    planes = j.planes_of(win)
    out["jp2/cv2_lossy.jp2"] = cv2.imencode(".jp2", win, [
        cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 200])[1].tobytes()
    out["jp2/codestream_rpcl_precincts_layers.j2k"] = j.pil_jp2(
        win, no_jp2=True, progression="RPCL", precinct_size=(32, 32), codeblock_size=(8, 8),
        quality_layers=[40, 10, 2], irreversible=True)
    out["jp2/styles_sop_eph_cprl.j2k"] = j.opj_encode(planes, mode=63, csty=6, prog=4,
                                                      rates=(20, 5), mct=1)
    out["jp2/roi_poc_9_7.j2k"] = j.opj_encode(planes, roi=(0, 6), irreversible=True, mct=1,
                                              pocs=[(0, 0, 1, 3, 3, 1), (3, 0, 1, 6, 3, 2)])
    out["jp2/tiles_tile_parts_pcrl.j2k"] = j.opj_encode(planes, tiles=(40, 24, 0, 0), numres=3,
                                                        tile_parts="R", prog=3)
    out["jp2/grey_12bit_colour_none.j2k"] = j.opj_encode([planes[1].astype(np.int64) * 16 + 7],
                                                         prec=12)
    out["jp2/ppt_headers.j2k"] = j.moved_headers(j.opj_encode(planes, csty=6, rates=(30, 8)),
                                                 "ppt")
    out["jp2/ppm_headers.j2k"] = j.moved_headers(j.opj_encode(planes, csty=6, mode=1), "ppm")
    grey = cv2.cvtColor(win, cv2.COLOR_BGR2GRAY)
    index = grey // 2
    entries = [[v * 2, 255 - v * 2, (v * 7) % 256] for v in range(128)]
    out["jp2/palette.jp2"] = j.jp2_file(j.opj_encode([index]), 64, 96, 1,
                                        pclr=(entries, [8, 8, 8]),
                                        cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    out["jp2/sycc_cdef.jp2"] = j.jp2_file(j.opj_encode(planes), 64, 96, 3, colr=18,
                                          cdef=[(0, 0, 1), (1, 0, 3), (2, 0, 2)])
    out["jp2/signed_none.j2k"] = j.opj_encode([p.astype(np.int64) - 128 for p in planes],
                                              sgnd=True)
    lossless = out[f"jp2/lossless/{os.path.splitext(prog_names[0])[0]}.jp2"]
    out["jp2/cut_none.jp2"] = lossless[:len(lossless) // 3]
    out["tiff/old_style_lzw_predictor.tif"] = t.tiff_bytes(win, compression=5, old_lzw=True,
                                                           predictor=2, rows_per_strip=16)
    buf = io.BytesIO()
    Image.fromarray(win[..., ::-1].copy()).convert("LAB").save(buf, "TIFF")
    out["tiff/cielab8_pillow.tif"] = buf.getvalue()
    rng = np.random.default_rng(20)
    out["tiff/cielab16_tiles.tif"] = lab._lab_tiff(rng.integers(0, 65536, (45, 70, 3)), 16,
                                                   tile=(32, 16))
    ok, enc = cv2.imencode(".tif", win.astype(np.float32) / 150,
                           [cv2.IMWRITE_TIFF_COMPRESSION, 34676])
    out["tiff/sgilog_luv_cv2.tif"] = enc.tobytes()
    ok, enc = cv2.imencode(".tif", win.astype(np.float32) / 150,
                           [cv2.IMWRITE_TIFF_COMPRESSION, 34677])
    out["tiff/sgilog24_cv2.tif"] = enc.tobytes()
    out["tiff/sgilog_logl_tiles.tif"] = lab.sgilog_tiff(lab._log_values(rng, (45, 70), False),
                                                        False, tile=(32, 16))
    stream = io.BytesIO()
    Image.fromarray(win[:16, :24, ::-1].copy()).save(stream, "JPEG")
    out["tiff/old_jpeg_none.tif"] = c.raw_tiff(24, 16, [stream.getvalue()], {
        258: (3, [8, 8, 8]), 259: (3, [6]), 262: (3, [6]), 277: (3, [3]), 278: (4, [16])})
    for photometric, what in ((9, "icclab"), (10, "itulab")):
        out[f"tiff/{what}_none.tif"] = c.raw_tiff(24, 16, [win[:16, :24].tobytes()], {
            258: (3, [8, 8, 8]), 259: (3, [1]), 262: (3, [photometric]), 277: (3, [3]),
            278: (4, [16])})
    return out


def counts_directory_files(prog_images, prog_names) -> dict:
    """{relative path: bytes} of the byte-count and directory files of
    ``tiff/``: a file for each rule of libtiff's handling of strip and tile
    byte counts and of directory damage the port models, on a 64x96 window
    of ``img_112``, and ``img_113`` whole as one Deflate strip without
    StripByteCounts."""
    import cv2

    sys.path.insert(0, REPO)
    t = importlib.import_module("tests.test_torch_port_imageio_tiff")
    k = importlib.import_module("tests.test_torch_port_imageio_tiff_counts")
    win = np.ascontiguousarray(prog_images[0][200:264, 300:396])
    rgb = win[..., ::-1]
    grey = cv2.cvtColor(win, cv2.COLOR_BGR2GRAY)

    def first(delta):
        return lambda offsets, counts: [counts[0] + delta] + counts[1:]
    out = {}
    # EstimateStripByteCounts: the tag missing, one strip's count 0, the
    # first two of four uncompressed strips' counts differing (the counts
    # equal to the offsets among them) or of four tiles
    out["tiff/counts_missing_deflate.tif"] = k.patch_counts(t.tiff_bytes(rgb, compression=8),
                                                            drop=True)
    out["tiff/counts_missing_planes.tif"] = k.patch_counts(t.tiff_bytes(rgb, planar=2),
                                                           drop=True)
    out["tiff/counts_zero_packbits.tif"] = k.patch_counts(t.tiff_bytes(rgb, compression=32773),
                                                          lambda offsets, counts: [0])
    # (the estimate, 64 // 4 rows a strip, ends past the file's last strip)
    strips = t.tiff_bytes(rgb, rows_per_strip=20, ifd_first=False) + bytes(4096)
    out["tiff/counts_wrong_raw_strips.tif"] = k.patch_counts(strips, first(-5))
    out["tiff/counts_are_offsets.tif"] = k.patch_counts(strips, lambda offsets, counts: offsets)
    tiles = t.tiff_bytes(rgb, tile=(64, 32))
    out["tiff/counts_first_tile_short.tif"] = k.patch_counts(tiles, first(-7))
    # a short uncompressed strip reads as nothing; a short last tile fails
    out["tiff/counts_raw_strip_short.tif"] = k.patch_counts(
        t.tiff_bytes(grey, rows_per_strip=32), first(-1))
    out["tiff/counts_last_tile_short_none.tif"] = k.patch_counts(
        tiles, lambda offsets, counts: counts[:-1] + [counts[-1] - 7])
    out["tiff/counts_fillorder2_tile_short.tif"] = k.patch_counts(
        t.tiff_bytes(np.dstack([rgb[:16, :32], grey[:16, :32]]), tile=(16, 16), fillorder=2),
        first(-24))
    # one directory field: a signed Photometric, a colour map before
    # BitsPerSample (ignored: the palette reads as grey), a tile width of no
    # whole bytes (the 1-bit put routine's skew), ExtraSamples 999, no
    # Photometric (None)
    rgb8 = t.tiff_bytes(rgb, compression=8)
    out["tiff/directory_photometric_sshort.tif"] = k._edit(rgb8, 262, typ=8)
    rng = np.random.default_rng(21)
    palette = t.tiff_bytes(grey, photometric=3, colormap=[int(v) for v in rng.integers(
        0, 65536, 768)])
    out["tiff/directory_colormap_first.tif"] = k._moved(palette, 320, 258)
    out["tiff/directory_tile_width_250_1bit.tif"] = t.tiff_bytes(grey >> 7, bps=1,
                                                                 tile=(250, 16))
    out["tiff/directory_extrasamples_999.tif"] = k._edit(
        t.tiff_bytes(np.dstack([rgb, grey]), extrasamples=[2]), 338, value=999)
    out["tiff/directory_no_photometric_none.tif"] = k._edit(rgb8, 262)
    out["tiff/img_113_deflate_no_counts.tif"] = k.patch_counts(
        t.tiff_bytes(prog_images[1][..., ::-1], compression=8, predictor=2), drop=True)
    return out


def files(images, names) -> dict:
    """{relative path: bytes} of every file but the scenes' annotations."""
    import cv2

    t = _test_writers()
    out = {}
    for im, name in zip(images[:SCENES], names[:SCENES]):
        ok, enc = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
                                            cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        out[f"prog/{name}"] = enc.tobytes()
    out["hand_scripted.jpg"] = t.hand_scripted_progressive(images[0][200:264, 300:396], 5)
    ok, enc = cv2.imencode(".jpg", images[1][100:260, 200:440], [cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    out["cut_sequential.jpg"] = enc.tobytes()[:int(len(enc) * CUT_FRACTION)]
    window = images[2][:21, :27]
    grey = cv2.cvtColor(window, cv2.COLOR_BGR2GRAY)
    s2, pal2 = t.png_samples(3, 2, h=21, w=27)
    out["adam7_rgb.png"] = t.png_bytes(window[..., ::-1], 8, 2, filters=(0, 1, 2, 3, 4),
                                       interlace=1)
    out["grey_1bit.png"] = t.png_bytes(grey >> 7, 1, 0, filters=(1, 4))
    out["palette_2bit.png"] = t.png_bytes(s2, 2, 3, pal2, filters=(2, 3))
    out["adam7_grey_4bit.png"] = t.png_bytes(grey >> 4, 4, 0, filters=(4,), interlace=1)
    rgba = np.concatenate([window[..., ::-1], grey[..., None]], -1).astype(np.uint16) * 257
    rgba += np.arange(rgba.size, dtype=np.uint16).reshape(rgba.shape) % 251  # low bytes
    out["rgba_16bit.png"] = t.png_bytes(rgba, 16, 6, filters=(0, 4))
    exif = t._chunk(b"eXIf", t._tiff_orientation(6, False))
    out["exif_palette.png"] = t.png_bytes(s2, 2, 3, pal2, filters=(1,), extra=exif)
    out.update(format_files(images, names, out[f"prog/{names[0]}"]))
    out.update(bmp_gif_tiff_files(images))
    prog = [cv2.imdecode(np.frombuffer(out[f"prog/{n}"], np.uint8), cv2.IMREAD_COLOR)
            for n in names[:SCENES]]
    out.update(webp_pnm_files(images, prog, names[:SCENES]))
    out.update(codings_files(prog, names[:SCENES]))
    out.update(jp2_lab_log_files(prog, names[:SCENES]))
    out.update(counts_directory_files(prog, names[:SCENES]))
    return out


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> int:
    import cv2
    import jax

    from fots_torch.imageio import imread

    with np.load(HELDOUT) as z:
        images = z["images"]
        names = [os.path.basename(str(n)) for n in z["names"]]
    shutil.rmtree(OUT, ignore_errors=True)
    for sub in ("prog", "bmp", "gif", "tiff", "webp/lossless", "webp/lossy", "pnm", "tiff_jpeg",
                "ccitt", "sunras", "pfm", "hdr", "jp2/lossless", "jp2/lossy"):
        os.makedirs(os.path.join(OUT, sub))
    manifest = {}
    for rel, data in files(images, names).items():
        path = os.path.join(OUT, rel)
        with open(path, "wb") as f:
            f.write(data)
        entry = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
        for key, flag in (("colour", cv2.IMREAD_COLOR), ("grey", cv2.IMREAD_GRAYSCALE)):
            want = cv2.imread(path, flag)
            got = imread(path, grayscale=key == "grey")
            if want is None and got is None and (
                    rel.startswith(("lossless_", "pfm/")) or "_none." in rel
                    or rel.endswith(("_cut.webp", "_cut.ppm"))):
                # a lossless frame's other colour space; a file cut short; a
                # coding OpenCV's build lacks; a PFM read in its other mode
                entry[key] = None
                continue
            if want is None or got is None or not np.array_equal(got, want):
                raise RuntimeError(f"{rel}: the port does not read it as cv2 does ({key})")
            entry[key] = {"shape": list(want.shape), "sha256": _digest(want)}
        manifest[rel] = entry
        read = entry["colour"] or entry["grey"]
        print(f"{rel}: {len(data)} bytes, {read['shape'] if read else 'None (as cv2)'}")
    for name in names[:SCENES]:
        shutil.copy(os.path.join(HELDOUT_JPG, f"gt_{os.path.splitext(name)[0]}.txt"),
                    os.path.join(OUT, "prog"))
    with open(os.path.join(OUT, "prog", "eval.txt"), "w") as f:
        f.writelines(n + "\n" for n in names[:SCENES])
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    shutil.copy(os.path.join(HELDOUT_JPG, f"gt_{os.path.splitext(names[0])[0]}.txt"),
                os.path.join(OUT, "gif"))
    gif_scene = os.path.splitext(names[0])[0] + ".gif"
    with open(os.path.join(OUT, "gif", "eval.txt"), "w") as f:
        f.write(gif_scene + "\n")
    stems = [os.path.splitext(n)[0] for n in names[:SCENES]]
    for sub, listed, ext in (("webp/lossless", stems[:1], "webp"), ("webp/lossy", stems, "webp"),
                             ("tiff_jpeg", stems, "tif"), ("ccitt", stems, "tif"),
                             ("jp2/lossless", stems, "jp2"), ("jp2/lossy", stems, "jp2")):
        for stem in listed:
            shutil.copy(os.path.join(HELDOUT_JPG, f"gt_{stem}.txt"), os.path.join(OUT, sub))
        with open(os.path.join(OUT, sub, "eval.txt"), "w") as f:
            f.writelines(f"{stem}.{ext}\n" for stem in listed)
    for sub, paths, what in (
            ("", [os.path.join(OUT, "prog", n) for n in names[:SCENES]],
             f"{SCENES} progressive scenes"),
            ("gif", [os.path.join(OUT, "gif", gif_scene)], "the GIF scene"),
            ("webp/lossy", [os.path.join(OUT, "webp", "lossy", f"{s}.webp") for s in stems],
             f"the {SCENES} lossy WebP scenes"),
            ("tiff_jpeg", [os.path.join(OUT, "tiff_jpeg", f"{s}.tif") for s in stems],
             f"the {SCENES} TIFF-JPEG scenes"),
            ("ccitt", [os.path.join(OUT, "ccitt", f"{s}.tif") for s in stems],
             f"the {SCENES} binarised Group 4 scenes"),
            ("jp2/lossless", [os.path.join(OUT, "jp2", "lossless", f"{s}.jp2") for s in stems],
             f"the {SCENES} lossless JP2 scenes"),
            ("jp2/lossy", [os.path.join(OUT, "jp2", "lossy", f"{s}.jp2") for s in stems],
             f"the {SCENES} irreversible JP2 scenes")):
        run = run_fots(paths, [])
        result = {"snapshot": "artifacts/serving_params.npz", "images_list": os.path.relpath(
                      os.path.join(OUT, sub or "prog", "eval.txt"), REPO),
                  "precision": "f32", "platform": jax.default_backend(), "jax": jax.__version__,
                  "opencv": cv2.__version__,
                  "run": {k: run[k] for k in ("summary", "counts")}}
        if sub.startswith("jp2"):  # and with prefix beam search of width 8
            beam = run_fots(paths, ["-beam", str(JP2_BEAM)])
            result["run_beam"] = {"beam": JP2_BEAM,
                                  **{k: beam[k] for k in ("summary", "counts")}}
        with open(os.path.join(OUT, sub, "eval_fots_cpu.json"), "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
        print(f"fots eval_e2e over {what}: {run['counts']} "
              f"{ {k: round(v, 4) for k, v in run['summary'].items() if k.endswith('hmean')} }")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(f"wrote {OUT} ({size / 1e6:.3f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
