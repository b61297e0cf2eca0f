"""Fuzz the port's WebP, Netpbm, TIFF-coding, Sun raster, PFM, HDR and JPEG
2000 readers against ``cv2.imread``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/fuzz_torch_decoders.py [--seed S] [--scale K]

Needs OpenCV and Pillow on the CPU (the port's GPU machine has
neither).  Every file is written to a temporary directory and read by
``cv2.imread`` and ``fots_torch.imageio.imread`` in colour and grey; the
two must agree byte for byte, on None, and on raising.  Kinds (``--scale``
multiplies the counts):

- ``encoders`` (300): Pillow's libwebp at random options (lossy, lossless,
  ``exact``, alpha qualities, methods), palettes of 2-256 colours and
  ``cv2.imencode`` at random qualities, on random windows and sizes;
- ``damaged`` (1000): those files cut at a random byte or with 1-3 bits
  flipped past the RIFF header;
- ``vp8_writer`` (300): frames of ``tests/test_torch_port_imageio_webp.py``'s
  ``vp8_frame`` at random filters, sharpness, segments, deltas, partitions,
  skips, quantisers and coefficient sizes (up to 2,000);
- ``animations`` (300): random canvases and frames (offsets, blends,
  disposals, lossy / lossless / alpha frames, EXIF, shuffled chunks), a
  quarter cut and a quarter bit-flipped;
- ``containers`` (300): a still image's chunks with EXIF / ICCP / XMP /
  unknown / extra ALPH / VP8X / ANIM chunks, reordered, random VP8X flags
  and canvases, RIFF sizes off by up to 12, trailing bytes, cuts;
- ``netpbm`` (1000): P1-P7 with random separators and comments, maxvals,
  tuple types and depths, cut or with a byte replaced; OpenCV's PAM reader
  leaves part of a GRAYSCALE_ALPHA / RGB_ALPHA row unwritten, so those
  bytes are compared only on the port's side (zeros);
- ``tiff_jpeg`` (300): ``cv2.imencode``'s TIFF-JPEG and
  ``tests/test_torch_port_imageio_tiff_codings.py``'s ``jpeg_tiff`` at random
  sizes, subsamplings, qualities, strips, tiles, tables in each stream, full
  last strips, grey; a third with 1-3 bits flipped, a fifth cut;
- ``ccitt`` (1000): that module's ``fax_tiff`` (RLE, RLE-word at odd and
  even offsets, Group 3 1-D / 2-D with fill bits, Group 4, fill orders,
  photometrics, strips) of text-like or random rows; half with 1-3 bits
  flipped in the coded rows, a third with their tail zeroed or replaced;
- ``ycbcr_cmyk`` (300): ``ycbcr_tiff`` at every subsampling (and three
  without a put routine), sizes, strips, tiles, LZW, coefficients and
  reference black and white, planar; ``cmyk_tiff`` at 4 and 5 samples,
  planar, LZW, tiles, ink sets;
- ``sunras`` (300): random headers (types 0-3, depths 1/4/8/16/24/32, map
  types and lengths) over random rows, a sixth cut, a sixth with a header
  bit flipped;
- ``pfm`` (300): random floats (NaN, infinities, huge, negative) at random
  scales (0 and NaN included), both channel counts and byte orders, a fifth
  cut;
- ``hdr`` (300): ``cv2.imencode``'s HDRs of random floats, a quarter cut, a
  third with 1-3 bits flipped, some under ``#?RGBE``;
- ``jp2`` (600): ``cv2.imwrite``'s JP2 at random rates, Pillow's files and
  codestreams at random options (orders, layers, tiles, resolutions, 9/7,
  MCT), ``tests/test_torch_port_imageio_jp2.py``'s ``opj_encode`` at random
  code-block styles, SOP / EPH, ROI, tile-parts, precisions and component
  counts, and its ``jp2_file`` with palettes, channel definitions and colour
  spaces; 85% then cut at a random byte or with 1-3 bytes replaced;
- ``tiff_lzw_old`` (300): old-style LZW of ``tiff_bytes`` (grey, RGB, 16 bits,
  the predictor, strips, tiles, planes, fill orders), a third with 1-3
  bytes replaced in the strips, a fifth cut.  These TIFF kinds replace bytes
  between the header and the directory only; the directory is the last two
  kinds' to damage;
- ``cielab`` (300): 8- and 16-bit CIELab (random samples, WhitePoint tags,
  strips, tiles, LZW, flips), a tenth of them cut and a tenth with bytes
  replaced in the data, and Pillow's LAB scenes;
- ``sgilog`` (300): ``cv2.imwrite``'s SGILog and SGILog24 of random floats
  (LogLuv, LogL) and ``tests/test_torch_port_imageio_tiff_lab_log.py``'s
  ``sgilog_tiff`` / ``sgilog24_tiff`` in strips and tiles, a third with
  bytes replaced in the data, a fifth cut;
- ``tiff_counts`` (300): a TIFF of any writer above (``_any_tiff``) with its
  strip or tile byte counts removed, zero, short, long, past the end of the
  file, over 1 MiB, equal to the offsets, or all one value
  (``tests/test_torch_port_imageio_tiff_counts.py``'s ``patch_counts``);
- ``tiff_directory`` (300): such a TIFF with one field of its first
  directory damaged (that module's ``directory_damage``: one entry's type,
  count, value or offset, or the entry duplicated, moved out of order or
  removed); its mismatches are also counted by tag.

Prints the counts of each kind (files, None, mismatches) and writes each
mismatching file beside the temporary directory's path it prints.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KINDS = {"encoders": 300, "damaged": 1000, "vp8_writer": 300, "animations": 300,
         "containers": 300, "netpbm": 1000, "tiff_jpeg": 300, "ccitt": 1000, "ycbcr_cmyk": 300,
         "sunras": 300, "pfm": 300, "hdr": 300, "jp2": 600, "tiff_lzw_old": 300, "cielab": 300,
         "sgilog": 300, "tiff_counts": 300, "tiff_directory": 300}


def _read(path, gray):
    import cv2

    from fots_torch.imageio import imread

    out = []
    for reader in (lambda: cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR),
                   lambda: imread(path, grayscale=gray)):
        try:
            out.append(reader())
        except (cv2.error, ValueError):
            out.append("raise")
    return out


def same(path, data, depth=None) -> tuple:
    """(cv2 read something in colour, both agree in both modes)."""
    with open(path, "wb") as f:
        f.write(data)
    read = None
    for gray in (False, True):
        want, got = _read(path, gray)
        if not gray:
            read = isinstance(want, np.ndarray)
        if isinstance(want, np.ndarray) and isinstance(got, np.ndarray):
            if want.shape != got.shape:
                return read, False
            if depth in (2, 4):  # the PAM reader's unwritten bytes
                n = -(-want.shape[1] // depth) * (3 if gray else 1)
                if not np.array_equal(want[:, :n], got[:, :n]) or got[:, n:].any():
                    return read, False
            elif not np.array_equal(want, got):
                return read, False
        elif not ((want is None and got is None) or (isinstance(want, str)
                                                     and isinstance(got, str))):
            return read, False
    return read, True


def _webp_module():
    import importlib

    return importlib.import_module("tests.test_torch_port_imageio_webp")


def _encoded(w, rng):
    """A random file of the encoders here."""
    import cv2
    h, wd = int(rng.integers(1, 90)), int(rng.integers(1, 90))
    im = w.window(h, wd, y=int(rng.integers(0, 500)), x=int(rng.integers(0, 800)),
                  k=int(rng.integers(0, 4)))
    alpha = rng.integers(0, 256, (h, wd), np.uint8)
    if rng.random() < 0.3:
        alpha = (alpha > 128).astype(np.uint8) * 255
    bgra = np.dstack([im, alpha])
    kind = int(rng.integers(0, 6))
    if kind == 0:
        return w.pil_webp(im, quality=int(rng.integers(0, 101)), method=int(rng.integers(0, 7)))
    if kind == 1:
        return w.pil_webp(bgra, lossless=True, method=int(rng.integers(0, 7)),
                          quality=int(rng.integers(0, 101)), exact=bool(rng.random() < 0.5))
    if kind == 2:
        return w.pil_webp(bgra, quality=int(rng.integers(0, 101)),
                          alpha_quality=int(rng.integers(0, 101)), method=int(rng.integers(0, 7)))
    if kind == 3:
        n = int(rng.choice([2, 3, 4, 11, 16, 17, 256]))
        pal = rng.integers(0, 256, (n, 3), np.uint8)
        return w.pil_webp(pal[rng.integers(0, n, (h, wd))], lossless=True)
    if kind == 4:
        n = int(rng.choice([300, 1000]))
        pal = rng.integers(0, 256, (n, 3), np.uint8)
        return w.pil_webp(pal[rng.integers(0, n, (h, wd))], lossless=True, method=6)
    return cv2.imencode(".webp", im, [cv2.IMWRITE_WEBP_QUALITY, int(rng.integers(1, 102))])[
        1].tobytes()


def _damaged(data, rng):
    d = bytearray(data)
    if rng.random() < 0.4:
        return bytes(d[:int(rng.integers(12, len(d)))])
    for _ in range(int(rng.integers(1, 4))):
        i = int(rng.integers(12, len(d)))
        d[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(d)


def _vp8_written(w, rng):
    ints = lambda lo, hi, n: tuple(int(x) for x in rng.integers(lo, hi, n))  # noqa: E731
    kw = dict(simple=int(rng.integers(0, 2)), level=int(rng.integers(0, 64)),
              sharpness=int(rng.integers(0, 8)), parts_log2=int(rng.integers(0, 4)),
              q=int(rng.integers(0, 128)), dq=ints(-15, 16, 5),
              i4x4_share=float(rng.choice([0, 0.3, 0.8])),
              amplitude=int(rng.choice([3, 24, 200, 2000])))
    if rng.random() < 0.5:
        kw["skip_prob"] = int(rng.integers(1, 256))
    if rng.random() < 0.5:
        kw["segments"] = dict(update_map=int(rng.integers(0, 2)), absolute=int(rng.integers(0, 2)),
                              quant=ints(-127, 128, 4), strength=ints(-63, 64, 4),
                              probs=ints(0, 256, 3))
    if rng.random() < 0.5:
        kw["lf_delta"] = dict(ref=ints(-63, 64, 4), mode=ints(-63, 64, 4))
    frame = w.vp8_frame(int(rng.integers(1, 70)), int(rng.integers(1, 70)),
                        int(rng.integers(0, 1 << 30)), **kw)
    return w.riff([w.chunk(b"VP8 ", frame)])


def _animation(w, rng):
    cw, ch = int(rng.integers(2, 60)), int(rng.integers(2, 60))
    chunks = [w.vp8x(int(rng.choice([0x02, 0x12, 0x1a, 0x22])), cw, ch)]
    if rng.random() < 0.9:
        chunks.append(w.anim(tuple(int(x) for x in rng.integers(0, 256, 4)),
                             int(rng.integers(0, 3))))
    for _ in range(int(rng.integers(1, 4))):
        fw, fh = int(rng.integers(1, cw + 1)), int(rng.integers(1, ch + 1))
        x = int(rng.integers(0, cw - fw + 1)) & ~1
        y = int(rng.integers(0, ch - fh + 1)) & ~1
        if rng.random() < 0.1:
            x += 2 * int(rng.integers(1, 5))  # past the canvas
        bgra = rng.integers(0, 256, (fh, fw, 4), np.uint8)
        kind = int(rng.integers(0, 3))
        data = (w.pil_webp(bgra, lossless=True) if kind == 0 else
                w.pil_webp(bgra[..., :3].copy(), quality=int(rng.integers(0, 100))) if kind == 1
                else w.pil_webp(bgra, quality=int(rng.integers(0, 100))))
        payload = b"".join(w.chunk(t, b) for t, b in w.chunks_of(data)
                           if t in (b"ALPH", b"VP8 ", b"VP8L"))
        if rng.random() < 0.1:
            payload += w.chunk(b"ABCD", b"xy")
        chunks.append(w.anmf(x, y, fw, fh, payload, int(rng.integers(0, 200)),
                             int(rng.integers(0, 4))))
    if rng.random() < 0.2:
        chunks.append(w.chunk(b"EXIF", w.exif_orientation(int(rng.integers(1, 9)))))
    if rng.random() < 0.1:
        rest = chunks[1:]
        rng.shuffle(rest)
        chunks = chunks[:1] + rest
    data = w.riff(chunks)
    r = rng.random()
    return _damaged(data, rng) if r < 0.5 else data


def _container(w, rng):
    import struct

    h, wd = int(rng.integers(1, 40)), int(rng.integers(1, 60))
    im = w.window(h, wd)
    bgra = np.dstack([im, rng.integers(0, 256, (h, wd), np.uint8)])
    kind = int(rng.integers(0, 3))
    src = (w.pil_webp(bgra, lossless=True) if kind == 0 else
           w.pil_webp(bgra, quality=int(rng.integers(0, 100))) if kind == 1 else
           w.cv2_webp(im, int(rng.integers(1, 101))))
    parts = [(t, b) for t, b in w.chunks_of(src) if t != b"VP8X"]
    for _ in range(int(rng.integers(0, 4))):
        t = [b"EXIF", b"ICCP", b"XMP ", b"ABCD", b"ALPH", b"VP8X", b"ANIM"][int(rng.integers(0, 7))]
        body = (w.exif_orientation(int(rng.integers(1, 9))) if t == b"EXIF" else
                bytes(rng.integers(0, 256, int(rng.integers(0, 9)), np.uint8)))
        parts.append((t, body))
    order = rng.permutation(len(parts)) if rng.random() < 0.3 else range(len(parts))
    chunks = [w.chunk(*parts[i]) for i in order]
    flags = (int(rng.integers(0, 256)) if rng.random() < 0.2 else
             int(rng.choice([0, 0x08, 0x10, 0x18, 0x28, 0x0c])))
    if rng.random() < 0.8:
        cw = wd if rng.random() < 0.9 else wd + 1
        chunks = [w.vp8x(flags & ~0x02 if rng.random() < 0.9 else flags, cw, h)] + chunks
    d = bytearray(w.riff(chunks))
    r = rng.random()
    if r < 0.15:
        d[4:8] = struct.pack("<I", max(0, len(d) - 8 + int(rng.integers(-12, 12))))
    elif r < 0.3:
        d += bytes(int(rng.integers(1, 9)))
    elif r < 0.4:
        d = d[:int(rng.integers(12, len(d)))]
    return bytes(d)


def _netpbm(rng):
    """(file, PAM depth or None)."""
    def sep():
        return [b" ", b"\n", b"\t", b"\r\n", b"  ", b" #c\n", b"\n# x y\n"][int(rng.integers(0, 7))]

    magic = int(rng.integers(1, 8))
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 9))
    maxval = int(rng.choice([1, 2, 7, 100, 255, 256, 1000, 65535]))
    depth = None
    if magic == 7:
        depth = int(rng.integers(1, 5))
        tupltypes = [None, b"GRAYSCALE", b"RGB", b"BLACKANDWHITE", b"GRAYSCALE_ALPHA", b"RGB_ALPHA"]
        tt = tupltypes[int(rng.integers(0, 6))]
        lines = [b"WIDTH %d\n" % w, b"HEIGHT %d\n" % h, b"DEPTH %d\n" % depth,
                 b"MAXVAL %d\n" % maxval] + ([b"TUPLTYPE " + tt + b"\n"] if tt else []) + (
                     [b"# comment\n"] if rng.random() < 0.3 else [])
        head = b"P7\n" + b"".join(lines[i] for i in rng.permutation(len(lines))) + b"ENDHDR\n"
        body = rng.integers(0, 256, w * h * depth * (2 if maxval > 255 else 1),
                            np.uint8).tobytes()
        if maxval == 1:
            depth = None
    else:
        ch = 3 if magic in (3, 6) else 1
        head = b"P%d" % magic + sep() + b"%d" % w + sep() + b"%d" % h + sep()
        if magic not in (1, 4):
            head += b"%d" % maxval + [b" ", b"\n", b"\t"][int(rng.integers(0, 3))]
        if magic in (1, 2, 3):
            top = 2 if magic == 1 else min(maxval + 3, 70000)
            body = b"".join(b"%d" % v + sep() for v in rng.integers(0, top, w * h * ch))
        elif magic == 4:
            body = rng.integers(0, 256, (w + 7) // 8 * h, np.uint8).tobytes()
        else:
            body = rng.integers(0, 256, w * h * ch * (2 if maxval > 255 else 1),
                                np.uint8).tobytes()
    d = bytearray(head + body)
    r = rng.random()
    if r < 0.2:
        d = d[:int(rng.integers(3, len(d) + 1))]
    elif r < 0.35:
        for _ in range(int(rng.integers(1, 3))):
            d[int(rng.integers(3, len(d)))] = int(rng.integers(0, 256))
    return bytes(d), depth


def _codings_module():
    import importlib

    return importlib.import_module("tests.test_torch_port_imageio_tiff_codings")


def _flip(data, rng, lo, hi, n):
    d = bytearray(data)
    for _ in range(n):
        i = int(rng.integers(lo, max(lo + 1, hi)))
        d[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(d)


def _scene(rng, h, w):
    from tests.test_torch_port_imageio import scene

    return scene(h, w, seed=int(rng.integers(0, 1 << 30)))


def _tiff_jpeg(rng):
    import cv2

    c = _codings_module()
    h, w = int(rng.integers(1, 60)), int(rng.integers(1, 70))
    im = _scene(rng, h, w)
    if rng.random() < 0.25:
        src = im if rng.random() < 0.7 else im[..., 0]
        ok, enc = cv2.imencode(".tif", src, [cv2.IMWRITE_TIFF_COMPRESSION, 7])
        data = enc.tobytes() if ok else c.jpeg_tiff(im[..., ::-1], 16)
    else:
        kw = dict(subsampling=int(rng.integers(0, 3)), quality=int(rng.integers(5, 100)))
        if rng.random() < 0.2:
            kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
        else:
            kw["rows_per_strip"] = 16 * int(rng.integers(1, 4)) if rng.random() < 0.7 else None
            if kw["rows_per_strip"] and rng.random() < 0.2:
                kw["strip_height"] = kw["rows_per_strip"]
        kw["ycbcr_tag"] = rng.random() > 0.2
        kw["tables"] = rng.random() > 0.15
        data = c.jpeg_tiff(im[..., ::-1] if rng.random() < 0.8 else im[..., 1], **kw)
    r = rng.random()
    if r < 0.33:
        return _flip(data, rng, 8, len(data), int(rng.integers(1, 4)))
    if r < 0.53:
        return data[:int(rng.integers(8, len(data)))]
    return data


def _ccitt(rng):
    import struct

    c = _codings_module()
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 200))
    rows = (c.bilevel(h, w, int(rng.integers(0, 1 << 30))) if rng.random() < 0.7 else
            (rng.random((h, w)) < rng.random()).astype(np.uint8))
    comp = int(rng.choice([2, 3, 4, 32771]))
    two_d = comp == 3 and rng.random() < 0.5
    data = c.fax_tiff(rows, comp, rows_per_strip=int(rng.integers(1, h + 1))
                      if rng.random() < 0.5 else None, photometric=int(rng.integers(0, 2)),
                      fillorder=int(rng.choice([1, 2])), two_d=two_d,
                      fill_bits=comp == 3 and rng.random() < 0.5, lead=int(rng.integers(0, 3)))
    ifd = struct.unpack("<I", data[4:8])[0]
    r = rng.random()
    if r < 0.5:
        return _flip(data, rng, 8, ifd, int(rng.integers(1, 4)))
    if r < 0.8:
        d = bytearray(data)
        k = int(rng.integers(1, max(2, ifd - 8)))
        for i in range(ifd - k, ifd):
            d[i] = 0 if rng.random() < 0.5 else int(rng.integers(0, 256))
        return bytes(d)
    return data


def _ycbcr_cmyk(rng):
    c = _codings_module()
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    if rng.random() < 0.25:
        n = 5 if rng.random() < 0.2 else 4
        kw = dict(planar=int(rng.integers(1, 3)), compression=int(rng.choice([1, 5])))
        if rng.random() < 0.3:
            kw["tile"] = (16, 16)
        if rng.random() < 0.1:
            kw["inkset"] = int(rng.integers(1, 3))
        if n == 5 and rng.random() < 0.5:
            kw["extrasamples"] = [0]
        return c.cmyk_tiff(rng.integers(0, 256, (h, w, n)), **kw)
    hs, vs = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 4), (2, 4),
              (3, 1)][int(rng.integers(0, 10))]
    kw = {}
    r = rng.random()
    if r < 0.3:
        kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
    elif r < 0.7:
        kw["rows_per_strip"] = int(rng.integers(1, h + 1))
    if rng.random() < 0.3:
        kw["compression"] = 5
    if rng.random() < 0.3:
        kw["coefficients"] = [int(x) for x in rng.integers(1, 1000, 6)]
    if rng.random() < 0.3:
        kw["refbw"] = [int(x) for x in rng.integers(0, 300, 12)]
    if rng.random() < 0.1:
        kw["planar"] = 2
    return c.ycbcr_tiff(w, h, hs, vs, seed=int(rng.integers(0, 1 << 30)), **kw)


def _sunras(rng):
    import struct

    w, h = int(rng.integers(1, 20)), int(rng.integers(1, 20))
    depth = int(rng.choice([1, 8, 24, 32, 4, 16]))
    typ = int(rng.choice([0, 1, 1, 1, 2, 3]))
    maptype = int(rng.choice([0, 0, 1, 2]))
    cmap = rng.integers(0, 256, int(rng.integers(0, 800)), np.uint8).tobytes() if maptype else b""
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    body = rng.integers(0, 256, pitch * h, np.uint8).tobytes()
    data = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), typ, maptype,
                       len(cmap)) + cmap + body
    r = rng.random()
    if r < 0.17:
        return data[:int(rng.integers(0, len(data)))]
    if r < 0.33:
        return _flip(data, rng, 4, 32, 1)
    return data


def _pfm(rng):
    h, w = int(rng.integers(1, 6)), int(rng.integers(1, 6))
    nch = int(rng.choice([1, 3]))
    scale = float(rng.choice([-1.0, 1.0, -2.5, 0.7, -1 / 255, 0.0, np.nan]))
    v = (rng.random((h, w, nch)) * rng.choice([1, 300, 3e9]) - rng.random() * 10)
    v = v.astype(np.float32)
    v.ravel()[int(rng.integers(0, v.size))] = rng.choice([np.nan, np.inf, -np.inf, 0.5, 2.5])
    data = (b"PF" if nch == 3 else b"Pf") + b"\n%d %d\n%r\n" % (w, h, scale) + v.astype(
        "<f4" if scale < 0 else ">f4").tobytes()
    if rng.random() < 0.2:
        return data[:int(rng.integers(0, len(data)))]
    return data


def _hdr(rng):
    import cv2

    f = (rng.random((int(rng.integers(1, 12)), int(rng.integers(1, 40)), 3))
         * rng.choice([1, 2, 100, 1e-3])).astype(np.float32)
    data = cv2.imencode(".hdr", f)[1].tobytes()
    r = rng.random()
    if r < 0.25:
        return data[:int(rng.integers(0, len(data)))]
    if r < 0.6:
        return _flip(data, rng, 0, len(data), int(rng.integers(1, 4)))
    if r < 0.7:
        return data.replace(b"#?RADIANCE", b"#?RGBE")
    return data


def _module(name):
    import importlib

    return importlib.import_module(f"tests.{name}")


def _damage(data, rng, lo=0):
    """Cut at a random byte (40%) or 1-3 bytes replaced or bit-flipped."""
    if rng.random() < 0.4:
        return data[:int(rng.integers(1, len(data)))]
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        at = int(rng.integers(lo, len(d)))
        d[at] = int(rng.integers(256)) if rng.random() < 0.5 else d[at] ^ 1 << int(
            rng.integers(8))
    return bytes(d)


def _jp2(rng):
    import tempfile as tf

    import cv2

    j = _module("test_torch_port_imageio_jp2")
    h, w = int(rng.integers(2, 70)), int(rng.integers(2, 90))
    im = _scene(rng, h, w)
    kind = rng.random()
    if kind < 0.2:
        with tf.TemporaryDirectory() as d:
            path = os.path.join(d, "w.jp2")
            cv2.imwrite(path, im if min(h, w) >= 32 else cv2.resize(im, (w + 32, h + 32)),
                        [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, int(rng.integers(1, 1001))])
            with open(path, "rb") as f:
                data = f.read()
    elif kind < 0.5:
        kw = {}
        if rng.random() < 0.5:
            kw["irreversible"] = True
        if rng.random() < 0.3:
            kw["progression"] = ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"][int(rng.integers(5))]
        if rng.random() < 0.3:
            kw["quality_layers"] = sorted([float(x) for x in rng.integers(2, 60, int(
                rng.integers(1, 4)))], reverse=True)
        if rng.random() < 0.3 and not kw.get("irreversible"):
            kw["tile_size"] = (int(rng.integers(8, 64)), int(rng.integers(8, 64)))
        if rng.random() < 0.3:
            kw["mct"] = 1
        if rng.random() < 0.3:
            kw["no_jp2"] = True
        src = im if rng.random() < 0.8 else im[..., 0]
        try:
            data = j.pil_jp2(src, **kw)
        except (OSError, ValueError):
            data = j.pil_jp2(src, num_resolutions=1)
    else:
        planes = j.planes_of(im)[:int(rng.choice([1, 3, 3]))]
        if rng.random() < 0.1:
            planes = planes + [planes[0] // 2]
        numres = int(rng.integers(1, min(7, int(np.log2(min(h, w))) + 2)))
        kw = dict(mode=int(rng.integers(0, 64)) if rng.random() < 0.6 else 0,
                  irreversible=bool(rng.random() < 0.4), csty=int(rng.choice([0, 2, 4, 6])),
                  prog=int(rng.integers(0, 5)), numres=numres,
                  mct=int(len(planes) >= 3 and rng.random() < 0.5))
        if rng.random() < 0.5:
            kw["rates"] = tuple(sorted([float(x) for x in rng.integers(2, 50, int(
                rng.integers(1, 4)))], reverse=True))
        if rng.random() < 0.3:
            cw, ch = int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7))
            kw["cblk"] = (cw, ch) if cw * ch <= 4096 else (64, 64)
        if rng.random() < 0.2:
            kw["roi"] = (0, int(rng.integers(1, 12)))
        if rng.random() < 0.2 and not kw["irreversible"]:
            kw["tiles"] = (int(rng.integers(8, 64)), int(rng.integers(8, 64)), 0, 0)
            kw["numres"] = 1
        if rng.random() < 0.2:
            kw["tile_parts"] = str(rng.choice(list("RLC")))
        prec = 8
        if rng.random() < 0.15:
            prec = int(rng.choice([9, 10, 12, 16, 5]))
            planes = [(p.astype(np.int64) << max(prec - 8, 0)) >> max(8 - prec, 0) for p in planes]
        try:
            data = j.opj_encode(planes, prec=prec, **kw)
        except AssertionError:
            data = j.opj_encode(planes, numres=1)
        if rng.random() < 0.3:  # in a JP2 file of random boxes
            box = {}
            r = rng.random()
            if r < 0.3 and len(planes) == 1:
                n = int(rng.integers(1, 300))
                cols = int(rng.integers(1, 4))
                box = dict(pclr=(rng.integers(0, 256, (n, cols)).tolist(), [8] * cols),
                           cmap=[(0, 1, i) for i in range(cols)])
            elif r < 0.6:
                box = dict(colr=int(rng.choice([16, 17, 18, 12, 24, 99])))
            elif len(planes) >= 3:
                box = dict(cdef=[(i, 0, int(c)) for i, c in enumerate(rng.permutation(3) + 1)])
            data = j.jp2_file(data, h, w, len(planes), **box)
    return _damage(data, rng) if rng.random() < 0.85 else data


def _in_data(data, rng):
    """1-3 bytes replaced in a little-endian TIFF's data, the bytes between
    its header and its directory (``tiff_counts`` and ``tiff_directory``
    damage the directory)."""
    import struct

    ifd = struct.unpack("<I", data[4:8])[0]
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        d[int(rng.integers(8, max(9, ifd)))] = int(rng.integers(256))
    return bytes(d)


def _tiff_lzw_old(rng):
    t = _module("test_torch_port_imageio_tiff")
    h, w = int(rng.integers(1, 50)), int(rng.integers(1, 60))
    im = _scene(rng, h, w)
    kw = {}
    if rng.random() < 0.3:
        im = im[..., int(rng.integers(3))]
    if rng.random() < 0.2:
        kw["bps"] = 16
        im = im.astype(np.int64) * 257
    if rng.random() < 0.3:
        kw["predictor"] = 2
    r = rng.random()
    if r < 0.3:
        kw["rows_per_strip"] = int(rng.integers(1, h + 1))
    elif r < 0.45:
        kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
    if rng.random() < 0.15 and im.ndim == 3:
        kw["planar"] = 2
    if rng.random() < 0.15:
        kw["fillorder"] = 2
    data = t.tiff_bytes(im, compression=5, old_lzw=True, ifd_first=False, **kw)
    r = rng.random()
    if r < 0.33:
        return _in_data(data, rng)
    if r < 0.53:
        return data[:int(rng.integers(8, len(data)))]
    return data


def _cielab(rng):
    import io

    from PIL import Image

    lab = _module("test_torch_port_imageio_tiff_lab_log")
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 50))
    if rng.random() < 0.2:
        buf = io.BytesIO()
        Image.fromarray(_scene(rng, h, w)).convert("LAB").save(buf, "TIFF")
        return buf.getvalue()  # its directory comes first: left whole
    else:
        bps = int(rng.choice([8, 16]))
        px = rng.integers(0, 1 << bps, (h, w, 3))
        kw = {}
        if rng.random() < 0.3:
            kw["white"] = [int(x) for x in rng.integers(0, 20000, 4)] if rng.random() < 0.2 else [
                int(rng.integers(2000, 4000)), 10000, int(rng.integers(2000, 4000)), 10000]
        else:
            r = rng.random()
            if r < 0.3:
                kw["rows_per_strip"] = int(rng.integers(1, h + 1))
            elif r < 0.5:
                kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.3:
                kw["compression"] = int(rng.choice([5, 8, 32773]))
            if rng.random() < 0.2:
                kw["orientation"] = int(rng.integers(1, 5))
        if "white" not in kw:
            kw["ifd_first"] = False
        data = lab._lab_tiff(px, bps, **kw)
    r = rng.random()
    if r < 0.1:
        return data[:int(rng.integers(8, len(data)))]
    if r < 0.2:
        return _in_data(data, rng)
    return data


def _sgilog(rng):
    import tempfile as tf

    import cv2

    lab = _module("test_torch_port_imageio_tiff_lab_log")
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 50))
    luv = rng.random() < 0.6
    coding = 34677 if luv and rng.random() < 0.4 else 34676
    if rng.random() < 0.4:
        shape = (h, w, 3) if luv else (h, w)
        f = (np.exp(rng.normal(float(rng.normal(0, 2)), float(rng.random() * 3), shape))
             * rng.choice([1, -1, 1, 1])).astype(np.float32)
        with tf.TemporaryDirectory() as d:
            path = os.path.join(d, "s.tif")
            cv2.imwrite(path, f, [cv2.IMWRITE_TIFF_COMPRESSION, coding])
            with open(path, "rb") as fh:
                data = fh.read()
    else:
        kw = {}
        r = rng.random()
        if r < 0.4:
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        elif r < 0.6:
            kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
        if rng.random() < 0.2:
            kw["orientation"] = int(rng.integers(1, 5))
        if coding == 34677:
            kw.pop("orientation", None)
            data = lab.sgilog24_tiff(rng.integers(0, 1 << 24, (h, w)).astype(np.uint32), **kw)
        else:
            data = lab.sgilog_tiff(lab._log_values(rng, (h, w), luv), luv, **kw)
    r = rng.random()
    if r < 0.33:
        return _in_data(data, rng)
    if r < 0.53:
        return data[:int(rng.integers(8, len(data)))]
    return data


def _any_tiff(rng):
    """A small TIFF of any writer here: ``tiff_bytes`` (grey 1, 8 and 16
    bits, RGB, RGBA, palettes of 1, 4 and 8 bits; uncompressed, LZW,
    old-style LZW, Deflate, PackBits; strips, tiles, planes, the predictor,
    fill order 2, both byte orders, BigTIFF, the directory first or last),
    YCbCr, CMYK, JPEG, CCITT, SGILog, SGILog24 and CIELab."""
    t = _module("test_torch_port_imageio_tiff")
    c = _codings_module()
    lab = _module("test_torch_port_imageio_tiff_lab_log")
    h, w = int(rng.integers(1, 50)), int(rng.integers(1, 60))
    r = rng.random()
    if r < 0.55:
        im, kw = _scene(rng, h, w), {}
        k = rng.random()
        if k < 0.2:
            im = im[..., 0]
        elif k < 0.3:
            im, kw["bps"] = (im[..., 0] > 128).astype(int), 1
        elif k < 0.4:
            im, kw["bps"] = im.astype(np.int64) * 257, 16
        elif k < 0.5:
            im, kw["bps"] = im[..., 0].astype(np.int64) * 251, 16
        elif k < 0.6:
            bps = int(rng.choice([1, 4, 8]))
            im = rng.integers(0, 1 << bps, (h, w))
            kw.update(bps=bps, photometric=3,
                      colormap=[int(x) for x in rng.integers(0, 65536, 3 << bps)])
        elif k < 0.7:
            im, kw["extrasamples"] = np.dstack([im, im[..., :1]]), [int(rng.integers(0, 3))]
        kw["compression"] = int(rng.choice([1, 1, 1, 5, 8, 32773, 32946]))
        kw["old_lzw"] = kw["compression"] == 5 and rng.random() < 0.1
        k = rng.random()
        if k < 0.5:
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        elif k < 0.75:
            kw["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
        if (im.ndim == 3 and kw.get("bps", 8) >= 8 and kw.get("photometric") != 3
                and rng.random() < 0.2):
            kw["planar"] = 2
        if kw["compression"] in (5, 8, 32946) and kw.get("bps", 8) in (8, 16) and (
                rng.random() < 0.2):
            kw["predictor"] = 2
        kw.update(fillorder=2 if rng.random() < 0.1 else 1, big_endian=rng.random() < 0.15,
                  bigtiff=rng.random() < 0.1, ifd_first=rng.random() < 0.5)
        return t.tiff_bytes(im, **kw)
    if r < 0.65:
        hs, vs = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)][int(rng.integers(7))]
        kw = {}
        k = rng.random()
        if k < 0.3:
            kw["tile"] = (16, 16)
        elif k < 0.7:
            kw["rows_per_strip"] = int(rng.integers(1, h + 1))
        if rng.random() < 0.3:
            kw["compression"] = 5
        return c.ycbcr_tiff(w, h, hs, vs, seed=int(rng.integers(1 << 30)), **kw)
    if r < 0.72:
        kw = dict(planar=int(rng.integers(1, 3)), compression=int(rng.choice([1, 5])))
        if rng.random() < 0.3:
            kw["tile"] = (16, 16)
        return c.cmyk_tiff(rng.integers(0, 256, (h, w, 4)), **kw)
    if r < 0.8:
        kw = dict(subsampling=int(rng.integers(0, 3)))
        if rng.random() < 0.3:
            kw["tile"] = (16, 16)
        else:
            kw["rows_per_strip"] = 16 * int(rng.integers(1, 4))
        return c.jpeg_tiff(_scene(rng, h, w)[..., ::-1], **kw)
    if r < 0.88:
        comp = int(rng.choice([2, 3, 4, 32771]))
        return c.fax_tiff(c.bilevel(h, max(w, 8), int(rng.integers(1 << 30))), comp,
                          rows_per_strip=int(rng.integers(1, h + 1)) if rng.random() < 0.5
                          else None)
    kw = {}
    if rng.random() < 0.3:
        kw["tile"] = (16, 16)
    elif rng.random() < 0.5:
        kw["rows_per_strip"] = int(rng.integers(1, h + 1))
    if r < 0.91:
        return lab.sgilog24_tiff(rng.integers(0, 1 << 24, (h, w)).astype(np.uint32), **kw)
    if r < 0.94:
        luv = rng.random() < 0.5
        return lab.sgilog_tiff(lab._log_values(rng, (h, w), luv), luv, **kw)
    if rng.random() < 0.3:
        kw["compression"] = int(rng.choice([5, 8]))
    bps = int(rng.choice([8, 16]))
    return lab._lab_tiff(rng.integers(0, 1 << bps, (h, w, 3)), bps, **kw)


def _tiff_counts(rng):
    """A TIFF of any writer with its strip or tile byte counts damaged: the
    tag removed, every count 0, one count 0, short, long, past the end of
    the file, 1 or over 1 MiB, the first, second or last off by up to 100,
    the counts equal to the offsets, or all one random value."""
    import struct

    cnt = _module("test_torch_port_imageio_tiff_counts")
    data = _any_tiff(rng)
    if rng.random() < 0.12:
        return cnt.patch_counts(data, drop=True)
    size = len(data)
    how = int(rng.integers(12))

    def change(offsets, counts):
        c, n = list(counts), len(counts)
        k = int(rng.integers(n))
        if how == 0:
            c = [0] * n
        elif how == 1:
            c[k] = 0
        elif how == 2:
            c[k] = max(0, c[k] - int(rng.integers(1, 200)))
        elif how == 3:
            c[k] += int(rng.integers(1, 200))
        elif how in (4, 5, 6):
            j = (0, min(1, n - 1), n - 1)[how - 4]
            c[j] = max(0, c[j] + int(rng.integers(-100, 101)))
        elif how == 7:
            c = list(offsets)
        elif how == 8:
            c[k] = size - offsets[k] + int(rng.integers(1, 50))
        elif how == 9:
            c = [int(rng.integers(1, 3 * max(c) + 2))] * n
        elif how == 10:
            c[k] = 1
        else:
            c[k] = int(rng.integers(1 << 20, 1 << 31))
        return c
    try:
        return cnt.patch_counts(data, change)
    except struct.error:  # a count the entry's type cannot hold: left whole
        return data


def _tiff_directory(rng):
    """(file, tag): a TIFF of any writer with one field of its directory
    damaged (``directory_damage``: an entry's type, count, value or offset,
    or the entry duplicated, moved or removed), and the damaged entry's tag."""
    cnt = _module("test_torch_port_imageio_tiff_counts")
    _, tag, data = cnt.directory_damage(_any_tiff(rng), rng)
    return data, tag


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--kinds", default=",".join(KINDS))
    args = ap.parse_args()
    w = _webp_module()
    tmp = tempfile.mkdtemp(prefix="fots_fuzz_")
    path = os.path.join(tmp, "x.bin")
    total_bad = 0
    for kind in args.kinds.split(","):
        rng = np.random.default_rng([args.seed, list(KINDS).index(kind)])
        n, none, bad = int(KINDS[kind] * args.scale), 0, 0
        by_tag = {}  # tiff_directory: mismatches by the damaged entry's tag
        for i in range(n):
            depth = tag = None
            if kind == "encoders":
                data = _encoded(w, rng)
            elif kind == "damaged":
                data = _damaged(_encoded(w, rng), rng)
            elif kind == "vp8_writer":
                data = _vp8_written(w, rng)
            elif kind == "animations":
                data = _animation(w, rng)
            elif kind == "containers":
                data = _container(w, rng)
            elif kind == "netpbm":
                data, depth = _netpbm(rng)
            elif kind == "tiff_directory":
                data, tag = _tiff_directory(rng)
            else:
                data = {"tiff_jpeg": _tiff_jpeg, "ccitt": _ccitt, "ycbcr_cmyk": _ycbcr_cmyk,
                        "sunras": _sunras, "pfm": _pfm, "hdr": _hdr, "jp2": _jp2,
                        "tiff_lzw_old": _tiff_lzw_old, "cielab": _cielab,
                        "sgilog": _sgilog, "tiff_counts": _tiff_counts}[kind](rng)
            read, ok = same(path, data, depth)
            none += not read
            if not ok:
                bad += 1
                if tag is not None:
                    by_tag[tag] = by_tag.get(tag, 0) + 1
                with open(os.path.join(tmp, f"bad_{kind}_{i}.bin"), "wb") as f:
                    f.write(data)
        total_bad += bad
        print(f"{kind}: {n} files, {none} read as nothing (or raising) by cv2, {bad} mismatches"
              + (f" (by tag: {dict(sorted(by_tag.items()))})" if by_tag else ""), flush=True)
    print(f"mismatching files (if any) under {tmp}")
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
