"""Image files on the host: :func:`imread`, the port's ``cv2.imread``, and
:func:`imwrite` / :func:`imencode_jpg`, its ``cv2.imwrite`` /
``cv2.imencode(".jpg")`` of JPEG.

The card's machine has no OpenCV and no image decoder, so the port reads
its own files: JPEG and PNG, decoded by ``fots_torch/csrc/image_decode.cpp``
(g++, built at first use by :mod:`fots_torch.kernels.build` and loaded with
ctypes, like the host NMS).  The JPEG decoder reproduces libjpeg-turbo's
default decompression as OpenCV asks for it (islow IDCT as its SIMD code
computes it, fancy upsampling, its colour tables, block smoothing), so the
pixels equal ``cv2.imread``'s byte for byte, colour and grayscale; the EXIF
orientation of a JPEG's first APP1 segment is applied as ``cv2.imread``
applies it.  PNG chunks are parsed here and IDAT is inflated with
:mod:`zlib`; the C++ side unfilters the scanlines and converts as libpng
does under ``cv2.imread``'s settings (alpha dropped, RGB -> BGR, palette
expanded, gray scaled to 8 bits and -> BGR, 16 bits cut to their high byte,
and libpng's fixed-point RGB -> gray, through its gamma tables where the
file's gamma is significant).

Read as ``cv2.imread`` reads them, every JPEG and PNG it reads:
- JPEG: baseline, extended sequential, progressive and lossless frames
  (SOF0-3, SOF9-10), Huffman or arithmetic coding, 8-bit samples (2-8 in a
  lossless frame), 1 (grey), 3 (YCbCr, or RGB: Adobe transform 0, ids R, G,
  B, or a lossless frame without JFIF) or 4 components (CMYK, YCCK),
  integral sampling ratios such as 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1
  (grayscale output of YCbCr needs Y's alone), restart intervals, any side,
  a sequential file without DHT (libjpeg's standard tables), any scan
  script, block-smoothed as libjpeg smooths a progressive image whose
  coefficients 1-9 are not all refined to their last bit (one cut short,
  or whose script stops early);
- a JPEG that ends early, as libjpeg reads it: the rest of the scan where
  the data ends is grey (level 128) for a sequential file;
- PNG of every colour type and bit depth (1, 2, 4, 8, 16), interlaced
  (Adam7) or not, with its eXIf orientation applied, gamma-tagged (``gAMA``,
  ``sRGB``) colour read as grey through libpng's gamma tables.

``None``, where ``cv2.imread`` gives None: a missing file, a directory, one
whose signature is no format ``cv2`` reads, a JPEG that libjpeg or OpenCV's
use of it fails on (cut before its first scan's data, corrupt headers, a
hierarchical frame, an unknown marker, 2 or 5-10 components, samples of
other than 8 bits, an MCU of more than 10 blocks, non-integral sampling of
a component the output needs, a lossless frame that is arithmetic-coded,
whose colour space the output would convert or whose restart interval is
not whole MCU rows), and a truncated or corrupt PNG (libpng's).

``ValueError`` naming the file and the format, for a file of one of the
other formats OpenCV 5.0's ``imread`` decodes, found by its signature as
``cv2`` finds it (by content, not by name): BMP, PBM/PGM/PPM and PAM, PFM,
Sun raster, TIFF, WebP, JPEG 2000 (codestream or JP2), AVIF, GIF and
Radiance HDR.  The port decodes none of them (a reader would otherwise drop
such a sample in silence where ``fots`` trains on it).  A PFM is refused in
both modes, though ``cv2`` 5.0 reads a 3-channel one only in colour and a
1-channel one only in grey.

The writer is ``fots_torch/csrc/image_encode.cpp`` (g++ as well): baseline
JPEG as libjpeg-turbo writes it under ``cv2.imwrite``'s defaults (quality
95, 4:2:0 for BGR, one component for grey, standard Huffman tables), byte
for byte.  ``fots`` writes only ``.jpg``, so only JPEG is written.  Host code (numpy and the standard
library only): the data readers call it on their spawned workers.
"""

from __future__ import annotations

import ctypes
import math
import struct
import zlib
from typing import Optional

import numpy as np

from fots_torch.kernels import build

JPEG_SIGNATURE = b"\xff\xd8\xff"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERR_LEN = 256
#: PNG colour type -> the bit depths the format allows
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_EXIF_HEADERS = (b"II*\x00", b"MM\x00*")
_PNG_MAX_SIDE = 1_000_000  # libpng's default user limit on width and height
_MAX_PIXELS = 1 << 30      # OpenCV's limit on an image read
_SPACE = b" \t\n\v\f\r"      # isspace(): what follows a Netpbm / PFM magic number


def _other_format(data: bytes) -> Optional[str]:
    """The name of the format of ``data`` when its signature is one of the
    other decoders of OpenCV 5.0.0's ``imread`` (which finds a file's format
    by its content, not its name), else None."""
    if data.startswith(b"BM"):
        return "BMP"
    if len(data) >= 3 and data[:1] == b"P" and data[2:3] in _SPACE:
        if data[1:2] in b"123456":
            return "PBM/PGM/PPM (Netpbm)"
        if data[1:2] == b"7":
            return "PAM (Netpbm)"
        if data[1:2] in b"Ff":
            return "PFM"
    if data.startswith(b"\x59\xa6\x6a\x95"):
        return "Sun raster"
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "TIFF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data.startswith(b"\x00\x00\x00\x0cjP  \r\n\x87\n") or data.startswith(b"\xff\x4f\xff\x51"):
        return "JPEG 2000"
    if data[4:8] == b"ftyp" and len(data) >= 12:
        size = int.from_bytes(data[:4], "big")
        box = data[8:min(max(size, 16), 4096)]
        brands = [box[i:i + 4] for i in range(0, len(box) - 3, 4) if i != 4]  # minor version at 4
        if b"avif" in brands or b"avis" in brands:
            return "AVIF"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data.startswith((b"#?RADIANCE", b"#?RGBE")):
        return "Radiance HDR"
    return None


class _Unreadable(Exception):
    """A file ``cv2.imread`` reads as nothing: :func:`imread` gives None."""


def _lib() -> ctypes.CDLL:
    lib = build.load("image_decode")
    if not getattr(lib, "_fots_typed", False):
        u8p, buf, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_int
        lib.fots_jpeg_header.restype = i32
        lib.fots_jpeg_header.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                         buf, i32]
        lib.fots_jpeg_decode.restype = i32
        lib.fots_jpeg_decode.argtypes = [u8p, ctypes.c_int64, i32, u8p, buf, i32]
        lib.fots_png_unfilter.restype = i32
        lib.fots_png_unfilter.argtypes = [u8p, ctypes.c_int64, i32, i32, i32, i32, i32, u8p,
                                          i32, i32, u8p, ctypes.POINTER(ctypes.c_uint16), i32,
                                          u8p, buf, i32]
        lib.fots_exif_orientation.restype = i32
        lib.fots_exif_orientation.argtypes = [u8p, ctypes.c_int64]
        lib._fots_typed = True
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _checked(code: int, err, path: str) -> None:
    """The decoder's return code: 1 is a file ``cv2`` reads as nothing, -1
    any other failure (such as memory)."""
    if code == 1:
        raise _Unreadable(err.value.decode(errors="replace"))
    if code != 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")


def _orient(im: np.ndarray, orientation: int) -> np.ndarray:
    """Apply an EXIF orientation as OpenCV's ``ExifTransform`` does."""
    if orientation in (5, 6, 7, 8):
        im = im.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        im = np.flip(im, axis)
    return np.ascontiguousarray(im)


def _decode_jpeg(data: bytes, grayscale: bool, path: str):
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    info = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _checked(lib.fots_jpeg_header(_u8(src), src.size, info, err, _ERR_LEN), err, path)
    h, w, _components, orientation = info
    out = np.empty((h, w) if grayscale else (h, w, 3), np.uint8)
    _checked(lib.fots_jpeg_decode(_u8(src), src.size, int(grayscale), _u8(out), err, _ERR_LEN),
             err, path)
    return out, orientation


# libpng's fixed-point gamma arithmetic (png.c, floating-point build), for
# png_set_rgb_to_gray of a file whose gAMA or sRGB chunk gives a gamma
_FP_1 = 100000
_SRGB_GAMMA = 45455  # PNG_GAMMA_sRGB_INVERSE
_MAX_GAMMA_8 = 11    # PNG_MAX_GAMMA_8: input bits kept when 16 bits go to 8


def _significant(g: int) -> bool:  # png_gamma_significant
    return g < _FP_1 - 5000 or g > _FP_1 + 5000


def _fixed(r: float) -> int:
    r = math.floor(r + 0.5)
    return int(r) if -2147483648.0 <= r <= 2147483647.0 else 0


def _table8(g: int) -> np.ndarray:  # png_build_8bit_table
    i = np.arange(256)
    if not _significant(g):
        return i.astype(np.uint8)
    out = np.floor(255 * np.power(i / 255.0, g * 0.00001) + 0.5)
    return np.where((i > 0) & (i < 255), out, i).astype(np.uint8)


def _table16(shift: int, g: int) -> np.ndarray:  # png_build_16bit_table: [low bits][high byte]
    num, top = 1 << (8 - shift), (1 << (16 - shift)) - 1
    ig = (np.arange(256)[None, :] << (8 - shift)) + np.arange(num)[:, None]
    if _significant(g):
        return np.floor(65535.0 * np.power(ig * (1.0 / top), g * 0.00001) + 0.5).astype(np.uint16)
    if shift:
        ig = (ig * 65535 + (1 << (15 - shift))) // top
    return ig.astype(np.uint16)


def _table16to8(shift: int, g: int) -> np.ndarray:  # png_build_16to8_table
    num, top = 1 << (8 - shift), (1 << (16 - shift)) - 1
    flat = np.full(num << 8, 65535, np.uint16)  # indexed by the top 16 - shift bits
    last = 0
    for i in range(255):
        out = i * 257
        v = out + 128
        bound = math.floor(65535 * math.pow(v / 65535.0, g * 0.00001) + 0.5) if v < 65535 else v
        bound = (bound * top + 32768) // 65535 + 1
        flat[last:max(last, bound)] = out
        last = max(last, bound)
    idx = (np.arange(256)[None, :] << (8 - shift)) + np.arange(num)[:, None]
    return flat[idx]


def _png_gamma(file_gamma: int, depth: int, sig_bit: int):
    """(8-bit tables, 16-bit tables, shift) of png_build_gamma_table for
    rgb_to_gray, as png_init_read_transformations sets them up under
    ``cv2.imread``'s settings (no screen gamma: it is the file gamma's
    reciprocal, so no overall correction), or (None, None, 0) when neither
    gamma is significant."""
    screen = _fixed(1e10 / file_gamma)  # png_reciprocal
    if not (_significant(file_gamma) or _significant(screen)):
        return None, None, 0
    to_1, from_1 = _fixed(1e10 / file_gamma), _fixed(1e10 / screen)
    if depth <= 8:
        overall = _fixed(1e15 / file_gamma / screen)  # png_reciprocal2
        return np.concatenate([_table8(to_1), _table8(from_1), _table8(overall)]), None, 0
    shift = 16 - sig_bit if 0 < sig_bit < 16 else 0
    shift = min(max(shift, 16 - _MAX_GAMMA_8), 8)  # png_set_strip_16 is on
    product = _fixed(file_gamma * 1e-5 * screen)  # png_product2
    tables = [_table16(shift, to_1), _table16(shift, from_1), _table16to8(shift, product)]
    return None, np.ascontiguousarray(np.stack(tables)), shift


def _png_chunks(data: bytes):
    """(type, body, critical) of each chunk up to IEND as libpng reads them:
    a critical chunk with a CRC error fails the file, an ancillary one is
    dropped; a file that ends before IEND fails."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise _Unreadable("the PNG ends before its IEND chunk (truncated)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise _Unreadable(f"the PNG ends inside its {ctype!r} chunk (truncated)")
        body = data[pos + 8:pos + 8 + length]
        critical = not ctype[0] & 0x20
        if zlib.crc32(ctype + body) == int.from_bytes(data[end - 4:end], "big"):
            yield ctype, body, critical
            if ctype == b"IEND":
                return
        elif critical:
            raise _Unreadable(f"CRC error in the PNG's {ctype!r} chunk")
        pos = end


def _decode_png(data: bytes, grayscale: bool, path: str):
    header, palette, idat, exif = None, None, [], None
    gama, srgb, sig_bit = None, False, 0
    idat_ended = False  # image data is the first run of IDAT chunks
    for ctype, body, critical in _png_chunks(data):
        if header is None and ctype != b"IHDR":
            raise _Unreadable("the PNG's first chunk is not IHDR")
        if idat and ctype != b"IDAT":
            idat_ended = True
        if ctype == b"IHDR":
            if header is not None or len(body) != 13:
                raise _Unreadable("bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            if not idat_ended:
                idat.append(body)
        elif ctype == b"gAMA" and len(body) == 4 and not idat and palette is None:
            g = struct.unpack(">I", body)[0]
            if gama is None and 16 <= g <= 625000000:
                gama = g
        elif ctype == b"sRGB" and len(body) == 1 and body[0] < 4 and not idat and palette is None:
            srgb = True
        elif ctype == b"sBIT" and not idat:
            sig_bit = max(body[:3]) if len(body) >= 3 else 0
        elif ctype == b"eXIf":
            if exif is None and body[:4] in _EXIF_HEADERS:  # libpng keeps the first valid one
                exif = np.frombuffer(body, np.uint8)
        elif critical and ctype != b"IEND":
            raise _Unreadable(f"unknown critical PNG chunk {ctype!r}")
    w, h, depth, color_type, compression, filtering, interlace = header
    if (depth not in _PNG_DEPTHS.get(color_type, ()) or compression or filtering
            or interlace > 1 or not 0 < w <= _PNG_MAX_SIDE or not 0 < h <= _PNG_MAX_SIDE
            or w * h > _MAX_PIXELS):
        raise _Unreadable(f"bad PNG header: {w}x{h}, {depth}-bit, colour type {color_type}, "
                          f"compression {compression}, filter {filtering}, interlace "
                          f"{interlace}")
    if color_type == 3 and (palette is None or palette.size % 3):
        raise _Unreadable("palette PNG without a valid PLTE chunk")
    gamma8 = gamma16 = None
    shift = 0
    file_gamma = _SRGB_GAMMA if srgb else gama
    if grayscale and color_type in (2, 3, 6) and file_gamma:
        gamma8, gamma16, shift = _png_gamma(file_gamma, depth, sig_bit)
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat))
    except zlib.error as e:
        raise _Unreadable(f"corrupt PNG image data ({e})") from None
    if not inflater.eof:
        raise _Unreadable("the PNG's image data ends inside its zlib stream")
    raw = np.frombuffer(raw, np.uint8)
    pal = palette if palette is not None else np.zeros(0, np.uint8)
    out = np.empty((h, w) if grayscale else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = _lib()
    g8 = None if gamma8 is None else _u8(gamma8)
    g16 = None if gamma16 is None else gamma16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
    _checked(lib.fots_png_unfilter(_u8(raw), raw.size, w, h, depth, color_type, interlace,
                                   _u8(pal), pal.size // 3, int(grayscale), g8, g16, shift,
                                   _u8(out), err, _ERR_LEN), err, path)
    orientation = 1 if exif is None else lib.fots_exif_orientation(_u8(exif), exif.size)
    return out, orientation


def imread(path: str, grayscale: bool = False) -> Optional[np.ndarray]:
    """``cv2.imread(path)`` (u8 [H, W, 3] BGR) or, with ``grayscale``,
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (u8 [H, W]) of a JPEG or PNG.
    None where ``cv2.imread`` gives None: a file that cannot be opened, whose
    signature is no format ``cv2`` reads, or that libjpeg or libpng fails on
    (a JPEG cut before its first scan's data, a corrupt or truncated PNG).
    ``ValueError``, naming the file and the format, for a file of another
    format ``cv2`` reads (BMP, Netpbm, PFM, Sun raster, TIFF, WebP, JPEG
    2000, AVIF, GIF, Radiance HDR)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        if data.startswith(JPEG_SIGNATURE):
            im, orientation = _decode_jpeg(data, grayscale, str(path))
        elif data.startswith(PNG_SIGNATURE):
            im, orientation = _decode_png(data, grayscale, str(path))
        else:
            other = _other_format(data)
            if other:
                raise ValueError(f"{path}: the {other} format (cv2.imread reads it; the port "
                                 "decodes JPEG and PNG only)")
            return None
    except _Unreadable:
        return None
    return _orient(im, orientation)


JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe")
JPEG_QUALITY = 95   # cv2.imwrite's default, the only one fots writes


def _encoder() -> ctypes.CDLL:
    lib = build.load("image_encode")
    if not getattr(lib, "_fots_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fots_jpeg_encode.restype = ctypes.c_int64
        lib.fots_jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, u8p, ctypes.c_int64]
        lib._fots_typed = True
    return lib


def imencode_jpg(im: np.ndarray) -> bytes:
    """``cv2.imencode(".jpg", im)[1].tobytes()`` of a u8 image: [H, W] grey
    or [H, W, 3] BGR."""
    im = np.asarray(im)
    if im.dtype != np.uint8:
        raise TypeError(f"imencode_jpg: a u8 image, got {im.dtype}")
    if not (im.ndim == 2 or (im.ndim == 3 and im.shape[2] == 3)):
        raise ValueError(f"imencode_jpg: [H, W] or [H, W, 3], got {im.shape}")
    im = np.ascontiguousarray(im)
    h, w = im.shape[:2]
    channels = 1 if im.ndim == 2 else 3
    cap = 1024 + 440 * (h // 8 + 2) * (w // 8 + 2) * 2
    out = np.empty(cap, np.uint8)
    n = _encoder().fots_jpeg_encode(_u8(im), h, w, channels, JPEG_QUALITY, _u8(out), cap)
    if n < 0:
        raise ValueError(f"imencode_jpg: cannot encode an image of shape {im.shape}"
                         if n == -1 else f"imencode_jpg: output of {-n} bytes over {cap}")
    return out[:n].tobytes()


def imwrite(path: str, im: np.ndarray) -> bool:
    """``cv2.imwrite(path, im)`` for a JPEG file name (``.jpg``, ``.jpeg``,
    ``.jpe``); any other extension raises ``ValueError``."""
    if not str(path).lower().endswith(JPEG_EXTENSIONS):
        raise ValueError(f"imwrite: {path}: the port writes JPEG files only "
                         f"({', '.join(JPEG_EXTENSIONS)})")
    data = imencode_jpg(im)
    with open(path, "wb") as f:
        f.write(data)
    return True
