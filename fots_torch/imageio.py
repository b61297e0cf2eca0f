"""Image files on the host: :func:`imread`, the port's ``cv2.imread``, and
:func:`imwrite` / :func:`imencode_jpg`, its ``cv2.imwrite`` /
``cv2.imencode(".jpg")`` of JPEG.

The card's machine has no OpenCV and no image decoder, so the port reads
its own files: baseline JPEG and 8-bit PNG, decoded by
``fots_torch/csrc/image_decode.cpp`` (g++, built at first use by
:mod:`fots_torch.kernels.build` and loaded with ctypes, like the host NMS).
The JPEG decoder reproduces libjpeg-turbo's default decompression as
OpenCV asks for it (islow IDCT, fancy upsampling, its YCbCr tables), so the
pixels equal ``cv2.imread``'s byte for byte, colour and grayscale; the EXIF
orientation of a JPEG's first APP1 segment is applied as ``cv2.imread``
applies it.  PNG chunks are parsed here and IDAT is inflated with :mod:`zlib`; the
C++ side unfilters the scanlines and converts as libpng does under
``cv2.imread``'s settings (alpha dropped, RGB -> BGR, palette expanded,
gray -> BGR, and libpng's fixed-point RGB -> gray).

Supported: JPEG SOF0/SOF1 (Huffman, 8-bit, 1 or 3 YCbCr components,
integral sampling ratios such as 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1,
restart intervals, any side); 8-bit PNG of colour type gray, gray + alpha,
RGB, RGBA or palette, not interlaced.  Any other encoding (progressive or
arithmetic JPEG, 12-bit samples, CMYK, YCCK or RGB-coded JPEG, PNG below or
above 8 bits, interlaced, or with an eXIf chunk, a gamma-tagged colour PNG
read as grayscale) and a truncated or corrupt file raise ``ValueError`` naming
the file; ``cv2`` reads some of those.

The writer is ``fots_torch/csrc/image_encode.cpp`` (g++ as well): baseline
JPEG as libjpeg-turbo writes it under ``cv2.imwrite``'s defaults (quality
95, 4:2:0 for BGR, one component for grey, standard Huffman tables), byte
for byte.  ``fots`` writes only ``.jpg``, so only JPEG is written.  Host code (numpy and the standard
library only): the data readers call it on their spawned workers.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional

import numpy as np

from fots_torch.kernels import build

JPEG_SIGNATURE = b"\xff\xd8\xff"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ERR_LEN = 256
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _lib() -> ctypes.CDLL:
    lib = build.load("image_decode")
    if not getattr(lib, "_fots_typed", False):
        u8p, buf = ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p
        lib.fots_jpeg_header.restype = ctypes.c_int
        lib.fots_jpeg_header.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                                         buf, ctypes.c_int]
        lib.fots_jpeg_decode.restype = ctypes.c_int
        lib.fots_jpeg_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, u8p, buf,
                                         ctypes.c_int]
        lib.fots_png_unfilter.restype = ctypes.c_int
        lib.fots_png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, u8p,
                                          buf, ctypes.c_int]
        lib._fots_typed = True
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


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
    if lib.fots_jpeg_header(_u8(src), src.size, info, err, _ERR_LEN) != 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    h, w, _components, orientation = info
    out = np.empty((h, w) if grayscale else (h, w, 3), np.uint8)
    if lib.fots_jpeg_decode(_u8(src), src.size, int(grayscale), _u8(out), err, _ERR_LEN) != 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out, orientation


def _png_chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: the PNG ends before its IEND chunk (truncated)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"{path}: the PNG ends inside its {ctype!r} chunk (truncated)")
        body = data[pos + 8:pos + 8 + length]
        critical = not ctype[0] & 0x20
        if critical and zlib.crc32(ctype + body) != int.from_bytes(data[end - 4:end], "big"):
            raise ValueError(f"{path}: CRC error in the PNG's {ctype!r} chunk")
        yield ctype, body, critical
        if ctype == b"IEND":
            return
        pos = end


def _decode_png(data: bytes, grayscale: bool, path: str):
    header, palette, idat, gamma_tagged = None, None, [], False
    for ctype, body, critical in _png_chunks(data, path):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path}: bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"gAMA":
            gamma_tagged = body != struct.pack(">I", 100000)
        elif ctype == b"sRGB":
            gamma_tagged = True
        elif ctype == b"eXIf":
            raise ValueError(f"{path}: PNG with an eXIf chunk (its orientation is not applied)")
        elif critical and ctype != b"IEND":
            raise ValueError(f"{path}: unknown critical PNG chunk {ctype!r}")
    if header is None:
        raise ValueError(f"{path}: the PNG has no IHDR chunk")
    w, h, depth, color_type, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG (only 8-bit)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG (only non-interlaced)")
    if color_type not in _PNG_CHANNELS or compression or filtering:
        raise ValueError(f"{path}: PNG colour type {color_type}, compression {compression}, "
                         f"filter method {filtering} not supported")
    if color_type == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    if grayscale and color_type in (2, 3, 6) and gamma_tagged:
        raise ValueError(f"{path}: a gamma-tagged colour PNG read as grayscale (libpng's "
                         "gamma-corrected conversion is not reproduced)")
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    raw = np.frombuffer(raw, np.uint8)
    pal = palette if palette is not None else np.zeros(0, np.uint8)
    out = np.empty((h, w) if grayscale else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if _lib().fots_png_unfilter(_u8(raw), raw.size, w, h, color_type, _u8(pal), pal.size // 3,
                                int(grayscale), _u8(out), err, _ERR_LEN) != 0:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out


def imread(path: str, grayscale: bool = False) -> Optional[np.ndarray]:
    """``cv2.imread(path)`` (u8 [H, W, 3] BGR) or, with ``grayscale``,
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (u8 [H, W]).  ``None`` for a
    file that cannot be opened or is neither JPEG nor PNG by its signature;
    ``ValueError`` for an encoding the decoder does not support or a
    corrupt file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(JPEG_SIGNATURE):
        im, orientation = _decode_jpeg(data, grayscale, str(path))
    elif data.startswith(PNG_SIGNATURE):
        im, orientation = _decode_png(data, grayscale, str(path)), 1
    else:
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
