"""Image files on the host: :func:`imread`, the port's ``cv2.imread``, and
:func:`imwrite` / :func:`imencode_jpg`, its ``cv2.imwrite`` /
``cv2.imencode(".jpg")`` of JPEG.

The card's machine has no OpenCV and no image decoder, so the port reads
its own files: JPEG and PNG, decoded by ``fots_torch/csrc/image_decode.cpp``
(g++, built at first use by :mod:`fots_torch.kernels.build` and loaded with
ctypes, like the host NMS).  The JPEG decoder reproduces libjpeg-turbo's
default decompression as OpenCV asks for it (islow IDCT, fancy upsampling,
its YCbCr tables), so the pixels equal ``cv2.imread``'s byte for byte,
colour and grayscale; the EXIF orientation of a JPEG's first APP1 segment is
applied as ``cv2.imread`` applies it.  PNG chunks are parsed here and IDAT
is inflated with :mod:`zlib`; the C++ side unfilters the scanlines and
converts as libpng does under ``cv2.imread``'s settings (alpha dropped, RGB
-> BGR, palette expanded, gray scaled to 8 bits and -> BGR, 16 bits cut to
their high byte, and libpng's fixed-point RGB -> gray).

Read as ``cv2.imread`` reads them:
- JPEG SOF0/SOF1/SOF2: baseline, extended sequential and progressive
  Huffman coding, 8-bit, 1 or 3 YCbCr components, integral sampling ratios
  such as 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 (grayscale output needs Y's
  alone), restart intervals, any side, a sequential file without DHT
  (libjpeg's standard tables), any scan script whose scans refine every DCT
  coefficient 1-9 to its last bit (``cv2``'s own progressive writer's,
  mozjpeg's, Photoshop's);
- a JPEG that ends early, as libjpeg reads it: the rest of the scan where
  the data ends is grey (level 128) for a sequential file;
- PNG of every colour type and bit depth (1, 2, 4, 8, 16), interlaced
  (Adam7) or not, with its eXIf orientation applied.

``None``, where ``cv2.imread`` gives None: a missing file, one that is
neither JPEG nor PNG by its signature, a JPEG that libjpeg or OpenCV's use
of it fails on (cut before its first scan's data, corrupt headers, a
hierarchical frame, an unknown marker, 2 or 5-10 components, samples of
other than 8 bits, an MCU of more than 10 blocks, non-integral sampling of
a component the output needs, a lossless frame that is arithmetic-coded or
whose colour space the output would convert), and a truncated or corrupt
PNG (libpng's).

``ValueError`` naming the file and the reason, for what ``cv2`` reads and
this decoder does not reproduce: a progressive JPEG that libjpeg would
block-smooth (one cut short, or whose scans stop before refining some
coefficient 1-9 to its last bit), arithmetic coding, lossless frames, 4
components (CMYK, YCCK), RGB-coded JPEG, and a gamma-tagged colour PNG
read as grayscale (libpng's gamma tables).

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
#: PNG colour type -> the bit depths the format allows
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_EXIF_HEADERS = (b"II*\x00", b"MM\x00*")
_PNG_MAX_SIDE = 1_000_000  # libpng's default user limit on width and height
_MAX_PIXELS = 1 << 30      # OpenCV's limit on an image read


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
                                          i32, i32, u8p, buf, i32]
        lib.fots_exif_orientation.restype = i32
        lib.fots_exif_orientation.argtypes = [u8p, ctypes.c_int64]
        lib._fots_typed = True
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _checked(code: int, err, path: str) -> None:
    """The decoder's return code: 1 is a file ``cv2`` reads as nothing, -1
    one it reads and the decoder does not reproduce."""
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
    header, palette, idat, gamma_tagged, exif = None, None, [], False, None
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
        elif ctype == b"gAMA":
            gamma_tagged = body != struct.pack(">I", 100000)
        elif ctype == b"sRGB":
            gamma_tagged = True
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
    if grayscale and color_type in (2, 3, 6) and gamma_tagged:
        raise ValueError(f"{path}: a gamma-tagged colour PNG read as grayscale (libpng's "
                         "gamma-corrected conversion is not reproduced)")
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
    _checked(lib.fots_png_unfilter(_u8(raw), raw.size, w, h, depth, color_type, interlace,
                                   _u8(pal), pal.size // 3, int(grayscale), _u8(out), err,
                                   _ERR_LEN), err, path)
    orientation = 1 if exif is None else lib.fots_exif_orientation(_u8(exif), exif.size)
    return out, orientation


def imread(path: str, grayscale: bool = False) -> Optional[np.ndarray]:
    """``cv2.imread(path)`` (u8 [H, W, 3] BGR) or, with ``grayscale``,
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (u8 [H, W]).  None where
    ``cv2.imread`` gives None: a file that cannot be opened, is neither JPEG
    nor PNG by its signature, or that libjpeg or libpng fails on (a JPEG cut
    before its first scan's data, a corrupt or truncated PNG).
    ``ValueError``, naming the file and the reason, for a file ``cv2`` reads
    and the decoder does not reproduce."""
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
