"""Image files on the host: :func:`imread`, the port's ``cv2.imread``, and
:func:`imwrite` / :func:`imencode_jpg`, its ``cv2.imwrite`` /
``cv2.imencode(".jpg")`` of JPEG.

The card's machine has no OpenCV and no image decoder, so the port reads
its own files: JPEG and PNG, decoded by ``fots_torch/csrc/image_decode.cpp``,
and BMP, GIF, TIFF, WebP, Netpbm, Sun raster, PFM, Radiance HDR and JPEG
2000 (below)
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

BMP, GIF and TIFF, read as ``cv2.imread`` reads them by
``fots_torch/csrc/decode_bmp.cpp``, ``decode_gif.cpp`` and
``decode_tiff.cpp`` with the TIFF directory parsed here (see each file):
- BMP as OpenCV's own BmpDecoder: the 12-byte OS/2 header and the 40-byte
  one with its V4 / V5 forms, 1/4/8-bit palettes, 16-bit 5-5-5 and 5-6-5,
  24 and 32 bits (a V3+ header's bit fields applied), RLE8 and RLE4, rows
  bottom-up or top-down;
- GIF as OpenCV's own GifDecoder: the first frame on the logical screen
  filled with the background colour, its transparent index, local and
  global tables, interlaced rows, LZW at minimum code sizes 2-11;
- TIFF as libtiff 4.7's RGBA reader under OpenCV: the first directory of a
  classic or BigTIFF file in either byte order, uncompressed, PackBits, LZW
  and Deflate strips or tiles with the horizontal predictor, planar or
  not, grey (1, 8, 16 bits, MinIsBlack or MinIsWhite), palette (1, 4, 8
  bits; 8- or 16-bit colour maps), RGB and RGBA (8, 16 bits; alpha dropped,
  unassociated alpha premultiplied), FillOrder 2, orientations 1-4; JPEG
  (compression 7: each strip or tile an abbreviated stream after the
  JPEGTables tag, decoded by ``image_decode.cpp``, YCbCr to RGB there),
  CCITT RLE, RLE-word, Group 3 (1-D and 2-D) and Group 4
  (``csrc/decode_fax.cpp``, libtiff's tif_fax3.c, damaged data included),
  YCbCr (every YCbCrSubsampling with a put routine, through
  TIFFYCbCrToRGBInit's tables), 8-bit CMYK (InkSet 1), old-style LZW
  (LZWDecodeCompat; the file's first LZW strip picks the decoder for all),
  8- and 16-bit CIELab (through TIFFCIELabToRGBInit over display_sRGB and
  the WhitePoint tag, D50 by default), and SGILog (compression 34676: LogL
  grey and LogLuv colour, into libtiff's 8-bit samples) and SGILog24
  (34677, LogLuv: its uv index through uvcode.h's table).
  Strip and tile byte counts are read as libtiff's TIFFReadDirectory leaves
  them: a missing StripByteCounts is estimated for one strip (or one a
  plane; more strips are None), and so is one strip's count of 0 in any
  coding or, uncompressed, past the end of the file or short of the image,
  and the counts of more than two uncompressed contiguous strips or tiles
  whose first two differ (the counts equal to the offsets among them): a
  tile's size, ``imagelength / strips`` rows of a strip, or, compressed,
  the file's size less the directory's bytes, cut at the end of the file.
  An uncompressed strip shorter than asked for reads as zeros; an
  uncompressed tile whose data is not the tile's size makes the file None
  (a later plane's tile reads as zeros); a count past 1 MiB is cut to ten
  strips and 4 KiB; one uncompressed strip is never chopped.  A damaged
  directory field reads as libtiff reads it: each tag through its own
  reader (any integer type, values in range, one value or one a sample),
  failing the file or ignored as libtiff does; only the first entry of a
  tag counts; a colour map only after BitsPerSample; no Photometric is None.
A format is found by its signature, as ``cv2`` finds it (by content, not by
name): a BMP named ``.jpg`` is read as a BMP.

``None`` also where ``cv2.imread`` gives None for those: a BMP, GIF or TIFF
cut short or with a header its decoder rejects, a GIF frame whose LZW data
is damaged, a TIFF of a depth OpenCV refuses (2 and 4-bit grey, 2-bit
palette, samples of 32 or more bits, float), of a coding libtiff's build
lacks (old-style JPEG, PixarLog, LZMA, ZSTD, ...), a JPEG strip
JPEGPreDecode rejects (a size, component count or sampling the directory
does not give), CMYK of other than 8 bits, 4 samples and InkSet 1, YCbCr
without a put routine, ICCLab and ITULab, CIELab of other than 3 contiguous
samples or with a WhitePoint of y = 0, LogL or LogLuv without SGILog or at
another sample count, SGILog of another photometric, or an orientation of
5-8 (imread's own ExifTransform asserts).

WebP, read as ``cv2.imread`` reads it through libwebp 1.5 by
``fots_torch/csrc/decode_webp.cpp`` (see that file): lossy (VP8) and
lossless (VP8L) images, simple or in a VP8X file with ALPH / ICCP / EXIF /
XMP chunks, raw VP8 and VP8L streams (cv2 reads them too), an animation's
first frame on its canvas; colour is BGR with alpha dropped, grey
``cvtColor(BGR2GRAY)`` of it, and the orientation of the first EXIF chunk
of a VP8X file whose EXIF flag is set is applied, as cv2 applies it.  None
where libwebp or OpenCV's use of it fails (a file cut short, a damaged
frame or alpha plane, a file of fewer than 32 bytes).

PBM, PGM, PPM (P1-P6) and PAM (P7), read here as OpenCV 5.0's PxMDecoder
and PAMDecoder read them (quirks included: see the Netpbm section below);
None where they fail (a bad header, samples cut short, a stray character
among ASCII samples).

Sun raster (``csrc/decode_sunras.cpp``), PFM and Radiance HDR
(``csrc/decode_hdr.cpp`` for the run-length pixels) as OpenCV 5.0's own
decoders read them: see the section below.

JPEG 2000, read as ``cv2.imread`` reads it through OpenJPEG 2.5 by
``fots_torch/csrc/decode_jp2.cpp`` (see that file): the JP2 file and the raw
codestream, every progression order, code-block style, tiling, precinct and
layer layout, the 5/3 and 9/7 wavelets with RCT and ICT, ROI, PPM / PPT,
palettes and channel definitions, then OpenCV's shift of precisions above 8
and its conversions (sRGB, grey, sYCC); None where OpenJPEG (in its strict
mode) or OpenCV's use of it fails (a cut or damaged file, signed or
sub-sampled components, an image offset, precisions under 8, one or two
components of a codestream read in colour).

``ValueError`` naming the file and the format, for a file of the one other
format OpenCV 5.0's ``imread`` decodes, found by its signature: AVIF; and
naming the coding, for a JPEG 2000 file of HT (high-throughput) code-blocks
or of Part 2's multi-component transforms.  The port decodes none of them
(a reader would otherwise drop such a sample in silence where ``fots``
trains on it).

The writer is ``fots_torch/csrc/image_encode.cpp`` (g++ as well): baseline
JPEG as libjpeg-turbo writes it under ``cv2.imwrite``'s defaults (quality
95, 4:2:0 for BGR, one component for grey, standard Huffman tables), byte
for byte.  ``fots`` writes only ``.jpg``, so only JPEG is written.  Host code (numpy and the standard
library only): the data readers call it on their spawned workers.
"""

from __future__ import annotations

import ctypes
import math
import re
import struct
import zlib
from typing import Optional

import numpy as np

from fots_torch.kernels import build

JPEG_SIGNATURE = b"\xff\xd8\xff"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
BMP_SIGNATURE = b"BM"
GIF_SIGNATURE = b"GIF"
#: a JP2 file, a raw JPEG 2000 codestream
JP2_SIGNATURES = (b"\x00\x00\x00\x0cjP  \r\n\x87\n", b"\xff\x4f\xff\x51")
_ERR_LEN = 256
#: PNG colour type -> the bit depths the format allows
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_EXIF_HEADERS = (b"II*\x00", b"MM\x00*")
_PNG_MAX_SIDE = 1_000_000  # libpng's default user limit on width and height
_MAX_PIXELS = 1 << 30      # OpenCV's limit on an image read
_SPACE = b" \t\n\v\f\r"      # isspace(): what follows a Netpbm / PFM magic number


def _other_format(data: bytes) -> Optional[str]:
    """The name of the format of ``data`` when its signature is that of the
    one decoder of OpenCV 5.0.0's ``imread`` (which finds a file's format by
    its content, not its name) the port does not decode (AVIF), else None."""
    if data[4:8] == b"ftyp" and len(data) >= 12:
        size = int.from_bytes(data[:4], "big")
        box = data[8:min(max(size, 16), 4096)]
        brands = [box[i:i + 4] for i in range(0, len(box) - 3, 4) if i != 4]  # minor version at 4
        if b"avif" in brands or b"avis" in brands:
            return "AVIF"
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
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.fots_tiff_jpeg.restype = i32
        lib.fots_tiff_jpeg.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64, i32p, u8p,
                                       ctypes.c_int64, i32p, buf, i32]
        lib._fots_typed = True
    return lib


def _format_lib(name: str, prefix: str) -> ctypes.CDLL:
    """The library of one of the other formats: ``<prefix>_header`` (height
    and width) and ``<prefix>_decode`` (the pixels), typed as the JPEG pair."""
    lib = build.load(name)
    if not getattr(lib, "_fots_typed", False):
        u8p, buf, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_int
        header, decode = getattr(lib, f"{prefix}_header"), getattr(lib, f"{prefix}_decode")
        header.restype = decode.restype = i32
        header.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), buf, i32]
        decode.argtypes = [u8p, ctypes.c_int64, i32, u8p, buf, i32]
        lib._fots_typed = True
    return lib


def _decode_whole(name: str, prefix: str, data: bytes, grayscale: bool, path: str):
    """Decode a BMP, GIF, Sun raster or JPEG 2000 file with its library:
    (image, orientation 1).
    An image past OpenCV's size limits raises (imread raises for it)."""
    lib = _format_lib(name, prefix)
    src = np.frombuffer(data, np.uint8)
    info = (ctypes.c_int32 * 2)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _checked(getattr(lib, f"{prefix}_header")(_u8(src), src.size, info, err, _ERR_LEN), err, path)
    h, w = info
    out = np.empty((h, w) if grayscale else (h, w, 3), np.uint8)
    _checked(getattr(lib, f"{prefix}_decode")(_u8(src), src.size, int(grayscale), _u8(out), err,
                                               _ERR_LEN), err, path)
    return out, 1


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


# ---------------------------------------------------------------- TIFF
# The first directory of a classic or BigTIFF file, read as cv2.imread reads
# it: OpenCV's TiffDecoder over libtiff 4.7, whose 8-bit output comes from
# TIFFReadRGBAStrip / TIFFReadRGBATile (tif_getimage.c), one strip or tile
# at a time, then OpenCV's RGBA -> BGR or grey.

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i",
               10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
#: codings libtiff knows but OpenCV's build does not decode (old-style JPEG,
#: PixarLog, LZMA, ZSTD, ...), or decodes only at depths cv2.imread refuses
#: (ThunderScan 4-bit, NeXT 2-bit): None
_TIFF_UNREAD_CODINGS = {6, 32809, 32766, 34661, 34925, 50000, 50001, 50002, 34887, 32909}
_TIFF_FAX = (2, 3, 4, 32771)  # CCITT RLE, Group 3, Group 4, RLE-word
_TIFF_SGILOG = (34676, 34677)
_LOGL, _LOGLUV = 32844, 32845
#: CIE D50, libtiff's default WhitePoint (float x, y chromaticity)
_D50 = np.float32(96.4250) + np.float32(100.0) + np.float32(82.4680)
_WHITE_POINT = (float(np.float32(96.4250) / _D50), float(np.float32(100.0) / _D50))
#: YCbCrSubsampling values with a put routine in libtiff's RGBA reader
_YCBCR_SAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
#: TIFFDataWidth of each type (0 counts as a byte; a type without a width
#: fails EstimateStripByteCounts)
_TIFF_WIDTHS = {0: 1, 1: 1, 2: 1, 6: 1, 7: 1, 3: 2, 8: 2, 4: 4, 9: 4, 11: 4, 13: 4, 5: 8, 10: 8,
                12: 8, 16: 8, 17: 8, 18: 8}
#: the types TIFFReadDirEntryShort / Long / Long8 and their arrays read (not
#: IFD or IFD8), with their formats; a negative value or one too large for
#: the field fails the read
_TIFF_INTS = {1: "B", 6: "b", 3: "H", 8: "h", 4: "I", 9: "i", 16: "Q", 17: "q"}
#: how TIFFReadDirectory reads the tags the decoder uses as numbers: the
#: read ("persample": one 16-bit value, or one a sample that must all agree;
#: else one value of at most that many bits), whether a tag it cannot read
#: fails the directory (else the tag is ignored and its default kept), and
#: the range of values TIFFSetField takes (which fails or ignores the same)
_TIFF_NUMBERS = {256: (32, True, 0, 2**32), 257: (32, True, 0, 2**32), 278: (32, True, 1, 2**32),
                 322: (32, True, 0, 2**32), 323: (32, True, 0, 2**32), 277: (16, True, 1, 2**16),
                 284: (16, True, 1, 3), 259: ("persample", True, 0, 2**16),
                 258: ("persample", True, 0, 2**16), 280: ("persample", True, 0, 2**16),
                 281: ("persample", True, 0, 2**16), 339: ("persample", True, 1, 7),
                 262: (16, False, 0, 2**16), 266: (16, False, 1, 3), 274: (16, False, 1, 9),
                 317: (16, False, 0, 2**16), 332: (16, False, 0, 2**16),
                 292: (32, False, 0, 2**32)}
_BIT_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _tiff_lib() -> ctypes.CDLL:
    lib = build.load("decode_tiff")
    if not getattr(lib, "_fots_typed", False):
        u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
        for fn in (lib.fots_tiff_lzw, lib.fots_tiff_lzw_compat, lib.fots_tiff_packbits):
            fn.restype = ctypes.c_int
            fn.argtypes = [u8p, i64, u8p, i64]
        lib.fots_tiff_sgilog.restype = ctypes.c_int
        lib.fots_tiff_sgilog.argtypes = [u8p, i64, u8p, i64, i64, ctypes.c_int]
        lib.fots_tiff_cielab.restype = None
        lib.fots_tiff_cielab.argtypes = [ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_float,
                                         ctypes.c_float, u8p]
        lib._fots_typed = True
    return lib


def _fax_lib() -> ctypes.CDLL:
    lib = build.load("decode_fax")
    if not getattr(lib, "_fots_typed", False):
        u8p, i64, i32 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int
        lib.fots_tiff_fax.restype = i32
        lib.fots_tiff_fax.argtypes = [u8p, i64, i32, i32, i32, i64, i64, i32,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_uint32), u8p]
        lib._fots_typed = True
    return lib


def _tiff_jpeg(tables: np.ndarray, raw: bytes, params, occ: int, rowbytes: int):
    """One strip or tile of compression 7 through the JPEG decoder
    (``fots_tiff_jpeg``): (buffer, ok); the stream failing JPEGPreDecode's
    reading or checks is _Unreadable (the strip read that allocates the
    buffer fails, and cv2.imread with it)."""
    lib = _lib()
    buf = np.zeros(occ + rowbytes, np.uint8)  # room for a row of a stream narrower than it says
    src = np.frombuffer(raw, np.uint8)
    p = (ctypes.c_int32 * 8)(*params)
    info = (ctypes.c_int32 * 1)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    code = lib.fots_tiff_jpeg(_u8(tables), tables.size, _u8(src), src.size, p, _u8(buf), rowbytes,
                              info, err, _ERR_LEN)
    if code == 1:
        raise _Unreadable(f"a JPEG strip or tile libtiff's JPEGPreDecode fails on "
                          f"({err.value.decode(errors='replace')})")
    if code != 0:
        raise MemoryError(err.value.decode(errors="replace"))
    return buf[:occ], True


def _tiff_ints(data: bytes, e: str, layout: dict, entry, limit=None, bits=64):
    """The integers of a directory entry as TIFFReadDirEntry{Short,Long,
    Long8}Array reads them (the first ``limit`` of them), or None where the
    read fails: a type of another kind, values past the end of the file, a
    value negative or of more than ``bits`` bits.  Whether the values lie
    in the entry or at its offset follows from the whole count."""
    typ, cnt, value_at = entry[1:4]
    fmt = _TIFF_INTS.get(typ)
    if fmt is None:
        return None
    k = cnt if limit is None else min(cnt, limit)
    if k == 0:
        return ()
    width = struct.calcsize(e + fmt)
    if width * cnt > layout["inline"]:
        value_at = struct.unpack_from(e + layout["off_fmt"], data, value_at)[0]
    if value_at + width * k > len(data):
        return None
    values = struct.unpack_from(e + fmt * k, data, value_at)
    if min(values) < 0 or max(values) >> bits:
        return None
    return values


def _tiff_directory(data: bytes):
    """(tags, big-endian, layout) of the first directory as TIFFReadDirectory
    reads it: tag -> tuple of numbers.  Only the first entry of a tag counts.
    The tags of ``_TIFF_NUMBERS`` are read as libtiff reads them (failing the
    directory, _Unreadable, or left out); a colour map counts only after
    BitsPerSample and with 3 << BitsPerSample values, YCbCrSubsampling only
    with 2; ExtraSamples of more values than samples or of a value over 2
    (999 reads as 2) fails.  The strip and tile arrays are left unread:
    ``layout["strile"]`` holds their entries for :func:`_tiff_strile` to read
    once the number of strips is known; ``layout["space"]`` is what
    EstimateStripByteCounts counts as the directory's bytes (None where an
    entry's type has no size, which fails the estimate)."""
    order = data[:2]
    e = ">" if order == b"MM" else "<"
    magic = struct.unpack(e + "H", data[2:4])[0]
    n = len(data)
    try:
        if magic == 43:  # BigTIFF
            bytesize, reserved, at = struct.unpack(e + "HHQ", data[4:16])
            if bytesize != 8 or reserved != 0:
                raise _Unreadable("bad BigTIFF header")
            count_fmt, entry, inline, off_fmt = "Q", 20, 8, "Q"
        else:
            at = struct.unpack(e + "I", data[4:8])[0]
            count_fmt, entry, inline, off_fmt = "H", 12, 4, "I"
        count = struct.unpack_from(e + count_fmt, data, at)[0]
        if count == 0 or at + struct.calcsize(count_fmt) + count * entry > n:
            raise _Unreadable("the TIFF directory lies past the end of the file")
    except struct.error:
        raise _Unreadable("the TIFF ends inside its header or directory (truncated)") from None
    layout = {"strile": {}, "inline": inline, "off_fmt": off_fmt}
    # sizeof(header) + the count + the entries + the next offset, then every
    # entry's values that do not fit in it
    space = (16 + 8 + count * 20 + 8) if magic == 43 else (8 + 2 + count * 12 + 4)
    entries = {}  # tag -> (tag, type, count, where its value field lies, position)
    pos = at + struct.calcsize(count_fmt)
    for k in range(count):
        tag, typ, cnt = struct.unpack_from(e + ("HHQ" if magic == 43 else "HHI"), data, pos)
        width = _TIFF_WIDTHS.get(typ)  # TIFFDataWidth
        if space is not None:
            space = None if width is None else space + (
                width * cnt if width * cnt > inline else 0)
        entries.setdefault(tag, (tag, typ, cnt, pos + entry - inline, k))
        pos += entry
    layout["space"] = space
    spp = 1
    tags = {}
    for tag, ent in sorted(entries.items(), key=lambda x: x[0] != 277):  # SamplesPerPixel first
        _, typ, cnt, value_at, _ = ent
        if tag in (273, 279, 324, 325):
            layout["strile"][tag] = ent
            continue
        rule = _TIFF_NUMBERS.get(tag)
        if rule is not None:
            bits, fails, lo, hi = rule
            if bits == "persample":  # TIFFReadDirEntryShort, else PersampleShort
                values = _tiff_ints(data, e, layout, ent, bits=16)
                if values is not None and cnt != 1:
                    values = values[:spp] if cnt >= spp and len(set(values[:spp])) == 1 else None
            else:
                values = _tiff_ints(data, e, layout, ent, bits=bits) if cnt == 1 else None
            if values is None or not lo <= values[0] < hi:
                if fails:
                    raise _Unreadable(f"TIFF tag {tag} of type {typ} and count {cnt} that "
                                      f"libtiff cannot read")
                continue
            tags[tag] = values[:1]
            if tag == 277:
                spp = values[0]
            continue
        if tag == 338:  # setExtraSamples
            values = _tiff_ints(data, e, layout, ent, bits=16)
            if values is None or cnt > spp:
                raise _Unreadable("bad TIFF ExtraSamples")
            values = tuple(2 if v == 999 else v for v in values)
            if any(v > 2 for v in values):
                raise _Unreadable("bad TIFF ExtraSamples")
            tags[338] = values
            continue
        if tag == 347:  # JPEGTables: bytes, or integers of 0-255; else (or empty) ignored
            values = _tiff_ints(data, e, layout, (tag, 1 if typ in (2, 7) else typ) + ent[2:],
                                bits=8)
            if values:
                tags[347] = values
            continue
        if tag == 530:  # TIFF_SETGET_UINT16_PAIR: two values, else ignored
            values = _tiff_ints(data, e, layout, ent, bits=16) if cnt == 2 else None
            if values is not None:
                tags[530] = values
            continue
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(e + fmt) * cnt
        if size > inline:
            value_at = struct.unpack_from(e + off_fmt, data, value_at)[0]
            if value_at + size > n:
                continue  # libtiff drops a tag whose values lie past the end
        tags[tag] = struct.unpack_from(e + fmt * cnt, data, value_at)
    if 320 in tags:  # a colour map counts only after BitsPerSample, and whole
        bps = tags.get(258, (1,))[0]
        cmap = _tiff_ints(data, e, layout, entries[320], bits=16)
        if (258 not in entries or entries[258][4] > entries[320][4] or bps > 24
                or entries[320][2] != 3 << bps or cmap is None):
            del tags[320]
    return tags, e == ">", layout


def _tiff_strile(data: bytes, e: str, layout: dict, tags: tuple, n: int):
    """TIFFFetchStripThing: the first ``n`` values of the StripOffsets /
    TileOffsets (or the byte counts) entry, 0 past its count, or None where
    the directory has neither tag; the later entry of the two wins, as
    libtiff's second pass copies each.  An entry libtiff cannot read fails
    the directory (_Unreadable), and so does one short of more than a
    million strips."""
    entries = [layout["strile"][t] for t in tags if t in layout["strile"]]
    if not entries:
        return None
    entry = max(entries, key=lambda x: x[4])
    if entry[2] < n and n > 1_000_000:
        raise _Unreadable("a TIFF strip or tile array short of more than a million strips")
    values = _tiff_ints(data, e, layout, entry, limit=n)
    if values is None:
        raise _Unreadable("a TIFF strip or tile array libtiff cannot read")
    return values + (0,) * (n - len(values))


def _tiff_counts(data, big_endian, layout, n, planes, tiled, planar, compression, h,
                 scanline, tile_bytes):
    """The offsets and byte counts of the ``n`` strips or tiles as
    TIFFReadDirectory leaves them: the arrays as read (:func:`_tiff_strile`),
    then EstimateStripByteCounts' counts in their place
    - where the tag is missing: one strip, or one a plane (more is
      "MissingRequired", _Unreadable);
    - of one strip whose count ByteCountLooksBad: 0 in any coding, past the
      end of the file or short of the image uncompressed (offset 0 is never
      bad);
    - of more than two contiguous uncompressed strips or tiles whose first
      two counts differ and are not 0 ("Wrong StripByteCounts").
    The estimate: a tile's size, or ``imagelength / strips a plane`` rows;
    compressed, the file's size less the directory's bytes (a plane's
    share), the last strip's cut at the end of the file.  OpenCV's libtiff
    chops no strip (its build leaves STRIPCHOP_DEFAULT unset): one
    uncompressed strip stays one strip, however large."""
    e = ">" if big_endian else "<"
    offsets = _tiff_strile(data, e, layout, (273, 324), n)
    counts = _tiff_strile(data, e, layout, (279, 325), n)
    if offsets is None:
        raise _Unreadable("TIFF without the offsets of its strips or tiles")
    if counts is None:
        if planar == 1 and n > 1 or planar == 2 and n != planes:
            raise _Unreadable("TIFF without the byte counts of its strips or tiles")
        estimate = True
    elif n == 1 and not tiled:  # ByteCountLooksBad
        off, cnt = offsets[0], counts[0]
        estimate = off != 0 and (cnt == 0 or compression == 1 and (
            off <= len(data) and cnt > len(data) - off or cnt < scanline * h))
    else:
        estimate = (planar == 1 and n > 2 and compression == 1 and counts[0] != counts[1]
                    and counts[0] and counts[1])
    if estimate:  # EstimateStripByteCounts
        if compression != 1:
            if layout["space"] is None:
                raise _Unreadable("a TIFF directory entry of a type without a size")
            space = len(data) - layout["space"] if len(data) >= layout["space"] else len(data)
            counts = [space // planes] * n
            last = offsets[-1]
            if last + counts[-1] > len(data):
                counts[-1] = len(data) - last if last < len(data) else 0
        elif tiled:
            counts = [tile_bytes] * n
        else:
            counts = [scanline * (h // (n // planes))] * n
    return offsets, tuple(counts)


def _tiff_inflate(raw: bytes, occ: int):
    """ZIPDecode: (bytes, ok) where the bytes are what inflate gave before
    it failed or the data ended."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(raw, occ)
        return out, len(out) == occ
    except zlib.error:
        pass
    # what inflate wrote before the error: whole blocks of input, then the
    # failing block a byte at a time
    d, out, i = zlib.decompressobj(), bytearray(), 0
    for step in (4096, 1):
        try:
            while i < len(raw) and len(out) < occ:
                probe = d.copy()
                out += d.decompress(raw[i:i + step], occ - len(out))
                i += step
        except zlib.error:
            d = probe
            continue
        break
    return bytes(out[:occ]), False


def _tiff_chunk(raw: bytes, compression: int, occ: int, ctx: dict):
    """One strip or tile, decompressed into a zeroed buffer of ``occ`` bytes:
    (buffer, ok).  A failed decoder leaves what it wrote (libtiff goes on
    with the strip buffer as it is).  ``ctx``: what JPEG, CCITT, SGILog and
    LZW need (the chunk's geometry, JPEGTables, T4Options, where the data
    lies, the LZW decoder the file's first LZW chunk picked)."""
    buf = np.zeros(occ, np.uint8)
    if compression == 1:
        if len(raw) < occ:  # DumpModeDecode copies nothing
            return buf, False
        buf[:] = np.frombuffer(raw, np.uint8, occ)
        return buf, True
    if compression in (8, 32946):
        out, ok = _tiff_inflate(raw, occ)
        buf[:len(out)] = np.frombuffer(out, np.uint8)
        return buf, ok
    if compression in (5, 32773):
        src = np.frombuffer(raw, np.uint8)
        lib = _tiff_lib()
        fn = lib.fots_tiff_packbits
        if compression == 5:
            # LZWPreDecode's test for old-style codes: the first LZW chunk
            # decoded picks the decoder (LZWDecodeCompat or LZWDecode) for
            # every chunk of the file after it
            if ctx.get("lzw_old") is None:
                ctx["lzw_old"] = bool(raw[:1] == b"\x00" and raw[1:2] and raw[1] & 1)
            fn = lib.fots_tiff_lzw_compat if ctx["lzw_old"] else lib.fots_tiff_lzw
        return buf, bool(fn(_u8(src), src.size, _u8(buf), occ))
    if compression in _TIFF_SGILOG:  # rows into 8-bit grey (LogL) or RGB (LogLuv)
        src = np.frombuffer(raw, np.uint8)
        rows, width, luv = ctx["sgilog"]
        mode = 2 if compression == 34677 else int(luv)
        return buf, bool(_tiff_lib().fots_tiff_sgilog(_u8(src), src.size, _u8(buf), rows, width,
                                                       mode))
    if compression == 7:
        return _tiff_jpeg(ctx["tables"], raw, ctx["jpeg"], occ, ctx["rowbytes"])
    if compression in _TIFF_FAX:
        src = np.frombuffer(raw, np.uint8)
        rowbytes = ctx["rowbytes"]
        ok = _fax_lib().fots_tiff_fax(_u8(src), src.size, compression, ctx["two_d"],
                                      ctx["width"], rowbytes, occ // rowbytes, ctx["odd"],
                                      ctx["noeol"], ctx["runs"].ctypes.data_as(
                                          ctypes.POINTER(ctypes.c_uint32)), _u8(buf))
        return buf, bool(ok)
    return buf, False  # a coding libtiff does not know: "not implemented"


def _tiff_processed(chunk: np.ndarray, ok: bool, rows: int, rowbytes: int, spp: int, bps: int,
                    big_endian: bool, predictor: int) -> np.ndarray:
    """A decoded strip or tile as libtiff leaves it for the put routines:
    [rows, rowbytes] bytes, 16-bit samples in host (little-endian) order.
    The byte swap and the predictor run only where the decoder succeeded."""
    a = chunk[:rows * rowbytes].reshape(rows, rowbytes)
    if not ok or (predictor != 2 and not (bps == 16 and big_endian)):
        return a
    if bps == 16:
        v = a[:, :rowbytes // 2 * 2].view(">u2" if big_endian else "<u2").astype(np.uint16)
        if predictor == 2:
            v = v.reshape(rows, -1, spp).cumsum(1, dtype=np.uint16).reshape(rows, -1)
        out = a.copy()
        out[:, :rowbytes // 2 * 2] = v.astype("<u2").view(np.uint8)
        return out
    return a.reshape(rows, -1, spp).cumsum(1, dtype=np.uint8).reshape(rows, rowbytes)


def _tiff_samples(a: np.ndarray, cols: int, spp: int, bps: int) -> np.ndarray:
    """[rows, cols, spp] samples of processed rows."""
    rows = a.shape[0]
    if bps == 16:
        v = a[:, :cols * spp * 2].view("<u2")
    elif bps == 8:
        v = a[:, :cols * spp]
    else:
        v = np.unpackbits(a, axis=1).reshape(rows, -1, bps)[:, :cols * spp]
        v = (v * (1 << np.arange(bps - 1, -1, -1, dtype=np.uint8))).sum(2, dtype=np.uint8)
    return v.reshape(rows, cols, spp)


def _tiff_skewed_grey(a: np.ndarray, npix: int, spp: int, bps: int) -> np.ndarray:
    """The grey samples put16bitbwtile, putgreytile and putagreytile read
    from a tile clipped at the image's right edge: they step to the next row
    by the clipped width in samples, not in bytes, so each row r starts at
    r * (npix * step + (tile width - npix)) bytes (step: the bytes of a
    pixel).  16-bit: the high byte of the sample there."""
    rows, rowbytes = a.shape
    flat = a.ravel()
    step = spp * (2 if bps == 16 else 1)
    stride = npix * step + rowbytes // step - npix
    offs = np.arange(rows)[:, None] * stride + np.arange(npix)[None, :] * step
    return flat[offs + 1] if bps == 16 else flat[offs]


def _tiff_tag(tags, tag, default=None):
    return tags[tag] if tag in tags else default


def _decode_tiff(data: bytes, grayscale: bool, path: str) -> np.ndarray:
    tags, big_endian, layout = _tiff_directory(data)
    if 256 not in tags or 257 not in tags:
        raise _Unreadable("TIFF without its image width or length")
    w, h = tags[256][0], tags[257][0]
    compression = _tiff_tag(tags, 259, (1,))[0]
    spp = _tiff_tag(tags, 277, (1,))[0]
    bps = _tiff_tag(tags, 258, (1,))[0]
    extras = _tiff_tag(tags, 338, ())
    if 262 not in tags:  # OpenCV's readHeader needs the tag (libtiff guesses none)
        raise _Unreadable("TIFF without a Photometric tag libtiff reads")
    photometric = tags[262][0]
    channels = {0: 1, 1: 1, 3: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, _LOGLUV: 3, 4: 4, 5: 4}.get(
        photometric, 0)  # _TIFFGetMaxColorChannels
    if channels and spp - len(extras) > channels:  # the rest become (unspecified) extra samples
        extras += (0,) * (spp - len(extras) - channels)
    if photometric == 3 and 320 not in tags:  # TIFFReadDirectory's repair
        if bps < 8:
            raise _Unreadable("palette TIFF without its colour map")
        photometric = 2 if spp == 3 else 1
    planar = _tiff_tag(tags, 284, (1,))[0]
    fmt = _tiff_tag(tags, 339, (1,))[0]
    predictor = _tiff_tag(tags, 317, (1,))[0]
    orientation = _tiff_tag(tags, 274, (1,))[0]
    fillorder = _tiff_tag(tags, 266, (1,))[0]
    tiled = 322 in tags or 323 in tags  # FIELD_TILEDIMENSIONS
    if not 0 < w or not 0 < h or spp < 1:
        raise _Unreadable("TIFF of zero size")
    # OpenCV's readHeader / readData and TIFFRGBAImageOK / Begin
    depths = {3: (1, 4, 8), _LOGL: (1, 8, 16), _LOGLUV: (1, 2, 4, 8, 16)}.get(
        photometric, (1, 8, 16) if photometric in (0, 1) else (8, 16))
    if (bps not in depths or spp > 4 or fmt not in (1, 2, 4)
            or planar not in (1, 2) or compression in _TIFF_UNREAD_CODINGS):
        raise _Unreadable(f"TIFF of {bps}-bit samples, photometric {photometric}, "
                          f"sample format {fmt}, compression {compression}")
    log = photometric in (_LOGL, _LOGLUV)
    if log or compression in _TIFF_SGILOG:  # LogLuvSetupDecode, TIFFRGBAImageOK
        luv = photometric == _LOGLUV
        codings = _TIFF_SGILOG if luv else (34676,)
        if not log or compression not in codings or planar != 1 or extras or spp != (
                3 if luv else 1):
            raise _Unreadable(f"a TIFF of photometric {photometric} and compression {compression} "
                              f"libtiff's RGBA reader does not read (LogL needs SGILog, LogLuv "
                              f"SGILog or SGILog24, contiguous, 1 or 3 samples)")
    if photometric == 8 and (spp != 3 or extras or planar != 1):
        raise _Unreadable("a CIELab TIFF libtiff's RGBA reader has no routine for (3 samples "
                          "of 8 or 16 bits, contiguous)")
    if photometric not in (0, 1, 2, 3, 5, 6, 8) and not log:
        raise _Unreadable(f"TIFF of photometric {photometric} (ICCLab and ITULab included: "
                          f"libtiff's RGBA reader has no routine for them)")
    if photometric == 8:
        white = _tiff_floats(tags, 318, _WHITE_POINT)
        if white[1] == 0:
            raise _Unreadable("invalid WhitePoint")
    if log:  # SGILOGDATAFMT_8BIT: 8-bit grey or RGB
        photometric, bps = (2, 8) if photometric == _LOGLUV else (1, 8)
    hs, vs = _tiff_tag(tags, 530, (2, 2))[:2] if len(_tiff_tag(tags, 530, ())) >= 2 else (2, 2)
    # the strips or tiles, with their offsets and byte counts as
    # TIFFReadDirectory leaves them
    if tiled:
        tw, th = _tiff_tag(tags, 322, (0,))[0], _tiff_tag(tags, 323, (0,))[0]
        if tw <= 0 or th <= 0:
            raise _Unreadable("TIFF tiles of a size libtiff refuses")
    else:
        tw, th = w, min(_tiff_tag(tags, 278, (h,))[0], h)
    planes = spp if planar == 2 else 1
    plane_spp = 1 if planar == 2 else spp
    if photometric == 6 and planar == 1 and spp == 3:  # TIFFScanlineSize of subsampled YCbCr
        if bps != 8 or hs not in (1, 2, 4) or vs not in (1, 2, 4):
            raise _Unreadable("a YCbCr TIFF of a depth or subsampling libtiff's sizes refuse")
        scanline = -(-w // hs) * (hs * vs + 2) // vs
        tile_bytes = -(-th // vs) * -(-tw // hs) * (hs * vs + 2)
    else:
        scanline = (w * plane_spp * bps + 7) // 8
        tile_bytes = th * ((tw * plane_spp * bps + 7) // 8)
    across, down = -(-w // tw), -(-h // th)
    offsets, counts = _tiff_counts(data, big_endian, layout, across * down * planes, planes,
                                   tiled, planar, compression, h, scanline, tile_bytes)
    # OpenCV's strip: RowsPerStrip as libtiff gives it, not cut to the image
    # (h where the tag is unset or 2^32 - 1)
    tw0, th0 = (tw, th) if tiled else (w, _tiff_tag(tags, 278, (h,))[0])
    th0 = h if th0 == 0xFFFFFFFF else th0
    jpeg_rgb = compression == 7 and photometric == 6 and planar == 1
    if jpeg_rgb and 530 not in tags:  # JPEGFixupTagsSubsampling: the first stream's sampling
        hs, vs = _jpeg_sampling(data, offsets, counts, (hs, vs))
    if jpeg_rgb:  # TIFFRGBAImageBegin: libjpeg converts YCbCr to RGB (JPEGCOLORMODE_RGB)
        photometric = 2
    if photometric == 5 and (bps != 8 or _tiff_tag(tags, 332, (1,))[0] != 1 or spp < 4
                             or planar == 2 and spp != 4):
        raise _Unreadable("a separated TIFF libtiff's RGBA reader has no routine for "
                          "(8-bit CMYK only, InkSet 1, 4 samples in planes)")
    if photometric == 6 and (bps != 8 or spp != 3 or (hs, vs) not in _YCBCR_SAMPLINGS
                             or planar == 2 and (hs, vs) != (1, 1)):
        raise _Unreadable(f"a YCbCr TIFF libtiff's RGBA reader has no routine for ({bps}-bit, "
                          f"{spp} samples, subsampling {hs}x{vs}, planar {planar})")
    if compression in _TIFF_FAX and bps != 1:
        raise _Unreadable("CCITT coding of samples of more than one bit")
    colour = photometric == 2
    if colour and spp - len(extras) < 3:
        raise _Unreadable("RGB TIFF of fewer than 3 colour channels")
    if photometric == 3 and (spp != 1 or planar == 2 and bps < 8):
        raise _Unreadable("palette TIFF of more than one sample")
    if photometric in (0, 1, 3) and planar == 1 and spp != 1 and bps < 8:
        raise _Unreadable("TIFF of packed samples with extra samples")
    if planar == 2 and (bps < 8 or photometric == 3):
        raise _Unreadable("planar TIFF libtiff's RGBA reader does not read")
    if predictor not in (1, 2) and compression in (5, 8, 32946):
        raise _Unreadable(f"TIFF predictor {predictor}")
    if predictor == 2 and compression in (5, 8, 32946) and bps not in (8, 16):
        raise _Unreadable(f"TIFF horizontal predictor of {bps}-bit samples")
    if orientation in (5, 6, 7, 8):
        raise _Unreadable("TIFF orientation that transposes (imread's ExifTransform asserts)")
    if w > 1 << 20 or h > 1 << 20 or w * h > _MAX_PIXELS:
        raise ValueError(f"{path}: TIFF larger than OpenCV's limits (cv2.imread raises)")
    if compression not in (5, 8, 32946):  # libtiff runs it inside LZW and Deflate only
        predictor = 1
    alpha = 0  # 0 none, 1 associated, 2 unassociated (EXTRASAMPLE_*)
    if extras:
        alpha = {0: 1 if spp > 3 else 0, 1: 1, 2: 2}.get(extras[0], 0)
    elif spp == 4 and photometric == 2:
        alpha = 1
    # OpenCV's limits on a strip or tile: each side at most 2^24, under 1 GiB
    # of samples and of its RGBA buffer
    if (not 0 < tw0 <= 1 << 24 or not 0 < th0 <= 1 << 24
            or tw0 * th0 * max(spp * max(1, bps // 8), 4) >= 1 << 30):
        raise _Unreadable("TIFF strip or tile of a side over 2^24 or of 1 GiB or more")
    subsampled = photometric == 6 and planar == 1
    if photometric == 6:
        ycc = _ycbcr_tables(tags)
    if subsampled:  # the RGB of libtiff's putcontig8bitYCbCr*tile, chunk by chunk
        samples = np.zeros((h, w, 3), np.uint8)
    else:
        samples = np.zeros((h, w, spp), np.uint16 if bps == 16 else np.uint8)
    ctx = {"tables": np.frombuffer(bytes(_tiff_tag(tags, 347, ())), np.uint8),
           "two_d": _tiff_tag(tags, 292, (0,))[0] & 1, "width": tw, "noeol": ctypes.c_int(0)}
    if compression in _TIFF_FAX:  # libtiff's run arrays, kept from strip to strip
        ctx["runs"] = np.zeros(2 * (-(-(tw + 1) // 32) * 32) + 1, np.uint32)
    skewed = []  # (y0, x0, grey samples) of clipped tiles read with the wrong stride
    # TIFFFillStrip / TIFFFillTile cut a count past 1 MiB to 10 chunks + 4 KiB
    full = tile_bytes if tiled else (
        -(-th // vs) * -(-tw // hs) * (hs * vs + 2) if subsampled else th * (
            (tw * plane_spp * bps + 7) // 8))
    # tif_rawdatasize: the count where libtiff reads the mapped file in place,
    # else a buffer that grows by whole KiB (fill order 2 but for JPEG and CCITT)
    mapped = fillorder != 2 or compression == 7 or compression in _TIFF_FAX
    raw_size = 0
    # the RGBA reader's buffer for a tile: one a plane to draw from
    tile_buffer = tile_bytes * (1 if planes == 1 else 4 if alpha else 3)
    for p in range(planes):
        for j in range(down):
            for i in range(across):
                k = (p * down + j) * across + i
                off, cnt = offsets[k], counts[k]
                if cnt > 1 << 20 and (cnt - 4096) // 10 > full:
                    cnt = full * 10 + 4096
                failed = cnt == 0 or off + cnt > len(data)
                if not failed:
                    raw_size = cnt if mapped else max(raw_size, -(-cnt // 1024) * 1024)
                if failed or tiled and p == 0 and (
                        raw_size != tile_bytes if compression == 1 else
                        tile_buffer > 100_000_000 and raw_size < tile_bytes // 1000):
                    # _TIFFReadEncodedTileAndAllocBuffer: an uncompressed tile
                    # whose raw data is not the tile's size fails, and so does
                    # one compressed more than 1000 times into a buffer of over
                    # 10^8 bytes
                    if p == 0:  # the read that allocates the buffer fails
                        raise _Unreadable("a TIFF strip or tile past the end of the file or "
                                          "of a byte count libtiff refuses")
                    continue  # a later plane's read fails: its samples stay 0
                raw = data[off:off + cnt]
                if fillorder == 2 and compression != 7:  # JPEG asks for no bit reversal
                    raw = raw.translate(_BIT_REVERSE)
                rows = th if tiled else min(th, h - j * th)
                y0, x0 = j * th, i * tw
                if subsampled:
                    _ycbcr_chunk(raw, compression, ycc, hs, vs, tw, rows, tiled, samples, y0, x0,
                                 ctx)
                    continue
                rowbytes = (tw * plane_spp * bps + 7) // 8
                ctx["rowbytes"], ctx["odd"] = rowbytes, off & 1
                if compression == 7:  # JPEGPreDecode's expectations of the stream
                    last = not tiled and j == down - 1
                    ctx["jpeg"] = (tw, rows, int(last), plane_spp,
                                   *((hs, vs) if jpeg_rgb else (1, 1)), bps, int(jpeg_rgb))
                if compression in _TIFF_SGILOG:
                    ctx["sgilog"] = (rows, tw, photometric == 2)
                chunk, ok = _tiff_chunk(raw, compression, rows * rowbytes, ctx)
                a = _tiff_processed(chunk, ok, rows, rowbytes, plane_spp, bps, big_endian,
                                    predictor)
                npix = min(tw, w - x0)
                if tiled and bps < 8 and npix < tw:
                    # the 1, 2 and 4-bit put routines step over a clipped
                    # tile's right part in whole bytes (fromskew / 8, 4, 2),
                    # a byte short a row where the tile's width is not whole
                    # bytes
                    used = (npix * bps + 7) // 8
                    step = used + (tw - npix) * bps // 8
                    at = np.arange(rows)[:, None] * step + np.arange(used)[None, :]
                    v = _tiff_samples(a.ravel()[at], npix, 1, bps)[:h - y0]
                else:
                    v = _tiff_samples(a, tw, plane_spp, bps)[:h - y0, :npix]
                samples[y0:y0 + v.shape[0], x0:x0 + v.shape[1], p:p + plane_spp] = v
                if (tiled and npix < tw and planar == 1 and photometric in (0, 1)
                        and (bps == 16 or (bps == 8 and spp > 1))):
                    skewed.append((y0, x0, _tiff_skewed_grey(a, npix, spp, bps)[:v.shape[0]]))
    for y0, x0, g in skewed:
        samples[y0:y0 + g.shape[0], x0:x0 + g.shape[1], 0] = g if bps == 8 else g.astype(
            np.uint16) << 8
    if subsampled:
        rgb = samples
    elif photometric == 6:  # putseparate8bitYCbCr11tile
        rgb = _ycbcr_rgb(ycc, samples[..., 0], samples[..., 1], samples[..., 2])
    elif photometric == 8:  # putcontig8bitCIELab8 / 16 through TIFFCIELabToRGBInit
        rgb = np.empty((h, w, 3), np.uint8)
        lab = np.ascontiguousarray(samples)
        _tiff_lib().fots_tiff_cielab(lab.ctypes.data, h * w, bps, float(white[0]),
                                     float(white[1]), _u8(rgb))
    elif photometric == 5:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bittile
        k = 255 - samples[..., 3].astype(np.int32)
        rgb = (k[..., None] * (255 - samples[..., :3].astype(np.int32)) // 255).astype(np.uint8)
    else:
        rgb = _tiff_rgb(samples, tags, photometric, bps, spp, planar, alpha)
    # orientation: libtiff flips each strip or tile toward its bottom-left
    # request and OpenCV places the rows back; a horizontal flip of a tiled
    # file mirrors each tile in place
    if orientation in (2, 3):
        if tiled:
            for x0 in range(0, w, tw):
                rgb[:, x0:x0 + tw] = rgb[:, x0:x0 + tw][:, ::-1]
        else:
            rgb = rgb[:, ::-1]
    if orientation in (3, 4):
        rgb = rgb[::-1]
    if grayscale:  # icvCvt_BGRA2Gray_8u_C4C1R
        r, g, b = (rgb[..., c].astype(np.int32) for c in range(3))
        return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)
    return np.ascontiguousarray(rgb[..., ::-1])


def _jpeg_sampling(data: bytes, offsets, counts, default):
    """The sampling of component 0 in the frame header of the first strip or
    tile's JPEG stream, as JPEGFixupTagsSubsampling reads it for a YCbCr
    TIFF without YCbCrSubsampling; ``default`` where it finds none."""
    if not offsets or not counts:
        return default
    s = data[offsets[0]:offsets[0] + counts[0]]
    i = 2 if s[:2] == b"\xff\xd8" else len(s)
    while i + 4 <= len(s) and s[i] == 0xFF:
        m, n = s[i + 1], int.from_bytes(s[i + 2:i + 4], "big")
        if m in (0xC0, 0xC1, 0xC2) and i + 12 <= len(s):
            hv = s[i + 11]
            if hv >> 4 in (1, 2, 4) and hv & 15 in (1, 2, 4):
                return hv >> 4, hv & 15
            return default
        if m == 0xDA:
            return default
        i += 2 + n
    return default


def _tiff_floats(tags, tag, default):
    """A RATIONAL tag as libtiff reads it into floats ((float) n / (float) d,
    0 where d is 0), or ``default``."""
    v = tags.get(tag)
    if v is None or len(v) < 2 * len(default):
        return np.array(default, np.float32)
    num = np.array(v[0::2][:len(default)], np.float32)
    den = np.array(v[1::2][:len(default)], np.float32)
    return np.where(den == 0, np.float32(0), num / np.where(den == 0, np.float32(1), den))


def _ycbcr_tables(tags):
    """TIFFYCbCrToRGBInit's tables (tif_color.c), built in float as libtiff
    builds them from YCbCrCoefficients and ReferenceBlackWhite: (Y, Cr->R,
    Cb->B, Cr->G, Cb->G), each indexed by the 8-bit sample."""
    f32 = np.float32
    luma = _tiff_floats(tags, 529, (0.299, 0.587, 0.114))
    rbw = _tiff_floats(tags, 532, (0, 255, 128, 255, 128, 255))
    if np.isnan(luma).any() or luma[1] == 0 or np.isnan(rbw).any():
        raise _Unreadable("invalid YCbCrCoefficients or ReferenceBlackWhite")
    lr, lg, lb = luma

    def fix(x):  # FIX(CLAMP(x, 0, 2)): the float product, + 0.5 in double, truncated
        x = f32(2) if x > 2 else x if x >= 0 else f32(0)
        return int(float(f32(x) * f32(65536)) + 0.5)
    f1 = f32(2) - f32(2) * lr
    d1 = fix(f1)
    d2 = -fix(lr * f1 / lg)
    f3 = f32(2) - f32(2) * lb
    d3 = fix(f3)
    d4 = -fix(lb * f3 / lg)

    def code2v(c, rb, rw, cr):  # Code2V, then CLAMPw to +-4096 and (int32_t)
        rb, rw = f32(rb), f32(rw)
        span = rw - rb
        v = (c - np.int32(np.trunc(rb))).astype(f32) * f32(cr) / (span if span != 0 else f32(1))
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)
    x = np.arange(-128, 128)
    cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    half = 1 << 15
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    return (y_tab, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr, d4 * cb + half)


def _ycbcr_rgb(ycc, y, cb, cr) -> np.ndarray:
    """TIFFYCbCrtoRGB of 8-bit samples: [..., 3] R, G, B."""
    y_tab, cr_r, cb_b, cr_g, cb_g = ycc
    yv = y_tab[y]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    return np.stack([np.clip(yv + cr_r[cr], 0, 255), np.clip(g, 0, 255),
                     np.clip(yv + cb_b[cb], 0, 255)], -1).astype(np.uint8)


def _ycbcr_chunk(raw, compression, ycc, hs, vs, tw, rows, tiled, rgb, y0, x0, ctx):
    """One strip or tile of subsampled YCbCr into ``rgb`` as gtStripContig /
    gtTileContig and the putcontig8bitYCbCr*tile routines put it: blocks of
    hs * vs Y samples then Cb and Cr; a strip is read as the routine asks,
    rows rounded up to whole blocks times TIFFScanlineSize, which is the
    block row's bytes / vs rounded down (short by 2 bytes a block row when
    the blocks of 4x4 are odd in number); a clipped tile skips
    (skipped pixels / hs) blocks after each block row, counted at 10 bytes a
    block by the 4x4 routine."""
    h, w = rgb.shape[:2]
    bs = hs * vs + 2
    blocks = -(-tw // hs)
    size = -(-rows // vs) * blocks * bs  # TIFFVStripSize / TIFFVTileSize
    occ = size if tiled else min(size, -(-rows // vs) * vs * (blocks * bs // vs))
    buf, _ = _tiff_chunk(raw, compression, occ, ctx)
    buf = np.concatenate([buf, np.zeros(size - occ + bs * blocks + bs, np.uint8)])
    nrow, npix = min(rows, h - y0), min(tw, w - x0)
    skip = tw - npix
    stride = -(-npix // hs) * bs + (skip // hs) * (10 if (hs, vs) == (4, 4) else bs)
    yy, xx = np.arange(nrow)[:, None], np.arange(npix)[None, :]
    base = (yy // vs) * stride + (xx // hs) * bs
    y = buf[base + (yy % vs) * hs + xx % hs]
    rgb[y0:y0 + nrow, x0:x0 + npix] = _ycbcr_rgb(ycc, y, buf[base + hs * vs],
                                                  buf[base + hs * vs + 1])


def _tiff_rgb(samples, tags, photometric, bps, spp, planar, alpha) -> np.ndarray:
    """The R, G, B that libtiff's put routines write for each pixel."""
    s = samples
    if photometric in (0, 1) and planar == 1:
        v = s[..., 0] >> 8 if bps == 16 else s[..., 0].astype(np.int32)  # high byte
        rng = 255 if bps == 16 else (1 << bps) - 1
        lut = np.arange(rng + 1) * 255 // rng
        if photometric == 0:
            lut = (rng - np.arange(rng + 1)) * 255 // rng
        g = lut[v].astype(np.uint8)
        return np.stack([g, g, g], -1)
    if photometric == 3:
        cmap = np.asarray(tags.get(320, ()), np.int64)
        n = 1 << bps
        if cmap.size < 3 * n:
            raise _Unreadable("palette TIFF without a colour map")
        cmap = cmap[:3 * n].reshape(3, n)
        if (cmap >= 256).any():  # libtiff's checkcmap: a 16-bit colour map
            cmap = cmap >> 8
        return cmap[:, s[..., 0]].transpose(1, 2, 0).astype(np.uint8)
    # RGB, and grey in planes (gtStripSeparate reads the one plane as R, G, B)
    colours = [0, 0, 0] if photometric in (0, 1) else [0, 1, 2]
    if bps == 8 and alpha != 2 and photometric == 2:
        return s[..., :3]
    if bps == 16:
        c = ((s.astype(np.int32) + 128) // 257)  # Bitdepth16To8
    else:
        c = s.astype(np.int32)
    rgb = c[..., colours]
    if alpha == 2 and spp > len(set(colours)):  # UaToAa: alpha after the colour channels
        a = c[..., len(set(colours)):len(set(colours)) + 1]
        rgb = (a * rgb + 127) // 255
    return rgb.astype(np.uint8)


# ---------------------------------------------------------------- WebP
# fots_torch/csrc/decode_webp.cpp: the container, VP8L, VP8, ALPH and an
# animation's first frame, as OpenCV 5.0's WebPDecoder reads them through
# libwebp 1.5; the orientation of the EXIF chunk OpenCV reads (through
# WebPDemux) is applied here.

_DECODED = ("JPEG, PNG, BMP, GIF, TIFF, WebP, Netpbm, Sun raster, PFM, Radiance HDR and "
            "JPEG 2000 only")


def _webp_lib() -> ctypes.CDLL:
    lib = _format_lib("decode_webp", "fots_webp")
    if not getattr(lib, "_fots_webp_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.fots_webp_signature.restype = ctypes.c_int
        lib.fots_webp_signature.argtypes = [u8p, ctypes.c_int64]
        lib.fots_webp_decode_bgra.restype = ctypes.c_int
        lib.fots_webp_decode_bgra.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_char_p,
                                              ctypes.c_int]
        lib._fots_webp_typed = True
    return lib


def _is_webp(data: bytes) -> bool:
    """OpenCV's WebP signature check (WebPGetFeatures on the first 32 bytes,
    so a raw VP8 or VP8L stream counts); a RIFF ... WEBP file always goes to
    the WebP decoder, which gives None where cv2 finds no decoder for it."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return True
    if len(data) < 32 or not (data[:1] == b"\x2f" or data[3:6] == b"\x9d\x01\x2a"):
        return False
    head = np.frombuffer(data[:32], np.uint8)
    return bool(_webp_lib().fots_webp_signature(_u8(head), 32))


def _decode_webp(data: bytes, grayscale: bool, path: str, bgra: bool = False):
    """(image, EXIF orientation) of a WebP file; ``bgra``: [H, W, 4] with the
    decoded alpha plane (``cv2.IMREAD_UNCHANGED``'s for an image with alpha)."""
    lib = _webp_lib()
    src = np.frombuffer(data, np.uint8)
    info = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _checked(lib.fots_webp_header(_u8(src), src.size, info, err, _ERR_LEN), err, path)
    h, w, exif_at, exif_size = info
    if bgra:
        out = np.empty((h, w, 4), np.uint8)
        _checked(lib.fots_webp_decode_bgra(_u8(src), src.size, _u8(out), err, _ERR_LEN), err, path)
    else:
        out = np.empty((h, w) if grayscale else (h, w, 3), np.uint8)
        _checked(lib.fots_webp_decode(_u8(src), src.size, int(grayscale), _u8(out), err,
                                      _ERR_LEN), err, path)
    orientation = 1
    if exif_size:
        exif = src[exif_at:exif_at + exif_size]
        orientation = _lib().fots_exif_orientation(_u8(exif), exif.size)
    return out, orientation


# ---------------------------------------------------------------- Netpbm
# PBM / PGM / PPM (P1-P6) as OpenCV 5.0's PxMDecoder reads them and PAM (P7)
# as its PAMDecoder does (grfmt_pxm.cpp, grfmt_pam.cpp), quirks included:
#   - binary samples of a maxval below 256 are the bytes as stored (maxval
#     100 does not scale); ASCII ones are clipped to maxval and scaled by
#     v * 255 // maxval; 16-bit samples (maxval 256-65535, ASCII or
#     big-endian binary) keep their high byte (v >> 8, no scaling);
#   - P1 reads one digit at a time (no separator needed), P1 / P4 bit 1 is
#     black; a number ends at the first non-digit, which is consumed
#     unread ("1x 2" reads 1 and 2; "12#34" reads 12 and 34); an ASCII
#     file must go on for a byte past its last number (P1 excepted);
#   - PAM: header lines of an 8-character identifier and a value (decimal,
#     an optional minus sign, nothing else but trailing blanks), TUPLTYPE
#     checked against DEPTH, MAXVAL 1 read as packed bits (one bit a pixel
#     from the first bytes of each row's samples), an RGB PAM read in colour
#     as stored (no swap to BGR), GRAYSCALE_ALPHA and RGB_ALPHA converted
#     for only the first ceil(width / depth) pixels of a row, three bytes a
#     pixel in grey too (OpenCV leaves the rest of the row as the memory it
#     was given: zeros here);
#   - grey of colour samples by imgcodecs' fixed point (4899, 9617, 1868
#     over 2^14, rounded).
# None where cv2 gives None: a bad header, data that ends early, a
# character other than a digit, blank or comment among ASCII samples.

_PXM_COEFFS = (4899, 9617, 1868)  # R, G, B over 2^14 (icvCvt_BGR2Gray_8u_C3C1R)
_INT_MAX = 2**31 - 1
_PAM_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
#: TUPLTYPE -> channels
_PAM_TUPLTYPES = {"": 0, "BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3,
                  "RGB_ALPHA": 4}


class _Oversize(ValueError):
    """An image past OpenCV's limits on a side or its pixels (imread raises)."""


def _check_size(w: int, h: int) -> None:  # validateInputImageSize
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20) or w * h > _MAX_PIXELS:
        raise _Oversize(f"a Netpbm image of {w}x{h}, past OpenCV's limits (cv2.imread raises)")


class _ByteReader:
    """RLByteStream over the file: reading past the end fails (IndexError)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise IndexError("the Netpbm file ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, maxdigits: int = 0) -> int:  # ReadNumber
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:  # '#': a comment to the end of its line
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError(f"unexpected byte 0x{code:02x} in a Netpbm number")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > _INT_MAX:
                raise ValueError("a Netpbm number past INT_MAX")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            code = self.byte()
            if not 48 <= code <= 57:
                break
        return val


_CLEAN = re.compile(rb"[0-9 \t\n\v\f\r]*")


def _ascii_samples(r: _ByteReader, count: int, single_digits: bool) -> np.ndarray:
    """``count`` ASCII numbers from the reader's position, as ReadNumber reads
    them: split on blanks where the rest of the file is only digits and
    blanks, else one number at a time."""
    rest = r.data[r.pos:]
    if _CLEAN.fullmatch(rest):
        if single_digits:
            digits = np.frombuffer(rest.translate(None, _SPACE), np.uint8)
            if digits.size < count:
                raise IndexError("the Netpbm file ends early")
            return (digits[:count] - 48).astype(np.int64)
        tokens = rest.split(None, count)
        if len(tokens) < count or (len(tokens) == count and not rest[-1:] in _SPACE):
            raise IndexError("the Netpbm file ends early")  # no byte after the last number
        if any(len(t) > 9 and int(t) > _INT_MAX for t in tokens[:count]):
            raise ValueError("a Netpbm number past INT_MAX")
        return np.array(tokens[:count], np.int64)
    return np.array([r.number(1 if single_digits else 0) for _ in range(count)], np.int64)


def _grey14(rgb: np.ndarray) -> np.ndarray:
    """imgcodecs' grey of [..., 3] R, G, B samples."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    c_r, c_g, c_b = _PXM_COEFFS
    return ((r * c_r + g * c_g + b * c_b + (1 << 13)) >> 14).astype(np.uint8)


def _bits_rows(raw: np.ndarray, w: int) -> np.ndarray:
    """[rows, w] bits (most significant first) of [rows, bytes] data."""
    return np.unpackbits(raw, axis=1)[:, :w]


def _decode_pxm(data: bytes, grayscale: bool) -> np.ndarray:
    r = _ByteReader(data, 2)
    kind = data[1] - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    w, h = r.number(), r.number()
    maxval = r.number() if bpp > 1 else 1
    if maxval > 65535:
        raise ValueError("a Netpbm maxval past 65535")
    if not (w > 0 and h > 0 and maxval > 0):
        raise ValueError(f"a Netpbm header of {w}x{h}, maxval {maxval}")
    _check_size(w, h)
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            bits = _bits_rows(np.frombuffer(r.bytes(pitch * h), np.uint8).reshape(h, pitch), w)
        else:
            bits = (_ascii_samples(r, w * h, True) != 0).reshape(h, w).astype(np.uint8)
        v = np.where(bits != 0, 0, 255).astype(np.uint8)  # bit 1 is black
    else:
        wide = maxval > 255
        n = w * h * nch
        if binary:
            raw = np.frombuffer(r.bytes(n * (2 if wide else 1)), np.uint8)
            v = raw[0::2] if wide else raw  # big-endian: the high byte
        else:
            codes = np.minimum(_ascii_samples(r, n, False), maxval)
            v = (codes >> 8) if wide else codes * 255 // maxval
        v = v.astype(np.uint8).reshape(h, w, nch)
        if nch == 3:
            return _grey14(v) if grayscale else np.ascontiguousarray(v[..., ::-1])
        v = v[..., 0]
    return v if grayscale else np.repeat(v[..., None], 3, axis=2)


def _pam_line(r: _ByteReader):
    """ReadPAMHeaderLine: (field or None for a comment, value), or False."""
    code = r.byte()
    while code in _SPACE:
        code = r.byte()
    if code == 35:
        while code not in (10, 13):
            code = r.byte()
        return None, ""
    ident = bytearray()
    while len(ident) < 8 and code not in _SPACE:
        ident.append(code)
        code = r.byte()
    if code not in _SPACE or ident.decode("latin-1") not in _PAM_FIELDS:
        return False
    if code in (10, 13):
        return ident.decode(), ""
    while code in _SPACE and code not in (10, 13):
        code = r.byte()
    if code in (10, 13):
        return False  # an identifier and blanks, then no value
    value = bytearray()
    while len(value) < 255 and code not in (10, 13):
        value.append(code)
        code = r.byte()
    return ident.decode(), value.rstrip(_SPACE).decode("latin-1")


def _pam_number(value: str) -> int:
    if value == "":
        return 0
    if not re.fullmatch(r"-?[0-9]+", value) or not -_INT_MAX - 1 <= int(value) <= _INT_MAX:
        raise ValueError(f"a bad PAM number {value!r}")
    return int(value)


def _decode_pam(data: bytes, grayscale: bool) -> np.ndarray:
    if data[2] not in (10, 13):
        raise ValueError("a PAM magic number not followed by a line break")
    r = _ByteReader(data, 3)
    fields = {}
    tupltype = None
    while True:
        line = _pam_line(r)
        if line is False:
            raise ValueError("a bad PAM header line")
        field, value = line
        if field == "ENDHDR":
            break
        if field == "TUPLTYPE":
            if value not in _PAM_TUPLTYPES:
                raise ValueError(f"an unknown PAM TUPLTYPE {value!r}")
            tupltype = value
        elif field is not None:
            if field in fields:
                raise ValueError(f"PAM {field} given twice")
            fields[field] = _pam_number(value)
    if len(fields) != 4:
        raise ValueError("a PAM header without its WIDTH, HEIGHT, DEPTH and MAXVAL")
    w, h, depth, maxval = fields["WIDTH"], fields["HEIGHT"], fields["DEPTH"], fields["MAXVAL"]
    if maxval > 65535:
        raise ValueError("a PAM maxval past 65535")
    if not tupltype:
        if depth == 1 and maxval < 256:
            tupltype = "BLACKANDWHITE" if maxval == 1 else "GRAYSCALE"
        elif depth == 3 and maxval < 256:
            tupltype = "RGB"
        else:
            raise ValueError("a PAM whose tuple type cv2 cannot tell")
    elif _PAM_TUPLTYPES[tupltype] != depth:
        raise ValueError(f"a PAM {tupltype} of depth {depth}")
    if not 1 <= depth <= 4:
        raise ValueError(f"a PAM of depth {depth}")
    _check_size(w, h)
    wide = maxval > 255
    rowbytes = w * depth * (2 if wide else 1)
    raw = np.frombuffer(r.bytes(rowbytes * h), np.uint8).reshape(h, rowbytes)
    target = 1 if grayscale else 3
    if maxval == 1:  # packed bits from the first bytes of each row
        v = np.where(_bits_rows(raw, w) != 0, 255, 0).astype(np.uint8)
        return v if grayscale else np.repeat(v[..., None], 3, axis=2)
    s = raw[:, 0::2] if wide else raw  # [h, w * depth] samples' (high) bytes
    if target == depth:
        return np.ascontiguousarray(s.reshape((h, w) if grayscale else (h, w, 3)))
    if tupltype == "RGB":  # rgb_convert: grey only, as target != depth
        return _grey14(s.reshape(h, w, 3))
    # basic_conversion: pixels i < ceil(w / depth) of the row, each from
    # sample i * depth (B, G, R from channels 2, 1, 0 of RGB_ALPHA); in grey
    # each writes three bytes of the row, so byte j is pixel j // 3's
    n = -(-w // depth)
    idx = np.arange(n) * depth
    if grayscale:
        j = np.arange(min(w, 3 * n))
        out = np.zeros((h, w), np.uint8)
        out[:, :j.size] = s[:, (j // 3) * depth]
        return out
    out = np.zeros((h, w, 3), np.uint8)
    if tupltype == "RGB_ALPHA":
        out[:, :n] = np.stack([s[:, idx + c] for c in (2, 1, 0)], -1)
    else:
        out[:, :n] = s[:, idx, None]
    return out


def _decode_netpbm(data: bytes, grayscale: bool) -> np.ndarray:
    return _decode_pam(data, grayscale) if data[1:2] == b"7" else _decode_pxm(data, grayscale)


# ---------------------------------------------------------------- PFM, Sun raster, HDR
# PFM as OpenCV 5.0's PFMDecoder reads it (grfmt_pfm.cpp), Sun raster as its
# SunRasterDecoder (fots_torch/csrc/decode_sunras.cpp) and Radiance HDR as
# its HdrDecoder (rgbe.cpp: the header here, the pixels in
# fots_torch/csrc/decode_hdr.cpp).  PFM and HDR hold floats, which imread
# turns into 8 bits as ``Mat.convertTo`` does: the float product (PFM: the
# sample times 1 / |scale|; HDR: the value times 255) rounded half to even,
# saturated to 0..255, and 0 where it is NaN or rounds outside int32
# (cvRound gives INT_MIN there).

SUNRAS_SIGNATURE = b"\x59\xa6\x6a\x95"
HDR_SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_HDR_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_HDR_SIZE = re.compile(rb"-Y\s*([+-]?[0-9]+)\s*\+X\s*([+-]?[0-9]+)")
_C_INT = re.compile(rb"\s*([+-]?[0-9]+)")
_C_FLOAT = re.compile(rb"\s*([+-]?(0[xX]([0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)"
                      rb"([pP][+-]?[0-9]+)?|([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?"
                      rb"|inf(inity)?|nan))", re.I)


def _c_int(text: bytes) -> int:
    """``atoi`` / ``sscanf("%d")`` as glibc computes them: strtol, clamped to
    a long, then cut to 32 bits."""
    m = _C_INT.match(text)
    if not m:
        return 0
    v = min(max(int(m.group(1)), -2**63), 2**63 - 1)
    return (v + 2**31) % 2**32 - 2**31


def _c_float(text: bytes) -> float:
    """``atof``: the longest number at the start of ``text``, else 0."""
    m = _C_FLOAT.match(text)
    if not m:
        return 0.0
    t = m.group(1).decode()
    if "x" in t.lower():
        t = t if "p" in t.lower() else t + "p0"
        return float.fromhex(t)
    return float(t)


def _u8_of_float(v: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>`` of float32 values (cvRound, then saturate)."""
    r = np.rint(v, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        r[~(np.abs(r) < 2.0**31)] = 0  # NaN, infinities, past int32: INT_MIN, then 0
    return np.clip(r, 0, 255, out=r).astype(np.uint8)


def _pfm_field(data: bytes, pos: int):
    """read_number's text: bytes up to one whitespace byte (consumed), at
    most 2048; a byte past 127 or the end of the file fails."""
    end = pos
    while end < len(data) and end - pos < 2048:
        c = data[end]
        if c >= 128:
            raise _Unreadable("a PFM header byte past 127")
        if c in _SPACE:
            return data[pos:end], end + 1
        end += 1
    if end - pos < 2048:
        raise _Unreadable("the PFM ends inside its header (truncated)")
    return data[pos:end], end


def _decode_pfm(data: bytes, grayscale: bool, path: str) -> np.ndarray:
    """PFMDecoder: ``PF`` (RGB) or ``Pf`` (grey) and a line break, then width,
    height and scale, each ended by one whitespace byte (atoi, atoi, atof);
    rows bottom to top, little-endian where the scale is negative.  A
    3-channel file reads only in colour and a 1-channel one only in grey
    (OpenCV 5.0 fails the other mode); a scale of 0 or NaN fails."""
    if data[2:3] != b"\n":
        raise _Unreadable("a PFM magic number not followed by a line break")
    nch = 3 if data[1:2] == b"F" else 1
    text, pos = _pfm_field(data, 3)
    w = _c_int(text)
    text, pos = _pfm_field(data, pos)
    h = _c_int(text)
    text, pos = _pfm_field(data, pos)
    scale = _c_float(text)
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20) or w * h > _MAX_PIXELS:
        raise ValueError(f"{path}: a PFM of {w}x{h}, past OpenCV's limits (cv2.imread raises)")
    if scale == 0 or math.isnan(scale):
        raise _Unreadable(f"a PFM scale of {scale}")
    if (nch == 3) == grayscale:
        raise _Unreadable("a PFM read in the other mode than its channels (OpenCV 5.0 fails)")
    n = w * h * nch * 4
    if pos + n > len(data):
        raise _Unreadable("the PFM ends early (truncated)")
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h * nch, pos)
    with np.errstate(invalid="ignore", over="ignore"):  # inf * 0, NaN: 0 as cvRound gives
        out = _u8_of_float(v * np.float32(1.0 / abs(scale))).reshape(h, w, nch)[::-1]
    return np.ascontiguousarray(out[..., ::-1] if nch == 3 else out[..., 0])


def _fgets(data: bytes, pos: int):
    """``fgets`` into a 128-byte buffer: (the C string, the next position),
    or (None, pos) at the end of the file."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    chunk = data[pos:end + 1] if end >= 0 else data[pos:pos + 127]
    return chunk.split(b"\0")[0], pos + len(chunk)


def _hdr_lib() -> ctypes.CDLL:
    lib = build.load("decode_hdr")
    if not getattr(lib, "_fots_typed", False):
        i64 = ctypes.c_int64
        lib.fots_hdr_pixels.restype = ctypes.c_int
        lib.fots_hdr_pixels.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64, i64, i64, i64,
                                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
                                        ctypes.c_int]
        lib._fots_typed = True
    return lib


def _decode_hdr(data: bytes, grayscale: bool, path: str) -> np.ndarray:
    """RGBE_ReadHeader (without its header-info argument: the first line is
    one of the lines searched), then the pixels: lines up to exactly
    ``FORMAT=32-bit_rle_rgbe`` (an empty line or ``xyze`` fails), an empty
    line, and ``-Y h +X w`` (the only orientation read; sscanf's whitespace
    rules).  Each RGBE pixel is R, G, B times 2^(E - 136) in float (0 where
    E is 0), stored B, G, R and converted times 255; grey is
    ``cvtColor(BGR2GRAY)`` of the 8-bit colour image."""
    line, pos = _fgets(data, 0)
    while True:
        if line is None:
            raise _Unreadable("the HDR ends inside its header (truncated)")
        if line[:1] in (b"", b"\n"):
            raise _Unreadable("no FORMAT=32-bit_rle_rgbe line in the HDR header")
        if line == _HDR_FORMAT:
            break
        line, pos = _fgets(data, pos)
    line, pos = _fgets(data, pos)
    if line != b"\n":
        raise _Unreadable("no empty line after the HDR's FORMAT line")
    line, pos = _fgets(data, pos)
    m = _HDR_SIZE.match(line or b"")
    if not m:
        raise _Unreadable("no '-Y h +X w' resolution line in the HDR header")
    h, w = _c_int(m.group(1)), _c_int(m.group(2))
    if w <= 0 or h <= 0:
        raise _Unreadable(f"an HDR of {w}x{h}")
    if w > 1 << 20 or h > 1 << 20 or w * h > _MAX_PIXELS:
        raise ValueError(f"{path}: an HDR of {w}x{h}, past OpenCV's limits (cv2.imread raises)")
    src = np.frombuffer(data, np.uint8)
    rgbe = np.empty((h, w, 4), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _checked(_hdr_lib().fots_hdr_pixels(_u8(src), src.size, pos, w, h, _u8(rgbe), err, _ERR_LEN),
             err, path)
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136), np.float32(0)).astype(np.float32)
    with np.errstate(over="ignore"):  # past float: 0 as cvRound gives
        bgr = _u8_of_float(rgbe[..., 2::-1].astype(np.float32) * f[..., None] * np.float32(255))
    if grayscale:  # cvtColor(BGR2GRAY) of 8-bit pixels: 15-bit fixed point, rounded
        b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
        return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(np.uint8)
    return bgr


def imread(path: str, grayscale: bool = False) -> Optional[np.ndarray]:
    """``cv2.imread(path)`` (u8 [H, W, 3] BGR) or, with ``grayscale``,
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (u8 [H, W]) of a JPEG, PNG,
    BMP, GIF, TIFF, WebP, Netpbm, Sun raster, PFM, Radiance HDR or JPEG 2000
    file.
    None where ``cv2.imread`` gives None: a file that cannot be opened,
    whose signature is no format ``cv2`` reads, or that its decoder fails on
    (a JPEG cut before its first scan's data, a corrupt or truncated file of
    the other formats, a PFM read in the other mode than its channels).
    ``ValueError``, naming the file and the format, for a file of the other
    format ``cv2`` reads (AVIF), a coding the port does not decode (JPEG
    2000's HT code-blocks and Part 2 transforms), or an image past OpenCV's
    size limits (``cv2.imread`` raises for it)."""
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
        elif data.startswith(JP2_SIGNATURES):
            im, orientation = _decode_whole("decode_jp2", "fots_jp2", data, grayscale, str(path))
        elif data.startswith(BMP_SIGNATURE):
            im, orientation = _decode_whole("decode_bmp", "fots_bmp", data, grayscale, str(path))
        elif data.startswith(GIF_SIGNATURE):
            im, orientation = _decode_whole("decode_gif", "fots_gif", data, grayscale, str(path))
        elif data[:4] in TIFF_SIGNATURES:
            try:
                im, orientation = _decode_tiff(data, grayscale, str(path)), 1
            except (struct.error, IndexError, OverflowError) as e:  # a damaged directory
                raise _Unreadable(str(e)) from None
        elif data.startswith(SUNRAS_SIGNATURE):
            im, orientation = _decode_whole("decode_sunras", "fots_sunras", data, grayscale,
                                            str(path))
        elif data.startswith(HDR_SIGNATURES):
            im, orientation = _decode_hdr(data, grayscale, str(path)), 1
        elif len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"Ff" and data[2:3] in _SPACE:
            im, orientation = _decode_pfm(data, grayscale, str(path)), 1
        else:
            if _is_webp(data):
                im, orientation = _decode_webp(data, grayscale, str(path))
            elif len(data) >= 3 and data[:1] == b"P" and data[2:3] in _SPACE and (
                    data[1:2] in b"1234567"):
                try:
                    im, orientation = _decode_netpbm(data, grayscale), 1
                except (IndexError, ValueError) as e:  # the stream ends, or a bad number
                    if isinstance(e, _Oversize):
                        raise ValueError(f"{path}: {e}") from None
                    raise _Unreadable(str(e)) from None
            else:
                other = _other_format(data)
                if other:
                    raise ValueError(f"{path}: the {other} format (cv2.imread reads it; the "
                                     f"port decodes {_DECODED})")
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
