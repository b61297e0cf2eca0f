"""JPEG 2000 against ``cv2.imread``, byte for byte in colour (BGR) and
grayscale, read by ``fots_torch.imageio.imread`` as OpenCV 5.0 reads it
through OpenJPEG 2.5 (``fots_torch/csrc/decode_jp2.cpp``):

- ``cv2.imwrite``'s JP2 files, lossless and at lower rates (9/7 and ICT);
- Pillow's (OpenJPEG 2.5.4) files and raw codestreams: every progression
  order, resolutions, code-block and precinct sizes, tiles, quality layers,
  the irreversible transform, MCT, PLT, grey, grey with alpha, RGBA, 16 bits;
- files of OpenJPEG's own encoder driven here through ctypes (``opj_encode``,
  the library inside Pillow's wheel) for what Pillow does not expose: every
  code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), SOP / EPH,
  ROI max-shift, POC, tile-parts by resolution, layer and component,
  precisions of 9-16 bits, 2 and 4 components, and what OpenCV refuses
  (signed and sub-sampled components, an image offset, under 8 bits);
- packet headers moved into PPT and PPM markers (``moved_headers``);
- JP2 boxes written here (``jp2_file``): palettes (pclr / cmap), channel
  definitions, sYCC, ICC, EYCC and CMYK colour specifications, misplaced and
  damaged boxes;
- cut and damaged files: what OpenJPEG (strict) decodes or refuses;
- the detection and crop readers of ``fots`` and the port over JP2 files,
  codestreams and the new TIFF codings: byte-equal samples.
"""

import ctypes
import glob
import io
import os
import struct
import tempfile

import cv2
import numpy as np
import pytest
import PIL
from PIL import Image

from fots_torch.imageio import imread
from tests.test_torch_port_imageio import scene
from tests.test_torch_port_imageio_bmp_gif import assert_cuts, assert_same

# --------------------------------------------------------------------------
# writers
# --------------------------------------------------------------------------


def pil_jp2(im, **kw):
    """Pillow's JPEG 2000 of a BGR or grey image (a JP2 file, or with
    ``no_jp2`` a raw codestream)."""
    buf = io.BytesIO()
    Image.fromarray(im[..., ::-1].copy() if im.ndim == 3 else im).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def cv2_jp2(tmp_path, im, rate=None):
    """``cv2.imwrite``'s JP2 (lossless, or ``IMWRITE_JPEG2000_COMPRESSION_X1000``)."""
    path = str(tmp_path / "w.jp2")
    assert cv2.imwrite(path, im, [] if rate is None else
                       [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, rate])
    with open(path, "rb") as f:
        return f.read()


_OPJ = []


def _opj():
    """OpenJPEG 2.5 of Pillow's wheel (``pillow.libs/libopenjp2-*.so``)."""
    if not _OPJ:
        found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                       "libopenjp2-*.so*"))
        lib = ctypes.CDLL(found[0])
        for name in ("opj_create_compress", "opj_image_create",
                     "opj_stream_create_default_file_stream"):
            getattr(lib, name).restype = ctypes.c_void_p
        _OPJ.append(lib)
    return _OPJ[0]


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp",
                                               "sgnd", "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _OpjImage(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32), ("x1", ctypes.c_uint32),
                ("y1", ctypes.c_uint32), ("numcomps", ctypes.c_uint32),
                ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_ImageComp)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


# byte offsets in OpenJPEG 2.5's opj_cparameters_t (x86-64): checked against
# opj_set_default_encoder_parameters' defaults in test_encoder_parameters
_P_TILES, _P_DISTO, _P_CSTY, _P_POC, _P_NUMPOCS = 0, 20, 48, 56, 4792
_P_RATES, _P_NUMRES, _P_ROI, _P_PRC, _P_TP_ON, _P_MCT = 4800, 5600, 5620, 5632, 18696, 18698
_POC_SIZE = 148


def _defaults():
    buf = ctypes.create_string_buffer(1 << 16)
    _opj().opj_set_default_encoder_parameters(buf)
    return buf


def opj_encode(planes, prec=8, sgnd=False, sub=None, origin=(0, 0), numres=6, cblk=(64, 64),
               mode=0, irreversible=False, mct=0, csty=0, prog=0, precincts=None, tiles=None,
               rates=(0,), roi=None, pocs=(), tile_parts=None):
    """A raw codestream of OpenJPEG 2.5's encoder from integer planes (one a
    component, each ``sub``-sampled, of ``prec`` bits: one for all, or one
    a component, which writes QCC markers): ``mode`` the code-block style bits,
    ``csty`` 2 SOP and 4 EPH, ``prog`` LRCP..CPRL as 0..4, ``rates`` one
    per layer (0 lossless), ``roi`` (component, shift), ``pocs`` (resno0,
    compno0, layno1, resno1, compno1, order) in the tile header,
    ``tile_parts`` "R", "L" or "C"."""
    lib = _opj()
    n = len(planes)
    sub = sub or [(1, 1)] * n
    x0, y0 = origin
    parms = (_CmptParm * n)()
    precs = list(prec) if isinstance(prec, (list, tuple)) else [prec] * n
    for i, p in enumerate(planes):
        dx, dy = sub[i]
        parms[i] = _CmptParm(dx, dy, p.shape[1], p.shape[0], -(-x0 // dx), -(-y0 // dy),
                             precs[i], precs[i], int(sgnd))
    img = ctypes.cast(lib.opj_image_create(n, parms, 1 if n >= 3 else 2),
                      ctypes.POINTER(_OpjImage))
    im = img.contents
    im.x0, im.y0 = x0, y0
    im.x1, im.y1 = x0 + planes[0].shape[1] * sub[0][0], y0 + planes[0].shape[0] * sub[0][1]
    for i, p in enumerate(planes):
        flat = np.ascontiguousarray(p, np.int32).ravel()
        ctypes.memmove(im.comps[i].data, flat.ctypes.data, flat.nbytes)
    b = _defaults()

    def put(off, fmt, *v):
        struct.pack_into("<" + fmt, b, off, *v)
    if tiles:
        put(_P_TILES, "iiiii", 1, tiles[2], tiles[3], tiles[0], tiles[1])
    put(_P_DISTO, "i", 1)
    put(_P_CSTY, "ii", csty | (1 if precincts else 0), prog)
    for k, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        off = _P_POC + _POC_SIZE * k
        put(off, "IIIII", r0, c0, l1, r1, c1)
        put(off + 32, "II", prg, prg)
        put(off + 48, "I", 1)  # the tile, counted from 1
    put(_P_NUMPOCS, "Ii", len(pocs), len(rates))
    for k, r in enumerate(rates):
        put(_P_RATES + 4 * k, "f", r)
    put(_P_NUMRES, "iiiii", numres, cblk[0], cblk[1], mode, int(irreversible))
    if roi:
        put(_P_ROI, "ii", *roi)
    if precincts:
        put(_P_ROI + 8, "i", len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            put(_P_PRC + 4 * k, "i", pw)
            put(_P_PRC + 132 + 4 * k, "i", ph)
    if tile_parts:
        put(_P_TP_ON, "bb", 1, ord(tile_parts))
    put(_P_MCT, "b", mct)
    codec = ctypes.c_void_p(lib.opj_create_compress(0))
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        ok = lib.opj_setup_encoder(codec, b, img)
        stream = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(path.encode(), 0))
        ok = ok and lib.opj_start_compress(codec, img, stream)
        ok = ok and lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream)
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        assert ok, "OpenJPEG failed to encode"
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def box(kind, payload):
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_file(codestream, h, w, nc, bpc=7, colr=16, icc=None, pclr=None, cmap=None, cdef=None,
             extra=b"", after=b""):
    """A JP2 file around a codestream: ``colr`` an enumerated colour space
    (or None), ``icc`` an ICC profile (method 2), ``pclr`` (bytes of each
    entry's columns: [[...], ...], column depths), ``cmap`` [(cmp, mtyp,
    pcol)], ``cdef`` [(cn, typ, asoc)]; ``extra`` boxes inside jp2h,
    ``after`` boxes after the codestream."""
    head = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    if icc is not None:
        head += box(b"colr", bytes([2, 0, 0]) + icc)
    elif colr is not None:
        head += box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", colr))
    if pclr is not None:
        entries, depths = pclr
        body = struct.pack(">HB", len(entries), len(depths)) + bytes(d - 1 for d in depths)
        for e in entries:
            for v, d in zip(e, depths):
                body += int(v).to_bytes((d + 7) // 8, "big")
        head += box(b"pclr", body)
    if cmap is not None:
        head += box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in cmap))
    if cdef is not None:
        head += box(b"cdef", struct.pack(">H", len(cdef))
                    + b"".join(struct.pack(">HHH", *d) for d in cdef))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + box(b"jp2h", head + extra) + box(b"jp2c", codestream) + after)


def moved_headers(codestream, where):
    """The single-tile codestream (written with SOP and EPH) with its packet
    headers moved into PPT markers in the tile-part header (``where`` "ppt")
    or PPM markers in the main header ("ppm"): a packet's header runs from
    after its SOP through its EPH, which travels with it."""
    sot = codestream.index(b"\xff\x90")
    sod = codestream.index(b"\xff\x93", sot)
    data = codestream[sod + 2:codestream.rindex(b"\xff\xd9")]
    headers, bodies = b"", b""
    for packet in data.split(b"\xff\x91")[1:]:
        eph = packet.index(b"\xff\x92", 4) + 2
        headers += packet[4:eph]
        bodies += b"\xff\x91" + packet[:4] + packet[eph:]
    tile_header = codestream[sot + 12:sod]
    if where == "ppt":
        marker = []
        for z, at in enumerate(range(0, len(headers), 60000)):
            part = headers[at:at + 60000]
            marker.append(b"\xff\x61" + struct.pack(">HB", 3 + len(part), z) + part)
        tile_header += b"".join(marker)
        main = codestream[:sot]
    else:
        ippm = struct.pack(">I", len(headers)) + headers
        main = codestream[:sot] + b"\xff\x60" + struct.pack(">HB", 3 + len(ippm), 0) + ippm
    psot = 12 + len(tile_header) + 2 + len(bodies)
    return (main + b"\xff\x90" + struct.pack(">HHIBB", 10, 0, psot, 0, 1) + tile_header
            + b"\xff\x93" + bodies + b"\xff\xd9")


def planes_of(im):
    """R, G, B planes of a BGR image."""
    return [im[..., 2], im[..., 1], im[..., 0]]


def _write(tmp_path, data, name="x.jp2"):
    path = tmp_path / name
    path.write_bytes(data)
    return path


# --------------------------------------------------------------------------
# cv2's and Pillow's files
# --------------------------------------------------------------------------

def test_encoder_parameters():
    """The offsets ``opj_encode`` writes hold opj_set_default_encoder_parameters'
    defaults: 6 resolutions, 64 x 64 code-blocks, no ROI (-1), sub-sampling
    1 / 1 and unset formats (-1) before the error-protection block."""
    raw = _defaults().raw
    assert struct.unpack_from("<iiiiii", raw, _P_NUMRES) == (6, 64, 64, 0, 0, -1)
    assert struct.unpack_from("<iiii", raw, 18196) == (1, 1, -1, -1)
    assert raw[_P_TP_ON:_P_MCT + 1] == b"\0\0\0"


@pytest.mark.parametrize("rate", [None, 1000, 500, 100, 20])
def test_cv2_jp2_decodes_as_cv2(tmp_path, rate):
    """cv2.imwrite's JP2 (lossless 5/3 with RCT at its default, 9/7 with ICT
    below 1000) of a scene and of a grey image."""
    for im in (scene(45, 67, seed=1), scene(36, 40, seed=2)[..., 1]):
        assert_same(_write(tmp_path, cv2_jp2(tmp_path, im, rate)))


_PIL_OPTIONS = [
    dict(), dict(no_jp2=True), dict(irreversible=True), dict(irreversible=True, mct=1),
    dict(mct=1), dict(progression="RLCP"), dict(progression="RPCL"), dict(progression="PCRL"),
    dict(progression="CPRL"), dict(num_resolutions=1), dict(num_resolutions=3,
                                                            codeblock_size=(16, 16)),
    dict(codeblock_size=(4, 8), num_resolutions=4), dict(precinct_size=(32, 32),
                                                         codeblock_size=(8, 8)),
    dict(precinct_size=(64, 64), codeblock_size=(16, 16), progression="RPCL"),
    dict(precinct_size=(32, 32), codeblock_size=(8, 8), progression="PCRL", num_resolutions=4),
    dict(precinct_size=(32, 32), codeblock_size=(8, 8), progression="CPRL", tile_size=(40, 40)),
    dict(tile_size=(16, 16), num_resolutions=4),
    dict(tile_size=(30, 25), irreversible=True, num_resolutions=3),
    dict(quality_layers=[80, 40, 20], quality_mode="rates"),
    dict(quality_layers=[30, 40, 50], quality_mode="dB", irreversible=True),
    dict(plt=True), dict(offset=(8, 4), tile_offset=(2, 2), tile_size=(32, 32)),
]


@pytest.mark.parametrize("k", range(len(_PIL_OPTIONS)))
def test_pillow_jp2_decodes_as_cv2(tmp_path, k):
    """Pillow's files at its options (an image offset: None in both)."""
    assert_same(_write(tmp_path, pil_jp2(scene(67, 91, seed=k), **_PIL_OPTIONS[k])))


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "I;16"])
def test_pillow_modes_decode_as_cv2(tmp_path, mode):
    """Grey, grey and alpha, RGBA and 16-bit grey, as JP2 and as raw
    codestreams (one or two components of a codestream read in colour:
    None, as OpenCV's sRGB conversion refuses them)."""
    im = scene(37, 53, seed=5)
    src = Image.fromarray(im[..., ::-1].copy()).convert(mode) if mode != "I;16" else \
        Image.fromarray(im[..., 0].astype(np.uint16) * 257 + 3)
    for kw in (dict(), dict(no_jp2=True)):
        buf = io.BytesIO()
        src.save(buf, "JPEG2000", **kw)
        assert_same(_write(tmp_path, buf.getvalue()))


# --------------------------------------------------------------------------
# OpenJPEG's encoder: code-block styles, markers, precision, components
# --------------------------------------------------------------------------

_OPJ_CASES = [
    dict(mode=1), dict(mode=2), dict(mode=4), dict(mode=8), dict(mode=16), dict(mode=32),
    dict(mode=63), dict(mode=1, irreversible=True, rates=(20, 10, 5)),
    dict(mode=4 | 16, rates=(30, 8)), dict(mode=8 | 32, irreversible=True, mct=1),
    dict(csty=6), dict(csty=2, prog=2), dict(csty=4, rates=(20, 6)),
    dict(roi=(0, 5)), dict(roi=(1, 9), irreversible=True, mct=1),
    dict(pocs=[(0, 0, 1, 3, 3, 1), (3, 0, 1, 6, 3, 2)]),
    dict(pocs=[(0, 0, 2, 6, 1, 0), (0, 1, 2, 6, 3, 4)], rates=(20, 5)),
    dict(pocs=[(0, 0, 3, 2, 3, 3), (2, 0, 3, 6, 3, 0)], rates=(40, 20, 5),
         precincts=[(32, 32)] * 6, cblk=(16, 16)),
    dict(tile_parts="R", tiles=(32, 32, 0, 0)), dict(tile_parts="L", rates=(20, 10, 1)),
    dict(tile_parts="C", mct=1), dict(cblk=(4, 1024)), dict(cblk=(1024, 4), numres=2),
    dict(cblk=(4, 4), precincts=[(8, 8)] * 6), dict(numres=1, mode=63),
    dict(tiles=(20, 14, 0, 0), prog=4, mct=1, irreversible=True, numres=3),
]


@pytest.mark.parametrize("k", range(len(_OPJ_CASES)))
def test_opj_styles_decode_as_cv2(tmp_path, k):
    """Code-block styles, SOP / EPH, ROI, POC, tile-parts, code-block and
    precinct sizes of OpenJPEG's encoder, colour and grey."""
    im = scene(45, 61, seed=10 + k)
    assert_same(_write(tmp_path, opj_encode(planes_of(im), **_OPJ_CASES[k])))
    assert_same(_write(tmp_path, opj_encode(planes_of(im)[1:2], **{
        key: v for key, v in _OPJ_CASES[k].items() if key not in ("mct", "roi", "pocs")})))


@pytest.mark.parametrize("prec", [9, 10, 12, 16, 4, 7])
def test_precisions_decode_as_cv2(tmp_path, prec):
    """Components of 9-16 bits (shifted right to 8 by OpenCV), reversible
    and irreversible, and mixed with 8- and 12-bit ones (QCC markers);
    under 8 bits None."""
    im = scene(45, 61, seed=prec)
    rng = np.random.default_rng(prec)
    planes = [(p.astype(np.int64) << max(prec - 8, 0) >> max(8 - prec, 0))
              + rng.integers(0, 1 << max(prec - 8, 0), p.shape) for p in planes_of(im)]
    for kw in (dict(), dict(irreversible=True, mct=1)):
        assert_same(_write(tmp_path, opj_encode(planes, prec=prec, **kw)))
    assert_same(_write(tmp_path, opj_encode(planes[:1], prec=prec)))
    # components of 8, 12 and the case's bits (QCC): all shifted by the largest
    mixed = [planes_of(im)[0], planes_of(im)[1].astype(np.int64) * 16 + 5, planes[2]]
    for kw in (dict(), dict(irreversible=True, rates=(20,))):
        path = _write(tmp_path, opj_encode(mixed, prec=[8, 12, prec], **kw))
        assert b"\xff\x5d" in path.read_bytes()
        assert_same(path)


def test_components_decode_as_cv2(tmp_path):
    """Four components (the fourth dropped), two (grey read only), and the
    component layouts OpenCV refuses: signed, sub-sampled, an image offset."""
    im = scene(45, 61, seed=3)
    p = planes_of(im)
    for planes, kw in ((p + [p[0] // 2], {}), (p[:2], {}),
                       ([x.astype(int) - 128 for x in p], dict(sgnd=True)),
                       ([p[0], p[1][::2, ::2], p[2][::2, ::2]],
                        dict(sub=[(1, 1), (2, 2), (2, 2)])),
                       (p, dict(origin=(5, 3)))):
        path = _write(tmp_path, opj_encode(planes, **kw))
        assert_same(path)
    assert cv2.imread(str(path)) is None


@pytest.mark.parametrize("where", ["ppt", "ppm"])
def test_moved_packet_headers_decode_as_cv2(tmp_path, where):
    """Packet headers in PPT (tile-part header) and PPM (main header)
    markers, of one and of several layers and code-block styles."""
    im = scene(45, 61, seed=21)
    for kw in (dict(), dict(rates=(30, 10, 2), mode=63), dict(irreversible=True, mct=1)):
        cs = opj_encode(planes_of(im), csty=6, **kw)
        moved = moved_headers(cs, where)
        assert (b"\xff\x61" if where == "ppt" else b"\xff\x60") in moved
        path = _write(tmp_path, moved)
        assert cv2.imread(str(path)) is not None
        assert_same(path)


def _segment(cs, marker):
    at = cs.index(marker)
    return cs[at:at + 2 + struct.unpack(">H", cs[at + 2:at + 4])[0]]


def test_marker_segments_as_cv2(tmp_path):
    """Marker segments added to a codestream's main header (a COC and a QCC
    restating COD / QCD, a second COD or QCD, COM, TLM valid, short or of ST
    3, CRG right or short, PLM, RGN of any Srgn or past the components, a
    short POC, an empty PPM, unknown markers that OpenJPEG scans past two
    bytes at a time, SOP out of place) and to its tile-part header (COD,
    two CODs or QCDs, COM, PLT whole or cut, an unknown marker, TLM)."""
    cs = opj_encode(planes_of(scene(45, 61, seed=3)), irreversible=True)
    sot, sod = cs.index(b"\xff\x90"), cs.index(b"\xff\x93")
    cod, qcd = _segment(cs, b"\xff\x52"), _segment(cs, b"\xff\x5c")
    coc = b"\xff\x53" + struct.pack(">HBB", 4 + len(cod) - 9, 1, cod[4] & 1) + cod[9:]
    qcc = b"\xff\x5d" + struct.pack(">HB", len(qcd) - 1, 2) + qcd[4:]

    def main(extra):
        return cs[:sot] + extra + cs[sot:]

    def tile(extra):
        psot = struct.unpack(">I", cs[sot + 6:sot + 10])[0]
        return (cs[:sot + 6] + struct.pack(">I", psot + len(extra)) + cs[sot + 10:sod] + extra
                + cs[sod:])
    files = [main(coc), main(qcc), main(cod), main(qcd), main(b"\xff\x64\x00\x08\x00\x01abcd"),
             main(b"\xff\x55\x00\x06\x00\x00\x00\x00"), main(b"\xff\x55\x00\x07" + bytes(5)),
             main(b"\xff\x55\x00\x03\x00"), main(b"\xff\x55\x00\x06\x00\x30\x00\x00"),
             main(b"\xff\x63\x00\x0e" + bytes(12)), main(b"\xff\x63\x00\x06" + bytes(4)),
             main(b"\xff\x57\x00\x03\x00"), main(b"\xff\x5e\x00\x05\x00\x00\x07"),
             main(b"\xff\x5e\x00\x05\x00\x01\x07"), main(b"\xff\x5e\x00\x05\x07\x00\x07"),
             main(b"\xff\x5f\x00\x05\x00\x00\x00"), main(b"\xff\x60\x00\x02"),
             main(b"\xff\x30\x00\x04\x12\x34"), main(b"\xff\x3f\x00\x06\xff\x93\xab\xcd"),
             main(b"\xff\x91\x00\x04\x00\x00"), tile(cod), tile(cod + cod), tile(qcd + qcd),
             tile(b"\xff\x64\x00\x06\x00\x01ab"), tile(b"\xff\x58\x00\x04\x00\x05"),
             tile(b"\xff\x58\x00\x04\x00\x85"), tile(b"\xff\x30\x00\x04\x00\x00"),
             tile(b"\xff\x55\x00\x06\x00\x00\x00\x00")]
    read = []
    for data in files:
        path = _write(tmp_path, data)
        assert_same(path)
        read.append(cv2.imread(str(path)) is not None)
    assert sum(read) == 19 and not read[7] and not read[-1]


def test_part2_markers_as_cv2_or_refused(tmp_path):
    """Part 2's multi-component transform markers in the main and tile-part
    headers: the ones OpenJPEG rejects (too short, a CBD of the wrong
    count) are None and the ones it ignores read as cv2 reads them; an MCC
    collection or an MCO stage, which the port does not apply, raises
    ValueError naming Part 2."""
    cs = opj_encode(planes_of(scene(45, 61, seed=3)), irreversible=True)
    sot, sod = cs.index(b"\xff\x90"), cs.index(b"\xff\x93")

    def placed(marker, body):
        seg = bytes([0xFF, marker]) + struct.pack(">H", 2 + len(body)) + body
        psot = struct.unpack(">I", cs[sot + 6:sot + 10])[0]
        return [cs[:sot] + seg + cs[sot:],
                cs[:sot + 6] + struct.pack(">I", psot + len(seg)) + cs[sot + 10:sod] + seg
                + cs[sod:]]
    same = [(0x74, b""), (0x74, bytes(6)), (0x74, b"\x00\x01" + bytes(4)),
            (0x74, bytes(range(12))), (0x75, bytes(5)), (0x75, bytes(7)),
            (0x75, b"\x00\x00\x00\x00\x00\x00\x01"), (0x75, b"\x00\x00\x00\x00\x00\x00\x03"),
            (0x77, b""), (0x77, bytes(2)), (0x77, b"\x00"), (0x77, b"\x02\x00"),
            (0x78, bytes(5)), (0x78, bytes(4))]
    for marker, body in same:
        for data in placed(marker, body):
            assert_same(_write(tmp_path, data))
    for marker, body in ((0x77, b"\x01\x00"), (0x75, bytes(6) + b"\x01\x01\x00\x03")):
        for data in placed(marker, body):
            path = _write(tmp_path, data)
            for gray in (False, True):
                with pytest.raises(ValueError) as e:
                    imread(str(path), grayscale=gray)
                assert "Part 2" in str(e.value) and str(path) in str(e.value)


# --------------------------------------------------------------------------
# JP2 boxes
# --------------------------------------------------------------------------

def _grey_codestream(h=36, w=44, seed=0, top=256):
    rng = np.random.default_rng(seed)
    return opj_encode([rng.integers(0, top, (h, w))]), h, w


def test_palette_decodes_as_cv2(tmp_path):
    """pclr and cmap: an 8-bit index into 3 columns of 8 bits (and of 5 and
    12 bits), indices past the entries clamped; direct use of a component."""
    rng = np.random.default_rng(1)
    cs, h, w = _grey_codestream()
    entries = rng.integers(0, 256, (200, 3))
    cases = [
        dict(pclr=(entries.tolist(), [8, 8, 8]), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
        dict(pclr=((entries >> 3).tolist(), [5, 8, 8]), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
        dict(pclr=((entries * 16).tolist(), [12, 12, 12]),
             cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
        dict(pclr=(entries[:, :2].tolist(), [8, 8]), cmap=[(0, 1, 0), (0, 1, 1)]),
        dict(pclr=(entries.tolist(), [8, 8, 8]), cmap=[(0, 0, 0), (0, 1, 1), (0, 1, 2)]),
        dict(pclr=(entries.tolist(), [8, 8, 8])),  # no cmap: the palette is ignored
        dict(pclr=(entries.tolist(), [8, 8, 8]), cmap=[(0, 1, 0), (0, 1, 0), (0, 1, 2)]),
        dict(pclr=(entries.tolist(), [8, 8, 8]), cmap=[(1, 1, 0), (0, 1, 1), (0, 1, 2)]),
    ]
    read = []
    for kw in cases:
        path = _write(tmp_path, jp2_file(cs, h, w, 1, **kw))
        assert_same(path)
        read.append(cv2.imread(str(path)) is not None)
    # two columns make two components, which OpenCV's sRGB path reads in grey only
    assert read[:3] == [True] * 3 and read[3:5] == [False, True] and read[-2:] == [False, False]


def test_colour_specifications_decode_as_cv2(tmp_path):
    """sRGB, grey (component 0 copied), sYCC (cvtColor YUV2BGR), unknown
    and ICC colour spaces (sRGB assumed), EYCC and CMYK (None), a second
    colr ignored, channel definitions that swap components or mark alpha,
    and ones OpenJPEG rejects."""
    im = scene(36, 44, seed=4)
    cs = opj_encode(planes_of(im))
    cs4 = opj_encode(planes_of(im) + [im[..., 0]])
    h, w = im.shape[:2]
    cases = [
        (cs, 3, dict(colr=16)), (cs, 3, dict(colr=17)), (cs, 3, dict(colr=18)),
        (cs, 3, dict(colr=99)), (cs, 3, dict(icc=b"\0" * 40)), (cs, 3, dict(colr=24)),
        (cs, 3, dict(colr=12)), (cs, 3, dict(colr=None)),
        (cs, 3, dict(extra=box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 17)))),
        (cs, 3, dict(cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)])),
        (cs, 3, dict(cdef=[(0, 0, 1), (1, 0, 2), (2, 1, 0)])),
        (cs4, 4, dict(cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])),
        (cs4, 4, dict(cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 65535)])),
        (cs, 3, dict(cdef=[(0, 0, 1), (1, 0, 2)])),
        (cs, 3, dict(cdef=[(0, 0, 1), (1, 0, 2), (5, 0, 3)])),
    ]
    for codestream, nc, kw in cases:
        assert_same(_write(tmp_path, jp2_file(codestream, h, w, nc, **kw)))


def test_boxes_decode_as_cv2(tmp_path):
    """Boxes after the codestream, unknown boxes, a codestream box to the
    end of the file (length 0), an XL length; the layouts OpenJPEG refuses
    (no jp2h, ftyp out of place, an ihdr size that disagrees with SIZ) and
    the ones it reads (an ihdr component count that disagrees, ihdr after
    colr)."""
    im = scene(36, 44, seed=6)
    cs = opj_encode(planes_of(im))
    h, w = im.shape[:2]
    good = jp2_file(cs, h, w, 3)
    sig, ftyp = box(b"jP  ", b"\r\n\x87\n"), box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    head = box(b"jp2h", box(b"ihdr", struct.pack(">IIHBBBB", h, w, 3, 7, 7, 0, 0))
               + box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 16)))
    files = [
        good, good + box(b"xml ", b"<a/>"), good + b"garbage",
        sig + ftyp + box(b"uuid", b"\0" * 20) + head + box(b"jp2c", cs),
        sig + ftyp + head + struct.pack(">I", 0) + b"jp2c" + cs,
        sig + ftyp + head + struct.pack(">I", 1) + b"jp2c" + struct.pack(">Q", 16 + len(cs)) + cs,
        sig + ftyp + box(b"jp2c", cs),
        sig + head + ftyp + box(b"jp2c", cs),
        jp2_file(cs, h + 1, w, 3), jp2_file(cs, h, w, 1),
        sig + ftyp + box(b"jp2h", box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 16))
                         + box(b"ihdr", struct.pack(">IIHBBBB", h, w, 3, 7, 7, 0, 0)))
        + box(b"jp2c", cs),
        ftyp + sig + head + box(b"jp2c", cs),
    ]
    read = []
    for data in files:
        path = _write(tmp_path, data)
        assert_same(path)
        read.append(cv2.imread(str(path)) is not None)
    assert read == [True] * 6 + [False] * 3 + [True, True, False]


# --------------------------------------------------------------------------
# cut and damaged files
# --------------------------------------------------------------------------

def _damaged_sources(tmp_path):
    im = scene(40, 52, seed=7)
    return [cv2_jp2(tmp_path, im), cv2_jp2(tmp_path, im, 60),
            pil_jp2(im, no_jp2=True, quality_layers=[40, 10], progression="RPCL",
                    precinct_size=(32, 32), codeblock_size=(8, 8)),
            opj_encode(planes_of(im), mode=63, csty=6, rates=(30, 6)),
            opj_encode(planes_of(im), tiles=(24, 24, 0, 0), tile_parts="R", irreversible=True,
                       numres=3, mct=1)]


@pytest.mark.parametrize("k", range(5))
def test_cut_files_as_cv2(tmp_path, k):
    """Files cut at 24 places: a tile-part longer than the data is None
    (strict), a stream cut right after its last tile's data decodes."""
    data = _damaged_sources(tmp_path)[k]
    assert_cuts(tmp_path / "cut.jp2", data, points=24)
    end = data.rindex(b"\xff\xd9")
    for cut in (end, end + 1):
        assert_same(_write(tmp_path, data[:cut]))


@pytest.mark.parametrize("k", range(5))
def test_damaged_files_as_cv2(tmp_path, k):
    """Files with 1-3 bytes replaced anywhere (headers, packet headers,
    code-block data): cv2's image, or None."""
    data = _damaged_sources(tmp_path)[k]
    rng = np.random.default_rng(100 + k)
    for _ in range(30):
        d = bytearray(data)
        for at in rng.integers(0, len(d), rng.integers(1, 4)):
            d[at] = int(rng.integers(256)) if rng.random() < 0.5 else d[at] ^ (1 << int(
                rng.integers(8)))
        assert_same(_write(tmp_path, bytes(d)))


def test_jp2_found_by_content(tmp_path):
    """A JP2 file and a codestream under .jpg and .png names are still
    JPEG 2000, as cv2 finds them."""
    im = scene(36, 44, seed=8)
    for data, name in ((cv2_jp2(tmp_path, im), "a.jpg"), (pil_jp2(im, no_jp2=True), "b.png")):
        assert_same(_write(tmp_path, data, name))


# --------------------------------------------------------------------------
# the readers over JPEG 2000 and the new TIFF codings
# --------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_detection_readers_over_jp2_equal_fots(tmp_path):
    """``fots.data.detection`` (cv2.imread) and the port's reader over four
    scenes as lossless JP2, 9/7 JP2 under a .jpg name, a raw codestream and
    an old-style LZW TIFF: byte-equal samples."""
    import shutil

    from fots.data.detection import detection_generator as fots_generator
    from fots_torch.data.detection import detection_generator
    from tests.test_torch_port_imageio_tiff import tiff_bytes

    synth = os.path.join(_REPO, "data", "synth")
    paths = []
    for k, form in enumerate(("jp2", "jpg", "j2k", "tif")):
        stem = f"img_00{k}"
        im = cv2.imread(os.path.join(synth, f"{stem}.jpg"))[:320, :448]
        data = {"jp2": lambda: pil_jp2(im, mct=1),
                "jpg": lambda: pil_jp2(im, irreversible=True, mct=1, quality_layers=[10]),
                "j2k": lambda: pil_jp2(im, no_jp2=True, progression="RPCL"),
                "tif": lambda: tiff_bytes(im, compression=5, old_lzw=True)}[form]()
        path = _write(tmp_path, data, f"{stem}.{form}")
        shutil.copy(os.path.join(synth, f"gt_{stem}.txt"), tmp_path)
        paths.append(str(path))
    lst = tmp_path / "l.txt"
    lst.write_text("".join(p + "\n" for p in paths))
    kw = dict(input_size=-1, batch_size=4, in_train=False, augment=False)
    got = next(detection_generator(str(lst), None, **kw))
    want = next(fots_generator(str(lst), **kw))
    assert len(got.image_fns) == 4
    for k in ("images", "score_maps", "geo_maps", "training_masks"):
        a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.shape == b.shape and np.array_equal(a, b), k


@pytest.mark.parametrize("rgb", [True, False])
def test_ocr_crop_readers_over_jp2_equal_fots(tmp_path, rgb):
    """The recognition crop readers of ``fots`` and the port over crops as
    JP2 files, 9/7 codestreams and CIELab TIFFs in turn."""
    from fots.codec import LabelCodec as JaxLabelCodec
    from fots.data import ocr_crops as jcrops
    from fots_torch.data import ocr_crops as tcrops

    src = os.path.join(_REPO, "fots_torch", "assets", "ocr_eval_png")
    entries = [ln.split(",", 1) for ln in open(os.path.join(src, "gt.txt")).read().splitlines()[:6]]
    names = []
    for k, (name, _) in enumerate(entries):
        im = cv2.imread(os.path.join(src, name.strip()))
        if k % 3 == 2:
            buf = io.BytesIO()
            Image.fromarray(im[..., ::-1].copy()).convert("LAB").save(buf, "TIFF")
            data, ext = buf.getvalue(), "tif"
        else:
            data = opj_encode(planes_of(im), numres=1, irreversible=k % 3 == 1, mct=1)
            data, ext = (data, "j2k") if k % 3 else (jp2_file(data, *im.shape[:2], 3), "jp2")
        names.append(f"c{k}.{ext}")
        _write(tmp_path, data, names[-1])
    lst = tmp_path / "gt.txt"
    lst.write_text("".join(f"{n},{text}\n" for n, (_, text) in zip(names, entries)))
    kw = dict(batch_size=3, norm_height=32, rgb=rgb, in_train=False)
    got = list(tcrops.ocr_crop_generator(None, train_list=str(lst), **kw))
    want = list(jcrops.ocr_crop_generator(str(lst), codec=JaxLabelCodec(), **kw))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"]
        for k in ("images", "labels", "label_lengths"):
            assert np.array_equal(g[k], np.asarray(w[k])), k
