"""TIFF strip and tile byte counts, and damage to one field of a TIFF's
directory, read by ``fots_torch.imageio.imread`` as ``cv2.imread`` (OpenCV
5.0 over libtiff 4.7) reads them, byte for byte in colour and grey, None
and raising included.

The byte counts: missing, zero, short, long, past the end of the file,
equal to the offsets, on one strip or several, tiles, planes, every coding
and photometric the port reads.  libtiff repairs some of them in
TIFFReadDirectory (EstimateStripByteCounts where the tag is missing, where
one strip's count ByteCountLooksBad, and where the first two of more than
two contiguous uncompressed counts differ), chops one uncompressed strip
into strips of about 8 KiB, refuses an uncompressed tile whose raw data is
not the tile's size, and reads nothing of an uncompressed strip shorter
than asked for (DumpModeDecode).

The directory: one entry's type, count, value or offset changed, an entry
duplicated, moved out of order or removed (``directory_damage``), each
class libtiff reads in its own way held against ``cv2``.

``patch_counts`` and ``directory_damage`` edit any TIFF in place, so the
fuzz (``tools/fuzz_torch_decoders.py``) damages every writer's files with
them.
"""

import struct

import cv2
import numpy as np
import pytest

from fots_torch.imageio import imread
from tests.test_torch_port_imageio_bmp_gif import assert_same as _assert_read
from tests.test_torch_port_imageio_tiff import tiff_bytes

#: type -> struct format of the integer and float types an entry may hold
_FMT = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
        11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}


def assert_same(path):
    """imread equals cv2.imread in both modes, None and raising included."""
    try:
        cv2.imread(str(path))
    except cv2.error:  # OpenCV's limits on the image's size
        for gray in (False, True):
            with pytest.raises(ValueError):
                imread(str(path), grayscale=gray)
        return
    _assert_read(path)


def directory(data):
    """(byte order, BigTIFF, offset of the first directory, its entries as
    [tag, type, count, the entry's value field])."""
    e = ">" if data[:2] == b"MM" else "<"
    big = struct.unpack(e + "H", data[2:4])[0] == 43
    at = struct.unpack_from(e + ("Q" if big else "I"), data, 8 if big else 4)[0]
    n = struct.unpack_from(e + ("Q" if big else "H"), data, at)[0]
    pos, size, inline = at + (8 if big else 2), 20 if big else 12, 8 if big else 4
    entries = []
    for k in range(n):
        p = pos + k * size
        tag, typ, cnt = struct.unpack_from(e + ("HHQ" if big else "HHI"), data, p)
        entries.append([tag, typ, cnt, data[p + size - inline:p + size]])
    return e, big, at, entries


def write_directory(data, entries):
    """``data`` with its first directory rewritten in place as ``entries``
    (no more of them than it had), zeros after them."""
    e, big, at, old = directory(data)
    assert len(entries) <= len(old)
    size = 20 if big else 12
    d = bytearray(data)
    out = struct.pack(e + ("Q" if big else "H"), len(entries))
    for tag, typ, cnt, field in entries:
        out += struct.pack(e + ("HHQ" if big else "HHI"), tag, typ, cnt) + field
    out += b"\0" * (8 if big else 4)  # no next directory
    start = at
    end = at + (8 if big else 2) + len(old) * size + (8 if big else 4)
    d[start:end] = out + b"\0" * (end - start - len(out))
    return bytes(d)


def entry_values(data, entry, e, big):
    """The numbers of an entry of an integer type."""
    tag, typ, cnt, field = entry
    fmt = _FMT[typ]
    width = struct.calcsize(e + fmt)
    src, at = (field, 0) if width * cnt <= len(field) else (
        data, struct.unpack(e + ("Q" if big else "I"), field)[0])
    return list(struct.unpack_from(e + fmt * cnt, src, at))


def strips(data):
    """(offsets, byte counts) of the strips or tiles as the file writes them."""
    e, big, _, entries = directory(data)
    by_tag = {ent[0]: ent for ent in entries}
    offsets = by_tag.get(273) or by_tag.get(324)
    counts = by_tag.get(279) or by_tag.get(325)
    return (entry_values(data, offsets, e, big),
            entry_values(data, counts, e, big) if counts else None)


def patch_counts(data, change=None, drop=False):
    """``data`` with its StripByteCounts / TileByteCounts entry removed
    (``drop``) or its values replaced in place by ``change(offsets,
    counts)``, a list as long as the counts (the entry's type kept)."""
    e, big, _, entries = directory(data)
    k = next(i for i, ent in enumerate(entries) if ent[0] in (279, 325))
    if drop:
        return write_directory(data, entries[:k] + entries[k + 1:])
    offsets, counts = strips(data)
    values = [int(v) for v in change(offsets, counts)]
    assert len(values) == len(counts)
    tag, typ, cnt, field = entries[k]
    fmt = _FMT[typ]
    raw = struct.pack(e + fmt * cnt, *values)
    if len(raw) <= len(field):
        entries[k][3] = raw + b"\0" * (len(field) - len(raw))
        return write_directory(data, entries)
    at = struct.unpack(e + ("Q" if big else "I"), field)[0]
    return data[:at] + raw + data[at + len(raw):]


def relocated(data, entries):
    """``data`` with a new first directory of ``entries`` appended at its
    end (on a word boundary) and the header pointing at it."""
    e, big, _, _ = directory(data)
    d = data + b"\0" * (len(data) & 1)
    out = struct.pack(e + ("Q" if big else "H"), len(entries))
    for tag, typ, cnt, field in entries:
        out += struct.pack(e + ("HHQ" if big else "HHI"), tag, typ, cnt) + field
    out += b"\0" * (8 if big else 4)
    at = struct.pack(e + ("Q" if big else "I"), len(d))
    return (d[:8] + at + d[16:] if big else d[:4] + at + d[8:]) + out


#: the kinds of ``directory_damage``
DAMAGE = ("type", "count", "value", "offset", "duplicate", "order", "missing")


def directory_damage(data, rng, kind=None, k=None):
    """(kind, tag, damaged file): one field of one entry of the first
    directory changed (its type, count, value or, for values that do not fit
    in the entry, their offset), or the entry duplicated (with another
    value), moved out of order or removed.  ``rng``: a numpy Generator."""
    e, big, _, entries = directory(data)
    kind = kind or DAMAGE[int(rng.integers(len(DAMAGE)))]
    k = int(rng.integers(len(entries))) if k is None else k
    ent = [list(x) for x in entries]
    tag, typ, cnt, field = ent[k]
    inline = len(field)
    if kind == "type":
        ent[k][1] = int(rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16, 17, 18, 19,
                                    int(rng.integers(0, 65536))]))
    elif kind == "count":
        ent[k][2] = int(rng.choice([0, 1, 2, 3, max(0, cnt - 1), cnt + 1, 2 * cnt,
                                    int(rng.integers(0, 1 << 16)), 0xFFFFFFFF]))
    elif kind == "value":
        width = struct.calcsize(e + _FMT.get(typ, "B"))
        if width * cnt <= inline and rng.random() < 0.7:  # one of the values in the entry
            small = [0, 1, 2, 3, 4, 5, 6, 7, 8, 16, 255, 256, 65535, int(rng.integers(0, 1 << 16))]
            v = int(rng.choice(small)) % (1 << 8 * width)
            j = int(rng.integers(max(1, inline // width)))
            f = bytearray(field)
            f[j * width:(j + 1) * width] = v.to_bytes(width, "big" if e == ">" else "little")
            ent[k][3] = bytes(f)
        else:  # a byte of the entry's field, or of its values
            f = bytearray(field)
            f[int(rng.integers(inline))] = int(rng.integers(256))
            ent[k][3] = bytes(f)
    elif kind == "offset":
        width = struct.calcsize(e + _FMT.get(typ, "B"))
        if width * cnt > inline:
            at = int(rng.choice([0, 8, len(data) - 1, len(data) + 10, int(rng.integers(0, len(data)))]))
            ent[k][3] = struct.pack(e + ("Q" if big else "I"), at)
        else:
            f = bytearray(field)
            f[int(rng.integers(inline))] ^= 1 << int(rng.integers(8))
            ent[k][3] = bytes(f)
    elif kind == "duplicate":
        dup = list(ent[k])
        f = bytearray(dup[3])
        f[int(rng.integers(inline))] = int(rng.integers(256))
        dup[3] = bytes(f)
        j = k + 1 if rng.random() < 0.7 else int(rng.integers(len(ent) + 1))
        if rng.random() < 0.5:  # the changed copy first
            ent[k], dup = dup, ent[k]
        return kind, tag, relocated(data, ent[:j] + [dup] + ent[j:])
    elif kind == "order":
        j = int(rng.integers(len(ent)))
        ent[k], ent[j] = ent[j], ent[k]
    else:
        return kind, tag, write_directory(data, ent[:k] + ent[k + 1:])
    return kind, tag, write_directory(data, ent)


# --------------------------------------------------------------------------
# byte counts
# --------------------------------------------------------------------------

def _scene(h=30, w=40, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, n)) if n > 1 else rng.integers(0, 256, (h, w))


def _set(k, delta):
    """A change that adds ``delta`` to count ``k``."""
    return lambda offsets, counts: [c + delta * (i == k) for i, c in enumerate(counts)]


def _table():
    """The files of the table of cases cv2 and the port once read apart:
    (file, whether cv2 reads it)."""
    rgb, grey = _scene(), _scene(n=1, seed=1)
    out = {}
    for comp, name in ((8, "deflate"), (5, "lzw"), (32773, "packbits")):
        one = tiff_bytes(rgb, compression=comp)
        out[f"one_{name}_strip_count_0"] = (patch_counts(one, lambda o, c: [0]), True)
        out[f"one_{name}_strip_no_counts"] = (patch_counts(one, drop=True), True)
    out["one_raw_strip_no_counts"] = (patch_counts(tiff_bytes(rgb), drop=True), True)
    # 30 rows in 4 strips of 8: the estimate's rows are 30 // 4 = 7
    rgb4 = tiff_bytes(rgb, rows_per_strip=8, ifd_first=False)
    for delta in (-5, 5):
        out[f"four_raw_rgb_strips_first_{delta:+d}"] = (patch_counts(rgb4, _set(0, delta)), True)
    out["four_raw_strips_counts_are_offsets"] = (
        patch_counts(rgb4, lambda offsets, counts: offsets), True)
    grey4 = tiff_bytes(grey, rows_per_strip=8, ifd_first=False)
    for name, k, delta in (("first_-1", 0, -1), ("first_+100", 0, 100), ("second_+3", 1, 3)):
        out[f"four_grey_strips_{name}"] = (patch_counts(grey4, _set(k, delta)), True)
    tiles = tiff_bytes(rgb, tile=(32, 16))
    out["raw_tiles_first_-7"] = (patch_counts(tiles, _set(0, -7)), True)
    out["raw_tiles_last_-7"] = (patch_counts(tiles, _set(3, -7)), False)
    return out


_TABLE = _table()


@pytest.mark.parametrize("name", sorted(_TABLE))
def test_tiff_counts_table_as_cv2(tmp_path, name):
    """Each row of the table: cv2 reads it (or gives None) and the port
    gives the same, byte for byte in colour and grey."""
    data, read = _TABLE[name]
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    assert (cv2.imread(str(path)) is not None) == read, name
    assert_same(path)


def _rules():
    """Files of each rule fitted beyond the table."""
    rgb, grey = _scene(), _scene(n=1, seed=1)
    rgba = _scene(n=4, seed=2)
    out = {}
    # a missing tag: one strip a plane is estimated, more strips are refused
    for comp in (1, 8):
        planar = tiff_bytes(rgb, planar=2, compression=comp)
        out[f"planar_one_strip_a_plane_no_counts_c{comp}"] = patch_counts(planar, drop=True)
        strips4 = tiff_bytes(rgb, rows_per_strip=8, compression=comp)
        out[f"four_strips_no_counts_c{comp}"] = patch_counts(strips4, drop=True)
        one_tile = tiff_bytes(rgb, tile=(48, 32), compression=comp)
        out[f"one_tile_no_counts_c{comp}"] = patch_counts(one_tile, drop=True)
    out["planar_strips_no_counts"] = patch_counts(tiff_bytes(rgb, planar=2, rows_per_strip=16),
                                                  drop=True)
    # the compressed estimate: the file's size less the directory's bytes,
    # the last strip's cut at the end of the file; a plane's share
    one = tiff_bytes(rgb, compression=8, ifd_first=False)
    out["deflate_directory_last_no_counts"] = patch_counts(one, drop=True)
    out["lzw_planar_no_counts_directory_last"] = patch_counts(
        tiff_bytes(rgb, planar=2, compression=5, ifd_first=False), drop=True)
    # every entry's values count (type 0 as bytes); a type with no size
    # fails the estimate
    no_counts = patch_counts(tiff_bytes(rgb, compression=8), drop=True)
    entries = directory(no_counts)[3]
    for typ, cnt in ((7, 2000), (0, 2000), (19, 2)):
        out[f"deflate_no_counts_entry_of_type_{typ}"] = relocated(
            no_counts, entries + [[65000, typ, cnt, struct.pack("<I", 8)]])
    out["deflate_no_counts_bigtiff"] = patch_counts(tiff_bytes(rgb, compression=8, bigtiff=True),
                                                    drop=True)
    # ByteCountLooksBad on one uncompressed strip: past the end, short;
    # offset 0 is never bad (the strip reads from the header on)
    raw = tiff_bytes(rgb)
    out["one_raw_strip_past_the_end"] = patch_counts(raw, lambda o, c: [c[0] + 100])
    out["one_raw_strip_short"] = patch_counts(raw, lambda o, c: [c[0] - 120])
    out["one_raw_strip_long_inside"] = patch_counts(tiff_bytes(rgb, ifd_first=False),
                                                    lambda o, c: [c[0] + 8])
    zero = [[t, ty, n, struct.pack("<I", 0) if t == 273 else f]
            for t, ty, n, f in directory(raw)[3]]
    out["one_raw_strip_offset_0_short"] = patch_counts(write_directory(raw, zero),
                                                       lambda o, c: [100])
    out["one_raw_strip_offset_0_whole"] = write_directory(raw, zero)
    # uncompressed strips shorter than asked for read as nothing (zeros)
    grey4 = tiff_bytes(grey, rows_per_strip=8)
    out["four_strips_same_first_two_last_short"] = patch_counts(grey4, _set(3, -1))
    out["two_strips_first_short"] = patch_counts(tiff_bytes(grey, rows_per_strip=16),
                                                 _set(0, -1))
    # "Wrong StripByteCounts" of tiles: every tile its size
    tiles = tiff_bytes(grey, tile=(16, 16))
    out["raw_grey_tiles_first_long"] = patch_counts(tiles, _set(0, 40))
    out["raw_tiles_all_equal_short"] = patch_counts(tiles, lambda o, c: [200] * len(c))
    # an uncompressed tile whose raw data is not its size: the first plane
    # fails the read, a later plane's reads as zeros
    planar_tiles = tiff_bytes(rgba, planar=2, tile=(32, 16), extrasamples=[2])
    n = len(strips(planar_tiles)[1])
    out["planar_tiles_later_plane_short"] = patch_counts(planar_tiles, _set(n // 2, -9))
    out["planar_tiles_first_plane_long"] = patch_counts(planar_tiles, _set(1, 9))
    # fill order 2: the raw buffer grows by whole KiB, so a tile of 1 KiB
    # with a short count reads (as zeros) and a long one fails
    fo2 = tiff_bytes(_scene(32, 16, 4, seed=3), tile=(16, 16), fillorder=2, ifd_first=False)
    out["fillorder2_tile_1k_short"] = patch_counts(fo2, _set(0, -24))
    out["fillorder2_tile_1k_long"] = patch_counts(fo2, _set(0, 24))
    # a count past 1 MiB is cut to ten strips and 4 KiB (inside this file)
    big_count = tiff_bytes(_scene(4, 8, 1, seed=4), rows_per_strip=1) + bytes(5000)
    out["count_past_1_mib_cut"] = patch_counts(big_count, _set(0, 3 << 20))
    # a compressed strip's count long or short, zero on a later strip
    lzw = tiff_bytes(rgb, compression=5, rows_per_strip=8, ifd_first=False)
    out["lzw_strip_long"] = patch_counts(lzw, _set(1, 60))
    out["lzw_strip_short"] = patch_counts(lzw, _set(1, -60))
    out["lzw_later_strip_0"] = patch_counts(lzw, lambda o, c: c[:2] + [0] + c[3:])
    return out


_RULES = _rules()


@pytest.mark.parametrize("name", sorted(_RULES))
def test_tiff_count_rules_as_cv2(tmp_path, name):
    path = tmp_path / "x.tif"
    path.write_bytes(_RULES[name])
    assert_same(path)


def _codings():
    """A file of each other writer (YCbCr, CMYK, JPEG, CCITT, SGILog,
    SGILog24, CIELab) with its counts damaged each way."""
    import tests.test_torch_port_imageio_tiff_codings as c
    import tests.test_torch_port_imageio_tiff_lab_log as lab

    rng = np.random.default_rng(21)
    im = _scene(24, 32, seed=5).astype(np.uint8)
    files = {"ycbcr_2x2_strips": c.ycbcr_tiff(32, 24, 2, 2, rows_per_strip=6),
             "ycbcr_4x2_lzw_tiles": c.ycbcr_tiff(40, 24, 4, 2, tile=(16, 16), compression=5),
             "cmyk_planar": c.cmyk_tiff(rng.integers(0, 256, (24, 32, 4)), planar=2),
             "jpeg_strips": c.jpeg_tiff(im, rows_per_strip=16),
             "group4": c.fax_tiff(c.bilevel(24, 40, 1), 4, rows_per_strip=8),
             "group3_2d": c.fax_tiff(c.bilevel(24, 40, 2), 3, two_d=True),
             "sgilog_luv": lab.sgilog_tiff(lab._log_values(rng, (20, 24), True), True,
                                           rows_per_strip=5),
             "sgilog24_tiles": lab.sgilog24_tiff(
                 rng.integers(0, 1 << 24, (20, 24)).astype(np.uint32), tile=(16, 16)),
             "cielab16": lab._lab_tiff(rng.integers(0, 1 << 16, (20, 24, 3)), 16,
                                       rows_per_strip=5)}
    changes = {"no_counts": None, "all_0": lambda o, c: [0] * len(c),
               "first_short": _set(0, -7), "first_long": _set(0, 7),
               "last_past_the_end": lambda o, c: c[:-1] + [c[-1] + 10**6],
               "offsets": lambda o, c: o}
    out = {}
    for name, data in files.items():
        for how, change in changes.items():
            out[f"{name}_{how}"] = patch_counts(data, change, drop=change is None)
    return out


_CODINGS = _codings()


@pytest.mark.parametrize("name", sorted(_CODINGS))
def test_tiff_counts_of_every_coding_as_cv2(tmp_path, name):
    path = tmp_path / "x.tif"
    path.write_bytes(_CODINGS[name])
    assert_same(path)


# --------------------------------------------------------------------------
# one field of the directory
# --------------------------------------------------------------------------

def _edit(data, tag, typ=None, cnt=None, value=None, fmt="<H"):
    """``data`` with the first entry of ``tag`` given another type, count or
    value (packed with ``fmt`` into the entry's field); or the entry removed
    where all three are None."""
    entries = directory(data)[3]
    k = next(i for i, ent in enumerate(entries) if ent[0] == tag)
    if typ is None and cnt is None and value is None:
        return write_directory(data, entries[:k] + entries[k + 1:])
    ent = entries[k]
    ent[1] = ent[1] if typ is None else typ
    ent[2] = ent[2] if cnt is None else cnt
    if value is not None:
        raw = struct.pack(fmt, *value) if isinstance(value, tuple) else struct.pack(fmt, value)
        ent[3] = raw + b"\0" * (len(ent[3]) - len(raw))
    return write_directory(data, entries)


def _moved(data, tag, before):
    """``data`` with the entry of ``tag`` moved in front of ``before``'s."""
    entries = directory(data)[3]
    ent = next(x for x in entries if x[0] == tag)
    rest = [x for x in entries if x[0] != tag]
    k = next(i for i, x in enumerate(rest) if x[0] == before)
    return write_directory(data, rest[:k] + [ent] + rest[k:])


def _doubled(data, tag, value, first=True, fmt="<H"):
    """``data`` with a second entry of ``tag`` holding ``value``, before
    (``first``) or after the file's own."""
    entries = directory(data)[3]
    k = next(i for i, ent in enumerate(entries) if ent[0] == tag)
    dup = list(entries[k])
    dup[3] = struct.pack(fmt, value) + b"\0" * (len(dup[3]) - struct.calcsize(fmt))
    at = k if first else k + 1
    return relocated(data, entries[:at] + [dup] + entries[at:])


def _values(data, tag, fmt, *values):
    """``data`` with ``values`` (packed little-endian by ``fmt``, SHORT or
    LONG) appended and the entry of ``tag`` pointing at them."""
    entries = directory(data)[3]
    k = next(i for i, ent in enumerate(entries) if ent[0] == tag)
    at = len(data) + (len(data) & 1)
    raw = struct.pack(fmt, *values)
    entries[k][1:] = [3 if fmt[-1] == "H" else 4, len(values), struct.pack("<I", at)]
    return write_directory(data, entries)[:len(data)] + b"\0" * (len(data) & 1) + raw


def _directory_cases():
    """(file, whether cv2 reads it) of each class of directory damage the
    port reads as libtiff does."""
    import tests.test_torch_port_imageio_tiff_codings as c
    import tests.test_torch_port_imageio_tiff_lab_log as lab

    rgb, grey = _scene(), _scene(n=1, seed=1)
    rgb8 = tiff_bytes(rgb, compression=8, rows_per_strip=8)
    grey8 = tiff_bytes(grey, rows_per_strip=8)
    out = {}
    # Photometric: needed (OpenCV's readHeader), read from any integer type
    out["photometric_missing"] = (_edit(rgb8, 262), False)
    out["photometric_missing_grey"] = (_edit(grey8, 262), False)
    out["photometric_sbyte"] = (_edit(rgb8, 262, typ=6), True)
    out["photometric_slong"] = (_edit(grey8, 262, typ=9, value=1, fmt="<i"), True)
    out["photometric_ascii"] = (_edit(rgb8, 262, typ=2), False)
    out["photometric_two_values"] = (_edit(rgb8, 262, cnt=2), False)
    out["photometric_negative"] = (_edit(grey8, 262, typ=8, value=-1, fmt="<h"), False)
    # SamplesPerPixel and the per-sample tags
    out["samples_sshort"] = (_edit(rgb8, 277, typ=8), True)
    out["samples_two_values"] = (_edit(rgb8, 277, cnt=2), False)
    out["samples_zero"] = (_edit(rgb8, 277, value=0), False)
    rgb_planes = tiff_bytes(rgb, compression=5, planar=2)
    out["compression_one_a_sample"] = (_values(rgb_planes, 259, "<3H", 5, 5, 5), True)
    out["compression_one_a_sample_differing"] = (_values(rgb_planes, 259, "<3H", 5, 5, 1), False)
    out["compression_too_few_for_the_samples"] = (_values(rgb_planes, 259, "<2H", 5, 5), False)
    out["compression_two_values_grey"] = (_edit(grey8, 259, cnt=2, value=(1, 7), fmt="<2H"),
                                          True)
    out["compression_two_differing_of_rgb"] = (
        _edit(tiff_bytes(rgb, compression=5), 259, cnt=2, value=(5, 1), fmt="<2H"), False)
    out["bits_per_sample_long"] = (_edit(grey8, 258, typ=4, value=8, fmt="<I"), True)
    out["bits_per_sample_rational"] = (_edit(grey8, 258, typ=5), False)
    # a palette of 3 samples without its colour map: RGB of 1 colour channel
    # (the other two made extra samples before the repair), which is None
    out["palette_of_3_samples_without_map"] = (_edit(rgb8, 262, value=3), False)
    out["sample_format_7"] = (tiff_bytes(grey, sampleformat=7), False)
    out["bits_per_sample_a_sample_differing"] = (_values(rgb8, 258, "<3H", 8, 8, 16), False)
    # SGILog: BitsPerSample is libtiff's to set (1, 8, 16 for LogL; LogLuv
    # also 2 and 4)
    rng = np.random.default_rng(3)
    logl = lab.sgilog_tiff(lab._log_values(rng, (9, 11), False), False)
    logluv = lab.sgilog_tiff(lab._log_values(rng, (9, 11), True), True)
    out["sgilog_logl_no_bits_per_sample"] = (_edit(logl, 258), True)
    out["sgilog_logl_4_bits"] = (_edit(logl, 258, value=4), False)
    out["sgilog_logluv_4_bits"] = (_edit(logluv, 258, cnt=1, value=4), True)
    # ColorMap: counts only after BitsPerSample and whole; else an 8-bit
    # palette reads as grey, a 4-bit one as nothing
    pal8 = tiff_bytes(grey, photometric=3, colormap=list(rng.integers(0, 65536, 768)))
    pal4 = tiff_bytes(grey >> 4, bps=4, photometric=3, colormap=list(rng.integers(0, 256, 48)))
    out["colormap_before_bits_per_sample"] = (_moved(pal8, 320, 258), True)
    out["colormap_before_bits_per_sample_4bit"] = (_moved(pal4, 320, 258), False)
    out["colormap_count_off_by_one"] = (_edit(pal8, 320, cnt=767), True)
    # the first entry of a tag wins, read or not
    out["duplicate_fillorder_first_unreadable"] = (
        _doubled(tiff_bytes(grey, fillorder=2), 266, 7), True)
    out["duplicate_width_second"] = (_doubled(rgb8, 256, 12, first=False, fmt="<I"), True)
    out["duplicate_width_first"] = (_doubled(rgb8, 256, 12, fmt="<I"), True)
    # StripOffsets: any integer type of values 0 or more; 273 and 324
    # are one field (the later entry wins)
    small = tiff_bytes(_scene(4, 5, 1, seed=5), rows_per_strip=2)
    offs = strips(small)[0]
    out["offsets_sshort"] = (_edit(small, 273, typ=8, value=tuple(offs), fmt="<2h"), True)
    out["offsets_negative"] = (_edit(small, 273, typ=8, value=(offs[0], -1), fmt="<2h"), False)
    out["offsets_ifd_type"] = (_edit(small, 273, typ=13), False)
    tiles = tiff_bytes(grey, tile=(16, 16), compression=5)
    out["tile_offsets_without_tile_size"] = (_edit(_edit(tiles, 322), 323), True)
    out["strip_offsets_short_of_a_million_strips"] = (
        _edit(rgb8, 257, value=0x7FFFFFF, fmt="<I"), False)
    # RowsPerStrip: not 0, and as OpenCV reads a strip, 2^24 at most
    out["rows_per_strip_0"] = (_edit(grey8, 278, value=0, fmt="<I"), False)
    out["rows_per_strip_over_2_24"] = (_edit(tiff_bytes(grey, compression=8), 278,
                                             value=(1 << 24) + 1, fmt="<I"), False)
    out["rows_per_strip_2_32_less_1"] = (_edit(tiff_bytes(grey, compression=8), 278,
                                               value=0xFFFFFFFF, fmt="<I"), True)
    out["rows_per_strip_2_30"] = (_edit(tiff_bytes(grey, compression=8), 278, value=1 << 20,
                                        fmt="<I"), True)
    # YCbCrSubsampling and JPEGTables of a type libtiff ignores
    jpeg = c.jpeg_tiff(_scene(24, 32, seed=6).astype(np.uint8), rows_per_strip=16,
                       subsampling=0)
    out["ycbcr_subsampling_ascii"] = (_edit(jpeg, 530, typ=2), True)
    out["ycbcr_subsampling_three_values"] = (_edit(jpeg, 530, cnt=3), True)
    out["jpeg_tables_sbyte"] = (_edit(jpeg, 347, typ=6), False)
    # ExtraSamples: 999 reads as unassociated alpha
    rgba = tiff_bytes(_scene(n=4, seed=7), extrasamples=[2])
    out["extrasamples_999"] = (_edit(rgba, 338, value=999), True)
    out["extrasamples_3"] = (_edit(rgba, 338, value=3), False)
    # a tile width of no whole bytes: the bitmap put routines' skew
    bits = _scene(30, 40, 1, seed=8) >> 7
    out["tile_width_250_1bit"] = (tiff_bytes(bits, bps=1, tile=(250, 16)), True)
    out["tile_width_20_4bit_palette"] = (tiff_bytes(grey >> 4, bps=4, photometric=3,
                                                    colormap=list(rng.integers(0, 256, 48)),
                                                    tile=(20, 16)), True)
    return out


_DIRECTORY = _directory_cases()


@pytest.mark.parametrize("name", sorted(_DIRECTORY))
def test_tiff_directory_damage_as_cv2(tmp_path, name):
    """One class of directory damage: cv2 reads the file (or gives None) and
    the port gives the same in both modes."""
    data, read = _DIRECTORY[name]
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    assert (cv2.imread(str(path)) is not None) == read, name
    assert_same(path)


@pytest.mark.parametrize("kind", DAMAGE)
def test_tiff_directory_damage_fuzz_as_cv2(tmp_path, kind):
    """Every entry of a few files damaged by ``directory_damage`` of one kind."""
    import tests.test_torch_port_imageio_tiff_codings as c

    rng = np.random.default_rng(DAMAGE.index(kind))
    path = tmp_path / "x.tif"
    files = (tiff_bytes(_scene(9, 13, seed=9), compression=5, rows_per_strip=4),
             tiff_bytes(_scene(9, 13, 1, seed=10), tile=(16, 16), planar=1),
             c.ycbcr_tiff(13, 9, 2, 2, rows_per_strip=4))
    for data in files:
        for k in range(len(directory(data)[3])):
            path.write_bytes(directory_damage(data, rng, kind, k)[2])
            assert_same(path)
