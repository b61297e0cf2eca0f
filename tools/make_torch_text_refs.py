"""Write the glyph atlas and the text references of the PyTorch port's putText.

    PYTHONPATH=. python tools/make_torch_text_refs.py

Needs OpenCV 5 (the port's GPU machine has none; there
``fots_torch.imgproc.put_text`` must reproduce these renders).  OpenCV 5
draws the Hershey faces from a built-in TrueType font (``Rubik.ttf``, kept
gzipped inside the ``cv2`` binary), antialiased.  What ``fots`` calls,
``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1)``, is
measured here from ``cv2``'s own renders, and every rule below is checked
against ``cv2`` before anything is written:

- each glyph lands on whole pixels: its coverage bitmap (8 bits, read from
  a render on black in white) and its offset from the pen are the same
  wherever the pen stands;
- the pen moves by a whole number of pixels a character, the same after a
  character whatever follows it (no kerning: every ordered pair of the
  alphabet, the space included, is measured);
- a glyph of coverage ``a`` blends over a background channel ``p`` in colour
  channel ``c`` as ``(c * a + p * (255 - a) + 127) // 255`` (checked on every
  ``a`` and ``p`` in 0..255 with ``c`` 0 and 255);
- glyphs are blended one after another in string order, so where two
  overlap (``TT``, ``ff``, ``jj``) the second blends over the first.

Writes ``fots_torch/assets/text_glyphs/``:

- ``atlas.npz``: ``chars`` (the code points of the 86 characters of the
  ICDAR 2015 alphabet, the space among them), ``dy`` / ``dx`` (each
  bitmap's top-left corner from the pen on the baseline), ``height`` /
  ``width``, ``offset`` into ``pixels`` (the bitmaps, flat u8, row-major)
  and ``advance`` (pixels the pen moves after the character);
- ``manifest.json``: the font's source (OpenCV's version, the font file,
  its size, SHA-256 and place in the ``cv2`` binary), the call, the rules;
- ``OFL.txt``: the font's copyright and licence notice, from its name table.

and ``fots_torch/assets/text_ref/``:

- ``refs.npz``: for each case ``<name>_bg`` (seeded noise, or a window of
  the first held-out scene) and ``<name>`` (``cv2.putText`` over it);
- ``cases.json``: each case's text, origin, colour and shape: strings with
  overlapping glyphs, ``É`` and ``´``, origins clipped at every edge.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
import zlib

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLYPHS_OUT = os.path.join(REPO, "fots_torch", "assets", "text_glyphs")
REF_OUT = os.path.join(REPO, "fots_torch", "assets", "text_ref")
# the 86-character ICDAR 2015 alphabet (fots_torch/codec.py's, in its order)
ALPHABET = (
    "7BCNTh2!F'P0ouRvz3[Qdesr6#:ÉyU(4bt%\"?´Kl.ZOM8@A1+)/ ki&DW$fwn;=p5HqSjV]JX-GEagxILmYc9,"
)
FONT = "Rubik.ttf"
FACE, SCALE, THICKNESS = cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
SEED = 12
ORG = (24, 40)       # where single glyphs are rendered, on a CANVAS-sized image
CANVAS = (64, 64)
PAIR_CANVAS = (64, 96)


def render(text, org, shape, bg=0, color=(255, 255, 255)) -> np.ndarray:
    im = np.empty((*shape, 3), np.uint8)
    im[...] = bg
    cv2.putText(im, text, org, FACE, SCALE, color, THICKNESS)
    return im


def blend(a, p, c):
    """The blend every render is checked against (ints, any shapes)."""
    return (c * a + p * (255 - a) + 127) // 255


def embedded_font(name: str = FONT):
    """(bytes, gzip member offset) of a font kept in the cv2 binary."""
    so = [os.path.join(os.path.dirname(cv2.__file__), f)
          for f in os.listdir(os.path.dirname(cv2.__file__)) if f.startswith("cv2") and
          f.endswith(".so")][0]
    with open(so, "rb") as f:
        data = f.read()
    # a gzip member with FNAME set (flags 0x08) names its file after the header
    m = re.search(re.escape(b"\x1f\x8b\x08\x08") + b".{6}" + re.escape(name.encode()) + b"\0",
                  data, re.S)
    if m is None:
        raise RuntimeError(f"no gzip member {name} in {so}")
    font = zlib.decompressobj(16 + zlib.MAX_WBITS).decompress(data[m.start():])
    return font, m.start(), os.path.basename(so)


def name_records(font: bytes) -> dict:
    """{nameID: string} of the font's English (Windows, Unicode) name records."""
    n_tables = struct.unpack(">H", font[4:6])[0]
    for i in range(n_tables):
        tag, _, off, _ = struct.unpack(">4sIII", font[12 + 16 * i:28 + 16 * i])
        if tag == b"name":
            break
    else:
        raise RuntimeError("the font has no name table")
    _, count, strings = struct.unpack(">HHH", font[off:off + 6])
    out = {}
    for r in range(count):
        pid, eid, lang, nid, length, soff = struct.unpack(
            ">HHHHHH", font[off + 6 + 12 * r:off + 18 + 12 * r])
        if (pid, eid, lang) == (3, 1, 0x409):
            s = font[off + strings + soff:off + strings + soff + length]
            out[nid] = s.decode("utf-16-be")
    return out


def measure_glyphs() -> dict:
    """{char: (dy, dx, bitmap)}; the space has an empty bitmap."""
    glyphs = {}
    for ch in ALPHABET:
        im = render(ch, ORG, CANVAS)
        if not (im[..., 0] == im[..., 1]).all() or not (im[..., 0] == im[..., 2]).all():
            raise RuntimeError(f"{ch!r}: the channels of a white render differ")
        m = im[..., 0]
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            glyphs[ch] = (0, 0, np.zeros((0, 0), np.uint8))
            continue
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        if min(y0, x0) == 0 or y1 == CANVAS[0] or x1 == CANVAS[1]:
            raise RuntimeError(f"{ch!r} touches the canvas's edge")
        glyphs[ch] = (int(y0 - ORG[1]), int(x0 - ORG[0]), m[y0:y1, x0:x1].copy())
        # whole pixels: the same bitmap one and seven pixels further on
        for org in ((ORG[0] + 1, ORG[1] + 1), (ORG[0] + 7, ORG[1] - 2)):
            want = np.zeros(CANVAS, np.uint8)
            draw(want, glyphs[ch], org)
            if not np.array_equal(render(ch, org, CANVAS)[..., 0], want):
                raise RuntimeError(f"{ch!r}: the bitmap moves with the pen by other than pixels")
    return glyphs


def draw(canvas, glyph, org):
    """Blend one glyph in white over a one-channel canvas (no clipping)."""
    dy, dx, m = glyph
    y0, x0 = org[1] + dy, org[0] + dx
    h, w = m.shape
    p = canvas[y0:y0 + h, x0:x0 + w].astype(np.int64)
    canvas[y0:y0 + h, x0:x0 + w] = blend(m.astype(np.int64), p, 255)


def pair_offset(glyphs, first, second, text, lead=0) -> int:
    """The one pen step d from ``first`` to ``second`` at which ``text``
    (``first`` + ``second``, or ``first`` + space + ``l`` with ``lead`` the
    space's own step) renders as the two glyphs blended in turn."""
    org = (16, 40)
    got = render(text, org, PAIR_CANVAS)[..., 0]
    hits = []
    for d in range(-4, 24):
        want = np.zeros(PAIR_CANVAS, np.uint8)
        draw(want, glyphs[first], org)
        draw(want, glyphs[second], (org[0] + d + lead, org[1]))
        if np.array_equal(got, want):
            hits.append(d)
    if len(hits) != 1:
        raise RuntimeError(f"{text!r}: pen steps {hits} reproduce the render")
    return hits[0]


def measure_advances(glyphs) -> dict:
    """Every ordered pair's pen step; raises if one depends on the second
    character (kerning), else {char: advance}."""
    space_step = pair_offset(glyphs, " ", "l", " l")
    steps = {}
    for a in ALPHABET:
        for b in ALPHABET:
            if b != " ":
                steps[a, b] = pair_offset(glyphs, a, b, a + b)
            elif a == " ":
                steps[a, b] = pair_offset(glyphs, " ", "l", "  l", lead=space_step)
            else:
                steps[a, b] = pair_offset(glyphs, a, "l", a + " l", lead=space_step)
    advance = {}
    for a in ALPHABET:
        found = {steps[a, b] for b in ALPHABET}
        if len(found) != 1:
            raise RuntimeError(f"the pen step after {a!r} depends on what follows: {found}")
        advance[a] = found.pop()
    return advance


def check_blend(glyphs):
    """The blend on every coverage and background level with colours 0 and
    255 (isolated glyphs, so no pixel is blended twice)."""
    text = "  ".join(ch for ch in ALPHABET if ch != " ")
    shape = (30, 8 * len(text) + 40)
    a = render(text, (5, 20), shape)[..., 0].astype(np.int64)
    if len(np.unique(a)) != 256:
        raise RuntimeError("the renders do not hold every coverage level")
    for c in (0, 255):
        for p in range(256):
            got = render(text, (5, 20), shape, p, (c, c, c))[..., 0]
            if not np.array_equal(got, blend(a, p, c)):
                raise RuntimeError(f"the blend differs at colour {c}, background {p}")


def ref_cases(rng) -> list:
    """(name, text, org, colour, background) of the committed renders."""
    with np.load(os.path.join(REPO, "fots_torch", "assets", "heldout_eval_u8.npz")) as z:
        scene = z["images"][0]
    noise = lambda h, w: rng.integers(0, 256, (h, w, 3)).astype(np.uint8)  # noqa: E731
    return [
        ("overlaps", "TTff jjVV rfyf7", (4, 22), (0, 255, 0), noise(32, 140)),
        ("accents", "CAFÉ´S É? 9% #@&", (6, 20), (37, 201, 90), noise(30, 150)),
        ("clip_top", "Top gJ", (3, 4), (0, 255, 0), noise(16, 70)),
        ("clip_right", "right edge", (36, 20), (255, 0, 128), noise(28, 90)),
        ("clip_left", "[left], (edge)", (-23, 18), (0, 255, 0), noise(26, 80)),
        ("clip_bottom", "gjpqy,;", (5, 28), (12, 34, 250), noise(30, 70)),
        ("alphabet", ALPHABET, (-3, 17), (0, 255, 0), noise(24, 620)),
        ("scene", "SALE 42%", (101, 9), (0, 255, 0),
         np.ascontiguousarray(scene[200:230, 300:420])),
    ]


def main():
    font, at, so = embedded_font()
    names = name_records(font)
    glyphs = measure_glyphs()
    advance = measure_advances(glyphs)
    check_blend(glyphs)
    print(f"{len(glyphs)} glyphs, advances {sorted(set(advance.values()))}; no kerning; "
          "the blend holds on every level")

    os.makedirs(GLYPHS_OUT, exist_ok=True)
    heights = [glyphs[c][2].shape[0] for c in ALPHABET]
    widths = [glyphs[c][2].shape[1] for c in ALPHABET]
    sizes = [h * w for h, w in zip(heights, widths)]
    np.savez_compressed(
        os.path.join(GLYPHS_OUT, "atlas.npz"),
        chars=np.array([ord(c) for c in ALPHABET], np.int32),
        dy=np.array([glyphs[c][0] for c in ALPHABET], np.int32),
        dx=np.array([glyphs[c][1] for c in ALPHABET], np.int32),
        height=np.array(heights, np.int32), width=np.array(widths, np.int32),
        offset=np.cumsum([0] + sizes[:-1]).astype(np.int64),
        pixels=np.concatenate([glyphs[c][2].reshape(-1) for c in ALPHABET]),
        advance=np.array([advance[c] for c in ALPHABET], np.int32))
    manifest = {
        "source": {"library": f"OpenCV {cv2.__version__}", "binary": so, "font": FONT,
                   "family": names.get(4), "version": names.get(5),
                   "gzip_member_offset": at, "bytes": len(font),
                   "sha256": hashlib.sha256(font).hexdigest(),
                   "licence": "SIL Open Font License 1.1 (OFL.txt)"},
        "call": "cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1) "
                "(LINE_8, bottomLeftOrigin false)",
        "bitmaps": "8-bit coverage of a render in white on black; dy, dx from the pen "
                   "on the baseline to the bitmap's top-left pixel; the same at every "
                   "pen position (glyphs land on whole pixels)",
        "pen": "starts at org; moves by advance[char] after each character; every "
               "ordered pair of the alphabet measured: no kerning",
        "blend": "per channel, out = (c * a + p * (255 - a) + 127) // 255 for colour c, "
                 "coverage a, background p; glyphs blended one after another in string "
                 "order; clipped at the image's edges",
        "writer": "tools/make_torch_text_refs.py",
    }
    with open(os.path.join(GLYPHS_OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, ensure_ascii=False)
        f.write("\n")
    with open(os.path.join(GLYPHS_OUT, "OFL.txt"), "w") as f:
        f.write(f"{FONT} as built into OpenCV {cv2.__version__} "
                f"(\"{names.get(4)}\", {names.get(5)}).\n\n")
        for nid in (0, 13, 14):
            if nid in names:
                f.write(names[nid] + "\n\n")

    os.makedirs(REF_OUT, exist_ok=True)
    arrays, cases = {}, []
    for name, text, org, color, bg in ref_cases(np.random.default_rng(SEED)):
        out = bg.copy()
        cv2.putText(out, text, org, FACE, SCALE, color, THICKNESS)
        arrays[f"{name}_bg"], arrays[name] = bg, out
        cases.append({"name": name, "text": text, "org": list(org), "color": list(color),
                      "shape": list(bg.shape)})
        print(f"{name}: {text!r} at {org} over {bg.shape}")
    np.savez_compressed(os.path.join(REF_OUT, "refs.npz"), **arrays)
    with open(os.path.join(REF_OUT, "cases.json"), "w") as f:
        json.dump({"opencv": cv2.__version__, "cases": cases}, f, indent=1, ensure_ascii=False)
        f.write("\n")


if __name__ == "__main__":
    main()
