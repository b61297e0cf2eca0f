"""The port's ``imgproc.put_text`` against OpenCV 5's ``cv2.putText`` (CPU).

``fots`` writes each detection's text with ``cv2.putText(img, text, org,
FONT_HERSHEY_SIMPLEX, 0.5, color, 1)``; OpenCV 5 renders it from its
built-in TrueType font, antialiased.  ``put_text`` draws from an atlas of
OpenCV's own glyph bitmaps and advances (``fots_torch/assets/text_glyphs/``,
written by ``tools/make_torch_text_refs.py``).  Held byte for byte:

- every ordered pair of the 86 alphabet characters on seeded backgrounds;
- every coverage level over every background level, colours 0 and 255;
- random strings of up to 40 characters at origins past every edge, in
  random colours, on colour and grey images (hypothesis);
- the committed atlas and references (``text_ref/``, what ``chip_smoke.py``
  holds on the card) against what ``cv2`` renders now.
"""

import json
import os

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fots_torch import imgproc
from fots_torch.codec import ICDAR15_ALPHABET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_REF = os.path.join(REPO, "fots_torch", "assets", "text_ref")
GREEN = (0, 255, 0)


def cv2_text(img, text, org, color):
    out = img.copy()
    cv2.putText(out, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return out


def test_atlas_holds_the_alphabet_as_cv2_renders_each_glyph():
    atlas = imgproc._text_atlas()
    assert "".join(atlas) == ICDAR15_ALPHABET
    org = (20, 36)
    for ch, (dy, dx, m, advance) in atlas.items():
        im = cv2_text(np.zeros((56, 48, 3), np.uint8), ch, org, (255, 255, 255))[..., 0]
        ys, xs = np.nonzero(im)
        if ch == " ":
            assert len(ys) == 0 and m.size == 0
        else:
            assert (ys.min() - org[1], xs.min() - org[0]) == (dy, dx)
            assert np.array_equal(im[ys.min():ys.max() + 1, xs.min():xs.max() + 1], m)
        assert 3 <= advance <= 13


def test_every_ordered_pair_equals_cv2():
    rng = np.random.default_rng(0)
    pairs = [a + b for a in ICDAR15_ALPHABET for b in ICDAR15_ALPHABET]
    assert len(pairs) == 7396
    backgrounds = rng.integers(0, 256, (len(pairs), 24, 34, 3), dtype=np.uint8)
    colours = rng.integers(0, 256, (len(pairs), 3))
    differ = []
    for i, text in enumerate(pairs):
        colour = GREEN if i % 2 else tuple(int(v) for v in colours[i])
        bg = backgrounds[i]
        if not np.array_equal(imgproc.put_text(bg.copy(), text, (4, 17), colour),
                              cv2_text(bg, text, (4, 17), colour)):
            differ.append(text)
    assert differ == []


def test_every_coverage_over_every_background_equals_cv2():
    """Isolated glyphs (each pixel blended once) holding all 256 coverage
    levels, over each uniform background level, in colours 0 and 255."""
    text = "  ".join(ch for ch in ICDAR15_ALPHABET if ch != " ")
    shape = (30, 8 * len(text) + 40)
    white = cv2_text(np.zeros((*shape, 3), np.uint8), text, (5, 20), (255, 255, 255))
    assert len(np.unique(white)) == 256
    for c in (0, 255):
        for p in range(256):
            bg = np.full((*shape, 3), p, np.uint8)
            assert np.array_equal(imgproc.put_text(bg.copy(), text, (5, 20), (c, c, c)),
                                  cv2_text(bg, text, (5, 20), (c, c, c))), (c, p)


@settings(max_examples=400, deadline=None, database=None)
@given(text=st.text(alphabet=ICDAR15_ALPHABET, max_size=40),
       h=st.integers(1, 48), w=st.integers(1, 160),
       fx=st.floats(-1.2, 1.2), fy=st.floats(-0.5, 1.5),
       colour=st.tuples(*[st.integers(0, 255)] * 3), grey=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_random_strings_and_origins_equal_cv2(text, h, w, fx, fy, colour, grey, seed):
    """Origins from past the left edge (a string up to 40 glyphs long) to
    past the right, and from above the top to below the bottom."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w) if grey else (h, w, 3), dtype=np.uint8)
    org = (int(fx * (w + 400)) - (200 if fx < 0 else 0), int(fy * (h + 20)) - 5)
    assert np.array_equal(imgproc.put_text(bg.copy(), text, org, colour),
                          cv2_text(bg, text, org, colour))


def test_committed_references_equal_cv2_and_put_text():
    with open(os.path.join(TEXT_REF, "cases.json")) as f:
        cases = json.load(f)["cases"]
    names = {c["name"] for c in cases}
    assert {"overlaps", "accents", "clip_top", "clip_right", "clip_left",
            "clip_bottom"} <= names
    with np.load(os.path.join(TEXT_REF, "refs.npz")) as z:
        refs = {k: z[k] for k in z.files}
    for case in cases:
        bg, want = refs[case["name"] + "_bg"], refs[case["name"]]
        org, colour = tuple(case["org"]), tuple(case["color"])
        assert list(bg.shape) == case["shape"]
        assert np.array_equal(cv2_text(bg, case["text"], org, colour), want), case["name"]
        assert np.array_equal(imgproc.put_text(bg.copy(), case["text"], org, colour),
                              want), case["name"]
        assert not np.array_equal(bg, want), case["name"]


def test_put_text_refuses_what_the_atlas_lacks():
    img = np.zeros((20, 40, 3), np.uint8)
    for text in ("café", "a\nb", "€", "\t"):
        with pytest.raises(ValueError, match="no glyph"):
            imgproc.put_text(img, text, (2, 15), GREEN)
    assert not img.any()
    with pytest.raises(TypeError):
        imgproc.put_text(np.zeros((20, 40, 3), np.float32), "a", (2, 15), GREEN)
    assert imgproc.put_text(img, "", (2, 15), GREEN) is img and not img.any()
