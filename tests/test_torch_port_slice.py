"""The served slice end to end: fots_torch FOTSInference against fots.

Both engines load the shipped snapshot and serve the same two committed
``data/synth`` scenes in f32 with the shipped settings (masked recognition
IN and the fine bucket grid, device letterbox, u16 candidate transport)
and with the unmasked, coarse-grid, f32-transport settings.
Held to: the same box count per image, quad corners within 0.5 px,
identical texts, confidences within 1e-3.  The port runs on the CPU (plain
versions of its kernels).

The parity test serves at 640x960, the scenes' own size.  At 320x480 (the
smallest /32 size where the weights find five boxes) every box and text
agrees too, but one frame of one word sits at an argmax near-tie between
a character and the blank: the text is the same after CTC collapse, the
confidence mean over character frames moves by 7e-3.
"""

import os

import cv2
import numpy as np
import pytest

import jax

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector
from fots.pipeline import FOTSInference as JaxInference
from fots_torch.checkpoint import load_detector
from fots_torch.pipeline import FINE_STRIP_BUCKETS, STRIP_BUCKETS, FOTSInference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SERVE_HW = (320, 480)
PARITY_HW = (640, 960)


@pytest.fixture(scope="module")
def images():
    return [cv2.imread(os.path.join(REPO, "data", "synth", f"img_00{i}.jpg"))
            for i in range(2)]


@pytest.fixture(scope="module")
def port():
    model, _, config = load_detector(SNAPSHOT, "cpu")
    with FOTSInference(model, masked_norm=config["masked_norm"], device="cpu") as eng:
        yield eng


@pytest.fixture(scope="module")
def jax_model():
    jm = JaxDetector(nclass=87)
    jv, _ = jax_load_serving_params(SNAPSHOT, init_detector(jm, jax.random.PRNGKey(0)))
    return jm, jv


@pytest.mark.parametrize("masked_norm,cand_transport", [(True, "u16"), (False, "f32")])
def test_batch_call_matches_fots(images, jax_model, masked_norm, cand_transport):
    """The shipped settings, and the other grid (coarse buckets, unmasked
    recognition IN) with the exact f32 candidate transport."""
    jm, jv = jax_model
    ref = JaxInference(jm, jv, masked_norm=masked_norm, device_letterbox=True,
                       cand_transport=cand_transport)
    model, _, _ = load_detector(SNAPSHOT, "cpu")
    with FOTSInference(model, masked_norm=masked_norm, cand_transport=cand_transport,
                       device="cpu") as port:
        got = port.batch_call(images, serve_hw=PARITY_HW)
        assert port.strip_buckets == (FINE_STRIP_BUCKETS if masked_norm
                                      else STRIP_BUCKETS)
    want = ref.batch_call(images, serve_hw=PARITY_HW)
    assert sum(len(r) for r in want) >= 5
    assert [len(r) for r in got] == [len(r) for r in want]
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g["box"][:8], w["box"][:8], atol=0.5)
            assert g["text"] == w["text"]
            assert abs(g["conf"] - w["conf"]) <= 1e-3


def test_stream_matches_batch_call(images, port):
    batches = [images, images[::-1], images]
    want = [port.batch_call(b, serve_hw=SERVE_HW) for b in batches]
    got = list(port.stream(iter(batches), serve_hw=SERVE_HW))
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        assert [len(r) for r in gb] == [len(r) for r in wb]
        for g_img, w_img in zip(gb, wb):
            for g, w in zip(g_img, w_img):
                np.testing.assert_array_equal(g["box"], w["box"])
                assert g["text"] == w["text"] and g["conf"] == w["conf"]


def test_mixed_shape_batch_raises(images, port):
    """A batch of mixed source shapes is letterboxed on the host and served
    (tests/test_torch_port_eval.py holds it against fots); what still raises
    is an image that is not u8 [h, w, 3]."""
    small = cv2.resize(images[0], (480, 320))
    got = port.batch_call([images[0], small], serve_hw=SERVE_HW)
    assert len(got) == 2 and all(len(r) > 0 for r in got)
    with pytest.raises(ValueError, match=r"expected u8 \[h, w, 3\] images"):
        port.batch_call([images[0], small.astype(np.float32)], serve_hw=SERVE_HW)
