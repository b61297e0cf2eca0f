"""The dense detection path of the port against fots, on the CPU.

Host helpers (exactly equal arrays): ``decode_quads_np``, ``quad_iou``,
``get_boxes`` and ``get_boxes_from_candidates`` (f32 pack with k = every
pixel, and the u16 pack), on seeded maps with structured word regions, as
``fots``'s ``tests/test_nms.py`` builds them.

``FOTSInference.detect_maps``: one model at ``fots``'s test widths (the
full detector, inputs of 96x128), its seeded ``fots`` initialisation
carried over by ``state_dict_from_fots``, in f32: segm within 1e-4, angle
within 5e-4 (the unit (sin, cos) pair of a raw 2-vector that this
initialisation leaves short, so its normalisation amplifies), rbox
(distances up to ~110 px here) and focr within 1e-4 and 1e-5 of their
largest magnitude (only the summation order differs, as in the detector
test).
Then the shipped snapshot on two ``data/synth`` scenes at 320x480: boxes
from the maps through ``get_boxes`` against ``fots``'s (the same count,
corners within 0.5 px, as the slice test holds serving) and the texts
``recognize_boxes`` reads from the raw focr map (identical); within the
port, the dense boxes equal the candidate path's exactly.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.geometry import decode_quads_np as jax_decode_quads_np
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.ops import nms as jnms
from fots.pipeline import FOTSInference as JaxInference
from fots_torch.checkpoint import load_detector, state_dict_from_fots
from fots_torch.geometry import decode_quads_np
from fots_torch.models.detector import FOTSDetector
from fots_torch.ops import nms as tnms
from fots_torch.pipeline import FOTSInference, PackedFocr
from fots_torch.serving import host_letterbox

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SCENE_HW = (320, 480)


def _maps(seed, b=2, h=32, w=64):
    """Seeded score / geometry / angle maps [b, h, w, ...] with two word
    regions, so that merges happen."""
    rng = np.random.default_rng(seed)
    segm = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    segm[:, 10:15, 10:31] += 0.5
    segm[:, 20:26, 35:60] += 0.45
    geo = rng.uniform(0.5, 8.0, (b, h, w, 4)).astype(np.float32)
    theta = rng.uniform(-0.3, 0.3, (b, h, w))
    angle = np.stack([np.sin(theta), np.cos(theta)], -1).astype(np.float32)
    return segm, geo, angle


# --------------------------------------------------------------------------
# host helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_quads_np_matches_fots(seed):
    segm, geo, angle = _maps(seed)
    for thresh in (0.5, 0.9):
        got = decode_quads_np(segm[0], geo[0], angle[0], thresh)
        want = jax_decode_quads_np(segm[0], geo[0], angle[0], thresh)
        assert got[0].shape[0] == want[0].shape[0] > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quad_iou_matches_fots(seed):
    """Rotated, overlapping, nested, disjoint and degenerate quads."""
    rng = np.random.default_rng(seed)
    values = []
    for _ in range(60):
        c = rng.uniform(0, 40, 2)
        quads = []
        for _ in range(2):
            w, h = rng.uniform(0, 30, 2)
            t = rng.uniform(-np.pi, np.pi)
            rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
            corners = np.array([[-w, -h], [-w, h], [w, h], [w, -h]]) / 2
            quads.append(corners @ rot.T + c + rng.uniform(-15, 15, 2))
        for qa, qb in ((quads[0], quads[1]), (quads[0], quads[0]),
                       (quads[0], quads[1] + 100.0)):
            got, want = tnms.quad_iou(qa, qb), jnms.quad_iou(qa, qb)
            assert got == want
            values.append(got)
    assert min(values) == 0.0 and 0.0 < np.median(values) and max(values) > 0.99


@pytest.mark.parametrize("thresh", [0.5, 0.9])
@pytest.mark.parametrize("seed", [0, 1])
def test_get_boxes_matches_fots(seed, thresh):
    segm, geo, angle = _maps(seed)
    for b in range(segm.shape[0]):
        got = tnms.get_boxes(segm[b], geo[b], angle[b], thresh)
        want = jnms.get_boxes(segm[b], geo[b], angle[b], thresh)
        assert got.shape[0] > 0
        np.testing.assert_array_equal(got, want)
    empty = np.zeros((8, 8), np.float32)
    assert tnms.get_boxes(empty, np.zeros((8, 8, 4), np.float32),
                          np.zeros((8, 8, 2), np.float32)).shape == (0, 9)


@pytest.mark.parametrize("seed", [0, 1])
def test_get_boxes_from_candidates_matches_fots(seed):
    """The port's candidate pack with k = every pixel equals fots's and gives
    the dense boxes exactly; the u16 pack gives fots's boxes of the same
    pack."""
    segm, geo, angle = _maps(seed)
    b, h, w = segm.shape
    cands = tnms.extract_candidates(torch.from_numpy(segm), torch.from_numpy(geo),
                                    torch.from_numpy(angle), h * w, 0.9)
    want_pack = np.asarray(jnms.extract_candidates(jnp.asarray(segm), jnp.asarray(geo),
                                                   jnp.asarray(angle), h * w, 0.9))
    np.testing.assert_array_equal(cands.numpy(), want_pack)
    u16 = tnms.pack_candidates_u16(cands).numpy().view(np.uint16)
    for i in range(b):
        dense = tnms.get_boxes(segm[i], geo[i], angle[i], 0.9)
        assert dense.shape[0] > 0
        np.testing.assert_array_equal(
            tnms.get_boxes_from_candidates(cands[i].numpy(), h, w, 0.9), dense)
        np.testing.assert_array_equal(dense, jnms.get_boxes(segm[i], geo[i], angle[i], 0.9))
        np.testing.assert_array_equal(
            tnms.get_boxes_from_candidates(u16[i], h, w, 0.9),
            jnms.get_boxes_from_candidates(u16[i], h, w, 0.9))


# --------------------------------------------------------------------------
# detect_maps
# --------------------------------------------------------------------------

def test_detect_maps_matches_fots():
    """A seeded fots initialisation carried over; f32 at 96x128, given as
    normalized f32 and as u8 pixels."""
    jm = JaxDetector(nclass=87)
    jv = jax.tree.map(np.asarray, jax_init_detector(jm, jax.random.PRNGKey(3)))
    model = FOTSDetector(nclass=87)
    model.load_state_dict(state_dict_from_fots(jv["params"], jv.get("batch_stats")))
    ref = JaxInference(jm, jv)
    pixels = np.random.default_rng(3).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    norm = pixels.astype(np.float32) / 128.0 - 1.0
    want = ref.detect_maps(norm)
    with FOTSInference(model, device="cpu") as port:
        got = port.detect_maps(norm)
        got_u8 = port.detect_maps(pixels)
    assert [g.shape for g in got[:3]] == [(2, 24, 32), (2, 24, 32, 4), (2, 24, 32, 2)]
    assert all(g.dtype == np.float32 and isinstance(g, np.ndarray) for g in got[:3])
    for g, w, atol in zip(got[:3], want[:3], (1e-4, 1e-4 * np.abs(want[1]).max(), 5e-4)):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    for g, w in zip(got, got_u8):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    focr, want_focr = got[3], np.asarray(want[3])
    assert isinstance(focr, torch.Tensor)
    assert tuple(focr.shape) == want_focr.shape == (2, 24, 32, 64)
    np.testing.assert_allclose(focr.numpy(), want_focr, rtol=0,
                               atol=1e-5 * np.abs(want_focr).max())


@pytest.fixture(scope="module")
def scenes():
    ims = [cv2.imread(os.path.join(REPO, "data", "synth", f"img_00{i}.jpg")) for i in range(2)]
    return host_letterbox(ims, SCENE_HW)[0].astype(np.float32) / 128.0 - 1.0


def test_dense_boxes_and_texts_match_fots(scenes):
    """The shipped snapshot: boxes from detect_maps' maps and texts from the
    raw focr map, against fots; within the port, the dense path against the
    candidate path (f32 transport) on the same batch."""
    jm = JaxDetector(nclass=87)
    jv, _ = jax_load_serving_params(SNAPSHOT, jax_init_detector(jm, jax.random.PRNGKey(0)))
    ref = JaxInference(jm, jv, masked_norm=True)
    jsegm, jrbox, jangle, jfocr = ref.detect_maps(scenes)
    model, _, config = load_detector(SNAPSHOT, "cpu")
    assert config["masked_norm"]
    with FOTSInference(model, masked_norm=True, cand_transport="f32", device="cpu") as port:
        segm, rbox, angle, focr = port.detect_maps(scenes)
        sparse, packed = port.detect_boxes_batch(scenes)
        n_boxes = 0
        for i in range(len(scenes)):
            boxes = tnms.get_boxes(segm[i], rbox[i], angle[i])
            want = jnms.get_boxes(jsegm[i], jrbox[i], jangle[i])
            assert boxes.shape == want.shape
            np.testing.assert_allclose(boxes[:, :8], want[:, :8], rtol=0, atol=0.5)
            np.testing.assert_array_equal(boxes, sparse[i])
            hs, ws = segm.shape[1:]
            cands = tnms.extract_candidates(*(torch.from_numpy(a[i:i + 1])
                                              for a in (segm, rbox, angle)), hs * ws, 0.5)
            np.testing.assert_array_equal(
                tnms.get_boxes_from_candidates(cands[0].numpy(), hs, ws), boxes)
            texts = port.recognize_boxes(boxes, focr, batch_index=i)
            assert texts == ref.recognize_boxes(boxes, jfocr, batch_index=i)
            assert texts == port.recognize_boxes(boxes, packed, batch_index=i)
            assert isinstance(packed, PackedFocr)
            n_boxes += boxes.shape[0]
            assert sum(bool(t) for t in texts) >= 2
    assert n_boxes >= 5
