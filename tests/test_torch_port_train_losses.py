"""fots_torch losses, codec encoders, roi sampling and candidate extraction
against fots (CPU).

Inputs come from numpy seeds and from the committed training asset
(``fots_torch/assets/train_targets.npz``).  Tolerances, f32: values within
1e-5 (relative and absolute); gradients within ``1e-4 * max|g_jax| + 1e-6``
per tensor.  The one exception is the gradient of a CTC row whose
alignment is impossible through repeated characters: there both optax and
the port work at |log alpha| ~ 1e5, where f32 resolves only 2^-7, so the
path weights, and with them that row's gradient, agree within 1e-2 of its
largest magnitude (its value agrees within 1e-5).  Roi batches are
compared exactly.
"""

import os

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fots.losses as jlosses
import fots.roirotate as jroi
import fots.train as jtrain
from fots.codec import LabelCodec as JaxCodec
from fots_torch import losses as tlosses
from fots_torch import roirotate as troi
from fots_torch import train as ttrain
from fots_torch.codec import LabelCodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def assert_grad_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = rel * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= tol, (np.abs(got - want).max(), tol)


@pytest.fixture(scope="module")
def asset():
    with np.load(os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images = z["images"]
    with np.load(os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")) as z:
        targets = {k: z[k] for k in z.files}
    return images, targets


def _outputs(rng, b, h, w):
    """Random detector outputs at 1/4 and 1/8 scale (NHWC lists)."""
    out = {"segm": [], "rbox": [], "angle": []}
    for hh, ww in ((h, w), (h // 2, w // 2)):
        out["segm"].append(rng.uniform(0.02, 0.98, (b, hh, ww, 1)).astype(np.float32))
        out["rbox"].append(rng.uniform(0.5, 40.0, (b, hh, ww, 4)).astype(np.float32))
        a = rng.standard_normal((b, hh, ww, 2)).astype(np.float32)
        out["angle"].append((a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32))
    return out


def _targets(rng, b, h, w):
    score = np.zeros((b, h, w), np.float32)
    score[:, h // 4:h // 2, w // 5:3 * w // 4] = 1.0
    score[1:, 2:5, 1:4] = 1.0
    mask = (rng.uniform(size=(b, h, w)) > 0.1).astype(np.float32)
    geo = rng.uniform(0.0, 30.0, (b, h, w, 4)).astype(np.float32)
    geo[rng.uniform(size=(b, h, w, 4)) < 0.1] = -1.0      # poisoned distances
    angle = rng.uniform(-0.5, 0.5, (b, h, w)).astype(np.float32)
    return score, mask, geo, angle


@pytest.mark.parametrize("multi_scale,ohem", [(True, False), (False, False), (True, True)])
def test_detection_loss_and_gradient_match_fots(multi_scale, ohem):
    rng = np.random.default_rng(40)
    b, h, w = 2, 16, 24
    outs = _outputs(rng, b, h, w)
    score, mask, geo, angle = _targets(rng, b, h, w)

    def jfn(o):
        return jlosses.detection_loss(o, jnp.asarray(score), jnp.asarray(mask),
                                      jnp.asarray(geo), jnp.asarray(angle), multi_scale, ohem)

    jo = {k: [jnp.asarray(v) for v in vs] for k, vs in outs.items()}
    want = jfn(jo)
    want_g = jax.grad(lambda o: jfn(o)["total"])(jo)
    to = {k: [_t(v, True) for v in vs] for k, vs in outs.items()}
    got = tlosses.detection_loss(to, _t(score), _t(mask), _t(geo), _t(angle), multi_scale, ohem)
    for k in ("total", "segm", "angle", "iou"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), **F32_TOL)
    leaves = [t for vs in to.values() for t in vs]
    grads = torch.autograd.grad(got["total"], leaves, allow_unused=True)
    for t, g, wg in zip(leaves, grads, [g for k in to for g in want_g[k]]):
        g = torch.zeros_like(t) if g is None else g
        assert_grad_close(g.numpy(), wg)


def test_iou_and_dice_alone_match_fots():
    rng = np.random.default_rng(41)
    score, mask, geo, _ = _targets(rng, 2, 8, 12)
    pred = rng.uniform(0.5, 40.0, geo.shape).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.iou_loss(_t(geo), _t(score), _t(pred))),
        float(jlosses.iou_loss(jnp.asarray(geo), jnp.asarray(score), jnp.asarray(pred))),
        **F32_TOL)
    p = rng.uniform(size=score.shape).astype(np.float32)
    np.testing.assert_allclose(float(tlosses.dice_loss(_t(p), _t(score))),
                               float(jlosses.dice_loss(jnp.asarray(p), jnp.asarray(score))),
                               **F32_TOL)


def _ctc_case(rng, labels, label_lengths, frames, mask, t=12, k=9):
    logits = rng.standard_normal((len(labels), t, k)).astype(np.float32) * 2

    def jfn(lg):
        return jlosses.ctc_loss(jax.nn.log_softmax(lg, -1), jnp.asarray(labels),
                                jnp.asarray(label_lengths), jnp.asarray(frames),
                                jnp.asarray(mask))

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits))
    lg = _t(logits, True)
    got = tlosses.ctc_loss(torch.log_softmax(lg, -1), _t(labels), _t(label_lengths),
                           _t(frames), _t(mask))
    (got_g,) = torch.autograd.grad(got, lg)
    return got.item(), float(want), got_g.numpy(), np.asarray(want_g)


def test_ctc_loss_and_gradient_match_fots():
    """Feasible rows, a padded (masked) row, a row longer than its frame
    window (masked out as infeasible) and per-row frame windows."""
    rng = np.random.default_rng(42)
    labels = np.array([[1, 2, 3, 0, 0], [4, 4, 5, 6, 0], [2, 0, 0, 0, 0], [0, 0, 0, 0, 0],
                       [1, 2, 3, 4, 5]], np.int32)
    lengths = np.array([3, 4, 1, 0, 5], np.int32)
    frames = np.array([12, 12, 7, 12, 4], np.int32)
    mask = np.array([1, 1, 1, 0, 1], np.float32)
    got, want, got_g, want_g = _ctc_case(rng, labels, lengths, frames, mask)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert_grad_close(got_g, want_g)


def test_ctc_loss_repeat_infeasible_row_takes_optax_value():
    """Row 0 ("aab" in 3 frames) fits by length but needs a blank between the
    repeats: F.ctc_loss says inf, optax ~1e5; the port reproduces optax's
    value, and the feasible rows keep their exact gradients."""
    rng = np.random.default_rng(43)
    labels = np.array([[3, 3, 5, 0], [1, 2, 0, 0], [6, 6, 0, 0]], np.int32)
    lengths = np.array([3, 2, 2], np.int32)
    frames = np.array([3, 12, 12], np.int32)
    mask = np.ones(3, np.float32)
    assert list(tlosses.repeat_infeasible_rows(labels, lengths, frames)) == [0]
    got, want, got_g, want_g = _ctc_case(rng, labels, lengths, frames, mask)
    assert want > 1e4  # optax's log-epsilon clamp, divided by 3 rows
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert_grad_close(got_g[1:], want_g[1:])
    assert_grad_close(got_g[0], want_g[0], rel=1e-2)


def test_ctc_loss_optax_matches_optax_per_row():
    import optax

    rng = np.random.default_rng(44)
    logits = rng.standard_normal((3, 8, 7)).astype(np.float32)
    labels = np.array([[1, 1, 2], [3, 4, 0], [5, 5, 5]], np.int32)
    lengths = np.array([3, 2, 3], np.int32)
    frames = np.array([8, 5, 4], np.int32)
    want = optax.ctc_loss(jnp.asarray(logits),
                          (np.arange(8)[None] >= frames[:, None]).astype(np.float32),
                          jnp.asarray(labels),
                          (np.arange(3)[None] >= lengths[:, None]).astype(np.float32))
    got = tlosses.ctc_loss_optax(_t(logits), _t(labels), _t(lengths), _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_encode_padded_matches_fots_codec():
    texts = ["TOWER", "", "a b", "héllo#", "X" * 70, "7BCNTh2!"]
    want = JaxCodec().encode_padded(texts, 64)
    got = LabelCodec().encode_padded(texts, 64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(LabelCodec().encode(texts), JaxCodec().encode(texts)):
        np.testing.assert_array_equal(a, b)
    assert LabelCodec().num_classes == JaxCodec().num_classes == 87


def test_box_points_and_bounding_rect_match_cv2():
    rng = np.random.default_rng(45)
    for i in range(2000):
        c = rng.uniform(-50, 1000, 2)
        s = rng.uniform(0, 300, 2)
        a = float(rng.uniform(-180, 180))
        if i % 2:
            c, s, a = np.round(c * 4) / 4, np.round(s), float(np.round(a))
        want = cv2.boxPoints(((c[0], c[1]), (s[0], s[1]), a))
        got = troi.box_points(c, s, a)
        np.testing.assert_array_equal(got, want)
        assert troi.bounding_rect(got) == tuple(cv2.boundingRect(want))


def _predictions(batch):
    """Ground-truth geometry as a perfect prediction (so the predicted-roi
    filters pass): segm, geo [.., 4], angle (sin, cos)."""
    angle = batch.geo_maps[..., 4]
    return (batch.score_maps.astype(np.float32), batch.geo_maps[..., :4].copy(),
            np.stack([np.sin(angle), np.cos(angle)], -1).astype(np.float32))


def _assert_same_roi_batch(got, want):
    for f in ("rois", "labels", "label_lengths", "roi_mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("strip_width", "n_predicted", "n_gt"):
        assert getattr(got, f) == getattr(want, f), f


def test_sample_rois_gt_and_full_map_paths_match_fots(asset):
    images, targets = asset
    batch = ttrain.asset_batch(images, targets, [0, 1, 2, 3])
    args = (batch.score_maps, batch.gt_idxs, batch.gt_quads, batch.labels,
            batch.images.shape[1:3])
    got = troi.sample_rois(np.random.default_rng(5), *args, LabelCodec())
    want = jroi.sample_rois(np.random.default_rng(5), *args, JaxCodec())
    _assert_same_roi_batch(got, want)
    assert got.n_gt == 16 and got.n_predicted == 0
    segm, geo, ang = _predictions(batch)
    got = troi.sample_rois(np.random.default_rng(6), *args, LabelCodec(), segm_pred=segm,
                           geo_pred=geo, angle_pred=ang)
    want = jroi.sample_rois(np.random.default_rng(6), *args, JaxCodec(), segm_pred=segm,
                            geo_pred=geo, angle_pred=ang)
    _assert_same_roi_batch(got, want)
    assert got.n_predicted > 0


def test_extract_roi_candidates_and_candidate_path_match_fots(asset, monkeypatch):
    """Candidates with injected priorities (jax.random.uniform patched to
    return them) are identical; sample_rois on them then gives one RoiBatch."""
    images, targets = asset
    batch = ttrain.asset_batch(images, targets, [1, 3])
    segm, geo, ang = _predictions(batch)
    segm = segm * np.random.default_rng(7).uniform(0.6, 1.0, segm.shape).astype(np.float32)
    b, h, w = segm.shape
    pri = np.random.default_rng(8).uniform(size=(b, h * w)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype: jnp.asarray(pri))
    want = np.asarray(jtrain.extract_roi_candidates(
        jax.random.PRNGKey(0), jnp.asarray(segm), jnp.asarray(batch.score_maps),
        jnp.asarray(geo), jnp.asarray(ang)))
    got = ttrain.extract_roi_candidates(_t(segm), _t(batch.score_maps), _t(geo), _t(ang),
                                        priorities=_t(pri)).numpy()
    assert got.shape == (b, 8, 128)
    np.testing.assert_array_equal(got, want)
    args = (batch.score_maps, batch.gt_idxs, batch.gt_quads, batch.labels,
            batch.images.shape[1:3])
    rb = troi.sample_rois(np.random.default_rng(9), *args, LabelCodec(), pred_candidates=got,
                          pred_map_hw=(h, w))
    jb = jroi.sample_rois(np.random.default_rng(9), *args, JaxCodec(), pred_candidates=want,
                          pred_map_hw=(h, w))
    _assert_same_roi_batch(rb, jb)
    assert rb.n_predicted > 0


def test_pack_host_batch_round_trips_like_fots(asset):
    images, targets = asset
    batch = ttrain.asset_batch(images, targets, [2, 0])
    roi = troi.sample_rois(np.random.default_rng(1), batch.score_maps, batch.gt_idxs,
                           batch.gt_quads, batch.labels, batch.images.shape[1:3],
                           LabelCodec())
    bufs = ttrain.pack_host_batch(batch, roi)
    for a, b in zip(bufs, jtrain.pack_host_batch(batch, roi)):
        np.testing.assert_array_equal(a, b)
    got = ttrain.unpack_device_batch(*[torch.from_numpy(a) for a in bufs], (640, 960))
    want = jtrain._unpack_device_batch(*[jnp.asarray(a) for a in bufs], (640, 960),
                                       troi.MAX_ROIS, troi.MAX_LABEL_LEN)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(got["images"].numpy(), batch.images)
