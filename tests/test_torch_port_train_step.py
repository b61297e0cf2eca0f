"""The port's whole training step against fots, and the training slice's
plumbing (CPU).

The whole step: the shipped snapshot in both packages, two asset scenes
cropped to 192x352 (targets with them; three words inside), ground-truth
rois from one numpy seed.  The models run in eval mode (dropout off,
BatchNorm on running statistics), as ``model.apply(..., train=False)``
does, since random streams cannot match across frameworks; train mode is
held against flax per module in ``test_torch_port_train_ops.py``.  The
JAX model runs its canonical stem (``stem_s2d=False``), the formulation
the port implements.

Tolerances (f32): the five loss terms within 1e-5 (relative and
absolute); one Adam update within 1e-6 of optax's.  Gradients, each limit
a few times above what this test reads (port against fots's canonical
stem, f32, CPU): every parameter tensor within 5e-3 of its norm
(``||g - g_jax|| <= 5e-3 ||g_jax||``; reads 2.2e-3 at worst) and within
3e-2 of its largest |g| element-wise (reads 1.1e-2 at worst); the median
tensor within 2e-4 of its norm and 2e-4 of its largest |g| (read 7.8e-5
and 8.3e-5).  The worst tensors are InstanceNorm biases, whose gradient
is a sum through ReLU gates that cancels near the snapshot's optimum, so
a per-element ``1e-4 * max|g|`` for every tensor is below what f32
resolves here: fots's own two stems (s2d and canonical, the same
function) differ by up to 4.5e-3 of a tensor's largest element.  The
operators alone are held at 1e-4 of max|g| in
``test_torch_port_train_ops.py``.  The training asset is regenerated and
must be equal, pixels included.
"""

import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.losses import ctc_loss as jax_ctc_loss
from fots.losses import detection_loss as jax_detection_loss
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector
from fots.ops.rroi_align import rroi_align as jax_rroi_align
from fots_torch import checkpoint as tck
from fots_torch import train as ttrain
from fots_torch.codec import LabelCodec
from fots_torch.losses import repeat_infeasible_rows
from fots_torch.roirotate import POOLED_HEIGHT, sample_rois

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
CROP = (128, 160, 192, 352)  # y0, x0, H, W (multiples of 32 and of 4)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _cropped_batch():
    with np.load(os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images = z["images"]
    with np.load(os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")) as z:
        targets = {k: z[k] for k in z.files}
    b = ttrain.asset_batch(images, targets, [0, 1])
    y0, x0, h, w = CROP
    ys, xs = slice(y0 // 4, (y0 + h) // 4), slice(x0 // 4, (x0 + w) // 4)
    return ttrain.DetectionBatch(
        images=np.ascontiguousarray(b.images[:, y0:y0 + h, x0:x0 + w]),
        score_maps=b.score_maps[:, ys, xs], geo_maps=b.geo_maps[:, ys, xs],
        training_masks=b.training_masks[:, ys, xs], gt_idxs=b.gt_idxs[:, ys, xs],
        gt_quads=[[q - np.float32([x0, y0]) for q in s] for s in b.gt_quads],
        labels=b.labels)


@pytest.fixture(scope="module")
def step_inputs():
    batch = _cropped_batch()
    roi = sample_rois(np.random.default_rng(0), batch.score_maps, batch.gt_idxs,
                      batch.gt_quads, batch.labels, batch.images.shape[1:3], LabelCodec())
    assert int(roi.roi_mask.sum()) == 3
    return batch, roi, ttrain.pack_host_batch(batch, roi)


def _jax_loss_fn(model, batch_stats, batch, strip_width):
    """fots/train.py's loss_fn at train=False (its masked_norm, multi-scale,
    reference CTC frame window)."""

    def loss_fn(params):
        variables = {"params": params, "batch_stats": batch_stats}
        out = model.apply(variables, batch["images"], train=False)
        det = jax_detection_loss(out, batch["score_maps"], batch["training_masks"],
                                 batch["geo_maps"], batch["angle_gt"], multi_scale=True)
        rois = batch["rois"]
        strips = jax_rroi_align(out["focr"], rois, POOLED_HEIGHT, strip_width, 0.25)
        aspect_all = rois[:, 4] / jnp.maximum(rois[:, 3], 1e-6)
        valid_w = jnp.clip(jnp.ceil(POOLED_HEIGHT * aspect_all), 1,
                           strip_width).astype(jnp.int32)
        logp = model.apply(variables, strips, train=False, method=JaxDetector.recognize,
                           valid_w=valid_w)
        aspect = jnp.where(batch["roi_mask"] > 0, rois[:, 4] / jnp.maximum(rois[:, 3], 1e-6),
                           0.0)
        t_ref = jnp.clip(jnp.ceil(POOLED_HEIGHT * jnp.max(aspect)), 1.0,
                         float(strip_width)).astype(jnp.int32)
        ctc = jax_ctc_loss(logp, batch["labels"], batch["label_lengths"],
                           logit_lengths=jnp.full((logp.shape[0],), t_ref),
                           roi_mask=batch["roi_mask"])
        total = det["total"] + ctc
        return total, {"loss": total, "segm_loss": det["segm"], "angle_loss": det["angle"],
                       "iou_loss": det["iou"], "ctc_loss": ctc}

    return loss_fn


def _flat(tree, group="params"):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {group + "/" + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


def test_train_step_loss_and_gradients_match_fots(step_inputs):
    batch, roi, host = step_inputs
    hw = batch.images.shape[1:3]
    jm = JaxDetector(nclass=87, stem_s2d=False)
    jv, _ = jax_load_serving_params(SNAPSHOT, init_detector(jm, jax.random.PRNGKey(0)))
    jbatch = jtrain_unpack(host, hw)
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jm, jv["batch_stats"], jbatch, roi.strip_width), has_aux=True))(
        jv["params"])

    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    frames = ttrain.ctc_frame_count(roi.rois, roi.roi_mask, roi.strip_width)
    rows = repeat_infeasible_rows(roi.labels, roi.label_lengths,
                                  np.full(len(roi.roi_mask), frames))
    tbatch = ttrain.unpack_device_batch(*[torch.from_numpy(a) for a in host], hw)
    _, got, _ = ttrain.train_losses(model, tbatch, roi.strip_width, frames, optax_rows=rows)
    got["loss"].backward()
    for k in ttrain.METRIC_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]), **F32_TOL, err_msg=k)
    assert float(want["ctc_loss"]) > 0
    grads = {n: p.grad for n, p in model.named_parameters()}
    flat = _flat(jgrads)
    assert len(flat) == len(grads)
    norm_err, elem_err = {}, {}
    for key, g in flat.items():
        gt = grads[tck.torch_key(key)].numpy()
        if g.ndim == 4:
            gt = gt.transpose(2, 3, 1, 0)
        norm_err[key] = float(np.linalg.norm(gt - g) / np.linalg.norm(g))
        elem_err[key] = float(np.abs(gt - g).max()) / (float(np.abs(g).max()) + 1e-30)
        assert norm_err[key] <= 5e-3, (key, norm_err[key])
        assert elem_err[key] <= 3e-2, (key, elem_err[key])
    assert float(np.median(list(norm_err.values()))) <= 2e-4
    assert float(np.median(list(elem_err.values()))) <= 2e-4


def jtrain_unpack(host, hw):
    from fots.roirotate import MAX_LABEL_LEN, MAX_ROIS
    from fots.train import _unpack_device_batch

    return _unpack_device_batch(*[jnp.asarray(a) for a in host], hw, MAX_ROIS, MAX_LABEL_LEN)


def test_adam_update_matches_optax():
    """torch.optim.Adam(lr, betas=(0.5, 0.999), eps=1e-8) = optax.adam(lr,
    b1=0.5, b2=0.999) over three steps."""
    rng = np.random.default_rng(50)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    tx = optax.adam(1e-3, b1=0.5, b2=0.999)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.Adam([p], lr=1e-3, betas=(0.5, 0.999), eps=1e-8)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_trainer_runs_pipelined_on_cpu(step_inputs):
    """Three pipelined steps: metrics for each, predicted candidates carried
    to the next step's sampler, BatchNorm statistics updated, and
    parameters moved."""
    batch = step_inputs[0]
    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = ttrain.Trainer(model, learning_rate=1e-4, seed=3, device="cpu")
    assert trainer.model.training
    trainer.train([batch] * 3, max_steps=3, log_every=0)
    assert len(trainer.history) == 3
    assert all(np.isfinite(list(h.values())).all() for h in trainer.history)
    assert trainer.metrics["loss"].count == 3
    cands, hw = trainer._prev_cands
    assert cands.numpy().shape == (2, 8, 128) and hw == batch.score_maps.shape[1:]
    after = trainer.model.state_dict()
    assert not torch.equal(after["layer2.0.down_bn.running_mean"],
                           before["layer2.0.down_bn.running_mean"])
    assert not torch.equal(after["ocr.conv11.weight"], before["ocr.conv11.weight"])


def test_trainer_goes_past_a_failing_batch(step_inputs, capsys):
    """As fots/train.py does: a batch whose roi sampling raises (its labels
    do not cover its quads) is reported with its traceback and skipped; it
    uses up its step index, and the good batches around it train and log."""
    batch = step_inputs[0]
    bad = ttrain.DetectionBatch(**{**vars(batch), "labels": [[] for _ in batch.labels]})
    with pytest.raises(IndexError):
        sample_rois(np.random.default_rng(0), bad.score_maps, bad.gt_idxs, bad.gt_quads,
                    bad.labels, bad.images.shape[1:3], LabelCodec())
    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    trainer = ttrain.Trainer(model, learning_rate=1e-4, seed=3, device="cpu")
    trainer.train([batch, bad, batch], max_steps=3, log_every=1)
    out, err = capsys.readouterr()
    assert "Traceback" in err and "IndexError" in err
    logged = [line.split()[1] for line in out.splitlines() if line.startswith("step ")]
    assert logged == ["0", "2"]
    assert len(trainer.history) == 2 and trainer.metrics["loss"].count == 2
    assert all(np.isfinite(list(h.values())).all() for h in trainer.history)


def test_entry_points_default_to_cuda(monkeypatch):
    """load_detector and Trainer run on the card unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.load_detector(SNAPSHOT)
    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.Trainer(model)


def test_serving_params_round_trip_key_by_key(tmp_path):
    """A port model written by save_serving_params reads back key by key,
    through fots_torch.checkpoint and through fots.checkpoint."""
    flat, step, config = tck.load_serving_params(SNAPSHOT)
    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    back = tck.flat_from_state_dict(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == np.float32
    with torch.no_grad():  # stand-in for training: move every tensor
        for t in model.state_dict().values():
            t.add_(0.25)
    path = tck.save_serving_params(str(tmp_path / "trained.npz"), model, step=7,
                                   config={"masked_norm": True})
    flat2, step2, config2 = tck.load_serving_params(path)
    assert (step2, config2) == (7, {"masked_norm": True})
    for k, v in flat.items():
        np.testing.assert_array_equal(flat2[k], v + np.float32(0.25), err_msg=k)
    again, _, _ = tck.load_detector(path, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    jm = JaxDetector(nclass=87)
    jv, jstep = jax_load_serving_params(path, init_detector(jm, jax.random.PRNGKey(0)))
    assert jstep == 7
    for group in ("params", "batch_stats"):
        for k, v in _flat(jv[group], group).items():
            np.testing.assert_array_equal(v, flat2[k], err_msg=k)
    assert tck.flat_key("layer2.0.down_bn.weight", 1, {"layer2.0.down_bn"}) == \
        "params/layer2_0/down_bn/bn/scale"
    assert tck.flat_key("stem.crelu0a.norm.bias", 1, set()) == "params/stem/crelu0a/in/bias"


def test_training_asset_regenerates_equal():
    spec = importlib.util.spec_from_file_location(
        "make_torch_train_targets", os.path.join(REPO, "tools", "make_torch_train_targets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = mod.make_targets()
    with np.load(os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    with np.load(os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        np.testing.assert_array_equal(z["names"], want["names"])
