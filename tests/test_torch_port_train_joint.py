"""Training from scratch, checkpoints and resume in the port (CPU).

- ``init_detector`` against ``fots.models.detector.init_detector``: the same
  keys and shapes through the snapshot maps, the same zeros and ones, and
  every kernel's std within 10% of sqrt(1 / fan_in) with no value past 2
  std (the draws themselves cannot match JAX's);
- checkpoints: a round trip of weights, BatchNorm statistics and Adam's
  state, ``latest_checkpoint``; one step after a restore equals one step of
  the trainer that never stopped, bit for bit (same batch, same random
  streams);
- a ``fots`` TrainState one optax step past the shipped snapshot, carried by
  ``train_state_from_fots``: equal weights and moments, then one more step
  in each package on the same batch (eval mode, as the whole-step test in
  ``test_torch_port_train_step.py`` runs): every parameter within 2e-5 of
  fots's, an Adam step being 1e-4 here (measured: at most 4.7e-6, where the
  two packages' gradients differ by up to 3e-2 of a tensor's max);
- ``fots_torch.cli.train_joint`` at 128x128 on the CPU: 3 steps, a
  checkpoint, a resume that continues the global step, and
  ``load_engine`` on the run's directory and on a ``step_N``.
"""

import copy
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.losses import ctc_loss as jax_ctc_loss
from fots.losses import detection_loss as jax_detection_loss
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.ops.rroi_align import rroi_align as jax_rroi_align
from fots.roirotate import MAX_LABEL_LEN, MAX_ROIS
from fots.train import _unpack_device_batch
from fots_torch import checkpoint as tck
from fots_torch import tracing
from fots_torch import train as ttrain
from fots_torch.cli import train_joint
from fots_torch.cli.detect import load_engine
from fots_torch.codec import LabelCodec
from fots_torch.losses import repeat_infeasible_rows
from fots_torch.models.detector import FOTSDetector, init_detector
from fots_torch.roirotate import POOLED_HEIGHT, sample_rois

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")
CROP = (128, 160, 192, 352)  # y0, x0, H, W: three words of two asset scenes
LR = 1e-4


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and a CPU training step that spreads over every core of a shared host
    stalls on its own threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flat(tree, group):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {group + "/" + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


def test_init_from_scratch_matches_flax_defaults():
    jv = jax_init_detector(JaxDetector(nclass=87), jax.random.PRNGKey(0))
    want = tck.state_dict_from_flat({**_flat(jv["params"], "params"),
                                     **_flat(jv["batch_stats"], "batch_stats")})
    model = init_detector(FOTSDetector(nclass=87), torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(want)
    n_kernels = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if w.ndim == 4:  # a conv kernel: the distribution, not the values
            o, i, kh, kw = g.shape
            std = math.sqrt(1.0 / (kh * kw * i))
            assert abs(float(g.std()) / std - 1) <= 0.1, (name, float(g.std()), std)
            assert abs(float(w.std()) / std - 1) <= 0.1, name  # flax's own draw
            assert float(g.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7, name
            n_kernels += 1
        else:  # biases, scales, running statistics: exact zeros and ones
            assert torch.equal(g, w), name
    assert n_kernels == sum(1 for w in want.values() if w.ndim == 4) > 60


def _cropped_batch():
    with np.load(SMOKE_IMAGES) as z:
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


def _scratch_trainer(seed=0):
    return ttrain.Trainer(learning_rate=LR, seed=seed, use_predicted_rois=False, device="cpu")


def _payload(trainer):
    return tck.checkpoint_payload(trainer.model, trainer.optimizer, trainer.global_step)


def _assert_payload_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_checkpoint_round_trip_and_resume_equal_to_never_stopping(tmp_path):
    batch = _cropped_batch()
    a = _scratch_trainer()
    with torch.no_grad():  # an Adam update from random gradients gives it state
        for p in a.model.parameters():
            p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
    a.optimizer.step()
    a.global_step = 1
    path = tck.save_checkpoint(str(tmp_path), a, a.global_step)
    assert os.path.basename(path) == "step_1"
    for name in ("step_12", "step_3"):  # the largest N wins, not the last written
        (tmp_path / name).mkdir()
        (tmp_path / name / tck.CHECKPOINT_FILE).write_bytes(b"")
    (tmp_path / "step_99").mkdir()  # no state file: not a checkpoint
    assert tck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_12")
    assert tck.latest_checkpoint(str(tmp_path / "none")) is None
    saved = _payload(a)
    assert any(k.startswith("exp_avg_sq/") for k in saved)
    assert all(float(v) == 1.0 for k, v in saved.items() if k.startswith("adam_step/"))

    b = _scratch_trainer(seed=5)  # other weights, no Adam state yet
    assert tck.restore_checkpoint(path, b) == 1 and b.global_step == 1
    _assert_payload_equal(_payload(b), saved)
    # the same random streams from here on; then one step in each
    b._gen.set_state(a._gen.get_state())
    b._np_rng = copy.deepcopy(a._np_rng)
    a.step(batch)
    b.step(batch)
    _assert_payload_equal(_payload(b), _payload(a))
    assert [h["step"] for h in b.history] == [1] and b.global_step == 2


def _jax_grad_fn(model, batch_stats, batch, strip_width):
    """fots/train.py's loss_fn at train=False (masked_norm, multi-scale,
    the reference CTC frame window)."""

    def loss_fn(params):
        variables = {"params": params, "batch_stats": batch_stats}
        out = model.apply(variables, batch["images"], train=False)
        det = jax_detection_loss(out, batch["score_maps"], batch["training_masks"],
                                 batch["geo_maps"], batch["angle_gt"], multi_scale=True)
        rois = batch["rois"]
        strips = jax_rroi_align(out["focr"], rois, POOLED_HEIGHT, strip_width, 0.25)
        valid_w = jnp.clip(jnp.ceil(POOLED_HEIGHT * rois[:, 4] / jnp.maximum(rois[:, 3], 1e-6)),
                           1, strip_width).astype(jnp.int32)
        logp = model.apply(variables, strips, train=False, method=JaxDetector.recognize,
                           valid_w=valid_w)
        aspect = jnp.where(batch["roi_mask"] > 0, rois[:, 4] / jnp.maximum(rois[:, 3], 1e-6),
                           0.0)
        t_ref = jnp.clip(jnp.ceil(POOLED_HEIGHT * jnp.max(aspect)), 1.0,
                         float(strip_width)).astype(jnp.int32)
        ctc = jax_ctc_loss(logp, batch["labels"], batch["label_lengths"],
                           logit_lengths=jnp.full((logp.shape[0],), t_ref),
                           roi_mask=batch["roi_mask"])
        return det["total"] + ctc

    return jax.jit(jax.grad(loss_fn))


def test_fots_train_state_carried_across_then_one_more_step():
    from flax.training import train_state

    batch = _cropped_batch()
    roi = sample_rois(np.random.default_rng(0), batch.score_maps, batch.gt_idxs,
                      batch.gt_quads, batch.labels, batch.images.shape[1:3], LabelCodec())
    host = ttrain.pack_host_batch(batch, roi)
    hw = batch.images.shape[1:3]

    jm = JaxDetector(nclass=87, stem_s2d=False)
    jv, _ = jax_load_serving_params(SNAPSHOT, jax_init_detector(jm, jax.random.PRNGKey(0)))
    jbatch = _unpack_device_batch(*[jnp.asarray(a) for a in host], hw, MAX_ROIS, MAX_LABEL_LEN)
    grad_fn = _jax_grad_fn(jm, jv["batch_stats"], jbatch, roi.strip_width)
    state = train_state.TrainState.create(apply_fn=jm.apply, params=jv["params"],
                                          tx=optax.adam(LR, b1=0.5, b2=0.999))
    state = state.apply_gradients(grads=grad_fn(state.params))  # the TrainState after a step

    payload = tck.train_state_from_fots(jax.device_get(state.params),
                                        jax.device_get(jv["batch_stats"]),
                                        jax.device_get(state.opt_state), int(state.step))
    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    trainer = ttrain.Trainer(model, learning_rate=LR, device="cpu")
    assert tck.load_payload(trainer.model, trainer.optimizer, payload) == 1
    mu = state.opt_state[0].mu
    for key, v in _flat(state.params, "params").items():
        name = tck.torch_key(key)
        layout = (lambda a: a.transpose(3, 2, 0, 1)) if v.ndim == 4 else (lambda a: a)
        p = dict(trainer.model.named_parameters())[name]
        np.testing.assert_array_equal(p.detach().numpy(), layout(v), err_msg=key)
        st = trainer.optimizer.state[p]
        assert float(st["step"]) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), layout(_flat(mu, "params")[key]))

    # one more step in each, on the same batch, eval mode
    state = state.apply_gradients(grads=grad_fn(state.params))
    trainer.model.eval()
    frames = ttrain.ctc_frame_count(roi.rois, roi.roi_mask, roi.strip_width)
    rows = repeat_infeasible_rows(roi.labels, roi.label_lengths,
                                  np.full(len(roi.roi_mask), frames))
    tbatch = ttrain.unpack_device_batch(*[torch.from_numpy(a) for a in host], hw)
    trainer.optimizer.zero_grad()
    total, _, _ = ttrain.train_losses(trainer.model, tbatch, roi.strip_width, frames,
                                      optax_rows=rows)
    total.backward()
    trainer.optimizer.step()
    params = dict(trainer.model.named_parameters())
    worst = 0.0
    for key, v in _flat(state.params, "params").items():
        got = params[tck.torch_key(key)].detach().numpy()
        if v.ndim == 4:
            got = got.transpose(2, 3, 1, 0)
        worst = max(worst, float(np.abs(got - v).max()))
    assert worst <= 2e-5, worst


@pytest.fixture(scope="module")
def scene_list(tmp_path_factory):
    with np.load(SMOKE_IMAGES) as z:
        names = [str(n) for n in z["names"]]
    path = tmp_path_factory.mktemp("scenes") / "smoke.txt"
    path.write_text("".join(os.path.join(REPO, "data", "synth", n) + "\n" for n in names))
    return str(path)


def test_train_joint_cli_from_scratch_checkpoint_resume_and_eval(scene_list, tmp_path, capsys):
    save = str(tmp_path / "run")
    common = ["-train_list", scene_list, "-images_npz", SMOKE_IMAGES, "-save_path", save,
              "-batch_size", "2", "-input_size", "128", "-checkpoint_every", "2",
              "-num_readers", "1", "-disp_interval", "1", "-seed", "0", "-device", "cpu"]
    tracing.reset()
    with tracing.enable():
        trainer = train_joint.main(common + ["-max_iters", "3", "-no_masked_norm"])
    assert [h["step"] for h in trainer.history] == [0, 1, 2]
    assert trainer.global_step == 3 and trainer.dropped_samples == 0
    # one span per fetched batch: the main thread's wait, the reader's time
    fetched = [s for s in tracing.spans() if s.name == "train.fetch"]
    assert len(fetched) == 3
    assert all(s.end_ns >= s.start_ns and s.attrs["make_s"] > 0 and s.attrs["made_at"] > 0
               for s in fetched)
    # and its reader's stages: no decode from the archive
    stages = [tuple(s.attrs[k] for k in ("decode_s", "augment_s", "targets_s")) for s in fetched]
    assert len(stages) == 3
    assert all(d == 0 and a > 0 and t > 0 for d, a, t in stages)
    tracing.reset()
    assert all(np.isfinite([h[k] for k in ttrain.METRIC_KEYS]).all() for h in trainer.history)
    assert sorted(os.listdir(save)) == ["step_2", "step_3", "train_config.json"]
    with open(os.path.join(save, "train_config.json")) as f:
        assert json.load(f) == {"masked_norm": False}
    step_3 = tck.read_checkpoint(os.path.join(save, "step_3"))
    _assert_payload_equal(_payload(trainer), step_3)

    # resume: the global step continues, max_iters stays a global bound
    args, resumed = train_joint.build(common + ["-max_iters", "3", "-no_masked_norm", "-model",
                                                os.path.join(save, "step_2")])
    assert resumed.global_step == 2
    _assert_payload_equal(_payload(resumed), tck.read_checkpoint(os.path.join(save, "step_2")))
    train_joint.run(args, resumed)
    assert [h["step"] for h in resumed.history] == [2]
    assert "resumed from" in capsys.readouterr().out
    _assert_payload_equal(_payload(resumed), tck.read_checkpoint(os.path.join(save, "step_3")))

    # the run's directory serves, with train_config.json's masked_norm
    with load_engine(save, device="cpu") as engine:
        assert engine.masked_norm is False
    with open(os.path.join(save, "train_config.json"), "w") as f:
        json.dump({"masked_norm": True}, f)
    with load_engine(os.path.join(save, "step_3"), device="cpu") as engine:
        assert engine.masked_norm is True
        with np.load(SMOKE_IMAGES) as z:
            im = z["images"][0]
        results, _ = engine(im[:256, :384])
        assert isinstance(results, list)


def test_train_joint_reader_pixels_and_targets_equal_fots(scene_list):
    """The CLI's reader at its test settings (one worker, seed 0, 128 px
    augmented crops) makes the batches ``fots``'s does from the same draws:
    targets and augmented pixels byte for byte."""
    from fots.data.detection import detection_generator as fots_generator
    from fots_torch.data.detection import detection_generator

    got = detection_generator(scene_list, SMOKE_IMAGES, input_size=128, batch_size=2, seed=0)
    want = fots_generator(scene_list, input_size=128, batch_size=2, seed=0)
    for _ in range(3):
        a, b = next(got), next(want)
        for k in ("images", "score_maps", "geo_maps", "training_masks", "gt_idxs"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        assert a.labels == b.labels


def test_train_joint_refuses_missing_pixels_and_defaults_to_cuda(scene_list, tmp_path,
                                                                monkeypatch):
    bad = tmp_path / "bad.txt"
    bad.write_text(open(scene_list).read() + os.path.join(REPO, "data", "synth",
                                                          "img_012.jpg") + "\n")
    argv = ["-train_list", str(bad), "-images_npz", SMOKE_IMAGES, "-save_path",
            str(tmp_path / "run"), "-max_iters", "1", "-device", "cpu"]
    with pytest.raises(FileNotFoundError, match="no pixels"):
        train_joint.main(argv)
    with pytest.raises(SystemExit):  # -n_data 2 without a process group
        train_joint.main(argv[:2] + argv[4:] + ["-n_data", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_joint.main(argv[:-2])
