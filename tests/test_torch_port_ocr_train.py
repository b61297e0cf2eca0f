"""The recognition-only trainers and their crop pipeline against fots (CPU).

- ``ocr_crop_generator``: the port reads the crop archive
  (``fots_torch/assets/ocr_crops_u8.npz``), fots reads the same crops
  written out as PNGs with a ``gt.txt``.  With ``in_train=False`` every
  batch is identical (images, labels, lengths, texts, bucket order); with
  ``in_train=True`` and one seed the buckets, labels, texts and pixels are
  identical (the port's ``warpAffine`` and HSV -> BGR are OpenCV's byte for
  byte).
- One step of each trainer, the same weights on both sides (carried across
  from fots's tree), with dropout off: fots's recognizer step draws dropout
  from a JAX key that the port cannot replay, so its loss and gradients are
  taken from ``recognize(train=False)`` outside its jitted step, as
  ``tests/test_torch_port_train_step.py`` does for the joint step; the
  CRNNs have no dropout and run in train mode (BatchNorm on the batch's
  statistics).  The loss within 1e-4 relative.  Gradients: each tensor
  within 1e-4 of its largest |g| (read: 2.5e-5 at worst; the CTC gradients
  of ``F.ctc_loss`` and optax alone differ by 1.7e-5 of theirs), but for
  ``CRNNE2ETrainer``, whose 32 wide strips hold near-tied pool maxima (see
  its test), held by norm; a bias in front of a train-mode BatchNorm (true
  gradient 0) only as small as fots's.  Every parameter after one Adam step
  (optax's update applied to fots's gradients) within
  ``test_torch_port_train_step.py``'s ``F32_TOL`` (rtol = atol = 1e-5)
  where the gradient's sign is resolved, else within 2 lr (Adam's first
  step moves by +-lr); CRNN BatchNorm statistics within 1e-4 relative.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.codec import LabelCodec as JaxLabelCodec
from fots.data import ocr_crops as jcrops
from fots.losses import ctc_loss as jax_ctc_loss
from fots.models import CRNN as JaxCRNN
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.models.own import OwnModel as JaxOwnModel
from fots.ops.rroi_align import rroi_align as jax_rroi_align
from fots.train_ocr import OcrTrainState
from fots.train_ocr import build_gt_crop_batch as jax_build_gt_crop_batch
from fots_torch import checkpoint as tck
from fots_torch.data import ocr_crops as tcrops
from fots_torch.models import CRNN, OwnModel
from fots_torch.train import asset_batch
from fots_torch.train_ocr import CRNNE2ETrainer, CRNNTrainer, FOTSRecognizerTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROPS = os.path.join(REPO, "fots_torch", "assets", "ocr_crops_u8.npz")
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-4
LR = 1e-4


@pytest.fixture(scope="module")
def crop_lists(tmp_path_factory):
    """Each split's crops as PNG files with a fots-style ``gt.txt``."""
    root = tmp_path_factory.mktemp("crops")
    lists = {}
    for split in tcrops.SPLITS:
        d = root / split
        d.mkdir()
        with open(d / "gt.txt", "w", encoding="utf-8") as f:
            for i, (im, txt) in enumerate(tcrops.load_crops(CROPS, split)):
                cv2.imwrite(str(d / f"c{i:04d}.png"), im)
                f.write(f'c{i:04d}.png, "{txt}"\n')
        lists[split] = str(d / "gt.txt")
    return lists


def test_crop_list_parsing_and_buckets_match_fots(crop_lists):
    texts = [t for _, t in tcrops.load_crops(CROPS, "eval")]
    parsed = tcrops.parse_crop_list(crop_lists["eval"])
    assert parsed == jcrops.parse_crop_list(crop_lists["eval"])
    assert [t for _, t in parsed] == texts and len(texts) == 58
    assert tcrops.BUCKETS == jcrops.BUCKETS
    for bs in (1, 4, 8, 32):
        assert tcrops.batch_sizes_per_bucket(bs) == jcrops.batch_sizes_per_bucket(bs)
    for w in (0, 11, 12, 13, 14, 250, 1000):
        assert tcrops.best_bucket(w) == jcrops.best_bucket(w)


def test_numpy_resize_is_byte_exact_against_cv2():
    """``resize_bilinear_u8`` is ``cv2.resize`` byte for byte at the crop
    generator's scales (and at the serving letterbox's 640x960 -> 704x1056):
    rows past the edge keep both of cv2's truncated weights."""
    from fots_torch.geometry import resize_bilinear_u8

    rng = np.random.default_rng(17)
    cases = [(640, 960, 704, 1056), (28, 100, 32, 112), (44, 170, 44, 168)]
    cases += [tuple(int(v) for v in rng.integers(2, 120, 4)) for _ in range(60)]
    for h, w, dh, dw in cases:
        im = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(resize_bilinear_u8(im, (dw, dh)),
                                      cv2.resize(im, (dw, dh)), err_msg=str((h, w, dh, dw)))


@pytest.mark.parametrize("norm_height", [32, 44])
def test_crop_generator_without_augmentation_equals_fots(crop_lists, norm_height):
    got = list(tcrops.ocr_crop_generator(CROPS, batch_size=4, norm_height=norm_height,
                                         in_train=False, split="eval"))
    want = list(jcrops.ocr_crop_generator(crop_lists["eval"], codec=JaxLabelCodec(),
                                          batch_size=4, norm_height=norm_height,
                                          in_train=False))
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert g["images"].dtype == w["images"].dtype == np.float32
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["label_lengths"], w["label_lengths"])
        assert g["texts"] == w["texts"]


def test_crop_generator_with_augmentation_matches_fots_within_one_level(crop_lists):
    n = 40
    gen_t = tcrops.ocr_crop_generator(CROPS, batch_size=8, norm_height=32, seed=11,
                                      split="train")
    gen_j = jcrops.ocr_crop_generator(crop_lists["train"], codec=JaxLabelCodec(), batch_size=8,
                                      norm_height=32, seed=11)
    for _ in range(n):
        g, w = next(gen_t), next(gen_j)
        assert g["images"].shape == w["images"].shape
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["label_lengths"], w["label_lengths"])
        assert g["texts"] == w["texts"]
        np.testing.assert_array_equal(g["images"], w["images"])


# --------------------------------------------------------------------------
# one step of each trainer
# --------------------------------------------------------------------------

def _flat(tree, group="params"):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {group + "/" + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


def _hold_step(trainer, loss, want_loss, jgrads, jparams, kind, prefix="", grad_rel=1e-4,
               norm_rel=None):
    """Backward and one Adam step of the port ``trainer`` against fots's loss,
    gradients (a flax tree) and parameters after optax's update.  Each
    gradient within ``grad_rel`` of its tensor's largest |g| (or, with
    ``norm_rel``, ``||g - g_fots|| <= norm_rel ||g_fots||``); a tensor whose
    fots gradient is below 1e-4 of the model's largest (a bias in front of a
    train-mode BatchNorm, whose true gradient is 0) only as small on the
    port's side.  Parameters after Adam within ``F32_TOL`` where the
    gradient's sign is resolved (|g| above 10x the tensor's gradient
    difference), within 2 lr elsewhere."""
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    trainer.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    want_g = tck.model_state_dict_from_flat(_flat(jgrads), kind, moments=True)
    params = dict(trainer.model.named_parameters())
    top = max(float(g.abs().max()) for g in want_g.values())
    errs, sure = {}, {}
    for name, g in want_g.items():
        p = params[prefix + name]
        if p.grad is None:  # no gradient reaches it: fots's is zero
            assert not g.any(), name
            continue
        d = (p.grad - g).abs()
        gmax = float(g.abs().max())
        if gmax < 1e-4 * top:
            assert float(p.grad.abs().max()) < 1e-4 * top, name
            continue
        if norm_rel is None:
            errs[name] = float(d.max()) / gmax
            assert errs[name] <= grad_rel, (name, errs[name])
        else:
            errs[name] = float(d.norm() / g.norm())
            assert errs[name] <= norm_rel, (name, errs[name])
        sure[name] = g.abs() > 10 * float(d.max())
    assert len(errs) > 10
    trainer.optimizer.step()
    after = tck.model_state_dict_from_flat(_flat(jparams), kind, moments=True)
    sd = trainer.model.state_dict()
    for name, t in after.items():
        got = sd[prefix + name]
        ok = sure.get(name, torch.ones_like(t, dtype=torch.bool))
        if name in want_g and name not in sure:
            ok = torch.zeros_like(t, dtype=torch.bool)
        np.testing.assert_allclose(got[ok].numpy(), t[ok].numpy(), **F32_TOL, err_msg=name)
        assert bool(((got - t).abs() <= 2 * LR + 1e-7).all()), name
    return errs


def _flax_crnn_vars(nclass, hidden, seed):
    """A fots CRNN's variables drawn with numpy at flax's init scales
    (kernels N(0, 1 / fan_in), vectors moved by seeded noise from flax's
    init values: biases 0, BatchNorm scale and variance 1, mean 0), shaped
    by ``jax.eval_shape`` of ``CRNN.init`` (no compile)."""
    model = JaxCRNN(nclass=nclass, hidden=hidden)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 64, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if leaf in ("scale", "var") else 0.0
        noise = rng.standard_normal(s.shape).astype(np.float32) * 0.1
        return (base + (np.abs(noise) if leaf == "var" else noise)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _crop_batch(norm_height):
    return next(tcrops.ocr_crop_generator(CROPS, batch_size=8, norm_height=norm_height,
                                          in_train=False, split="train"))


def test_crnn_trainer_step_matches_fots():
    batch = _crop_batch(32)
    jm, v = _flax_crnn_vars(87, 256, seed=0)
    params, stats = v["params"], v["batch_stats"]

    def loss_fn(p):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                            train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(out, axis=-1)
        return jax_ctc_loss(logp, jnp.asarray(batch["labels"]),
                            jnp.asarray(batch["label_lengths"])), upd["batch_stats"]

    (want, new_stats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    # fots's OcrTrainState after the step (optax's Adam applied to its grads)
    state = OcrTrainState.create(apply_fn=jm.apply, params=params, batch_stats=stats,
                                 tx=optax.adam(LR))
    state = state.apply_gradients(grads=jgrads, batch_stats=new_stats)
    jparams = state.params

    model = CRNN(nclass=87)
    model.load_state_dict(tck.state_dict_from_fots(params, stats, "crnn"))
    trainer = CRNNTrainer(lr=LR, model=model, device="cpu")
    _hold_step(trainer, trainer.loss(batch), want, jgrads, jparams, "crnn")
    for bn in ("bn2", "bn4", "bn6"):
        mod = getattr(trainer.model, bn)
        np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(new_stats[bn]["var"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(new_stats[bn]["mean"]),
                                   rtol=1e-4, atol=1e-6)

    # the TrainState carried into a fresh port trainer: its weights, statistics
    # and Adam moments are fots's, and its step count; Adam's moments equal the
    # port's own after its step to the gradients' limit (exp_avg = 0.1 g,
    # exp_avg_sq = 0.001 g^2 after one step)
    payload = tck.train_state_from_fots(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats), state.opt_state,
        int(state.step), kind="crnn")
    carried = CRNNTrainer(lr=LR, device="cpu")
    assert tck.load_payload(carried.model, carried.optimizer, payload) == 1
    own = dict(trainer.model.named_parameters())
    for name, p in carried.model.named_parameters():
        if not p.requires_grad:  # the LSTMs' frozen input biases: no moments
            assert p not in carried.optimizer.state and not p.any()
            continue
        st, mine = carried.optimizer.state[p], trainer.optimizer.state[own[name]]
        assert float(st["step"]) == float(mine["step"]) == 1.0
        if name in ("conv2.bias", "conv4.bias", "conv6.bias"):
            continue  # true gradient 0 (a bias in front of train-mode BatchNorm)
        for key, rel in (("exp_avg", 1e-4), ("exp_avg_sq", 2e-4)):
            d = float((st[key] - mine[key]).abs().max())
            assert d <= rel * float(mine[key].abs().max()), (name, key)
    sd = carried.model.state_dict()
    for name, t in trainer.model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(sd[name].numpy(), t.numpy(), rtol=1e-4, atol=1e-6)


def test_fots_recognizer_trainer_step_matches_fots_with_dropout_off():
    batch = _crop_batch(44)
    jm = JaxDetector(nclass=87)
    template = jax.eval_shape(lambda: jax_init_detector(jm, jax.random.PRNGKey(0)))
    jv, _ = jax_load_serving_params(SNAPSHOT, template)
    params, stats = jv["params"], jv["batch_stats"]

    def loss_fn(p):
        variables = {"params": p, "batch_stats": stats}
        feats = jm.apply(variables, jnp.asarray(batch["images"]),
                         method=JaxDetector.forward_features)
        logp = jm.apply(variables, feats, train=False, method=JaxDetector.recognize)
        return jax_ctc_loss(logp, jnp.asarray(batch["labels"]),
                            jnp.asarray(batch["label_lengths"]))

    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jparams = optax.apply_updates(params, upd)

    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    trainer = FOTSRecognizerTrainer(lr=LR, model=model, device="cpu")
    trainer.model.eval()  # dropout off
    assert float(want) > 0
    _hold_step(trainer, trainer.loss(batch), want, jgrads, jparams, "detector")


def test_crnn_e2e_trainer_step_matches_fots():
    """Ground-truth crops of two asset scenes (RoIRotate of the normalised
    f32 image, K4''s C = 3 pack in its plain version), one numpy seed for
    the height jitter on both sides."""
    with np.load(os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images = z["images"]
    with np.load(os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")) as z:
        targets = {k: z[k] for k in z.files}
    batch = asset_batch(images, targets, [0, 1])
    rois, labels, lengths, mask, width, _ = jax_build_gt_crop_batch(
        batch.gt_quads, batch.labels, JaxLabelCodec(), batch.images.shape[1:3],
        rng=np.random.default_rng(0))
    assert mask.sum() >= 4
    _, crnn_vars = _flax_crnn_vars(87, 256, seed=1)
    params, stats = {"crnn": crnn_vars["params"]}, {"crnn": crnn_vars["batch_stats"]}
    jm = JaxOwnModel(nclass=87)

    def loss_fn(p):
        crops = jax_rroi_align(jnp.asarray(batch.images), jnp.asarray(rois), 32, width, 1.0)
        out, _ = jm.apply({"params": p, "batch_stats": stats}, crops, train=True,
                          mutable=["batch_stats"], method=JaxOwnModel.ocr_forward)
        logp = jax.nn.log_softmax(out, axis=-1)
        return jax_ctc_loss(logp, jnp.asarray(labels), jnp.asarray(lengths),
                            roi_mask=jnp.asarray(mask))

    want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adam(LR)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jparams = optax.apply_updates(params, upd)

    model = OwnModel(nclass=87)
    model.crnn.load_state_dict(tck.state_dict_from_fots(crnn_vars["params"],
                                                        crnn_vars["batch_stats"], "crnn"))
    trainer = CRNNE2ETrainer(lr=LR, model=model, device="cpu")
    loss, crop = trainer.loss(batch, np.random.default_rng(0))
    np.testing.assert_array_equal(crop[0], rois)
    assert crop[4] == width
    # 32 strips of 256 columns hold maxima in the CRNN's pools whose two
    # largest values lie within f32 rounding of each other: torch and XLA
    # may pick different winners, which moves a whole channel's gradient in
    # the layers below (one channel of conv4 at 7.8e-3 of the tensor's max,
    # the other 511 at 7e-6; read 1.8e-2 in norm at worst, conv0).  The
    # trunk's gradients are held by norm, to 3e-2
    _hold_step(trainer, loss, want, jgrads["crnn"], jparams["crnn"], "crnn", prefix="crnn.",
               norm_rel=3e-2)
    # the detector gets no gradient and is not moved
    assert all(p.grad is None for n, p in trainer.model.named_parameters()
               if n.startswith("detector."))
