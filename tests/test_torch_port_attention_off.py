"""fots's detector without the attention gate and with the single-scale loss,
``FOTSDetector(attention=False, multi_scale=False)``, in the port against
fots on the CPU.

- The forward pass of a seeded ``fots`` init carried over, for that
  configuration and the two mixed ones, and of the shipped snapshot with the
  gate's two tensors left out (written by the port, read by ``fots``), at
  ``tests/test_torch_port_detector.py``'s tolerances (segm and angle within
  1e-4, rbox within 5e-3 px at both scales, the merged features and focr
  within 1e-5 of their largest magnitude) or where a test says why not,
  within a limit derived from what the unchanged gated model reads.
- The key sets: the port's gateless state dict is ``fots``'s tree without
  ``conv_attention``; a gated tree into a gateless model raises, and the
  reverse too (``fots``'s every-key policy); checkpoints of a gateless
  trainer round-trip.
- One joint training step through ``fots``'s own ``Trainer`` and the
  port's, from the gateless snapshot on the same batch, in train mode
  (BatchNorm on the batch's statistics) with dropout's rate at 0 on both
  sides, since random streams cannot match across frameworks: the five loss
  terms within 1e-5, every gradient at
  ``tests/test_torch_port_train_step.py``'s limits (each tensor within
  5e-3 of its norm and 3e-2 of its largest element, the median tensor within
  2e-4 of both), the BatchNorm statistics within 1e-4.  The port's trainer
  takes ``multi_scale=False`` from the model, as ``fots/train.py`` does,
  on one process and on a one-rank mesh.
- Serving: ``batch_call`` of two ``data/synth`` scenes gives ``fots``'s
  boxes and texts, and ``recognize_boxes`` over their ground-truth quads
  ``fots``'s texts.  The snapshot was trained with the gate: without it its
  geometry heads read 0, so every box that passes the threshold is a point,
  recognised as an empty text, and ``batch_call`` returns none, in both; the
  boxes themselves are held within 0.5 px.  Export: a gateless bundle's programs give the eager engine's
  results.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.parallel.mesh import make_mesh as jax_make_mesh
from fots.pipeline import FOTSInference as JaxInference
from fots.pipeline import device_letterbox_batch as jax_letterbox
from fots.train import Trainer as JaxTrainer
from fots_torch import checkpoint as tck
from fots_torch import train as ttrain
from fots_torch.codec import LabelCodec
from fots_torch.export import ExportedEngine, export_serving
from fots_torch.models.detector import FOTSDetector, init_detector
from fots_torch.models.layers import Dropout
from fots_torch.models.own import OwnModel
from fots_torch.parallel import mesh as pmesh
from fots_torch.pipeline import FOTSInference, cast_params_bf16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")
TRAIN_TARGETS = os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")
SERVE_HW = (640, 960)             # the scenes' own size
CROP = (128, 160, 192, 352)       # y0, x0, H, W: three words of two asset scenes
LR = 1e-4
MAX_BOXES = 32                    # serving: the boxes an image recognises
GATE = "/conv_attention/"


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flat(tree, group):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {group + "/" + "/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in leaves}


def _gateless_port(flat):
    model = FOTSDetector(nclass=87, attention=False, multi_scale=False)
    tck.load_flat(model, flat)
    return model.eval()


@pytest.fixture(scope="module")
def gateless_flat():
    flat, _, config = tck.load_serving_params(SNAPSHOT)
    return {k: v for k, v in flat.items() if GATE not in k}, config


@pytest.fixture(scope="module")
def gateless_snapshot(gateless_flat, tmp_path_factory):
    """The shipped snapshot without the gate, written by the port."""
    flat, config = gateless_flat
    path = str(tmp_path_factory.mktemp("snap") / "gateless.npz")
    tck.save_serving_params(path, _gateless_port(flat), step=24500, config=config)
    return path


@pytest.fixture(scope="module")
def jax_gateless(gateless_snapshot):
    """fots's gateless detector and the port-written snapshot's weights."""
    jm = JaxDetector(nclass=87, attention=False, multi_scale=False)
    template = jax.eval_shape(lambda: jax_init_detector(jm, jax.random.PRNGKey(0)))
    jv, step = jax_load_serving_params(gateless_snapshot, template)
    assert step == 24500
    return jm, jv


@pytest.fixture(scope="module")
def scenes():
    return [cv2.imread(os.path.join(REPO, "data", "synth", f"img_00{i}.jpg"))
            for i in range(2)]


def _maps(out):
    return {k: [t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)
                for t in out[k]] for k in ("segm", "rbox", "angle")}


# --------------------------------------------------------------------------
# the forward pass
# --------------------------------------------------------------------------

#: tests/test_torch_port_detector.py's limits (max |diff|; features and focr
#: relative to their largest magnitude)
FORWARD_TOL = {"segm": 1e-4, "angle": 1e-4, "rbox": 5e-3, "features": 1e-5, "focr": 1e-5}


def _forward_errors(tout, jout):
    tm, jmaps = _maps(tout), _maps(jout)
    err = {f"{k}{s}": float(np.abs(tm[k][s] - jmaps[k][s]).max())
           for k in ("segm", "angle", "rbox") for s in range(2)}
    for k in ("features", "focr"):
        want = np.asarray(jout[k])
        err[k] = float(np.abs(tout[k].numpy() - want).max() / np.abs(want).max())
    return err


def _tol(key):
    return FORWARD_TOL[key.rstrip("01")]


def _carried(params, stats, attention, multi_scale):
    model = FOTSDetector(nclass=87, attention=attention, multi_scale=multi_scale)
    assert hasattr(model, "conv_attention") == attention
    assert model.multi_scale == multi_scale
    model.load_state_dict(tck.state_dict_from_fots(params, stats), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def seeded_init():
    """A seeded fots init of the gated tree at 1x64x96x3, a seeded input, and
    the gated default's own differences from fots on them.  flax draws each
    parameter from its own path's key, so the gateless init is this tree
    without ``conv_attention``."""
    jm = JaxDetector(nclass=87)
    jv = jax.device_get(jax_init_detector(jm, jax.random.PRNGKey(11),
                                          image_shape=(1, 64, 96, 3)))
    x = np.random.default_rng(5).uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
    with torch.inference_mode():
        tout = _carried(jv["params"], jv["batch_stats"], True, True)(torch.from_numpy(x))
    return jv, x, _forward_errors(tout, jm.apply(jv, x, train=False))


@pytest.mark.parametrize("attention,multi_scale", [(False, False), (False, True),
                                                   (True, False)])
def test_forward_of_a_seeded_init_matches_fots(seeded_init, attention, multi_scale):
    """Every output within the detector test's limit, or within twice the
    gated default's own difference on the same draw: a random init's deep
    residual stream and saturated heads magnify f32 rounding past the
    limits set on the trained snapshot (rbox 1e-2 px, angle 2e-4 here), and
    the unchanged default shows the same."""
    jv, x, gated_err = seeded_init
    params = {k: v for k, v in jv["params"].items() if attention or k != "conv_attention"}
    jm = JaxDetector(nclass=87, attention=attention, multi_scale=multi_scale)
    model = _carried(params, jv["batch_stats"], attention, multi_scale)
    with torch.inference_mode():
        tout = model(torch.from_numpy(x))
    jout = jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, x, train=False)
    for key, e in _forward_errors(tout, jout).items():
        assert e <= max(_tol(key), 2 * gated_err[key]), (key, e, gated_err[key])


def test_forward_of_the_gateless_snapshot_matches_fots(jax_gateless, gateless_flat, scenes):
    """The detector test's scenes at 128x256.  Every limit is the detector
    test's but the 1/4-scale segm's, 2e-4: the snapshot was trained with the
    gate, and without it the merged features reach 152 where the gated
    model's reach 119, so the score logits are larger and a logit error
    passes into segm at up to a quarter of its size (measured 1.07e-4, the
    gated snapshot 2.5e-5), while the features agree to 1.2e-6 of their
    magnitude, as the gated model's do."""
    jm, jv = jax_gateless
    x = np.asarray(jax_letterbox(np.stack(scenes), (128, 256)))
    model = _gateless_port(gateless_flat[0])
    with torch.inference_mode():
        tout = model(torch.from_numpy(x.copy()))
    for key, e in _forward_errors(tout, jm.apply(jv, x, train=False)).items():
        assert e <= (2e-4 if key == "segm0" else _tol(key)), (key, e)


def test_init_draws_no_gate_and_own_model_passes_the_fields():
    """A gateless init draws the gated model's kernels but the gate's: the
    modules after ``conv_attention`` take its draw, the ones before it are
    equal; ``OwnModel`` builds its detector with both fields, as ``fots``'s
    does."""
    gated = init_detector(FOTSDetector(), torch.Generator().manual_seed(4))
    plain = init_detector(FOTSDetector(attention=False, multi_scale=False),
                          torch.Generator().manual_seed(4))
    g, p = gated.state_dict(), plain.state_dict()
    assert set(g) - set(p) == {"conv_attention.weight", "conv_attention.bias"}
    assert torch.equal(g["upconv2.pw.weight"], p["upconv2.pw.weight"])
    assert not torch.equal(g["act.weight"], p["act.weight"])
    own = OwnModel(nclass=87, attention=False, multi_scale=False)
    assert not hasattr(own.detector, "conv_attention")
    assert own.detector.multi_scale is False and own.multi_scale is False
    assert hasattr(OwnModel().detector, "conv_attention")


# --------------------------------------------------------------------------
# weights carried across
# --------------------------------------------------------------------------

def test_key_sets_and_refusals(gateless_flat, tmp_path):
    flat, _ = gateless_flat
    full = tck.load_serving_params(SNAPSHOT)[0]
    jm = JaxDetector(nclass=87, attention=False, multi_scale=False)
    template = jax.eval_shape(lambda: jax_init_detector(jm, jax.random.PRNGKey(0)))
    want = set(_flat(template["params"], "params")) | set(_flat(template["batch_stats"],
                                                                "batch_stats"))
    assert want == {k for k in full if GATE not in k} == set(flat)
    model = FOTSDetector(attention=False, multi_scale=False)
    assert set(tck.flat_from_state_dict(model.state_dict())) == want
    with pytest.raises(KeyError, match="unused"):
        tck.load_flat(model, full)
    with pytest.raises(KeyError, match="missing"):
        tck.load_flat(FOTSDetector(), flat)
    # fots refuses both ways too
    with pytest.raises(AssertionError):
        jax_load_serving_params(SNAPSHOT, template)
    gated = jax.eval_shape(lambda: jax_init_detector(JaxDetector(nclass=87),
                                                     jax.random.PRNGKey(0)))
    path = str(tmp_path / "gateless.npz")
    tck.save_serving_params(path, _gateless_port(flat))
    with pytest.raises(KeyError):
        jax_load_serving_params(path, gated)
    # bf16 casting of a model without the gate keeps the heads in f32
    cast = cast_params_bf16(_gateless_port(flat))
    assert cast.act.weight.dtype == torch.float32
    assert cast.upconv1.pw.weight.dtype == torch.bfloat16


def test_checkpoints_of_a_gateless_trainer_round_trip(gateless_flat, tmp_path):
    a = ttrain.Trainer(_gateless_port(gateless_flat[0]), learning_rate=LR, device="cpu")
    with torch.no_grad():  # an Adam update gives the optimizer state
        for p in a.model.parameters():
            p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
    a.optimizer.step()
    a.global_step = 1
    path = tck.save_checkpoint(str(tmp_path), a, 1)
    b = ttrain.Trainer(init_detector(FOTSDetector(attention=False, multi_scale=False),
                                     torch.Generator().manual_seed(1)), device="cpu")
    assert tck.restore_checkpoint(path, b) == 1
    got, want = (tck.checkpoint_payload(t.model, t.optimizer, 1) for t in (b, a))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(KeyError, match="missing"):
        tck.restore_checkpoint(path, ttrain.Trainer(FOTSDetector(), device="cpu"))


# --------------------------------------------------------------------------
# one joint training step
# --------------------------------------------------------------------------

def _cropped_batch():
    with np.load(SMOKE_IMAGES) as z:
        images = z["images"]
    with np.load(TRAIN_TARGETS) as z:
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


def _port_trainer(flat, mesh=None):
    trainer = ttrain.Trainer(_gateless_port(flat), learning_rate=LR, seed=0,
                             use_predicted_rois=False, device="cpu", mesh=mesh)
    for mod in trainer.model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    return trainer


@pytest.fixture(scope="module")
def fots_step(jax_gateless):
    """fots's Trainer of the gateless model (its canonical stem, the one the
    port implements) one step past the gateless snapshot, dropout off."""
    import flax.linen as fnn

    class NoDropout(fnn.Dropout):
        def __call__(self, inputs, deterministic=None, rng=None):
            return inputs

    _, jv = jax_gateless
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn, "Dropout", NoDropout)
    try:
        jm = JaxDetector(nclass=87, attention=False, multi_scale=False, stem_s2d=False)
        trainer = JaxTrainer(model=jm, codec=LabelCodec(), learning_rate=LR, input_size=64,
                             seed=0, mesh=jax_make_mesh(n_data=1), use_predicted_rois=False)
        # host copies: the step donates its state's buffers
        trainer.state = trainer.state.replace(params=jax.device_get(jv["params"]),
                                              batch_stats=jax.device_get(jv["batch_stats"]))
        metrics = trainer.step(_cropped_batch())
    finally:
        mp.undo()
    mu = trainer.state.opt_state[0].mu  # (1 - b1) g after the first step: g / 2
    grads = {k: 2.0 * v for k, v in _flat(jax.device_get(mu), "params").items()}
    return metrics, grads, _flat(jax.device_get(trainer.state.batch_stats), "batch_stats")


def test_one_joint_step_matches_fots_trainer(fots_step, gateless_flat, monkeypatch):
    want, jgrads, jstats = fots_step
    assert want["ctc_loss"] > 0
    scales = []
    loss = ttrain.detection_loss

    def recorded(*args, **kw):
        scales.append(kw["multi_scale"])
        return loss(*args, **kw)

    monkeypatch.setattr(ttrain, "detection_loss", recorded)
    trainer = _port_trainer(gateless_flat[0])
    assert trainer.multi_scale is False and trainer.model.training
    got = trainer.step(_cropped_batch())
    assert scales == [False]
    for k in ttrain.METRIC_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    grads = {n: p.grad for n, p in trainer.model.named_parameters()}
    assert len(jgrads) == len(grads)
    norm_err, elem_err = {}, {}
    for key, g in jgrads.items():
        gt = grads[tck.torch_key(key)].numpy()
        if g.ndim == 4:
            gt = gt.transpose(2, 3, 1, 0)
        norm_err[key] = float(np.linalg.norm(gt - g) / np.linalg.norm(g))
        elem_err[key] = float(np.abs(gt - g).max()) / (float(np.abs(g).max()) + 1e-30)
        assert norm_err[key] <= 5e-3, (key, norm_err[key])
        assert elem_err[key] <= 3e-2, (key, elem_err[key])
    assert float(np.median(list(norm_err.values()))) <= 2e-4
    assert float(np.median(list(elem_err.values()))) <= 2e-4
    sd = trainer.model.state_dict()
    for key, v in jstats.items():
        np.testing.assert_allclose(sd[tck.torch_key(key)].numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_trainer_multi_scale_follows_the_model(gateless_flat, tmp_path):
    """The default detector trains multi-scale, the argument overrides the
    model, and a one-rank mesh takes the field as one process does: the
    same first step's losses."""
    assert ttrain.Trainer(device="cpu").multi_scale is True
    gateless = _gateless_port(gateless_flat[0])
    assert ttrain.Trainer(gateless, multi_scale=True, device="cpu").multi_scale is True
    batch = _cropped_batch()
    want = _port_trainer(gateless_flat[0]).step(batch)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        meshed = _port_trainer(gateless_flat[0], mesh=pmesh.make_mesh(1, 1))
        assert meshed.multi_scale is False
        got = meshed.step(batch)
    finally:
        dist.destroy_process_group()
    for k in ttrain.METRIC_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# serving and export
# --------------------------------------------------------------------------

def _gt_boxes(i):
    """Scene ``i``'s ground-truth quads as boxes [N, 9] (score 1)."""
    rows = []
    with open(os.path.join(REPO, "data", "synth", f"gt_img_00{i}.txt")) as f:
        for line in f:
            rows.append([float(v) for v in line.split(",")[:8]] + [1.0])
    return np.asarray(rows, np.float32)


def test_serving_matches_fots(jax_gateless, gateless_flat, scenes):
    """Both engines cap the boxes that enter recognition at :data:`MAX_BOXES`
    (of the 1024 an image passes)."""
    jm, jv = jax_gateless
    flat, config = gateless_flat
    # at the scenes' own size the host letterbox is the identity, so fots's
    # batch_call and detect_boxes_batch run one detection program
    ref = JaxInference(jm, jv, masked_norm=config["masked_norm"], max_boxes=MAX_BOXES)
    batch = np.stack(scenes)
    with FOTSInference(_gateless_port(flat), masked_norm=config["masked_norm"],
                       max_boxes=MAX_BOXES, device="cpu") as port:
        got = port.batch_call(scenes, serve_hw=SERVE_HW)
        want = ref.batch_call(scenes, serve_hw=SERVE_HW)
        assert got == want == [[], []]
        boxes, focr = port.detect_boxes_batch(batch)
        jboxes, jfocr = ref.detect_boxes_batch(batch)
        assert [len(b) for b in boxes] == [len(b) for b in jboxes]
        for b, jb in zip(boxes, jboxes):
            np.testing.assert_allclose(b, jb, rtol=0, atol=0.5)
            assert np.ptp(b[:, 0:8:2], axis=1).max() == 0  # points, not words
        texts = []
        for i in range(len(scenes)):
            gt = _gt_boxes(i)
            texts.append(port.recognize_boxes(gt, focr, batch_index=i))
            assert texts[-1] == ref.recognize_boxes(gt, jfocr, batch_index=i)
    assert sum(t != "" for r in texts for t in r) >= 8


def test_export_replays_the_eager_engine(tmp_path):
    """Seeded gateless weights at 64x96, the threshold lowered until boxes
    pass (as ``tests/test_torch_port_export.py``'s tiny engine)."""
    model = init_detector(FOTSDetector(attention=False, multi_scale=False),
                          torch.Generator().manual_seed(3)).eval()
    rng = np.random.default_rng(3)
    ims = [rng.integers(0, 256, (64, 96, 3), dtype=np.uint8) for _ in range(2)]
    with FOTSInference(model, segm_thresh=0.3, device="cpu", max_boxes=3) as eng:
        eng.strip_buckets = (32,)
        manifest = export_serving(eng, str(tmp_path), 2, 64, 96, roi_pad=4,
                                  platforms=("cpu",))
        want = eng.batch_call(ims, serve_hw=(64, 96))
    assert not any(k.startswith("conv_attention") for k in manifest["param_dtypes"])
    with ExportedEngine(str(tmp_path), device="cpu") as exported:
        got = exported.batch_call(ims)
    assert 0 < sum(len(r) for r in want)
    assert [len(r) for r in got] == [len(r) for r in want]
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g["text"] == w["text"]
            np.testing.assert_allclose(g["box"][:8], w["box"][:8], rtol=0, atol=1e-5)
            assert abs(g["conf"] - w["conf"]) <= 1e-6
