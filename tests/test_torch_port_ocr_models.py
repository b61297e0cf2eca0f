"""The recognition-only stack's host pieces and models against fots (CPU).

- The codecs (``Codec4`` with its word-split decode, ``SepLabelCodec``,
  ``load_charset``, ``build_charset_from_labels``), ``quads_to_rrois`` and
  ``build_gt_crop_batch``: equal to fots's outputs exactly.
- ``CRNN``: weights carried across from a flax tree (every key accounted
  for), outputs in eval and train mode and the updated BatchNorm statistics
  within 1e-4 relative and 1e-5 absolute (f32; convolutions and LSTM sums
  in another order), at ``hidden=16, nclass=7`` and at full width
  (``hidden=256, nclass=87``), at an even and an odd crop width, with
  fots's frame count W/4 + 1.
- ``OwnModel``'s carry-over: every flax key maps onto one state-dict entry
  and back, the CRNN branch equal to the CRNN's.
- ``rroi_align`` of a 3-channel f32 image (the CRNN crops' K4' shape):
  within 1e-5 of fots's (the plain pack is exact; the bilinear sums run in
  another order).
- ``OCRMetrics``: summary, worst cases, confusion matrix, CSV and HTML
  identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fots import codec as jcodec
from fots import geometry as jgeometry
from fots.models.crnn import CRNN as JaxCRNN
from fots.models.own import OwnModel as JaxOwnModel
from fots.models.own import init_own_model as jax_init_own_model
from fots.ocr_eval import OCRMetrics as JaxOCRMetrics
from fots.ops.rroi_align import rroi_align as jax_rroi_align
from fots.train_ocr import build_gt_crop_batch as jax_build_gt_crop_batch
from fots_torch import checkpoint as tck
from fots_torch import codec as tcodec
from fots_torch.geometry import quads_to_rrois
from fots_torch.models import CRNN, OwnModel
from fots_torch.models.crnn import init_crnn
from fots_torch.ocr_eval import OCRMetrics
from fots_torch.ops.rroi_align import rroi_align
from fots_torch.train_ocr import build_gt_crop_batch

F32_MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# codecs, rois
# --------------------------------------------------------------------------

def test_codec4_matches_fots():
    charset = "abc .,:xyz"
    mine, ref = tcodec.Codec4(charset), jcodec.Codec4(charset)
    assert mine.num_classes == ref.num_classes and mine.reserved_ids == ref.reserved_ids
    for text in ("ab c", "zz?", "", "x.y,z:a"):
        assert mine.encode(text) == ref.encode(text)
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 40):
        ids = rng.integers(0, len(charset) + 5, n)
        got, want = mine.decode_with_splits(ids), ref.decode_with_splits(ids)
        assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
        np.testing.assert_array_equal(got[2], want[2])


def test_sep_label_codec_and_charset_helpers_match_fots(tmp_path):
    alphabet = "ab|cd|e|ff"
    mine, ref = tcodec.SepLabelCodec(alphabet, "|"), jcodec.SepLabelCodec(alphabet, "|")
    assert mine.tokens == ref.tokens and mine.num_classes == ref.num_classes
    for text in ("ab|e|zz|ff", "", "cd"):
        for a, b in zip(mine.encode(text), ref.encode(text)):
            np.testing.assert_array_equal(a, b)
    for ids in ([1, 1, 0, 2, 4, 4, 9], [0, 0], [3, 0, 3]):
        for raw in (False, True):
            assert mine.decode_ids(ids, raw) == ref.decode_ids(ids, raw)
    path = tmp_path / "codec.txt"
    path.write_text("xyzÉ´ \nsecond line\n", encoding="utf-8")
    assert tcodec.load_charset(str(path)) == jcodec.load_charset(str(path)) == "xyzÉ´ "
    labels = ["HOTEL", "café", "ÉTÉ 24", ""]
    assert tcodec.build_charset_from_labels(labels) == jcodec.build_charset_from_labels(labels)


def test_quads_to_rrois_matches_fots_exactly():
    rng = np.random.default_rng(5)
    quads = rng.uniform(0, 500, (9, 4, 2))
    for bid, jitter in ((0, 0), (3, -2), (1, 2)):
        np.testing.assert_array_equal(quads_to_rrois(quads, bid, jitter),
                                      jgeometry.quads_to_rrois(quads, bid, jitter))


def test_build_gt_crop_batch_matches_fots_exactly():
    rng = np.random.default_rng(9)
    quads, labels = [], []
    for _ in range(3):
        n = int(rng.integers(0, 6))
        c = rng.uniform(20, 230, (n, 1, 2))
        w, h = rng.uniform(10, 120, (n, 1)), rng.uniform(6, 30, (n, 1))
        q = np.concatenate([c + np.stack([-w, h], -1) / 2, c + np.stack([-w, -h], -1) / 2,
                            c + np.stack([w, -h], -1) / 2, c + np.stack([w, h], -1) / 2], 1)
        quads.append(list(q))
        labels.append([["HOTEL", "##", "BANK", "###x", "TAXI", "a"][i % 6] for i in range(n)])
    quads[0].append(np.array([[10, 50], [10, 30], [900, 30], [900, 50]], np.float64))
    labels[0].append("OUTSIDE")
    codec, jc = tcodec.LabelCodec(), jcodec.LabelCodec()
    for seed in (None, 4):
        got = build_gt_crop_batch(quads, labels, codec, (256, 256),
                                  rng=None if seed is None else np.random.default_rng(seed))
        want = jax_build_gt_crop_batch(quads, labels, jc, (256, 256),
                                       rng=None if seed is None else np.random.default_rng(seed))
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a, b)
        assert got[4] == want[4] and got[5] == want[5]
        assert "OUTSIDE" not in got[5] and got[3].sum() == len(got[5]) > 0


# --------------------------------------------------------------------------
# CRNN, OwnModel
# --------------------------------------------------------------------------

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


@pytest.mark.parametrize("hidden,nclass,width", [(16, 7, 40), (16, 7, 45),
                                                 (256, 87, 64), (256, 87, 53)])
def test_crnn_matches_flax_in_eval_and_train_mode(hidden, nclass, width):
    jm, v = _flax_crnn_vars(nclass, hidden, seed=width)
    x = np.random.default_rng(width).uniform(-1, 1, (2, 32, width, 3)).astype(np.float32)
    model = CRNN(nclass=nclass, hidden=hidden)
    sd = tck.state_dict_from_fots(v["params"], v["batch_stats"], "crnn")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)

    want_eval = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    want_train, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert want_eval.shape == (2, width // 4 + 1, nclass)  # fots's frame count
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x)).numpy()
        got_train = model.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_eval, want_eval, **F32_MODEL_TOL)
    np.testing.assert_allclose(got_train, np.asarray(want_train), **F32_MODEL_TOL)
    for bn in ("bn2", "bn4", "bn6"):
        mod = getattr(model, bn)
        np.testing.assert_allclose(mod.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"][bn]["mean"]), **F32_MODEL_TOL)
        np.testing.assert_allclose(mod.running_var.numpy(),
                                   np.asarray(upd["batch_stats"][bn]["var"]), **F32_MODEL_TOL)


def test_crnn_carry_over_refuses_unknown_and_partial_trees():
    _, v = _flax_crnn_vars(7, 16, seed=0)
    params = v["params"]
    bad = {**params, "conv9": {"kernel": np.zeros((3, 3, 3, 3), np.float32)}}
    with pytest.raises(KeyError):
        tck.state_dict_from_fots(bad, v["batch_stats"], "crnn")
    cell = dict(params["rnn0"]["OptimizedLSTMCell_0"])
    cell.pop("hg")
    partial = {**params, "rnn0": {**params["rnn0"], "OptimizedLSTMCell_0": cell}}
    with pytest.raises(KeyError):
        tck.state_dict_from_fots(partial, v["batch_stats"], "crnn")


def test_init_crnn_follows_flax_defaults():
    model = init_crnn(CRNN(nclass=7, hidden=16), torch.Generator().manual_seed(0))
    w = model.conv4.weight.detach()
    assert abs(float(w.std()) - (1.0 / (9 * 256)) ** 0.5) < 0.1 * (1.0 / (9 * 256)) ** 0.5
    w_hh = model.rnn0.lstm.weight_hh_l0.detach()
    for g in range(4):
        blk = w_hh[16 * g:16 * (g + 1)]
        torch.testing.assert_close(blk @ blk.T, torch.eye(16), rtol=0, atol=1e-5)
    for name, t in model.state_dict().items():
        if "bias" in name or "running_mean" in name:
            assert not t.any(), name
    assert not model.rnn0.lstm.bias_ih_l0.requires_grad


def test_own_model_carry_over_accounts_for_every_key():
    jm = JaxOwnModel(nclass=87)
    shapes = jax.eval_shape(lambda: jax_init_own_model(jm, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes)
    model = OwnModel(nclass=87)
    sd = tck.state_dict_from_fots(v["params"], v["batch_stats"], "own")
    # fots's OwnModel init never touches the recognition head
    head = {k for k in model.state_dict() if k.startswith("detector.ocr.")}
    assert head and set(sd) == set(model.state_dict()) - head
    for k, t in sd.items():
        assert model.state_dict()[k].shape == t.shape, k
    tck.load_own_model(model, sd)
    for k, t in sd.items():
        assert torch.equal(model.state_dict()[k], t), k
    n_flax = len(jax.tree_util.tree_leaves(v))
    # each of the 4 LSTM cells: 12 flax leaves (8 gate kernels, 4 biases) ->
    # weight_ih, weight_hh, bias_hh and the frozen zero bias_ih
    assert len(sd) == n_flax - 4 * 12 + 4 * 4
    with pytest.raises(KeyError):
        tck.load_own_model(model, {k: t for k, t in sd.items() if "conv4" not in k})
    crnn_only = tck.state_dict_from_fots(v["params"]["crnn"], v["batch_stats"]["crnn"], "crnn")
    for k, t in crnn_only.items():
        assert torch.equal(sd[f"crnn.{k}"], t)
    det_only = tck.state_dict_from_fots(v["params"]["detector"],
                                        v["batch_stats"]["detector"], "detector")
    for k, t in det_only.items():
        assert torch.equal(sd[f"detector.{k}"], t)


# --------------------------------------------------------------------------
# RoIRotate on the image, OCRMetrics
# --------------------------------------------------------------------------

def test_rroi_align_on_a_three_channel_image_matches_fots():
    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (2, 96, 160, 3)).astype(np.float32)
    quads = [rng.uniform(10, 150, (3, 4, 2)), rng.uniform(5, 90, (2, 4, 2))]
    rois = np.concatenate([quads_to_rrois(q, b, 1) for b, q in enumerate(quads)]).astype(np.float32)
    rois[:, 3:5] = np.abs(rois[:, 3:5]) + 4.0
    got = rroi_align(torch.from_numpy(images), torch.from_numpy(rois), 32, 64, 1.0).numpy()
    want = np.asarray(jax_rroi_align(jnp.asarray(images), jnp.asarray(rois), 32, 64, 1.0))
    assert got.shape == (5, 32, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ocr_metrics_match_fots(tmp_path):
    pairs = [("HOTEL", "HOTEL"), ("H0TEL", "HOTEL"), ("", "BANK"), ("مرحبا", "مرحبا"),
             ("abc", "日本"), ("12", "12"), ("ΑΒΓ", "ΑΒ"), ("x", "")]
    mine, ref = OCRMetrics(), JaxOCRMetrics()
    for p, g in pairs:
        mine.add(p, g)
        ref.add(p, g)
    assert mine.summary() == ref.summary()
    assert mine.worst_cases(3) == ref.worst_cases(3)
    assert mine.confusion_matrix() == ref.confusion_matrix()
    for ext in ("csv", "html"):
        a, b = tmp_path / f"mine.{ext}", tmp_path / f"ref.{ext}"
        if ext == "csv":
            mine.to_csv(str(a))
            ref.to_csv(str(b))
        else:
            mine.to_html(str(a), n_worst=5, images={"HOTEL": "crop <1>.png"})
            ref.to_html(str(b), n_worst=5, images={"HOTEL": "crop <1>.png"})
        assert a.read_bytes() == b.read_bytes()
    from fots.ocr_eval import script_of as jax_script_of
    from fots_torch.ocr_eval import script_of

    for text in ("abc", "مرحبا", "123", "", "!?", "한국", "カタ"):
        assert script_of(text) == jax_script_of(text)
