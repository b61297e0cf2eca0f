"""The reference's torch weights (``-h5``) at the port's entry points, against
fots on the CPU (f32).

- ``-h5``: a random state dict under the reference's keys (fots's
  ``reference_key_map``, shapes from fots's ``init_detector`` in torch
  layout, plus a ``num_batches_tracked``, an ``rnn`` and an unknown key) is
  imported by both packages: the same keys imported and skipped, with and
  without ``skip_substrings``; every port parameter is reached; the port's
  weights equal fots's imported ones bit for bit, so the detection maps
  (both scales) and the recognition head's log-probs of the two imports
  agree exactly; against fots's own forward the log-probs agree within 1e-5
  of the tensor's largest magnitude and the detection maps within the
  limits of that test's docstring; a ``torch.save``d file
  reads the same through both ``load_torch_h5``; the snapshot written under
  the reference's keys loads through ``load_engine(h5_path=...)`` into
  exactly the snapshot's weights; ``train_joint -h5`` warm-starts all but
  the vocabulary head (173 imported, 2 skipped).

Split from ``test_torch_port_files.py`` so that a distributed run can
balance its sections; the tests kept their names.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fots.checkpoint import import_torch_state_dict as jax_import_state_dict
from fots.checkpoint import load_torch_h5 as jax_load_torch_h5
from fots.checkpoint import reference_key_map as jax_reference_key_map
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.pipeline import device_letterbox_batch as jax_letterbox
from fots_torch import checkpoint as tck
from fots_torch.cli import train_joint
from fots_torch.cli.detect import load_engine
from fots_torch.models.detector import FOTSDetector, init_detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SCENES = [os.path.join(REPO, "data", "synth", f"img_00{i}.jpg") for i in range(2)]
REL = 1e-5


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _within(got, want, what, rel=REL):
    """|got - want| within ``rel`` of the largest |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


# --------------------------------------------------------------------------
# -h5: the reference's torch weights
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    model = JaxDetector(nclass=87)
    return model, jax_init_detector(model, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def reference_dict(jax_model):
    """Random weights under every reference key, scaled as an init draws
    them, plus keys the map does not know."""
    _, variables = jax_model
    rng = np.random.default_rng(0)
    sd = {}
    for key, (path, kind) in jax_reference_key_map().items():
        shape = _at(variables["batch_stats" if kind == "stat" else "params"], path).shape
        if kind in ("conv", "dw"):
            kh, kw, i, o = shape
            arr = rng.standard_normal((o, i, kh, kw)) * np.sqrt(1.0 / (kh * kw * i))
        elif key.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("weight"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            arr = 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    sd["layer2.0.downsample.1.num_batches_tracked"] = torch.tensor(7)
    sd["rnn.weight_ih_l0"] = torch.zeros(4, 4)
    sd["decoder.weight"] = torch.zeros(3)
    return sd


def test_h5_import_keys_match_fots(jax_model, reference_dict):
    _, variables = jax_model
    for skip in ((), ("conv11", "rnn")):
        _, want_imported, want_skipped = jax_import_state_dict(reference_dict, dict(variables),
                                                               skip_substrings=skip)
        model = FOTSDetector(nclass=87)
        imported, skipped = tck.import_torch_state_dict(reference_dict, model,
                                                        skip_substrings=skip)
        assert imported == want_imported and skipped == want_skipped
    assert len(tck.reference_key_map()) == len(jax_reference_key_map()) == 175
    assert (len(imported), sorted(skipped)) == (173, ["conv11.bias", "conv11.weight",
                                                      "decoder.weight", "rnn.weight_ih_l0"])
    reached = {name for name, _ in tck.reference_key_map().values()}
    assert reached == set(FOTSDetector(nclass=87).state_dict())


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict) else
                   {f"{prefix}/{k}": np.asarray(v)})
    return out


def test_h5_import_outputs_match_fots(jax_model, reference_dict):
    """The port's import equals fots's weight for weight (fots's imported
    flax tree, carried over by the snapshot map, is the same model bit for
    bit), so their outputs agree exactly.  Across the two frameworks, f32
    on the CPU with these random weights: the recognition log-probs and the
    merged features within 1e-5 of each tensor's max (read: 2.4e-6,
    7.2e-6); the detection maps within 5e-5 of theirs (segm and rbox read
    1.8e-5-2.4e-5: forty layers of f32 convolutions in two libraries); the
    angle map, a 2-vector normalised to unit length (which magnifies the
    error where both components are near 0), within 1e-3 (read 3.4e-4)."""
    jm, variables = jax_model
    jv, _, _ = jax_import_state_dict(reference_dict, dict(variables))
    model = init_detector(FOTSDetector(nclass=87), torch.Generator().manual_seed(0))
    tck.import_torch_state_dict(reference_dict, model)
    via_fots = FOTSDetector(nclass=87)
    tck.load_flat(via_fots, {**_flat(jv["params"], "params"),
                             **_flat(jv["batch_stats"], "batch_stats")})
    got_sd, want_sd = model.state_dict(), via_fots.state_dict()
    assert set(got_sd) == set(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)

    raw = np.stack([cv2.imread(p) for p in SCENES])
    x = np.asarray(jax_letterbox(raw, (128, 192)))
    strips = np.random.default_rng(1).standard_normal((4, 11, 48, 64)).astype(np.float32)
    valid_w = np.array([1, 16, 48, 40], np.int32)
    outs = []
    for m in (model.eval(), via_fots.eval()):
        with torch.inference_mode():
            outs.append((m(torch.from_numpy(np.array(x))),
                         m.recognize(torch.from_numpy(strips), torch.from_numpy(valid_w))))
    (got, got_rec), (same, same_rec) = outs
    for k in ("segm", "rbox", "angle"):
        for s in range(2):
            _within(got[k][s].numpy(), same[k][s].numpy(), f"{k}[{s}] via fots's import")
    _within(got_rec.numpy(), same_rec.numpy(), "log-probs via fots's import")

    want = jm.apply(jv, jnp.asarray(x), train=False)
    limits = {"segm": 5e-5, "rbox": 5e-5, "angle": 1e-3}
    for k, rel in limits.items():
        for s in range(2):
            _within(got[k][s].numpy(), want[k][s], f"{k}[{s}]", rel)
    _within(got["features"].numpy(), want["features"], "features")
    want_rec = jm.apply(jv, jnp.asarray(strips), train=False, method=JaxDetector.recognize,
                        valid_w=jnp.asarray(valid_w))
    _within(got_rec.numpy(), want_rec, "recognition log-probs")


def test_h5_file_round_trips_through_both_readers(reference_dict, tmp_path):
    path = str(tmp_path / "ref.h5")
    torch.save({"state_dict": reference_dict, "epoch": 3}, path)
    got, want = tck.load_torch_h5(path), jax_load_torch_h5(path)
    assert list(got) == list(want) == list(reference_dict)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_h5_engine_and_warm_start_from_the_snapshot(tmp_path, capsys):
    snap, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    path = str(tmp_path / "snapshot.h5")
    torch.save({"state_dict": tck.reference_state_dict(snap)}, path)
    with load_engine(h5_path=path, masked_norm=True, device="cpu") as engine:
        assert engine.masked_norm is True
        got, want = engine.model.state_dict(), snap.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert "imported 175 tensors" in capsys.readouterr().out
    _, trainer = train_joint.build(["-train_list", "unused.txt", "-h5", path, "-save_path",
                                    str(tmp_path / "run"), "-device", "cpu"])
    assert f"warm-started 173 tensors from {path} (2 skipped)" in capsys.readouterr().out
    got = trainer.model.state_dict()
    assert torch.equal(got["layer4.3.conv2.pw.weight"], want["layer4.3.conv2.pw.weight"])
    assert not torch.equal(got["ocr.conv11.weight"], want["ocr.conv11.weight"])
