"""The last public pieces of ``fots`` and their port counterparts, on the same
inputs: ``checkpoint.load_serving_config``, ``pipeline.valid_frames``, both
``strip_width_for_box`` (the serving grid of ``pipeline``'s, the coarse one
of ``geometry``'s), ``fots_torch.cli.export_serving_params`` read back by
``fots.checkpoint.load_serving_params``, and ``load_engine(n_model=2)``
serving unmeshed without ``n_data``."""

import json
import os

import jax
import numpy as np
import pytest

from fots import checkpoint as jck
from fots import geometry as jgeo
from fots import pipeline as jpipe
from fots.cli.detect import load_engine as jax_load_engine
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots_torch import checkpoint as tck
from fots_torch import geometry as tgeo
from fots_torch import pipeline as tpipe
from fots_torch import train as ttrain
from fots_torch.cli import export_serving_params as export_cli
from fots_torch.cli.detect import load_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")


def _boxes(n=400, seed=0):
    """(w, h) pairs from slivers to wide words and tall boxes."""
    rng = np.random.default_rng(seed)
    w = np.exp(rng.uniform(np.log(0.5), np.log(2000), n))
    h = np.exp(rng.uniform(np.log(0.3), np.log(300), n))
    return list(zip(w.tolist(), h.tolist())) + [(100, 22), (0, 0), (1e4, 1), (31.9, 8)]


@pytest.mark.parametrize("buckets", [None, (256, 512), (64, 128), (32,)])
@pytest.mark.parametrize("target_h", [8, 32])
def test_strip_width_for_box_as_fots(buckets, target_h):
    """``pipeline.strip_width_for_box`` defaults to the fine serving grid and
    ``geometry.strip_width_for_box`` to (256, 512), in the port as in fots."""
    kw = {} if buckets is None else {"buckets": buckets}
    for w, h in _boxes():
        for port, ref in ((tpipe.strip_width_for_box, jpipe.strip_width_for_box),
                          (tgeo.strip_width_for_box, jgeo.strip_width_for_box)):
            assert port(w, h, target_h, **kw) == ref(w, h, target_h, **kw), (w, h, kw)
    assert tpipe.strip_width_for_box(100, 22) == jpipe.strip_width_for_box(100, 22) == 64
    assert tgeo.strip_width_for_box(100, 22) == 256


def test_valid_frames_as_fots():
    """Frames an rroi ``[bid, cx, cy, h, w, angle]`` covers at each strip
    width, over a seeded grid of boxes, degenerate heights included."""
    rng = np.random.default_rng(1)
    for w, h in _boxes(seed=2):
        roi = np.array([0, rng.uniform(0, 900), rng.uniform(0, 600), h, w,
                        rng.uniform(-90, 90)], np.float32)
        for width in (1, 16, 64, 128, 512):
            for target_h in (8, 32):
                assert (tpipe.valid_frames(roi, width, target_h)
                        == jpipe.valid_frames(roi, width, target_h)), (roi, width)
    assert tpipe.valid_frames(np.array([0, 1, 1, 0, 5, 0]), 64) == \
        jpipe.valid_frames(np.array([0, 1, 1, 0, 5, 0]), 64) == 64


def test_load_serving_config_as_fots(tmp_path):
    """The shipped snapshot's config, and port-written snapshots with and
    without one, read the same by both."""
    assert tck.load_serving_config(SNAPSHOT) == jck.load_serving_config(SNAPSHOT)
    assert tck.load_serving_config(SNAPSHOT).get("masked_norm") is True
    model = tck.load_detector(SNAPSHOT, "cpu")[0]
    for i, config in enumerate((None, {}, {"masked_norm": False, "input_size": 512,
                                           "note": "ünïcode"})):
        path = str(tmp_path / f"s{i}.npz")
        tck.save_serving_params(path, model, step=3 if i else None, config=config)
        assert tck.load_serving_config(path) == jck.load_serving_config(path) == (config or {})


def _checkpoint_run(tmp_path, name, step, config):
    """A port run directory holding ``step_<step>`` of the shipped weights
    (and Adam's empty state), with ``train_config.json`` when ``config``."""
    run = tmp_path / name
    trainer = ttrain.Trainer(tck.load_detector(SNAPSHOT, "cpu")[0], device="cpu")
    trainer.global_step = step
    tck.save_checkpoint(str(run), trainer, step)
    if config is not None:
        (run / "train_config.json").write_text(json.dumps(config))
    return run, trainer.model


def test_export_serving_params_read_by_fots(tmp_path, capsys):
    """The CLI's snapshot of the newest step of a port run directory, read
    by ``fots.checkpoint.load_serving_params`` into fots's variables: every
    key accounted for (fots raises otherwise), the values the port's, the
    step and the sidecar config embedded.  Without a sidecar the config is
    empty and the CLI warns, as ``tools/export_serving_params.py`` does."""
    run, model = _checkpoint_run(tmp_path, "run", 12, {"masked_norm": True, "lr": 1e-4})
    older = ttrain.Trainer(tck.load_detector(SNAPSHOT, "cpu")[0], device="cpu")
    tck.save_checkpoint(str(run), older, 4)  # the newest step wins
    out = str(tmp_path / "snap.npz")
    assert export_cli.main([str(run), out]) == 0
    assert "WARNING" not in capsys.readouterr().err
    template = jax_init_detector(JaxDetector(nclass=87), jax.random.PRNGKey(0))
    variables, step, config = jck.load_serving_params(out, template, with_config=True)
    assert step == 12 and config == {"masked_norm": True, "lr": 1e-4}
    flat = tck.flat_from_state_dict(model.state_dict())
    n = 0
    for key, want in flat.items():
        node = variables
        for part in key.split("/"):
            node = node[part]
        assert np.array_equal(np.asarray(node, np.float32), want), key
        n += 1
    leaves = sum(len(jax.tree_util.tree_leaves(variables[g])) for g in ("params", "batch_stats"))
    assert n == leaves
    # a step_N directory itself, and no train_config.json anywhere: a warning
    bare, _ = _checkpoint_run(tmp_path, "bare", 5, None)
    out2 = str(tmp_path / "bare.npz")
    assert export_cli.main([str(bare / "step_5"), out2]) == 0
    assert "WARNING: no train_config.json" in capsys.readouterr().err
    _, step2, config2 = jck.load_serving_params(out2, template, with_config=True)
    assert step2 == 5 and config2 == {} == tck.load_serving_config(out2)
    assert export_cli.main([]) == 2


def test_load_engine_n_model_without_n_data_is_unmeshed():
    """fots meshes only when ``n_data`` is above 1: ``n_model=2`` alone
    serves on one device, in both."""
    ref = jax_load_engine(SNAPSHOT, n_model=2)
    assert ref.mesh is None
    with load_engine(SNAPSHOT, device="cpu", n_model=2) as port:
        assert port.mesh is None
    with load_engine(SNAPSHOT, device="cpu", n_data=1, n_model=2) as port:
        assert port.mesh is None
