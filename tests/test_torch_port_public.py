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


# --------------------------------------------------------------------------
# the argument surface
# --------------------------------------------------------------------------

#: fots arguments the port leaves out, by (module, function): each is a JAX
#: or TPU concern, or an option fots never sets otherwise
JAX_ONLY = {
    ("checkpoint", "import_torch_state_dict"): {
        "variables": "fots returns new flax variables; the port copies into a module"},
    ("checkpoint", "load_serving_params"): {
        "variables": "the port returns the flat arrays; load_flat fills a module",
        "with_config": "the port always returns the config, {} when absent"},
    ("checkpoint", "restore_checkpoint"): {
        "state": "an orbax TrainState; the port restores into its trainer"},
    ("checkpoint", "save_checkpoint"): {
        "state": "an orbax TrainState; the port saves its trainer"},
    ("checkpoint", "save_serving_params"): {
        "variables": "flax variables; the port writes a module's state dict"},
    ("data.ocr_crops", "ocr_crop_batches"): {
        "train_list": "the port reads a decoded archive first; a list passes as "
                      "train_list= through **kwargs"},
    ("data.prefetch", "PrefetchPool.__init__"): {
        "ctx": "a forked child of a process that holds a CUDA context cannot use "
               "CUDA: the port always spawns"},
    ("export", "ExportedEngine.recognize"): {
        "focr": "the port's programs read the detection program's packed quads"},
    ("models.crnn", "CRNN.<fields>"): {
        "dtype": "flax's compute dtype; the port casts parameters and inputs"},
    ("models.detector", "FOTSDetector.<fields>"): {
        "stem_s2d": "the stem's space-to-depth layout for the TPU's lanes",
        "stem_split_conv1a": "a TPU layout of conv1a, the same function",
        "dtype": "flax's compute dtype; the port casts (cast_params_bf16)"},
    ("models.detector", "FOTSDetector.recognize"): {
        "train": "torch's module.train() / eval()"},
    ("models.detector", "Stem.<fields>"): {
        "s2d": "the space-to-depth layout for the TPU's lanes",
        "split_conv1a": "a TPU layout of conv1a, the same function"},
    ("models.detector", "init_detector"): {
        "rng": "a JAX key; the port draws from a torch.Generator",
        "image_shape": "flax traces the init at a shape; torch modules need none",
        "strip_shape": "flax traces the init at a shape; torch modules need none"},
    ("models.layers", "BasicBlockSepIn.<fields>"): {
        "dilation": "fots builds every block with dilation 1"},
    ("models.layers", "BatchNorm.<fields>"): {
        "momentum": "fots builds every BatchNorm at 0.9, the port's class attribute"},
    ("models.layers", "ConvDWIn.<fields>"): {
        "dilation": "fots builds every block with dilation 1"},
    ("models.layers", "InstanceNorm.<fields>"): {
        "dtype": "flax's compute dtype; the port casts parameters and inputs"},
    ("models.layers", "max_pool"): {"padding": "fots only ever pools VALID"},
    ("models.own", "OwnModel.ocr_forward"): {"train": "torch's module.train() / eval()"},
    ("models.own", "OwnModel.recognize"): {"train": "torch's module.train() / eval()"},
    ("models.own", "init_own_model"): {
        "rng": "a JAX key; the port draws from a torch.Generator",
        "image_shape": "flax traces the init at a shape; torch modules need none",
        "crop_shape": "flax traces the init at a shape; torch modules need none"},
    ("ops.instance_norm", "instance_norm"): {
        "use_pallas": "Pallas or XLA on the TPU; the port picks by the tensor's device"},
    ("ops.rroi_align", "pack_neighbors"): {
        "prefer_pallas": "Pallas or XLA on the TPU; the port picks by the tensor's device"},
    ("parallel.mesh", "make_mesh"): {
        "devices": "JAX devices; the port's mesh spans the process group's ranks"},
    ("parallel.mesh", "param_shardings"): {
        "params": "a flax tree; the port takes the module"},
    ("parallel.mesh", "shard_init"): {
        "variables": "flax variables; the port shards the module in place"},
    ("pipeline", "FOTSInference.__init__"): {
        "variables": "flax variables; the port's model holds its weights"},
    ("pipeline", "cast_params_bf16"): {
        "variables": "flax variables; the port casts the module in place"},
    ("train", "Trainer.__init__"): {
        "input_size": "flax initialises at that size; the port needs no shape"},
    ("train", "extract_roi_candidates"): {
        "rng": "a JAX key; the port draws the priorities from a torch.Generator"},
    ("train_ocr", "CRNNTrainer.__init__"): {
        "input_width": "flax initialises at that width; the port needs no shape"},
}


def _arg_names(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n != "self"]


def _surface(package: str) -> dict:
    """{(module, name): argument names} of a package's public functions, its
    public classes' public methods, ``__init__`` and ``__call__``, and (as
    ``Class.<fields>``) a flax module's dataclass fields, read with ``ast``."""
    import ast

    root = os.path.join(REPO, package)
    out = {}
    for folder, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(folder, name)
            module = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in tree.body:
                if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
                    out[(module, node.name)] = _arg_names(node)
                elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                    for item in node.body:
                        if isinstance(item, ast.FunctionDef) and (
                                not item.name.startswith("_")
                                or item.name in ("__init__", "__call__")):
                            out[(module, f"{node.name}.{item.name}")] = _arg_names(item)
                    fields = [item.target.id for item in node.body
                              if isinstance(item, ast.AnnAssign)
                              and isinstance(item.target, ast.Name)]
                    if fields:
                        out[(module, f"{node.name}.<fields>")] = fields
    return out


def test_every_fots_argument_has_a_port_counterpart():
    """For every public function and method of fots with a port counterpart
    (the same module and name; a flax module's fields against the port
    class's ``__init__``), fots's argument names are a subset of the
    port's, but for :data:`JAX_ONLY`; and every entry there is still a gap."""
    ref, port = _surface("fots"), _surface("fots_torch")
    gaps, compared = {}, 0
    for key, names in ref.items():
        module, name = key
        if name.endswith(".<fields>"):
            theirs = port.get((module, name.replace("<fields>", "__init__")))
        else:
            theirs = port.get(key)
        if theirs is None:
            continue
        compared += 1
        missing = [n for n in names if n not in theirs]
        if missing:
            gaps[key] = missing
    assert compared >= 170
    for key, missing in gaps.items():
        assert key in JAX_ONLY and set(missing) <= set(JAX_ONLY[key]), \
            f"{key}: fots's {missing} have no port counterpart"
    for key, reasons in JAX_ONLY.items():
        assert set(reasons) <= set(gaps.get(key, ())), \
            f"{key}: {sorted(set(reasons) - set(gaps.get(key, ())))} are ported now"


def test_decode_batch_lengths_as_fots():
    """Frames at or past a row's length are dropped: lengths 0, T and in
    between, over seeded ids with blanks, repeats and out-of-alphabet ids."""
    from fots.codec import LabelCodec as JaxCodec
    from fots_torch.codec import LabelCodec

    rng = np.random.default_rng(22)
    ids = rng.integers(0, 90, (64, 40)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = 0
    lengths = np.concatenate([[0, 40, 1, 39], rng.integers(0, 41, 60)])
    port, ref = LabelCodec(), JaxCodec()
    for lens in (lengths, lengths.astype(np.int64).tolist(), None):
        want = ref.decode_batch(ids, lens)
        assert port.decode_batch(ids, lens) == want
    assert port.decode_batch(ids, lengths)[0] == "" and \
        port.decode_batch(ids, lengths)[1] == port.decode_batch(ids)[1]
    assert port.decode_batch(ids[:0], lengths[:0]) == ref.decode_batch(ids[:0], lengths[:0])


@pytest.mark.parametrize("max_queue", [None, 2])
def test_prefetch_pool_max_queue_as_fots(max_queue):
    """One worker fills the queue up to ``max_queue`` items and no further,
    in both pools (the port's default is its 4, fots's 24)."""
    import itertools
    import time

    from fots.data.prefetch import PrefetchPool as JaxPool
    from fots_torch.data import prefetch

    kw = {} if max_queue is None else {"max_queue": max_queue}
    for pool_cls, default in ((prefetch.PrefetchPool, prefetch.QUEUE_BATCHES),
                              (JaxPool, 24)):
        want = max_queue or default
        with pool_cls(itertools.repeat, num_workers=1, **kw) as pool:
            deadline = time.monotonic() + 60
            while pool._queue.qsize() < want and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.5)
            assert pool._queue.qsize() == want, pool_cls
            assert next(pool) == 0
