"""A new configuration, architecture, cell, traffic mix, frame maker and
per-layer metric need only new files and new ``BENCHMARK.json`` entries:
the harness finds each by its name."""

import ast
import json
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest

from gpubench import check_train, common, report, weights
from gpubench.drivers import driver, serve, train

ROOT = common.ROOT

#: a frame maker that only a test knows: rows numbered from the seed
THROWAWAY_FRAMES = ("def make(traffic, seed):\n"
                    "    return [seed + k for k in range(traffic['batch'] * "
                    "traffic['pool_batches'])]\n")

#: an architecture that only a test knows: the gateless detector with its
#: 1/4-scale maps alone, in the program's output lists and in the reference's
THROWAWAY_MODEL = '''"""The gateless detector with its 1/4-scale maps alone."""
import os

from gpubench import common

BASE = common.load_file("models", "fots-resnetsep2", os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
MAPS = ("segm", "rbox", "angle", "focr")
POOLED_HEIGHT = BASE.POOLED_HEIGHT
param_shapes, seeded = BASE.param_shapes, BASE.seeded
program_leaves, recognition = BASE.program_leaves, BASE.recognition


def program_model(config, flat):
    from fots_torch.checkpoint import load_flat
    from fots_torch.models.detector import FOTSDetector

    class OneScale(FOTSDetector):
        def forward(self, images, generator=None):
            out = super().forward(images, generator)
            return {k: v[:1] if isinstance(v, list) else v for k, v in out.items()}

    model = OneScale(config["nclass"], config["attention"], config["multi_scale"])
    load_flat(model, flat)
    return model


def program_maps(out):
    if any(len(out[k]) != 1 for k in ("segm", "rbox", "angle")):
        raise ValueError("more than the 1/4-scale maps")
    maps = {"focr": out["focr"], **{k: out[k][0] for k in ("segm", "rbox", "angle")}}
    return {k: v.permute(0, 3, 1, 2) for k, v in maps.items()}


def reference(config, params, precision="f32", train=False):
    net = BASE.reference(config, params, precision, train)
    forward = net.forward
    net.forward = lambda images, drop=None: {
        k: v for k, v in forward(images, drop).items() if k in MAPS}
    return net
'''

#: an architecture of two leaves, whose draw is its own
TINY_MODEL = ("import torch\n"
              "def param_shapes(config):\n"
              "    return {'params/w/kernel': (1, 1, 2, 3), 'params/w/bias': (3,)}\n"
              "def seeded(config, seed, device):\n"
              "    return {k: torch.full(s, float(seed), device=device)\n"
              "            for k, s in param_shapes(config).items()}\n")


def _throwaway_tree(tmp_path):
    """A copy of the benchmark's data with one more configuration, traffic,
    frame maker, cell and metric, each only as data or a new file; and one
    more architecture (``gpubench/models/throwaway.py``) with its own
    configuration, traffic and cell."""
    root = tmp_path / "checkout"
    for sub in ("configs", "workloads", "metrics", "frames", "models"):
        shutil.copytree(os.path.join(ROOT, "gpubench", sub), root / "gpubench" / sub)
    bench = common.read_benchmark(ROOT)
    cfg = json.load(open(os.path.join(ROOT, "gpubench", "configs", "fots-icdar15-gated.json")))
    cfg["name"] = "throwaway-config"
    (root / "gpubench" / "configs" / "throwaway-config.json").write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(ROOT, "gpubench", "workloads",
                                          "train-crops512-b32.json")))
    traffic.update(batch=4, pool_batches=2, frames="throwaway")
    (root / "gpubench" / "workloads" / "throwaway-traffic.json").write_text(json.dumps(traffic))
    (root / "gpubench" / "frames" / "throwaway.py").write_text(THROWAWAY_FRAMES)
    (root / "gpubench" / "metrics" / "throwaway_metric.train.py").write_text(
        "def read(run):\n    return None if run.kind != 'train' else 2.0 * run.batch\n")
    bench["configs"].append({"name": "throwaway-config", "source": "https://example.org/x",
                             "file": "gpubench/configs/throwaway-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "throwaway-cell", "config": "throwaway-config",
                               "traffic": "throwaway-traffic", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway_metric.train", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "host",
                               "moves": "train_images_per_s", "workloads": ["throwaway-cell"]})
    (root / "gpubench" / "models" / "throwaway.py").write_text(THROWAWAY_MODEL)
    arch = json.load(open(os.path.join(ROOT, "gpubench", "configs",
                                       "fots-icdar15-gateless.json")))
    arch.update(name="throwaway-arch", model="throwaway")
    (root / "gpubench" / "configs" / "throwaway-arch.json").write_text(json.dumps(arch))
    small = json.load(open(os.path.join(ROOT, "gpubench", "workloads",
                                        "train-crops512-b32.json")))
    small.update(batch=2, crop=128, pool_batches=4, warmup_steps=0)
    (root / "gpubench" / "workloads" / "throwaway-arch-traffic.json").write_text(
        json.dumps(small))
    bench["configs"].append({"name": "throwaway-arch", "source": "https://example.org/y",
                             "file": "gpubench/configs/throwaway-arch.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "throwaway-arch-cell", "config": "throwaway-arch",
                               "traffic": "throwaway-arch-traffic", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_images_per_s":
            m["workloads"] += ["throwaway-cell", "throwaway-arch-cell"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def test_new_cell_configuration_and_metric_are_found_by_name(tmp_path):
    root = _throwaway_tree(tmp_path)
    cell = common.find_cell("throwaway-cell", root)
    assert cell.config["name"] == "throwaway-config"
    assert cell.traffic["batch"] == 4
    assert [m["name"] for m in cell.per_layer] == ["throwaway_metric.train"]
    assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s", "setup_s"}
    got = common.read_metrics(cell.per_layer, SimpleNamespace(kind="train", batch=4), root)
    assert got == {"throwaway_metric.train": {"value": 8.0, "unit": "x"}}


def test_a_new_frame_maker_is_found_by_name(tmp_path):
    cell = common.find_cell("throwaway-cell", _throwaway_tree(tmp_path))
    assert train.make_pool(cell.traffic, 10, cell.root) == [[10, 11, 12, 13], [14, 15, 16, 17]]
    frames = serve.Frames(cell.traffic, 20, cell.root)
    assert frames.frames == list(range(20, 28))
    assert set(frames.draw()) <= set(range(8))


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_traffic_kind_is_driven_by_the_module_of_its_name(kind):
    assert driver(kind).__name__ == f"gpubench.drivers.{kind}"
    assert callable(driver(kind).run)


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    root = _throwaway_tree(tmp_path)
    cell = common.find_cell("throwaway-cell", root)
    assert common.read_metrics(cell.per_layer, SimpleNamespace(kind="serve", batch=4), root) == {}


def test_every_cell_of_the_benchmark_resolves():
    bench = common.read_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = common.find_cell(w["name"])
        assert os.path.exists(os.path.join(ROOT, "gpubench", "drivers",
                                           cell.traffic["kind"] + ".py"))
        assert os.path.exists(os.path.join(ROOT, "gpubench", "frames",
                                           cell.traffic["frames"] + ".py"))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(ROOT, "gpubench", "metrics", m["name"] + ".py"))


@pytest.mark.parametrize("config", [c["name"] for c in common.read_benchmark(ROOT)["configs"]])
def test_every_configuration_names_a_model_module(config):
    entry = next(c for c in common.read_benchmark(ROOT)["configs"] if c["name"] == config)
    with open(os.path.join(ROOT, entry["file"])) as f:
        model = json.load(f)["model"]
    assert os.path.exists(os.path.join(ROOT, "gpubench", "models", model + ".py"))
    module = common.load_file("models", model)
    for name in ("program_model", "param_shapes", "seeded", "reference", "program_maps",
                 "recognition", "program_leaves"):
        assert callable(getattr(module, name)), name
    assert module.MAPS and module.POOLED_HEIGHT > 0


def test_a_new_architecture_is_found_by_name_and_its_cell_runs_correct(tmp_path):
    """The throwaway architecture's cell, driven on the CPU at a small size
    through the harness with nothing but new files: its program gives only
    the 1/4-scale maps, and the check compares those."""
    cell = common.find_cell("throwaway-arch-cell", _throwaway_tree(tmp_path))
    assert cell.model.MAPS == ("segm", "rbox", "angle", "focr")
    run = report.drive(cell, 3_000_000_029, 0.0, False, time.perf_counter(), "cpu")
    assert run["failed"] == 0
    assert run["check"].ok, run["check"].line()
    assert sorted(k for k in run["check"].notes if k.startswith("map_gap.")) == [
        "map_gap.angle", "map_gap.focr", "map_gap.rbox", "map_gap.segm"]


def test_cell_weights_take_their_leaves_from_the_model_module(tmp_path):
    root = _throwaway_tree(tmp_path)
    (tmp_path / "checkout" / "gpubench" / "models" / "tiny.py").write_text(TINY_MODEL)
    drawn = common.find_cell("throwaway-arch-cell", root)
    drawn.config["model"] = "tiny"
    flat = weights.cell_weights(drawn, 5, "cpu")
    assert {k: v.tolist() for k, v in flat.items()} == {
        "params/w/kernel": np.full((1, 1, 2, 3), 5.0).tolist(), "params/w/bias": [5.0] * 3}
    snapshot = common.find_cell("throwaway-cell", root)   # the gated snapshot's configuration
    assert set(weights.cell_weights(snapshot, 0, "cpu")) == set(
        snapshot.model.param_shapes(snapshot.config))
    snapshot.config["model"] = "tiny"
    with pytest.raises(RuntimeError, match="leaves differ"):
        weights.cell_weights(snapshot, 0, "cpu")


@pytest.mark.parametrize("height,mask,width,frames", [
    (8, [1, 0], 256, 80),     # aspect 10: 8 x 10 = 80 frames, in the 256 bucket
    (8, [1, 1], 512, 400),    # aspect 50: 400 frames, in the 512 bucket
    (11, [1, 0], 256, 110),
    (11, [1, 1], 512, 512),   # 550 frames, cut to the widest bucket
])
def test_strip_width_and_frames_take_the_models_pooled_height(height, mask, width, frames):
    model = SimpleNamespace(POOLED_HEIGHT=height)
    rois = np.asarray([[0, 50, 50, 10, 100, 0], [0, 50, 50, 4, 200, 0]], np.float32)
    mask = np.asarray(mask, np.float32)
    assert check_train.strip_width(model, rois, mask) == width
    assert check_train.frame_count(model, rois, mask, width) == frames


def test_only_model_modules_name_the_architecture():
    """Outside ``models/``, ``reference/`` and ``tests/`` no file of the
    harness imports the program's models, or imports or names the reference
    detector, its leaves or its pooled height: it reaches them through the
    cell's model module (``cell.model.param_shapes``)."""
    names = {"Detector", "FOTSDetector", "param_shapes", "POOLED_HEIGHT"}
    top = os.path.join(ROOT, "gpubench")
    seen = 0
    for folder, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if os.path.relpath(os.path.join(folder, d), top)
                   not in ("models", "reference", "tests")]
        for name in (f for f in files if f.endswith(".py")):
            path = os.path.join(folder, name)
            seen += 1
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                    assert not names & {a.name for a in node.names}, (path, node.lineno)
                elif isinstance(node, ast.Name):
                    assert node.id not in names, (path, node.lineno)
                for m in mods:
                    assert not m.startswith("fots_torch.models"), (path, m)
    assert seen > 20
