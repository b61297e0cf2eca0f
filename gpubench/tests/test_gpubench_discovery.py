"""A new configuration, cell, traffic mix, frame maker and per-layer metric
need only new files and new ``BENCHMARK.json`` entries: the harness finds
each by its name."""

import json
import os
import shutil
from types import SimpleNamespace

import pytest

from gpubench import common
from gpubench.drivers import driver, serve, train

ROOT = common.ROOT

#: a frame maker that only a test knows: rows numbered from the seed
THROWAWAY_FRAMES = ("def make(traffic, seed):\n"
                    "    return [seed + k for k in range(traffic['batch'] * "
                    "traffic['pool_batches'])]\n")


def _throwaway_tree(tmp_path):
    """A copy of the benchmark's data with one more configuration, traffic,
    frame maker, cell and metric, each only as data or a new file."""
    root = tmp_path / "checkout"
    for sub in ("configs", "workloads", "metrics", "frames"):
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
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "train_images_per_s":
            m["workloads"].append("throwaway-cell")
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
