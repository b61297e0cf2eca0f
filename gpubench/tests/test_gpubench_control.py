"""The control of each cell: the plain reference put in the program's place
in the next precision below the configuration's (serving's bf16 backbone ->
float8 e4m3; training's float32 with TF32 convolutions -> bfloat16
convolutions), held to the cell's own limits through ``common.Check``.

On the CPU at a small size, here; at the cell's own size on the card (the
``cuda`` test, which runs ``gpubench/control.py``'s readings on three seeds
of every cell of ``BENCHMARK.json``; the limits were set from those
readings, ``PERF.md``).  The serving cells are not in ``BENCHMARK.json``
yet (``PERF.md``): their tests build them from their files."""

import copy
import json
import time

import numpy as np
import pytest

from gpubench import check_serve, check_train, common, control
from gpubench.drivers import serve, train

GATED = "gpubench/configs/fots-icdar15-gated.json"
SMALL_SERVE = {"stream-frames-b32-704x1280": dict(batch=2, serve_hw=[192, 320]),
               "stream-mosaic-b8-1408x2560": dict(batch=1, serve_hw=[384, 640], mosaics=2)}


@pytest.mark.parametrize("traffic", sorted(SMALL_SERVE))
def test_serving_control_fails_the_limits(traffic):
    cell = common.cell_from_files(traffic, GATED, traffic)
    cell.traffic.update(SMALL_SERVE[traffic])
    frames = serve.Frames(cell.traffic, 4_000_000_007)
    frames_u8 = np.stack(frames.images(frames.draw()))
    flat = serve.cell_weights(cell, 0, "cpu")
    with serve.reference_math("cpu"):
        boxes, texts, _ = check_serve.reference_pass(
            cell, check_serve.reference_params(flat, "cpu"), frames_u8, "fp8", device="cpu")
    keep = [np.asarray([t != "" for t in ts], bool) for ts in texts]
    boxes = [b[k] if len(b) else b for b, k in zip(boxes, keep)]
    texts = [[t for t in ts if t] for ts in texts]
    nums = serve.compare_to_reference(cell, flat, frames_u8, boxes, texts, "cpu")
    assert control.over_limits(cell, nums), nums


TRAIN = {"train-gated-frames640x960-b16": dict(batch=2, pool_batches=3, warmup_steps=0),
         "train-gateless-crops512-b32": dict(batch=2, crop=128, pool_batches=3, warmup_steps=0)}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_training_control(name):
    cell = copy.deepcopy(common.find_cell(name))
    cell.traffic.update(TRAIN[name])
    seed = 4_000_000_009
    run = train.run(cell, seed, 0.0, False, time.perf_counter(), "cpu")
    assert run["check"].ok, run["check"].line()
    args = (cell, run["check_weights"], run["check_pool"], run["check_rois"], seed, "cpu")
    ref = check_train.reference_steps(*args)
    ctl = check_train.numbers(cell.model, check_train.reference_steps(*args, "bf16"), ref,
                              run["check_rois"][0])
    assert control.over_limits(cell, ctl), (ctl, run["check"].line())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in common.read_benchmark()["workloads"]])
def test_control_at_the_cells_own_size(cuda_device, name, tmp_path):
    """On three seeds at the cell's own size: the program within every
    limit; the control and each planted fault over one at least."""
    out = tmp_path / "readings.json"
    assert control.main(["--workload", name, "--seeds", "3", "--control-seeds", "3",
                         "--out", str(out)]) == 0
    readings = json.load(open(out))["readings"]
    sides = {r["side"] for r in readings}
    assert sides & {"control_fp8", "control_bf16"}, sides
    for r in readings:
        assert bool(r["over_limits"]) is (r["side"] != "program"), r
