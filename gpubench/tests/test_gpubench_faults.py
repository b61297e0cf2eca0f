"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a small size (the program's plain versions; serving in f32), with
the cell's own limits: once sound, once for each fault the cell can have.  Serving:
half of the batch left out, a text altered where it is produced.
Training: a step that returns its state unchanged, half of the batch left
out (the mean taken over the rest).  No cell runs on several cards, so
none can leave out an exchange between them."""

import copy
import time

import numpy as np
import pytest
import torch

from gpubench import common, report
from gpubench.control import half_batch

SERVE = "stream-frames-b32-704x1280"
TRAIN = {"train-gateless-crops512-b32": dict(batch=2, crop=128, pool_batches=4),
         "train-gated-frames640x960-b16": dict(batch=2, pool_batches=3)}


def _small(name, **over):
    cell = copy.deepcopy(common.find_cell(name))
    cell.traffic.update(over)
    return cell


def _small_serving(**over):
    """The scenes serving cell (not in ``BENCHMARK.json`` yet), from its
    files."""
    cell = common.cell_from_files(SERVE, "gpubench/configs/fots-icdar15-gated.json", SERVE)
    cell.traffic.update(over)
    return cell


def _serve_run(monkeypatch, fault=None):
    import fots_torch.codec as codec
    from fots_torch.pipeline import FOTSInference

    if fault == "drop_half":
        host_boxes = FOTSInference._host_boxes

        def half(self, cands, n, hw):
            boxes = host_boxes(self, cands, n, hw)
            return [b if i < len(boxes) // 2 else b[:0] for i, b in enumerate(boxes)]

        monkeypatch.setattr(FOTSInference, "_host_boxes", half)
    elif fault == "alter_text":
        decode = codec.LabelCodec.decode_batch

        def altered(self, ids, *a, **k):
            return [("Q" + t[1:]) if t else t for t in decode(self, ids, *a, **k)]

        monkeypatch.setattr(codec.LabelCodec, "decode_batch", altered)
    # f32 on the CPU and the same two scenes in every batch: the faults are in
    # the pipeline, not in the precision or the draw
    from gpubench.drivers import serve
    monkeypatch.setattr(serve, "MIXED_PRECISION", False)
    monkeypatch.setattr(serve.Frames, "draw", lambda self: np.asarray([16, 17]))
    cell = _small_serving(batch=2, serve_hw=[192, 320], warmup_batches=1, check_batches=1)
    run = report.drive(cell, 3_000_000_019, 2.0, False, time.perf_counter(), "cpu")
    return run["check"], run["failed"]


@pytest.mark.parametrize("fault", [None, "drop_half", "alter_text"])
def test_serving_faults(monkeypatch, fault):
    check, failed = _serve_run(monkeypatch, fault)
    assert failed == 0
    assert check.ok is (fault is None), check.line()


def _train_run(monkeypatch, name, fault=None):
    import fots_torch.train as program_train

    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        monkeypatch.setattr(program_train, "detection_loss",
                            half_batch(program_train.detection_loss))
    cell = _small(name, warmup_steps=0, **TRAIN[name])
    run = report.drive(cell, 3_000_000_023, 0.0, False, time.perf_counter(), "cpu")
    return run["check"]


@pytest.mark.parametrize("name", sorted(TRAIN))
@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_training_faults(monkeypatch, name, fault):
    check = _train_run(monkeypatch, name, fault)
    assert check.ok is (fault is None), check.line()
    assert np.isfinite(list(check.numbers.values())).all() or fault is not None
