"""The span recorder of the port (:mod:`fots_torch.tracing`), on the CPU.

- off (no ``enable()``, no profiler) a span records nothing and costs a
  shared no-op context;
- a span on a pool thread is recorded while a ``torch.profiler.profile``
  runs (which itself records only the thread that started it), and not
  after it stopped;
- parents, self time, and the bounded ring that drops the oldest and
  counts them;
- a span and a ``record_function`` range around the same block agree on
  the profiler's clock within 1 ms;
- three ``Trainer.train`` steps (a crop dump and a checkpoint every other
  step) give every span of the training loop on the thread that does the
  work, with the step it belongs to; a fourth step with the recorder off
  leaves the ring empty;
- :func:`fots_torch.profiling._idle_ns_under`, which puts the card's idle
  time down to spans, and ``_union_us``, the card's busy time, on
  intervals with known answers.
"""

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fots_torch import checkpoint as tck
from fots_torch import profiling
from fots_torch import tracing
from fots_torch import train as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
CROP = (128, 160, 192, 352)  # y0, x0, H, W: three words of two asset scenes

STEP_SPANS = {"train.fetch", "train.wait_prepared", "step.upload", "step.forward",
              "step.backward", "step.optimizer", "step.candidates", "train.drain_metrics"}
MAIN_SPANS = STEP_SPANS | {"train.debug_dump", "train.checkpoint"}
PREP_SPANS = {"prep.pack_maps", "prep.pin", "prep.sample_rois", "prep.pack_rois"}


@pytest.fixture(autouse=True)
def _empty_ring():
    tracing.reset()
    yield
    tracing.reset()


def _names():
    return [s.name for s in tracing.spans()]


def test_off_records_nothing():
    with tracing.span("x") as s:
        assert s is None
    assert tracing.span("a") is tracing.span("b")
    assert tracing.spans() == []
    with tracing.enable():
        with tracing.enable():  # nests
            pass
        with tracing.span("x", k=1) as s:
            s.attrs["n"] = 2
    with tracing.span("y") as s:
        assert s is None
    assert _names() == ["x"] and tracing.spans()[0].attrs == {"k": 1, "n": 2}


def test_pool_thread_span_is_recorded_while_a_profiler_runs_and_not_after():
    def work(name):
        with tracing.span(name):
            torch.ones(4).add_(1)

    with ThreadPoolExecutor(max_workers=1) as pool:
        pool.submit(work, "before").result()  # the thread exists before the profiler
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pool.submit(work, "during").result()
        pool.submit(work, "after").result()
    assert _names() == ["during"]
    assert tracing.spans()[0].thread != threading.get_ident()
    # the profiler itself did not see the pool thread's work
    assert "during" not in {e.name() for e in prof.profiler.kineto_results.events()}


def test_parents_self_time_and_the_bounded_ring(monkeypatch):
    with tracing.enable():
        tracing.set_step(7)
        with tracing.span("outer") as outer:
            with tracing.span("inner", step=8) as inner:
                time.sleep(0.002)
            with tracing.span("inner2") as inner2:
                time.sleep(0.001)
    got = {s.name: s for s in tracing.spans()}
    assert got["outer"].parent is None and got["outer"].step == 7
    assert got["inner"].parent == got["inner2"].parent == outer.id
    assert got["inner"].step == 8 and got["inner2"].step == 7
    assert got["outer"].start_ns <= got["inner"].start_ns < got["inner"].end_ns \
        <= got["inner2"].start_ns < got["inner2"].end_ns <= got["outer"].end_ns
    own = tracing.self_ns(tracing.spans())
    dur = {n: s.end_ns - s.start_ns for n, s in got.items()}
    assert own[inner.id] == dur["inner"] and own[inner2.id] == dur["inner2"]
    assert own[outer.id] == dur["outer"] - dur["inner"] - dur["inner2"]

    # a full ring drops its oldest span and counts it
    monkeypatch.setattr(tracing, "_ring", deque(maxlen=3))
    with tracing.enable():
        for k in range(5):
            with tracing.span(f"s{k}"):
                pass
    assert _names() == ["s2", "s3", "s4"] and tracing.dropped() == 2
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_span_agrees_with_record_function_on_the_profiler_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        time.sleep(0.01)
        with tracing.span("block"), torch.profiler.record_function("block"):
            time.sleep(0.005)
            torch.ones(16).mul_(2)
    (rec,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "block"]
    (s,) = tracing.spans()
    assert abs(s.start_ns - rec.start_ns()) < 1_000_000
    assert abs(s.end_ns - (rec.start_ns() + rec.duration_ns())) < 1_000_000


def _cropped_batch():
    with np.load(os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images = z["images"]
    with np.load(os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")) as z:
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


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three pipelined steps with the recorder on, then one with it off:
    (the spans of the three, the spans left by the fourth)."""
    tmp = tmp_path_factory.mktemp("traced")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        batch = _cropped_batch()
        model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
        trainer = ttrain.Trainer(model, learning_rate=1e-4, seed=3, device="cpu")
        tracing.reset()
        with tracing.enable():
            trainer.train([batch] * 3, max_steps=3, log_every=1,
                          checkpoint_dir=str(tmp / "run"), checkpoint_every=2,
                          debug_dir=str(tmp / "debug"), debug_every=2)
        recorded = tracing.spans()
        tracing.reset()
        trainer.train([batch], max_steps=4, log_every=1)
        assert trainer.global_step == 4
        return recorded, tracing.spans()
    finally:
        torch.set_num_threads(saved)


def test_trainer_spans_on_both_threads_with_their_steps(trained):
    spans, _ = trained
    main = threading.get_ident()
    on_main = {s.name for s in spans if s.thread == main}
    prep_threads = {s.thread for s in spans if s.name.startswith("prep.")}
    assert on_main == MAIN_SPANS
    assert len(prep_threads) == 1 and main not in prep_threads
    assert {s.name for s in spans if s.thread != main} == PREP_SPANS | {"prep.wait_candidates"}
    by_id = {s.id: s for s in spans}
    for step in range(3):
        names = [s.name for s in spans if s.step == step]
        assert set(names) >= STEP_SPANS | PREP_SPANS, step
        assert names.count("train.fetch") == 1 and names.count("step.forward") == 1
        # the first step has no earlier step's candidates to wait for
        assert names.count("prep.wait_candidates") == (step > 0)
    for s in spans:
        if s.name == "prep.pin":
            assert by_id[s.parent].name in ("prep.pack_maps", "prep.pack_rois")
            assert by_id[s.parent].step == s.step
        elif s.name == "prep.wait_candidates":
            assert by_id[s.parent].name == "prep.sample_rois"
        else:
            assert s.parent is None, s
    # a step's device work is dispatched after its batch was prepared
    for step in range(3):
        prepared = max(s.end_ns for s in spans if s.step == step and s.name == "prep.pack_rois")
        waited = [s for s in spans if s.step == step and s.name == "train.wait_prepared"]
        upload = [s for s in spans if s.step == step and s.name == "step.upload"]
        assert prepared <= waited[0].end_ns <= upload[0].start_ns
    dumps = [s for s in spans if s.name == "train.debug_dump"]
    assert [s.step for s in dumps] == [0, 2] and all(s.attrs["crops"] > 0 for s in dumps)
    # every other step, and at the end
    assert [s.step for s in spans if s.name == "train.checkpoint"] == [1, 2]
    fetched = [s for s in spans if s.name == "train.fetch"]
    assert [s.step for s in fetched] == [0, 1, 2]
    assert all(set(s.attrs) == set(ttrain.FETCH_ATTRS) for s in fetched)


def test_trainer_off_records_nothing(trained):
    _, after = trained
    assert after == []


@pytest.mark.parametrize("busy,under,lo,hi,want", [
    ([], [(0, 10)], 0, 100, 10),                       # idle all through the span
    ([(0, 100)], [(0, 10)], 0, 100, 0),                # busy all through
    ([(2, 4), (6, 8)], [(0, 10)], 0, 100, 6),          # two kernels inside
    ([(2, 4), (3, 9)], [(0, 10), (5, 20)], 0, 100, 13),  # overlaps merged
    ([(5, 15)], [(0, 10), (12, 30)], 0, 20, 10),       # clipped to the window
    ([(50, 60)], [(0, 10)], 0, 100, 10),               # busy elsewhere
])
def test_idle_under_spans(busy, under, lo, hi, want):
    assert profiling._idle_ns_under(busy, under, lo, hi) == want


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 10.0)], 10.0),
    ([(5.0, 8.0), (0.0, 10.0)], 10.0),                 # nested
    ([(0.0, 4.0), (3.0, 6.0), (8.0, 9.5)], 7.5),       # overlap, then a gap
    ([(0.0, 2.0), (2.0, 3.0)], 3.0),                   # touching
])
def test_union_of_busy_intervals(intervals, want):
    assert profiling._union_us(intervals) == want
