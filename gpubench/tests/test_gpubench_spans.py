"""The readers of the program's spans (``gpubench/spans.py``) on synthetic
spans and device events, with answers worked out by hand; and nothing to
read where the program records no spans."""

from types import SimpleNamespace

import pytest

from gpubench import common, spans, trace
from gpubench.spans import Recorded
from gpubench.trace import Event

MAIN, PREP = 1, 2

#: window 0-100 us (first to last event)
EVENTS = [Event("aten::conv2d", False, 0, 5),
          Event("kernel_a", True, 20, 40), Event("kernel_b", True, 70, 100)]

SPANS = [
    Recorded("train.fetch", MAIN, 1, None, -10, 0),            # before the window
    Recorded("train.wait_prepared", MAIN, 2, None, 0, 25),
    Recorded("step.upload", MAIN, 3, None, 25, 30),
    Recorded("step.forward", MAIN, 4, None, 30, 50),
    Recorded("step.backward", MAIN, 5, None, 50, 80),
    Recorded("prep.pack_maps", PREP, 6, None, -20, 30),        # 30 inside, less its pin
    Recorded("prep.pin", PREP, 7, 6, 10, 20),
    Recorded("prep.sample_rois", PREP, 8, None, 40, 90),       # 50, less the wait
    Recorded("prep.wait_candidates", PREP, 9, 8, 45, 75),
    Recorded("prep.pack_rois", PREP, 10, None, 90, 110),       # 10 inside, less its pin
    Recorded("prep.pin", PREP, 11, 10, 95, 105),
]

WANT = {
    "prep_busy_ms.train": (20 + 10 + 20 + 5 + 5) / 1e3 / 2,
    "cand_wait_ms.train": 30 / 1e3 / 2,
}


def _run(kind="train"):
    return SimpleNamespace(kind=kind, window=object(),
                           span=SimpleNamespace(prof=object(), spanned=2))


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: list(SPANS))
    monkeypatch.setattr(trace, "events_of", lambda prof: list(EVENTS))


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_synthetic_spans(synthetic, metric):
    assert common.load_reader(metric)(_run()) == pytest.approx(WANT[metric])


def test_nothing_to_read_without_the_preparing_threads_spans(synthetic, monkeypatch):
    monkeypatch.setattr(spans, "program_spans",
                        lambda: [r for r in SPANS if not r.name.startswith(spans.PREP)])
    for metric in WANT:
        assert common.load_reader(metric)(_run()) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_nothing_to_read_without_program_spans(monkeypatch, metric):
    monkeypatch.setattr(trace, "events_of", lambda prof: list(EVENTS))
    monkeypatch.setattr(spans, "program_spans", lambda: None)
    assert common.load_reader(metric)(_run()) is None
    monkeypatch.setattr(spans, "program_spans", lambda: list(SPANS))
    assert common.load_reader(metric)(_run("serve")) is None


def test_a_checkout_without_the_recorder_reads_none(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tracing(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "fots_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("cannot import name 'tracing'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracing)
    assert spans.program_spans() is None


def test_the_program_spans_are_read_in_microseconds():
    from fots_torch import tracing

    tracing.reset()
    try:
        with tracing.enable():
            with tracing.span("step.forward") as outer:
                with tracing.span("prep.pin"):
                    pass
        got = spans.program_spans()
    finally:
        tracing.reset()
    assert [(r.name, r.parent) for r in got] == [("prep.pin", outer.id), ("step.forward", None)]
    assert got[1].start_us == outer.start_ns / 1e3 and got[1].end_us == outer.end_ns / 1e3
