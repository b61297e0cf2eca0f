"""The program's own spans over a traced window: the preparing thread's
host work a step by what it was.

The program records its spans in ``fots_torch.tracing`` (on by itself while
the profiler runs, on every thread); they carry unix nanoseconds, the clock
of the profiler's events.  The window is the one ``device_idle.train``
reads (``trace.reduce``: first to last event of the profiler's span).  Only
the preparing thread's spans are read: the profiler slows the dispatching
thread's work (2.4-4x on an H100), so its spans, and the card's idle under them, would
describe the profiled loop and not the untraced one.  A checkout whose
program records no spans gives None everywhere, so its metrics are left
out."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from gpubench import trace

#: the preparing thread's spans; the wait for the previous step's candidates
PREP, CAND_WAIT = "prep.", "prep.wait_candidates"


@dataclass
class Recorded:
    """One program span, in microseconds."""

    name: str
    thread: int
    id: int
    parent: Optional[int]
    start_us: float
    end_us: float


@dataclass
class Traced:
    """A traced window with the program's spans in it."""

    spans: List[Recorded]
    t0: float
    t1: float
    steps: int                        # steps the profiler spanned


def program_spans():
    """``fots_torch.tracing``'s spans as :class:`Recorded`, or None where
    the program has no recorder."""
    try:
        from fots_torch import tracing
    except ImportError:
        return None
    return [Recorded(s.name, s.thread, s.id, s.parent, s.start_ns / 1e3, s.end_ns / 1e3)
            for s in tracing.spans()]


def traced(run) -> Optional[Traced]:
    """The program's spans over a training cell's traced window (computed
    once a run), or None."""
    if getattr(run, "kind", None) != "train" or run.window is None or not run.span.spanned:
        return None
    if "_traced_spans" not in vars(run):
        run._traced_spans = _traced(run)
    return run._traced_spans


def _traced(run) -> Optional[Traced]:
    recorded = program_spans()
    if not recorded:
        return None
    events = trace.events_of(run.span.prof)
    t0 = min(e.start_us for e in events)
    t1 = max(e.end_us for e in events)
    inside = [s for s in recorded if s.end_us > t0 and s.start_us < t1]
    if not any(s.name.startswith(PREP) for s in inside):
        return None
    return Traced(inside, t0, t1, run.span.spanned)


def self_ms_per_step(t: Optional[Traced], pick: Callable[[str], bool]) -> Optional[float]:
    """Self time (a span less its children) of the spans whose name
    ``pick`` takes, clipped to the window, in ms a step."""
    if t is None:
        return None

    def clipped(s):
        return max(0.0, min(s.end_us, t.t1) - max(s.start_us, t.t0))

    ids = {s.id for s in t.spans if pick(s.name)}
    total = sum(clipped(s) for s in t.spans if s.id in ids)
    total -= sum(clipped(s) for s in t.spans if s.parent in ids)
    return total / 1e3 / t.steps
