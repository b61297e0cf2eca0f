"""Spans of the port's host work, on the clock of torch.profiler's events.

    from fots_torch import tracing

    with tracing.enable():
        trainer.train(batches, max_steps=10)
    for s in tracing.spans():
        print(s.name, s.step, s.thread, s.end_ns - s.start_ns, s.attrs)

``with span(name, **attrs) as s:`` marks a block.  The recorder is on while
:func:`enable` is in force and while any torch profiler runs in the process
(``torch.autograd.profiler._is_profiler_enabled``, which every thread
sees), so a profiled window gets the spans of every thread, including the
ones the profiler itself does not record.  Off, a span costs the check of
two module-level flags and hands back a shared no-op context (``s`` is
None): no span object, no clock read, no ``record_function``.

On, a span is kept when it ends, in a bounded ring (:data:`RING` spans; the
oldest are dropped and counted, :func:`dropped`).  Each holds its name, the
thread, the step (the thread's, :func:`set_step`, unless given), the id of
the innermost span open on the thread when it started (``parent``), start
and end, and ``attrs`` (``s.attrs`` may be filled inside the block).
Stamps are unix nanoseconds, the clock of ``kineto_results.events()``'
``start_ns()``: one ``time.time_ns()`` / ``perf_counter_ns()`` pair read
when recording starts, then the monotonic counter.

Spans of :mod:`fots_torch.train` (see :meth:`fots_torch.train.Trainer.train`):
the dispatching thread's ``train.fetch``, ``train.wait_prepared``,
``step.upload``, ``step.forward``, ``step.backward``, ``step.optimizer``,
``step.candidates``, ``train.drain_metrics``, ``train.debug_dump`` and
``train.checkpoint``; the preparing thread's ``prep.pack_maps``,
``prep.pin`` (a child of the span that pins), ``prep.sample_rois``,
``prep.wait_candidates`` (its child) and ``prep.pack_rois``.
:func:`fots_torch.profiling.profile_training` reports them a step.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

import torch.autograd.profiler as _profiler

#: spans the ring holds
RING = 1 << 16

_enabled = 0                       # nesting depth of enable()
_ring: deque = deque(maxlen=RING)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_anchor: Optional[tuple] = None    # (time_ns, perf_counter_ns) at the start of recording
_local = threading.local()         # .step, .stack (ids of the open spans)


class Span:
    """One recorded block (see the module docstring)."""

    __slots__ = ("name", "thread", "step", "parent", "id", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, step: Optional[int], attrs: dict):
        self.name, self.step, self.attrs = name, step, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if self.step is None:
            self.step = getattr(_local, "step", None)
        self.thread = threading.get_ident()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped, _anchor
        end = time.perf_counter_ns()
        _local.stack.pop()
        if _anchor is None:
            _anchor = (time.time_ns(), time.perf_counter_ns())
        wall, mono = _anchor
        self.start_ns += wall - mono
        self.end_ns = end + wall - mono
        with _lock:
            if len(_ring) == _ring.maxlen:
                _dropped += 1
            _ring.append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, step={self.step}, thread={self.thread}, id={self.id}, "
                f"parent={self.parent}, {self.end_ns - self.start_ns} ns, {self.attrs})")


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, step: Optional[int] = None, **attrs):
    """A context manager that records the block as span ``name`` while the
    recorder is on (``step``: the step it belongs to, default the thread's)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, step, attrs)


def set_step(step: Optional[int]) -> None:
    """The step this thread's next spans belong to."""
    _local.step = step


def at_step(step: int, fn, *args):
    """``fn(*args)`` with ``step`` as this thread's step (for a pool task)."""
    _local.step = step
    return fn(*args)


@contextlib.contextmanager
def enable():
    """Record spans inside the block (nests)."""
    global _enabled, _anchor
    with _lock:
        if not _enabled:
            _anchor = None
        _enabled += 1
    try:
        yield
    finally:
        with _lock:
            _enabled -= 1


def spans() -> List[Span]:
    """The recorded spans, oldest first."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Spans the ring dropped since the last :func:`reset`."""
    return _dropped


def reset() -> None:
    """Empty the ring; the next span reads the clock pair anew."""
    global _dropped, _anchor
    with _lock:
        _ring.clear()
        _dropped = 0
        _anchor = None


def self_ns(recorded: Iterable[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration less its recorded
    children's."""
    recorded = list(recorded)
    out = {s.id: s.end_ns - s.start_ns for s in recorded}
    for s in recorded:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
