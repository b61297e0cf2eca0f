"""Reading a torch.profiler window: device busy time (the union of kernel,
copy and memset intervals, user annotations left out), the host's launch
calls, the registered ops' shapes, and where the device sat idle.

``union_us`` and ``is_annotation`` are copies of the program's own
(``fots_torch/profiling.py``), kept here so the yardstick cannot change
with the program."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: the host's CUDA runtime calls that put work on the card: a kernel each
#: (``cudaLaunchKernel``, ``cudaLaunchKernelExC``), a captured graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch")
#: device gaps shorter than this are counted together, not put down to an op
SHORT_GAP_US = 20.0
#: the registered ops of the hand-written kernels
KERNEL_OPS = ("fots_torch::instance_norm", "fots_torch::instance_norm_stats",
              "fots_torch::spatial_stats", "fots_torch::spatial_norm",
              "fots_torch::pack_neighbors")


def union_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def is_annotation(name: str, flagged: bool = False) -> bool:
    """A record_function range mirrored onto the device timeline: it spans
    the kernels launched inside it and the gaps between them, so it is no
    device work of its own."""
    return flagged or re.fullmatch(r"[\w.:]+#[\w.]+", name) is not None


@dataclass
class Event:
    name: str
    device: bool
    start_us: float
    end_us: float
    shapes: list = field(default_factory=list)
    dtypes: list = field(default_factory=list)


@dataclass
class Window:
    """One traced window, reduced."""

    busy_s: float
    window_s: float
    launches: int
    kernel_us: Dict[str, float]        # device microseconds by kernel name
    op_calls: List[Tuple[str, list, list]]
    device_ops: List[Tuple[str, float]]  # top device ops, seconds
    idle_gaps: List[Tuple[str, float]]   # idle seconds by what the host was doing


def events_of(prof) -> List[Event]:
    """The profiler's events as :class:`Event` (microseconds)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        flagged = bool(getattr(e, "is_user_annotation", lambda: False)())
        if dev and is_annotation(e.name(), flagged):
            continue
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), dev, start, start + e.duration_ns() / 1e3,
                         list(e.shapes()) if not dev else [],
                         list(e.dtypes()) if not dev else []))
    return out


def reduce(events: List[Event], host_labels: Tuple[str, ...] = ("bench::",)) -> Window:
    """The window's numbers.  Its span runs from the first to the last event
    of either side.  An idle gap of the device is put down to the host
    range (a ``record_function`` label starting with one of
    ``host_labels``) or else the torch op that overlaps it most."""
    dev = [e for e in events if e.device]
    host = [e for e in events if not e.device]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    t0 = min(e.start_us for e in events)
    t1 = max(e.end_us for e in events)
    busy = union_us([(e.start_us, e.end_us) for e in dev])
    launches = sum(1 for e in host if e.name.startswith(LAUNCH_CALLS))
    kernel_us: Dict[str, float] = defaultdict(float)
    for e in dev:
        kernel_us[e.name] += e.end_us - e.start_us
    calls = [(e.name, e.shapes, e.dtypes) for e in host if e.name in KERNEL_OPS]
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps of the device timeline, put down to the host's activity
    gaps, end = [], t0
    for s, e in sorted((e.start_us, e.end_us) for e in dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    labelled = sorted((e for e in host if e.name.startswith(host_labels)),
                      key=lambda e: e.start_us)
    ops = sorted((e for e in host if e.name.startswith("aten::")), key=lambda e: e.start_us)
    labelled_at, ops_at = [e.start_us for e in labelled], [e.start_us for e in ops]
    by_what: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        if e - s < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US:g} us"
        else:
            name = (_overlapping(labelled, labelled_at, s, e)
                    or _overlapping(ops, ops_at, s, e) or "host outside torch ops")
        by_what[name] += (e - s) / 1e6
    idle = sorted(by_what.items(), key=lambda kv: -kv[1])[:10]
    return Window(busy / 1e6, (t1 - t0) / 1e6, launches, dict(kernel_us), calls,
                  [(n[:120], us / 1e6) for n, us in top], idle)


def _overlapping(events: List[Event], starts: List[float], s: float, e: float,
                 back: int = 256):
    """The name of the event that overlaps [s, e] most, among the ``back``
    events that start last before ``e`` (``events`` sorted by start, whose
    starts are ``starts``)."""
    best, best_ov = None, 0.0
    i = bisect.bisect_left(starts, e)
    for ev in events[max(0, i - back):i]:
        ov = min(e, ev.end_us) - max(s, ev.start_us)
        if ov > best_ov:
            best, best_ov = ev.name, ov
    return best


class Span:
    """A profiler over part of a window: it starts once ``start_after``
    batches (or steps) are done and stops ``count`` later (or at
    :meth:`close`).  Also the program's own launch counters over the same
    span (``counters``: a dict the program increments)."""

    def __init__(self, start_after: int, count: int, counters=None):
        self.start_after, self.count = start_after, count
        self.counters = counters
        self.prof = None
        self.first = self.last = None
        self.counted = {}

    def tick(self, done: int) -> None:
        import torch

        if self.prof is None and done >= self.start_after:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA], record_shapes=True)
            self.counted = dict(self.counters or {})
            self.prof.start()
            self.first = done
        elif self.prof is not None and self.last is None and done >= self.first + self.count:
            self._stop(done)

    def close(self, done: int) -> None:
        if self.prof is not None and self.last is None:
            self._stop(done)

    def _stop(self, done: int) -> None:
        self.prof.stop()
        self.last = done
        self.counted = {k: (self.counters or {})[k] - v for k, v in self.counted.items()
                        if (self.counters or {})[k] != v}

    @property
    def spanned(self) -> int:
        """Batches (steps) done while the profiler ran."""
        return 0 if self.last is None else self.last - self.first
