"""Reading a profiler window: the interval union, busy and idle time, the
launch calls and where the device sat idle."""

import pytest

from gpubench.trace import Event, Span, reduce, union_us


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),          # overlap counted once
    ([(0, 10), (2, 3)], 10.0),           # nested
    ([(20, 30), (0, 10)], 20.0),         # unsorted, disjoint
    ([(0, 10), (10, 20)], 20.0),         # touching
])
def test_union(intervals, want):
    assert union_us(intervals) == want


def test_reduce_busy_idle_launches_and_gaps():
    ev = [Event("cudaLaunchKernel", False, 0, 1), Event("cudaLaunchKernelExC", False, 2, 3),
          Event("aten::conv2d", False, 0, 5),
          Event("bench::nms", False, 10, 60),
          Event("kernel_a", True, 1, 11), Event("kernel_b", True, 5, 9),
          Event("kernel_a", True, 61, 100),
          Event("fots_torch::instance_norm", False, 0.5, 0.9, [[2, 4, 4, 8]], ["float"])]
    w = reduce(ev)
    assert w.window_s == pytest.approx(100e-6)
    assert w.busy_s == pytest.approx((10 + 39) * 1e-6)
    assert w.launches == 2
    assert w.kernel_us == {"kernel_a": 49.0, "kernel_b": 4.0}
    assert w.op_calls == [("fots_torch::instance_norm", [[2, 4, 4, 8]], ["float"])]
    assert dict(w.idle_gaps)["bench::nms"] == pytest.approx(50e-6)


def test_reduce_refuses_a_window_without_device_work():
    with pytest.raises(RuntimeError):
        reduce([Event("aten::add", False, 0, 1)])


def test_span_counts_batches_between_start_and_stop(monkeypatch):
    class Prof:
        def __init__(self, **_):
            self.on = False

        def start(self):
            self.on = True

        def stop(self):
            self.on = False

    import torch

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    counters = {"k": 0}
    span = Span(2, 3, counters)
    for done in range(1, 8):
        counters["k"] += 10
        span.tick(done)
    assert span.first == 2 and span.last == 5 and span.spanned == 3
    assert span.counted == {"k": 30}
