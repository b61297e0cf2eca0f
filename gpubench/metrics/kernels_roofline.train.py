"""Percent: the least time of the traced span's K1'-K4' launches and their
backward kernels (K1'-bwd, K4'-bwd) by bytes (each input read once, each
output written once, at 3.35 TB/s; a backward launch at the shapes of the
forward call it differentiates) over the device time those kernels took,
in a training cell.  The bound is bytes."""

from gpubench import roofline


def read(run):
    if run.kind != "train" or run.window is None:
        return None
    by_kernel = {}
    for name, us in run.window.kernel_us.items():
        k = roofline.kernel_of(name)
        if k is not None:
            by_kernel[k] = by_kernel.get(k, 0.0) + us
    return roofline.roofline_share(run.window.op_calls, by_kernel, backward=True)
