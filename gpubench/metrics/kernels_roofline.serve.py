"""Percent: the least time of the traced span's K1'-K4' launches by bytes
(each input read once, each output written once, at 3.35 TB/s) over the
device time those kernels took, in a serving cell.  The bound is bytes."""

from gpubench import roofline


def read(run):
    if run.kind != "serve" or run.window is None:
        return None
    return roofline.roofline_share(run.window.op_calls, _by_kernel(run.window.kernel_us),
                                   backward=False)


def _by_kernel(kernel_us):
    out = {}
    for name, us in kernel_us.items():
        k = roofline.kernel_of(name)
        if k is not None:
            out[k] = out.get(k, 0.0) + us
    return out
