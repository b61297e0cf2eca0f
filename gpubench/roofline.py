"""The yardstick's table of peaks and the bytes each hand-written kernel
must move, from the shapes of its call.

Bytes count each input read once and each output written once.  The
forward kernels take their shapes from the registered ops the profiler
records (``fots_torch::instance_norm``, ``instance_norm_stats``,
``spatial_stats``, ``spatial_norm``, ``pack_neighbors``); a backward
launch takes the shapes of the forward call it differentiates.  The bound
of all of them is bytes: none does enough arithmetic per byte to be bound
by operations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

#: one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, 700 W)
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "f32_flops_per_s": 67e12,
}

#: element sizes of the dtype names the profiler records
_ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "int": 4,
             "long int": 8, "signed char": 1, "unsigned char": 1, "bool": 1}

#: kernel-name fragment -> the kernel it belongs to (first match wins)
KERNEL_NAMES = (("in_bwd_", "K1'-bwd"), ("in_cluster_kernel", "K1'"),
                ("in_stats_kernel", "K1'"), ("in_apply_kernel", "K1'"),
                ("spatial_stats_kernel", "K2'"), ("spatial_norm_kernel", "K3'"),
                ("pack_neighbors_bwd_kernel", "K4'-bwd"), ("pack_neighbors_kernel", "K4'"))


def kernel_of(name: str) -> Optional[str]:
    for frag, k in KERNEL_NAMES:
        if frag in name:
            return k
    return None


def itemsize(dtype: str) -> int:
    return _ITEMSIZE.get(dtype, 4)


def _n(shape: Sequence[int]) -> int:
    return int(math.prod(shape)) if shape else 0


def op_bytes(op: str, shapes: List[List[int]], dtypes: List[str],
             backward: bool = False) -> Dict[str, float]:
    """Bytes by kernel of one call of a registered op (its forward kernels,
    or with ``backward`` the kernels that differentiate it)."""
    x, isz = _n(shapes[0]), itemsize(dtypes[0])
    if op in ("fots_torch::instance_norm", "fots_torch::instance_norm_stats"):
        c = shapes[0][-1]
        b = shapes[0][0]
        small = 2 * 4 * c + (4 * b if len(shapes) > 5 and shapes[5] else 0)
        if backward:  # x and the cotangent read, dx written, (mean, rstd) read
            return {"K1'-bwd": 3 * x * isz + 2 * 4 * b * c + small}
        stats = 2 * 4 * b * c if op.endswith("_stats") else 0
        return {"K1'": 2 * x * isz + small + stats}
    if op == "fots_torch::spatial_stats":
        b, c = shapes[0][0], shapes[0][-1]
        return {"K2'": x * isz + 2 * 4 * b * c}
    if op == "fots_torch::spatial_norm":
        b, c = shapes[0][0], shapes[0][-1]
        halves = _n(shapes[1]) // max(1, 2 * b * c)
        if backward:  # the CReLU-IN's backward: x and both halves read, dx written
            return {"K1'-bwd": (2 + halves) * x * isz + 4 * _n(shapes[1])}
        return {"K3'": (1 + halves) * x * isz + 4 * _n(shapes[1])}
    if op == "fots_torch::pack_neighbors":
        if backward:  # the quads' f32 cotangent read, the map's written
            return {"K4'-bwd": 5 * x * 4}
        return {"K4'": 5 * x * isz}
    return {}


def bound_ms(nbytes: float) -> float:
    return 1e3 * nbytes / PEAKS["hbm_bytes_per_s"]


def roofline_share(calls, kernel_us: Dict[str, float], backward: bool) -> Optional[float]:
    """Percent: the least time of the window's kernel launches by bytes over
    the device time they took.  ``calls``: (op, shapes, dtypes) of the
    registered ops; ``kernel_us``: device microseconds by kernel;
    ``backward``: every forward call was differentiated once (a training
    step).  None when no kernel ran."""
    need: Dict[str, float] = {}
    for op, shapes, dtypes in calls:
        for k, v in op_bytes(op, shapes, dtypes).items():
            need[k] = need.get(k, 0.0) + v
        if backward:
            for k, v in op_bytes(op, shapes, dtypes, backward=True).items():
                need[k] = need.get(k, 0.0) + v
    took = sum(kernel_us.get(k, 0.0) for k in need)
    if took <= 0:
        return None
    return 100.0 * sum(bound_ms(v) * 1e3 for v in need.values()) / took
