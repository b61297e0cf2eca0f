"""Fused instance normalization (+ affine + optional leaky-relu), NHWC,
with its gradient; and the CReLU-IN of the stem.

Port of ``fots/ops/instance_norm.py``.  Entry points:

- :func:`instance_norm` (optionally masked by ``valid_w``): forward K1'
  (``fots_torch/csrc/instance_norm.cu``), backward K1'-bwd
  (``csrc/instance_norm_bwd.cu``), joined by a ``torch.autograd.Function``;
- :func:`crelu_instance_norm`, the counterpart of
  ``crelu_instance_norm_half``: concat(x, -x) -> IN(affine) -> leaky as K2'
  statistics (``csrc/spatial_norm.cu``), a per-(b, c) fold, and K3' writing
  the ``[+x part | -x part]`` halves; its backward is K1'-bwd in the CReLU
  mode (reads x once and both halves of the cotangent, writes dx).

On a CUDA tensor each launches its kernels; on a CPU tensor it runs the
kernels' plain versions (``*_ref``), which repeat their arithmetic.

K1' and K1'-bwd have two routes, chosen by :func:`in_plan` from the shape
alone: ``"cluster"``, one kernel in which a thread-block cluster keeps the
(H, W, channel-group) plane in shared memory so each tensor crosses device
memory once, and ``"two_pass"`` (statistics kernel, then apply kernel) for
planes no cluster can hold, channel counts that are not a multiple of the
32-byte group, the CReLU mode and unaligned pointers.  A launch that fails
raises; no route is a fallback of the other.

Layout: ``x`` is ``[B, H, W, C]`` — the JAX package's NHWC — which is a
``permute(0, 2, 3, 1)`` view of a channels_last NCHW activation, so the
modules pass their tensors without a copy.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from fots_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = {torch.float32: 0}
#: target stats-pass blocks per SM (the pass reads x once; a few blocks
#: per SM hide load latency)
_STATS_BLOCKS_PER_SM = 4


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def instance_norm_ref(x, scale, bias, eps=1e-5, negative_slope=None):
    """Plain version; the same sum/sumsq formula as ``instance_norm_jnp``:
    f32 statistics, ``var = max(s2/n - mean^2, 0)``, output in x's dtype."""
    x32 = x.float()
    n = x32.shape[1] * x32.shape[2]
    s1 = x32.sum(dim=(1, 2), keepdim=True)
    s2 = (x32 * x32).sum(dim=(1, 2), keepdim=True)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    if negative_slope is not None:
        y = torch.where(y >= 0, y, y * negative_slope)
    return y.to(x.dtype)


def _column_mask(valid_w, w, device):
    """[N, 1, W, 1] f32: 1 on columns < valid_w[n]."""
    mask = (torch.arange(w, device=device)[None, :] < valid_w[:, None]).float()
    return mask[:, None, :, None]


def masked_instance_norm_ref(x, valid_w, scale=None, bias=None, eps=1e-5,
                             negative_slope=None):
    """Plain version of ``masked_instance_norm_jnp``: statistics over
    columns ``< valid_w[n]`` (n = H * valid_w[n] values), output re-zeroed
    past them."""
    x32 = x.float()
    _, h, w, _ = x32.shape
    mask = _column_mask(valid_w, w, x.device)
    xm = x32 * mask
    n = (h * valid_w).float()[:, None, None, None]
    s1 = xm.sum(dim=(1, 2), keepdim=True)
    s2 = (xm * xm).sum(dim=(1, 2), keepdim=True)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float() + bias.float()
    if negative_slope is not None:
        y = torch.where(y >= 0, y, y * negative_slope)
    return (y * mask).to(x.dtype)


def instance_norm_stats_ref(x, eps=1e-5, valid_w=None):
    """[B, 2, C] f32 (mean, rstd) of the (masked) statistics, as K1' saves
    them for the backward pass."""
    x32 = x.float()
    _, h, w, _ = x32.shape
    if valid_w is None:
        n = float(h * w)
    else:
        x32 = x32 * _column_mask(valid_w, w, x.device)
        n = (h * valid_w).float()[:, None]
    mean = x32.sum(dim=(1, 2)) / n
    var = torch.clamp_min((x32 * x32).sum(dim=(1, 2)) / n - mean * mean, 0.0)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


def instance_norm_bwd_ref(x, g, stats, scale, bias, negative_slope=None,
                          valid_w=None, halves=1, groups=1):
    """Plain version of K1'-bwd, the same interface and arithmetic.

    u = x (halves 1) or cat(x, -x) (halves 2) over Cu channels; ``stats``
    [B, 2, Cu] (mean, rstd), ``scale``/``bias`` [Cu], all per u channel
    (tiled over ``groups``, whose sums are folded together).  Returns
    (dx [B, H, W, C] in x's dtype, dsb [B, 2, Cu] f32 = per-sample sums of
    gp * z and gp, where gp is g through the activation and the mask)."""
    x32 = x.float()
    b, h, w, c = x32.shape
    u = x32 if halves == 1 else torch.cat([x32, -x32], dim=-1)
    cu = u.shape[-1]
    mean = stats[:, 0][:, None, None, :]
    rstd = stats[:, 1][:, None, None, :]
    s = scale.float()
    z = (u - mean) * rstd
    pre = z * s + bias.float()
    gp = g.float()
    if negative_slope is not None:
        gp = torch.where(pre < 0, gp * negative_slope, gp)
    if valid_w is None:
        n = float(h * w * groups)
        mask = None
    else:
        mask = _column_mask(valid_w, w, x.device)
        gp = gp * mask
        n = (h * valid_w).float()[:, None]
    sum_g = gp.sum(dim=(1, 2))
    sum_gz = (gp * z).sum(dim=(1, 2))
    dsb = torch.stack([sum_gz, sum_g], dim=1)
    if groups > 1:  # statistics are per (half, channel within group)
        def fold(v):
            v = v.view(b, halves, groups, c // groups).sum(dim=2, keepdim=True)
            return v.expand(b, halves, groups, c // groups).reshape(b, cu)
        sum_g, sum_gz = fold(sum_g), fold(sum_gz)
    mdz = (s * sum_g / n)[:, None, None, :]
    mdzz = (s * sum_gz / n)[:, None, None, :]
    du = rstd * s * gp - rstd * mdz - rstd * z * mdzz
    if mask is not None:
        du = du * mask
    dx = du if halves == 1 else du[..., :c] - du[..., c:]
    return dx.to(x.dtype), dsb


def crelu_instance_norm_ref(x, scale, bias, groups=1, eps=1e-5,
                            negative_slope=0.01):
    """Plain CReLU-IN, a copy of ``_crelu_half_jnp``: per original channel
    statistics across ``groups``, output ``[+x part | -x part]``."""
    b, h, w, c = x.shape
    cg = c // groups
    n = h * w * groups
    x32 = x.float()
    s1 = x32.reshape(b, h * w, groups, cg).sum(dim=(1, 2))
    s2 = (x32 * x32).reshape(b, h * w, groups, cg).sum(dim=(1, 2))
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    mean_t = mean.repeat(1, groups)[:, None, None, :]
    rstd_t = rstd.repeat(1, groups)[:, None, None, :]
    z = (x32 - mean_t) * rstd_t
    sc = scale.float()
    bi = bias.float()
    sp, sn = sc[:cg].repeat(groups), sc[cg:].repeat(groups)
    bp, bn = bi[:cg].repeat(groups), bi[cg:].repeat(groups)
    yp = z * sp + bp
    yn = -z * sn + bn
    if negative_slope is not None:
        yp = torch.where(yp >= 0, yp, yp * negative_slope)
        yn = torch.where(yn >= 0, yn, yn * negative_slope)
    return torch.cat([yp, yn], dim=-1).to(x.dtype)


def spatial_stats_ref(x):
    """Plain K2': [B, 2, C] f32 per-(b, c) sum and sum of squares."""
    x32 = x.float()
    return torch.stack([x32.sum(dim=(1, 2)), (x32 * x32).sum(dim=(1, 2))], dim=1)


def spatial_norm_ref(x, vecs, negative_slope=None, out_mul=1):
    """Plain K3': ``x * a + c`` (+ leaky) per output half, vecs
    [B, 2 * out_mul, C]; output [B, H, W, out_mul * C] in x's dtype."""
    x32 = x.float()
    outs = []
    for half in range(out_mul):
        a = vecs[:, 2 * half][:, None, None, :]
        c = vecs[:, 2 * half + 1][:, None, None, :]
        y = x32 * a + c
        if negative_slope is not None:
            y = torch.where(y >= 0, y, y * negative_slope)
        outs.append(y)
    return torch.cat(outs, dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# the plan: which route a shape takes, and how a cluster cuts its plane
# --------------------------------------------------------------------------

#: dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
#: channels per cluster come in whole 32-byte sectors of a pixel, so that
#: neighbouring clusters never share a sector ...
GROUP_BYTES = 32
#: ... and two of them where the channel count allows: the card's memory
#: moves 64 bytes at a time, and a cluster that reads 32 of every 128 ran at
#: three quarters of the speed of one that reads 64 (H100 80GB HBM3; PERF.md)
RUN_BYTES = 64
#: blocks per cluster the cluster route may use.  Up to 8 is portable; 16
#: needs the kernel's non-portable attribute (set by the launcher)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: four blocks of at most this much share an SM (228 KB, 1 KB of it taken per
#: block), so that one block's reads overlap another's writes: the plan takes
#: the smallest cluster that gets under it, else the largest cluster that
#: holds the plane at all
_TARGET_SMEM_BYTES = 56 * 1024


class InPlan(NamedTuple):
    """How one K1' / K1'-bwd call runs.  ``route`` "two_pass" leaves the
    other fields 0.  On "cluster": one cluster of ``cluster`` blocks per
    (sample, ``channels`` channels); rank r holds pixels ``shares(h * w)[r]``
    of the plane: ``block_bytes`` of the held tensors, ``smem_bytes`` with
    the fold's scratch, in blocks of ``threads`` threads."""
    route: str
    channels: int = 0
    cluster: int = 0
    block_bytes: int = 0
    threads: int = 0
    smem_bytes: int = 0
    held: str = ""

    def shares(self, hw: int) -> List[Tuple[int, int]]:
        """[p0, p1) flat pixel range of each rank (empty past the plane)."""
        chunk = -(-hw // self.cluster)
        return [(min(hw, r * chunk), min(hw, (r + 1) * chunk)) for r in range(self.cluster)]


TWO_PASS = InPlan("two_pass")


def _cluster_shape(hw, channels, cluster, itemsize, held) -> InPlan:
    chunk = -(-hw // cluster)
    block_bytes = chunk * channels * itemsize * len(held)
    lanes = channels * itemsize // 16        # 16-byte vectors per pixel
    cap = 1024 if block_bytes > SMEM_LIMIT // 2 else 512 if block_bytes > SMEM_LIMIT // 4 else 256
    threads = min(cap, max(64, 32 * -(-chunk * lanes // 128)))  # ~4 vectors per thread
    while True:  # fewer warps, less scratch, where the share leaves little room
        smem = block_bytes + (threads // 32 + 2) * 2 * channels * 4
        if smem <= SMEM_LIMIT or threads <= 128:
            return InPlan("cluster", channels, cluster, block_bytes, threads, smem, held)
        threads //= 2


def in_plan(h, w, c, itemsize, halves=1, held="x", aligned=True, cluster=None,
            channels=None) -> InPlan:
    """The route of K1' (``held`` "x": its blocks hold x) or K1'-bwd ("xg":
    they hold x and g) at one shape.

    Pure arithmetic on the shape: ``itemsize`` bytes per value, ``halves`` 2
    for the CReLU mode, ``aligned`` whether every tensor's pointer is a
    multiple of 16.  ``cluster`` / ``channels`` force a cluster size or the
    channels per cluster (a measurement's knobs; a forced shape that cannot
    be held raises)."""
    if held not in ("x", "xg"):
        raise ValueError(f"in_plan: held must be 'x' or 'xg', got {held!r}")
    group = GROUP_BYTES // itemsize
    forced = cluster is not None or channels is not None
    if halves != 1 or c % group != 0 or not aligned or h * w == 0:
        if forced:
            raise ValueError(f"in_plan: the cluster route does not take c={c}, "
                             f"halves={halves}, aligned={aligned}, {h}x{w} pixels")
        return TWO_PASS
    if channels is None:
        run = RUN_BYTES // itemsize
        channels = run if c % run == 0 else group
    lanes = channels * itemsize // 16
    if channels % group != 0 or c % channels != 0 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"in_plan: {channels} channels per cluster: need a multiple of "
                         f"{group} that divides {c}, a power of two of at most 32 "
                         "16-byte vectors")
    sizes = CLUSTER_SIZES if cluster is None else (cluster,)
    shapes = [_cluster_shape(h * w, channels, cs, itemsize, held) for cs in sizes]
    for shape in shapes:
        if shape.smem_bytes <= _TARGET_SMEM_BYTES:
            return shape
    if shapes[-1].smem_bytes <= SMEM_LIMIT:
        return shapes[-1]
    if forced:
        raise ValueError(f"in_plan: a cluster of {sizes[-1]} cannot hold {held} of a "
                         f"{h}x{w}x{channels} plane ({itemsize} bytes per value)")
    return TWO_PASS


def in_bwd_plan(h, w, c, halves=1, aligned=True) -> InPlan:
    """K1'-bwd's route (f32): its clusters hold x and g."""
    return in_plan(h, w, c, 4, halves, "xg", aligned)


def cluster_fold_stats_ref(x, plan: InPlan, eps=1e-5, valid_w=None):
    """Plain emulation of the cluster route's summation order: each rank
    sums its share of the (masked) plane in f32, the shares are folded in
    rank order.  [B, 2, C] f32 (mean, rstd), as the kernel saves them."""
    x32 = x.float()
    b, h, w, c = x32.shape
    if valid_w is None:
        n = float(h * w)
    else:
        x32 = x32 * _column_mask(valid_w, w, x.device)
        n = (h * valid_w).float()[:, None]
    flat = x32.reshape(b, h * w, c)
    s1 = torch.zeros((b, c), dtype=torch.float32, device=x.device)
    s2 = torch.zeros_like(s1)
    for p0, p1 in plan.shares(h * w):
        share = flat[:, p0:p1]
        s1 = s1 + share.sum(dim=1)
        s2 = s2 + (share * share).sum(dim=1)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


# --------------------------------------------------------------------------
# folds between the kernels (a few [B, C] vectors; as in fots)
# --------------------------------------------------------------------------

def crelu_coefficients(stats, scale, bias, groups, hw, eps):
    """Fold K2' sums [B, 2, C] into K3' vectors [B, 4, C] (a+, c+, a-, c-)
    as ``_crelu_half_pallas`` does; also the per-group (mean, rstd)
    [B, 2, Cg] the backward pass needs."""
    b, _, c = stats.shape
    cg = c // groups
    sg = stats.view(b, 2, groups, cg).sum(dim=2)
    n = float(hw * groups)
    mean = sg[:, 0] / n
    var = torch.clamp_min(sg[:, 1] / n - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    sc = scale.float()
    bi = bias.float()
    ap = rstd * sc[None, :cg]
    cp = bi[None, :cg] - mean * ap
    an = -rstd * sc[None, cg:]
    cn = bi[None, cg:] - mean * an
    vecs = torch.stack([v.repeat(1, groups) for v in (ap, cp, an, cn)], dim=1)
    return vecs.contiguous(), torch.stack([mean, rstd], dim=1)


def _crelu_u_params(stats_g, scale, bias, groups):
    """Per u channel (u = cat(x, -x), tiled over groups) stats [B, 2, 2C]
    and scale/bias [2C] for K1'-bwd, from per-group (mean, rstd)."""
    cg = stats_g.shape[-1]
    mean = stats_g[:, 0].repeat(1, groups)
    rstd = stats_g[:, 1].repeat(1, groups)
    stats_u = torch.stack([torch.cat([mean, -mean], 1), torch.cat([rstd, rstd], 1)], 1)

    def tile(v):
        v = v.float()
        return torch.cat([v[:cg].repeat(groups), v[cg:].repeat(groups)])

    return stats_u.contiguous(), tile(scale), tile(bias)


def _fold_param_grads(dsb, halves, groups):
    """Per-sample kernel sums [B, 2, Cu] -> (dscale, dbias) of the
    canonical [halves * Cg] parameters."""
    b, _, cu = dsb.shape
    tot = dsb.sum(dim=0).view(2, halves, groups, cu // (halves * groups)).sum(dim=2)
    return tot[0].reshape(-1), tot[1].reshape(-1)


# --------------------------------------------------------------------------
# CUDA launchers (raw: no autograd; the Functions below call them)
# --------------------------------------------------------------------------

def _typed(name, specs):
    lib = build.load(name)
    if not getattr(lib, "_fots_typed", False):
        for fn, (restype, argtypes) in specs.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        lib._fots_typed = True
    return lib


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    return _typed("instance_norm", {
        "fots_instance_norm": (_i, [_p, _p, _i, _i, _i, _i, _i, _p, _p, _p, _f, _f, _i,
                                    _p, _p, _p, _p, _i, _p]),
        "fots_instance_norm_cluster": (_i, [_p, _p, _i, _i, _i, _i, _i, _p, _p, _p, _f, _f,
                                            _i, _p, _i, _i, _i, _i, _p]),
        "fots_instance_norm_rows": (_i, [_i, _i])})


def _bwd_lib():
    return _typed("instance_norm_bwd", {
        "fots_instance_norm_bwd": (_i, [_p, _p, _p, _i, _i, _i, _i, _i, _i, _p, _p, _p, _p,
                                        _f, _i, _p, _p, _p, _p, _i, _p]),
        "fots_instance_norm_bwd_cluster": (_i, [_p, _p, _p, _i, _i, _i, _i, _p, _p, _p, _p,
                                                _f, _i, _p, _i, _i, _i, _i, _p]),
        "fots_instance_norm_bwd_rows": (_i, [_i])})


def _spatial_lib():
    return _typed("spatial_norm", {
        "fots_spatial_stats": (_i, [_p, _p, _i, _i, _i, _i, _i, _p, _p, _i, _p]),
        "fots_spatial_norm": (_i, [_p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _i, _p]),
        "fots_spatial_stats_rows": (_i, [_i, _i])})


def _chunks(dev, b, npix, rows):
    """Pixel chunks per sample for a reduction pass: enough blocks to fill
    the card, at least ~4 pixels per thread."""
    s = -(-_STATS_BLOCKS_PER_SM * build.num_sms(dev) // b)
    return max(1, min(s, -(-npix // (rows * 4))))


#: the C entries' code for a cluster the card cannot schedule
_CLUSTER_UNSCHEDULABLE = -2


def _check(rc, what, plan: Optional[InPlan] = None):
    if rc == _CLUSTER_UNSCHEDULABLE:
        raise RuntimeError(f"{what}: this card cannot schedule a cluster of {plan.cluster} "
                           f"blocks with {plan.smem_bytes} bytes of shared memory each")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _count(kernel, plan: InPlan):
    build.launch_counts[kernel] += 1
    build.route_counts[f"{kernel}/{plan.route}"] += 1


def _vec(v, n, dev, what):
    v = v.to(device=dev, dtype=torch.float32).contiguous()
    if v.shape != (n,):
        raise ValueError(f"{what}: expected a [{n}] vector, got {tuple(v.shape)}")
    return v


def _valid_w_arg(valid_w, b, dev, what):
    if valid_w is None:
        return None, None
    valid_w = valid_w.to(device=dev, dtype=torch.int32).contiguous()
    if valid_w.shape != (b,):
        raise ValueError(f"{what}: valid_w must be [{b}], got {tuple(valid_w.shape)}")
    return valid_w, valid_w.data_ptr()


def instance_norm_cuda(x, scale, bias, eps=1e-5, negative_slope=None,
                       valid_w=None, with_stats=False, plan: Optional[InPlan] = None):
    """Launch K1' on NHWC ``x`` (f32 or bf16, contiguous).  scale/bias:
    [C] (cast to f32); valid_w: optional [B] int.  ``with_stats`` also
    returns the [B, 2, C] (mean, rstd) the backward pass reads.  ``plan``
    (default: :func:`in_plan` of the shape) picks the route."""
    build.check_kernel_input(x, "instance_norm", _DTYPE_CODES)
    b, h, w, c = x.shape
    dev = x.device
    scale = _vec(scale, c, dev, "instance_norm scale")
    bias = _vec(bias, c, dev, "instance_norm bias")
    valid_w, vw_ptr = _valid_w_arg(valid_w, b, dev, "instance_norm")
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    y = torch.empty_like(x)
    stats = (torch.empty((b, 2, c), dtype=torch.float32, device=dev)
             if with_stats else None)
    if plan is None:
        plan = in_plan(h, w, c, x.element_size(), aligned=_aligned(x, y))
    head = (x.data_ptr(), y.data_ptr(), code, b, h, w, c, vw_ptr, scale.data_ptr(),
            bias.data_ptr(), float(eps),
            0.0 if negative_slope is None else float(negative_slope),
            0 if negative_slope is None else 1)
    stats_ptr = None if stats is None else stats.data_ptr()
    if plan.route == "cluster":
        rc = lib.fots_instance_norm_cluster(
            *head, stats_ptr, plan.channels, plan.cluster, plan.threads, plan.smem_bytes,
            build.current_stream_handle(dev))
    else:
        s = _chunks(dev, b, h * w, lib.fots_instance_norm_rows(code, c))
        partial = torch.empty((b, s, 2, c), dtype=torch.float32, device=dev)
        coef = torch.empty((b, 2, c), dtype=torch.float32, device=dev)
        counter = torch.zeros((b,), dtype=torch.int32, device=dev)
        rc = lib.fots_instance_norm(
            *head, partial.data_ptr(), coef.data_ptr(), stats_ptr, counter.data_ptr(), s,
            build.current_stream_handle(dev))
    _check(rc, "instance_norm", plan)
    _count("instance_norm", plan)
    return (y, stats) if with_stats else y


def instance_norm_bwd_cuda(x, g, stats, scale, bias, negative_slope=None,
                           valid_w=None, halves=1, groups=1, plan: Optional[InPlan] = None):
    """Launch K1'-bwd (f32).  Same interface as :func:`instance_norm_bwd_ref`;
    returns (dx, dsb).  ``plan`` (default: :func:`in_bwd_plan` of the shape)
    picks the route."""
    build.check_kernel_input(x, "instance_norm_bwd", _F32)
    build.check_kernel_input(g, "instance_norm_bwd (cotangent)", _F32)
    b, h, w, c = x.shape
    cu = halves * c
    if g.shape != (b, h, w, cu):
        raise ValueError(f"instance_norm_bwd: cotangent shape {tuple(g.shape)}, "
                         f"expected {(b, h, w, cu)}")
    dev = x.device
    stats = stats.to(device=dev, dtype=torch.float32).contiguous()
    if stats.shape != (b, 2, cu):
        raise ValueError(f"instance_norm_bwd: stats must be [{b}, 2, {cu}], got "
                         f"{tuple(stats.shape)}")
    scale = _vec(scale, cu, dev, "instance_norm_bwd scale")
    bias = _vec(bias, cu, dev, "instance_norm_bwd bias")
    valid_w, vw_ptr = _valid_w_arg(valid_w, b, dev, "instance_norm_bwd")
    lib = _bwd_lib()
    dx = torch.empty_like(x)
    dsb = torch.empty((b, 2, cu), dtype=torch.float32, device=dev)
    if plan is None:
        plan = in_bwd_plan(h, w, c, halves, _aligned(x, g, dx))
    slope = (0.0 if negative_slope is None else float(negative_slope),
             0 if negative_slope is None else 1)
    if plan.route == "cluster":
        if halves != 1 or groups != 1 or plan.held != "xg":
            raise ValueError("instance_norm_bwd: the cluster route holds x and g and has "
                             "no CReLU mode")
        rc = lib.fots_instance_norm_bwd_cluster(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), b, h, w, c, vw_ptr, stats.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), *slope, dsb.data_ptr(), plan.channels,
            plan.cluster, plan.threads, plan.smem_bytes, build.current_stream_handle(dev))
    else:
        s = _chunks(dev, b, h * w, lib.fots_instance_norm_bwd_rows(c))
        partial = torch.empty((b, s, 2, cu), dtype=torch.float32, device=dev)
        coef = torch.empty((b, 3, cu), dtype=torch.float32, device=dev)
        counter = torch.zeros((b,), dtype=torch.int32, device=dev)
        rc = lib.fots_instance_norm_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), b, h, w, c, halves, groups, vw_ptr,
            stats.data_ptr(), scale.data_ptr(), bias.data_ptr(), *slope, partial.data_ptr(),
            coef.data_ptr(), dsb.data_ptr(), counter.data_ptr(), s,
            build.current_stream_handle(dev))
    _check(rc, "instance_norm_bwd", plan)
    _count("instance_norm_bwd", plan)
    return dx, dsb


def spatial_stats_cuda(x):
    """Launch K2' on NHWC ``x`` (f32 or bf16): [B, 2, C] f32 sums."""
    build.check_kernel_input(x, "spatial_stats", _DTYPE_CODES)
    b, h, w, c = x.shape
    dev = x.device
    lib = _spatial_lib()
    code = _DTYPE_CODES[x.dtype]
    s = _chunks(dev, b, h * w, lib.fots_spatial_stats_rows(code, c))
    out = torch.empty((b, 2, c), dtype=torch.float32, device=dev)
    partial = torch.empty((b, s, 2, c), dtype=torch.float32, device=dev)
    counter = torch.zeros((b,), dtype=torch.int32, device=dev)
    _check(lib.fots_spatial_stats(x.data_ptr(), out.data_ptr(), code, b, h, w, c,
                                  partial.data_ptr(), counter.data_ptr(), s,
                                  build.current_stream_handle(dev)), "spatial_stats")
    build.launch_counts["spatial_stats"] += 1
    return out


def spatial_norm_cuda(x, vecs, negative_slope=None, out_mul=1):
    """Launch K3' on NHWC ``x`` with vecs [B, 2 * out_mul, C] f32."""
    build.check_kernel_input(x, "spatial_norm", _DTYPE_CODES)
    b, h, w, c = x.shape
    if out_mul not in (1, 2):
        raise ValueError(f"spatial_norm: out_mul must be 1 or 2, got {out_mul}")
    dev = x.device
    vecs = vecs.to(device=dev, dtype=torch.float32).contiguous()
    if vecs.shape != (b, 2 * out_mul, c):
        raise ValueError(f"spatial_norm: vecs must be [{b}, {2 * out_mul}, {c}], got "
                         f"{tuple(vecs.shape)}")
    y = torch.empty((b, h, w, out_mul * c), dtype=x.dtype, device=dev)
    _check(_spatial_lib().fots_spatial_norm(
        x.data_ptr(), vecs.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype], b, h, w, c,
        out_mul, 0.0 if negative_slope is None else float(negative_slope),
        0 if negative_slope is None else 1, build.current_stream_handle(dev)),
        "spatial_norm")
    build.launch_counts["spatial_norm"] += 1
    return y


# --------------------------------------------------------------------------
# device dispatch and autograd
# --------------------------------------------------------------------------

def _on_card(x) -> bool:
    return x.device.type == "cuda"


def _in_forward(x, scale, bias, eps, slope, valid_w, with_stats):
    if _on_card(x):
        return instance_norm_cuda(x, scale, bias, eps, slope, valid_w, with_stats)
    if valid_w is None:
        y = instance_norm_ref(x, scale, bias, eps, slope)
    else:
        y = masked_instance_norm_ref(x, valid_w, scale, bias, eps, slope)
    return (y, instance_norm_stats_ref(x, eps, valid_w)) if with_stats else y


def _in_backward(x, g, stats, scale, bias, slope, valid_w, halves=1, groups=1):
    fn = instance_norm_bwd_cuda if _on_card(x) else instance_norm_bwd_ref
    return fn(x, g.contiguous(), stats, scale, bias, slope, valid_w, halves, groups)


def _crelu_forward(x, scale, bias, groups, eps, slope):
    """K2' -> fold -> K3' (CReLU mode); returns (y, per-group stats)."""
    stats = spatial_stats_cuda(x) if _on_card(x) else spatial_stats_ref(x)
    vecs, stats_g = crelu_coefficients(stats, scale, bias, groups,
                                       x.shape[1] * x.shape[2], eps)
    norm = spatial_norm_cuda if _on_card(x) else spatial_norm_ref
    return norm(x, vecs, slope, 2), stats_g


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, slope, valid_w):
        y, stats = _in_forward(x, scale, bias, eps, slope, valid_w, True)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.slope, ctx.valid_w = slope, valid_w
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dsb = _in_backward(x, gy, stats, scale, bias, ctx.slope, ctx.valid_w)
        dscale, dbias = _fold_param_grads(dsb, 1, 1)
        return dx, dscale, dbias, None, None, None


class _CReLUInstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, slope):
        y, stats_g = _crelu_forward(x, scale, bias, groups, eps, slope)
        ctx.save_for_backward(x, scale, bias, stats_g)
        ctx.groups, ctx.slope = groups, slope
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale, bias, stats_g = ctx.saved_tensors
        stats_u, scale_u, bias_u = _crelu_u_params(stats_g, scale, bias, ctx.groups)
        dx, dsb = _in_backward(x, gy, stats_u, scale_u, bias_u, ctx.slope, None,
                               2, ctx.groups)
        dscale, dbias = _fold_param_grads(dsb, 2, ctx.groups)
        return dx, dscale, dbias, None, None, None


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def instance_norm(x, scale=None, bias=None, eps=1e-5,
                  negative_slope: Optional[float] = None, valid_w=None):
    """Fused instance norm of NHWC ``x``.  ``scale``/``bias`` None =>
    non-affine (identity affine, as ``fots`` does).  ``valid_w`` [B] =>
    masked statistics and zeroed padding columns.  CUDA tensor => the
    kernels (K1', and K1'-bwd under autograd); CPU tensor => the plain
    versions."""
    c = x.shape[-1]
    if scale is None:
        scale = torch.ones((c,), dtype=torch.float32, device=x.device)
        bias = torch.zeros((c,), dtype=torch.float32, device=x.device)
    if _records_grad(x, scale, bias):
        return _InstanceNorm.apply(x, scale, bias, eps, negative_slope, valid_w)
    return _in_forward(x, scale, bias, eps, negative_slope, valid_w, False)


def crelu_instance_norm(x, scale, bias, groups: int = 1, eps: float = 1e-5,
                        negative_slope: Optional[float] = 0.01):
    """CReLU + IN(affine) + leaky of NHWC ``x`` [B, H, W, C] in the half
    layout ``[+x part | -x part]`` ([B, H, W, 2C]), statistics per original
    channel across ``groups`` (C = groups * Cg; 1 for a plain tensor);
    ``scale``/``bias`` [2 * Cg] are the canonical IN's over concat(x, -x).
    CUDA tensor => K2' + K3' (K1'-bwd under autograd); CPU => plain."""
    c = x.shape[-1]
    if groups < 1 or c % groups != 0:
        raise ValueError(f"crelu_instance_norm: {c} channels do not split into "
                         f"{groups} groups")
    if scale.shape != (2 * c // groups,) or bias.shape != scale.shape:
        raise ValueError(f"crelu_instance_norm: scale/bias must be [{2 * c // groups}], "
                         f"got {tuple(scale.shape)} / {tuple(bias.shape)}")
    if _records_grad(x, scale, bias):
        return _CReLUInstanceNorm.apply(x, scale, bias, groups, eps, negative_slope)
    return _crelu_forward(x, scale, bias, groups, eps, negative_slope)[0]

