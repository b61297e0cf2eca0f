"""RoIRotate: crop rotated boxes from NHWC feature maps into strips.

Port of ``fots/ops/rroi_align.py``.  The sampling rules are the
reference's: roi = [batch_idx, cx, cy, h, w, angle_deg]; each output cell
samples the centre of its source bin, whose corners are rounded half away
from zero and clamped; columns past the aspect-preserving width ``ph*w/h``
and degenerate rois (h <= 0 or w <= 0) are zero; bilinear neighbours obey
the strict ``0 < idx < limit`` rule.

:func:`pack_neighbors` builds the packed source once per batch: on a CUDA
tensor it launches ``fots_torch/csrc/pack_neighbors.cu`` (K4'), on a CPU
tensor it runs :func:`pack_neighbors_ref`.  Under autograd its backward is
K4'-bwd (same source), the gather form of ``_pack_pallas_diff_bwd``, or
:func:`pack_neighbors_bwd_ref` on the CPU.  The crop itself
(:func:`rroi_align_packed`) is plain torch, as it is XLA in ``fots``; its
``index_select`` backward is torch's.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from fots_torch.kernels import build

PI = 3.1415926535  # the reference's literal (kernel.cu:65)

_PACK_DTYPES = (torch.float32, torch.bfloat16)


def _round_half_away(x):
    """C round(): halfway cases away from zero (torch.round is half-to-even)."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


def _sample_centers(rois, pooled_height, pooled_width, spatial_scale, height,
                    width):
    """Bin-centre source coordinates (bin_cx, bin_cy) [N, ph, pw] of every
    cell, plus the validity mask [N, 1, pw] (aspect width, degenerate roi)."""
    cx = rois[:, 1][:, None, None]
    cy = rois[:, 2][:, None, None]
    h = rois[:, 3][:, None, None]
    w = rois[:, 4][:, None, None]
    angle = rois[:, 5][:, None, None] / 180.0 * PI

    roi_ok = (h > 0) & (w > 0)
    h = torch.where(roi_ok, h, 1.0)
    w = torch.where(roi_ok, w, 1.0)

    roi_pw = pooled_height * w / h
    dx = -roi_pw / 2.0
    dy = -pooled_height / 2.0
    sx = w * spatial_scale / roi_pw
    sy = h * spatial_scale / pooled_height
    alpha = torch.cos(angle)
    beta = torch.sin(angle)
    gx = cx * spatial_scale
    gy = cy * spatial_scale

    m00 = alpha * sx
    m01 = beta * sy
    m02 = alpha * sx * dx + beta * sy * dy + gx
    m10 = -beta * sx
    m11 = alpha * sy
    m12 = -beta * sx * dx + alpha * sy * dy + gy

    ph_idx = torch.arange(pooled_height, dtype=rois.dtype,
                          device=rois.device)[None, :, None]
    pw_idx = torch.arange(pooled_width, dtype=rois.dtype,
                          device=rois.device)[None, None, :]

    def corner(pw_off, ph_off):
        px = m00 * (pw_idx + pw_off) + m01 * (ph_idx + ph_off) + m02
        py = m10 * (pw_idx + pw_off) + m11 * (ph_idx + ph_off) + m12
        return px, py

    p0x, p0y = corner(0.0, 0.0)
    p1x, p1y = corner(0.0, 1.0)
    p2x, p2y = corner(1.0, 0.0)
    p3x, p3y = corner(1.0, 1.0)

    mn, mx = torch.minimum, torch.maximum
    left = torch.clamp_min(_round_half_away(mn(mn(p0x, p1x), mn(p2x, p3x))), 0.0)
    right = torch.clamp_max(_round_half_away(mx(mx(p0x, p1x), mx(p2x, p3x))),
                            width - 1.0)
    top = torch.clamp_min(_round_half_away(mn(mn(p0y, p1y), mn(p2y, p3y))), 0.0)
    bottom = torch.clamp_max(_round_half_away(mx(mx(p0y, p1y), mx(p2y, p3y))),
                             height - 1.0)

    bin_cx = (left + right) / 2.0
    bin_cy = (top + bottom) / 2.0
    valid = (pw_idx <= roi_pw) & roi_ok
    return bin_cx, bin_cy, valid


def pack_neighbors_ref(features):
    """Plain version: ``quads[i] = [f[i], f[i+1], f[i+W], f[i+W+1]]`` over
    the flat [B*H*W, C] rows, zeros where the source row is past the map
    (what the TPU kernel writes on every row)."""
    b, h, w, c = features.shape
    n = b * h * w
    flat = features.reshape(n, c)
    padded = torch.cat([flat, flat.new_zeros((w + 1, c))], dim=0)
    return torch.cat([padded[0:n], padded[1:n + 1], padded[w:n + w],
                      padded[w + 1:n + w + 1]], dim=1)


def pack_neighbors_bwd_ref(g, feature_shape):
    """Plain version of K4'-bwd: the cotangent [B, H, W, C] of the map from
    the quads' cotangent ``g`` [B*H*W, 4C]:
    ``df[i] = g[i,0] + g[i-1,1] + g[i-W,2] + g[i-W-1,3]`` (zero below row 0);
    the quads' out-of-map slots read nothing."""
    b, h, w, c = feature_shape
    n = b * h * w
    g = g.reshape(n, 4, c)

    def down(v, k):  # v[i - k], zero-filled
        return torch.cat([v.new_zeros((k, c)), v[:n - k]], dim=0)

    df = g[:, 0] + down(g[:, 1], 1) + down(g[:, 2], w) + down(g[:, 3], w + 1)
    return df.reshape(b, h, w, c)


def _lib():
    lib = build.load("pack_neighbors")
    if not getattr(lib, "_fots_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fots_pack_neighbors.restype = i
        lib.fots_pack_neighbors.argtypes = [p, p, ll, ll, i, i, p]
        lib.fots_pack_neighbors_bwd.restype = i
        lib.fots_pack_neighbors_bwd.argtypes = [p, p, ll, ll, i, i, p]
        lib._fots_typed = True
    return lib


def pack_neighbors_cuda(features):
    """Launch the CUDA pack on a contiguous NHWC map with
    ``C * itemsize % 16 == 0``; returns [B*H*W, 4C]."""
    build.check_kernel_input(features, "pack_neighbors", _PACK_DTYPES)
    b, h, w, c = features.shape
    row_bytes = c * features.element_size()
    if row_bytes % 16 != 0:
        raise ValueError(f"pack_neighbors: C * itemsize = {row_bytes} bytes is "
                         "not a multiple of 16")
    n = b * h * w
    out = torch.empty((n, 4 * c), dtype=features.dtype, device=features.device)
    rc = _lib().fots_pack_neighbors(
        features.data_ptr(), out.data_ptr(), n, w, row_bytes,
        build.num_sms(features.device),
        build.current_stream_handle(features.device))
    if rc != 0:
        raise RuntimeError(f"pack_neighbors kernel launch failed: CUDA error {rc}")
    build.launch_counts["pack_neighbors"] += 1
    return out


def pack_neighbors_bwd_cuda(g, feature_shape):
    """Launch K4'-bwd on the quads' cotangent ``g`` [B*H*W, 4C] (f32,
    contiguous, C % 4 == 0); returns the map's cotangent [B, H, W, C]."""
    build.check_kernel_input(g, "pack_neighbors_bwd", (torch.float32,))
    b, h, w, c = feature_shape
    n = b * h * w
    if g.shape != (n, 4 * c):
        raise ValueError(f"pack_neighbors_bwd: cotangent shape {tuple(g.shape)}, "
                         f"expected {(n, 4 * c)}")
    if c % 4 != 0:
        raise ValueError(f"pack_neighbors_bwd: C = {c} is not a multiple of 4")
    df = torch.empty((b, h, w, c), dtype=g.dtype, device=g.device)
    rc = _lib().fots_pack_neighbors_bwd(
        g.data_ptr(), df.data_ptr(), n, w, c, build.num_sms(g.device),
        build.current_stream_handle(g.device))
    if rc != 0:
        raise RuntimeError(f"pack_neighbors_bwd kernel launch failed: CUDA error {rc}")
    build.launch_counts["pack_neighbors_bwd"] += 1
    return df


class _PackNeighbors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features):
        ctx.shape = tuple(features.shape)
        if features.device.type == "cuda":
            return pack_neighbors_cuda(features)
        return pack_neighbors_ref(features)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.device.type == "cuda":
            return pack_neighbors_bwd_cuda(g, ctx.shape)
        return pack_neighbors_bwd_ref(g, ctx.shape)


def pack_neighbors(features):
    """Pack every 2x2 bilinear-neighbour tile of NHWC ``features`` into one
    4C row (see ``fots.ops.rroi_align.pack_neighbors``).  CUDA tensor =>
    the kernel (K4'-bwd for its gradient); CPU tensor => the plain
    versions."""
    if torch.is_grad_enabled() and features.requires_grad:
        return _PackNeighbors.apply(features)
    if features.device.type == "cuda":
        return pack_neighbors_cuda(features)
    return pack_neighbors_ref(features)


def rroi_align_packed(quads, feature_shape, rois, pooled_height: int,
                      pooled_width: int, spatial_scale: float = 1.0):
    """RoIRotate over a map packed by :func:`pack_neighbors`.

    quads [B*H*W, 4C]; feature_shape the original (B, H, W, C); rois
    [N, 6].  Returns [N, pooled_height, pooled_width, C] in quads' dtype."""
    _, height, width, channels = feature_shape
    rois = rois.float()  # pixel coordinates stay f32 for bf16 features
    bin_cx, bin_cy, valid = _sample_centers(rois, pooled_height, pooled_width,
                                            spatial_scale, height, width)
    bidx = rois[:, 0].to(torch.int64)[:, None, None]

    x0 = torch.floor(bin_cx)
    y0 = torch.floor(bin_cy)
    rx = bin_cx - x0
    ry = bin_cy - y0
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    xs = torch.clamp(xi, 0, width - 2)
    ys = torch.clamp(yi, 0, height - 2)

    def tile_weights(orig, start, frac, lim):
        """Neighbour j (at orig + j) lands at tile slot j + (orig - start);
        the strict ``0 < idx < lim`` rule zeroes out-of-tile neighbours."""
        d = orig - start
        ok0 = ((orig > 0) & (orig < lim)).float()
        ok1 = ((orig + 1 > 0) & (orig + 1 < lim)).float()
        w0 = (1.0 - frac) * ok0
        w1 = frac * ok1
        zero = torch.zeros((), dtype=frac.dtype, device=frac.device)
        t0 = torch.where(d == 0, w0, zero) + torch.where(d == -1, w1, zero)
        t1 = torch.where(d == 1, w0, zero) + torch.where(d == 0, w1, zero)
        return t0, t1

    wx0, wx1 = tile_weights(xi, xs, rx, width)
    wy0, wy1 = tile_weights(yi, ys, ry, height)

    idx = (bidx * height + ys) * width + xs
    g = quads.index_select(0, idx.reshape(-1)).reshape(
        idx.shape + (2, 2, channels))
    wdt = quads.dtype
    out = (g[..., 0, 0, :] * (wy0 * wx0)[..., None].to(wdt)
           + g[..., 0, 1, :] * (wy0 * wx1)[..., None].to(wdt)
           + g[..., 1, 0, :] * (wy1 * wx0)[..., None].to(wdt)
           + g[..., 1, 1, :] * (wy1 * wx1)[..., None].to(wdt))
    return out * valid[..., None].to(wdt)


def rroi_align(features, rois, pooled_height: int, pooled_width: int,
               spatial_scale: float = 1.0):
    """Crop + rotate + scale rois out of NHWC ``features`` [B, H, W, C];
    returns [N, pooled_height, pooled_width, C] strips."""
    return rroi_align_packed(pack_neighbors(features), tuple(features.shape),
                             rois, pooled_height, pooled_width, spatial_scale)


def pooled_width_for(rois, pooled_height: int) -> int:
    """Max aspect-preserving width, ceil'd (host helper)."""
    r = np.asarray(rois)
    ratio = (r[:, 4] / r[:, 3]).max()
    return int(math.ceil(pooled_height * float(ratio)))


def width_bucket(width: int, buckets=(32, 64, 96, 128, 160, 192, 256, 320, 416,
                                      512)) -> int:
    """Snap a pooled width up to a bucket of the grid (the last one caps)."""
    for b in buckets:
        if width <= b:
            return b
    return buckets[-1]
