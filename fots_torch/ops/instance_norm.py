"""Fused instance normalization (+ affine + optional leaky-relu), NHWC.

Port of ``fots/ops/instance_norm.py``.  :func:`instance_norm` is the entry
point: on a CUDA tensor it launches the hand-written kernel
(``fots_torch/csrc/instance_norm.cu``, two passes: statistics, then
normalise), on a CPU tensor it runs the plain version.  The same kernel
serves the masked variant (``valid_w``) of the recognition head.

Layout: ``x`` is ``[B, H, W, C]`` — the JAX package's NHWC — which is a
``permute(0, 2, 3, 1)`` view of a channels_last NCHW activation, so the
modules pass their tensors without a copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fots_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: target stats-pass blocks per SM (the pass reads x once; a few blocks
#: per SM hide load latency)
_STATS_BLOCKS_PER_SM = 4


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


def masked_instance_norm_ref(x, valid_w, scale=None, bias=None, eps=1e-5,
                             negative_slope=None):
    """Plain version of ``masked_instance_norm_jnp``: statistics over
    columns ``< valid_w[n]`` (n = H * valid_w[n] values), output re-zeroed
    past them."""
    x32 = x.float()
    _, h, w, _ = x32.shape
    mask = (torch.arange(w, device=x.device)[None, :] < valid_w[:, None]).float()
    mask = mask[:, None, :, None]
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


def _lib():
    lib = build.load("instance_norm")
    if not getattr(lib, "_fots_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fots_instance_norm.restype = i
        lib.fots_instance_norm.argtypes = [p, p, i, i, i, i, i, p, p, p, f, f, i,
                                           p, p, p, i, p]
        lib.fots_instance_norm_rows.restype = i
        lib.fots_instance_norm_rows.argtypes = [i, i]
        lib._fots_typed = True
    return lib


def instance_norm_cuda(x, scale, bias, eps=1e-5, negative_slope=None,
                       valid_w=None):
    """Launch the CUDA kernel on NHWC ``x`` (f32 or bf16, contiguous).
    ``scale``/``bias``: [C] (cast to f32); ``valid_w``: optional [B] int."""
    build.check_kernel_input(x, "instance_norm", _DTYPE_CODES)
    b, h, w, c = x.shape
    dev = x.device
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"instance_norm: scale/bias must be [{c}], got "
                         f"{tuple(scale.shape)} / {tuple(bias.shape)}")
    vw_ptr = None
    if valid_w is not None:
        valid_w = valid_w.to(device=dev, dtype=torch.int32).contiguous()
        if valid_w.shape != (b,):
            raise ValueError(f"instance_norm: valid_w must be [{b}], got "
                             f"{tuple(valid_w.shape)}")
        vw_ptr = valid_w.data_ptr()
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    rows = lib.fots_instance_norm_rows(code, c)
    # S pixel chunks per sample: enough stats blocks to fill the card, at
    # least ~4 pixels per thread
    s = -(-_STATS_BLOCKS_PER_SM * build.num_sms(dev) // b)
    s = max(1, min(s, -(-h * w // (rows * 4))))
    y = torch.empty_like(x)
    partial = torch.empty((b, s, 2, c), dtype=torch.float32, device=dev)
    coef = torch.empty((b, 2, c), dtype=torch.float32, device=dev)
    counter = torch.zeros((b,), dtype=torch.int32, device=dev)
    rc = lib.fots_instance_norm(
        x.data_ptr(), y.data_ptr(), code, b, h, w, c, vw_ptr, scale.data_ptr(),
        bias.data_ptr(), float(eps),
        0.0 if negative_slope is None else float(negative_slope),
        0 if negative_slope is None else 1, partial.data_ptr(), coef.data_ptr(),
        counter.data_ptr(), s, build.current_stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"instance_norm kernel launch failed: CUDA error {rc}")
    build.launch_counts["instance_norm"] += 1
    return y


def instance_norm(x, scale=None, bias=None, eps=1e-5,
                  negative_slope: Optional[float] = None, valid_w=None):
    """Fused instance norm of NHWC ``x``.  ``scale``/``bias`` None =>
    non-affine (identity affine, as ``fots`` does).  ``valid_w`` [B] =>
    masked statistics and zeroed padding columns.  CUDA tensor => the
    kernel; CPU tensor => the plain version."""
    c = x.shape[-1]
    if scale is None:
        scale = torch.ones((c,), dtype=torch.float32, device=x.device)
        bias = torch.zeros((c,), dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        return instance_norm_cuda(x, scale, bias, eps, negative_slope, valid_w)
    if valid_w is not None:
        return masked_instance_norm_ref(x, valid_w, scale, bias, eps,
                                        negative_slope)
    return instance_norm_ref(x, scale, bias, eps, negative_slope)
