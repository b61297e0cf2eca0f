"""Fused conv3x3 + InstanceNorm + (residual add) + ReLU / leaky, NHWC.

Port of ``fots/ops/fused_block.py``:

    out = act(IN(conv3x3_same(x, w)) * scale + bias [+ residual])

with x, residual, out ``[N, H, W, C]``, w ``[3, 3, C_in, C]`` (HWIO, cast to
x's type before the product), scale / bias ``[C]``; ``negative_slope`` None is
ReLU, else leaky.  Entry points:

- :func:`conv_in_act_reference`: the plain PyTorch version (``F.conv2d`` +
  f32 statistics).  It serves CPU tensors, the tests and the backward, and
  nothing on a CUDA tensor's forward;
- :func:`conv_in_act_cuda`: the raw launcher of K5'
  (``fots_torch/csrc/fused_block.cu``: Hopper's warpgroup product ``wgmma``
  for bf16, plain FMA for f32, the statistics folded in a fixed order);
- :func:`wgmma_weight_image`: the bf16 kernel's weight taps as its shared
  memory holds them (wgmma's K-major layout with the 128-byte swizzle),
  built on the host side of every bf16 launch;
- :func:`fused_conv3x3_in_act`: the differentiable entry, a
  ``torch.autograd.Function``.  Forward: CUDA tensor => the kernel, CPU tensor
  => the plain version.  Backward: autograd of the plain version on the saved
  inputs, as ``fots`` does.

The kernel takes C_in == C, a multiple of 16 up to 128 (16-byte loads and
16-deep tensor-core tiles; one shared-memory tile holds all C channels), and
any H and W.  The TPU kernel's ``C % 128`` and 8-row-tile rules are its
compiler's, not the function's.  Other channel counts raise on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fots_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: channel counts K5' is built for
KERNEL_CHANNELS = tuple(range(16, 129, 16))
#: K elements (input channels) in one 128-byte row of a swizzled weight tap
_B_ROW = 64
_B_INDEX = {}


def _wgmma_b_index(c: int, device) -> torch.Tensor:
    """Source of every element of :func:`wgmma_weight_image`: its flat index
    in ``w.reshape(-1)``, or ``9 * c * c`` (a zero) for the padding."""
    key = (c, str(device))
    if key not in _B_INDEX:
        kp = -(-c // _B_ROW) * _B_ROW
        t, kb, n, j, e = np.meshgrid(np.arange(9), np.arange(kp // _B_ROW), np.arange(c),
                                     np.arange(_B_ROW // 8), np.arange(8), indexing="ij")
        k = kb * _B_ROW + (j ^ (n % 8)) * 8 + e  # 16-byte piece j of row n holds piece j ^ n % 8
        src = np.where(k < c, (t * c + k) * c + n, 9 * c * c)
        _B_INDEX[key] = torch.from_numpy(src.reshape(-1)).to(device)
    return _B_INDEX[key]


def wgmma_weight_image(w):
    """``[3, 3, C, C]`` HWIO -> ``[9 * KP * C]``, KP = C rounded up to 64: the
    nine ``[C_in, C_out]`` taps as the bf16 kernel's shared memory holds
    them, so that it copies each tap as it lies.  A tap is wgmma's canonical
    K-major B layout with the 128-byte swizzle (PTX ISA, "Shared Memory
    Matrix Layout"): blocks of 64 input channels; in a block, one 128-byte
    row per output channel n holding its 64 weights, whose 16-byte piece j
    is stored at piece ``j ^ (n % 8)``.  The padding past C is zero."""
    c = w.shape[-1]
    flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
    return flat[_wgmma_b_index(c, w.device)]


def conv_in_act_reference(x, w, scale, bias, residual=None, eps=1e-5,
                          negative_slope=None):
    """Plain version, the arithmetic of ``fots``'s ``conv_in_act_reference``:
    the conv in x's type, then f32 statistics ``var = max(s2/n - mean^2, 0)``,
    affine, residual and activation in f32, output cast to x's type."""
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(dt).permute(3, 2, 0, 1), padding=1)
    y32 = y.permute(0, 2, 3, 1).float()
    n = y32.shape[1] * y32.shape[2]
    s1 = y32.sum(dim=(1, 2), keepdim=True)
    s2 = (y32 * y32).sum(dim=(1, 2), keepdim=True)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    z = (y32 - mean) * torch.rsqrt(var + eps)
    z = z * scale.float() + bias.float()
    if residual is not None:
        z = z + residual.float()
    if negative_slope is None:
        z = torch.clamp_min(z, 0.0)
    else:
        z = torch.where(z >= 0, z, z * negative_slope)
    return z.to(dt)


def check_conv_in_act_shapes(x, w, scale, bias, residual) -> None:
    """What K5' requires beyond :func:`build.check_kernel_input`; raises on
    the rest (no route to the plain version for a CUDA tensor)."""
    if x.ndim != 4:
        raise ValueError(f"fused_block: x must be [N, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"fused_block: the kernel takes C in {KERNEL_CHANNELS} (a "
                         f"multiple of 16 up to 128), got C = {c}")
    if tuple(w.shape) != (3, 3, c, c):
        raise ValueError(f"fused_block: w must be [3, 3, {c}, {c}] (HWIO, C_in == C), "
                         f"got {tuple(w.shape)}")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"fused_block: scale and bias must be [{c}], got "
                         f"{tuple(scale.shape)} / {tuple(bias.shape)}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"fused_block: residual must match x ({tuple(x.shape)} {x.dtype}), "
                         f"got {tuple(residual.shape)} {residual.dtype}")


def _lib():
    lib = build.load("fused_block")
    if not getattr(lib, "_fots_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fots_conv_in_act.restype = i
        lib.fots_conv_in_act.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p, f, f, i, p, p, p, p]
        lib.fots_conv_in_act_blocks.restype = i
        lib.fots_conv_in_act_blocks.argtypes = [i, i, i]
        lib._fots_typed = True
    return lib


def conv_in_act_cuda(x, w, scale, bias, residual=None, eps=1e-5,
                     negative_slope: Optional[float] = None):
    """Launch K5' on NHWC ``x`` (f32 or bf16, contiguous, on the card).  No
    autograd: differentiable callers go through :func:`fused_conv3x3_in_act`."""
    check_conv_in_act_shapes(x, w, scale, bias, residual)
    build.check_kernel_input(x, "fused_block", _DTYPE_CODES)
    if residual is not None:
        build.check_kernel_input(residual, "fused_block (residual)", (x.dtype,))
    n, h, wd, c = x.shape
    dev = x.device
    w = w.detach().to(device=dev, dtype=x.dtype).contiguous()
    if x.dtype == torch.bfloat16:
        w = wgmma_weight_image(w)
    scale = scale.detach().to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.detach().to(device=dev, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)      # the pre-norm convolution, in x's type
    out = torch.empty_like(x)
    for name, t in (("x", x), ("residual", residual), ("w", w), ("y", y), ("out", out)):
        if t is not None and t.data_ptr() % 16 != 0:
            raise ValueError(f"fused_block: {name} is not 16-byte aligned")
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    nblk = lib.fots_conv_in_act_blocks(code, h, wd)
    partial = torch.empty((n, nblk, 2, c), dtype=torch.float32, device=dev)
    coef = torch.empty((n, 2, c), dtype=torch.float32, device=dev)
    counter = torch.zeros((n,), dtype=torch.int32, device=dev)
    rc = lib.fots_conv_in_act(
        x.data_ptr(), w.data_ptr(), None if residual is None else residual.data_ptr(),
        y.data_ptr(), out.data_ptr(), code, n, h, wd, c, scale.data_ptr(), bias.data_ptr(),
        float(eps), 0.0 if negative_slope is None else float(negative_slope),
        0 if negative_slope is None else 1, partial.data_ptr(), coef.data_ptr(),
        counter.data_ptr(), build.current_stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"fused_block kernel launch failed: CUDA error {rc}")
    build.launch_counts["fused_block"] += 1
    return out


class _FusedConvInAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, bias, residual, eps, negative_slope):
        ctx.save_for_backward(x, w, scale, bias, residual)
        ctx.eps, ctx.slope = eps, negative_slope
        if x.device.type == "cuda":
            return conv_in_act_cuda(x.detach(), w, scale, bias,
                                    None if residual is None else residual.detach(),
                                    eps, negative_slope)
        return conv_in_act_reference(x, w, scale, bias, residual, eps, negative_slope)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        has_res = saved[4] is not None
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in saved[:4 + has_res]]
            out = conv_in_act_reference(*ins[:4], ins[4] if has_res else None,
                                        ctx.eps, ctx.slope)
            wanted = [i for i in range(len(ins)) if ctx.needs_input_grad[i]]
            grads = torch.autograd.grad(out, [ins[i] for i in wanted], g)
        full = [None] * 7
        for i, gr in zip(wanted, grads):
            full[i] = gr
        return tuple(full)


def fused_conv3x3_in_act(x, w, scale, bias, residual, eps=1e-5,
                         negative_slope: Optional[float] = None):
    """``act(IN(conv3x3_same(x, w)) * scale + bias [+ residual])``.  CUDA tensor
    => K5' (raises on what the kernel does not take); CPU tensor => the plain
    version.  Differentiable in x, w, scale, bias and residual: the backward is
    autograd of the plain version on the saved inputs."""
    return _FusedConvInAct.apply(x, w, scale, bias, residual, eps, negative_slope)
