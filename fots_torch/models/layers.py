"""Building-block layers (PyTorch; NCHW tensors in channels_last memory).

Port of ``fots/models/layers.py``.  Module and parameter names follow the
flax tree (``conv1``, ``in1``, ``down_bn``, ...; flax's child ``in`` is
``norm`` here, a Python keyword otherwise) so that
:mod:`fots_torch.checkpoint` maps a snapshot key by key.

Dtype rules are flax's, written out: a conv computes in
``promote_types(input, kernel)`` (an f32 input meets a bf16 kernel in f32),
instance norm computes f32 statistics and returns the input's dtype, and
BatchNorm computes in f32 and returns ``promote(input, scale, bias)``.

Train mode (``module.train()``) is flax's ``train=True``: BatchNorm
normalises with the batch's biased statistics and updates its running
ones, and :class:`Dropout` drops whole channels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from fots_torch.device import to_device_async
from fots_torch.ops.instance_norm import crelu_instance_norm, instance_norm

IntPair = Union[int, Tuple[int, int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def leaky_relu(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


class Conv(nn.Module):
    """2-D conv with torch-symmetric ``(k-1)//2`` padding for EVERY
    stride (XLA's 'SAME' pads (0, 1) for stride 2 on even inputs, which the
    JAX package deliberately avoids) and flax's dtype promotion."""

    def __init__(self, in_features: int, features: int, kernel: IntPair = 3,
                 stride: IntPair = 1, groups: int = 1, bias: bool = False,
                 padding: Optional[Sequence[int]] = None):
        super().__init__()
        kh, kw = _pair(kernel)
        self.stride = _pair(stride)
        self.groups = groups
        self.padding = (((kh - 1) // 2, (kw - 1) // 2) if padding is None
                        else tuple(padding))
        self.weight = nn.Parameter(torch.zeros(features, in_features // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, 1, self.groups)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W with f32 statistics
    (torch InstanceNorm2d(eps=1e-5) semantics), optional affine, optional
    fused leaky (``fused_slope``; 0.0 == ReLU).  ``valid_w`` [N] selects the
    masked, bucket-width-invariant statistics of the recognition head."""

    def __init__(self, features: int, affine: bool = True, eps: float = 1e-5,
                 fused_slope: Optional[float] = None):
        super().__init__()
        self.eps = eps
        self.fused_slope = fused_slope
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None

    def forward(self, x, valid_w=None):
        scale = bias = None
        if self.weight is not None:
            scale, bias = self.weight.float(), self.bias.float()
        y = instance_norm(x.permute(0, 2, 3, 1), scale, bias, self.eps,
                          self.fused_slope, valid_w)
        return y.permute(0, 3, 1, 2)


class CReLUIN(nn.Module):
    """concat(x, -x) -> InstanceNorm(affine) -> leaky(0.01); doubles C.
    Runs as :func:`crelu_instance_norm` (the concat is never built); the
    affine lives in ``norm`` so snapshot keys map as before."""

    def __init__(self, features: int):
        super().__init__()
        self.norm = InstanceNorm(2 * features, affine=True, fused_slope=0.01)

    def forward(self, x):
        y = crelu_instance_norm(x.permute(0, 2, 3, 1), self.norm.weight.float(),
                                self.norm.bias.float(), 1, self.norm.eps,
                                self.norm.fused_slope)
        return y.permute(0, 3, 1, 2)


class BatchNorm(nn.Module):
    """BatchNorm (eps 1e-5) with flax's arithmetic, in f32:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  Eval mode uses the
    running statistics.  Train mode uses the batch's, with the *biased*
    variance ``max(E[x^2] - E[x]^2, 0)`` for both the normalisation and the
    running update ``r = 0.9 r + 0.1 batch`` (``F.batch_norm`` would update
    with the unbiased variance)."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        x32 = x.float()
        if self.training:
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        y = x32 - mean.view(shape)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = y * mul.view(shape) + self.bias.float().view(shape)
        dt = torch.promote_types(torch.promote_types(x.dtype, self.weight.dtype),
                                 self.bias.dtype)
        return y.to(dt)


class Dropout(nn.Module):
    """Channel dropout in train mode, flax's ``nn.Dropout(rate,
    broadcast_dims=(1, 2))`` on NHWC: one keep/drop per (sample, channel),
    kept values scaled by ``1 / (1 - rate)``.  The mask is drawn on the CPU
    from ``generator`` (a CPU ``torch.Generator``; the default one if None)
    and moved to x's device, so a CUDA run and a CPU run drawing from
    equally seeded generators drop the same channels."""

    def __init__(self, rate: float = 0.2):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand((x.shape[0], x.shape[1]), generator=generator)
        mask = to_device_async(u < keep, x.device)[:, :, None, None]
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class ConvDWIn(nn.Module):
    """depthwise 3x3 -> pointwise 1x1 -> InstanceNorm(no affine) -> leaky."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1):
        super().__init__()
        self.dw = Conv(in_features, in_features, 3, stride, groups=in_features)
        self.pw = Conv(in_features, out_features, 1)
        self.norm = InstanceNorm(out_features, affine=False, fused_slope=0.01)

    def forward(self, x):
        return self.norm(self.pw(self.dw(x)))


class ConvDWResIn(nn.Module):
    """dw3x3 -> IN(affine) -> leaky -> pw1x1 -> IN(affine)."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1):
        super().__init__()
        self.dw = Conv(in_features, in_features, 3, stride, groups=in_features)
        self.in1 = InstanceNorm(in_features, affine=True, fused_slope=0.01)
        self.pw = Conv(in_features, out_features, 1)
        self.in2 = InstanceNorm(out_features, affine=True)

    def forward(self, x):
        return self.in2(self.pw(self.in1(self.dw(x))))


class ConvDWPlain(nn.Module):
    """dw3x3 + pw1x1, no norm or activation."""

    def __init__(self, features: int):
        super().__init__()
        self.dw = Conv(features, features, 3, groups=features)
        self.pw = Conv(features, features, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class BasicBlockIn(nn.Module):
    """conv3x3 -> IN -> relu -> conv3x3 -> IN (+skip) -> relu; the skip is a
    1x1 conv + BatchNorm where the shape changes."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, stride)
        self.in1 = InstanceNorm(features, affine=True, fused_slope=0.0)
        self.conv2 = Conv(features, features, 3, 1)
        self.in2 = InstanceNorm(features, affine=True)
        self.down_conv = self.down_bn = None
        if stride != 1 or in_features != features:
            self.down_conv = Conv(in_features, features, 1, stride)
            self.down_bn = BatchNorm(features)

    def forward(self, x):
        y = self.in2(self.conv2(self.in1(self.conv1(x))))
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + residual)


class BasicBlockSepIn(nn.Module):
    """Separable residual block: ConvDWIn -> ConvDWResIn (+skip) -> leaky."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.sep1 = ConvDWIn(in_features, features, stride)
        self.conv2 = ConvDWResIn(features, features, 1)
        self.down_conv = self.down_bn = None
        if stride != 1 or in_features != features:
            self.down_conv = Conv(in_features, features, 1, stride)
            self.down_bn = BatchNorm(features)

    def forward(self, x):
        y = self.conv2(self.sep1(x))
        residual = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return leaky_relu(y + residual)


def resize_bilinear(x, out_hw: Tuple[int, int]):
    """align_corners=True bilinear resize of NCHW ``x``."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def max_pool(x, window: Tuple[int, int], stride: Tuple[int, int]):
    """VALID max pooling of NCHW ``x``."""
    return F.max_pool2d(x, window, stride)
