"""FOTS shared backbone + EAST detection heads + CTC recognition head.

Port of ``fots/models/detector.py``: CReLU-IN stem, four instance-norm
residual stages, FPN top-down merge (attention-gated laterals by default,
plain sums with ``attention=False``, the FOTS paper's merge), 1/4 and 1/8
scale score/geometry/angle heads, and the fully-convolutional CTC
recognition head over RoIRotated 1/4-scale features.

The stem is the canonical formulation (``Stem`` with ``s2d=False`` in
``fots``); the JAX package's space-to-depth execution computes the same
function with a TPU lane-padding layout and is not ported.

Public tensors keep the JAX package's NHWC layout; inside, activations
are NCHW in channels_last memory, which is the same bytes.

``model.train()`` is flax's ``train=True``: BatchNorm on batch statistics
and channel dropout (rate 0.2) where ``fots`` has it, with masks drawn
from the ``generator`` passed to ``forward`` / ``recognize``.  Under a mesh
:func:`fots_torch.parallel.shard_init` replaces ``ocr.conv11`` by a
column-parallel :class:`fots_torch.parallel.mesh.VocabShard` where the
model axis divides ``nclass``, and ``generator`` is a ``RowDraw`` over the
global batch (the detector's images, the recognizer's rois).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fots_torch.models.layers import (BasicBlockIn, BasicBlockSepIn, BatchNorm, Conv,
                                      ConvDWPlain, CReLUIN, Dropout, InstanceNorm,
                                      leaky_relu, max_pool, resize_bilinear)


class Stem(nn.Module):
    """3 -> 64 channels at 1/4 scale; its output is also the shared OCR
    feature ``focr``."""

    def __init__(self):
        super().__init__()
        self.conv0a = Conv(3, 16, 3, 1)
        self.crelu0a = CReLUIN(16)
        self.conv0b = Conv(32, 32, 3, 2)
        self.crelu0b = CReLUIN(32)
        self.conv1a = Conv(64, 64, 3, 1)
        self.conv1b = Conv(64, 64, 3, 2)

    def forward(self, x):
        x = self.crelu0a(self.conv0a(x))
        x = self.crelu0b(self.conv0b(x))
        x = F.relu(self.conv1a(x))
        return F.relu(self.conv1b(x))


class RecognitionHead(nn.Module):
    """Fully-conv CTC head: strips [N, 11, W, 64] (NHWC) -> log-probs
    [N, W, nclass].  conv6/conv8/conv9 are each applied twice with shared
    weights."""

    def __init__(self, nclass: int):
        super().__init__()
        self.conv5 = Conv(64, 128)
        self.batch5 = InstanceNorm(128, affine=True, fused_slope=0.01)
        self.conv6 = Conv(128, 128)
        self.conv7 = Conv(128, 256)
        self.batch7 = InstanceNorm(256, affine=True, fused_slope=0.01)
        self.conv8 = Conv(256, 256)
        self.conv9 = Conv(256, 256)
        # (2, 3) conv, valid in height, padded by 1 in width
        self.conv10_s = Conv(256, 256, (2, 3), padding=(0, 1))
        self.batch10_s = InstanceNorm(256, affine=True, fused_slope=0.01)
        self.drop = Dropout(0.2)
        self.conv11 = Conv(256, nclass, 1, bias=True)

    def forward(self, strips, valid_w=None, generator: Optional[torch.Generator] = None):
        """valid_w [N] (optional): per-strip content widths; every IN then
        takes masked statistics so a roi's features do not depend on the
        bucket width it was batched into.  ``generator``: the dropout
        masks' CPU generator in train mode."""
        x = strips.permute(0, 3, 1, 2)
        x = self.batch5(self.conv5(x), valid_w)
        x = leaky_relu(self.conv6(x))
        x = leaky_relu(self.conv6(x))
        x = max_pool(x, (2, 1), (2, 1))
        x = self.batch7(self.conv7(x), valid_w)
        x = leaky_relu(self.conv8(x))
        x = leaky_relu(self.conv8(x))
        x = leaky_relu(self.conv9(x))
        x = leaky_relu(self.conv9(x))
        x = max_pool(x, (2, 1), (2, 1))
        x = self.batch10_s(self.conv10_s(x), valid_w)
        x = self.drop(x, generator)
        x = self.conv11(x)                       # [N, nclass, 1, W]
        x = x[:, :, 0, :].transpose(1, 2)        # [N, W, nclass]
        return F.log_softmax(x, dim=-1)


class FOTSDetector(nn.Module):
    """Detection + shared features + recognition head.  ``attention``: gate
    each FPN lateral by the sigmoid attention of the coarser merged map
    (``conv_attention`` exists only then); ``multi_scale``: the model's
    training loss also holds the 1/8-scale heads (it changes nothing in the
    forward pass; :class:`fots_torch.train.Trainer` reads it)."""

    def __init__(self, nclass: int = 87, attention: bool = True, multi_scale: bool = True):
        super().__init__()
        self.nclass = nclass
        self.attention = attention
        self.multi_scale = multi_scale
        self.stem = Stem()
        self.layer1 = nn.ModuleList(BasicBlockIn(64, 64, 1) for _ in range(3))
        self.layer2 = nn.ModuleList(
            BasicBlockIn(64 if i == 0 else 128, 128, 2 if i == 0 else 1)
            for i in range(4))
        self.layer3 = nn.ModuleList(
            BasicBlockSepIn(128 if i == 0 else 256, 256, 2 if i == 0 else 1)
            for i in range(6))
        self.layer4 = nn.ModuleList(
            BasicBlockSepIn(256 if i == 0 else 512, 512, 2 if i == 0 else 1)
            for i in range(4))
        self.feature1 = Conv(64, 256, 1)
        self.feature2 = Conv(128, 256, 1)
        self.feature3 = Conv(256, 256, 1)
        self.feature4 = Conv(512, 256, 1)
        self.upconv1 = ConvDWPlain(256)
        self.upconv2 = ConvDWPlain(256)
        if attention:
            self.conv_attention = Conv(256, 1, 1, bias=True)
        self.act = Conv(256, 1, 1, bias=True)
        self.rbox = Conv(256, 4, 1, bias=True)
        self.angle = Conv(256, 2, 1, bias=True)
        self.drop = Dropout(0.2)
        self.ocr = RecognitionHead(nclass)

    def _heads(self, x):
        """The three 1x1 heads as one conv over their concatenated kernels
        (x is read once), in ``promote(x, head params)``: f32 geometry even
        under a bf16 backbone.  Returns NHWC (segm, rbox, angle)."""
        k = torch.cat([self.act.weight, self.rbox.weight, self.angle.weight], 0)
        b = torch.cat([self.act.bias, self.rbox.bias, self.angle.bias], 0)
        dt = torch.promote_types(x.dtype, k.dtype)
        out = F.conv2d(x.to(dt), k.to(dt), b.to(dt)).permute(0, 2, 3, 1)
        segm = torch.sigmoid(out[..., 0:1])
        rbox = torch.sigmoid(out[..., 1:5]) * 128.0
        angle = torch.sigmoid(out[..., 5:7]) * 2.0 - 1.0
        # eps guards the 0/0 at exactly-zero activations
        den = torch.sqrt(torch.sum(angle * angle, dim=-1, keepdim=True) + 1e-12)
        return segm, rbox, angle / den

    def _lateral(self, f, coarser):
        """The lateral ``f`` as the merge adds it: times the attention of the
        ``coarser`` merged map resized to ``f``'s size, or as it is without
        the gate."""
        if not self.attention:
            return f
        return f * resize_bilinear(torch.sigmoid(self.conv_attention(coarser)), f.shape[2:])

    def forward(self, images, generator: Optional[torch.Generator] = None
                ) -> Dict[str, object]:
        """images [B, H, W, 3] normalized (x/128 - 1), NHWC.  Returns
        segm/rbox/angle as [1/4-scale, 1/8-scale] NHWC lists, ``features``
        (final 1/4 merged, 256 ch) and ``focr`` (64 ch, 1/4), both NHWC.
        In train mode dropout follows focr's capture, layer4, and precedes
        the 1/4 heads, as in ``fots``; ``generator`` draws the masks."""
        x = self.stem(images.permute(0, 3, 1, 2))
        focr = x
        x = self.drop(x, generator)
        for blk in self.layer1:
            x = blk(x)
        f1 = self.feature1(x)
        for blk in self.layer2:
            x = blk(x)
        f2 = self.feature2(x)
        for blk in self.layer3:
            x = blk(x)
        f3 = self.feature3(x)
        for blk in self.layer4:
            x = blk(x)
        x = self.drop(x, generator)
        f4 = self.feature4(x)

        x = resize_bilinear(f4, f3.shape[2:]) + self._lateral(f3, f4)
        f2m = self.upconv1(resize_bilinear(x, f2.shape[2:])) + self._lateral(f2, x)
        x = self.upconv2(resize_bilinear(f2m, f1.shape[2:])) + self._lateral(f1, f2m)

        segm2, rbox2, angle2 = self._heads(f2m)
        x = self.drop(x, generator)
        segm, rbox, angle = self._heads(x)
        return {
            "segm": [segm, segm2],
            "rbox": [rbox, rbox2],
            "angle": [angle, angle2],
            "features": x.permute(0, 2, 3, 1),
            "focr": focr.permute(0, 2, 3, 1),
        }

    def forward_features(self, images):
        """Stem only: images [B, H, W, 3] (NHWC, normalized) -> the shared
        OCR features [B, H/4, W/4, 64] (NHWC)."""
        return self.stem(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def recognize(self, strips, valid_w=None,
                  generator: Optional[torch.Generator] = None):
        """CTC head over RoIRotated NHWC strips -> [N, W, nclass] log-probs."""
        return self.ocr(strips, valid_w, generator)


#: std of a standard normal truncated to [-2, 2]: flax's truncated-normal
#: initialisers divide by it so the truncated draw keeps the asked-for std
_TRUNC_STD = 0.87962566103423978


def init_detector(model: FOTSDetector, generator: torch.Generator) -> FOTSDetector:
    """Initialise every parameter from scratch with flax's defaults, as
    ``fots.models.detector.init_detector`` does (in place; returns
    ``model``): conv kernels ``lecun_normal`` (a normal truncated at +-2
    std, with std sqrt(1 / fan_in), fan_in = kh kw in / groups, so a
    depthwise kernel's is kh kw), conv biases zeros, InstanceNorm and
    BatchNorm scales ones and biases zeros, BatchNorm running mean 0 and
    variance 1.  The kernels are drawn on the CPU from ``generator``, module
    by module in the model's order (JAX's threefry draws cannot be matched,
    only their distribution)."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv):
                o, i, kh, kw = module.weight.shape
                std = math.sqrt(1.0 / (kh * kw * i)) / _TRUNC_STD
                w = torch.empty((o, i, kh, kw))
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                module.weight.copy_(w)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (InstanceNorm, BatchNorm)) and module.weight is not None:
                module.weight.fill_(1.0)
                module.bias.zero_()
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
    return model
