"""The plain reference of the FOTS detector and its recognition head.

Plain PyTorch in NCHW over a flat weight dict keyed as the published
snapshot is (``params/<path>/<leaf>``, conv kernels HWIO), written from the
reference model (E2E-MLT ``ModelResNetSep2(attention, nclass)``, SURVEY
section 3.1): a CReLU-InstanceNorm stem, four instance-norm residual stages
(two plain, two separable), an FPN merged top-down (each lateral gated by
the sigmoid attention of the coarser merged map when ``attention``), score,
geometry and angle heads at 1/4 and 1/8 scale, and a fully convolutional
CTC head over rotated crops of the stem's 1/4-scale features.

Every convolution goes through :class:`Precision`, which is float32 with
TF32 off (the reference) or one of the lower precisions the controls use.
Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

#: heads kept in float32 by a lower precision (they regress sub-pixel
#: geometry; the configuration states them in f32)
F32_HEADS = ("act", "rbox", "angle", "conv_attention")
EPS = 1e-5
SLOPE = 0.01


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (amax to
    the format's largest value 448), returned in float32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = 448.0 / amax
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """How the reference computes a convolution: ``"f32"`` (float32, TF32
    off by the caller), ``"fp8"`` (inputs and kernels rounded to e4m3 under
    a per-tensor scale, accumulated in f32) or ``"bf16"`` (inputs and
    kernels in bfloat16, accumulated by cuDNN, result in f32).  The heads
    in :data:`F32_HEADS` stay float32 in every mode."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def conv(self, name: str, x, w, b=None, stride=1, padding=0, groups=1):
        if self.mode == "f32" or name.split("/")[0] in F32_HEADS:
            return F.conv2d(x.float(), w, b, stride, padding, 1, groups)
        if self.mode == "fp8":
            return F.conv2d(fake_fp8(x), fake_fp8(w), b, stride, padding, 1, groups)
        y = F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16),
                     None if b is None else b.to(torch.bfloat16), stride, padding, 1, groups)
        return y.float()


def oihw(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The flat dict with every conv kernel turned from HWIO to OIHW (a
    depthwise (3, 3, 1, C) kernel becomes (C, 1, 3, 3))."""
    return {k: (v.permute(3, 2, 0, 1).contiguous() if v.ndim == 4 else v)
            for k, v in params.items()}


def instance_norm(x, scale=None, bias=None, slope=None, valid_w=None):
    """Per-sample, per-channel normalisation over H, W (biased variance,
    eps 1e-5), then the affine and the leaky ReLU (slope 0: ReLU).  With
    ``valid_w`` [N] the statistics cover the first ``valid_w[n]`` columns
    and the output is zero past them."""
    if valid_w is None:
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
        mask = None
    else:
        w = x.shape[3]
        mask = (torch.arange(w, device=x.device)[None, :] < valid_w[:, None].to(x.device))
        mask = mask.to(x.dtype)[:, None, None, :]
        n = (x.shape[2] * valid_w.to(x.device).to(x.dtype))[:, None, None, None]
        mean = (x * mask).sum(dim=(2, 3), keepdim=True) / n
        var = (((x - mean) * mask) ** 2).sum(dim=(2, 3), keepdim=True) / n
    y = (x - mean) / torch.sqrt(var + EPS)
    if scale is not None:
        y = y * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    if slope is not None:
        y = F.leaky_relu(y, slope) if slope > 0 else F.relu(y)
    return y if mask is None else y * mask


def batch_norm(x, p, prefix, train: bool):
    """BatchNorm, eps 1e-5: the batch's biased statistics in training, the
    running ones otherwise (running statistics are not updated here)."""
    scale, bias = p[f"params/{prefix}/bn/scale"], p[f"params/{prefix}/bn/bias"]
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), keepdim=True, unbiased=False)
    else:
        mean = p[f"batch_stats/{prefix}/bn/mean"].view(1, -1, 1, 1)
        var = p[f"batch_stats/{prefix}/bn/var"].view(1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + EPS) * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def resize(x, hw):
    """Bilinear resize with aligned corners (NCHW)."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class Dropouts:
    """Channel dropout (rate 0.2, kept channels times 1/0.8) with each mask's
    uniforms drawn on the CPU from ``generator``, in the order the network
    meets the dropout layers.  ``None``: no dropout (inference)."""

    RATE = 0.2

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def __call__(self, x):
        if self.generator is None:
            return x
        u = torch.rand((x.shape[0], x.shape[1]), generator=self.generator)
        keep = (u < 1.0 - self.RATE).to(x.device)[:, :, None, None]
        return torch.where(keep, x / (1.0 - self.RATE), torch.zeros((), device=x.device))


class Detector:
    """The reference network over a flat OIHW weight dict ``p``.

    ``forward(images)``: images [B, H, W, 3] normalised (x/128 - 1).
    Returns NCHW ``segm`` [B, 1, H/4, W/4], ``rbox`` (4 distances, 0..128),
    ``angle`` (sin, cos), the same at 1/8 scale under ``*2`` keys, and
    ``focr`` [B, 64, H/4, W/4]."""

    def __init__(self, p: Dict[str, torch.Tensor], attention: bool,
                 precision: Optional[Precision] = None, train: bool = False):
        self.p = p
        self.attention = attention
        self.prec = precision or Precision("f32")
        self.train = train

    def conv(self, name, x, stride=1, groups=1, padding=None):
        w = self.p[f"params/{name}/kernel"]
        b = self.p.get(f"params/{name}/bias")
        kh, kw = w.shape[2:]
        pad = ((kh - 1) // 2, (kw - 1) // 2) if padding is None else padding
        return self.prec.conv(name, x, w, b, stride, pad, groups)

    def norm(self, name, x, slope=None, valid_w=None, affine=True):
        if not affine:
            return instance_norm(x, slope=slope, valid_w=valid_w)
        return instance_norm(x, self.p[f"params/{name}/scale"], self.p[f"params/{name}/bias"],
                             slope, valid_w)

    def crelu_in(self, name, x):
        return self.norm(f"{name}/in", torch.cat([x, -x], dim=1), SLOPE)

    def stem(self, x):
        x = self.crelu_in("stem/crelu0a", self.conv("stem/conv0a", x))
        x = self.crelu_in("stem/crelu0b", self.conv("stem/conv0b", x, 2))
        x = F.relu(self.conv("stem/conv1a", x))
        return F.relu(self.conv("stem/conv1b", x, 2))

    def downsample(self, name, x, stride):
        if f"params/{name}/down_conv/kernel" not in self.p:
            return x
        return batch_norm(self.conv(f"{name}/down_conv", x, stride), self.p,
                          f"{name}/down_bn", self.train)

    def basic_block(self, name, x, stride):
        y = self.norm(f"{name}/in1", self.conv(f"{name}/conv1", x, stride), 0.0)
        y = self.norm(f"{name}/in2", self.conv(f"{name}/conv2", y))
        return F.relu(y + self.downsample(name, x, stride))

    def sep_block(self, name, x, stride):
        c_in = x.shape[1]
        y = self.conv(f"{name}/sep1/dw", x, stride, groups=c_in)
        y = self.norm(None, self.conv(f"{name}/sep1/pw", y), SLOPE, affine=False)
        c = y.shape[1]
        y = self.norm(f"{name}/conv2/in1", self.conv(f"{name}/conv2/dw", y, groups=c), SLOPE)
        y = self.norm(f"{name}/conv2/in2", self.conv(f"{name}/conv2/pw", y))
        return F.leaky_relu(y + self.downsample(name, x, stride), SLOPE)

    def dw_pw(self, name, x):
        return self.conv(f"{name}/pw", self.conv(f"{name}/dw", x, groups=x.shape[1]))

    def lateral(self, f, coarser):
        if not self.attention:
            return f
        return f * resize(torch.sigmoid(self.conv("conv_attention", coarser)), f.shape[2:])

    def heads(self, x):
        segm = torch.sigmoid(self.conv("act", x))
        rbox = torch.sigmoid(self.conv("rbox", x)) * 128.0
        angle = torch.sigmoid(self.conv("angle", x)) * 2.0 - 1.0
        angle = angle / torch.sqrt((angle * angle).sum(dim=1, keepdim=True) + 1e-12)
        return segm, rbox, angle

    def forward(self, images, drop: Optional[Dropouts] = None):
        drop = drop or Dropouts(None)
        x = self.stem(images.permute(0, 3, 1, 2).float())
        focr = x
        x = drop(x)
        stages = (("layer1", 3, self.basic_block, 1), ("layer2", 4, self.basic_block, 2),
                  ("layer3", 6, self.sep_block, 2), ("layer4", 4, self.sep_block, 2))
        feats = []
        for stage, n, block, stride in stages:
            for i in range(n):
                x = block(f"{stage}_{i}", x, stride if i == 0 else 1)
            if stage == "layer4":
                x = drop(x)
            feats.append(self.conv(f"feature{len(feats) + 1}", x))
        f1, f2, f3, f4 = feats
        x = resize(f4, f3.shape[2:]) + self.lateral(f3, f4)
        f2m = self.dw_pw("upconv1", resize(x, f2.shape[2:])) + self.lateral(f2, x)
        x = self.dw_pw("upconv2", resize(f2m, f1.shape[2:])) + self.lateral(f1, f2m)
        segm2, rbox2, angle2 = self.heads(f2m)
        x = drop(x)
        segm, rbox, angle = self.heads(x)
        return {"segm": segm, "rbox": rbox, "angle": angle, "segm2": segm2, "rbox2": rbox2,
                "angle2": angle2, "focr": focr}

    def recognize(self, strips, valid_w=None, drop: Optional[Dropouts] = None):
        """strips [N, 64, 11, W] (NCHW) -> log-probs [N, W, nclass]."""
        drop = drop or Dropouts(None)

        def lrelu(t):
            return F.leaky_relu(t, SLOPE)

        x = self.norm("ocr/batch5", self.conv("ocr/conv5", strips), SLOPE, valid_w)
        x = lrelu(self.conv("ocr/conv6", x))
        x = lrelu(self.conv("ocr/conv6", x))
        x = F.max_pool2d(x, (2, 1), (2, 1))
        x = self.norm("ocr/batch7", self.conv("ocr/conv7", x), SLOPE, valid_w)
        x = lrelu(self.conv("ocr/conv8", x))
        x = lrelu(self.conv("ocr/conv8", x))
        x = lrelu(self.conv("ocr/conv9", x))
        x = lrelu(self.conv("ocr/conv9", x))
        x = F.max_pool2d(x, (2, 1), (2, 1))
        x = self.norm("ocr/batch10_s", self.conv("ocr/conv10_s", x, padding=(0, 1)), SLOPE,
                      valid_w)
        x = drop(x)
        x = self.conv("ocr/conv11", x)
        return F.log_softmax(x[:, :, 0, :].transpose(1, 2), dim=-1)


def param_shapes(nclass: int, attention: bool) -> Dict[str, tuple]:
    """Every leaf of the network and its shape, keyed as the snapshot is
    (conv kernels HWIO), with BatchNorm's running statistics under
    ``batch_stats/``."""
    s: Dict[str, tuple] = {}

    def conv(name, kh, kw, cin, cout, bias=False):
        s[f"params/{name}/kernel"] = (kh, kw, cin, cout)
        if bias:
            s[f"params/{name}/bias"] = (cout,)

    def affine(name, c):
        s[f"params/{name}/scale"] = (c,)
        s[f"params/{name}/bias"] = (c,)

    def bn(name, c):
        affine(f"{name}/bn", c)
        s[f"batch_stats/{name}/bn/mean"] = (c,)
        s[f"batch_stats/{name}/bn/var"] = (c,)

    conv("stem/conv0a", 3, 3, 3, 16)
    affine("stem/crelu0a/in", 32)
    conv("stem/conv0b", 3, 3, 32, 32)
    affine("stem/crelu0b/in", 64)
    conv("stem/conv1a", 3, 3, 64, 64)
    conv("stem/conv1b", 3, 3, 64, 64)
    for stage, n, cin, cout, sep in (("layer1", 3, 64, 64, False), ("layer2", 4, 64, 128, False),
                                     ("layer3", 6, 128, 256, True),
                                     ("layer4", 4, 256, 512, True)):
        for i in range(n):
            name, c0 = f"{stage}_{i}", (cin if i == 0 else cout)
            if sep:
                conv(f"{name}/sep1/dw", 3, 3, 1, c0)
                conv(f"{name}/sep1/pw", 1, 1, c0, cout)
                conv(f"{name}/conv2/dw", 3, 3, 1, cout)
                affine(f"{name}/conv2/in1", cout)
                conv(f"{name}/conv2/pw", 1, 1, cout, cout)
                affine(f"{name}/conv2/in2", cout)
            else:
                conv(f"{name}/conv1", 3, 3, c0, cout)
                affine(f"{name}/in1", cout)
                conv(f"{name}/conv2", 3, 3, cout, cout)
                affine(f"{name}/in2", cout)
            if i == 0 and (stage != "layer1"):
                conv(f"{name}/down_conv", 1, 1, c0, cout)
                bn(f"{name}/down_bn", cout)
    for i, c in enumerate((64, 128, 256, 512), 1):
        conv(f"feature{i}", 1, 1, c, 256)
    for name in ("upconv1", "upconv2"):
        conv(f"{name}/dw", 3, 3, 1, 256)
        conv(f"{name}/pw", 1, 1, 256, 256)
    if attention:
        conv("conv_attention", 1, 1, 256, 1, bias=True)
    conv("act", 1, 1, 256, 1, bias=True)
    conv("rbox", 1, 1, 256, 4, bias=True)
    conv("angle", 1, 1, 256, 2, bias=True)
    conv("ocr/conv5", 3, 3, 64, 128)
    affine("ocr/batch5", 128)
    conv("ocr/conv6", 3, 3, 128, 128)
    conv("ocr/conv7", 3, 3, 128, 256)
    affine("ocr/batch7", 256)
    conv("ocr/conv8", 3, 3, 256, 256)
    conv("ocr/conv9", 3, 3, 256, 256)
    conv("ocr/conv10_s", 2, 3, 256, 256)
    affine("ocr/batch10_s", 256)
    conv("ocr/conv11", 1, 1, 256, nclass, bias=True)
    return s
