"""CRNN recognizer: a VGG-style conv trunk and two bidirectional LSTMs
(PyTorch port of ``fots/models/crnn.py``).

Seven convs take a 32-pixel-high crop to height 1; two stacked BiLSTMs give
per-frame class scores.  Input NHWC [B, 32, W, 3], output [B, W/4 + 1,
nclass] raw scores (the CTC applies ``log_softmax``).  The two width-keeping
pools pad one zero column on each side, as ``fots`` does, so the frame count
is ``fots``'s at every width.

Module and parameter names follow the flax tree (``conv0`` .. ``conv6``,
``bn2`` / ``bn4`` / ``bn6``, ``rnn0`` / ``rnn1`` each with an LSTM and an
``embedding``) so that :mod:`fots_torch.checkpoint` maps a tree key by key.
Each BiLSTM is one ``torch.nn.LSTM(bidirectional=True)`` (cuDNN on the
card; ``fots`` computes it with ``lax.scan`` outside any kernel): flax's
``OptimizedLSTMCell`` has the same gates in the same order (i, f, g, o),
input kernels without a bias and recurrent kernels with one, and its
``reverse=True, keep_order=True`` RNN is torch's reverse direction with the
outputs aligned to the input frames.  BatchNorm is
:class:`fots_torch.models.layers.BatchNorm` (flax's momentum and biased
variance).  Train mode (``model.train()``) is flax's ``train=True``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fots_torch.models.layers import BatchNorm, Conv, max_pool


class BiLSTM(nn.Module):
    """Bidirectional LSTM and a linear embedding of the two directions'
    concatenated outputs: [B, T, C] -> [B, T, out].  The LSTM's input biases
    (``bias_ih``) stay zero and frozen: flax's cell has one bias per gate,
    torch's ``bias_hh``, and a second trained copy would move the sum twice
    as fast under Adam."""

    def __init__(self, in_features: int, hidden: int, out: int):
        super().__init__()
        self.lstm = nn.LSTM(in_features, hidden, batch_first=True, bidirectional=True)
        with torch.no_grad():
            for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
                getattr(self.lstm, name).zero_().requires_grad_(False)
        self.embedding = nn.Linear(2 * hidden, out)

    def forward(self, x):
        y, _ = self.lstm(x)
        return self.embedding(y)


def _pad_pool(x):
    """One zero column each side, then the VALID (2, 2) / (2, 1) pool:
    height halves, W -> W + 1 (after a ReLU zeros add no maximum)."""
    return max_pool(F.pad(x, (1, 1)), (2, 2), (2, 1))


class CRNN(nn.Module):
    """Conv trunk + two BiLSTMs; ``nclass`` output scores per frame."""

    def __init__(self, nclass: int = 7500, hidden: int = 256):
        super().__init__()
        self.nclass = nclass
        self.hidden = hidden
        self.conv0 = Conv(3, 64, 3, bias=True)
        self.conv1 = Conv(64, 128, 3, bias=True)
        self.conv2 = Conv(128, 256, 3, bias=True)
        self.bn2 = BatchNorm(256)
        self.conv3 = Conv(256, 256, 3, bias=True)
        self.conv4 = Conv(256, 512, 3, bias=True)
        self.bn4 = BatchNorm(512)
        self.conv5 = Conv(512, 512, 3, bias=True)
        self.conv6 = Conv(512, 512, 2, bias=True, padding=(0, 0))
        self.bn6 = BatchNorm(512)
        self.rnn0 = BiLSTM(512, hidden, hidden)
        self.rnn1 = BiLSTM(hidden, hidden, nclass)

    def forward(self, x):
        """x [B, 32, W, 3] NHWC -> [B, W/4 + 1, nclass] raw scores."""
        x = x.permute(0, 3, 1, 2)
        x = max_pool(F.relu(self.conv0(x)), (2, 2), (2, 2))    # 16 x W/2
        x = max_pool(F.relu(self.conv1(x)), (2, 2), (2, 2))    # 8 x W/4
        x = F.relu(self.bn2(self.conv2(x)))
        x = _pad_pool(F.relu(self.conv3(x)))                   # 4 x W/4 + 1
        x = F.relu(self.bn4(self.conv4(x)))
        x = _pad_pool(F.relu(self.conv5(x)))                   # 2 x W/4 + 2
        x = F.relu(self.bn6(self.conv6(x)))                    # 1 x W/4 + 1
        x = x[:, :, 0, :].transpose(1, 2).contiguous()         # [B, W', 512]
        return self.rnn1(self.rnn0(x))


#: std of a standard normal truncated to [-2, 2] (flax's truncated-normal
#: initialisers divide by it so the truncated draw keeps its std)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(t.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    t.copy_(w)


def init_crnn(model: CRNN, generator: torch.Generator) -> CRNN:
    """Initialise every parameter from scratch with flax's defaults (in
    place; returns ``model``), drawn on the CPU from ``generator`` module by
    module: conv kernels and the embeddings' kernels ``lecun_normal``
    (fan-in kh kw in, or in), the LSTMs' input kernels ``lecun_normal`` and
    their recurrent kernels orthogonal per gate, every bias zero, BatchNorm
    scale 1, bias 0, running mean 0 and variance 1.  JAX's draws cannot be
    matched, only their distribution."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv):
                o, i, kh, kw = module.weight.shape
                _lecun_normal_(module.weight, kh * kw * i, generator)
                module.bias.zero_()
            elif isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, nn.LSTM):
                hidden = module.hidden_size
                for suffix in ("", "_reverse"):
                    w_ih = getattr(module, f"weight_ih_l0{suffix}")
                    w_hh = getattr(module, f"weight_hh_l0{suffix}")
                    for gate in range(4):  # one Dense per gate in flax
                        rows = slice(gate * hidden, (gate + 1) * hidden)
                        _lecun_normal_(w_ih[rows], module.input_size, generator)
                        w = torch.empty((hidden, hidden))
                        nn.init.orthogonal_(w, generator=generator)
                        w_hh[rows].copy_(w)
                    getattr(module, f"bias_ih_l0{suffix}").zero_()
                    getattr(module, f"bias_hh_l0{suffix}").zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
    return model
