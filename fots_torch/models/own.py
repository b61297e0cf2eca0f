"""OwnModel: the detector with a CRNN recognition branch (PyTorch port of
``fots/models/own.py``).

The shared-backbone :class:`FOTSDetector` plus a :class:`CRNN` over
RoIRotated *image* crops (``ocr_forward``), as the recognition-only
``CRNNE2ETrainer`` trains it.  Parameter names nest as flax's do
(``detector.*``, ``crnn.*``).
"""

from __future__ import annotations

import torch
from torch import nn

from fots_torch.models.crnn import CRNN, init_crnn
from fots_torch.models.detector import FOTSDetector, init_detector


class OwnModel(nn.Module):
    def __init__(self, nclass: int = 87, attention: bool = True, multi_scale: bool = True):
        super().__init__()
        self.attention = attention
        self.multi_scale = multi_scale
        self.detector = FOTSDetector(nclass=nclass, attention=attention,
                                     multi_scale=multi_scale)
        self.crnn = CRNN(nclass=nclass)

    def forward(self, images, generator=None):
        return self.detector(images, generator)

    def ocr_forward(self, crops):
        """CRNN branch over [N, 32, W, 3] RoIRotated image crops (NHWC) ->
        [N, W/4 + 1, nclass] raw scores."""
        return self.crnn(crops)

    def recognize(self, strips, valid_w=None, generator=None):
        return self.detector.recognize(strips, valid_w, generator)


def init_own_model(model: OwnModel, generator: torch.Generator) -> OwnModel:
    """Both branches from scratch with flax's defaults, the detector's draws
    first (as ``fots.models.own.init_own_model`` touches them); in place."""
    init_detector(model.detector, generator)
    init_crnn(model.crnn, generator)
    return model
