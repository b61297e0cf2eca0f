"""The FOTS models (PyTorch port of ``fots.models``)."""

from fots_torch.models.crnn import CRNN, BiLSTM
from fots_torch.models.detector import FOTSDetector, RecognitionHead, Stem
from fots_torch.models.own import OwnModel

__all__ = ["BiLSTM", "CRNN", "FOTSDetector", "OwnModel", "RecognitionHead", "Stem"]
