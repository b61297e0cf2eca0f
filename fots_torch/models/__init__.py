"""The FOTS model (PyTorch port of ``fots.models``)."""

from fots_torch.models.detector import FOTSDetector, RecognitionHead, Stem

__all__ = ["FOTSDetector", "RecognitionHead", "Stem"]
