"""fots_torch: the PyTorch/CUDA port of FOTS for one NVIDIA H100.

A second package beside the JAX reference ``fots``; it imports torch, numpy
and the standard library, never ``jax`` or any module of ``fots``.  Module
layout mirrors ``fots`` (``fots_torch/models/layers.py`` <->
``fots/models/layers.py``, ...).  Ported so far: batched serving
(:mod:`fots_torch.pipeline`) and the joint training step
(:mod:`fots_torch.train`).  The TPU kernels on those paths are
hand-written CUDA for ``sm_90a`` under ``fots_torch/csrc/``, built at first
use by :mod:`fots_torch.kernels.build`, each behind a
``torch.autograd.Function`` whose backward is a kernel too.

Entry points run on the card: ``device=None`` resolves to ``cuda`` and
raises when CUDA is absent.  ``device="cpu"`` runs every kernel's plain
PyTorch version instead (the tests do this).
"""

from fots_torch.device import resolve_device

__all__ = ["resolve_device"]
