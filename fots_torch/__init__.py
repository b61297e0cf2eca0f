"""fots_torch: the PyTorch/CUDA port of FOTS for one NVIDIA H100.

A second package beside the JAX reference ``fots``; it imports torch, numpy
and the standard library, never ``jax`` or any module of ``fots``.  Module
layout mirrors ``fots`` (``fots_torch/models/layers.py`` <->
``fots/models/layers.py``, ...).  Ported so far: batched serving and the
per-image evaluation path (:mod:`fots_torch.pipeline`,
:mod:`fots_torch.evaluate`, :mod:`fots_torch.cli.eval_e2e`), the joint
training step (:mod:`fots_torch.train`) and the fused residual-block kernel
behind its profiling entry (:mod:`fots_torch.ops.fused_block`,
:mod:`fots_torch.profiling`).  Every TPU kernel of ``fots`` has its
counterpart, hand-written CUDA for ``sm_90a`` under ``fots_torch/csrc/``,
built at first use by :mod:`fots_torch.kernels.build`, each behind a
``torch.autograd.Function`` whose backward is a kernel too where the TPU
kernel's was.

Entry points run on the card: ``device=None`` resolves to ``cuda`` and
raises when CUDA is absent.  ``device="cpu"`` runs every kernel's plain
PyTorch version instead (the tests do this).
"""

from fots_torch.device import resolve_device

__all__ = ["resolve_device"]
