"""fots_torch: the PyTorch/CUDA port of FOTS for one NVIDIA H100.

A second package beside the JAX reference ``fots``; it imports torch, numpy
and the standard library, never ``jax`` or any module of ``fots``.  Module
layout mirrors ``fots`` (``fots_torch/models/layers.py`` <->
``fots/models/layers.py``, ...).  Ported so far: batched serving and the
per-image evaluation path (:mod:`fots_torch.pipeline`,
:mod:`fots_torch.evaluate`, :mod:`fots_torch.cli.eval_e2e`), joint training
from scratch or a snapshot with checkpoints and resume
(:mod:`fots_torch.train`, :mod:`fots_torch.cli.train_joint`) over its NumPy
data pipeline (:mod:`fots_torch.data`, :mod:`fots_torch.imgproc`), the
recognition-only stack (:mod:`fots_torch.models.crnn`,
:mod:`fots_torch.models.own`, :mod:`fots_torch.train_ocr`,
:mod:`fots_torch.ocr_eval`, :mod:`fots_torch.data.ocr_crops` and their
CLIs), image files read and written byte for byte as OpenCV does
(:mod:`fots_torch.imageio`; the drawing of :mod:`fots_torch.imgproc`,
:mod:`fots_torch.debug_vis`, :mod:`fots_torch.cli.rroi_demo`), and the fused
residual-block kernel behind its profiling entry
(:mod:`fots_torch.ops.fused_block`, :mod:`fots_torch.profiling`), and the
device mesh (:mod:`fots_torch.parallel`: data-parallel training and serving
over ``torch.distributed``, the vocabulary head split over 'model').  Every TPU kernel of ``fots`` has its
counterpart, hand-written CUDA for ``sm_90a`` under ``fots_torch/csrc/``,
built at first use by :mod:`fots_torch.kernels.build`, each behind a
``torch.autograd.Function`` whose backward is a kernel too where the TPU
kernel's was.

Entry points run on the card: ``device=None`` resolves to ``cuda`` and
raises when CUDA is absent.  ``device="cpu"`` runs every kernel's plain
PyTorch version instead (the tests do this).
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # imported on first use, so that the data modules (whose prefetch
    # workers import numpy only) do not pull in torch through the package
    if name == "resolve_device":
        from fots_torch.device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'fots_torch' has no attribute {name!r}")
