"""Engine loading for the port's CLIs.

Counterpart of ``load_engine`` in ``fots/cli/detect.py`` for the ``.npz``
serving snapshots (``artifacts/serving_params.npz``).  The drawing CLI over
a folder of jpgs is not ported: the port has no image decoder.
"""

from __future__ import annotations

import os

from fots_torch.checkpoint import load_detector
from fots_torch.pipeline import FOTSInference


def load_engine(model_path, segm_thresh=0.5, mixed_precision=False, expand_w_frac=0.0,
                masked_norm=None, beam=0, device=None) -> FOTSInference:
    """A :class:`FOTSInference` around the serving snapshot ``model_path``
    (``.npz``).  ``masked_norm`` None reads the config embedded in the
    snapshot.  The engine letterboxes on the host, as ``fots``'s CLIs do.
    ``device`` None is the card (raises without CUDA); ``"cpu"`` runs the
    kernels' plain versions."""
    if not (model_path and model_path.endswith(".npz") and os.path.isfile(model_path)):
        raise ValueError(f"fots_torch loads .npz serving snapshots only "
                         f"(tools/export_serving_params.py writes them); got {model_path!r}")
    model, step, config = load_detector(model_path, device)
    print(f"loaded serving snapshot {model_path} (step {step})")
    if masked_norm is None:
        masked_norm = config.get("masked_norm", False)
    return FOTSInference(model, segm_thresh=segm_thresh, mixed_precision=mixed_precision,
                         expand_w_frac=expand_w_frac, masked_norm=bool(masked_norm),
                         beam=beam, device=device, device_letterbox=False)
