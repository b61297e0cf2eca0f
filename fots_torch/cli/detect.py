"""Engine loading for the port's CLIs.

Counterpart of ``load_engine`` in ``fots/cli/detect.py`` for the ``.npz``
serving snapshots (``artifacts/serving_params.npz``) and the port's own
training checkpoints (a ``step_N`` directory, or a run directory for its
latest).  The drawing CLI over a folder of jpgs is not ported: the port has
no image decoder.
"""

from __future__ import annotations

import json
import os

from fots_torch.checkpoint import detector_from_checkpoint, load_detector
from fots_torch.pipeline import FOTSInference


def load_engine(model_path, segm_thresh=0.5, mixed_precision=False, expand_w_frac=0.0,
                masked_norm=None, beam=0, device=None) -> FOTSInference:
    """A :class:`FOTSInference` around ``model_path``: a serving snapshot
    (``.npz``) or a port checkpoint directory.  ``masked_norm`` None reads
    the config embedded in the snapshot, or the ``train_config.json`` that
    ``fots_torch.cli.train_joint`` writes beside a run's checkpoints.  The
    engine letterboxes on the host, as ``fots``'s CLIs do.  ``device`` None
    is the card (raises without CUDA); ``"cpu"`` runs the kernels' plain
    versions."""
    if model_path and model_path.endswith(".npz") and os.path.isfile(model_path):
        model, step, config = load_detector(model_path, device)
        print(f"loaded serving snapshot {model_path} (step {step})")
        if masked_norm is None:
            masked_norm = config.get("masked_norm", False)
    elif model_path and os.path.isdir(model_path):
        model, step, path = detector_from_checkpoint(model_path, device)
        print(f"restored checkpoint {path} (step {step})")
        if masked_norm is None:
            cfg = os.path.join(os.path.dirname(os.path.abspath(path)), "train_config.json")
            masked_norm = False
            if os.path.exists(cfg):
                with open(cfg) as f:
                    masked_norm = json.load(f).get("masked_norm", False)
    else:
        raise ValueError(f"fots_torch loads .npz serving snapshots (tools/"
                         f"export_serving_params.py writes them) and its own checkpoint "
                         f"directories; got {model_path!r}")
    return FOTSInference(model, segm_thresh=segm_thresh, mixed_precision=mixed_precision,
                         expand_w_frac=expand_w_frac, masked_norm=bool(masked_norm),
                         beam=beam, device=device, device_letterbox=False)
