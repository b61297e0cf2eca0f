"""Write a port training checkpoint as a serving snapshot, the counterpart of
``tools/export_serving_params.py``.

Reads the newest ``step_N`` under CKPT_DIR (or CKPT_DIR itself when it is a
``step_N`` directory: weights, BatchNorm statistics and Adam's state) and
writes the params + batch_stats ``.npz`` that ``-model`` of the serving
CLIs and ``fots``'s reader take, with the step as ``__step__`` and the
``train_config.json`` found in CKPT_DIR or beside the checkpoint embedded as
``__config__`` (an empty config, with a warning, when there is none).

Usage:
  python -m fots_torch.cli.export_serving_params CKPT_DIR [OUT_NPZ]
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not 1 <= len(argv) <= 2 or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    from fots_torch.checkpoint import detector_from_checkpoint, save_serving_params

    ckpt_dir = argv[0]
    out = argv[1] if len(argv) > 1 else "artifacts/serving_params.npz"
    model, step, path = detector_from_checkpoint(ckpt_dir, "cpu")
    config = {}
    for d in (ckpt_dir, os.path.dirname(os.path.abspath(path))):
        cfg = os.path.join(d, "train_config.json")
        if os.path.exists(cfg):
            with open(cfg) as f:
                config = json.load(f)
            break
    else:
        # an empty config makes `-model snapshot.npz` serve with
        # masked_norm off, which is wrong for a masked-norm-trained run
        # whose sidecar was moved away
        print("WARNING: no train_config.json found next to the checkpoint; "
              "embedding an EMPTY config (masked_norm etc. will default "
              "off at serve time)", file=sys.stderr)
    save_serving_params(out, model, step=step, config=config)
    print(f"wrote {out} from {path} (step {step}, config {config})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
