"""One dataclass of settings with a preset per workload.

The port's own copy of ``fots/config.py``: the same fields, defaults and
presets (the five workloads of ``BASELINE.json``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass
class Config:
    # model
    nclass: int = 87                  # the ICDAR15 alphabet + the CTC blank
    attention: bool = True
    multi_scale: bool = True

    # training
    train_list: str = "./data/ICDAR2015.txt"
    batch_size: int = 2
    input_size: int = 512
    base_lr: float = 1e-3
    max_iters: int = 300_000
    num_readers: int = 4
    disp_interval: int = 5
    checkpoint_every: int = 10_000
    save_path: str = "backup"
    resume: Optional[str] = None
    import_h5: Optional[str] = None   # warm start from reference weights
    import_skip: Tuple[str, ...] = ("conv11", "rnn")
    seed: int = 0
    use_predicted_rois: bool = True
    ohem: bool = False                # OHEM score loss in place of dice
    geo_type: int = 0                 # 0: edge distances, 1: row/column-scan targets

    # recognition-only training
    ocr_feed_list: str = "sample_train_data/MLT_CROPS/gt.txt"
    ocr_batch_size: int = 8
    norm_height: int = 32

    # inference and evaluation
    model_path: Optional[str] = None
    segm_thresh: float = 0.5
    iou_th1: float = 0.4
    iou_th2: float = 0.2
    test_folder: str = "./data/example_image/"
    output: str = "./out"
    scale_up: bool = False
    eval_text_length: int = 3
    mixed_precision: bool = False     # bf16 backbone and recognizer at inference
    max_candidates: int = 8192        # NMS candidates per image taken on the device

    # mesh
    n_data: Optional[int] = None
    n_model: int = 1


PRESETS = {
    "roirotate_unit": Config(),
    "crnn_crops": Config(ocr_batch_size=8, norm_height=32),
    "detect_only": Config(segm_thresh=0.5),
    "e2e_inference": Config(),
    "joint_train": Config(batch_size=2, input_size=512),
}


def get_config(preset: str = "joint_train", **overrides) -> Config:
    """A copy of ``preset`` (an unknown name gives the defaults) with
    ``overrides`` applied."""
    return replace(PRESETS.get(preset, Config()), **overrides)
