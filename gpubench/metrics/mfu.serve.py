"""Percent of the card's dense bf16 peak (989 TFLOP/s): the model FLOPs of
the images served in the traced run's window (the detector's forward and
recognition over the rois it recognised, counted over the plain
reference) over the window's seconds."""

from gpubench.roofline import PEAKS


def read(run):
    if run.kind != "serve" or getattr(run, "model_flops", None) is None:
        return None
    return 100.0 * run.model_flops / run.window_s / PEAKS["bf16_flops_per_s"]
