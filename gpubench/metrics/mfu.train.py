"""Percent of the card's dense TF32 peak (495 TFLOP/s; the program trains
in float32 under cuDNN's default TF32): the model FLOPs of a step (forward
and backward, counted over the plain reference) times the steps of the
traced run's window over its seconds."""

from gpubench.roofline import PEAKS


def read(run):
    if run.kind != "train" or getattr(run, "model_flops", None) is None:
        return None
    return 100.0 * run.model_flops * run.steps / run.window_s / PEAKS["tf32_flops_per_s"]
