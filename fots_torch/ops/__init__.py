"""Ops of the serving path: fused InstanceNorm, RoIRotate, NMS."""
