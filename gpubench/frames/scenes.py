"""Serving frames: the 20 committed 640x960 scenes, u8 BGR."""

from gpubench import inputs


def make(traffic: dict, seed: int):
    return [s.pixels for s in inputs.load_scenes()]
