"""Serving frames: ``mosaics`` 1280x1920 u8 BGR 2x2 mosaics, each of four
distinct scenes drawn from the seed."""

from gpubench import inputs


def make(traffic: dict, seed: int):
    scenes = inputs.load_scenes()
    rng = inputs.seed_rng(seed, "mosaics")
    return [inputs.mosaic(scenes, rng.choice(len(scenes), 4, replace=False)).pixels
            for _ in range(traffic["mosaics"])]
