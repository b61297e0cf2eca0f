"""Training samples: ``batch`` x ``pool_batches`` whole 640x960 scenes with
their native-size targets, in an order drawn from the seed (every scene
once before any repeats)."""

import numpy as np

from gpubench import inputs


def make(traffic: dict, seed: int):
    scenes = inputs.load_scenes()
    rng = inputs.seed_rng(seed, "train")
    n = traffic["batch"] * traffic["pool_batches"]
    native = [inputs.native_sample(s) for s in scenes]
    order = np.concatenate([rng.permutation(len(scenes)) for _ in range(-(-n // len(scenes)))])
    return [native[i] for i in order[:n]]
