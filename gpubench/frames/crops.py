"""Training samples: ``batch`` x ``pool_batches`` cuts of ``crop`` x
``crop`` pixels, each of a scene drawn from the seed at a scale drawn from
``scale``, around a drawn word, with its targets
(:func:`gpubench.inputs.crop_samples`)."""

from gpubench import inputs


def make(traffic: dict, seed: int):
    n = traffic["batch"] * traffic["pool_batches"]
    return inputs.crop_samples(inputs.load_scenes(), inputs.seed_rng(seed, "train"), n,
                               traffic["crop"], tuple(traffic["scale"]))
