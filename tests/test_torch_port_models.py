"""fots_torch layers and weight loader against fots (CPU).

The same weights go into both: every leaf of a flax module's tree is
replaced with numpy random values and loaded into the port's module
through fots_torch.checkpoint.  Layers agree within 1e-5 relative (f32;
the only difference is summation order).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fots.models.layers as jl
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector
from fots_torch import checkpoint as tck
from fots_torch.models import FOTSDetector
from fots_torch.models import layers as tl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")


def _flatten(variables):
    """Flat ``group/path/leaf`` dict, as fots.checkpoint.save_serving_params
    writes it."""
    flat = {}
    for group in ("params", "batch_stats"):
        if group not in variables:
            continue
        for keypath, leaf in jax.tree_util.tree_flatten_with_path(variables[group])[0]:
            key = group + "/" + "/".join(str(getattr(k, "key", k)) for k in keypath)
            flat[key] = np.asarray(leaf)
    return flat


def _randomized(variables, rng):
    """Replace every leaf with random values (variances positive) so that
    affine, BatchNorm and bias paths all matter; returns (tree, flat)."""
    flat = {}
    out = dict(variables)
    for group in ("params", "batch_stats"):
        if group not in variables:
            continue

        def fn(keypath, leaf, group=group):
            key = group + "/" + "/".join(str(getattr(k, "key", k)) for k in keypath)
            if key.endswith("/var"):
                arr = rng.uniform(0.5, 1.5, leaf.shape)
            else:
                arr = rng.standard_normal(leaf.shape) * 0.5
            flat[key] = arr.astype(np.float32)
            return jnp.asarray(flat[key])

        out[group] = jax.tree_util.tree_map_with_path(fn, variables[group])
    return out, flat


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _run_pair(jax_module, torch_module, x, rng, **apply_kw):
    variables = jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **apply_kw)
    variables, flat = _randomized(variables, rng)
    tck.load_flat(torch_module, flat)
    torch_module.eval().to(memory_format=torch.channels_last)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x), **apply_kw))
    with torch.inference_mode():
        got = torch_module(_nchw(x)).permute(0, 2, 3, 1).numpy()
    return got, want


LAYER_CASES = {
    "instance_norm": (lambda: jl.InstanceNorm(16, fused_slope=0.01),
                      lambda: tl.InstanceNorm(16, fused_slope=0.01), 16, {}),
    "crelu_in": (lambda: jl.CReLUIN(16), lambda: tl.CReLUIN(16), 16, {}),
    "conv_stride2": (lambda: jl.conv(24, (3, 3), 2),
                     lambda: tl.Conv(16, 24, 3, 2), 16, {}),
    "conv_dw_in_stride2": (lambda: jl.ConvDWIn(16, 32, 2),
                           lambda: tl.ConvDWIn(16, 32, 2), 16, {}),
    "conv_dw_res_in": (lambda: jl.ConvDWResIn(16, 32),
                       lambda: tl.ConvDWResIn(16, 32), 16, {}),
    "conv_dw_plain": (lambda: jl.ConvDWPlain(16), lambda: tl.ConvDWPlain(16), 16, {}),
    "basic_block_in": (lambda: jl.BasicBlockIn(16, 16, 1),
                       lambda: tl.BasicBlockIn(16, 16, 1), 16, {"train": False}),
    "basic_block_in_down": (lambda: jl.BasicBlockIn(16, 32, 2),
                            lambda: tl.BasicBlockIn(16, 32, 2), 16, {"train": False}),
    "basic_block_sep_in": (lambda: jl.BasicBlockSepIn(32, 32, 1),
                           lambda: tl.BasicBlockSepIn(32, 32, 1), 32, {"train": False}),
    "basic_block_sep_in_down": (lambda: jl.BasicBlockSepIn(16, 32, 2),
                                lambda: tl.BasicBlockSepIn(16, 32, 2), 16,
                                {"train": False}),
    "batch_norm": (lambda: jl.BatchNorm(16), lambda: tl.BatchNorm(16), 16,
                   {"train": False}),
}


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_flax(name):
    make_jax, make_torch, cin, kw = LAYER_CASES[name]
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, 18, cin)).astype(np.float32)
    got, want = _run_pair(make_jax(), make_torch(), x, rng, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("src,dst", [((6, 10), (12, 20)), ((12, 20), (6, 10)),
                                     ((1, 5), (4, 9)), ((5, 7), (5, 7))])
def test_resize_bilinear_and_max_pool(src, dst):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jl.resize_bilinear(jnp.asarray(x), dst))
    got = tl.resize_bilinear(_nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if src[0] < 2:
        return
    want = np.asarray(jl.max_pool(jnp.asarray(x), (2, 1), (2, 1)))
    got = tl.max_pool(_nchw(x), (2, 1), (2, 1)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_snapshot_keys_all_map_both_ways():
    flat, step, config = tck.load_serving_params(SNAPSHOT)
    assert step == 24500 and config == {"masked_norm": True}
    assert len(flat) == 175  # 177 archive entries less __step__ and __config__
    model = FOTSDetector(nclass=87)
    tck.load_flat(model, flat)  # raises on a missing or unused key
    sd = model.state_dict()
    for key, arr in flat.items():
        want = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
        np.testing.assert_array_equal(sd[tck.torch_key(key)].numpy(), want)
    with pytest.raises(KeyError):
        tck.load_flat(FOTSDetector(nclass=87), {**flat, "params/extra/kernel": flat[
            "params/act/kernel"]})
    short = dict(flat)
    short.pop("params/layer1_0/in1/scale")
    with pytest.raises(KeyError):
        tck.load_flat(FOTSDetector(nclass=87), short)


def test_random_init_tree_round_trips():
    model = JaxDetector(nclass=87)
    flat = _flatten(init_detector(model, jax.random.PRNGKey(3)))
    port = FOTSDetector(nclass=87)
    tck.load_flat(port, flat)
    sd = port.state_dict()
    assert len(sd) == len(flat)
    assert tck.torch_key("params/layer3_0/sep1/dw/kernel") == "layer3.0.sep1.dw.weight"
    assert tck.torch_key("batch_stats/layer2_0/down_bn/bn/var") == \
        "layer2.0.down_bn.running_var"
    assert tck.torch_key("params/stem/crelu0a/in/scale") == "stem.crelu0a.norm.weight"
    assert tuple(sd["layer3.0.sep1.dw.weight"].shape) == (128, 1, 3, 3)
    for key, arr in flat.items():
        want = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
        np.testing.assert_array_equal(sd[tck.torch_key(key)].numpy(), want)
