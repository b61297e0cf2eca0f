"""fots_torch.ops.fused_block (K5's port) against fots.ops.fused_block.

The same numpy inputs go through the port's plain version (what its wrapper
runs on a CPU tensor, what ``chip_smoke.py`` holds the CUDA kernel against on
the card, and what the backward differentiates) and through ``fots``: its
XLA reference and its Pallas kernel in interpret mode, at the cases of
``tests/test_fused_block.py`` with its tolerances.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fots.ops.fused_block import (_conv_in_act_pallas,
                                  conv_in_act_reference as jax_reference,
                                  fused_conv3x3_in_act as jax_fused)
from fots_torch.kernels import build
from fots_torch.ops import fused_block as fb


def _data(n=2, h=32, w=48, c=64, seed=0):
    """The inputs of tests/test_fused_block.py, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    g = (rng.standard_normal(c) * 0.3 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    r = rng.standard_normal((n, h, w, c)).astype(np.float32)
    return x, wk, g, b, r


def _torch(arrays, dtype=torch.float32):
    x, wk, g, b, r = (torch.from_numpy(a) for a in arrays)
    return x.to(dtype), wk, g, b, r.to(dtype)


def _jax(arrays, dtype=jnp.float32):
    x, wk, g, b, r = arrays
    return (jnp.asarray(x, dtype), jnp.asarray(wk), jnp.asarray(g), jnp.asarray(b),
            jnp.asarray(r, dtype))


@pytest.mark.parametrize("slope", [None, 0.01])
@pytest.mark.parametrize("with_res", [True, False])
def test_plain_version_matches_fots(slope, with_res):
    arrays = _data()
    x, wk, g, b, r = _torch(arrays)
    jx, jw, jg, jb, jr = _jax(arrays)
    got = fb.fused_conv3x3_in_act(x, wk, g, b, r if with_res else None, 1e-5, slope).numpy()
    ref = jax_reference(jx, jw, jg, jb, jr if with_res else None, negative_slope=slope)
    pal = _conv_in_act_pallas(jx, jw, jg, jb, jr if with_res else None, 1e-5, slope,
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pal), atol=2e-5, rtol=2e-5)


def test_plain_version_matches_fots_multi_row_tiles():
    # H = 40: five 8-row tiles of the TPU kernel, halos at both edges
    arrays = _data(n=1, h=40, w=32, c=64, seed=3)
    x, wk, g, b, r = _torch(arrays)
    jx, jw, jg, jb, jr = _jax(arrays)
    got = fb.conv_in_act_reference(x, wk, g, b, r).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_reference(jx, jw, jg, jb, jr)),
                               atol=2e-5, rtol=2e-5)
    pal = _conv_in_act_pallas(jx, jw, jg, jb, jr, 1e-5, None, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=2e-5, rtol=2e-5)


def test_plain_version_matches_fots_bf16():
    arrays = _data(seed=1)
    x, wk, g, b, r = _torch(arrays, torch.bfloat16)
    jx, jw, jg, jb, jr = _jax(arrays, jnp.bfloat16)
    got = fb.conv_in_act_reference(x, wk, g, b, r)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ref = np.asarray(jax_reference(jx, jw, jg, jb, jr), np.float32)
    pal = np.asarray(_conv_in_act_pallas(jx, jw, jg, jb, jr, 1e-5, None, interpret=True),
                     np.float32)
    np.testing.assert_allclose(got, ref, atol=0.1, rtol=0.1)
    np.testing.assert_allclose(got, pal, atol=0.1, rtol=0.1)


@pytest.mark.parametrize("with_res", [True, False])
def test_gradients_match_fots(with_res):
    """sum(y**2) differentiated through the port's autograd.Function (its
    backward is autograd of the plain version) against jax.grad of fots's
    public entry (whose backward is the XLA composition's)."""
    arrays = _data(n=1, h=16, w=16, c=64, seed=2)
    tens = [t.requires_grad_(True) for t in _torch(arrays)]
    x, wk, g, b, r = tens
    y = fb.fused_conv3x3_in_act(x, wk, g, b, r if with_res else None)
    (y ** 2).sum().backward()
    jx, jw, jg, jb, jr = _jax(arrays)

    def loss(x, wk, g, b, r):
        return jnp.sum(jax_fused(x, wk, g, b, r if with_res else None) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4) if with_res else (0, 1, 2, 3))(
        jx, jw, jg, jb, jr)
    for got, ref in zip(tens, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    if not with_res:
        assert r.grad is None


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x, wk, g, b, r = _torch(_data(n=1, h=8, w=8, c=24))
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="multiple of 16 up to 128"):
        fb.conv_in_act_cuda(x, wk, g, b, r)
    x, wk, g, b, r = _torch(_data(n=1, h=8, w=8, c=64))
    with pytest.raises(ValueError, match=r"w must be \[3, 3, 64, 64\]"):
        fb.conv_in_act_cuda(x, wk[..., :32], g, b, r)
    with pytest.raises(ValueError, match="residual must match x"):
        fb.conv_in_act_cuda(x, wk, g, b, r[:, :4])
    # a CPU tensor never reaches the kernel through the raw launcher
    with pytest.raises(ValueError, match="CUDA tensor"):
        fb.conv_in_act_cuda(x, wk, g, b, r)
    # the launcher's rule for a tensor on the card: contiguous NHWC, no silent
    # copy (a stand-in carries the attributes the check reads; there is no
    # card here)
    strided = x.permute(0, 2, 1, 3)
    on_card = SimpleNamespace(device=SimpleNamespace(type="cuda"), dtype=strided.dtype,
                              is_contiguous=strided.is_contiguous, stride=strided.stride,
                              shape=strided.shape, requires_grad=False)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        build.check_kernel_input(on_card, "fused_block", (torch.float32, torch.bfloat16))
    assert build.launch_counts == before
    assert "fused_block" in build.CUDA_KERNELS
    assert build.PATH_KERNELS["fused_block"] == ("fused_block",)
