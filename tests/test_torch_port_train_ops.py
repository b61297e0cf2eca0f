"""fots_torch training-path ops and layers against fots (CPU, plain versions).

The same numpy inputs go through the JAX function and its port.
Tolerances, f32: values within 1e-5 (relative and absolute; the two
frameworks sum in different orders); gradients within
``1e-4 * max|g_jax| + 1e-6`` per tensor; bf16 outputs within one bf16 ulp
(relative 2^-7); the pack's backward bit-exact.
"""

import importlib

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from fots_torch.models import layers as tl
from fots_torch.ops import instance_norm as tin
from fots_torch.ops import rroi_align as trr

jin = importlib.import_module("fots.ops.instance_norm")
jrr = importlib.import_module("fots.ops.rroi_align")

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.tensor(np.array(a), requires_grad=grad)


def assert_grad_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-4 * float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) <= tol, (np.abs(got - want).max(), tol)


def _in_inputs(rng, shape, affine):
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    c = shape[-1]
    scale = rng.standard_normal(c).astype(np.float32) if affine else np.ones(c, np.float32)
    bias = rng.standard_normal(c).astype(np.float32) if affine else np.zeros(c, np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("affine,slope", [(True, None), (True, 0.01), (False, 0.0),
                                          (True, 0.0)])
def test_instance_norm_backward_matches_jax_vjp(masked, affine, slope):
    """The autograd Function (plain K1 forward + plain K1'-bwd) vs jax.vjp of
    instance_norm_jnp / masked_instance_norm_jnp."""
    rng = np.random.default_rng(20)
    x, scale, bias, g = _in_inputs(rng, (3, 5, 12, 8), affine)
    valid_w = np.array([12, 4, 1], np.int32)
    if masked:
        fn = lambda x, s, b: jin.masked_instance_norm_jnp(  # noqa: E731
            x, jnp.asarray(valid_w), s, b, 1e-5, slope)
    else:
        fn = lambda x, s, b: jin.instance_norm_jnp(x, s, b, 1e-5, slope)  # noqa: E731
    want_y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))

    xt, st, bt = _t(x, True), _t(scale, True), _t(bias, True)
    y = tin.instance_norm(xt, st, bt, 1e-5, slope, _t(valid_w) if masked else None)
    got = torch.autograd.grad(y, (xt, st, bt), _t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **F32_TOL)
    for gg, ww in zip(got, want):
        assert_grad_close(gg.numpy(), ww)


def test_instance_norm_bwd_ref_is_the_kernel_interface():
    """instance_norm_bwd_ref's (dx, per-sample sums) fold to jax's (dx,
    dscale, dbias) with the saved statistics of the forward."""
    rng = np.random.default_rng(21)
    x, scale, bias, g = _in_inputs(rng, (2, 6, 7, 5), True)
    _, vjp = jax.vjp(lambda x, s, b: jin.instance_norm_jnp(x, s, b, 1e-5, 0.01),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    stats = tin.instance_norm_stats_ref(_t(x))
    dx, dsb = tin.instance_norm_bwd_ref(_t(x), _t(g), stats, _t(scale), _t(bias), 0.01)
    assert dsb.shape == (2, 2, 5)
    dscale, dbias = tin._fold_param_grads(dsb, 1, 1)
    for gg, ww in zip((dx, dscale, dbias), want):
        assert_grad_close(gg.numpy(), ww)


def _crelu_inputs(rng, shape, groups):
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    cg = shape[-1] // groups
    scale = rng.standard_normal(2 * cg).astype(np.float32)
    bias = rng.standard_normal(2 * cg).astype(np.float32)
    g = rng.standard_normal(shape[:-1] + (2 * shape[-1],)).astype(np.float32)
    return x, scale, bias, g


@pytest.mark.parametrize("groups", [1, 4])
def test_crelu_instance_norm_matches_pallas_interpret_and_jnp(groups):
    """crelu_instance_norm (plain K2 + fold + plain K3) and
    crelu_instance_norm_ref vs the Pallas two-pass CReLU-IN in interpret
    mode and its jnp reference."""
    rng = np.random.default_rng(22)
    x, scale, bias, _ = _crelu_inputs(rng, (2, 8, 16, 32), groups)
    xj, sj, bj = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    want_pallas = np.asarray(jin.crelu_instance_norm_half(xj, sj, bj, groups, interpret=True))
    want_jnp = np.asarray(jin._crelu_half_jnp(xj, sj, bj, groups, 1e-5, 0.01))
    got = tin.crelu_instance_norm(_t(x), _t(scale), _t(bias), groups).numpy()
    ref = tin.crelu_instance_norm_ref(_t(x), _t(scale), _t(bias), groups).numpy()
    for out in (got, ref):
        assert out.shape == (2, 8, 16, 64)
        np.testing.assert_allclose(out, want_pallas, **F32_TOL)
        np.testing.assert_allclose(out, want_jnp, **F32_TOL)


@pytest.mark.parametrize("groups", [1, 4])
def test_crelu_instance_norm_gradient_matches_jax(groups):
    """The CReLU-IN Function's backward (plain K1'-bwd in its CReLU mode)
    and autograd of crelu_instance_norm_ref vs jax.vjp of _crelu_half_jnp."""
    rng = np.random.default_rng(23)
    x, scale, bias, g = _crelu_inputs(rng, (2, 6, 10, 8), groups)
    _, vjp = jax.vjp(lambda x, s, b: jin._crelu_half_jnp(x, s, b, groups, 1e-5, 0.01),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    for fn in (tin.crelu_instance_norm, tin.crelu_instance_norm_ref):
        xt, st, bt = _t(x, True), _t(scale, True), _t(bias, True)
        y = fn(xt, st, bt, groups)
        got = torch.autograd.grad(y, (xt, st, bt), _t(g))
        for gg, ww in zip(got, want):
            assert_grad_close(gg.numpy(), ww)


def test_crelu_instance_norm_bf16_within_one_ulp():
    rng = np.random.default_rng(24)
    x, scale, bias, _ = _crelu_inputs(rng, (2, 8, 16, 16), 1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jin._crelu_half_jnp(xb, jnp.asarray(scale), jnp.asarray(bias), 1,
                                          1e-5, 0.01)).astype(np.float32)
    got = tin.crelu_instance_norm(_t(x).to(torch.bfloat16), _t(scale), _t(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 4])
def test_spatial_stats_and_norm_plain_match_pallas_kernels(groups):
    """The plain K2 and K3 against the Pallas kernels themselves
    (_spatial_stats, _spatial_norm in interpret mode), both out_mul modes."""
    rng = np.random.default_rng(25)
    b, h, w, c = 2, 8, 16, 32
    x = (rng.standard_normal((b, h, w, c)) * 2 + 0.5).astype(np.float32)
    xj = jnp.asarray(x)
    want_stats = np.asarray(jin._spatial_stats(xj, 4, interpret=True))
    got_stats = tin.spatial_stats_ref(_t(x))
    np.testing.assert_allclose(got_stats.numpy(), want_stats, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_stats).max()))
    for out_mul, slope in ((1, None), (2, 0.01)):
        vecs = rng.standard_normal((b, 2 * out_mul, c)).astype(np.float32)
        want = np.asarray(jin._spatial_norm(xj, jnp.asarray(vecs), 4, slope, out_mul,
                                            interpret=True))
        got = tin.spatial_norm_ref(_t(x), _t(vecs), slope, out_mul).numpy()
        np.testing.assert_allclose(got, want, **F32_TOL)
    # the fold between them, as _crelu_half_pallas computes it
    scale = rng.standard_normal(2 * (c // groups)).astype(np.float32)
    bias = rng.standard_normal(2 * (c // groups)).astype(np.float32)
    vecs, stats_g = tin.crelu_coefficients(got_stats, _t(scale), _t(bias), groups, h * w, 1e-5)
    assert vecs.shape == (b, 4, c) and stats_g.shape == (b, 2, c // groups)
    want = np.asarray(jin._crelu_half_pallas(xj, jnp.asarray(scale), jnp.asarray(bias),
                                             groups, 1e-5, 0.01, True))
    got = tin.spatial_norm_ref(_t(x), vecs, 0.01, 2).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("slope", [None, 0.01])
def test_spatial_norm_plain_out_mul1_matches_pallas_interpret(slope):
    """The plain K3 with one output half, at an InstanceNorm's coefficients
    (folded from the plain K2 as _instance_norm_spatial folds them), vs
    _spatial_norm in interpret mode on the same vectors and vs the whole
    _instance_norm_spatial."""
    rng = np.random.default_rng(26)
    x, scale, bias, _ = _in_inputs(rng, (2, 16, 32, 16), True)
    stats = tin.spatial_stats_ref(_t(x))
    mean = stats[:, 0] / (16 * 32)
    a = torch.rsqrt(torch.clamp_min(stats[:, 1] / (16 * 32) - mean * mean, 0.0) + 1e-5) \
        * _t(scale)
    vecs = torch.stack([a, _t(bias) - mean * a], dim=1)
    got = tin.spatial_norm_ref(_t(x), vecs, slope, 1).numpy()
    xj = jnp.asarray(x)
    want_kernel = np.asarray(jin._spatial_norm(xj, jnp.asarray(vecs.numpy()), 4, slope, 1,
                                               interpret=True))
    np.testing.assert_allclose(got, want_kernel, **F32_TOL)
    want = np.asarray(jin._instance_norm_spatial(xj, jnp.asarray(scale), jnp.asarray(bias),
                                                 1e-5, slope, interpret=True))
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("shape", [(2, 3, 5, 8), (1, 4, 1, 4), (3, 2, 7, 16)])
def test_pack_neighbors_backward_matches_pallas_vjp(shape):
    """pack_neighbors_bwd_ref and the pack's autograd vs
    _pack_pallas_diff_bwd, bit-exact (a sum of four terms in one order)."""
    rng = np.random.default_rng(27)
    n = shape[0] * shape[1] * shape[2]
    g = rng.standard_normal((n, 4 * shape[3])).astype(np.float32)
    (want,) = jrr._pack_pallas_diff_bwd(shape, jnp.asarray(g))
    got = trr.pack_neighbors_bwd_ref(_t(g), shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = torch.zeros(shape, requires_grad=True)
    (auto,) = torch.autograd.grad(trr.pack_neighbors(f), f, _t(g))
    np.testing.assert_array_equal(auto.numpy(), np.asarray(want))


def test_rroi_align_gradient_matches_jax():
    """RoIRotate of a map (pack + plain crop) differentiates like fots's
    (the Pallas pack's custom VJP + XLA's gather transpose)."""
    rng = np.random.default_rng(28)
    f = rng.standard_normal((2, 12, 20, 8)).astype(np.float32)
    rois = np.array([[0, 8.0, 6.0, 5.0, 12.0, 10.0], [1, 10.0, 5.0, 6.0, 9.0, -30.0],
                     [0, 8.0, 8.0, 8.0, 8.0, 0.0]], np.float32)
    g = rng.standard_normal((3, 11, 24, 8)).astype(np.float32)

    def jfn(feat):
        return jrr.rroi_align_packed(jrr._pack_pallas_diff(feat), feat.shape,
                                     jnp.asarray(rois), 11, 24, 0.5)

    want_y, vjp = jax.vjp(jfn, jnp.asarray(f))
    (want,) = vjp(jnp.asarray(g))
    ft = _t(f, True)
    y = trr.rroi_align(ft, _t(rois), 11, 24, 0.5)
    (got,) = torch.autograd.grad(y, ft, _t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **F32_TOL)
    assert_grad_close(got.numpy(), want)


def _bn_pair(x, rng):
    m = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.standard_normal(x.shape[-1]).astype(np.float32)
    bias = rng.standard_normal(x.shape[-1]).astype(np.float32)
    mean = rng.standard_normal(x.shape[-1]).astype(np.float32)
    var = rng.uniform(0.5, 1.5, x.shape[-1]).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    port = tl.BatchNorm(x.shape[-1])
    port.load_state_dict({"weight": _t(scale), "bias": _t(bias), "running_mean": _t(mean),
                          "running_var": _t(var)})
    return m, variables, port


def test_batch_norm_train_matches_flax():
    """Train-mode BatchNorm: output, gradients and the updated running
    statistics (biased variance, r = 0.9 r + 0.1 batch) vs flax."""
    rng = np.random.default_rng(29)
    x = (rng.standard_normal((3, 5, 7, 6)) * 2 + 1).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    m, variables, port = _bn_pair(x, rng)

    def fn(params, x):
        return m.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                       mutable=["batch_stats"])

    want_y, updates = fn(variables["params"], jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, x: fn(p, x)[0], variables["params"], jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))

    port.train()
    xt = _t(x.transpose(0, 3, 1, 2), True)
    y = port(xt)
    got = torch.autograd.grad(y, (xt, port.weight, port.bias), _t(g.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want_y),
                               **F32_TOL)
    assert_grad_close(got[0].numpy().transpose(0, 2, 3, 1), dx)
    assert_grad_close(got[1].numpy(), dparams["scale"])
    assert_grad_close(got[2].numpy(), dparams["bias"])
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(updates["batch_stats"]["mean"]), **F32_TOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(updates["batch_stats"]["var"]), **F32_TOL)
    port.eval()  # eval mode leaves the statistics alone
    before = port.running_var.clone()
    port(xt.detach())
    assert torch.equal(port.running_var, before)


def test_dropout_drops_whole_channels_and_scales_the_rest():
    """flax nn.Dropout(0.2, broadcast_dims=(1, 2)) on NHWC = one keep/drop
    per (sample, channel) of NCHW, kept values / 0.8; the mask follows the
    generator; eval mode is the identity."""
    drop = tl.Dropout(0.2).train()
    x = torch.rand((4, 64, 3, 5)) + 0.5
    y = drop(x, torch.Generator().manual_seed(3))
    kept = (y != 0).all(dim=(2, 3))
    dropped = (y == 0).all(dim=(2, 3))
    assert bool((kept | dropped).all())                 # whole channels only
    assert 0.5 < float(kept.float().mean()) < 0.95      # about 80 % kept
    torch.testing.assert_close(y[kept], (x / 0.8)[kept], rtol=0, atol=0)
    y2 = drop(x, torch.Generator().manual_seed(3))
    assert torch.equal(y, y2)
    assert torch.equal(drop.eval()(x), x)
    # flax's own mask has the same shape and scale
    jy = fnn.Dropout(0.2, broadcast_dims=(1, 2), deterministic=False).apply(
        {}, jnp.ones((4, 3, 5, 64)), rngs={"dropout": jax.random.PRNGKey(0)})
    vals = np.unique(np.asarray(jy))
    assert set(vals.tolist()) <= {0.0, np.float32(1 / 0.8)}
    assert bool((np.asarray(jy) == np.asarray(jy)[:, :1, :1, :]).all())
