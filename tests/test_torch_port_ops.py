"""fots_torch ops against fots on the same inputs (CPU, plain versions).

Inputs come from ``np.random.default_rng``; the same arrays go through the
JAX function and its port.  Tolerances: f32 results within 1e-5 (relative
and absolute: the two frameworks sum in different orders); bf16 outputs
within one bf16 ulp (relative 2^-7), since an f32 difference in the last
bit can flip the final rounding; the neighbour pack and the candidate pack
bit-exact.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fots.pipeline import device_letterbox_batch as jax_letterbox
from fots_torch.ops import instance_norm as tin
from fots_torch.ops import nms as tnms
from fots_torch.ops import rroi_align as trr
from fots_torch.pipeline import device_letterbox_batch as torch_letterbox

# fots.ops re-exports functions under the module names, so import the
# modules themselves
jin = importlib.import_module("fots.ops.instance_norm")
jnms = importlib.import_module("fots.ops.nms")
jrr = importlib.import_module("fots.ops.rroi_align")

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _in_case(rng, shape, dtype, affine):
    x = (rng.standard_normal(shape) * 3 + 1.5).astype(np.float32)
    c = shape[-1]
    scale = rng.standard_normal(c).astype(np.float32) if affine else np.ones(c, np.float32)
    bias = rng.standard_normal(c).astype(np.float32) if affine else np.zeros(c, np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    xt = _t(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return xj, xt, scale, bias


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("affine,slope", [(True, None), (True, 0.01), (False, 0.0),
                                          (False, None)])
def test_instance_norm_ref_matches_pallas_and_jnp(dtype, affine, slope):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(0)
    xj, xt, scale, bias = _in_case(rng, (2, 8, 16, 32), dtype, affine)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jin.instance_norm(xj, jnp.asarray(scale), jnp.asarray(bias),
                                        negative_slope=slope, use_pallas=True)
    want_jnp = jin.instance_norm_jnp(xj, jnp.asarray(scale), jnp.asarray(bias),
                                     negative_slope=slope)
    got = tin.instance_norm(xt, _t(scale) if affine else None,
                            _t(bias) if affine else None, negative_slope=slope)
    assert got.dtype == xt.dtype
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want_pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(want_jnp), **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masked_instance_norm_ref_matches_jnp(dtype):
    rng = np.random.default_rng(1)
    xj, xt, scale, bias = _in_case(rng, (4, 11, 32, 16), dtype, True)
    valid_w = np.array([1, 7, 32, 20], np.int32)
    want = jin.masked_instance_norm_jnp(xj, jnp.asarray(valid_w), jnp.asarray(scale),
                                        jnp.asarray(bias), negative_slope=0.01)
    got = tin.instance_norm(xt, _t(scale), _t(bias), negative_slope=0.01,
                            valid_w=_t(valid_w))
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert (_np(got)[1, :, 7:] == 0).all()


def test_pack_neighbors_ref_bit_exact_vs_pallas_kernel():
    """At 2x16x32x64 the Pallas pack really runs (interpret mode); the port
    must equal it on every row, out-of-map rows (zeros) included, and equal
    the XLA pack on the rows whose neighbours are all in the map."""
    rng = np.random.default_rng(3)
    f = rng.random((2, 16, 32, 64), np.float32)
    want = np.asarray(jrr._pack_neighbors_pallas(jnp.asarray(f), interpret=True))
    got = trr.pack_neighbors(_t(f)).numpy()
    assert got.shape == want.shape == (2 * 16 * 32, 256)
    np.testing.assert_array_equal(got, want)
    xla = np.asarray(jrr._pack_neighbors_xla(jnp.asarray(f)))
    in_map = 2 * 16 * 32 - 32 - 1
    np.testing.assert_array_equal(got[:in_map], xla[:in_map])


def test_pack_neighbors_ref_bf16_bit_exact():
    rng = np.random.default_rng(4)
    f = jnp.asarray(rng.random((2, 16, 32, 64), np.float32)).astype(jnp.bfloat16)
    want = np.asarray(jrr._pack_neighbors_pallas(f, interpret=True).astype(jnp.float32))
    got = trr.pack_neighbors(_t(np.asarray(f.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), want)


def _rois(rng, n, b, h, w, scale):
    rows = []
    for _ in range(n):
        rows.append([rng.integers(0, b), rng.uniform(0, w / scale), rng.uniform(0, h / scale),
                     rng.uniform(4, 40), rng.uniform(8, 200), rng.uniform(-60, 60)])
    rows += [[0, 5.0, 5.0, 0.0, 20.0, 0.0],          # degenerate h
             [1, 40.0, 30.0, 12.0, -3.0, 10.0],       # degenerate w
             [0, 0.0, 0.0, 10.0, 30.0, 45.0],         # at the map corner
             [1, w / scale - 1, h / scale - 1, 8.0, 16.0, -90.0],  # far edge
             [0, w / scale / 2, h / scale / 2, 6.0, 900.0, 3.0],   # wider than the map
             [1, 2.5, 2.5, 4.0, 4.0, 0.0]]            # exact halves
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("scale,pw", [(1.0, 24), (0.25, 64)])
def test_rroi_align_matches_fots(scale, pw):
    rng = np.random.default_rng(5)
    f = rng.standard_normal((2, 20, 36, 8)).astype(np.float32)
    rois = _rois(rng, 12, 2, 20, 36, scale)
    want = np.asarray(jrr.rroi_align(jnp.asarray(f), jnp.asarray(rois), 11, pw, scale))
    got = trr.rroi_align(_t(f), _t(rois), 11, pw, scale).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    quads = np.asarray(jrr._pack_neighbors_xla(jnp.asarray(f)))
    want_p = np.asarray(jrr.rroi_align_packed(jnp.asarray(quads), f.shape,
                                              jnp.asarray(rois), 11, pw, scale))
    got_p = trr.rroi_align_packed(trr.pack_neighbors(_t(f)), f.shape, _t(rois), 11, pw,
                                  scale).numpy()
    np.testing.assert_allclose(got_p, want_p, **F32_TOL)
    assert (got[-6] == 0).all() and (got[-5] == 0).all()  # degenerate rois


def test_width_helpers_match_fots():
    rng = np.random.default_rng(6)
    rois = _rois(rng, 8, 1, 20, 36, 1.0)[:8]
    assert trr.pooled_width_for(rois, 11) == jrr.pooled_width_for(rois, 11)
    for w in [1, 31, 32, 33, 200, 511, 4000]:
        assert trr.width_bucket(w) == jrr.width_bucket(w)


def _maps(rng, b=2, h=24, w=40):
    segm = rng.random((b, h, w)).astype(np.float32)
    segm[:, :, : w // 3] *= 0.5  # a third of every map below threshold
    geo = (rng.random((b, h, w, 4)) * 60).astype(np.float32)
    ang = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    ang /= np.linalg.norm(ang, axis=-1, keepdims=True)
    return segm, geo, ang


def test_extract_candidates_and_u16_pack_match_fots():
    rng = np.random.default_rng(7)
    segm, geo, ang = _maps(rng)
    k = 512
    live = (segm > 0.5).sum(axis=(1, 2))
    assert live.max() <= k  # the premise under which the sets agree
    want = np.asarray(jnms.extract_candidates(jnp.asarray(segm), jnp.asarray(geo),
                                              jnp.asarray(ang), k))
    got = tnms.extract_candidates(_t(segm), _t(geo), _t(ang), k).numpy()
    assert got.shape == want.shape == (2, 8, k)
    for i in range(2):
        g = got[i][:, got[i][0] > 0.5]
        w = want[i][:, want[i][0] > 0.5]
        g = g[:, np.argsort(g[7])]
        w = w[:, np.argsort(w[7])]
        np.testing.assert_array_equal(g, w)
    # u16 transport: the same bit patterns as the JAX pack
    vals = jax.lax.bitcast_convert_type(jnp.asarray(want)[:, :7].astype(jnp.float16),
                                        jnp.uint16)
    want16 = np.concatenate([np.asarray(vals), want[:, 7:].astype(np.uint16)], axis=1)
    got16 = tnms.pack_candidates_u16(_t(got)).numpy().view(np.uint16)
    for i in range(2):
        live_g = got16[i][:, got[i][0] > 0.5]
        live_w = want16[i][:, want[i][0] > 0.5]
        np.testing.assert_array_equal(live_g[:, np.argsort(live_g[7])],
                                      live_w[:, np.argsort(live_w[7])])
    np.testing.assert_array_equal(tnms.unpack_candidates(got16),
                                  jnms.unpack_candidates(got16))


@pytest.mark.parametrize("transport", ["u16", "f32"])
def test_host_nms_matches_fots(transport):
    """The same candidate packs through both host NMS paths: byte-identical
    boxes (the port's C++ is its own copy of native/nms_core.cpp)."""
    rng = np.random.default_rng(8)
    b, h, w = 2, 32, 48
    segm = np.zeros((b, h, w), np.float32)
    geo = np.zeros((b, h, w, 4), np.float32)
    ang = np.zeros((b, h, w, 2), np.float32)
    for i in range(b):  # a few text-like blobs of consistent geometry
        for _ in range(4):
            y0, x0 = rng.integers(2, h - 8), rng.integers(2, w - 14)
            hh, ww = rng.integers(3, 6), rng.integers(6, 12)
            t = rng.uniform(-0.2, 0.2)
            for y in range(y0, y0 + hh):
                for x in range(x0, x0 + ww):
                    segm[i, y, x] = rng.uniform(0.6, 0.99)
                    geo[i, y, x] = [4 * (y - y0) + 2, 4 * (y0 + hh - y) + 2,
                                    4 * (x - x0) + 2, 4 * (x0 + ww - x) + 2]
                    ang[i, y, x] = [np.sin(t), np.cos(t)]
    cands = np.asarray(jnms.extract_candidates(jnp.asarray(segm), jnp.asarray(geo),
                                               jnp.asarray(ang), 512))
    if transport == "u16":
        cands = tnms.pack_candidates_u16(_t(cands)).numpy().view(np.uint16)
    want = jnms.get_boxes_from_candidates_batch(cands, h, w)
    got = tnms.get_boxes_from_candidates_batch(cands, h, w)
    assert sum(len(x) for x in want) >= 4
    for g, wnt in zip(got, want):
        assert g.tobytes() == wnt.tobytes()


def test_device_letterbox_matches_fots():
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, (3, 50, 70, 3)).astype(np.uint8)
    for hw in [(64, 96), (96, 64), (50, 70)]:
        want = np.asarray(jax_letterbox(raw, hw))
        got = torch_letterbox(_t(raw), hw).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **F32_TOL)


def test_codec_decode_batch_matches_fots():
    from fots.codec import LabelCodec as JaxCodec
    from fots_torch.codec import LabelCodec

    rng = np.random.default_rng(10)
    ids = rng.integers(0, 88, (64, 48)).astype(np.uint8)
    ids[:, ::3] = 0  # blanks between repeats
    ids[5] = 0       # an all-blank row decodes to ""
    want = JaxCodec().decode_batch(ids)
    assert LabelCodec().decode_batch(ids) == want
    assert LabelCodec().reserved_ids == JaxCodec().reserved_ids
    assert want[5] == "" and any(len(w) > 5 for w in want)
