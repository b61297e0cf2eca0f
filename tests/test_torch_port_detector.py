"""fots_torch FOTSDetector against fots with the shipped weights (CPU).

Both load ``artifacts/serving_params.npz``; the input is two of the
committed ``data/synth`` scenes letterboxed to 128x256.  Tolerances (f32):
segm and angle within 1e-4, rbox within 5e-3 px, recognition log-probs
within 1e-3, the 256/64-channel features within 1e-5 of their largest
magnitude.  The only difference in f32 is summation order (XLA's vs
PyTorch's conv and reduction kernels; the JAX stem runs space-to-depth,
the port's the canonical form).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector
from fots.pipeline import cast_params_bf16 as jax_cast_bf16
from fots.pipeline import device_letterbox_batch as jax_letterbox
from fots_torch import checkpoint as tck
from fots_torch.pipeline import cast_params_bf16

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")


@pytest.fixture(scope="module")
def jax_shipped():
    model = JaxDetector(nclass=87)
    variables = init_detector(model, jax.random.PRNGKey(0))
    variables, step = jax_load_serving_params(SNAPSHOT, variables)
    return model, variables


def _scene(hw):
    import cv2

    raw = np.stack([cv2.imread(os.path.join(REPO, "data", "synth", f"img_00{i}.jpg"))
                    for i in range(2)])
    return np.asarray(jax_letterbox(raw, hw))


def _maps(out):
    return {k: [np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor)
                else t.float().numpy() for t in out[k]] for k in ("segm", "rbox", "angle")}


def test_detector_matches_fots_with_shipped_weights(jax_shipped):
    """f32 at 128x256 on two letterboxed scenes: every head at both scales,
    the merged features, focr, and masked recognition at two widths."""
    jm, jv = jax_shipped
    x = _scene((128, 256))
    jout = jm.apply(jv, jnp.asarray(x), train=False)
    port, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    with torch.inference_mode():
        tout = port(torch.from_numpy(np.array(x)))
    jmaps, tmaps = _maps(jout), _maps(tout)
    for s in range(2):
        np.testing.assert_allclose(tmaps["segm"][s], jmaps["segm"][s], atol=1e-4)
        np.testing.assert_allclose(tmaps["angle"][s], jmaps["angle"][s], atol=1e-4)
        np.testing.assert_allclose(tmaps["rbox"][s], jmaps["rbox"][s], atol=5e-3)
    assert (jmaps["segm"][0] > 0.5).sum() > 20  # the scenes hold text
    for k in ("features", "focr"):
        want = np.asarray(jout[k])
        np.testing.assert_allclose(tout[k].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())

    rng = np.random.default_rng(12)
    for width in (32, 96):
        strips = rng.standard_normal((4, 11, width, 64)).astype(np.float32)
        valid_w = np.array([1, width // 3, width, width - 5], np.int32)
        want = np.asarray(jm.apply(jv, jnp.asarray(strips), train=False,
                                   method=JaxDetector.recognize,
                                   valid_w=jnp.asarray(valid_w)))
        with torch.inference_mode():
            got = port.recognize(torch.from_numpy(strips), torch.from_numpy(valid_w))
        assert got.shape == (4, width, 87)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_detector_bf16_matches_fots_bf16(jax_shipped):
    """bf16 backbone with f32 heads (cast_params_bf16 on both sides).  The
    two frameworks round bf16 at different places (XLA keeps fused
    elementwise chains in f32; the resize matrix is bf16 in JAX), so the
    port is held to the JAX package's own bf16-vs-f32 gap: within twice
    that gap (plus 0.02 px / 0.01) on live pixels (segm > 0.5 in f32)."""
    jm, jv = jax_shipped
    x = _scene((128, 256))
    j32 = _maps(jm.apply(jv, jnp.asarray(x), train=False))
    j16 = _maps(jm.apply(jax_cast_bf16(dict(jv)), jnp.asarray(x).astype(jnp.bfloat16),
                         train=False))
    port, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    cast_params_bf16(port)
    assert port.act.weight.dtype == torch.float32
    assert port.stem.conv0a.weight.dtype == torch.bfloat16
    assert port.layer2[0].down_bn.running_var.dtype == torch.float32
    with torch.inference_mode():
        tout = port(torch.from_numpy(np.array(x)).to(torch.bfloat16))
    assert tout["rbox"][0].dtype == torch.float32  # geometry stays f32
    assert tout["focr"].dtype == torch.bfloat16
    t16 = _maps(tout)
    live = j32["segm"][0][..., 0] > 0.5
    assert live.sum() > 20
    gap = {k: np.abs(j16[k][0] - j32[k][0])[live].max() for k in ("rbox", "angle")}
    np.testing.assert_allclose(t16["segm"][0], j16["segm"][0],
                               atol=2 * np.abs(j16["segm"][0] - j32["segm"][0]).max() + 0.01)
    for k, extra in (("rbox", 0.02), ("angle", 0.01)):
        err = np.abs(t16[k][0] - j16[k][0])[live].max()
        assert err <= 2 * gap[k] + extra, (k, err, gap[k])
