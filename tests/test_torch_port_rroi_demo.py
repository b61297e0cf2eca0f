"""The RRoIAlign demo of the port against fots's (CPU), and K4'-bwd's plain
version at three channels.

- ``fots_torch.cli.rroi_demo -device cpu`` and ``fots.cli.rroi_demo`` on the
  committed held-out scene ``img_112`` with its ``gt_img_112.txt``
  (``-pooled_height 8 -max_rois 2``, and the default height with 3 rois):
  the energy within 1e-5 relative (an f32 sum of up to 7e4 squares, in
  another order: read 3.3e-6), the crops within 1e-4 absolute, the
  image gradient within 1e-4 of its largest magnitude with the same
  support.  The files: every ``crop<i>.jpg`` whose u8 pixels are equal is
  equal byte for byte, and ``grad.jpg`` / ``grad_overlay.jpg`` are equal
  byte for byte wherever the two runs' u8 heat maps are equal (the
  tolerance: the heat maps may differ only where the gradients' f32
  channel sums differ, at most one level at under 0.1% of the pixels).
- ``pack_neighbors_bwd_ref`` at C = 3 equals fots's VJP rule of the pack
  (``_pack_pallas_diff_bwd``) exactly, and ``jax.vjp`` of fots's XLA pack
  where the cotangent of the slots past the map is zero (the slots the
  crops' weights mask: the XLA pack wraps there, the kernel writes zeros).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fots.cli import rroi_demo as fots_demo
from fots_torch.cli import rroi_demo as port_demo
from fots_torch.imageio import imread
from fots_torch.imgproc import apply_color_map_jet
from fots_torch.ops import rroi_align as trr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jrr = importlib.import_module("fots.ops.rroi_align")  # the package exports a function by that name
SCENE = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_jpg", "img_112.jpg")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs six workers on the cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _heat(grad):
    g = np.abs(grad).sum(-1)
    hi = max(float(np.percentile(g[g > 0], 95)) if (g > 0).any() else 0.0, 1e-6)
    return np.clip(255.0 * g / hi, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("flags", [["-pooled_height", "8", "-max_rois", "2"],
                                   ["-max_rois", "3"]])
def test_rroi_demo_equals_fots(tmp_path, flags, capsys, monkeypatch):
    port_dir, fots_dir = tmp_path / "port", tmp_path / "fots"
    energy, crops, grad = port_demo.main(["-image", SCENE, "-out_dir", str(port_dir),
                                          "-device", "cpu"] + flags)
    assert "cpu" in capsys.readouterr().out

    # fots's crops and gradient: the same computation as its main, whose
    # files are compared below
    captured = {}
    real_grad = jax.value_and_grad

    def value_and_grad(fn, **kw):
        def run(x):
            out = real_grad(fn, **kw)(x)
            captured["out"] = out
            return out
        return run

    monkeypatch.setattr(jax, "value_and_grad", value_and_grad)
    fots_demo.main(["-image", SCENE, "-out_dir", str(fots_dir)] + flags)
    (f_energy, f_crops), f_grad = captured["out"]
    f_crops, f_grad = np.asarray(f_crops), np.asarray(f_grad[0])

    assert abs(energy - float(f_energy)) <= 1e-5 * abs(float(f_energy))
    assert crops.shape == f_crops.shape
    assert np.abs(crops - f_crops).max() <= 1e-4
    assert grad.shape == f_grad.shape == imread(SCENE).shape
    assert np.abs(grad - f_grad).max() <= 1e-4 * np.abs(f_grad).max()
    assert np.array_equal(grad != 0, f_grad != 0)

    names = sorted(os.listdir(fots_dir))
    assert sorted(os.listdir(port_dir)) == names
    assert names == sorted([f"crop{i}.jpg" for i in range(len(crops))]
                           + ["grad.jpg", "grad_overlay.jpg"])
    for i in range(len(crops)):
        if np.array_equal(np.clip(crops[i], 0, 255).astype(np.uint8),
                          np.clip(f_crops[i], 0, 255).astype(np.uint8)):
            assert (port_dir / f"crop{i}.jpg").read_bytes() == (fots_dir / f"crop{i}.jpg").read_bytes()
    heat, f_heat = _heat(grad), _heat(f_grad)
    d = np.abs(heat.astype(int) - f_heat)
    assert d.max() <= 1 and np.mean(d > 0) < 1e-3
    if np.array_equal(heat, f_heat):
        for name in ("grad.jpg", "grad_overlay.jpg"):
            assert (port_dir / name).read_bytes() == (fots_dir / name).read_bytes(), name
    assert np.array_equal(imread(str(port_dir / "grad.jpg")).shape[:2], heat.shape)
    assert apply_color_map_jet(heat).shape == heat.shape + (3,)


@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (2, 6, 9, 3), (1, 2, 4, 3)])
def test_pack_bwd_plain_version_at_three_channels_equals_fots(shape):
    b, h, w, c = shape
    n = b * h * w
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n, 4 * c)).astype(np.float32)
    got = trr.pack_neighbors_bwd_ref(torch.from_numpy(g), shape).numpy()
    want = np.asarray(jrr._pack_pallas_diff_bwd(shape, jnp.asarray(g))[0])
    assert np.array_equal(got, want)

    # jax.vjp of the XLA pack, the slots past the map at zero cotangent
    masked = g.reshape(n, 4, c).copy()
    rows = np.arange(n)
    for slot, off in ((1, 1), (2, w), (3, w + 1)):
        masked[rows + off >= n, slot] = 0
    masked = masked.reshape(n, 4 * c)
    f = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    _, vjp = jax.vjp(jrr._pack_neighbors_xla, f)
    want = np.asarray(vjp(jnp.asarray(masked))[0])
    got = trr.pack_neighbors_bwd_ref(torch.from_numpy(masked), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    # the autograd route of the port's pack on the CPU is the plain version
    ft = torch.from_numpy(np.array(f)).requires_grad_(True)
    trr.pack_neighbors(ft).backward(torch.from_numpy(masked))
    assert np.array_equal(ft.grad.numpy(), got)
