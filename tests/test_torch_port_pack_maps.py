"""The training batch's native packing pass (``csrc/pack_maps.cpp``,
:func:`fots_torch.train.pack_maps_into`) against :func:`pack_host_maps`.

- byte for byte at batch 1, 3 and 32, at 512x512, 640x960 and odd widths,
  with its AVX2 + F16C code and with its portable code, on one thread and
  on several: images on and off the u8 grid, ties of rint, values outside
  [-1, 1], -0.0; geometry at f16's subnormal, rounding and overflow edges;
- :func:`pack_threads` from the bytes, the rows and the CPU affinity;
- :meth:`Trainer._prepare_maps` takes the native route for the benchmark's
  kind of batch and a meshed rank's row slice, and the NumPy route, with
  :func:`pack_host_maps`' bytes, for NaN / inf images, maps that are not
  whole numbers in [0, 255], NaN geometry, foreign dtypes and strided
  views; ``prep.pack_maps`` names the route and the buffers' bytes;
- three ``Trainer.train`` steps on the CPU give the same history and
  weights on either route; on a card (``cuda`` marker), six steps over two
  batches upload exactly the NumPy route's bytes while pinned buffers are
  reused under uploads in flight.

The file imports no JAX, so the card runs it alone:
``python3 -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_port_pack_maps.py``.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from fots_torch import checkpoint as tck
from fots_torch import tracing
from fots_torch import train as ttrain
from fots_torch.parallel.mesh import BatchShard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
CROP = (128, 160, 192, 352)  # y0, x0, H, W: three words of two asset scenes
OUT_DTYPES = (torch.uint8, torch.uint8, torch.float16)
# the reference warns on the edges' overflow (images past FLT_MAX / 128, f16 casts)
pytestmark = pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")

F32 = np.float32
#: image values: ties of rint after (x + 1) * 128 at both clip edges and
#: inside, the clip edges themselves, signed zeros, far outside [-1, 1]
IMAGE_EDGES = F32([(k - 127.5) / 128 for k in (-2, -1, 0, 1, 2, 127, 254, 255, 256)]
                  + [-0.0, 0.0, -1.0, 1.0, 127 / 128, 0.9921875, 0.99609375, -1.00390625,
                     -0.99609375, 1e-40, -1e-40, 3.0, -5.0, 1e30, -1e30,
                     np.finfo(F32).max, -np.finfo(F32).max,
                     np.nextafter(F32(-1), F32(0)), np.nextafter(F32(1), F32(2))])
#: geometry values at f16's edges: below, at and above 2^-25, subnormal
#: ties, the subnormal / normal border, normal ties, the largest half,
#: overflow to inf, f32 subnormals, infinities
GEO_EDGES = F32([0.0, -0.0, 2.0 ** -25, 2.0 ** -26, 1.5 * 2.0 ** -24, 2.5 * 2.0 ** -24,
                 3.5 * 2.0 ** -24, 2.0 ** -24, 2.0 ** -14, 2.0 ** -14 - 2.0 ** -25,
                 2.0 ** -14 - 2.0 ** -24, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 2048.5,
                 65504.0, 65519.0, 65520.0, 65536.0, 1e9, 1e-40, -1e-40, np.inf, -np.inf,
                 -65520.0, -1.5 * 2.0 ** -24])
GEO_EDGES = np.concatenate([GEO_EDGES, np.nextafter(GEO_EDGES, F32(np.inf)),
                            np.nextafter(GEO_EDGES, F32(-np.inf))])


def _scatter(rng, a, values, share=0.02):
    """Put ``values`` at a random ``share`` of ``a``'s elements and at its
    first and last ones (the scalar tails)."""
    flat = a.reshape(-1)
    k = max(1, int(flat.size * share))
    flat[rng.integers(0, flat.size, k)] = rng.choice(values, k)
    m = min(len(values), flat.size)
    flat[:m] = values[:m]
    flat[-m:] = values[-m:]


def _batch(rng, b, h, w, score_dtype=np.float32, mask_dtype=np.uint8):
    images = (rng.integers(0, 256, (b, h, w, 3)).astype(F32) / F32(128) - F32(1))
    off = rng.random(images.shape) < 0.3
    images[off] = rng.uniform(-1.2, 1.2, int(off.sum())).astype(F32)
    _scatter(rng, images, IMAGE_EDGES)
    hs, ws = h // 4, w // 4
    score = (rng.random((b, hs, ws)) < 0.4).astype(score_dtype)
    _scatter(rng, score, np.array([0, 1, 2, 17, 128, 254, 255, -0.0], dtype=F32)
             .astype(score_dtype), 0.05)
    mask = (rng.random((b, hs, ws)) < 0.8).astype(mask_dtype)
    geo = (rng.standard_normal((b, hs, ws, 5)) * F32(60)).astype(F32)
    bits = rng.integers(0, 1 << 32, geo.size // 4, dtype=np.uint64).astype(np.uint32)
    bits = np.where(rng.random(bits.size) < 0.5, (bits & ~np.uint32(0x1fff)) | 0x1000, bits)
    rand = bits.view(F32)
    rand = rand[~np.isnan(rand)]
    geo.reshape(-1)[rng.integers(0, geo.size, rand.size)] = rand
    _scatter(rng, geo, GEO_EDGES, 0.03)
    return ttrain.DetectionBatch(images=images, score_maps=score, geo_maps=geo,
                                 training_masks=mask, gt_idxs=None, gt_quads=None, labels=None)


def _native(batch, threads, simd=True):
    shapes = ttrain.native_map_shapes(batch)
    assert shapes is not None
    outs = [torch.full(s, float("nan") if d == torch.float16 else 171, dtype=d)
            for s, d in zip(shapes, OUT_DTYPES)]  # bytes the pass has to overwrite
    return ttrain.pack_maps_into(batch, outs, threads, simd), outs


def _assert_bytes(want, got):
    for a, t in zip(want, got):
        assert a.shape == tuple(t.shape) and a.dtype == t.numpy().dtype
        np.testing.assert_array_equal(a.view(np.uint8), t.numpy().view(np.uint8))


@pytest.mark.parametrize("simd", [True, False], ids=["avx2_f16c", "portable"])
@pytest.mark.parametrize("b,h,w", [(1, 640, 960), (3, 512, 512), (32, 512, 512),
                                   (3, 92, 140), (1, 36, 44)])
def test_native_pass_gives_pack_host_maps_bytes(b, h, w, simd):
    batch = _batch(np.random.default_rng(b * 7919 + h * 31 + w), b, h, w)
    want = ttrain.pack_host_maps(batch)
    for threads in (1, 2, 5):
        ok, outs = _native(batch, threads, simd)
        assert ok, threads
        _assert_bytes(want, outs)


@pytest.mark.parametrize("score_dtype,mask_dtype", [(np.uint8, np.float32),
                                                    (np.float32, np.float32),
                                                    (np.uint8, np.uint8)])
def test_native_pass_takes_u8_and_f32_maps(score_dtype, mask_dtype):
    batch = _batch(np.random.default_rng(5), 3, 92, 140, score_dtype, mask_dtype)
    for simd in (True, False):
        ok, outs = _native(batch, 2, simd)
        assert ok
        _assert_bytes(ttrain.pack_host_maps(batch), outs)


def test_every_f16_rounding_case_of_a_wide_sweep():
    """Every f32 of 2^20 evenly spread bit patterns (every exponent, the
    low bits of each), on both implementations."""
    bits = (np.arange(1 << 20, dtype=np.uint64) * 4099 + 12345).astype(np.uint32)
    vals = bits.view(F32)
    vals = vals[~np.isnan(vals)]
    n = vals.size // 5
    batch = ttrain.DetectionBatch(
        images=np.zeros((1, 4, 4, 3), F32), score_maps=np.zeros((1, 1, n), F32),
        geo_maps=np.ascontiguousarray(vals[:n * 5].reshape(1, 1, n, 5)),
        training_masks=np.zeros((1, 1, n), np.uint8), gt_idxs=None, gt_quads=None,
        labels=None)
    want = ttrain.pack_host_maps(batch)
    for simd in (True, False):
        ok, outs = _native(batch, 1, simd)
        assert ok
        _assert_bytes(want, outs)


@pytest.mark.parametrize("fault", ["nan_image", "inf_image", "neg_inf_image", "half_score",
                                   "score_256", "negative_score", "nan_score", "half_mask_f32",
                                   "nan_geo"])
def test_values_the_pass_does_not_reproduce_are_counted(fault):
    rng = np.random.default_rng(11)
    batch = _batch(rng, 3, 92, 140, mask_dtype=np.float32 if "mask" in fault else np.uint8)
    field, value = {
        "nan_image": ("images", np.nan), "inf_image": ("images", np.inf),
        "neg_inf_image": ("images", -np.inf), "half_score": ("score_maps", 0.5),
        "score_256": ("score_maps", 256.0), "negative_score": ("score_maps", -1.0),
        "nan_score": ("score_maps", np.nan), "half_mask_f32": ("training_masks", 1.5),
        "nan_geo": ("geo_maps", np.nan)}[fault]
    a = getattr(batch, field)
    a.reshape(-1)[a.size // 2 + 3] = value
    for simd in (True, False):
        for threads in (1, 3):
            assert not _native(batch, threads, simd)[0]


@pytest.mark.parametrize("cpus,nbytes,rows,want", [
    (8, 105 << 20, 32, 4),   # b32 512x512: the cap
    (8, 40 << 20, 32, 2),    # one thread per 16 MiB
    (3, 105 << 20, 32, 2),   # one CPU left to the dispatching thread
    (1, 105 << 20, 32, 1),
    (8, 105 << 20, 3, 3),    # no more threads than rows
    (8, 1 << 20, 2, 1),
])
def test_pack_threads(monkeypatch, cpus, nbytes, rows, want):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    assert ttrain.pack_threads(nbytes, rows) == want


@pytest.fixture(scope="module")
def trainer():
    model, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    return ttrain.Trainer(model, learning_rate=1e-4, seed=3, device="cpu")


def _prepared_maps(trainer, batch):
    tracing.reset()
    with tracing.enable():
        host = trainer._prepare_maps(batch)
    (span,) = [s for s in tracing.spans() if s.name == "prep.pack_maps"]
    tracing.reset()
    return host, span


@pytest.mark.parametrize("case", ["f32_score_u8_mask", "u8_maps", "nan_image", "inf_image",
                                  "half_score", "score_300", "nan_geo", "f64_images",
                                  "bool_mask", "f16_geo", "i64_score", "strided_images",
                                  "strided_geo"])
def test_prepare_maps_routes(trainer, case):
    batch = _batch(np.random.default_rng(23), 2, 92, 140)
    native = case in ("f32_score_u8_mask", "u8_maps")
    if case == "u8_maps":
        batch = replace(batch, score_maps=batch.score_maps.astype(np.uint8))
    elif case in ("nan_image", "inf_image"):
        batch.images[1, 5, 7, 2] = np.nan if case == "nan_image" else np.inf
    elif case in ("half_score", "score_300"):
        batch.score_maps[0, 3, 4] = 0.5 if case == "half_score" else 300.0
    elif case == "nan_geo":
        batch.geo_maps[1, 2, 2, 4] = np.nan
    elif case == "f64_images":
        batch = replace(batch, images=batch.images.astype(np.float64))
    elif case == "bool_mask":
        batch = replace(batch, training_masks=batch.training_masks.astype(bool))
    elif case == "f16_geo":
        batch = replace(batch, geo_maps=batch.geo_maps.astype(np.float16))
    elif case == "i64_score":
        batch = replace(batch, score_maps=batch.score_maps.astype(np.int64))
    elif case == "strided_images":
        wide = np.repeat(batch.images, 2, axis=2)
        batch = replace(batch, images=wide[:, :, ::2])
    elif case == "strided_geo":
        batch = replace(batch, geo_maps=np.concatenate([batch.geo_maps, batch.geo_maps],
                                                       axis=1)[:, ::2])
    with np.errstate(invalid="ignore", over="ignore"):  # NaN to u8, overflow to f16
        want = ttrain.pack_host_maps(batch)
        host, span = _prepared_maps(trainer, batch)
    _assert_bytes(want, host)
    assert span.attrs == {"route": "native" if native else "numpy",
                          "bytes": sum(a.nbytes for a in want)}


def test_a_meshed_ranks_row_slice_takes_the_native_route(trainer, monkeypatch):
    batch = _batch(np.random.default_rng(29), 4, 92, 140)
    monkeypatch.setattr(trainer, "mesh", object())
    monkeypatch.setattr(trainer, "shard", BatchShard(2, 1))
    host, span = _prepared_maps(trainer, batch)
    rows = replace(batch, **{k: getattr(batch, k)[2:4] for k in
                             ("images", "score_maps", "geo_maps", "training_masks")})
    _assert_bytes(ttrain.pack_host_maps(rows), host)
    assert span.attrs["route"] == "native"


def _crop_batches():
    """Two contiguous batches of the asset scenes' three-word crop."""
    with np.load(os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images = z["images"]
    with np.load(os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")) as z:
        targets = {k: z[k] for k in z.files}
    y0, x0, h, w = CROP
    ys, xs = slice(y0 // 4, (y0 + h) // 4), slice(x0 // 4, (x0 + w) // 4)
    out = []
    for order in ([0, 1], [1, 0]):
        b = ttrain.asset_batch(images, targets, order)
        out.append(ttrain.DetectionBatch(
            images=np.ascontiguousarray(b.images[:, y0:y0 + h, x0:x0 + w]),
            score_maps=np.ascontiguousarray(b.score_maps[:, ys, xs]),
            geo_maps=np.ascontiguousarray(b.geo_maps[:, ys, xs]),
            training_masks=np.ascontiguousarray(b.training_masks[:, ys, xs]),
            gt_idxs=np.ascontiguousarray(b.gt_idxs[:, ys, xs]),
            gt_quads=[[q - np.float32([x0, y0]) for q in s] for s in b.gt_quads],
            labels=b.labels))
    return out


def _train(device, batches, steps, monkeypatch, numpy_route):
    """``steps`` steps over ``batches`` cycled; returns the history, the
    weights, the routes of ``prep.pack_maps`` and the buffers each step
    uploaded, read back on the device in stream order after the copy."""
    with monkeypatch.context() as m:
        if numpy_route:
            m.setattr(ttrain, "native_map_shapes", lambda batch: None)
        uploaded = []
        unpack = ttrain.unpack_device_batch

        def keep(images_u8, maps_u8, maps_f16, *rest, **kw):
            uploaded.append([t.clone() for t in (images_u8, maps_u8, maps_f16)])
            return unpack(images_u8, maps_u8, maps_f16, *rest, **kw)

        m.setattr(ttrain, "unpack_device_batch", keep)
        model, _, _ = tck.load_detector(SNAPSHOT, device)
        trainer = ttrain.Trainer(model, learning_rate=1e-4, seed=3, device=device)
        tracing.reset()
        with tracing.enable():
            trainer.train([batches[i % len(batches)] for i in range(steps)], max_steps=steps,
                          log_every=0)
        routes = [s.attrs["route"] for s in tracing.spans() if s.name == "prep.pack_maps"]
        tracing.reset()
    weights = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    return trainer.history, weights, routes, [[t.cpu() for t in u] for u in uploaded]


def _same_weights(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_trainer_steps_are_identical_on_either_route(monkeypatch):
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        batches = _crop_batches()
        native = _train("cpu", batches, 3, monkeypatch, numpy_route=False)
        numpy_ = _train("cpu", batches, 3, monkeypatch, numpy_route=True)
    finally:
        torch.set_num_threads(saved)
    assert native[2] == ["native"] * 3 and numpy_[2] == ["numpy"] * 3
    assert native[0] == numpy_[0] and len(native[0]) == 3
    _same_weights(native[1], numpy_[1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return "cuda"


@pytest.mark.cuda
def test_pinned_buffers_reused_under_uploads_change_nothing(cuda_device, monkeypatch):
    batches = _crop_batches()
    big = [replace(b, **{k: np.ascontiguousarray(np.concatenate([getattr(b, k)] * 8))
                         for k in ("images", "score_maps", "geo_maps", "training_masks",
                                   "gt_idxs")},
                   gt_quads=b.gt_quads * 8, labels=b.labels * 8) for b in batches]
    native = _train(cuda_device, big, 6, monkeypatch, numpy_route=False)
    numpy_ = _train(cuda_device, big, 6, monkeypatch, numpy_route=True)
    assert native[2] == ["native"] * 6 and numpy_[2] == ["numpy"] * 6
    for step, (a, b) in enumerate(zip(native[3], numpy_[3])):
        want = ttrain.pack_host_maps(big[step % 2])
        for w, x, y in zip(want, a, b):
            np.testing.assert_array_equal(x.numpy().view(np.uint8), w.view(np.uint8))
            np.testing.assert_array_equal(y.numpy().view(np.uint8), w.view(np.uint8))
    assert len(native[3]) == len(numpy_[3]) == 6
