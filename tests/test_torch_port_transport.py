"""The yuv420 transport, the bundle for several device types, the config
presets and the profiling helpers of the port, on the CPU.

- ``imgproc.bgr2yuv_u8`` and ``imgproc.resize_area_u8`` against ``cv2``
  byte for byte: every one of the 2^24 colours at widths whose rows end in
  OpenCV's vector body and in its scalar tail; ``INTER_AREA`` at odd and
  even sizes (an odd side halves to ``(n + 1) // 2``, a fractional factor)
  and at integral factors;
- the ``yuv420`` letterbox's (Y, UV) byte-equal to ``fots``'s; the
  candidate packs of ``fots``'s ``tests/test_pipeline.py`` images (blurred
  noise, 64x64) against ``fots``'s ``transport="yuv420"`` with the shipped
  snapshot, threshold -1 so that every pixel is a candidate: the same pixels,
  scores and (sin, cos) within 1e-4, distances within 5e-4 of their largest
  magnitude (f32; XLA rounds the colour reconstruction's divisions one
  unit differently in about a fifth of the pixels);
- ``batch_call`` and ``stream`` under ``yuv420`` on two ``data/synth``
  scenes at 320x480 against ``fots``'s: the same count, corners within
  0.5 px, identical texts, confidences within 1e-3 (the slice test's
  tolerances);
- ``export_serving(platforms=...)`` and ``cli.export -platforms``: a
  ``("cpu",)`` bundle lists cpu and serves, ``cuda`` without a card raises
  and writes nothing, a bundle without the engine's device type is
  refused;
- ``config``: ``Config``, ``PRESETS`` and ``get_config`` field for field;
  ``profiling``: ``StepTimer.summary`` on the same times, ``MetricsLogger``'s
  records but for their ``time``, ``trace``'s file.
"""

import dataclasses
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

import jax

from fots import config as jax_config
from fots import profiling as jax_profiling
from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.pipeline import FOTSInference as JaxInference
from fots_torch import config, profiling
from fots_torch.checkpoint import load_detector
from fots_torch.cli import export as export_cli
from fots_torch.export import MANIFEST, ExportedEngine, export_serving
from fots_torch.imgproc import bgr2yuv_u8, resize_area_u8
from fots_torch.models.detector import FOTSDetector, init_detector
from fots_torch.pipeline import FOTSInference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SCENE_HW = (320, 480)


# --------------------------------------------------------------------------
# the host side: BGR -> YUV and INTER_AREA
# --------------------------------------------------------------------------

@pytest.mark.parametrize("width", [4096, 4093, 31, 7])
def test_bgr2yuv_matches_cv2_on_every_colour(width):
    c = np.arange(1 << 24, dtype=np.uint32)
    c = np.concatenate([c, np.zeros((-c.size) % width, np.uint32)])
    im = np.stack([c & 255, (c >> 8) & 255, c >> 16], axis=-1).astype(np.uint8)
    im = im.reshape(-1, width, 3)
    np.testing.assert_array_equal(bgr2yuv_u8(im), cv2.cvtColor(im, cv2.COLOR_BGR2YUV))


@pytest.mark.parametrize("sizes", ["small", "serving", "integral"])
def test_resize_area_matches_cv2(sizes):
    """``small``: every side 1..13 halved as the transport halves it;
    ``serving``: odd and even letterboxed sizes near 704x1280 halved and
    shrunk by 2/3; ``integral``: factors 1 to 4."""
    rng = np.random.default_rng(7)
    cases = []
    if sizes == "small":
        cases = [((h, w), ((w + 1) // 2, (h + 1) // 2)) for h in range(1, 14)
                 for w in range(1, 14)]
    elif sizes == "serving":
        for h, w in ((351, 639), (352, 640), (351, 640), (703, 1279), (704, 1280), (480, 853)):
            cases += [((h, w), ((w + 1) // 2, (h + 1) // 2)), ((h, w), (w * 2 // 3, h))]
    else:
        cases = [((300, 400), (100, 100)), ((300, 400), (200, 75)), ((96, 64), (64, 32)),
                 ((90, 90), (30, 90)), ((12, 12), (12, 12))]
    for (h, w), dsize in cases:
        im = rng.integers(0, 256, (h, w, 2), dtype=np.uint8)
        want = cv2.resize(im, dsize, interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area_u8(im, dsize), want, err_msg=f"{h}x{w} {dsize}")
    with pytest.raises(ValueError, match="only shrinks"):
        resize_area_u8(np.zeros((4, 4, 2), np.uint8), (8, 2))
    with pytest.raises(ValueError, match=r"u8 \[h, w, 2\]"):
        resize_area_u8(np.zeros((4, 4, 3), np.uint8), (2, 2))


# --------------------------------------------------------------------------
# the yuv420 engines
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_snapshot():
    jm = JaxDetector(nclass=87)
    jv, _ = jax_load_serving_params(SNAPSHOT, jax_init_detector(jm, jax.random.PRNGKey(0)))
    return jm, jv


@pytest.fixture(scope="module")
def port_model():
    model, _, config_ = load_detector(SNAPSHOT, "cpu")
    assert config_["masked_norm"]
    return model


def _blurred(seed, n=2):
    """``fots``'s ``tests/test_pipeline.py`` yuv420 images."""
    rng = np.random.default_rng(seed)
    return [cv2.GaussianBlur(rng.integers(0, 255, (50, 60, 3)).astype(np.uint8), (15, 15), 6)
            for _ in range(n)]


def test_yuv420_letterbox_matches_fots(jax_snapshot, port_model):
    jm, jv = jax_snapshot
    ref = JaxInference(jm, jv, transport="yuv420")
    rng = np.random.default_rng(11)
    shapes = [(50, 60), (61, 77), (130, 97), (96, 128), (17, 250), (33, 9)]
    with FOTSInference(port_model, transport="yuv420", device="cpu") as port:
        assert port.device_letterbox is False
        for serve_hw in ((64, 96), (96, 128)):
            ims = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes] + _blurred(1)
            (y, uv), scales = port._letterbox(ims, serve_hw)
            (want_y, want_uv), want_scales = ref._letterbox(ims, serve_hw)
            assert y.dtype == uv.dtype == np.uint8 and scales == want_scales
            assert uv.shape == (len(ims), serve_hw[0] // 2, serve_hw[1] // 2, 2)
            np.testing.assert_array_equal(y, want_y)
            np.testing.assert_array_equal(uv, want_uv)
    with pytest.raises(ValueError, match="unknown transport"):
        FOTSInference(port_model, transport="rgb", device="cpu")


def test_yuv420_candidates_match_fots(jax_snapshot, port_model):
    jm, jv = jax_snapshot
    ref = JaxInference(jm, jv, transport="yuv420", cand_transport="f32", segm_thresh=-1.0)
    imgs = _blurred(0)
    (y, uv), _ = ref._letterbox(imgs, (64, 64))
    want = np.asarray(ref._dispatch_detect((y, uv))[0])
    with FOTSInference(port_model, transport="yuv420", cand_transport="f32", segm_thresh=-1.0,
                       device="cpu") as port:
        got = port._dispatch_detect((y, uv), (64, 64))[0].numpy()
    assert got.shape == want.shape == (2, 8, 256)
    for g, w in zip(got, want):
        g, w = g[:, np.argsort(g[7])], w[:, np.argsort(w[7])]
        np.testing.assert_array_equal(g[7], w[7])
        assert (w[0] >= 0.0).all()
        for rows, atol in ((slice(0, 1), 1e-4), (slice(1, 5), 5e-4 * np.abs(w[1:5]).max()),
                           (slice(5, 7), 1e-4)):
            np.testing.assert_allclose(g[rows], w[rows], rtol=0, atol=atol)


def _same_results(got, want):
    assert [len(r) for r in got] == [len(r) for r in want]
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g["box"][:8], w["box"][:8], rtol=0, atol=0.5)
            assert g["text"] == w["text"]
            assert abs(g["conf"] - w["conf"]) <= 1e-3


def test_yuv420_serving_matches_fots(jax_snapshot, port_model):
    jm, jv = jax_snapshot
    ims = [cv2.imread(os.path.join(REPO, "data", "synth", f"img_00{i}.jpg")) for i in range(2)]
    ref = JaxInference(jm, jv, masked_norm=True, transport="yuv420")
    want = ref.batch_call(ims, serve_hw=SCENE_HW)
    assert sum(len(r) for r in want) >= 5
    with FOTSInference(port_model, masked_norm=True, transport="yuv420", device="cpu") as port:
        got = port.batch_call(ims, serve_hw=SCENE_HW)
        streamed = list(port.stream(iter([ims, ims[::-1]]), serve_hw=SCENE_HW))
        boxes, _ = port.detect_boxes_batch(port._letterbox(ims, SCENE_HW)[0])
    _same_results(got, want)
    _same_results(streamed[0], got)
    _same_results(streamed[1], got[::-1])
    assert [b.shape[0] for b in boxes] == [len(r) for r in got]


# --------------------------------------------------------------------------
# a bundle for several device types
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_engine():
    model = init_detector(FOTSDetector(), torch.Generator().manual_seed(3))
    with FOTSInference(model, segm_thresh=0.3, device="cpu", device_letterbox=False) as eng:
        eng.strip_buckets = (32,)
        yield eng


@pytest.fixture(scope="module")
def cpu_bundle(tiny_engine, tmp_path_factory):
    out = tmp_path_factory.mktemp("cpu_bundle")
    manifest = export_serving(tiny_engine, str(out), 2, 64, 96, roi_pad=4, platforms=("cpu",))
    return out, manifest


def test_cpu_bundle_lists_cpu_and_serves(tiny_engine, cpu_bundle):
    out, manifest = cpu_bundle
    rng = np.random.default_rng(5)
    ims = [rng.integers(0, 256, (40, 70, 3), dtype=np.uint8) for _ in range(2)]
    assert manifest["platforms"] == ["cpu"]
    assert sorted(os.listdir(out)) == ["detect.cpu.pt2", MANIFEST, "params.npz",
                                       "recognize_32.cpu.pt2"]
    want = tiny_engine.batch_call(ims, serve_hw=(64, 96))
    with tiny_engine.copy_to("cpu") as copy:
        assert copy.model is not tiny_engine.model and copy.strip_buckets == (32,)
        assert copy.segm_thresh == 0.3 and copy._pool is not tiny_engine._pool
        assert [[e["text"] for e in r] for r in copy.batch_call(ims, serve_hw=(64, 96))] == \
            [[e["text"] for e in r] for r in want]
    with ExportedEngine(str(out), device="cpu") as exported:
        got = exported.batch_call(ims)
    assert sum(len(r) for r in want) > 0
    assert [[(e["text"], e["box"].tolist()) for e in r] for r in got] == \
        [[(e["text"], e["box"].tolist()) for e in r] for r in want]


def test_cuda_bundle_without_a_card_raises(tiny_engine, tmp_path):
    out = tmp_path / "b"
    for platforms in (("cuda", "cpu"), ("cuda",)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_serving(tiny_engine, str(out), 2, 64, 96, platforms=platforms)
    for platforms in (("tpu",), ("cpu", "cpu"), ()):
        with pytest.raises(ValueError, match="platforms must be"):
            export_serving(tiny_engine, str(out), 2, 64, 96, platforms=platforms)
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["-model", SNAPSHOT, "-out", str(out), "-platforms", "cuda,cpu"])
    assert not out.exists()


def test_bundle_without_the_engines_device_type_refuses_it(cpu_bundle, tmp_path):
    copy = tmp_path / "cuda_only"
    shutil.copytree(cpu_bundle[0], copy)
    manifest = json.loads(json.dumps(cpu_bundle[1]))
    manifest["platforms"] = ["cuda"]
    for prog in manifest["programs"].values():
        prog["files"] = {"cuda": prog["files"].pop("cpu")}
    with open(copy / MANIFEST, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="exported for cuda and cannot serve on cpu"):
        ExportedEngine(str(copy), device="cpu")


# --------------------------------------------------------------------------
# config presets and profiling helpers
# --------------------------------------------------------------------------

def test_config_matches_fots():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(config.Config)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_config.Config)]
    assert ours == ref and len(ours) == 34
    assert list(config.PRESETS) == list(jax_config.PRESETS)
    for name, preset in config.PRESETS.items():
        assert dataclasses.asdict(preset) == dataclasses.asdict(jax_config.PRESETS[name])
    for args, kwargs in ((("joint_train",), {}), ((), {}), (("crnn_crops",), {"seed": 4}),
                         (("no_such_preset",), {"batch_size": 8, "ohem": True})):
        assert (dataclasses.asdict(config.get_config(*args, **kwargs))
                == dataclasses.asdict(jax_config.get_config(*args, **kwargs)))
    with pytest.raises(TypeError):
        config.get_config(no_such_field=1)


def test_step_timer_and_metrics_logger_match_fots(tmp_path):
    times = list(np.random.default_rng(2).uniform(0.01, 0.2, 37))
    ours, ref = profiling.StepTimer(times=list(times)), jax_profiling.StepTimer(times=list(times))
    assert ours.summary() == ref.summary()
    assert set(ours.summary()) == {"mean_s", "p50_s", "p90_s", "p99_s", "steps_per_s"}
    assert profiling.StepTimer().summary() == jax_profiling.StepTimer().summary() == {}
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert len(timer.times) == 3 and all(t >= 0 for t in timer.times)

    records = [(0, {"loss": 3.5, "lr": np.float32(1e-3)}), (5, {"loss": 2}), (10, {})]
    for module, name in ((profiling, "ours.jsonl"), (jax_profiling, "ref.jsonl")):
        log = module.MetricsLogger(str(tmp_path / name))
        for step, metrics in records:
            log.log(step, **metrics)
        log.close()
    rows = {}
    for name in ("ours.jsonl", "ref.jsonl"):
        with open(tmp_path / name) as f:
            rows[name] = [json.loads(line) for line in f]
    assert all(isinstance(r.pop("time"), float) for v in rows.values() for r in v)
    assert rows["ours.jsonl"] == rows["ref.jsonl"] and len(rows["ours.jsonl"]) == 3


def test_trace_writes_a_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        torch.ones(8).sum()
    assert log_dir == str(tmp_path / "t")
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, files[0])) as f:
        assert "traceEvents" in json.load(f)
