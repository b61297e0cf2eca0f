"""fots_torch package rules: no JAX or fots imports, CUDA by default, the
kernel wrappers refuse CPU tensors, and the smoke images are the committed
scenes."""

import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from fots_torch.kernels import build
from fots_torch.ops.fused_block import conv_in_act_cuda
from fots_torch.ops.instance_norm import (instance_norm_bwd_cuda, instance_norm_cuda,
                                         spatial_norm_cuda, spatial_stats_cuda)
from fots_torch.ops.rroi_align import pack_neighbors_bwd_cuda, pack_neighbors_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|cv2|fots)(\.|\s|$)",
                       re.MULTILINE)


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fots_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_port_sources_import_no_jax_cv2_or_fots():
    paths = _port_sources()
    assert len(paths) >= 27
    names = {os.path.relpath(p, REPO) for p in paths}
    assert {"fots_torch/ops/fused_block.py", "fots_torch/ops/ctc_decode.py",
            "fots_torch/wordsplit.py", "fots_torch/evaluate.py",
            "fots_torch/data/annotations.py", "fots_torch/cli/detect.py",
            "fots_torch/cli/eval_e2e.py"} <= names
    for path in paths:
        with open(path, encoding="utf-8") as f:
            hits = FORBIDDEN.findall(f.read())
        assert not hits, (path, hits)


def test_importing_the_port_loads_no_jax_or_fots():
    code = (
        "import sys\n"
        "import chip_smoke, fots_torch, fots_torch.pipeline, fots_torch.checkpoint\n"
        "import fots_torch.ops.nms, fots_torch.kernels.build, fots_torch.train\n"
        "import fots_torch.ops.fused_block, fots_torch.ops.ctc_decode\n"
        "import fots_torch.wordsplit, fots_torch.evaluate, fots_torch.profiling\n"
        "import fots_torch.data.annotations, fots_torch.cli.detect\n"
        "import fots_torch.cli.eval_e2e\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'cv2', 'fots')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from fots_torch import resolve_device
    from fots_torch.models import FOTSDetector
    from fots_torch.pipeline import FOTSInference

    from fots_torch.cli.detect import load_engine
    from fots_torch.cli import eval_e2e
    from fots_torch.profiling import profile_fused_block

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FOTSInference(FOTSDetector())
    snapshot = os.path.join(REPO, "artifacts", "serving_params.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_engine(snapshot)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_e2e.main(["-model", snapshot, "-images_npz",
                       os.path.join(REPO, "fots_torch", "assets", "heldout_eval_u8.npz")])
    with pytest.raises(RuntimeError, match="needs a card"):
        profile_fused_block(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrappers_refuse_cpu_tensors(dtype):
    x = torch.zeros((1, 4, 8, 64), dtype=dtype)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        instance_norm_cuda(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pack_neighbors_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spatial_stats_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_in_act_cuda(x, torch.zeros((3, 3, 64, 64)), torch.ones(64), torch.zeros(64), x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spatial_norm_cuda(x, torch.zeros((1, 4, 64)), 0.01, 2)
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="CUDA tensor"):
            instance_norm_bwd_cuda(x, x, torch.zeros((1, 2, 64)), torch.ones(64),
                                   torch.zeros(64))
        with pytest.raises(ValueError, match="CUDA tensor"):
            pack_neighbors_bwd_cuda(torch.zeros((32, 256)), (1, 4, 8, 64))
    assert build.launch_counts == before


def test_builds_are_keyed_by_source_and_flags():
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert os.path.dirname(path) == build.BUILD_DIR
        assert re.fullmatch(rf"lib{name}_[0-9a-f]{{16}}\.so", os.path.basename(path))
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_concurrent_first_loads_build_once(tmp_path, monkeypatch):
    """The NMS pool's threads may ask for the host library at once on a
    fresh checkout: every thread must get the one built library."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_loaded", {})
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda _: build.load("nms_core"), range(4)))
    assert all(lib is libs[0] for lib in libs)
    assert os.listdir(tmp_path) == [os.path.basename(build.library_path("nms_core"))]


def test_smoke_images_are_the_committed_scenes():
    with np.load(os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")) as z:
        images, names = z["images"], [str(n) for n in z["names"]]
    assert images.shape == (4, 640, 960, 3) and images.dtype == np.uint8
    for im, name in zip(images, names):
        np.testing.assert_array_equal(
            im, cv2.imread(os.path.join(REPO, "data", "synth", name)))


def test_heldout_eval_asset_is_the_decoded_scene_list():
    """The evaluation asset names the 16 scenes of data/synth_big_eval.txt in
    order, carries one annotation per scene, and fots's stored result covers
    the same scenes in all four runs."""
    import json

    with np.load(os.path.join(REPO, "fots_torch", "assets", "heldout_eval_u8.npz")) as z:
        images, names = z["images"], [str(n) for n in z["names"]]
        gt_names, gt_texts = [str(n) for n in z["gt_names"]], [str(t) for t in z["gt_texts"]]
    assert images.shape == (16, 640, 960, 3) and images.dtype == np.uint8
    with open(os.path.join(REPO, "data", "synth_big_eval.txt")) as f:
        listed = [os.path.basename(line.strip()) for line in f if line.strip()]
    assert [os.path.basename(n) for n in names] == listed
    assert [os.path.basename(n) for n in gt_names] == [
        "gt_" + os.path.splitext(n)[0] + ".txt" for n in listed]
    assert all(t.strip() for t in gt_texts)
    with open(os.path.join(REPO, "fots_torch", "assets", "heldout_eval_fots_cpu.json")) as f:
        ref = json.load(f)
    assert set(ref["runs"]) == {"per_image", "serve_704x1280", "beam8", "split_words"}
    for run in ref["runs"].values():
        assert [r["image"] for r in run["images"]] == names
        assert run["counts"]["gt"] == 58 and run["counts"]["tp"] >= 50


def test_profile_summary_drops_device_annotations():
    """A record_function range on the device timeline (Adam's step) is no
    device work: it is neither counted as a launch nor put in the busy
    union, whose gap between two kernels stays idle.  A kernel whose name
    holds a lambda's ``#`` is kept."""
    from types import SimpleNamespace

    from fots_torch import profiling

    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, start, end, device=cuda, annotation=False):
        return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [ev("Optimizer.step#Adam.step", 0.0, 1000.0, annotation=True),
              ev("ProfilerStep#3", 0.0, 1000.0),
              ev("void multi_tensor_apply_kernel<TensorListMetadata<4>>", 0.0, 100.0),
              ev("void fots_in_stats_kernel<float>", 900.0, 1000.0),
              ev("void at::native::vectorized_elementwise_kernel<4, "
                 "at::native::{lambda(float)#1}>(int, float*)", 950.0, 1000.0),
              ev("aten::add_", 0.0, 1000.0, device=torch.autograd.DeviceType.CPU)]
    out = profiling._summary(events, wall=2e-3, batches=1)
    assert out["kernel_launches_per_batch"] == 3
    assert out["device_busy_ms_per_batch"] == pytest.approx(0.2)
    assert out["device_idle_share"] == pytest.approx(0.9)
    assert out["ms_per_batch_by_category"] == pytest.approx(
        {"optimizer": 0.1, "instance_norm (K1')": 0.1, "elementwise": 0.05})
