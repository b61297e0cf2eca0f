"""The exported serving bundle of the port against the in-process port and
against fots, on the CPU.

One bundle is exported from the shipped snapshot in f32 at batch 2, 640x960
(the ``data/synth`` scenes' own size), with the strip buckets cut to
(64, 128) on every engine (masked IN makes a strip independent of its
bucket's width, and every box of the two scenes fits 128 frames).  Held to:

- the port's in-process ``batch_call`` with the host letterbox: the same
  boxes within 1e-5 px, identical texts, confidences within 1e-6 (the
  in-process engine batches a bucket's rois in chunks of another size);
- ``fots``'s ``FOTSInference.batch_call`` on the same weights and pixels at
  the slice test's tolerances: the same count, corners within 0.5 px,
  identical texts, confidences within 1e-3.

Also: the ``ignore_case`` codec against ``fots``'s, the five registered ops
against their plain versions (and ``torch.library.opcheck``), the host
letterbox and the box cap on a tiny seeded engine, the manifest and every
refusal, a fresh process that serves the bundle without importing
``fots_torch.models``, and the two CLIs.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import zipfile

import cv2
import numpy as np
import pytest
import torch

import jax

from fots.checkpoint import load_serving_params as jax_load_serving_params
from fots.codec import LabelCodec as JaxCodec
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.pipeline import FOTSInference as JaxInference
from fots_torch import pipeline as port_pipeline
from fots_torch.checkpoint import load_detector
from fots_torch.cli import export as export_cli
from fots_torch.cli import serve as serve_cli
from fots_torch.codec import LabelCodec
from fots_torch.export import FORMAT, MANIFEST, ExportedEngine, export_serving
from fots_torch.models.detector import FOTSDetector, init_detector
from fots_torch.ops import instance_norm as tin
from fots_torch.ops import rroi_align as trr
from fots_torch.pipeline import FOTSInference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SERVE_HW = (640, 960)
BUCKETS = (64, 128)
FOTS_MANIFEST_KEYS = {"format", "jax_version", "platforms", "batch", "height", "width",
                      "max_candidates", "strip_buckets", "roi_pad", "target_h", "segm_thresh",
                      "iou_th1", "iou_th2", "expand_w_frac", "mixed_precision", "masked_norm",
                      "max_boxes", "codec", "param_dtypes", "programs"}


@pytest.fixture(scope="module")
def images():
    return [cv2.imread(os.path.join(REPO, "data", "synth", f"img_00{i}.jpg"))
            for i in range(2)]


@pytest.fixture(scope="module")
def port():
    model, _, config = load_detector(SNAPSHOT, "cpu")
    with FOTSInference(model, masked_norm=config["masked_norm"], device="cpu",
                       device_letterbox=False) as eng:
        eng.strip_buckets = BUCKETS
        yield eng


@pytest.fixture(scope="module")
def bundle(port, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bundle"))
    manifest = export_serving(port, out, 2, *SERVE_HW, platforms=("cpu",))
    return out, manifest


@pytest.fixture(scope="module")
def served(bundle, images):
    with ExportedEngine(bundle[0], device="cpu") as exported:
        return exported.batch_call(images)


def _assert_same(got, want, box_atol, conf_atol):
    assert [len(r) for r in got] == [len(r) for r in want]
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g["text"] == w["text"]
            np.testing.assert_allclose(g["box"][:8], w["box"][:8], rtol=0, atol=box_atol)
            assert abs(g["conf"] - w["conf"]) <= conf_atol


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------

def test_ignore_case_codec_matches_fots():
    ours, ref = LabelCodec(ignore_case=True), JaxCodec(ignore_case=True)
    assert ours.alphabet == ref.alphabet and ours.num_classes == ref.num_classes
    texts = ["PLAZA", "Coffee", "tIcKeTs #7", "ÉCOLE", ""]
    for got, want in zip(ours.encode(texts), ref.encode(texts)):
        np.testing.assert_array_equal(got, want)
    ids = np.random.default_rng(0).integers(0, ours.num_classes + 3, (64, 40))
    assert ours.decode_batch(ids) == ref.decode_batch(ids)
    assert LabelCodec().alphabet != ours.alphabet


def test_engine_takes_a_codec():
    codec = LabelCodec(ignore_case=True)
    eng = FOTSInference(FOTSDetector(), device="cpu", codec=codec)
    with eng:
        assert eng.codec is codec
    with FOTSInference(FOTSDetector(), device="cpu") as eng:
        assert eng.codec.alphabet == LabelCodec().alphabet


# --------------------------------------------------------------------------
# the registered ops
# --------------------------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(1)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(1.0, 2.0, shape).astype(np.float32)).to(dtype)

    x = t(2, 5, 7, 32)
    sc, bi = t(32), t(32)
    vw = torch.tensor([3, 7], dtype=torch.int32)
    xs = t(2, 6, 8, 16, dtype=torch.bfloat16)
    vecs = t(2, 4, 16)
    return {
        "instance_norm": (torch.ops.fots_torch.instance_norm, (x, sc, bi, 1e-5, 0.01, None),
                          tin.instance_norm_ref(x, sc, bi, 1e-5, 0.01)),
        "instance_norm_masked": (torch.ops.fots_torch.instance_norm,
                                 (x, sc, bi, 1e-5, None, vw),
                                 tin.masked_instance_norm_ref(x, vw, sc, bi, 1e-5, None)),
        "instance_norm_stats": (torch.ops.fots_torch.instance_norm_stats,
                                (x, sc, bi, 1e-5, 0.01, vw),
                                (tin.masked_instance_norm_ref(x, vw, sc, bi, 1e-5, 0.01),
                                 tin.instance_norm_stats_ref(x, 1e-5, vw))),
        "spatial_stats": (torch.ops.fots_torch.spatial_stats, (xs,),
                          tin.spatial_stats_ref(xs)),
        "spatial_norm": (torch.ops.fots_torch.spatial_norm, (xs, vecs, 0.01, 2),
                         tin.spatial_norm_ref(xs, vecs, 0.01, 2)),
        "pack_neighbors": (torch.ops.fots_torch.pack_neighbors, (xs,),
                           trr.pack_neighbors_ref(xs)),
    }


@pytest.mark.parametrize("case", ["instance_norm", "instance_norm_masked",
                                  "instance_norm_stats", "spatial_stats", "spatial_norm",
                                  "pack_neighbors"])
def test_registered_op_is_its_plain_version(case):
    op, args, want = _op_cases()[case]
    got = op(*args)
    for g, w in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    torch.library.opcheck(op, args)


def test_no_grad_paths_call_the_registered_ops():
    """An exported program holds one node per serving kernel call."""
    model = FOTSDetector().eval()
    x = torch.zeros((1, 64, 64, 3))
    with torch.no_grad():
        ep = torch.export.export(_ForwardPack(model), (x,), strict=False)
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert {"fots_torch.instance_norm.default", "fots_torch.spatial_stats.default",
            "fots_torch.spatial_norm.default", "fots_torch.pack_neighbors.default"} <= targets


class _ForwardPack(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return trr.pack_neighbors(self.model(x)["focr"])


# --------------------------------------------------------------------------
# the bundle
# --------------------------------------------------------------------------

def test_bundle_matches_the_in_process_port(port, served, images):
    want = port.batch_call(images, serve_hw=SERVE_HW)
    assert sum(len(r) for r in want) >= 5
    _assert_same(served, want, box_atol=1e-5, conf_atol=1e-6)


def test_bundle_matches_fots(bundle, served, images):
    jm = JaxDetector(nclass=87)
    jv, _ = jax_load_serving_params(SNAPSHOT, jax_init_detector(jm, jax.random.PRNGKey(0)))
    ref = JaxInference(jm, jv, masked_norm=bundle[1]["masked_norm"], cand_transport="u16")
    ref.strip_buckets = BUCKETS
    want = ref.batch_call(images, serve_hw=SERVE_HW)
    assert sum(len(r) for r in want) >= 5
    _assert_same(served, want, box_atol=0.5, conf_atol=1e-3)


def test_manifest(bundle, port):
    out, manifest = bundle
    with open(os.path.join(out, MANIFEST)) as f:
        assert json.load(f) == manifest
    renamed = (FOTS_MANIFEST_KEYS - {"jax_version"}) | {"torch_version"}
    assert set(manifest) == renamed
    assert manifest["format"] == FORMAT == "fots-torch-serving-v2"
    assert manifest["torch_version"] == torch.__version__ and manifest["platforms"] == ["cpu"]
    assert (manifest["batch"], manifest["height"], manifest["width"]) == (2, *SERVE_HW)
    assert manifest["strip_buckets"] == list(BUCKETS) and manifest["roi_pad"] == 32
    assert manifest["masked_norm"] is True and manifest["mixed_precision"] is False
    assert manifest["codec"] == {"type": "LabelCodec", "alphabet": LabelCodec().alphabet,
                                 "ignore_case": False}
    assert manifest["max_candidates"] == port.max_candidates
    assert set(manifest["param_dtypes"]) == set(port.model.state_dict())
    progs = manifest["programs"]
    assert sorted(progs) == ["detect", "recognize_128", "recognize_64"]
    assert all(p["files"] == {"cpu": f"{name}.cpu.pt2"} for name, p in progs.items())
    assert progs["detect"]["candidates"] == [[2, 8, port.max_candidates], "int16"]
    assert progs["detect"]["quads"] == [[2 * 160 * 240, 256], "float32"]


def test_no_program_carries_a_tensor(bundle):
    out, _ = bundle
    weights = os.path.getsize(os.path.join(out, "params.npz"))
    programs = [f for f in os.listdir(out) if f.endswith(".pt2")]
    assert len(programs) == 3
    for fname in programs:
        path = os.path.join(out, fname)
        assert os.path.getsize(path) < weights / 8
        with zipfile.ZipFile(path) as z:
            data = [i.filename for i in z.infolist()
                    if re.search(r"(^|/)data/(weights|constants|sample_inputs)/", i.filename)
                    and not i.filename.endswith(".json") and i.file_size > 0]
        assert data == []
        ep = torch.export.load(path)
        assert not ep.state_dict and not ep.constants and ep.example_inputs is None
    with np.load(os.path.join(out, "params.npz")) as z:
        assert all(z[k].dtype == np.float32 for k in z.files)


def test_bundle_refuses_another_device_or_format(bundle, tmp_path):
    out, manifest = bundle
    for key, value, match in (("platforms", ["cuda"], "exported for cuda"),
                              ("format", "fots-serving-v1", "not a fots_torch serving bundle")):
        copy = tmp_path / key
        shutil.copytree(out, copy)
        with open(copy / MANIFEST, "w") as f:
            json.dump({**manifest, key: value}, f)
        with pytest.raises(ValueError, match=match):
            ExportedEngine(str(copy), device="cpu")


def test_export_refusals(port, tmp_path):
    with pytest.raises(ValueError, match="/32 multiples"):
        export_serving(port, str(tmp_path), 1, 100, 96)
    codec = port.codec
    try:
        port.codec = LabelCodec(alphabet="abc")
        with pytest.raises(ValueError, match="vocab head"):
            export_serving(port, str(tmp_path), 1, 64, 96)
        port.codec = JaxCodec()
        with pytest.raises(ValueError, match="supports LabelCodec"):
            export_serving(port, str(tmp_path), 1, 64, 96)
    finally:
        port.codec = codec
    assert os.listdir(tmp_path) == []


def test_bundle_served_in_a_fresh_process(bundle, served, tmp_path):
    """The runtime serves from the bundle without the model definition."""
    out = tmp_path / "served.json"
    code = (
        "import json, sys, cv2\n"
        "from fots_torch.export import ExportedEngine\n"
        f"ims = [cv2.imread('{REPO}/data/synth/img_00%d.jpg' % i) for i in range(2)]\n"
        f"with ExportedEngine({bundle[0]!r}, device='cpu') as eng:\n"
        "    res = eng.batch_call(ims)\n"
        "models = [m for m in sys.modules if m.startswith('fots_torch.models')]\n"
        f"json.dump({{'models': models, 'res': [[[e['text'], e['conf'], e['box'].tolist()]"
        f" for e in r] for r in res]}}, open({str(out)!r}, 'w'))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(out) as f:
        got = json.load(f)
    assert got["models"] == []
    assert [[t for t, _, _ in r] for r in got["res"]] == [[e["text"] for e in r] for r in served]
    for g_img, w_img in zip(got["res"], served):
        for (_, conf, box), w in zip(g_img, w_img):
            assert conf == w["conf"] and box == w["box"].tolist()


def test_letterbox_and_box_cap_on_a_tiny_engine(tmp_path):
    """Images smaller than the serving size go through the host letterbox,
    the manifest's box cap applies; random weights from a seed."""
    model = init_detector(FOTSDetector(), torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    ims = [rng.integers(0, 256, (40, 70, 3), dtype=np.uint8),
           rng.integers(0, 256, (50, 44, 3), dtype=np.uint8)]
    with FOTSInference(model, segm_thresh=0.3, device="cpu", device_letterbox=False,
                       max_boxes=2) as eng:
        eng.strip_buckets = (32,)
        export_serving(eng, str(tmp_path), 2, 64, 96, roi_pad=4, platforms=("cpu",))
        want = eng.batch_call(ims, serve_hw=(64, 96))
    with ExportedEngine(str(tmp_path), device="cpu") as exported:
        assert exported.serve_hw == (64, 96)
        got = exported.batch_call(ims)
        with pytest.raises(ValueError, match="exported batch"):
            exported.batch_call(ims * 2)
    assert 0 < sum(len(r) for r in want) <= 4
    _assert_same(got, want, box_atol=1e-5, conf_atol=1e-6)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.fixture()
def archive(images, tmp_path):
    path = tmp_path / "two.npz"
    np.savez(path, images=np.stack(images), names=np.array(["a/img_000.jpg", "a/img_001.jpg"]))
    return str(path)


def test_export_cli_selftest(archive, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port_pipeline, "FINE_STRIP_BUCKETS", BUCKETS)
    out = str(tmp_path / "b")
    manifest = export_cli.main(["-model", SNAPSHOT, "-out", out, "-batch", "2", "-height",
                                "320", "-width", "480", "-platforms", "cpu", "-selftest",
                                archive])
    assert manifest["max_candidates"] == 1024 and manifest["mixed_precision"] is True
    assert manifest["strip_buckets"] == list(BUCKETS)
    text = capsys.readouterr().out
    assert re.search(r"selftest ok: [1-9]\d* boxes identical across 2 images on cpu", text)
    for fname in ("detect.cpu.pt2", "params.npz", "manifest.json"):
        assert f"{fname}: " in text
    with pytest.raises(SystemExit):  # -out is required
        export_cli.main(["-h5", "w.h5"])


def test_serve_cli_writes_what_stream_returns(archive, tmp_path, monkeypatch):
    monkeypatch.setattr(port_pipeline, "FINE_STRIP_BUCKETS", BUCKETS)
    out = tmp_path / "json"
    args = ["-model", SNAPSHOT, "-images_npz", archive, "-output", str(out), "-batch", "2",
            "-height", "320", "-width", "480", "-device", "cpu"]
    assert serve_cli.main(args) == 2
    with np.load(archive) as z:
        ims = list(z["images"])
    from fots_torch.cli.detect import load_engine
    with load_engine(SNAPSHOT, mixed_precision=True, device="cpu") as eng:
        (_, res), = list(eng.stream(iter([(None, ims)]), serve_hw=(320, 480),
                                    with_context=True))
    assert sorted(os.listdir(out)) == ["img_000.json", "img_001.json"]
    for name, r in zip(("img_000", "img_001"), res):
        with open(out / f"{name}.json") as f:
            assert json.load(f) == [{"box": e["box"].tolist(), "text": e["text"]} for e in r]
    assert sum(len(r) for r in res) > 0
    for bad in (["-n_data", "2"], ["-n_model", "2"]):
        with pytest.raises(SystemExit):
            serve_cli.main(args + bad)
