"""The port's entry points from image files and reference weights, against
fots on the CPU (f32).

- ``-h5``: a random state dict under the reference's keys (fots's
  ``reference_key_map``, shapes from fots's ``init_detector`` in torch
  layout, plus a ``num_batches_tracked``, an ``rnn`` and an unknown key) is
  imported by both packages: the same keys imported and skipped, with and
  without ``skip_substrings``; every port parameter is reached; the port's
  weights equal fots's imported ones bit for bit, so the detection maps
  (both scales) and the recognition head's log-probs of the two imports
  agree exactly; against fots's own forward the log-probs agree within 1e-5
  of the tensor's largest magnitude and the detection maps within the
  limits of that test's docstring; a ``torch.save``d file
  reads the same through both ``load_torch_h5``; the snapshot written under
  the reference's keys loads through ``load_engine(h5_path=...)`` into
  exactly the snapshot's weights; ``train_joint -h5`` warm-starts all but
  the vocabulary head (173 imported, 2 skipped).
- Entries from files, on 2 ``data/synth`` scenes at their own size, one
  fots engine for the module: ``eval_e2e -images_list`` gives fots's
  summary and texts (boxes within 0.05 px, as in
  ``test_torch_port_eval.py``; read 1.7e-3), also over two committed
  progressive jpgs and a 16-bit PNG crop; ``cli.detect``'s ``.txt`` rows
  equal ``fots.cli.detect``'s (texts equal, corners and scores within
  1e-3); ``cli.serve -test_folder`` writes what ``-images_npz`` of the
  ``cv2``-decoded pixels writes; ``cli.export``'s ``-selftest`` folder
  reads the ``cv2`` pixels.
- Readers: a ``detection_generator`` batch from the files is byte-equal to
  one from an archive of the ``cv2``-decoded pixels (augmented, and at
  native size without augmentation) and reports its decode time; the
  ``ocr_crop_generator`` over the PNG crop list equals the one over the crop
  archive (colour, with and without augmentation), and its grey crops equal
  fots's generator on the same list; ``train_joint`` and ``train_crnn`` run
  from file lists.
"""

import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fots.checkpoint import import_torch_state_dict as jax_import_state_dict
from fots.checkpoint import load_torch_h5 as jax_load_torch_h5
from fots.checkpoint import reference_key_map as jax_reference_key_map
from fots.cli import detect as jax_detect_cli
from fots.cli import eval_e2e as jax_eval_cli
from fots.codec import LabelCodec as JaxLabelCodec
from fots.data import ocr_crops as jcrops
from fots.models import FOTSDetector as JaxDetector
from fots.models.detector import init_detector as jax_init_detector
from fots.pipeline import device_letterbox_batch as jax_letterbox
from fots_torch import checkpoint as tck
from fots_torch import pipeline as port_pipeline
from fots_torch.cli import detect as port_detect_cli
from fots_torch.cli import eval_e2e as port_eval_cli
from fots_torch.cli import export as export_cli
from fots_torch.cli import serve as serve_cli
from fots_torch.cli import train_crnn, train_joint
from fots_torch.cli.detect import load_engine
from fots_torch.data import ocr_crops as tcrops
from fots_torch.data.detection import detection_generator
from fots_torch.models.detector import FOTSDetector, init_detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SCENES = [os.path.join(REPO, "data", "synth", f"img_00{i}.jpg") for i in range(2)]
SMOKE = [os.path.join(REPO, "data", "synth", f"img_00{i}.jpg") for i in range(4)]
CROPS = os.path.join(REPO, "fots_torch", "assets", "ocr_crops_u8.npz")
PNG_LIST = os.path.join(REPO, "fots_torch", "assets", "ocr_eval_png", "gt.txt")
REL = 1e-5


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _within(got, want, what, rel=REL):
    """|got - want| within ``rel`` of the largest |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


def _write_list(path, files):
    path.write_text("".join(f + "\n" for f in files))
    return str(path)


# --------------------------------------------------------------------------
# -h5: the reference's torch weights
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    model = JaxDetector(nclass=87)
    return model, jax_init_detector(model, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def reference_dict(jax_model):
    """Random weights under every reference key, scaled as an init draws
    them, plus keys the map does not know."""
    _, variables = jax_model
    rng = np.random.default_rng(0)
    sd = {}
    for key, (path, kind) in jax_reference_key_map().items():
        shape = _at(variables["batch_stats" if kind == "stat" else "params"], path).shape
        if kind in ("conv", "dw"):
            kh, kw, i, o = shape
            arr = rng.standard_normal((o, i, kh, kw)) * np.sqrt(1.0 / (kh * kw * i))
        elif key.endswith("running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("weight"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            arr = 0.1 * rng.standard_normal(shape)
        sd[key] = torch.from_numpy(arr.astype(np.float32))
    sd["layer2.0.downsample.1.num_batches_tracked"] = torch.tensor(7)
    sd["rnn.weight_ih_l0"] = torch.zeros(4, 4)
    sd["decoder.weight"] = torch.zeros(3)
    return sd


def test_h5_import_keys_match_fots(jax_model, reference_dict):
    _, variables = jax_model
    for skip in ((), ("conv11", "rnn")):
        _, want_imported, want_skipped = jax_import_state_dict(reference_dict, dict(variables),
                                                               skip_substrings=skip)
        model = FOTSDetector(nclass=87)
        imported, skipped = tck.import_torch_state_dict(reference_dict, model,
                                                        skip_substrings=skip)
        assert imported == want_imported and skipped == want_skipped
    assert len(tck.reference_key_map()) == len(jax_reference_key_map()) == 175
    assert (len(imported), sorted(skipped)) == (173, ["conv11.bias", "conv11.weight",
                                                      "decoder.weight", "rnn.weight_ih_l0"])
    reached = {name for name, _ in tck.reference_key_map().values()}
    assert reached == set(FOTSDetector(nclass=87).state_dict())


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict) else
                   {f"{prefix}/{k}": np.asarray(v)})
    return out


def test_h5_import_outputs_match_fots(jax_model, reference_dict):
    """The port's import equals fots's weight for weight (fots's imported
    flax tree, carried over by the snapshot map, is the same model bit for
    bit), so their outputs agree exactly.  Across the two frameworks, f32
    on the CPU with these random weights: the recognition log-probs and the
    merged features within 1e-5 of each tensor's max (read: 2.4e-6,
    7.2e-6); the detection maps within 5e-5 of theirs (segm and rbox read
    1.8e-5-2.4e-5: forty layers of f32 convolutions in two libraries); the
    angle map, a 2-vector normalised to unit length (which magnifies the
    error where both components are near 0), within 1e-3 (read 3.4e-4)."""
    jm, variables = jax_model
    jv, _, _ = jax_import_state_dict(reference_dict, dict(variables))
    model = init_detector(FOTSDetector(nclass=87), torch.Generator().manual_seed(0))
    tck.import_torch_state_dict(reference_dict, model)
    via_fots = FOTSDetector(nclass=87)
    tck.load_flat(via_fots, {**_flat(jv["params"], "params"),
                             **_flat(jv["batch_stats"], "batch_stats")})
    got_sd, want_sd = model.state_dict(), via_fots.state_dict()
    assert set(got_sd) == set(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)

    raw = np.stack([cv2.imread(p) for p in SCENES])
    x = np.asarray(jax_letterbox(raw, (128, 192)))
    strips = np.random.default_rng(1).standard_normal((4, 11, 48, 64)).astype(np.float32)
    valid_w = np.array([1, 16, 48, 40], np.int32)
    outs = []
    for m in (model.eval(), via_fots.eval()):
        with torch.inference_mode():
            outs.append((m(torch.from_numpy(np.array(x))),
                         m.recognize(torch.from_numpy(strips), torch.from_numpy(valid_w))))
    (got, got_rec), (same, same_rec) = outs
    for k in ("segm", "rbox", "angle"):
        for s in range(2):
            _within(got[k][s].numpy(), same[k][s].numpy(), f"{k}[{s}] via fots's import")
    _within(got_rec.numpy(), same_rec.numpy(), "log-probs via fots's import")

    want = jm.apply(jv, jnp.asarray(x), train=False)
    limits = {"segm": 5e-5, "rbox": 5e-5, "angle": 1e-3}
    for k, rel in limits.items():
        for s in range(2):
            _within(got[k][s].numpy(), want[k][s], f"{k}[{s}]", rel)
    _within(got["features"].numpy(), want["features"], "features")
    want_rec = jm.apply(jv, jnp.asarray(strips), train=False, method=JaxDetector.recognize,
                        valid_w=jnp.asarray(valid_w))
    _within(got_rec.numpy(), want_rec, "recognition log-probs")


def test_h5_file_round_trips_through_both_readers(reference_dict, tmp_path):
    path = str(tmp_path / "ref.h5")
    torch.save({"state_dict": reference_dict, "epoch": 3}, path)
    got, want = tck.load_torch_h5(path), jax_load_torch_h5(path)
    assert list(got) == list(want) == list(reference_dict)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_h5_engine_and_warm_start_from_the_snapshot(tmp_path, capsys):
    snap, _, _ = tck.load_detector(SNAPSHOT, "cpu")
    path = str(tmp_path / "snapshot.h5")
    torch.save({"state_dict": tck.reference_state_dict(snap)}, path)
    with load_engine(h5_path=path, masked_norm=True, device="cpu") as engine:
        assert engine.masked_norm is True
        got, want = engine.model.state_dict(), snap.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert "imported 175 tensors" in capsys.readouterr().out
    _, trainer = train_joint.build(["-train_list", "unused.txt", "-h5", path, "-save_path",
                                    str(tmp_path / "run"), "-device", "cpu"])
    assert f"warm-started 173 tensors from {path} (2 skipped)" in capsys.readouterr().out
    got = trainer.model.state_dict()
    assert torch.equal(got["layer4.3.conv2.pw.weight"], want["layer4.3.conv2.pw.weight"])
    assert not torch.equal(got["ocr.conv11.weight"], want["ocr.conv11.weight"])


# --------------------------------------------------------------------------
# entry points from files, against fots
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine():
    from fots.cli.detect import load_engine as jax_load_engine

    return jax_load_engine(SNAPSHOT)


@pytest.fixture
def fots_uses(monkeypatch, jax_engine):
    monkeypatch.setattr(jax_detect_cli, "load_engine", lambda *a, **k: jax_engine)


@pytest.fixture
def scene_folder(tmp_path):
    folder = tmp_path / "scenes"
    folder.mkdir()
    for p in SCENES:
        shutil.copy(p, folder)
    return str(folder)


def test_eval_e2e_images_list_matches_fots(tmp_path, fots_uses):
    lst = _write_list(tmp_path / "eval.txt", SCENES)
    got_dump, want_dump = tmp_path / "port.json", tmp_path / "fots.json"
    summary = port_eval_cli.main(["-model", SNAPSHOT, "-images_list", lst, "-device", "cpu",
                                  "-dump_json", str(got_dump)])
    jax_eval_cli.main(["-model", SNAPSHOT, "-images_list", lst, "-out_json",
                       str(tmp_path / "fots_summary.json"), "-dump_json", str(want_dump)])
    with open(tmp_path / "fots_summary.json") as f:
        assert summary == json.load(f)
    got, want = json.loads(got_dump.read_text()), json.loads(want_dump.read_text())
    assert [d["image"] for d in got] == [d["image"] for d in want] == SCENES
    for g, w in zip(got, want):
        assert [d["text"] for d in g["detections"]] == [d["text"] for d in w["detections"]]
        np.testing.assert_allclose([d["box"] for d in g["detections"]],
                                   [d["box"] for d in w["detections"]], atol=0.05)
    assert sum(len(d["detections"]) for d in got) >= 8


def test_eval_e2e_progressive_and_16_bit_files_match_fots(tmp_path, fots_uses):
    """``eval_e2e -images_list`` over two committed progressive scenes and a
    16-bit PNG crop of a third: fots reads them with ``cv2.imread``, the port
    with its own decoder, and both give the same summary and texts."""
    prog = os.path.join(REPO, "fots_torch", "assets", "decode_ref", "prog")
    files = []
    for name in ("img_112", "img_113"):
        for f in (f"{name}.jpg", f"gt_{name}.txt"):
            shutil.copy(os.path.join(prog, f), tmp_path)
        files.append(str(tmp_path / f"{name}.jpg"))
    crop = cv2.imread(os.path.join(prog, "img_114.jpg"))[:480, :640].astype(np.uint16) * 257
    crop += np.arange(crop.size, dtype=np.uint16).reshape(crop.shape) % 199  # low bytes
    files.append(str(tmp_path / "img_114_16bit.png"))
    assert cv2.imwrite(files[-1], crop)
    with open(os.path.join(prog, "gt_img_114.txt"), encoding="utf-8") as f:
        kept = [line for line in f if all(
            0 <= float(v) < lim for v, lim in zip(line.split(",")[:8], (640, 480) * 4))]
    assert kept
    (tmp_path / "gt_img_114_16bit.txt").write_text("".join(kept), encoding="utf-8")
    lst = _write_list(tmp_path / "eval.txt", files)
    got_dump, want_dump = tmp_path / "port.json", tmp_path / "fots.json"
    summary = port_eval_cli.main(["-model", SNAPSHOT, "-images_list", lst, "-device", "cpu",
                                  "-dump_json", str(got_dump)])
    jax_eval_cli.main(["-model", SNAPSHOT, "-images_list", lst, "-out_json",
                       str(tmp_path / "fots_summary.json"), "-dump_json", str(want_dump)])
    with open(tmp_path / "fots_summary.json") as f:
        assert summary == json.load(f)
    got, want = json.loads(got_dump.read_text()), json.loads(want_dump.read_text())
    assert [d["image"] for d in got] == [d["image"] for d in want] == files
    for g, w in zip(got, want):
        assert [d["text"] for d in g["detections"]] == [d["text"] for d in w["detections"]]
        np.testing.assert_allclose([d["box"] for d in g["detections"]],
                                   [d["box"] for d in w["detections"]], atol=0.05)
    assert all(len(d["detections"]) >= 1 for d in got)


def test_detect_cli_rows_match_fots(tmp_path, scene_folder, fots_uses, capsys):
    rows = port_detect_cli.main(["-model", SNAPSHOT, "-test_folder", scene_folder, "-output",
                                 str(tmp_path / "port"), "-device", "cpu"])
    printed = capsys.readouterr().out
    assert all(os.path.isfile(tmp_path / "port" / base) for base in rows)
    jax_detect_cli.main(["-model", SNAPSHOT, "-test_folder", scene_folder, "-output",
                         str(tmp_path / "fots")])
    assert sorted(rows) == ["img_000.jpg", "img_001.jpg"]
    for base, got_rows in rows.items():
        # the annotated image: fots's boxes and texts on fots's letterbox,
        # byte for byte, and each text printed
        assert ((tmp_path / "port" / base).read_bytes()
                == (tmp_path / "fots" / base).read_bytes())
        assert all(f"{r.split(',', 9)[9]}\n" in printed for r in got_rows)
        name = os.path.splitext(base)[0] + ".txt"
        with open(tmp_path / "port" / name) as f:
            assert f.read().split("\n") == got_rows
        with open(tmp_path / "fots" / name) as f:
            want_rows = f.read().split("\n")
        assert len(got_rows) == len(want_rows) >= 4
        for g, w in zip(got_rows, want_rows):
            g, w = g.split(",", 9), w.split(",", 9)
            assert g[9] == w[9]
            np.testing.assert_allclose(np.float64(g[:9]), np.float64(w[:9]), atol=1e-3)


def test_serve_cli_test_folder_writes_what_the_archive_run_writes(tmp_path, scene_folder,
                                                                  monkeypatch):
    monkeypatch.setattr(port_pipeline, "FINE_STRIP_BUCKETS", (64, 128))
    archive = tmp_path / "scenes.npz"
    np.savez(archive, images=np.stack([cv2.imread(p) for p in SCENES]),
             names=np.asarray([os.path.basename(p) for p in SCENES]))
    common = ["-model", SNAPSHOT, "-batch", "2", "-height", "320", "-width", "480", "-device",
              "cpu"]
    assert serve_cli.main(common + ["-test_folder", scene_folder, "-output",
                                    str(tmp_path / "files")]) == 2
    assert serve_cli.main(common + ["-images_npz", str(archive), "-output",
                                    str(tmp_path / "npz")]) == 2
    for name in ("img_000.json", "img_001.json"):
        got = json.loads((tmp_path / "files" / name).read_text())
        assert got == json.loads((tmp_path / "npz" / name).read_text()) and got


def test_export_selftest_reads_a_folder_as_cv2(scene_folder, tmp_path):
    want = [cv2.imread(p) for p in SCENES]
    got = export_cli.selftest_images(scene_folder, 8)
    assert len(got) == 2 and all(np.array_equal(g, w) for g, w in zip(got, want))
    archive = str(tmp_path / "a.npz")
    np.savez(archive, images=np.stack(want))
    assert all(np.array_equal(g, w) for g, w in
               zip(export_cli.selftest_images(archive, 1), want[:1]))


# --------------------------------------------------------------------------
# readers from files
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [dict(input_size=256, seed=3),
                                    dict(input_size=-1, in_train=False, augment=False)])
def test_detection_batch_from_files_equals_archive(tmp_path, kwargs):
    lst = _write_list(tmp_path / "l.txt", SCENES)
    archive = str(tmp_path / "px.npz")
    np.savez(archive, images=np.stack([cv2.imread(p) for p in SCENES]),
             names=np.asarray([os.path.basename(p) for p in SCENES]))
    got = next(detection_generator(lst, None, batch_size=2, **kwargs))
    want = next(detection_generator(lst, archive, batch_size=2, **kwargs))
    for k in ("images", "score_maps", "geo_maps", "training_masks", "gt_idxs"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert got.image_fns == want.image_fns and got.labels == want.labels
    assert all(np.array_equal(a, b) for ga, wa in zip(got.gt_quads, want.gt_quads)
               for a, b in zip(ga, wa))
    assert got.decoded >= 2 and 0 < got.decode_s < got.make_s
    assert want.decoded == 0 and want.decode_s == 0
    for batch in (got, want):  # the stages are parts of the batch's making
        assert batch.augment_s > 0 and batch.targets_s > 0
        assert batch.decode_s + batch.augment_s + batch.targets_s < batch.make_s


@pytest.mark.parametrize("in_train", [False, True])
def test_ocr_crops_from_png_list_equal_archive(in_train):
    kw = dict(batch_size=4, norm_height=44, in_train=in_train, seed=5)
    got = tcrops.ocr_crop_generator(None, train_list=PNG_LIST, **kw)
    want = tcrops.ocr_crop_generator(CROPS, split="eval", **kw)
    for _ in range(6 if in_train else 10 ** 6):
        g, w = next(got, None), next(want, None)
        if g is None or w is None:
            assert g is None and w is None
            break
        assert g["texts"] == w["texts"]
        for k in ("images", "labels", "label_lengths"):
            assert np.array_equal(g[k], w[k]), k


def test_grey_ocr_crops_from_png_list_equal_fots():
    got = list(tcrops.ocr_crop_generator(None, train_list=PNG_LIST, batch_size=4,
                                         norm_height=32, rgb=False, in_train=False))
    want = list(jcrops.ocr_crop_generator(PNG_LIST, codec=JaxLabelCodec(), batch_size=4,
                                          norm_height=32, rgb=False, in_train=False))
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert g["texts"] == w["texts"] and g["images"].shape[-1] == 1
        for k in ("images", "labels", "label_lengths"):
            assert np.array_equal(g[k], np.asarray(w[k])), k


def test_training_clis_from_file_lists(tmp_path):
    lst = _write_list(tmp_path / "smoke.txt", SMOKE)
    trainer = train_joint.main(["-train_list", lst, "-save_path", str(tmp_path / "run"),
                                "-batch_size", "2", "-input_size", "128", "-num_readers", "1",
                                "-max_iters", "2", "-checkpoint_every", "10", "-seed", "0",
                                "-device", "cpu"])
    assert [h["step"] for h in trainer.history] == [0, 1] and trainer.dropped_samples == 0
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    crnn = train_crnn.main(["-train_list", PNG_LIST, "-max_iters", "2", "-num_readers", "1",
                            "-batch_size", "4", "-device", "cpu"])
    assert len(crnn.history) == 2 and all(np.isfinite(h["loss"]) for h in crnn.history)
