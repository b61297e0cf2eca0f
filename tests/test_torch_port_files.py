"""The port's entry points from image files, against fots on the CPU (f32).

- Entries from files, on 2 ``data/synth`` scenes at their own size, one
  fots engine for the module: ``eval_e2e -images_list`` gives fots's
  summary and texts (boxes within 0.05 px, as in
  ``test_torch_port_eval.py``; read 1.7e-3), also over two committed
  progressive jpgs and a 16-bit PNG crop; ``cli.detect``'s ``.txt`` rows
  equal ``fots.cli.detect``'s (texts equal, corners and scores within
  1e-3); ``cli.serve -test_folder`` writes what ``-images_npz`` of the
  ``cv2``-decoded pixels writes; ``cli.export``'s ``-selftest`` folder
  reads the ``cv2`` pixels.

The ``-h5`` tests are in ``test_torch_port_files_h5.py`` and the readers'
in ``test_torch_port_files_readers.py``.
"""

import json
import os
import shutil

import cv2
import numpy as np
import pytest

from fots.cli import detect as jax_detect_cli
from fots.cli import eval_e2e as jax_eval_cli
from fots_torch import pipeline as port_pipeline
from fots_torch.cli import detect as port_detect_cli
from fots_torch.cli import eval_e2e as port_eval_cli
from fots_torch.cli import export as export_cli
from fots_torch.cli import serve as serve_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SCENES = [os.path.join(REPO, "data", "synth", f"img_00{i}.jpg") for i in range(2)]


def _write_list(path, files):
    path.write_text("".join(f + "\n" for f in files))
    return str(path)


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
