"""The recognition-only CLIs of the port at a tiny size on the CPU
(``-device cpu``), and their refusals.

- ``train_crnn``: 3 steps from scratch with a checkpoint every 2; the
  state restored from ``step_2`` equals the checkpoint bit for bit and a
  resumed run takes ``-max_iters`` more steps.
- The three training CLIs print the step numbers and losses, and label the
  checkpoints, as ``fots``'s CLIs do, across a resume (both driving one
  stand-in trainer).
- ``eval_ocr -arch fots`` with the shipped snapshot over the crop
  archive's eval split, greedy and ``-beam 8``: every crop reads as fots
  reads it (``fots_torch/assets/ocr_eval_fots_cpu.json``, written by
  ``tools/make_torch_ocr_asset.py``); CSV and HTML reports written.
- ``train_ocr`` and ``train_crnn_e2e``: two steps each, finite losses.
- Without CUDA and without ``-device cpu`` every entry point raises; a
  ``-train_list`` that does not exist is refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from fots_torch.checkpoint import checkpoint_payload, read_checkpoint, restore_checkpoint
from fots_torch.cli import eval_ocr, train_crnn, train_crnn_e2e, train_ocr
from fots_torch.train_ocr import CRNNE2ETrainer, CRNNTrainer, FOTSRecognizerTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROPS = os.path.join(REPO, "fots_torch", "assets", "ocr_crops_u8.npz")
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SMOKE = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")


def test_train_crnn_cli_checkpoints_and_resumes_bit_for_bit(tmp_path):
    save = str(tmp_path / "run")
    common = ["-device", "cpu", "-num_readers", "1", "-disp_interval", "1", "-save_path", save]
    trainer = train_crnn.main(common + ["-max_iters", "3", "-checkpoint_every", "2"])
    assert [h["step"] for h in trainer.history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in trainer.history)
    # fots's labels: step_2 after step i = 2 (3 updates), step_3 at the end
    assert sorted(os.listdir(save)) == ["step_2", "step_3"]
    ckpt = os.path.join(save, "step_2")
    payload = read_checkpoint(ckpt)
    fresh = CRNNTrainer(device="cpu")
    assert restore_checkpoint(ckpt, fresh) == 3
    got = checkpoint_payload(fresh.model, fresh.optimizer, fresh.global_step)
    assert set(got) == set(payload)
    for k, v in payload.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # a resumed run takes -max_iters more steps, its updates counted on
    resumed = train_crnn.main(common + ["-max_iters", "2", "-model", ckpt])
    assert [h["step"] for h in resumed.history] == [3, 4]
    assert os.path.isdir(os.path.join(save, "step_2"))


class _FakeTrainer:
    """Stands in for a trainer of either package: a fixed loss sequence, so
    the CLIs' loops are compared on equal numbers."""

    def __init__(self, *args, **kwargs):
        self.n, self.state, self.codec = 0, None, None

    def step(self, batch):
        self.n += 1
        return 4.0 / self.n + 0.125 * (self.n % 3)

    def predict(self, batch):
        return ["ab", "cd", "e"][: 1 + self.n % 3], ["ab", "xd", "e"]


class _FakeBatches:
    def __init__(self, *args, **kwargs):
        self.stopped = False

    def __iter__(self):
        return iter(range(100))

    def stop(self):
        self.stopped = True


@pytest.mark.parametrize("cli", ["train_crnn", "train_ocr", "train_crnn_e2e"])
def test_ocr_cli_steps_prints_and_labels_equal_fots(cli, monkeypatch, capsys):
    """Each recognition CLI numbers its steps, prints its losses and labels
    its checkpoints as ``fots``'s does, from scratch and across a resume
    (``-max_iters`` more steps, ``i`` from 0): both CLIs drive the same
    stand-in trainer, batches and checkpoint writer."""
    import importlib

    import fots.checkpoint
    import fots.data.detection
    import fots.data.ocr_crops
    import fots.train_ocr
    import fots_torch.checkpoint
    import fots_torch.data.detection
    import fots_torch.data.ocr_crops
    import fots_torch.train_ocr

    labels = []

    def save(path, state, step):
        labels.append(step)
        return f"{path}/step_{step}"

    for mod in (fots.train_ocr, fots_torch.train_ocr):
        for name in ("CRNNTrainer", "FOTSRecognizerTrainer", "CRNNE2ETrainer"):
            monkeypatch.setattr(mod, name, _FakeTrainer)
    for mod in (fots.data.ocr_crops, fots_torch.data.ocr_crops):
        monkeypatch.setattr(mod, "ocr_crop_batches", _FakeBatches)
    for mod in (fots.data.detection, fots_torch.data.detection):
        monkeypatch.setattr(mod, "detection_batches", _FakeBatches)
    monkeypatch.setattr(fots.checkpoint, "save_checkpoint", save)
    monkeypatch.setattr(fots.checkpoint, "restore_checkpoint", lambda path, state: (state, 7))
    monkeypatch.setattr(fots_torch.checkpoint, "save_checkpoint", save)
    monkeypatch.setattr(fots_torch.train_ocr, "load_weights", lambda trainer, path: 7)
    fots_cli = importlib.import_module(f"fots.cli.{cli}")
    port_cli = importlib.import_module(f"fots_torch.cli.{cli}")
    extra = (["-train_list", "scenes.txt", "-eval_interval", "3"] if cli == "train_crnn_e2e"
             else [])
    for run in (["-max_iters", "8"], ["-max_iters", "5", "-model", "ckpt/step_6"],
                ["-max_iters", "1"]):
        argv = extra + run + ["-disp_interval", "3", "-checkpoint_every", "2",
                              "-save_path", "ckpt"]
        seen = []
        for main in (fots_cli.main, lambda a: port_cli.main(a + ["-device", "cpu"])):
            labels.clear()
            main(argv)
            out = [line for line in capsys.readouterr().out.splitlines()
                   if line.startswith(("step ", "  eval", "saved ", "resumed "))]
            seen.append((out, list(labels)))
        assert seen[0] == seen[1], (run, seen)
        assert seen[0][0], run


def test_eval_ocr_cli_reads_every_crop_as_fots_does(tmp_path):
    with open(os.path.join(REPO, "fots_torch", "assets", "ocr_eval_fots_cpu.json")) as f:
        ref = json.load(f)["runs"]
    csv, html = str(tmp_path / "r.csv"), str(tmp_path / "r.html")
    for run in ("greedy", "beam8"):
        metrics, crops = eval_ocr.main(["-device", "cpu", "-crops_npz", CROPS, "-model", SNAPSHOT,
                                        "-beam", str(ref[run]["beam"]), "-out_csv", csv,
                                        "-out_html", html])
        assert metrics.total == ref[run]["summary"]["total"] == 58
        assert metrics.correct == ref[run]["correct"]
        assert crops == ref[run]["crops"]
        assert metrics.summary() == ref[run]["summary"]
    assert open(csv).read().startswith("script,accuracy,total")
    assert "<h2>Worst predictions</h2>" in open(html, encoding="utf-8").read()


def test_train_ocr_and_train_crnn_e2e_clis_run_on_cpu(tmp_path):
    rec = train_ocr.main(["-device", "cpu", "-num_readers", "1", "-max_iters", "2",
                          "-batch_size", "4"])
    assert len(rec.history) == 2 and all(np.isfinite(h["loss"]) for h in rec.history)
    with np.load(SMOKE) as z:
        names = [str(n) for n in z["names"]]
    lst = tmp_path / "scenes.txt"
    lst.write_text("".join(os.path.join(REPO, "data", "synth", n) + "\n" for n in names))
    e2e = train_crnn_e2e.main(["-device", "cpu", "-train_list", str(lst), "-images_npz", SMOKE,
                               "-input_size", "256", "-batch_size", "1", "-num_readers", "1",
                               "-max_iters", "2", "-eval_interval", "1",
                               "-save_path", str(tmp_path / "e2e")])
    assert len(e2e.history) == 2 and all(np.isfinite(h["loss"]) for h in e2e.history)
    assert os.path.isdir(tmp_path / "e2e" / "step_2")


def test_ocr_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (CRNNTrainer, FOTSRecognizerTrainer, CRNNE2ETrainer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_crnn.main(["-max_iters", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_ocr.main(["-max_iters", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_ocr.main(["-model", SNAPSHOT])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_crnn_e2e.main(["-train_list", str(tmp_path / "x.txt"), "-images_npz", SMOKE])
    for cli in (train_crnn, train_ocr, eval_ocr):
        with pytest.raises(SystemExit):
            cli.main(["-train_list", str(tmp_path / "gt.txt"), "-device", "cpu"])
