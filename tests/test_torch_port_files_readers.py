"""The port's readers from image files, against their archive runs and fots
on the CPU.

- Readers: a ``detection_generator`` batch from the files is byte-equal to
  one from an archive of the ``cv2``-decoded pixels (augmented, and at
  native size without augmentation) and reports its decode time; the
  ``ocr_crop_generator`` over the PNG crop list equals the one over the crop
  archive (colour, with and without augmentation), and its grey crops equal
  fots's generator on the same list; ``train_joint`` and ``train_crnn`` run
  from file lists.

Split from ``test_torch_port_files.py`` so that a distributed run can
balance its sections; the tests kept their names.
"""

import os

import cv2
import numpy as np
import pytest

from fots.codec import LabelCodec as JaxLabelCodec
from fots.data import ocr_crops as jcrops
from fots_torch.cli import train_crnn, train_joint
from fots_torch.data import ocr_crops as tcrops
from fots_torch.data.detection import detection_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = [os.path.join(REPO, "data", "synth", f"img_00{i}.jpg") for i in range(2)]
SMOKE = [os.path.join(REPO, "data", "synth", f"img_00{i}.jpg") for i in range(4)]
CROPS = os.path.join(REPO, "fots_torch", "assets", "ocr_crops_u8.npz")
PNG_LIST = os.path.join(REPO, "fots_torch", "assets", "ocr_eval_png", "gt.txt")


def _write_list(path, files):
    path.write_text("".join(f + "\n" for f in files))
    return str(path)


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
