"""The port's image writers and the entry points that write images, against
OpenCV and fots (CPU).

- ``imageio.imencode_jpg`` is ``cv2.imencode(".jpg")`` byte for byte: seeded
  noise at sizes on and off the 8 and 16 pixel MCU grids, grey and BGR;
  smooth gradients; the 16 held-out scenes; ``imwrite`` writes
  ``cv2.imwrite``'s file and refuses any extension but JPEG's.  The
  committed references under ``fots_torch/assets/encode_ref/`` (what
  ``chip_smoke.py`` holds on the card) are ``cv2.imwrite``'s bytes of their
  sources.
- Drawing, byte for byte with cv2: ``polylines`` (boxes inside, across and
  past the edges), ``get_rotation_matrix_2d`` (f64 equality), the JET table
  and ``applyColorMap``, ``add_weighted_u8`` on every pair of u8 values.
- ``debug_vis`` against ``fots.debug_vis`` on the same rois: crops equal,
  files equal byte for byte under the same names.
- ``cli.detect -device cpu`` over two held-out scenes: each annotated
  ``.jpg`` is ``cv2.polylines`` and ``cv2.putText`` of the port's own rows,
  in ``fots``'s order, on the port's own letterboxed image, written by
  ``cv2.imwrite`` (``put_text`` itself: ``tests/test_torch_port_text.py``).
- ``train_joint -debug -device cpu``, 2 steps: every dump equals, name and
  bytes, what ``fots``'s hook writes from the same images and rois.
"""

import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

from fots import debug_vis as fots_vis
from fots.codec import LabelCodec as JaxLabelCodec
from fots.roirotate import RoiBatch as JaxRoiBatch
from fots_torch import debug_vis as port_vis
from fots_torch import imgproc, tracing
from fots_torch.codec import LabelCodec
from fots_torch.data.annotations import load_annotation
from fots_torch.geometry import quads_to_rrois
from fots_torch.imageio import imencode_jpg, imread, imwrite
from fots_torch.roirotate import RoiBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELDOUT = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_jpg")
SCENES = sorted(glob.glob(os.path.join(HELDOUT, "img_*.jpg")))
ENCODE_REF = os.path.join(REPO, "fots_torch", "assets", "encode_ref")
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs six workers on the cores,
    where torch's default of a thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _gradient(channels):
    yy, xx = np.mgrid[0:123, 0:171]
    planes = [(xx * 1.5) % 256, (yy * 2.0) % 256, (xx + yy) % 256][:channels]
    im = np.stack(planes, -1).astype(np.uint8)
    return im[..., 0] if channels == 1 else im


_NOISE = [(h, w, c) for (h, w) in ((1, 1), (7, 9), (8, 16), (16, 16), (17, 17), (37, 53),
                                   (64, 48), (33, 100), (100, 33), (15, 31))
          for c in (1, 3)]
ENCODE_CASES = ([f"noise-{h}x{w}x{c}" for h, w, c in _NOISE] + ["gradient-1", "gradient-3"]
                + [f"scene-{os.path.basename(p)}" for p in SCENES])


def _encode_case(name):
    kind, spec = name.split("-", 1)
    if kind == "noise":
        h, w, c = (int(v) for v in spec.split("x"))
        return _noise((h, w) if c == 1 else (h, w, c), seed=h * 1000 + w * 10 + c)
    if kind == "gradient":
        return _gradient(int(spec))
    return cv2.imread(os.path.join(HELDOUT, spec))


@pytest.mark.parametrize("case", ENCODE_CASES)
def test_imencode_jpg_equals_cv2(case):
    im = _encode_case(case)
    assert imencode_jpg(im) == cv2.imencode(".jpg", im)[1].tobytes()


def test_imwrite_equals_cv2_and_refuses_other_formats(tmp_path):
    im = _noise((29, 41, 3), seed=7)
    assert imwrite(str(tmp_path / "a.jpg"), im)
    cv2.imwrite(str(tmp_path / "b.jpg"), im)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    assert np.array_equal(imread(str(tmp_path / "a.jpg")), cv2.imread(str(tmp_path / "b.jpg")))
    for bad in ("a.png", "a.bmp", "a"):
        with pytest.raises(ValueError):
            imwrite(str(tmp_path / bad), im)
    with pytest.raises(TypeError):
        imencode_jpg(im.astype(np.float32))


def test_committed_encode_refs_are_cv2s_bytes():
    with np.load(os.path.join(ENCODE_REF, "sources.npz")) as z:
        sources = {k: z[k] for k in z.files}
    with np.load(os.path.join(REPO, "fots_torch", "assets", "heldout_eval_u8.npz")) as z:
        sources["img_112"] = z["images"][0]
    with open(os.path.join(ENCODE_REF, "manifest.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest) == sorted(sources)
    for name, entry in manifest.items():
        with open(os.path.join(ENCODE_REF, entry["file"]), "rb") as f:
            ref = f.read()
        assert ref == cv2.imencode(".jpg", sources[name])[1].tobytes(), name
        assert imencode_jpg(sources[name]) == ref, name


@pytest.mark.parametrize("seed", range(4))
def test_polylines_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        img = rng.integers(0, 4, (h, w, 3)).astype(np.uint8)
        n = int(rng.integers(2, 6))
        lo, hi = (-40, 110) if rng.random() < 0.5 else (0, min(h, w))  # across and past the edges
        pts = rng.integers(lo, hi, (n, 2)).astype(np.int32)
        want = cv2.polylines(img.copy(), [pts], True, (0, 255, 0), 1)
        got = imgproc.polylines(img.copy(), pts, (0, 255, 0))
        assert np.array_equal(got, want), (h, w, pts.tolist())
    grey = np.zeros((30, 40), np.uint8)
    quad = np.int32([[3, 4], [35, 2], [38, 29], [1, 25]])
    assert np.array_equal(imgproc.polylines(grey.copy(), quad, 200),
                          cv2.polylines(grey.copy(), [quad], True, 200, 1))


def test_rotation_matrix_jet_and_add_weighted_equal_cv2():
    rng = np.random.default_rng(0)
    for _ in range(200):
        center = tuple(float(v) for v in rng.uniform(-500, 1500, 2))
        angle, scale = float(rng.uniform(-180, 180)), float(rng.uniform(0.05, 4))
        want = cv2.getRotationMatrix2D(center, angle, scale)
        got = imgproc.get_rotation_matrix_2d(center, angle, scale)
        assert got.dtype == want.dtype and np.array_equal(got, want), (center, angle, scale)
    levels = np.arange(256, dtype=np.uint8)
    assert np.array_equal(imgproc.JET_LUT, cv2.applyColorMap(levels[None], cv2.COLORMAP_JET)[0])
    g = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    assert np.array_equal(imgproc.apply_color_map_jet(g), cv2.applyColorMap(g, cv2.COLORMAP_JET))
    a = np.repeat(levels, 256).reshape(256, 256)
    b = np.tile(levels, 256).reshape(256, 256)
    for alpha, beta in ((0.6, 0.4), (0.3, 0.7), (0.123, 0.877), (0.5, 0.5)):
        for shape in ((256, 256), (65536 // 7, 7)):  # a row's vector body and its tail
            x = a.reshape(-1)[:shape[0] * shape[1]].reshape(shape)
            y = b.reshape(-1)[:shape[0] * shape[1]].reshape(shape)
            assert np.array_equal(imgproc.add_weighted_u8(x, alpha, y, beta),
                                  cv2.addWeighted(x, alpha, y, beta, 0))
    im, heat = rng.integers(0, 256, (2, 41, 67, 3)).astype(np.uint8)
    assert np.array_equal(imgproc.add_weighted_u8(im, 0.6, heat, 0.4),
                          cv2.addWeighted(im, 0.6, heat, 0.4, 0))


def _roi_batches(n_predicted=2):
    """The same rois as a port and a fots RoiBatch: two held-out scenes'
    ground-truth words, some rotated, and padding slots."""
    rows, labels, lengths = [], [], []
    codec = LabelCodec()
    for b, path in enumerate(SCENES[:2]):
        polys, tags, texts = load_annotation(path, (640, 960, 3))
        keep = [i for i, t in enumerate(tags) if not t][:5]
        rois = quads_to_rrois(np.asarray(polys)[keep], batch_idx=b)
        rois[::2, 5] += 7.5  # rotate some
        rows.append(rois)
        ids, n = codec.encode_padded([texts[i] for i in keep], 16)
        labels += list(ids)
        lengths += [int(v) for v in n]
    rois = np.concatenate(rows).astype(np.float32)
    k = len(rois)
    pad = 3
    arrays = dict(rois=np.concatenate([rois, np.zeros((pad, 6), np.float32)]),
                  labels=np.concatenate([np.asarray(labels, np.int32),
                                         np.zeros((pad, 16), np.int32)]),
                  label_lengths=np.asarray(lengths + [0] * pad, np.int32),
                  roi_mask=np.asarray([1.0] * k + [0.0] * pad, np.float32),
                  strip_width=64, n_predicted=n_predicted, n_gt=k - n_predicted)
    return RoiBatch(**arrays), JaxRoiBatch(**arrays)


def test_debug_vis_equals_fots(tmp_path):
    images = np.stack([cv2.imread(p) for p in SCENES[:2]])
    port_rois, jax_rois = _roi_batches()
    for j in range(len(port_rois.rois)):
        if port_rois.roi_mask[j] > 0:
            roi = port_rois.rois[j]
            want = fots_vis.crop_rroi_image(images[int(roi[0])], roi)
            assert np.array_equal(port_vis.crop_rroi_image(images[int(roi[0])], roi), want)
    for name, batch in (("u8", images), ("normalised", images / 128.0 - 1.0)):
        n_port = port_vis.dump_roi_crops(batch, port_rois, LabelCodec(), str(tmp_path / name / "p"),
                                         12)
        n_fots = fots_vis.dump_roi_crops(batch, jax_rois, JaxLabelCodec(),
                                         str(tmp_path / name / "f"), 12)
        assert n_port == n_fots == int(port_rois.roi_mask.sum())
        names = sorted(os.listdir(tmp_path / name / "f"))
        assert sorted(os.listdir(tmp_path / name / "p")) == names
        assert any("_pred_" in n for n in names) and any("_gt_" in n for n in names)
        for n in names:
            assert ((tmp_path / name / "p" / n).read_bytes()
                    == (tmp_path / name / "f" / n).read_bytes()), n
    assert port_vis._safe("a b/c?") == fots_vis._safe("a b/c?") == "a_b_c_"


def test_detect_cli_writes_cv2s_drawing_of_its_own_boxes(tmp_path, monkeypatch):
    from fots_torch.cli import detect

    folder = tmp_path / "scenes"
    folder.mkdir()
    for p in SCENES[:2]:
        (folder / os.path.basename(p)).write_bytes(open(p, "rb").read())
    drawn = {}
    original = detect.draw_results

    def record(im_resized, results):
        drawn[len(drawn)] = (np.array(im_resized, copy=True),
                             [(r["box"].copy(), r["text"]) for r in results])
        return original(im_resized, results)

    monkeypatch.setattr(detect, "draw_results", record)
    rows = detect.main(["-model", SNAPSHOT, "-test_folder", str(folder),
                        "-output", str(tmp_path / "out"), "-device", "cpu"])
    assert sorted(rows) == [os.path.basename(p) for p in SCENES[:2]]
    assert sum(len(r) for r in rows.values()) >= 4
    for i, base in enumerate(sorted(rows)):
        im, results = drawn[i]
        assert all(text for _, text in results)
        want = im.copy()
        for b, text in results:
            cv2.polylines(want, [b[:8].reshape(4, 2).astype(np.int32)], True, (0, 255, 0), 1)
            cv2.putText(want, text, (int(b[0]), int(b[1]) - 3), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        (0, 255, 0), 1)
        assert (tmp_path / "out" / base).read_bytes() == cv2.imencode(".jpg", want)[1].tobytes()
        assert os.path.isfile(tmp_path / "out" / (os.path.splitext(base)[0] + ".txt"))


def test_train_joint_debug_dumps_equal_fots_hook(tmp_path, monkeypatch):
    from fots_torch.cli import train_joint

    with np.load(SMOKE_IMAGES) as z:
        names = [str(n) for n in z["names"]]
    lst = tmp_path / "scenes.txt"
    lst.write_text("".join(os.path.join(REPO, "data", "synth", n) + "\n" for n in names))
    seen = []
    original = port_vis.dump_roi_crops

    def record(images, roi_batch, codec, out_dir, step, *args, **kwargs):
        seen.append((np.array(images, copy=True), roi_batch, step))
        return original(images, roi_batch, codec, out_dir, step, *args, **kwargs)

    monkeypatch.setattr(port_vis, "dump_roi_crops", record)
    debug = tmp_path / "debug"
    tracing.reset()
    with tracing.enable():
        train_joint.main(["-train_list", str(lst), "-images_npz", SMOKE_IMAGES,
                          "-save_path", str(tmp_path / "run"), "-batch_size", "2",
                          "-input_size", "128", "-num_readers", "1", "-max_iters", "2",
                          "-debug", str(debug), "-debug_every", "1", "-device", "cpu",
                          "-gt_rois_only"])
    dumps = [s for s in tracing.spans() if s.name == "train.debug_dump"]
    tracing.reset()
    assert [s.step for s in dumps] == [0, 1] == [s for _, _, s in seen]
    want = tmp_path / "fots"
    for images, rb, step in seen:
        jax_rb = JaxRoiBatch(rois=rb.rois, labels=rb.labels, label_lengths=rb.label_lengths,
                             roi_mask=rb.roi_mask, strip_width=rb.strip_width,
                             n_predicted=rb.n_predicted, n_gt=rb.n_gt)
        fots_vis.dump_roi_crops(images, jax_rb, JaxLabelCodec(), str(want), step)
    names = sorted(os.listdir(want))
    assert names and sorted(os.listdir(debug)) == names
    assert sum(s.attrs["crops"] for s in dumps) == len(names)
    assert all(n.startswith(("crop_000000_", "crop_000001_")) for n in names)
    for n in names:
        assert (debug / n).read_bytes() == (want / n).read_bytes(), n
