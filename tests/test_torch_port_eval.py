"""The port's per-image evaluation path against fots, on the same numpy inputs.

Host modules (beam search, word splitting, the ICDAR metric, annotation
parsing, the NumPy resize) are held to identical results.  The engine
(``FOTSInference.__call__``, ``recognize_boxes`` by its three routes,
``max_boxes``, ``expand_w_frac``, ``split_words``, a mixed-shape
``batch_call``) runs the shipped snapshot in f32 on the CPU on one committed
scene cropped to 512x576: the same boxes within 0.05 px, the same texts,
confidences within 1e-3.
"""

import glob
import os

import cv2
import numpy as np
import pytest
import torch

from fots.cli.detect import load_engine as jax_load_engine
from fots.codec import LabelCodec as JaxCodec
from fots.data import annotations as jax_ann
from fots.evaluate import E2EMetrics as JaxMetrics, evaluate_image as jax_evaluate_image
from fots.geometry import resize_to_multiple_of_32 as jax_resize32
from fots.ops import ctc_decode as jax_ctc
from fots import wordsplit as jax_split
from fots_torch import wordsplit as port_split
from fots_torch.cli.detect import load_engine
from fots_torch.cli import eval_e2e as port_eval_cli
from fots_torch.codec import LabelCodec, levenshtein
from fots_torch.data import annotations as port_ann
from fots_torch.evaluate import E2EMetrics, evaluate_image
from fots_torch.geometry import resize_bilinear_u8, resize_to_multiple_of_32
from fots_torch.ops import ctc_decode as port_ctc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")


# --------------------------------------------------------------------------
# host modules
# --------------------------------------------------------------------------

def _log_probs(seed, t=24, k=87, peaked=True):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, k)).astype(np.float32)
    if peaked:  # a few confident frames and blanks, as a recognizer emits
        logits[np.arange(t), rng.integers(0, k, t)] += 4.0
        logits[rng.random(t) < 0.4, 0] += 5.0
    logits -= logits.max(axis=-1, keepdims=True)
    return (logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_beam_search_matches_fots(seed):
    lp = _log_probs(seed, peaked=seed != 2)
    got = port_ctc.prefix_beam_search(lp, beam_width=8)
    want = jax_ctc.prefix_beam_search(lp, beam_width=8)
    assert [h for h, _ in got] == [h for h, _ in want] and len(got) > 1
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)
    assert port_ctc.beam_decode_text(lp, LabelCodec()) == jax_ctc.beam_decode_text(lp, JaxCodec())
    np.testing.assert_array_equal(port_ctc.greedy_decode(lp), jax_ctc.greedy_decode(lp))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_beam_search_topk_matches_fots(seed):
    lp = _log_probs(10 + seed, t=32)
    top_ids = np.argsort(-lp, axis=-1)[:, :16]
    top_lp = np.take_along_axis(lp, top_ids, axis=-1)
    got = port_ctc.prefix_beam_search_topk(top_ids, top_lp, lp[:, 0], beam_width=8)
    want = jax_ctc.prefix_beam_search_topk(top_ids, top_lp, lp[:, 0], beam_width=8)
    assert [h for h, _ in got] == [h for h, _ in want] and len(got) > 1
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wordsplit_matches_fots(seed):
    rng = np.random.default_rng(seed)
    codec, jcodec = LabelCodec(), JaxCodec()
    space = codec.alphabet.index(" ") + 1
    dot = codec.alphabet.index(".") + 1
    # frames of a line of words: repeats, blanks, spaces and a separator
    ids = []
    for _ in range(int(rng.integers(1, 5))):
        for _ in range(int(rng.integers(1, 6))):
            ids += [int(rng.integers(1, codec.num_classes))] * int(rng.integers(1, 3))
            ids += [0] * int(rng.integers(0, 2))
        ids += [space if rng.random() < 0.7 else dot] + [0] * int(rng.integers(0, 3))
    ids = np.asarray(ids + [0] * 5)
    got = port_split.decode_with_splits(ids, codec)
    want = jax_split.decode_with_splits(ids, jcodec)
    assert got[:2] == want[:2] and got[3:] == want[3:]
    np.testing.assert_array_equal(got[2], want[2])
    box = np.array([10.0, 40.0, 14.0, 12.0, 210.0, 30.0, 206.0, 58.0, 0.9])
    got = port_split.split_detection(box, ids, codec)
    want = jax_split.split_detection(box, ids, jcodec)
    assert [t for _, t in got] == [t for _, t in want]
    for (gq, _), (wq, _) in zip(got, want):
        np.testing.assert_array_equal(gq, wq)
    assert codec.decode_ids(ids) == jcodec.decode_ids(ids)
    assert codec.decode_ids(ids[ids > 0], raw=True) == jcodec.decode_ids(ids[ids > 0], raw=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_matches_fots(seed):
    rng = np.random.default_rng(seed)
    words = ["TOWER", "COFFEE", "ab", "###", "PLAZA", "Books", "RIVER"]
    port_m, jax_m = E2EMetrics(ignore_dontcare=seed == 2), JaxMetrics(ignore_dontcare=seed == 2)
    for _ in range(4):
        n_gt = int(rng.integers(0, 6))
        gt = np.zeros((n_gt, 8))
        for i in range(n_gt):
            x, y = rng.uniform(0, 500, 2)
            w, h = rng.uniform(40, 160), rng.uniform(15, 50)
            gt[i] = [x, y + h, x, y, x + w, y, x + w, y + h]
        gt_txt = [words[int(rng.integers(len(words)))] for _ in range(n_gt)]
        dets = []
        for i in range(n_gt):  # a jittered detection per GT, texts sometimes off by one
            if rng.random() < 0.8:
                t = gt_txt[i] if rng.random() < 0.6 else gt_txt[i][:-1] + "x"
                dets.append((np.append(gt[i] + rng.uniform(-6, 6, 8), 0.9), t))
        dets.append((np.append(rng.uniform(0, 600, 8), 0.5), "NOISE"))
        got = evaluate_image(dets, gt, gt_txt)
        want = jax_evaluate_image(dets, gt, gt_txt)
        assert got == want
        port_m.add_image(dets, gt, gt_txt)
        jax_m.add_image(dets, gt, gt_txt)
    assert port_m == E2EMetrics(**{k: getattr(jax_m, k) for k in port_m.__dataclass_fields__})
    assert port_m.summary() == jax_m.summary()
    assert levenshtein("kitten", "sitting") == 3


def test_annotation_parsing_matches_fots():
    paths = sorted(glob.glob(os.path.join(REPO, "data", "synth", "img_*.jpg")))[:6]
    assert len(paths) == 6
    for p in paths:
        got = port_ann.load_annotation(p, (640, 960, 3))
        want = jax_ann.load_annotation(p, (640, 960, 3))
        assert len(want[2]) > 0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        gt = port_ann.gt_path_for_image(p)[1]
        with open(gt, encoding="utf-8") as f:
            mem = port_ann.parse_annotation_text(f.read(), os.path.relpath(gt, REPO), (640, 960, 3))
        np.testing.assert_array_equal(mem[0], want[0])
        assert mem[2] == want[2]
    assert port_ann.gt_path_for_image(paths[0]) == jax_ann.gt_path_for_image(paths[0])
    # the MLT format goes through box_points in place of cv2.boxPoints
    lines = ["1 0.41 0.52 0.21 0.05 0.31 HELLO world", "1 0.7 0.2 0.1 0.03 -60.0 ###"]
    got = port_ann.parse_mlt_lines(lines, (640, 960, 3))
    want = jax_ann.parse_mlt_lines(lines, (640, 960, 3))
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert port_ann.parse_annotation_text("\n".join(lines), "img_1.txt", (640, 960, 3))[2] == want[2]
    lst = os.path.join(REPO, "data", "heldout_eval.txt")
    assert port_ann.load_image_list(lst) == jax_ann.load_image_list(lst)


@pytest.mark.parametrize("dsize", [(480, 320), (1280, 853), (333, 777)])
def test_numpy_resize_within_one_level_of_cv2(dsize):
    im = cv2.imread(os.path.join(REPO, "data", "synth", "img_000.jpg"))
    got = resize_bilinear_u8(im, dsize)
    want = cv2.resize(im, dsize)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("scale_up", [False, True])
def test_resize_to_multiple_of_32_matches_fots(scale_up):
    im = cv2.imread(os.path.join(REPO, "data", "synth", "img_001.jpg"))[:500, :731]
    got, got_hw = resize_to_multiple_of_32(im, scale_up=scale_up)
    want, want_hw = jax_resize32(im, scale_up=scale_up)
    assert got_hw == want_hw and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    same, _ = resize_to_multiple_of_32(im[:480, :704], scale_up=False)
    np.testing.assert_array_equal(same, im[:480, :704])


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """img_000 cropped to the 512x576 window that holds seven of its words."""
    im = cv2.imread(os.path.join(REPO, "data", "synth", "img_000.jpg"))
    return np.ascontiguousarray(im[128:640, 96:672])


@pytest.fixture(scope="module")
def engines():
    """(port on the CPU, fots): one pair for the module; tests set ``beam``,
    ``max_boxes`` and ``expand_w_frac`` on both and restore them."""
    ref = jax_load_engine(SNAPSHOT)
    with load_engine(SNAPSHOT, device="cpu") as port:
        assert port.masked_norm and ref.masked_norm
        yield port, ref


def _set(engines, **attrs):
    for eng in engines:
        for k, v in attrs.items():
            setattr(eng, k, v)


def _same_results(got, want, key="box", atol=0.05):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g[key]), np.asarray(w[key]), atol=atol)
        assert g["text"] == w["text"]
        if "conf" in w:
            assert abs(g["conf"] - w["conf"]) <= 1e-3


def test_call_matches_fots(engines, scene):
    port, ref = engines
    got, got_im = port(scene)
    want, want_im = ref(scene)
    np.testing.assert_array_equal(got_im, want_im)
    assert len(want) >= 4
    _same_results(got, want)


def test_split_words_matches_fots(engines, scene):
    port, ref = engines
    got, _ = port(scene, split_words=True)
    want, _ = ref(scene, split_words=True)
    _same_results(got, want)
    assert all("words" in r for r in want)
    for g, w in zip(got, want):
        _same_results(g["words"], w["words"], key="quad")


@pytest.mark.parametrize("route", ["greedy", "beam8", "images_norm"])
def test_recognize_boxes_matches_fots(engines, scene, route):
    """The three recognition routes, both packages on fots's boxes."""
    port, ref = engines
    boxes, focr_ref, _ = ref.detect(scene)
    _, focr, _ = port.detect(scene)
    kw_port, kw_ref = {"focr": focr}, {"focr": focr_ref}
    if route == "images_norm":
        norm = scene[None].astype(np.float32) / 128.0 - 1.0
        kw_port = kw_ref = {"images_norm": norm}
    _set(engines, beam=8 if route == "beam8" else 0)
    try:
        got = port.recognize_boxes(boxes, return_ids=True, **kw_port)
        want = ref.recognize_boxes(boxes, return_ids=True, **kw_ref)
    finally:
        _set(engines, beam=0)
    assert got[0] == want[0] and sum(len(t) > 0 for t in want[0]) >= 4
    np.testing.assert_allclose(got[2], want[2], atol=1e-3)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert port.recognize_boxes(boxes[:0], focr) == []


def test_recognize_boxes_takes_a_raw_focr_map(engines, scene):
    port, _ = engines
    boxes, focr, im = port.detect(scene)
    with torch.inference_mode():
        x = torch.from_numpy(im[None]).float() / 128.0 - 1.0
        raw = port.model(x)["focr"]
    assert port.recognize_boxes(boxes, raw) == port.recognize_boxes(boxes, focr)
    # detect_boxes_batch takes the normalized f32 batch as well as the u8 one
    boxes_f32, _ = port.detect_boxes_batch(x.numpy())
    np.testing.assert_array_equal(boxes_f32[0], boxes)
    with pytest.raises(ValueError, match="a float batch must be f32"):
        port.detect_boxes_batch(x.numpy().astype(np.float64))


def test_max_boxes_matches_fots(engines, scene):
    port, ref = engines
    _set(engines, max_boxes=2)
    try:
        got, _ = port(scene)
        want, _ = ref(scene)
        got_b = port.batch_call([scene], serve_hw=scene.shape[:2])[0]
    finally:
        _set(engines, max_boxes=None)
    assert len(want) == 2
    _same_results(got, want)
    _same_results(got_b, want)


def test_expand_w_frac_matches_fots(engines, scene):
    port, ref = engines
    plain, _ = port(scene)
    _set(engines, expand_w_frac=0.25)
    try:
        got, _ = port(scene)
        want, _ = ref(scene)
    finally:
        _set(engines, expand_w_frac=0.0)
    _same_results(got, want)
    assert [r["conf"] for r in got] != [r["conf"] for r in plain]


def test_mixed_shape_batch_call_matches_fots(engines, scene):
    """Two source shapes in one batch: the host letterbox of both packages
    (cv2 in fots, NumPy in the port, within one u8 level)."""
    port, ref = engines
    batch = [scene, np.ascontiguousarray(scene[:448, 64:])]
    got = port.batch_call(batch, serve_hw=(512, 576), split_words=True)
    want = ref.batch_call(batch, serve_hw=(512, 576), split_words=True)
    assert [len(r) for r in want] == [len(r) for r in got] and len(want[0]) >= 4
    for g_img, w_img in zip(got, want):
        # the second image is resized by 1.125: a one-level pixel difference
        # may move a corner by more than the same-pixels limit
        _same_results(g_img, w_img, atol=0.5)
        for g, w in zip(g_img, w_img):
            _same_results(g["words"], w["words"], key="quad", atol=0.5)
    ctx = list(port.stream(iter([("a", batch), ("b", batch[:1])]), serve_hw=(512, 576),
                           with_context=True))
    assert [c for c, _ in ctx] == ["a", "b"]
    assert [[r["text"] for r in im] for im in ctx[0][1]] == [[r["text"] for r in im] for im in got]


def test_eval_cli_matches_fots_on_one_scene(engines, scene, tmp_path):
    """The port's eval_e2e over an in-memory archive against fots's metric on
    fots's own detections of the same pixels."""
    port, ref = engines
    gt_path = os.path.join(REPO, "data", "synth", "gt_img_000.txt")
    with open(gt_path, encoding="utf-8") as f:
        # shift the annotation into the crop's coordinates
        lines = []
        for line in f.read().splitlines():
            s = line.split(",")
            xy = np.asarray(list(map(float, s[:8]))).reshape(4, 2) - [96, 128]
            lines.append(",".join([*(f"{v:g}" for v in xy.reshape(-1)), *s[8:]]))
    npz = tmp_path / "one.npz"
    np.savez(npz, images=scene[None], names=np.asarray(["img_000.jpg"]),
             gt_names=np.asarray(["gt_img_000.txt"]), gt_texts=np.asarray(["\n".join(lines)]))
    summary, metrics, dump, _ = port_eval_cli.evaluate(
        port, *port_eval_cli.load_images_npz(str(npz)), log_every=0)
    polys, _, labels = jax_ann.parse_icdar_lines(lines, roll_icdar=False)
    want_res, _ = ref(scene)
    jm = JaxMetrics()
    jm.add_image([(r["box"], r["text"]) for r in want_res if len(r["text"].strip()) >= 3],
                 polys.reshape(-1, 8), labels)
    assert summary == jm.summary() and metrics.tp_e2e_all >= 3
    assert [d["text"] for d in dump[0]["detections"]] == [r["text"] for r in want_res]
    with pytest.raises(SystemExit):
        port_eval_cli.main(["-model", SNAPSHOT, "-images_list", "data/synth_big_eval.txt",
                            "-device", "cpu"])
