"""The port's training data path against OpenCV and fots (CPU).

- ``fots_torch.imgproc`` against ``cv2``: ``fill_poly`` byte-exact on random
  quads (inside, off the map, negative, degenerate, self-intersecting,
  truncated floats; u8 and f32 maps); ``box_blur3``, ``pad_constant`` and
  ``bgr2hsv_u8``, ``hsv2bgr_u8``, ``bgr2gray_u8`` and ``warp_affine_u8``
  byte for byte;
- ``generate_rbox`` / ``generate_rbox2`` equal to fots's, every array, on the
  16 ``data/synth`` annotations and on random polygons;
- the augmentation functions under equal seeds: equal polygons, crops and
  pixels, before and after the jitter; the lazy window chain bit-equal to
  the whole chain;
- ``detection_generator`` against fots's on ``data/synth`` (the port reads
  pixels from an archive built here with ``cv2.imread``): everything equal
  without augmentation at the native size, equal targets, polygons and
  pixels with augmentation at 512x512; and the port's targets equal the
  committed ``train_targets.npz`` byte for byte.
"""

import glob
import io
import os
import zipfile

import cv2
import numpy as np
import pytest

from fots import geometry as fgeo
from fots.data import augment as faug
from fots.data.annotations import load_annotation as fots_load_annotation
from fots.data.detection import detection_generator as fots_generator
from fots_torch import geometry as tgeo
from fots_torch import imgproc
from fots_torch.data import augment as taug
from fots_torch.data import detection as tdet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "data", "synth")
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")


def _quads(kind, rng, n):
    """n int32 quads [n, 1, 4, 2] of one kind, for maps up to 60x60."""
    if kind == "inside":
        q = rng.integers(0, 40, (n, 4, 2))
    elif kind == "off_map":
        q = rng.integers(-20, 80, (n, 4, 2))
    elif kind == "far":
        q = rng.integers(-1000, 1000, (n, 4, 2))
    elif kind == "degenerate":
        q = np.repeat(rng.integers(-5, 60, (n, 1, 2)), 4, axis=1)
        q[:, 2, 0] += rng.integers(-6, 6, n)
        q[:, 3, 1] += rng.integers(-1, 2, n)
    else:  # truncated: unrounded floats cast as fots casts them
        q = rng.normal(25, 25, (n, 4, 2))
    return np.asarray(q, np.int32)[:, None]


@pytest.mark.parametrize("kind", ["inside", "off_map", "far", "degenerate", "truncated"])
def test_fill_poly_byte_exact(kind):
    rng = np.random.default_rng(["inside", "off_map", "far", "degenerate",
                                 "truncated"].index(kind))
    sizes = rng.integers(1, 60, (400, 2))
    for (h, w), q in zip(sizes, _quads(kind, rng, 400)):
        for dtype, value in ((np.uint8, 3), (np.float32, 1.0)):
            want = np.zeros((h, w), dtype)
            cv2.fillPoly(want, q, value)
            got = imgproc.fill_poly(np.zeros((h, w), dtype), q, value)
            assert np.array_equal(got, want), (kind, (h, w), q.tolist())


def test_fill_poly_two_contours_and_existing_values():
    """Several contours fill together (even-odd over all edges) on a map
    that already holds values, as cv2.fillPoly does."""
    rng = np.random.default_rng(7)
    for _ in range(100):
        q = rng.integers(-10, 50, (2, 4, 2)).astype(np.int32)
        base = rng.integers(0, 3, (40, 45)).astype(np.uint8)
        want = cv2.fillPoly(base.copy(), q, 9)
        assert np.array_equal(imgproc.fill_poly(base.copy(), q, 9), want)


def test_box_blur_and_pad_exact():
    rng = np.random.default_rng(1)
    for shape in ((40, 60), (1, 5), (5, 1), (2, 2), (160, 240)):
        for x in (rng.random(shape).astype(np.float32),
                  (rng.random(shape) > 0.5).astype(np.float32)):
            assert np.array_equal(imgproc.box_blur3(x), cv2.blur(x, (3, 3)))
    im = rng.integers(0, 256, (30, 41, 3)).astype(np.uint8)
    assert np.array_equal(imgproc.pad_constant(im, 3, 4, 5, 6),
                          cv2.copyMakeBorder(im, 3, 4, 5, 6, cv2.BORDER_CONSTANT))


def test_hsv_conversions():
    rng = np.random.default_rng(2)
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 5)] * 3, indexing="ij"), -1)
    bgr = np.concatenate([grid.reshape(-1, 3),
                          rng.integers(0, 256, (200_000, 3))]).astype(np.uint8)[None]
    assert np.array_equal(imgproc.bgr2hsv_u8(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    hsv = bgr.copy()
    hsv[..., 0] %= 180
    assert np.array_equal(imgproc.hsv2bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    # OpenCV's row body (32 pixels a step) truncates, its tail rounds
    for w in (1, 7, 31, 33, 63, 65, 301):
        hsv = rng.integers(0, 256, (max(2, 6000 // w), w, 3)).astype(np.uint8)
        hsv[..., 0] %= 180
        assert np.array_equal(imgproc.hsv2bgr_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)), w


@pytest.mark.parametrize("shape", [(256 * 256, 256), (37, 53), (5, 1), (1, 17)])
def test_bgr2gray_exact(shape):
    if shape[0] == 256 * 256:   # every colour
        b, g, r = np.meshgrid(*[np.arange(256)] * 3, indexing="ij")
        im = np.stack([b, g, r], -1).astype(np.uint8).reshape(shape + (3,))
    else:
        im = np.random.default_rng(4).integers(0, 256, shape + (3,)).astype(np.uint8)
    got = imgproc.bgr2gray_u8(im)
    assert got.shape == shape + (1,)
    assert np.array_equal(got[..., 0], cv2.cvtColor(im, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("shear", [0.2, -0.2, 0.137, -0.05, 0.0])
def test_warp_affine_within_one_level(shear):
    """Byte for byte (the name dates from when the port was within one
    level): the augment's shear, a general matrix past the border, 1 and 3
    channels at odd sizes (each row's vector body and tail)."""
    rng = np.random.default_rng(3)
    im = rng.integers(0, 256, (120, 170, 3)).astype(np.uint8)  # noise: the worst case
    m = np.float32([[1, shear, 0], [0, 1, 0]])
    assert np.array_equal(imgproc.warp_affine_u8(im, m, (170, 120)),
                          cv2.warpAffine(im, m, (170, 120)))
    m = np.float32([[1.1, 0.3, -20], [-0.2, 0.9, 15]])
    assert np.array_equal(imgproc.warp_affine_u8(im, m, (190, 130)),
                          cv2.warpAffine(im, m, (190, 130)))
    for c, (h, w), dsize in ((1, (37, 53), (61, 29)), (3, (37, 53), (47, 41)),
                             (1, (9, 200), (15, 9)), (3, (64, 33), (33, 64))):
        src = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        m = np.float64([[1 + shear, 0.25, -w / 3], [-shear, 0.9, h / 4]])  # reaches past the border
        want = cv2.warpAffine(src, m, dsize).reshape(dsize[1], dsize[0], c)
        assert np.array_equal(imgproc.warp_affine_u8(src, m, dsize), want), (c, h, w)


def _assert_targets_equal(a, b):
    for x, y in zip(a[:4], b[:4]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert len(a[4]) == len(b[4]) and all(np.array_equal(p, q) for p, q in zip(a[4], b[4]))
    assert a[5] == b[5]


@pytest.mark.parametrize("fn", ["generate_rbox", "generate_rbox2"])
def test_targets_equal_fots_on_synth(fn):
    gts = sorted(glob.glob(os.path.join(SYNTH, "gt_img_*.txt")))
    assert len(gts) == 16
    for gt in gts:
        im = gt.replace("gt_img_", "img_").replace(".txt", ".jpg")
        for shape in ((640, 960), (512, 512), (320, 480)):
            polys, tags, labels = fots_load_annotation(im, shape)
            _assert_targets_equal(getattr(tgeo, fn)(shape, polys.copy(), tags, labels),
                                  getattr(fgeo, fn)(shape, polys.copy(), tags, labels))


@pytest.mark.parametrize("fn", ["generate_rbox", "generate_rbox2"])
def test_targets_equal_fots_on_random_polygons(fn):
    """Rotated boxes of every size, some out of the image, ignore tags,
    multi-word lines and long words on tall boxes."""
    rng = np.random.default_rng(4)
    words = ["a", "abcd", "two words", "###", "x y z", "longword"]
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(8, 60, 2) * 8)
        n = int(rng.integers(1, 12))
        c = rng.uniform(-0.1, 1.1, (n, 2)) * [w, h]
        size = rng.uniform(4, 120, (n, 2))
        ang = rng.uniform(-0.6, 0.6, n)
        polys = np.stack([tgeo.box_points(c[i], size[i], np.degrees(ang[i]))
                          for i in range(n)]).astype(np.float64)
        labels = [words[int(k)] for k in rng.integers(0, len(words), n)]
        tags = np.asarray([t == "###" or rng.uniform() < 0.1 for t in labels])
        _assert_targets_equal(getattr(tgeo, fn)((h, w), polys.copy(), tags, labels),
                              getattr(fgeo, fn)((h, w), polys.copy(), tags, labels))


def _smoke_images():
    with np.load(SMOKE_IMAGES) as z:
        return z["images"]


def _chain(mod, rng, im, polys):
    im, polys = mod.random_border_pad(rng, im, polys)
    im, polys = mod.random_shear(rng, im, polys)
    im, polys = mod.random_scale(rng, im, polys)
    im = mod.random_invert(rng, im, p=0.5)
    return mod.word_centered_crop(rng, im, (512, 512), polys)


def test_augmentation_equal_draws_and_window_chain():
    images = _smoke_images()
    polys0 = np.random.default_rng(5).uniform(100, 800, (5, 4, 2))
    for seed in range(4):
        im = images[seed]
        rf, rt, rl = (np.random.default_rng(seed) for _ in range(3))
        f_im, f_p = _chain(faug, rf, im, polys0.copy())
        t_im, t_p = _chain(taug, rt, im, polys0.copy())
        l_im, l_p = _chain(taug, rl, taug.Source(im), polys0.copy())
        assert np.array_equal(f_p, t_p) and np.array_equal(t_p, l_p)
        assert f_im.shape == t_im.shape == l_im.shape
        # the window chain computes the same pixels as the whole chain
        assert np.array_equal(t_im, taug.materialise(l_im))
        assert np.array_equal(f_im, t_im)
        f_j, t_j = faug.color_jitter(rf, f_im), taug.color_jitter(rt, t_im)
        assert np.array_equal(taug.color_jitter(rl, taug.materialise(l_im)), t_j)
        assert np.array_equal(f_j, t_j)
        assert rf.uniform() == rt.uniform() == rl.uniform()  # the same draws were taken


def test_crop_without_polygons_and_after_31_tries():
    """The no-polygon branch draws a corner; a crop that is never square
    returns the image as it was after 31 tries."""
    im = np.zeros((300, 700, 3), np.uint8)
    for polys in (np.zeros((0, 4, 2)), np.full((2, 4, 2), 150.0)):
        rf, rt = np.random.default_rng(9), np.random.default_rng(9)
        f_im, f_p = faug.word_centered_crop(rf, im, (512, 512), polys.copy())
        t_im, t_p = taug.word_centered_crop(rt, taug.Source(im), (512, 512), polys.copy())
        assert f_im.shape == t_im.shape and np.array_equal(f_p, t_p)
        assert rf.uniform() == rt.uniform()


@pytest.fixture(scope="module")
def synth_archive(tmp_path_factory):
    """data/synth's 16 scenes as a list file and an archive of their pixels
    decoded by cv2."""
    tmp = tmp_path_factory.mktemp("synth")
    jpgs = sorted(glob.glob(os.path.join(SYNTH, "img_*.jpg")))
    archive = str(tmp / "pixels.npz")
    np.savez(archive, images=np.stack([cv2.imread(p) for p in jpgs]),
             names=np.asarray([os.path.basename(p) for p in jpgs]))
    list_path = str(tmp / "list.txt")
    with open(list_path, "w") as f:
        f.writelines(p + "\n" for p in jpgs)
    return list_path, archive


def _batches_equal_targets(a, b):
    for k in ("score_maps", "geo_maps", "training_masks", "gt_idxs"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert a.labels == b.labels and a.image_fns == b.image_fns
    for qa, qb in zip(a.gt_quads, b.gt_quads):
        assert len(qa) == len(qb) and all(np.array_equal(p, q) for p, q in zip(qa, qb))


def test_generator_without_augmentation_equals_fots(synth_archive):
    list_path, archive = synth_archive
    want = next(fots_generator(list_path, input_size=-1, batch_size=16, seed=0,
                               in_train=False, augment=False))
    got = next(tdet.detection_generator(list_path, archive, input_size=-1, batch_size=16,
                                        seed=0, in_train=False, augment=False))
    _batches_equal_targets(got, want)
    assert np.array_equal(got.images, want.images) and got.dropped == 0


@pytest.mark.parametrize("geo_type", [0, 1])
def test_generator_with_augmentation_equals_fots(synth_archive, geo_type):
    list_path, archive = synth_archive
    want = fots_generator(list_path, input_size=512, batch_size=4, seed=3, geo_type=geo_type)
    got = tdet.detection_generator(list_path, archive, input_size=512, batch_size=4, seed=3,
                                   geo_type=geo_type)
    for _ in range(2):
        a, b = next(got), next(want)
        _batches_equal_targets(a, b)
        assert np.array_equal(a.images, b.images)


def test_port_targets_equal_the_committed_asset(tmp_path):
    """What chip_smoke.py holds on the card: the port's targets of the smoke
    scenes equal fots's asset byte for byte."""
    with np.load(os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")) as z:
        want = {k: z[k] for k in z.files}
    names = [str(n) for n in want["names"]]
    list_path = str(tmp_path / "smoke.txt")
    with open(list_path, "w") as f:
        f.writelines(os.path.join(SYNTH, n) + "\n" for n in names)
    b = next(tdet.detection_generator(list_path, SMOKE_IMAGES, input_size=-1,
                                      batch_size=len(names), seed=0, in_train=False,
                                      augment=False))
    got = {"score_maps": b.score_maps, "training_masks": b.training_masks,
           "geo_maps": b.geo_maps, "gt_idxs": b.gt_idxs,
           "gt_quads": np.stack([np.asarray(q, np.float32) for s in b.gt_quads for q in s]),
           "gt_counts": np.asarray([len(s) for s in b.gt_quads], np.int64)}
    for k, v in got.items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k
    assert [t for s in b.labels for t in s] == [str(t) for t in want["gt_labels"]]


def test_list_entry_without_pixels_raises(synth_archive, tmp_path):
    list_path, archive = synth_archive
    bad = tmp_path / "list.txt"
    bad.write_text(open(list_path).read() + os.path.join(SYNTH, "img_999.jpg") + "\n")
    with pytest.raises(FileNotFoundError, match="no pixels"):
        tdet.detection_generator(str(bad), archive)
    with pytest.raises(FileNotFoundError, match="no pixels"):
        tdet.detection_batches(str(bad), archive, num_workers=1)


def _npy(a=None, header_shape=None):
    """The bytes of ``np.save(a)``, or of a u8 header of ``header_shape``
    followed by no data."""
    buf = io.BytesIO()
    if a is not None:
        np.save(buf, a)
    else:
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "|u1", "fortran_order": False, "shape": header_shape})
    return buf.getvalue()


@pytest.mark.parametrize("compression", [zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED])
def test_archive_check_reads_names_and_header_only(tmp_path, compression):
    """detection_batches's pre-flight: an archive whose images member is a
    header of 3 rows of 3 TB each with no data passes when it is stored (the
    readers map it) and is refused with a clear error when compressed (each
    reader would keep its rows); a missing entry raises either way."""
    archive = str(tmp_path / "big.npz")
    with zipfile.ZipFile(archive, "w", compression) as zf:
        zf.writestr("images.npy", _npy(header_shape=(3, 10 ** 6, 10 ** 6, 3)))
        zf.writestr("names.npy", _npy(np.asarray(["a.jpg", "b.jpg", "c.jpg"])))
    image_list = [os.path.join(SYNTH, n) for n in ("a.jpg", "c.jpg")]
    if compression == zipfile.ZIP_STORED:
        tdet.check_archive(archive, image_list, readers=6)
    else:
        with pytest.raises(MemoryError, match="np.savez"):
            tdet.check_archive(archive, image_list, readers=6)
    with pytest.raises(FileNotFoundError, match="no pixels"):
        tdet.check_archive(archive, image_list + ["d.jpg"], readers=1)


def test_pixels_memory_mapped_when_stored_streamed_when_compressed(synth_archive, tmp_path):
    """A stored archive's images are views of one memory map; a compressed
    one keeps the list's rows only; both equal cv2's pixels."""
    list_path, stored = synth_archive
    image_list = tdet.load_image_list(list_path)
    want = {p: cv2.imread(p) for p in image_list}
    mapped = tdet.load_pixels(stored, image_list)
    assert all(isinstance(v, np.memmap) and np.array_equal(v, want[p])
               for p, v in mapped.items())
    compressed = str(tmp_path / "pixels_z.npz")
    with np.load(stored) as z:
        np.savez_compressed(compressed, images=z["images"], names=z["names"])
    subset = image_list[3:6]
    streamed = tdet.load_pixels(compressed, subset)
    assert list(streamed) == subset
    assert all(np.array_equal(v, want[p]) for p, v in streamed.items())


def test_a_failing_sample_is_reported_dropped_and_counted(synth_archive, monkeypatch, capsys):
    list_path, archive = synth_archive
    calls = {"n": 0}
    real = tdet.generate_rbox

    def flaky(*args):
        calls["n"] += 1
        if calls["n"] == 2:
            raise ValueError("bad sample")
        return real(*args)

    monkeypatch.setattr(tdet, "generate_rbox", flaky)
    batch = next(tdet.detection_generator(list_path, archive, input_size=-1, batch_size=4,
                                          seed=0, in_train=False, augment=False))
    assert batch.dropped == 1 and len(batch.image_fns) == 4
    assert "ValueError: bad sample" in capsys.readouterr().err
