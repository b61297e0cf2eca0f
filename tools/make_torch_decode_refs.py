"""Write the image files the PyTorch port's decoder is held to on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/make_torch_decode_refs.py

Needs OpenCV and JAX on the CPU (the port's GPU machine has neither; there
``fots_torch.imageio.imread`` must decode these files to the hashes of
``cv2.imread``'s bytes).  Each file is checked against ``cv2`` and the port's
reader here first.  Writes ``fots_torch/assets/decode_ref/``:

- ``prog/img_112.jpg`` ... ``img_115.jpg``: the first four held-out scenes
  (rows 0-3 of ``fots_torch/assets/heldout_eval_u8.npz``) through ``cv2``'s
  progressive writer at quality 95 (libjpeg's ``jpeg_simple_progression``),
  their ``gt_*.txt`` and ``eval.txt`` listing them by relative name;
- ``hand_scripted.jpg``: a 64x96 window of ``img_112`` through the scan
  script of ``tests/test_torch_port_imageio.py``'s own progressive writer
  (non-interleaved DC scans, bands split as mozjpeg splits them, successive
  approximation from ``Al`` = 2, restart markers, a DQT between scans);
- ``cut_sequential.jpg``: a 160x240 window of ``img_113`` through
  ``cv2.imwrite`` (restart interval 4), cut at 60% of its bytes;
- small PNGs: Adam7 RGB, 1-bit grey, 2-bit palette, Adam7 4-bit grey,
  16-bit RGBA, and a palette PNG with an ``eXIf`` orientation (6);
- what libjpeg-turbo and libpng read beyond those, each decoded through its
  own path: ``scene_smoothed.jpg`` (``prog/img_112.jpg`` cut halfway into its
  second scan: block-smoothed, the rows past the cut with the DC scan's
  state), ``scene_cmyk.jpg`` (``img_112`` as Pillow's Adobe-inverted CMYK at
  quality 50, C sampled 2x2) and ``scene_arith.jpg`` (``img_112`` through
  ``tests/test_torch_port_imageio_formats.py``'s arithmetic encoder, SOF9):
  640x960 each, the forms phase 12 of ``chip_smoke.py`` times; on a 64x96
  window of ``img_115``, ``unrefined.jpg`` and ``dc_only.jpg`` (the
  hand-scripted file ended with EOI before its refinement scans, and after
  its DC scans), ``ycck.jpg``, ``rgb_coded.jpg`` (Pillow's ``keep_rgb``),
  ``arith_progressive.jpg`` (SOF10 with restarts and DAC conditioning),
  ``lossless_grey.jpg`` (predictor 4, point transform 1, restarts) and
  ``lossless_rgb.jpg`` (predictor 7); gamma-tagged PNGs (``gAMA`` 45455
  RGB, ``sRGB`` 16-bit RGBA, ``gAMA`` 220000 palette) that grey output reads
  through libpng's gamma tables;
- ``manifest.json``: for each file its SHA-256 and the shape and SHA-256 of
  ``cv2.imread``'s colour and grey bytes (null where ``cv2`` reads nothing:
  a lossless frame's output in another colour space);
- ``eval_fots_cpu.json``: ``fots.cli.eval_e2e -images_list prog/eval.txt``
  with the shipped snapshot (f32, CPU): summary and match counts.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from make_torch_eval_asset import run_fots  # noqa: E402

ASSETS = os.path.join(REPO, "fots_torch", "assets")
OUT = os.path.join(ASSETS, "decode_ref")
HELDOUT = os.path.join(ASSETS, "heldout_eval_u8.npz")
HELDOUT_JPG = os.path.join(ASSETS, "heldout_eval_jpg")
SCENES = 4
QUALITY = 95
CUT_FRACTION = 0.6


def _test_writers():
    """The PNG and progressive JPEG writers of the decoder's CPU tests."""
    path = os.path.join(REPO, "tests", "test_torch_port_imageio.py")
    spec = importlib.util.spec_from_file_location("test_torch_port_imageio", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _formats_module():
    """The arithmetic and lossless encoders of the decoder's format tests."""
    sys.path.insert(0, REPO)
    return importlib.import_module("tests.test_torch_port_imageio_formats")


def _cmyk(im):
    """Pillow's CMYK JPEG at quality 50 of a BGR image (K = 255 - max)."""
    import io

    from PIL import Image

    rgb = im[..., ::-1].astype(np.int32)
    k = 255 - rgb.max(-1, keepdims=True)
    cmy = (255 - rgb - k) * 255 // np.maximum(255 - k, 1)
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([cmy, k], -1).astype(np.uint8), "CMYK").save(
        buf, "JPEG", quality=50, subsampling=2)
    return buf.getvalue()


def _scans(data):
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


def format_files(images, names, prog) -> dict:
    """{relative path: bytes} of the files read by the decoder's paths
    beyond baseline, progressive, cut JPEG and plain PNG."""
    import io

    from PIL import Image

    t, f = _test_writers(), _formats_module()
    out = {}
    scans = _scans(prog)
    out["scene_smoothed.jpg"] = prog[:(scans[1] + scans[2]) // 2]
    out["scene_cmyk.jpg"] = _cmyk(images[0])
    out["scene_arith.jpg"] = f.arith_jpeg(images[0])
    win = np.ascontiguousarray(images[3][120:184, 200:296])
    hand = t.hand_scripted_progressive(win, 5)
    scans = _scans(hand)
    out["unrefined.jpg"] = hand[:scans[-4]] + b"\xff\xd9"
    out["dc_only.jpg"] = hand[:scans[2]] + b"\xff\xd9"
    ycck = bytearray(_cmyk(win))
    ycck[ycck.index(b"Adobe") + 11] = 2
    out["ycck.jpg"] = bytes(ycck)
    buf = io.BytesIO()
    Image.fromarray(win[..., ::-1].copy(), "RGB").save(buf, "JPEG", keep_rgb=True)
    out["rgb_coded.jpg"] = buf.getvalue()
    out["arith_progressive.jpg"] = f.arith_jpeg(win, progressive=True, restart=3,
                                                dac={0: (1, 3, 10), 1: (0, 2, 2)})
    grey = np.ascontiguousarray(win[..., 1])
    out["lossless_grey.jpg"] = f.lossless_jpeg([grey], [(1, 1)], 4, 1, restart_rows=2)
    out["lossless_rgb.jpg"] = f.lossless_jpeg([win[..., 2], win[..., 1], win[..., 0]],
                                              [(1, 1)] * 3, 7, 0)
    small = win[:23, :29]

    def tagged(data, chunk, before):
        at = data.index(before) - 4
        return data[:at] + chunk + data[at:]
    out["gamma_rgb.png"] = tagged(t.png_bytes(small[..., ::-1], 8, 2, filters=(0, 1, 4)),
                                  t._chunk(b"gAMA", (45455).to_bytes(4, "big")), b"IDAT")
    rgba = np.concatenate([small[..., ::-1], small[..., :1]], -1).astype(np.uint16) * 257
    rgba += np.arange(rgba.size, dtype=np.uint16).reshape(rgba.shape) % 241
    out["srgb_rgba_16bit.png"] = tagged(t.png_bytes(rgba, 16, 6, filters=(4,)),
                                        t._chunk(b"sRGB", b"\x00"), b"IDAT")
    s4, pal4 = t.png_samples(3, 4, h=23, w=29)
    out["gamma_palette.png"] = tagged(t.png_bytes(s4, 4, 3, pal4, filters=(2,)),
                                      t._chunk(b"gAMA", (220000).to_bytes(4, "big")), b"PLTE")
    return out


def files(images, names) -> dict:
    """{relative path: bytes} of every file but the scenes' annotations."""
    import cv2

    t = _test_writers()
    out = {}
    for im, name in zip(images[:SCENES], names[:SCENES]):
        ok, enc = cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY, QUALITY,
                                            cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        out[f"prog/{name}"] = enc.tobytes()
    out["hand_scripted.jpg"] = t.hand_scripted_progressive(images[0][200:264, 300:396], 5)
    ok, enc = cv2.imencode(".jpg", images[1][100:260, 200:440], [cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    out["cut_sequential.jpg"] = enc.tobytes()[:int(len(enc) * CUT_FRACTION)]
    window = images[2][:21, :27]
    grey = cv2.cvtColor(window, cv2.COLOR_BGR2GRAY)
    s2, pal2 = t.png_samples(3, 2, h=21, w=27)
    out["adam7_rgb.png"] = t.png_bytes(window[..., ::-1], 8, 2, filters=(0, 1, 2, 3, 4),
                                       interlace=1)
    out["grey_1bit.png"] = t.png_bytes(grey >> 7, 1, 0, filters=(1, 4))
    out["palette_2bit.png"] = t.png_bytes(s2, 2, 3, pal2, filters=(2, 3))
    out["adam7_grey_4bit.png"] = t.png_bytes(grey >> 4, 4, 0, filters=(4,), interlace=1)
    rgba = np.concatenate([window[..., ::-1], grey[..., None]], -1).astype(np.uint16) * 257
    rgba += np.arange(rgba.size, dtype=np.uint16).reshape(rgba.shape) % 251  # low bytes
    out["rgba_16bit.png"] = t.png_bytes(rgba, 16, 6, filters=(0, 4))
    exif = t._chunk(b"eXIf", t._tiff_orientation(6, False))
    out["exif_palette.png"] = t.png_bytes(s2, 2, 3, pal2, filters=(1,), extra=exif)
    out.update(format_files(images, names, out[f"prog/{names[0]}"]))
    return out


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> int:
    import cv2
    import jax

    from fots_torch.imageio import imread

    with np.load(HELDOUT) as z:
        images = z["images"]
        names = [os.path.basename(str(n)) for n in z["names"]]
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(os.path.join(OUT, "prog"))
    manifest = {}
    for rel, data in files(images, names).items():
        path = os.path.join(OUT, rel)
        with open(path, "wb") as f:
            f.write(data)
        entry = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
        for key, flag in (("colour", cv2.IMREAD_COLOR), ("grey", cv2.IMREAD_GRAYSCALE)):
            want = cv2.imread(path, flag)
            got = imread(path, grayscale=key == "grey")
            if want is None and got is None and rel.startswith("lossless_"):
                entry[key] = None  # no colour conversion in a lossless frame
                continue
            if want is None or got is None or not np.array_equal(got, want):
                raise RuntimeError(f"{rel}: the port does not read it as cv2 does ({key})")
            entry[key] = {"shape": list(want.shape), "sha256": _digest(want)}
        manifest[rel] = entry
        print(f"{rel}: {len(data)} bytes, {(entry['colour'] or entry['grey'])['shape']}")
    for name in names[:SCENES]:
        shutil.copy(os.path.join(HELDOUT_JPG, f"gt_{os.path.splitext(name)[0]}.txt"),
                    os.path.join(OUT, "prog"))
    with open(os.path.join(OUT, "prog", "eval.txt"), "w") as f:
        f.writelines(n + "\n" for n in names[:SCENES])
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    paths = [os.path.join(OUT, "prog", n) for n in names[:SCENES]]
    run = run_fots(paths, [])
    result = {"snapshot": "artifacts/serving_params.npz", "images_list":
              os.path.relpath(os.path.join(OUT, "prog", "eval.txt"), REPO),
              "precision": "f32", "platform": jax.default_backend(), "jax": jax.__version__,
              "opencv": cv2.__version__,
              "run": {k: run[k] for k in ("summary", "counts")}}
    with open(os.path.join(OUT, "eval_fots_cpu.json"), "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"fots eval_e2e over {SCENES} progressive scenes: {run['counts']} "
          f"{ {k: round(v, 4) for k, v in run['summary'].items() if k.endswith('hmean')} }")
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(f"wrote {OUT} ({size / 1e6:.3f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
