"""Write the recognition-only stack's crop archive for the PyTorch port and
``fots``'s own recognition result on it.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/make_torch_ocr_asset.py

Needs JAX and OpenCV (it cuts the crops with OpenCV and runs ``fots`` on the
CPU); the port's GPU machine has neither, so it trains and evaluates on
what this writes:

- ``fots_torch/assets/ocr_crops_u8.npz``: every ground-truth word (``###``
  skipped) cut from its scene with ``cv2.getPerspectiveTransform`` +
  ``cv2.warpPerspective`` (``INTER_LINEAR``) into an upright rectangle of
  the quad's mean edge lengths.  Split ``eval``: the 16 held-out scenes of
  ``fots_torch/assets/heldout_eval_u8.npz`` (their decoded pixels and
  annotations); split ``train``: the first 64 scenes of
  ``data/synth_big_train.txt`` (``data/synth_big`` is regenerated from its
  seed when missing).  Stored as one flat u8 buffer (``pixels``) with
  ``shapes`` [N, 3], ``offsets`` [N], ``texts`` [N], ``split`` [N] and
  ``sources`` [N] (scene file and word index), compressed.
- ``fots_torch/assets/ocr_eval_fots_cpu.json``: ``fots``'s
  ``ocr_crop_generator`` (batch 4, ``in_train=False``, ``norm_height`` 44)
  over the eval crops written out as PNGs with a ``gt.txt``, read by
  ``FOTSRecognizerTrainer.predict_texts`` with the shipped snapshot's
  weights, f32 on the CPU, greedy and ``-beam 8``: each run's
  ``OCRMetrics.summary()``, its count of exact crops, and each crop's
  prediction in the generator's order.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fots_torch", "assets")
HELDOUT = os.path.join(ASSETS, "heldout_eval_u8.npz")
TRAIN_LIST = os.path.join(REPO, "data", "synth_big_train.txt")
SYNTH_BIG = os.path.join(REPO, "data", "synth_big")
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
TRAIN_SCENES = 64
NORM_HEIGHT = 44
RUNS = {"greedy": 0, "beam8": 8}


def cut_word(im: np.ndarray, quad: np.ndarray) -> np.ndarray:
    """The word under ``quad`` (p0 bottom-left, p1 top-left, p2 top-right,
    p3 bottom-right, as ``fots``'s annotations give it) as an upright
    rectangle of the quad's mean width and height."""
    import cv2

    q = np.asarray(quad, np.float32).reshape(4, 2)
    w = 0.5 * (np.linalg.norm(q[2] - q[1]) + np.linalg.norm(q[3] - q[0]))
    h = 0.5 * (np.linalg.norm(q[1] - q[0]) + np.linalg.norm(q[2] - q[3]))
    w, h = max(1, int(round(w))), max(1, int(round(h)))
    src = np.float32([q[1], q[2], q[3], q[0]])
    dst = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    m = cv2.getPerspectiveTransform(src, dst)
    return cv2.warpPerspective(im, m, (w, h), flags=cv2.INTER_LINEAR)


def words_of(im, polys, tags, labels, source):
    out = []
    for k, (q, tag, txt) in enumerate(zip(polys, tags, labels)):
        if tag or not txt.strip():
            continue
        out.append((cut_word(im, q), txt, f"{source}#{k}"))
    return out


def eval_words():
    from fots.data.annotations import parse_icdar_lines

    out = []
    with np.load(HELDOUT) as z:
        for im, name, text in zip(z["images"], z["names"], z["gt_texts"]):
            polys, tags, labels = parse_icdar_lines(str(text).splitlines(), roll_icdar=False)
            out += words_of(im, polys, tags, labels, str(name))
    return out


def train_words():
    import cv2

    from fots.data.annotations import load_annotation

    with open(TRAIN_LIST) as f:
        names = [os.path.basename(line.strip()) for line in f if line.strip()][:TRAIN_SCENES]
    paths = [os.path.join(SYNTH_BIG, n) for n in names]
    if not all(os.path.exists(p) for p in paths):
        subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synth_dataset.py"),
                        "--out", SYNTH_BIG, "--n", "128", "--n_eval", "16", "--seed", "7"],
                       check=True, cwd=REPO)
    out = []
    for p in paths:
        im = cv2.imread(p)
        if im is None:
            raise RuntimeError(f"cannot decode {p}")
        polys, tags, labels = load_annotation(p, im.shape[:2])
        out += words_of(im, polys, tags, labels, os.path.relpath(p, REPO))
    return out


def write_archive(path: str, splits) -> None:
    crops, texts, split, sources = [], [], [], []
    for name, words in splits:
        for im, txt, src in words:
            crops.append(np.ascontiguousarray(im, np.uint8))
            texts.append(txt)
            split.append(name)
            sources.append(src)
    shapes = np.asarray([c.shape for c in crops], np.int32)
    sizes = np.asarray([c.size for c in crops], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    np.savez_compressed(path, pixels=np.concatenate([c.ravel() for c in crops]),
                        shapes=shapes, offsets=offsets, texts=np.asarray(texts),
                        split=np.asarray(split), sources=np.asarray(sources))


def fots_recognizer():
    """``FOTSRecognizerTrainer`` with the shipped snapshot's weights."""
    import jax

    from fots.checkpoint import load_serving_params
    from fots.train_ocr import FOTSRecognizerTrainer

    trainer = FOTSRecognizerTrainer(norm_height=NORM_HEIGHT)
    variables = {"params": trainer.state.params, "batch_stats": trainer.state.batch_stats}
    variables, _ = load_serving_params(SNAPSHOT, variables)
    trainer.state = trainer.state.replace(
        params=jax.tree_util.tree_map(np.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return trainer


def run_fots(words) -> dict:
    import cv2

    from fots.data.ocr_crops import ocr_crop_generator
    from fots.ocr_eval import OCRMetrics

    trainer = fots_recognizer()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        lst = os.path.join(tmp, "gt.txt")
        with open(lst, "w", encoding="utf-8") as f:
            for i, (im, txt, _) in enumerate(words):
                name = f"crop_{i:04d}.png"
                cv2.imwrite(os.path.join(tmp, name), im)
                f.write(f'{name}, "{txt}"\n')
        for run, beam in RUNS.items():
            metrics = OCRMetrics()
            crops = []
            gen = ocr_crop_generator(lst, codec=trainer.codec, batch_size=4,
                                     norm_height=NORM_HEIGHT, in_train=False)
            for batch in gen:
                preds = trainer.predict_texts(batch["images"], beam=beam)
                for p, gt, width in zip(preds, batch["texts"],
                                        [batch["images"].shape[2]] * len(preds)):
                    metrics.add(p, gt)
                    crops.append({"gt": gt, "pred": p, "bucket_width": int(width)})
            runs[run] = {"beam": beam, "summary": metrics.summary(),
                         "correct": metrics.correct, "crops": crops}
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default=ASSETS)
    args = ap.parse_args(argv)
    import cv2
    import jax

    evals, trains = eval_words(), train_words()
    os.makedirs(args.out_dir, exist_ok=True)
    npz = os.path.join(args.out_dir, "ocr_crops_u8.npz")
    write_archive(npz, [("eval", evals), ("train", trains)])
    print(f"wrote {npz}: {len(evals)} eval and {len(trains)} train crops "
          f"({os.path.getsize(npz) / 1e6:.2f} MB)")
    result = {"snapshot": os.path.relpath(SNAPSHOT, REPO),
              "crops": os.path.relpath(npz, REPO), "split": "eval",
              "norm_height": NORM_HEIGHT, "batch_size": 4, "precision": "f32",
              "platform": jax.default_backend(), "jax": jax.__version__,
              "opencv": cv2.__version__, "runs": run_fots(evals)}
    out = os.path.join(args.out_dir, "ocr_eval_fots_cpu.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1, ensure_ascii=False)
    print(f"wrote {out}")
    for name, run in result["runs"].items():
        print(name, run["correct"], run["summary"]["total"], run["summary"]["accuracy"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
