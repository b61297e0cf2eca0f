"""Write the held-out evaluation asset of the PyTorch port and ``fots``'s own
result on it.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/make_torch_eval_asset.py

Needs JAX and OpenCV (it runs ``fots`` on the CPU); the port's GPU machine has
neither, so it evaluates on what this writes:

- ``fots_torch/assets/heldout_eval_u8.npz``: the 16 held-out scenes of
  ``data/synth_big_eval.txt`` as ``cv2.imread`` decodes them (``images`` u8
  [16, 640, 960, 3] BGR), ``names`` (paths relative to the repository),
  ``gt_names`` and ``gt_texts`` (each scene's annotation file, name and
  content).  ``data/synth_big`` is regenerated from its seed when missing.
- ``fots_torch/assets/heldout_eval_fots_cpu.json``: ``fots.cli.eval_e2e`` on
  exactly those files with the shipped snapshot, f32 on the CPU: the summary,
  the match / detection / ground-truth counts and the per-image dump of four
  runs: default flags (``per_image``), ``-serve_hw 704x1280``, ``-beam 8`` and
  ``-split_words``.
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
EVAL_LIST = os.path.join(REPO, "data", "synth_big_eval.txt")
SYNTH_BIG = os.path.join(REPO, "data", "synth_big")
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
ASSETS = os.path.join(REPO, "fots_torch", "assets")
RUNS = {"per_image": [], "serve_704x1280": ["-serve_hw", "704x1280"],
        "beam8": ["-beam", "8"], "split_words": ["-split_words"]}


def scene_paths():
    """The list's scenes; the list holds absolute paths of another checkout,
    so only the file names are taken from it."""
    with open(EVAL_LIST) as f:
        names = [os.path.basename(line.strip()) for line in f if line.strip()]
    return [os.path.join(SYNTH_BIG, n) for n in names]


def ensure_synth_big(paths) -> None:
    if all(os.path.exists(p) for p in paths):
        return
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synth_dataset.py"),
                    "--out", SYNTH_BIG, "--n", "128", "--n_eval", "16", "--seed", "7"],
                   check=True, cwd=REPO)


def write_images(paths, out_path) -> None:
    import cv2

    from fots.data.annotations import gt_path_for_image

    images, gt_names, gt_texts = [], [], []
    for p in paths:
        im = cv2.imread(p)
        if im is None:
            raise RuntimeError(f"cannot decode {p}")
        images.append(im)
        txt_fn, txt_fn_gt = gt_path_for_image(p)
        gt = txt_fn_gt if os.path.exists(txt_fn_gt) else txt_fn
        with open(gt, encoding="utf-8") as f:
            gt_texts.append(f.read())
        gt_names.append(os.path.relpath(gt, REPO))
    np.savez_compressed(out_path, images=np.stack(images),
                        names=np.asarray([os.path.relpath(p, REPO) for p in paths]),
                        gt_names=np.asarray(gt_names), gt_texts=np.asarray(gt_texts))


def counts_of(dump) -> dict:
    """Match / detection / ground-truth totals of a per-image dump, through
    ``fots.evaluate.E2EMetrics``."""
    from fots.evaluate import E2EMetrics

    m = E2EMetrics()
    for rec in dump:
        dets = [(np.asarray(d["box"]), d["text"]) for d in rec["detections"]]
        gt = np.asarray([g["box"] for g in rec["gt"]]).reshape(-1, 8)
        m.add_image(dets, gt, [g["text"] for g in rec["gt"]])
    return {"tp": m.tp_all, "tp_e2e": m.tp_e2e_all, "tp_e2e_ed1": m.tp_e2e_ed1_all,
            "detections": m.detections_all, "gt": m.gt_all}


def run_fots(paths, extra_args) -> dict:
    from fots.cli import eval_e2e

    with tempfile.TemporaryDirectory() as tmp:
        lst, out, dump = (os.path.join(tmp, n) for n in ("eval.txt", "out.json", "dump.json"))
        with open(lst, "w") as f:
            f.writelines(p + "\n" for p in paths)
        eval_e2e.main(["-model", SNAPSHOT, "-images_list", lst, "-out_json", out,
                       "-dump_json", dump, *extra_args])
        with open(out) as f:
            summary = json.load(f)
        with open(dump) as f:
            images = json.load(f)
    for rec in images:
        rec["image"] = os.path.relpath(rec["image"], REPO)
    return {"args": list(extra_args), "summary": summary, "counts": counts_of(images),
            "images": images}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", default=ASSETS)
    args = ap.parse_args(argv)
    import cv2
    import jax

    paths = scene_paths()
    ensure_synth_big(paths)
    os.makedirs(args.out_dir, exist_ok=True)
    npz = os.path.join(args.out_dir, "heldout_eval_u8.npz")
    write_images(paths, npz)
    print(f"wrote {npz} ({os.path.getsize(npz) / 1e6:.2f} MB)")
    result = {"snapshot": os.path.relpath(SNAPSHOT, REPO),
              "images_list": os.path.relpath(EVAL_LIST, REPO),
              "precision": "f32", "platform": jax.default_backend(),
              "jax": jax.__version__, "opencv": cv2.__version__,
              "runs": {name: run_fots(paths, extra) for name, extra in RUNS.items()}}
    out = os.path.join(args.out_dir, "heldout_eval_fots_cpu.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out}")
    for name, run in result["runs"].items():
        print(name, run["counts"], {k: round(v, 4) for k, v in run["summary"].items()
                                    if k.endswith("hmean")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
