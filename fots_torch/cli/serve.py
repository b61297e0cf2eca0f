"""Batched throughput serving CLI, the counterpart of ``fots/cli/serve.py``.

Serves the ``*.jpg`` files of ``-test_folder`` (sorted, read with
:func:`fots_torch.imageio.imread` as each batch is reached; a file that
reads as nothing is skipped), or an archive of decoded images
(``-images_npz``: ``images`` u8 [N, h, w, 3] BGR and ``names``), in
fixed-shape letterboxed batches through ``FOTSInference.stream`` and writes
``<name>.json`` per image (its boxes in source-image pixels and texts).
``-h5`` serves the reference's torch weights.  ``-n_data N [-n_model M]``
serves on a mesh of N x M cards, one process a card under torchrun: each
rank decodes and serves its rows of every batch, rank 0 writes the files.

Usage:
  python -m fots_torch.cli.serve -model artifacts/serving_params.npz \\
      -test_folder data/synth/ -output out/ -batch 16
  torchrun --nproc-per-node 4 -m fots_torch.cli.serve -n_data 4 ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-model", default=None,
                        help=".npz serving snapshot, or a fots_torch.cli.train_joint "
                             "checkpoint directory (step_N or the run directory)")
    parser.add_argument("-h5", default=None, help="reference torch weights (.h5)")
    parser.add_argument("-segm_thresh", type=float, default=0.5)
    parser.add_argument("-test_folder", default=None, help="folder of *.jpg images")
    parser.add_argument("-images_npz", default=None,
                        help="instead of -test_folder: archive of decoded images (images, "
                             "names)")
    parser.add_argument("-output", default="./out")
    parser.add_argument("-batch", type=int, default=8)
    parser.add_argument("-height", type=int, default=704)
    parser.add_argument("-width", type=int, default=1280)
    parser.add_argument("-mixed_precision", action="store_true", default=True)
    parser.add_argument("-f32", dest="mixed_precision", action="store_false",
                        help="disable bf16 inference")
    parser.add_argument("-n_data", type=int, default=None,
                        help="data-parallel serving mesh size (cards; under torchrun)")
    parser.add_argument("-n_model", type=int, default=1,
                        help="cards the vocabulary head's classes split over (with -n_data; "
                             "without it the engine serves on one device, as fots's)")
    parser.add_argument("-split_words", action="store_true")
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    args = parser.parse_args(argv)
    if bool(args.test_folder) == bool(args.images_npz):
        parser.error("give one of -test_folder and -images_npz")

    from fots_torch.cli.detect import folder_images, load_engine
    from fots_torch.imageio import imread
    from fots_torch.parallel import mesh as pmesh

    if (args.n_data or 1) > 1 and pmesh.init_from_env(args.device) == 1:
        parser.error(f"-n_data above 1 needs one process a card: run under "
                     f"torchrun --nproc-per-node {args.n_data * args.n_model}")
    engine = load_engine(args.model, args.h5, segm_thresh=args.segm_thresh,
                         mixed_precision=args.mixed_precision, device=args.device,
                         n_data=args.n_data, n_model=args.n_model)
    main_rank = pmesh.is_main(engine.mesh)
    if main_rank:
        os.makedirs(args.output, exist_ok=True)

    def stem(path):
        return os.path.splitext(os.path.basename(str(path)))[0]

    if args.images_npz:
        with np.load(args.images_npz) as z:
            images = z["images"]
            names = [stem(n) for n in z["names"]]

        def batches():
            for i in range(0, len(names), args.batch):
                yield names[i:i + args.batch], list(images[i:i + args.batch])
    else:
        paths = folder_images(args.test_folder)

        def batches():
            """Each chunk's files decoded as ``stream`` reaches it, so the
            decoding overlaps the card's work on the previous chunk.  On a
            mesh a rank decodes its own rows of a chunk only (the others
            stay None); a file of its rows that reads as nothing is served
            as a black image and not written, which the data ranks agree on
            before the chunk is served."""
            for i in range(0, len(paths), args.batch):
                chunk = paths[i:i + args.batch]
                if engine.mesh is None:
                    keep = [(stem(p), im) for p, im in ((p, imread(p)) for p in chunk)
                            if im is not None]
                    if keep:
                        yield [n for n, _ in keep], [im for _, im in keep]
                    continue
                rows = engine.shard.rows(len(chunk))
                mine = [imread(p) for p in chunk[rows]]
                read = pmesh.all_gather_objects([im is not None for im in mine], engine.mesh,
                                                pmesh.DATA_AXIS)
                ok = [flag for part in read for flag in part]
                images = [None] * len(chunk)
                images[rows.start:rows.start + len(mine)] = [
                    np.zeros((32, 32, 3), np.uint8) if im is None else im for im in mine]
                yield [stem(p) if good else None for p, good in zip(chunk, ok)], images

    total = 0
    t0 = time.perf_counter()
    with engine:
        for chunk, res_batch in engine.stream(batches(), serve_hw=(args.height, args.width),
                                              split_words=args.split_words,
                                              with_context=True):
            for name, res in zip(chunk, res_batch):
                if name is None:
                    continue
                if main_rank:
                    out = [{"box": r["box"].tolist(), "text": r["text"]} for r in res]
                    with open(os.path.join(args.output, name + ".json"), "w") as f:
                        json.dump(out, f)
                total += 1
    dt = time.perf_counter() - t0
    if main_rank:
        print(f"{total} images in {dt:.2f}s = {total / max(dt, 1e-9):.2f} images/sec")
    return total


if __name__ == "__main__":
    main()
