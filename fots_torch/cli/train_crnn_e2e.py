"""CRNN training on ground-truth crops of whole scenes, the counterpart of
``fots/cli/train_crnn_e2e.py``: each batch's ground-truth words are
RoIRotated out of the images into 32-pixel strips for an OwnModel's CRNN
branch.  Runs on the card unless given ``-device cpu``.

The readers decode the list's scene files, or take their pixels from
``-images_npz`` (``images`` u8 [N, h, w, 3] BGR and ``names``, matched by
basename), as ``fots_torch.cli.train_joint`` does; the ground truth comes
from the annotation file beside each entry.  ``-model`` resumes a port
``step_N`` checkpoint; steps, prints and checkpoints as in
:mod:`fots_torch.cli.train_crnn`.

Usage:
  python -m fots_torch.cli.train_crnn_e2e -train_list data/synth_big_train.txt \\
      -save_path runs/crnn_e2e
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Returns the trainer."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-train_list", required=True)
    parser.add_argument("-images_npz", default=None,
                        help="archive of the list's decoded images (default: read the files)")
    parser.add_argument("-batch_size", type=int, default=2)
    parser.add_argument("-input_size", type=int, default=512)
    parser.add_argument("-base_lr", type=float, default=1e-4)
    parser.add_argument("-max_iters", type=int, default=10000)
    parser.add_argument("-disp_interval", type=int, default=10)
    parser.add_argument("-eval_interval", type=int, default=500)
    parser.add_argument("-num_readers", type=int, default=2)
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-save_path", default=None, help="checkpoint dir")
    parser.add_argument("-checkpoint_every", type=int, default=1000)
    parser.add_argument("-model", default=None,
                        help="port checkpoint to resume (step_N or a run directory)")
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    args = parser.parse_args(argv)

    from fots_torch.data.detection import detection_batches
    from fots_torch.train_ocr import CRNNE2ETrainer, load_weights, train_loop

    trainer = CRNNE2ETrainer(lr=args.base_lr, seed=args.seed, device=args.device)
    if args.model:
        print(f"resumed from {args.model} at step {load_weights(trainer, args.model)}",
              flush=True)
    batches = detection_batches(args.train_list, args.images_npz, num_workers=args.num_readers,
                                input_size=args.input_size, batch_size=args.batch_size,
                                seed=args.seed)
    try:
        return train_loop(trainer, batches, args.max_iters, args.disp_interval, args.save_path,
                          args.checkpoint_every, args.eval_interval)
    finally:
        batches.stop()


if __name__ == "__main__":
    main()
