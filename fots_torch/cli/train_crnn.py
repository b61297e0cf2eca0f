"""Standalone CRNN training CLI, the counterpart of
``fots/cli/train_crnn.py``; runs on the card unless given ``-device cpu``.

The word crops are the image files of a crop list (``-train_list``, a
``gt.txt`` of ``file, "text"`` lines, as ``fots`` takes them), or come from
a decoded crop archive (``-crops_npz``, one split of it;
``tools/make_torch_ocr_asset.py`` writes ``fots_torch/assets/ocr_crops_u8.npz``,
the default).  ``-model`` resumes a port ``step_N`` checkpoint (or
a run directory's latest).  Steps are numbered as ``fots`` numbers them:
``i`` counts this run's batches from 0, so a resumed run takes
``-max_iters`` more steps; ``-save_path/step_i`` is written after every
step i > 0 with i % ``-checkpoint_every`` == 0, and ``step_{min(i + 1,
max_iters)}`` at the end.  Each printed loss is the step's own.

Usage:
  python -m fots_torch.cli.train_crnn -train_list crops/gt.txt -max_iters 1000 \\
      -save_path runs/crnn
"""

from __future__ import annotations

import argparse
import os

DEFAULT_CROPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "assets", "ocr_crops_u8.npz")


def crop_parser(description: str, split: str) -> argparse.ArgumentParser:
    """The flags the crop CLIs share."""
    parser = argparse.ArgumentParser(description=description,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-train_list", default=None,
                        help="a crop list (gt.txt of file, \"text\" lines) of image files; "
                             "read instead of -crops_npz")
    parser.add_argument("-crops_npz", default=DEFAULT_CROPS, help="decoded crop archive")
    parser.add_argument("-split", default=split, choices=("train", "eval"),
                        help="the archive's split to read")
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    return parser


def training_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-batch_size", type=int, default=8)
    parser.add_argument("-base_lr", type=float, default=1e-4)
    parser.add_argument("-max_iters", type=int, default=10000)
    parser.add_argument("-disp_interval", type=int, default=10)
    parser.add_argument("-num_readers", type=int, default=2)
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-save_path", default=None, help="checkpoint dir")
    parser.add_argument("-checkpoint_every", type=int, default=1000)
    parser.add_argument("-model", default=None,
                        help="port checkpoint to resume (step_N or a run directory)")


def parse(parser: argparse.ArgumentParser, argv):
    args = parser.parse_args(argv)
    if args.train_list and not os.path.isfile(args.train_list):
        parser.error(f"-train_list: no such file {args.train_list!r}")
    return args


def run_crops(args, trainer, norm_height: int, running_sum: bool = False):
    """Train ``trainer`` on the crop batches (the list's files, or the
    archive's split) as the flags say."""
    from fots_torch.data.ocr_crops import ocr_crop_batches
    from fots_torch.train_ocr import load_weights, train_loop

    if args.model:
        print(f"resumed from {args.model} at step {load_weights(trainer, args.model)}",
              flush=True)
    batches = ocr_crop_batches(args.crops_npz, num_workers=args.num_readers,
                               batch_size=args.batch_size, norm_height=norm_height,
                               seed=args.seed, split=args.split, codec=trainer.codec,
                               train_list=args.train_list)
    try:
        return train_loop(trainer, batches, args.max_iters, args.disp_interval, args.save_path,
                          args.checkpoint_every, running_sum=running_sum)
    finally:
        batches.stop()


def main(argv=None):
    """Returns the trainer."""
    parser = crop_parser(__doc__, "train")
    training_flags(parser)
    args = parse(parser, argv)

    from fots_torch.train_ocr import CRNNTrainer

    trainer = CRNNTrainer(lr=args.base_lr, seed=args.seed, device=args.device)
    return run_crops(args, trainer, 32)


if __name__ == "__main__":
    main()
