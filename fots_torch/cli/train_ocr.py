"""Recognition-branch training CLI, the counterpart of
``fots/cli/train_ocr.py``: trains the FOTS recognition head (over the
stem's features) on word crops with width bucketing; runs on the card
unless given ``-device cpu``.

The crops are a crop list's image files (``-train_list``) or a decoded
crop archive's (``-crops_npz``).  ``-model`` resumes a port ``step_N`` checkpoint (a serving snapshot ``.npz``
is taken as a warm start).  Steps and checkpoints as in
:mod:`fots_torch.cli.train_crnn`; the printed loss is the sum since the
last print over ``max(1, i % disp_interval + 1)``, as ``fots`` prints it.

Usage:
  python -m fots_torch.cli.train_ocr -crops_npz fots_torch/assets/ocr_crops_u8.npz \\
      -max_iters 1000 -save_path runs/ocr
"""

from __future__ import annotations

from fots_torch.cli.train_crnn import crop_parser, parse, run_crops, training_flags


def main(argv=None):
    """Returns the trainer."""
    parser = crop_parser(__doc__, "train")
    training_flags(parser)
    parser.add_argument("-norm_height", type=int, default=44)
    args = parse(parser, argv)

    from fots_torch.train_ocr import FOTSRecognizerTrainer

    trainer = FOTSRecognizerTrainer(lr=args.base_lr, norm_height=args.norm_height,
                                    seed=args.seed, device=args.device)
    return run_crops(args, trainer, args.norm_height, running_sum=True)


if __name__ == "__main__":
    main()
