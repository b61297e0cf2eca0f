"""Joint detection + recognition training CLI, the counterpart of
``fots/cli/train_joint.py``; runs on the card unless given ``-device cpu``.

A model is initialised from ``-seed``, warm-started from the reference's
torch weights (``-h5``: every tensor but the vocabulary head's ``conv11`` /
``rnn``, as ``fots`` does), or resumed from a port checkpoint with
``-model`` (a ``step_N`` directory, or a run directory for its latest);
prefetch workers compute the EAST targets and the augmentation in NumPy;
``Trainer.train`` writes ``step_N`` checkpoints every ``-checkpoint_every``
steps and at the end, under ``-save_path`` beside ``train_config.json``
(which ``fots_torch.cli.eval_e2e -model <save_path>`` reads).

The readers decode the list's image files (:func:`fots_torch.imageio.
imread`) and read the ground truth from the annotation file beside each;
``-images_npz`` instead takes the pixels from a decoded archive (``images``
u8 [N, h, w, 3] BGR and ``names``, matched to the list entries by basename;
write a large one with ``np.savez``: the readers memory-map it, where each
would keep its own copy of a compressed one).  ``-debug DIR`` writes the
crops of the rois sampled for every ``-debug_every``-th step to DIR, named
and encoded as ``fots`` writes them.

Under torchrun (one process a card) it trains data-parallel on an
``-n_data`` x ``-n_model`` mesh, as ``fots`` does (``-n_data`` defaults to
the largest divisor of ``-batch_size`` that ``world // n_model`` allows;
``-n_model`` splits the vocabulary head's classes): rank 0 runs the readers
and sends each global batch to every rank, prints, and writes the
checkpoints, which are the files a single-card run writes.

Usage:
  python -m fots_torch.cli.train_joint -train_list data/synth_big_train.txt \\
      -batch_size 8 -input_size 512 -max_iters 300000 -save_path backup
  torchrun --nproc-per-node 4 -m fots_torch.cli.train_joint -n_data 4 ...
"""

from __future__ import annotations

import argparse
import json
import os


def build(argv=None):
    """Parse the flags, build the trainer (restored when ``-model`` is
    given) and write ``train_config.json``.  Returns (args, trainer)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-train_list", default="./data/ICDAR2015.txt")
    parser.add_argument("-images_npz", default=None,
                        help="archive of the list's decoded images (default: read the files)")
    parser.add_argument("-save_path", default="backup")
    parser.add_argument("-model", default=None,
                        help="port checkpoint to resume (step_N or a run directory)")
    parser.add_argument("-h5", default=None, help="reference torch weights to warm-start from")
    parser.add_argument("-batch_size", type=int, default=2)
    parser.add_argument("-num_readers", type=int, default=4)
    parser.add_argument("-input_size", type=int, default=512)
    parser.add_argument("-base_lr", type=float, default=1e-3)
    parser.add_argument("-max_iters", type=int, default=300000)
    parser.add_argument("-disp_interval", type=int, default=5)
    parser.add_argument("-checkpoint_every", type=int, default=10000)
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-gt_rois_only", action="store_true",
                        help="skip predicted-roi sampling (early-training mode)")
    parser.add_argument("-geo_type", type=int, default=0,
                        help="0=edge-distance targets, 1=row/col-scan variant")
    parser.add_argument("-no_aug", action="store_true",
                        help="disable augmentation (deterministic full-image samples; use "
                             "with -input_size -1 for overfit runs)")
    parser.add_argument("-ohem", action="store_true",
                        help="OHEM score loss (FOTS paper) instead of dice")
    parser.add_argument("-no_masked_norm", action="store_true",
                        help="whole-strip InstanceNorm statistics in the recognition head; "
                             "the choice is recorded in save_path/train_config.json")
    parser.add_argument("-n_data", type=int, default=None,
                        help="data-parallel mesh size (cards; under torchrun)")
    parser.add_argument("-n_model", type=int, default=1,
                        help="cards the vocabulary head's classes split over")
    parser.add_argument("-debug", default=None, metavar="DIR",
                        help="dump the sampled rois' image crops to DIR every -debug_every "
                             "steps (as fots's data/tshow hook)")
    parser.add_argument("-debug_every", type=int, default=1000)
    parser.add_argument("-device", default=None,
                        help="default: the card (fails without CUDA); 'cpu' runs the "
                             "kernels' plain versions")
    args = parser.parse_args(argv)
    mesh = _mesh(parser, args)

    from fots_torch.checkpoint import (import_torch_state_dict, load_torch_h5,
                                       restore_checkpoint)
    from fots_torch.codec import LabelCodec
    from fots_torch.parallel.mesh import is_main
    from fots_torch.train import Trainer

    trainer = Trainer(codec=LabelCodec(), learning_rate=args.base_lr, seed=args.seed,
                      use_predicted_rois=not args.gt_rois_only, ohem=args.ohem,
                      masked_norm=not args.no_masked_norm, device=args.device, mesh=mesh)
    main_rank = is_main(mesh)
    if main_rank:
        os.makedirs(args.save_path, exist_ok=True)
        with open(os.path.join(args.save_path, "train_config.json"), "w") as f:
            json.dump({"masked_norm": not args.no_masked_norm}, f)
    if args.h5 and os.path.exists(args.h5):
        # partial warm start without the vocabulary head, as fots does
        imported, skipped = import_torch_state_dict(load_torch_h5(args.h5), trainer.model,
                                                    skip_substrings=("conv11", "rnn"))
        if main_rank:
            print(f"warm-started {len(imported)} tensors from {args.h5} "
                  f"({len(skipped)} skipped)", flush=True)
    elif args.model:
        step = restore_checkpoint(args.model, trainer)
        if main_rank:
            print(f"resumed from {args.model} at step {step}", flush=True)
    return args, trainer


def _mesh(parser, args):
    """The training mesh of the flags under torchrun's process group, as
    ``fots`` sizes it; None on one device.  A usage error where the flags
    and the processes disagree."""
    from fots_torch.parallel import init_from_env, make_mesh

    world = init_from_env(args.device)
    if world == 1 and ((args.n_data or 1) > 1 or args.n_model > 1):
        parser.error(f"-n_data / -n_model above 1 need one process a card: run under "
                     f"torchrun --nproc-per-node {(args.n_data or 1) * args.n_model}")
    n_data = args.n_data
    if n_data is None:
        # the largest width that divides the batch, as fots picks it
        avail = max(1, world // max(1, args.n_model))
        n_data = max(d for d in range(1, avail + 1) if args.batch_size % d == 0)
    if args.batch_size % n_data:
        parser.error(f"-batch_size {args.batch_size} does not split over -n_data {n_data}")
    if n_data * args.n_model != world:
        parser.error(f"a {n_data}x{args.n_model} mesh needs {n_data * args.n_model} "
                     f"processes; torchrun started {world}")
    return make_mesh(n_data, args.n_model) if world > 1 else None


def run(args, trainer):
    """Train ``trainer`` as the flags say; returns it.  On a mesh rank 0
    reads and every rank trains on its batches."""
    from fots_torch.data.detection import detection_batches
    from fots_torch.data.prefetch import BroadcastBatches
    from fots_torch.parallel.mesh import is_main, object_group

    batches = None
    if is_main(trainer.mesh):
        batches = detection_batches(args.train_list, args.images_npz,
                                    num_workers=args.num_readers, input_size=args.input_size,
                                    batch_size=args.batch_size, seed=args.seed,
                                    geo_type=args.geo_type, augment=not args.no_aug)
    if trainer.mesh is not None:
        batches = BroadcastBatches(batches, object_group(trainer.mesh))
    try:
        trainer.train(batches, max_steps=args.max_iters, log_every=args.disp_interval,
                      checkpoint_dir=args.save_path, checkpoint_every=args.checkpoint_every,
                      debug_dir=args.debug, debug_every=args.debug_every)
    finally:
        batches.stop()
    return trainer


def main(argv=None):
    return run(*build(argv))


if __name__ == "__main__":
    main()
