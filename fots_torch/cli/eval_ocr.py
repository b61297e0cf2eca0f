"""Recognition evaluation CLI, the counterpart of ``fots/cli/eval_ocr.py``:
exact-match accuracy, edit distance, per-script tables and the worst cases
of a recognizer over word crops; optional CSV and HTML reports.  Runs on the
card unless given ``-device cpu``.

The crops are the image files of a crop list (``-train_list``, as ``fots``
takes them), or come from a decoded crop archive (``-crops_npz``, split
``eval`` by default).  ``-model`` is a port ``step_N`` checkpoint of the ``-arch``'s
trainer, or for ``-arch fots`` also a serving snapshot (``.npz``).

Usage:
  python -m fots_torch.cli.eval_ocr -model artifacts/serving_params.npz -beam 8 \\
      -train_list fots_torch/assets/ocr_eval_png/gt.txt
"""

from __future__ import annotations

import json

from fots_torch.cli.train_crnn import crop_parser, parse


def evaluate(trainer, crops_npz: str, split: str, norm_height: int, beam: int = 0,
             train_list=None):
    """(OCRMetrics, per crop {"gt", "pred", "bucket_width"} in the
    generator's order) of ``trainer.predict_texts`` over ``train_list``'s
    crop files when given, else the archive's ``split``, batched as ``fots``
    batches it (4 a bucket, no augmentation)."""
    from fots_torch.data.ocr_crops import ocr_crop_generator
    from fots_torch.ocr_eval import OCRMetrics

    metrics, crops = OCRMetrics(), []
    for batch in ocr_crop_generator(crops_npz, codec=trainer.codec, batch_size=4,
                                    norm_height=norm_height, in_train=False, split=split,
                                    train_list=train_list):
        preds = trainer.predict_texts(batch["images"], beam=beam)
        for p, gt in zip(preds, batch["texts"]):
            metrics.add(p, gt)
            crops.append({"gt": gt, "pred": p, "bucket_width": int(batch["images"].shape[2])})
    return metrics, crops


def main(argv=None):
    """Returns (OCRMetrics, per-crop predictions)."""
    parser = crop_parser(__doc__, "eval")
    parser.add_argument("-model", default=None,
                        help="port checkpoint, or (-arch fots) a serving snapshot .npz")
    parser.add_argument("-arch", choices=("fots", "crnn"), default="fots")
    parser.add_argument("-norm_height", type=int, default=44)
    parser.add_argument("-out_csv", default=None)
    parser.add_argument("-out_html", default=None, help="HTML report of the worst cases")
    parser.add_argument("-worst", type=int, default=10)
    parser.add_argument("-beam", type=int, default=0,
                        help="prefix beam search width (0 = greedy argmax)")
    args = parse(parser, argv)

    from fots_torch.train_ocr import CRNNTrainer, FOTSRecognizerTrainer, load_weights

    if args.arch == "fots":
        trainer = FOTSRecognizerTrainer(norm_height=args.norm_height, device=args.device)
        norm_height = args.norm_height
    else:
        trainer = CRNNTrainer(device=args.device)
        norm_height = 32
    if args.model:
        load_weights(trainer, args.model)

    metrics, crops = evaluate(trainer, args.crops_npz, args.split, norm_height, args.beam,
                              args.train_list)
    print(json.dumps(metrics.summary(), indent=2, ensure_ascii=False))
    for d, gt, pred in metrics.worst_cases(args.worst):
        print(f"  ed={d}  gt={gt!r}  pred={pred!r}")
    if args.out_csv:
        metrics.to_csv(args.out_csv)
    if args.out_html:
        metrics.to_html(args.out_html, n_worst=max(args.worst, 50))
    return metrics, crops


if __name__ == "__main__":
    main()
