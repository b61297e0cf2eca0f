"""Recognition-only training on one GPU (port of ``fots/train_ocr.py``).

Three trainers, each a model, ``torch.optim.Adam`` (optax's ``adam`` with
the same betas and eps 1e-8) and a ``step`` that applies one update:

- :class:`CRNNTrainer`: a :class:`~fots_torch.models.CRNN` over 32-pixel
  crops (Adam(lr));
- :class:`FOTSRecognizerTrainer`: the detector's stem and recognition head
  over ``norm_height``-pixel crops, crop -> stem (1/4 features) -> head ->
  CTC (Adam(lr, b1 0.5)); on the card the stem's CReLU-IN runs K2' + K3'
  and its backward K1'-bwd, the head's INs K1' with saved statistics and
  K1'-bwd;
- :class:`CRNNE2ETrainer`: an :class:`~fots_torch.models.OwnModel`'s CRNN
  branch on ground-truth rois RoIRotated out of the *images*
  (:func:`build_gt_crop_batch`; K4' packs the 3-channel f32 image).

CTC is :func:`fots_torch.losses.ctc_loss` over ``log_softmax`` of the
scores (the recognition head returns log-probs already), every frame,
blank 0.  Predictions decode greedily or, with ``beam > 0``, by prefix beam
search (:func:`fots_torch.ops.ctc_decode.beam_decode_text`).  The
recognition head's dropout draws from the trainer's CPU ``torch.Generator``
(``seed``), the roi height jitter from its ``np.random.Generator``.  A
trainer trains ``model`` when given one, else initialises it from ``seed``
with flax's defaults.  ``device=None`` trains on CUDA and raises without it;
``"cpu"`` runs the kernels' plain versions.  Checkpoints are the port's
``step_N`` directories (:func:`fots_torch.checkpoint.save_checkpoint`:
``model``, ``optimizer``, ``global_step``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fots_torch.codec import LabelCodec
from fots_torch.device import resolve_device, to_device_async
from fots_torch.geometry import quads_to_rrois
from fots_torch.losses import ctc_loss, repeat_infeasible_rows
from fots_torch.models.crnn import CRNN, init_crnn
from fots_torch.models.detector import FOTSDetector, init_detector
from fots_torch.models.own import OwnModel, init_own_model
from fots_torch.ops.ctc_decode import beam_decode_text
from fots_torch.ops.rroi_align import rroi_align, width_bucket
from fots_torch.roirotate import TRAIN_STRIP_BUCKETS


def _crop_ctc(logp, labels: np.ndarray, lengths: np.ndarray, roi_mask=None):
    """CTC over every frame of ``logp`` [N, T, K] for host ``labels`` [N, L]
    and ``lengths`` [N]."""
    t = logp.shape[1]
    rows = repeat_infeasible_rows(labels, lengths, np.full(len(lengths), t))
    return ctc_loss(logp, to_device_async(torch.from_numpy(np.asarray(labels)), logp.device),
                    torch.from_numpy(np.asarray(lengths)), roi_mask=roi_mask, optax_rows=rows)


class _OcrTrainer:
    """What the three trainers share: the device, the model in train mode
    (channels_last) with its Adam, the step count and the loss history."""

    def __init__(self, model: torch.nn.Module, codec: Optional[LabelCodec], lr: float,
                 betas, seed: int, device):
        self.device = resolve_device(device)
        self.codec = codec or LabelCodec()
        self.model = model.to(device=self.device, memory_format=torch.channels_last).train()
        self.optimizer = torch.optim.Adam(
            [p for p in self.model.parameters() if p.requires_grad], lr=lr, betas=betas,
            eps=1e-8)
        self._gen = torch.Generator().manual_seed(seed)  # dropout masks
        #: applied updates; a restored checkpoint sets it
        self.global_step = 0
        #: per step: its index, loss, samples, the model's input shape and the
        #: host clock after it
        self.history: List[Dict[str, float]] = []

    def _images(self, images) -> torch.Tensor:
        return to_device_async(torch.from_numpy(np.ascontiguousarray(images, np.float32)),
                               self.device)

    def _apply(self, loss, samples: int, shape) -> float:
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        value = float(loss.detach())
        self.history.append({"step": self.global_step, "loss": value, "samples": samples,
                             "shape": list(shape), "t": time.perf_counter()})
        self.global_step += 1
        return value

    def _decode(self, logp, beam: int) -> List[str]:
        if beam > 0:
            lp = logp.float().cpu().numpy()
            return [beam_decode_text(lp[i], self.codec, beam_width=beam)
                    for i in range(lp.shape[0])]
        return self.codec.decode_batch(torch.argmax(logp, dim=-1).cpu().numpy())


class _CropTrainer(_OcrTrainer):
    """A trainer over crop batches (:mod:`fots_torch.data.ocr_crops`): dicts
    of ``images`` [N, h, w, 3], ``labels`` [N, L], ``label_lengths`` [N];
    ``logp(images)`` is the subclass's model."""

    def loss(self, batch: Dict) -> torch.Tensor:
        return _crop_ctc(self.logp(batch["images"]), batch["labels"], batch["label_lengths"])

    def step(self, batch: Dict) -> float:
        return self._apply(self.loss(batch), len(batch["labels"]), batch["images"].shape)

    def predict_texts(self, images, beam: int = 0) -> List[str]:
        self.model.eval()
        try:
            with torch.no_grad():
                return self._decode(self.logp(images), beam)
        finally:
            self.model.train()


class CRNNTrainer(_CropTrainer):
    """Standalone CRNN trainer (32-pixel crops), Adam(lr)."""

    def __init__(self, codec: Optional[LabelCodec] = None, lr: float = 1e-4, seed: int = 0,
                 model: Optional[CRNN] = None, device=None):
        codec = codec or LabelCodec()
        if model is None:
            model = init_crnn(CRNN(nclass=codec.num_classes), torch.Generator().manual_seed(seed))
        super().__init__(model, codec, lr, (0.9, 0.999), seed, device)

    def logp(self, images) -> torch.Tensor:
        """log_softmax of the CRNN's scores [N, W/4 + 1, nclass] (the model's
        mode: train mode uses and updates BatchNorm's batch statistics)."""
        return F.log_softmax(self.model(self._images(images)), dim=-1)


class FOTSRecognizerTrainer(_CropTrainer):
    """The shared-backbone recognition branch on word crops: crop -> stem
    (1/4 features) -> recognition head -> CTC; Adam(lr, b1 0.5)."""

    def __init__(self, codec: Optional[LabelCodec] = None, lr: float = 1e-4,
                 norm_height: int = 44, seed: int = 0, model: Optional[FOTSDetector] = None,
                 device=None):
        codec = codec or LabelCodec()
        self.norm_height = norm_height
        if model is None:
            model = init_detector(FOTSDetector(nclass=codec.num_classes),
                                  torch.Generator().manual_seed(seed))
        super().__init__(model, codec, lr, (0.5, 0.999), seed, device)

    def logp(self, images) -> torch.Tensor:
        """Log-probs [N, W/4, nclass] of the head over the stem's features
        (train mode: channel dropout from the trainer's generator)."""
        feats = self.model.forward_features(self._images(images))
        return self.model.recognize(feats, None, self._gen)


def build_gt_crop_batch(gt_quads, labels, codec: LabelCodec, im_hw, rng=None,
                        pooled_height: int = 32, max_rois: int = 32, max_label: int = 64):
    """Ground-truth quads -> a fixed-shape roi batch for image-crop
    recognition: every in-bounds quad whose text does not start with
    ``##`` becomes an rroi (with a +-2 px height jitter per image when
    ``rng`` is given); labels are CTC-encoded.  Returns (rois [R, 6], labels
    [R, L], lengths [R], mask [R], width, texts): ``width`` is the strip
    bucket of the largest aspect at ``pooled_height``, ``texts`` the kept
    transcriptions (the valid roi slots)."""
    H, W = im_hw
    rois_list, texts = [], []
    for bid, (quads, lbs) in enumerate(zip(gt_quads, labels)):
        if len(quads) == 0:
            continue
        jitter = int(rng.integers(-2, 3)) if rng is not None else 0
        rr = quads_to_rrois(np.asarray(quads), bid, height_jitter=jitter)
        for gi in range(rr.shape[0]):
            txt = lbs[gi]
            if txt.startswith("##"):
                continue
            q = np.asarray(quads[gi])
            if q[:, 0].max() > W or q[:, 1].max() > H or q.min() < 0:
                continue
            if rr[gi, 3] <= 0 or rr[gi, 4] <= 0:
                continue
            rois_list.append(rr[gi])
            texts.append(txt)
    n = min(len(rois_list), max_rois)
    rois = np.zeros((max_rois, 6), np.float32)
    mask = np.zeros((max_rois,), np.float32)
    if n:
        rois[:n] = np.asarray(rois_list[:n], np.float32)
        mask[:n] = 1.0
        ratio = (rois[:n, 4] / np.maximum(rois[:n, 3], 1e-6)).max()
        width = width_bucket(int(math.ceil(pooled_height * float(ratio))),
                             buckets=TRAIN_STRIP_BUCKETS)
    else:
        width = width_bucket(pooled_height, buckets=TRAIN_STRIP_BUCKETS)
    rois[n:] = [0, 8.0, 8.0, 8.0, 8.0, 0.0]
    labels_mat, lengths = codec.encode_padded(texts[:n] + [""] * (max_rois - n), max_label)
    lengths[n:] = 0
    return rois, labels_mat, lengths, mask, int(width), texts[:n]


class CRNNE2ETrainer(_OcrTrainer):
    """An OwnModel's CRNN branch trained on ground-truth crops RoIRotated
    out of whole scenes (32-pixel strips of the normalised image), Adam(lr);
    ``predict`` decodes instead."""

    def __init__(self, codec: Optional[LabelCodec] = None, lr: float = 1e-4, seed: int = 0,
                 model: Optional[OwnModel] = None, device=None):
        codec = codec or LabelCodec()
        if model is None:
            model = init_own_model(OwnModel(nclass=codec.num_classes),
                                   torch.Generator().manual_seed(seed))
        super().__init__(model, codec, lr, (0.9, 0.999), seed, device)
        self._rng = np.random.default_rng(seed)  # roi height jitter

    def logp(self, images, rois, width: int) -> torch.Tensor:
        """log_softmax of the CRNN's scores over ``rois`` [R, 6] cropped
        from ``images`` [B, H, W, 3] (normalised) into 32 x ``width``."""
        crops = rroi_align(self._images(images),
                           to_device_async(torch.from_numpy(np.asarray(rois, np.float32)),
                                           self.device), 32, width, 1.0)
        return F.log_softmax(self.model.ocr_forward(crops), dim=-1)

    def loss(self, batch, rng=None):
        """(loss, the :func:`build_gt_crop_batch` tuple) of a
        :class:`~fots_torch.data.detection.DetectionBatch`."""
        crop = build_gt_crop_batch(batch.gt_quads, batch.labels, self.codec,
                                   batch.images.shape[1:3], rng=rng)
        rois, labels, lengths, mask, width, _ = crop
        logp = self.logp(batch.images, rois, width)
        return _crop_ctc(logp, labels, lengths,
                         to_device_async(torch.from_numpy(mask), self.device)), crop

    def step(self, batch) -> float:
        """batch: a :class:`~fots_torch.data.detection.DetectionBatch`."""
        loss, crop = self.loss(batch, self._rng)
        return self._apply(loss, int(crop[3].sum()), (len(crop[3]), 32, crop[4], 3))

    def predict(self, batch):
        """Eval mode: (decoded texts, ground-truth texts) of the valid rois."""
        rois, _, _, mask, width, gts = build_gt_crop_batch(
            batch.gt_quads, batch.labels, self.codec, batch.images.shape[1:3])
        self.model.eval()
        try:
            with torch.no_grad():
                texts = self._decode(self.logp(batch.images, rois, width), 0)
        finally:
            self.model.train()
        return texts[:int(mask.sum())], gts


def load_weights(trainer: _OcrTrainer, path: str) -> int:
    """Put ``path``'s weights into ``trainer``: a port ``step_N`` checkpoint
    (or a run directory's latest) restores weights, statistics, Adam's state
    and the step; a serving snapshot (``.npz``, the detector's weights) only
    the weights, for the detector-based trainers.  Returns the step."""
    from fots_torch.checkpoint import load_flat, load_serving_params, restore_checkpoint

    if path.endswith(".npz"):
        if not isinstance(trainer.model, FOTSDetector):
            raise ValueError(f"{path}: a serving snapshot holds a detector's weights, not "
                             f"a {type(trainer.model).__name__}'s")
        flat, _, _ = load_serving_params(path)
        load_flat(trainer.model, flat)
        return 0
    return restore_checkpoint(path, trainer)


def train_loop(trainer: _OcrTrainer, batches, max_iters: int, disp_interval: int = 10,
               save_path: Optional[str] = None, checkpoint_every: int = 1000,
               eval_interval: int = 0, running_sum: bool = False) -> _OcrTrainer:
    """The recognition CLIs' loop, numbered as ``fots``'s: ``i`` counts this
    run's batches from 0, so a resumed trainer takes ``max_iters`` more
    steps (its history goes on from its global step).  Every
    ``disp_interval`` steps it prints step i's loss, or with ``running_sum``
    (``train_ocr``) the losses summed since the last print divided by
    ``max(1, i % disp_interval + 1)``; with ``eval_interval``
    (:class:`CRNNE2ETrainer`) the exact reads of the batch just trained every
    ``eval_interval`` steps; with ``save_path`` a checkpoint labelled ``i``
    after every step i > 0 with i % ``checkpoint_every`` == 0, and one
    labelled ``min(i + 1, max_iters)`` at the end."""
    from fots_torch.checkpoint import save_checkpoint

    i, running = 0, 0.0
    for i, batch in enumerate(batches):
        if i >= max_iters:
            break
        loss = trainer.step(batch)
        running += loss
        if disp_interval and i % disp_interval == 0:
            shown = running / max(1, i % disp_interval + 1) if running_sum else loss
            print(f"step {i} ctc_loss {shown:.4f}", flush=True)
            running = 0.0
        if eval_interval and i > 0 and i % eval_interval == 0:
            preds, gts = trainer.predict(batch)
            print(f"  eval: {sum(p == g for p, g in zip(preds, gts))}/{len(gts)} exact",
                  flush=True)
        if save_path and i > 0 and i % checkpoint_every == 0:
            save_checkpoint(save_path, trainer, i)
    if save_path:
        print(f"saved {save_checkpoint(save_path, trainer, min(i + 1, max_iters))}", flush=True)
    return trainer
