"""Joint detection + recognition training on one GPU (port of
``fots/train.py``).

One step (:func:`train_step`): detector forward, EAST loss, RoIRotate of the
shared ``focr`` features, the recognition head with masked InstanceNorm,
CTC over the reference's frame window, backward, then Adam(lr, betas=(0.5,
0.999), eps=1e-8) — ``optax.adam(lr, b1=0.5, b2=0.999)``.  Every kernel of
the path is a ``torch.autograd.Function`` over hand-written CUDA: K1'/K1'-bwd
(InstanceNorm), K2'/K3' forward and K1'-bwd backward (the stem's CReLU-IN),
K4'/K4'-bwd (the focr pack).

The host side is ``fots``'s: roi sampling (:mod:`fots_torch.roirotate`) on
the previous step's detached predictions, shipped as 128 random candidate
pixels per image (:func:`extract_roi_candidates`), and four compact upload
buffers (:func:`pack_host_batch`).  :meth:`Trainer.train` prepares step
i + 1 on a prefetch thread while the card runs step i.

Randomness: dropout masks and candidate priorities are drawn on the CPU
from the trainer's ``torch.Generator`` (so a CUDA run and a CPU run of
equal seeds draw the same), roi sampling from its ``np.random.Generator``.
Left out so far: checkpoint resume, the debug crop dumps, initialisation
from scratch (a run starts from a snapshot), the training CLI and its jpg
data pipeline.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from fots_torch.codec import LabelCodec
from fots_torch.device import resolve_device, to_device_async
from fots_torch.losses import ctc_loss, detection_loss, repeat_infeasible_rows
from fots_torch.models.detector import FOTSDetector
from fots_torch.ops.rroi_align import rroi_align
from fots_torch.pipeline import HostCopy
from fots_torch.roirotate import (MAX_LABEL_LEN, MAX_ROIS, POOLED_HEIGHT, RoiBatch,
                                  sample_rois)

METRIC_KEYS = ("loss", "segm_loss", "angle_loss", "iou_loss", "ctc_loss")
ROI_CANDIDATES_K = 128  # random candidate pixels shipped to the host sampler


@dataclass
class DetectionBatch:
    """A host training batch, with the fields of ``fots.data.detection.
    DetectionBatch``."""

    images: np.ndarray          # [B, H, W, 3] float32, x / 128 - 1
    score_maps: np.ndarray      # [B, H/4, W/4] float32
    geo_maps: np.ndarray        # [B, H/4, W/4, 5] float32 (4 distances, angle)
    training_masks: np.ndarray  # [B, H/4, W/4] uint8
    gt_idxs: np.ndarray         # [B, H/4, W/4] int64, pixel -> word index
    gt_quads: List[List[np.ndarray]]
    labels: List[List[str]] = field(default_factory=list)


def asset_batch(images_u8: np.ndarray, targets, order) -> DetectionBatch:
    """A :class:`DetectionBatch` of scenes ``order`` (indices, repeats
    allowed) from u8 images [N, H, W, 3] and the arrays of
    ``fots_torch/assets/train_targets.npz``."""
    counts = np.asarray(targets["gt_counts"])
    starts = np.concatenate([[0], np.cumsum(counts)])
    quads = np.asarray(targets["gt_quads"])
    words = [str(t) for t in targets["gt_labels"]]
    order = list(order)
    return DetectionBatch(
        images=images_u8[order].astype(np.float32) / 128.0 - 1.0,
        score_maps=np.asarray(targets["score_maps"])[order],
        geo_maps=np.asarray(targets["geo_maps"])[order],
        training_masks=np.asarray(targets["training_masks"])[order],
        gt_idxs=np.asarray(targets["gt_idxs"])[order],
        gt_quads=[list(quads[starts[i]:starts[i + 1]]) for i in order],
        labels=[words[starts[i]:starts[i + 1]] for i in order])


def pack_host_maps(batch) -> tuple:
    """The image and target buffers of :func:`pack_host_batch` (they do not
    depend on the roi sampling)."""
    b = batch.images.shape[0]
    images_u8 = np.clip(np.rint((batch.images + 1.0) * 128.0), 0, 255).astype(np.uint8)
    maps_u8 = np.concatenate([batch.score_maps.reshape(b, -1).astype(np.uint8),
                              batch.training_masks.reshape(b, -1).astype(np.uint8)], axis=1)
    maps_f16 = np.concatenate(
        [np.ascontiguousarray(batch.geo_maps[..., :4], np.float16).reshape(b, -1),
         np.ascontiguousarray(batch.geo_maps[..., 4], np.float16).reshape(b, -1)], axis=1)
    return images_u8, maps_u8, maps_f16


def pack_rois(roi_batch: RoiBatch) -> np.ndarray:
    """The roi buffer of :func:`pack_host_batch` (label ids are exact in f32)."""
    return np.concatenate([roi_batch.rois.ravel(),
                           roi_batch.labels.ravel().astype(np.float32),
                           roi_batch.label_lengths.astype(np.float32),
                           roi_batch.roi_mask]).astype(np.float32)


def pack_host_batch(batch, roi_batch: RoiBatch) -> tuple:
    """The host batch as four compact buffers (as ``fots`` packs it):
    images as uint8 (exact for x / 128 - 1 of u8 pixels); score map +
    training mask as one uint8 buffer; geometry + angle as float16; the roi
    data as one flat f32 buffer."""
    return (*pack_host_maps(batch), pack_rois(roi_batch))


def unpack_device_batch(images_u8, maps_u8, maps_f16, rep, input_hw,
                        max_rois: int = MAX_ROIS, max_label: int = MAX_LABEL_LEN
                        ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_host_batch`, on the buffers' device."""
    h, w = input_hw
    b = maps_u8.shape[0]
    hs, ws = h // 4, w // 4
    n = hs * ws
    r0 = max_rois * 6
    r1 = r0 + max_rois * max_label
    r2 = r1 + max_rois
    return {
        "images": images_u8.float() / 128.0 - 1.0,
        "score_maps": maps_u8[:, :n].reshape(b, hs, ws).float(),
        "training_masks": maps_u8[:, n:].reshape(b, hs, ws).float(),
        "geo_maps": maps_f16[:, :n * 4].reshape(b, hs, ws, 4).float(),
        "angle_gt": maps_f16[:, n * 4:].reshape(b, hs, ws).float(),
        "rois": rep[:r0].reshape(max_rois, 6),
        "labels": rep[r0:r1].reshape(max_rois, max_label).long(),
        "label_lengths": rep[r1:r2].long(),
        "roi_mask": rep[r2:r2 + max_rois],
    }


def ctc_frame_count(rois: np.ndarray, roi_mask: np.ndarray, strip_width: int) -> int:
    """The reference's CTC frame window T = ceil(11 * max aspect) over the
    valid rois, in [1, strip_width] (f32 arithmetic, as ``fots`` computes
    it on the device).  Frames past T are masked out of the CTC, so the
    objective does not depend on the strip bucket."""
    rois = np.asarray(rois, np.float32)
    aspect = np.where(np.asarray(roi_mask) > 0,
                      rois[:, 4] / np.maximum(rois[:, 3], np.float32(1e-6)), np.float32(0))
    t = np.ceil(np.float32(POOLED_HEIGHT) * aspect.max())
    return int(np.clip(t, 1.0, float(strip_width)))


def extract_roi_candidates(segm_pred, score_gt, geo_pred, angle_pred,
                           k: int = ROI_CANDIDATES_K, priorities=None,
                           generator: Optional[torch.Generator] = None):
    """``k`` random pixels per image where ``segm_pred > 0.5`` inside ground
    -truth text, without replacement (top-k over uniform priorities, drawn
    on the CPU from ``generator`` unless given as ``priorities`` [B, H*W]),
    packed channel-first [B, 8, k] as ``(score, d0..d3, sin, cos,
    flat_idx)``; slots past the valid pixels carry score -1."""
    b, h, w = segm_pred.shape
    k = min(k, h * w)
    valid = ((segm_pred > 0.5) & (score_gt > 0)).reshape(b, h * w)
    if priorities is None:
        priorities = torch.rand((b, h * w), generator=generator)
    pri = torch.where(valid, to_device_async(priorities.float(), segm_pred.device),
                      torch.full((), -1.0, device=segm_pred.device))
    top_pri, idx = torch.topk(pri, k, dim=1)
    flat_score = torch.gather(segm_pred.reshape(b, h * w), 1, idx)
    score = torch.where(top_pri > 0, flat_score, torch.full_like(flat_score, -1.0))
    g = torch.gather(geo_pred.reshape(b, h * w, 4), 1, idx[..., None].expand(b, k, 4))
    a = torch.gather(angle_pred.reshape(b, h * w, 2), 1, idx[..., None].expand(b, k, 2))
    packed = torch.cat([score[..., None], g, a, idx[..., None].float()], dim=-1)
    return packed.transpose(1, 2).contiguous().float()


def train_losses(model: FOTSDetector, batch: Dict[str, torch.Tensor], strip_width: int,
                 ctc_frames: int, generator: Optional[torch.Generator] = None,
                 multi_scale: bool = True, ohem: bool = False, masked_norm: bool = True,
                 optax_rows=None):
    """The step's loss (``fots/train.py`` ``loss_fn``): returns (total, the
    five metric terms by :data:`METRIC_KEYS`, the detector's outputs).
    ``ctc_frames``: :func:`ctc_frame_count` of the batch's rois;
    ``optax_rows``: :func:`fots_torch.losses.repeat_infeasible_rows` of them."""
    out = model(batch["images"], generator)
    det = detection_loss(out, batch["score_maps"], batch["training_masks"],
                         batch["geo_maps"], batch["angle_gt"], multi_scale=multi_scale,
                         ohem=ohem)
    rois = batch["rois"]
    strips = rroi_align(out["focr"], rois, POOLED_HEIGHT, strip_width, 0.25)
    valid_w = None
    if masked_norm:
        aspect = rois[:, 4] / torch.clamp_min(rois[:, 3], 1e-6)
        valid_w = torch.clamp(torch.ceil(POOLED_HEIGHT * aspect), 1, strip_width).to(torch.int32)
    logp = model.recognize(strips, valid_w, generator)
    frames = torch.full((logp.shape[0],), ctc_frames, dtype=torch.int64)  # on the host
    ctc = ctc_loss(logp, batch["labels"], batch["label_lengths"], frames, batch["roi_mask"],
                   optax_rows=optax_rows)
    total = det["total"] + ctc
    terms = {"loss": total, "segm_loss": det["segm"], "angle_loss": det["angle"],
             "iou_loss": det["iou"], "ctc_loss": ctc}
    return total, terms, out


def train_step(model: FOTSDetector, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], strip_width: int, ctc_frames: int,
               optax_rows=None, generator: Optional[torch.Generator] = None,
               multi_scale: bool = True, ohem: bool = False, masked_norm: bool = True):
    """One optimisation step.  Returns (metric vector [5] in
    :data:`METRIC_KEYS` order, next step's roi candidates [B, 8, k]), both
    still on the device."""
    optimizer.zero_grad(set_to_none=True)
    total, terms, out = train_losses(model, batch, strip_width, ctc_frames, generator,
                                     multi_scale, ohem, masked_norm, optax_rows)
    total.backward()
    optimizer.step()
    with torch.no_grad():
        cands = extract_roi_candidates(out["segm"][0][..., 0], batch["score_maps"],
                                       out["rbox"][0], out["angle"][0], generator=generator)
        metric_vec = torch.stack([terms[k].detach() for k in METRIC_KEYS])
    return metric_vec, cands


@dataclass
class Averager:
    """Running mean (reference src/utils.py:192-220)."""

    total: float = 0.0
    count: int = 0

    def add(self, v: float):
        self.total += float(v)
        self.count += 1

    def val(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self):
        self.total, self.count = 0.0, 0


class Trainer:
    """Training loop driver: host roi sampling pipelined against device
    steps, from ``model``'s weights (e.g. :func:`fots_torch.checkpoint.
    load_detector`).  ``device=None`` trains on CUDA and raises without it;
    ``device="cpu"`` runs the kernels' plain versions."""

    def __init__(self, model: FOTSDetector,
                 codec: Optional[LabelCodec] = None, learning_rate: float = 1e-3,
                 seed: int = 0, use_predicted_rois: bool = True, ohem: bool = False,
                 masked_norm: bool = True, multi_scale: bool = True, device=None):
        self.device = resolve_device(device)
        self.codec = codec or LabelCodec()
        self._gen = torch.Generator().manual_seed(seed)  # dropout, priorities
        self._np_rng = np.random.default_rng(seed)       # roi sampling
        self.model = model.to(device=self.device, memory_format=torch.channels_last).train()
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=learning_rate,
                                          betas=(0.5, 0.999), eps=1e-8)
        self.use_predicted_rois = use_predicted_rois
        self.ohem = ohem
        self.masked_norm = masked_norm
        self.multi_scale = multi_scale
        self._prev_cands = None  # (HostCopy of [B, 8, K], (hs, ws)) of the last step
        self._pending: List[HostCopy] = []
        self.metrics = {k: Averager() for k in METRIC_KEYS}
        #: every recorded step's metrics, in step order
        self.history: List[Dict[str, float]] = []

    def _build_roi_batch(self, batch) -> RoiBatch:
        cands = hw = None
        if self.use_predicted_rois and self._prev_cands is not None:
            copy, phw = self._prev_cands
            pc = copy.numpy()  # waits for the previous step's candidates only
            if pc.shape[0] == batch.images.shape[0] and phw == batch.score_maps.shape[1:]:
                cands, hw = pc, phw
        return sample_rois(self._np_rng, batch.score_maps, batch.gt_idxs, batch.gt_quads,
                           batch.labels, batch.images.shape[1:3], self.codec,
                           pred_candidates=cands, pred_map_hw=hw)

    def _host_tensor(self, a) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _prepare_maps(self, batch) -> List[torch.Tensor]:
        """The image and map upload buffers (independent of earlier steps)."""
        return [self._host_tensor(a) for a in pack_host_maps(batch)]

    def _prepare_rois(self, batch, maps: List[torch.Tensor]):
        """Roi sampling (waits for the previous step's candidates) and the
        roi buffer; returns what :meth:`step` takes as ``prepared``."""
        roi_batch = self._build_roi_batch(batch)
        host = maps + [self._host_tensor(pack_rois(roi_batch))]
        frames = ctc_frame_count(roi_batch.rois, roi_batch.roi_mask, roi_batch.strip_width)
        optax_rows = repeat_infeasible_rows(roi_batch.labels, roi_batch.label_lengths,
                                            np.full(len(roi_batch.roi_mask), frames))
        return roi_batch, host, frames, optax_rows

    def _prepare(self, batch):
        """Host side of a step: packing, roi sampling, pinned buffers."""
        return self._prepare_rois(batch, self._prepare_maps(batch))

    def _record(self, vals) -> Dict[str, float]:
        out = {k: float(v) for k, v in zip(METRIC_KEYS, vals)}
        for k, v in out.items():
            self.metrics[k].add(v)
        self.history.append(out)
        return out

    def step(self, batch, defer: bool = False, prepared=None):
        """One training step from a host :class:`DetectionBatch`.  With
        ``defer`` the metrics stay on their way to the host until
        :meth:`drain_metrics`; otherwise returns them."""
        roi_batch, host, frames, optax_rows = (prepared if prepared is not None
                                               else self._prepare(batch))
        dev = [t.to(self.device, non_blocking=True) for t in host]
        dev_batch = unpack_device_batch(*dev, tuple(batch.images.shape[1:3]))
        # F.ctc_loss reads the lengths on the host: hand it the host copy
        dev_batch["label_lengths"] = torch.from_numpy(roi_batch.label_lengths).long()
        metric_vec, cands = train_step(self.model, self.optimizer, dev_batch,
                                       roi_batch.strip_width, frames, optax_rows, self._gen,
                                       self.multi_scale, self.ohem, self.masked_norm)
        self._prev_cands = (HostCopy(cands), tuple(batch.score_maps.shape[1:3]))
        copy = HostCopy(metric_vec)
        if defer:
            self._pending.append(copy)
            return None
        return self._record(copy.numpy())

    def drain_metrics(self) -> Dict[str, float]:
        """Fold deferred metric vectors into the averagers and the history;
        returns the last step's values."""
        out: Dict[str, float] = {}
        for copy in self._pending:
            out = self._record(copy.numpy())
        self._pending.clear()
        return out

    def train(self, batches, max_steps: int, log_every: int = 5):
        """Pipelined loop over at most ``max_steps`` batches.  One prefetch
        thread packs step i + 1's images and maps while the main thread
        dispatches step i, then samples its rois, which waits for step i's
        candidates (they stream home while the card works); metrics are
        pulled at log points."""
        it = iter(batches)
        with ThreadPoolExecutor(max_workers=1) as pool:
            def fetch():
                batch = next(it, None)
                return None if batch is None else (batch, pool.submit(self._prepare_maps, batch))

            def sample(batch, maps):  # queued after ``maps`` on the one worker
                return pool.submit(lambda: self._prepare_rois(batch, maps.result()))

            t0 = time.perf_counter()
            cur = fetch()
            rois = None if cur is None else sample(*cur)
            for step_idx in range(max_steps):
                if cur is None:
                    break
                prepared = rois.result()
                nxt = fetch()
                self.step(cur[0], defer=True, prepared=prepared)
                rois = None if nxt is None else sample(*nxt)
                cur = nxt
                if log_every and step_idx % log_every == 0:
                    self.drain_metrics()
                    msg = " ".join(f"{k}: {a.val():.3f}" for k, a in self.metrics.items())
                    print(f"step {step_idx} {msg} time {time.perf_counter() - t0:.3f}s",
                          flush=True)
                    t0 = time.perf_counter()
            if rois is not None:
                rois.result()  # an unused prefetch: surface its error
        self.drain_metrics()
