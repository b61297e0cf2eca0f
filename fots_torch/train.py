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
A run starts from scratch (:func:`fots_torch.models.detector.init_detector`
from the seed) or from a given model, writes ``step_N`` checkpoints
(:mod:`fots_torch.checkpoint`) and resumes from them; the training CLI is
:mod:`fots_torch.cli.train_joint`, whose ``-debug`` writes the sampled rois'
crops (:mod:`fots_torch.debug_vis`).

``Trainer(mesh=...)`` trains over a ('data', 'model') mesh
(:mod:`fots_torch.parallel`) and computes what one device computes on the
global batch, as ``fots``'s pjit step does.  Every rank is handed the same
global host batch and keeps its rows; BatchNorm and the losses reduce over
the data group through autograd, so every rank computes the global loss;
DistributedDataParallel over the data group averages the gradients, which
the collectives' adjoints made ``n_data`` times each rank's share.  Dropout
masks and candidate priorities are drawn at the global shape from the
shared seed (each rank keeps its rows); each step's candidates are
all-gathered, so every rank samples the same global roi batch and
recognises the rois of its own images; ``conv11`` runs column-parallel over
'model' where it divides.  Metrics are the global batch's on every rank.
"""

from __future__ import annotations

import ctypes
import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from fots_torch import tracing
from fots_torch.codec import LabelCodec
from fots_torch.data.detection import DetectionBatch
from fots_torch.device import resolve_device, to_device_async
from fots_torch.losses import ctc_loss, detection_loss, repeat_infeasible_rows
from fots_torch.models.detector import FOTSDetector, init_detector
from fots_torch.models.layers import BatchNorm
from fots_torch.ops.rroi_align import rroi_align
from fots_torch.device import HostCopy
from fots_torch.kernels import build
from fots_torch.parallel import mesh as pmesh
from fots_torch.roirotate import (MAX_LABEL_LEN, MAX_ROIS, POOLED_HEIGHT, RoiBatch,
                                  sample_rois, shard_rois)

METRIC_KEYS = ("loss", "segm_loss", "angle_loss", "iou_loss", "ctc_loss")
#: what :meth:`Trainer.train`'s ``train.fetch`` span keeps of a batch that has it
FETCH_ATTRS = ("make_s", "made_at", "decode_s", "augment_s", "targets_s")
ROI_CANDIDATES_K = 128  # random candidate pixels shipped to the host sampler
#: input bytes of a packing pass for each of its threads, and its most threads
PACK_BYTES_PER_THREAD = 16 << 20
PACK_MAX_THREADS = 4


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


def _pack_lib() -> ctypes.CDLL:
    lib = build.load("pack_maps")
    if not getattr(lib, "_fots_typed", False):
        lib.fots_pack_maps.restype = ctypes.c_longlong
        lib.fots_pack_maps.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib._fots_typed = True
    return lib


def native_map_shapes(batch) -> Optional[tuple]:
    """The shapes of :func:`pack_host_maps`' three buffers where
    :func:`pack_maps_into` takes ``batch``: C-contiguous NumPy arrays, f32
    images [B, H, W, 3], score maps and training masks [B, h, w] of u8 or
    f32, f32 geometry [B, h, w, 5].  None for any other batch."""
    arrays = (batch.images, batch.score_maps, batch.training_masks, batch.geo_maps)
    if not all(isinstance(a, np.ndarray) and a.flags.c_contiguous for a in arrays):
        return None
    images, score, mask, geo = arrays
    if (images.dtype != np.float32 or images.ndim != 4 or geo.dtype != np.float32
            or score.ndim != 3 or score.shape != mask.shape
            or geo.shape != (*score.shape, 5) or score.shape[0] != images.shape[0]
            or score.dtype not in (np.uint8, np.float32)
            or mask.dtype not in (np.uint8, np.float32)):
        return None
    b, n = score.shape[0], score.shape[1] * score.shape[2]
    return images.shape, (b, 2 * n), (b, 5 * n)


def pack_threads(nbytes: int, rows: int) -> int:
    """Threads for a packing pass over ``nbytes`` of input in ``rows``
    batch rows: one per :data:`PACK_BYTES_PER_THREAD`, at most
    :data:`PACK_MAX_THREADS` and no more than the rows, leaving one of the
    process's CPUs to the dispatching thread."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity on this platform
        cpus = os.cpu_count() or 1
    return max(1, min(PACK_MAX_THREADS, cpus - 1, rows, nbytes // PACK_BYTES_PER_THREAD))


def pack_maps_into(batch, outs: List[torch.Tensor], threads: int, simd: bool = True) -> bool:
    """Write :func:`pack_host_maps`' bytes into ``outs`` (contiguous CPU
    tensors: u8 images, u8 maps, f16 maps, of :func:`native_map_shapes`)
    in one native pass over ``threads`` threads (``simd=False``: the
    portable code, not AVX2 + F16C).  False, ``outs`` then undefined, where
    the batch holds a value whose NumPy result the pass does not reproduce:
    a non-finite image value, a score or mask that is not a whole number in
    [0, 255], a NaN in the geometry."""
    shapes = native_map_shapes(batch)
    if shapes is None:
        raise ValueError("the native packing pass does not take this batch "
                         "(see native_map_shapes)")
    for t, shape, dtype in zip(outs, shapes, (torch.uint8, torch.uint8, torch.float16)):
        if (t.device.type != "cpu" or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"output buffer {t.dtype} {tuple(t.shape)} on {t.device}: "
                             f"want a contiguous CPU {dtype} {tuple(shape)}")
    images, score, mask, geo = (batch.images, batch.score_maps, batch.training_masks,
                                batch.geo_maps)
    b = images.shape[0]
    bad = _pack_lib().fots_pack_maps(
        images.ctypes.data, b, images[0].size if b else 0,
        score.ctypes.data, int(score.dtype == np.float32),
        mask.ctypes.data, int(mask.dtype == np.float32),
        geo.ctypes.data, score[0].size if b else 0,
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), threads, int(simd))
    return bad == 0


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
    on the CPU from ``generator`` unless given as ``priorities`` [B, H*W];
    a :class:`fots_torch.parallel.mesh.RowDraw` draws them for the global
    batch), packed channel-first [B, 8, k] as ``(score, d0..d3, sin, cos,
    flat_idx)``; slots past the valid pixels carry score -1."""
    b, h, w = segm_pred.shape
    k = min(k, h * w)
    valid = ((segm_pred > 0.5) & (score_gt > 0)).reshape(b, h * w)
    if priorities is None:
        priorities = pmesh.global_draw((b, h * w), generator)
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
                 optax_rows=None, roi_draw=None, group=None):
    """The step's loss (``fots/train.py`` ``loss_fn``): returns (total, the
    five metric terms by :data:`METRIC_KEYS`, the detector's outputs).
    ``ctc_frames``: :func:`ctc_frame_count` of the batch's rois;
    ``optax_rows``: :func:`fots_torch.losses.repeat_infeasible_rows` of them.
    Under a mesh ``model`` is the DDP-wrapped detector, ``generator`` /
    ``roi_draw`` the draws over the global images / rois, and ``group`` the
    data group the losses reduce over."""
    net = model.module if isinstance(model, DistributedDataParallel) else model
    out = model(batch["images"], generator)
    det = detection_loss(out, batch["score_maps"], batch["training_masks"],
                         batch["geo_maps"], batch["angle_gt"], multi_scale=multi_scale,
                         ohem=ohem, group=group)
    rois = batch["rois"]
    strips = rroi_align(out["focr"], rois, POOLED_HEIGHT, strip_width, 0.25)
    valid_w = None
    if masked_norm:
        aspect = rois[:, 4] / torch.clamp_min(rois[:, 3], 1e-6)
        valid_w = torch.clamp(torch.ceil(POOLED_HEIGHT * aspect), 1, strip_width).to(torch.int32)
    logp = net.recognize(strips, valid_w, generator if roi_draw is None else roi_draw)
    frames = torch.full((logp.shape[0],), ctc_frames, dtype=torch.int64)  # on the host
    ctc = ctc_loss(logp, batch["labels"], batch["label_lengths"], frames, batch["roi_mask"],
                   optax_rows=optax_rows, group=group)
    total = det["total"] + ctc
    terms = {"loss": total, "segm_loss": det["segm"], "angle_loss": det["angle"],
             "iou_loss": det["iou"], "ctc_loss": ctc}
    return total, terms, out


def train_step(model: FOTSDetector, optimizer: torch.optim.Optimizer,
               batch: Dict[str, torch.Tensor], strip_width: int, ctc_frames: int,
               optax_rows=None, generator: Optional[torch.Generator] = None,
               multi_scale: bool = True, ohem: bool = False, masked_norm: bool = True,
               roi_draw=None, group=None):
    """One optimisation step.  Returns (metric vector [5] in
    :data:`METRIC_KEYS` order, next step's roi candidates [B, 8, k] of this
    rank's images), both still on the device."""
    with tracing.span("step.forward"):
        optimizer.zero_grad(set_to_none=True)
        total, terms, out = train_losses(model, batch, strip_width, ctc_frames, generator,
                                         multi_scale, ohem, masked_norm, optax_rows, roi_draw,
                                         group)
    with tracing.span("step.backward"):
        total.backward()
    with tracing.span("step.optimizer"):
        optimizer.step()
    with tracing.span("step.candidates"), torch.no_grad():
        cands = extract_roi_candidates(out["segm"][0][..., 0], batch["score_maps"],
                                       out["rbox"][0], out["angle"][0], generator=generator)
        metric_vec = torch.stack([terms[k].detach() for k in METRIC_KEYS])
    return metric_vec, cands


class Prepared(NamedTuple):
    """The host side of a step: the global roi batch, the upload buffers
    (this rank's rows and rois under a mesh), the CTC frame window and
    optax's rows of the recognised rois, the :class:`RoiBatch` this rank
    recognises and those rois' indices in the global one (None without a
    mesh)."""

    roi_batch: RoiBatch
    host: list
    frames: int
    optax_rows: np.ndarray
    recognised: RoiBatch
    roi_index: Optional[np.ndarray]


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
    steps.  ``model=None`` builds ``FOTSDetector(nclass=codec.num_classes)``
    and initialises it from ``seed`` as ``fots`` does; otherwise it trains
    ``model``'s weights (e.g. :func:`fots_torch.checkpoint.load_detector`).
    ``device=None`` trains on
    CUDA and raises without it; ``device="cpu"`` runs the kernels' plain
    versions.  ``mesh`` (:func:`fots_torch.parallel.make_mesh`; None: one
    device) trains data-parallel, each rank given the same global batches,
    whose size the data axis must divide; ``model`` is then this rank's
    (with its vocabulary-head rows under a model axis) and :attr:`ddp` the
    DistributedDataParallel around it.  The loss holds the 1/8-scale heads
    as the model's ``multi_scale`` says, unless ``multi_scale`` is given."""

    def __init__(self, model: Optional[FOTSDetector] = None,
                 codec: Optional[LabelCodec] = None, learning_rate: float = 1e-3,
                 seed: int = 0, use_predicted_rois: bool = True,
                 ohem: bool = False, masked_norm: bool = True,
                 multi_scale: Optional[bool] = None, device=None, mesh=None):
        self.device = resolve_device(device)
        self.codec = codec or LabelCodec()
        if model is None:
            model = init_detector(FOTSDetector(nclass=self.codec.num_classes),
                                  torch.Generator().manual_seed(seed))
        self._gen = torch.Generator().manual_seed(seed)  # dropout, priorities
        self._np_rng = np.random.default_rng(seed)       # roi sampling
        self.model = model.to(device=self.device, memory_format=torch.channels_last).train()
        self.mesh = mesh
        self.shard = pmesh.batch_sharding(mesh)
        self.ddp = None
        if mesh is not None:
            group = pmesh.data_group(mesh)
            pmesh.shard_init(self.model, mesh)
            for mod in self.model.modules():
                if isinstance(mod, BatchNorm):
                    mod.group = group
            self.ddp = DistributedDataParallel(self.model, process_group=group,
                                               broadcast_buffers=False)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=learning_rate,
                                          betas=(0.5, 0.999), eps=1e-8)
        self.use_predicted_rois = use_predicted_rois
        self.ohem = ohem
        self.masked_norm = masked_norm
        self.multi_scale = model.multi_scale if multi_scale is None else multi_scale
        #: applied updates; a restored checkpoint sets it and a resumed
        #: :meth:`train` continues the numbering
        self.global_step = 0
        #: samples the data pipeline dropped on an exception (summed over
        #: the batches' ``dropped`` counts)
        self.dropped_samples = 0
        self._prev_cands = None  # (HostCopy of [B, 8, K], (hs, ws)) of the last step
        self._pending: List[tuple] = []
        self.metrics = {k: Averager() for k in METRIC_KEYS}
        #: every recorded step's metrics and step index, in step order
        self.history: List[Dict[str, float]] = []

    def _build_roi_batch(self, batch) -> RoiBatch:
        with tracing.span("prep.sample_rois"):
            cands = hw = None
            if self.use_predicted_rois and self._prev_cands is not None:
                copy, phw = self._prev_cands
                with tracing.span("prep.wait_candidates"):
                    pc = copy.numpy()  # waits for the previous step's candidates only
                if pc.shape[0] == batch.images.shape[0] and phw == batch.score_maps.shape[1:]:
                    cands, hw = pc, phw
            return sample_rois(self._np_rng, batch.score_maps, batch.gt_idxs, batch.gt_quads,
                               batch.labels, batch.images.shape[1:3], self.codec,
                               max_rois=MAX_ROIS, pred_candidates=cands, pred_map_hw=hw)

    def _host_tensor(self, a) -> torch.Tensor:
        with tracing.span("prep.pin"):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.pin_memory() if self.device.type == "cuda" else t

    def _rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b``."""
        if b % self.shard.n:
            raise ValueError(f"a batch of {b} does not split over {self.shard.n} data ranks")
        return self.shard.rows(b)

    def _prepare_maps(self, batch) -> List[torch.Tensor]:
        """The image and map upload buffers of this rank's rows
        (independent of earlier steps): one native pass into fresh buffers
        (pinned on CUDA, where the caching host allocator hands a block out
        again only after the upload that read it), or, for a batch that
        pass does not take, :func:`pack_host_maps` and pinned copies.  The
        span's attrs: ``route`` ("native" or "numpy") and ``bytes`` (of the
        three buffers)."""
        with tracing.span("prep.pack_maps") as sp:
            if self.mesh is not None:
                rows = self._rows(batch.images.shape[0])
                batch = replace(batch, **{k: getattr(batch, k)[rows] for k in
                                          ("images", "score_maps", "geo_maps",
                                           "training_masks")})
            route, host = "native", self._pack_native(batch)
            if host is None:
                route, host = "numpy", [self._host_tensor(a) for a in pack_host_maps(batch)]
            if sp is not None:
                sp.attrs.update(route=route, bytes=sum(t.nbytes for t in host))
            return host

    def _pack_native(self, batch) -> Optional[List[torch.Tensor]]:
        shapes = native_map_shapes(batch)
        if shapes is None:
            return None
        pin = self.device.type == "cuda"
        host = [torch.empty(shape, dtype=dtype, pin_memory=pin) for shape, dtype in
                zip(shapes, (torch.uint8, torch.uint8, torch.float16))]
        nbytes = sum(a.nbytes for a in (batch.images, batch.score_maps,
                                        batch.training_masks, batch.geo_maps))
        ok = pack_maps_into(batch, host, pack_threads(nbytes, batch.images.shape[0]))
        return host if ok else None

    def _prepare_rois(self, batch, maps: List[torch.Tensor]) -> Prepared:
        """Roi sampling on the global batch (waits for the previous step's
        candidates) and the roi buffer of the rois this rank recognises;
        returns what :meth:`step` takes as ``prepared``."""
        roi_batch = self._build_roi_batch(batch)
        with tracing.span("prep.pack_rois"):
            frames = ctc_frame_count(roi_batch.rois, roi_batch.roi_mask, roi_batch.strip_width)
            rec, index = roi_batch, None
            if self.mesh is not None:
                rec, index = shard_rois(roi_batch, self._rows(batch.images.shape[0]))
            host = maps + [self._host_tensor(pack_rois(rec))]
            optax_rows = repeat_infeasible_rows(rec.labels, rec.label_lengths,
                                                np.full(len(rec.roi_mask), frames))
        return Prepared(roi_batch, host, frames, optax_rows, rec, index)

    def _prepare(self, batch):
        """Host side of a step: packing, roi sampling, pinned buffers."""
        return self._prepare_rois(batch, self._prepare_maps(batch))

    def _record(self, step_idx: int, vals) -> Dict[str, float]:
        out = {k: float(v) for k, v in zip(METRIC_KEYS, vals)}
        for k, v in out.items():
            self.metrics[k].add(v)
        self.history.append({**out, "step": step_idx})
        return out

    def step(self, batch, defer: bool = False, prepared=None, step_idx: Optional[int] = None):
        """One training step from a host :class:`DetectionBatch`; counts one
        applied update.  With ``defer`` the metrics stay on their way to the
        host until :meth:`drain_metrics`; otherwise returns them.
        ``step_idx`` labels the step in the history (default: the applied
        updates before it)."""
        step_idx = self.global_step if step_idx is None else step_idx
        tracing.set_step(step_idx)
        prep = prepared if prepared is not None else self._prepare(batch)
        rec = prep.recognised
        with tracing.span("step.upload"):
            dev = [t.to(self.device, non_blocking=True) for t in prep.host]
            dev_batch = unpack_device_batch(*dev, tuple(batch.images.shape[1:3]),
                                            max_rois=len(rec.roi_mask))
            # F.ctc_loss reads the lengths on the host: hand it the host copy
            dev_batch["label_lengths"] = torch.from_numpy(rec.label_lengths).long()
        if self.mesh is None:
            metric_vec, cands = train_step(self.model, self.optimizer, dev_batch,
                                           rec.strip_width, prep.frames, prep.optax_rows,
                                           self._gen, self.multi_scale, self.ohem,
                                           self.masked_norm)
        else:
            b = batch.images.shape[0]
            metric_vec, cands = train_step(
                self.ddp, self.optimizer, dev_batch, rec.strip_width, prep.frames,
                prep.optax_rows, pmesh.RowDraw(self._gen, b, self._rows(b)), self.multi_scale,
                self.ohem, self.masked_norm,
                roi_draw=pmesh.RowDraw(self._gen, len(prep.roi_batch.roi_mask),
                                       prep.roi_index),
                group=pmesh.data_group(self.mesh))
            with tracing.span("step.candidates"):
                cands = pmesh.gather_data_rows(cands, self.mesh)
        self.global_step += 1
        with tracing.span("step.candidates"):
            self._prev_cands = (HostCopy(cands), tuple(batch.score_maps.shape[1:3]))
            copy = HostCopy(metric_vec)
        if defer:
            self._pending.append((step_idx, copy))
            return None
        return self._record(step_idx, copy.numpy())

    def drain_metrics(self) -> Dict[str, float]:
        """Fold deferred metric vectors into the averagers and the history;
        returns the last step's values."""
        out: Dict[str, float] = {}
        for step_idx, copy in self._pending:
            out = self._record(step_idx, copy.numpy())
        self._pending.clear()
        return out

    def _dump_rois(self, batch, roi_batch, out_dir: str, step_idx: int) -> None:
        from fots_torch.debug_vis import dump_roi_crops

        with tracing.span("train.debug_dump", step_idx) as sp:
            n = dump_roi_crops(batch.images, roi_batch, self.codec, out_dir, step_idx)
            if sp is not None:
                sp.attrs["crops"] = n

    def train(self, batches, max_steps: int, log_every: int = 5,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 10000,
              debug_dir: Optional[str] = None, debug_every: int = 1000):
        """Pipelined loop up to global step ``max_steps``.  The step index
        starts at :attr:`global_step` (so a resumed run continues its
        numbering and ``max_steps`` is a global bound).  One prefetch
        thread packs step i + 1's images and maps while the main thread
        dispatches step i, then samples its rois, which waits for step i's
        candidates (they stream home while the card works); metrics are
        pulled at log points.  A batch whose preparation or step raises is
        reported with its traceback and skipped, as ``fots`` does; it uses
        up its step index and applies no update.  With ``checkpoint_dir``,
        a checkpoint labelled with the applied updates is written after
        every index i with (i + 1) % ``checkpoint_every`` == 0 (and the
        averagers reset), and one at the end.  With ``debug_dir``, the rois
        sampled for every step i with i % ``debug_every`` == 0 are cropped
        from its images and written there before the step is dispatched
        (:func:`fots_torch.debug_vis.dump_roi_crops`, host only, as ``fots``
        does).  While :mod:`fots_torch.tracing` records, each part of step
        i is a span of step i on the thread that does it: ``train.fetch``
        (attrs: the batch's ``make_s``, ``made_at``, ``decode_s``,
        ``augment_s``, ``targets_s`` where it carries them),
        ``train.wait_prepared``, ``train.debug_dump`` (attr ``crops``), the
        ``step.*`` spans of :meth:`step`, ``train.drain_metrics`` and
        ``train.checkpoint``; on the prefetch thread the ``prep.*`` spans.
        Under a mesh every rank iterates the same ``batches`` (see
        :class:`fots_torch.data.prefetch.BroadcastBatches`); rank 0 prints,
        dumps and writes the checkpoints.  There a batch that raises ends
        the run on the rank that raised: the other ranks may already wait
        in the step's collectives, and a rank that went on alone would pair
        its collectives with theirs across steps.  torchrun then stops the
        other ranks."""
        from fots_torch.checkpoint import save_checkpoint

        it = iter(batches)
        with ThreadPoolExecutor(max_workers=1) as pool:
            def fetch(step):
                with tracing.span("train.fetch", step) as sp:
                    batch = next(it, None)
                    if sp is not None and batch is not None:
                        sp.attrs.update((k, getattr(batch, k)) for k in FETCH_ATTRS
                                        if hasattr(batch, k))
                if batch is None:
                    return None
                self.dropped_samples += int(getattr(batch, "dropped", 0))
                return batch, pool.submit(tracing.at_step, step, self._prepare_maps, batch)

            def sample(step, batch, maps):  # queued after ``maps`` on the one worker
                return pool.submit(lambda: tracing.at_step(step, self._prepare_rois, batch,
                                                           maps.result()))

            t0 = time.perf_counter()
            start = self.global_step
            cur = fetch(start) if start < max_steps else None
            rois = None if cur is None else sample(start, *cur)
            for step_idx in range(start, max_steps):
                if cur is None:
                    break
                nxt = fetch(step_idx + 1) if step_idx + 1 < max_steps else None
                try:
                    with tracing.span("train.wait_prepared", step_idx):
                        prepared = rois.result()
                    if debug_dir and step_idx % debug_every == 0 and pmesh.is_main(self.mesh):
                        self._dump_rois(cur[0], prepared[0], debug_dir, step_idx)
                    self.step(cur[0], defer=True, prepared=prepared, step_idx=step_idx)
                    ok = True
                except Exception:
                    if self.mesh is not None:
                        raise  # the other ranks may be inside this step's collectives
                    traceback.print_exc()
                    ok = False
                rois = None if nxt is None else sample(step_idx + 1, *nxt)
                cur = nxt
                if ok and log_every and step_idx % log_every == 0:
                    with tracing.span("train.drain_metrics", step_idx):
                        self.drain_metrics()
                    msg = " ".join(f"{k}: {a.val():.3f}" for k, a in self.metrics.items())
                    if pmesh.is_main(self.mesh):
                        print(f"step {step_idx} {msg} time {time.perf_counter() - t0:.3f}s",
                              flush=True)
                    t0 = time.perf_counter()
                if checkpoint_dir and (step_idx + 1) % checkpoint_every == 0:
                    with tracing.span("train.checkpoint", step_idx):
                        self.drain_metrics()
                        save_checkpoint(checkpoint_dir, self, self.global_step)
                    for avg in self.metrics.values():
                        avg.reset()
        with tracing.span("train.drain_metrics"):
            self.drain_metrics()
        if checkpoint_dir:
            with tracing.span("train.checkpoint"):
                save_checkpoint(checkpoint_dir, self, self.global_step)
