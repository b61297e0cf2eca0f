"""End-to-end inference: letterbox -> detect -> NMS -> recognize.

Port of ``fots/pipeline.py``: the batched serving path
(``FOTSInference.batch_call`` and ``stream``) and the per-image path of the
evaluation (``__call__`` -> ``detect`` -> ``recognize_boxes``, with beam
decoding, word splitting, the box cap and the crop margin).  Serving:

  u8 images -> [device] letterbox + FOTSDetector forward + top-k NMS
               candidates (u16 pack) + focr neighbour pack
            -> [host] decode + locality-aware NMS
            -> [device] rrois bucketed by strip width, fixed roi chunks:
               rroi_align_packed + RecognitionHead (masked IN) + argmax
            -> [host] CTC collapse.

Device work is queued on the current CUDA stream; results come back by
non-blocking copies into pinned host buffers, each followed by a CUDA event
the host waits on only when it needs the values.  ``stream`` keeps two
detections and two recognitions in flight, so host NMS and decoding
overlap the next batch's device work.

The per-image path runs one image at its own /32 size through the same
detection and recognition calls and waits for each result.

``transport="yuv420"`` ships each letterboxed batch as full-size luma and
half-size chroma (1.5 bytes a pixel in place of 3) and rebuilds BGR on the
device before the same forward.  :meth:`FOTSInference.detect_maps` is the
dense detection path: the head maps to the host in one copy (for
:func:`fots_torch.ops.nms.get_boxes`), the focr map left on the device.

``FOTSInference(mesh=...)`` serves over a ('data', 'model') mesh
(:mod:`fots_torch.parallel`), one process a card, each called with the
same images: the batch is padded to a multiple of the data axis, each rank
letterboxes its rows and runs them through the detector and recognises
their boxes (another rank's images may be left out, as None), and
``batch_call``, ``stream`` and ``__call__`` return the whole batch's
results on every rank.  ``conv11`` runs column-parallel over 'model' where
it divides; the ranks of a model group share the boxes of their first
rank, so their recognition calls stay in step.  ``fots`` packs the focr map
with its XLA pack under a mesh (its Pallas pack has no sharded wrapper);
here every rank holds whole images, so K4' stays on the path, and the
crops are the same, since both packs' edges are weight-masked.
"""

from __future__ import annotations

import copy
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fots_torch.codec import LabelCodec
from fots_torch.device import HostCopy, resolve_device, to_device_async
from fots_torch.geometry import (TARGET_H, resize_to_multiple_of_32, rroi_from_box,
                                 strip_width_for_box)
from fots_torch.models.detector import FOTSDetector
from fots_torch.ops.ctc_decode import prefix_beam_search_topk
from fots_torch.ops.nms import (extract_candidates, get_boxes_from_candidates_batch,
                                pack_candidates_u16)
from fots_torch.ops.rroi_align import pack_neighbors, rroi_align, rroi_align_packed
from fots_torch.parallel import mesh as pmesh
from fots_torch.serving import (assemble_results, bucket_rois, cap_boxes, check_images,
                                host_letterbox, host_letterbox_yuv420, letterbox_scales,
                                roi_chunks)
from fots_torch.wordsplit import split_detection

# Strip-width buckets; the coarse grid matches training without masked IN,
# the fine grid serves checkpoints trained with masked InstanceNorm (strip
# features are then bucket-width-invariant).
STRIP_BUCKETS = (256, 512)
FINE_STRIP_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)

# parameter subtrees kept in f32 under mixed precision: geometry/score
# heads need sub-pixel precision and the attention gate stays with them
_KEEP_F32 = ("act", "rbox", "angle", "conv_attention")


class PackedFocr(NamedTuple):
    """The focr map packed once per batch by :func:`pack_neighbors`
    (``quads`` [B*H*W, 4C]) and its original shape (B, H, W, C)."""

    quads: torch.Tensor
    shape: Tuple[int, int, int, int]


def cast_params_bf16(model: FOTSDetector, keep_f32=_KEEP_F32) -> FOTSDetector:
    """Cast parameters to bfloat16 in place, except the subtrees named in
    ``keep_f32``, which then compute in f32 through dtype promotion.
    BatchNorm running statistics stay f32 (the JAX package casts only
    ``params``)."""
    for name, p in model.named_parameters():
        if name.split(".")[0] not in keep_f32 and p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    return model


def letterbox_taps(src: int, dst: int):
    """Half-pixel bilinear 2-tap table (the cv2 INTER_LINEAR convention):
    (lo, hi, frac) numpy arrays for resizing ``src`` samples to ``dst``."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    lo = np.clip(np.floor(pos), 0, src - 1).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1).astype(np.int64)
    fr = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
    return lo, hi, fr


def letterbox_tables(src_hw: Tuple[int, int], serve_hw: Tuple[int, int], device):
    """The row and column tap tables of one (source, serving) shape pair on
    ``device``: ((ylo, yhi, yfr), (xlo, xhi, xfr))."""
    h0, w0 = src_hw
    s = min(serve_hw[0] / h0, serve_hw[1] / w0)
    nh, nw = int(h0 * s), int(w0 * s)
    return tuple(tuple(torch.from_numpy(a).to(device) for a in letterbox_taps(src, dst))
                 for src, dst in ((h0, nh), (w0, nw)))


def device_letterbox_batch(raw, serve_hw: Tuple[int, int], tables=None):
    """Letterbox a raw u8 batch [B, h, w, 3] (any device) to normalized f32
    [B, H, W, 3]: two 2-tap row gathers (half-pixel bilinear), x/128 - 1,
    padding with the background value -1.  ``tables``: the
    :func:`letterbox_tables` of this shape pair, when the caller keeps them
    on the device."""
    H, W = serve_hw
    if tables is None:
        tables = letterbox_tables(raw.shape[1:3], serve_hw, raw.device)
    (ylo, yhi, yfr), (xlo, xhi, xfr) = tables
    nh, nw = ylo.shape[0], xlo.shape[0]
    x = raw.float()
    x = (x[:, ylo] * (1.0 - yfr)[None, :, None, None]
         + x[:, yhi] * yfr[None, :, None, None])
    x = (x[:, :, xlo] * (1.0 - xfr)[None, None, :, None]
         + x[:, :, xhi] * xfr[None, None, :, None])
    x = x / 128.0 - 1.0
    return F.pad(x, (0, 0, 0, W - nw, 0, H - nh), value=-1.0)


def yuv420_to_normalized(y, uv):
    """The ``yuv420`` transport's batch (Y [B, H, W], UV [B, H/2, W/2, 2] u8,
    ``cv2.COLOR_BGR2YUV``'s convention) as normalized f32 BGR [B, H, W, 3]:
    the chroma upsampled 2x by nearest neighbour, ``b = y + u/0.492``, ``r =
    y + v/0.877``, ``g = (y - 0.299 r - 0.114 b)/0.587``, clipped to [0, 255],
    then x/128 - 1."""
    yf = y.float()
    uvf = uv.float() - 128.0
    uvf = uvf.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    uvf = uvf[:, :yf.shape[1], :yf.shape[2]]
    u, v = uvf[..., 0], uvf[..., 1]
    b = yf + u / 0.492
    r = yf + v / 0.877
    g = (yf - 0.299 * r - 0.114 * b) / 0.587
    return torch.clamp(torch.stack([b, g, r], dim=-1), 0.0, 255.0) / 128.0 - 1.0


class FOTSInference:
    """Serving engine around an eval-mode :class:`FOTSDetector`.

    ``device=None`` runs on CUDA and raises without it; ``device="cpu"``
    runs the kernels' plain versions.  ``mixed_precision`` casts the
    backbone and recognizer to bf16 (heads and attention stay f32).
    ``masked_norm`` selects masked recognition IN and the fine bucket grid
    (set it from the snapshot's config).  ``beam`` > 0 decodes the per-image
    path (``__call__`` / ``recognize_boxes``) with a prefix beam search of
    that width on the host, over the device's per-frame top-k log-probs; the
    batched stream stays greedy.  ``max_boxes`` caps the detections per image
    that enter recognition (top by NMS score; None recognizes everything).
    ``expand_w_frac`` widens every crop by that fraction of the box height.
    ``device_letterbox`` (the serving setting, and the default here) resizes
    a batch of one source shape on the device in f32; without it, as for a
    batch of mixed shapes, each image is resized on the host and rounded to
    u8, which is what ``fots``'s CLIs do.  ``transport`` is how a served
    batch crosses to the device: ``"u8"`` BGR pixels, or ``"yuv420"``, luma
    and half-size chroma letterboxed on the host (whatever
    ``device_letterbox`` says) and turned back into BGR on the device.
    ``codec`` (default: the 86-character :class:`LabelCodec`) decodes the
    recognition head's ids; its alphabet must match the head's width.
    ``mesh`` (:func:`fots_torch.parallel.make_mesh`; None: one device)
    serves data-parallel (see the module's docstring); ``model`` is then
    this rank's, its vocabulary head sharded where the model axis divides it.
    Close the engine (or use it as a context manager) to stop its NMS thread
    pool.
    """

    #: per-frame symbols brought to the host beam search
    BEAM_TOPK = 16
    #: strip columns (rois x bucket width) per recognition call; sets the
    #: fixed roi chunk of each width
    CHUNK_FRAME_BUDGET = 2048

    def __init__(self, model: FOTSDetector, segm_thresh: float = 0.5,
                 iou_th1: float = 0.4, iou_th2: float = 0.2,
                 mixed_precision: bool = False, max_candidates: int = 8192,
                 masked_norm: bool = False, cand_transport: str = "u16",
                 device=None, expand_w_frac: float = 0.0, beam: int = 0,
                 max_boxes: Optional[int] = None, device_letterbox: bool = True,
                 codec: Optional[LabelCodec] = None, transport: str = "u8", mesh=None):
        if cand_transport not in ("u16", "f32"):
            raise ValueError(f"unknown cand_transport {cand_transport!r}")
        if transport not in ("u8", "yuv420"):
            raise ValueError(f"unknown transport {transport!r}")
        self.device = resolve_device(device)
        model = model.eval().to(device=self.device,
                                memory_format=torch.channels_last)
        self.mesh = mesh
        self.shard = pmesh.batch_sharding(mesh)
        self._data_parallel = self.shard.n
        if mesh is not None:
            pmesh.shard_init(model, mesh)
        if mixed_precision:
            model = cast_params_bf16(model)
        self.model = model
        self.compute_dtype = torch.bfloat16 if mixed_precision else torch.float32
        self.codec = codec or LabelCodec()
        self.segm_thresh = segm_thresh
        self.iou_th1 = iou_th1
        self.iou_th2 = iou_th2
        self.max_candidates = max_candidates
        self.masked_norm = masked_norm
        self.strip_buckets = FINE_STRIP_BUCKETS if masked_norm else STRIP_BUCKETS
        self.cand_transport = cand_transport
        self.expand_w_frac = expand_w_frac
        self.beam = int(beam)
        self.max_boxes = max_boxes
        self.transport = transport
        self.device_letterbox = device_letterbox and transport == "u8"
        self._tables = {}  # letterbox tap tables on the device, by shape pair
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="fots-nms")

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def copy_to(self, device) -> "FOTSInference":
        """This engine with every setting on ``device``, over a copy of its
        model there (close the copy too).  Single-device engines only."""
        if self.mesh is not None:
            raise ValueError("copy_to needs a single-device engine")
        other = copy.copy(self)
        other.device = resolve_device(device)
        other.model = copy.deepcopy(self.model).to(other.device)
        other._tables = {}
        other._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="fots-nms")
        return other

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------- mesh helpers --------

    def _pad_to_shards(self, n: int) -> int:
        """``n`` rounded up to a multiple of the data axis."""
        return self.shard.padded(n)

    def _my_images(self, images_bgr, serve_hw):
        """This rank's images of a batch padded to the data axis with black
        images, how many of them are the caller's, and whether the batch's
        images share one shape.  Every rank checks every image it is given;
        it letterboxes only its own, and another rank's may be None (a rank
        that read only its own).  Without a mesh, the batch."""
        given = [im for im in images_bgr if im is not None]
        check_images(given)
        same = len({im.shape for im in given}) == 1
        n = len(images_bgr)
        if self.mesh is None:
            return list(images_bgr), n, same
        rows = self.shard.rows(n)
        mine = list(images_bgr[rows.start:rows.stop])
        blank = (np.zeros_like(mine[0]) if mine
                 else np.zeros(tuple(serve_hw) + (3,), np.uint8))
        return mine + [blank] * (rows.stop - rows.start - len(mine)), len(mine), same

    def _agree(self, boxes):
        """The boxes of model rank 0 on every rank of this model group (their
        recognition calls gather over it)."""
        if pmesh.axis_size(self.mesh, pmesh.MODEL_AXIS) > 1:
            boxes = pmesh.all_gather_objects(boxes, self.mesh, pmesh.MODEL_AXIS)[0]
        return boxes

    def _gather_results(self, results, n: int):
        """Every data rank's per-image results in batch order."""
        if self.mesh is None:
            return results
        parts = pmesh.all_gather_objects(results, self.mesh, pmesh.DATA_AXIS)
        return [r for part in parts for r in part][:n]

    # -------- detection --------

    def _letterbox(self, images_bgr: List[np.ndarray], serve_hw,
                   same_shape: Optional[bool] = None):
        """(u8 batch, per-image scale) for :meth:`_dispatch_detect`.  Under
        ``device_letterbox`` a batch of one source shape (``same_shape``,
        by default read from ``images_bgr``) is only stacked: the device
        letterboxes it.  Otherwise the batch is letterboxed here, image by
        image (bilinear resize, zero padding, which normalizes to the
        background value), to [B, H, W, 3] at ``serve_hw``, or under
        ``yuv420`` to a (Y, UV) pair."""
        if self.transport == "yuv420":
            return host_letterbox_yuv420(images_bgr, serve_hw)
        if same_shape is None:
            same_shape = len({im.shape for im in images_bgr}) == 1
        if self.device_letterbox and same_shape:
            check_images(images_bgr)
            return np.stack(images_bgr), letterbox_scales(images_bgr, serve_hw)
        return host_letterbox(images_bgr, serve_hw)

    @torch.inference_mode()
    def _dispatch_detect(self, raw: np.ndarray, serve_hw):
        """Queue letterbox + forward + candidate extraction + focr pack;
        returns (candidate pack on its way to the host, PackedFocr).  ``raw``
        [B, h, w, 3]: u8 pixels, normalized here (and letterboxed, unless
        already at ``serve_hw``), or f32 already normalized at ``serve_hw``;
        or a ``yuv420`` (Y, UV) pair at ``serve_hw``."""
        if isinstance(raw, tuple):
            y, uv = (to_device_async(torch.from_numpy(a), self.device) for a in raw)
            x = yuv420_to_normalized(y, uv)
            cands, quads = self._detect_body(x)
            return HostCopy(cands), self._packed(quads, x.shape)
        x = to_device_async(torch.from_numpy(raw), self.device)
        key = (tuple(raw.shape[1:3]), tuple(serve_hw))
        if raw.dtype != np.uint8:
            if raw.dtype != np.float32 or key[0] != key[1]:
                raise ValueError("a float batch must be f32, normalized and at the "
                                 f"serving size {key[1]}; got {raw.dtype} {key[0]}")
        elif key[0] == key[1]:
            x = x.float() / 128.0 - 1.0
        else:
            if key not in self._tables:  # a blocking upload, once per shape pair
                self._tables[key] = letterbox_tables(key[0], key[1], self.device)
            x = device_letterbox_batch(x, serve_hw, self._tables[key])
        cands, quads = self._detect_body(x)
        return HostCopy(cands), self._packed(quads, x.shape)

    @staticmethod
    def _packed(quads, shape) -> PackedFocr:
        """The focr quads of a batch of ``shape`` [B, H, W, ...] with their
        map's shape (B, H/4, W/4, C)."""
        b, h, w = shape[:3]
        return PackedFocr(quads, (b, h // 4, w // 4, quads.shape[1] // 4))

    def _detect_body(self, x):
        """Forward + candidate extraction + focr pack of a normalized f32
        batch at its serving size -> (candidate pack, focr quads).  The
        exported detection program is this body behind the u8
        normalization."""
        out = self.model(x.to(self.compute_dtype))
        cands = extract_candidates(
            out["segm"][0][..., 0].float(), out["rbox"][0].float(),
            out["angle"][0].float(), self.max_candidates, self.segm_thresh)
        hs, ws = x.shape[1] // 4, x.shape[2] // 4
        if self.cand_transport == "u16" and hs * ws < 65536:
            cands = pack_candidates_u16(cands)
        return cands, pack_neighbors(out["focr"])

    def _host_boxes(self, cands_copy: HostCopy, n: int, serve_hw):
        """Host decode + NMS of a candidate pack -> per-image boxes [M, 9]
        of its first ``n`` images (none on a rank that holds only padding)."""
        if n == 0:
            return self._agree([])
        cands = cands_copy.numpy()
        if cands.dtype == np.int16:
            cands = cands.view(np.uint16)
        return self._agree(cap_boxes(get_boxes_from_candidates_batch(
            cands[:n], serve_hw[0] // 4, serve_hw[1] // 4, self.segm_thresh,
            self.iou_th1, self.iou_th2, pool=self._pool), self.max_boxes))

    def detect_boxes_batch(self, batch):
        """Detection of a batch already at its serving size: [B, H, W, 3] u8
        pixels or normalized f32, or a ``yuv420`` (Y, UV) pair.  Device
        candidate extraction, host NMS, the box cap.  Returns (per-image
        boxes [M, 9], PackedFocr)."""
        lead = batch[0] if isinstance(batch, tuple) else batch
        hw = tuple(lead.shape[1:3])
        cands, focr = self._dispatch_detect(batch, hw)
        return self._host_boxes(cands, lead.shape[0], hw), focr

    @torch.inference_mode()
    def detect_maps(self, images_norm: np.ndarray):
        """The dense detection path: the detector over a batch at its own size,
        [B, H, W, 3] normalized f32 (x/128 - 1) or u8 pixels.  Returns (segm
        [B, Hs, Ws], rbox [B, Hs, Ws, 4], angle [B, Hs, Ws, 2]) as host f32,
        brought over in one channel-first [B, 7, Hs, Ws] copy, and the raw
        focr map [B, Hs, Ws, C] left on the device (``recognize_boxes`` takes
        it as ``focr``)."""
        x = to_device_async(torch.from_numpy(np.ascontiguousarray(images_norm)), self.device)
        if x.dtype == torch.uint8:
            x = x.float() / 128.0 - 1.0
        out = self.model(x.to(self.compute_dtype))
        maps = torch.cat([out["segm"][0].float(), out["rbox"][0].float(),
                          out["angle"][0].float()], dim=-1)
        maps = HostCopy(maps.permute(0, 3, 1, 2).contiguous()).numpy()
        return (maps[:, 0], np.moveaxis(maps[:, 1:5], 1, -1), np.moveaxis(maps[:, 5:7], 1, -1),
                out["focr"])

    def detect(self, image_bgr: np.ndarray, scale_up: bool = False):
        """Detect text boxes in one raw u8 BGR image.  Returns (boxes [N, 9] in
        resized-image pixels, PackedFocr, the image resized to /32 sides)."""
        im_resized, _ = resize_to_multiple_of_32(image_bgr, scale_up=scale_up)
        boxes, focr = self.detect_boxes_batch(np.ascontiguousarray(im_resized[None]))
        return boxes[0], focr, im_resized

    # -------- recognition --------

    @classmethod
    def _roi_chunk(cls, width: int, shards: int = 1) -> int:
        """Fixed roi count per recognition call at this strip width: the
        frame budget over the width, rounded down to a power of two, in
        [4, 64], then up to a multiple of ``shards`` (the data axis), as
        ``fots`` pads it."""
        c = max(1, cls.CHUNK_FRAME_BUDGET // max(width, 1))
        c = 1 << (c.bit_length() - 1)
        c = max(4, min(64, c))
        return -(-c // shards) * shards

    def _box_conf(self, ids, logp_max):
        """Per-box mean of exp(max logp) over character frames (0 when none)."""
        mask = (ids >= self.codec.reserved_ids).float()
        num = torch.sum(torch.exp(logp_max.float()) * mask, dim=-1)
        return num / torch.clamp_min(torch.sum(mask, dim=-1), 1.0)

    def _strip_logp(self, focr: PackedFocr, rois, width: int):
        """RoIRotate + CTC head of one roi chunk -> log-probs [N, width, K]."""
        strips = rroi_align_packed(focr.quads, focr.shape, rois, TARGET_H,
                                   width, 0.25)
        valid_w = None
        if self.masked_norm:
            aspect = rois[:, 4] / torch.clamp_min(rois[:, 3], 1e-6)
            valid_w = torch.clamp(torch.ceil(TARGET_H * aspect), 1,
                                  width).to(torch.int32)
        return self.model.recognize(strips, valid_w)

    def _ids_conf(self, logp):
        """Greedy ids (u8 when the vocabulary fits) and the box confidence."""
        logp_max, ids = torch.max(logp, dim=-1)
        conf = self._box_conf(ids, logp_max)
        return ids.to(torch.uint8 if self.model.nclass <= 255 else torch.int32), conf

    def _recognize(self, focr: PackedFocr, rois, width: int):
        """RoIRotate + CTC head + argmax of one roi chunk -> (ids, conf)."""
        return self._ids_conf(self._strip_logp(focr, rois, width))

    def _recognize_topk(self, focr: PackedFocr, rois, width: int):
        """Beam-decode variant: also each frame's top-k symbol log-probs and
        the blank's, for the host prefix beam search."""
        logp = self._strip_logp(focr, rois, width)
        ids, conf = self._ids_conf(logp)
        top_lp, top_ids = torch.topk(logp.float(), min(self.BEAM_TOPK, logp.shape[-1]),
                                     dim=-1)
        return ids, conf, top_lp, top_ids, logp[..., 0].float()

    def _recognize_from_image(self, images_norm, rois, width: int):
        """Crop the normalized image itself at strip height ``4 * TARGET_H -
        4``, run the stem over the crops, then the CTC head (no masking)."""
        # a fourth zero channel makes a pixel 16 bytes, which the pack needs
        crops = rroi_align(F.pad(images_norm, (0, 1)), rois, 4 * TARGET_H - 4,
                           width, 1.0)[..., :3]
        feats = self.model.forward_features(crops.to(self.compute_dtype))
        return self._ids_conf(self.model.recognize(feats))

    @torch.inference_mode()
    def recognize_boxes(self, boxes: np.ndarray, focr=None, batch_index: int = 0,
                        images_norm=None, return_ids: bool = False):
        """RoIRotate + CTC head over all boxes of one image, bucketed by strip
        width.  Crops the shared 1/4-scale features when ``focr`` is given (a
        :class:`PackedFocr` or a raw [B, H, W, C] map), or the normalized
        image ``images_norm`` [B, H, W, 3] itself.  Returns the texts, or
        (texts, frame ids, confidences) with ``return_ids``."""
        n = boxes.shape[0]
        if n == 0:
            return ([], [], []) if return_ids else []
        buckets: Dict[int, List[int]] = {}
        rois = np.zeros((n, 6), np.float32)
        for i in range(n):
            roi, w, h = rroi_from_box(boxes[i], batch_index, self.expand_w_frac)
            rois[i] = roi
            buckets.setdefault(
                strip_width_for_box(w, h, buckets=self.strip_buckets), []).append(i)
        if images_norm is not None:
            images_norm = torch.as_tensor(images_norm, dtype=torch.float32,
                                          device=self.device)
        elif not isinstance(focr, PackedFocr):
            focr = PackedFocr(pack_neighbors(focr), tuple(focr.shape))

        texts = [""] * n
        ids_out: List[Optional[np.ndarray]] = [None] * n
        confs = np.zeros((n,), np.float32)
        for width, idxs in sorted(buckets.items()):
            pieces = []
            if images_norm is not None:
                sel = to_device_async(torch.from_numpy(rois[np.asarray(idxs)]), self.device)
                ids, conf = self._recognize_from_image(images_norm, sel, width * 4)
                pieces.append((idxs, ids, conf, None))
            else:
                chunk_size = self._roi_chunk(width, self._data_parallel)
                for chunk, sel in roi_chunks(rois, idxs, chunk_size):
                    sel = to_device_async(torch.from_numpy(sel), self.device)
                    if self.beam > 0:
                        ids, conf, *beams = self._recognize_topk(focr, sel, width)
                        beams = [t.cpu().numpy() for t in beams]
                    else:
                        ids, conf = self._recognize(focr, sel, width)
                        beams = None
                    pieces.append((chunk, ids, conf, beams))
            for idx_chunk, ids, conf, beams in pieces:
                ids = ids.cpu().numpy()[: len(idx_chunk)]
                conf = conf.cpu().numpy()[: len(idx_chunk)]
                decoded = self.codec.decode_batch(ids)
                if beams is not None:
                    top_lp, top_ids, blank_lp = beams
                    for j in range(len(idx_chunk)):
                        hyp = prefix_beam_search_topk(top_ids[j], top_lp[j], blank_lp[j],
                                                      beam_width=self.beam)
                        if hyp:
                            decoded[j] = self.codec.decode_ids(hyp[0][0], raw=True)
                for j, i in enumerate(idx_chunk):
                    texts[i] = decoded[j]
                    ids_out[i] = ids[j]
                    confs[i] = conf[j]
        return (texts, ids_out, confs) if return_ids else texts

    @torch.inference_mode()
    def _recognize_dispatch(self, per_image_boxes, focr: PackedFocr):
        """Queue bucketed recognition of all images' boxes; returns (keys,
        jobs) with the results on their way to the host."""
        rois_arr, all_keys, buckets = bucket_rois(per_image_boxes, self.expand_w_frac,
                                                  self.strip_buckets)
        jobs = []
        for width, idxs in sorted(buckets.items()):
            chunk_size = self._roi_chunk(width, self._data_parallel)
            for chunk, sel in roi_chunks(rois_arr, idxs, chunk_size):
                rois = to_device_async(torch.from_numpy(sel), self.device)
                ids, conf = self._recognize(focr, rois, width)
                jobs.append((chunk, HostCopy(ids), HostCopy(conf)))
        return all_keys, jobs

    def _recognize_finish(self, n, per_image_boxes, all_keys, jobs, scales,
                          split_words: bool = False):
        """Wait for the recognition results, CTC-decode the full bucket
        width, and assemble per-image results in source-image coordinates
        (with per-word sub-boxes under 'words' when ``split_words``)."""
        texts = [""] * len(all_keys)
        ids_out: List[Optional[np.ndarray]] = [None] * len(all_keys)
        confs = np.zeros((len(all_keys),), np.float32)
        for idxs, ids_copy, conf_copy in jobs:
            ids = ids_copy.numpy()[: len(idxs)]
            conf = conf_copy.numpy()[: len(idxs)]
            dec = self.codec.decode_batch(ids)
            for k, ridx in enumerate(idxs):
                texts[ridx] = dec[k]
                ids_out[ridx] = ids[k]
                confs[ridx] = conf[k]
        return assemble_results(n, per_image_boxes, all_keys, texts, ids_out, confs, scales,
                                self.codec, split_words)

    # -------- batched serving --------

    def batch_call(self, images_bgr: List[np.ndarray],
                   serve_hw: Tuple[int, int] = (704, 1280), split_words: bool = False):
        """Serve one batch of u8 BGR images at the fixed ``serve_hw``.
        Returns per image a list of {'box': [8 coords + score] in
        source-image pixels, 'text', 'conf'} (plus 'words' with
        ``split_words``)."""
        n = len(images_bgr)
        mine, n_local, same = self._my_images(images_bgr, serve_hw)
        raw, scales = self._letterbox(mine, serve_hw, same)
        cands, focr = self._dispatch_detect(raw, serve_hw)
        boxes = self._host_boxes(cands, n_local, serve_hw)
        keys, jobs = self._recognize_dispatch(boxes, focr)
        return self._gather_results(self._recognize_finish(n_local, boxes, keys, jobs, scales,
                                                           split_words), n)

    def stream(self, batch_iter, serve_hw: Tuple[int, int] = (704, 1280),
               split_words: bool = False, with_context: bool = False):
        """Pipelined serving over an iterable of image lists; yields one
        :meth:`batch_call`-format result per batch, in order.  Two
        detections stay queued ahead, and each batch's recognition is
        collected one iteration after it was queued.  With ``with_context``
        the iterable yields ``(ctx, images)`` pairs and the stream yields
        ``(ctx, results)``: the caller's per-batch data rides through the
        pipeline."""
        it = iter(batch_iter)
        inflight = deque()
        rec_pending = deque()

        def pull():
            item = next(it, None)
            if item is None:
                return False
            ctx, images = item if with_context else (None, item)
            n = len(images)
            mine, n_local, same = self._my_images(images, serve_hw)
            raw, scales = self._letterbox(mine, serve_hw, same)
            cands, focr = self._dispatch_detect(raw, serve_hw)
            inflight.append((ctx, n, n_local, scales, cands, focr))
            return True

        if pull():
            pull()
        while inflight or rec_pending:
            if inflight:
                ctx, n, n_local, scales, cands, focr = inflight.popleft()
                boxes = self._host_boxes(cands, n_local, serve_hw)
                keys, jobs = self._recognize_dispatch(boxes, focr)
                rec_pending.append((ctx, n, n_local, scales, boxes, keys, jobs))
                pull()  # the next forward overlaps this batch's recognition
            if rec_pending and (len(rec_pending) > 1 or not inflight):
                ctx, n, n_local, scales, boxes, keys, jobs = rec_pending.popleft()
                res = self._gather_results(self._recognize_finish(
                    n_local, boxes, keys, jobs, scales, split_words), n)
                yield (ctx, res) if with_context else res

    # -------- one image end to end --------

    def __call__(self, image_bgr: np.ndarray, scale_up: bool = False,
                 split_words: bool = False):
        """The whole pipeline on one u8 BGR image at its own /32 size.  Returns
        (list of {'box': [8 coords + score] in resized-image pixels, 'text',
        'conf'} (plus 'words' with ``split_words``), the resized image).  On a
        mesh the image is data shard 0's (the others hold padding, which
        nothing reads) and every rank returns its result."""
        if self.mesh is not None:
            mine = (self._call_one(image_bgr, scale_up, split_words)
                    if self.shard.index == 0 else None)
            return pmesh.all_gather_objects(mine, self.mesh, pmesh.DATA_AXIS)[0]
        return self._call_one(image_bgr, scale_up, split_words)

    def _call_one(self, image_bgr: np.ndarray, scale_up: bool, split_words: bool):
        boxes, focr, im_resized = self.detect(image_bgr, scale_up=scale_up)
        texts, ids, confs = self.recognize_boxes(boxes, focr, return_ids=True)
        out = []
        for k, (b, t) in enumerate(zip(boxes, texts)):
            if len(t) == 0:
                continue
            entry = {"box": b, "text": t, "conf": float(confs[k])}
            if split_words:
                entry["words"] = [{"quad": q, "text": wt}
                                  for q, wt in split_detection(b, ids[k], self.codec)]
            out.append(entry)
        return out, im_resized

