"""Batched end-to-end serving: letterbox -> detect -> NMS -> recognize.

Port of the serving path of ``fots/pipeline.py`` (``FOTSInference.batch_call``
and ``stream``):

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

Left out of this port so far: the host cv2 letterbox (a batch must share
one source shape), the yuv420 transport, beam decoding, word splitting,
recognition from the raw image, and the mesh.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fots_torch.codec import LabelCodec
from fots_torch.device import resolve_device
from fots_torch.geometry import TARGET_H, rroi_from_box, strip_width_for_box
from fots_torch.models.detector import FOTSDetector
from fots_torch.ops.nms import (extract_candidates, get_boxes_from_candidates_batch,
                                pack_candidates_u16)
from fots_torch.ops.rroi_align import pack_neighbors, rroi_align_packed

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


class HostCopy:
    """A device tensor on its way to the host: on CUDA a non-blocking copy
    into a pinned buffer plus an event; :meth:`numpy` waits for it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._buf = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._buf.numpy()


class FOTSInference:
    """Serving engine around an eval-mode :class:`FOTSDetector`.

    ``device=None`` runs on CUDA and raises without it; ``device="cpu"``
    runs the kernels' plain versions.  ``mixed_precision`` casts the
    backbone and recognizer to bf16 (heads and attention stay f32).
    ``masked_norm`` selects masked recognition IN and the fine bucket grid
    (set it from the snapshot's config).  Close the engine (or use it as a
    context manager) to stop its NMS thread pool.
    """

    _DUMMY_ROI = (0.0, 8.0, 8.0, 8.0, 8.0, 0.0)
    #: strip columns (rois x bucket width) per recognition call; sets the
    #: fixed roi chunk of each width
    CHUNK_FRAME_BUDGET = 2048

    def __init__(self, model: FOTSDetector, segm_thresh: float = 0.5,
                 iou_th1: float = 0.4, iou_th2: float = 0.2,
                 mixed_precision: bool = False, max_candidates: int = 8192,
                 masked_norm: bool = False, cand_transport: str = "u16",
                 device=None):
        if cand_transport not in ("u16", "f32"):
            raise ValueError(f"unknown cand_transport {cand_transport!r}")
        self.device = resolve_device(device)
        model = model.eval().to(device=self.device,
                                memory_format=torch.channels_last)
        if mixed_precision:
            model = cast_params_bf16(model)
        self.model = model
        self.compute_dtype = torch.bfloat16 if mixed_precision else torch.float32
        self.codec = LabelCodec()
        self.segm_thresh = segm_thresh
        self.iou_th1 = iou_th1
        self.iou_th2 = iou_th2
        self.max_candidates = max_candidates
        self.masked_norm = masked_norm
        self.strip_buckets = FINE_STRIP_BUCKETS if masked_norm else STRIP_BUCKETS
        self.cand_transport = cand_transport
        self._tables = {}  # letterbox tap tables on the device, by shape pair
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="fots-nms")

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -------- detection --------

    def _letterbox(self, images_bgr: List[np.ndarray], serve_hw):
        """Stack a same-shape u8 batch for the device letterbox; returns
        (raw [B, h, w, 3] u8, per-image scale)."""
        shapes = {im.shape for im in images_bgr}
        if len(shapes) != 1:
            raise ValueError(
                f"batch mixes source shapes {sorted(shapes)}: fots_torch serves "
                "with the device letterbox only, which needs one source shape "
                "per batch (the host cv2 letterbox is not ported); group the "
                "images by shape")
        raw = np.stack(images_bgr)
        if raw.dtype != np.uint8 or raw.ndim != 4 or raw.shape[-1] != 3:
            raise ValueError(f"expected u8 [h, w, 3] images, got {raw.dtype} "
                             f"{raw.shape[1:]}")
        h0, w0 = raw.shape[1:3]
        s = min(serve_hw[0] / h0, serve_hw[1] / w0)
        return raw, [s] * len(images_bgr)

    @torch.inference_mode()
    def _dispatch_detect(self, raw: np.ndarray, serve_hw):
        """Queue letterbox + forward + candidate extraction + focr pack;
        returns (candidate pack on its way to the host, PackedFocr)."""
        x = torch.from_numpy(raw)
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        key = (raw.shape[1:3], tuple(serve_hw))
        if key not in self._tables:  # a blocking upload, once per shape pair
            self._tables[key] = letterbox_tables(key[0], key[1], self.device)
        x = device_letterbox_batch(x, serve_hw, self._tables[key]).to(self.compute_dtype)
        out = self.model(x)
        cands = extract_candidates(
            out["segm"][0][..., 0].float(), out["rbox"][0].float(),
            out["angle"][0].float(), self.max_candidates, self.segm_thresh)
        hs, ws = serve_hw[0] // 4, serve_hw[1] // 4
        if self.cand_transport == "u16" and hs * ws < 65536:
            cands = pack_candidates_u16(cands)
        focr = out["focr"]
        return HostCopy(cands), PackedFocr(pack_neighbors(focr), tuple(focr.shape))

    def _host_boxes(self, cands_copy: HostCopy, n: int, serve_hw):
        """Host decode + NMS of a candidate pack -> per-image boxes [M, 9]."""
        cands = cands_copy.numpy()
        if cands.dtype == np.int16:
            cands = cands.view(np.uint16)
        return get_boxes_from_candidates_batch(
            cands[:n], serve_hw[0] // 4, serve_hw[1] // 4, self.segm_thresh,
            self.iou_th1, self.iou_th2, pool=self._pool)

    # -------- recognition --------

    @classmethod
    def _roi_chunk(cls, width: int) -> int:
        """Fixed roi count per recognition call at this strip width: the
        frame budget over the width, rounded down to a power of two, in
        [4, 64]."""
        c = max(1, cls.CHUNK_FRAME_BUDGET // max(width, 1))
        c = 1 << (c.bit_length() - 1)
        return max(4, min(64, c))

    def _roi_chunks(self, rois_np: np.ndarray, idxs, width: int):
        """(index chunk, rois [chunk, 6] f32) pieces of one width bucket,
        the last one padded with the dummy roi."""
        csize = self._roi_chunk(width)
        idxs = list(idxs)
        for start in range(0, len(idxs), csize):
            chunk = idxs[start:start + csize]
            sel = rois_np[np.asarray(chunk)]
            if len(chunk) < csize:
                pad = np.tile(np.asarray(self._DUMMY_ROI, np.float32),
                              (csize - len(chunk), 1))
                sel = np.concatenate([sel, pad], axis=0)
            yield chunk, sel

    def _box_conf(self, ids, logp_max):
        """Per-box mean of exp(max logp) over character frames (0 when none)."""
        mask = (ids >= self.codec.reserved_ids).float()
        num = torch.sum(torch.exp(logp_max.float()) * mask, dim=-1)
        return num / torch.clamp_min(torch.sum(mask, dim=-1), 1.0)

    def _recognize(self, focr: PackedFocr, rois, width: int):
        """RoIRotate + CTC head + argmax of one roi chunk -> (ids, conf)."""
        strips = rroi_align_packed(focr.quads, focr.shape, rois, TARGET_H,
                                   width, 0.25)
        valid_w = None
        if self.masked_norm:
            aspect = rois[:, 4] / torch.clamp_min(rois[:, 3], 1e-6)
            valid_w = torch.clamp(torch.ceil(TARGET_H * aspect), 1,
                                  width).to(torch.int32)
        logp = self.model.recognize(strips, valid_w)
        logp_max, ids = torch.max(logp, dim=-1)
        conf = self._box_conf(ids, logp_max)
        ids = ids.to(torch.uint8 if self.model.nclass <= 255 else torch.int32)
        return ids, conf

    @torch.inference_mode()
    def _recognize_dispatch(self, per_image_boxes, focr: PackedFocr):
        """Queue bucketed recognition of all images' boxes; returns (keys,
        jobs) with the results on their way to the host."""
        all_rois: List[np.ndarray] = []
        all_keys: List[Tuple[int, int]] = []
        buckets: Dict[int, List[int]] = {}
        for i, boxes in enumerate(per_image_boxes):
            for j in range(boxes.shape[0]):
                roi, w, h = rroi_from_box(boxes[j], i)
                buckets.setdefault(
                    strip_width_for_box(w, h, buckets=self.strip_buckets), []
                ).append(len(all_rois))
                all_rois.append(roi)
                all_keys.append((i, j))
        jobs = []
        if all_rois:
            rois_arr = np.asarray(all_rois, np.float32)
            for width, idxs in sorted(buckets.items()):
                for chunk, sel in self._roi_chunks(rois_arr, idxs, width):
                    rois = torch.from_numpy(sel)
                    if self.device.type == "cuda":
                        rois = rois.pin_memory().to(self.device, non_blocking=True)
                    ids, conf = self._recognize(focr, rois, width)
                    jobs.append((chunk, HostCopy(ids), HostCopy(conf)))
        return all_keys, jobs

    def _recognize_finish(self, n, per_image_boxes, all_keys, jobs, scales):
        """Wait for the recognition results, CTC-decode the full bucket
        width, and assemble per-image results in source-image coordinates."""
        texts = [""] * len(all_keys)
        confs = np.zeros((len(all_keys),), np.float32)
        for idxs, ids_copy, conf_copy in jobs:
            ids = ids_copy.numpy()[: len(idxs)]
            conf = conf_copy.numpy()[: len(idxs)]
            dec = self.codec.decode_batch(ids)
            for k, ridx in enumerate(idxs):
                texts[ridx] = dec[k]
                confs[ridx] = conf[k]
        results = [[] for _ in range(n)]
        for ridx, (i, j) in enumerate(all_keys):
            if not texts[ridx]:
                continue
            b = per_image_boxes[i][j].copy()
            b[:8] /= scales[i]
            results[i].append({"box": b, "text": texts[ridx],
                               "conf": float(confs[ridx])})
        return results

    # -------- batched serving --------

    def batch_call(self, images_bgr: List[np.ndarray],
                   serve_hw: Tuple[int, int] = (704, 1280)):
        """Serve one batch of same-shape u8 BGR images at the fixed
        ``serve_hw``.  Returns per image a list of {'box': [8 coords +
        score] in source-image pixels, 'text', 'conf'}."""
        raw, scales = self._letterbox(images_bgr, serve_hw)
        cands, focr = self._dispatch_detect(raw, serve_hw)
        boxes = self._host_boxes(cands, len(images_bgr), serve_hw)
        keys, jobs = self._recognize_dispatch(boxes, focr)
        return self._recognize_finish(len(images_bgr), boxes, keys, jobs, scales)

    def stream(self, batch_iter, serve_hw: Tuple[int, int] = (704, 1280)):
        """Pipelined serving over an iterable of image lists; yields one
        :meth:`batch_call`-format result per batch, in order.  Two
        detections stay queued ahead, and each batch's recognition is
        collected one iteration after it was queued."""
        it = iter(batch_iter)
        inflight = deque()
        rec_pending = deque()

        def pull():
            images = next(it, None)
            if images is None:
                return False
            raw, scales = self._letterbox(images, serve_hw)
            cands, focr = self._dispatch_detect(raw, serve_hw)
            inflight.append((len(images), scales, cands, focr))
            return True

        if pull():
            pull()
        while inflight or rec_pending:
            if inflight:
                n, scales, cands, focr = inflight.popleft()
                boxes = self._host_boxes(cands, n, serve_hw)
                keys, jobs = self._recognize_dispatch(boxes, focr)
                rec_pending.append((n, scales, boxes, keys, jobs))
                pull()  # the next forward overlaps this batch's recognition
            if rec_pending and (len(rec_pending) > 1 or not inflight):
                n, scales, boxes, keys, jobs = rec_pending.popleft()
                yield self._recognize_finish(n, boxes, keys, jobs, scales)

