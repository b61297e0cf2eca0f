"""The exported serving bundle: fixed-shape programs, the weights once, and
a host runtime that serves from them without the model code.

Port of ``fots/export.py``.  :func:`export_serving` writes, from a
:class:`fots_torch.pipeline.FOTSInference`, a directory that holds, for each
device type it lists (``"cuda"``, ``"cpu"``):

- ``detect.<device>.pt2``: u8 normalization (x/128 - 1) + the detector
  forward (bf16 backbone with f32 heads under mixed precision) + top-k NMS
  candidate extraction (u16 pack while the 1/4-scale map has < 2^16 pixels)
  + the focr neighbour pack -> (candidates [B, 8, k], quads [B*H/4*W/4,
  4C]), at one fixed (batch, height, width);
- ``recognize_<w>.<device>.pt2``, one per strip-width bucket: RoIRotate over
  the quads + the CTC head + argmax -> (ids, confidences) of ``roi_pad``
  rois;

and, once for every device type,

- ``params.npz``: the weights (bf16 stored as f32, its dtype in the
  manifest's ``param_dtypes``): every program takes them as its first
  input, so no ``.pt2`` holds a weight;
- ``manifest.json``: the device types, each program's file for each of
  them, shapes, thresholds, buckets and the codec.

Each program is ``torch.export`` of the engine's own body (no
``torch.compile``): the ATen ops it traced, run eagerly, and the serving
kernels K1'-K4' as the registered ops ``torch.ops.fots_torch.*``, so loading
a program needs only the ops registered (this module imports them).

A traced program is for one device type (its factory calls keep their
device), so every program is traced once for each listed type, the other
type's from a copy of the engine on that device; one bundle then serves on
each of them, as ``fots``'s bundle serves on each platform it was lowered
for.

:class:`ExportedEngine` wires the programs up as ``FOTSInference.batch_call``
does (host letterbox, detect, host NMS, the box cap, bucketed recognition in
``roi_pad`` chunks, CTC collapse) and imports no ``fots_torch.models``.  On
the card it captures one CUDA graph per program after one eager warm-up
call and replays it over static input buffers; a capture that fails raises.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import fots_torch.ops.instance_norm  # noqa: F401  (registers fots_torch::instance_norm, ...)
import fots_torch.ops.rroi_align  # noqa: F401  (registers fots_torch::pack_neighbors)
from fots_torch.codec import LabelCodec
from fots_torch.device import HostCopy, resolve_device
from fots_torch.geometry import TARGET_H
from fots_torch.ops.nms import get_boxes_from_candidates_batch
from fots_torch.serving import (assemble_results, bucket_rois, cap_boxes, host_letterbox,
                                roi_chunks)

MANIFEST = "manifest.json"
FORMAT = "fots-torch-serving-v2"
#: the device types a bundle can list
PLATFORMS = ("cuda", "cpu")
#: rois per recognition program call
ROI_PAD = 32


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _Body(torch.nn.Module):
    """``fn`` (an engine body that calls ``model``) as a module's forward."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Stateless(torch.nn.Module):
    """A program over a parameter dict given as its first input.  The module
    holds no parameter (the body sits in a tuple, not as a submodule), so
    the exported program carries no weight."""

    def __init__(self, model: torch.nn.Module, fn):
        super().__init__()
        self._body = (_Body(model, fn),)

    def forward(self, params: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(
            self._body[0], {f"model.{k}": v for k, v in params.items()}, args)


def _export(module, params, args, path: str):
    """``torch.export`` of ``module(params, *args)`` under no_grad, saved to
    ``path`` without its example inputs (they would be a copy of the
    weights).  Returns the [(shape, dtype)] of its outputs."""
    with torch.no_grad():
        ep = torch.export.export(module, (params, *args), strict=False)
    if ep.state_dict or ep.constants:
        raise RuntimeError(f"{os.path.basename(path)} would carry tensors: "
                           f"{sorted(ep.state_dict)[:4]} {sorted(ep.constants)[:4]}")
    ep.example_inputs = None
    torch.export.save(ep, path)
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [(list(a.meta["val"].shape), _dtype_name(a.meta["val"].dtype))
            for a in out.args[0]]


def export_serving(engine, out_dir: str, batch: int, height: int, width: int,
                   roi_pad: int = ROI_PAD, platforms: Sequence[str] = PLATFORMS) -> Dict:
    """Export ``engine``'s serving programs and weights to ``out_dir``.

    ``engine``: a :class:`fots_torch.pipeline.FOTSInference`.  The detection
    program takes [batch, height, width, 3] u8; one recognition program per
    ``engine.strip_buckets`` entry takes ``roi_pad`` rois.  Every program is
    traced for each device type of ``platforms``; ``"cuda"`` without a card
    raises before anything is written.  Prints each file's size; returns
    the manifest (also written to ``out_dir/manifest.json``).  A bundle is
    single-device: a meshed engine is refused, as ``fots`` refuses it."""
    if getattr(engine, "mesh", None) is not None:
        raise ValueError("export_serving requires a single-device engine")
    if height % 32 or width % 32:
        raise ValueError("serving height/width must be /32 multiples")
    platforms = tuple(platforms)
    if not platforms or len(set(platforms)) != len(platforms) or set(platforms) - set(PLATFORMS):
        raise ValueError(f"platforms must be distinct device types of {PLATFORMS}; "
                         f"got {platforms}")
    # the bundle must decode without the exporting process: only the plain
    # LabelCodec's state (alphabet, case) round-trips through the manifest
    if type(engine.codec) is not LabelCodec:
        raise ValueError(f"export_serving supports LabelCodec engines; got "
                         f"{type(engine.codec).__name__}")
    params = {k: v.detach() for k, v in engine.model.state_dict().items()}
    # the vocabulary head's width must match the codec baked into the
    # manifest, or every served string would decode with the wrong alphabet
    for key, v in params.items():
        if key.endswith("conv11.weight") and v.shape[0] != engine.codec.num_classes:
            raise ValueError(f"vocab head {key} has {v.shape[0]} classes but the engine "
                             f"codec expects {engine.codec.num_classes}")
    for p in platforms:
        resolve_device(p)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "params.npz"),
             **{k: v.float().cpu().numpy() for k, v in params.items()})

    programs: Dict[str, Dict] = {}
    for p in platforms:
        if p == engine.device.type:
            _export_programs(engine, params, out_dir, batch, height, width, roi_pad, programs)
        else:
            with engine.copy_to(p) as other:
                _export_programs(other, {k: v.to(other.device) for k, v in params.items()},
                                 out_dir, batch, height, width, roi_pad, programs)

    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "batch": batch, "height": height, "width": width,
        "max_candidates": engine.max_candidates,
        "strip_buckets": list(engine.strip_buckets),
        "roi_pad": roi_pad,
        "target_h": TARGET_H,
        "segm_thresh": engine.segm_thresh,
        "iou_th1": engine.iou_th1, "iou_th2": engine.iou_th2,
        "expand_w_frac": engine.expand_w_frac,
        "mixed_precision": engine.compute_dtype == torch.bfloat16,
        "masked_norm": engine.masked_norm,
        "max_boxes": engine.max_boxes,
        "codec": {"type": "LabelCodec", "alphabet": engine.codec.alphabet,
                  "ignore_case": bool(engine.codec.ignore_case)},
        "param_dtypes": {k: _dtype_name(v.dtype) for k, v in params.items()},
        "programs": programs,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    for fname in sorted(os.listdir(out_dir)):
        print(f"  {fname}: {os.path.getsize(os.path.join(out_dir, fname))} bytes")
    return manifest


def _export_programs(engine, params, out_dir: str, batch: int, height: int, width: int,
                     roi_pad: int, programs: Dict[str, Dict]) -> None:
    """Trace ``engine``'s detection program and one recognition program per
    strip bucket for ``engine.device``'s type into ``out_dir``, adding each
    file (and, the first time, each program's shapes: every device type's
    are the same) to ``programs``."""
    from fots_torch.pipeline import PackedFocr

    dev = engine.device
    images = torch.zeros((batch, height, width, 3), dtype=torch.uint8, device=dev)
    detect = _Stateless(engine.model, lambda im: engine._detect_body(im.float() / 128.0 - 1.0))
    fname = f"detect.{dev.type}.pt2"
    (cand_shape, cand_dtype), (quad_shape, quad_dtype) = _export(
        detect, params, (images,), os.path.join(out_dir, fname))
    programs.setdefault("detect", {"files": {}, "images": [list(images.shape), "uint8"],
                                   "candidates": [cand_shape, cand_dtype],
                                   "quads": [quad_shape, quad_dtype]})["files"][dev.type] = fname

    quads = torch.zeros(quad_shape, dtype=getattr(torch, quad_dtype), device=dev)
    rois = torch.zeros((roi_pad, 6), dtype=torch.float32, device=dev)
    fshape = (batch, height // 4, width // 4, quad_shape[1] // 4)
    for w in engine.strip_buckets:
        def recognize(q, r, w=w):
            return engine._recognize(PackedFocr(q, fshape), r, w)

        fname = f"recognize_{w}.{dev.type}.pt2"
        _export(_Stateless(engine.model, recognize), params, (quads, rois),
                os.path.join(out_dir, fname))
        programs.setdefault(f"recognize_{w}", {"files": {}, "width": w})["files"][dev.type] = fname


class _Program:
    """One loaded program at its fixed shapes.  Given static input buffers
    ``inputs`` (on the card), one CUDA graph, captured after one eager
    warm-up call and replayed over those buffers into the static
    ``outputs``; a call copies each argument that is not already its buffer
    into it.  Without them (on the CPU), an eager call."""

    def __init__(self, path: str, params: Dict[str, torch.Tensor],
                 inputs: Optional[Sequence[torch.Tensor]] = None):
        #: the loaded ``torch.export.ExportedProgram``, and its callable module
        self.program = torch.export.load(path)
        self.module = self.program.module()
        self.params = params
        self.inputs = inputs
        self.graph = None
        self.outputs = None
        if inputs is not None:
            # the warm-up builds the kernels and sets the cluster attributes
            # once per configuration, so neither happens inside the capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.eager()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.outputs = self.eager()
            self.graph = graph

    def eager(self, *args):
        """An eager call of the loaded program on ``args`` (default: the
        static inputs)."""
        with torch.no_grad():
            return self.module(self.params, *(args or self.inputs))

    def __call__(self, *args):
        if self.graph is None:
            return self.eager(*args)
        for buf, a in zip(self.inputs, args):
            if a is not buf:
                buf.copy_(a, non_blocking=True)
        self.graph.replay()
        return self.outputs


class ExportedEngine:
    """Host runtime over an exported bundle (see the module docstring).

    ``device`` None is the card (raises without CUDA); ``"cpu"`` runs the
    kernels' plain versions, each from the programs traced for its type.  A
    bundle of another format, or one without programs for the device's
    type, is refused.  ``codec`` None builds the manifest's
    :class:`LabelCodec`.  Close the engine (or use it as a context manager)
    to stop its NMS thread pool."""

    def __init__(self, bundle_dir: str, codec: Optional[LabelCodec] = None, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(bundle_dir, MANIFEST)) as f:
            m = json.load(f)
        if m.get("format") != FORMAT:
            raise ValueError(f"not a fots_torch serving bundle: {bundle_dir}")
        if self.device.type not in m["platforms"]:
            raise ValueError(f"bundle {bundle_dir} was exported for "
                             f"{', '.join(m['platforms'])} and cannot serve on "
                             f"{self.device.type}: export it with that platform")
        self.manifest = m
        with np.load(os.path.join(bundle_dir, "params.npz")) as z:
            self.params = {k: torch.from_numpy(z[k]).to(self.device).to(getattr(torch, dt))
                           for k, dt in m["param_dtypes"].items()}
        if codec is None:
            spec = m["codec"]
            codec = LabelCodec(alphabet=spec["alphabet"], ignore_case=spec["ignore_case"])
        self.codec = codec

        def path(name):
            return os.path.join(bundle_dir, m["programs"][name]["files"][self.device.type])

        graphs = self.device.type == "cuda"
        shape, _ = m["programs"]["detect"]["images"]
        images = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        self.programs: Dict[str, _Program] = {
            "detect": _Program(path("detect"), self.params, [images] if graphs else None)}
        for w in m["strip_buckets"]:
            # the recognition graphs read the detection graph's static quads
            inputs = None
            if graphs:
                inputs = [self.programs["detect"].outputs[1],
                          torch.zeros((m["roi_pad"], 6), dtype=torch.float32,
                                      device=self.device)]
            self.programs[f"recognize_{w}"] = _Program(path(f"recognize_{w}"), self.params,
                                                       inputs)
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="fots-nms")

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def serve_hw(self) -> Tuple[int, int]:
        return self.manifest["height"], self.manifest["width"]

    def _host_input(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a program's argument: pinned on the card, so that
        the copy into the graph's static buffer does not wait."""
        t = torch.from_numpy(a)
        return t.pin_memory() if self.device.type == "cuda" else t

    def detect(self, images_u8: np.ndarray):
        """[B, H, W, 3] u8 at the bundle's shape -> (candidate pack, quads),
        on the card the detection graph's static outputs."""
        return self.programs["detect"](self._host_input(images_u8))

    def recognize(self, quads, rois: np.ndarray, width: int):
        """Padded rois [roi_pad, 6] f32 over ``quads`` -> (ids, conf) of one
        bucket, on the card that graph's static outputs."""
        return self.programs[f"recognize_{width}"](quads, self._host_input(rois))

    def batch_call(self, images_bgr: List[np.ndarray]):
        """Serve one batch of u8 BGR images.  Returns per image a list of
        {'box': [8 coords + score] in source-image pixels, 'text', 'conf'},
        as ``FOTSInference.batch_call`` with the host letterbox does."""
        m = self.manifest
        H, W = self.serve_hw
        n = len(images_bgr)
        if n > m["batch"]:
            raise ValueError(f"batch {n} > exported batch {m['batch']}")
        batch, scales = host_letterbox(images_bgr, (H, W), m["batch"])
        cands, quads = self.detect(batch)
        cands = HostCopy(cands).numpy()
        if cands.dtype == np.int16:
            cands = cands.view(np.uint16)
        boxes = cap_boxes(get_boxes_from_candidates_batch(
            cands[:n], H // 4, W // 4, m["segm_thresh"], m["iou_th1"], m["iou_th2"],
            pool=self._pool), m["max_boxes"])
        rois, keys, buckets = bucket_rois(boxes, m["expand_w_frac"], m["strip_buckets"])
        # every recognition of this batch is queued before the next detection
        # replay overwrites the quads (batch_call returns only when done)
        jobs = []
        for width, idxs in sorted(buckets.items()):
            for chunk, sel in roi_chunks(rois, idxs, m["roi_pad"]):
                ids, conf = self.recognize(quads, sel, width)
                jobs.append((chunk, HostCopy(ids), HostCopy(conf)))
        texts = [""] * len(keys)
        ids_out: List[Optional[np.ndarray]] = [None] * len(keys)
        confs = np.zeros((len(keys),), np.float32)
        for chunk, ids_copy, conf_copy in jobs:
            ids = ids_copy.numpy()[:len(chunk)]
            conf = conf_copy.numpy()[:len(chunk)]
            for k, (ridx, text) in enumerate(zip(chunk, self.codec.decode_batch(ids))):
                texts[ridx], ids_out[ridx], confs[ridx] = text, ids[k], conf[k]
        return assemble_results(n, boxes, keys, texts, ids_out, confs, scales, self.codec)
