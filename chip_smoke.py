"""Chip smoke test of the PyTorch/CUDA port (``fots_torch``) on one GPU.

    python3 chip_smoke.py                # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels   # a subset (no result line)
    python3 chip_smoke.py --serve-bundle DIR OUT [--no-tf32]   # a fresh process of 5, 14

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build every native library from the sources in this checkout (nvcc for
   the CUDA kernels, all started together; g++ for the host NMS), printing
   each kernel's registers and spills from ptxas and any compiler warning;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes the serving path (batch 16, 704x1280) and the training paths
   (batch 8, 640x960 and 512x512) give it, plus odd shapes.  K1' and K1'-bwd run each
   shape on both of their routes (the single-kernel cluster route as the plan
   cuts it, and the two-pass route), against the plain version and against
   each other; the cluster route also twice (bit identity), at ragged pixel
   counts, at every cluster size, and its saved statistics against the plain
   emulation of its fold; K1' also at the exported bundle's recognition
   strips (32 rois at every strip bucket, bf16, masked) through the registered
   op ``torch.ops.fots_torch.instance_norm``.  Then each kernel's median time
   beside the plain version's, a library call's where one PyTorch call
   computes the same function, and the least time the card could take
   (bytes moved over the memory rate, or operations over the rate of
   their type, whichever is larger).  K5' (the fused conv3x3 + instance
   norm + residual + activation) is held at the shapes of the JAX package's
   tests (f32, TF32 off for the plain version), one ragged shape in bf16 at
   every channel count it is built for, its profile shape 16x88x160x128
   bf16, and its gradients through the ``autograd.Function`` against
   autograd of the plain version.  K2', K3', K1' and K1'-bwd also at the
   recognition trainers' crop buckets (the stem's CReLU-INs and the head's
   INs of the narrowest and the widest batch ``eval_ocr`` makes), and K4'
   on both of its kernels, bit-exact: the 16-byte kernel at the feature
   maps, the narrow kernel at f32 C = 1, 2, 3, 5, 6, 7 and bf16 C = 1, 2, 3,
   5, 6, 7, 12 (two images with an odd width, fewer rows than one block's
   span, a row count no span divides, a source 4 bytes past a 16-byte
   boundary) and at the 3-channel f32 and bf16 images of the CRNN crops at
   [2, 512, 512, 3], with the image rows' times; K4'-bwd likewise on its
   4-float and narrow kernels at f32 C = 1, 2, 3, 5, 6, 7, and K4' and
   K4'-bwd at C = 3 f32 at ``cli.rroi_demo``'s image [1, 640, 960, 3] and
   at [2, 512, 512, 3], timed beside their plain versions, ``index_add_``
   and their bound.  Every timed row has its event-bracketed ms and its
   device-busy ms (torch.profiler).  The NMS candidates of two maps with
   more than k pixels tied at 1.0 must equal the CPU's;
3. the CUDA port against the CPU port (f32, TF32 off for this phase only)
   on one serving batch of two smoke images at 704x1280 with the shipped
   snapshot: same box count per image, quad corners within 1 px,
   identical texts;
4. serving at full width (a main path): bf16, the snapshot's masked_norm,
   device letterbox, u16 candidates, batch 16 at 704x1280, ``stream`` over
   6 batches with the launch counts zeroed just before; every image must
   yield text, every serving kernel must have launched; images/s over the
   steady batches on the host clock (PyTorch's default math settings);
5. the exported bundle (a main path): ``fots_torch.export.export_serving``
   of the phase-4 engine's settings (bf16, the snapshot's masked_norm, its
   max_candidates) at batch 16, 704x1280, roi_pad 32 into a temporary
   directory, every file's size printed and no ``.pt2`` large enough to
   carry the weights; a fresh process (``--serve-bundle``) loads it with
   ``ExportedEngine`` (one CUDA graph per program), serves the 4 smoke
   scenes repeated to 16 with the launch counts zeroed just before (its
   eager warm-up and capture calls launch; a replay moves no counter), and
   must not import ``fots_torch.models``; its results are held against the
   in-process ``batch_call`` with the host letterbox (same count per image,
   identical texts, corners within 1e-4 px, confidences within 1e-5); in
   this process no loaded program may hold a tensor, the detection graph's
   replay and that of each bucket the batch used must equal an eager call
   of the same program bit for bit, and a profile of one replay of each of
   those graphs must show K1', K2', K3' and K4''s kernels in the detection
   graph and K1''s in each recognition graph; reported, not held: images/s
   of both engines over batches 2..6, and per batch the device busy ms and
   the host's launch calls (torch.profiler) over 5 more batches, beside the
   card's name and power limit; the exported window's trace gives that
   path's kernel launches; then ``fots_torch.cli.serve`` over the smoke
   archive must write what ``stream`` returns;
6. one training step, CUDA port against CPU port (f32, TF32 off for this
   phase only): two asset scenes at 640x960, ground-truth rois from one
   seed, dropout masks from equally seeded CPU generators; the five loss
   terms, every parameter gradient, the BatchNorm running statistics and
   every parameter after one Adam step must agree; once with the dice
   score loss and once with OHEM;
7. training at full width (a main path): the snapshot as warm start, f32,
   batch 8 at 640x960 (the four asset scenes twice, one repeated batch),
   predicted-roi sampling pipelined on a prefetch thread, masked_norm,
   12 steps of ``Trainer.train`` with the launch counts zeroed just
   before; every loss finite, every training kernel launched, the total
   loss after 10 updates below the first step's; images/s over steps
   3..12 on the host clock (PyTorch's default math settings: cuDNN may use
   TF32 for the convolutions);
8. training from scratch (a main path): the port's own targets on the
   card's host must equal ``fots_torch/assets/train_targets.npz`` (``fots``'s
   output, OpenCV's rasteriser) byte for byte; then
   ``fots_torch.cli.train_joint`` over the 4 smoke scenes, augmented, batch
   8 at 512x512, 20 steps from seed 0 with checkpoints every 10, the launch
   counts zeroed just before: every training kernel launched, every loss
   finite, no sample dropped, the mean loss of steps 16-20 below that of
   steps 1-5, ``step_10`` and ``step_20`` written; then a resume from
   ``step_10`` to 15 that restores weights, statistics and Adam's moments
   bit for bit, logs from step 10 and writes ``step_15``; images/s over
   steps 3..20 on the host clock; over those steps, the main thread's wait
   for each batch and the samples/s a reader made while training ran;
   peak memory;
9. K5's own path (a main path): ``fots_torch.profiling``'s ``fused_block``
   entry at the full shape 16x88x160x128 bf16 with the launch counts zeroed
   just before: the numeric check, then K5' against the detector's
   composition (cuDNN conv + K1' + add + ReLU) and against PyTorch calls
   only;
10. the evaluation path (a main path): ``fots_torch.cli.eval_e2e`` over the
   16 held-out scenes of ``fots_torch/assets/heldout_eval_u8.npz`` with the
   shipped snapshot: per image at the scenes' own size in f32 (TF32 off; the
   launch counts zeroed just before), through ``-serve_hw 704x1280``, with
   ``-beam 8`` and with ``-split_words``, each held to the JAX package's
   own result on the same pixels (``heldout_eval_fots_cpu.json``: match,
   detection and ground-truth counts within one, the same text on every
   detection both have but for at most two argmax near-ties); then once in
   bf16, reported and not held;
11. the recognition-only stack (a main path): first one step of each
   trainer, CUDA port against CPU port (f32, TF32 off): ``CRNNTrainer`` on
   a crop batch, ``FOTSRecognizerTrainer`` from the snapshot (dropout masks
   from equally seeded CPU generators), ``CRNNE2ETrainer`` on two asset
   scenes (K4' on the 3-channel image); the loss within 1e-4 relative,
   gradients and parameters after Adam to phase 6's limits.  Then, with the
   launch counts zeroed just before, through the CLIs over
   ``fots_torch/assets/ocr_crops_u8.npz``: ``train_crnn`` from scratch, 30
   steps at batch 8 (the mean loss of the last 5 below the first 5; a
   ``step_20`` checkpoint restored bit for bit and resumed), ``train_ocr``
   10 steps, ``train_crnn_e2e`` 10 steps at 512 over the smoke scenes,
   ``eval_ocr -arch fots`` with the snapshot over the eval split, greedy
   and beam 8, each within one exact crop of ``fots``'s result on the same
   crops (``ocr_eval_fots_cpu.json``); K1', K1'-bwd, K2', K3' and K4' must
   each have launched.  Reported, not held: samples/s of each trainer, and
   device busy ms and idle share a step (torch.profiler);
12. image files and reference weights (a main path, ``files``): the port's
   own decoder (``fots_torch.imageio.imread``) must give the 4 smoke scenes'
   jpgs and the 16 held-out jpgs of ``fots_torch/assets/heldout_eval_jpg``
   byte for byte as their decoded assets (median decode ms of a 640x960
   scene and the host's CPU printed), and every file of
   ``fots_torch/assets/decode_ref`` (progressive, hand-scripted progressive,
   truncated sequential, Adam7 / 1-2-4-16-bit / eXIf PNG, block-smoothed
   progressive, CMYK, YCCK, RGB-coded, arithmetic-coded and lossless JPEG,
   gamma-tagged PNG) to the SHA-256 of ``cv2.imread``'s colour and grey
   bytes in its manifest, or to nothing where its entry is null (the
   decode ms of the 640x960 scene ``img_112`` printed in five forms,
   sequential, progressive, block-smoothed, CMYK and arithmetic-coded, timed
   in turns); a BMP must raise ``ValueError`` naming the format; reader 0's
   first 4 batches from the
   jpg files must be byte-equal to those from the archive, made in turn in
   this process and timed by stage (decode, augment, targets, the rest), and
   a detection reader over the progressive jpgs must drop none;
   the in-process engines whose results the CLIs are held to run next.
   Then, with the launch counts zeroed just before, the CLIs through their
   ``main``: ``eval_e2e -images_list`` over the held-out jpgs (f32, TF32
   off) must give ``fots``'s stored summary exactly (phase 10's too);
   ``detect -test_folder`` over the smoke jpgs must write the in-process
   engine's rows on the asset pixels (texts equal, numbers within 1e-3);
   ``serve -test_folder`` must write ``batch_call``'s texts and boxes
   (within 1e-3 px); over the progressive copies of four held-out scenes
   (``decode_ref/prog``), ``eval_e2e -images_list`` must give ``fots``'s
   committed counts (``decode_ref/eval_fots_cpu.json``) within one match,
   and ``detect`` and ``serve -test_folder`` at their defaults the engines'
   results on the decoded pixels, with K1'-K4' launched;
   ``export -selftest <folder>`` must pass;
   ``train_joint`` from the jpg files (no archive, seed 0, 6 readers, 20
   steps at batch 8, 512x512, as phase 8): finite losses, no sample
   dropped, readers' samples/s, stage ms and the main thread's wait beside
   phase 8's; ``eval_ocr`` over the PNG crops of
   ``fots_torch/assets/ocr_eval_png``, greedy and beam 8, every crop read as
   ``ocr_eval_fots_cpu.json`` says (47/58); ``-h5``: the snapshot written
   under the reference's keys serves the snapshot's texts through
   ``load_engine(h5_path=..., masked_norm=True)`` and ``train_joint -h5``
   warm-starts 173 tensors, skipping 2.  Every training kernel must have
   launched;
13. the image writers (a main path, ``writers``): ``imageio.imencode_jpg``
   of the sources under ``fots_torch/assets/encode_ref`` must equal the
   committed ``cv2.imwrite`` files byte for byte (the median encode ms of
   the 640x960 scene printed), and ``imgproc.put_text`` the committed
   ``cv2.putText`` renders under ``fots_torch/assets/text_ref``; then, each
   with the launch counts zeroed
   just before it and read just after: ``cli.rroi_demo`` on the held-out
   scene ``img_112`` with its ground truth (``-pooled_height 44 -max_rois
   8``, the card by default) must launch exactly one K4' and one K4'-bwd,
   give the CPU port's crops within 1e-3 and gradient within 1e-4 of its
   largest magnitude with the same support, and write files that decode;
   ``cli.detect`` over the 16 held-out jpgs must write the engine's rows on
   the asset pixels and, for each image, the port's drawing of its rows on
   the letterboxed image (each box, then its text, as ``fots`` draws them),
   encoded by the port (ms an image with and without the drawing and
   writing, and ``put_text``'s ms, printed); ``train_joint -debug`` (4 steps at batch
   8, 512x512, a dump every 2) must dump at steps 0 and 2 under ``fots``'s
   names, every file decoding (host ms a dump adds printed);
14. the transports (a main path, ``transports``), each part with the launch
   counts zeroed just before it and read just after: (a) the dense path,
   bf16, the 4 smoke scenes repeated to 16 at 704x1280 through
   ``FOTSInference.detect_maps`` (head maps to the host in one copy),
   ``ops.nms.get_boxes`` per image and ``recognize_boxes`` over the raw focr
   map: per image the boxes must equal ``get_boxes_from_candidates`` over
   ``extract_candidates`` of the same maps with k = every pixel exactly, and
   match ``detect_boxes_batch``'s f32-transport boxes (the same count,
   corners within 1 px), and the texts over the raw focr must equal those
   over that batch's ``PackedFocr``; (b) ``transport="yuv420"`` against the
   u8 host letterbox on the 16 held-out scenes at 704x1280 bf16,
   ``batch_call`` and ``stream`` (3 batches): every image must yield text
   and ``stream`` must give ``batch_call``'s texts on both; printed: the box
   counts, how many images and texts differ, the host letterbox's ms of
   each streamed batch, h2d bytes a batch and images/s of each whole stream
   (its letterboxes included); K1', K2', K3' and K4' must have
   launched on (a) and on (b); (c) one bundle exported for ``cuda`` and
   ``cpu`` from an f32 engine at batch 2, 704x1280 (the strip buckets the 2
   smoke images use): its cuda programs served in a fresh process
   (``--serve-bundle ... --no-tf32``), its cpu programs here, held to each
   other as phase 3 holds the ports: the same box count per image, corners
   within 1 px, identical texts;
15. the mesh (a main path, ``mesh``; ``fots_torch.parallel``, TF32 off):
   (a) world 1 under NCCL in this process: the serving batch (bf16, the 4
   smoke scenes repeated to 16 at 704x1280) through
   ``FOTSInference(mesh=)`` must give the unmeshed engine's texts and box
   counts, corners within 1 px, and one training step (f32, batch 8 at
   640x960 from the snapshot, ground-truth rois) through ``Trainer(mesh=)``
   the unmeshed step within phase 6's limits, each with the launch counts
   zeroed just before it and read just after (K1'-K4' on the serving run,
   with K1'-bwd and K4'-bwd on the step); then 3 more batches and steps of
   each, timed (ms a batch / step, meshed and unmeshed: DDP's cost at world
   1); (b) two ranks spawned on the card over gloo (``fots_torch.parallel.
   selfcheck``, CUDA tensors): the same serving batch and step, held as in
   (a) to (a)'s unmeshed results, each rank running the CUDA kernels, rank
   0's ms a batch / step printed (gloo on one card: not NCCL across cards),
   and the batch once more letterboxed on the host (as ``cli.serve``
   serves; f32, since in bf16 one process's texts already depend on the
   batch's row count, which (a) prints: ROADMAP's known behaviours), held
   to the unmeshed engine's, with the ms of rank 0's letterbox (its 8
   images) against the whole batch's;
   (c) four ranks, data 2 x model 2, on the card over gloo, 750 classes (the
   snapshot's weights and a fresh ``conv11``, which splits 375 + 375): one
   step of the 4 asset scenes shrunk to 160x224 against one process within
   phase 6's limits, each model rank holding its rows of ``conv11``; the
   phase's seconds.

Then it prints a ``{"kernels": [...]}`` JSON line (K4' and K4'-bwd at C = 3
listed as rows of their own), the serving, export, training,
training-from-scratch, fused-block, evaluation, ocr, files, writers, transports and
mesh JSON lines,
the card's name and power limit from nvidia-smi, and last the
``{"ok": true, "device": {...}}`` line.  Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")
TRAIN_TARGETS = os.path.join(REPO, "fots_torch", "assets", "train_targets.npz")
SERVE_HW = (704, 1280)
BATCH = 16
STREAM_BATCHES = 6
TRAIN_HW = (640, 960)
TRAIN_BATCH = 8
TRAIN_STEPS = 12
TRAIN_LR = 1e-4
JOINT_SIZE = 512       # train_joint: augmented crops, batch TRAIN_BATCH
JOINT_STEPS = 20
JOINT_CKPT_EVERY = 10
JOINT_RESUME_TO = 15
JOINT_READERS = 6
EVAL_IMAGES = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_u8.npz")
EVAL_REFERENCE = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_fots_cpu.json")
FUSED_SHAPE = (16, 88, 160, 128)
OCR_CROPS = os.path.join(REPO, "fots_torch", "assets", "ocr_crops_u8.npz")
OCR_REFERENCE = os.path.join(REPO, "fots_torch", "assets", "ocr_eval_fots_cpu.json")
OCR_HEIGHT = 44          # FOTSRecognizerTrainer's crops (its norm_height)
OCR_BATCH = 8
CRNN_STEPS = 30
CRNN_CKPT_EVERY = 20
OCR_STEPS = 10           # train_ocr: the recognizer from scratch
E2E_STEPS = 10
E2E_SIZE = 512
IMAGE_PACK_SHAPE = (2, E2E_SIZE, E2E_SIZE, 3)  # K4' on CRNNE2ETrainer's images
DEMO_SCENE = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_jpg", "img_112.jpg")
DEMO_SHAPE = (1, 640, 960, 3)  # K4' and K4'-bwd on cli.rroi_demo's image
DEMO_POOLED_HEIGHT = 44
DEMO_MAX_ROIS = 8
ENCODE_REF = os.path.join(REPO, "fots_torch", "assets", "encode_ref")
TEXT_REF = os.path.join(REPO, "fots_torch", "assets", "text_ref")
ENCODE_REPEATS = 15
DEBUG_STEPS = 4          # train_joint -debug: steps, and a dump every DEBUG_EVERY
DEBUG_EVERY = 2
DEBUG_READERS = 2
FILES_JPG = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_jpg")
DECODE_REF = os.path.join(REPO, "fots_torch", "assets", "decode_ref")
PROG_JPG = os.path.join(DECODE_REF, "prog")  # progressive copies of 4 held-out scenes
OCR_PNG_LIST = os.path.join(REPO, "fots_torch", "assets", "ocr_eval_png", "gt.txt")
FILES_STEPS = JOINT_STEPS  # train_joint from the jpg files, as long as phase 8's run
DECODE_REPEATS = 15
READER_BATCHES = 4       # reader 0's batches made from files and from the archive
PHASES = ("build", "kernels", "serve_parity", "serve", "export", "train_parity", "train",
          "train_joint", "fused_block", "eval", "ocr", "files", "writers", "transports", "mesh")
EXPORT_BATCHES = 6
TRANSPORT_BATCHES = 3    # stream batches of the held-out scenes a transport (phase 14)
#: kernel -> (route, fragment of a ``__global__`` name in csrc/*.cu) of the
#: serving kernels: each call of a kernel's wrapper runs one device kernel
#: with one of its fragments, so a trace of graph replays, which move no
#: launch counter, counts the calls (K1''s two-pass route runs
#: in_stats_kernel, then in_apply_kernel)
GRAPH_KERNELS = {"instance_norm": (("cluster", "in_cluster_kernel"),
                                   ("two_pass", "in_apply_kernel")),
                 "spatial_stats": ((None, "spatial_stats_kernel"),),
                 "spatial_norm": ((None, "spatial_norm_kernel"),),
                 "pack_neighbors": ((None, "pack_neighbors_kernel"),)}

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s, f32 (non-tensor-core) flop/s and bf16 tensor-core
# flop/s, by card name.
_PEAKS = (("H100 PCIe", 2.0e12, 51e12, 756e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
          ("H200", 4.8e12, 67e12, 989e12), ("H100", 3.35e12, 67e12, 989e12))

# where each kernel's source lives and which TPU kernel it replaces
KERNEL_META = {
    "instance_norm": ("fots_torch/csrc/instance_norm.cu", "fots/ops/instance_norm.py:126"),
    "instance_norm_bwd": ("fots_torch/csrc/instance_norm_bwd.cu",
                          "fots/ops/instance_norm.py:151"),
    "spatial_stats": ("fots_torch/csrc/spatial_norm.cu", "fots/ops/instance_norm.py:243"),
    "spatial_norm": ("fots_torch/csrc/spatial_norm.cu", "fots/ops/instance_norm.py:263"),
    "pack_neighbors": ("fots_torch/csrc/pack_neighbors.cu", "fots/ops/rroi_align.py:304"),
    "pack_neighbors_bwd": ("fots_torch/csrc/pack_neighbors.cu", "fots/ops/rroi_align.py:304"),
    "fused_block": ("fots_torch/csrc/fused_block.cu", "fots/ops/fused_block.py:222"),
}
#: the 3-channel f32 rows of K4' and K4'-bwd (cli.rroi_demo's image), listed
#: as kernels of their own: row -> the kernel it runs
C3_KERNELS = {"pack_neighbors C=3": "pack_neighbors",
              "pack_neighbors_bwd C=3": "pack_neighbors_bwd"}


def card_peaks(name: str):
    for key, bw, f32, bf16 in _PEAKS:
        if key in name:
            return key, bw, f32, bf16
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def ptxas_report(log: str) -> dict:
    """Registers and spills of each kernel in an ``nvcc -Xptxas -v`` log,
    keyed by the kernel's name and its integer template arguments
    (``conv_stats_mma_kernel<128>``)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            # the name follows its length (digits) in the mangled symbol
            k = re.search(r"\d([a-z_]*_kernel)I(.*?)EEv", m.group(1))
            name = m.group(1)
            if k is not None:
                args = ",".join(re.findall(r"Li(\d+)E", k.group(2)))
                name = f"{k.group(1)}<{args}>"
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def errors(got, want):
    """(max |got - want|, that over max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    return d, d / max(float(want.float().abs().max()), 1e-30)


class no_tf32:
    """f32 convolutions and matmuls in full f32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def load_assets():
    with np.load(SMOKE_IMAGES) as z:
        images = z["images"]
    with np.load(TRAIN_TARGETS) as z:
        targets = {k: z[k] for k in z.files}
    return images, targets


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions, and their times
# --------------------------------------------------------------------------

def phase_kernels(dev, peaks):
    from fots_torch.ops import fused_block as tfb
    from fots_torch.ops import instance_norm as tin
    from fots_torch.ops import rroi_align as trr
    from fots_torch.pipeline import FOTSInference
    from fots_torch.profiling import (cuda_busy_ms, cuda_median_ms, fused_block_inputs,
                                      instance_norm_path_shapes)

    gen = torch.Generator(device=dev).manual_seed(0)
    H, W = SERVE_HW
    TH, TW = TRAIN_HW
    J = JOINT_SIZE
    worst = {name: 0.0 for name in (*KERNEL_META, *C3_KERNELS)}
    seen_plans = set()  # (kernel, route, cluster size, held) phase 2 ran

    def rand(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def report(name, tag, ok, ab, rel):
        print(f"  {name} {tag}: max abs err {ab:.3e} ({rel:.2e} of max |ref|)"
              f"{'' if ok else '  MISS'}")
        check(ok, f"{name} {tag} outside tolerance")
        worst[name] = max(worst[name], ab)

    def forward_ok(got, want, dtype):
        # f32: sums over up to 0.9 M pixels in another order and the affine
        # folded into x*a + c; bf16: one bf16 ulp (2^-8 relative) plus the
        # f32 slack before the final rounding
        d = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            return bool((d <= 1e-4 * (1 + want.float().abs())).all())
        return bool((d <= 2.0 ** -7 * want.float().abs() + 1e-3).all())

    def routes(plan):
        """The shape's own plan, and the two-pass route beside it."""
        return [plan] if plan.route == "two_pass" else [plan, tin.TWO_PASS]

    def plan_tag(plan):
        if plan.route == "two_pass":
            return "two_pass"
        return f"cluster {plan.cluster}x{plan.block_bytes}B holds {plan.held}"

    def stats_ok(got, want, rel):
        return bool(((got - want).abs() <= rel * (1 + want.abs())).all())

    def in_case(b, h, w, c, dtype, affine, slope, valid_w=None, plan=None, op=False):
        """K1' at one shape on each route: output and saved statistics
        against the plain version; on the cluster route also twice (bit
        identity), the statistics against the plain emulation of its fold
        (1e-5 (1 + |ref|): the same shares in the same rank order, summed
        inside a share in another order), and against the two-pass route.
        ``op``: also the registered op ``torch.ops.fots_torch.instance_norm``
        (what an exported program calls) against the plain version, and bit
        for bit against its plan's route."""
        x = rand((b, h, w, c), dtype, 3, 1.5)
        scale = rand(c) if affine else torch.ones(c, device=dev)
        bias = rand(c) if affine else torch.zeros(c, device=dev)
        if valid_w is None:
            want = tin.instance_norm_ref(x, scale, bias, 1e-5, slope)
        else:
            want = tin.masked_instance_norm_ref(x, valid_w, scale, bias, 1e-5, slope)
        want_stats = tin.instance_norm_stats_ref(x, 1e-5, valid_w)
        shape_tag = (f"{'masked ' if valid_w is not None else ''}{str(dtype)[6:]} "
                     f"{(b, h, w, c)} affine={affine} slope={slope}")
        outs = {}
        for pl in routes(plan or tin.in_plan(h, w, c, x.element_size())):
            got, stats = tin.instance_norm_cuda(x, scale, bias, 1e-5, slope, valid_w, True, pl)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == x.shape, "instance_norm shape/dtype")
            tag = f"{shape_tag} [{plan_tag(pl)}]"
            report("instance_norm", tag, forward_ok(got, want, dtype), *errors(got, want))
            report("instance_norm", f"saved (mean, rstd) {tag}",
                   stats_ok(stats, want_stats, 1e-4), *errors(stats, want_stats))
            outs[pl.route] = got
            seen_plans.add(("instance_norm", pl.route, pl.cluster, pl.held))
            if pl.route != "cluster":
                continue
            again, stats2 = tin.instance_norm_cuda(x, scale, bias, 1e-5, slope, valid_w,
                                                   True, pl)
            fold = tin.cluster_fold_stats_ref(x, pl, 1e-5, valid_w)
            torch.cuda.synchronize()
            check(torch.equal(got, again) and torch.equal(stats, stats2),
                  f"instance_norm {tag} differs from run to run")
            report("instance_norm", f"saved (mean, rstd) vs the fold's emulation {tag}",
                   stats_ok(stats, fold, 1e-5), *errors(stats, fold))
        if len(outs) == 2:
            report("instance_norm", f"{shape_tag} cluster vs two_pass",
                   forward_ok(outs["cluster"], outs["two_pass"], dtype),
                   *errors(outs["cluster"], outs["two_pass"]))
        if op:
            got = torch.ops.fots_torch.instance_norm(x, scale, bias, 1e-5, slope, valid_w)
            torch.cuda.synchronize()
            report("instance_norm", f"{shape_tag} [torch.ops.fots_torch.instance_norm]",
                   forward_ok(got, want, dtype), *errors(got, want))
            pl = plan or tin.in_plan(h, w, c, x.element_size())
            check(torch.equal(got, outs[pl.route]),
                  f"torch.ops.fots_torch.instance_norm {shape_tag} differs from its "
                  f"{plan_tag(pl)} launch")

    def bwd_case(b, h, w, c, affine, slope, valid_w=None, halves=1, groups=1, plan=None):
        """K1'-bwd at one shape on each route, and the forward that feeds it
        (K1', or K2'+K3' for the CReLU mode): its output and saved
        statistics."""
        x = rand((b, h, w, c), torch.float32, 3, 1.5)
        g = rand((b, h, w, halves * c))
        shape_tag = f"{'masked ' if valid_w is not None else ''}{(b, h, w, c)}"
        if halves == 1:
            scale = rand(c) if affine else torch.ones(c, device=dev)
            bias = rand(c) if affine else torch.zeros(c, device=dev)
            y, stats = tin.instance_norm_cuda(x, scale, bias, 1e-5, slope, valid_w, True)
            if valid_w is None:
                want_y = tin.instance_norm_ref(x, scale, bias, 1e-5, slope)
            else:
                want_y = tin.masked_instance_norm_ref(x, valid_w, scale, bias, 1e-5, slope)
            want_stats = tin.instance_norm_stats_ref(x, 1e-5, valid_w)
            torch.cuda.synchronize()
            report("instance_norm", f"float32 {shape_tag} affine={affine} slope={slope}",
                   forward_ok(y, want_y, torch.float32), *errors(y, want_y))
            report("instance_norm", f"saved (mean, rstd) {shape_tag}",
                   stats_ok(stats, want_stats, 1e-4), *errors(stats, want_stats))
        else:
            cg = c // groups
            scale, bias = rand(2 * cg), rand(2 * cg)
            y, stats_g = tin._crelu_forward(x, scale, bias, groups, 1e-5, slope)
            want_y = tin.crelu_instance_norm_ref(x, scale, bias, groups, 1e-5, slope)
            torch.cuda.synchronize()
            report("spatial_norm", f"CReLU-IN float32 {shape_tag} groups={groups}",
                   forward_ok(y, want_y, torch.float32), *errors(y, want_y))
            stats, scale, bias = tin._crelu_u_params(stats_g, scale, bias, groups)
        want_dx, want_dsb = tin.instance_norm_bwd_ref(x, g, stats, scale, bias, slope,
                                                      valid_w, halves, groups)
        outs = {}
        for pl in routes(plan or tin.in_bwd_plan(h, w, c, halves)):
            dx, dsb = tin.instance_norm_bwd_cuda(x, g, stats, scale, bias, slope, valid_w,
                                                 halves, groups, pl)
            torch.cuda.synchronize()
            tag = (f"{'crelu ' if halves == 2 else ''}{shape_tag} groups={groups} "
                   f"slope={slope} [{plan_tag(pl)}]")
            for what, got, want in (("dx", dx, want_dx), ("per-sample sums", dsb, want_dsb)):
                ab, rel = errors(got, want)
                # f32 reductions over up to 0.6 M pixels in another order feed
                # the per-(b, c) coefficients: within 1e-4 of the tensor's scale
                ok = ab <= 1e-4 * float(want.abs().max()) + 1e-6
                report("instance_norm_bwd", f"{tag} {what}", ok, ab, rel)
            outs[pl.route] = dx
            seen_plans.add(("instance_norm_bwd", pl.route, pl.cluster, pl.held))
            if pl.route != "cluster":
                continue
            dx2, dsb2 = tin.instance_norm_bwd_cuda(x, g, stats, scale, bias, slope, valid_w,
                                                   halves, groups, pl)
            torch.cuda.synchronize()
            check(torch.equal(dx, dx2) and torch.equal(dsb, dsb2),
                  f"instance_norm_bwd {tag} differs from run to run")
        if len(outs) == 2:
            ab, rel = errors(outs["cluster"], outs["two_pass"])
            report("instance_norm_bwd", f"{shape_tag} dx cluster vs two_pass",
                   ab <= 1e-4 * float(want_dx.abs().max()) + 1e-6, ab, rel)

    def stats_case(shape, dtype):
        x = rand(shape, dtype, 3, 1.5)
        got = tin.spatial_stats_cuda(x)
        want = tin.spatial_stats_ref(x)
        # f32 sums of up to 0.9 M values in another order: within 1e-5 of
        # the sum of |x| (and of the sum of x^2)
        scale = tin.spatial_stats_ref(x.float().abs())
        torch.cuda.synchronize()
        ok = bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
        report("spatial_stats", f"{str(dtype)[6:]} {shape}", ok, *errors(got, want))

    def norm_case(shape, dtype, out_mul, slope):
        x = rand(shape, dtype, 3, 1.5)
        vecs = rand((shape[0], 2 * out_mul, shape[-1]))
        got = tin.spatial_norm_cuda(x, vecs, slope, out_mul)
        want = tin.spatial_norm_ref(x, vecs, slope, out_mul)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        report("spatial_norm", f"{str(dtype)[6:]} {shape} out_mul={out_mul} slope={slope} "
               f"bit-exact={equal}", equal, *errors(got, want))

    def crelu_case(shape, dtype, groups=1):
        """The stem's whole CReLU-IN (K2' + fold + K3') against the plain
        copy of ``_crelu_half_jnp``."""
        x = rand(shape, dtype, 3, 1.5)
        cg = shape[-1] // groups
        scale, bias = rand(2 * cg), rand(2 * cg)
        got = tin.crelu_instance_norm(x, scale, bias, groups)
        want = tin.crelu_instance_norm_ref(x, scale, bias, groups)
        torch.cuda.synchronize()
        report("spatial_norm", f"CReLU-IN {str(dtype)[6:]} {shape} groups={groups}",
               forward_ok(got, want, dtype), *errors(got, want))

    def sliced(shape, dtype, offset):
        """A contiguous tensor of ``shape`` that starts ``offset`` elements
        into its storage (offset 0: a fresh tensor)."""
        n = math.prod(shape)
        return rand((n + offset,), dtype)[offset:].view(shape)

    def pack_route(row_bytes, *tensors):
        wide = row_bytes % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
        return "16-byte" if wide else "narrow"

    def pack_case(shape, dtype, offset=0):
        f = sliced(shape, dtype, offset)
        got = trr.pack_neighbors(f)
        want = trr.pack_neighbors_ref(f)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        name = "pack_neighbors C=3" if (shape[3], dtype) == (3, torch.float32) else "pack_neighbors"
        route = pack_route(shape[3] * f.element_size(), f, got)
        report(name, f"{str(dtype)[6:]} {shape} {route} source at +{f.data_ptr() % 16} bytes "
               f"bit-exact={equal}", equal, *errors(got, want))

    def pack_bwd_case(shape, offset=0):
        n = shape[0] * shape[1] * shape[2]
        g = sliced((n, 4 * shape[3]), torch.float32, offset)
        got = trr.pack_neighbors_bwd_cuda(g, shape)
        want = trr.pack_neighbors_bwd_ref(g, shape)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        name = "pack_neighbors_bwd C=3" if shape[3] == 3 else "pack_neighbors_bwd"
        route = pack_route(shape[3] * 4, g, got)
        report(name, f"f32 {shape} {route} g at +{g.data_ptr() % 16} bytes bit-exact={equal}",
               equal, *errors(got, want))

    def fused_inputs(shape, dtype, seed):
        """Inputs at the scales of the JAX package's K5 tests."""
        c = shape[-1]
        g5 = torch.Generator(device=dev).manual_seed(seed)

        def rn(sh, scale=1.0, shift=0.0):
            return torch.randn(sh, generator=g5, device=dev) * scale + shift

        return (rn(shape).to(dtype), rn((3, 3, c, c), 0.05), rn(c, 0.3, 1.0), rn(c, 0.1),
                rn(shape).to(dtype))

    def fused_case(shape, dtype, slope, with_res, seed=0, abs_limit=None):
        """K5' against its plain version.  f32: |err| <= 2e-5 (1 + |ref|), the
        limit of the JAX package's test (another summation order; the plain
        version's convolution runs without TF32).  bf16: within 2 bf16 ulp of
        max |ref| (kernel and plain version each round the convolution and
        the output to bf16 once, from f32 sums taken in another order), or
        ``abs_limit`` at the profile shape (that test's 0.1)."""
        x, wk, sc, bi, r = fused_inputs(shape, dtype, seed)
        res = r if with_res else None
        got = tfb.fused_conv3x3_in_act(x, wk, sc, bi, res, 1e-5, slope)
        with no_tf32():
            want = tfb.conv_in_act_reference(x, wk, sc, bi, res, 1e-5, slope)
        again = tfb.conv_in_act_cuda(x, wk, sc, bi, res, 1e-5, slope)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == x.shape, "fused_block shape/dtype")
        check(bool(torch.isfinite(got.float()).all()), "fused_block output not finite")
        check(bool(torch.equal(got, again)), "fused_block differs from run to run")
        d = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if dtype == torch.float32:
            ok = bool((d <= 2e-5 * (1 + want.abs())).all())
        elif abs_limit is not None:
            ok = float(d.max()) <= abs_limit
        else:
            ok = float(d.max()) <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
        report("fused_block", f"{str(dtype)[6:]} {shape} slope={slope} residual={with_res}",
               ok, *errors(got, want))

    def fused_grad_case(shape):
        """Gradients of sum(y^2) through the autograd.Function (kernel forward,
        plain backward) against autograd of the plain version: each within
        1e-4 of its tensor's max (the two forwards differ by ~1e-6)."""
        ins = [t.requires_grad_(True) for t in fused_inputs(shape, torch.float32, 2)]
        with no_tf32():
            (tfb.fused_conv3x3_in_act(*ins) ** 2).sum().backward()
            got = [t.grad.clone() for t in ins]
            for t in ins:
                t.grad = None
            (tfb.conv_in_act_reference(*ins) ** 2).sum().backward()
        torch.cuda.synchronize()
        for name, g, t in zip(("dx", "dw", "dscale", "dbias", "dresidual"), got, ins):
            ab, rel = errors(g, t.grad)
            report("fused_block", f"gradient {name} {shape}", rel <= 1e-4, ab, rel)

    print("phase 2: kernels vs plain versions (tolerances: instance_norm and the "
          "CReLU-IN f32 |err| <= 1e-4 (1 + |ref|), bf16 |err| <= 2^-7 |ref| + 1e-3; "
          "instance_norm_bwd max |err| <= 1e-4 max |ref| + 1e-6 per tensor; "
          "spatial_stats |err| <= 1e-5 sum|x| + 1e-6; spatial_norm, pack_neighbors "
          "and pack_neighbors_bwd bit-exact; fused_block f32 |err| <= 2e-5 (1 + |ref|), "
          "bf16 max |err| <= 2 bf16 ulp of max |ref|, 0.1 at the profile shape, "
          "identical from run to run, gradients within 1e-4 of each tensor's max)")
    # (h, w, c, affine, slope) of every K1' InstanceNorm of the detector
    # (layer1..layer4 in1/in2/sep1 norms), at a scale's fraction of (h0, w0)
    def in_shapes(h0, w0):
        return [(h0 // 4, w0 // 4, 64, True, 0.0), (h0 // 4, w0 // 4, 64, True, None),
                (h0 // 8, w0 // 8, 128, True, 0.0), (h0 // 8, w0 // 8, 128, True, None),
                (h0 // 16, w0 // 16, 256, False, 0.01), (h0 // 16, w0 // 16, 256, True, 0.01),
                (h0 // 16, w0 // 16, 256, True, None), (h0 // 32, w0 // 32, 512, False, 0.01),
                (h0 // 32, w0 // 32, 512, True, 0.01), (h0 // 32, w0 // 32, 512, True, None)]

    for dtype in (torch.float32, torch.bfloat16):
        for h, w, c, affine, slope in in_shapes(H, W):
            in_case(BATCH, h, w, c, dtype, affine, slope)
        in_case(3, 7, 13, 20, dtype, True, 0.01)   # odd shape (bf16: scalar path)
        in_case(2, 5, 9, 6, dtype, False, None)    # odd shape, scalar path
        # the recognition head's masked INs at two bucket widths
        for width in (32, 512):
            chunk = FOTSInference._roi_chunk(width)
            vw = torch.randint(1, width + 1, (chunk,), generator=gen, device=dev,
                               dtype=torch.int32)
            for h, c in ((11, 128), (5, 256), (1, 256)):
                in_case(chunk, h, width, c, dtype, True, 0.01, valid_w=vw)
    # the exported bundle's recognition programs: their roi_pad rois at every
    # strip bucket, through the registered op they call
    for path, (b, h, w, c), dtype, _, _ in instance_norm_path_shapes():
        if path == "export strips":
            vw = torch.randint(1, w + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
            in_case(b, h, w, c, dtype, True, 0.01, valid_w=vw, op=True)

    # the training path's backward: every K1' IN at batch 8, 640x960, the
    # masked INs of a 256-wide strip batch, the stem's two CReLU-INs
    for h, w, c, affine, slope in in_shapes(TH, TW):
        bwd_case(TRAIN_BATCH, h, w, c, affine, slope)
    # training from scratch: every K1' IN at batch 8, 512x512, forward and
    # backward, and the stem's CReLU-INs there
    for h, w, c, affine, slope in in_shapes(J, J):
        in_case(TRAIN_BATCH, h, w, c, torch.float32, affine, slope)
        bwd_case(TRAIN_BATCH, h, w, c, affine, slope)
    bwd_case(TRAIN_BATCH, J, J, 16, True, 0.01, halves=2)
    bwd_case(TRAIN_BATCH, J // 2, J // 2, 32, True, 0.01, halves=2)
    vw = torch.randint(1, 257, (32,), generator=gen, device=dev, dtype=torch.int32)
    for h, c in ((11, 128), (5, 256), (1, 256)):
        bwd_case(32, h, 256, c, True, 0.01, valid_w=vw)
    bwd_case(TRAIN_BATCH, TH, TW, 16, True, 0.01, halves=2)
    bwd_case(TRAIN_BATCH, TH // 2, TW // 2, 32, True, 0.01, halves=2)
    bwd_case(3, 7, 13, 20, True, 0.01)                 # odd shapes, scalar paths
    bwd_case(2, 5, 9, 6, False, None, valid_w=torch.tensor([3, 9], device=dev))
    bwd_case(2, 6, 10, 12, True, 0.01, halves=2, groups=4)

    # ragged planes (a pixel count no cluster size divides) on both routes,
    # then every cluster size either kernel may use, forced on one ragged
    # plane; a masked ragged strip batch
    for dtype in (torch.float32, torch.bfloat16):
        in_case(2, 173, 321, 64, dtype, True, 0.01)
        in_case(3, 45, 79, 32, dtype, False, None)
    bwd_case(2, 81, 119, 128, True, 0.01)
    vw = torch.randint(1, 256, (5,), generator=gen, device=dev, dtype=torch.int32)
    in_case(5, 11, 255, 128, torch.bfloat16, True, 0.01, valid_w=vw)
    bwd_case(5, 11, 255, 128, True, 0.01, valid_w=vw)
    for cs in tin.CLUSTER_SIZES:
        in_case(2, 23, 39, 32, torch.bfloat16, True, 0.01,
                plan=tin.in_plan(23, 39, 32, 2, cluster=cs))
        bwd_case(2, 23, 39, 32, True, 0.01,
                 plan=tin.in_plan(23, 39, 32, 4, held="xg", cluster=cs))
    # every (route, cluster size) the plans of the path shapes use was held
    for _, (b, h, w, c), dtype, _, bwd in instance_norm_path_shapes():
        pl = tin.in_plan(h, w, c, 2 if dtype == torch.bfloat16 else 4)
        check(("instance_norm", pl.route, pl.cluster, pl.held) in seen_plans,
              f"phase 2 ran no K1' case as {plan_tag(pl)}")
        if bwd:
            pl = tin.in_bwd_plan(h, w, c)
            check(("instance_norm_bwd", pl.route, pl.cluster, pl.held) in seen_plans,
                  f"phase 2 ran no K1'-bwd case as {plan_tag(pl)}")
    for kernel in ("instance_norm", "instance_norm_bwd"):
        for route in ("cluster", "two_pass"):
            check(any(k == kernel and r == route for k, r, _, _ in seen_plans),
                  f"phase 2 ran {kernel} on no {route} case")
    print(f"  routes held: {sorted(seen_plans)}")

    # K2' / K3' and the whole CReLU-IN at the stem's serving (bf16) and
    # training (f32) shapes, plus odd shapes
    stem = [((BATCH, H, W, 16), torch.bfloat16), ((BATCH, H // 2, W // 2, 32), torch.bfloat16),
            ((TRAIN_BATCH, TH, TW, 16), torch.float32),
            ((TRAIN_BATCH, TH // 2, TW // 2, 32), torch.float32),
            ((TRAIN_BATCH, J, J, 16), torch.float32),
            ((TRAIN_BATCH, J // 2, J // 2, 32), torch.float32),
            ((3, 7, 13, 20), torch.float32), ((2, 5, 9, 6), torch.bfloat16)]
    for shape, dtype in stem:
        stats_case(shape, dtype)
        norm_case(shape, dtype, 2, 0.01)
        norm_case(shape, dtype, 1, None)
        crelu_case(shape, dtype)
    crelu_case((2, 6, 10, 12), torch.float32, groups=4)

    # the recognition trainers' crops: the stem's CReLU-INs (K2' + K3', and
    # K1'-bwd in CReLU mode) and the head's INs (K1' with its statistics,
    # K1'-bwd) at the smallest and the largest bucket the ocr phase batches
    for n, w in ocr_bucket_shapes():
        for shape in ((n, OCR_HEIGHT, w, 16), (n, OCR_HEIGHT // 2, w // 2, 32)):
            stats_case(shape, torch.float32)
            norm_case(shape, torch.float32, 2, 0.01)
            crelu_case(shape, torch.float32)
            bwd_case(*shape, True, 0.01, halves=2)
        for h, c in ((OCR_HEIGHT // 4, 128), (OCR_HEIGHT // 4 // 2, 256),
                     (OCR_HEIGHT // 4 // 2 // 2, 256)):
            in_case(n, h, w // 4, c, torch.float32, True, 0.01)
            bwd_case(n, h, w // 4, c, True, 0.01)

    # K4': the 16-byte kernel at the serving and training maps (and rows of
    # 32 and 48 bytes), the narrow kernel at every other row.  Narrow cases:
    # each C of f32 and bf16 at B = 2 with odd W (rows that run from one
    # image into the next), with fewer rows than one block's span, with a
    # row count no span divides, from a source 4 bytes past a 16-byte
    # boundary (a sliced view; also a 16-byte row, which then goes narrow),
    # and at the three timed shapes
    for shape, dtype in (((BATCH, H // 4, W // 4, 64), torch.bfloat16),
                         ((TRAIN_BATCH, TH // 4, TW // 4, 64), torch.float32),
                         ((TRAIN_BATCH, J // 4, J // 4, 64), torch.float32),
                         ((3, 5, 7, 8), torch.float32), ((2, 3, 5, 24), torch.bfloat16),
                         (IMAGE_PACK_SHAPE, torch.float32), (IMAGE_PACK_SHAPE, torch.bfloat16),
                         (DEMO_SHAPE, torch.float32)):
        pack_case(shape, dtype)
    for dtype, channels in ((torch.float32, (1, 2, 3, 5, 6, 7)),
                            (torch.bfloat16, (1, 2, 3, 5, 6, 7, 12))):
        for c in channels:
            pack_case((2, 5, 7, c), dtype)          # N = 70, under one span
            pack_case((2, 37, 61, c), dtype)        # N = 4514, ragged last span
            # 4 bytes into the storage
            pack_case((2, 37, 61, c), dtype, offset=1 if dtype == torch.float32 else 2)
    pack_case((2, 37, 61, 4), torch.float32, offset=1)
    pack_case((2, 3, 5, 8), torch.bfloat16, offset=2)
    pack_case(IMAGE_PACK_SHAPE, torch.float32, offset=1)
    # K4'-bwd: the 4-float kernel at the training maps (and C = 8, 4), the
    # narrow kernel at every other C, in the same cases
    for shape in ((TRAIN_BATCH, TH // 4, TW // 4, 64), (TRAIN_BATCH, J // 4, J // 4, 64),
                  (3, 5, 7, 8), (2, 3, 5, 4), IMAGE_PACK_SHAPE, DEMO_SHAPE):
        pack_bwd_case(shape)
    for c in (1, 2, 3, 5, 6, 7):
        pack_bwd_case((2, 5, 7, c))
        pack_bwd_case((2, 37, 61, c))
        pack_bwd_case((2, 37, 61, c), offset=1)
    pack_bwd_case((2, 37, 61, 4), offset=1)
    pack_bwd_case(DEMO_SHAPE, offset=1)

    # NMS candidates with more than k pixels tied at 1.0 (the snapshot's
    # saturated sigmoid) at the serving map size: the card takes the same
    # pixels as the CPU (ties in ascending pixel order, as fots takes them)
    from fots_torch.ops import nms as tnms
    hs, ws_ = H // 4, W // 4
    segm = torch.rand((2, hs, ws_), generator=gen, device=dev)
    segm[0, : hs // 2] = 1.0
    segm[1] = torch.where(torch.rand((hs, ws_), generator=gen, device=dev) < 0.3, 1.0, segm[1])
    geo = torch.rand((2, hs, ws_, 4), generator=gen, device=dev) * 60
    ang = torch.rand((2, hs, ws_, 2), generator=gen, device=dev)
    k = 8192
    check(bool(((segm == 1.0).sum(dim=(1, 2)) > k).all()), "NMS tie case: too few ties")
    got = tnms.extract_candidates(segm, geo, ang, k).cpu()
    want = tnms.extract_candidates(segm.cpu(), geo.cpu(), ang.cpu(), k)
    check(torch.equal(got, want), "NMS candidates with ties: the card's pixel set or "
          "pack differs from the CPU's")
    print(f"  NMS candidates, 2 maps {hs}x{ws_} with "
          f"{(segm == 1.0).sum(dim=(1, 2)).tolist()} pixels tied at 1.0, k = {k}: the card's "
          "pixels and pack equal the CPU's")

    # K5': the JAX package's test shapes (f32), a ragged shape (H, W not
    # multiples of 8, C = 48), bf16 at every C it is built for, and the
    # profile shape
    for slope in (None, 0.01):
        for with_res in (True, False):
            fused_case((2, 32, 48, 64), torch.float32, slope, with_res)
    fused_case((1, 40, 32, 64), torch.float32, None, True, seed=3)
    fused_case((2, 16, 32, 128), torch.float32, 0.01, True, seed=4)
    for dtype in (torch.float32, torch.bfloat16):
        fused_case((2, 13, 21, 48), dtype, 0.01, True, seed=5)
    fused_case((1, 9, 70, 16), torch.bfloat16, None, False, seed=6)
    for c in (32, 80, 96, 112):  # every other wgmma width (N = C) and K-block split
        fused_case((2, 13, 21, c), torch.bfloat16, 0.01, True, seed=c)
    fused_case((2, 32, 48, 64), torch.bfloat16, None, True, seed=1)
    fused_case(FUSED_SHAPE, torch.bfloat16, None, True, abs_limit=0.1)
    fused_case(FUSED_SHAPE, torch.bfloat16, 0.01, False, abs_limit=0.1)
    fused_grad_case((2, 32, 48, 64))

    # times: serving kernels at the serving shape (bf16), training kernels
    # at the training shape (f32), K5' at its profile shape (bf16)
    _, bw, f32_rate, bf16_rate = peaks
    rows = {}

    def row(name, shape, dtype, kernel, plain, library, nbytes, ops, library_note=None,
            rate=f32_rate, **extra):
        # ms: CUDA events around each call; device_busy_ms: the device's busy
        # time a call (torch.profiler), without its waits for the host
        rows[name] = dict(ms=cuda_median_ms(kernel), device_busy_ms=cuda_busy_ms(kernel),
                          plain_ms=cuda_median_ms(plain),
                          library_ms=None if library is None else cuda_median_ms(library),
                          library_note=library_note, bound=(nbytes / bw, ops / rate),
                          shape=list(shape), dtype=dtype, extra=extra)

    x = rand((BATCH, H // 4, W // 4, 64), torch.bfloat16)
    scale, bias = rand(64), rand(64)
    nb = x.numel() * x.element_size()
    x_nchw = x.permute(0, 3, 1, 2)

    def both_routes(plan, call, cluster_plan=None):
        """The plan's route at the table shape, and each route's time (where
        the plan takes two passes, ``cluster_plan`` is the cut that is timed
        beside it)."""
        timed = routes(plan) if cluster_plan is None else [cluster_plan, plan]
        return {"plan": plan_tag(plan),
                "route_ms": {plan_tag(pl): cuda_median_ms(lambda: call(pl)) for pl in timed},
                # without the card's waits for the host between launches
                "route_device_busy_ms": {plan_tag(pl): cuda_busy_ms(lambda: call(pl))
                                         for pl in timed}}

    row("instance_norm", x.shape, "bf16",
        lambda: tin.instance_norm_cuda(x, scale, bias, 1e-5, 0.0),
        lambda: tin.instance_norm_ref(x, scale, bias, 1e-5, 0.0),
        lambda: torch.nn.functional.instance_norm(x_nchw, weight=scale.to(x.dtype),
                                                  bias=bias.to(x.dtype), eps=1e-5),
        2 * nb, 6 * x.numel(), "F.instance_norm (no fused ReLU)",
        **both_routes(tin.in_plan(*x.shape[1:], 2),
                      lambda pl: tin.instance_norm_cuda(x, scale, bias, 1e-5, 0.0, plan=pl)))
    row("pack_neighbors", x.shape, "bf16", lambda: trr.pack_neighbors_cuda(x),
        lambda: trr.pack_neighbors_ref(x), None, 5 * nb, 0,
        "null: no single PyTorch call builds the quads")
    # the CRNN crops' images (C = 3): 12-byte f32 rows (4-byte vectors) and
    # 6-byte bf16 rows (2-byte vectors)
    image_rows = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        xi = rand(IMAGE_PACK_SHAPE, dtype)
        row(f"pack_neighbors {tag} C=3", xi.shape, tag, lambda: trr.pack_neighbors_cuda(xi),
            lambda: trr.pack_neighbors_ref(xi), None, 5 * xi.numel() * xi.element_size(), 0,
            "null: no single PyTorch call builds the quads")
        image_rows[tag] = rows.pop(f"pack_neighbors {tag} C=3")

    xs = rand((BATCH, H, W, 16), torch.bfloat16, 3, 1.5)
    nbs = xs.numel() * xs.element_size()
    vecs = rand((BATCH, 4, 16))
    row("spatial_stats", xs.shape, "bf16", lambda: tin.spatial_stats_cuda(xs),
        lambda: tin.spatial_stats_ref(xs),
        lambda: torch.var_mean(xs, dim=(1, 2), correction=0),
        nbs + BATCH * 2 * 16 * 4, 3 * xs.numel(), "torch.var_mean (mean and variance)")
    row("spatial_norm", xs.shape, "bf16", lambda: tin.spatial_norm_cuda(xs, vecs, 0.01, 2),
        lambda: tin.spatial_norm_ref(xs, vecs, 0.01, 2), None, 3 * nbs, 6 * xs.numel(),
        "null: no single PyTorch call writes both affine halves with leaky")

    xt = rand((TRAIN_BATCH, TH // 4, TW // 4, 64), torch.float32, 3, 1.5)
    gt = rand(xt.shape)
    st, sc, bi = tin.instance_norm_stats_ref(xt), rand(64), rand(64)
    nbt = xt.numel() * 4
    b_, h_, w_, c_ = xt.shape
    xt_nchw = xt.permute(0, 3, 1, 2).contiguous()
    gt_nchw = gt.permute(0, 3, 1, 2).contiguous()
    mean_, rstd_ = st[:, 0].contiguous(), st[:, 1].contiguous()
    row("instance_norm_bwd", xt.shape, "f32",
        lambda: tin.instance_norm_bwd_cuda(xt, gt, st, sc, bi, 0.0),
        lambda: tin.instance_norm_bwd_ref(xt, gt, st, sc, bi, 0.0),
        lambda: torch.ops.aten.native_group_norm_backward(
            gt_nchw, xt_nchw, mean_, rstd_, sc, b_, c_, h_ * w_, c_, [True, True, True]),
        3 * nbt, 12 * xt.numel(),
        "aten.native_group_norm_backward with one channel per group (no ReLU gate)",
        **both_routes(tin.in_bwd_plan(h_, w_, c_),
                      lambda pl: tin.instance_norm_bwd_cuda(xt, gt, st, sc, bi, 0.0, plan=pl),
                      # x and g of a 64-byte group do not fit 16 blocks here: the
                      # one cluster cut that holds them has 32-byte groups
                      tin.in_plan(h_, w_, c_, 4, held="xg", cluster=16, channels=8)))
    n_rows = b_ * h_ * w_
    gq = rand((n_rows, 4 * c_))
    quad_index = (torch.arange(n_rows, device=dev)[:, None]
                  + torch.tensor([0, 1, w_, w_ + 1], device=dev)[None, :]).reshape(-1)
    acc = torch.zeros((n_rows + w_ + 1, c_), device=dev)
    gq_rows = gq.view(n_rows * 4, c_)
    row("pack_neighbors_bwd", xt.shape, "f32",
        lambda: trr.pack_neighbors_bwd_cuda(gq, tuple(xt.shape)),
        lambda: trr.pack_neighbors_bwd_ref(gq, tuple(xt.shape)),
        lambda: acc.index_add_(0, quad_index, gq_rows), 5 * nbt, 3 * xt.numel(),
        "index_add_ of the 4N quad rows into N + W + 1 rows")

    # K4' and K4'-bwd at C = 3 f32 (12-byte rows: 4-byte vectors in the pack,
    # 1-float vectors in its backward), at cli.rroi_demo's image (the main
    # path's shape) and at the CRNN crops' images.  K4' reads 12 B and
    # writes 48 B a pixel, K4'-bwd reads 48 B (g) and writes 12 B (df) with
    # three adds an element: 60 B a pixel each
    c3_rows = {name: {} for name in C3_KERNELS}
    for shape in (DEMO_SHAPE, IMAGE_PACK_SHAPE):
        x3 = rand(shape)
        b3, h3, w3, c3 = shape
        n3 = b3 * h3 * w3
        g3 = rand((n3, 4 * c3))
        index3 = (torch.arange(n3, device=dev)[:, None]
                  + torch.tensor([0, 1, w3, w3 + 1], device=dev)[None, :]).reshape(-1)
        acc3 = torch.zeros((n3 + w3 + 1, c3), device=dev)
        g3_rows = g3.view(n3 * 4, c3)
        nb3 = x3.numel() * 4
        row("c3 fwd", shape, "f32", lambda: trr.pack_neighbors_cuda(x3),
            lambda: trr.pack_neighbors_ref(x3), None, 5 * nb3, 0,
            "null: no single PyTorch call builds the quads")
        row("c3 bwd", shape, "f32", lambda: trr.pack_neighbors_bwd_cuda(g3, shape),
            lambda: trr.pack_neighbors_bwd_ref(g3, shape),
            lambda: acc3.index_add_(0, index3, g3_rows), 5 * nb3, 3 * x3.numel(),
            "index_add_ of the 4N quad rows into N + W + 1 rows")
        c3_rows["pack_neighbors C=3"][shape] = rows.pop("c3 fwd")
        c3_rows["pack_neighbors_bwd C=3"][shape] = rows.pop("c3 bwd")
    for name, by_shape in c3_rows.items():
        # the entry is the main path's shape (printed with the rows below);
        # the crops' images ride along
        r = by_shape[IMAGE_PACK_SHAPE]
        print(f"  {name} at {IMAGE_PACK_SHAPE} f32: kernel {r['ms']:.4f} ms, device busy "
              f"{r['device_busy_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']} ms "
              f"({r['library_note']}), bound {1e3 * max(r['bound']):.4f} ms")
        entry = dict(by_shape[DEMO_SHAPE])
        entry["extra"] = {"at_" + "x".join(map(str, IMAGE_PACK_SHAPE)): {
            k: (1e3 * max(v) if k == "bound" else v)
            for k, v in by_shape[IMAGE_PACK_SHAPE].items() if k != "extra"}}
        rows[name] = entry

    # K5' at the profile entry's own inputs.  Its bound counts x, the
    # residual and the weights read once, the output written once, and one
    # convolution at the bf16 tensor-core rate; beside it the least time of
    # the two designs: the TPU kernel's (convolve twice, four activation
    # tensors) and this kernel's (convolve once, five: it writes and reads
    # the pre-norm output)
    fx, fw, fg, fb_, fr = fused_block_inputs(FUSED_SHAPE, dev)
    n5, h5, w5, c5 = FUSED_SHAPE
    act_bytes = fx.numel() * fx.element_size()
    conv_ops = 2 * 9 * c5 * c5 * n5 * h5 * w5
    w_oihw = fw.to(fx.dtype).permute(3, 2, 0, 1).contiguous()
    fr_nchw, fg_t, fb_t = fr.permute(0, 3, 1, 2), fg.to(fx.dtype), fb_.to(fx.dtype)
    row("fused_block", FUSED_SHAPE, "bf16",
        lambda: tfb.conv_in_act_cuda(fx, fw, fg, fb_, fr),
        lambda: tfb.conv_in_act_reference(fx, fw, fg, fb_, fr),
        lambda: torch.relu(torch.nn.functional.instance_norm(
            torch.nn.functional.conv2d(fx.permute(0, 3, 1, 2), w_oihw, padding=1),
            weight=fg_t, bias=fb_t, eps=1e-5) + fr_nchw),
        3 * act_bytes + 9 * c5 * c5 * 2 + 2 * c5 * 4, conv_ops,
        "F.conv2d + F.instance_norm + add + relu: four PyTorch calls, no single one "
        "computes the function", rate=bf16_rate,
        bound_ms_recompute_design=1e3 * max(4 * act_bytes / bw, 2 * conv_ops / bf16_rate),
        bound_ms_compute_once_design=1e3 * max(5 * act_bytes / bw, conv_ops / bf16_rate))

    # the stem's CReLU-IN as served now (K2' + fold + K3') and as PR 1 ran
    # it (torch.cat + K1'), for the record
    sc32, bi32 = rand(32), rand(32)
    crelu_ms = cuda_median_ms(lambda: tin.crelu_instance_norm(xs, sc32, bi32))
    cat_ms = cuda_median_ms(lambda: tin.instance_norm_cuda(torch.cat([xs, -xs], -1),
                                                           sc32, bi32, 1e-5, 0.01))
    for name, r in rows.items():
        print(f"  {name} at {tuple(r['shape'])} {r['dtype']}: kernel {r['ms']:.4f} ms, device "
              f"busy {r['device_busy_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']} ms ({r['library_note']}), bound "
              f"{1e3 * max(r['bound']):.4f} ms"
              + (f"; by route {r['extra']['route_ms']}, device busy "
                 f"{r['extra']['route_device_busy_ms']}" if "route_ms" in r["extra"] else ""))
    print(f"  CReLU-IN at {tuple(xs.shape)} bf16: K2'+fold+K3' {crelu_ms:.4f} ms, "
          f"torch.cat + K1' {cat_ms:.4f} ms")
    for tag, r in image_rows.items():
        r["bound_ms"] = 1e3 * max(r.pop("bound"))
        print(f"  pack_neighbors at {tuple(r['shape'])} {tag} (C = 3): kernel {r['ms']:.4f} "
              f"ms, device busy {r['device_busy_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']} ms "
              f"({r['library_note']}), bound {r['bound_ms']:.4f} ms")
    rows["pack_neighbors"]["extra"]["images_c3"] = image_rows
    return worst, rows, {"crelu_ms": crelu_ms, "cat_plus_in_ms": cat_ms}


# --------------------------------------------------------------------------
# phases 3 and 4: serving
# --------------------------------------------------------------------------

def phase_serve_parity(images):
    """f32 CUDA port against the f32 CPU port on one batch of two images."""
    from fots_torch.checkpoint import load_detector
    from fots_torch.pipeline import FOTSInference

    print(f"phase 3: CUDA port vs CPU port, serving, f32 (TF32 off), 2 images at {SERVE_HW}")
    results = {}
    with no_tf32():
        for device in ("cuda", "cpu"):
            model, _, config = load_detector(SNAPSHOT, device)
            with FOTSInference(model, masked_norm=config.get("masked_norm", False),
                               device=device) as eng:
                t0 = time.perf_counter()
                results[device] = eng.batch_call(list(images[:2]), serve_hw=SERVE_HW)
                print(f"  {device}: {time.perf_counter() - t0:.2f} s, boxes "
                      f"{[len(r) for r in results[device]]}")
    got, want = results["cuda"], results["cpu"]
    check([len(r) for r in got] == [len(r) for r in want], "box counts differ")
    check(sum(len(r) for r in want) > 0, "no text found on the smoke images")
    worst = 0.0
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            worst = max(worst, float(np.abs(g["box"][:8] - w["box"][:8]).max()))
            check(g["text"] == w["text"], f"texts differ: {g['text']!r} vs {w['text']!r}")
    print(f"  texts {[[e['text'] for e in r] for r in got]}; max corner diff {worst:.4f} px")
    check(worst <= 1.0, f"quad corners differ by {worst} px")
    return worst


def phase_serve(images):
    """bf16 serving at batch 16, 704x1280: a main path for the counts."""
    from fots_torch.checkpoint import load_detector
    from fots_torch.kernels import build
    from fots_torch.pipeline import FOTSInference

    print(f"phase 4: serving, bf16, batch {BATCH} at {SERVE_HW}, "
          f"{STREAM_BATCHES} batches through stream()")
    model, step, config = load_detector(SNAPSHOT, "cuda")
    batch = [images[i % len(images)] for i in range(BATCH)]
    with FOTSInference(model, masked_norm=config.get("masked_norm", False),
                       mixed_precision=True, cand_transport="u16",
                       device="cuda") as eng:
        eng.batch_call(batch, serve_hw=SERVE_HW)  # warm-up, not counted
        torch.cuda.synchronize()
        build.reset_launch_counts()
        stamps = []
        outs = []
        for res in eng.stream(iter([batch] * STREAM_BATCHES), serve_hw=SERVE_HW):
            stamps.append(time.perf_counter())
            outs.append(res)
        torch.cuda.synchronize()
        launches = {**build.launch_counts, **build.route_counts}
    check(len(outs) == STREAM_BATCHES, "stream lost batches")
    for res in outs:
        check(len(res) == BATCH and all(len(r) > 0 for r in res),
              "an image of the serving batch yielded no text")
        for r in res:
            for e in r:
                check(np.isfinite(e["box"]).all() and 0.0 < e["conf"] <= 1.0,
                      "non-finite box or confidence out of range")
    for name in build.PATH_KERNELS["serving"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the serving path")
    steady = (STREAM_BATCHES - 1) * BATCH / (stamps[-1] - stamps[0])
    print(f"  snapshot step {step}, config {config}; texts of image 0: "
          f"{[e['text'] for e in outs[-1][0]]}")
    print(f"  launches {launches} over {STREAM_BATCHES} batches; "
          f"{steady:.2f} images/s over batches 2..{STREAM_BATCHES}")
    return launches, steady


# --------------------------------------------------------------------------
# phase 5: the exported serving bundle
# --------------------------------------------------------------------------

def _models_imported():
    return sorted(m for m in sys.modules
                  if m == "fots_torch.models" or m.startswith("fots_torch.models."))


def serve_bundle(bundle: str, out_path: str) -> int:
    """``--serve-bundle``: load ``bundle`` in this (fresh) process, serve one
    batch of the smoke images repeated to the bundle's batch, and write the
    results, the kernel launches (the counts zeroed just before the engine is
    built: its warm-up and capture calls) and the ``fots_torch.models``
    modules this process imported to ``out_path`` as JSON."""
    from fots_torch.export import ExportedEngine
    from fots_torch.kernels import build

    with np.load(SMOKE_IMAGES) as z:
        images = list(z["images"])
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with ExportedEngine(bundle) as engine:
        load_s = time.perf_counter() - t0
        batch = [images[i % len(images)] for i in range(engine.manifest["batch"])]
        res = engine.batch_call(batch)
        torch.cuda.synchronize()
    with open(out_path, "w") as f:
        json.dump({"results": [[{"box": e["box"].tolist(), "text": e["text"],
                                 "conf": e["conf"]} for e in r] for r in res],
                   "launches": {**build.launch_counts, **build.route_counts},
                   "models_imported": _models_imported(), "load_s": load_s}, f)
    return 0


def _python_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _run_child(args, what: str):
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=900, env=_python_env(), cwd=REPO)
    for line in proc.stdout.splitlines()[-6:]:
        print(f"  [{what}] {line}")
    check(proc.returncode == 0, f"{what} failed (exit {proc.returncode}):\n"
          f"{proc.stderr[-4000:]}")


def _graph_launches(names) -> dict:
    """Calls of each serving kernel's wrapper (and of K1' by route) read off
    the device kernels' names of a trace (see ``GRAPH_KERNELS``)."""
    counts = {}
    for kernel, frags in GRAPH_KERNELS.items():
        counts[kernel] = 0
        for route, frag in frags:
            n = sum(frag in name for name in names)
            counts[kernel] += n
            if route:
                counts[f"{kernel}/{route}"] = n
    return counts


def phase_export(images):
    """The exported bundle at the serving shape (a main path)."""
    from fots_torch.checkpoint import load_detector
    from fots_torch.export import ROI_PAD, ExportedEngine, export_serving
    from fots_torch.kernels import build
    from fots_torch.pipeline import FOTSInference
    from fots_torch.profiling import card_name_and_power_limit, images_per_s, profile_window

    print(f"phase 5: exported bundle, bf16, batch {BATCH} at {SERVE_HW}, roi_pad "
          f"{ROI_PAD}: export, serve from a fresh process, graphs vs eager")
    model, _, config = load_detector(SNAPSHOT, "cuda")
    batch = [images[i % len(images)] for i in range(BATCH)]
    out = {"batch": BATCH, "serve_hw": list(SERVE_HW), "dtype": "bf16",
           "roi_pad": ROI_PAD}
    with tempfile.TemporaryDirectory(prefix="fots_bundle_") as tmp, \
            FOTSInference(model, masked_norm=config.get("masked_norm", False),
                          mixed_precision=True, device="cuda",
                          device_letterbox=False) as eng:
        # 1. export; no program carries a weight
        bundle = os.path.join(tmp, "bundle")
        t0 = time.perf_counter()
        manifest = export_serving(eng, bundle, BATCH, *SERVE_HW, roi_pad=ROI_PAD,
                                  platforms=("cuda",))
        out["export_s"] = time.perf_counter() - t0
        out["files_bytes"] = {f: os.path.getsize(os.path.join(bundle, f))
                              for f in sorted(os.listdir(bundle))}
        weights = out["files_bytes"]["params.npz"]
        for f, size in out["files_bytes"].items():
            check(not f.endswith(".pt2") or size < weights / 8,
                  f"{f} ({size} bytes) is large enough to carry the weights ({weights})")
        print(f"  exported {len(manifest['programs'])} programs in {out['export_s']:.1f} s; "
              f"torch {manifest['torch_version']}, platforms {manifest['platforms']}")

        # 2. a fresh process serves it without the model code
        served_path = os.path.join(tmp, "served.json")
        _run_child([os.path.abspath(__file__), "--serve-bundle", bundle, served_path],
                   "serve-bundle")
        with open(served_path) as f:
            served = json.load(f)
        check(not served["models_imported"],
              f"the bundle's runtime imported {served['models_imported']}")
        setup = served["launches"]
        for name in build.PATH_KERNELS["export"]:
            check(setup[name] > 0, f"kernel {name} was not launched on the export path")
        out["setup_launches"] = setup
        out["subprocess_load_s"] = served["load_s"]
        print(f"  fresh process: loaded and captured in {served['load_s']:.1f} s, imported "
              f"no fots_torch.models; launches counted in its warm-up and capture "
              f"calls (a replay counts none) {setup}")

        # 3. held against the in-process engine on the same batch
        want = eng.batch_call(batch, serve_hw=SERVE_HW)
        got = served["results"]
        check([len(r) for r in got] == [len(r) for r in want],
              f"box counts differ: {[len(r) for r in got]} vs {[len(r) for r in want]}")
        check(all(len(r) > 0 for r in want), "an image of the batch yielded no text")
        corner = conf = 0.0
        for g_img, w_img in zip(got, want):
            for g, w in zip(g_img, w_img):
                check(g["text"] == w["text"], f"texts differ: {g['text']!r} vs {w['text']!r}")
                corner = max(corner, float(np.abs(np.asarray(g["box"][:8]) - w["box"][:8]).max()))
                conf = max(conf, abs(g["conf"] - w["conf"]))
        print(f"  bundle vs in-process batch_call: {sum(len(r) for r in want)} boxes, texts "
              f"identical, max corner diff {corner:.3e} px, max conf diff {conf:.3e}")
        check(corner <= 1e-4, f"quad corners differ by {corner} px")
        check(conf <= 1e-5, f"confidences differ by {conf}")
        out["vs_in_process"] = {"boxes": sum(len(r) for r in want),
                                "max_corner_px": corner, "max_conf": conf}

        with ExportedEngine(bundle) as ex:
            for name, prog in ex.programs.items():
                held = (len(prog.program.state_dict) + len(prog.program.constants)
                        + (prog.program.example_inputs is not None))
                check(held == 0, f"{name}.pt2 carries {held} tensors or example inputs")
            # 4. each graph replay bit-equal to an eager call of its program
            used = {}
            recognize = ex.recognize

            def recording(quads, rois, width):
                used.setdefault(width, rois.copy())
                return recognize(quads, rois, width)

            ex.recognize = recording
            ex.batch_call(batch)
            del ex.recognize
            det = ex.programs["detect"]
            graph_out = [t.clone() for t in det()]
            check(all(torch.equal(g, e) for g, e in zip(graph_out, det.eager())),
                  "the detection graph's replay differs from an eager call")
            for width, rois in sorted(used.items()):
                prog = ex.programs[f"recognize_{width}"]
                r = torch.from_numpy(rois).cuda()
                graph_out = [t.clone() for t in prog(prog.inputs[0], r)]
                check(all(torch.equal(g, e) for g, e in
                          zip(graph_out, prog.eager(prog.inputs[0], r))),
                      f"the recognize_{width} graph's replay differs from an eager call")
            out["graphs_bit_equal"] = ["detect"] + [f"recognize_{w}" for w in sorted(used)]
            print(f"  graph replay == eager call, bit for bit: {out['graphs_bit_equal']}")

            # 5. the serving kernels inside the graphs: one replay of the
            # detection graph and of each recognition graph the batch used
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            out["graph_kernels"] = {}
            for name in ["detect"] + [f"recognize_{w}" for w in sorted(used)]:
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    ex.programs[name]()
                    torch.cuda.synchronize()
                names = [e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
                out["graph_kernels"][name] = {
                    "device_kernels": len(names),
                    "cudaGraphLaunch": sum(e.name == "cudaGraphLaunch" for e in prof.events()),
                    **_graph_launches(names)}
            for k, frags in GRAPH_KERNELS.items():
                check(out["graph_kernels"]["detect"][k] > 0,
                      f"no {k} kernel ({frags}) in a replayed detection graph")
            for w in used:
                check(out["graph_kernels"][f"recognize_{w}"]["instance_norm"] > 0,
                      f"no instance_norm kernel in a replayed recognize_{w} graph")
            print(f"  one replay of each graph, serving kernels read off the trace: "
                  f"{out['graph_kernels']}")

            # 6. reported, not held: both engines with the host letterbox,
            # then one profiled window each; the exported window's trace
            # gives the exported path's launches
            smi = card_name_and_power_limit()
            in_process = lambda b: eng.batch_call(b, serve_hw=SERVE_HW)  # noqa: E731
            window = EXPORT_BATCHES - 1
            ips = {"in_process": images_per_s(in_process, batch, window),
                   "exported": images_per_s(ex.batch_call, batch, window)}
            prof_out, names = {}, []
            for key, call, sink in (("in_process", in_process, None),
                                    ("exported", ex.batch_call, names)):
                summary = profile_window(lambda: [call(batch) for _ in range(window)],
                                         window, sink)
                prof_out[key] = {k: summary[k] for k in (
                    "wall_ms_per_batch", "device_busy_ms_per_batch", "device_idle_share",
                    "kernel_launches_per_batch", "host_launch_calls_per_batch")}
            launches = _graph_launches(names)
            for name in build.PATH_KERNELS["export"]:
                check(launches[name] > 0,
                      f"kernel {name} ran in no exported batch of the profiled window")
            out.update(images_per_s=ips, profile=prof_out, card=smi, export_batches=window,
                       launches=launches)
            print(f"  [{smi}] images/s over batches 2..{EXPORT_BATCHES}: {ips}")
            for key, summary in prof_out.items():
                print(f"  [{smi}] {key}: {summary}")
            print(f"  exported path, {window} batches: serving kernel launches read off "
                  f"the trace {launches}")

        # 7. cli.serve writes what stream() returns
        with np.load(SMOKE_IMAGES) as z:
            names = [os.path.splitext(os.path.basename(str(n)))[0] for n in z["names"]]
        json_dir = os.path.join(tmp, "served_json")
        _run_child(["-m", "fots_torch.cli.serve", "-model", SNAPSHOT, "-images_npz",
                    SMOKE_IMAGES, "-output", json_dir, "-batch", str(BATCH)], "cli.serve")
        (_, res), = list(eng.stream(iter([(names, list(images))]), serve_hw=SERVE_HW,
                                    with_context=True))
        for name, r in zip(names, res):
            with open(os.path.join(json_dir, name + ".json")) as f:
                written = json.load(f)
            check(written == [{"box": e["box"].tolist(), "text": e["text"]} for e in r],
                  f"cli.serve's {name}.json differs from stream()'s result")
        out["cli_serve_images"] = len(names)
        print(f"  cli.serve: {len(names)} json files equal stream()'s results")
    return launches, out


# --------------------------------------------------------------------------
# phases 5 and 6: training
# --------------------------------------------------------------------------

def phase_train_parity(images, targets, ohem=False):
    """One training step, f32, CUDA port against CPU port (``ohem``: the OHEM
    score loss in place of dice)."""
    from fots_torch.checkpoint import load_detector
    from fots_torch.codec import LabelCodec
    from fots_torch.losses import repeat_infeasible_rows
    from fots_torch.roirotate import sample_rois
    from fots_torch.train import (METRIC_KEYS, asset_batch, ctc_frame_count,
                                  pack_host_batch, train_losses, unpack_device_batch)

    batch = asset_batch(images, targets, [0, 1])
    hw = tuple(batch.images.shape[1:3])
    roi = sample_rois(np.random.default_rng(0), batch.score_maps, batch.gt_idxs,
                      batch.gt_quads, batch.labels, hw, LabelCodec())
    host = pack_host_batch(batch, roi)
    frames = ctc_frame_count(roi.rois, roi.roi_mask, roi.strip_width)
    optax_rows = repeat_infeasible_rows(roi.labels, roi.label_lengths,
                                        np.full(len(roi.roi_mask), frames))
    print(f"phase 6: one training step{' with OHEM' if ohem else ''}, CUDA port vs CPU "
          f"port, f32 (TF32 off), 2 scenes at {hw}, {int(roi.roi_mask.sum())} rois, strip width "
          f"{roi.strip_width}, {frames} CTC frames")
    torch.set_num_threads(os.cpu_count() or 1)
    res = {}
    with no_tf32():
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            model, _, _ = load_detector(SNAPSHOT, device)
            model.train()
            opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, betas=(0.5, 0.999),
                                   eps=1e-8)
            dev_batch = unpack_device_batch(*[torch.from_numpy(a).to(device) for a in host],
                                            hw)
            _, terms, _ = train_losses(model, dev_batch, roi.strip_width, frames,
                                       torch.Generator().manual_seed(7), ohem=ohem,
                                       optax_rows=optax_rows)
            terms["loss"].backward()
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            opt.step()
            res[device] = ({k: terms[k].item() for k in METRIC_KEYS}, grads,
                           {n: t.detach().cpu().clone() for n, t in model.state_dict().items()})
            print(f"  {device}: {time.perf_counter() - t0:.2f} s, losses {res[device][0]}")
            del model, opt, dev_batch, terms
    (lc, gc, sc), (lp, gp, sp) = res["cuda"], res["cpu"]
    # losses: f32 sums over 2 x 160 x 240 maps and the whole network in
    # another order (cuDNN vs the CPU's convolutions)
    for k in METRIC_KEYS:
        check(math.isfinite(lc[k]) and abs(lc[k] - lp[k]) <= 1e-4 * abs(lp[k]) + 1e-5,
              f"{k}: CUDA {lc[k]} vs CPU {lp[k]}")
    # gradients: each tensor within 3e-2 of its largest |g|, the median
    # tensor within 2e-3.  f32 through ~60 layers with cuDNN's and the CPU's
    # convolution algorithms and index_add's atomics; near the snapshot's
    # optimum a parameter's gradient is a sum of terms that cancel, so its
    # error relative to its own magnitude is larger than the terms' (every
    # kernel alone agrees with its plain version to ~1e-7 in phase 2)
    rel = {}
    for n, g in gp.items():
        rel[n] = float((gc[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
    ranked = sorted(rel.items(), key=lambda kv: -kv[1])
    worst_grad = ranked[0][1]
    print(f"  gradient max |diff| / max |g| per tensor: median "
          f"{statistics.median(rel.values()):.2e}, worst {ranked[:4]}")
    for n, r in ranked:
        check(r <= 3e-2, f"gradient of {n}: max |diff| {r:.3e} of max |g|")
    check(statistics.median(rel.values()) <= 2e-3, "median gradient error above 2e-3")
    # after one Adam step every parameter moved by lr * g / (|g| + eps):
    # exactly +-lr, unless |g| is so small that its sign is not resolved
    # between the two runs; BatchNorm running statistics within 1e-4
    worst_param, unresolved = 0.0, 0
    for n, p in sp.items():
        d = (sc[n] - p).abs()
        if n in gp:
            sure = gp[n].abs() > 10 * float((gc[n] - gp[n]).abs().max()) + 1e-12
            unresolved += int((~sure).sum())
            d_sure = float(d[sure].max()) if bool(sure.any()) else 0.0
            worst_param = max(worst_param, d_sure)
            check(d_sure <= 1e-3 * TRAIN_LR + 1e-7,
                  f"{n} after one Adam step: max |diff| {d_sure}")
            check(bool((d <= 2 * TRAIN_LR + 1e-7).all()), f"{n} after one Adam step")
        else:
            check(bool((d <= 1e-4 * (1 + p.abs())).all()), f"buffer {n} differs")
    print(f"  losses agree; gradients within {worst_grad:.2e} of each tensor's max |g| "
          f"({len(gp)} tensors); params after one Adam step within {worst_param:.3e} "
          f"({unresolved} elements with |g| below the runs' difference, within 2 lr)")
    return {"max_grad_rel_err": worst_grad,
            "median_grad_rel_err": statistics.median(rel.values()),
            "max_param_err": worst_param,
            "losses_cuda": lc, "losses_cpu": lp}


def phase_train(images, targets):
    """Full-width training: a main path for the counts."""
    from fots_torch.checkpoint import load_detector
    from fots_torch.kernels import build
    from fots_torch.train import METRIC_KEYS, Trainer, asset_batch

    batch = asset_batch(images, targets, [i % 4 for i in range(TRAIN_BATCH)])
    print(f"phase 7: training, f32, batch {TRAIN_BATCH} at {TRAIN_HW}, {TRAIN_STEPS} "
          f"steps on one repeated batch, warm start from the snapshot, lr {TRAIN_LR}")
    model, _, _ = load_detector(SNAPSHOT, "cuda")
    trainer = Trainer(model, learning_rate=TRAIN_LR, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    trainer.train([batch] * 2, max_steps=2, log_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train([batch] * (TRAIN_STEPS - 2), max_steps=TRAIN_STEPS,
                  log_every=0)  # max_steps bounds the global step
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {**build.launch_counts, **build.route_counts}
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    check(len(hist) == TRAIN_STEPS, f"{len(hist)} steps recorded, expected {TRAIN_STEPS}")
    for i, h in enumerate(hist):
        check(all(math.isfinite(h[k]) for k in METRIC_KEYS), f"step {i + 1}: {h}")
    for name in build.PATH_KERNELS["training"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the training path")
    first, after10 = hist[0]["loss"], hist[10]["loss"]
    print(f"  losses {[round(h['loss'], 5) for h in hist]}")
    check(after10 < first, f"loss after 10 updates {after10} not below the first {first}")
    ips = (TRAIN_STEPS - 2) * TRAIN_BATCH / elapsed
    out = {"images_per_s": ips, "steps_timed": f"3..{TRAIN_STEPS}", "batch": TRAIN_BATCH,
           "hw": list(batch.images.shape[1:3]), "dtype": "f32", "tf32": "PyTorch defaults",
           "peak_memory_bytes": peak, "first_losses": hist[0], "last_losses": hist[-1],
           "loss_after_10_updates": after10}
    print(f"  launches {launches} over {TRAIN_STEPS} steps; {ips:.2f} images/s over steps "
          f"3..{TRAIN_STEPS}; peak memory {peak / 2 ** 30:.2f} GiB")
    return launches, out


# --------------------------------------------------------------------------
# phase 7: training from scratch through the CLI
# --------------------------------------------------------------------------

def _smoke_list(tmp):
    """A list file of the smoke scenes' paths under data/synth."""
    with np.load(SMOKE_IMAGES) as z:
        names = [str(n) for n in z["names"]]
    path = os.path.join(tmp, "smoke_scenes.txt")
    with open(path, "w") as f:
        f.writelines(os.path.join(REPO, "data", "synth", n) + "\n" for n in names)
    return path, names


def _state_equal(trainer, payload):
    """Whether the trainer's weights, BatchNorm statistics and Adam state
    equal a checkpoint payload's bit for bit; returns (equal, tensors held)."""
    from fots_torch.checkpoint import checkpoint_payload

    got = checkpoint_payload(trainer.model, trainer.optimizer, trainer.global_step)
    same = set(got) == set(payload) and all(
        got[k].dtype == payload[k].dtype and np.array_equal(got[k], payload[k]) for k in got)
    return same, len(got)


def _stage_ms(makes, stages) -> dict:
    """Mean ms a batch of each reader stage (decode, augment, targets, the
    rest of ``make_s``) over batches with their ``make_s`` and their
    ``(decode_s, augment_s, targets_s)``."""
    ms = {k: 1e3 * statistics.mean(st[i] for st in stages)
          for i, k in enumerate(("decode", "augment", "targets"))}
    ms["make"] = 1e3 * statistics.mean(makes)
    ms["other"] = ms["make"] - ms["decode"] - ms["augment"] - ms["targets"]
    return ms


def _readers_in_window(trainer, lo: float, hi: float) -> dict:
    """The data pipeline while ``trainer`` ran its timed window (``lo``,
    ``hi``], perf_counter seconds between two dispatches: the main
    thread's wait for each batch it fetched inside the window, how many of
    those batches the readers had made before it, and their samples/s a
    reader over the batches made inside it (on the loaded host, queue waits
    excluded; ``None`` when none was made there) and over every batch the
    run fetched."""
    clock = time.time() - time.perf_counter()
    fetched = trainer.fetch_log[4:]  # batch k is fetched between dispatches k - 2 and k - 1
    made_in = [m for _, m, at in trainer.fetch_log if lo + clock < at <= hi + clock]
    per_reader = TRAIN_BATCH / statistics.mean(made_in) if made_in else None
    makes = [m for _, m, _ in trainer.fetch_log]
    return {"samples_per_s_per_reader_all_fetched": TRAIN_BATCH / statistics.mean(makes),
            "stage_ms_per_batch_all_fetched": _stage_ms(makes, trainer.stage_log),
            "main_thread_wait_ms": [round(1e3 * w, 3) for w, _, _ in fetched],
            "main_thread_wait_share": sum(w for w, _, _ in fetched) / (hi - lo),
            "fetched_in_window_made_before": sum(at <= lo + clock for _, _, at in fetched),
            "fetched_in_window": len(fetched), "made_in_window": len(made_in),
            "samples_per_s_per_reader_in_run": per_reader,
            "readers_samples_per_s_in_run": (None if per_reader is None
                                             else JOINT_READERS * per_reader)}


def phase_train_joint(targets):
    """Targets on the card's host, then ``fots_torch.cli.train_joint`` from
    scratch and resumed: a main path for the counts."""
    from fots_torch.checkpoint import read_checkpoint
    from fots_torch.cli import train_joint
    from fots_torch.data.detection import detection_generator
    from fots_torch.kernels import build

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build_dir, prefix="train_joint_")
    list_path, names = _smoke_list(tmp)

    # 1. the port's targets, native size, no augmentation: fots's asset byte for byte
    t0 = time.perf_counter()
    batch = next(detection_generator(list_path, SMOKE_IMAGES, input_size=-1,
                                     batch_size=len(names), seed=0, in_train=False,
                                     augment=False))
    target_s = time.perf_counter() - t0
    mine = {"score_maps": batch.score_maps, "training_masks": batch.training_masks,
            "geo_maps": batch.geo_maps, "gt_idxs": batch.gt_idxs,
            "gt_quads": np.stack([np.asarray(q, np.float32) for sc in batch.gt_quads
                                  for q in sc]).reshape(-1, 4, 2),
            "gt_labels": np.asarray([t for sc in batch.labels for t in sc]),
            "gt_counts": np.asarray([len(sc) for sc in batch.gt_quads], np.int64)}
    for k, v in mine.items():
        want = targets[k]
        check(v.dtype == want.dtype and v.shape == want.shape and np.array_equal(v, want),
              f"train_joint: the port's {k} differ from fots's train_targets.npz")
    print(f"phase 8: targets of {len(names)} scenes {batch.images.shape[1:3]} equal fots's "
          f"asset byte for byte ({', '.join(mine)}; {target_s:.2f} s on the host)")

    # 2. from scratch through the CLI
    save = os.path.join(tmp, "run")
    common = ["-train_list", list_path, "-images_npz", SMOKE_IMAGES, "-save_path", save,
              "-batch_size", str(TRAIN_BATCH), "-input_size", str(JOINT_SIZE),
              "-checkpoint_every", str(JOINT_CKPT_EVERY), "-seed", "0",
              "-num_readers", str(JOINT_READERS), "-disp_interval", "1"]
    print(f"  train_joint from scratch: batch {TRAIN_BATCH} at {JOINT_SIZE}x{JOINT_SIZE}, "
          f"augmented, {JOINT_STEPS} steps, lr 1e-3, {JOINT_READERS} readers")
    args, trainer = train_joint.build(common + ["-max_iters", str(JOINT_STEPS)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    train_joint.run(args, trainer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**build.launch_counts, **build.route_counts}
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    check([h["step"] for h in hist] == list(range(JOINT_STEPS)),
          f"train_joint: steps {[h['step'] for h in hist]}")
    for h in hist:
        check(all(math.isfinite(h[k]) for k in ("loss", "segm_loss", "angle_loss",
                                                 "iou_loss", "ctc_loss")),
              f"train_joint step {h['step']}: {h}")
    for name in build.PATH_KERNELS["training"]:
        check(launches[name] > 0, f"kernel {name} was not launched by train_joint")
    check(trainer.dropped_samples == 0,
          f"train_joint: {trainer.dropped_samples} samples dropped on an exception")
    for step in (JOINT_CKPT_EVERY, JOINT_STEPS):
        check(os.path.isdir(os.path.join(save, f"step_{step}")), f"no step_{step} written")
    first = statistics.mean(h["loss"] for h in hist[:5])
    last = statistics.mean(h["loss"] for h in hist[-5:])
    print(f"  losses {[round(h['loss'], 4) for h in hist]}")
    check(last < first, f"train_joint: mean loss of steps 16-20 {last} not below steps 1-5 "
          f"{first}")
    stamps = trainer.dispatch_times
    ips = (len(stamps) - 3) * TRAIN_BATCH / (stamps[-1] - stamps[2])
    readers = _readers_in_window(trainer, stamps[2], stamps[-1])

    # 3. resume from step_10 to JOINT_RESUME_TO
    ckpt = os.path.join(save, f"step_{JOINT_CKPT_EVERY}")
    args2, trainer2 = train_joint.build(common + ["-max_iters", str(JOINT_RESUME_TO),
                                                  "-model", ckpt])
    same, n_held = _state_equal(trainer2, read_checkpoint(ckpt))
    check(same, f"train_joint: the state restored from {ckpt} differs from the checkpoint")
    check(trainer2.global_step == JOINT_CKPT_EVERY, f"resumed at {trainer2.global_step}")
    train_joint.run(args2, trainer2)
    steps2 = [h["step"] for h in trainer2.history]
    check(steps2 == list(range(JOINT_CKPT_EVERY, JOINT_RESUME_TO)),
          f"train_joint resumed: steps {steps2}")
    check(os.path.isdir(os.path.join(save, f"step_{JOINT_RESUME_TO}")),
          f"no step_{JOINT_RESUME_TO} written on resume")
    check(trainer2.dropped_samples == 0, "train_joint resumed: samples dropped")
    out = {"images_per_s": ips, "steps_timed": f"3..{JOINT_STEPS}", "batch": TRAIN_BATCH,
           "hw": [JOINT_SIZE, JOINT_SIZE], "dtype": "f32", "tf32": "PyTorch defaults",
           "readers": JOINT_READERS, **readers,
           "peak_memory_bytes": peak, "wall_s": wall,
           "mean_loss_steps_1_5": first, "mean_loss_steps_16_20": last,
           "losses": [h["loss"] for h in hist], "dropped_samples": trainer.dropped_samples,
           "resume": {"restored_tensors_bit_equal": n_held, "steps": steps2,
                      "losses": [h["loss"] for h in trainer2.history]},
           "targets_equal_fots_asset": True}
    print(f"  launches {launches} over {JOINT_STEPS} steps; {ips:.2f} images/s over steps "
          f"3..{JOINT_STEPS}; readers {readers}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; mean loss steps 1-5 {first:.4f}, 16-20 {last:.4f}; "
          f"resumed at step {JOINT_CKPT_EVERY} with {n_held} tensors bit-equal, steps {steps2}")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, out


# --------------------------------------------------------------------------
# phase 8: K5's own path; phase 9: the evaluation path
# --------------------------------------------------------------------------

def phase_fused_block():
    """K5's entry point at the full shape: a main path for the counts."""
    from fots_torch.kernels import build
    from fots_torch.profiling import profile_fused_block

    print(f"phase 9: fots_torch.profiling --path fused_block at {FUSED_SHAPE} bf16")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    out = profile_fused_block(FUSED_SHAPE, iters=10)
    torch.cuda.synchronize()
    launches = {**build.launch_counts, **build.route_counts}
    for name in build.PATH_KERNELS["fused_block"]:
        check(launches[name] > 0, f"kernel {name} was not launched by its profiling entry")
    check(out["max_abs_err"] <= 0.1, f"K5' differs from its plain version by "
          f"{out['max_abs_err']} at the profile shape")
    for name in ("composition", "library", "cuda_fused"):
        check(math.isfinite(out[name]["ms_per_iter"]) and out[name]["ms_per_iter"] > 0,
              f"{name}: no time")
    print(f"  launches {launches['fused_block']} (the check, a warm-up and 5 timed programs of "
          f"10 chained iterations, 5 profiled calls); "
          f"composition {out['composition']['ms_per_iter']:.4f} ms, library "
          f"{out['library']['ms_per_iter']:.4f} ms, K5' {out['cuda_fused']['ms_per_iter']:.4f} "
          f"ms per iteration; fused_speedup {out['fused_speedup']:.3f}; K5' device ms per "
          f"call by kernel {out['cuda_fused']['kernels_ms_per_call']}")
    return launches, out


def _match_dumps(got, want, max_px=2.0):
    """Pair the detections of two per-image dumps by box (every corner within
    ``max_px``).  Returns (pairs with the same text, pairs whose texts differ,
    detections only one side has)."""
    same = differ = alone = 0
    for g_img, w_img in zip(got, want):
        left = list(w_img["detections"])
        for g in g_img["detections"]:
            gb = np.asarray(g["box"])
            hit = next((w for w in left
                        if np.abs(np.asarray(w["box"]) - gb).max() <= max_px), None)
            if hit is None:
                alone += 1
                continue
            left.remove(hit)
            if hit["text"] == g["text"]:
                same += 1
            else:
                differ += 1
        alone += len(left)
    return same, differ, alone


def phase_eval():
    """The evaluation CLI over the held-out scenes, against the JAX package's
    stored result on the same pixels: a main path for the counts."""
    from fots_torch.cli.detect import load_engine
    from fots_torch.cli.eval_e2e import evaluate, load_images_npz
    from fots_torch.kernels import build

    with open(EVAL_REFERENCE) as f:
        reference = json.load(f)["runs"]
    data = load_images_npz(EVAL_IMAGES)
    n_images = len(data[0])
    print(f"phase 10: eval_e2e over {n_images} held-out scenes {data[0].shape[1:3]}, the "
          "shipped snapshot, against fots (f32, CPU) on the same pixels")
    runs = (("per_image", "per_image", {}, {}, False),
            ("serve_704x1280", "serve_704x1280", {}, {"serve_hw": SERVE_HW}, False),
            ("beam8", "beam8", {"beam": 8}, {}, False),
            ("split_words", "split_words", {}, {"split_words": True}, False),
            ("per_image_bf16", "per_image", {}, {}, True))
    out, launches = {}, None
    for name, ref_name, engine_kw, eval_kw, bf16 in runs:
        ref = reference[ref_name]
        with no_tf32(), load_engine(SNAPSHOT, mixed_precision=bf16, device="cuda",
                                    **engine_kw) as engine:
            # warm-up, not counted: cuDNN's algorithm search at this run's shapes
            evaluate(engine, *(d[:1] for d in data), log_every=0, **eval_kw)
            torch.cuda.synchronize()
            if launches is None:  # the CLI's default flags: the path that is counted
                build.reset_launch_counts()
            summary, m, dump, seconds = evaluate(engine, *data, log_every=0, **eval_kw)
            torch.cuda.synchronize()
            if launches is None:
                launches = {**build.launch_counts, **build.route_counts}
        counts = {"tp": m.tp_all, "tp_e2e": m.tp_e2e_all, "tp_e2e_ed1": m.tp_e2e_ed1_all,
                  "detections": m.detections_all, "gt": m.gt_all}
        same, differ, alone = _match_dumps(dump, ref["images"])
        out[name] = {"counts": counts, "fots_counts": ref["counts"],
                     "detection_hmean": summary["detection_hmean"],
                     "e2e_hmean": summary["e2e_hmean"],
                     "fots_detection_hmean": ref["summary"]["detection_hmean"],
                     "fots_e2e_hmean": ref["summary"]["e2e_hmean"],
                     "detections_with_same_text": same, "with_other_text": differ,
                     "only_one_side": alone, "images_per_s": n_images / seconds,
                     "dtype": "bf16" if bf16 else "f32 (TF32 off)", "held": not bf16}
        print(f"  {name}: port {counts} det hmean {summary['detection_hmean']:.4f} e2e hmean "
              f"{summary['e2e_hmean']:.4f}; fots {ref['counts']} det "
              f"{ref['summary']['detection_hmean']:.4f} e2e {ref['summary']['e2e_hmean']:.4f}; "
              f"paired detections: {same} same text, {differ} other text, {alone} unpaired; "
              f"{n_images / seconds:.2f} images/s{'' if not bf16 else '  (reported, not held)'}")
        for k in ("detection_hmean", "e2e_hmean"):
            check(math.isfinite(summary[k]) and 0.0 < summary[k] <= 1.0, f"{name}: {k}")
        if bf16:
            continue
        check(counts["gt"] == ref["counts"]["gt"], f"{name}: ground-truth counts differ")
        for k in ("tp", "tp_e2e", "detections"):
            check(abs(counts[k] - ref["counts"][k]) <= 1,
                  f"{name}: {k} {counts[k]} vs fots {ref['counts'][k]}")
        check(differ <= 2 and alone <= 2,
              f"{name}: {differ} paired detections read differently, {alone} unpaired")
    for kname in build.PATH_KERNELS["evaluation"]:
        check(launches[kname] > 0, f"kernel {kname} was not launched on the evaluation path")
    print(f"  launches {launches} over {n_images} images (per-image path, f32)")
    return launches, {"scenes": n_images, "runs": out}


# --------------------------------------------------------------------------
# phase 11: the recognition-only stack
# --------------------------------------------------------------------------

def ocr_bucket_shapes():
    """(batch, width) of the narrowest and the widest batch ``eval_ocr``
    makes of the archive's eval crops (batch 4 a bucket, ``OCR_HEIGHT``)."""
    from fots_torch.data.ocr_crops import ocr_crop_generator

    shapes = sorted({(b["images"].shape[2], b["images"].shape[0]) for b in ocr_crop_generator(
        OCR_CROPS, batch_size=4, norm_height=OCR_HEIGHT, in_train=False, split="eval")})
    return [(n, w) for w, n in (shapes[0], shapes[-1])]


def _ocr_step_parity(name, make, run_loss):
    """One step of a recognition trainer, CUDA against CPU (f32, TF32 off):
    ``make(device)`` builds the trainer, ``run_loss(trainer)`` its loss.
    The loss within 1e-4 relative; gradients, parameters after Adam and
    BatchNorm statistics to phase 6's limits."""
    res = {}
    with no_tf32():
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            trainer = make(device)
            loss = run_loss(trainer)
            trainer.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in trainer.model.named_parameters() if p.grad is not None}
            trainer.optimizer.step()
            res[device] = (float(loss.detach()), grads,
                           {n: t.detach().cpu().clone()
                            for n, t in trainer.model.state_dict().items()},
                           time.perf_counter() - t0)
            del trainer, loss
    (lc, gc, sc, tc), (lp, gp, sp, tp) = res["cuda"], res["cpu"]
    check(math.isfinite(lc) and abs(lc - lp) <= 1e-4 * abs(lp),
          f"{name}: loss CUDA {lc} vs CPU {lp}")
    check(set(gc) == set(gp) and gp, f"{name}: the two runs' gradients cover other tensors")
    # a bias in front of a train-mode BatchNorm has a true gradient of 0: both
    # runs' are rounding noise, held only as small (below 1e-4 of the largest)
    top = max(float(g.abs().max()) for g in gp.values())
    zero = sorted(n for n, g in gp.items() if float(g.abs().max()) < 1e-4 * top)
    for n in zero:
        check(float(gc[n].abs().max()) < 1e-4 * top, f"{name}: gradient of {n} not ~0 on the card")
    rel = {n: float((gc[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for n, g in gp.items() if n not in zero}
    ranked = sorted(rel.items(), key=lambda kv: -kv[1])
    for n, r in ranked:
        check(r <= 3e-2, f"{name}: gradient of {n}: max |diff| {r:.3e} of max |g|")
    median = statistics.median(rel.values())
    check(median <= 2e-3, f"{name}: median gradient error {median:.3e} above 2e-3")
    lr = 1e-4
    worst_param = 0.0
    for n, p in sp.items():
        d = (sc[n] - p).abs()
        if n in gp:
            sure = (gp[n].abs() > 10 * float((gc[n] - gp[n]).abs().max()) + 1e-12
                    if n not in zero else torch.zeros_like(gp[n], dtype=torch.bool))
            d_sure = float(d[sure].max()) if bool(sure.any()) else 0.0
            worst_param = max(worst_param, d_sure)
            check(d_sure <= 1e-3 * lr + 1e-7, f"{name}: {n} after one Adam step: {d_sure}")
            check(bool((d <= 2 * lr + 1e-7).all()), f"{name}: {n} after one Adam step")
        else:
            check(bool((d <= 1e-4 * (1 + p.abs())).all()), f"{name}: buffer {n} differs")
    print(f"  {name}: loss CUDA {lc:.6f} CPU {lp:.6f}; gradients ({len(rel)} tensors, "
          f"{len(zero)} ~0: {zero}) median "
          f"{median:.2e}, worst {ranked[:2]}; params after Adam within {worst_param:.3e} "
          f"({tc:.2f} s on the card, {tp:.2f} s on the host)")
    return {"loss_cuda": lc, "loss_cpu": lp, "max_grad_rel_err": ranked[0][1],
            "median_grad_rel_err": median, "max_param_err": worst_param}


def _trainer_profile(trainer, batch, steps: int = 5) -> dict:
    """Device busy ms and idle share a step over ``steps`` steps of one
    batch (torch.profiler), after a warm-up step."""
    from fots_torch.profiling import profile_window

    trainer.step(batch)
    out = profile_window(lambda: [trainer.step(batch) for _ in range(steps)], steps)
    return {k: out[k] for k in ("wall_ms_per_batch", "device_busy_ms_per_batch",
                                "device_idle_share", "kernel_launches_per_batch")}


def _samples_per_s(trainer) -> float:
    """Samples a second over a run's steps 3.. (host clock after each step)."""
    h = trainer.history[2:]
    return sum(x["samples"] for x in h[1:]) / (h[-1]["t"] - h[0]["t"])


def _step_ms_by_shape(trainer) -> dict:
    """Host ms of each step after the first (clock after the step before to
    clock after it), split by whether the step's input shape was new to the
    run (first use: cuDNN and PyTorch set the shape up) or seen before."""
    h, seen = trainer.history, {tuple(trainer.history[0]["shape"])}
    new, again = [], []
    for prev, cur in zip(h, h[1:]):
        ms = 1e3 * (cur["t"] - prev["t"])
        (again if tuple(cur["shape"]) in seen else new).append(ms)
        seen.add(tuple(cur["shape"]))
    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    return {"new_shape_steps": len(new), "median_ms_new_shape": med(new),
            "seen_shape_steps": len(again), "median_ms_seen_shape": med(again)}


def phase_ocr(images, targets):
    """The recognition-only stack: each trainer's step CUDA against CPU, then
    (the path that is counted) ``train_crnn``, ``train_ocr``,
    ``train_crnn_e2e`` and ``eval_ocr`` through their CLIs."""
    from fots_torch.checkpoint import load_detector, read_checkpoint, restore_checkpoint
    from fots_torch.cli import eval_ocr, train_crnn, train_crnn_e2e, train_ocr
    from fots_torch.data.detection import detection_generator
    from fots_torch.data.ocr_crops import ocr_crop_generator
    from fots_torch.kernels import build
    from fots_torch.train import asset_batch
    from fots_torch.train_ocr import (CRNNE2ETrainer, CRNNTrainer, FOTSRecognizerTrainer,
                                      train_loop)

    t_phase = time.perf_counter()
    with open(OCR_REFERENCE) as f:
        reference = json.load(f)["runs"]
    torch.set_num_threads(os.cpu_count() or 1)
    print("phase 11: the recognition-only stack; one step of each trainer, CUDA port vs "
          "CPU port (f32, TF32 off)")
    crnn_batch = next(ocr_crop_generator(OCR_CROPS, batch_size=OCR_BATCH, norm_height=32,
                                         seed=0, split="train"))
    fots_batch = next(ocr_crop_generator(OCR_CROPS, batch_size=OCR_BATCH,
                                         norm_height=OCR_HEIGHT, seed=0, split="train"))
    scenes = asset_batch(images, targets, [0, 1])
    parity = {
        "crnn": _ocr_step_parity(
            f"CRNNTrainer {crnn_batch['images'].shape}",
            lambda d: CRNNTrainer(seed=0, device=d), lambda t: t.loss(crnn_batch)),
        "fots_recognizer": _ocr_step_parity(
            f"FOTSRecognizerTrainer from the snapshot {fots_batch['images'].shape}",
            lambda d: FOTSRecognizerTrainer(model=load_detector(SNAPSHOT, d)[0], seed=0,
                                            device=d),
            lambda t: t.loss(fots_batch)),
        "crnn_e2e": _ocr_step_parity(
            f"CRNNE2ETrainer on 2 scenes {scenes.images.shape[1:3]}",
            lambda d: CRNNE2ETrainer(seed=0, device=d),
            lambda t: t.loss(scenes, np.random.default_rng(0))[0]),
    }

    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build_dir, prefix="ocr_")
    list_path, _ = _smoke_list(tmp)
    crnn_dir, ocr_dir = os.path.join(tmp, "crnn"), os.path.join(tmp, "ocr")
    common = ["-crops_npz", OCR_CROPS, "-batch_size", str(OCR_BATCH), "-seed", "0",
              "-num_readers", "2", "-disp_interval", "5"]
    print(f"  train_crnn from scratch: batch {OCR_BATCH} (halving every 10 buckets), "
          f"{CRNN_STEPS} steps, checkpoint every {CRNN_CKPT_EVERY}; train_ocr {OCR_STEPS} "
          f"steps; train_crnn_e2e {E2E_STEPS} steps at {E2E_SIZE}; eval_ocr -arch fots "
          "greedy and beam 8")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    crnn = train_crnn.main(common + ["-max_iters", str(CRNN_STEPS), "-save_path", crnn_dir,
                                     "-checkpoint_every", str(CRNN_CKPT_EVERY)])
    t1 = time.perf_counter()
    recognizer = train_ocr.main(common + ["-max_iters", str(OCR_STEPS), "-save_path", ocr_dir,
                                          "-checkpoint_every", str(OCR_STEPS)])
    t2 = time.perf_counter()
    e2e = train_crnn_e2e.main(["-train_list", list_path, "-images_npz", SMOKE_IMAGES,
                               "-input_size", str(E2E_SIZE), "-batch_size", "2",
                               "-max_iters", str(E2E_STEPS), "-num_readers", "2",
                               "-disp_interval", "5", "-eval_interval", str(E2E_STEPS - 1)])
    t3 = time.perf_counter()
    evals = {run: eval_ocr.main(["-crops_npz", OCR_CROPS, "-model", SNAPSHOT, "-beam",
                                 str(ref["beam"]), "-worst", "0"])
             for run, ref in reference.items()}
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {**build.launch_counts, **build.route_counts}
    for kname in build.PATH_KERNELS["ocr"]:
        check(launches[kname] > 0, f"kernel {kname} was not launched on the ocr path")

    losses = [h["loss"] for h in crnn.history]
    check(len(losses) == CRNN_STEPS and all(math.isfinite(v) for v in losses),
          f"train_crnn: losses {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"  train_crnn losses {[round(v, 3) for v in losses]}")
    check(last < first, f"train_crnn: mean loss of the last 5 steps {last} not below the "
          f"first 5 {first}")
    stats = {name: {"samples_per_s": _samples_per_s(tr), "step_ms": _step_ms_by_shape(tr)}
             for name, tr in (("train_crnn", crnn), ("train_ocr", recognizer),
                              ("train_crnn_e2e", e2e))}
    # resume: the state of step_20 (saved after step i = 20, 21 updates)
    # restored bit for bit, then two more steps (the CLI's -model path, on
    # the batches at hand): the history goes on from update 21
    ckpt = os.path.join(crnn_dir, f"step_{CRNN_CKPT_EVERY}")
    resumed = CRNNTrainer(device="cuda")
    restore_checkpoint(ckpt, resumed)
    same, n_held = _state_equal(resumed, read_checkpoint(ckpt))
    check(same and resumed.global_step == CRNN_CKPT_EVERY + 1,
          f"train_crnn: the state restored from {ckpt} differs from the checkpoint")
    train_loop(resumed, [crnn_batch] * 2, 2, disp_interval=0)
    check([h["step"] for h in resumed.history] == [CRNN_CKPT_EVERY + 1, CRNN_CKPT_EVERY + 2],
          f"train_crnn resumed: steps {[h['step'] for h in resumed.history]}")
    for name, tr in (("train_ocr", recognizer), ("train_crnn_e2e", e2e)):
        vals = [h["loss"] for h in tr.history]
        check(vals and all(math.isfinite(v) for v in vals), f"{name}: losses {vals}")
    check(len(e2e.history) == E2E_STEPS, f"train_crnn_e2e ran {len(e2e.history)} steps")

    eval_out = {}
    for run, (metrics, crops) in evals.items():
        ref = reference[run]
        same_text = sum(c["pred"] == r["pred"] for c, r in zip(crops, ref["crops"]))
        eval_out[run] = {"correct": metrics.correct, "fots_correct": ref["correct"],
                         "total": metrics.total, "summary": metrics.summary(),
                         "same_prediction_as_fots": same_text}
        print(f"  eval_ocr {run}: {metrics.correct}/{metrics.total} exact, fots "
              f"{ref['correct']}/{ref['summary']['total']}; {same_text} crops read as fots "
              "reads them")
        check(metrics.total == ref["summary"]["total"], f"eval_ocr {run}: crop counts differ")
        check(abs(metrics.correct - ref["correct"]) <= 1,
              f"eval_ocr {run}: {metrics.correct} exact vs fots {ref['correct']}")

    # reported, not held: device time and idle share a step of each trainer
    e2e_batch = next(detection_generator(list_path, SMOKE_IMAGES, input_size=E2E_SIZE,
                                         batch_size=2, seed=0))
    profiles = {"crnn": _trainer_profile(crnn, crnn_batch),
                "fots_recognizer": _trainer_profile(recognizer, fots_batch),
                "crnn_e2e": _trainer_profile(e2e, e2e_batch)}
    out = {"parity": parity, "launches": launches,
           "train_crnn": {"losses": losses, "mean_loss_first_5": first,
                          "mean_loss_last_5": last, "wall_s": t1 - t0, **stats["train_crnn"],
                          "resume": {"restored_tensors_bit_equal": n_held,
                                     "steps": [h["step"] for h in resumed.history]}},
           "train_ocr": {"losses": [h["loss"] for h in recognizer.history], "wall_s": t2 - t1,
                         **stats["train_ocr"]},
           "train_crnn_e2e": {"losses": [h["loss"] for h in e2e.history], "wall_s": t3 - t2,
                              **stats["train_crnn_e2e"]},
           "eval_ocr": {**eval_out, "wall_s": t4 - t3},
           "profile_per_step": profiles, "phase_wall_s": time.perf_counter() - t_phase}
    for name, prof in profiles.items():
        print(f"  {name} a step: {prof}")
    for name, unit in (("train_crnn", "crops"), ("train_ocr", "crops"),
                       ("train_crnn_e2e", "rois")):
        print(f"  {name}: {out[name]['samples_per_s']:.2f} {unit}/s over steps 3.., host ms a "
              f"step {out[name]['step_ms']}, CLI wall {out[name]['wall_s']:.2f} s")
    print(f"  launches {launches}; mean loss first 5 {first:.4f}, last 5 {last:.4f}; resumed "
          f"at step {CRNN_CKPT_EVERY} with {n_held} tensors bit-equal; phase "
          f"{out['phase_wall_s']:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, out


# --------------------------------------------------------------------------
# phase 12: the entry points from image files and reference weights
# --------------------------------------------------------------------------

def _cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``), its
    architecture and the cores this process may use."""
    import platform

    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not name and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        name = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                     if line.lower().startswith("model name")), None)
    return f"{name or 'model not reported'} ({platform.machine()}, " \
           f"{len(os.sched_getaffinity(0))} cores)"


def _captured(fn, *args):
    """(``fn(*args)``, what it printed), echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue()


def _rows_close(got, want, what):
    check(len(got) == len(want), f"{what}: {len(got)} rows vs {len(want)}")
    for g, w in zip(got, want):
        g, w = g.split(",", 9), w.split(",", 9)
        check(g[9] == w[9], f"{what}: text {g[9]!r} vs {w[9]!r}")
        check(max(abs(float(a) - float(b)) for a, b in zip(g[:9], w[:9])) <= 1e-3,
              f"{what}: row {g} vs {w}")


def _dump_counts(dump) -> dict:
    """Match / detection / ground-truth totals of an ``eval_e2e -dump_json``
    dump, through the port's ``E2EMetrics``."""
    from fots_torch.evaluate import E2EMetrics

    m = E2EMetrics()
    for rec in dump:
        dets = [(np.asarray(d["box"]), d["text"]) for d in rec["detections"]]
        m.add_image(dets, np.asarray([g["box"] for g in rec["gt"]]).reshape(-1, 8),
                    [g["text"] for g in rec["gt"]])
    return {"tp": m.tp_all, "tp_e2e": m.tp_e2e_all, "tp_e2e_ed1": m.tp_e2e_ed1_all,
            "detections": m.detections_all, "gt": m.gt_all}


def phase_files(images, eval_result=None, joint_result=None):
    """The CLIs over image files and the reference's weights (``-h5``), with
    the port's own decoder: a main path for the counts."""
    from fots_torch.checkpoint import load_detector, reference_state_dict
    from fots_torch.cli import detect, eval_e2e, eval_ocr, serve, train_joint
    from fots_torch.cli import export as export_cli
    from fots_torch.cli.detect import load_engine
    from fots_torch.data.detection import detection_generator
    from fots_torch.imageio import imread
    from fots_torch.kernels import build
    from fots_torch.profiling import card_name_and_power_limit

    t_phase = time.perf_counter()
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build_dir, prefix="files_")
    list_path, names = _smoke_list(tmp)
    smoke_files = [os.path.join(REPO, "data", "synth", n) for n in names]

    # (a) the decoder against both decoded assets, byte for byte
    for path, want in zip(smoke_files, images):
        got = imread(path)
        check(got is not None and got.shape == want.shape and np.array_equal(got, want),
              f"files: {path} decodes differently from smoke_images_u8.npz")
    with np.load(EVAL_IMAGES) as z:
        held, held_names = z["images"], [os.path.basename(str(n)) for n in z["names"]]
    for name, want in zip(held_names, held):
        got = imread(os.path.join(FILES_JPG, name))
        check(got is not None and np.array_equal(got, want),
              f"files: {name} decodes differently from heldout_eval_u8.npz")
    times = []
    for _ in range(DECODE_REPEATS):
        t0 = time.perf_counter()
        imread(smoke_files[0])
        times.append(1e3 * (time.perf_counter() - t0))
    decode_ms = statistics.median(times)
    cpu = _cpu_model()
    print(f"phase 12: {len(smoke_files)} smoke scenes and {len(held)} held-out scenes decode "
          f"byte-equal to their assets; a 640x960 4:2:0 scene in {decode_ms:.3f} ms (median "
          f"of {DECODE_REPEATS}, {min(times):.3f}-{max(times):.3f}) on {cpu}")
    # every file cv2 read for fots_torch/assets/decode_ref/manifest.json, to its hashes
    with open(os.path.join(DECODE_REF, "manifest.json")) as f:
        manifest = json.load(f)
    for rel, entry in manifest.items():
        for key in ("colour", "grey"):
            got = imread(os.path.join(DECODE_REF, rel), grayscale=key == "grey")
            if entry[key] is None:  # cv2 reads nothing (a lossless frame's other colour space)
                check(got is None, f"files: {rel} ({key}) decodes where cv2.imread gives None")
                continue
            check(got is not None and list(got.shape) == entry[key]["shape"]
                  and hashlib.sha256(got.tobytes()).hexdigest() == entry[key]["sha256"],
                  f"files: {rel} ({key}) decodes differently from cv2.imread's bytes")
    bmp = os.path.join(tmp, "not_a_jpeg.jpg")
    with open(bmp, "wb") as f:
        f.write(b"BM" + bytes(60))
    try:
        imread(bmp)
        check(False, "files: a BMP read as something")
    except ValueError as e:
        check("BMP" in str(e) and bmp in str(e), f"files: the BMP refusal says {e}")
    # the same 640x960 scene in five forms, timed in turns: sequential and
    # progressive (quality 95, 4:2:0), block-smoothed (the progressive file
    # cut in its second scan), CMYK (quality 50) and arithmetic-coded
    decode_forms = {"sequential": os.path.join(FILES_JPG, "img_112.jpg"),
                    "progressive": os.path.join(PROG_JPG, "img_112.jpg"),
                    "block_smoothed": os.path.join(DECODE_REF, "scene_smoothed.jpg"),
                    "cmyk": os.path.join(DECODE_REF, "scene_cmyk.jpg"),
                    "arithmetic": os.path.join(DECODE_REF, "scene_arith.jpg")}
    forms = list(decode_forms)
    pair_times = {k: [] for k in decode_forms}
    for i in range(DECODE_REPEATS):
        for k in forms[i % len(forms):] + forms[:i % len(forms)]:
            t0 = time.perf_counter()
            imread(decode_forms[k])
            pair_times[k].append(1e3 * (time.perf_counter() - t0))
    pair_ms = {k: statistics.median(v) for k, v in pair_times.items()}
    smi = card_name_and_power_limit()
    print(f"  {len(manifest)} files of decode_ref decode to cv2.imread's hashes, colour and "
          f"grey; a BMP is refused by name; img_112 640x960 decode ms on {cpu} (card {smi}), "
          f"medians of {DECODE_REPEATS} in turns: " + ", ".join(
              f"{k} {pair_ms[k]:.3f} ({min(v):.3f}-{max(v):.3f})"
              for k, v in pair_times.items()))
    folder = os.path.join(tmp, "scenes")
    os.makedirs(folder)
    for p in smoke_files:
        shutil.copy(p, folder)
    with open(EVAL_REFERENCE) as f:
        eval_ref = json.load(f)["runs"]["per_image"]
    with open(OCR_REFERENCE) as f:
        ocr_ref = json.load(f)["runs"]
    h5_path = os.path.join(tmp, "snapshot.h5")
    torch.save({"state_dict": reference_state_dict(load_detector(SNAPSHOT, "cpu")[0])}, h5_path)

    # reader 0's first batches from the jpg files and from the archive, made in
    # turn in this process: byte-equal, and timed by stage
    gen_kw = dict(input_size=JOINT_SIZE, batch_size=TRAIN_BATCH, seed=0)
    gens = {"files": detection_generator(list_path, None, **gen_kw),
            "archive": detection_generator(list_path, SMOKE_IMAGES, **gen_kw)}
    made = {k: [] for k in gens}
    for i in range(READER_BATCHES):
        for k in (("files", "archive") if i % 2 == 0 else ("archive", "files")):
            made[k].append(next(gens[k]))
        a, b = made["files"][-1], made["archive"][-1]
        for k in ("images", "score_maps", "geo_maps", "training_masks", "gt_idxs"):
            check(np.array_equal(getattr(a, k), getattr(b, k)),
                  f"train_joint: batch {i}'s {k} from files differ from the archive's")
        check(a.image_fns == b.image_fns, f"train_joint: batch {i}'s files")
    reader = {k: {"samples_per_s": TRAIN_BATCH / statistics.median(b.make_s for b in bs),
                  "decoded_per_batch": statistics.mean(b.decoded for b in bs),
                  "stage_ms_per_batch": _stage_ms(
                      [b.make_s for b in bs],
                      [(b.decode_s, b.augment_s, b.targets_s) for b in bs])}
              for k, bs in made.items()}
    print(f"  reader 0's first {READER_BATCHES} batches byte-equal from files and archive: "
          f"{reader}")
    with open(os.path.join(PROG_JPG, "eval.txt")) as f:
        prog_names = [line.strip() for line in f if line.strip()]
    prog_files = [os.path.join(PROG_JPG, n) for n in prog_names]
    prog_list = os.path.join(tmp, "prog_list.txt")
    with open(prog_list, "w") as f:
        f.writelines(p + "\n" for p in prog_files)
    prog_gen = detection_generator(prog_list, None, input_size=JOINT_SIZE,
                                   batch_size=len(prog_files), seed=0)
    prog_batches = [next(prog_gen) for _ in range(3)]
    check(all(b.dropped == 0 for b in prog_batches)
          and {os.path.basename(n) for b in prog_batches for n in b.image_fns} == set(prog_names),
          f"files: the detection reader dropped progressive files "
          f"{[(b.dropped, b.image_fns) for b in prog_batches]}")
    print(f"  a detection reader over {len(prog_files)} progressive jpgs: "
          f"{sum(len(b.image_fns) for b in prog_batches)} samples in 3 batches, none dropped")

    # the results the CLIs are held to, before the counted window
    with load_engine(SNAPSHOT, device="cuda") as engine:
        detect_want = {name: detect.result_rows(engine(im)[0])
                       for name, im in zip(names, images)}
        h5_want = engine.batch_call(list(images), serve_hw=SERVE_HW)
        prog_images = [imread(p) for p in prog_files]
        prog_detect_want = {n: detect.result_rows(engine(im)[0])
                            for n, im in zip(prog_names, prog_images)}
    with load_engine(SNAPSHOT, mixed_precision=True, device="cuda") as engine:
        serve_want = engine.batch_call(list(images), serve_hw=SERVE_HW)
        prog_serve_want = engine.batch_call(prog_images, serve_hw=SERVE_HW)
    with open(os.path.join(DECODE_REF, "eval_fots_cpu.json")) as f:
        prog_eval_ref = json.load(f)["run"]

    torch.cuda.synchronize()
    build.reset_launch_counts()
    t_path = time.perf_counter()
    # (b) held-out evaluation from the jpg files
    with no_tf32():
        summary = eval_e2e.main(["-model", SNAPSHOT, "-images_list",
                                 os.path.join(FILES_JPG, "eval.txt")])
    check(summary == eval_ref["summary"],
          f"files: eval_e2e -images_list {summary} differs from fots's {eval_ref['summary']}")
    if eval_result is not None:
        check(summary["e2e_hmean"] == eval_result["runs"]["per_image"]["e2e_hmean"]
              and summary["detection_hmean"]
              == eval_result["runs"]["per_image"]["detection_hmean"],
              "files: eval_e2e -images_list differs from phase 10's per-image run")
    t_eval = time.perf_counter()
    # (c) cli.detect over the folder against the engine on the asset pixels
    out_dir = os.path.join(tmp, "detect")
    rows = detect.main(["-model", SNAPSHOT, "-test_folder", folder, "-output", out_dir])
    t_detect = time.perf_counter()
    # (d) cli.serve over the folder against batch_call on the asset pixels
    serve_dir = os.path.join(tmp, "serve")
    served = serve.main(["-model", SNAPSHOT, "-test_folder", folder, "-output", serve_dir,
                         "-batch", str(len(names))])
    t_serve = time.perf_counter()
    # (d') the progressive copies of four held-out scenes through eval_e2e,
    # cli.detect and cli.serve at their defaults
    before = dict(build.launch_counts)
    prog_dump = os.path.join(tmp, "prog_dump.json")
    with no_tf32():
        prog_summary = eval_e2e.main(["-model", SNAPSHOT, "-images_list",
                                      os.path.join(PROG_JPG, "eval.txt"), "-dump_json",
                                      prog_dump])
    prog_detect_dir = os.path.join(tmp, "prog_detect")
    prog_rows = detect.main(["-model", SNAPSHOT, "-test_folder", PROG_JPG, "-output",
                             prog_detect_dir])
    prog_serve_dir = os.path.join(tmp, "prog_serve")
    prog_served = serve.main(["-model", SNAPSHOT, "-test_folder", PROG_JPG, "-output",
                              prog_serve_dir])
    torch.cuda.synchronize()
    prog_launches = {k: build.launch_counts[k] - before[k] for k in before}
    t_prog = time.perf_counter()
    # (e) the exported bundle's selftest on the folder
    _, printed = _captured(export_cli.main, ["-model", SNAPSHOT, "-out",
                                             os.path.join(tmp, "bundle"), "-batch",
                                             str(len(names)), "-platforms", "cuda",
                                             "-selftest", folder])
    check("selftest ok" in printed, "export -selftest <folder> did not pass")
    t_export = time.perf_counter()
    # (f) train_joint from the jpg files, 10 steps
    save = os.path.join(tmp, "run")
    args, trainer = train_joint.build(
        ["-train_list", list_path, "-save_path", save, "-batch_size", str(TRAIN_BATCH),
         "-input_size", str(JOINT_SIZE), "-checkpoint_every", str(FILES_STEPS), "-seed", "0",
         "-num_readers", str(JOINT_READERS), "-disp_interval", "5",
         "-max_iters", str(FILES_STEPS)])
    train_joint.run(args, trainer)
    t_train = time.perf_counter()
    # (g) eval_ocr over the PNG crops, greedy and beam 8
    ocr_runs = {run: eval_ocr.main(["-model", SNAPSHOT, "-train_list", OCR_PNG_LIST,
                                    "-beam", str(ref["beam"]), "-worst", "0"])
                for run, ref in ocr_ref.items()}
    t_ocr = time.perf_counter()
    # (h) -h5: the snapshot under the reference's keys serves as the snapshot does
    with load_engine(h5_path=h5_path, masked_norm=True, device="cuda") as h5_engine:
        h5_got = h5_engine.batch_call(list(images), serve_hw=SERVE_HW)
    (_, h5_trainer), printed = _captured(train_joint.build, [
        "-train_list", list_path, "-h5", h5_path, "-save_path", os.path.join(tmp, "warm")])
    del h5_trainer
    torch.cuda.synchronize()
    t_h5 = time.perf_counter()
    launches = {**build.launch_counts, **build.route_counts}

    for kname in build.PATH_KERNELS["training"]:
        check(launches[kname] > 0, f"kernel {kname} was not launched on the files path")
    for name in names:
        _rows_close(rows[name], detect_want[name], f"detect {name}")
        with open(os.path.join(out_dir, os.path.splitext(name)[0] + ".txt")) as f:
            check(f.read().split("\n") == rows[name], f"detect {name}: file rows")
    check(served == len(names), f"serve -test_folder served {served} images")
    for name, res in zip(names, serve_want):
        with open(os.path.join(serve_dir, os.path.splitext(name)[0] + ".json")) as f:
            got = json.load(f)
        check([g["text"] for g in got] == [r["text"] for r in res] and len(res) > 0,
              f"serve {name}: texts differ from batch_call's")
        check(all(np.allclose(g["box"], r["box"], rtol=0.0, atol=1e-3)
                  for g, r in zip(got, res)), f"serve {name}: boxes differ from batch_call's")
    for kname in build.PATH_KERNELS["serving"]:
        check(prog_launches[kname] > 0,
              f"kernel {kname} was not launched over the progressive files")
    with open(prog_dump) as f:
        prog_counts = _dump_counts(json.load(f))
    ref_counts = prog_eval_ref["counts"]
    check(prog_counts["gt"] == ref_counts["gt"]
          and all(abs(prog_counts[k] - ref_counts[k]) <= 1 for k in ("tp", "tp_e2e", "detections")),
          f"files: eval_e2e over the progressive jpgs {prog_counts} vs fots's {ref_counts}")
    check(sorted(prog_rows) == sorted(prog_names), f"detect over the progressive jpgs: "
          f"{sorted(prog_rows)}")
    for name in prog_names:
        _rows_close(prog_rows[name], prog_detect_want[name], f"detect progressive {name}")
    check(prog_served == len(prog_names), f"serve over the progressive jpgs: {prog_served}")
    for name, res in zip(prog_names, prog_serve_want):
        with open(os.path.join(prog_serve_dir, os.path.splitext(name)[0] + ".json")) as f:
            got = json.load(f)
        check([g["text"] for g in got] == [r["text"] for r in res] and len(res) > 0
              and all(np.allclose(g["box"], r["box"], rtol=0.0, atol=1e-3)
                      for g, r in zip(got, res)),
              f"serve progressive {name}: differs from batch_call on the decoded pixels")
    print(f"  progressive jpgs: eval_e2e {prog_counts} (fots {ref_counts}; det hmean "
          f"{prog_summary['detection_hmean']:.4f} e2e hmean {prog_summary['e2e_hmean']:.4f}); "
          f"detect and serve equal the engines on the decoded pixels; launches {prog_launches}")
    hist = trainer.history
    check([h["step"] for h in hist] == list(range(FILES_STEPS)),
          f"train_joint from files: steps {[h['step'] for h in hist]}")
    check(all(math.isfinite(h["loss"]) for h in hist), f"train_joint from files: {hist}")
    check(trainer.dropped_samples == 0, "train_joint from files: samples dropped")
    stamps = trainer.dispatch_times
    readers = _readers_in_window(trainer, stamps[2], stamps[-1])
    ocr_out = {}
    for run, ref in ocr_ref.items():
        metrics, crops = ocr_runs[run]
        same = sum(c["pred"] == r["pred"] for c, r in zip(crops, ref["crops"]))
        check(metrics.total == ref["summary"]["total"] and metrics.correct == ref["correct"]
              and same == len(ref["crops"]) == len(crops),
              f"eval_ocr {run} over PNG files: {metrics.correct}/{metrics.total}, {same} "
              f"crops as fots reads them")
        ocr_out[run] = {"correct": metrics.correct, "total": metrics.total,
                        "crops_as_fots": same}
    check([[r["text"] for r in g] for g in h5_got] == [[r["text"] for r in w] for w in h5_want],
          "-h5 engine's texts differ from the snapshot's")
    check(f"warm-started 173 tensors from {h5_path} (2 skipped)" in printed,
          "train_joint -h5: not the 173 imported / 2 skipped of the CPU test")

    archive_readers = {k: (joint_result or {}).get(k) for k in (
        "samples_per_s_per_reader_in_run", "samples_per_s_per_reader_all_fetched",
        "stage_ms_per_batch_all_fetched", "main_thread_wait_share")}
    out = {"decode_ms_640x960": decode_ms, "decode_ms_all": times, "host_cpu": cpu, "card": smi,
           "decode_ms_img_112": pair_ms, "decode_ms_img_112_all": pair_times,
           "decode_ref_files": len(manifest),
           "progressive": {"eval_counts": prog_counts, "fots_eval_counts": ref_counts,
                           "eval_summary": prog_summary, "launches": prog_launches},
           "eval_e2e_images_list": summary,
           "train_joint_from_files": {
               "steps": FILES_STEPS, "losses": [h["loss"] for h in hist], **readers,
               "phase_8_archive": archive_readers},
           "reader_first_batches": reader,
           "eval_ocr_png": ocr_out,
           "seconds": {"eval_e2e": t_eval - t_path, "detect": t_detect - t_eval,
                       "serve": t_serve - t_detect, "progressive": t_prog - t_serve,
                       "export_selftest": t_export - t_prog,
                       "train_joint": t_train - t_export, "eval_ocr": t_ocr - t_train,
                       "h5": t_h5 - t_ocr},
           "phase_wall_s": time.perf_counter() - t_phase}
    print(f"  eval_e2e -images_list det hmean {summary['detection_hmean']:.4f} e2e hmean "
          f"{summary['e2e_hmean']:.4f} (fots's); detect and serve over the folder equal the "
          f"engine on the asset pixels; export -selftest passed; train_joint from files: losses "
          f"{[round(h['loss'], 3) for h in hist]}, readers {readers}, phase 8 from the archive "
          f"{archive_readers}; eval_ocr over PNG files {ocr_out}; -h5 texts equal the "
          f"snapshot's, train_joint -h5 173 imported / 2 skipped")
    print(f"  launches {launches}; seconds {out['seconds']}; phase {out['phase_wall_s']:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches, out


# --------------------------------------------------------------------------
# phase 13: the image writers and the entry points that write images
# --------------------------------------------------------------------------

def _encode_sources():
    """The committed encoder references' sources ({name: u8 image}) and
    manifest (``tools/make_torch_encode_refs.py``)."""
    with np.load(os.path.join(ENCODE_REF, "sources.npz")) as z:
        src = {k: z[k] for k in z.files}
    with np.load(EVAL_IMAGES) as z:
        src["img_112"] = z["images"][0]
    with open(os.path.join(ENCODE_REF, "manifest.json")) as f:
        return src, json.load(f)


def phase_writers():
    """The JPEG encoder against ``cv2.imwrite``'s committed files, then (a
    main path) the three entry points that write images, each with the
    launch counts zeroed just before it: ``cli.rroi_demo`` (K4' and K4'-bwd
    at C = 3), ``cli.detect``'s annotated images, ``train_joint -debug``."""
    import fots_torch.imageio as imageio
    from fots_torch import imgproc
    from fots_torch.cli import detect, rroi_demo, train_joint
    from fots_torch.cli.detect import load_engine
    from fots_torch.imgproc import polylines, put_text
    from fots_torch.kernels import build
    from fots_torch.profiling import card_name_and_power_limit

    t_phase = time.perf_counter()
    smi = card_name_and_power_limit()
    cpu = _cpu_model()
    build_dir = os.path.join(REPO, "build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build_dir, prefix="writers_")

    # (a) the encoder: the committed cv2.imwrite files, byte for byte
    src, manifest = _encode_sources()
    sizes = {}
    for name, entry in manifest.items():
        with open(os.path.join(ENCODE_REF, entry["file"]), "rb") as f:
            want = f.read()
        got = imageio.imencode_jpg(src[name])
        check(got == want, f"writers: imencode_jpg({name}) differs from cv2.imwrite's file "
              f"({len(got)} vs {len(want)} bytes)")
        sizes[name] = len(got)
    times = []
    for _ in range(ENCODE_REPEATS):
        t0 = time.perf_counter()
        imageio.imencode_jpg(src["img_112"])
        times.append(1e3 * (time.perf_counter() - t0))
    encode_ms = statistics.median(times)
    print(f"phase 13: imencode_jpg equals cv2.imwrite's bytes on {sizes}; the 640x960 scene "
          f"encodes in {encode_ms:.3f} ms (median of {ENCODE_REPEATS}, "
          f"{min(times):.3f}-{max(times):.3f}) on {cpu}; card {smi}")
    # put_text: the committed cv2.putText renders, byte for byte
    with open(os.path.join(TEXT_REF, "cases.json")) as f:
        text_cases = json.load(f)["cases"]
    with np.load(os.path.join(TEXT_REF, "refs.npz")) as z:
        text_refs = {k: z[k] for k in z.files}
    for case in text_cases:
        got = put_text(text_refs[case["name"] + "_bg"].copy(), case["text"],
                       tuple(case["org"]), tuple(case["color"]))
        check(np.array_equal(got, text_refs[case["name"]]),
              f"writers: put_text differs from cv2.putText's render {case['name']}")
    print(f"  put_text equals the {len(text_cases)} committed cv2.putText renders "
          f"({', '.join(c['name'] for c in text_cases)})")

    # the results the path is held to, before the counted windows
    demo_args = ["-image", DEMO_SCENE, "-pooled_height", str(DEMO_POOLED_HEIGHT),
                 "-max_rois", str(DEMO_MAX_ROIS)]
    _, cpu_crops, cpu_grad = rroi_demo.main(demo_args + ["-out_dir", os.path.join(tmp, "cpu"),
                                                         "-device", "cpu"])
    with np.load(EVAL_IMAGES) as z:
        held, held_names = z["images"], [os.path.basename(str(n)) for n in z["names"]]
    with load_engine(SNAPSHOT, device="cuda") as engine:
        detect_want = {name: detect.result_rows(engine(im)[0])
                       for name, im in zip(held_names, held)}
    list_path, _ = _smoke_list(tmp)
    launches = {}

    # (b) cli.rroi_demo on the card
    demo_dir = os.path.join(tmp, "demo")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    energy, crops, grad = rroi_demo.main(demo_args + ["-out_dir", demo_dir])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches["rroi_demo"] = dict(build.launch_counts)
    check(launches["rroi_demo"]["pack_neighbors"] == 1
          and launches["rroi_demo"]["pack_neighbors_bwd"] == 1
          and sum(launches["rroi_demo"].values()) == 2,
          f"rroi_demo: launches {launches['rroi_demo']}, not one K4' and one K4'-bwd")
    crop_err = float(np.abs(crops - cpu_crops).max())
    grad_err = float(np.abs(grad - cpu_grad).max()) / float(np.abs(cpu_grad).max())
    check(crops.shape == cpu_crops.shape and crop_err <= 1e-3,
          f"rroi_demo: crops {crops.shape} differ from the CPU port's by {crop_err}")
    check(grad_err <= 1e-4, f"rroi_demo: the gradient differs by {grad_err} of its max")
    check(np.array_equal(grad != 0, cpu_grad != 0), "rroi_demo: the gradient's support differs")
    demo_files = sorted(os.listdir(demo_dir))
    check(demo_files == sorted([f"crop{i}.jpg" for i in range(len(crops))]
                               + ["grad.jpg", "grad_overlay.jpg"]),
          f"rroi_demo wrote {demo_files}")
    for name in demo_files:
        im = imageio.imread(os.path.join(demo_dir, name))
        check(im is not None and im.ndim == 3, f"rroi_demo: {name} does not decode")
    print(f"  rroi_demo on {DEMO_SHAPE} f32, {len(crops)} rois at {crops.shape[1:3]}: energy "
          f"{energy:.6e}; crops within {crop_err:.3e} and the gradient within {grad_err:.3e} "
          f"of its max of the CPU port's, same support; launches {launches['rroi_demo']}; "
          f"{demo_s:.3f} s; {len(demo_files)} files decode")

    # (c) cli.detect over the held-out jpgs, each drawing and write timed
    det_dir = os.path.join(tmp, "detect")
    drawn, write_s, text_s = [], [], []
    draw_results, imwrite = detect.draw_results, imageio.imwrite

    def timed_draw(im_resized, results):
        t = time.perf_counter()
        out = draw_results(im_resized, results)
        write_s.append(time.perf_counter() - t)
        drawn.append((np.array(im_resized, copy=True),
                      [(r["box"].copy(), r["text"]) for r in results]))
        return out

    def timed_text(*args):
        t = time.perf_counter()
        out = put_text(*args)
        text_s.append(time.perf_counter() - t)
        return out

    def timed_write(path, im):
        t = time.perf_counter()
        out = imwrite(path, im)
        write_s.append(time.perf_counter() - t)
        return out

    detect.draw_results, imageio.imwrite, imgproc.put_text = timed_draw, timed_write, timed_text
    try:
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        rows = detect.main(["-model", SNAPSHOT, "-test_folder", FILES_JPG, "-output", det_dir])
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0
    finally:
        detect.draw_results, imageio.imwrite, imgproc.put_text = draw_results, imwrite, put_text
    launches["detect"] = dict(build.launch_counts)
    check(sorted(rows) == sorted(held_names), f"detect wrote {sorted(rows)}")
    n_texts = 0
    for (im_resized, results), name in zip(drawn, sorted(rows)):
        _rows_close(rows[name], detect_want[name], f"writers detect {name}")
        # fots's drawing: each box, then its text, in the rows' order
        want = im_resized.copy()
        for b, text in results:
            polylines(want, b[:8].reshape(4, 2).astype(np.int32), (0, 255, 0))
            put_text(want, text, (int(b[0]), int(b[1]) - 3), (0, 255, 0))
            n_texts += bool(text)
        with open(os.path.join(det_dir, name), "rb") as f:
            check(f.read() == imageio.imencode_jpg(want),
                  f"detect {name}: the annotated jpg is not the drawing of its rows")
    n_img = len(rows)
    check(len(text_s) == sum(len(r) for _, r in drawn) and n_texts > 0,
          f"detect: {len(text_s)} put_text calls for {n_texts} texts")
    detect_ms = 1e3 * detect_s / n_img
    write_ms = 1e3 * sum(write_s) / n_img
    text_ms = 1e3 * sum(text_s) / n_img
    print(f"  detect over {n_img} held-out jpgs: rows equal the engine's on the asset pixels, "
          f"each annotated jpg is the drawing of its rows with {n_texts} texts; "
          f"{detect_ms:.2f} ms an image, of which drawing and writing {write_ms:.2f} ms "
          f"({detect_ms - write_ms:.2f} without), put_text {text_ms:.3f} ms; "
          f"launches {launches['detect']}; card {smi}")

    # (d) train_joint -debug: dumps at steps 0 and 2 of 4
    debug_dir = os.path.join(tmp, "debug")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    args, trainer = train_joint.build(
        ["-train_list", list_path, "-images_npz", SMOKE_IMAGES, "-save_path",
         os.path.join(tmp, "run"), "-batch_size", str(TRAIN_BATCH), "-input_size",
         str(JOINT_SIZE), "-checkpoint_every", "1000", "-seed", "0", "-num_readers",
         str(DEBUG_READERS), "-disp_interval", "2", "-max_iters", str(DEBUG_STEPS),
         "-debug", debug_dir, "-debug_every", str(DEBUG_EVERY)])
    train_joint.run(args, trainer)
    torch.cuda.synchronize()
    launches["train_joint_debug"] = dict(build.launch_counts)
    dumped = [s for s, _, _ in trainer.debug_log]
    check(dumped == list(range(0, DEBUG_STEPS, DEBUG_EVERY)), f"train_joint -debug at {dumped}")
    files = sorted(os.listdir(debug_dir))
    check(len(files) == sum(n for _, n, _ in trainer.debug_log) > 0,
          f"train_joint -debug: {len(files)} files for {trainer.debug_log}")
    pattern = re.compile(r"crop_(\d{6})_(\d{2})_(pred|gt)_[0-9A-Za-z_-]+\.jpg")
    for name in files:
        m = pattern.fullmatch(name)
        check(m is not None and int(m.group(1)) in dumped, f"train_joint -debug: file {name}")
        im = imageio.imread(os.path.join(debug_dir, name))
        check(im is not None and im.shape[0] == 44, f"train_joint -debug: {name} does not decode")
    check(all(math.isfinite(h["loss"]) for h in trainer.history), "train_joint -debug: losses")
    dump_ms = [1e3 * t for _, _, t in trainer.debug_log]
    print(f"  train_joint -debug, {DEBUG_STEPS} steps at b{TRAIN_BATCH} {JOINT_SIZE}: "
          f"{len(files)} crops at steps {dumped}; a dumped step adds "
          f"{[round(v, 3) for v in dump_ms]} host ms; launches {launches['train_joint_debug']}")

    total = {k: sum(run.get(k, 0) for run in launches.values()) for k in build.launch_counts}
    for run, kernels in (("rroi_demo", ("pack_neighbors", "pack_neighbors_bwd")),
                         ("detect", build.PATH_KERNELS["serving"]),
                         ("train_joint_debug", build.PATH_KERNELS["training"])):
        for kname in kernels:
            check(launches[run][kname] > 0, f"kernel {kname} was not launched by {run}")
    out = {"card": smi, "host_cpu": cpu, "encode_bytes": sizes, "encode_ms_640x960": encode_ms,
           "encode_ms_all": times,
           "rroi_demo": {"shape": list(DEMO_SHAPE), "rois": int(crops.shape[0]),
                         "pooled": list(crops.shape[1:3]), "energy": energy,
                         "crop_max_abs_err": crop_err, "grad_err_of_max": grad_err,
                         "seconds": demo_s, "launches": launches["rroi_demo"]},
           "detect": {"images": n_img, "ms_per_image": detect_ms,
                      "draw_write_ms_per_image": write_ms, "put_text_ms_per_image": text_ms,
                      "texts": n_texts, "text_refs": len(text_cases),
                      "ms_per_image_without_writing": detect_ms - write_ms,
                      "boxes": sum(len(r) for r in rows.values())},
           "train_joint_debug": {"steps": DEBUG_STEPS, "dumped_steps": dumped,
                                 "crops": len(files), "dump_host_ms": dump_ms},
           "launches": launches, "phase_wall_s": time.perf_counter() - t_phase}
    print(f"  launches {total}; phase {out['phase_wall_s']:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    return total, out


# --------------------------------------------------------------------------
# phase 14: the dense path, the yuv420 transport, a cuda,cpu bundle
# --------------------------------------------------------------------------

def _timed_stream(eng, scenes, batches: int):
    """(results of the last batch, images/s of the whole stream, every batch's
    host letterbox included, on the host clock, and the ms of each batch's
    letterbox) of ``stream`` over ``scenes`` repeated."""
    letterbox, lb_ms = eng._letterbox, []

    def timed(*args):
        t = time.perf_counter()
        out = letterbox(*args)
        lb_ms.append(1e3 * (time.perf_counter() - t))
        return out

    eng._letterbox = timed
    try:
        t0 = time.perf_counter()
        for last in eng.stream(iter([scenes] * batches), serve_hw=SERVE_HW):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng._letterbox
    return last, batches * len(scenes) / wall, lb_ms


def phase_transports(images):
    """The dense detection path, the yuv420 transport and a bundle for two
    device types, each with the launch counts zeroed just before it."""
    from fots_torch.checkpoint import load_detector
    from fots_torch.export import ExportedEngine, export_serving
    from fots_torch.kernels import build
    from fots_torch.ops.nms import extract_candidates, get_boxes, get_boxes_from_candidates
    from fots_torch.pipeline import FOTSInference
    from fots_torch.profiling import card_name_and_power_limit
    from fots_torch.serving import bucket_rois, host_letterbox

    t_phase = time.perf_counter()
    smi = card_name_and_power_limit()
    print(f"phase 14: transports; [{smi}]")
    model, _, config = load_detector(SNAPSHOT, "cuda")
    masked = config.get("masked_norm", False)
    batch = [images[i % len(images)] for i in range(BATCH)]
    out = {"card": smi, "batch": BATCH, "serve_hw": list(SERVE_HW), "dtype": "bf16"}
    launches = {}

    # (a) the dense path: maps to the host, get_boxes, texts from the raw focr
    with FOTSInference(model, masked_norm=masked, mixed_precision=True, cand_transport="f32",
                       device="cuda") as eng:
        boxed, _ = host_letterbox(batch, SERVE_HW)
        norm = boxed.astype(np.float32) / 128.0 - 1.0
        thresholds = (eng.segm_thresh, eng.iou_th1, eng.iou_th2)
        eng.detect_maps(norm)  # warm-up, not counted
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        segm, rbox, angle, focr = eng.detect_maps(norm)
        maps_s = time.perf_counter() - t0
        dense = [get_boxes(segm[i], rbox[i], angle[i], *thresholds) for i in range(BATCH)]
        nms_s = time.perf_counter() - t0 - maps_s
        texts = [eng.recognize_boxes(dense[i], focr, batch_index=i) for i in range(BATCH)]
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        launches["dense"] = dict(build.launch_counts)
        hs, ws = segm.shape[1:]
        cands = extract_candidates(*(torch.from_numpy(a).cuda() for a in (segm, rbox, angle)),
                                   hs * ws, eng.segm_thresh).cpu().numpy()
        for i in range(BATCH):
            check(np.array_equal(get_boxes_from_candidates(cands[i], hs, ws, *thresholds),
                                 dense[i]),
                  f"image {i}: get_boxes and get_boxes_from_candidates (k = all) differ")
        t0 = time.perf_counter()
        sparse, packed = eng.detect_boxes_batch(boxed)
        sparse_texts = [eng.recognize_boxes(dense[i], packed, batch_index=i)
                        for i in range(BATCH)]
        torch.cuda.synchronize()
        sparse_s = time.perf_counter() - t0
    check([b.shape[0] for b in dense] == [b.shape[0] for b in sparse],
          f"dense boxes {[b.shape[0] for b in dense]} vs candidate path "
          f"{[b.shape[0] for b in sparse]}")
    corner = max([float(np.abs(d[:, :8] - s[:, :8]).max()) for d, s in zip(dense, sparse)
                  if d.size] or [0.0])
    check(corner <= 1.0, f"dense and candidate-path corners differ by {corner} px")
    check(texts == sparse_texts, "texts from the raw focr differ from the PackedFocr's")
    check(all(any(t) for t in texts), "an image of the dense path yielded no text")
    out["dense"] = {"boxes": [int(b.shape[0]) for b in dense], "max_corner_px": corner,
                    "maps_ms": 1e3 * maps_s, "host_nms_ms": 1e3 * nms_s,
                    "batch_ms": 1e3 * dense_s, "candidate_path_batch_ms": 1e3 * sparse_s,
                    "launches": launches["dense"]}
    print(f"  (a) dense, b{BATCH} {SERVE_HW}: boxes {out['dense']['boxes']} = the candidate "
          f"path's (k = all: exactly; f32 transport: corners within {corner:.4f} px), texts "
          f"from the raw focr = the PackedFocr's; detect_maps {1e3 * maps_s:.2f} ms, host "
          f"get_boxes {1e3 * nms_s:.2f} ms, with recognition {1e3 * dense_s:.2f} ms a batch "
          f"(candidate path {1e3 * sparse_s:.2f}); launches {launches['dense']}")

    # (b) yuv420 against the u8 host letterbox, on the held-out scenes
    with np.load(EVAL_IMAGES) as z:
        scenes = list(z["images"])
    res, lb_ms, h2d, ips = {}, {}, {}, {}
    for transport in ("u8", "yuv420"):
        with FOTSInference(model, masked_norm=masked, mixed_precision=True, transport=transport,
                           device_letterbox=False, device="cuda") as eng:
            raw, _ = eng._letterbox(scenes, SERVE_HW)
            h2d[transport] = int(sum(a.nbytes for a in raw) if isinstance(raw, tuple)
                                 else raw.nbytes)
            eng.detect_boxes_batch(raw)  # warm-up, not counted
            torch.cuda.synchronize()
            build.reset_launch_counts()
            res[transport] = eng.batch_call(scenes, serve_hw=SERVE_HW)
            streamed, ips[transport], lb_ms[transport] = _timed_stream(eng, scenes,
                                                                       TRANSPORT_BATCHES)
            launches[transport] = dict(build.launch_counts)
        check([[e["text"] for e in r] for r in streamed]
              == [[e["text"] for e in r] for r in res[transport]],
              f"{transport}: stream's texts differ from batch_call's")
        check(all(len(r) > 0 for r in res[transport]),
              f"{transport}: an image of the held-out scenes yielded no text")
    counts = {t: [len(r) for r in res[t]] for t in res}
    # texts of an image that the other transport's results of it lack (as multisets)
    only = {t: sum(sum((Counter(e["text"] for e in a) - Counter(e["text"] for e in b)).values())
                   for a, b in zip(res[t], res[o]))
            for t, o in (("u8", "yuv420"), ("yuv420", "u8"))}
    differ = sum(sorted(e["text"] for e in a) != sorted(e["text"] for e in b)
                 for a, b in zip(res["yuv420"], res["u8"]))
    n_texts = {t: sum(len(r) for r in res[t]) for t in res}
    out["yuv420"] = {"scenes": len(scenes), "boxes": counts, "texts": n_texts,
                     "images_with_other_texts": differ, "texts_only_in": only,
                     "host_letterbox_ms": lb_ms, "h2d_bytes_per_batch": h2d,
                     "stream_images_per_s": ips,
                     "launches": {t: launches[t] for t in ("u8", "yuv420")}}
    print(f"  (b) yuv420 vs u8 host letterbox, {len(scenes)} held-out scenes at {SERVE_HW} bf16: "
          f"boxes {counts}; {differ} images read other texts ({only['yuv420']} texts only "
          f"under yuv420, {only['u8']} only under u8, of {n_texts}); host letterbox ms a "
          f"batch {lb_ms}; h2d bytes a batch {h2d}; "
          f"[{smi}] stream images/s over {TRANSPORT_BATCHES} batches {ips}; launches "
          f"{ {t: launches[t] for t in ('u8', 'yuv420')} }")
    for path in ("dense", "yuv420"):
        for name in build.PATH_KERNELS["serving"]:
            check(launches[path][name] > 0, f"kernel {name} was not launched on the {path} path")

    # (c) one bundle for cuda and cpu, f32; each device type's programs
    # against the other's, as phase 3 holds the CUDA port against the CPU port
    model32, _, _ = load_detector(SNAPSHOT, "cuda")
    pair = list(images[:2])
    with tempfile.TemporaryDirectory(prefix="fots_bundle2_") as tmp, \
            FOTSInference(model32, masked_norm=masked, device_letterbox=False,
                          device="cuda") as eng:
        # the strip buckets the two images use (masked IN: a strip does not
        # depend on its bucket's width, and no roi changes bucket)
        with no_tf32():
            boxes, _ = eng.detect_boxes_batch(host_letterbox(pair, SERVE_HW)[0])
        eng.strip_buckets = tuple(sorted(bucket_rois(boxes, eng.expand_w_frac,
                                                     eng.strip_buckets)[2]))
        bundle = os.path.join(tmp, "bundle")
        t0 = time.perf_counter()
        manifest = export_serving(eng, bundle, len(pair), *SERVE_HW, platforms=("cuda", "cpu"))
        export_s = time.perf_counter() - t0
        check(manifest["platforms"] == ["cuda", "cpu"] and all(
            sorted(p["files"]) == ["cpu", "cuda"] for p in manifest["programs"].values()),
              f"the manifest lists {manifest['platforms']}")
        served_path = os.path.join(tmp, "served.json")
        _run_child([os.path.abspath(__file__), "--serve-bundle", bundle, served_path,
                    "--no-tf32"], "serve-bundle cuda")
        with open(served_path) as f:
            served = json.load(f)
        with ExportedEngine(bundle, device="cpu") as cpu_engine:
            t0 = time.perf_counter()
            on_cpu = cpu_engine.batch_call(pair)
            cpu_s = time.perf_counter() - t0
    got = [[{"box": np.asarray(e["box"]), "text": e["text"]} for e in r]
           for r in served["results"]]
    check([len(r) for r in got] == [len(r) for r in on_cpu],
          f"bundle box counts: cuda {[len(r) for r in got]} vs cpu {[len(r) for r in on_cpu]}")
    check(all(len(r) > 0 for r in on_cpu), "the cpu programs found no text")
    bundle_corner = 0.0
    for g_img, w_img in zip(got, on_cpu):
        for g, w in zip(g_img, w_img):
            check(g["text"] == w["text"], f"bundle texts differ: {g['text']!r} vs {w['text']!r}")
            bundle_corner = max(bundle_corner, float(np.abs(g["box"][:8] - w["box"][:8]).max()))
    check(bundle_corner <= 1.0, f"bundle corners differ by {bundle_corner} px across devices")
    out["bundle"] = {"batch": len(pair), "dtype": "f32", "platforms": manifest["platforms"],
                     "strip_buckets": manifest["strip_buckets"],
                     "programs": len(manifest["programs"]), "export_s": export_s,
                     "boxes": [len(r) for r in on_cpu], "max_corner_px": bundle_corner,
                     "cuda_load_s": served["load_s"], "cpu_batch_s": cpu_s,
                     "cuda_setup_launches": served["launches"]}
    print(f"  (c) a cuda,cpu bundle, f32 b{len(pair)} {SERVE_HW}, buckets "
          f"{manifest['strip_buckets']}: exported in {export_s:.1f} s; the cuda programs in a "
          f"fresh process (loaded in {served['load_s']:.1f} s) and the cpu programs here "
          f"({cpu_s:.2f} s a batch): boxes {out['bundle']['boxes']}, texts identical, corners "
          f"within {bundle_corner:.4f} px")
    total = {k: launches["dense"][k] + launches["yuv420"][k] + launches["u8"][k]
             for k in build.launch_counts}
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"  launches {total}; phase {out['phase_wall_s']:.1f} s")
    return total, out


# --------------------------------------------------------------------------
# phase 15: the mesh
# --------------------------------------------------------------------------

#: phase 3's and phase 6's limits: corners within 1 px and identical texts;
#: loss terms within 1e-4, each gradient within 3e-2 of its tensor's largest
#: magnitude (the median within 2e-3), one Adam step within 1e-3 lr where the
#: gradient's sign is resolved, BatchNorm statistics within 1e-4
MESH_CORNER_PX = 1.0
MESH_WIDE = 750          # classes of (c): conv11 splits over the model axis
MESH_SCENE_HW = (160, 224)  # (c): the asset scenes shrunk 4 times, cut to /32
MESH_TIMED = 3           # timed serving batches of (a) and (b), train steps of (b);
                         # (a) times 2 * MESH_TIMED steps of each trainer in turns


def _card_limits():
    from fots_torch.parallel.selfcheck import Limits

    return Limits(loss_rel=1e-4, loss_abs=1e-5, grad_rel=3e-2, grad_median=2e-3,
                  param_lr=1e-3, stat_rel=1e-4, cand_rel=1e-4, cand_abs=1e-4)


def _held(res, what):
    check(res["failures"] == [], f"{what}: {res['failures'][:6]}")
    return {k: v for k, v in res.items() if k != "failures"}


def phase_mesh(images, targets, device="cuda", serve_hw=SERVE_HW, batch=BATCH,
               train_order=tuple(i % 4 for i in range(TRAIN_BATCH))):
    """The mesh: (a) world 1 under NCCL in this process, the serving batch
    and one training step through ``FOTSInference(mesh=)`` and
    ``Trainer(mesh=)`` against the unmeshed engine and step; (b) two ranks
    sharing the card over gloo, the same batch and step; (c) four ranks,
    data 2 x model 2, on the card over gloo, 750 classes, one step of four
    shrunk scenes against one process.  TF32 off throughout."""
    import torch.distributed as dist

    from fots_torch.parallel import make_mesh
    from fots_torch.parallel import selfcheck as sc
    from fots_torch.train import asset_batch

    limits = _card_limits()
    t_phase = time.perf_counter()
    scenes = [images[i % len(images)] for i in range(batch)]
    train_batch = asset_batch(images, targets, list(train_order))
    serve = dict(snapshot=SNAPSHOT, device=device, masked_norm=True, mixed_precision=True,
                 images=scenes, serve_hw=serve_hw, time_batches=MESH_TIMED)
    # as cli.serve letterboxes, in f32: in bf16 the host-letterboxed texts of
    # one process already depend on the batch's row count (the 16-row and
    # 8-row runs of (a) below; cuDNN's convolutions and K2''s split choose by
    # the rows, fots_torch.profiling --path batch_rows)
    host_serve = dict(serve, device_letterbox=False, mixed_precision=False)
    host_bf16 = dict(host_serve, mixed_precision=True, time_batches=0)
    train = dict(snapshot=SNAPSHOT, device=device, lr=TRAIN_LR, batches=[train_batch])
    print(f"phase 15: the mesh; (a) world 1 ({'nccl' if device == 'cuda' else 'gloo'}): "
          f"serving bf16 b{batch} at {serve_hw}, a training step f32 b{len(train_order)} at "
          f"{train_batch.images.shape[1:3]}, meshed against unmeshed")
    out = {}
    tmp = tempfile.mkdtemp(prefix="fots_mesh_")
    try:
        with no_tf32():
            dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                    store=dist.FileStore(os.path.join(tmp, "store1"), 1),
                                    rank=0, world_size=1)
            try:
                mesh = make_mesh(1, 1)
                plain_serve = sc.run_serve(serve, None)
                plain_host = sc.run_serve(host_serve, None)
                rows_bf16 = [sc.run_serve(dict(host_bf16, images=scenes[:n]), None)["results"][0]
                             for n in (batch, batch // 2)]
                mesh_serve = sc.run_serve(serve, mesh)
                plain_train = sc.run_train(train, None)
                mesh_train = sc.run_train(train, mesh)
                # then steps of the two trainers in turns (unmeshed, meshed, meshed,
                # unmeshed, ...), each unpipelined: upload, roi sampling and dispatch
                # on the host clock until the card is idle
                trainers = {"unmeshed": plain_train.pop("trainer"),
                            "meshed": mesh_train.pop("trainer")}
                step_ms = {k: [] for k in trainers}
                for i in range(2 * MESH_TIMED):
                    for k in (("unmeshed", "meshed") if i % 2 == 0 else ("meshed", "unmeshed")):
                        step_ms[k] += sc.timed_ms(lambda: trainers[k].step(train_batch), 1,
                                                device)
                del trainers
            finally:
                dist.destroy_process_group()
        a_serve = _held(sc.compare_serve(mesh_serve, plain_serve, limits, px=MESH_CORNER_PX,
                                         px_rel=0.0, candidates=False), "(a) serving")
        a_train = _held(sc.compare_train(mesh_train, plain_train, limits, TRAIN_LR),
                        "(a) training step")
        for name in ("instance_norm", "spatial_stats", "spatial_norm", "pack_neighbors"):
            check(device != "cuda" or mesh_serve["launches"][name] > 0,
                  f"(a) meshed serving launched no {name}")
        for name in ("instance_norm", "instance_norm_bwd", "spatial_stats", "spatial_norm",
                     "pack_neighbors", "pack_neighbors_bwd"):
            check(device != "cuda" or mesh_train["launches"][name] > 0,
                  f"(a) meshed training launched no {name}")
        rows_differ = [i for i in range(batch // 2)
                       if [e["text"] for e in rows_bf16[0][i]] != [e["text"] for e in
                                                                    rows_bf16[1][i]]]
        rows_px = max((float(np.abs(np.asarray(e["box"][:8]) - np.asarray(f["box"][:8])).max())
                       for i in range(batch // 2) for e, f in zip(rows_bf16[0][i],
                                                                  rows_bf16[1][i])),
                      default=0.0)
        out["a"] = {"bf16_host_letterbox_16_vs_8_rows": {"texts_differ": rows_differ,
                                                         "max_corner_px": rows_px},
                    "serving": a_serve, "train": a_train,
                    "serve_batch_ms": {"unmeshed": plain_serve["batch_ms"],
                                       "meshed": mesh_serve["batch_ms"]},
                    "train_step_ms": step_ms,
                    "launches_serving": mesh_serve["launches"],
                    "launches_training": mesh_train["launches"]}
        print(f"  (a) serving: corners within {a_serve['max_corner_px']:.4f} px, texts equal; "
              f"batch ms unmeshed {plain_serve['batch_ms']} meshed {mesh_serve['batch_ms']}")
        print(f"  (a) bf16, host letterbox, one process: the texts of images {rows_differ} "
              f"differ between {batch} rows and the first {batch // 2}, corners within "
              f"{rows_px:.4f} px")
        print(f"  (a) training: {a_train}; step ms in turns: unmeshed "
              f"{step_ms['unmeshed']}, meshed {step_ms['meshed']}")
        del mesh_serve, mesh_train
        if device == "cuda":
            torch.cuda.empty_cache()

        print("  (b) two ranks sharing the card over gloo: the same serving batch (letterboxed "
              "on the card; then on the host, f32) and step")
        t0 = time.perf_counter()
        got = sc.finish(sc.start([("serve", serve), ("train", dict(train, time_steps=MESH_TIMED)),
                                  ("serve", host_serve)],
                                 os.path.join(tmp, "w2"), n_data=2), os.path.join(tmp, "w2"))
        b_serve = _held(sc.compare_serve(got[0], plain_serve, limits, px=MESH_CORNER_PX,
                                         px_rel=0.0, candidates=False), "(b) serving")
        b_host = _held(sc.compare_serve(got[2], plain_host, limits, px=MESH_CORNER_PX,
                                        px_rel=0.0, candidates=False),
                       "(b) serving, host letterbox")
        b_train = _held(sc.compare_train(got[1], plain_train, limits, TRAIN_LR),
                        "(b) training step")
        for rec, what in ((got[0], "serving"), (got[1], "training")):
            check(device != "cuda" or rec["launches"]["instance_norm"] > 0,
                  f"(b) rank 0's {what} ran no CUDA kernel")
        out["b"] = {"serving": b_serve, "train": b_train, "seconds": time.perf_counter() - t0,
                    "rank0_serve_batch_ms": got[0]["batch_ms"],
                    "rank0_train_step_ms": got[1]["step_ms"],
                    "rank0_launches_serving": got[0]["launches"],
                    "rank0_launches_training": got[1]["launches"],
                    "host_letterbox": {
                        "serving": b_host,
                        "unmeshed_batch_ms": plain_host["batch_ms"],
                        "unmeshed_letterbox_ms": plain_host["letterbox_ms"],
                        "rank0_batch_ms": got[2]["batch_ms"],
                        "rank0_letterbox_ms": got[2]["letterbox_ms"]},
                    "note": "gloo between two processes on one card: not NCCL across cards"}
        print(f"  (b) {out['b']['seconds']:.1f} s; serving within "
              f"{b_serve['max_corner_px']:.4f} px; training {b_train}; rank 0 batch ms "
              f"{got[0]['batch_ms']}, step ms {got[1]['step_ms']} (gloo on one card, not "
              f"NCCL across cards)")
        print(f"  (b) host letterbox: within {b_host['max_corner_px']:.4f} px; letterbox ms of "
              f"rank 0's rows {got[2]['letterbox_ms']} against the whole batch's "
              f"{plain_host['letterbox_ms']}; batch ms rank 0 {got[2]['batch_ms']}, unmeshed "
              f"{plain_host['batch_ms']}")
        del got, plain_serve, plain_train, plain_host

        print(f"  (c) four ranks, data 2 x model 2, {MESH_WIDE} classes, one step of 4 scenes "
              f"at {MESH_SCENE_HW} against one process")
        t0 = time.perf_counter()
        small = sc.scene_batch(images, targets, [0, 1, 2, 3], scale=4, width=MESH_SCENE_HW[1])
        wide = dict(snapshot=SNAPSHOT, nclass=MESH_WIDE, seed=0, device=device, lr=TRAIN_LR,
                    batches=[small])
        ctx = sc.start([("train", wide)], os.path.join(tmp, "w4"), n_data=2, n_model=2)
        with no_tf32():
            want = sc.single([("train", wide)])[0]
        got = sc.finish(ctx, os.path.join(tmp, "w4"))[0]
        c_train = _held(sc.compare_train(got, want, limits, TRAIN_LR), "(c) training step")
        rows = sc.conv11_rows_hold(got, want)
        check(rows is None, f"(c) {rows}")
        out["c"] = {"train": c_train, "seconds": time.perf_counter() - t0,
                    "conv11_rows": [[d, m, list(w.shape)] for d, m, w in got["conv11_rows"]]}
        print(f"  (c) {out['c']['seconds']:.1f} s; {c_train}; conv11 rows "
              f"{out['c']['conv11_rows']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 15: {out['seconds']:.1f} s")
    launches = {k: out["a"]["launches_serving"].get(k, 0) + out["a"]["launches_training"].get(k, 0)
                for k in out["a"]["launches_serving"]}
    return launches, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}; the result "
                    "lines are printed only when every phase ran")
    ap.add_argument("--serve-bundle", nargs=2, metavar=("BUNDLE", "OUT_JSON"),
                    help="serve one batch from an exported bundle in this process and "
                    "write the results to OUT_JSON (phases 5 and 14 run this in a fresh "
                    "process)")
    ap.add_argument("--no-tf32", action="store_true",
                    help="with --serve-bundle: f32 convolutions and matmuls in full f32")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if args.serve_bundle:
        if args.no_tf32:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        return serve_bundle(*args.serve_bundle)
    from fots_torch.kernels import build
    from fots_torch.profiling import card_name_and_power_limit

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"device {name}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; peaks assumed for "
          f"{peaks[0]}: {peaks[1] / 1e12} TB/s, {peaks[2] / 1e12} TFLOP/s f32, "
          f"{peaks[3] / 1e12} TFLOP/s bf16 (tensor cores)")

    t0 = time.perf_counter()
    logs = build.build()
    print(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for lib, text in logs.items():
        for line in text.splitlines():
            if line.startswith("[") or "warning" in line.lower():
                print(f"  {lib}: {line.strip()}")
    ptxas = {lib: ptxas_report(text) for lib, text in logs.items()}
    for lib, kernels in ptxas.items():
        for kname, info in kernels.items():
            print(f"  {lib}: {kname} {info}")

    images, targets = load_assets()
    results = {}
    if "kernels" in phases:
        results["kernels"] = phase_kernels(dev, peaks)
    if "serve_parity" in phases:
        results["serve_parity"] = phase_serve_parity(list(images))
    if "serve" in phases:
        results["serve"] = phase_serve(list(images))
    if "export" in phases:
        results["export"] = phase_export(list(images))
    if "train_parity" in phases:
        results["train_parity"] = {name: phase_train_parity(images, targets, ohem)
                                   for name, ohem in (("dice", False), ("ohem", True))}
    if "train" in phases:
        results["train"] = phase_train(images, targets)
    if "train_joint" in phases:
        results["train_joint"] = phase_train_joint(targets)
    if "fused_block" in phases:
        results["fused_block"] = phase_fused_block()
    if "eval" in phases:
        results["eval"] = phase_eval()
    if "ocr" in phases:
        results["ocr"] = phase_ocr(images, targets)
    if "files" in phases:
        results["files"] = phase_files(images, results.get("eval", (None, None))[1],
                                       results.get("train_joint", (None, None))[1])
    if "writers" in phases:
        results["writers"] = phase_writers()
    if "transports" in phases:
        results["transports"] = phase_transports(list(images))
    if "mesh" in phases:
        results["mesh"] = phase_mesh(images, targets)
    smi = card_name_and_power_limit()
    if set(phases) != set(PHASES):
        print(f"ran phases {phases} only; no result lines")
        print(smi)
        return 0

    worst, rows, crelu = results["kernels"]
    serve_launches, ips = results["serve"]
    export_launches, exported = results["export"]
    train_launches, train = results["train"]
    joint_launches, joint = results["train_joint"]
    fused_launches, fused = results["fused_block"]
    eval_launches, evaluation = results["eval"]
    ocr_launches, ocr = results["ocr"]
    files_launches, files = results["files"]
    writers_launches, writers = results["writers"]
    transports_launches, transports = results["transports"]
    mesh_launches, mesh = results["mesh"]
    kernels = []
    for kname, (source, replaces) in KERNEL_META.items():
        r = rows[kname]
        by_bytes, by_ops = r["bound"]
        paths = {"serving": serve_launches[kname], "export": export_launches.get(kname, 0),
                 "training": train_launches[kname],
                 "train_joint": joint_launches[kname], "fused_block": fused_launches[kname],
                 "evaluation": eval_launches[kname], "ocr": ocr_launches[kname],
                 "files": files_launches[kname], "writers": writers_launches[kname],
                 "transports": transports_launches[kname], "mesh": mesh_launches[kname]}
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "max_abs_err": worst[kname],
            "ms": r["ms"], "device_busy_ms": r["device_busy_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": r["library_ms"], "library_call": r["library_note"],
            "shape": r["shape"], "dtype": r["dtype"], "paths": paths,
            "launches_per_serving_batch": paths["serving"] / STREAM_BATCHES,
            "launches_per_train_step": paths["training"] / TRAIN_STEPS,
            "launches_per_train_joint_step": paths["train_joint"] / JOINT_STEPS,
            "launches_per_eval_image": paths["evaluation"] / evaluation["scenes"],
            "launches_per_export_batch": paths["export"] / exported["export_batches"],
            "export_setup_launches": exported["setup_launches"].get(kname, 0),
            **({"launches_by_route": {
                route: {"serving": serve_launches[f"{kname}/{route}"],
                        "export": export_launches.get(f"{kname}/{route}", 0),
                        "training": train_launches[f"{kname}/{route}"],
                        "train_joint": joint_launches[f"{kname}/{route}"],
                        "evaluation": eval_launches[f"{kname}/{route}"],
                        "ocr": ocr_launches[f"{kname}/{route}"],
                        "files": files_launches[f"{kname}/{route}"]}
                for route in ("cluster", "two_pass")}}
               if f"{kname}/cluster" in serve_launches else {}),
            **r["extra"],
            **({"ptxas": ptxas.get("fused_block", {})} if kname == "fused_block" else {}),
        })
    # the C = 3 f32 rows: launched by cli.rroi_demo's one forward and backward
    for kname, base in C3_KERNELS.items():
        r = rows[kname]
        by_bytes, by_ops = r["bound"]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_META[base][0],
            "replaces": KERNEL_META[base][1],
            "launches": writers["rroi_demo"]["launches"][base],
            "max_abs_err": worst[kname], "ms": r["ms"], "device_busy_ms": r["device_busy_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": r["library_ms"], "library_call": r["library_note"],
            "shape": r["shape"], "dtype": r["dtype"],
            "paths": {"writers": writers["rroi_demo"]["launches"][base]}, **r["extra"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": {"images_per_s": ips, "batch": BATCH,
                              "serve_hw": list(SERVE_HW), "dtype": "bf16",
                              "batches": STREAM_BATCHES,
                              "cuda_vs_cpu_max_corner_px": results["serve_parity"],
                              "stem_crelu_ms": crelu}}))
    print(json.dumps({"export": exported}))
    print(json.dumps({"train": {**train, "cuda_vs_cpu": results["train_parity"]}}))
    print(json.dumps({"train_joint": joint}))
    print(json.dumps({"fused_block": fused}))
    print(json.dumps({"eval": evaluation}))
    print(json.dumps({"ocr": ocr}))
    print(json.dumps({"files": files}))
    print(json.dumps({"writers": writers}))
    print(json.dumps({"transports": transports}))
    print(json.dumps({"mesh": mesh}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
