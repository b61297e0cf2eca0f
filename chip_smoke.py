"""Chip smoke test of the PyTorch/CUDA port (``fots_torch``) on one GPU.

    python3 chip_smoke.py                # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels   # a subset (no result line)

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build every native library from the sources in this checkout (nvcc for
   the CUDA kernels, all started together; g++ for the host NMS);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes the serving path (batch 16, 704x1280) and the training path
   (batch 8, 640x960) give it, plus odd shapes.  K1' and K1'-bwd run each
   shape on both of their routes (the single-kernel cluster route as the plan
   cuts it, and the two-pass route), against the plain version and against
   each other; the cluster route also twice (bit identity), at ragged pixel
   counts, at every cluster size, and its saved statistics against the plain
   emulation of its fold.  Then each kernel's median time
   beside the plain version's, a library call's where one PyTorch call
   computes the same function, and the least time the card could take
   (bytes moved over the memory rate, or operations over the rate of
   their type, whichever is larger).  K5' (the fused conv3x3 + instance
   norm + residual + activation) is held at the shapes of the JAX package's
   tests (f32, TF32 off for the plain version), one ragged shape and its
   profile shape 16x88x160x128 bf16, and its gradients through the
   ``autograd.Function`` against autograd of the plain version;
3. the CUDA port against the CPU port (f32, TF32 off for this phase only)
   on one serving batch of two smoke images at 704x1280 with the shipped
   snapshot: same box count per image, quad corners within 1 px,
   identical texts;
4. serving at full width (a main path): bf16, the snapshot's masked_norm,
   device letterbox, u16 candidates, batch 16 at 704x1280, ``stream`` over
   6 batches with the launch counts zeroed just before; every image must
   yield text, every serving kernel must have launched; images/s over the
   steady batches on the host clock (PyTorch's default math settings);
5. one training step, CUDA port against CPU port (f32, TF32 off for this
   phase only): two asset scenes at 640x960, ground-truth rois from one
   seed, dropout masks from equally seeded CPU generators; the five loss
   terms, every parameter gradient, the BatchNorm running statistics and
   every parameter after one Adam step must agree;
6. training at full width (a main path): the snapshot as warm start, f32,
   batch 8 at 640x960 (the four asset scenes twice, one repeated batch),
   predicted-roi sampling pipelined on a prefetch thread, masked_norm,
   12 steps of ``Trainer.train`` with the launch counts zeroed just
   before; every loss finite, every training kernel launched, the total
   loss after 10 updates below the first step's; images/s over steps
   3..12 on the host clock (PyTorch's default math settings: cuDNN may use
   TF32 for the convolutions);
7. K5's own path (a main path): ``fots_torch.profiling``'s ``fused_block``
   entry at the full shape 16x88x160x128 bf16 with the launch counts zeroed
   just before: the numeric check, then K5' against the detector's
   composition (cuDNN conv + K1' + add + ReLU) and against PyTorch calls
   only;
8. the evaluation path (a main path): ``fots_torch.cli.eval_e2e`` over the
   16 held-out scenes of ``fots_torch/assets/heldout_eval_u8.npz`` with the
   shipped snapshot: per image at the scenes' own size in f32 (TF32 off; the
   launch counts zeroed just before), through ``-serve_hw 704x1280``, with
   ``-beam 8`` and with ``-split_words``, each held to the JAX package's
   own result on the same pixels (``heldout_eval_fots_cpu.json``: match,
   detection and ground-truth counts within one, the same text on every
   detection both have but for at most two argmax near-ties); then once in
   bf16, reported and not held.

Then it prints a ``{"kernels": [...]}`` JSON line, the serving, training,
fused-block and evaluation JSON lines, the card's name and power limit from nvidia-smi, and
last the ``{"ok": true, "device": {...}}`` line.  Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

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
EVAL_IMAGES = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_u8.npz")
EVAL_REFERENCE = os.path.join(REPO, "fots_torch", "assets", "heldout_eval_fots_cpu.json")
FUSED_SHAPE = (16, 88, 160, 128)
PHASES = ("build", "kernels", "serve_parity", "serve", "train_parity", "train",
          "fused_block", "eval")

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


def card_peaks(name: str):
    for key, bw, f32, bf16 in _PEAKS:
        if key in name:
            return key, bw, f32, bf16
    raise RuntimeError(f"no published peaks recorded for {name!r}")


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
    worst = {name: 0.0 for name in KERNEL_META}
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

    def in_case(b, h, w, c, dtype, affine, slope, valid_w=None, plan=None):
        """K1' at one shape on each route: output and saved statistics
        against the plain version; on the cluster route also twice (bit
        identity), the statistics against the plain emulation of its fold
        (1e-5 (1 + |ref|): the same shares in the same rank order, summed
        inside a share in another order), and against the two-pass route."""
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

    def pack_case(shape, dtype):
        f = rand(shape, dtype)
        got = trr.pack_neighbors(f)
        want = trr.pack_neighbors_ref(f)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        report("pack_neighbors", f"{str(dtype)[6:]} {shape} bit-exact={equal}", equal,
               *errors(got, want))

    def pack_bwd_case(shape):
        n = shape[0] * shape[1] * shape[2]
        g = rand((n, 4 * shape[3]))
        got = trr.pack_neighbors_bwd_cuda(g, shape)
        want = trr.pack_neighbors_bwd_ref(g, shape)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        report("pack_neighbors_bwd", f"f32 {shape} bit-exact={equal}", equal,
               *errors(got, want))

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

    # the training path's backward: every K1' IN at batch 8, 640x960, the
    # masked INs of a 256-wide strip batch, the stem's two CReLU-INs
    for h, w, c, affine, slope in in_shapes(TH, TW):
        bwd_case(TRAIN_BATCH, h, w, c, affine, slope)
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
            ((3, 7, 13, 20), torch.float32), ((2, 5, 9, 6), torch.bfloat16)]
    for shape, dtype in stem:
        stats_case(shape, dtype)
        norm_case(shape, dtype, 2, 0.01)
        norm_case(shape, dtype, 1, None)
        crelu_case(shape, dtype)
    crelu_case((2, 6, 10, 12), torch.float32, groups=4)

    for shape, dtype in (((BATCH, H // 4, W // 4, 64), torch.bfloat16),
                         ((TRAIN_BATCH, TH // 4, TW // 4, 64), torch.float32),
                         ((3, 5, 7, 8), torch.float32), ((2, 3, 5, 24), torch.bfloat16)):
        pack_case(shape, dtype)
    for shape in ((TRAIN_BATCH, TH // 4, TW // 4, 64), (3, 5, 7, 8), (2, 3, 5, 4)):
        pack_bwd_case(shape)

    # K5': the JAX package's test shapes (f32), a ragged shape (H, W not
    # multiples of 8, C = 48), bf16, and the profile shape
    for slope in (None, 0.01):
        for with_res in (True, False):
            fused_case((2, 32, 48, 64), torch.float32, slope, with_res)
    fused_case((1, 40, 32, 64), torch.float32, None, True, seed=3)
    fused_case((2, 16, 32, 128), torch.float32, 0.01, True, seed=4)
    for dtype in (torch.float32, torch.bfloat16):
        fused_case((2, 13, 21, 48), dtype, 0.01, True, seed=5)
    fused_case((1, 9, 70, 16), torch.bfloat16, None, False, seed=6)
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
        rows[name] = dict(ms=cuda_median_ms(kernel), plain_ms=cuda_median_ms(plain),
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
        print(f"  {name} at {tuple(r['shape'])} {r['dtype']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms ({r['library_note']}), "
              f"bound {1e3 * max(r['bound']):.4f} ms"
              + (f"; by route {r['extra']['route_ms']}, device busy "
                 f"{r['extra']['route_device_busy_ms']}" if "route_ms" in r["extra"] else ""))
    print(f"  CReLU-IN at {tuple(xs.shape)} bf16: K2'+fold+K3' {crelu_ms:.4f} ms, "
          f"torch.cat + K1' {cat_ms:.4f} ms")
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
# phases 5 and 6: training
# --------------------------------------------------------------------------

def phase_train_parity(images, targets):
    """One training step, f32, CUDA port against CPU port."""
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
    print(f"phase 5: one training step, CUDA port vs CPU port, f32 (TF32 off), "
          f"2 scenes at {hw}, {int(roi.roi_mask.sum())} rois, strip width "
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
                                       torch.Generator().manual_seed(7),
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
    print(f"phase 6: training, f32, batch {TRAIN_BATCH} at {TRAIN_HW}, {TRAIN_STEPS} "
          f"steps on one repeated batch, warm start from the snapshot, lr {TRAIN_LR}")
    model, _, _ = load_detector(SNAPSHOT, "cuda")
    trainer = Trainer(model, learning_rate=TRAIN_LR, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    trainer.train([batch] * 2, max_steps=2, log_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train([batch] * (TRAIN_STEPS - 2), max_steps=TRAIN_STEPS - 2, log_every=0)
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
# phase 7: K5's own path; phase 8: the evaluation path
# --------------------------------------------------------------------------

def phase_fused_block():
    """K5's entry point at the full shape: a main path for the counts."""
    from fots_torch.kernels import build
    from fots_torch.profiling import profile_fused_block

    print(f"phase 7: fots_torch.profiling --path fused_block at {FUSED_SHAPE} bf16")
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
          f"ms per iteration; fused_speedup {out['fused_speedup']:.3f}")
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
    print(f"phase 8: eval_e2e over {n_images} held-out scenes {data[0].shape[1:3]}, the "
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}; the result "
                    "lines are printed only when every phase ran")
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
            if "registers" in line or "spill" in line or line.startswith("["):
                print(f"  {lib}: {line.strip()}")

    images, targets = load_assets()
    results = {}
    if "kernels" in phases:
        results["kernels"] = phase_kernels(dev, peaks)
    if "serve_parity" in phases:
        results["serve_parity"] = phase_serve_parity(list(images))
    if "serve" in phases:
        results["serve"] = phase_serve(list(images))
    if "train_parity" in phases:
        results["train_parity"] = phase_train_parity(images, targets)
    if "train" in phases:
        results["train"] = phase_train(images, targets)
    if "fused_block" in phases:
        results["fused_block"] = phase_fused_block()
    if "eval" in phases:
        results["eval"] = phase_eval()
    smi = card_name_and_power_limit()
    if set(phases) != set(PHASES):
        print(f"ran phases {phases} only; no result lines")
        print(smi)
        return 0

    worst, rows, crelu = results["kernels"]
    serve_launches, ips = results["serve"]
    train_launches, train = results["train"]
    fused_launches, fused = results["fused_block"]
    eval_launches, evaluation = results["eval"]
    kernels = []
    for kname, (source, replaces) in KERNEL_META.items():
        r = rows[kname]
        by_bytes, by_ops = r["bound"]
        paths = {"serving": serve_launches[kname], "training": train_launches[kname],
                 "fused_block": fused_launches[kname], "evaluation": eval_launches[kname]}
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "max_abs_err": worst[kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": r["library_ms"], "library_call": r["library_note"],
            "shape": r["shape"], "dtype": r["dtype"], "paths": paths,
            "launches_per_serving_batch": paths["serving"] / STREAM_BATCHES,
            "launches_per_train_step": paths["training"] / TRAIN_STEPS,
            "launches_per_eval_image": paths["evaluation"] / evaluation["scenes"],
            **({"launches_by_route": {
                route: {"serving": serve_launches[f"{kname}/{route}"],
                        "training": train_launches[f"{kname}/{route}"],
                        "evaluation": eval_launches[f"{kname}/{route}"]}
                for route in ("cluster", "two_pass")}}
               if f"{kname}/cluster" in serve_launches else {}),
            **r["extra"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": {"images_per_s": ips, "batch": BATCH,
                              "serve_hw": list(SERVE_HW), "dtype": "bf16",
                              "batches": STREAM_BATCHES,
                              "cuda_vs_cpu_max_corner_px": results["serve_parity"],
                              "stem_crelu_ms": crelu}}))
    print(json.dumps({"train": {**train, "cuda_vs_cpu": results["train_parity"]}}))
    print(json.dumps({"fused_block": fused}))
    print(json.dumps({"eval": evaluation}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
