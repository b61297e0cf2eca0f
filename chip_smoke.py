"""Chip smoke test of the PyTorch/CUDA port (``fots_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build every native library of the serving path from the sources in
   this checkout (nvcc for the CUDA kernels, g++ for the host NMS);
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it at batch 16, 704x1280 (f32 and bf16),
   plus odd shapes; then its median time at the serving shape beside the
   plain version's, a library call's where one computes the same
   function, and the least time the card could take (bytes moved over the
   memory rate, or operations over the f32 rate, whichever is larger);
3. the CUDA port against the CPU port (f32, TF32 off for this phase only)
   on one batch of two smoke images at 704x1280 with the shipped snapshot:
   same box count per image, quad corners within 1 px, identical texts;
4. serving at full width: bf16, the snapshot's masked_norm, device
   letterbox, u16 candidates, batch 16 at 704x1280, ``stream`` over 6
   batches with the kernel launch counts zeroed just before; every image
   must yield text, every kernel must have launched; images/s over the
   steady batches on the host clock (PyTorch's default math settings:
   cuDNN may use TF32 for the f32 parts of the FPN).

Then it prints a ``{"kernels": [...]}`` JSON line, an end-to-end JSON
line, the card's name and power limit from nvidia-smi, and last the
``{"ok": true, "device": {...}}`` line.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(REPO, "artifacts", "serving_params.npz")
SMOKE_IMAGES = os.path.join(REPO, "fots_torch", "assets", "smoke_images_u8.npz")
SERVE_HW = (704, 1280)
BATCH = 16
STREAM_BATCHES = 6

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s and f32 (non-tensor-core) flop/s, by card name.
_PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
          ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))


def card_peaks(name: str):
    for key, bw, f32 in _PEAKS:
        if key in name:
            return key, bw, f32
    raise RuntimeError(f"no published peaks recorded for {name!r}")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_median_ms(fn, reps=15, warmup=3):
    """Median device time of ``fn`` over ``reps`` calls, CUDA events
    around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def errors(got, want):
    """(max |got - want|, that over max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    return d, d / max(float(want.float().abs().max()), 1e-30)


def phase_kernels(dev, peaks):
    """Kernels against their plain versions; timings at the serving shape."""
    from fots_torch.ops import instance_norm as tin
    from fots_torch.ops import rroi_align as trr
    from fots_torch.pipeline import FOTSInference

    gen = torch.Generator(device=dev).manual_seed(0)
    H, W = SERVE_HW
    # (h, w, c, affine, slope) of every InstanceNorm of the detector at
    # 704x1280 (stem CReLU-INs, then layer1..layer4 in1/in2/sep1 norms)
    in_shapes = [(H, W, 32, True, 0.01), (H // 2, W // 2, 64, True, 0.01),
                 (H // 4, W // 4, 64, True, 0.0), (H // 4, W // 4, 64, True, None),
                 (H // 8, W // 8, 128, True, 0.0), (H // 8, W // 8, 128, True, None),
                 (H // 16, W // 16, 256, False, 0.01), (H // 16, W // 16, 256, True, 0.01),
                 (H // 16, W // 16, 256, True, None), (H // 32, W // 32, 512, False, 0.01),
                 (H // 32, W // 32, 512, True, 0.01), (H // 32, W // 32, 512, True, None)]
    worst = {"instance_norm": 0.0, "pack_neighbors": 0.0}

    def in_case(b, h, w, c, dtype, affine, slope, valid_w=None):
        x = (torch.randn((b, h, w, c), generator=gen, device=dev) * 3 + 1.5).to(dtype)
        scale = torch.randn(c, generator=gen, device=dev) if affine else None
        bias = torch.randn(c, generator=gen, device=dev) if affine else None
        got = tin.instance_norm(x, scale, bias, 1e-5, slope, valid_w)
        if scale is None:
            scale, bias = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        if valid_w is None:
            want = tin.instance_norm_ref(x, scale, bias, 1e-5, slope)
        else:
            want = tin.masked_instance_norm_ref(x, valid_w, scale, bias, 1e-5, slope)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == x.shape, "instance_norm shape/dtype")
        ab, rel = errors(got, want)
        # f32: sums over up to 0.9 M pixels in another order and the affine
        # folded into x*a + c; bf16: one bf16 ulp (2^-8 relative) plus the
        # f32 slack before the final rounding
        d = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            ok = bool((d <= 1e-4 * (1 + want.float().abs())).all())
        else:
            ok = bool((d <= 2.0 ** -7 * want.float().abs() + 1e-3).all())
        tag = "masked " if valid_w is not None else ""
        print(f"  instance_norm {tag}{str(dtype)[6:]:8s} {(b, h, w, c)} "
              f"affine={affine} slope={slope}: max abs err {ab:.3e} ({rel:.2e} of max |ref|)"
              f"{'' if ok else '  MISS'}")
        check(ok, f"instance_norm {tag}{dtype} {(b, h, w, c)} outside tolerance")
        worst["instance_norm"] = max(worst["instance_norm"], ab)
        del x, got, want, d

    print("phase 2: kernels vs plain versions (tolerance: instance_norm f32 "
          "|err| <= 1e-4 (1 + |ref|), bf16 |err| <= 2^-7 |ref| + 1e-3; "
          "pack_neighbors bit-exact)")
    for dtype in (torch.float32, torch.bfloat16):
        for h, w, c, affine, slope in in_shapes:
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

    for shape, dtype in (((BATCH, H // 4, W // 4, 64), torch.bfloat16),
                         ((BATCH, H // 4, W // 4, 64), torch.float32),
                         ((3, 5, 7, 8), torch.float32), ((2, 3, 5, 24), torch.bfloat16)):
        f = torch.randn(shape, generator=gen, device=dev).to(dtype)
        got = trr.pack_neighbors(f)
        want = trr.pack_neighbors_ref(f)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        ab, _ = errors(got, want)
        print(f"  pack_neighbors {str(dtype)[6:]:8s} {shape}: bit-exact={equal} "
              f"max abs {ab:.3e}")
        check(equal, f"pack_neighbors {dtype} {shape} not bit-exact")
        worst["pack_neighbors"] = max(worst["pack_neighbors"], ab)

    # timings at the serving shape (bf16, as served): layer1's norm and the
    # once-per-batch focr pack
    _, bw, f32_rate = peaks
    x = torch.randn((BATCH, H // 4, W // 4, 64), generator=gen, device=dev).to(torch.bfloat16)
    scale = torch.randn(64, generator=gen, device=dev)
    bias = torch.randn(64, generator=gen, device=dev)
    nbytes = x.numel() * x.element_size()
    x_nchw = x.permute(0, 3, 1, 2)
    rows = {}
    in_bytes = 2 * nbytes                 # read x once, write y once
    in_ops = 6 * x.numel()                # sum, sumsq, fma, leaky
    rows["instance_norm"] = dict(
        ms=cuda_median_ms(lambda: tin.instance_norm_cuda(x, scale, bias, 1e-5, 0.0)),
        plain_ms=cuda_median_ms(lambda: tin.instance_norm_ref(x, scale, bias, 1e-5, 0.0)),
        library_ms=cuda_median_ms(lambda: torch.nn.functional.instance_norm(
            x_nchw, weight=scale.to(x.dtype), bias=bias.to(x.dtype), eps=1e-5)),
        bound=(in_bytes / bw, in_ops / f32_rate), shape=tuple(x.shape))
    pk_bytes = nbytes + 4 * nbytes        # read the map once, write 4x
    rows["pack_neighbors"] = dict(
        ms=cuda_median_ms(lambda: trr.pack_neighbors_cuda(x)),
        plain_ms=cuda_median_ms(lambda: trr.pack_neighbors_ref(x)),
        library_ms=None, bound=(pk_bytes / bw, 0.0), shape=tuple(x.shape))
    for name, r in rows.items():
        print(f"  {name} at {r['shape']} bf16: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{1e3 * max(r['bound']):.4f} ms")
    return worst, rows


def phase_cuda_vs_cpu(images):
    """f32 CUDA port against the f32 CPU port on one batch of two images."""
    from fots_torch.checkpoint import load_detector
    from fots_torch.pipeline import FOTSInference

    print(f"phase 3: CUDA port vs CPU port, f32 (TF32 off), 2 images at {SERVE_HW}")
    results = {}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ("cuda", "cpu"):
            model, _, config = load_detector(SNAPSHOT, device)
            with FOTSInference(model, masked_norm=config.get("masked_norm", False),
                               device=device) as eng:
                t0 = time.perf_counter()
                results[device] = eng.batch_call(list(images[:2]), serve_hw=SERVE_HW)
                print(f"  {device}: {time.perf_counter() - t0:.2f} s, boxes "
                      f"{[len(r) for r in results[device]]}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
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


def phase_serving(images):
    """bf16 serving at batch 16, 704x1280; the main path for the counts."""
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
        launches = dict(build.launch_counts)
    check(len(outs) == STREAM_BATCHES, "stream lost batches")
    for res in outs:
        check(len(res) == BATCH and all(len(r) > 0 for r in res),
              "an image of the serving batch yielded no text")
        for r in res:
            for e in r:
                check(np.isfinite(e["box"]).all() and 0.0 < e["conf"] <= 1.0,
                      "non-finite box or confidence out of range")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    steady = (STREAM_BATCHES - 1) * BATCH / (stamps[-1] - stamps[0])
    print(f"  snapshot step {step}, config {config}; texts of image 0: "
          f"{[e['text'] for e in outs[-1][0]]}")
    print(f"  launches {launches} over {STREAM_BATCHES} batches; "
          f"{steady:.2f} images/s over batches 2..{STREAM_BATCHES}")
    return launches, steady


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fots_torch.kernels import build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"device {name}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; peaks assumed for "
          f"{peaks[0]}: {peaks[1] / 1e12} TB/s, {peaks[2] / 1e12} TFLOP/s f32")

    t0 = time.perf_counter()
    logs = build.build()
    print(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for lib, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or line.startswith("["):
                print(f"  {lib}: {line.strip()}")

    worst, rows = phase_kernels(dev, peaks)
    with np.load(SMOKE_IMAGES) as z:
        images = list(z["images"])
    corner = phase_cuda_vs_cpu(images)
    launches, ips = phase_serving(images)

    kernels = []
    meta = {"instance_norm": ("fots_torch/csrc/instance_norm.cu",
                              "fots/ops/instance_norm.py:126"),
            "pack_neighbors": ("fots_torch/csrc/pack_neighbors.cu",
                               "fots/ops/rroi_align.py:304")}
    for kname, (source, replaces) in meta.items():
        r = rows[kname]
        by_bytes, by_ops = r["bound"]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": worst[kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": r["library_ms"], "shape": list(r["shape"]), "dtype": "bf16",
            "launches_per_batch": launches[kname] / STREAM_BATCHES,
        })
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"e2e": {"images_per_s": ips, "batch": BATCH,
                              "serve_hw": list(SERVE_HW), "dtype": "bf16",
                              "batches": STREAM_BATCHES,
                              "cuda_vs_cpu_max_corner_px": corner}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
