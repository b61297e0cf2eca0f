"""Build the port's native code at first use and load it with ctypes.

CUDA kernels (``fots_torch/csrc/*.cu``) compile with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface; the host NMS
(``csrc/nms_core.cpp``) and the image decoder and encoder
(``csrc/image_decode.cpp``, ``csrc/image_encode.cpp``) compile with ``g++``.  Outputs go to
``build/fots_torch/`` beside the package, named by a hash of the source,
the shared headers and the flags, so an edited source rebuilds and an
unchanged one is reused.  Builds start together (one compiler process per source) and a
finished library is moved into place atomically, so concurrent processes
never load a half-written file.

No PyTorch headers are compiled (``torch.utils.cpp_extension`` would need
``ninja`` and minutes per build): the Python wrappers pass
``tensor.data_ptr()``, sizes and ``torch.cuda.current_stream().cuda_stream``.
This module imports torch only inside the helpers that take tensors, so the
data readers (numpy-only processes) can load the host libraries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "fots_torch")

#: library name -> source under csrc/
SOURCES = {
    "instance_norm": "instance_norm.cu",
    "instance_norm_bwd": "instance_norm_bwd.cu",
    "spatial_norm": "spatial_norm.cu",
    "pack_neighbors": "pack_neighbors.cu",
    "fused_block": "fused_block.cu",
    "nms_core": "nms_core.cpp",
    "image_decode": "image_decode.cpp",
    "image_encode": "image_encode.cpp",
    "decode_bmp": "decode_bmp.cpp",
    "decode_gif": "decode_gif.cpp",
    "decode_tiff": "decode_tiff.cpp",
    "decode_webp": "decode_webp.cpp",
    "decode_fax": "decode_fax.cpp",
    "decode_sunras": "decode_sunras.cpp",
    "decode_hdr": "decode_hdr.cpp",
    "decode_jp2": "decode_jp2.cpp",
}
#: headers the CUDA sources include (hashed into every CUDA library's name)
CUDA_HEADERS = ("common.cuh", "cluster.cuh")

#: CUDA kernel -> the library that holds it
CUDA_KERNELS = {
    "instance_norm": "instance_norm",          # K1'
    "instance_norm_bwd": "instance_norm_bwd",  # K1'-bwd
    "spatial_stats": "spatial_norm",           # K2'
    "spatial_norm": "spatial_norm",            # K3'
    "pack_neighbors": "pack_neighbors",        # K4'
    "pack_neighbors_bwd": "pack_neighbors",    # K4'-bwd
    "fused_block": "fused_block",              # K5'
}
#: the kernels each main path launches (serving, the exported bundle and
#: evaluation: inference; training: forward and backward of the joint step;
#: ocr: the recognition-only trainers and their evaluation, whose gradients
#: never reach an image, so no K4'-bwd; fused_block: K5's own profiling
#: entry, the only path that runs it, as in the JAX package)
_SERVING = ("instance_norm", "spatial_stats", "spatial_norm", "pack_neighbors")
PATH_KERNELS = {
    "serving": _SERVING,
    "export": _SERVING,
    "evaluation": _SERVING,
    "training": _SERVING + ("instance_norm_bwd", "pack_neighbors_bwd"),
    "ocr": _SERVING + ("instance_norm_bwd",),
    "fused_block": ("fused_block",),
}

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

#: launches of each CUDA kernel wrapper in this process (one per launch of
#: its kernel; never incremented by the plain versions)
launch_counts: Dict[str, int] = {name: 0 for name in CUDA_KERNELS}
#: of those, the launches of the two instance-norm kernels by route
#: ("<kernel>/cluster": one kernel, each tensor crosses device memory once;
#: "<kernel>/two_pass": statistics kernel, then apply kernel)
route_counts: Dict[str, int] = {f"{name}/{route}": 0
                                for name in ("instance_norm", "instance_norm_bwd")
                                for route in ("cluster", "two_pass")}

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin: the CUDA kernels cannot be built")
    return path


def _compile_command(name: str, out: str) -> list:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS, "-o", out, src]
    return [shutil.which("g++") or "g++", *GXX_FLAGS, "-o", out, src]


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    cuda = src.endswith(".cu")
    flags = NVCC_FLAGS if cuda else GXX_FLAGS
    h = hashlib.sha256()
    for path in [src] + ([os.path.join(CSRC_DIR, n) for n in CUDA_HEADERS] if cuda else []):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, all compilers running at once.  Returns the compiler output of each
    library built now; raises with that output if a compile fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(_compile_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs.append((name, out, tmp, proc, time.perf_counter()))
    logs = {}
    for name, out, tmp, proc, t0 in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCES[name]} failed "
                               f"(exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)
        logs[name] = f"[{time.perf_counter() - t0:.1f} s] {text}"
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed (thread-safe:
    the NMS pool's threads may ask for the same library at once)."""
    with _load_lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(library_path(name))
        return _loaded[name]


def check_kernel_input(x, what: str, dtypes) -> None:
    """What every CUDA launcher requires of its main input: a CUDA tensor
    of an accepted dtype, contiguous in the layout the kernel indexes (NHWC
    for the 4-D activations), and no autograd recording (a launcher's
    output has no ``grad_fn``: differentiable callers go through the op's
    ``torch.autograd.Function``)."""
    import torch

    if x.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {x.dtype} not in {tuple(dtypes)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous NHWC (a "
                         "channels_last NCHW tensor viewed with "
                         "permute(0, 2, 3, 1)); got strides "
                         f"{tuple(x.stride())} for shape {tuple(x.shape)}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{what}: the raw launcher does not record autograd; "
                           "call the op's differentiable entry point")


def current_stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def num_sms(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
