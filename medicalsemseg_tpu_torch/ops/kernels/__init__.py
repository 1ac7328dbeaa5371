"""Build and load the port's hand-written CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of the package (one
process per source, side by side) and links them into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds),
which is loaded with ``ctypes``. The library's name carries
a hash of the sources, so an edited source is rebuilt and a stale library is
never loaded. The build directory is ``build/kernels`` at the root of the
checkout (listed in ``.gitignore``).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises if that is not 0, because a
refused launch never runs and a later synchronise would not report it.
Every wrapper counts its launches in one registry (:func:`count_launch`,
read by :func:`launches` and :func:`routes`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import threading
from collections.abc import Mapping
from typing import Dict, Optional, Tuple

from medicalsemseg_tpu_torch.utils import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# token rows per tile of the backward kernels (kTile in csrc/common.cuh)
TILE_ROWS = 32
# dynamic shared memory a block may ask for on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448
# the routes of the kernels that have two (K1, K3, K6 heads launches and
# GEMM launches; K2, K4, K7, K9, K10), with their codes in the C entry points
# (kRouteCudaCore, kRouteTensorCore in csrc/mma_tile.cuh)
ROUTES = {"cuda_core": 0, "tensor_core": 1}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

# -- the launch registry: every launch of a kernel, counted by kernel ("K1"
# to "K11"), launch and route. K1, K3 and K6 make two launches a call,
# "heads" and "gemm" (the projection; K3's dx and dw); K8 "forward" (its
# sums) and "backward" (dlogits); K11 "forward" (its statistics, merge and
# apply launches, or the statistics alone) and "backward" (its three
# launches); the others one: "backward" for K4 and K5, "forward" for the
# rest (K9 and K10 also where the same launch computes an input gradient).
# K8 and K11 have the one route "cuda_core".
_launches: Dict[Tuple[str, str, str], int] = {}


def count_launch(kernel: str, launch: str, route: str) -> None:
    """Count one launch, and name its route on the kernel wrapper's span
    (``route``; ``gemm_route`` for a "gemm" launch) while tracing."""
    key = (kernel, launch, route)
    _launches[key] = _launches.get(key, 0) + 1
    if profiling.tracing():
        profiling.tag("gemm_route" if launch == "gemm" else "route", route)


def launches(kernel: Optional[str] = None, launch: Optional[str] = None,
             route: Optional[str] = None) -> int:
    """Launches counted since the process started (or since
    :func:`reset_launches`), summed over every key that matches the ones
    given."""
    return sum(n for (k, la, r), n in list(_launches.items())
               if kernel in (None, k) and launch in (None, la)
               and route in (None, r))


def routes(kernel: str, launch: Optional[str] = None) -> Dict[str, int]:
    """{route: launches} of a kernel (and launch)."""
    return {r: launches(kernel, launch, r) for r in ROUTES}


def reset_launches() -> None:
    _launches.clear()


class RouteCounts(Mapping):
    """A read-only view {route: launches} of one kernel's launch in the
    registry."""

    def __init__(self, kernel: str, launch: str):
        self.kernel, self.launch = kernel, launch

    def __getitem__(self, route: str) -> int:
        if route not in ROUTES:
            raise KeyError(route)
        return launches(self.kernel, self.launch, route)

    def __iter__(self):
        return iter(ROUTES)

    def __len__(self) -> int:
        return len(ROUTES)


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmedseg_kernels_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, path)  # atomic: a concurrent loader never sees half a file


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.medseg_window_attention_fwd.argtypes = (
        [p] * 10 + [i] * 19 + [f, f, p])
    lib.medseg_window_attention_fwd.restype = i
    lib.medseg_global_window_attention_fwd.argtypes = (
        [p] * 11 + [i] * 10 + [f, f, p])
    lib.medseg_global_window_attention_fwd.restype = i
    lib.medseg_sr_attention_fwd.argtypes = [p] * 9 + [i] * 10 + [f, p]
    lib.medseg_sr_attention_fwd.restype = i
    lib.medseg_sr_attention_smem_bytes.argtypes = [i] * 4
    lib.medseg_sr_attention_smem_bytes.restype = ll
    lib.medseg_fused_mlp_fwd.argtypes = [p] * 8 + [i] * 9 + [f, p]
    lib.medseg_fused_mlp_fwd.restype = i
    lib.medseg_window_attention_bwd.argtypes = [p] * 19 + [i] * 21 + [f, f, p]
    lib.medseg_window_attention_bwd.restype = i
    lib.medseg_fused_mlp_bwd.argtypes = [p] * 12 + [i] * 9 + [f, p]
    lib.medseg_fused_mlp_bwd.restype = i
    lib.medseg_dw27.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.medseg_dw27.restype = i
    lib.medseg_winograd_f23.argtypes = [p] * 4 + [i] * 9 + [f, i, i, p]
    lib.medseg_winograd_f23.restype = i
    lib.medseg_conv3x3x3.argtypes = [p] * 3 + [i] * 10 + [p]
    lib.medseg_conv3x3x3.restype = i
    lib.medseg_dice_ce_sums.argtypes = [p] * 4 + [i, ll, i, i, i, p]
    lib.medseg_dice_ce_sums.restype = i
    lib.medseg_dice_ce_dlogits.argtypes = [p] * 6 + [i, ll, i, i, p]
    lib.medseg_dice_ce_dlogits.restype = i
    lib.medseg_instance_norm_fwd.argtypes = (
        [p] * 9 + [i, i, ll, i, i, i, i, i, f, p])
    lib.medseg_instance_norm_fwd.restype = i
    lib.medseg_instance_norm_bwd.argtypes = (
        [p] * 13 + [i, i, ll, i, i, i, i, i, p])
    lib.medseg_instance_norm_bwd.restype = i
    lib.medseg_cuda_error_string.argtypes = [i]
    lib.medseg_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.medseg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    """The current stream of ``device`` as an address (the ``c_void_p``
    argtypes rows pass a plain int as a pointer)."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def pick_route(route: Optional[str], auto: str, what: str) -> str:
    """``route`` if given, else ``auto``, the route the kernel's picker
    gives this dtype and shape (``what``); the tensor cores can be asked
    for only where the picker gives them."""
    if route is None:
        return auto
    if route not in ROUTES or (route == "tensor_core" and auto != route):
        raise ValueError(f"route {route!r} does not take {what}")
    return route


def sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def resident_blocks(device) -> int:
    """Blocks that a launch with per-block partial sums spreads its tiles
    over: four per SM, enough to fill the card while the partials stay few."""
    return 4 * sm_count(device)


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor as an int (a ``c_void_p`` argtypes row
    passes it as a pointer), or None (NULL) for None."""
    return None if t is None else t.data_ptr()


def dtype_code(name, dtype) -> int:
    """The dtype argument of the kernels that take their activations' dtype
    (K1-K4, K6, K7: kBf16, kF16, kF32 in csrc/common.cuh); raises for any
    other dtype."""
    import torch

    codes = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
    if dtype not in codes:
        raise ValueError(f"{name} is {dtype}, the kernel takes bfloat16, "
                         "float16 or float32")
    return codes[dtype]


def check_tensor(name, t, device, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of this device, dtype and
    shape: the kernels take raw pointers and trust all four."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def tensor_core_dtype(dtype) -> bool:
    """Whether the tensor-core routes take this dtype: bf16 and fp16."""
    import torch

    return dtype in (torch.bfloat16, torch.float16)


def check_aligned(**tensors) -> None:
    """The tensor-core kernels copy rows in 16-byte pieces: raise unless
    every tensor starts on a 16-byte boundary."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} does not start on a 16-byte boundary")


def layer_norm(xf, ln, eps: float):
    """fp32 LayerNorm of ``xf`` (..., C) with (2, C) scale/bias rows and the
    fast variance max(0, E[x^2] - E[x]^2), flax.linen.LayerNorm's formula
    (``torch.nn.LayerNorm``'s two-pass variance does not reproduce it)."""
    import torch

    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (xf - mu) * (torch.rsqrt(var + eps) * ln[0]) + ln[1]
