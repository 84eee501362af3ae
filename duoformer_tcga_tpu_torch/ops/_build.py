"""Build and load the port's CUDA kernels, and the helpers their ctypes
wrappers share (argument checks, pointers, the stream, the launch counts).

Each `csrc/<name>.cu` is one kernel source with a plain C interface (the
device helpers they share are in `csrc/*.cuh`).
At first use it is compiled with nvcc for sm_90a into a shared library
under `duoformer_tcga_tpu_torch/_build/` (listed in .gitignore) and
loaded with ctypes. The library name carries a hash of the sources,
headers and flags, so an edited source is never served by a stale build.

A missing nvcc or a failed build raises KernelBuildError: nothing here
falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("fused_attention_residual", "fused_attention_residual_bwd",
           "fused_mlp_residual", "mlp_dz", "fused_attention_residual_int8",
           "fused_mlp_residual_int8", "drop_ew", "fused_mlp_bwd",
           "layernorm", "block_diag_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}

# Launches of each kernel form since the last reset (ops/fused_attention.
# reset_launch_counts); a wrapper adds one where it launches its kernel and
# nowhere else.
launch_counts: collections.Counter = collections.Counter()


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """-> (Popen, tmp path, final path), or None when already built."""
    out = _library_path(name)
    if out.exists():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=KERNELS) -> dict:
    """Compile every named kernel with one nvcc each, all started
    together. -> {name: nvcc output (ptxas register/smem report)}."""
    with _lock:
        jobs = {n: _start_build(n) for n in names}
        return {n: _finish_build(n, j) if j else "(already built)"
                for n, j in jobs.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(_library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str):
    """Raise when a launch returned a CUDA error (its cudaGetLastError)."""
    if status != 0:
        msg = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_tensor(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    # the kernels copy rows in 16-byte cp.async chunks from aligned starts
    _require(t.data_ptr() % 32 == 0, f"{name} must be 32-byte aligned")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
