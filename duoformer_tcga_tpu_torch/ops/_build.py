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
KERNELS = ("attention_bwd_sm90", "fused_mlp_residual", "mlp_dz",
           "fused_attention_residual_int8", "fused_mlp_residual_int8",
           "drop_ew", "fused_mlp_bwd", "layernorm", "attention_sm90",
           "fused_attention_residual_int8_s86",
           "fused_attention_residual_bwd_s86", "attention_long",
           "fused_attention_residual_f32", "fused_mlp_residual_f32",
           "fused_attention_residual_bwd_f32", "mlp_dz_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_entries: dict = {}

# Launches of each kernel form since the last reset (ops/fused_attention.
# reset_launch_counts); a wrapper adds one where it launches its kernel and
# nowhere else.
launch_counts: collections.Counter = collections.Counter()


def count_launch(name: str, C: int):
    """One launch of form `name` at width C; a launch of a kernel's
    384-wide instantiation (ViT-S) counts under name + "_c384", so a run
    shows that the path went through that form."""
    launch_counts[name + ("_c384" if C == 384 else "")] += 1


# float32 on the card (ROADMAP B5a): the forms with a float32 kernel
# (csrc/*_f32.cu), the release model's default routes, at up to
# F32_MAX_SEG_LEN tokens a segment and the widths F32_C
F32_FORMS = ("fused_attention_residual", "fused_mlp_residual",
             "fused_mlp_residual_z", "fused_attention_residual_bwd",
             "mlp_dz")
F32_MAX_SEG_LEN = 64
F32_C = (256, 512, 768)


def f32_form(what: str, seg_len: int = 1, C: int = 768, reg: bool = False,
             dw: bool = False) -> str:
    """The launch name of form `what`'s float32 kernel (what + "_f32"), or
    NotImplementedError naming ROADMAP B5a where a float32 tensor on the
    card reaches a form that has none: a form outside F32_FORMS (the lean
    route's fused_mlp_bwd and fused_layernorm, block_diag_attention, the
    65..197-token launches), seg_len past F32_MAX_SEG_LEN, the reg flags
    (LayerScale, dropout), the backward's dw form, or C outside F32_C.
    Nothing falls back to a plain version. Takes no tensor."""
    if what not in F32_FORMS:
        why = "has no float32 form"
    elif reg:
        why = "has no float32 form with the reg flags (LayerScale, dropout)"
    elif dw:
        why = "has no float32 form of its dw route (attn_bwd_dw)"
    elif seg_len > F32_MAX_SEG_LEN:
        why = (f"has no float32 form at seg_len {seg_len} > "
               f"{F32_MAX_SEG_LEN}")
    elif C not in F32_C:
        why = f"has no float32 form at C={C} (only C in {F32_C})"
    else:
        return what + "_f32"
    raise NotImplementedError(
        f"{what} {why} on the card: float32 kernels exist for the release "
        f"model's default routes only (ROADMAP B5a)")


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


def entry(name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """The C function fn_name of kernel library `name`, the library built
    and loaded and the signature bound at the first call; every later call
    is one dictionary lookup, with no lock and no rebinding, so a launch's
    host path is the ctypes call alone."""
    fn = _entries.get((name, fn_name))
    if fn is None:
        fn = getattr(load_library(name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _entries[(name, fn_name)] = fn
    return fn


def call_on(device, fn, *args):
    """fn(*args) with `device` the current CUDA device, entering
    torch.cuda.device only where another one is current."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def check(lib, status: int, what: str):
    """Raise when a launch returned a CUDA error (its cudaGetLastError);
    lib: the kernel library or its name."""
    if status != 0:
        if isinstance(lib, str):
            lib = load_library(lib)
        msg = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_tensor(name, t, device, dtype, shape):
    if (t.dtype is dtype and t.shape == shape and t.device == device
            and t.is_contiguous() and t.data_ptr() % 32 == 0):
        return   # the common case, at a third of the checks' host time
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
    # the raw handle, without building a torch.cuda.Stream (~7 us a call)
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(device.index))
