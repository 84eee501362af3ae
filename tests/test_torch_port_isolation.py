"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to run quietly on the CPU, and its
kernels never fall back to their plain versions."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

import duoformer_tcga_tpu_torch as port
from duoformer_tcga_tpu_torch.ops import _build
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import nn as tnn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax():
    code = textwrap.dedent("""
        import pkgutil, importlib, sys
        import duoformer_tcga_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "duoformer_tcga_tpu"
                     or m.startswith("duoformer_tcga_tpu."))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 15 else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_point_needs_a_device_choice_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.build_model_no_extra_params()
    with pytest.raises(RuntimeError):
        port.build_model_no_extra_params(device="cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.load_library("attention_sm90")
    with pytest.raises(_build.KernelBuildError):
        _build.build_all()


def test_wrappers_refuse_devices_without_a_kernel():
    """Only a CPU tensor reaches the plain version; any other device
    launches the kernel or raises, and counts nothing."""
    fa.reset_launch_counts()
    x = torch.empty(2, 6, 128, device="meta")
    v = torch.empty(128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.fused_attention_residual(x, v, v, x, v, x, v, 2, 6, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        fa.fused_mlp_residual(x, v, v, x, v, x, v)
    with pytest.raises(ValueError, match="no kernel"):
        fa.fused_attention_residual_bwd(x, x, v, v, x, v, x, 2, 6, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        fa.mlp_dz(x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        fa.fused_attention_residual_bwd(x, x, v, v, x, v, x, 2, 6, 0.125,
                                        dw=True)
    with pytest.raises(ValueError, match="no kernel"):
        fa.fused_mlp_bwd(x, x, v, v, x, v, x)
    with pytest.raises(ValueError, match="no kernel"):
        fa.block_diag_attention_fwd(x, 2, 6, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        tnn._fused_layernorm_fwd(x, v, v, 1e-6)
    with pytest.raises(ValueError, match="no kernel"):
        fa.attention_core_long(x, v, v, x, v, 2, 6, 0.125)
    assert sum(fa.launch_counts.values()) == 0


def test_plain_path_counts_no_launch():
    fa.reset_launch_counts()
    C = 128
    x = torch.randn(3, 6, C)
    z = torch.zeros(C)
    fa.fused_attention_residual(x, z, z, torch.zeros(C, 3 * C),
                                torch.zeros(3 * C), torch.zeros(C, C), z,
                                2, 6, 0.125)
    fa.fused_attention_residual_bwd(x, x, z, z, torch.zeros(C, 3 * C),
                                    torch.zeros(3 * C), torch.zeros(C, C),
                                    2, 6, 0.125)
    fa.mlp_dz(x.reshape(-1, C), torch.zeros(18, 256), torch.zeros(256, C))
    assert sum(fa.launch_counts.values()) == 0
