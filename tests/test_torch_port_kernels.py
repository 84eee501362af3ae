"""The PyTorch port's kernel-bearing entries and ops against the JAX
package, on the CPU in float32.

The port's fused entries run their plain versions here (CPU tensors);
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_attention.py does. Inputs come from numpy and go to
both sides unchanged. Bars: 3e-5 for the fused entries and the regroup
(the bar of test_pallas_attention.py:90), 1e-5 for single ops.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from duoformer_tcga_tpu.models import regroup as jregroup
from duoformer_tcga_tpu.ops import attention as jattn
from duoformer_tcga_tpu.ops import nn as jnn
from duoformer_tcga_tpu.ops import pallas_attention as pa

from duoformer_tcga_tpu_torch.models import regroup as tregroup
from duoformer_tcga_tpu_torch.ops import attention as tattn
from duoformer_tcga_tpu_torch.ops import fused_attention as fa
from duoformer_tcga_tpu_torch.ops import nn as tnn

from torch_port_shared import shared_jax_compiles  # noqa: F401 (autouse)

TOL = dict(atol=3e-5, rtol=3e-5)


def _randn(rng, *shape, std=1.0, mean=0.0):
    return (rng.standard_normal(shape) * std + mean).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("n_seg,S,C,H,use_ln,use_residual", [
    (98, 6, 128, 2, True, True),       # ScaleBlock form, ragged TPU tiles
    (4, 50, 128, 2, False, False),     # PatchBlock bare form
    (13, 6, 128, 2, True, True),       # odd segment count
])
def test_fused_attention_residual_matches_pallas(n_seg, S, C, H, use_ln,
                                                 use_residual):
    rng = np.random.default_rng(0)
    x = _randn(rng, n_seg, S, C)
    if use_ln:
        lns, lnb = _randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1)
    else:
        lns, lnb = np.zeros(C, np.float32), np.zeros(C, np.float32)
    arrays = (x, lns, lnb, _randn(rng, C, 3 * C, std=0.02),
              _randn(rng, 3 * C, std=0.01), _randn(rng, C, C, std=0.02),
              _randn(rng, C, std=0.01))
    scale = (C // H) ** -0.5
    ref = pa.fused_attention_residual(*_j(*arrays), H, S, scale, 1e-6,
                                      use_ln, use_residual)
    out = fa.fused_attention_residual(*_t(*arrays), H, S, scale, 1e-6,
                                      use_ln, use_residual)
    _close(out, ref)


def test_fused_mlp_residual_matches_pallas():
    rng = np.random.default_rng(1)
    C, hidden = 128, 512
    arrays = (_randn(rng, 37, 6, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, hidden, std=0.02),
              _randn(rng, hidden, std=0.01), _randn(rng, hidden, C, std=0.02),
              _randn(rng, C, std=0.01))
    ref = pa.fused_mlp_residual(*_j(*arrays), 1e-6)
    out = fa.fused_mlp_residual(*_t(*arrays), 1e-6)
    _close(out, ref)


@pytest.mark.parametrize("rows, C, hidden", [
    (1, 256, 1024), (222, 768, 3072), (3200, 384, 1536),
    (18816, 768, 3072), (26113, 768, 3072), (37632, 768, 3072),
    (269696, 768, 3072), (539392, 768, 3072)])
def test_mlp_row_chunks_tile_the_rows_within_the_scratch(rows, C, hidden):
    """The card's MLP wrapper runs its kernels over these chunks: they tile
    [0, rows) in order from global first rows (the dropout masks count from
    them), each chunk's LN scratch (rows rounded up to the row tile) and
    hidden scratch fit in MLP_SCRATCH_BYTES, and there are no more chunks
    than that bound forces."""
    chunks = fa.mlp_row_chunks(rows, C, hidden)
    starts = [r0 for r0, _ in chunks]
    assert starts == list(itertools.accumulate(
        [0] + [n for _, n in chunks[:-1]]))
    assert sum(n for _, n in chunks) == rows and all(n > 0 for _, n in chunks)
    tile = fa.MLP_ROW_TILE
    for _, n in chunks:
        ln_rows = -(-n // tile) * tile
        assert 2 * (ln_rows * C + n * hidden) <= fa.MLP_SCRATCH_BYTES
    assert all(n % tile == 0 for _, n in chunks[:-1])
    most = fa.MLP_SCRATCH_BYTES // (2 * (C + hidden)) // tile * tile
    assert len(chunks) == -(-rows // most)


@pytest.mark.parametrize("rows, C, hidden", [
    (1, 256, 1024), (222, 768, 3072), (3200, 384, 1536),
    (18816, 768, 3072), (26113, 768, 3072), (37632, 768, 3072),
    (269696, 768, 3072), (539392, 768, 3072)])
def test_mlp_bwd_row_chunks_tile_the_rows_within_the_scratch(rows, C,
                                                             hidden):
    """The card's recompute-from-x MLP backward runs its chain over these
    chunks (csrc/fused_mlp_bwd.cu): they tile [0, rows) in order, every
    chunk but the last a multiple of the row tile and of one size, each
    chunk's float32 scratch (dln, the LN statistics, the partial rows)
    within MLP_BWD_SCRATCH_BYTES whatever the hidden width, and there are
    no more chunks than that bound forces."""
    chunks = fa.mlp_bwd_row_chunks(rows, C)
    starts = [r0 for r0, _ in chunks]
    assert starts == list(itertools.accumulate(
        [0] + [n for _, n in chunks[:-1]]))
    assert sum(n for _, n in chunks) == rows and all(n > 0 for _, n in chunks)
    tile = fa.MLP_ROW_TILE
    assert all(n % tile == 0 for _, n in chunks[:-1])
    assert len({n for _, n in chunks[:-1]}) <= 1
    assert chunks[-1][1] <= chunks[0][1]
    for _, n in chunks:
        assert fa.mlp_bwd_scratch_bytes(n, C) <= fa.MLP_BWD_SCRATCH_BYTES
    most = tile                # the most rows, in whole tiles, a chunk holds
    while most < rows and fa.mlp_bwd_scratch_bytes(
            most + tile, C) <= fa.MLP_BWD_SCRATCH_BYTES:
        most += tile
    assert len(chunks) == -(-rows // most)
    # L4's 539,392 rows never take a float32 dln of the whole call
    assert 4 * chunks[0][1] * C <= fa.MLP_BWD_SCRATCH_BYTES


def test_mlp_bwd_scratch_bytes_counts_each_piece():
    """The scratch of a chunk of 130 rows at C=256: dln in float32, the LN
    statistics, the LN backward's partial rows (3 blocks of 64 rows, 3C
    floats each), each rounded up to 256 bytes, as csrc/fused_mlp_bwd.cu
    carves them."""
    pieces = [4 * 130 * 256, 8 * 130, 4 * 3 * 3 * 256]
    assert fa.mlp_bwd_scratch_bytes(130, 256) == sum(
        -(-n // 256) * 256 for n in pieces)


@pytest.mark.parametrize("n_seg, S, C, use_ln", [
    (1, 65, 512, True), (7, 86, 768, True), (1001, 86, 768, True),
    (3136, 86, 768, True), (3136, 86, 768, False), (6272, 86, 256, True),
    (1, 197, 512, True), (64, 197, 768, True), (128, 197, 768, False),
    (1024, 197, 768, True), (5, 87, 256, False),
    (3136, 6, 768, True), (6272, 6, 768, True), (6273, 6, 768, True),
    (3136, 22, 768, True), (6272, 22, 768, False), (64, 50, 768, False),
    (128, 50, 384, True)])
def test_attention_seg_chunks_tile_the_segments_within_the_scratch(
        n_seg, S, C, use_ln):
    """The card's attention core runs its chain over these chunks: whole
    segments tiling [0, n_seg) in order, each chunk's first
    global token its first segment times S (the attention dropout's masks
    count from it), each chunk's LN and qkv scratch within
    ATTN_SCRATCH_BYTES, equal chunks but the last, and no more chunks than
    that bound forces."""
    chunks = fa.attention_seg_chunks(n_seg, S, C, use_ln)
    starts = [s0 for s0, _ in chunks]
    assert starts == list(itertools.accumulate(
        [0] + [n for _, n in chunks[:-1]]))
    assert sum(n for _, n in chunks) == n_seg and all(n > 0 for _, n in chunks)
    assert [s0 * S for s0 in starts] == [
        sum(n * S for _, n in chunks[:i]) for i in range(len(chunks))]
    for _, n in chunks:
        ln_rows = -(-n * S // fa.MLP_ROW_TILE) * fa.MLP_ROW_TILE
        want = 2 * ((ln_rows if use_ln else 0) * C + n * S * 3 * C)
        assert fa.attention_scratch_bytes(n * S, C, use_ln) == want
        assert want <= fa.ATTN_SCRATCH_BYTES
    assert len({n for _, n in chunks[:-1]}) <= 1
    assert chunks[-1][1] <= chunks[0][1]
    most = max(m for m in range(1, n_seg + 1) if fa.attention_scratch_bytes(
        m * S, C, use_ln) <= fa.ATTN_SCRATCH_BYTES)
    assert len(chunks) == -(-n_seg // most)


@pytest.mark.parametrize("n_seg, S, C, use_ln", [
    (13, 6, 768, True), (6272, 6, 768, True), (6273, 6, 768, True),
    (3136, 22, 768, True), (6272, 22, 768, False), (64, 50, 768, False),
    (130, 1, 256, True), (5, 21, 512, True), (3, 64, 512, True),
    (7, 86, 768, True)])
def test_attention_seg_plan_packs_whole_segments_within_each_chunk(
        n_seg, S, C, use_ln):
    """The core's units up to 64 tokens take G = 64 // S whole segments in
    one 64-row strip (one segment past 64 tokens), grouped from each
    chunk's first segment as csrc/attention_sm90.cu walks them (group k:
    the chunk's segments [k G, min(k G + G, n))): the groups tile the
    chunk's segments in order, hold G segments but the chunk's last
    (1..G), never span two chunks, and only the last chunk ends short
    (the chunks but the last hold whole groups)."""
    plan = fa.attention_seg_plan(n_seg, S, C, use_ln)
    assert [(s0, n) for s0, n, _ in plan] == fa.attention_seg_chunks(
        n_seg, S, C, use_ln)
    for i, (s0, n, G) in enumerate(plan):
        assert G == fa.unit_segments(S) == (64 // S if S <= 64 else 1)
        assert G * S <= 64 or G == 1
        groups = [(s0 + g0, min(G, n - g0)) for g0 in range(0, n, G)]
        firsts = [g0 for g0, _ in groups]
        assert firsts == list(itertools.accumulate(
            [s0] + [k for _, k in groups[:-1]]))
        assert sum(k for _, k in groups) == n
        assert all(k == G for _, k in groups[:-1])
        assert 1 <= groups[-1][1] <= G
        assert groups[-1][0] + groups[-1][1] == s0 + n
        if i < len(plan) - 1:
            assert n % G == 0


@pytest.mark.parametrize("S", [1, 6, 21, 22, 50, 64, 65, 86, 87, 197])
@pytest.mark.parametrize("C", [256, 384, 768])
def test_attention_bwd_seg_chunks_tile_whole_groups_within_the_scratch(S, C):
    """The card's backward runs its chain over these chunks
    (csrc/attention_bwd_sm90.cu, at 1..197 tokens): whole segments tiling
    [0, n_seg) in order from global first segments (the dropout masks
    count from them), every chunk but the last a multiple of G =
    unit_segments(S) (64 // S up to 64 tokens, so a unit's group never
    spans two chunks; 1 past), equal chunks but the last, each chunk's
    scratch within ATTN_BWD_SCRATCH_BYTES for dw False and True, inert and
    reg, and no more chunks than that bound forces."""
    G = fa.unit_segments(S)
    for n_seg in (1, G + 1, 6273):
        for dw, use_ln, reg in itertools.product((False, True), repeat=3):
            flags = dict(dw=dw, use_ln=use_ln, geff=reg, gm=reg and dw)
            chunks = fa.attention_bwd_seg_chunks(n_seg, S, C, **flags)
            starts = [s0 for s0, _ in chunks]
            assert starts == list(itertools.accumulate(
                [0] + [n for _, n in chunks[:-1]]))
            assert sum(n for _, n in chunks) == n_seg
            assert all(n > 0 for _, n in chunks)
            assert all(n % G == 0 for _, n in chunks[:-1])
            assert len({n for _, n in chunks[:-1]}) <= 1
            assert chunks[-1][1] <= chunks[0][1]
            for _, n in chunks:
                assert fa.attention_bwd_scratch_bytes(
                    n, S, C, **flags) <= fa.ATTN_BWD_SCRATCH_BYTES
            k = 1           # the most whole groups a chunk's scratch holds
            while k * G < n_seg and fa.attention_bwd_scratch_bytes(
                    (k + 1) * G, S, C, **flags) <= fa.ATTN_BWD_SCRATCH_BYTES:
                k += 1
            assert len(chunks) == -(-n_seg // (k * G))


def test_attention_bwd_scratch_bytes_counts_each_piece():
    """The scratch of a chunk of 10 segments at S=6, C=256 (60 rows, one
    unit group), and of 7 at S=86, C=768: qkv, dattn, dln, the LN
    statistics, the partial rows; the dw form's ln, attn, dqkv and gm; the
    reg form's geff; each rounded up to 256 bytes, as
    csrc/attention_bwd_sm90.cu carves them."""
    C, rows = 256, 60
    base = [2 * rows * 3 * C, 2 * rows * C, 4 * rows * C, 8 * rows,
            4 * 1 * 3 * C, 4 * 1 * 3 * C]
    dw = [2 * rows * C, 2 * rows * C, 2 * rows * 3 * C, 2 * rows * C]
    geff = [2 * rows * C]

    def rounded(pieces):
        return sum(-(-n // 256) * 256 for n in pieces)

    assert fa.attention_bwd_scratch_bytes(10, 6, C, False) == rounded(base)
    assert fa.attention_bwd_scratch_bytes(
        10, 6, C, True, geff=True, gm=True) == rounded(base + dw + geff)
    assert fa.attention_bwd_scratch_bytes(
        10, 6, C, False, use_ln=False) == rounded(base[:3] + base[4:])
    # past 64 tokens a unit is one segment: 7 segments of 86 tokens at
    # C=768 (602 rows) have 7 partial rows of the core's column sums
    C, rows = 768, 7 * 86
    base = [2 * rows * 3 * C, 2 * rows * C, 4 * rows * C, 8 * rows,
            4 * 10 * 3 * C, 4 * 7 * 3 * C]
    dw = [2 * rows * C, 2 * rows * C, 2 * rows * 3 * C, 2 * rows * C]
    assert fa.attention_bwd_scratch_bytes(7, 86, C, False) == rounded(base)
    assert fa.attention_bwd_scratch_bytes(
        7, 86, C, True, geff=True, gm=True) == rounded(base + dw + [
            2 * rows * C])


def test_build_entry_binds_a_signature_once(monkeypatch):
    """_build.entry loads a kernel library once, binds a C function's
    argtypes and restype at the first call and hands back the same bound
    function after, without loading or binding again (a stand-in library
    on the CPU)."""
    import ctypes

    from duoformer_tcga_tpu_torch.ops import _build

    class Fn:
        def __init__(self):
            self.binds = 0

        def __setattr__(self, name, value):
            if name == "argtypes":
                object.__setattr__(self, "binds", self.binds + 1)
            object.__setattr__(self, name, value)

    class Lib:
        loads = 0

        def __init__(self):
            self.launch_stand_in = Fn()

    def load(name):
        Lib.loads += 1
        assert name == "stand_in"
        return Lib()

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(_build, "_entries", {})
    args = [ctypes.c_void_p, ctypes.c_int]
    first = _build.entry("stand_in", "launch_stand_in", args)
    again = _build.entry("stand_in", "launch_stand_in", args)
    assert again is first and Lib.loads == 1 and first.binds == 1
    assert first.argtypes == args and first.restype is ctypes.c_int


def _entry_binds_its_c_signature_once(monkeypatch, lib_name, fn_name,
                                      args):
    """fn_name of csrc/<lib_name>.cu against its wrapper's ctypes
    signature `args`, argument by argument (a pointer c_void_p, long long
    c_longlong, int c_int, float c_float: a pointer passed as int would be
    cut), and _build.entry binding it once (a stand-in library on the
    CPU)."""
    import ctypes
    import re

    from duoformer_tcga_tpu_torch.ops import _build
    src = (_build.CSRC_DIR / f"{lib_name}.cu").read_text()
    params = re.search(rf"int {fn_name}\((.*?)\)", src, re.S).group(1)
    kinds = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int, "float": ctypes.c_float}
    want = [kinds["void*" if "*" in p else " ".join(p.split()[:-1])]
            for p in params.split(",")]
    assert list(args) == want

    class Fn:
        binds = 0

        def __setattr__(self, name, value):
            if name == "argtypes":
                Fn.binds += 1
            object.__setattr__(self, name, value)

    class Lib:
        loads = 0

        def __init__(self):
            Lib.loads += 1
            setattr(self, fn_name, Fn())

    monkeypatch.setattr(_build, "load_library", lambda name: Lib())
    monkeypatch.setattr(_build, "_entries", {})
    first = _build.entry(lib_name, fn_name, args)
    again = _build.entry(lib_name, fn_name, args)
    assert again is first and Lib.loads == 1 and Fn.binds == 1
    assert first.argtypes == list(args)


def test_mlp_bwd_entry_binds_its_c_signature_once(monkeypatch):
    """fused_mlp_bwd's ctypes signature is csrc/fused_mlp_bwd.cu's C entry,
    argument by argument, and _build.entry binds it once."""
    _entry_binds_its_c_signature_once(monkeypatch, "fused_mlp_bwd",
                                      "launch_fused_mlp_bwd",
                                      fa._MLP_BWD_ARGS)


@pytest.mark.parametrize("lib_name, fn_name, args_name", [
    ("fused_attention_residual_f32", "launch_fused_attention_residual_f32",
     "_ATTN_F32_ARGS"),
    ("fused_attention_residual_f32", "launch_tf32_split_weight",
     "_TF32_SPLIT_ARGS"),
    ("mlp_dz", "launch_mlp_dz", "_MLP_DZ_ARGS"),
])
def test_c_entries_bind_their_signature_once(monkeypatch, lib_name, fn_name,
                                            args_name):
    """#1f's C entries (csrc/fused_attention_residual_f32.cu: the forward
    and its weight split alone) and #6's (csrc/mlp_dz.cu), as
    fused_mlp_bwd's."""
    _entry_binds_its_c_signature_once(monkeypatch, lib_name, fn_name,
                                      getattr(fa, args_name))


@pytest.mark.parametrize("rows, tiles", [(1, 1), (127, 1), (128, 1),
                                         (129, 2), (37632, 294),
                                         (539392, 4214)])
def test_mlp_dz_workspace_holds_a_partial_per_row_tile(rows, tiles):
    """mlp_dz's workspace on the card: one float32 column-sum partial per
    128-row tile of dz (the last one ragged) and hidden column; #1f's
    float32 scratch: the weights' planes, A's two planes and qkv."""
    assert fa.mlp_dz_part_floats(rows, 3072) == tiles * 3072
    assert fa.attention_f32_scratch_floats(rows, 768) == (
        8 * 768 * 768 + 5 * rows * 768)


def test_every_loaded_kernel_library_is_built_from_its_source():
    """Every library name a wrapper under ops/ loads (load_library, or
    _build.entry's first argument) is one that _build.KERNELS builds
    (chip_smoke.py builds those), and each has its source csrc/<name>.cu."""
    import re
    from pathlib import Path

    from duoformer_tcga_tpu_torch.ops import _build
    names = set()
    for path in sorted(Path(fa.__file__).parent.glob("*.py")):
        text = path.read_text()
        for call in re.findall(r"load_library\((.*?)\)", text, re.S):
            names.update(re.findall(r'"([a-z0-9_]+)"', call))
        names.update(re.findall(r'\bentry\(\s*"([a-z0-9_]+)"', text))
    assert "attention_bwd_sm90" in names and "layernorm" in names
    # the 65..197-token backward is attention_bwd_sm90's too
    assert not names & {"fused_attention_residual_bwd_s86", "attention_long"}
    assert not {"fused_attention_residual_bwd_s86", "attention_long"} & set(
        _build.KERNELS)
    assert not (_build.CSRC_DIR / "attention_chain.cuh").exists()
    assert names and names <= set(_build.KERNELS), names - set(_build.KERNELS)
    for name in _build.KERNELS:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file(), name


def test_plain_versions_keep_bf16_rounding_points():
    """In bf16 the plain attention rounds where the TPU kernel does: its
    result matches the JAX XLA twin run in bf16 to bf16 resolution."""
    rng = np.random.default_rng(2)
    n_seg, S, C, H = 10, 6, 128, 2
    arrays = (_randn(rng, n_seg, S, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, 3 * C, std=0.02),
              _randn(rng, 3 * C, std=0.01), _randn(rng, C, C, std=0.02),
              _randn(rng, C, std=0.01))
    jx = [a.astype(jnp.bfloat16) if i in (0, 3, 5) else a
          for i, a in enumerate(_j(*arrays))]
    tx = [a.to(torch.bfloat16) if i in (0, 3, 5) else a
          for i, a in enumerate(_t(*arrays))]
    scale = (C // H) ** -0.5
    ref = pa._fused_block_xla(*jx, H, S, scale, 1e-6)
    out = fa.fused_attention_residual(*tx, H, S, scale, 1e-6)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("stages", [["3", "2"], ["3", "2", "1", "0"]])
def test_regroup_matches_jax(stages):
    rng = np.random.default_rng(3)
    C = 8
    feats = {s: _randn(rng, 2, g, g, C)
             for s, g in jregroup.STAGE_GRID.items()}
    ref = jregroup.regroup({s: jnp.asarray(f) for s, f in feats.items()},
                           stages)
    ref_gather = jregroup.regroup_gather(
        {s: jnp.asarray(f) for s, f in feats.items()}, stages)
    tfeats = {s: torch.from_numpy(f) for s, f in feats.items()}
    _close(tregroup.regroup(tfeats, stages), ref)
    _close(tregroup.regroup(tfeats, stages), ref_gather)
    _close(tregroup.regroup_gather(tfeats, stages), ref_gather)


@pytest.mark.parametrize("stage", ["0", "1", "2", "3"])
def test_region_index_matches_jax(stage):
    np.testing.assert_array_equal(tregroup.region_index(stage),
                                  jregroup.region_index(stage))


def test_layernorm_gelu_and_mlp_match_jax():
    rng = np.random.default_rng(4)
    x, s, b = _randn(rng, 5, 7, 96), _randn(rng, 96), _randn(rng, 96)
    _close(tnn.layernorm(*_t(x, s, b)),
           jnn.layernorm({"scale": s, "bias": b}, jnp.asarray(x)),
           atol=1e-5, rtol=1e-5)
    _close(tnn.gelu(torch.from_numpy(x)), jnn.gelu(jnp.asarray(x)),
           atol=1e-6, rtol=1e-6)
    w1, b1 = _randn(rng, 96, 384, std=0.05), _randn(rng, 384, std=0.1)
    w2, b2 = _randn(rng, 384, 96, std=0.05), _randn(rng, 96, std=0.1)
    ref = jnn.mlp({"fc1": {"w": w1, "b": b1}, "fc2": {"w": w2, "b": b2}},
                  jnp.asarray(x))
    _close(tnn.mlp(*_t(x, w1, b1, w2, b2)), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,stride,padding,bias", [
    (7, 2, 3, False),          # the ResNet stem
    (3, 2, 1, False),          # stride-2 3x3 of a v1.5 bottleneck
    (1, 2, "VALID", False),    # downsample
    (1, 1, "VALID", True),     # projection
    (3, 2, "SAME", True),      # XLA SAME, asymmetric pad at stride 2
])
def test_conv2d_matches_jax(k, stride, padding, bias):
    rng = np.random.default_rng(5)
    x = _randn(rng, 2, 15, 15, 4)                          # NHWC
    w = _randn(rng, k, k, 4, 6, std=0.2)                   # HWIO
    b = _randn(rng, 6) if bias else None
    params = {"w": w} if b is None else {"w": w, "b": b}
    ref = jnn.conv2d(params, jnp.asarray(x), stride, padding)
    out = tnn.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w).permute(3, 2, 0, 1),
                     None if b is None else torch.from_numpy(b),
                     stride, padding)
    _close(out.permute(0, 2, 3, 1), ref, atol=1e-5, rtol=1e-5)


def test_maxpool_matches_jax():
    rng = np.random.default_rng(6)
    x = _randn(rng, 2, 13, 13, 3)
    ref = jnn.maxpool2d(jnp.asarray(x), window=3, stride=2, padding=1)
    out = tnn.maxpool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
    _close(out.permute(0, 2, 3, 1), ref, atol=0, rtol=0)


def test_fold_batchnorm_matches_jax():
    rng = np.random.default_rng(7)
    c = 6
    bn = {"scale": _randn(rng, c), "bias": _randn(rng, c),
          "mean": _randn(rng, c), "var": np.abs(_randn(rng, c)) + 0.1}
    x = _randn(rng, 2, 5, 5, c)
    ref_fold = jnn.fold_batchnorm(bn)
    s, b = tnn.fold_batchnorm(*_t(bn["scale"], bn["bias"], bn["mean"],
                                  bn["var"]))
    _close(s, ref_fold["scale"], atol=1e-6, rtol=1e-6)
    _close(b, ref_fold["bias"], atol=1e-6, rtol=1e-6)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = jnn.batchnorm(bn, jnp.asarray(x))
    _close(tnn.affine(tx, s, b).permute(0, 2, 3, 1), ref,
           atol=1e-5, rtol=1e-5)
    _close(tnn.batchnorm(tx, *_t(bn["scale"], bn["bias"], bn["mean"],
                                 bn["var"])).permute(0, 2, 3, 1), ref,
           atol=1e-5, rtol=1e-5)


def test_multihead_attention_matches_jax_and_unfused():
    """The bare fused form (PatchBlock) against the JAX XLA composition
    and against the port's own unfused composition."""
    rng = np.random.default_rng(8)
    B, S, C, H = 3, 50, 128, 2
    attn = tattn.Attention(C, H)
    params = {"qkv": {"w": _randn(rng, C, 3 * C, std=0.02),
                      "b": _randn(rng, 3 * C, std=0.01)},
              "proj": {"w": _randn(rng, C, C, std=0.02),
                       "b": _randn(rng, C, std=0.01)}}
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(attn, name).w.copy_(torch.from_numpy(params[name]["w"]))
            getattr(attn, name).b.copy_(torch.from_numpy(params[name]["b"]))
    x = _randn(rng, B, S, C)
    ref = jattn.multihead_attention(params, jnp.asarray(x), H, fused=False)
    out = tattn.multihead_attention(attn, torch.from_numpy(x), H)
    _close(out, ref)
    _close(out, tattn.multihead_attention_unfused(
        attn, torch.from_numpy(x), H).detach().numpy())


# ---------------------------------------------------------------------------
# The training slice: backward kernels' plain versions and the autograd
# functions against the JAX package, which runs its Pallas kernels in
# interpret mode on the save-hidden path with the dz kernel on.
# ---------------------------------------------------------------------------

@pytest.fixture
def train_env(monkeypatch):
    monkeypatch.setenv("DUOFORMER_PALLAS_BWD", "1")
    monkeypatch.setenv("DUOFORMER_MLP_SAVE_HIDDEN", "1")
    monkeypatch.setenv("DUOFORMER_MLP_DZ", "1")


def _attention_inputs(rng, n_seg, S, C, use_ln):
    """x, g and weights that spread the scores ~2 units (see
    chip_smoke.py), so the softmax backward is far from uniform."""
    x, g = _randn(rng, n_seg, S, C), _randn(rng, n_seg, S, C)
    if use_ln:
        lns, lnb = _randn(rng, C, std=0.1, mean=1.0), _randn(rng, C, std=0.1)
    else:
        lns, lnb = np.zeros(C, np.float32), np.zeros(C, np.float32)
    return x, g, (lns, lnb, _randn(rng, C, 3 * C, std=1.5 * C ** -0.5),
                  _randn(rng, 3 * C, std=0.1), _randn(rng, C, C,
                                                      std=C ** -0.5),
                  _randn(rng, C, std=0.1))


ATTN_SHAPES = [
    (98, 6, 128, 2, True, True),       # ScaleBlock form, ragged TPU tiles
    (4, 50, 128, 2, False, False),     # PatchBlock bare form
    (13, 6, 128, 2, True, True),       # odd segment count
]


@pytest.mark.parametrize("n_seg,S,C,H,use_ln,use_residual", ATTN_SHAPES)
def test_attention_bwd_plain_matches_pallas(train_env, n_seg, S, C, H,
                                            use_ln, use_residual):
    """Each output of the backward kernel's plain version against
    _fused_block_bwd_impl (dw=False), at 3e-5; the Pallas row tensors carry
    zero-padded rows past n_seg * S, which are cut off. The four column
    sums add hundreds of terms of size ~10 in another order, so they are
    held in units of their RMS."""
    rng = np.random.default_rng(10)
    x, g, (lns, lnb, wqkv, bqkv, wproj, _) = _attention_inputs(
        rng, n_seg, S, C, use_ln)
    scale = (C // H) ** -0.5
    ref = pa._fused_block_bwd_impl(*_j(x, g, lns, lnb, wqkv, bqkv, wproj),
                                   H, S, scale, 1e-6, use_ln, use_residual)
    out = fa.fused_attention_residual_bwd(
        *_t(x, g, lns, lnb, wqkv, bqkv, wproj), H, S, scale, 1e-6, use_ln,
        use_residual)
    rows = n_seg * S
    names = ("dx", "ln", "attn", "dqkv", "dlns", "dlnb", "dbqkv", "dbproj")
    for name, o, r in zip(names, out, ref):
        r = np.asarray(r)
        if name in ("ln", "attn", "dqkv"):
            r = r[:rows]
        unit = (np.sqrt(np.mean(np.square(r))) or 1.0) if r.ndim == 1 else 1.0
        np.testing.assert_allclose(o.numpy() / unit, r / unit, err_msg=name,
                                   **TOL)


def test_mlp_dz_and_z_plain_match_pallas(train_env):
    """The dz kernel's plain version against _mlp_dz_impl, and the z of the
    MLP kernel's plain version against _fused_mlp_impl(return_hidden=True),
    at 3e-5 (rows 222 leave the Pallas tiles ragged)."""
    rng = np.random.default_rng(11)
    rows, C, hidden = 222, 128, 512
    g2, z = _randn(rng, rows, C), _randn(rng, rows, hidden)
    w2 = _randn(rng, hidden, C, std=hidden ** -0.5)
    ref_dz, ref_db1, _ = pa._mlp_dz_impl(*_j(g2, z, w2), emit_h=False)
    dz, db1 = fa.mlp_dz(*_t(g2, z, w2))
    _close(dz, ref_dz)
    _close(db1, ref_db1)
    arrays = (_randn(rng, 37, 6, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, hidden, std=C ** -0.5),
              _randn(rng, hidden, std=0.1),
              _randn(rng, hidden, C, std=hidden ** -0.5),
              _randn(rng, C, std=0.1))
    ref_out, ref_z = pa._fused_mlp_impl(*_j(*arrays), 1e-6,
                                        return_hidden=True)
    out, zt = fa.fused_mlp_residual(*_t(*arrays), 1e-6, return_hidden=True)
    _close(out, ref_out)
    _close(zt, np.asarray(ref_z)[:37 * 6])


def _close_param_grad(name, out, ref):
    """dx at the bar as it is; a parameter's cotangent, a sum over every
    row, in units of its RMS."""
    ref = np.asarray(ref)
    unit = 1.0 if name == "dx" else float(np.sqrt(np.mean(np.square(ref))))
    np.testing.assert_allclose(out.numpy() / unit, ref / unit, err_msg=name,
                               **TOL)


def _port_grads(fn, arrays, g):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    fn(*leaves).backward(torch.from_numpy(g))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("n_seg,S,C,H,use_ln,use_residual", ATTN_SHAPES[:2])
def test_attention_autograd_matches_jax_vjp(train_env, n_seg, S, C, H,
                                            use_ln, use_residual):
    """All 7 input cotangents of attention_residual against jax.vjp of
    pa.fused_attention_residual (its Pallas backward), at 3e-5: dx as it
    is, the parameter cotangents (sums over all rows, of size ~10-40) in
    units of their RMS."""
    rng = np.random.default_rng(12)
    x, g, weights = _attention_inputs(rng, n_seg, S, C, use_ln)
    arrays = (x, *weights)
    scale = (C // H) ** -0.5
    _, vjp = jax.vjp(lambda *a: pa.fused_attention_residual(
        *a, H, S, scale, 1e-6, use_ln, use_residual), *_j(*arrays))
    ref = vjp(jnp.asarray(g))
    got = _port_grads(lambda *a: fa.attention_residual(
        *a, H, S, scale, 1e-6, use_ln, use_residual), arrays, g)
    names = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwproj",
             "dbproj")
    for name, o, r in zip(names, got, ref):
        _close_param_grad(name, o, r)


def test_mlp_autograd_matches_jax_vjp(train_env):
    """All 7 input cotangents of mlp_residual (z form forward, save-hidden
    backward with the dz kernel) against jax.vjp of pa.fused_mlp_residual,
    at 3e-5."""
    rng = np.random.default_rng(13)
    C, hidden = 128, 512
    arrays = (_randn(rng, 37, 6, C), _randn(rng, C, std=0.1, mean=1.0),
              _randn(rng, C, std=0.1), _randn(rng, C, hidden, std=C ** -0.5),
              _randn(rng, hidden, std=0.1),
              _randn(rng, hidden, C, std=hidden ** -0.5),
              _randn(rng, C, std=0.1))
    g = _randn(rng, 37, 6, C)
    _, vjp = jax.vjp(lambda *a: pa.fused_mlp_residual(*a, 1e-6),
                     *_j(*arrays))
    ref = vjp(jnp.asarray(g))
    fa.reset_launch_counts()
    got = _port_grads(lambda *a: fa.mlp_residual(*a, 1e-6), arrays, g)
    names = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")
    for name, o, r in zip(names, got, ref):
        _close_param_grad(name, o, r)


def test_mlp_residual_runs_the_z_form_only_for_a_gradient():
    """Without a gradient to take, mlp_residual is the serving form and
    saves no hidden."""
    C = 128
    x = torch.randn(4, C)
    w1, w2 = torch.randn(C, 256) * 0.05, torch.randn(256, C) * 0.05
    v, h = torch.zeros(C), torch.zeros(256)
    with torch.no_grad():
        y = fa.mlp_residual(x, v + 1, v, w1, h, w2, v)
    assert y.grad_fn is None
    y = fa.mlp_residual(x, v + 1, v, w1.requires_grad_(True), h, w2, v)
    assert type(y.grad_fn).__name__ == "_FusedMLPResidualBackward"
