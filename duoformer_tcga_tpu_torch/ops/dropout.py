"""Counter-based dropout masks (counterpart of
duoformer_tcga_tpu/ops/pallas_attention.py:56-125 and :1131-1153).

A keep-mask element is a hash of (seed, site, row, column): murmur3's fmix32
applied twice over a linear mix of the position counters. The same hash
runs inside every dropout kernel of the port (csrc/dropout_hash.cuh) and
here, in plain torch, for the plain versions and the tests, so a backward
regenerates its forward's masks bit for bit from global positions alone,
whatever tiling the kernels use. The masks are the JAX package's, bit for
bit: all arithmetic is on 32-bit words with wrap-around and logical
shifts, kept here in int32 tensors (keep_mask_from_counters).

Counters are global: the attention-probability site uses the global token
index (segment * S + t) for both row and column, every row-space site
(attention proj, MLP hidden, MLP output) the global flat row and the
column. Keep probability is 1 - rate, decided on the top 24 hash bits
against thr = round((1 - rate) * 2^24), computed on the host in Python
(round half to even, as the JAX package's int(round(...))); a kept value
is v * float32(1 / (1 - rate)), a multiply.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_K_ROW = 0x9E3779B1     # golden-ratio odd multipliers of the two counters
_K_COL = 0x85EBCA77
_FMIX1 = 0x85EBCA6B     # murmur3 fmix32 constants
_FMIX2 = 0xC2B2AE35
_K_SITE = 0x27D4EB2F

# site salts (one per dropout point); the attention site of head h is
# _SITE_ATTN + 4 * h
_SITE_ATTN = 0
_SITE_PROJ = 1
_SITE_MLP_HID = 2
_SITE_MLP_OUT = 3


def keep_threshold(rate: float) -> int:
    """Keep iff (hash >> 8) < this (pallas_attention.py:91)."""
    return int(round((1.0 - rate) * (1 << 24)))


def keep_scale(rate: float) -> float:
    """The kept values' factor: 1 / (1 - rate), rounded to float32 when it
    is used (pallas_attention.py:117)."""
    return 1.0 / (1.0 - rate)


def u32(v: int) -> int:
    """A Python int (an int32 seed, possibly negative) -> its 32-bit word."""
    return int(v) & _MASK32


def site_seed(seed: int, salt: int) -> int:
    """seed + salt * K_SITE on 32-bit words (pallas_attention.py:98-100)."""
    return (u32(seed) + u32(salt) * _K_SITE) & _MASK32


def _i32(v):
    """32-bit words (a Python int or an integer tensor) as the int32 of the
    same bits."""
    if isinstance(v, int):
        v = u32(v)
        return v - (1 << 32) if v >= (1 << 31) else v
    v = v.to(torch.int64) & _MASK32
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _srl(x, n: int):
    """Logical right shift of int32 words (>> is arithmetic on int32)."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def _fmix32(x):
    x = x ^ _srl(x, 16)
    x = x * _i32(_FMIX1)
    x = x ^ _srl(x, 13)
    x = x * _i32(_FMIX2)
    return x ^ _srl(x, 16)


def keep_mask_from_counters(seed_plus, row_ids, col_ids, rate: float):
    """Boolean keep-mask from position counters (pallas_attention.py:79-92).

    seed_plus: the seed with its site salt folded in, an int or an integer
    tensor broadcastable to the mask; row_ids, col_ids: integer tensors
    broadcastable to the mask shape (non-negative). The words are held in
    int32 tensors, whose products and sums wrap modulo 2^32 on either
    device (two's complement), as the kernels' uint32 arithmetic does;
    the shifts are made logical by masking. (Four times faster on the CPU
    than 64-bit words with overflow-free products, which the plain
    versions of a 4-scale step hash hundreds of millions of.)"""
    sp = _i32(seed_plus)
    x = _i32(row_ids) * _i32(_K_ROW) + _i32(col_ids) * _i32(_K_COL) + sp
    x = _fmix32(_fmix32(x) + sp)
    return _srl(x, 8) < keep_threshold(rate)


def row_keep_mask(n_rows, n_cols, seed, site, rate, device=None, row0=0):
    """[n_rows, n_cols] mask of a row-space site for global rows
    [row0, row0 + n_rows) (pallas_attention.py:1146-1153)."""
    rows = torch.arange(row0, row0 + n_rows, device=device)[:, None]
    cols = torch.arange(n_cols, device=device)[None, :]
    return keep_mask_from_counters(site_seed(seed, site), rows, cols, rate)


def attn_keep_masks(n_seg, seg_len, num_heads, seed, rate, device=None,
                    seg0=0):
    """[n_seg, H, S, S] masks of the attention-probability site for
    segments [seg0, seg0 + n_seg): head h salted 4h, rows and columns the
    global token indices (pallas_attention.py:1131-1143)."""
    gt = torch.arange(seg0 * seg_len, (seg0 + n_seg) * seg_len,
                      device=device).view(n_seg, 1, seg_len)
    sp = torch.tensor([site_seed(seed, _SITE_ATTN + 4 * h)
                       for h in range(num_heads)], dtype=torch.int64,
                      device=device)
    return keep_mask_from_counters(sp[None, :, None, None], gt[..., :, None],
                                   gt[..., None, :], rate)


def drop(v, mask, rate: float):
    """Inverted dropout of a float32 v: where(mask, v * keep_scale, 0)
    (pallas_attention.py:115-118)."""
    scale = torch.tensor(keep_scale(rate), dtype=torch.float32,
                         device=v.device)
    return torch.where(mask, v * scale, v.new_zeros(()))
