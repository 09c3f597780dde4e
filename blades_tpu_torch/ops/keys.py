"""Monotone integer keys of float values and exact order statistics over
them: the plain PyTorch counterpart of the radix select in
``csrc/fused_finish.cu``.

Keys follow the float order: negatives are bit-flipped, positives offset
past them, and every NaN, of either sign, is the largest key (NaN-last, as
a sort puts it).  Keys live in int64 so that ``torch.sort`` orders them as
unsigned 32-bit values.  Under bf16 storage only the top 16 key bits carry
order, and values come back through the 16-bit inverse, as the kernel's
16-step select returns them.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 17  # columns per step of the plain versions on large matrices
STRIPE = 512     # sanitize granularity: stripes start at multiples of 512


def keys_of(x: torch.Tensor, keys16: bool = False) -> torch.Tensor:
    """int64 keys of the f32 tensor ``x`` (32-bit, or the top 16 bits)."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (b >> 31) == 1
    k = torch.where(neg, b ^ 0xFFFFFFFF, b | 0x80000000)
    k = torch.where(torch.isnan(x), torch.full_like(k, 0xFFFFFFFF), k)
    return k >> 16 if keys16 else k


def vals_of(k: torch.Tensor, keys16: bool = False) -> torch.Tensor:
    """f32 values of int64 keys (the inverse of :func:`keys_of`)."""
    if keys16:
        k32 = k << 16
        k = torch.where((k >> 15) == 0, k32 | 0xFFFF, k32)
    pos = (k >> 31) == 1
    b = torch.where(pos, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    return b.to(torch.int32).view(torch.float32)


def kth_keys(sorted_keys: torch.Tensor, k: int, fkey=None, mult: int = 0):
    """The ``k``-th smallest (0-indexed) key per column of the multiset
    ``sorted_keys`` (rows sorted ascending per column) plus ``mult`` copies
    of the per-column key ``fkey``."""
    n = sorted_keys.shape[0]
    if not mult:
        return sorted_keys[k]
    below = (sorted_keys < fkey[None, :]).sum(0)  # forged run starts here
    kk = torch.full_like(below, k)
    lo = sorted_keys.gather(0, kk.clamp(max=n - 1)[None, :])[0]
    hi = sorted_keys.gather(0, (kk - mult).clamp(min=0, max=n - 1)[None, :])[0]
    return torch.where(kk < below, lo, torch.where(kk < below + mult, fkey, hi))
