"""Exact per-column order statistics: the coordinate-wise median and the
trimmed mean of an ``(n, d)`` matrix.

Counterpart of ``blades_tpu/ops/pallas_select.py``.  On a CUDA tensor each
function launches the radix select of ``csrc/column_select.cu``
(``ops/_cuda.py::launch_select``, route ``select:radix``, any row count;
built on first use) or raises; on a CPU tensor it runs its plain PyTorch
version, which also serves as the kernel's yardstick on the card.

Exactness: the selected values are exact order statistics of monotone keys
(NaN of either sign sorts last and comes back as a canonical NaN), so the
median is bit-for-bit the midpoint ``(s[(n-1)//2] + s[n//2]) / 2`` of the
sorted column.  The trimmed mean drops the ``k_cut`` smallest and largest
values per column with exact tie correction at both cuts.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.ops.fused_finish import _select_agg
from blades_tpu_torch.ops.keys import CHUNK


def _columnwise_plain(x: torch.Tensor, agg: tuple) -> torch.Tensor:
    n, d = x.shape
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    for c0 in range(0, d, CHUNK):
        xc = x[:, c0:c0 + CHUNK].float()
        out[c0:c0 + CHUNK] = _select_agg(xc, agg, None, 0, n, False, False)
    return out


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"need a (n >= 1, d) matrix, got {tuple(x.shape)}")


def column_median_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`column_median`."""
    _check(x)
    return _columnwise_plain(x, ("median",))


def column_median(x: torch.Tensor) -> torch.Tensor:
    """Exact coordinate-wise median over the rows of ``x`` (n, d) -> (d,)."""
    if not x.is_cuda:
        return column_median_plain(x)
    _check(x)
    x = x if x.dtype == torch.float32 else x.float()
    return _cuda.launch_select("column_median", x.contiguous(), ("median",))


def _check_trim(x: torch.Tensor, k_cut: int) -> None:
    _check(x)
    if k_cut < 0:
        raise ValueError(f"k_cut must be >= 0, got {k_cut}")
    if x.shape[0] <= 2 * k_cut:
        raise ValueError(f"need > {2 * k_cut} rows, got {x.shape[0]}")


def column_trimmed_mean_plain(x: torch.Tensor, k_cut: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`column_trimmed_mean`."""
    if k_cut == 0:
        return x.float().mean(0)
    _check_trim(x, k_cut)
    return _columnwise_plain(x, ("trimmed", k_cut))


def column_trimmed_mean(x: torch.Tensor, k_cut: int) -> torch.Tensor:
    """Mean of each column without its ``k_cut`` smallest and largest
    values (exact duplicate handling): ``sort(x)[k:n-k].mean(0)`` without
    the sort.  ``k_cut == 0`` is the plain mean, as in the reference."""
    if k_cut == 0 or not x.is_cuda:
        return column_trimmed_mean_plain(x, k_cut)
    _check_trim(x, k_cut)
    x = x if x.dtype == torch.float32 else x.float()
    return _cuda.launch_select("column_trimmed_mean", x.contiguous(),
                               ("trimmed", k_cut))
