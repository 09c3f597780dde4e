"""Masked reductions over stacked client-update matrices (counterpart of
``blades_tpu/ops/masked.py``).

``median`` is the midpoint ``(s[(n-1)//2] + s[n//2]) / 2`` of the sorted
column.  ``torch.median`` returns the lower of the two middle values, which
is a different aggregator for even ``n``, so it is not used.
"""

from __future__ import annotations

import torch


def _nonempty(mask: torch.Tensor) -> torch.Tensor:
    """An all-False selection degrades to all-True."""
    return torch.where(mask.any(), mask, torch.ones_like(mask))


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the rows of ``x`` (n, d) where ``mask`` (n,) is True."""
    w = _nonempty(mask).to(x.dtype)
    return (x * w[:, None]).sum(0) / w.sum()


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the selected rows (unselected rows sort
    past them as +inf)."""
    mask = _nonempty(mask)
    m = int(mask.sum())
    xs = torch.where(mask[:, None], x, torch.full_like(x, float("inf")))
    xs = xs.sort(0).values
    return (xs[max(m - 1, 0) // 2] + xs[m // 2]) / 2.0


def median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over all rows of ``x`` (n, d)."""
    return masked_median(x, torch.ones(x.shape[0], dtype=torch.bool,
                                       device=x.device))
