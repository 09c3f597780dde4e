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


def masked_trimmed_mean(x: torch.Tensor, mask: torch.Tensor, k: int
                        ) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the selected rows with a trim
    count ``k`` taken against the selected count ``m`` (``2k < m``):
    unselected rows sort past the selected ones as +inf and the mean runs
    over sorted ranks ``[k, m - k)``."""
    mask = _nonempty(mask)
    m = int(mask.sum())
    xs = torch.where(mask[:, None], x, torch.full_like(x, float("inf")))
    xs = xs.sort(0).values
    idx = torch.arange(x.shape[0], device=x.device)
    win = (idx >= k) & (idx < m - k)
    # where, not a product: the +inf pad rows must not make 0 * inf = NaN.
    kept = torch.where(win[:, None], xs, torch.zeros_like(xs)).sum(0)
    # A tensor divisor: ATen divides by a scalar as a multiply by its
    # reciprocal, which is not JAX's division.
    return kept / torch.full_like(kept, float(max(m - 2 * k, 1)))


def clip_to_norm(v: torch.Tensor, max_norm, eps: float = 1e-12
                 ) -> torch.Tensor:
    """Scale a vector down to L2 norm ``max_norm`` if above it."""
    norm = (v * v).sum().sqrt()
    return v * torch.clamp(max_norm / norm.clamp(min=eps), max=1.0)
