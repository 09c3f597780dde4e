"""Column-window layout of the streamed round and row-norm clipping
(counterpart of the parts of ``blades_tpu/ops/layout.py`` the port uses).

The streamed round walks the dense ``(n, d)`` matrix in column chunks
``[start, start + width)``; coordinate-wise forgers receive a
:class:`ChunkInfo` so that coordinate-position logic (ALIE's
SignGuard-evasion "negate the first half") uses GLOBAL coordinates.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChunkInfo:
    """Column window ``[start, start + width)`` (chunk ``index``) of a
    matrix ``global_d`` wide."""

    global_d: int
    width: int
    start: int
    index: int

    def coords(self, device=None) -> torch.Tensor:
        """Global coordinate of each local column ``(width,)``."""
        return self.start + torch.arange(self.width, device=device)


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """L2 norm of each row, as ``sqrt(sum(x**2))``."""
    return (x * x).sum(1).sqrt()


def clip_rows_to_norm(x: torch.Tensor, max_norm, eps: float = 1e-12
                      ) -> torch.Tensor:
    """Scale each row of ``x`` (n, d) down to L2 norm ``max_norm`` if
    above it."""
    norms = row_norms(x)[:, None]
    return x * torch.clamp(max_norm / norms.clamp(min=eps), max=1.0)
