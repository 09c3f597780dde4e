"""Per-client batch sampling (counterpart of ``blades_tpu/data/sampler.py``).

Each client draws ``num_batches`` batches of ``batch_size`` indices
uniformly with replacement from ``[0, length)`` of its padded shard, from
an explicit ``torch.Generator``.  Callers that must reproduce another
draw (the parity tests feed the JAX-drawn indices) pass the indices
instead and skip the draw.
"""

from __future__ import annotations

import torch


def sample_batch_indices(generator: torch.Generator, lengths: torch.Tensor,
                         batch_size: int, num_batches: int) -> torch.Tensor:
    """``(n, num_batches, batch_size)`` int64 indices, each in
    ``[0, max(length, 1))`` of its client."""
    n = lengths.shape[0]
    u = torch.rand((n, num_batches, batch_size), generator=generator,
                   device=lengths.device, dtype=torch.float64)
    return indices_from_uniforms(u, lengths)


def indices_from_uniforms(u: torch.Tensor, lengths: torch.Tensor
                          ) -> torch.Tensor:
    """The batch indices of :func:`sample_batch_indices` from its f64
    uniforms ``u (n, num_batches, batch_size)`` and ``lengths (n,)``."""
    hi = lengths.to(u.device).clamp(min=1).to(torch.float64)[:, None, None]
    idx = (u * hi).floor().to(torch.int64)
    return torch.minimum(idx, hi.to(torch.int64) - 1)


def gather_batches(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """Client shards ``x (G, shard, ...)``, ``y (G, shard)`` and indices
    ``(G, nb, B)`` -> batches ``(G, nb, B, ...)`` and ``(G, nb, B)``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[rows, idx], y[rows, idx]


def sample_client_batches(generator: torch.Generator, x: torch.Tensor,
                          y: torch.Tensor, lengths: torch.Tensor,
                          batch_size: int, num_batches: int):
    """The whole federation's batches for one round: ``(n, num_batches,
    batch_size, ...)`` inputs and ``(n, num_batches, batch_size)`` labels,
    indices drawn from ``generator`` on its own device."""
    idx = sample_batch_indices(generator, lengths.to(generator.device),
                               batch_size, num_batches)
    return gather_batches(x, y, idx.to(x.device))
