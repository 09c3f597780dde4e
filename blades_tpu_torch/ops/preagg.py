"""Per-shard robust pre-aggregation (counterpart of
``blades_tpu/ops/preagg.py``; ByzFL arXiv:2505.24802).

The hierarchical round (:mod:`blades_tpu_torch.parallel.hier`) reduces each
rank's ``(n_local, d)`` update block to ``m`` representatives before the
robust aggregator runs over the gathered ``(c * m, d)`` matrix.  Two
flavors share one ``bucket_size`` knob, and both are the identity at
``bucket_size=1``:

- ``bucket``: consecutive lanes average in groups of ``bucket_size``;
  ``m = ceil(n_local / bucket_size)``;
- ``nnm`` (nearest-neighbor mixing): every lane becomes the mean of its
  ``bucket_size`` nearest local rows (itself included, squared L2 on the
  raw updates); ``m = n_local``.

Ghost (padding) lanes carry ``real = False``: bucketing takes a masked
mean (a bucket with no real member is a zero row, which the caller's
static ``kept`` count slices away); NNM gives ghost rows infinite
distance, so they never join a real lane's neighborhood.
"""

from __future__ import annotations

import torch

PREAGG_FLAVORS = ("bucket", "nnm")
# The pairwise differences NNM holds at once (a column slice of them).
_PAIR_ELEMS = 1 << 22


def bucket_count(n_local: int, bucket_size: int) -> int:
    """Representatives a ``bucket`` pre-aggregation emits per rank."""
    return -(-int(n_local) // int(bucket_size))


def bucket_representatives(updates: torch.Tensor, real: torch.Tensor,
                           bucket_size: int) -> torch.Tensor:
    """Masked bucket means: ``(n_local, d) -> (m, d)``.  ``real`` is the
    ``(n_local,)`` bool mask of non-ghost lanes; ghost rows are zeroed
    before the sum (a non-finite ghost cannot reach a boundary bucket).
    At ``bucket_size=1`` the real rows come back unchanged."""
    b = int(bucket_size)
    n_local, d = updates.shape
    m = bucket_count(n_local, b)
    pad = m * b - n_local
    w = real.to(updates.dtype)
    zero = torch.zeros((), dtype=updates.dtype, device=updates.device)
    u = torch.where(real[:, None], updates, zero)
    if pad:
        u = torch.cat([u, u.new_zeros((pad, d))])
        w = torch.cat([w, w.new_zeros((pad,))])
    return (u.view(m, b, d).sum(1)
            / w.view(m, b, 1).sum(1).clamp(min=1.0))


def nnm_representatives(updates: torch.Tensor, real: torch.Tensor,
                        bucket_size: int) -> torch.Tensor:
    """Nearest-neighbor mixing: ``(n_local, d) -> (n_local, d)``, row ``i``
    the mean of the ``bucket_size`` rows nearest to it by squared L2 (its
    own distance is 0, so it is always its own neighbor).  Ghost columns
    are never selected; ghost rows still emit a row at their own index,
    which the caller's ``kept`` slice removes.  The distances are the
    exact sums of squared differences, as the reference takes them, over
    column slices whose ``(n_local, n_local, cols)`` differences hold at
    most ``_PAIR_ELEMS`` values (16 MiB in f32), never ``(n_local,
    n_local, d)``."""
    k = int(bucket_size)
    n_local, d = updates.shape
    cols = max(1, _PAIR_ELEMS // max(n_local * n_local, 1))
    sq = updates.new_zeros((n_local, n_local))
    for c0 in range(0, d, cols):
        u = updates[:, c0:c0 + cols]
        sq += ((u[:, None, :] - u[None, :, :]) ** 2).sum(-1)
    sq = torch.where(real[None, :], sq, torch.full((), float("inf"),
                                                   dtype=sq.dtype,
                                                   device=sq.device))
    idx = torch.topk(-sq, k, dim=1).indices
    return updates[idx].sum(1) / float(k)
