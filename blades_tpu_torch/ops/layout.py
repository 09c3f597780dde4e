"""Column layouts of the update matrix and the row geometry over them
(counterpart of ``blades_tpu/ops/layout.py``).

Two layouts hold a slice of the matrix's columns:

- :class:`ShardInfo`, the width-sharded round's: each rank holds all
  ``n`` rows on its shard's real columns, at most ``width`` of the
  ``d_pad``-wide matrix (``d`` zero-padded to a multiple of the shard
  count; :mod:`blades_tpu_torch.parallel.dsharded`).  Row geometry (norms, dots,
  Grams, pairwise distances) is the all-reduce of the shards' partials
  (:meth:`ShardInfo.psum`), so it is global without an ``(n, d)`` tensor
  anywhere; coordinate positions (ALIE's SignGuard evasion negating the
  first half) are global.
- :class:`ChunkInfo`, the streamed round's column chunk ``[start, start +
  width)`` on one card: full rows of its columns, no cross-window
  reduction.

``shard=None`` is the dense layout: every helper is then the plain local
reduction, the operations the dense aggregators run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

#: Columns a width shard's width is a multiple of.  Every shard but the
#: last then holds whole 64-column groups, and the last ends at ``d``: a
#: column reduction over a shard (torch's vectorized sums on the CPU) takes
#: each column down the path the dense matrix's reduction takes it, so the
#: coordinate-wise aggregates are the dense round's bit for bit.  Rows are
#: 256-byte aligned besides.
SHARD_ALIGN = 64


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Width shard ``index`` of ``num_shards``: global columns ``[offset,
    offset + width)`` of a matrix ``global_d`` wide zero-padded to ``d_pad
    = num_shards * width``.  A shard's tensors hold its ``columns`` real
    ones (``width``, or fewer on the last shard: the padding is never
    computed on).  :meth:`psum` all-reduces over ``mesh``'s ``clients``
    axis (the identity without a mesh), or calls ``reduce`` where one is
    given.  On a mesh, :meth:`psum` and :meth:`gather` count their
    collectives on ``recorder`` (a
    :class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder`)
    where one is given."""

    num_shards: int
    global_d: int
    width: int
    index: int = 0
    mesh: Any = None
    reduce: Optional[Callable] = None
    recorder: Any = None

    @classmethod
    def of(cls, d: int, num_shards: int, index: int = 0, **kw
           ) -> "ShardInfo":
        """Shard ``index`` of ``d`` columns over ``num_shards``, each
        shard's width a multiple of :data:`SHARD_ALIGN`."""
        k = int(num_shards)
        return cls(num_shards=k, global_d=int(d),
                   width=-(-int(d) // (k * SHARD_ALIGN)) * SHARD_ALIGN,
                   index=int(index), **kw)

    @property
    def d_pad(self) -> int:
        return self.num_shards * self.width

    def offset(self) -> int:
        """This shard's first global column."""
        return self.index * self.width

    @property
    def columns(self) -> int:
        """The shard's real (not padding) columns."""
        return max(0, min(self.width, self.global_d - self.offset()))

    def coords(self, device=None) -> torch.Tensor:
        """Global column of each of the shard's real columns."""
        return self.offset() + torch.arange(self.columns, device=device)

    def valid(self, device=None) -> torch.Tensor:
        """Which of the shard's ``width`` columns are real, not padding."""
        return (self.offset() + torch.arange(self.width, device=device)
                < self.global_d)

    def psum(self, x: torch.Tensor, label: Optional[str] = None
             ) -> torch.Tensor:
        """The sum of ``x`` over the shards (counted under ``label``)."""
        if self.reduce is not None:
            return self.reduce(x)
        if self.mesh is None:
            return x
        from blades_tpu_torch.parallel.mesh import all_reduce_sum

        return all_reduce_sum(self.mesh, x, recorder=self.recorder,
                              label=label)

    def gather(self, x: torch.Tensor, label: Optional[str] = None
               ) -> torch.Tensor:
        """The shards' ``(columns, ...)`` pieces in shard order, each
        zero-padded to ``width``: ``(d_pad, ...)`` (``x`` itself without a
        mesh; counted under ``label``)."""
        if self.mesh is None:
            return x
        from blades_tpu_torch.parallel.mesh import all_gather_rows

        if x.shape[0] < self.width:
            x = torch.cat([x, x.new_zeros((self.width - x.shape[0],)
                                          + tuple(x.shape[1:]))])
        return all_gather_rows(self.mesh, x, recorder=self.recorder,
                               label=label)

    def fold(self, generator: torch.Generator) -> torch.Generator:
        """A generator seeded from ``(seed, shard index)``, the counterpart
        of ``fold_in(key, axis_index)``: the seed is one word drawn from
        ``generator``, which every shard holds in the same state."""
        from blades_tpu_torch.utils.seeds import seed_of

        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device))
        gen = torch.Generator(device=generator.device)
        gen.manual_seed(seed_of(seed, self.index))
        return gen


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


def psum_if(x: torch.Tensor, shard: Optional[ShardInfo],
            label: Optional[str] = None) -> torch.Tensor:
    """``shard.psum(x, label)``, or ``x`` on the dense layout.  Each helper
    below takes the ``label`` its psum is counted under."""
    return x if shard is None else shard.psum(x, label)


def row_sq_norms(x: torch.Tensor, shard: Optional[ShardInfo] = None,
                 label: Optional[str] = None) -> torch.Tensor:
    """Squared L2 norm of each row ``(n,)``, global under ``shard``."""
    return psum_if((x * x).sum(1), shard, label)


def row_norms(x: torch.Tensor, shard: Optional[ShardInfo] = None,
              label: Optional[str] = None) -> torch.Tensor:
    """L2 norm of each row, as ``sqrt(sum(x**2))``; under ``shard`` the
    square root of the summed partials (clamped at 0)."""
    if shard is None:
        return (x * x).sum(1).sqrt()
    return row_sq_norms(x, shard, label).clamp(min=0.0).sqrt()


def row_dots(x: torch.Tensor, v: torch.Tensor,
             shard: Optional[ShardInfo] = None,
             label: Optional[str] = None) -> torch.Tensor:
    """``x @ v`` ``(n,)``, global under ``shard``."""
    return psum_if(x @ v, shard, label)


def gram(x: torch.Tensor, shard: Optional[ShardInfo] = None,
         label: Optional[str] = None) -> torch.Tensor:
    """The Gram matrix ``x @ x.T`` ``(n, n)``, global under ``shard``."""
    return psum_if(x @ x.T, shard, label)


def pairwise_sq_dists(x: torch.Tensor, shard: Optional[ShardInfo] = None,
                      label: Optional[str] = None) -> torch.Tensor:
    """``||x_i - x_j||**2`` ``(n, n)`` as ``sq_i + sq_j - 2 g_ij``: each
    shard's partial is linear in its own sums, so one psum of the
    assembled partial is the global matrix (up to the shards' order of
    summation)."""
    sq = (x * x).sum(1)
    return psum_if(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), shard,
                   label)


def clip_rows_to_norm(x: torch.Tensor, max_norm,
                      shard: Optional[ShardInfo] = None, eps: float = 1e-12,
                      label: Optional[str] = None) -> torch.Tensor:
    """Scale each row of ``x`` down to L2 norm ``max_norm`` if above it,
    the norms global under ``shard``."""
    norms = row_norms(x, shard, label)[:, None]
    return x * torch.clamp(max_norm / norms.clamp(min=eps), max=1.0)


def slice_to_shard(v: torch.Tensor, shard: ShardInfo) -> torch.Tensor:
    """A replicated ``(global_d,)`` vector's entries on ``shard``'s real
    columns."""
    lo = shard.offset()
    return v[lo:lo + shard.columns]
