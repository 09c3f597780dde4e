"""Fused row statistics of an update matrix (counterpart of
``blades_tpu/ops/pallas_rowstats.py``).

The row-geometry defenses take their statistics of the stored ``(n, d)``
update matrix through the pass planner
(:mod:`blades_tpu_torch.parallel.streamed_geometry`); every bundle of
kernel kinds it plans is ONE call here.  :func:`row_stats_bundle` computes
any subset of

- row squared norms ``sq (n,)``;
- the Gram matrix ``gram (n, n)``;
- per-row sign counts ``signs (n, 3)`` (positive, negative, zero; zero is
  ``d_true - pos - neg``);
- dots against ``R`` vectors ``dots (n, R)``;
- ``W`` weighted row sums ``wsum (W, d_true)``;
- ``G`` Gram-vector products ``(X X^T) w`` as ``gram_dot (n, G)``.

On a CUDA tensor it launches the kernels of ``csrc/rowstats.cu`` (built on
first use) or raises; on a CPU tensor it runs :func:`row_stats_bundle_plain`,
which walks the columns in chunks with the reference planner's chunk math
(f32 accumulation) and is the kernels' yardstick on the card.

int8 input (the wire-domain payload): ``sq`` and ``gram`` are exact integer
sums rounded to f32 once; every other statistic casts the values to f32.
Nothing is padded or copied here: the streamed round hands over its
``(n, d_alloc)`` buffer, zero past ``d_true`` as the JAX package allocates
it, whose rows are 16-byte aligned.  The statistics of such rows take the
ring kernel at any row count (``_cuda.rowstats_route``), and the Gram of
such bf16 or int8 rows the TMA + wgmma kernel (``_cuda.gram_route``: the
wire payload's rows are a multiple of 16 bytes too); the other kernels
mask their own ragged edges.

``gram_dot_shared`` tells the kernel which gram_dot vectors ARE weights
rows (the pass planner knows it by object identity: GeoMed's and
Centeredclipping's iterates ask for both with one vector): the column
sum over such a vector is taken once, written as ``wsum`` and used as the
gram_dot's ``t``, bit for bit what two passes give.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.ops.keys import CHUNK

DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _check(buf, sq, gram, signs, dots, weights, gram_dot, gram_dot_shared):
    if gram_dot_shared is not None:
        g = 0 if gram_dot is None else gram_dot.shape[0]
        w = 0 if weights is None else weights.shape[0]
        if (len(gram_dot_shared) != g
                or not all(-1 <= int(j) < w for j in gram_dot_shared)):
            raise ValueError(f"gram_dot_shared {list(gram_dot_shared)} must "
                             f"give, for each of {g} gram_dot vectors, a "
                             f"weights row below {w} or -1")
    if buf.dim() != 2 or buf.shape[0] < 1:
        raise ValueError(f"need a (n >= 1, d) matrix, got {tuple(buf.shape)}")
    if buf.dtype not in DTYPES:
        raise ValueError(f"dtype {buf.dtype} not supported "
                         "(float32, bfloat16 or int8)")
    if not (sq or gram or signs or dots is not None or weights is not None
            or gram_dot is not None):
        raise ValueError("empty row-stats bundle")


def row_stats_bundle_plain(
    buf: torch.Tensor,
    *,
    sq: bool = False,
    gram: bool = False,
    signs: bool = False,
    dots: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    gram_dot: Optional[torch.Tensor] = None,
    gram_dot_shared: Optional[Sequence[int]] = None,
    d_true: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`row_stats_bundle`."""
    _check(buf, sq, gram, signs, dots, weights, gram_dot, gram_dot_shared)
    n, d = buf.shape
    d_true = d if d_true is None else int(d_true)
    dev = buf.device
    exact = buf.dtype == torch.int8  # integer self-contractions in f64
    f32 = dict(dtype=torch.float32, device=dev)
    v = None if dots is None else dots.to(**f32)
    w = None if weights is None else weights.to(**f32)
    g = None if gram_dot is None else gram_dot.to(**f32)
    acc_t = torch.float64 if exact else torch.float32
    sq_acc = torch.zeros((n,), dtype=acc_t, device=dev) if sq else None
    gram_acc = torch.zeros((n, n), dtype=acc_t, device=dev) if gram else None
    pos = torch.zeros((n,), dtype=torch.int64, device=dev) if signs else None
    neg = torch.zeros((n,), dtype=torch.int64, device=dev) if signs else None
    dots_acc = torch.zeros((n, v.shape[0]), **f32) if v is not None else None
    wsum = torch.empty((w.shape[0], d), **f32) if w is not None else None
    gd_acc = torch.zeros((n, g.shape[0]), **f32) if g is not None else None
    for c0 in range(0, d, CHUNK):
        c1 = min(c0 + CHUNK, d)
        xc = buf[:, c0:c1].float()
        xe = buf[:, c0:c1].double() if exact else xc
        if sq:
            sq_acc += (xe * xe).sum(1)
        if gram:
            gram_acc += xe @ xe.T
        if signs:
            pos += (xc > 0).sum(1)
            neg += (xc < 0).sum(1)
        if v is not None:
            dots_acc += xc @ v[:, c0:c1].T
        if w is not None:
            wsum[:, c0:c1] = w @ xc
        if g is not None:
            t = g @ xc
            for k, j in enumerate(gram_dot_shared or ()):
                if j >= 0:
                    t[k] = wsum[j, c0:c1]
            gd_acc += xc @ t.T
    out = {}
    if sq:
        out["sq"] = sq_acc.float()
    if gram:
        out["gram"] = gram_acc.float()
    if signs:
        out["signs"] = torch.stack([pos, neg, d_true - pos - neg], 1).float()
    if v is not None:
        out["dots"] = dots_acc
    if w is not None:
        out["wsum"] = wsum[:, :d_true]
    if g is not None:
        out["gram_dot"] = gd_acc
    return out


def row_stats_bundle(
    buf: torch.Tensor,
    *,
    sq: bool = False,
    gram: bool = False,
    signs: bool = False,
    dots: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    gram_dot: Optional[torch.Tensor] = None,
    gram_dot_shared: Optional[Sequence[int]] = None,
    d_true: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Compute a statistics bundle of ``buf`` in one call.

    Args:
        buf: ``(n, d)`` matrix, float32, bfloat16 or int8.  Columns past
            ``d_true`` must be zero.
        sq/gram/signs: request the respective statistic.
        dots: ``(R, d)`` vectors to dot every row against.
        weights: ``(W, n)`` row weights for weighted row sums.
        gram_dot: ``(G, n)`` row weights for ``(buf buf^T) w``.
        gram_dot_shared: for each gram_dot vector, the index of the
            ``weights`` row it is (one column pass serves both), or -1.
        d_true: true model width (zero counts and the weighted sums' width);
            defaults to ``buf.shape[1]``.

    Returns a dict of only the requested results: ``sq (n,)``,
    ``gram (n, n)``, ``signs (n, 3)``, ``dots (n, R)``, ``wsum (W, d_true)``,
    ``gram_dot (n, G)``, all f32.
    """
    if not buf.is_cuda:
        return row_stats_bundle_plain(
            buf, sq=sq, gram=gram, signs=signs, dots=dots, weights=weights,
            gram_dot=gram_dot, gram_dot_shared=gram_dot_shared, d_true=d_true)
    _check(buf, sq, gram, signs, dots, weights, gram_dot, gram_dot_shared)
    return _cuda.launch_rowstats(
        "row_stats_bundle", buf.contiguous(), sq=sq, gram=gram, signs=signs,
        dots=dots, weights=weights, gram_dot=gram_dot,
        gram_dot_shared=gram_dot_shared, d_true=d_true)
