"""Row-geometry aggregation over the streamed ``(n, d)`` update buffer,
with request/plan/execute pass fusion (counterpart of
``blades_tpu/parallel/streamed_geometry.py``).

The row-geometry defenses (GeoMed, Multikrum, DnC, Centeredclipping,
Signguard, Clippedclustering, FLTrust) and forges (MinMax, SignGuard,
Attackclippedclustering) need full-matrix statistics: row norms, the Gram
matrix, dots against replicated vectors, sign counts, weighted row sums.
Each is a full traversal of a ~10 GB matrix, so they run on a lifecycle:

1. **request**: an aggregator asks a :class:`PassPlanner` for every
   statistic it needs at one point of its dataflow; each request returns a
   :class:`PassHandle` whose ``.value`` is filled at execute time;
2. **plan / execute**: ``execute()`` runs every pending request as ONE
   traversal (``fuse=False``: one per request, the unfused comparator).  A
   bundle of kernel kinds (``sq``, ``gram``, ``signs``, ``dots``, ``wsum``,
   ``gram_dot``) is one call of
   :func:`blades_tpu_torch.ops.rowstats.row_stats_bundle` (the CUDA
   kernels on a card, the plain version on a CPU tensor); a bundle with a
   chunk-only kind (``gather``, ``mean_std``, ``masked_median``,
   ``coordwise``) runs whole through the column-chunk loop, still one
   traversal.
3. A :class:`PassRecorder` counts the planned traversals, fused
   (``executed``) and one-per-request (``unfused``): the round's
   ``hbm_passes`` metrics.  A data-dependent loop (GeoMed's Weiszfeld
   iterations) counts its per-iteration traversals times its iteration
   BOUND, as the reference's trace-time count does; ``kernel_bundles`` and
   ``loop_iters`` count what actually ran.

The buffer may carry zero padding columns past the model width ``d``
(the streamed round allocates ``(n, d_alloc)``, ``d_alloc`` a multiple of
512, as the JAX package does): every chunk pass, forge and scatter is
bounded to ``d``, and the row-stats kernel reads the whole padded buffer
with ``d_true = d``, its rows 16-byte aligned.

Row-norm clipping never rewrites the matrix: every aggregator applies its
per-row scales inside the passes, with the constants, selection logic and
empty-mask degradation of the dense versions in
:mod:`blades_tpu_torch.ops.aggregators`.

Chunks follow the streamed round's scheme: width ``c``, starts
``min(i * c, d - c)`` (the tail chunk overlaps its predecessor;
accumulating passes mask the covered columns with :func:`new_cols`,
overwriting ones are idempotent).

Keyed draws are inputs or come from the caller's ``torch.Generator``:
DnC's column subsamples (``draws``) and SignGuard-attack's permutation and
uniforms (``draws``).

Wire-domain aggregation (``row_scale=``): the planner also serves a
packed int8 payload ``q`` with per-row f32 scales ``s``, whose logical
matrix is ``s[:, None] * q``.  Each statistic applies the scales
algebraically at its own size: the passes run on ``q`` and ``sq``, the
Gram, dots, gram_dot and gathers are scaled after them (``s_i^2``,
``s_i s_j``, ``s_i``); weighted sums and gram_dot fold one ``S`` into
their weights, masked medians into their row scale; the chunk-only
``mean_std`` and ``coordwise`` scale each in-flight slice.  On the card
the int8 statistics take the ring (``rowstats:ring``) and the Gram
``gram:wgmma`` (the TMA + wgmma kernel's s8 instance: the payload's rows
are a multiple of 16 bytes); :func:`aggregate_wire` runs every one of
:data:`WIRE_AGGREGATORS` so, and Median / Trimmedmean decode each chunk
for ``select:radix``, ranking the values decode-then-f32 would rank.  The
recorder's ``dequant_rows`` counts the full-width f32 rows decoded.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional, Tuple

import torch

from blades_tpu_torch.adversaries.update_attacks import (
    AttackclippedclusteringAdversary,
    MinMaxAdversary,
    SignGuardAdversary,
    _negate_first_half,
)
from blades_tpu_torch.ops import clustering, masked
from blades_tpu_torch.ops.aggregators import (
    Centeredclipping,
    Clippedclustering,
    DnC,
    FLTrust,
    GeoMed,
    Mean,
    Median,
    Multikrum,
    Signguard,
    Trimmedmean,
    _krum_mask,
)
from blades_tpu_torch.ops.rowstats import row_stats_bundle

STREAMED_ROW_AGGREGATORS = (
    GeoMed, DnC, Multikrum, Centeredclipping, Signguard, Clippedclustering,
    FLTrust,
)
STREAMED_ROW_FORGERS = (MinMaxAdversary, SignGuardAdversary,
                        AttackclippedclusteringAdversary)
# Everything aggregate_wire serves from a packed payload: the row-geometry
# seven plus the coordinate-wise three.
WIRE_AGGREGATORS = STREAMED_ROW_AGGREGATORS + (Mean, Median, Trimmedmean)


def chunk_grid(d: int, c: int):
    """``(c, k, starts)``: width ``c`` (clamped to ``d``), ``k`` chunks,
    starts ``min(i * c, d - c)``."""
    c = min(c, d)
    k = -(-d // c)
    return c, k, [min(i * c, d - c) for i in range(k)]


def new_cols(start: int, i: int, c: int, device=None) -> torch.Tensor:
    """Mask of chunk ``i``'s columns NOT covered by earlier chunks."""
    return (start + torch.arange(c, device=device)) >= i * c


def check_applicable(agg, n: int) -> None:
    """Raise the aggregator's n-dependent config errors (the streamed
    round calls this before training)."""
    if isinstance(agg, Multikrum):
        agg.check(n)
    if isinstance(agg, DnC):
        agg.keep(n)


class PassRecorder:
    """Traversal accounting for one streamed round.

    ``executed``: full-matrix traversals the fused plan runs; ``unfused``:
    what one traversal per request would run.  Inside
    :meth:`PassPlanner.loop` the first iteration's traversals count times
    the loop's iteration bound (a planned upper bound, as the reference
    counts a traced loop).  ``kernel_bundles`` counts the bundles the
    row-stats kernel served and ``loop_iters`` the iterations loops ran.
    ``dequant_rows`` counts the full-width f32 rows a wire-domain planner
    decodes (weighted sums, medians and coordwise 1 each, mean and std 2,
    a gather its share of the width, rounded up), as the reference does.
    ``ici_events`` holds one ``(label, kind, payload_bytes, ring_size)``
    per collective a round records (:meth:`count_ici`, the gossip round's
    exchange) and ``ici_bytes`` their per-device ring wire total.
    """

    def __init__(self):
        self.executed = 0
        self.unfused = 0
        self.dequant_rows = 0
        self.kernel_bundles = 0
        self.loop_iters = 0
        self.ici_events = []
        self.ici_bytes = 0

    def count(self, executed: int, unfused: int, mult: int = 1,
              dequant: int = 0) -> None:
        self.executed += executed * mult
        self.unfused += unfused * mult
        self.dequant_rows += dequant * mult

    def count_ici(self, label: str, kind: str, payload_bytes: int,
                  axis_size: int) -> None:
        """Record one ring collective: ``payload_bytes`` is the TOTAL
        gathered or reduced payload (the comm model's convention); the
        wire cost per device follows the ring factors (gathers move
        ``P*(k-1)/k``, a psum ``2P*(k-1)/k``; a ring of one moves
        nothing)."""
        k = max(1, int(axis_size))
        factor = 2 if kind == "psum" else 1
        self.ici_events.append((str(label), str(kind), int(payload_bytes), k))
        self.ici_bytes += int(factor * int(payload_bytes) * (k - 1) // k)


class PassHandle:
    """The future a request returns: ``.value`` after the next execute."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None


class _Req:
    __slots__ = ("kind", "handle", "kw")

    def __init__(self, kind: str, handle: PassHandle, **kw):
        self.kind = kind
        self.handle = handle
        self.kw = kw


_KERNEL_KINDS = frozenset({"sq", "gram", "signs", "dots", "wsum", "gram_dot"})


class PassPlanner:
    """Batch statistic requests into single traversals of ``buf``.

    Args:
        buf: ``(n, d_alloc)`` update matrix in its storage dtype.  Columns
            past ``d`` are zero padding: the chunk loop never reads them
            and the kernel reads them harmlessly.
        c: column-chunk width of the chunk loop.
        d: true model width (default ``buf.shape[1]``).
        recorder: optional :class:`PassRecorder`.
        fuse: ``False`` runs one traversal per request.
        row_scale: ``(n,)`` f32 scales of a packed wire payload: the
            logical matrix is then ``row_scale[:, None] * buf``.
    """

    def __init__(self, buf: torch.Tensor, c: int, *, d: Optional[int] = None,
                 recorder: Optional[PassRecorder] = None, fuse: bool = True,
                 row_scale: Optional[torch.Tensor] = None):
        self.buf = buf
        self.n = buf.shape[0]
        self.d = int(d) if d is not None else buf.shape[1]
        self.c = min(int(c), self.d)
        self.recorder = recorder
        self.fuse = fuse
        self.row_scale = row_scale
        self._pending: List[_Req] = []
        self._folded: dict = {}
        self._mult = 1

    # -- requests -----------------------------------------------------------

    def _req(self, kind: str, **kw) -> PassHandle:
        h = PassHandle()
        self._pending.append(_Req(kind, h, **kw))
        return h

    def sq_norms(self) -> PassHandle:
        """Row squared norms ``(n,)``."""
        return self._req("sq")

    def gram(self) -> PassHandle:
        """``buf @ buf.T`` ``(n, n)``."""
        return self._req("gram")

    def sign_counts(self) -> PassHandle:
        """Per-row (pos, neg, zero) counts ``(n, 3)`` over the true width."""
        return self._req("signs")

    def dots(self, v: torch.Tensor) -> PassHandle:
        """``buf @ v`` ``(n,)`` for a ``(d,)`` vector."""
        return self._req("dots", v=v)

    def _fold(self, w: torch.Tensor) -> torch.Tensor:
        """``w * row_scale``, one tensor per ``w`` until the next execute,
        so that a weighted sum and a gram_dot of one vector still share
        their column pass (the kernel knows the pair by identity)."""
        if self.row_scale is None:
            return w
        if id(w) not in self._folded:
            self._folded[id(w)] = (w, w * self.row_scale)
        return self._folded[id(w)][1]

    def weighted_sum(self, w: torch.Tensor) -> PassHandle:
        """``w @ buf`` ``(d,)``; under ``row_scale`` the scales fold into
        ``w`` (the output is the decoded row)."""
        return self._req("wsum", w=self._fold(w))

    def gram_dot(self, w: torch.Tensor) -> PassHandle:
        """``(buf @ buf.T) @ w`` ``(n,)`` without the Gram: per chunk
        ``C_new @ (C.T @ w)``.  ``buf @ wavg(w) = gram_dot(w) / w.sum()``,
        so the traversal that yields an iterate's center also yields every
        distance to it.  Under ``row_scale`` one ``S`` folds into ``w``
        here and the other scales the output."""
        return self._req("gram_dot", w=self._fold(w))

    def gather(self, idx: torch.Tensor) -> PassHandle:
        """``buf[:, idx]`` ``(n, m)`` f32 (chunk loop)."""
        return self._req("gather", idx=idx)

    def col_mean_std(self, malicious: torch.Tensor) -> PassHandle:
        """Benign per-coordinate mean and ddof=1 std ``((d,), (d,))``."""
        return self._req("mean_std", malicious=malicious)

    def masked_median(self, mask: torch.Tensor,
                      row_scale: torch.Tensor) -> PassHandle:
        """Coordinate-wise median over the selected rows of
        ``buf * row_scale`` ``(d,)``."""
        if self.row_scale is not None:
            row_scale = row_scale * self.row_scale
        return self._req("masked_median", mask=mask, row_scale=row_scale)

    def coordwise(self, agg) -> PassHandle:
        """Mean / Median / Trimmedmean of the buffer, chunk by chunk."""
        return self._req("coordwise", agg=agg)

    # -- plan / execute -----------------------------------------------------

    @contextlib.contextmanager
    def loop(self, iterations: int):
        """A loop of at most ``iterations`` iterations: the body's first
        iteration counts its traversals ``iterations`` times; the loop
        calls the yielded ``tick()`` at the end of every iteration."""
        prev = self._mult
        self._mult = prev * int(iterations)

        def tick():
            self._mult = 0
            if self.recorder is not None:
                self.recorder.loop_iters += 1

        try:
            yield tick
        finally:
            self._mult = prev

    def execute(self) -> None:
        """Run every pending request: ONE traversal when fused."""
        reqs, self._pending = self._pending, []
        self._folded = {}
        if not reqs:
            return
        groups = [reqs] if self.fuse else [[r] for r in reqs]
        for group in groups:
            if {r.kind for r in group} <= _KERNEL_KINDS:
                self._run_kernel(group)
            else:
                self._run_chunked(group)
        dequant = 0
        if self.row_scale is not None:
            self._apply_row_scale(reqs)
            dequant = sum(self._dequant_rows(r) for r in reqs)
        if self.recorder is not None:
            self.recorder.count(len(groups), len(reqs), self._mult,
                                dequant=dequant)

    def _apply_row_scale(self, reqs) -> None:
        """Scale the statistics the passes took of the stored payload;
        the folded kinds carried their ``S`` in, the chunk-only row
        materializers scaled each slice."""
        s = self.row_scale
        for r in reqs:
            v = r.handle.value
            if r.kind == "sq":
                r.handle.value = v * (s * s)
            elif r.kind == "gram":
                r.handle.value = v * (s[:, None] * s[None, :])
            elif r.kind in ("dots", "gram_dot"):
                r.handle.value = v * s
            elif r.kind == "gather":
                r.handle.value = v * s[:, None]

    def _dequant_rows(self, r: _Req) -> int:
        """Full-width f32 rows request ``r`` decodes from the payload."""
        if r.kind in ("wsum", "masked_median", "coordwise"):
            return 1
        if r.kind == "mean_std":
            return 2
        if r.kind == "gather":
            return -(-self.n * int(r.kw["idx"].shape[0]) // self.d)
        return 0

    def _run_kernel(self, reqs) -> None:
        kinds = {r.kind for r in reqs}

        def stacked(kind, key):
            vals = [r.kw[key] for r in reqs if r.kind == kind]
            return torch.stack(vals) if vals else None

        dots = stacked("dots", "v")
        pad = self.buf.shape[1] - self.d
        if dots is not None and pad:  # (R, d) -> (R, d_alloc), zeros
            dots = torch.nn.functional.pad(dots, (0, pad))
        # A gram_dot vector that IS a weighted-sum vector (GeoMed's and
        # Centeredclipping's iterates) shares its column pass: known by
        # identity, so nothing waits for the device to compare values.
        ws = [r.kw["w"] for r in reqs if r.kind == "wsum"]
        shared = tuple(next((j for j, w in enumerate(ws) if w is r.kw["w"]),
                            -1)
                       for r in reqs if r.kind == "gram_dot")
        out = row_stats_bundle(
            self.buf, sq="sq" in kinds, gram="gram" in kinds,
            signs="signs" in kinds, dots=dots, weights=stacked("wsum", "w"),
            gram_dot=stacked("gram_dot", "w"),
            gram_dot_shared=shared if any(j >= 0 for j in shared) else None,
            d_true=self.d)
        if self.recorder is not None:
            self.recorder.kernel_bundles += 1
        seen = {"dots": 0, "wsum": 0, "gram_dot": 0}
        for r in reqs:
            if r.kind in ("sq", "gram", "signs"):
                r.handle.value = out[r.kind]
            elif r.kind == "wsum":
                r.handle.value = out["wsum"][seen["wsum"]]
                seen["wsum"] += 1
            else:
                r.handle.value = out[r.kind][:, seen[r.kind]]
                seen[r.kind] += 1

    def _run_chunked(self, reqs) -> None:
        accs = [self._init(r) for r in reqs]
        c, _, starts = chunk_grid(self.d, self.c)
        for i, start in enumerate(starts):
            chunk = self.buf[:, start:start + c].float()
            new = new_cols(start, i, c, chunk.device)
            accs = [self._update(r, acc, chunk, start, new)
                    for r, acc in zip(reqs, accs)]
        for r, acc in zip(reqs, accs):
            r.handle.value = acc

    # per-kind accumulator init/update: the reference chunk math

    def _init(self, r: _Req):
        n, d = self.n, self.d
        f32 = dict(dtype=torch.float32, device=self.buf.device)
        if r.kind == "sq":
            return torch.zeros((n,), **f32)
        if r.kind == "gram":
            return torch.zeros((n, n), **f32)
        if r.kind == "signs":
            return torch.zeros((n, 3), **f32)
        if r.kind in ("dots", "gram_dot"):
            return torch.zeros((n,), **f32)
        if r.kind in ("wsum", "masked_median", "coordwise"):
            return torch.zeros((d,), **f32)
        if r.kind == "gather":
            return torch.zeros((n, r.kw["idx"].shape[0]), **f32)
        if r.kind == "mean_std":
            return (torch.zeros((d,), **f32), torch.zeros((d,), **f32))
        raise ValueError(f"unknown request kind {r.kind!r}")

    def _update(self, r: _Req, acc, chunk, start: int, new):
        kind, c = r.kind, chunk.shape[1]
        zero = torch.zeros((), dtype=chunk.dtype, device=chunk.device)
        if kind == "sq":
            return acc + torch.where(new[None, :], chunk * chunk, zero).sum(1)
        if kind == "gram":
            return acc + torch.where(new[None, :], chunk, zero) @ chunk.T
        if kind == "signs":
            m = new[None, :]
            return acc + torch.stack([((chunk > 0) & m).sum(1),
                                      ((chunk < 0) & m).sum(1),
                                      ((chunk == 0) & m).sum(1)], 1).float()
        if kind == "dots":
            vc = r.kw["v"][start:start + c]
            return acc + chunk @ torch.where(new, vc, zero)
        if kind == "wsum":
            acc[start:start + c] = r.kw["w"] @ chunk  # overlap: idempotent
            return acc
        if kind == "gram_dot":
            t = chunk.T @ r.kw["w"]
            return acc + torch.where(new[None, :], chunk, zero) @ t
        if kind == "gather":
            idx = r.kw["idx"].to(chunk.device)
            pos = idx - start
            inside = (pos >= 0) & (pos < c)
            vals = chunk.index_select(1, pos.clamp(0, c - 1))
            return torch.where(inside[None, :], vals, acc)
        if kind == "mean_std":
            if self.row_scale is not None:  # decode the in-flight slice
                chunk = chunk * self.row_scale[:, None]
            mean_acc, std_acc = acc
            w = (~r.kw["malicious"]).float()
            nb = w.sum().clamp(min=1.0)
            m = (chunk * w[:, None]).sum(0) / nb
            v = (((chunk - m) ** 2 * w[:, None]).sum(0)
                 / (nb - 1.0).clamp(min=1.0))
            mean_acc[start:start + c] = m
            std_acc[start:start + c] = torch.sqrt(v)
            return acc
        if kind == "masked_median":
            acc[start:start + c] = masked.masked_median(
                chunk * r.kw["row_scale"][:, None], r.kw["mask"])
            return acc
        if kind == "coordwise":
            if self.row_scale is not None:  # decode the in-flight slice
                chunk = chunk * self.row_scale[:, None]
            acc[start:start + c] = r.kw["agg"].aggregate(chunk)
            return acc
        raise ValueError(f"unknown request kind {kind!r}")


def aggregate_coordwise(agg, buf: torch.Tensor, c: int, *,
                        d: Optional[int] = None,
                        recorder: Optional[PassRecorder] = None
                        ) -> torch.Tensor:
    """Mean / Median / Trimmedmean of the buffer's first ``d`` columns
    (default all) chunk by chunk: the finish of a round whose row-geometry
    forge is already in the buffer."""
    p = PassPlanner(buf, c, d=d, recorder=recorder)
    h = p.coordwise(agg)
    p.execute()
    return h.value


# ---------------------------------------------------------------------------
# row-geometry forgers: fused statistics bundles -> one forged (d,) row
# ---------------------------------------------------------------------------


def forge_streamed(adv, buf, malicious, sq, aggregator,
                   planner: PassPlanner, *, generator=None, draws=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forged ``(d,)`` row of a row-geometry attack on the buffer
    (``d = planner.d``, the true width), and the row squared norms (not
    yet reflecting the forged rows).

    Mirrors the dense ``on_updates_ready`` with the matrix geometry taken
    as planner bundles: MinMax takes its benign mean/std, the Gram and
    (when ``sq`` is None) the row norms in ONE traversal and its candidate
    dots in a second; Attackclippedclustering likewise.  SignGuard's
    ``draws`` ``(rank, uniforms)`` come from ``generator`` when absent.
    """
    pl_ = planner
    benign = ~malicious
    w = benign.float()

    if isinstance(adv, MinMaxAdversary):
        h_sq = pl_.sq_norms() if sq is None else None
        h_ms = pl_.col_mean_std(malicious)
        h_g = pl_.gram()
        pl_.execute()
        if h_sq is not None:
            sq = h_sq.value
        mean, dev = h_ms.value
        if isinstance(aggregator, Signguard):
            dev = _negate_first_half(dev)
        d2 = (sq[:, None] + sq[None, :] - 2.0 * h_g.value).clamp(min=0.0)
        threshold = (d2 * (w[:, None] * w[None, :])).max().clamp(min=0.0).sqrt()
        h_dm = pl_.dots(mean)
        h_dv = pl_.dots(dev)
        pl_.execute()
        return adv.forged_row(mean, dev, sq, h_dm.value, h_dv.value,
                              threshold, benign), sq

    if isinstance(adv, SignGuardAdversary):
        h_sq = pl_.sq_norms() if sq is None else None
        h_ms = pl_.col_mean_std(malicious)
        pl_.execute()
        if h_sq is not None:
            sq = h_sq.value
        mean, _ = h_ms.value
        rank, u = draws if draws is not None else adv.draw(
            mean.shape[0], generator, mean.device)
        return adv.forged_row(mean, rank, u), sq

    if isinstance(adv, AttackclippedclusteringAdversary):
        h_sq = pl_.sq_norms() if sq is None else None
        h_ms = pl_.col_mean_std(malicious)
        h_g = pl_.gram()
        pl_.execute()
        if h_sq is not None:
            sq = h_sq.value
        mean, _ = h_ms.value
        q = 1.0 / sq.clamp(min=0.0).sqrt().clamp(min=1e-12)
        mean_hat = mean / (mean * mean).sum().sqrt().clamp(min=1e-12)
        h_c2m = pl_.dots(mean_hat)
        pl_.execute()
        forged = adv.forged_row(
            mean, q[:, None] * q[None, :] * h_g.value, h_c2m.value * q,
            benign, lambda i: buf[i, :pl_.d].float() * q[i])
        return forged, sq

    raise NotImplementedError(f"no streamed forge for {type(adv).__name__}")


def _masked_mean_w(mask: torch.Tensor, row_scale: torch.Tensor
                   ) -> torch.Tensor:
    """Row weights reproducing ``masked.masked_mean`` (with its empty-mask
    degradation to all rows) of the row-scaled matrix."""
    m = masked._nonempty(mask).float()
    return m * row_scale / m.sum()


# ---------------------------------------------------------------------------
# aggregator implementations: each returns (aggregate, sq), with sq passed
# through or fused into the first statistics bundle
# ---------------------------------------------------------------------------


def _geomed(agg: GeoMed, pl_: PassPlanner, sq):
    n = pl_.n
    w0 = torch.ones((n,), dtype=torch.float32, device=pl_.buf.device) / n
    # One traversal per iterate: the weighted row sum that IS the new
    # median and the gram_dot whose algebra gives every distance to it.
    h_sq = pl_.sq_norms() if sq is None else None
    h_m0 = pl_.weighted_sum(w0)
    h_gd0 = pl_.gram_dot(w0)
    pl_.execute()
    if h_sq is not None:
        sq = h_sq.value

    def derive(m_raw, gd, w):
        W = w.sum()
        d2 = sq - 2.0 * gd / W + (w @ gd) / (W * W)
        dists = d2.clamp(min=0.0).sqrt()
        return m_raw / W, dists, (dists * w0).sum() / w0.sum()

    median, dists, obj = derive(h_m0.value, h_gd0.value, w0)
    prev = torch.tensor(float("inf"), device=obj.device)
    i = 0
    with pl_.loop(agg.maxiter) as tick:
        # The stopping test reads the objective on the host each iteration.
        while i < agg.maxiter and bool(
                torch.abs(prev - obj) > agg.ftol * obj):
            w_k = w0 / dists.clamp(min=agg.eps)
            h_m = pl_.weighted_sum(w_k)
            h_gd = pl_.gram_dot(w_k)
            pl_.execute()
            prev = obj
            median, dists, obj = derive(h_m.value, h_gd.value, w_k)
            i += 1
            tick()
    return median, sq


def _multikrum(agg: Multikrum, pl_: PassPlanner, sq):
    agg.check(pl_.n)
    h_sq = pl_.sq_norms() if sq is None else None
    h_g = pl_.gram()
    pl_.execute()  # norms + Gram: ONE traversal
    if h_sq is not None:
        sq = h_sq.value
    mask = _krum_mask(sq, h_g.value, agg.num_byzantine, agg.k)
    h_out = pl_.weighted_sum(_masked_mean_w(mask, torch.ones_like(sq)))
    pl_.execute()
    return h_out.value, sq


def _dnc(agg: DnC, pl_: PassPlanner, sq, generator, draws):
    n, d = pl_.n, pl_.d
    keep = agg.keep(n)
    # Every iteration's columns in ONE gather, fused with the row norms.
    idxs = (draws if draws is not None
            else agg.draw(d, generator, pl_.buf.device))
    idxs = idxs.to(pl_.buf.device)
    h_sq = pl_.sq_norms() if sq is None else None
    h_sub = pl_.gather(idxs.reshape(-1))
    pl_.execute()
    if h_sq is not None:
        sq = h_sq.value
    subs = h_sub.value.reshape(n, idxs.shape[0], idxs.shape[1]).transpose(0, 1)
    benign = agg.select(subs, keep)
    h_out = pl_.weighted_sum(_masked_mean_w(benign, torch.ones_like(sq)))
    pl_.execute()
    return h_out.value, sq


def _centeredclipping(agg: Centeredclipping, pl_: PassPlanner, sq, state):
    n, d = pl_.n, pl_.d
    center = state
    if center is None or (isinstance(center, tuple) and not center):
        center = torch.zeros((d,), dtype=torch.float32, device=pl_.buf.device)
    # buf @ center once (fused with the norms); then each clip iteration is
    # ONE traversal: the clipped weighted sum that moves the center and the
    # gram_dot that advances buf @ center alongside it.
    h_sq = pl_.sq_norms() if sq is None else None
    h_dots = pl_.dots(center)
    pl_.execute()
    if h_sq is not None:
        sq = h_sq.value
    dots = h_dots.value
    with pl_.loop(agg.n_iter) as tick:
        for _ in range(agg.n_iter):
            dist = (sq - 2.0 * dots + center @ center).clamp(min=0.0).sqrt()
            scale = torch.clamp(agg.tau / dist.clamp(min=1e-12), max=1.0)
            h_ws = pl_.weighted_sum(scale)
            h_gd = pl_.gram_dot(scale)
            pl_.execute()
            s_sum = scale.sum()
            center, dots = (center + (h_ws.value - s_sum * center) / n,
                            dots + (h_gd.value - s_sum * dots) / n)
            tick()
    return center, center, sq


def _signguard(agg: Signguard, pl_: PassPlanner, sq):
    h_sq = pl_.sq_norms() if sq is None else None
    h_sc = pl_.sign_counts()
    pl_.execute()  # norms + sign features: ONE traversal
    if h_sq is not None:
        sq = h_sq.value
    norms = sq.clamp(min=0.0).sqrt()
    M = masked.median(norms[:, None])[0]
    scale = torch.clamp(M / norms.clamp(min=1e-12), max=1.0)
    cnorms = torch.minimum(norms, M)
    s1 = (cnorms >= 0.1 * M) & (cnorms <= 3.0 * M)
    # A positive row scale never changes a coordinate's sign.
    mask = s1 & clustering.kmeans_majority(h_sc.value / pl_.d)
    if agg.agg == "mean":
        h_out = pl_.weighted_sum(_masked_mean_w(mask, scale))
    else:
        h_out = pl_.masked_median(masked._nonempty(mask), scale)
    pl_.execute()
    return h_out.value, sq


def _clippedclustering(agg: Clippedclustering, pl_: PassPlanner, sq, state):
    h_sq = pl_.sq_norms() if sq is None else None
    h_g = pl_.gram()
    h_sc = pl_.sign_counts() if agg.signguard else None
    pl_.execute()  # norms + Gram (+ sign features): ONE traversal
    if h_sq is not None:
        sq = h_sq.value
    norms = sq.clamp(min=0.0).sqrt()
    threshold, new_state = agg.clip_threshold(norms, state)
    scale = torch.clamp(threshold / norms.clamp(min=1e-12), max=1.0)
    cnorm = norms * scale
    q = scale / cnorm.clamp(min=1e-12)
    dist = 1.0 - torch.clamp(q[:, None] * q[None, :] * h_g.value, -1.0, 1.0)
    zero = cnorm < 1e-12
    dist = torch.where(zero[:, None] | zero[None, :],
                       torch.full_like(dist, 2.0), dist)
    mask = clustering.agglomerative_majority(dist, linkage=agg.linkage)
    if agg.signguard:
        mask = mask & clustering.kmeans_majority(h_sc.value / pl_.d)
    if agg.agg == "mean":
        h_out = pl_.weighted_sum(_masked_mean_w(mask, scale))
    else:
        h_out = pl_.masked_median(masked._nonempty(mask), scale)
    pl_.execute()
    return h_out.value, new_state, sq


def _fltrust(pl_: PassPlanner, sq, trusted):
    if trusted is None:
        raise ValueError(
            "FLTrust requires trusted_update (the server's root-data "
            "update); without it the defense has no root of trust")
    h_sq = pl_.sq_norms() if sq is None else None
    h_dots = pl_.dots(trusted)
    pl_.execute()  # norms + trusted-row dots: ONE traversal
    if h_sq is not None:
        sq = h_sq.value
    s_norm = (trusted * trusted).sum().sqrt()
    c_norm = sq.clamp(min=0.0).sqrt().clamp(min=1e-12)
    trust = torch.relu(h_dots.value / (c_norm * s_norm.clamp(min=1e-12)))
    h_out = pl_.weighted_sum(trust * (s_norm / c_norm))
    pl_.execute()
    return h_out.value / trust.sum().clamp(min=1e-12), sq


def aggregate_streamed(
    agg,
    buf: torch.Tensor,
    sq: Optional[torch.Tensor] = None,
    state: Any = (),
    *,
    generator: Optional[torch.Generator] = None,
    draws=None,
    trusted: Optional[torch.Tensor] = None,
    d_chunk: int = 1 << 17,
    d: Optional[int] = None,
    recorder: Optional[PassRecorder] = None,
    fuse: bool = True,
    planner: Optional[PassPlanner] = None,
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Run a row-geometry aggregator over the streamed buffer.

    Args:
        agg: an instance of one of ``STREAMED_ROW_AGGREGATORS``.
        buf: ``(n, d_alloc)`` post-forge update matrix in its storage
            dtype; columns past ``d`` are zero padding.
        sq: ``(n,)`` f32 row squared norms of ``buf``, or ``None``: the
            norms request then fuses into the first statistics bundle.
        state: the aggregator state (``ServerState.agg_state``).
        generator / draws: DnC's column subsamples (drawn when absent).
        trusted: the server's root-data update (FLTrust).
        d: true model width (default ``buf.shape[1]``).
        recorder / fuse: see :class:`PassPlanner`.
        planner: a planner over ``buf`` to use instead (the wire domain's,
            with its row scales); ``d_chunk``, ``d``, ``recorder`` and
            ``fuse`` are then its own.

    Returns ``(aggregate (d,) f32, new_state, sq (n,) f32)``.
    """
    pl_ = planner or PassPlanner(buf, d_chunk, d=d, recorder=recorder,
                                 fuse=fuse)
    if isinstance(agg, GeoMed):
        out, sq = _geomed(agg, pl_, sq)
        return out, state, sq
    if isinstance(agg, Multikrum):
        out, sq = _multikrum(agg, pl_, sq)
        return out, state, sq
    if isinstance(agg, DnC):
        out, sq = _dnc(agg, pl_, sq, generator, draws)
        return out, state, sq
    if isinstance(agg, Centeredclipping):
        return _centeredclipping(agg, pl_, sq, state)
    if isinstance(agg, Signguard):
        out, sq = _signguard(agg, pl_, sq)
        return out, state, sq
    if isinstance(agg, Clippedclustering):
        return _clippedclustering(agg, pl_, sq, state)
    if isinstance(agg, FLTrust):
        out, sq = _fltrust(pl_, sq, trusted)
        return out, state, sq
    raise NotImplementedError(
        f"no streamed formulation for {type(agg).__name__}")


def aggregate_wire(
    agg,
    q: torch.Tensor,
    scales: Optional[torch.Tensor],
    *,
    state: Any = (),
    generator: Optional[torch.Generator] = None,
    draws=None,
    trusted: Optional[torch.Tensor] = None,
    d_chunk: int = 1 << 17,
    d: Optional[int] = None,
    recorder: Optional[PassRecorder] = None,
    fuse: bool = True,
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Aggregate a packed wire payload without the dense f32 matrix.

    Args:
        agg: an instance of one of :data:`WIRE_AGGREGATORS`.
        q: ``(n, d_alloc)`` payload, int8 under the quant codecs (zero past
            ``d``), or the f32 updates when ``scales`` is None (the
            identity wire: the plain statistics).
        scales: ``(n,)`` f32 row scales, or None.
        state / generator / draws / trusted: as :func:`aggregate_streamed`.
        d: true model width (default ``q.shape[1]``).

    Returns ``(aggregate (d,) f32, new_state, sq (n,) f32)``, ``sq`` the
    decoded rows' squared norms.  Against decode-then-f32: Median and
    Trimmedmean rank the same decoded values and are exact; Mean and the
    row-geometry seven differ by f32 reassociation.
    """
    pl_ = PassPlanner(q, d_chunk, d=d, recorder=recorder, fuse=fuse,
                      row_scale=scales)
    if isinstance(agg, (Mean, Median, Trimmedmean)):
        n = pl_.n
        h_sq = pl_.sq_norms()
        if isinstance(agg, Mean):
            h_out = pl_.weighted_sum(torch.full(
                (n,), 1.0 / n, dtype=torch.float32, device=q.device))
        else:
            h_out = pl_.coordwise(agg)
        pl_.execute()  # the norms and the aggregate: ONE traversal
        return h_out.value, state, h_sq.value
    if isinstance(agg, STREAMED_ROW_AGGREGATORS):
        return aggregate_streamed(agg, q, None, state, generator=generator,
                                  draws=draws, trusted=trusted,
                                  planner=pl_)
    raise NotImplementedError(
        f"no wire-domain formulation for {type(agg).__name__}")
