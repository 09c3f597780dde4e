"""Byzantine-robust aggregators as ``(n, d) -> (d,)`` tensor programs
(counterpart of ``blades_tpu/ops/aggregators.py``).

Every aggregator is a frozen-dataclass config whose ``__call__`` maps
``(updates, state)`` to ``(aggregate, new_state)``; the two stateful ones
(Centeredclipping's momentum, Clippedclustering's norm history) thread
explicit state.  Row selections are boolean masks
(:mod:`blades_tpu_torch.ops.masked`); clustering is
:mod:`blades_tpu_torch.ops.clustering`.  These dense versions are the
reference semantics the streamed planner
(:mod:`blades_tpu_torch.parallel.streamed_geometry`) is held against.

``Median`` and ``Trimmedmean`` reduce through
:mod:`blades_tpu_torch.ops.column_select`: the CUDA kernel on a CUDA
tensor, the plain version on a CPU tensor.  DnC's column subsamples are
an input (``draws``) or come from the caller's ``torch.Generator``.

Partial participation (the fault injector's ``(n,)`` participation mask):
``masked_call`` takes the dense ``__call__`` when every lane participates
(a host branch, bit-identical to the dense call) and ``_masked``
otherwise: Mean, Median, Trimmedmean, DnC, Multikrum and FLTrust have
exact masked formulations whose counts follow the participating count
``m``; the rest impute dropped rows with the participants' coordinate-wise
median and run the dense call.  The participants' median and trimmed mean
compact the participating rows and take the column selects (the CUDA
kernel on a card), as ``sort`` of the +inf-padded matrix would give them;
a column whose compacted result is NaN (a participant's NaN reached the
middle) is recomputed from the padded sort, whose +inf pad sorts below
NaN, so that the JAX result stands there too.

Defense forensics: every aggregator also exposes ``diagnose(updates,
state) -> (aggregate, new_state, diag)`` and ``masked_diagnose``, where
``diag`` is the per-lane bundle of :func:`lane_diag`: ``benign_mask``
((n,) bool, the lanes the defense kept) and ``scores`` ((n,) f32, the
aggregator's native per-lane statistic: Krum scores, DnC projection
energies, clip factors, FLTrust cosines, trimmed-mean trim fractions, or
for the aggregators that exclude no lane the distance to the aggregate).
The aggregate ``diagnose`` returns is the computation ``__call__`` runs
(the selection aggregators derive both from one shared selection; Median
and Trimmedmean reduce through the same column select), so arming
forensics does not change a bit of the round.  Under partial
participation ``masked_call`` runs ``_masked`` (the aggregate alone) and
``masked_diagnose`` runs ``_masked_diag`` (the aggregate by the same
computation, then the bundle), so a forensics-off round computes no
per-lane score.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from blades_tpu_torch.ops import clustering, masked
from blades_tpu_torch.ops.column_select import column_median, column_trimmed_mean
from blades_tpu_torch.ops.layout import clip_rows_to_norm, row_norms

#: Columns per chunk of the per-lane scores that read the whole matrix:
#: Trimmedmean's trim-fraction ranks (two ``argsort`` passes of int64
#: ranks, ``n * DIAG_CHUNK * 8`` bytes each) and the distance to the
#: aggregate (an ``(n, DIAG_CHUNK)`` difference).
DIAG_CHUNK = 1 << 17


def lane_diag(benign_mask: torch.Tensor, scores: torch.Tensor) -> dict:
    """The per-lane diagnostics bundle: ``benign_mask`` (n,) bool (the
    lanes the defense kept) and ``scores`` (n,) f32 (the aggregator's
    per-lane statistic; its polarity is documented on each)."""
    return {"benign_mask": benign_mask.bool(),
            "scores": scores.to(torch.float32)}


def _keep_all_diag(updates: torch.Tensor, scores=None) -> dict:
    n = updates.shape[0]
    if scores is None:
        scores = torch.zeros((n,), dtype=torch.float32,
                             device=updates.device)
    return lane_diag(torch.ones((n,), dtype=torch.bool,
                                device=updates.device), scores)


def distance_to(updates: torch.Tensor, agg: torch.Tensor,
                chunk: int = DIAG_CHUNK) -> torch.Tensor:
    """Each row's L2 distance to ``agg``, ``row_norms(updates - agg)``
    taken ``chunk`` columns at a time with f32 partial sums, so the
    transient is one ``(n, chunk)`` difference and not an ``(n, d)``
    copy."""
    d = updates.shape[1]
    sq = torch.zeros((updates.shape[0],), dtype=torch.float32,
                     device=updates.device)
    for c0 in range(0, d, chunk):
        diff = updates[:, c0:c0 + chunk] - agg[None, c0:c0 + chunk]
        sq += (diff * diff).sum(1, dtype=torch.float32)
        del diff
    return sq.sqrt()


def _distance_diag(updates: torch.Tensor, agg: torch.Tensor) -> dict:
    """Keep-all mask, each lane scored by its L2 distance to the
    aggregate."""
    return _keep_all_diag(updates, distance_to(updates, agg))


def trim_fraction(x: torch.Tensor, k: int, part=None,
                  chunk: int = DIAG_CHUNK) -> torch.Tensor:
    """Each row's share of the columns where its stable rank falls in
    the trimmed ``[0, k)`` or ``[m - k, m)``: ``m`` the row count, or
    with ``part`` (an ``(n,)`` participation mask) the participating
    count, the dropped rows read as +inf so they rank past the window.
    The ranks are ``argsort(argsort(column))`` with stable sorts, as
    JAX's sort is, taken ``chunk`` columns at a time."""
    n, d = x.shape
    m = n if part is None else int(part.sum())
    count = torch.zeros((n,), dtype=torch.int64, device=x.device)
    for c0 in range(0, d, chunk):
        cols = x[:, c0:c0 + chunk]
        if part is not None:
            cols = torch.where(part[:, None], cols,
                               torch.full_like(cols, float("inf")))
        ranks = torch.argsort(torch.argsort(cols, dim=0, stable=True),
                              dim=0, stable=True)
        trimmed = (ranks < k) | ((ranks >= m - k) & (ranks < m))
        count += trimmed.sum(1)
        del ranks, trimmed
    frac = count.to(torch.float32)
    # A tensor divisor: ATen divides by a scalar as a multiply by its
    # reciprocal, which is not JAX's mean.
    return frac / torch.full_like(frac, float(d))


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Stateless, keyless aggregators override :meth:`aggregate` (and
    :meth:`aggregate_diag` where they judge lanes)."""

    def init(self, num_params: int, num_clients: int, device=None):
        del num_params, num_clients, device
        return ()

    def aggregate(self, updates: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def aggregate_diag(self, updates: torch.Tensor):
        """``(aggregate, diag)``.  Default: keep every lane, scored by its
        L2 distance to the aggregate (the aggregators that exclude no
        lane: Mean, Median, GeoMed)."""
        agg = self.aggregate(updates)
        return agg, _distance_diag(updates, agg)

    def __call__(self, updates: torch.Tensor, state=(), *, generator=None,
                 draws=None):
        del generator, draws
        return self.aggregate(updates), state

    def diagnose(self, updates: torch.Tensor, state=(), *, generator=None,
                 draws=None):
        """:meth:`__call__` plus the per-lane bundle: ``(aggregate,
        new_state, diag)``, the aggregate the same computation."""
        del generator, draws
        agg, diag = self.aggregate_diag(updates)
        return agg, state, diag

    def masked_call(self, updates: torch.Tensor, participation: torch.Tensor,
                    state=(), *, generator=None, draws=None):
        """Aggregate over the lanes where ``participation`` (n,) is True:
        the dense call itself when every lane participates."""
        if bool(participation.all()):
            return self(updates, state, generator=generator, draws=draws)
        return self._masked(updates, participation, state,
                            generator=generator, draws=draws)

    def masked_diagnose(self, updates: torch.Tensor,
                        participation: torch.Tensor, state=(), *,
                        generator=None, draws=None):
        """:meth:`masked_call` plus the per-lane bundle; under dropout the
        ``benign_mask`` covers participating lanes only (a dropped lane
        was never judged, so it is not "kept")."""
        if bool(participation.all()):
            return self.diagnose(updates, state, generator=generator,
                                 draws=draws)
        return self._masked_diag(updates, participation, state,
                                 generator=generator, draws=draws)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        """``(aggregate, new_state)`` over the participating lanes.
        Dropped rows imputed with the participants' coordinate-wise median
        (a robust center: the active mean is corruptible), then the dense
        call."""
        return self(_impute(updates, participation), state,
                    generator=generator, draws=draws)

    def _masked_diag(self, updates, participation, state=(), *,
                     generator=None, draws=None):
        """:meth:`_masked` plus the bundle: ``(aggregate, new_state,
        diag)``, the dense diagnosis of the imputed matrix."""
        agg, new_state, diag = self.diagnose(
            _impute(updates, participation), state, generator=generator,
            draws=draws)
        bm = diag["benign_mask"]
        if bm.shape[0] == participation.shape[0]:
            diag = lane_diag(bm & participation.to(bm.device),
                             diag["scores"])
        return agg, new_state, diag


def _impute(updates, participation):
    """Dropped rows replaced by the participants' coordinate-wise
    median."""
    fill = participant_median(updates, participation)
    return torch.where(participation[:, None], updates, fill[None, :])


def _fix_nan_columns(out, x, mask, padded):
    """Recompute from ``padded(x[:, cols], mask)`` the columns where the
    compacted ``out`` is NaN (a host read of their count)."""
    bad = torch.isnan(out).nonzero().flatten()
    if bad.numel():
        out[bad] = padded(x.index_select(1, bad), mask).to(out.dtype)
    return out


def participant_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``masked.masked_median(x, mask)`` through the column median of the
    participating rows."""
    mask = masked._nonempty(mask)
    rows = x.index_select(0, mask.nonzero().flatten())
    return _fix_nan_columns(column_median(rows), x, mask,
                            masked.masked_median)


def participant_trimmed_mean(x: torch.Tensor, mask: torch.Tensor,
                             k: int) -> torch.Tensor:
    """``masked.masked_trimmed_mean(x, mask, k)`` through the column
    trimmed mean of the participating rows (``2k`` below their count)."""
    mask = masked._nonempty(mask)
    rows = x.index_select(0, mask.nonzero().flatten())
    return _fix_nan_columns(
        column_trimmed_mean(rows, k), x, mask,
        lambda xc, mc: masked.masked_trimmed_mean(xc, mc, k))


@dataclasses.dataclass(frozen=True)
class Mean(Aggregator):
    """Plain FedAvg mean."""

    def aggregate(self, updates):
        return updates.mean(0)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        return masked.masked_mean(updates, participation), state

    def _masked_diag(self, updates, participation, state=(), *,
                     generator=None, draws=None):
        agg, state = self._masked(updates, participation, state)
        return agg, state, lane_diag(participation,
                                     distance_to(updates, agg))


@dataclasses.dataclass(frozen=True)
class Median(Aggregator):
    """Coordinate-wise median (midpoint of the two middle values)."""

    def aggregate(self, updates):
        return column_median(updates)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        return participant_median(updates, participation), state

    def _masked_diag(self, updates, participation, state=(), *,
                     generator=None, draws=None):
        agg, state = self._masked(updates, participation, state)
        return agg, state, lane_diag(participation,
                                     distance_to(updates, agg))


@dataclasses.dataclass(frozen=True)
class Trimmedmean(Aggregator):
    """Coordinate-wise trimmed mean: drops the ``k`` largest and smallest
    values per coordinate, ``k = filter_frac * num_byzantine`` rounded up
    to an even integer, then means the rest."""

    num_byzantine: int
    filter_frac: float = 1.0

    @property
    def num_excluded(self) -> int:
        k = int(self.filter_frac * self.num_byzantine)
        return k if k % 2 == 0 else k + 1

    def aggregate(self, updates):
        n, k = updates.shape[0], self.num_excluded
        if n <= 2 * k:
            raise ValueError(
                f"Trimmedmean needs > 2*num_excluded={2 * k} clients, got {n}")
        return column_trimmed_mean(updates, k)

    def aggregate_diag(self, updates):
        """Score = each lane's TRIM FRACTION (its share of the columns
        where it fell in the dropped top-k / bottom-k; 2k/n for an
        average lane, -> 1 for a lane trimmed everywhere); benign_mask =
        trim fraction < 0.5.  The aggregate is :meth:`aggregate`, its
        column select included."""
        agg = self.aggregate(updates)
        frac = trim_fraction(updates, self.num_excluded)
        return agg, lane_diag(frac < 0.5, frac)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        """The trim count clamped to ``(m - 1) // 2`` of the participating
        count ``m``, so one lane always survives the trim."""
        m = int(masked._nonempty(participation).sum())
        k = min(self.num_excluded, max((m - 1) // 2, 0))
        return participant_trimmed_mean(updates, participation, k), state

    def _masked_diag(self, updates, participation, state=(), *,
                     generator=None, draws=None):
        """The trim fractions rank the participants only (+inf pushes the
        dropped rows past the window)."""
        agg, state = self._masked(updates, participation, state)
        part = participation.to(updates.device)
        m = int(part.sum())
        k = min(self.num_excluded, max((m - 1) // 2, 0))
        frac = trim_fraction(updates, k, part)
        return agg, state, lane_diag(part & (frac < 0.5), frac)


def _empty(state) -> bool:
    return state is None or (isinstance(state, tuple) and not state)


@dataclasses.dataclass(frozen=True)
class GeoMed(Aggregator):
    """Geometric median by smoothed Weiszfeld iterations: at most
    ``maxiter`` steps, stopping when the objective (weighted mean distance)
    changes by less than ``ftol * objective``.  The stopping test reads
    the objective on the host once per iteration."""

    maxiter: int = 100
    eps: float = 1e-6
    ftol: float = 1e-10

    def aggregate(self, updates):
        n = updates.shape[0]
        weights = torch.ones((n,), dtype=updates.dtype,
                             device=updates.device) / n

        def wavg(w):
            return (w[:, None] * updates).sum(0) / w.sum()

        def obj(median):
            return ((row_norms(updates - median) * weights).sum()
                    / weights.sum())

        median = wavg(weights)
        prev, cur = torch.tensor(float("inf")), obj(median)
        i = 0
        while i < self.maxiter and bool(
                torch.abs(prev - cur) > self.ftol * cur):
            denom = row_norms(updates - median).clamp(min=self.eps)
            median = wavg(weights / denom)
            prev, cur = cur, obj(median)
            i += 1
        return median


@dataclasses.dataclass(frozen=True)
class DnC(Aggregator):
    """Divide-and-Conquer spectral filter: per iteration, subsample
    ``sub_dim`` coordinates, score clients by their squared projection on
    the centered sub-updates' top right-singular vector and keep the
    ``n - filter_frac * f`` lowest; the aggregate is the mean of the union
    of the kept sets.  ``draws`` ``(num_iters, sub_dim)`` are the column
    subsamples; without them they are drawn from ``generator``."""

    num_byzantine: int
    sub_dim: int = 10000
    num_iters: int = 5
    filter_frac: float = 1.0

    def keep(self, n: int) -> int:
        keep = n - int(self.filter_frac * self.num_byzantine)
        if keep < 1:
            raise ValueError(
                f"DnC keeps n - filter_frac*num_byzantine = {keep} "
                "clients; needs >= 1")
        return keep

    def draw(self, d: int, generator, device=None) -> torch.Tensor:
        """``(num_iters, min(sub_dim, d))`` random column subsamples."""
        if generator is None:
            raise ValueError("DnC requires a generator (or pre-drawn "
                             "draws=) for its coordinate subsample")
        sub = min(self.sub_dim, d)
        return torch.stack([
            torch.randperm(d, generator=generator, device=device)[:sub]
            for _ in range(self.num_iters)])

    def select_scores(self, subs: torch.Tensor, keep: int):
        """The union keep-mask from ``(num_iters, n, sub_dim)`` subsamples
        and each lane's squared projection averaged over them."""
        benign = torch.zeros(subs.shape[1], dtype=torch.bool,
                             device=subs.device)
        scores = []
        for sub in subs:
            centered = sub - sub.mean(0)
            v = torch.linalg.svd(centered, full_matrices=False)[2][0]
            s = (centered @ v) ** 2
            rank = torch.argsort(torch.argsort(s, stable=True), stable=True)
            benign |= rank < keep
            scores.append(s)
        return benign, torch.stack(scores).mean(0)

    def select(self, subs: torch.Tensor, keep: int) -> torch.Tensor:
        """The union keep-mask of :meth:`select_scores`."""
        return self.select_scores(subs, keep)[0]

    def _run(self, updates, generator, draws):
        n, d = updates.shape
        keep = self.keep(n)
        idx = draws if draws is not None else self.draw(
            d, generator, updates.device)
        idx = idx.to(updates.device)
        subs = torch.stack([updates[:, i] for i in idx])
        benign, scores = self.select_scores(subs, keep)
        return masked.masked_mean(updates, benign), benign, scores

    def __call__(self, updates, state=(), *, generator=None, draws=None):
        return self._run(updates, generator, draws)[0], state

    def diagnose(self, updates, state=(), *, generator=None, draws=None):
        """Score = the squared projection on the top singular vector,
        averaged over the subsamples (higher = more outlying);
        benign_mask = the union keep-set the mean runs over."""
        agg, benign, scores = self._run(updates, generator, draws)
        return agg, state, lane_diag(benign, scores)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        return self._masked_diag(updates, participation, state,
                                 generator=generator, draws=draws)[:2]

    def _masked_diag(self, updates, participation, state=(), *,
                     generator=None, draws=None):
        """The keep count ``clip(m - filter_frac * f, 1, m)`` of the
        participating count ``m``; dropped lanes are zeroed out of the
        centered subsample (they cannot steer the singular vector) and
        score +inf (they never rank into the keep set)."""
        n, d = updates.shape
        part = participation.to(updates.device)
        m = int(part.sum())
        keep = min(max(m - int(self.filter_frac * self.num_byzantine), 1), m)
        idx = draws if draws is not None else self.draw(
            d, generator, updates.device)
        benign = torch.zeros((n,), dtype=torch.bool, device=updates.device)
        inf = torch.tensor(float("inf"), device=updates.device)
        scores = []
        for i in idx.to(updates.device):
            sub = updates[:, i]
            centered = torch.where(part[:, None],
                                   sub - masked.masked_mean(sub, part),
                                   torch.zeros_like(sub))
            v = torch.linalg.svd(centered, full_matrices=False)[2][0]
            s = (centered @ v) ** 2
            rank = torch.argsort(torch.argsort(torch.where(part, s, inf),
                                               stable=True), stable=True)
            benign |= (rank < keep) & part
            scores.append(s)
        if not bool(benign.any()):
            benign = part
        scores = torch.where(part, torch.stack(scores).mean(0),
                             torch.zeros_like(scores[0]))
        return (masked.masked_mean(updates, benign), state,
                lane_diag(benign, scores))


def _krum_select(sq, g, f: int, k: int):
    """Multi-Krum's selection from row squared norms and the Gram matrix:
    score = sum of the ``n - f - 2`` smallest squared distances to other
    rows; keep the ``k`` lowest scores.  Returns ``(mask, scores)``."""
    n = sq.shape[0]
    d2 = (sq[:, None] + sq[None, :] - 2.0 * g).clamp(min=0.0)
    d2 = d2.masked_fill(torch.eye(n, dtype=torch.bool, device=sq.device),
                        float("inf"))
    scores = torch.sort(d2, dim=1).values[:, :n - f - 2].sum(1)
    rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    return rank < k, scores


def _krum_mask(sq, g, f: int, k: int) -> torch.Tensor:
    """The selection mask of :func:`_krum_select`."""
    return _krum_select(sq, g, f, k)[0]


@dataclasses.dataclass(frozen=True)
class Multikrum(Aggregator):
    """Multi-Krum with the paper's squared-distance score (the reference's
    ``dist**4`` ranking is a bug the JAX package deliberately fixes); the
    aggregate is the mean of the ``k`` lowest-scoring updates."""

    num_byzantine: int
    k: int = 1

    def check(self, n: int) -> None:
        if 2 * self.num_byzantine + 2 > n:
            raise ValueError(f"Too many Byzantine workers: "
                             f"2*{self.num_byzantine}+2 > {n}")
        if not 1 <= self.k <= n:
            raise ValueError(f"k must be in [1, {n}], got {self.k}")

    def aggregate_diag(self, updates):
        """Score = the Krum score (higher = more isolated); benign_mask =
        the ``k`` lowest-scoring lanes the mean runs over."""
        self.check(updates.shape[0])
        sq = (updates * updates).sum(1)
        mask, scores = _krum_select(sq, updates @ updates.T,
                                    self.num_byzantine, self.k)
        return masked.masked_mean(updates, mask), lane_diag(mask, scores)

    def aggregate(self, updates):
        return self.aggregate_diag(updates)[0]

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        return self._masked_diag(updates, participation, state)[:2]

    def _masked_diag(self, updates, participation, state=(), *,
                     generator=None, draws=None):
        """Neighbour and selection counts of the participating count
        ``m``: score = sum of the ``max(m - f - 2, 1)`` smallest squared
        distances to other participants (dropped lanes are +inf in the
        distance matrix); the mean of the ``min(k, m)`` lowest-scoring
        participants."""
        n = updates.shape[0]
        part = participation.to(updates.device)
        m = int(part.sum())
        q = max(m - self.num_byzantine - 2, 1)
        sq = (updates * updates).sum(1)
        d2 = (sq[:, None] + sq[None, :] - 2.0 * (updates @ updates.T)
              ).clamp(min=0.0)
        out = ~part
        eye = torch.eye(n, dtype=torch.bool, device=updates.device)
        d2 = d2.masked_fill(eye | out[:, None] | out[None, :], float("inf"))
        sortd = torch.sort(d2, dim=1).values
        neigh = torch.arange(n, device=updates.device)[None, :] < q
        # where, not a product: 0 * inf in the padded tail would be NaN.
        scores = torch.where(neigh, sortd, torch.zeros_like(sortd)).sum(1)
        rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
        mask = (rank < min(self.k, m)) & part
        if not bool(mask.any()):
            mask = part
        return (masked.masked_mean(updates, mask), state,
                lane_diag(mask, scores))


@dataclasses.dataclass(frozen=True)
class Centeredclipping(Aggregator):
    """Iterative centered clipping: a momentum center ``(d,)`` carried as
    state; each call runs ``n_iter`` rounds of
    ``center += mean_i(clip(v_i - center, tau))``."""

    tau: float = 5.0
    n_iter: int = 5

    def init(self, num_params, num_clients, device=None):
        del num_clients
        return torch.zeros((num_params,), dtype=torch.float32, device=device)

    def __call__(self, updates, state=(), *, generator=None, draws=None):
        del generator, draws
        center = state
        if _empty(center):
            center = torch.zeros((updates.shape[1],), dtype=updates.dtype,
                                 device=updates.device)
        for _ in range(self.n_iter):
            center = center + clip_rows_to_norm(updates - center[None, :],
                                                self.tau).mean(0)
        return center, center

    def diagnose(self, updates, state=(), *, generator=None, draws=None):
        """Score = each lane's distance to the final center (what the
        clip tests); benign_mask = the lanes within ``tau`` of it."""
        agg, new_state = self(updates, state)
        dev = distance_to(updates, agg)
        return agg, new_state, lane_diag(dev <= self.tau, dev)


@dataclasses.dataclass(frozen=True)
class Signguard(Aggregator):
    """SignGuard: clip rows to the median norm M, keep clients whose
    clipped norm lies in ``[0.1 M, 3 M]`` and that fall in the majority
    2-means cluster of sign-fraction features, then mean (or median) the
    survivors.  ``max_tau`` and ``linkage`` are inert, as in the
    reference."""

    agg: str = "mean"
    max_tau: float = 1e5
    linkage: str = "average"

    def __post_init__(self):
        if self.agg not in ("mean", "median"):
            raise NotImplementedError(f"{self.agg} is not supported yet.")
        if self.linkage not in ("average", "single"):
            raise ValueError(f"unsupported linkage {self.linkage}")

    def aggregate_diag(self, updates):
        """Score = each lane's clip factor ``min(1, M / ||u_i||)`` (1 =
        untouched); benign_mask = the norm-band and majority-sign-cluster
        survivors the reduction runs over."""
        norms = row_norms(updates)
        M = masked.median(norms[:, None])[0]
        clipped = clip_rows_to_norm(updates, M)
        cnorms = torch.minimum(norms, M)
        s1 = (cnorms >= 0.1 * M) & (cnorms <= 3.0 * M)
        mask = s1 & clustering.kmeans_majority(
            clustering.sign_features(clipped))
        if self.agg == "mean":
            agg = masked.masked_mean(clipped, mask)
        else:
            agg = masked.masked_median(clipped, mask)
        clip_factor = torch.clamp(M / norms.clamp(min=1e-12), max=1.0)
        return agg, lane_diag(mask, clip_factor)

    def aggregate(self, updates):
        return self.aggregate_diag(updates)[0]


@dataclasses.dataclass(frozen=True)
class Clippedclustering(Aggregator):
    """Clipped clustering: clip rows to ``min(median(norm history),
    max_tau)`` (a ring buffer of ``history_rounds`` rounds of client norms
    carried as state), 2-cluster the cosine-distance matrix, keep the
    majority cluster (optionally intersected with SignGuard's k-means
    cluster), then mean (or median)."""

    agg: str = "mean"
    signguard: bool = False
    max_tau: float = 1e5
    linkage: str = "average"
    history_rounds: int = 100

    def __post_init__(self):
        if self.agg not in ("mean", "median"):
            raise NotImplementedError(f"{self.agg} is not supported yet.")
        if self.linkage not in ("average", "single"):
            raise ValueError(f"unsupported linkage {self.linkage}")

    def init(self, num_params, num_clients, device=None):
        del num_params
        return {"norm_history": torch.zeros(
                    (self.history_rounds * num_clients,),
                    dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def clip_threshold(self, norms, state):
        """Push ``norms`` into the history ring; return ``(threshold,
        new_state)``."""
        n = norms.shape[0]
        if _empty(state):
            state = self.init(0, n, norms.device)
        hist, count = state["norm_history"].clone(), state["count"]
        cap = hist.shape[0]
        pos = (count + torch.arange(n, device=norms.device)) % cap
        hist[pos] = norms.to(hist.dtype)
        count = count + n
        filled = torch.arange(cap, device=norms.device) < torch.clamp(
            count, max=cap)
        threshold = masked.masked_median(hist[:, None], filled)[0]
        threshold = torch.clamp(threshold, max=self.max_tau)
        return threshold, {"norm_history": hist, "count": count}

    def _run(self, updates, state):
        """``(aggregate, new_state, mask, clip factors)``: the one body of
        :meth:`__call__` and :meth:`diagnose`."""
        norms = row_norms(updates)
        threshold, new_state = self.clip_threshold(norms, state)
        clipped = clip_rows_to_norm(updates, threshold)
        cn = row_norms(clipped)
        normed = clipped / cn.clamp(min=1e-12)[:, None]
        dist = 1.0 - torch.clamp(normed @ normed.T, -1.0, 1.0)
        zero = cn < 1e-12
        dist = torch.where(zero[:, None] | zero[None, :],
                           torch.full_like(dist, 2.0), dist)
        mask = clustering.agglomerative_majority(dist, linkage=self.linkage)
        if self.signguard:
            mask = mask & clustering.kmeans_majority(
                clustering.sign_features(clipped))
        if self.agg == "mean":
            agg = masked.masked_mean(clipped, mask)
        else:
            agg = masked.masked_median(clipped, mask)
        clip_factor = torch.clamp(threshold / norms.clamp(min=1e-12),
                                  max=1.0)
        return agg, new_state, mask, clip_factor

    def __call__(self, updates, state=(), *, generator=None, draws=None):
        agg, new_state, _, _ = self._run(updates, state)
        return agg, new_state

    def diagnose(self, updates, state=(), *, generator=None, draws=None):
        """Score = the clip factor ``min(1, threshold / ||u_i||)``;
        benign_mask = the majority cosine cluster (intersected with
        SignGuard's when ``signguard``)."""
        agg, new_state, mask, clip_factor = self._run(updates, state)
        return agg, new_state, lane_diag(mask, clip_factor)


@dataclasses.dataclass(frozen=True)
class FLTrust(Aggregator):
    """FLTrust: trust of client i = ReLU(cos(u_i, u_server)); each client
    update is rescaled to the server update's norm and trust-weighted.
    The trusted server update is the LAST row of ``updates``."""

    expects_trusted_row: bool = True

    def aggregate_diag(self, updates):
        """The bundle covers the CLIENT rows only (the trusted row is the
        yardstick, not a lane under judgment).  Score = cos(u_i,
        u_server) (higher = more trusted); benign_mask = positive
        trust."""
        server, clients = updates[-1], updates[:-1]
        s_norm = row_norms(server[None])[0]
        c_norm = row_norms(clients).clamp(min=1e-12)
        cos = (clients @ server) / (c_norm * s_norm.clamp(min=1e-12))
        trust = torch.relu(cos)
        rescaled = clients * (s_norm / c_norm)[:, None]
        agg = ((trust[:, None] * rescaled).sum(0)
               / trust.sum().clamp(min=1e-12))
        return agg, lane_diag(trust > 0.0, cos)

    def aggregate(self, updates):
        return self.aggregate_diag(updates)[0]

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        return self._masked_diag(updates, participation, state)[:2]

    def _masked_diag(self, updates, participation, state=(), *,
                     generator=None, draws=None):
        """A dropped client gets trust 0.  ``participation`` covers the
        appended trusted row too (the server's own row participates)."""
        server, clients = updates[-1], updates[:-1]
        part = participation[:-1].to(updates.device)
        s_norm = row_norms(server[None])[0]
        c_norm = row_norms(clients).clamp(min=1e-12)
        cos = (clients @ server) / (c_norm * s_norm.clamp(min=1e-12))
        trust = torch.relu(cos) * part.to(cos.dtype)
        rescaled = clients * (s_norm / c_norm)[:, None]
        agg = ((trust[:, None] * rescaled).sum(0)
               / trust.sum().clamp(min=1e-12))
        return agg, state, lane_diag((trust > 0.0) & part, cos)


AGGREGATORS = {
    "Mean": Mean,
    "Median": Median,
    "Trimmedmean": Trimmedmean,
    "GeoMed": GeoMed,
    "DnC": DnC,
    "Multikrum": Multikrum,
    "Centeredclipping": Centeredclipping,
    "Signguard": Signguard,
    "Clippedclustering": Clippedclustering,
    "FLTrust": FLTrust,
}
_NEEDS_NUM_BYZANTINE = {"DnC", "Trimmedmean", "Multikrum"}


def get_aggregator(spec, num_byzantine: Optional[int] = None) -> Aggregator:
    """Resolve a name, ``{"type": ..., **kwargs}`` dict or instance,
    injecting ``num_byzantine`` where the aggregator needs it."""
    if isinstance(spec, Aggregator):
        return spec
    if isinstance(spec, str):
        spec = {"type": spec}
    spec = dict(spec)
    name = spec.pop("type")
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; known: "
                       f"{sorted(AGGREGATORS)}")
    if name in _NEEDS_NUM_BYZANTINE and "num_byzantine" not in spec:
        if num_byzantine is None:
            raise ValueError(f"{name} requires num_byzantine")
        spec["num_byzantine"] = int(num_byzantine)
    return AGGREGATORS[name](**spec)
