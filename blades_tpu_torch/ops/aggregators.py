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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from blades_tpu_torch.ops import clustering, masked
from blades_tpu_torch.ops.column_select import column_median, column_trimmed_mean
from blades_tpu_torch.ops.layout import clip_rows_to_norm, row_norms


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Stateless, keyless aggregators override :meth:`aggregate`."""

    def init(self, num_params: int, num_clients: int, device=None):
        del num_params, num_clients, device
        return ()

    def aggregate(self, updates: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, updates: torch.Tensor, state=(), *, generator=None,
                 draws=None):
        del generator, draws
        return self.aggregate(updates), state

    def masked_call(self, updates: torch.Tensor, participation: torch.Tensor,
                    state=(), *, generator=None, draws=None):
        """Aggregate over the lanes where ``participation`` (n,) is True:
        the dense call itself when every lane participates."""
        if bool(participation.all()):
            return self(updates, state, generator=generator, draws=draws)
        return self._masked(updates, participation, state,
                            generator=generator, draws=draws)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        """Dropped rows imputed with the participants' coordinate-wise
        median (a robust center: the active mean is corruptible), then the
        dense call."""
        fill = participant_median(updates, participation)
        filled = torch.where(participation[:, None], updates, fill[None, :])
        return self(filled, state, generator=generator, draws=draws)


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


@dataclasses.dataclass(frozen=True)
class Median(Aggregator):
    """Coordinate-wise median (midpoint of the two middle values)."""

    def aggregate(self, updates):
        return column_median(updates)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        return participant_median(updates, participation), state


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

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        """The trim count clamped to ``(m - 1) // 2`` of the participating
        count ``m``, so one lane always survives the trim."""
        m = int(masked._nonempty(participation).sum())
        k = min(self.num_excluded, max((m - 1) // 2, 0))
        return participant_trimmed_mean(updates, participation, k), state


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

    def select(self, subs: torch.Tensor, keep: int) -> torch.Tensor:
        """The union keep-mask from ``(num_iters, n, sub_dim)`` subsamples."""
        benign = torch.zeros(subs.shape[1], dtype=torch.bool,
                             device=subs.device)
        for sub in subs:
            centered = sub - sub.mean(0)
            v = torch.linalg.svd(centered, full_matrices=False)[2][0]
            s = (centered @ v) ** 2
            rank = torch.argsort(torch.argsort(s, stable=True), stable=True)
            benign |= rank < keep
        return benign

    def __call__(self, updates, state=(), *, generator=None, draws=None):
        n, d = updates.shape
        keep = self.keep(n)
        idx = draws if draws is not None else self.draw(
            d, generator, updates.device)
        idx = idx.to(updates.device)
        subs = torch.stack([updates[:, i] for i in idx])
        return masked.masked_mean(updates, self.select(subs, keep)), state

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
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
        if not bool(benign.any()):
            benign = part
        return masked.masked_mean(updates, benign), state


def _krum_mask(sq, g, f: int, k: int) -> torch.Tensor:
    """Multi-Krum's selection from row squared norms and the Gram matrix:
    score = sum of the ``n - f - 2`` smallest squared distances to other
    rows; keep the ``k`` lowest scores."""
    n = sq.shape[0]
    d2 = (sq[:, None] + sq[None, :] - 2.0 * g).clamp(min=0.0)
    d2 = d2.masked_fill(torch.eye(n, dtype=torch.bool, device=sq.device),
                        float("inf"))
    nearest = torch.sort(d2, dim=1).values[:, :n - f - 2]
    rank = torch.argsort(torch.argsort(nearest.sum(1), stable=True),
                         stable=True)
    return rank < k


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

    def aggregate(self, updates):
        self.check(updates.shape[0])
        sq = (updates * updates).sum(1)
        mask = _krum_mask(sq, updates @ updates.T, self.num_byzantine,
                          self.k)
        return masked.masked_mean(updates, mask)

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
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
        return masked.masked_mean(updates, mask), state


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

    def aggregate(self, updates):
        norms = row_norms(updates)
        M = masked.median(norms[:, None])[0]
        clipped = clip_rows_to_norm(updates, M)
        cnorms = torch.minimum(norms, M)
        s1 = (cnorms >= 0.1 * M) & (cnorms <= 3.0 * M)
        mask = s1 & clustering.kmeans_majority(
            clustering.sign_features(clipped))
        if self.agg == "mean":
            return masked.masked_mean(clipped, mask)
        return masked.masked_median(clipped, mask)


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

    def __call__(self, updates, state=(), *, generator=None, draws=None):
        del generator, draws
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
            return masked.masked_mean(clipped, mask), new_state
        return masked.masked_median(clipped, mask), new_state


@dataclasses.dataclass(frozen=True)
class FLTrust(Aggregator):
    """FLTrust: trust of client i = ReLU(cos(u_i, u_server)); each client
    update is rescaled to the server update's norm and trust-weighted.
    The trusted server update is the LAST row of ``updates``."""

    expects_trusted_row: bool = True

    def aggregate(self, updates):
        server, clients = updates[-1], updates[:-1]
        s_norm = row_norms(server[None])[0]
        c_norm = row_norms(clients).clamp(min=1e-12)
        cos = (clients @ server) / (c_norm * s_norm.clamp(min=1e-12))
        trust = torch.relu(cos)
        rescaled = clients * (s_norm / c_norm)[:, None]
        return ((trust[:, None] * rescaled).sum(0)
                / trust.sum().clamp(min=1e-12))

    def _masked(self, updates, participation, state=(), *, generator=None,
                draws=None):
        """A dropped client gets trust 0.  ``participation`` covers the
        appended trusted row too (the server's own row participates)."""
        server, clients = updates[-1], updates[:-1]
        part = participation[:-1].to(updates.device)
        s_norm = row_norms(server[None])[0]
        c_norm = row_norms(clients).clamp(min=1e-12)
        cos = (clients @ server) / (c_norm * s_norm.clamp(min=1e-12))
        trust = torch.relu(cos) * part.to(cos.dtype)
        rescaled = clients * (s_norm / c_norm)[:, None]
        return ((trust[:, None] * rescaled).sum(0)
                / trust.sum().clamp(min=1e-12)), state


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
