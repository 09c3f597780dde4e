"""Update-forging attacks (counterpart of the ALIE / IPM / Noise /
Adaptive / MinMax / SignGuard / Lazy / Attackclippedclustering subset of
``blades_tpu/adversaries/update_attacks.py``).

Each reads the benign rows' statistics and writes forged rows into the
malicious lanes.  Random inputs are arguments (``noise``: Adaptive's
per-coordinate uniforms, Noise's ``(rows, c)`` normals, Lazy's ``(lane
scores, normals)``, SignGuard's ``(rank, uniforms)``), drawn by the
caller from its generator when absent, never inside a kernel.  ``shard``
tells a forge which global columns its rows hold: a
:class:`~blades_tpu_torch.ops.layout.ChunkInfo` (a column chunk of the
streamed round) or a :class:`~blades_tpu_torch.ops.layout.ShardInfo` (the
width-sharded round's ``(n, d_local)`` shard).  On a width shard the row
geometry (MinMax's distances, SignGuard's sign census,
Attackclippedclustering's norms and Gram) is the psum of the shards'
partials, coordinate positions are global, and the draws over columns
are made at the global width from the replicated generator and sliced
(Adaptive's uniforms, SignGuard's permutation and magnitudes), so those
forged rows are the dense layout's.  Noise's and Lazy's ``(rows, c)``
normals come from a generator folded with the shard index
(``ShardInfo.fold``): deterministic per seed, not the dense draws.

MinMax, SignGuard and Attackclippedclustering need whole-row geometry;
the streamed round runs them through
:func:`blades_tpu_torch.parallel.streamed_geometry.forge_streamed`.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import torch

from blades_tpu_torch.adversaries.base import Adversary, benign_mean_std
from blades_tpu_torch.ops import clustering
from blades_tpu_torch.ops.aggregators import Signguard
from blades_tpu_torch.ops.layout import (
    ShardInfo,
    gram,
    pairwise_sq_dists,
    psum_if,
    row_dots,
    row_norms,
    slice_to_shard,
)


def _width_shard(shard):
    """``shard`` where it is a width shard (row geometry psum'd), else
    None (the dense layout, or a column chunk's full rows)."""
    return shard if isinstance(shard, ShardInfo) else None


def _negate_first_half(v: torch.Tensor, shard=None) -> torch.Tensor:
    """SignGuard evasion shared by ALIE and MinMax: negate the first
    ``d // 2`` GLOBAL coordinates of the deviation."""
    if shard is None:
        d = v.shape[0]
        coords, half = torch.arange(d, device=v.device), d // 2
    else:
        coords, half = shard.coords(v.device), shard.global_d // 2
    return torch.where(coords < half, -v, v)


@dataclasses.dataclass(frozen=True)
class ALIEAdversary(Adversary):
    """"A Little Is Enough": forged = benign mean + z_max * benign std, with
    z_max the inverse normal CDF at ``(n - f - s) / (n - f)``,
    ``s = n // 2 + 1 - f``."""

    num_clients: int = 60
    num_byzantine: int = 0

    @property
    def z_max(self) -> float:
        n, f = self.num_clients, self.num_byzantine
        s = n // 2 + 1 - f
        cdf = (n - f - s) / max(n - f, 1)
        return NormalDist().inv_cdf(min(max(cdf, 1e-9), 1.0 - 1e-9))

    def forged_row(self, updates, malicious, *, aggregator=None,
                   shard=None):
        """The ``(d,)`` row the malicious lanes receive."""
        mean, std = benign_mean_std(updates, malicious)
        if isinstance(aggregator, Signguard):
            std = _negate_first_half(std, shard)
        return mean + std * self.z_max

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del noise, generator
        return self.scatter_forged(
            updates, self.forged_row(updates, malicious,
                                     aggregator=aggregator, shard=shard),
            malicious)


@dataclasses.dataclass(frozen=True)
class IPMAdversary(Adversary):
    """Inner-product manipulation: forged = -scale * benign mean."""

    scale: float = 1.0

    def forged_row(self, updates, malicious, *, aggregator=None,
                   shard=None):
        """The ``(d,)`` row the malicious lanes receive."""
        del aggregator, shard
        mean, _ = benign_mean_std(updates, malicious)
        return -self.scale * mean

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del noise, generator
        return self.scatter_forged(
            updates, self.forged_row(updates, malicious,
                                     aggregator=aggregator, shard=shard),
            malicious)


@dataclasses.dataclass(frozen=True)
class AdaptiveAdversary(Adversary):
    """Fang's full-knowledge attack on median / trimmed mean: per
    coordinate, a uniform draw just beyond the benign max (mean < 0) or
    below the benign min (mean > 0), with the four sign cases of the
    reference.  ``noise`` is the ``(d,)`` uniforms; without it they are
    drawn from ``generator``."""

    b: float = 2.0

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del aggregator
        mean, _ = benign_mean_std(updates, malicious)
        if noise is None and _width_shard(shard) is not None:
            # The global-width draw of the dense layout, sliced.
            noise = slice_to_shard(torch.rand(
                (shard.global_d,), generator=generator, device=mean.device),
                shard)
        if noise is None and shard is not None:
            raise ValueError("Adaptive on a column chunk needs the full-width "
                             "uniforms sliced to it (noise=)")
        benign = (~malicious)[:, None]
        inf = torch.full_like(updates, float("inf"))
        mx = torch.where(benign, updates, -inf).max(0).values
        mn = torch.where(benign, updates, inf).min(0).values
        r = noise if noise is not None else torch.rand(
            mean.shape, generator=generator, device=mean.device)
        b = self.b
        neg_pos = r * ((b - 1.0) * mx) + mx
        neg_neg = r * ((1.0 / b - 1.0) * mx) + mx
        pos_pos = r * ((1.0 - 1.0 / b) * mn) + mn / b
        pos_neg = r * ((1.0 - b) * mn) + mn * b
        forged = torch.where(
            mean < 0, torch.where(mx > 0, neg_pos, neg_neg),
            torch.where(mean > 0, torch.where(mn > 0, pos_pos, pos_neg),
                        mean))
        return self.scatter_forged(updates, forged, malicious)


@dataclasses.dataclass(frozen=True)
class NoiseAdversary(Adversary):
    """Pure Gaussian rows ``N(mean, std)``, independent per malicious lane
    and coordinate.  ``noise`` is the ``(rows, c)`` standard normals;
    without it they are drawn from ``generator`` (on a width shard, from
    ``shard.fold(generator)``)."""

    mean: float = 0.1
    std: float = 0.1

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del aggregator
        ws = _width_shard(shard)
        if noise is None and ws is not None:
            generator = ws.fold(generator)
        z = noise if noise is not None else torch.randn(
            updates.shape, generator=generator, device=updates.device)
        forged = self.mean + self.std * z.to(updates.dtype)
        return torch.where(malicious[:, None], forged, updates)


@dataclasses.dataclass(frozen=True)
class LazyAdversary(Adversary):
    """Lazy / free-riding clients (BLADE-FL): ``mode="copy"`` sends
    ``copy_scale`` times the benign row of the highest lane score (one
    victim a call) plus Gaussian camouflage of std ``noise_std``;
    ``mode="replay"`` scales the lane's own row by ``copy_scale`` and adds
    the camouflage; under the buffered-async cycle that row was computed
    against the oldest retained params version (``wants_stale_replay``).  ``noise`` is ``(scores
    (rows,) uniforms, (rows, c) standard normals)``; without it both are
    drawn from ``generator`` (on a width shard the scores, a draw over
    lanes, from ``generator`` itself, so every shard copies the same
    victim, and the normals from ``shard.fold(generator)``).  The
    streamed round has no formulation for it, as in the JAX package."""

    mode: str = "copy"
    copy_scale: float = 1.0
    noise_std: float = 1e-3

    def __post_init__(self):
        if self.mode not in ("copy", "replay"):
            raise ValueError(
                f"LazyAdversary mode must be 'copy' or 'replay', got "
                f"{self.mode!r}")

    @property
    def wants_stale_replay(self) -> bool:
        """The async cycle computes a replaying lane's events against the
        oldest params version its history ring retains."""
        return self.mode == "replay"

    @staticmethod
    def draw(shape, generator, device=None):
        """The attack's random inputs for ``(rows, c)`` updates."""
        return (torch.rand((shape[0],), generator=generator, device=device),
                torch.randn(shape, generator=generator, device=device))

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del aggregator
        ws = _width_shard(shard)
        if noise is None and ws is not None:
            scores = torch.rand((updates.shape[0],), generator=generator,
                                device=updates.device)
            z = torch.randn(updates.shape, generator=ws.fold(generator),
                            device=updates.device)
        else:
            scores, z = noise if noise is not None else self.draw(
                updates.shape, generator, updates.device)
        camo = self.noise_std * z.to(updates.dtype)
        if self.mode == "copy":
            neg_inf = torch.tensor(-math.inf, device=updates.device)
            victim = torch.where(~malicious, scores.to(updates.device),
                                 neg_inf).argmax()
            forged = self.copy_scale * updates[victim][None, :] + camo
        else:
            forged = self.copy_scale * updates + camo
        return torch.where(malicious[:, None], forged, updates)


@dataclasses.dataclass(frozen=True)
class MinMaxAdversary(Adversary):
    """Shejwalkar Min-Max: bisect ``gamma`` in [0, 5] (``iters`` steps) so
    that ``mean - gamma * dev`` lies no farther from any benign update
    than the largest benign pairwise distance.  SignGuard-aware."""

    iters: int = 12

    def gamma(self, farthest, threshold, device):
        """Bisect ``gamma`` in [0, 5]: the largest for which
        ``farthest(gamma)``, the forged row's largest distance to a benign
        row, stays below ``threshold``."""
        lo = torch.zeros((), dtype=torch.float32, device=device)
        hi = torch.full((), 5.0, dtype=torch.float32, device=device)
        for _ in range(self.iters):
            mid = (lo + hi) / 2.0
            ok = farthest(mid) < threshold
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        return (lo + hi) / 2.0

    def forged_row(self, mean, dev, sq, dots_mean, dots_dev, threshold,
                   benign):
        """From the rows' squared norms ``sq`` and their dots with ``mean``
        and ``dev``: ``||x_i - (mean - g dev)||^2`` without touching the
        rows again."""
        mm, md, dd = mean @ mean, mean @ dev, dev @ dev
        neg_inf = torch.tensor(-math.inf, device=mean.device)

        def farthest(g):
            d2 = (sq - 2.0 * (dots_mean - g * dots_dev)
                  + (mm - 2.0 * g * md + g ** 2 * dd))
            return torch.where(benign, d2.clamp(min=0.0).sqrt(), neg_inf).max()

        return mean - self.gamma(farthest, threshold, mean.device) * dev

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del noise, generator
        ws = _width_shard(shard)
        mean, dev = benign_mean_std(updates, malicious)
        if isinstance(aggregator, Signguard):
            dev = _negate_first_half(dev, ws)
        benign = ~malicious
        w = benign.to(updates.dtype)
        d2 = pairwise_sq_dists(updates, ws, "minmax_pairwise")
        threshold = ((d2 * (w[:, None] * w[None, :])).max()
                     .clamp(min=0.0).sqrt())
        neg_inf = torch.tensor(-math.inf, device=updates.device)

        def farthest(g):
            dist = row_norms(updates - (mean - g * dev)[None, :], ws,
                             "minmax_bisection_norms")
            return torch.where(benign, dist, neg_inf).max()

        gamma = self.gamma(farthest, threshold, updates.device)
        return self.scatter_forged(updates, mean - gamma * dev, malicious)


@dataclasses.dataclass(frozen=True)
class SignGuardAdversary(Adversary):
    """A forged row whose sign census matches the benign mean's, with
    random magnitudes at shuffled positions: coordinates of permutation
    rank below ``#pos`` get ``+U(0,1)``, the next ``#neg`` get ``-U(0,1)``,
    the rest 0.  ``noise`` is ``(rank (d,), uniforms (d,))``; without it
    both are drawn from ``generator``.  On a width shard the census is
    psum'd and both draws are made at the global width and sliced."""

    @staticmethod
    def draw(d: int, generator, device=None):
        """The attack's random inputs: a permutation of ``range(d)`` and
        ``d`` uniforms."""
        return (torch.randperm(d, generator=generator, device=device),
                torch.rand((d,), generator=generator, device=device))

    @staticmethod
    def forged_row(mean, rank, u, shard=None):
        pos = psum_if((mean > 0).sum(), shard, "signguard_census_pos")
        neg = psum_if((mean < 0).sum(), shard, "signguard_census_neg")
        rank = rank.to(mean.device)
        u = u.to(device=mean.device, dtype=mean.dtype)
        return torch.where(rank < pos, u,
                           torch.where(rank < pos + neg, -u,
                                       torch.zeros_like(u)))

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del aggregator
        ws = _width_shard(shard)
        mean, _ = benign_mean_std(updates, malicious)
        if ws is None:
            rank, u = noise if noise is not None else self.draw(
                mean.shape[0], generator, mean.device)
        else:
            rank, u = noise if noise is not None else self.draw(
                ws.global_d, generator, mean.device)
            rank, u = slice_to_shard(rank, ws), slice_to_shard(u, ws)
        return self.scatter_forged(updates,
                                   self.forged_row(mean, rank, u, ws),
                                   malicious)


@dataclasses.dataclass(frozen=True)
class AttackclippedclusteringAdversary(Adversary):
    """Angle-chaining attack on clustering defenses: single-linkage
    2-cluster the benign cosine distances; with ``theta_cross`` the least
    benign pairwise angle minus 0.1 and ``u*`` the majority-cluster member
    at the largest angle ``theta`` to the benign mean, forge
    ``10 (a mean_hat + b u*_hat)`` rotated past the cluster gap, or
    ``-10 mean`` when the chained angle passes pi."""

    eps: float = 1e-4

    def forged_row(self, mean, cos, cos2mean, benign, unit_row, shard=None):
        """From the rows' pairwise cosines ``cos`` (n, n), their cosines
        to the benign mean ``cos2mean`` (n,) and ``unit_row(i)``, row ``i``
        scaled to unit norm (the mean's norm global under ``shard``)."""
        n = cos.shape[0]
        w = benign.to(torch.float32)
        dist = 1.0 - torch.clamp(cos, -1.0, 1.0)
        eye = torch.eye(n, dtype=torch.bool, device=cos.device)
        pair_ok = ((w[:, None] * w[None, :]) > 0) & ~eye
        dis_cross = torch.where(pair_ok, dist,
                                torch.full_like(dist, math.inf)).min()
        theta_cross = torch.arccos(torch.clamp(1.0 - dis_cross, -1.0,
                                               1.0)) - 0.1
        big = torch.where(pair_ok | eye, dist, torch.full_like(dist, 2.0))
        majority = clustering.agglomerative_majority(
            big, linkage="single") & benign
        mean_hat = mean / row_norms(mean[None], shard,
                                    "acc_mean_norm")[0].clamp(min=1e-12)
        dis2mean = torch.where(majority, 1.0 - cos2mean,
                               torch.full_like(cos2mean, -math.inf))
        idx = dis2mean.argmax()
        theta = torch.arccos(torch.clamp(1.0 - dis2mean[idx], -1.0, 1.0))
        theta = torch.clamp(theta, min=1e-3)
        ang = theta + theta_cross - self.eps
        a = torch.cos(ang) - torch.sin(ang) / torch.tan(theta)
        b = (torch.cos(theta_cross - self.eps)
             + torch.sin(theta_cross - self.eps) / torch.tan(theta))
        rotated = 10.0 * (a * mean_hat + b * unit_row(idx))
        return torch.where(theta + theta_cross >= math.pi, -10.0 * mean,
                           rotated)

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        del noise, generator, aggregator
        ws = _width_shard(shard)
        mean, _ = benign_mean_std(updates, malicious)
        normed = updates / row_norms(updates, ws, "acc_row_norms").clamp(
            min=1e-12)[:, None]
        mean_hat = mean / row_norms(mean[None], ws,
                                    "acc_mean_norm")[0].clamp(min=1e-12)
        forged = self.forged_row(mean, gram(normed, ws, "acc_gram"),
                                 row_dots(normed, mean_hat, ws,
                                          "acc_mean_dots"),
                                 ~malicious, lambda i: normed[i], ws)
        return self.scatter_forged(updates, forged, malicious)
