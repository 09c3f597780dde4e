"""The width-sharded round over the ranks of a process group (counterpart
of ``blades_tpu/parallel/dsharded.py``).

At ResNet-18 x 1000 clients the f32 ``(n, d)`` update matrix is ~45 GB:
no rank can hold it, as the client-sharded round's gather makes every
rank do.  The round swaps axes instead.  Each rank trains its own block
of client lanes into ``(n_local, d_pad)`` rows (``d`` zero-padded to a
multiple of the ranks), and ONE all-to-all turns them into all clients'
rows on this rank's width shard, ``(n, d_pad / k)``
(:func:`~blades_tpu_torch.parallel.mesh.rows_to_width_shard`).  A rank
holds ``n * d / k`` update entries, twice over at the swap.  ``d`` is
padded to a multiple of ``64 * k`` (``ops/layout.py::SHARD_ALIGN``); the padding
crosses the swap as zeros and is then left out: a shard's tensors hold its
real columns only.

On that layout every aggregator is exact (:func:`aggregate_dshard`):

- coordinate-wise (Mean, Median, Trimmedmean): the dense aggregator on
  the shard; Median and Trimmedmean reduce through the column selects
  (``select:radix`` on the card);
- row geometry (Multikrum, GeoMed, FLTrust, Signguard,
  Clippedclustering, Centeredclipping's clip): norms, dots and Grams are
  all-reduced shard partials (:mod:`blades_tpu_torch.ops.layout`);
- state (Centeredclipping's ``(d,)`` momentum, Clippedclustering's norm
  history) stays replicated as on the dense round, sliced to the shard;
- DnC: every rank draws the same column subsamples from the replicated
  generator, and one all-reduce assembles only the sampled columns.

Only the ``(d,)`` aggregate is gathered, and the server step is the dense
round's (:meth:`~blades_tpu_torch.core.server.Server.apply_aggregate`),
replicated.  Update forges receive the :class:`ShardInfo`
(:mod:`blades_tpu_torch.adversaries.update_attacks`).

RNG.  The training replays the one-process dense round's draws, as the
client-sharded round does (:class:`~blades_tpu_torch.parallel.sharded.
MeshRound`): every lane trains on the dense round's batches, dropout masks
and augmentation draws; an elided lane's draws are drawn and dropped.
Each rank trains its lanes in blocks of ``client_block``; where
``client_block`` divides ``n_local`` (and the elided count), a rank's
blocks are the dense round's, and the round's coordinate-wise aggregates
equal the dense round's bit for bit.  After the training every rank
holds the replicated generator where the dense round's stands before its
finish, so the forges' and aggregators' replicated draws (Adaptive's
uniforms, SignGuard's permutation, Lazy's victim scores, FLTrust's root
batches, DnC's subsamples) are the dense round's.  No rank draws an ``(n,
d)`` tensor: DP noise (added to the rank's rows before the swap) and
Noise's and Lazy's normals come from generators folded from the
replicated stream with the shard index (``ShardInfo.fold``).  They are
deterministic per seed and are not the dense stream.

Malicious-lane elision (``malicious_prefix``): an update forge replaces
every malicious row from benign statistics, so what those lanes train is
dead work.  On the strided layout of :func:`elision_client_order` every
rank's lanes are ``[f // k malicious | the rest]``; the rank trains the
rest and writes zero rows (and zero losses) for the prefix, whose
optimizer state stays as it came in.  The round is then the non-elided
round on the same layout, bit for bit.  The mask is checked once per mask
object; an adversary that forges nothing (a training attack) trains every
lane.  ``num_unhealthy`` counts trained lanes only, and the metrics carry
``elided_lanes``.

The round's update matrix is f32: the dense round's, whatever
``update_dtype`` says (as in the JAX package, whose width-sharded round
trains without an ``out_dtype``).

Accounting: every collective the round issues (the swap, the gathers,
``ShardInfo``'s psums and gathers) is counted on the step's
:class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder`
(``step.recorder.ici_events``, the last round's), and equals
:func:`blades_tpu_torch.parallel.comm_model.dsharded_round_volumes` as a
multiset.  No row field stamps it, as in the JAX round.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from blades_tpu_torch.adversaries.base import forges
from blades_tpu_torch.core.health import guard_server_state
from blades_tpu_torch.core.round import FedRound, RoundState
from blades_tpu_torch.core.round import _rows
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
from blades_tpu_torch.ops.layout import (
    SHARD_ALIGN,
    ShardInfo,
    clip_rows_to_norm,
    gram,
    row_dots,
    row_norms,
    row_sq_norms,
    slice_to_shard,
)
from blades_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    rows_to_width_shard,
)
from blades_tpu_torch.parallel.sharded import (
    MeshRound,
    _params_device,
    multi_dispatch,
)
from blades_tpu_torch.parallel.streamed_geometry import PassRecorder
from blades_tpu_torch.utils.tree import FlatLayout


def _sign_census_majority(clipped: torch.Tensor, shard: ShardInfo
                          ) -> torch.Tensor:
    """SignGuard's 2-means majority over the global sign fractions: the
    positive and negative counts psum'd, the zero count what is left of
    ``global_d`` (padding columns are zero and not counted), each divided
    by ``global_d`` as ``clustering.sign_features`` divides by ``d``."""
    d = shard.global_d
    pos = shard.psum((clipped > 0).sum(1), "sign_census_pos")
    neg = shard.psum((clipped < 0).sum(1), "sign_census_neg")
    zero = d - pos - neg
    feats = torch.stack([pos / d, neg / d, zero / d], 1).to(clipped.dtype)
    return clustering.kmeans_majority(feats)


def aggregate_dshard(aggregator, upd: torch.Tensor, shard: ShardInfo, *,
                     generator=None, agg_state=(), trusted_shard=None):
    """Aggregate an ``(n, columns)`` shard into ``(columns,)``, exactly:
    ``(aggregate shard, new state)``, the contract of the aggregator's
    ``__call__`` on the dense matrix, the global geometry psum'd.  The
    state has the dense layout (replicated), so checkpoints move between
    the two rounds.  GeoMed runs ``maxiter`` Weiszfeld steps with no early
    stop (its objective test would need a psum a step)."""
    n = upd.shape[0]
    if isinstance(aggregator, (Mean, Median, Trimmedmean)):
        return aggregator(upd, agg_state)
    if isinstance(aggregator, Multikrum):
        aggregator.check(n)
        mask = _krum_mask(row_sq_norms(upd, shard, "row_sq_norms"),
                          gram(upd, shard, "gram"),
                          aggregator.num_byzantine, aggregator.k)
        return masked.masked_mean(upd, mask), agg_state
    if isinstance(aggregator, GeoMed):
        weights = torch.ones((n,), dtype=upd.dtype, device=upd.device) / n

        def wavg(w):
            return (w[:, None] * upd).sum(0) / w.sum()

        median = wavg(weights)
        for _ in range(aggregator.maxiter):
            denom = row_norms(upd - median, shard,
                              "weiszfeld_row_norms").clamp(min=aggregator.eps)
            median = wavg(weights / denom)
        return median, agg_state
    if isinstance(aggregator, DnC):
        keep = aggregator.keep(n)
        idx = aggregator.draw(shard.global_d, generator, upd.device)
        # Only the sampled columns: each rank contributes the ones it owns
        # and one psum makes the (num_iters, n, sub_dim) stack global.
        local = idx - shard.offset()
        owned = (local >= 0) & (local < shard.columns)
        cols = upd[:, local.clamp(0, shard.columns - 1)].permute(1, 0, 2)
        subs = shard.psum(torch.where(owned[:, None, :], cols,
                                      torch.zeros_like(cols)),
                          "sampled_columns")
        benign = aggregator.select(subs, keep)
        return masked.masked_mean(upd, benign), agg_state
    if isinstance(aggregator, FLTrust):
        if trusted_shard is None:
            raise ValueError("FLTrust requires the server's trusted root-data "
                             "update (FedRound.trusted_data)")
        s_norm = row_norms(trusted_shard[None], shard, "trust_s_norm")[0]
        c_norm = row_norms(upd, shard, "trust_row_norms").clamp(min=1e-12)
        cos = (row_dots(upd, trusted_shard, shard, "trust_row_dots")
               / (c_norm * s_norm.clamp(min=1e-12)))
        trust = torch.relu(cos)
        rescaled = upd * (s_norm / c_norm)[:, None]
        agg = ((trust[:, None] * rescaled).sum(0)
               / trust.sum().clamp(min=1e-12))
        return agg, agg_state
    if isinstance(aggregator, Centeredclipping):
        momentum = agg_state
        if momentum is None or (isinstance(momentum, tuple) and not momentum):
            momentum = torch.zeros((shard.global_d,), dtype=upd.dtype,
                                   device=upd.device)
        center = slice_to_shard(momentum, shard)
        for _ in range(aggregator.n_iter):
            center = center + clip_rows_to_norm(
                upd - center[None, :], aggregator.tau, shard,
                label="clip_row_norms").mean(0)
        return center, shard.gather(center, "momentum_gather")[
            :shard.global_d]
    if isinstance(aggregator, Signguard):
        norms = row_norms(upd, shard, "row_norms")
        M = masked.median(norms[:, None])[0]
        clipped = clip_rows_to_norm(upd, M, shard, label="clip_row_norms")
        cnorms = torch.minimum(norms, M)
        mask = ((cnorms >= 0.1 * M) & (cnorms <= 3.0 * M)
                & _sign_census_majority(clipped, shard))
        if aggregator.agg == "mean":
            return masked.masked_mean(clipped, mask), agg_state
        return masked.masked_median(clipped, mask), agg_state
    if isinstance(aggregator, Clippedclustering):
        norms = row_norms(upd, shard, "row_norms")
        threshold, new_state = aggregator.clip_threshold(norms, agg_state)
        clipped = clip_rows_to_norm(upd, threshold, shard,
                                    label="clip_row_norms")
        cn = row_norms(clipped, shard, "clipped_row_norms")
        normed = clipped / cn.clamp(min=1e-12)[:, None]
        dist = 1.0 - torch.clamp(gram(normed, shard, "gram"), -1.0, 1.0)
        zero = cn < 1e-12
        dist = torch.where(zero[:, None] | zero[None, :],
                           torch.full_like(dist, 2.0), dist)
        mask = clustering.agglomerative_majority(dist,
                                                 linkage=aggregator.linkage)
        if aggregator.signguard:
            mask = mask & _sign_census_majority(clipped, shard)
        if aggregator.agg == "mean":
            return masked.masked_mean(clipped, mask), new_state
        return masked.masked_median(clipped, mask), new_state
    raise NotImplementedError(
        f"{type(aggregator).__name__} has no d-sharded formulation")


def elision_client_order(n: int, f: int, n_dev: int) -> np.ndarray:
    """The client permutation of the elision layout: ``array[order]`` puts
    ``f // n_dev`` of the canonical prefix's malicious clients (clients
    ``0..f-1``) first in every rank's contiguous block, and the ``f %
    n_dev`` left over in the first ranks' tails, where they train (their
    rows are forged over all the same).  Permuting the clients moves which
    lane's draws each client takes: a run on this layout is comparable
    with the dense round on the same layout, not with a natural-order
    run."""
    if n % n_dev:
        raise ValueError(f"n={n} must divide the mesh ({n_dev})")
    if not 0 < f < n:
        raise ValueError(f"f={f} must be in (0, {n})")
    fl, r, nl = f // n_dev, f % n_dev, n // n_dev
    mal = iter(range(f))
    ben = iter(range(f, n))
    order = []
    for k in range(n_dev):
        extra = 1 if k < r else 0
        order += [next(mal) for _ in range(fl + extra)]
        order += [next(ben) for _ in range(nl - fl - extra)]
    return np.asarray(order)


class DshardedStep(MeshRound):
    """The width-sharded round (see the module docstring):
    ``step(state, x, y, lengths, malicious, seed)`` over this rank's
    shards and the replicated ``(n,)`` mask, and ``step.prebatched(...)``
    (:class:`~blades_tpu_torch.parallel.sharded.MeshRound`).  ``f_local``
    is the elided lanes per rank."""

    _refused = MeshRound._refused + (("faults", "fault injection"),)

    def __init__(self, fr: FedRound, mesh: Mesh, n: Optional[int] = None,
                 malicious_prefix: Optional[int] = None):
        super().__init__(fr, mesh, n)
        if fr.forensics:
            raise ValueError("the width-sharded round never forms the "
                             "per-lane decisions forensics reports")
        self.f_local = 0
        if malicious_prefix and forges(fr.adversary):
            # floor(f / k) lanes elided a rank; the f mod k left over train
            # in the first ranks' tails, keeping the ranks' shapes equal.
            self.f_local = int(malicious_prefix) // self.c
        self._checked = None
        # The last round's collectives, as dsharded_round_volumes lists
        # them (parallel/comm_model.py).
        self.recorder = PassRecorder()

    def _validate(self, malicious) -> None:
        """Once per mask object: the elided prefix of every rank's lanes
        must be malicious, else a benign lane would lose its training."""
        if not self.f_local or self._checked is malicious:
            return
        m = malicious.detach().to("cpu", torch.bool)
        m = torch.cat([m, m.new_zeros(self.n_pad - m.shape[0])])
        if not bool(m.view(self.c, self.n_local)[:, :self.f_local].all()):
            raise ValueError(
                f"d-sharded elision promised every rank's first "
                f"{self.f_local} lanes malicious, but the mask disagrees "
                "— lay clients out with elision_client_order, or build "
                "the step without malicious_prefix")
        self._checked = malicious

    def train_lanes(self, state: RoundState, bx, by, malicious, masks, aug,
                    out):
        """This rank's lanes' local rounds into ``out`` ``(n_local, d)``:
        ``(client_opt, losses)``.  The elided prefix is not trained: zero
        rows, zero losses, its optimizer rows as they came in."""
        fr, f = self.fr, self.f_local
        mal = self.lanes(malicious)
        if not f:
            _, opt, losses = fr.train_clients(
                state, bx, by, mal, None, dropout_masks=masks,
                aug_draws=aug, out=out)
            return opt, losses
        live = dataclasses.replace(state,
                                   client_opt=_rows(state.client_opt, f, None))
        _, opt_b, losses_b = fr.train_clients(
            live, bx[f:], by[f:], mal[f:], None,
            dropout_masks=_rows(masks, f, None),
            aug_draws=_rows(aug, f, None), out=out[f:])
        out[:f] = 0.0
        losses = torch.cat([losses_b.new_zeros(f), losses_b])
        opt = (None if opt_b is None else
               {k: torch.cat([v[:f], opt_b[k]])
                for k, v in state.client_opt.items()})
        return opt, losses

    def round(self, state: RoundState, bx, by, malicious, generator, masks,
              aug, *, forge_noise=None, dp_noise=None):
        if forge_noise is not None:
            raise ValueError("the width-sharded round draws its forge's "
                             "noise itself (forge_noise= is not taken)")
        fr, n, mesh = self.fr, self.n, self.mesh
        self._validate(malicious)
        dev = _params_device(state)
        malicious = malicious.to(device=dev, dtype=torch.bool)
        d = FlatLayout(state.server.params).d
        rec = self.recorder
        rec.ici_events.clear()
        rec.ici_bytes = 0
        shard = ShardInfo.of(d, self.c, self.mesh.coords[0], mesh=mesh,
                             recorder=rec)
        if d <= (self.c - 1) * shard.width:
            raise ValueError(f"d={d} leaves a shard of the {self.c} ranks "
                             f"without columns ({SHARD_ALIGN}-column groups)")
        rows = torch.empty((self.n_local, shard.d_pad), dtype=torch.float32,
                           device=dev)
        rows[:, d:] = 0.0
        opt, losses = self.train_lanes(state, bx, by, malicious, masks, aug,
                                       rows[:, :d])
        if fr.dp_clip_threshold is not None:
            # DP on the rank's rows, before the swap; the noise from a
            # generator folded with this rank's coordinate.
            noise = None if dp_noise is None else self.lanes(dp_noise)
            gen = (None if noise is not None or fr.dp_noise_factor is None
                   else shard.fold(generator))
            rows[:, :d] = fr.apply_dp(rows[:, :d], noise, gen)
        # The round's collectives: the axis swap, then the losses.
        upd = rows_to_width_shard(mesh, rows, recorder=rec,
                                  label="update_matrix_swap")[
            :n, :shard.columns]
        del rows
        losses = all_gather_rows(mesh, losses, recorder=rec,
                                 label="losses_gather")[:n]
        healthy = None
        if fr.health_check:
            # A lane is unhealthy if any shard of its row holds a
            # non-finite value: one psum of the shards' verdicts, then the
            # row is zeroed on every shard.
            bad = (~torch.isfinite(upd).all(1)).to(torch.int32)
            healthy = shard.psum(bad, "row_health") == 0
            upd.masked_fill_(~healthy[:, None], 0.0)
        if forges(fr.adversary):
            upd = fr.adversary.on_updates_ready(
                upd, malicious, generator=generator,
                aggregator=fr.server.aggregator, shard=shard)
        trusted = fr.compute_trusted_update(state.server.params, generator)
        agg_shard, agg_state = aggregate_dshard(
            fr.server.aggregator, upd, shard, generator=generator,
            agg_state=state.server.agg_state,
            trusted_shard=(None if trusted is None
                           else slice_to_shard(trusted, shard)))
        # Only the (d,) aggregate is gathered; the server step is the
        # dense round's, replicated.
        agg = shard.gather(agg_shard, "aggregate_gather")[:d]
        server = fr.server.apply_aggregate(state.server, agg, agg_state)
        benign = (~malicious).float()
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(min=1.0),
            "update_norm_mean": row_norms(upd, shard,
                                          "metrics_row_norms").mean(),
            "agg_norm": (agg * agg).sum().sqrt(),
            "round": server.round,
        }
        if self.f_local:
            # Lanes whose training was skipped this round, federation-wide
            # (the basis num_unhealthy leaves out).
            metrics["elided_lanes"] = self.f_local * self.c
        if fr.health_check:
            ok = torch.isfinite(agg).all()
            server = guard_server_state(ok, server, state.server)
            metrics["num_unhealthy"] = (~healthy).sum()
            metrics["round_ok"] = ok
        return RoundState(server=server, client_opt=opt), metrics


def dsharded_step(fr: FedRound, mesh: Mesh,
                  malicious_prefix: Optional[int] = None) -> DshardedStep:
    """The width-sharded round of ``fr`` on ``mesh``: ``step(state, x, y,
    lengths, malicious, seed) -> (state, metrics)`` over this rank's
    shards; ``malicious_prefix`` elides the dead malicious-lane training
    on the :func:`elision_client_order` layout (checked once per mask
    object)."""
    return DshardedStep(fr, mesh, malicious_prefix=malicious_prefix)


def dsharded_multi_step(fr: FedRound, mesh: Mesh, num_rounds: int,
                        malicious_prefix: Optional[int] = None) -> Callable:
    """``rounds_per_dispatch`` on the width-sharded round: ``multi(state, x,
    y, lengths, malicious, seeds) -> (state, [metrics per round])``, round
    ``i`` from ``seeds[i]``; each round builds and frees its own update
    shard."""
    return multi_dispatch(
        DshardedStep(fr, mesh, malicious_prefix=malicious_prefix),
        num_rounds)
