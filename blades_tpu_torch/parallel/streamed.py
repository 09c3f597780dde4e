"""The single-device streamed round (counterpart of
``blades_tpu/parallel/streamed.py``), the port's main path.

Clients train in blocks of ``client_block`` into one ``(rows, d)`` update
buffer in the storage dtype (bf16 by default): each block's updates are
written into its rows in place, leaf by leaf, which the port does to keep
a single copy of the matrix.  The round then finishes in ONE kernel over
the buffer (:mod:`blades_tpu_torch.ops.fused_finish`): sanitize, forge,
aggregate and row norms.

``malicious_prefix`` is the caller's promise that the malicious mask marks
exactly the first ``malicious_prefix`` lanes.  When the adversary forges
updates from benign statistics, the malicious clients' training is dead
work, so blocks that lie wholly inside the prefix are skipped (checked once
per mask object).  When the prefix is block-aligned the buffer holds ONLY
the benign rows and the forged row enters the aggregate as a virtual row
of multiplicity ``malicious_prefix`` (``fused_finish_compact``); otherwise
the full matrix goes through ``fused_finish``.

The row-geometry aggregators (GeoMed, Multikrum, DnC, Centeredclipping,
Signguard, Clippedclustering, FLTrust) and forges (MinMax, SignGuard,
Attackclippedclustering) take the full matrix instead: a column-chunk pass
sanitizes and applies a coordinate-wise forge IN PLACE (writing back only
each chunk's not-yet-covered columns) and accumulates the row norms; a
row-geometry forge then computes its forged row through the pass planner
and scatters it into the malicious lanes; the aggregator runs as fused
statistics bundles over the buffer
(:mod:`blades_tpu_torch.parallel.streamed_geometry`), each bundle of
kernel kinds one call of the row-stats kernel.  These rounds stamp
``hbm_passes`` / ``hbm_passes_unfused``: the planned full-matrix
traversals of the fused plan and of one traversal per statistic, plus one
for the in-place pass and one for the scatter.  A row-geometry forge with
Mean, Median or Trimmedmean finishes chunk by chunk.

The adversary's training hooks (LabelFlip, SignFlip) run inside each
block's local rounds.  DP, the keyed Noise forge, ghost lanes and client
momentum raise ``NotImplementedError`` (a later slice of the port).
"""

from __future__ import annotations

from typing import Callable

import torch

from blades_tpu_torch.adversaries.base import forges
from blades_tpu_torch.adversaries.update_attacks import (
    AdaptiveAdversary,
    ALIEAdversary,
    IPMAdversary,
)
from blades_tpu_torch.core.health import guard_server_state, sanitize_updates
from blades_tpu_torch.core.round import FedRound, RoundState
from blades_tpu_torch.data.sampler import gather_batches, sample_batch_indices
from blades_tpu_torch.device import resolve_device
from blades_tpu_torch.ops.aggregators import Mean, Median, Trimmedmean
from blades_tpu_torch.ops.fused_finish import fused_finish, fused_finish_compact
from blades_tpu_torch.ops.layout import ChunkInfo
from blades_tpu_torch.parallel.streamed_geometry import (
    STREAMED_ROW_AGGREGATORS,
    STREAMED_ROW_FORGERS,
    PassPlanner,
    PassRecorder,
    aggregate_coordwise,
    aggregate_streamed,
    check_applicable,
    chunk_grid,
    forge_streamed,
)
from blades_tpu_torch.utils.tree import FlatLayout

D_CHUNK = 1 << 17  # columns per step of the column-chunk passes
_COORDWISE_FORGERS = (ALIEAdversary, IPMAdversary, AdaptiveAdversary)
_LATER = ("a later slice of the port (the chunked finish with DP, the keyed "
          "Noise forge, ghost lanes, client momentum)")


def _fused_spec(fr: FedRound):
    """``(forge, agg)`` specs of the fused finish for this round."""
    agg = fr.server.aggregator
    if isinstance(agg, Median):
        aspec = ("median",)
    elif isinstance(agg, Trimmedmean):
        aspec = ("trimmed", agg.num_excluded)
    elif isinstance(agg, Mean):
        aspec = ("mean",)
    else:
        raise NotImplementedError(
            f"{type(agg).__name__} has no streamed finish yet: {_LATER}")
    adv = fr.adversary
    if not forges(adv):
        fspec = None
    elif isinstance(adv, ALIEAdversary):
        fspec = ("alie", float(adv.z_max))
    elif isinstance(adv, IPMAdversary):
        fspec = ("ipm", float(adv.scale))
    elif isinstance(adv, AdaptiveAdversary):
        fspec = ("adaptive", float(adv.b))
    else:
        raise NotImplementedError(
            f"{type(adv).__name__} has no streamed forge yet: {_LATER}")
    return fspec, aspec


def streamed_step(
    fr: FedRound,
    *,
    client_block: int = 50,
    update_dtype: torch.dtype = torch.bfloat16,
    malicious_prefix: int | None = None,
    fuse_rowgeom: bool = True,
    d_chunk: int | None = None,
    device=None,
) -> Callable:
    """Build the streamed round on ``device`` (``None`` = the card).

    ``step(state, x, y, lengths, malicious, seed, batch_idx=None,
    dropout_masks=None) -> (state, metrics)``: ``x (n, shard, H, W, C)`` and ``y (n, shard)`` are
    the stacked client shards, ``lengths (n,)`` their true sizes,
    ``malicious (n,)`` the bool mask, and ``seed`` seeds the round's
    generator (batch indices, dropout masks, the forges' and DnC's draws,
    the trusted update's batches).
    ``batch_idx (n, num_batches, batch_size)`` replaces the index draw and
    ``dropout_masks`` (one ``(n, num_batches, batch_size, width)`` bool
    keep-mask per dropout layer) the mask draw.

    ``fuse_rowgeom=False`` runs the row-geometry statistics one traversal
    per request (the unfused comparator).  ``d_chunk`` is the column width
    of the chunk passes (default ``D_CHUNK``).  After each row-geometry round
    ``step.passes`` holds its
    :class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder`.
    """
    dev = resolve_device(device)
    if fr.task.spec.momentum:
        raise NotImplementedError(
            "client momentum on the streamed round: " + _LATER)
    d_chunk = d_chunk or D_CHUNK
    hooks = fr.hooks()
    agg, adv = fr.server.aggregator, fr.adversary
    row_geom = isinstance(agg, STREAMED_ROW_AGGREGATORS)
    coord_forges = forges(adv) and isinstance(adv, _COORDWISE_FORGERS)
    row_forges = forges(adv) and isinstance(adv, STREAMED_ROW_FORGERS)
    rowgeom_path = row_geom or row_forges
    if getattr(agg, "expects_trusted_row", False) and fr.trusted_data is None:
        raise ValueError(
            f"{type(agg).__name__} requires FedRound.trusted_data (the "
            "server's root data): without it the defense has no root of "
            "trust")
    if rowgeom_path:
        if forges(adv) and not (coord_forges or row_forges):
            raise NotImplementedError(
                f"{type(adv).__name__} has no streamed forge yet: {_LATER}")
        if not row_geom and not isinstance(agg, (Mean, Median, Trimmedmean)):
            raise NotImplementedError(
                f"{type(agg).__name__} has no streamed finish yet: {_LATER}")
        forge = aspec = None
    else:
        forge, aspec = _fused_spec(fr)
    forging = coord_forges or row_forges
    # The in-place chunk pass rewrites the buffer only when something
    # changes it; otherwise the row norms fuse into the first bundle.
    rewrites = coord_forges or fr.health_check
    checked_mask = [None]  # the last mask object validated

    def _serve_aggregate(state, agg_vec, malicious, losses, sq, bad,
                         agg_state=None):
        server = fr.server.apply_aggregate(state.server, agg_vec, agg_state)
        benign = (~malicious).float()
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(min=1.0),
            "update_norm_mean": sq.clamp(min=0.0).sqrt().mean(),
            # A plain sum of squares: torch's CPU vector_norm loses ~1e-4
            # relative over millions of f32 terms.
            "agg_norm": (agg_vec * agg_vec).sum().sqrt(),
            "round": server.round,
        }
        if fr.health_check:
            ok = torch.isfinite(agg_vec).all()
            server = guard_server_state(ok, server, state.server)
            metrics["num_unhealthy"] = bad.sum()
            metrics["round_ok"] = ok
        return server, metrics

    def _rowgeom_mat_chunk(buf, sq, bad, malicious, noise, i, start, c):
        """Sanitize and forge chunk ``i`` in place: write back only its
        not-yet-covered columns, and accumulate their squared norms."""
        raw = buf[:, start:start + c]
        chunk = raw.float()
        if fr.health_check:
            chunk, healthy = sanitize_updates(chunk)
            bad |= ~healthy
        if coord_forges:
            chunk = adv.on_updates_ready(
                chunk, malicious, aggregator=agg,
                noise=None if noise is None else noise[start:start + c],
                shard=ChunkInfo(global_d=buf.shape[1], width=c, start=start,
                                index=i))
        lo = max(i * c - start, 0)  # the tail chunk overlaps its predecessor
        fresh = chunk[:, lo:]
        sq += (fresh * fresh).sum(1)
        raw[:, lo:] = fresh.to(buf.dtype)

    def _forge_row(buf, malicious, sq, gen, recorder):
        """The row-geometry forge's statistics bundles -> the forged (d,)
        row and the post-forge row squared norms."""
        planner = PassPlanner(buf, d_chunk, recorder=recorder,
                              fuse=fuse_rowgeom)
        forged, sq = forge_streamed(adv, buf, malicious, sq, agg, planner,
                                    generator=gen)
        return forged, torch.where(malicious, forged @ forged, sq)

    def _scatter_chunk(buf, forged, rows, start, c):
        """The forged row's columns into the malicious rows of one chunk."""
        buf[rows, start:start + c] = forged[start:start + c].to(buf.dtype)

    def _rowgeom_aggregate(state, buf, malicious, losses, sq, bad, gen,
                           recorder):
        trusted = fr.compute_trusted_update(state.server.params, gen)
        agg_vec, agg_state, sq = aggregate_streamed(
            agg, buf, sq, state.server.agg_state, generator=gen,
            trusted=trusted, d_chunk=d_chunk, recorder=recorder,
            fuse=fuse_rowgeom)
        return _serve_aggregate(state, agg_vec, malicious, losses, sq, bad,
                                agg_state=agg_state)

    def _coordwise_after_forge(state, buf, malicious, losses, sq, bad,
                               recorder):
        agg_vec = aggregate_coordwise(agg, buf, d_chunk, recorder=recorder)
        return _serve_aggregate(state, agg_vec, malicious, losses, sq, bad)

    def _finish_rowgeom(state, buf, malicious, losses, gen):
        n, d = buf.shape
        recorder = PassRecorder()
        c, _, starts = chunk_grid(d, d_chunk)
        if rewrites:
            sq = torch.zeros((n,), dtype=torch.float32, device=dev)
            bad = torch.zeros((n,), dtype=torch.bool, device=dev)
            noise = (torch.rand((d,), generator=gen, device=dev)
                     if isinstance(adv, AdaptiveAdversary) else None)
            for i, start in enumerate(starts):
                _rowgeom_mat_chunk(buf, sq, bad, malicious, noise, i, start, c)
        else:
            sq, bad = None, torch.zeros((n,), dtype=torch.bool, device=dev)
        if row_forges:
            forged, sq = _forge_row(buf, malicious, sq, gen, recorder)
            rows = malicious.nonzero().flatten()
            for start in starts:
                _scatter_chunk(buf, forged, rows, start, c)
        if row_geom:
            server, metrics = _rowgeom_aggregate(state, buf, malicious,
                                                 losses, sq, bad, gen,
                                                 recorder)
        else:
            server, metrics = _coordwise_after_forge(state, buf, malicious,
                                                     losses, sq, bad,
                                                     recorder)
        fixed = int(rewrites) + int(row_forges)
        metrics["hbm_passes"] = recorder.executed + fixed
        metrics["hbm_passes_unfused"] = recorder.unfused + fixed
        step.passes = recorder
        return server, metrics

    def step(state: RoundState, data_x, data_y, lengths, malicious, seed,
             batch_idx=None, dropout_masks=None):
        n = data_x.shape[0]
        if n % client_block:
            raise ValueError(f"{n} clients not divisible by block "
                             f"{client_block}")
        if fr.num_clients is not None and fr.num_clients != n:
            raise NotImplementedError(
                "ghost (padding) lanes need the chunked finish: " + _LATER)
        if rowgeom_path:  # before training burns a full pass
            check_applicable(agg, n)
        malicious = malicious.to(device=dev, dtype=torch.bool)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if batch_idx is None:
            batch_idx = sample_batch_indices(
                gen, lengths.to(dev), fr.batch_size, fr.num_batches_per_round)
        batch_idx = batch_idx.to(device=data_x.device, dtype=torch.int64)

        skip_blocks = 0
        if malicious_prefix and forging:
            skip_blocks = malicious_prefix // client_block
            if skip_blocks and checked_mask[0] is not malicious:
                mal = malicious.cpu()
                if not (bool(mal[:skip_blocks * client_block].all())
                        and not bool(mal[malicious_prefix:].any())):
                    raise ValueError(
                        f"malicious_prefix={malicious_prefix} promised "
                        "exactly the first lanes malicious, but the mask "
                        "disagrees: elision would zero benign updates")
                checked_mask[0] = malicious
        compact = (not rowgeom_path and skip_blocks > 0
                   and malicious_prefix % client_block == 0)
        row_shift = malicious_prefix if compact else 0

        params = state.server.params
        d = FlatLayout(params).d
        shape = (n - row_shift, d)
        # Compact: training writes every row.  Otherwise elided rows stay
        # zero (finite, and the forge replaces them).
        buf = (torch.empty(shape, dtype=update_dtype, device=dev) if compact
               else torch.zeros(shape, dtype=update_dtype, device=dev))
        losses = torch.zeros((n,), dtype=torch.float32, device=dev)
        for b in range(skip_blocks, n // client_block):
            r0, r1 = b * client_block, (b + 1) * client_block
            bx, by = gather_batches(data_x[r0:r1], data_y[r0:r1],
                                    batch_idx[r0:r1])
            masks = (None if dropout_masks is None else
                     tuple(m[r0:r1].to(dev) for m in dropout_masks))
            _, loss, _ = fr.task.local_round_batched(
                params, bx.to(dev), by.to(dev), malicious=malicious[r0:r1],
                hooks=hooks, generator=gen, dropout_masks=masks,
                out=buf[r0 - row_shift:r1 - row_shift])
            losses[r0:r1] = loss

        if rowgeom_path:
            server, metrics = _finish_rowgeom(state, buf, malicious, losses,
                                              gen)
        else:
            noise = (torch.rand((d,), generator=gen, device=dev)
                     if forge is not None and forge[0] == "adaptive"
                     else None)
            if compact:
                agg_vec, sq_b, bad_b, forged = fused_finish_compact(
                    buf, noise, forged_mult=malicious_prefix, forge=forge,
                    agg=aspec, sanitize=fr.health_check)
                fsq = (forged * forged).sum()
                sq = torch.cat([fsq.expand(malicious_prefix), sq_b])
                bad = torch.cat([torch.zeros((malicious_prefix,),
                                             dtype=torch.bool, device=dev),
                                 bad_b])
            else:
                agg_vec, sq, bad = fused_finish(buf, malicious, noise,
                                                forge=forge, agg=aspec,
                                                sanitize=fr.health_check)
            server, metrics = _serve_aggregate(state, agg_vec, malicious,
                                               losses, sq, bad)
        del buf
        if skip_blocks:
            metrics["elided_lanes"] = skip_blocks * client_block
        return RoundState(server=server, client_opt=state.client_opt), metrics

    return step
