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

This slice covers the configurations the fused finish covers: Mean, Median
or Trimmedmean, under no adversary or a coordinate-wise forge (ALIE, IPM,
Adaptive).  Others raise ``NotImplementedError``.
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
from blades_tpu_torch.core.health import guard_server_state
from blades_tpu_torch.core.round import FedRound, RoundState
from blades_tpu_torch.data.sampler import gather_batches, sample_batch_indices
from blades_tpu_torch.device import resolve_device
from blades_tpu_torch.ops.aggregators import Mean, Median, Trimmedmean
from blades_tpu_torch.ops.fused_finish import fused_finish, fused_finish_compact
from blades_tpu_torch.utils.tree import FlatLayout

_LATER = ("a later slice of the port (the chunked finish with DP, the keyed "
          "Noise forge, the row-geometry forges and aggregators)")


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
    device=None,
) -> Callable:
    """Build the streamed round on ``device`` (``None`` = the card).

    ``step(state, x, y, lengths, malicious, seed, batch_idx=None,
    dropout_masks=None) -> (state, metrics)``: ``x (n, shard, H, W, C)`` and ``y (n, shard)`` are
    the stacked client shards, ``lengths (n,)`` their true sizes,
    ``malicious (n,)`` the bool mask, and ``seed`` seeds the round's
    generator (batch indices, dropout masks, Adaptive uniforms).
    ``batch_idx (n, num_batches, batch_size)`` replaces the index draw and
    ``dropout_masks`` (one ``(n, num_batches, batch_size, width)`` bool
    keep-mask per dropout layer) the mask draw.
    """
    dev = resolve_device(device)
    forge, aspec = _fused_spec(fr)
    checked_mask = [None]  # the last mask object validated

    def _serve_aggregate(state, agg_vec, malicious, losses, sq, bad):
        server = fr.server.apply_aggregate(state.server, agg_vec)
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

    def step(state: RoundState, data_x, data_y, lengths, malicious, seed,
             batch_idx=None, dropout_masks=None):
        n = data_x.shape[0]
        if n % client_block:
            raise ValueError(f"{n} clients not divisible by block "
                             f"{client_block}")
        if fr.num_clients is not None and fr.num_clients != n:
            raise NotImplementedError(
                "ghost (padding) lanes need the chunked finish: " + _LATER)
        malicious = malicious.to(device=dev, dtype=torch.bool)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if batch_idx is None:
            batch_idx = sample_batch_indices(
                gen, lengths.to(dev), fr.batch_size, fr.num_batches_per_round)
        batch_idx = batch_idx.to(device=data_x.device, dtype=torch.int64)

        skip_blocks = 0
        if malicious_prefix and forge is not None:
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
        compact = skip_blocks > 0 and malicious_prefix % client_block == 0
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
            _, loss = fr.task.local_round_batched(
                params, bx.to(dev), by.to(dev), generator=gen,
                dropout_masks=masks, out=buf[r0 - row_shift:r1 - row_shift])
            losses[r0:r1] = loss

        noise = (torch.rand((d,), generator=gen, device=dev)
                 if forge is not None and forge[0] == "adaptive" else None)
        if compact:
            agg_vec, sq_b, bad_b, forged = fused_finish_compact(
                buf, noise, forged_mult=malicious_prefix, forge=forge,
                agg=aspec, sanitize=fr.health_check)
            fsq = (forged * forged).sum()
            sq = torch.cat([fsq.expand(malicious_prefix), sq_b])
            bad = torch.cat([torch.zeros((malicious_prefix,), dtype=torch.bool,
                                         device=dev), bad_b])
        else:
            agg_vec, sq, bad = fused_finish(buf, malicious, noise, forge=forge,
                                            agg=aspec,
                                            sanitize=fr.health_check)
        del buf
        server, metrics = _serve_aggregate(state, agg_vec, malicious, losses,
                                           sq, bad)
        if skip_blocks:
            metrics["elided_lanes"] = skip_blocks * client_block
        return RoundState(server=server, client_opt=state.client_opt), metrics

    return step
