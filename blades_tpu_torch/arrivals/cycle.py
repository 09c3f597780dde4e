"""The buffered-async aggregation cycle (counterpart of
``blades_tpu/arrivals/cycle.py``), a plain function over torch tensors.

The cycle consumes ``K`` buffered arrival events -- ``(client, tick,
version)`` -- and computes each event's local round against the global
parameters the client last pulled, read from the ``(H+1, d)``
params-history ring (row ``j`` the parameters of ``j`` versions ago):

    per block of ``client_block`` events: the ring rows they pulled, their
    shards and optimizer rows -> local rounds, each lane from its own
    parameters (``Task.local_round_batched(lane_params=True)``)
    -> corruption of the flagged events -> adversary forge
    -> staleness-weighted robust aggregate (``Server.step_buffered``)
    -> server step; the new parameters pushed into the ring

Randomness is pure in ``(seed, tick, client)`` per event: batch indices,
augmentation and dropout masks come from a CPU generator seeded from
those three (:func:`event_generator`), so a resumed trial needs nothing
but the checkpointed tick.  The forge and the aggregator draw from a
generator of the cycle's server version (:func:`cycle_seed`).  The JAX
package's draws come from its own PRNG; ``prebatched=``,
``dropout_masks=``, ``aug_draws=`` and ``forge_noise=`` take them
instead.

Lazy ``mode="replay"`` (``wants_stale_replay``) computes malicious
events against the oldest ring row; campaign adversaries
(``wants_ticks``) receive the events' arrival ticks.  The optimizer rows
of the events are advanced in place in ``state.client_opt`` (the
registered stack), or, with ``windowed_state``, ``state.client_opt`` holds
the ``K`` event rows (gathered by the engine from its state store) and
comes back advanced.

With ``fed_round.forensics`` the cycle aggregates through
``Server.step_buffered_diag`` (the same aggregate) and its metrics gain
the detection scalars against the events' malicious mask,
``num_unhealthy`` and the per-lane bundle: lane i diagnoses registered
client ``ev_clients[i]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from blades_tpu_torch.adversaries.base import forges
from blades_tpu_torch.core.round import RoundState, _rows, lane_forensics
from blades_tpu_torch.data.sampler import sample_batch_indices
from blades_tpu_torch.faults.injector import _CORRUPT_FILL
from blades_tpu_torch.utils.seeds import generator_of, seed_of
from blades_tpu_torch.utils.tree import FlatLayout

#: Salt of the per-event training stream.
ASYNC_TRAIN_FOLD = 0xA51C
#: Salt of the per-cycle aggregation stream.
ASYNC_AGG_FOLD = 0xA99E


def event_generator(seed: int, tick: int, client: int) -> torch.Generator:
    """The CPU generator of one arrival event: pure in ``(seed, tick,
    client)``."""
    return generator_of(seed, ASYNC_TRAIN_FOLD, tick, client)


def cycle_seed(seed: int, version: int) -> int:
    """The seed of the forge / aggregation generator of the cycle fired
    at server ``version``."""
    return seed_of(seed, ASYNC_AGG_FOLD, version)


def init_history(params, staleness_cap: int) -> torch.Tensor:
    """The ``(H+1, d)`` params-history ring, every row the initial
    parameters (a client pulling before the first aggregation sees
    version 0)."""
    vec = FlatLayout(params).ravel(params)
    return vec[None, :].repeat(staleness_cap + 1, 1)


def draw_event_inputs(task, seed: int, ticks, clients, lengths,
                      batch_size: int, num_batches: int):
    """Every event's draws, each from its own :func:`event_generator`:
    ``(indices (K, nb, B) int64, dropout masks or None, augmentation
    draws or None)``, on the CPU.  ``lengths`` holds the events' true
    shard sizes."""
    idx, masks, aug = [], [], []
    shape = (1, num_batches, batch_size)
    for t, c, ln in zip(ticks, clients, lengths):
        gen = event_generator(seed, int(t), int(c))
        idx.append(sample_batch_indices(
            gen, torch.tensor([int(ln)]), batch_size, num_batches))
        aug.append(task.draw_augment(gen, shape, "cpu"))
        masks.append(task.draw_dropout_masks(gen, shape, "cpu"))
    aug = (None if aug[0] is None else
           tuple(torch.cat([a[i] for a in aug]) for i in range(2)))
    masks = (None if masks[0] is None else
             tuple(torch.cat([m[i] for m in masks])
                   for i in range(len(masks[0]))))
    return torch.cat(idx), masks, aug


def build_cycle(fed_round, *, staleness_cap: int, weight_schedule: str,
                weight_power: float, weight_cutoff: int,
                corrupt_mode: Optional[str] = None,
                windowed_state: bool = False, client_block: int = 50):
    """The cycle function of ``fed_round``:

    ``cycle(state, data, ev_clients, ev_ticks, ev_stale, ev_malicious,
    ev_corrupt, ev_lengths, *, seed, version, prebatched=None,
    dropout_masks=None, aug_draws=None, forge_noise=None) -> (new_state,
    metrics)``.

    ``data`` is ``(x, y)`` stacked over the registered clients (indexed by
    ``ev_clients``), or with ``windowed_state`` over the events in event
    order; the ``ev_*`` columns are the engine's ``(K,)`` host arrays
    (``ev_lengths`` the events' true shard sizes).  ``state.arrivals``
    holds the ring.  ``prebatched`` (``(bx (K, nb, B, ...), by (K, nb,
    B))``), ``dropout_masks``, ``aug_draws`` (the per-event draws) and
    ``forge_noise`` (the adversary's ``noise=``) replace the port's own
    draws.  After a call, ``cycle.last_ring_rows`` holds the ``(K,)`` ring
    rows the events trained against."""
    task = fed_round.task
    adv = fed_round.adversary
    stale_replay = bool(getattr(adv, "wants_stale_replay", False))
    wants_ticks = bool(getattr(adv, "wants_ticks", False))
    fill = None if corrupt_mode is None else _CORRUPT_FILL[corrupt_mode]
    hooks = fed_round.hooks()
    nb, bsz = fed_round.num_batches_per_round, fed_round.batch_size
    server = fed_round.server
    forensics = bool(getattr(fed_round, "forensics", False))

    def cycle(state: RoundState, data, ev_clients, ev_ticks, ev_stale,
              ev_malicious, ev_corrupt, ev_lengths, *, seed: int,
              version: int, prebatched=None, dropout_masks=None,
              aug_draws=None, forge_noise=None
              ) -> Tuple[RoundState, dict]:
        hist = state.arrivals
        dev = hist.device
        params = state.server.params
        layout = FlatLayout(params)
        k = len(ev_clients)
        stale = np.clip(np.asarray(ev_stale, np.int64), 0, staleness_cap)
        mal_host = np.asarray(ev_malicious, bool)
        if stale_replay:
            stale = np.where(mal_host, staleness_cap, stale)
        # The ring row each event trained against, for inspection.
        cycle.last_ring_rows = stale
        ring_rows = torch.as_tensor(stale, device=dev)
        mal = torch.as_tensor(mal_host, device=dev)
        rows = torch.as_tensor(
            np.arange(k) if windowed_state else np.asarray(ev_clients),
            dtype=torch.int64, device=dev)
        x, y = data
        if prebatched is None:
            idx, masks, aug = draw_event_inputs(
                task, seed, ev_ticks, ev_clients, ev_lengths, bsz, nb)
            masks = dropout_masks if dropout_masks is not None else masks
            aug = aug_draws if aug_draws is not None else aug
            idx = idx.to(dev)
        else:
            idx, masks, aug = None, dropout_masks, aug_draws
        opt = state.client_opt
        new_opt = (None if opt is None else
                   {n: torch.empty((k,) + v.shape[1:], dtype=v.dtype,
                                   device=v.device) for n, v in opt.items()})
        updates = torch.empty((k, layout.d), dtype=torch.float32, device=dev)
        losses = torch.empty((k,), dtype=torch.float32, device=dev)
        for b0 in range(0, k, client_block):
            b1 = min(k, b0 + client_block)
            r = rows[b0:b1]
            # Only this block's pulled versions are unravelled.
            lane = layout.unravel_rows(hist[ring_rows[b0:b1]])
            if prebatched is None:
                bx = x[r[:, None, None], idx[b0:b1]]
                by = y[r[:, None, None], idx[b0:b1]]
            else:
                bx, by = (t[b0:b1].to(dev) for t in prebatched)
            opt_b = None if opt is None else {n: v[r] for n, v in opt.items()}
            _, loss, opt_b = task.local_round_batched(
                lane, bx, by.long(), opt_state=opt_b,
                malicious=mal[b0:b1], hooks=hooks,
                dropout_masks=_to(_rows(masks, b0, b1), dev),
                aug_draws=_to(_rows(aug, b0, b1), dev),
                out=updates[b0:b1], lane_params=True)
            losses[b0:b1] = loss
            if new_opt is not None:
                for n, v in opt_b.items():
                    new_opt[n][b0:b1] = v
            del lane
        corrupt = torch.as_tensor(np.asarray(ev_corrupt, bool), device=dev)
        if fill is not None:
            updates = torch.where(corrupt[:, None], torch.full(
                (), fill, dtype=updates.dtype, device=dev), updates)
        gen = torch.Generator(device=dev).manual_seed(cycle_seed(seed,
                                                                 version))
        if forges(adv):
            kw = {"ticks": torch.as_tensor(np.asarray(ev_ticks, np.int64),
                                           device=dev)} if wants_ticks else {}
            updates = adv.on_updates_ready(
                updates, mal, noise=forge_noise, generator=gen,
                aggregator=server.aggregator, **kw)
        trusted = fed_round.compute_trusted_update(params, gen)
        # Norms of the delivered rows, before the staleness weighting.
        norms = (updates * updates).sum(1).sqrt()
        # The health predicate at the point the sync round takes it
        # (post-corruption, post-forge: what the server judges).
        healthy = torch.isfinite(updates).all(1) if forensics else None
        step = server.step_buffered_diag if forensics else server.step_buffered
        out = step(
            state.server, updates, staleness=torch.as_tensor(
                np.asarray(ev_stale, np.int64)), generator=gen,
            trusted_update=trusted, schedule=weight_schedule,
            power=weight_power, cutoff=weight_cutoff)
        new_server, agg = out[:2]
        del updates
        new_hist = torch.cat([FlatLayout(new_server.params).ravel(
            new_server.params)[None], hist[:-1]])
        if opt is not None and not windowed_state:
            for n, v in new_opt.items():
                opt[n].index_copy_(0, rows, v)
            new_opt = opt
        benign = ((~mal) & (~corrupt)).float()
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(
                min=1.0),
            "update_norm_mean": norms.mean(),
            "agg_norm": (agg * agg).sum().sqrt(),
            "round": new_server.round,
        }
        if forensics:
            metrics.update(lane_forensics(out[2], mal, healthy, norms))
            metrics["num_unhealthy"] = (~healthy).sum()
        return RoundState(server=new_server, client_opt=new_opt,
                          stale=state.stale, residual=state.residual,
                          arrivals=new_hist), metrics

    return cycle


def _to(t, dev):
    if t is None:
        return None
    return tuple(v.to(dev) for v in t)
