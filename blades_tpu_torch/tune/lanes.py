"""Trial lanes: shape-compatible trials as lanes of one program
(counterpart of ``blades_tpu/tune/lanes.py``).

Trials that share every static config knob (model, aggregator, adversary
type, client count, batch size, ...) and differ only in lane knobs
(``LANE_KEYS``) run as lanes of one laned round per FL round instead of
one trial after another:

- ``seed``: the lane's data partition and its generators;
- ``client_lr`` / ``server_lr``: the local and the server optimizer's
  step size;
- ``dp_epsilon`` / ``dp_clip_threshold`` / ``dp_noise_factor``: the DP
  grid (``dp_epsilon`` reaches the round as its derived noise factor);
- ``adversary_scale``: IPM's scale.

Each lane is its own :class:`~blades_tpu_torch.core.round.FedRound`, the
group's round with the lane's scalars (:func:`_apply_lane`), and keeps its
own ``RoundState``; a lane's clients train in blocks of that lane alone,
from the lane's parameters (lane-pure blocks), and every lane draws from
the generators its sequential trial seeds (``seed_of(seed, round)``), so a
lane reproduces its sequential trial.  Under a coordinate-wise aggregator
(Median, Trimmedmean) with no codec the lanes' updates go into one
client-major ``(n, L, d)`` matrix, whose ``(n, L * d)`` view the
aggregator reads in one call (one ``select:radix`` launch on the card):
each column's order statistic is its own lane's, bit for bit what the
lane's own ``(n, d)`` call computes.  Any other round (Mean, the
row-geometry aggregators, codecs, DP with Mean) runs lane by lane on the
lane's own ``(n, d)`` matrix, so its reductions run in the sequential
trial's order.

The JAX package vmaps the lanes, so each of its lane scalars is a traced
``(L,)`` array; here a lane's scalars stay the Python floats of its
config, the same operations its sequential trial runs.  Per-seed training
shards are stacked on a lane axis, padded to the widest shard (a batch
draws its indices below the client's true length, so padding changes no
draw); the test shards stay per lane, since batch-statistics layers
evaluate over the padded shard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from blades_tpu_torch.ops.aggregators import Median, Trimmedmean
from blades_tpu_torch.utils.seeds import seed_of

#: Flat config fields a lane may vary.
LANE_KEYS = ("seed", "client_lr", "server_lr", "dp_epsilon",
             "dp_clip_threshold", "dp_noise_factor", "adversary_scale")


def _apply_lane(fr, sc: Dict[str, float]):
    """The group's round ``fr`` with one lane's scalars ``sc`` (a dict of
    the arithmetic knobs: ``client_lr``, ``server_lr``,
    ``adversary_scale``, ``dp_clip_threshold``, ``dp_noise_factor``).
    Structural knobs (momentum on or off, DP on or off, the adversary's
    type) stay the group's: :func:`lane_groups` keeps them equal."""
    task, server, adv = fr.task, fr.server, fr.adversary
    if "client_lr" in sc:
        task = dataclasses.replace(
            task, spec=dataclasses.replace(task.spec, lr=sc["client_lr"]))
    if "server_lr" in sc:
        server = dataclasses.replace(server, lr=sc["server_lr"])
    if "adversary_scale" in sc:
        adv = dataclasses.replace(adv, scale=sc["adversary_scale"])
    kw = {k: sc[k] for k in ("dp_clip_threshold", "dp_noise_factor")
          if k in sc}
    return dataclasses.replace(fr, task=task, server=server, adversary=adv,
                               **kw)


def batches_lanes(fr) -> bool:
    """Whether the laned round aggregates every lane in one call: a
    coordinate-wise aggregator, and no codec, fault injector or forensics
    (whose rounds run lane by lane)."""
    return (isinstance(fr.server.aggregator, (Median, Trimmedmean))
            and fr.codec is None and fr.faults is None and not fr.forensics)


def laned_step(frs, states, trains, malicious, seeds, handed=None):
    """One FL round of every lane: ``frs`` the lanes' rounds, ``states``
    their ``RoundState``\\ s, ``trains`` their ``(x, y, lengths)``
    shards, ``seeds`` their round seeds.  ``handed`` (per lane, a dict or
    None) replaces a lane's draws: ``batches`` ``(bx, by)`` and any of
    ``FedRound.step_prebatched``'s ``dropout_masks``, ``aug_draws``,
    ``forge_noise``, ``dp_noise``.  Returns ``(states, metrics)``, one
    entry per lane."""
    from blades_tpu_torch.core.round import round_generator

    fr0 = frs[0]
    handed = handed or [None] * len(frs)
    dev = next(iter(states[0].server.params.values())).device

    def batches(fr, tr, gen, h):
        return (h["batches"] if h is not None
                else fr.sample_round_batches(*tr, gen))

    def drawn(h, *keys):
        return {k: (h or {}).get(k) for k in keys}

    if not batches_lanes(fr0):
        new_states, metrics = [], []
        for fr, st, tr, sd, h in zip(frs, states, trains, seeds, handed):
            gen = round_generator(sd, dev)
            bx, by = batches(fr, tr, gen, h)
            st, m = fr.step_prebatched(
                st, bx, by, malicious, gen,
                **drawn(h, "dropout_masks", "aug_draws", "forge_noise",
                        "dp_noise"))
            new_states.append(st)
            metrics.append(m)
        return new_states, metrics
    from blades_tpu_torch.utils.tree import FlatLayout

    lanes = len(frs)
    n, d = int(fr0.num_clients), FlatLayout(states[0].server.params).d
    mal = malicious.to(device=dev, dtype=torch.bool)
    # Client-major: the (n, L * d) view puts lane i's coordinate j in
    # column i * d + j.
    mat = torch.empty((n, lanes, d), dtype=torch.float32, device=dev)
    pending = []
    for i, (fr, st, tr, sd, h) in enumerate(zip(frs, states, trains, seeds,
                                                handed)):
        gen = round_generator(sd, dev)
        bx, by = batches(fr, tr, gen, h)
        upd, opt, losses = fr.train_clients(
            st, bx, by, mal, gen, out=mat[:, i],
            **drawn(h, "dropout_masks", "aug_draws"))
        del bx, by
        rows, healthy = fr.prepare_rows(upd, mal, gen,
                                        **drawn(h, "forge_noise", "dp_noise"))
        norms = (rows * rows).sum(1).sqrt()
        if rows is not upd:
            mat[:, i] = rows
        del rows, upd
        pending.append((opt, losses, healthy, norms))
    agg_all = fr0.server.aggregator.aggregate(mat.view(n, lanes * d))
    del mat
    agg_all = agg_all.view(lanes, d)
    new_states, metrics = [], []
    for i, (fr, st) in enumerate(zip(frs, states)):
        opt, losses, healthy, norms = pending[i]
        agg = agg_all[i]
        server = fr.server.apply_aggregate(st.server, agg)
        ns, m = fr.close_round(st, server, agg, norms, losses, mal,
                               healthy=healthy, client_opt=opt)
        new_states.append(ns)
        metrics.append(m)
    return new_states, metrics


def _stack_shards(arrs: List[np.ndarray]) -> np.ndarray:
    """Per-seed ``(n, cap_i, ...)`` shards padded to the widest cap and
    stacked: ``(L, n, cap, ...)``."""
    cap = max(a.shape[1] for a in arrs)
    return np.stack([
        np.pad(a, [(0, 0), (0, cap - a.shape[1])] + [(0, 0)] * (a.ndim - 2))
        for a in arrs])


def run_lanes(
    config_builder: Callable[[], "FedavgConfig"],  # noqa: F821
    lane_overrides: List[Dict],
    max_rounds: int,
    *,
    device=None,
    metrics_every: int = 1,
    tracer=None,
    return_states: bool = False,
    draws=None,
    init_params=None,
):
    """Run one trial per lane-override dict as lanes of one program.

    Args:
        config_builder: zero-argument callable returning a fresh config
            with the group's shared settings.
        lane_overrides: per lane, a dict of ``LANE_KEYS`` to that lane's
            value; every lane overrides the same keys.
        max_rounds: FL rounds per trial.
        device: torch device (``None`` = the card).
        metrics_every: fetch the lanes' metrics this many rounds at a
            time (and at the end).
        tracer: an :class:`~blades_tpu_torch.obs.trace.Tracer`; rounds
            and evaluations become its spans.
        return_states: also return the lanes' final ``RoundState``\\ s.
        draws: ``draws(lane, round) -> dict`` handing a lane's round the
            draws :func:`laned_step` takes as ``handed`` (another
            package's, for a parity check), or None.
        init_params: per lane, the parameters to start from in place of
            the lane's seeded initialisation, or None.

    Returns:
        Per lane, its per-round result rows (and, with ``return_states``,
        ``(rows, states)``).
    """
    from blades_tpu_torch.adversaries import make_malicious_mask
    from blades_tpu_torch.algorithms.fedavg import eval_arrays
    from blades_tpu_torch.data.datasets import DatasetCatalog
    from blades_tpu_torch.device import resolve_device
    from blades_tpu_torch.obs.trace import Tracer
    from blades_tpu_torch.utils.async_metrics import fetch as fetch_tree
    from blades_tpu_torch.utils.tree import FlatLayout

    if tracer is None:
        tracer = Tracer(record=False)
    dev = resolve_device(device)
    L = len(lane_overrides)
    keys_set = {frozenset(o.keys()) for o in lane_overrides}
    if len(keys_set) != 1:
        raise ValueError("all lanes must override the same keys")
    ok = next(iter(keys_set))
    unknown = set(ok) - set(LANE_KEYS)
    if unknown:
        raise ValueError(f"not lane-traceable: {sorted(unknown)}")

    # Per-lane configs (validated): the source of the seeds and of the
    # derived scalars such as FedavgDPConfig's noise factor.
    cfgs = []
    for o in lane_overrides:
        c = config_builder()
        for k, v in o.items():
            if k == "adversary_scale":
                ac = dict(c.adversary_config or {})
                ac["scale"] = v
                c.adversary_config = ac
            else:
                setattr(c, k, v)
        c.validate()
        cfgs.append(c)
    base = cfgs[0]
    fr = base.get_fed_round()
    if getattr(fr.server.aggregator, "expects_trusted_row", False):
        raise ValueError("trust-bootstrapped aggregators are not lane-able")
    if "server_lr" in ok and base.lr_schedule:
        raise ValueError(
            "server_lr lanes are incompatible with a configured "
            "lr_schedule; drop the schedule or run these trials "
            "sequentially")

    seeds = [int(c.seed) for c in cfgs]
    sc = {}
    for field in ("client_lr", "server_lr"):
        if field in ok:
            sc[field] = [float(getattr(c, field)) for c in cfgs]
    if "dp_epsilon" in ok or "dp_noise_factor" in ok:
        sc["dp_noise_factor"] = [float(c.dp_noise_factor) for c in cfgs]
    if "dp_clip_threshold" in ok:
        sc["dp_clip_threshold"] = [float(c.dp_clip_threshold) for c in cfgs]
    if "adversary_scale" in ok:
        sc["adversary_scale"] = [float(c.adversary_config["scale"])
                                 for c in cfgs]

    def load(seed):
        return DatasetCatalog.get_dataset(
            base.dataset, num_clients=base.num_clients, iid=base.iid,
            alpha=base.dirichlet_alpha, seed=seed)

    datasets = {s: load(s) for s in dict.fromkeys(seeds)}
    first_ds = datasets[seeds[0]]
    if len(datasets) > 1:
        parts = [datasets[s].train for s in seeds]
        x = torch.from_numpy(_stack_shards([p.x for p in parts])).to(dev)
        y = torch.from_numpy(_stack_shards([p.y for p in parts])).long().to(
            dev)
        ln = torch.from_numpy(np.stack([p.lengths for p in parts])).long(
            ).to(dev)
        trains = [(x[i], y[i], ln[i]) for i in range(L)]
    else:
        p = first_ds.train
        shared = (torch.from_numpy(p.x).to(dev),
                  torch.from_numpy(p.y).long().to(dev),
                  torch.from_numpy(p.lengths).long().to(dev))
        trains = [shared] * L
    tests = [eval_arrays(c, datasets[s], dev) for c, s in zip(cfgs, seeds)]
    # Fedavg's auto-augment resolution: crops of the synthetic fallback's
    # Gaussian patterns destroy the signal.
    fr = base.resolve_augment_for_data(fr, first_ds)
    frs = [_apply_lane(fr, {k: v[i] for k, v in sc.items()})
           for i in range(L)]
    mal = make_malicious_mask(base.num_clients, base.num_malicious_clients,
                              device=dev)
    states = [f.init(s, base.num_clients, device=dev)
              for f, s in zip(frs, seeds)]
    if init_params is not None:
        states = [dataclasses.replace(
            st, server=f.server.init(
                {k: v.to(dev) for k, v in p.items()}, base.num_clients),
            client_opt=f.task.init_client_opt_state(p, base.num_clients))
            for f, st, p in zip(frs, states, init_params)]

    # Static per round, stamped into every lane's rows as the sequential
    # driver stamps them.
    comm_row = {}
    if fr.codec is not None:
        d_model = FlatLayout(states[0].server.params).d
        comm_row = fr.codec.round_metrics(base.num_clients, d_model)
        comm_row["agg_domain"] = fr.agg_domain
        comm_row["agg_domain_bits"] = (fr.codec.storage_bits
                                       if fr.agg_domain == "wire" else 32)
    if fr.packing is not None:
        comm_row["pack_factor"] = int(fr.packing.pack)
        comm_row["packed_lanes"] = int(base.num_clients // fr.packing.pack)

    interval = base.evaluation_interval
    results: List[List[Dict]] = [[] for _ in range(L)]
    last_eval: List[Dict] = [{} for _ in range(L)]
    pending: List = []

    def flush():
        nonlocal last_eval
        if not pending:
            return
        with tracer.time("fetch", rows=len(pending)):
            fetched = fetch_tree([(m, e) for _, m, e in pending])
        for (r, _, _), (metrics, ev) in zip(pending, fetched):
            if ev is not None:
                last_eval = [{k: float(ev[i][k]) for k in (
                    "test_loss", "test_acc", "test_acc_top3")}
                    for i in range(L)]
            for i in range(L):
                row = {
                    "training_iteration": r,
                    "train_loss": float(metrics[i]["train_loss"]),
                    "agg_norm": float(metrics[i]["agg_norm"]),
                    "update_norm_mean": float(metrics[i]["update_norm_mean"]),
                    "seed": seeds[i],
                }
                row.update(comm_row)
                row.update({k: v for k, v in lane_overrides[i].items()
                            if k != "seed"})
                row.update(last_eval[i])
                results[i].append(row)
        pending.clear()

    for r in range(1, max_rounds + 1):
        round_seeds = [seed_of(s, r - 1) for s in seeds]
        # The first round builds the kernels: its span is "compile", as
        # in the sequential runner.
        with tracer.time("round" if r > 1 else "compile", step=r, lanes=L):
            states, metrics = laned_step(
                frs, states, trains, mal, round_seeds,
                None if draws is None else [draws(i, r) for i in range(L)])
            metrics = [{k: m[k] for k in ("train_loss", "agg_norm",
                                          "update_norm_mean")}
                       for m in metrics]
            ev = None
            if interval and r % interval == 0:
                with tracer.time("evaluate", step=r):
                    ev = [{k: v for k, v in f.evaluate(st, *te).items()
                           if k != "num_samples"}
                          for f, st, te in zip(frs, states, tests)]
        pending.append((r, metrics, ev))
        if len(pending) >= max(1, metrics_every):
            flush()
    flush()
    return (results, states) if return_states else results


def run_seed_lanes(config, seeds: List[int], max_rounds: int, *,
                   device=None) -> List[List[Dict]]:
    """Seed-only lanes: one trial of ``config`` per seed."""
    return run_lanes(config.copy, [{"seed": int(s)} for s in seeds],
                     max_rounds, device=device)
