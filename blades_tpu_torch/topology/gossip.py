"""Decentralized gossip round: peer-graph federation, no central server
(counterpart of ``blades_tpu/topology/gossip.py``).

Every node holds its OWN parameter replica, trains locally, exchanges
models with its graph neighborhood (:mod:`blades_tpu_torch.topology.graph`),
robust-aggregates its neighbors' updates with the existing aggregators,
and mixes parameters with doubly-stochastic gossip weights.  On one card
the replicas are stacked: ``RoundState.server`` is one
:class:`~blades_tpu_torch.core.server.ServerState` whose parameter leaves
carry a leading node axis ``(n, *shape)`` (:func:`gossip_federation`), so
the JAX round's gathers are plain indexing.

Round anatomy::

    train    θ_i --local rounds--> u_i       (blocks of lanes, each from
                                              its own replica)
    forge    dense-order health -> DP -> adversary
    select   slot-major (k1, n, d) neighborhood matrices (static tables;
             per receiver under a topology-scoped attack; a dead edge's
             slot holds the node's own row)
    mix      θ̄_i = θ_i + Σ_s w[i,s] (θ_nbr − θ_i)   (deviation form)
    agg      per-node robust aggregate + optimizer step on the stacks;
             self-trust below the aggregator's breakdown line

The column selects (Median, Trimmedmean) run once over the ``(k1, n *
d)`` view of the slot-major matrices: their columns are independent, so
one call (one ``select:radix`` launch on the card) is n per-node calls.
Multikrum runs all nodes on batched ``k1 x k1`` products.  The other
aggregators run node by node on each node's contiguous ``(k1, d)``
matrix, Mean among them: a reduction's summation order at the tail of a
row depends on the row's length, and the complete-graph pin needs the
dense round's ``mean(0)`` on the same ``(n, d)`` shape.  The mixing
accumulates slot by slot into an ``(n, d)`` sum, so no second ``(k1, n,
d)`` tensor is made.

Randomness follows the dense round: one generator per round, drawn in
the dense order (the batches, then per block the dropout masks and
augmentation draws, then DP noise and the forge's); the node-level draws
of a stochastic aggregator follow in node order.  ``step_prebatched(...,
edge_drop=)`` replaces the edge-dropout realization
(:meth:`~blades_tpu_torch.faults.FaultInjector.realize_edges`, pure in
``(fault seed, round)``), as the other draws are replaced.

On the complete graph each node's neighborhood slots are ``0..n-1`` in
ascending order, so its matrix IS the dense matrix, deviation-form mixing
over identical replicas is exactly the identity, and the aggregation half
of a complete-graph + Mean round equals :meth:`FedRound.finish_dense`'s
bit for bit on the same update matrix.  Local training from per-lane
parameters (a batched matmul or grouped convolution in the first step)
matches the dense round's shared-parameter training to f32 rounding.

Accounting: the round records the JAX round's collectives on its
:class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder` (the
updates, parameters, losses and aggregate-norm gathers, and with faults
the partition count's psum), each over a ring of one device: they
reconcile with
:func:`blades_tpu_torch.parallel.comm_model.gossip_round_volumes` for a
mesh of one, and ``gossip_ici_bytes`` is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from blades_tpu_torch.adversaries.base import forges
from blades_tpu_torch.core.health import sanitize_updates
from blades_tpu_torch.core.round import (
    FedRound,
    RoundState,
    _rows,
    round_generator,
)
from blades_tpu_torch.core.server import ServerState, lr_schedule
from blades_tpu_torch.ops.aggregators import (
    BREAKDOWN_MIN_ROWS,
    Median,
    Multikrum,
    Trimmedmean,
    _empty,
    breakdown_min_rows,
)
from blades_tpu_torch.parallel.streamed_geometry import PassRecorder
from blades_tpu_torch.topology.graph import TopologyConfig
from blades_tpu_torch.utils.tree import FlatLayout

#: Aggregators that run all nodes in one call over the ``(k1, n * d)``
#: view (stateless order statistics, column by column).
_SELECTS = (Median, Trimmedmean)
#: The one device the round runs on: every collective's ring size.
_RING = 1


def check_supported(fr: FedRound, topo: TopologyConfig) -> None:
    """The JAX package's refusals of the gossip round, with its words
    (a 2-D mesh and lane packing do not exist in the port)."""
    if fr.codec is not None:
        raise ValueError("gossip × codec is unsupported — the wire codec "
                         "runs on server-bound updates, which do not "
                         "exist here")
    if fr.agg_domain != "f32":
        raise ValueError(
            f"gossip × agg_domain={fr.agg_domain!r} is unsupported — "
            "per-node neighborhood aggregation is f32-domain only")
    if fr.stateless_clients:
        raise ValueError("gossip × stateless clients (window=0) is "
                         "unsupported")
    if fr.forensics:
        raise ValueError("gossip × forensics is unsupported — per-lane "
                         "diagnostics assume the single server matrix")
    if fr.faults is not None:
        if fr.faults.needs_stale_buffer:
            raise ValueError(
                "gossip × straggler faults is unsupported — the stale "
                "ring buffer is a server-path process; gossip faults are "
                "EDGE dropout (use dropout_rate/dropout_schedule)")
        if fr.faults.corrupt_rate > 0.0:
            raise ValueError(
                "gossip × corruption faults is unsupported — lane "
                "corruption models server-bound transfers; gossip "
                "faults are EDGE dropout")
    if fr.num_clients is not None and int(fr.num_clients) != topo.num_nodes:
        raise ValueError(
            f"topology num_nodes={topo.num_nodes} != num_clients="
            f"{fr.num_clients}: on the gossip path every client IS a "
            "node — size the topology to the federation")
    k1 = topo.neighbor_tables().nbr_idx.shape[1]
    name = type(fr.server.aggregator).__name__
    if name in BREAKDOWN_MIN_ROWS:
        f_cfg = int(getattr(fr.server.aggregator, "num_byzantine", 0) or 0)
        need = breakdown_min_rows(name, f_cfg)
        if need > k1:
            raise ValueError(
                f"gossip × {name}(num_byzantine={f_cfg}) needs "
                f"neighborhood matrices of >= {need} rows, but graph="
                f"{topo.graph!r} gives max closed-neighborhood size "
                f"{k1} — densify the graph (kregular with larger k, "
                "complete) or pick an aggregator with a smaller "
                "breakdown bound")


def degradation_bound(fr: FedRound) -> Tuple[int, int]:
    """``(a, b)`` of the aggregator's breakdown line ``a*f + b``
    (self-trust below it); an unknown aggregator never degrades."""
    return BREAKDOWN_MIN_ROWS.get(type(fr.server.aggregator).__name__, (0, 1))


def gossip_federation(round_state: RoundState, num_nodes: int) -> RoundState:
    """The gossip placement of a fresh :meth:`FedRound.init` state: the
    server state STACKED to one replica per node (parameter and momentum
    leaves ``(n, *shape)``, the optimizer counters ``(n,)`` host arrays,
    a stateful aggregator's state one entry per node); the client
    optimizer rows are already per node."""
    srv = round_state.server
    n = int(num_nodes)
    params = {k: v[None].expand((n,) + tuple(v.shape)).clone()
              for k, v in srv.params.items()}
    opt = {"count": np.full((n,), int(srv.opt_state["count"]), np.int64)}
    if "buf" in srv.opt_state:
        opt["buf"] = {k: v[None].expand((n,) + tuple(v.shape)).clone()
                      for k, v in srv.opt_state["buf"].items()}
        opt["step"] = np.full((n,), int(srv.opt_state["step"]), np.int64)
    agg_state = srv.agg_state
    if not _empty(agg_state):
        agg_state = [_clone(agg_state) for _ in range(n)]
    server = ServerState(params=params, opt_state=opt, agg_state=agg_state,
                         round=srv.round)
    return dataclasses.replace(round_state, server=server)


def _clone(state):
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        return tuple(_clone(s) for s in state)
    return state


def node_head(state: RoundState) -> RoundState:
    """The state of node 0's replica: the head that
    :func:`gossip_evaluate` scores."""
    srv = state.server
    return dataclasses.replace(state, server=ServerState(
        params={k: v[0] for k, v in srv.params.items()},
        opt_state={}, agg_state=(), round=srv.round))


def gossip_evaluate(fr: FedRound):
    """Evaluation of a gossip state: the node-0 replica through the dense
    evaluation.  On a healthy (unpartitioned) run consensus makes every
    head equivalent; ``consensus_dist`` says when that broke."""

    def evaluate(state: RoundState, test_x, test_y, lengths):
        return fr.evaluate(node_head(state), test_x, test_y, lengths)

    return evaluate


class GossipStep:
    """One gossip round of ``fr`` over ``topo`` (build it with
    :func:`gossip_step`): ``step(state, x, y, lengths, malicious, seed)``
    as :meth:`FedRound.step`, and :meth:`step_prebatched` /
    :meth:`finish` for the two halves."""

    def __init__(self, fr: FedRound, topo: TopologyConfig,
                 recorder: Optional[PassRecorder] = None):
        check_supported(fr, topo)
        self.fr, self.topo = fr, topo
        self.recorder = recorder if recorder is not None else PassRecorder()
        self.tables = topo.neighbor_tables()
        self.n = topo.num_nodes
        self.k1 = int(self.tables.nbr_idx.shape[1])
        self.bound = degradation_bound(fr)
        adv = fr.adversary
        if getattr(adv, "topology_scoped", False):
            recv = adv.receiver_mask(topo.adjacency())
        else:
            # Broadcast forges: every receiver sees the forged rows (the
            # dense threat model).
            recv = np.ones((self.n, self.n), bool)
        # (n, k1): does slot s of node i read its sender's forged row?
        self.sel = np.take_along_axis(recv, self.tables.nbr_idx.astype(
            np.int64), 1)

    # -- the round -----------------------------------------------------------

    def __call__(self, state: RoundState, data_x, data_y, lengths, malicious,
                 seed) -> Tuple[RoundState, dict]:
        dev = next(iter(state.server.params.values())).device
        gen = round_generator(seed, dev)
        bx, by = self.fr.sample_round_batches(data_x, data_y, lengths, gen)
        return self.step_prebatched(state, bx, by, malicious, gen)

    def step_prebatched(self, state: RoundState, bx, by, malicious,
                        generator=None, *, dropout_masks=None,
                        aug_draws=None, forge_noise=None, dp_noise=None,
                        edge_drop=None) -> Tuple[RoundState, dict]:
        """:meth:`__call__` with the batches drawn: every node's local
        round from its own replica, in blocks of ``fr.client_block``
        lanes, then :meth:`finish`.  ``dropout_masks``, ``aug_draws``,
        ``forge_noise`` and ``dp_noise`` replace those draws, as in
        :meth:`FedRound.step_prebatched`; ``edge_drop`` (an ``(n, n)``
        bool mask) the edge-dropout realization."""
        fr = self.fr
        params = state.server.params
        dev = next(iter(params.values())).device
        if isinstance(generator, int):
            generator = round_generator(generator, dev)
        n = bx.shape[0]
        if n != self.n:
            raise ValueError(f"{n} nodes' batches for a topology of "
                             f"{self.n} nodes")
        malicious = malicious.to(device=dev, dtype=torch.bool)
        layout = FlatLayout({k: v[0] for k, v in params.items()})
        block = min(fr.client_block or n, n)
        hooks = fr.hooks()
        opt = state.client_opt
        new_opt = (None if opt is None
                   else {k: torch.empty_like(v) for k, v in opt.items()})
        updates = torch.empty((n, layout.d), dtype=torch.float32, device=dev)
        losses = torch.empty((n,), dtype=torch.float32, device=dev)
        for r0 in range(0, n, block):
            r1 = min(n, r0 + block)
            _, loss, opt_b = fr.task.local_round_batched(
                {k: v[r0:r1] for k, v in params.items()},
                bx[r0:r1].to(dev), by[r0:r1].to(dev),
                opt_state=_rows(opt, r0, r1), malicious=malicious[r0:r1],
                hooks=hooks, generator=generator,
                dropout_masks=_rows(dropout_masks, r0, r1),
                aug_draws=_rows(aug_draws, r0, r1), out=updates[r0:r1],
                lane_params=True)
            losses[r0:r1] = loss
            if new_opt is not None:
                for k, v in opt_b.items():
                    new_opt[k][r0:r1] = v
        return self.finish(state, updates, new_opt, losses, malicious,
                           generator, forge_noise=forge_noise,
                           dp_noise=dp_noise, edge_drop=edge_drop)

    def finish(self, state: RoundState, updates, client_opt, losses,
               malicious, generator=None, *, forge_noise=None, dp_noise=None,
               edge_drop=None) -> Tuple[RoundState, dict]:
        """The exchange half of the round over the ``(n, d)`` update
        matrix: health check, DP and forge in the dense order, the
        per-receiver neighborhood matrices, mixing, the per-node
        aggregate and optimizer step, and the metrics."""
        fr, rec, n, k1 = self.fr, self.recorder, self.n, self.k1
        srv = state.server
        dev = updates.device
        d = updates.shape[1]
        malicious = malicious.to(device=dev, dtype=torch.bool)
        # One round's accounting: the JAX round's collectives, each over
        # the one device's ring.
        rec.ici_events.clear()
        rec.ici_bytes = 0
        layout = FlatLayout({k: v[0] for k, v in srv.params.items()})
        theta = layout.ravel_rows(srv.params)
        rec.count_ici("updates_gather", "all_gather", n * d * 4, _RING)
        rec.count_ici("params_gather", "all_gather", n * d * 4, _RING)
        rec.count_ici("losses_gather", "all_gather", n * 4, _RING)

        healthy = None
        if fr.health_check:
            updates, healthy = sanitize_updates(updates)
        clean = fr.apply_dp(updates, dp_noise, generator)
        forged = clean
        if forges(fr.adversary):
            forged = fr.adversary.on_updates_ready(
                clean, malicious, noise=forge_noise, generator=generator,
                aggregator=fr.server.aggregator)

        tabs = self.tables
        nbr = tabs.nbr_idx.astype(np.int64)
        w_eff = tabs.w_slot
        live = degraded = None
        if fr.faults is not None:
            # Symmetric edge dropout, pure in (fault seed, round).
            r0 = int(srv.round)
            drop = (fr.faults.realize_edges(n, r0) if edge_drop is None
                    else torch.as_tensor(edge_drop, dtype=torch.bool))
            dropped = np.take_along_axis(np.asarray(drop.cpu(), bool), nbr, 1)
            is_self = nbr == np.arange(n)[:, None]
            live = tabs.valid & (is_self | ~dropped)
            w_eff = np.where(live, tabs.w_slot, np.float32(0.0))
            # Loud per-node degradation: live rows below the aggregator's
            # breakdown line a*f_i + b -> self-trust.
            mal_host = malicious.cpu().numpy()
            f_i = (mal_host[nbr] & live).sum(1)
            a_bd, b_bd = self.bound
            degraded = live.sum(1) < a_bd * f_i + b_bd

        mat = self._neighborhoods(forged, clean, nbr, live)
        mixed = self._mix(theta, nbr, w_eff)
        aggs, agg_state = self._aggregate(mat, mixed, srv, generator)
        del mat
        if degraded is not None and degraded.any():
            own = torch.as_tensor(degraded, device=dev)[:, None]
            aggs = torch.where(own, clean, aggs)
        new_srv = self._apply(srv, mixed, layout, aggs, agg_state)
        del mixed
        aggn = (aggs * aggs).sum(1).sqrt()
        rec.count_ici("aggnorm_gather", "all_gather", n * 4, _RING)

        benign = (~malicious).float()
        gram = theta @ theta.T
        diag = torch.diagonal(gram)
        sq = diag[:, None] + diag[None, :] - 2.0 * gram
        node0 = aggs[0]
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(min=1.0),
            "update_norm_mean": (forged * forged).sum(1).sqrt().mean(),
            "agg_norm": (node0 * node0).sum().sqrt(),
            "round": new_srv.round,
            "consensus_dist": sq.clamp(min=0.0).max().sqrt(),
        }
        if degraded is not None:
            metrics["num_partitioned_nodes"] = torch.tensor(
                int(degraded.sum()), dtype=torch.int32)
            rec.count_ici("partitioned_psum", "psum", 4, _RING)
        else:
            metrics["num_partitioned_nodes"] = torch.tensor(
                0, dtype=torch.int32)
        if fr.health_check:
            metrics["num_unhealthy"] = (~healthy).sum()
            metrics["round_ok"] = torch.isfinite(aggn).all()
        metrics["gossip_ici_bytes"] = torch.tensor(rec.ici_bytes,
                                                   dtype=torch.int64)
        return RoundState(server=new_srv, client_opt=client_opt,
                          stale=state.stale, residual=state.residual,
                          cohort=getattr(state, "cohort", None)), metrics

    # -- the stages ----------------------------------------------------------

    def _neighborhoods(self, forged, clean, nbr, live):
        """The slot-major ``(k1, n, d)`` neighborhood matrices: slot ``s``
        of node ``i`` holds sender ``j = nbr[i, s]``'s forged row where
        the adversary's edge reaches receiver ``i`` (identical to the
        clean row for a benign ``j``), else its clean row; a dead slot
        (a dropped edge or a pad slot under faults) holds ``i``'s own
        clean row."""
        n, k1 = self.n, self.k1
        dev = clean.device
        mat = torch.empty((k1, n, clean.shape[1]), dtype=torch.float32,
                          device=dev)
        for s in range(k1):
            idx = nbr[:, s]
            sel = self.sel[:, s]
            src = forged if sel.all() else clean
            torch.index_select(src, 0, torch.as_tensor(idx, device=dev),
                               out=mat[s])
            part = np.flatnonzero(sel) if not sel.all() else ()
            if len(part):
                rows = torch.as_tensor(part, device=dev)
                mat[s, rows] = forged.index_select(
                    0, torch.as_tensor(idx[part], device=dev))
            if live is not None and not live[:, s].all():
                rows = torch.as_tensor(np.flatnonzero(~live[:, s]),
                                       device=dev)
                mat[s, rows] = clean.index_select(0, rows)
        return mat

    def _mix(self, theta, nbr, w_eff):
        """Deviation-form mixing of the round-input replicas: ``θ_i +
        Σ_s w[i, s] (θ_nbr[i, s] − θ_i)``, accumulated slot by slot (a
        zero deviation adds exactly +0.0)."""
        dev = theta.device
        acc = torch.zeros_like(theta)
        dev_s = torch.empty_like(theta)
        w = torch.as_tensor(np.asarray(w_eff, np.float32), device=dev)
        for s in range(self.k1):
            torch.index_select(theta, 0, torch.as_tensor(nbr[:, s],
                                                         device=dev),
                               out=dev_s)
            dev_s.sub_(theta).mul_(w[:, s, None])
            acc.add_(dev_s)
        del dev_s
        return theta + acc

    def _aggregate(self, mat, mixed, srv, generator):
        """Each node's robust aggregate of its ``(k1, d)`` matrix: ``(aggs
        (n, d), agg_state)``."""
        fr = self.fr
        agg = fr.server.aggregator
        n, k1, d = self.n, self.k1, mat.shape[2]
        trusted = getattr(agg, "expects_trusted_row", False)
        if isinstance(agg, _SELECTS) and not trusted:
            out, _ = agg(mat.view(k1, n * d), (), generator=generator)
            return out.view(n, d), srv.agg_state
        if isinstance(agg, Multikrum) and not trusted:
            return self._multikrum(agg, mat), srv.agg_state
        layout = FlatLayout({k: v[0] for k, v in srv.params.items()})
        states = srv.agg_state
        aggs = torch.empty((n, d), dtype=torch.float32, device=mat.device)
        new_states = []
        for i in range(n):
            m_i = mat[:, i].contiguous()
            if trusted:
                t = fr.compute_trusted_update(layout.unravel(mixed[i]),
                                              generator)
                m_i = fr.server._with_trusted_row(m_i, t)
            st = () if _empty(states) else states[i]
            aggs[i], st = agg(m_i, st, generator=generator)
            new_states.append(st)
        return aggs, (states if _empty(states) else new_states)

    def _multikrum(self, agg, mat):
        """Multi-Krum of every node at once from the batched ``(n, k1,
        k1)`` Gram: the squared-distance scores, the ``k`` lowest, the
        mean of the kept rows (``masked.masked_mean``'s arithmetic)."""
        n, k1 = self.n, self.k1
        agg.check(k1)
        rows = mat.permute(1, 0, 2)  # (n, k1, d) view
        sq = torch.stack([(mat[s] * mat[s]).sum(1) for s in range(k1)], 1)
        g = torch.bmm(rows, rows.transpose(1, 2))
        d2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * g).clamp(min=0.0)
        eye = torch.eye(k1, dtype=torch.bool, device=mat.device)
        d2 = d2.masked_fill(eye, float("inf"))
        scores = torch.sort(d2, dim=2).values[:, :, :k1 - agg.num_byzantine
                                              - 2].sum(2)
        rank = torch.argsort(torch.argsort(scores, dim=1, stable=True),
                             dim=1, stable=True)
        keep = rank < agg.k
        # An all-False selection degrades to all-True (masked._nonempty).
        keep = torch.where(keep.any(1, keepdim=True), keep,
                           torch.ones_like(keep)).to(mat.dtype)
        out = torch.zeros((n, mat.shape[2]), dtype=mat.dtype,
                          device=mat.device)
        for s in range(k1):
            out.add_(mat[s] * keep[:, s, None])
        return out / keep.sum(1, keepdim=True)

    def _apply(self, srv, mixed, layout, aggs, agg_state):
        """The optimizer step of every node on the stacks, from its MIXED
        parameters (``Server.apply_aggregate``'s arithmetic, leaf by
        leaf); with the health check a node whose aggregate is non-finite
        keeps its pre-mix replica and optimizer state."""
        server = self.fr.server
        params = layout.unravel_rows(mixed)
        grads = layout.unravel_rows(-aggs)
        opt = {k: (v.copy() if isinstance(v, np.ndarray) else v)
               for k, v in srv.opt_state.items()}
        if server.weight_decay:
            grads = {k: g + server.weight_decay * params[k]
                     for k, g in grads.items()}
        if server.momentum:
            scale = _per_node(np.where(opt["step"] == 0, 1.0,
                                       1.0 - server.dampening), params)
            buf = {k: server.momentum * opt["buf"][k] + _bcast(scale, g) * g
                   for k, g in grads.items()}
            opt["buf"], opt["step"] = buf, opt["step"] + 1
            grads = buf
        sched = lr_schedule(server.lr, server.schedule)
        step = _per_node(np.array([-sched(int(c)) for c in opt["count"]]),
                         params)
        opt["count"] = opt["count"] + 1
        new = {k: params[k] + _bcast(step, g) * g for k, g in grads.items()}
        if self.fr.health_check:
            ok = torch.isfinite(aggs).all(1)
            if not bool(ok.all()):
                new, opt, agg_state = _guard(ok, new, opt, agg_state, srv)
        return ServerState(params=new, opt_state=opt, agg_state=agg_state,
                           round=srv.round + 1)


def _per_node(values: np.ndarray, like):
    """A per-node scalar: a Python float when every node has the same
    value (the dense round's arithmetic), else an ``(n,)`` f32 tensor."""
    if (values == values[0]).all():
        return float(values[0])
    dev = next(iter(like.values())).device
    return torch.as_tensor(values, dtype=torch.float32, device=dev)


def _bcast(v, like):
    """``v`` broadcast against a stacked leaf ``(n, *shape)``."""
    if isinstance(v, float):
        return v
    return v.view((-1,) + (1,) * (like.dim() - 1))


def _guard(ok, new, opt, agg_state, old: ServerState):
    """Nodes where ``ok`` is False keep their old parameters, optimizer
    state and aggregator state (the round counter advances)."""
    keep = ok.cpu().numpy()
    new = {k: torch.where(_bcast(ok, v), v, old.params[k])
           for k, v in new.items()}
    old_opt = old.opt_state
    opt = dict(opt)
    opt["count"] = np.where(keep, opt["count"], old_opt["count"])
    if "buf" in opt:
        opt["buf"] = {k: torch.where(_bcast(ok, v), v, old_opt["buf"][k])
                      for k, v in opt["buf"].items()}
        opt["step"] = np.where(keep, opt["step"], old_opt["step"])
    if not _empty(agg_state):
        agg_state = [s if keep[i] else old.agg_state[i]
                     for i, s in enumerate(agg_state)]
    return new, opt, agg_state


def gossip_step(fr: FedRound, topo: TopologyConfig,
                recorder: Optional[PassRecorder] = None
                ) -> Tuple[GossipStep, PassRecorder]:
    """The gossip round of ``fr`` over ``topo``: ``(step, recorder)``,
    ``step(state, x, y, lengths, malicious, seed) -> (state, metrics)``
    on a :func:`gossip_federation` state; ``malicious`` is the ``(n,)``
    mask.  The metrics add ``consensus_dist`` (the largest pairwise
    distance of the round-input replicas), ``num_partitioned_nodes`` and
    ``gossip_ici_bytes``; ``recorder.ici_events`` holds the last round's
    collectives."""
    step = GossipStep(fr, topo, recorder)
    return step, step.recorder
