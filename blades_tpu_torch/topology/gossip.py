"""Decentralized gossip round: peer-graph federation, no central server
(counterpart of ``blades_tpu/topology/gossip.py``).

Every node holds its OWN parameter replica, trains locally, exchanges
models with its graph neighborhood (:mod:`blades_tpu_torch.topology.graph`),
robust-aggregates its neighbors' updates with the existing aggregators,
and mixes parameters with doubly-stochastic gossip weights.  The replicas
are stacked: ``RoundState.server`` is one
:class:`~blades_tpu_torch.core.server.ServerState` whose parameter leaves
carry a leading node axis ``(n, *shape)`` (:func:`gossip_federation`).
On one device the stack holds every node; on the ranks of a process
group's 1-D ``clients`` axis (``c`` ranks) each rank holds the contiguous
block of ``n_local = ceil(n / c)`` nodes, padded to ``c * n_local`` as the
JAX package pads them
(:func:`~blades_tpu_torch.parallel.mesh.shard_gossip_state`).

Round anatomy (one program for both; on one device the gathers are the
identity)::

    train    θ_i --local rounds--> u_i       (the rank's nodes, blocks of
                                              lanes, each from its replica)
    gather   all_gather u, ravel(θ), losses  (counted collectives)
    forge    dense-order health -> DP -> adversary   (replicated)
    select   slot-major (k1, m, d) neighborhood matrices of the rank's m
             receivers (static tables; per receiver under a
             topology-scoped attack; a dead edge's slot holds the node's
             own row)
    mix      θ̄_i = θ_i + Σ_s w[i,s] (θ_nbr − θ_i)   (deviation form)
    agg      per-node robust aggregate + optimizer step on the stacks;
             self-trust below the aggregator's breakdown line
    gather   the aggregate norms; psum the partition count (with faults)

The column selects (Median, Trimmedmean) run once over the ``(k1, m *
d)`` view of the slot-major matrices: their columns are independent, so
one call (one ``select:radix`` launch on the card) is m per-node calls.
Multikrum runs all receivers on batched ``k1 x k1`` products.  The other
aggregators run node by node on each node's contiguous ``(k1, d)``
matrix, Mean among them: a reduction's summation order at the tail of a
row depends on the row's length, and the complete-graph pin needs the
dense round's ``mean(0)`` on the same ``(n, d)`` shape.  The mixing
accumulates slot by slot into an ``(m, d)`` sum, so no second ``(k1, m,
d)`` tensor is made.

Randomness follows the dense round: one generator per round, drawn in
the dense order (the batch uniforms of all ``n`` nodes, then per block of
``client_block`` nodes the dropout masks and augmentation draws, then DP
noise and the forge's); the node-level draws of a stochastic aggregator
follow in node order, and a rank replays those of the nodes before its
block.  So every rank's nodes draw what they draw in the one-process
round, and where a rank's training blocks are the one-process round's
blocks (``client_block`` divides ``n_local``) the round on ``c`` ranks
equals it bit for bit.  ``step_prebatched(..., edge_drop=)`` replaces the
edge-dropout realization
(:meth:`~blades_tpu_torch.faults.FaultInjector.realize_edges`, pure in
``(fault seed, round)``: every rank realizes the whole graph's and reads
its receivers' rows), as the other draws are replaced.

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
the partition count's psum), each over the ring of the ``c`` ranks: they
reconcile with :func:`blades_tpu_torch.parallel.comm_model.
gossip_round_volumes` for ``(c, 1)``, and ``gossip_ici_bytes`` is their
ring wire total (0 on one device).
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
    DnC,
    Median,
    Multikrum,
    Trimmedmean,
    _empty,
    breakdown_min_rows,
)
from blades_tpu_torch.parallel.mesh import (
    LaneBlock,
    all_gather_rows,
    all_reduce_sum,
    broadcast_from,
)
from blades_tpu_torch.parallel.sharded import block_batches, dense_block_draws
from blades_tpu_torch.parallel.streamed_geometry import PassRecorder
from blades_tpu_torch.topology.graph import TopologyConfig
from blades_tpu_torch.utils.tree import FlatLayout

#: Aggregators that run all nodes in one call over the ``(k1, n * d)``
#: view (stateless order statistics, column by column).
_SELECTS = (Median, Trimmedmean)


def check_supported(fr: FedRound, topo: TopologyConfig, mesh=None) -> None:
    """The JAX package's refusals of the gossip round, with its words
    (lane packing does not reach the port's gossip round: the config
    refuses it)."""
    if mesh is not None and mesh.dd != 1:
        raise ValueError(
            "gossip × 2-D mesh_shape is unsupported — the gossip round "
            "shards nodes over the 1-D clients mesh; drop mesh_shape")
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


def node_head(state: RoundState, mesh=None) -> RoundState:
    """The state of node 0's replica: the head that
    :func:`gossip_evaluate` scores.  On a mesh node 0 is the first row of
    rank 0's block, broadcast to every rank (the JAX package's evaluation
    reads the head from its chip the same way, outside the round's
    counted collectives)."""
    srv = state.server
    params = {k: v[0] for k, v in srv.params.items()}
    if mesh is not None:
        params = {k: broadcast_from(mesh, v.contiguous(), 0)
                  for k, v in params.items()}
    return dataclasses.replace(state, server=ServerState(
        params=params, opt_state={}, agg_state=(), round=srv.round))


def gossip_evaluate(fr: FedRound, mesh=None):
    """Evaluation of a gossip state: the node-0 replica through the dense
    evaluation, on every rank over the whole test set.  On a healthy
    (unpartitioned) run consensus makes every head equivalent;
    ``consensus_dist`` says when that broke."""

    def evaluate(state: RoundState, test_x, test_y, lengths):
        return fr.evaluate(node_head(state, mesh), test_x, test_y, lengths)

    return evaluate


class GossipStep:
    """One gossip round of ``fr`` over ``topo`` (build it with
    :func:`gossip_step`): ``step(state, x, y, lengths, malicious, seed)``
    as :meth:`FedRound.step`, and :meth:`step_prebatched` /
    :meth:`finish` for the two halves.

    With a ``mesh`` (the ranks of a 1-D ``clients`` axis, ``c`` of them)
    this rank holds the contiguous block of ``n_local = ceil(n / c)``
    nodes ``[start, start + n_local)`` (nodes padded to ``n_pad = c *
    n_local``, the ghosts past ``n``), as
    :func:`~blades_tpu_torch.parallel.mesh.shard_gossip_state` places
    them; its receivers are the real nodes ``[lo, hi)`` of the block.
    Without one the block is every node and the collectives are the
    identity."""

    def __init__(self, fr: FedRound, topo: TopologyConfig,
                 recorder: Optional[PassRecorder] = None, mesh=None):
        check_supported(fr, topo, mesh)
        self.fr, self.topo, self.mesh = fr, topo, mesh
        self.recorder = recorder if recorder is not None else PassRecorder()
        self.tables = topo.neighbor_tables()
        self.n = n = topo.num_nodes
        self.k1 = int(self.tables.nbr_idx.shape[1])
        self.bound = degradation_bound(fr)
        self.block = LaneBlock.of(mesh, n)
        self.n_local = self.block.n_local
        self.lo, self.hi = self.block.real
        adv = fr.adversary
        if getattr(adv, "topology_scoped", False):
            recv = adv.receiver_mask(topo.adjacency())
        else:
            # Broadcast forges: every receiver sees the forged rows (the
            # dense threat model).
            recv = np.ones((n, n), bool)
        # (n, k1): does slot s of node i read its sender's forged row?
        self.sel = np.take_along_axis(recv, self.tables.nbr_idx.astype(
            np.int64), 1)

    # -- the rank's lanes and collectives ------------------------------------

    def _gather(self, label: str, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(n_local, ...)`` block stacked in rank order,
        cut to the ``n`` real nodes; recorded under ``label`` (without a
        mesh the identity, over a ring of one)."""
        return all_gather_rows(self.mesh, rows, recorder=self.recorder,
                               label=label)[:self.n]

    # -- the round -----------------------------------------------------------

    def __call__(self, state: RoundState, data_x, data_y, lengths, malicious,
                 seed) -> Tuple[RoundState, dict]:
        """One round over this rank's shards ``data_x (n_local, shard,
        ...)`` (every node's without a mesh), ``lengths (n_local,)`` and
        the ``(n,)`` mask: the batch uniforms of all ``n`` nodes are drawn
        and this rank's kept, as the stacked round draws them."""
        dev = next(iter(state.server.params.values())).device
        gen = round_generator(seed, dev)
        bx, by = block_batches(self.fr, self.block, gen, data_x, data_y,
                               lengths)
        return self._round(state, bx, by, malicious, gen)

    def step_prebatched(self, state: RoundState, bx, by, malicious,
                        generator=None, *, dropout_masks=None,
                        aug_draws=None, forge_noise=None, dp_noise=None,
                        edge_drop=None) -> Tuple[RoundState, dict]:
        """:meth:`__call__` with every node's batches drawn (``bx (n, nb,
        B, ...)``, this rank takes its lanes), then :meth:`finish`.
        ``dropout_masks``, ``aug_draws``, ``forge_noise`` and ``dp_noise``
        replace those draws, as in :meth:`FedRound.step_prebatched` (the
        first two the whole federation's); ``edge_drop`` (an ``(n, n)``
        bool mask) the edge-dropout realization."""
        n = bx.shape[0]
        if n != self.n:
            raise ValueError(f"{n} nodes' batches for a topology of "
                             f"{self.n} nodes")
        dev = next(iter(state.server.params.values())).device
        if isinstance(generator, int):
            generator = round_generator(generator, dev)
        lanes = self.block.lanes
        return self._round(state, lanes(bx), lanes(by), malicious,
                           generator, dropout_masks=dropout_masks,
                           aug_draws=aug_draws, forge_noise=forge_noise,
                           dp_noise=dp_noise, edge_drop=edge_drop)

    def _round(self, state, bx, by, malicious, generator, *,
               dropout_masks=None, aug_draws=None, **finish_kw):
        """Every real node of this rank's block trains its local round
        from its own replica, in blocks of ``fr.client_block`` lanes, on
        the stacked round's dropout masks and augmentation draws (every
        node's are drawn, block by block of the ``n`` nodes, and this
        rank's kept: :func:`~blades_tpu_torch.parallel.sharded.
        dense_block_draws`); ghost lanes train nothing (zero updates and
        losses, their optimizer rows as they came).  Then
        :meth:`finish`."""
        fr = self.fr
        params = state.server.params
        dev = next(iter(params.values())).device
        malicious = malicious.to(device=dev, dtype=torch.bool)
        masks, aug = dense_block_draws(
            fr, self.block, bx.shape[1], bx.shape[2], generator, dev,
            masks=dropout_masks, aug=aug_draws)
        layout = FlatLayout({k: v[0] for k, v in params.items()})
        m = self.hi - self.lo
        block = min(fr.client_block or max(m, 1), max(m, 1))
        hooks = fr.hooks()
        opt = state.client_opt
        new_opt = (None if opt is None
                   else {k: v.clone() for k, v in opt.items()})
        updates = torch.zeros((self.n_local, layout.d), dtype=torch.float32,
                              device=dev)
        losses = torch.zeros((self.n_local,), dtype=torch.float32,
                             device=dev)
        mal = self.block.lanes(malicious)
        for r0 in range(0, m, block):
            r1 = min(m, r0 + block)
            _, loss, opt_b = fr.task.local_round_batched(
                {k: v[r0:r1] for k, v in params.items()},
                bx[r0:r1].to(dev), by[r0:r1].to(dev),
                opt_state=_rows(opt, r0, r1), malicious=mal[r0:r1],
                hooks=hooks, generator=generator,
                dropout_masks=_rows(masks, r0, r1),
                aug_draws=_rows(aug, r0, r1), out=updates[r0:r1],
                lane_params=True)
            losses[r0:r1] = loss
            if new_opt is not None:
                for k, v in opt_b.items():
                    new_opt[k][r0:r1] = v
        return self.finish(state, updates, new_opt, losses, malicious,
                           generator, **finish_kw)

    def finish(self, state: RoundState, updates, client_opt, losses,
               malicious, generator=None, *, forge_noise=None, dp_noise=None,
               edge_drop=None) -> Tuple[RoundState, dict]:
        """The exchange half of the round over this rank's ``(n_local,
        d)`` update rows (the ``(n, d)`` matrix without a mesh): the
        gathers of the updates, the replicas and the losses, health
        check, DP and forge in the dense order over all ``n`` rows, this
        rank's receivers' neighborhood matrices, mixing, aggregates and
        optimizer step, and the metrics."""
        fr, rec, n, k1 = self.fr, self.recorder, self.n, self.k1
        lo, hi = self.lo, self.hi
        srv = state.server
        dev = updates.device
        d = updates.shape[1]
        malicious = malicious.to(device=dev, dtype=torch.bool)
        # One round's accounting: the JAX round's collectives, each over
        # the ring of the ``c`` ranks.
        rec.ici_events.clear()
        rec.ici_bytes = 0
        layout = FlatLayout({k: v[0] for k, v in srv.params.items()})
        theta_local = layout.ravel_rows(srv.params)
        updates = self._gather("updates_gather", updates)
        theta = self._gather("params_gather", theta_local)
        losses = self._gather("losses_gather", losses)

        healthy = None
        if fr.health_check:
            updates, healthy = sanitize_updates(updates)
        clean = fr.apply_dp(updates, dp_noise, generator)
        forged = clean
        if forges(fr.adversary):
            forged = fr.adversary.on_updates_ready(
                clean, malicious, noise=forge_noise, generator=generator,
                aggregator=fr.server.aggregator)

        # This rank's receivers' rows of the static tables.
        tabs = self.tables
        nbr = tabs.nbr_idx[lo:hi].astype(np.int64)
        w_eff = tabs.w_slot[lo:hi]
        live = degraded = None
        if fr.faults is not None:
            # Symmetric edge dropout, pure in (fault seed, round): every
            # rank realizes the whole graph's and reads its receivers'.
            r0 = int(srv.round)
            drop = (fr.faults.realize_edges(n, r0) if edge_drop is None
                    else torch.as_tensor(edge_drop, dtype=torch.bool))
            dropped = np.take_along_axis(
                np.asarray(drop.cpu(), bool)[lo:hi], nbr, 1)  # blades-lint: disable=host-sync — the edge-drop realization is a CPU tensor from a CPU generator: no card read
            is_self = nbr == np.arange(lo, hi)[:, None]
            live = tabs.valid[lo:hi] & (is_self | ~dropped)
            w_eff = np.where(live, w_eff, np.float32(0.0))
            # Loud per-node degradation: live rows below the aggregator's
            # breakdown line a*f_i + b -> self-trust.
            mal_host = malicious.cpu().numpy()  # blades-lint: disable=host-sync — known round-time sync: the malicious mask for the per-node breakdown count, once a round with edge dropout
            f_i = (mal_host[nbr] & live).sum(1)
            a_bd, b_bd = self.bound
            degraded = live.sum(1) < a_bd * f_i + b_bd

        mat = self._neighborhoods(forged, clean, nbr, live)
        mixed = self._mix(theta, nbr, w_eff)
        aggs, agg_state = self._aggregate(mat, mixed, srv, generator)
        del mat
        if degraded is not None and degraded.any():
            own = torch.as_tensor(degraded, device=dev)[:, None]
            aggs = torch.where(own, clean[lo:hi], aggs)
        ghosts = self.n_local - (hi - lo)
        if ghosts:
            # Ghost nodes keep their (zero) replicas: no aggregate.
            mixed = torch.cat([mixed, theta_local[hi - lo:]])
            aggs = torch.cat([aggs, aggs.new_zeros((ghosts, d))])
        new_srv = self._apply(srv, mixed, layout, aggs, agg_state)
        del mixed
        # Each node's aggregate norm, as the dense round takes its one.
        aggn = self._gather("aggnorm_gather", torch.stack(
            [(a * a).sum().sqrt() for a in aggs]))

        benign = (~malicious).float()
        gram = theta @ theta.T
        diag = torch.diagonal(gram)
        sq = diag[:, None] + diag[None, :] - 2.0 * gram
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(min=1.0),
            "update_norm_mean": (forged * forged).sum(1).sqrt().mean(),
            "agg_norm": aggn[0],
            "round": new_srv.round,
            "consensus_dist": sq.clamp(min=0.0).max().sqrt(),
        }
        if degraded is not None:
            parts = all_reduce_sum(
                self.mesh, torch.tensor([int(degraded.sum())],  # blades-lint: disable=host-sync — degraded is a host numpy mask: no card read
                                        dtype=torch.int32, device=dev),
                recorder=rec, label="partitioned_psum")
            metrics["num_partitioned_nodes"] = parts[0].cpu()  # blades-lint: disable=host-sync — known round-time sync: the partitioned-node count, one scalar once a round with edge dropout
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
        """The slot-major ``(k1, m, d)`` neighborhood matrices of this
        rank's ``m`` receivers (``nbr``, ``live``: their rows of the
        tables): slot ``s`` of receiver ``i`` holds sender ``j = nbr[i,
        s]``'s forged row where the adversary's edge reaches ``i``
        (identical to the clean row for a benign ``j``), else its clean
        row; a dead slot (a dropped edge or a pad slot under faults) holds
        ``i``'s own clean row."""
        k1, m = self.k1, nbr.shape[0]
        dev = clean.device
        sel_all = self.sel[self.lo:self.lo + m]
        mat = torch.empty((k1, m, clean.shape[1]), dtype=torch.float32,
                          device=dev)
        for s in range(k1):
            idx = nbr[:, s]
            sel = sel_all[:, s]
            src = forged if sel.all() else clean
            torch.index_select(src, 0, torch.as_tensor(idx, device=dev),
                               out=mat[s])
            part = np.flatnonzero(sel) if not sel.all() else ()
            if len(part):
                rows = torch.as_tensor(part, device=dev)
                mat[s, rows] = forged.index_select(
                    0, torch.as_tensor(idx[part], device=dev))
            if live is not None and not live[:, s].all():
                dead = np.flatnonzero(~live[:, s])
                mat[s, torch.as_tensor(dead, device=dev)] = clean.index_select(
                    0, torch.as_tensor(dead + self.lo, device=dev))
        return mat

    def _mix(self, theta, nbr, w_eff):
        """Deviation-form mixing of this rank's receivers' round-input
        replicas: ``θ_i + Σ_s w[i, s] (θ_nbr[i, s] − θ_i)``, accumulated
        slot by slot (a zero deviation adds exactly +0.0)."""
        dev = theta.device
        own = theta[self.lo:self.lo + nbr.shape[0]]
        acc = torch.zeros_like(own)
        dev_s = torch.empty_like(own)
        w = torch.as_tensor(np.asarray(w_eff, np.float32), device=dev)  # blades-lint: disable=host-sync — the mixing weights are host numpy tables: the copy goes to the card, nothing comes back
        for s in range(self.k1):
            torch.index_select(theta, 0, torch.as_tensor(nbr[:, s],
                                                         device=dev),
                               out=dev_s)
            dev_s.sub_(own).mul_(w[:, s, None])
            acc.add_(dev_s)
        del dev_s
        return own + acc

    def _aggregate(self, mat, mixed, srv, generator):
        """Each receiver's robust aggregate of its ``(k1, d)`` matrix:
        ``(aggs (m, d), agg_state)``.  The node-level draws of a
        stochastic aggregator (DnC's subsamples, FLTrust's root batches)
        follow in node order from the round's generator, so this rank
        first replays the draws of the nodes before its block."""
        fr = self.fr
        agg = fr.server.aggregator
        k1, m, d = mat.shape
        trusted = getattr(agg, "expects_trusted_row", False)
        if m == 0:
            return mat.new_empty((0, d)), srv.agg_state
        if isinstance(agg, _SELECTS) and not trusted:
            out, _ = agg(mat.view(k1, m * d), (), generator=generator)
            return out.view(m, d), srv.agg_state
        if isinstance(agg, Multikrum) and not trusted:
            return self._multikrum(agg, mat), srv.agg_state
        for _ in range(self.lo):
            fr.skip_trusted_update(generator, mat.device)
            if isinstance(agg, DnC):
                agg.draw(d, generator, mat.device)
        states = srv.agg_state
        aggs = torch.empty((m, d), dtype=torch.float32, device=mat.device)
        new_states = None if _empty(states) else list(states)
        layout = (FlatLayout({k: v[0] for k, v in srv.params.items()})
                  if trusted else None)
        for i in range(m):
            m_i = mat[:, i].contiguous()
            if trusted:
                t = fr.compute_trusted_update(layout.unravel(mixed[i]),
                                              generator)
                m_i = fr.server._with_trusted_row(m_i, t)
            st = () if new_states is None else states[i]
            aggs[i], st = agg(m_i, st, generator=generator)
            if new_states is not None:
                new_states[i] = st
        return aggs, (states if new_states is None else new_states)

    def _multikrum(self, agg, mat):
        """Multi-Krum of every receiver at once from the batched ``(m,
        k1, k1)`` Gram: the squared-distance scores, the ``k`` lowest, the
        mean of the kept rows (``masked.masked_mean``'s arithmetic)."""
        k1, m = self.k1, mat.shape[1]
        agg.check(k1)
        rows = mat.permute(1, 0, 2)  # (m, k1, d) view
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
        out = torch.zeros((m, mat.shape[2]), dtype=mat.dtype,
                          device=mat.device)
        for s in range(k1):
            out.add_(mat[s] * keep[:, s, None])
        return out / keep.sum(1, keepdim=True)

    def _apply(self, srv, mixed, layout, aggs, agg_state):
        """The optimizer step of every node of the block on the stacks,
        from its MIXED parameters (``Server.apply_aggregate``'s
        arithmetic, leaf by leaf); with the health check a node whose
        aggregate is non-finite keeps its pre-mix replica and optimizer
        state."""
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
        step = _per_node(np.array([-sched(int(c)) for c in opt["count"]]),  # blades-lint: disable=host-sync — the optimizer counts are host numpy ints: no card read
                         params)
        opt["count"] = opt["count"] + 1
        new = {k: params[k] + _bcast(step, g) * g for k, g in grads.items()}
        if self.fr.health_check:
            ok = torch.isfinite(aggs).all(1)
            if not bool(ok.all()):  # blades-lint: disable=host-sync — known round-time sync: the health check's all-finite test, once a round with health_check
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
    keep = ok.cpu().numpy()  # blades-lint: disable=host-sync — an unhealthy round only: the keep mask patches the host optimizer counts
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
                recorder: Optional[PassRecorder] = None, mesh=None
                ) -> Tuple[GossipStep, PassRecorder]:
    """The gossip round of ``fr`` over ``topo``: ``(step, recorder)``,
    ``step(state, x, y, lengths, malicious, seed) -> (state, metrics)``
    on a :func:`gossip_federation` state (on a ``mesh``, this rank's
    block of it and of the data:
    :func:`~blades_tpu_torch.parallel.mesh.shard_gossip_state`);
    ``malicious`` is the ``(n,)`` mask.  The metrics add
    ``consensus_dist`` (the largest pairwise distance of the round-input
    replicas), ``num_partitioned_nodes`` and ``gossip_ici_bytes``;
    ``recorder.ici_events`` holds the last round's collectives.  Without
    a mesh the replicas are stacked on one device and every collective is
    the identity on a ring of one."""
    step = GossipStep(fr, topo, recorder, mesh)
    return step, step.recorder
