"""The port's decentralized gossip round (blades_tpu_torch/topology/gossip.py)
against the JAX package's ``gossip_step``.

The JAX round runs on the 8-device CPU mesh, as tests/test_topology.py
runs it, with 16 nodes (two a device, no ghost nodes); the port runs the
same nodes stacked on one device.  Both start from the same flax-
initialised parameters (blades_tpu_torch/convert.py), and the port is
handed the JAX round's draws, recomputed with the same ``jax.random``
chain: the batches (``split(k_sample, n)`` through
``sample_client_batches_with_keys``), the dropout keep-masks of each
node's local round and, under faults, the edge-dropout realization
(``fold_in(round_key(round), EDGE_FOLD)``).

Tolerances: parameters, losses and norms ``rtol=1e-5, atol=1e-6`` (f32
sums in other orders, per-lane matmuls, as the dense-round tests hold the
MLP); ``consensus_dist`` is the square root of Gram differences, which
cancel, so its square is held within ``1e-5`` of the largest squared
replica norm (the f32 Gram entries' own agreement); the partition counts
exactly; a node's Median
over a given neighborhood matrix bit for bit.  The complete-graph + Mean
pin holds the port's exchange half against its own dense round at
tolerance zero; chained complete-graph rounds differ from the dense
round's only by per-lane training, within ``rtol=1e-5, atol=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.data.sampler import sample_client_batches_with_keys
from blades_tpu.faults import FaultInjector as JaxFaultInjector
from blades_tpu.models.mlp import MLP as JaxMLP
from blades_tpu.ops.aggregators import get_aggregator as jax_aggregator
from blades_tpu.parallel.mesh import make_mesh
from blades_tpu.topology import EDGE_FOLD as JAX_EDGE_FOLD
from blades_tpu.topology import TopologyConfig as JaxTopologyConfig
from blades_tpu.topology import gossip_federation as jax_gossip_federation
from blades_tpu.topology import gossip_step as jax_gossip_step
from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
from blades_tpu_torch.convert import params_from_jax
from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec
from blades_tpu_torch.faults import FaultInjector
from blades_tpu_torch.models.mlp import MLP
from blades_tpu_torch.parallel.comm_model import (
    gossip_round_volumes,
    gossip_wire_bytes,
)
from blades_tpu_torch.topology import (
    EDGE_FOLD,
    TopologyConfig,
    gossip_evaluate,
    gossip_federation,
    gossip_step,
)
from blades_tpu_torch.utils.tree import FlatLayout

N = 16
F = 4
ROWS = 4
SHAPE = (4, 4, 1)
BATCH = 2
RTOL, ATOL = 1e-5, 1e-6
GRAM_TOL = 1e-5
TOPO_ALIE = {"type": "TopologyAttack", "base": "ALIE"}
METRICS = ("train_loss", "update_norm_mean", "agg_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small torch ops: with
    several test workers on a few cores, the thread pools contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# tests/test_topology.py's headline grid, at 16 nodes: one cell per graph
# family and both attack flavors; Multikrum at f = 1 (Krum needs 2f + 2
# rows of a k1 = 5 neighborhood).
GRID_HEADLINE = [
    ("Median", TOPO_ALIE, "ring", {}, F),
    ("Mean", "SignFlip", "ring", {}, F),
    ("Multikrum", "SignFlip", "kregular", {"k": 4}, 1),
    ("Median", TOPO_ALIE, "complete", {}, F),
]
# The rest of the graph x aggregator x attack zoo (ring without
# Multikrum, which the breakdown gate refuses).
GRID_ZOO = [
    (agg, attack, graph, ({"k": 4} if graph == "kregular" else {}),
     (1 if agg == "Multikrum" else F))
    for graph in ("ring", "kregular", "complete")
    for agg in ("Mean", "Median", "Multikrum")
    for attack in (TOPO_ALIE, "SignFlip")
    if not (graph == "ring" and agg == "Multikrum")
    and (agg, attack, graph) not in [(a, k, g) for a, k, g, _, _ in
                                     GRID_HEADLINE]
]


def _ids(grid):
    return [f"{g}-{a}-{k if isinstance(k, str) else 'TopoALIE'}"
            for a, k, g, _, _ in grid]


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, ROWS) + SHAPE).astype(np.float32)
    y = rng.integers(0, 2, size=(n, ROWS)).astype(np.int32)
    lengths = np.full((n,), ROWS, np.int32)
    lengths[-1] = ROWS - 1
    return x, y, lengths


def _rounds(agg, attack, f, *, faults=None, health=False, n=N):
    """The two packages' FedRounds on the same task."""
    jfr = JaxFedRound(
        task=JaxTaskSpec(model=JaxMLP(hidden1=8, hidden2=8, num_classes=2),
                         num_classes=2, input_shape=SHAPE, lr=0.1).build(),
        server=JaxServer.from_config(aggregator=agg, num_byzantine=f or None,
                                     lr=0.5),
        adversary=(jax_adversary(attack, num_clients=n, num_byzantine=f)
                   if attack is not None else None),
        batch_size=BATCH, num_batches_per_round=1, num_clients=n,
        faults=None if faults is None else JaxFaultInjector(**faults),
        health_check=health)
    fr = FedRound(
        task=TaskSpec(model=MLP(16, hidden1=8, hidden2=8, num_classes=2),
                      num_classes=2, input_shape=SHAPE, lr=0.1).build(),
        server=Server.from_config(agg, num_byzantine=f or None, lr=0.5),
        adversary=(get_adversary(attack, num_clients=n, num_byzantine=f)
                   if attack is not None else None),
        batch_size=BATCH, num_batches_per_round=1, num_clients=n,
        faults=None if faults is None else FaultInjector(**faults),
        health_check=health, client_block=6)
    return jfr, fr


def _jax_masks(key, n, model):
    """The dropout keep-masks of every node's local round, as JAX's
    ``one_node`` draws them from ``split(k_train, n)``."""
    _, k_train, _, _, _ = jax.random.split(key, 5)
    masks = [np.zeros((n, 1, BATCH, w), bool) for w in (8, 8)]
    for i, kc in enumerate(jax.random.split(k_train, n)):
        (k,) = jax.random.split(kc, 1)
        for layer in range(2):
            masks[layer][i, 0] = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(k, layer), 1.0 - model.dropout_rate,
                (BATCH, 8)))
    return tuple(torch.from_numpy(m) for m in masks)


def _jax_edge_drop(faults, n, round_idx):
    """JAX's edge-dropout realization of one round."""
    inj = JaxFaultInjector(**faults)
    ek = jax.random.fold_in(inj.round_key(round_idx), JAX_EDGE_FOLD)
    u = np.asarray(jax.random.uniform(ek, (n, n)))
    return np.minimum(u, u.T) < float(inj.dropout_rate_at(round_idx))


def _rows_of(params):
    """A stacked parameter dict as ``(n, d)`` numpy rows in ravel order."""
    return FlatLayout({k: v[0] for k, v in params.items()}).ravel_rows(
        params).numpy()


def _jax_rows(params):
    return np.asarray(jax.vmap(lambda p: ravel_pytree(p)[0])(params))


def _run_pair(agg, attack, graph, f, *, rounds=2, faults=None, health=False,
              **topo_kw):
    """Both packages' gossip rounds from the same start: per round the JAX
    metrics, the port's, and both parameter stacks."""
    jfr, fr = _rounds(agg, attack, f, faults=faults, health=health)
    x, y, lengths = _data()
    jx, jy, jln = jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths)
    mesh = make_mesh(8)
    jtopo = JaxTopologyConfig(graph=graph, num_nodes=N, **topo_kw)
    jstate = jfr.init(jax.random.PRNGKey(0), N)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    jstate, arrays = jax_gossip_federation(mesh, jstate, (jx, jy, jln))
    jstep, _ = jax_gossip_step(jfr, mesh, jtopo)
    state = gossip_federation(RoundState(
        server=fr.server.init(params, N),
        client_opt=fr.task.init_client_opt_state(params, N)), N)
    step, rec = gossip_step(fr, TopologyConfig(graph=graph, num_nodes=N,
                                               **topo_kw))
    jmal = make_malicious_mask(N, f).numpy()
    mal = make_malicious_mask(N, f)
    out = []
    for r in range(rounds):
        key = jax.random.fold_in(jax.random.PRNGKey(9), r)
        k_sample = jax.random.split(key, 5)[0]
        bx, by = sample_client_batches_with_keys(
            jax.random.split(k_sample, N), jx, jy, jln, BATCH, 1)
        drop = None if faults is None else _jax_edge_drop(faults, N, r)
        jstate, jm = jstep(jstate, *arrays, jnp.asarray(jmal), key)
        state, m = step.step_prebatched(
            state, torch.from_numpy(np.array(bx)),
            torch.from_numpy(np.array(by)).long(), mal,
            dropout_masks=_jax_masks(key, N, fr.task.model), edge_drop=drop)
        out.append((jm, m, _jax_rows(jstate.server.params),
                    _rows_of(state.server.params)))
    return out, rec, state, fr


def _compare(out, counts=True):
    for jm, m, jrows, rows in out:
        np.testing.assert_allclose(rows, jrows[:N], rtol=RTOL, atol=ATOL)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        scale = float((jrows[:N].astype(np.float64) ** 2).sum(1).max())
        np.testing.assert_allclose(float(m["consensus_dist"]) ** 2,
                                   float(jm["consensus_dist"]) ** 2,
                                   rtol=0, atol=GRAM_TOL * scale)
        assert int(m["round"]) == int(jm["round"])
        if counts:
            assert (int(m["num_partitioned_nodes"])
                    == int(jm["num_partitioned_nodes"]))


@pytest.mark.parametrize("agg,attack,graph,kw,f", GRID_HEADLINE,
                         ids=_ids(GRID_HEADLINE))
def test_gossip_rounds_match_the_jax_gossip_step(agg, attack, graph, kw, f):
    out, _, _, _ = _run_pair(agg, attack, graph, f, **kw)
    _compare(out)
    # Attacked, the replicas drift apart (except on the complete graph
    # under a broadcast forge).
    assert all(np.isfinite(o[3]).all() for o in out)


@pytest.mark.slow
@pytest.mark.parametrize("agg,attack,graph,kw,f", GRID_ZOO,
                         ids=_ids(GRID_ZOO))
def test_gossip_zoo_matches_the_jax_gossip_step(agg, attack, graph, kw, f):
    out, _, _, _ = _run_pair(agg, attack, graph, f, **kw)
    _compare(out)


def test_edge_dropout_matches_the_jax_realization_and_counts():
    """Median under SignFlip on the ring with edge dropout at 0.6 and the
    health check: JAX's realization handed in, the partition counts equal
    round by round (and nonzero), the parameters within tolerance."""
    faults = {"seed": 5, "dropout_rate": 0.6}
    out, rec, _, _ = _run_pair("Median", "SignFlip", "ring", F, rounds=3,
                               faults=faults, health=True)
    _compare(out)
    parts = [int(o[1]["num_partitioned_nodes"]) for o in out]
    assert any(p > 0 for p in parts), parts
    assert all(bool(o[1]["round_ok"]) for o in out)
    # The fault-armed round records the partition count's psum too.
    vols = gossip_round_volumes(N, 226, (1,), faults=True)
    assert sorted(e[1:] for e in rec.ici_events) == sorted(
        (v.kind, v.payload_bytes, k) for v, k in vols)


def test_port_edge_realization_is_symmetric_and_pure():
    inj = FaultInjector(seed=5, dropout_rate=0.4)
    a, b = inj.realize_edges(N, 3), inj.realize_edges(N, 3)
    assert torch.equal(a, b) and torch.equal(a, a.T)
    assert not torch.equal(a, inj.realize_edges(N, 4))
    assert EDGE_FOLD == JAX_EDGE_FOLD
    # Its own stream: the node-fault realization of the round is not it.
    assert 0.2 < float(a.float().mean()) < 0.8
    sched = FaultInjector(seed=5, dropout_rate=0.0,
                          dropout_schedule=[[2, 0.5]])
    assert not sched.realize_edges(N, 1).any()
    assert sched.realize_edges(N, 2).any()


def test_recorder_reconciles_with_gossip_round_volumes_both_ways():
    """Every event the round records has its (kind, payload, ring) in the
    comm model's inventory for a mesh of one, and vice versa; a ring of
    one moves nothing, so gossip_ici_bytes is 0 on one card (the JAX
    package's figure on a mesh of one)."""
    fr = _rounds("Mean", "ALIE", F)[1]
    x, y, lengths = _data()
    params = fr.task.init_params(torch.Generator().manual_seed(0))
    state = gossip_federation(RoundState(
        server=fr.server.init(params, N)), N)
    step, rec = gossip_step(fr, TopologyConfig(graph="complete",
                                               num_nodes=N))
    d = FlatLayout(params).d
    for _ in range(2):  # each round records its own events, once
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(lengths).long(),
                        make_malicious_mask(N, F), 3)
        vols = gossip_round_volumes(N, d, (1,))
        model = sorted((v.kind, v.payload_bytes, k)
                       for v, k in vols for _ in range(v.count))
        recorded = sorted(e[1:] for e in rec.ici_events)
        assert recorded == model
        assert [e[0] for e in rec.ici_events] == [v.label for v, _ in vols]
        assert rec.ici_bytes == gossip_wire_bytes(vols) == 0
        assert int(m["gossip_ici_bytes"]) == 0
    # The model's arithmetic on a mesh of eight is the JAX package's.
    eight = gossip_round_volumes(N, d, (8, 1), faults=True)
    assert gossip_wire_bytes(eight) == 2 * (N * d * 4) * 7 // 8 + 2 * (
        N * 4) * 7 // 8 + 2 * 4 * 7 // 8


@pytest.mark.parametrize("agg", ["Median", "Mean", "Trimmedmean",
                                 "Multikrum"])
def test_neighborhood_aggregates_match_jax_per_node(agg):
    """One gossip aggregation over a given update matrix under an eclipse
    on the kregular graph: the slot-major matrices of every node (forged
    rows only in the victim's neighborhood) aggregated in one call equal
    the JAX aggregator on each node's own (k1, d) matrix, built from the
    JAX tables; Median bit for bit."""
    from blades_tpu.topology import TopologyConfig as JT

    f = 1 if agg == "Multikrum" else 0
    attack = {**TOPO_ALIE, "eclipse_target": 2}
    fr = FedRound(
        task=TaskSpec(model="mlp", input_shape=SHAPE).build(),
        server=Server.from_config(agg, num_byzantine=f if f else 1),
        adversary=get_adversary(attack, num_clients=N, num_byzantine=F),
        num_clients=N)
    topo = TopologyConfig(graph="kregular", num_nodes=N, k=4)
    step, _ = gossip_step(fr, topo)
    rng = np.random.default_rng(3)
    clean = rng.normal(size=(N, 300)).astype(np.float32)
    forged = clean.copy()
    forged[:F] = 7.0
    nbr = JT(graph="kregular", num_nodes=N, k=4).neighbor_tables().nbr_idx
    mat = step._neighborhoods(torch.from_numpy(forged),
                              torch.from_numpy(clean), nbr.astype(np.int64),
                              None)
    srv = fr.server.init({"w": torch.zeros(300)}, N)
    got, _ = step._aggregate(mat, None, srv, None)
    recv = fr.adversary.receiver_mask(topo.adjacency())
    jagg = jax_aggregator(agg, num_byzantine=f if f else 1)
    for i in range(N):
        want_mat = np.where(recv[i, nbr[i]][:, None], forged[nbr[i]],
                            clean[nbr[i]])
        assert np.array_equal(mat[:, i].numpy(), want_mat)
        want, _ = jagg(jnp.asarray(want_mat), jagg.init(300, 5))
        if agg == "Median":
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
    # Only the victim's neighborhood saw a forged row.
    assert [i for i in range(N) if (mat[:, i] == 7.0).any()] == [2]


def test_complete_mean_exchange_half_equals_the_dense_round_bitwise():
    """Tolerance zero: on the complete graph with Mean, the exchange half
    (health check, forge, neighborhoods, mixing, aggregate, optimizer
    step with momentum) over one update matrix equals the dense round's
    finish on it: every node's parameters, the aggregate norm, the loss
    and the update norms."""
    fr = FedRound(
        task=TaskSpec(model="mlp", input_shape=SHAPE).build(),
        server=Server.from_config("Mean", lr=0.5, momentum=0.9),
        adversary=get_adversary("ALIE", num_clients=N, num_byzantine=F),
        num_clients=N, health_check=True)
    params = fr.task.init_params(torch.Generator().manual_seed(1))
    dense = RoundState(server=fr.server.init(params, N))
    goss = gossip_federation(RoundState(server=fr.server.init(params, N)), N)
    step, _ = gossip_step(fr, TopologyConfig(graph="complete", num_nodes=N))
    gen = torch.Generator().manual_seed(5)
    mal = make_malicious_mask(N, F)
    for _ in range(3):
        d = FlatLayout(params).d
        upd = torch.randn((N, d), generator=gen) * 0.01
        losses = torch.rand((N,), generator=gen)
        dense, dm = fr.finish_dense(dense, upd.clone(), None, losses, mal)
        goss, gm = step.finish(goss, upd.clone(), None, losses, mal)
        for k, v in dense.server.params.items():
            for i in range(N):
                assert torch.equal(goss.server.params[k][i], v), k
            for i in range(N):
                assert torch.equal(goss.server.opt_state["buf"][k][i],
                                   dense.server.opt_state["buf"][k])
        for k in ("train_loss", "agg_norm", "update_norm_mean",
                  "num_unhealthy"):
            assert torch.equal(torch.as_tensor(gm[k]),
                               torch.as_tensor(dm[k])), k
        assert float(gm["consensus_dist"]) == 0.0
        assert int(gm["num_partitioned_nodes"]) == 0


def test_chained_complete_mean_rounds_follow_the_dense_round():
    """Three chained rounds of the complete graph + Mean from the same
    start and seeds: every node's replica within ``rtol=1e-5, atol=1e-6``
    of the dense round's parameters (per-lane training rounds the first
    step's product differently), and all replicas equal to each other
    bit for bit."""
    fr = FedRound(
        task=TaskSpec(model=MLP(16, hidden1=8, hidden2=8, num_classes=2),
                      num_classes=2, input_shape=SHAPE, lr=0.1).build(),
        server=Server.from_config("Mean", lr=0.5),
        adversary=get_adversary("ALIE", num_clients=N, num_byzantine=F),
        batch_size=BATCH, num_clients=N)
    x, y, lengths = (torch.from_numpy(a) for a in _data())
    params = fr.task.init_params(torch.Generator().manual_seed(0))
    dense = RoundState(server=fr.server.init(params, N))
    goss = gossip_federation(RoundState(server=fr.server.init(params, N)), N)
    step, _ = gossip_step(fr, TopologyConfig(graph="complete", num_nodes=N))
    mal = make_malicious_mask(N, F)
    for r in range(3):
        dense, dm = fr.step(dense, x, y, lengths.long(), mal, 100 + r)
        goss, gm = step(goss, x, y, lengths.long(), mal, 100 + r)
        for k, v in dense.server.params.items():
            stack = goss.server.params[k]
            assert all(torch.equal(stack[i], stack[0]) for i in range(N))
            np.testing.assert_allclose(stack[0].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(gm["agg_norm"]),
                                   float(dm["agg_norm"]), rtol=RTOL)


def test_gossip_evaluate_scores_node_zeros_head():
    """Evaluation reads node 0's replica: equal to the dense evaluation of
    that replica, and unchanged when the other replicas are scrambled."""
    fr = _rounds("Median", None, 0)[1]
    x, y, lengths = (torch.from_numpy(a) for a in _data())
    params = fr.task.init_params(torch.Generator().manual_seed(0))
    state = gossip_federation(RoundState(server=fr.server.init(params, N)),
                              N)
    step, _ = gossip_step(fr, TopologyConfig(graph="ring", num_nodes=N))
    state, _ = step(state, x, y, lengths.long(), make_malicious_mask(N, 0),
                    1)
    ev = gossip_evaluate(fr)(state, x, y, lengths.long())
    head = {k: v[0] for k, v in state.server.params.items()}
    want = fr.evaluate(RoundState(server=fr.server.init(head, N)), x, y,
                       lengths.long())
    for k in ("test_loss", "test_acc"):
        assert float(ev[k]) == float(want[k])
    for v in state.server.params.values():
        v[1:] = torch.randn_like(v[1:])
    ev2 = gossip_evaluate(fr)(state, x, y, lengths.long())
    assert float(ev2["test_loss"]) == float(ev["test_loss"])


@pytest.mark.slow
def test_resnet10_gossip_round_matches_the_jax_gossip_step():
    """One ResNet-10 gossip round (8 nodes on the ring, ALIE on 2, Median,
    16x16 CIFAR-shaped inputs, the lanes' per-node convolutions) against
    JAX's: every node's parameters within the convolutional models'
    ``rtol=1e-4, atol=1e-4`` (tests/test_torch_dense_round.py)."""
    n, f, shape = 8, 2, (16, 16, 3)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, ROWS) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(n, ROWS)).astype(np.int32)
    lengths = np.full((n,), ROWS, np.int32)
    spec = dict(model="resnet10", num_classes=10, input_shape=shape, lr=0.1)
    jfr = JaxFedRound(
        task=JaxTaskSpec(**spec).build(),
        server=JaxServer.from_config(aggregator="Median", lr=0.5),
        adversary=jax_adversary("ALIE", num_clients=n, num_byzantine=f),
        batch_size=BATCH, num_clients=n)
    fr = FedRound(
        task=TaskSpec(**spec).build(),
        server=Server.from_config("Median", lr=0.5),
        adversary=get_adversary("ALIE", num_clients=n, num_byzantine=f),
        batch_size=BATCH, num_clients=n, client_block=4)
    jx, jy, jln = jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths)
    mesh = make_mesh(8)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    jstate, arrays = jax_gossip_federation(mesh, jstate, (jx, jy, jln))
    jstep, _ = jax_gossip_step(jfr, mesh, JaxTopologyConfig(graph="ring",
                                                            num_nodes=n))
    state = gossip_federation(RoundState(server=fr.server.init(params, n)),
                              n)
    step, _ = gossip_step(fr, TopologyConfig(graph="ring", num_nodes=n))
    key = jax.random.PRNGKey(3)
    bx, by = sample_client_batches_with_keys(
        jax.random.split(jax.random.split(key, 5)[0], n), jx, jy, jln,
        BATCH, 1)
    jstate, jm = jstep(jstate, *arrays, jnp.asarray(np.arange(n) < f), key)
    state, m = step.step_prebatched(
        state, torch.from_numpy(np.array(bx)),
        torch.from_numpy(np.array(by)).long(), make_malicious_mask(n, f))
    np.testing.assert_allclose(_rows_of(state.server.params),
                               _jax_rows(jstate.server.params)[:n],
                               rtol=1e-4, atol=1e-4)
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
