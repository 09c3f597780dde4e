"""The port's peer graphs, topology-scoped adversary, gossip config and
gossip driver (blades_tpu_torch/topology/, adversaries/topology_attacks.py,
algorithms/) against the JAX package's.

The graph module is plain numpy in both packages: adjacency, mixing
matrix, spectral gap, neighbor tables and provenance are held equal
element for element for all five families and both mixings (the gap to
the float's last bit: the same ``eigvalsh`` on the same matrix).  The
receiver masks, the breakdown gate's and ``validate()``'s messages are
the JAX package's, word for word.  The driver runs ``execution="gossip"``
from ``FedavgConfig``, ``train run`` and ``train file``; its rows pass the
schema, and a kill-and-resume under edge dropout equals a straight run
bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.ops.aggregators import BREAKDOWN_MIN_ROWS as JAX_BREAKDOWN
from blades_tpu.parallel.mesh import make_mesh
from blades_tpu.topology import TopologyConfig as JaxTopologyConfig
from blades_tpu.topology import get_topology as jax_get_topology
from blades_tpu.topology import gossip_step as jax_gossip_step
from blades_tpu_torch import train
from blades_tpu_torch.adversaries import get_adversary
from blades_tpu_torch.adversaries.topology_attacks import (
    TopologyAttackAdversary,
)
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.algorithms.config import _EXECUTIONS
from blades_tpu_torch.core import FedRound, Server, TaskSpec
from blades_tpu_torch.obs.schema import validate_record
from blades_tpu_torch.ops.aggregators import (
    BREAKDOWN_MIN_ROWS,
    breakdown_min_rows,
)
from blades_tpu_torch.topology import (
    GRAPHS,
    MIXINGS,
    TopologyConfig,
    get_topology,
    gossip_step,
)

TOPO_ALIE = {"type": "TopologyAttack", "base": "ALIE"}
KNOBS = {"ring": {}, "torus": {}, "kregular": {"k": 4},
         "erdos": {"p": 0.3, "graph_seed": 7}, "complete": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small torch ops: with
    several test workers on a few cores, the thread pools contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(graph, n=12, **kw):
    kw = {**KNOBS[graph], **kw}
    return (TopologyConfig(graph=graph, num_nodes=n, **kw),
            JaxTopologyConfig(graph=graph, num_nodes=n, **kw))


@pytest.mark.parametrize("mixing", MIXINGS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_graph_arrays_equal_the_jax_arrays(graph, mixing):
    ours, theirs = _pair(graph, mixing=mixing)
    assert np.array_equal(ours.adjacency(), theirs.adjacency())
    assert np.array_equal(ours.mixing_matrix(), theirs.mixing_matrix())
    assert ours.spectral_gap == theirs.spectral_gap
    a, b = ours.neighbor_tables(), theirs.neighbor_tables()
    for f in ("nbr_idx", "valid", "w_slot", "self_slot"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert ours.provenance() == theirs.provenance()


@pytest.mark.parametrize("graph", GRAPHS)
def test_graph_adjacency_and_mixing_contracts(graph):
    """Symmetric adjacency without self loops or isolated nodes; a
    symmetric doubly-stochastic mixing with non-negative weights and a
    gap in (0, 1]."""
    topo = TopologyConfig(graph=graph, num_nodes=8, k=4, p=0.3)
    a = topo.adjacency()
    assert a.dtype == bool and a.shape == (8, 8)
    assert np.array_equal(a, a.T) and not a.diagonal().any()
    assert (a.sum(axis=1) >= 1).all()
    w = topo.mixing_matrix()
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-12)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-12)
    assert (w >= 0).all()
    np.testing.assert_allclose(w, w.T, atol=1e-15)
    assert 0.0 < topo.spectral_gap <= 1.0


def test_neighbor_tables_slot_contract():
    """Closed neighborhoods in ascending global index, pad slots pointing
    at the node itself, zero weight on self and pad slots; the complete
    graph's rows are 0..n-1."""
    t = TopologyConfig(graph="erdos", num_nodes=9, p=0.4).neighbor_tables()
    n, k1 = t.nbr_idx.shape
    for i in range(n):
        d_i = int(t.valid[i].sum())
        real = t.nbr_idx[i, :d_i]
        assert list(real) == sorted(real) and i in real
        assert (t.nbr_idx[i, d_i:] == i).all()
        assert t.nbr_idx[i, t.self_slot[i]] == i
        assert t.w_slot[i, t.self_slot[i]] == 0.0
        assert (t.w_slot[i, d_i:] == 0.0).all()
    tc = TopologyConfig(graph="complete", num_nodes=6).neighbor_tables()
    assert np.array_equal(tc.nbr_idx,
                          np.tile(np.arange(6, dtype=np.int32), (6, 1)))


def test_erdos_is_pure_in_its_seed():
    a1 = TopologyConfig(graph="erdos", num_nodes=12, p=0.4,
                        graph_seed=7).adjacency()
    a2 = TopologyConfig(graph="erdos", num_nodes=12, p=0.4,
                        graph_seed=7).adjacency()
    a3 = TopologyConfig(graph="erdos", num_nodes=12, p=0.4,
                        graph_seed=8).adjacency()
    assert np.array_equal(a1, a2) and not np.array_equal(a1, a3)
    gaps = {g: TopologyConfig(graph=g, num_nodes=8, k=4).spectral_gap
            for g in ("ring", "kregular", "complete")}
    assert gaps["complete"] == pytest.approx(1.0)
    assert gaps["ring"] < gaps["kregular"] <= gaps["complete"]


BAD_GRAPHS = [
    {"graph": "smallworld"}, {"graph": "ring", "mixing": "lazy"},
    {"graph": "ring", "num_nodes": 1}, {"graph": "kregular", "k": 3},
    {"graph": "erdos", "p": 1.5}, {"graph": "torus", "num_nodes": 7},
]


@pytest.mark.parametrize("spec", BAD_GRAPHS,
                         ids=[str(i) for i in range(len(BAD_GRAPHS))])
def test_graph_errors_are_the_jax_errors(spec):
    spec = {"num_nodes": 8, **spec}
    with pytest.raises(ValueError) as ours:
        TopologyConfig(**spec)
    with pytest.raises(ValueError) as theirs:
        JaxTopologyConfig(**spec)
    assert str(ours.value) == str(theirs.value)


def test_get_topology_resolution():
    assert get_topology("kregular", 8).graph == "kregular"
    assert get_topology({"graph": "erdos", "p": 0.5}, 8).p == 0.5
    t = TopologyConfig(graph="ring", num_nodes=4)
    assert get_topology(t, 99) is t
    assert get_topology(None, 5) == TopologyConfig(num_nodes=5)
    assert (dataclass_fields(get_topology({"graph": "torus"}, 12))
            == dataclass_fields(jax_get_topology({"graph": "torus"}, 12)))


def dataclass_fields(t):
    return (t.graph, t.num_nodes, t.k, t.p, t.graph_seed, t.mixing)


@pytest.mark.parametrize("eclipse", [None, 3])
@pytest.mark.parametrize("graph", ["ring", "kregular", "erdos"])
def test_receiver_masks_equal_the_jax_masks(graph, eclipse):
    spec = {**TOPO_ALIE, "eclipse_target": eclipse}
    ours = get_adversary(spec, num_clients=12, num_byzantine=3)
    theirs = jax_adversary(spec, num_clients=12, num_byzantine=3)
    a = TopologyConfig(graph=graph, num_nodes=12, **KNOBS[graph]).adjacency()
    assert isinstance(ours, TopologyAttackAdversary) and ours.topology_scoped
    mask = ours.receiver_mask(a)
    assert mask.dtype == bool
    assert np.array_equal(mask, theirs.receiver_mask(a))
    if eclipse is not None:
        assert mask[3].any() and not np.delete(mask, 3, axis=0).any()


def test_topology_attack_delegates_and_validates():
    """The wrapped attack forges the rows (ALIE's); a training-side base
    (SignFlip) corrupts in-lane; bad targets, self-wrapping and a
    mismatched graph raise with the JAX package's words."""
    adv = get_adversary(TOPO_ALIE, num_clients=6, num_byzantine=2)
    alie = get_adversary("ALIE", num_clients=6, num_byzantine=2)
    u = torch.randn((6, 40), generator=torch.Generator().manual_seed(0))
    mal = torch.arange(6) < 2
    assert torch.equal(adv.on_updates_ready(u, mal),
                       alie.on_updates_ready(u, mal))
    flip = get_adversary({**TOPO_ALIE, "base": "SignFlip"}, num_clients=6,
                         num_byzantine=2)
    g = {"w": torch.ones((6, 3))}
    assert torch.equal(flip.grad_hook(g, mal)["w"][:2], -torch.ones((2, 3)))
    cases = [({**TOPO_ALIE, "eclipse_target": 99}, "eclipse_target"),
             ({"type": "TopologyAttack", "base": "TopologyAttack"},
              "TopologyAttack")]
    for spec, match in cases:
        with pytest.raises(ValueError, match=match) as ours:
            get_adversary(spec, num_clients=6, num_byzantine=2)
        with pytest.raises(ValueError) as theirs:
            jax_adversary(spec, num_clients=6, num_byzantine=2)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="num_clients"):
        adv.receiver_mask(np.zeros((4, 4), bool))


def test_breakdown_bounds_are_the_jax_bounds():
    assert BREAKDOWN_MIN_ROWS == JAX_BREAKDOWN
    assert breakdown_min_rows("Multikrum", 2) == 5
    f = torch.tensor([0, 1, 3])
    assert torch.equal(breakdown_min_rows("Median", f),
                       torch.tensor([1, 3, 7]))
    with pytest.raises(KeyError, match="no breakdown bound"):
        breakdown_min_rows("Nope", 1)


def _mesh8():
    return make_mesh(8)


def _gate_rounds(agg, f):
    task = dict(num_classes=2, input_shape=(4, 4, 1))
    jfr = JaxFedRound(task=JaxTaskSpec(model="mlp", **task).build(),
                      server=JaxServer.from_config(aggregator=agg,
                                                   num_byzantine=f),
                      num_clients=8)
    fr = FedRound(task=TaskSpec(model="mlp", **task).build(),
                  server=Server.from_config(agg, num_byzantine=f),
                  num_clients=8)
    return jfr, fr


@pytest.mark.parametrize("agg,f,graph", [("Multikrum", 2, "ring"),
                                         ("Trimmedmean", 2, "kregular")])
def test_breakdown_gate_refuses_with_the_jax_words(agg, f, graph):
    """Multikrum(f=2) needs f + 3 = 5 neighborhood rows and the ring's
    closed neighborhoods hold 3; Trimmedmean(f=2) needs 2f + 1 = 5 and
    kregular k=2 gives 3: refused before any round, with the message the
    JAX package raises."""
    jfr, fr = _gate_rounds(agg, f)
    kw = {"k": 2} if graph == "kregular" else {}
    with pytest.raises(ValueError, match="needs neighborhood matrices") \
            as ours:
        gossip_step(fr, TopologyConfig(graph=graph, num_nodes=8, **kw))
    with pytest.raises(ValueError) as theirs:
        jax_gossip_step(jfr, _mesh8(),
                        JaxTopologyConfig(graph=graph, num_nodes=8, **kw))
    assert str(ours.value) == str(theirs.value)


def _configs():
    def base(cls):
        return (cls().data(dataset="mnist", num_clients=8, seed=0)
                .training(global_model="mlp", aggregator={"type": "Median"}))
    return base(FedavgConfig), base(JaxFedavgConfig)


VALIDATE_CASES = [
    ({"topology": {"graph": "ring"}, "execution": "dense"},
     "topology_config is set but execution='dense'"),
    ({"execution": "gossip", "codec_config": {"type": "quant", "bits": 8}},
     "execution='gossip' × update codecs"),
    ({"execution": "gossip", "agg_domain": "wire"},
     "execution='gossip' × wire-domain aggregation"),
    ({"execution": "gossip", "forensics": True},
     "execution='gossip' × defense forensics"),
    ({"execution": "gossip", "ledger": True},
     "execution='gossip' × the client ledger"),
    ({"execution": "gossip", "control_config": {"enabled": True}},
     "execution='gossip' × the control plane"),
    ({"execution": "gossip", "state_window": 4},
     "execution='gossip' × the participation-window store"),
    ({"execution": "gossip", "state_store": "host"},
     "execution='gossip' × out-of-core client state"),
    ({"execution": "gossip", "rounds_per_dispatch": 2},
     "execution='gossip' × rounds_per_dispatch > 1"),
    ({"execution": "gossip", "chained_dispatch": True},
     "execution='gossip' × chained_dispatch"),
    ({"execution": "gossip",
      "fault_config": {"num_stragglers": 2, "staleness": 1}},
     "execution='gossip' × straggler faults"),
    ({"execution": "gossip", "fault_config": {"corrupt_rate": 0.1}},
     "execution='gossip' × corruption faults"),
    ({"execution": "gossip", "topology": {"graph": "kregular", "k": 3}},
     "kregular degree k=3"),
    ({"adversary": TOPO_ALIE, "execution": "dense"}, "topology-scoped"),
]


@pytest.mark.parametrize("case,match", VALIDATE_CASES,
                         ids=[str(i) for i in range(len(VALIDATE_CASES))])
def test_gossip_validation_messages_are_the_jax_messages(case, match):
    """Each refused pair raises in both packages with the same message
    (set as the JAX test sets it: fields assigned on the config)."""
    msgs = []
    for cfg in _configs():
        fields = dict(case)
        topo = fields.pop("topology", None)
        adv = fields.pop("adversary", None)
        if topo is not None:
            cfg.topology(**topo)
        if adv is not None:
            cfg.adversary(num_malicious_clients=2, adversary_config=adv)
        for k, v in fields.items():
            setattr(cfg, k, v)
        with pytest.raises(ValueError, match=match) as err:
            cfg.validate()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("execution", ["dsharded", "hier", "nope"])
def test_execution_messages_name_every_path_the_port_runs(execution):
    """The stale-message repair: the refusal of a later execution and of
    an unknown one name auto, dense, streamed, async, gossip and hier;
    hier on one process is refused with the JAX package's words."""
    cfg = FedavgConfig()
    cfg.execution = execution
    if execution == "hier":
        with pytest.raises(ValueError, match="pre-aggregates per chip"):
            cfg.validate()
        return
    err = NotImplementedError if execution != "nope" else ValueError
    with pytest.raises(err) as info:
        cfg.validate()
    msg = str(info.value)
    assert _EXECUTIONS == ("auto", "dense", "streamed", "async", "gossip",
                           "hier")
    for name in _EXECUTIONS:
        assert (f"'{name}'" if err is NotImplementedError else name) in msg
    if err is ValueError:
        assert "auto|dense|streamed|async|gossip|hier" in msg
    else:
        assert ("'auto', 'dense', 'streamed', 'async', 'gossip' and "
                "'hier'") in msg


def test_topology_builder_merges_and_resolves():
    cfg = (FedavgConfig().data(num_clients=12).resources(execution="gossip")
           .topology(graph="kregular").topology(k=6, mixing="uniform"))
    assert cfg.topology_config == {"graph": "kregular", "k": 6,
                                   "mixing": "uniform"}
    cfg.validate()
    assert cfg.get_topology() == TopologyConfig(
        graph="kregular", num_nodes=12, k=6, mixing="uniform")
    assert FedavgConfig().get_topology() is None
    nested = FedavgConfig().update_from_dict({
        "dataset_config": {"num_clients": 12}, "execution": "gossip",
        "topology_config": {"graph": "kregular", "k": 6,
                            "mixing": "uniform"}})
    nested.validate()
    assert nested.items() == cfg.items()


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

GOSSIP_RUN = {
    "dataset_config": {"type": "mnist", "num_clients": 8, "train_bs": 4,
                       "seed": 3},
    "global_model": "mlp", "evaluation_interval": 0,
    "execution": "gossip", "topology_config": {"graph": "kregular", "k": 4},
    "num_malicious_clients": 2, "adversary_config": {"type": "SignFlip"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "fault_config": {"dropout_rate": 0.4, "seed": 11},
}


def test_driver_rows_stamp_the_gossip_fields_and_pass_the_schema():
    algo = FedavgConfig().update_from_dict({
        **GOSSIP_RUN, "fault_config": None,
        "topology_config": {"graph": "ring"},
        "adversary_config": TOPO_ALIE}).build(device="cpu")
    try:
        row = algo.train()
        validate_record(dict(row, experiment="gossip", trial="t0"))
        assert row["topology"] == "ring" and row["graph_seed"] == 0
        assert row["spectral_gap"] == TopologyConfig(
            graph="ring", num_nodes=8).spectral_gap
        assert row["gossip_ici_bytes"] == 0
        assert row["num_partitioned_nodes"] == 0
        assert row["consensus_dist"] == 0.0  # every replica starts equal
        row2 = algo.train()
        assert row2["consensus_dist"] > 0.0  # the ring drifts apart
        ev = algo.evaluate()
        assert np.isfinite(ev["test_loss"])
        assert {v.shape[0] for v in algo.state.server.params.values()} == {8}
    finally:
        algo.stop()


def test_driver_kill_and_resume_is_bit_identical(tmp_path):
    """Checkpoint a gossip run under edge dropout after round 1, restore
    into a fresh driver: rounds 2-3 equal the straight run's (rows and
    every node's parameters and momentum), the per-node stacks riding
    the checkpoint verbatim."""
    run = {**GOSSIP_RUN, "server_config": {
        "lr": 0.5, "momentum": 0.9, "aggregator": {"type": "Median"}}}
    a = FedavgConfig().update_from_dict(run).build(device="cpu")
    b = FedavgConfig().update_from_dict(run).build(device="cpu")
    try:
        a.train()
        path = a.save_checkpoint(str(tmp_path))
        ra = [a.train() for _ in range(2)]
        b.load_checkpoint(path)
        rb = [b.train() for _ in range(2)]
        for x, y in zip(ra, rb):
            for k in ("train_loss", "agg_norm", "num_partitioned_nodes",
                      "consensus_dist", "update_norm_mean"):
                assert x[k] == y[k], k
        assert any(r["num_partitioned_nodes"] > 0 for r in ra)
        for k, v in a.state.server.params.items():
            assert torch.equal(v, b.state.server.params[k])
            assert torch.equal(a.state.server.opt_state["buf"][k],
                               b.state.server.opt_state["buf"][k])
        assert (a.state.server.opt_state["count"]
                == b.state.server.opt_state["count"]).all()
    finally:
        a.stop()
        b.stop()


def test_run_command_merges_the_topology_flags(tmp_path):
    """``--execution gossip --topology --mixing --graph-seed`` merge into
    ``topology_config`` over the JSON's, as the JAX command merges them."""
    cfg = {k: v for k, v in GOSSIP_RUN.items()
           if k not in ("execution", "fault_config")}
    cfg["topology_config"] = {"graph": "ring", "p": 0.5}
    assert train.main([
        "run", "FEDAVG", "--rounds", "2", "--device", "cpu",
        "--storage-path", str(tmp_path), "--execution", "gossip",
        "--topology", "erdos", "--mixing", "uniform", "--graph-seed", "4",
        "--config-json", json.dumps(cfg)]) == 0
    tdir = tmp_path / "fedavg_run" / "fedavg_run_00000"
    params = json.loads((tdir / "params.json").read_text())
    assert params["topology_config"] == {"graph": "erdos", "p": 0.5,
                                         "mixing": "uniform",
                                         "graph_seed": 4}
    rows = [json.loads(line) for line in
            (tdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["topology"] for r in rows] == ["erdos", "erdos"]
    assert rows[-1]["graph_seed"] == 4
    assert rows[-1]["spectral_gap"] == TopologyConfig(
        graph="erdos", num_nodes=8, p=0.5, mixing="uniform",
        graph_seed=4).spectral_gap


def test_file_command_runs_a_gossip_grid(tmp_path):
    """A YAML with ``execution: gossip`` and a ``topology_config`` grid
    runs every point through ``file``; the rows carry each point's
    graph."""
    grid = {"g": {"run": "FEDAVG", "stop": {"training_iteration": 2},
                  "config": {**GOSSIP_RUN, "topology_config": {
                      "grid_search": [{"graph": "ring"},
                                      {"graph": "complete"}]}}}}
    path = tmp_path / "grid.yaml"
    path.write_text(json.dumps(grid))
    assert train.main(["file", str(path), "--device", "cpu",
                       "--storage-path", str(tmp_path / "s")]) == 0
    for i, graph in enumerate(("ring", "complete")):
        tdir = tmp_path / "s" / "g" / f"g_{i:05d}"
        rows = [json.loads(line) for line in
                (tdir / "metrics.jsonl").read_text().splitlines()]
        assert [r["topology"] for r in rows] == [graph, graph]
        assert all(np.isfinite(r["train_loss"]) for r in rows)
