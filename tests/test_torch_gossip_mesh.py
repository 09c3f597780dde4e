"""The port's gossip round on the ranks of a process group
(blades_tpu_torch/topology/gossip.py with a mesh, the placement in
blades_tpu_torch/parallel/mesh.py, the driver and the CLI) against the
port's one-process stacked round, the comm models and JAX's
``gossip_step``.

One group of 2 gloo ranks and one of 4, started together through
tests/test_torch_mesh.py's rank program (``start_ranks``), run the same
cases; each rank holds its block of ``ceil(n / c)`` nodes, and rank 0 also
runs the one-process stacked round of each case (single-threaded, as the
ranks are).  The MLP nodes train on JAX-drawn batches and dropout masks
(``split(k_sample, n)`` through ``sample_client_batches_with_keys``, the
masks as tests/test_torch_gossip.py recomputes them); under faults the
edge realization is JAX's.  Every case's training blocks are the stacked
round's blocks, so the rank round equals the stacked round bit for bit:
the parameters of every node (gathered), every metric, the partition
counts.  The recorder of every rank equals both packages'
``gossip_round_volumes`` for ``(c, 1)``, event by event, and its
``gossip_ici_bytes`` their ring total.  The headline case's stacked round
is held against JAX's ``gossip_step`` on the 8-device CPU mesh within
tests/test_torch_gossip.py's tolerances.
"""

import json
import os

import numpy as np
import pytest
import torch
from test_torch_mesh import _cpu, _scalars, start_ranks

N = 16
ROWS = 4
SHAPE = (4, 4, 1)
BATCH = 2
RTOL, ATOL = 1e-5, 1e-6
GRAM_TOL = 1e-5
ROUNDS = 2
WORLDS = (2, 4)
TOPO_ALIE = {"type": "TopologyAttack", "base": "ALIE"}
FAULTS = {"seed": 5, "dropout_rate": 0.5}
# name -> (aggregator, attack, f, graph kwargs, n, client_block, extras)
CASES = {
    "median": ("Median", "ALIE", 4, {"k": 4}, N, 4, {}),
    "multikrum": ("Multikrum", "ALIE", 1, {"k": 4}, N, 4, {}),
    # A subsample narrower than the MLP's 226 columns, so that the
    # draws decide which columns each node scores.
    "dnc": ({"type": "DnC", "sub_dim": 50}, "ALIE", 2, {"k": 4}, N, 4, {}),
    "fltrust": ("FLTrust", "ALIE", 2, {"k": 4}, N, 4, {}),
    "trimmed-faults": ("Trimmedmean", "SignFlip", 2, {"k": 4}, N, 4,
                       {"faults": FAULTS, "health": True}),
    "eclipse": ("Median", {**TOPO_ALIE, "eclipse_target": 11}, 2, {"k": 4},
                N, 4, {}),
    # 14 nodes: 7 a rank on 2 ranks, 4 a rank on 4 (the last with 2 ghost
    # nodes); blocks of one lane align with either.
    "padded": ("Median", "ALIE", 3, {"k": 4}, 14, 1, {}),
}
MLP_CONFIG = {
    "dataset_config": {"type": "mnist", "num_clients": 12, "train_bs": 8,
                       "seed": 3},
    "global_model": "mlp", "execution": "gossip",
    "topology_config": {"graph": "kregular", "k": 4},
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.1, "num_batch_per_round": 1},
    "client_block": 2, "evaluation_interval": 1,
}
DRIVER_ROUNDS, SAVE_AT = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the rank programs
# ---------------------------------------------------------------------------


def _fed_round(spec, trusted=None):
    from blades_tpu_torch.adversaries import get_adversary
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.faults import FaultInjector
    from blades_tpu_torch.models.mlp import MLP

    agg, attack, f, _, n, block, extra = spec
    faults = extra.get("faults")
    return FedRound(
        task=TaskSpec(model=MLP(16, hidden1=8, hidden2=8, num_classes=2),
                      num_classes=2, input_shape=SHAPE, lr=0.1).build(),
        server=Server.from_config(agg, num_byzantine=f, lr=0.5),
        adversary=get_adversary(attack, num_clients=n, num_byzantine=f),
        batch_size=BATCH, num_batches_per_round=1, num_clients=n,
        faults=None if faults is None else FaultInjector(**faults),
        health_check=extra.get("health", False), client_block=block,
        trusted_data=trusted)


def _run_rounds(step, state, case, n):
    from blades_tpu_torch.adversaries import make_malicious_mask

    mal = make_malicious_mask(n, case["spec"][2])
    out = []
    for r, inp in enumerate(case["rounds"]):
        state, m = step.step_prebatched(
            state, inp["bx"], inp["by"], mal, 1000 + r,
            dropout_masks=inp["masks"], edge_drop=inp.get("drop"))
        out.append((state, m))
    return out


def _round_case(case, rank):
    """The rank round of one case (its nodes' parameters gathered each
    round, the metrics, the recorder) and, on rank 0, the one-process
    stacked round of the same case."""
    from blades_tpu_torch.core import RoundState
    from blades_tpu_torch.parallel import make_mesh
    from blades_tpu_torch.parallel.mesh import (
        gather_gossip_state,
        shard_gossip_state,
    )
    from blades_tpu_torch.topology import (
        TopologyConfig,
        gossip_federation,
        gossip_step,
    )

    spec = case["spec"]
    n = spec[4]
    fr = _fed_round(spec, case.get("trusted"))
    topo = TopologyConfig(graph="kregular", num_nodes=n, **spec[3])
    params = case["params"]

    def fresh():
        return gossip_federation(RoundState(
            server=fr.server.init({k: v.clone() for k, v in params.items()},
                                  n),
            client_opt=fr.task.init_client_opt_state(params, n)), n)

    mesh = make_mesh()
    step, rec = gossip_step(fr, topo, mesh=mesh)
    state, _ = shard_gossip_state(mesh, fresh(), (), n)
    out = {"lanes": (step.block.start, step.n_local, step.lo, step.hi),
           "shapes": {k: tuple(v.shape) for k, v in
                      state.server.params.items()},
           "rounds": [], "stacked": []}
    for st, m in _run_rounds(step, state, case, n):
        full = gather_gossip_state(mesh, st, n)
        out["rounds"].append({
            "params": _cpu(full.server.params), "metrics": _scalars(m),
            "events": list(rec.ici_events), "ici_bytes": rec.ici_bytes})
    if rank == 0:
        one, one_rec = gossip_step(fr, topo)
        for st, m in _run_rounds(one, fresh(), case, n):
            out["stacked"].append({
                "params": _cpu(st.server.params), "metrics": _scalars(m),
                "events": list(one_rec.ici_events)})
    return out


def _driver(cfg, ckpt=None, save_at=None, rounds=DRIVER_ROUNDS):
    from blades_tpu_torch.algorithms import FedavgConfig

    algo = FedavgConfig().update_from_dict(cfg).build(device="cpu")
    rows = []
    try:
        if ckpt is not None and save_at is None:
            algo.load_checkpoint(ckpt)
        while algo.iteration < rounds:
            rows.append(algo.train())
            if save_at is not None and algo.iteration == save_at:
                algo.save_checkpoint(ckpt)
        state = (algo._gathered_state() if algo.mesh is not None
                 else algo.state)
        return {"params": _cpu(state.server.params),
                "opt": {k: (v.copy() if isinstance(v, np.ndarray)
                            else _cpu(v))
                        for k, v in state.server.opt_state.items()},
                "rows": [{k: v for k, v in r.items() if k != "timers"}
                         for r in rows]}
    finally:
        algo.stop()


def _driver_case(case, rank):
    """``Fedavg.train()`` of the gossip trial on the ranks, checkpointed at
    round 2 by rank 0 and resumed on the ranks; on rank 0 the one-process
    run and the one-process resume of the ranks' checkpoint."""
    import torch.distributed as dist

    world = dist.get_world_size()
    ckpt = os.path.join(case["dir"], f"ckpt{world}")
    cfg = {**MLP_CONFIG, "num_devices": world}
    out = {"mesh": _driver(cfg, ckpt, SAVE_AT)}
    dist.barrier()
    out["resumed"] = _driver(cfg, ckpt)
    if rank == 0:
        out["one"] = _driver(MLP_CONFIG)
        out["one_resumed"] = _driver(MLP_CONFIG, ckpt)
    return out


def _cli_case(case, rank):
    """``train run`` and ``train file`` of the gossip trial on the ranks
    (the group is already joined, as under torchrun), rank 0 writing."""
    from blades_tpu_torch import train

    import torch.distributed as dist

    world = dist.get_world_size()
    cfg = {k: v for k, v in MLP_CONFIG.items()
           if k not in ("execution", "topology_config")}
    run_dir = os.path.join(case["dir"], f"run{world}")
    rc_run = train.main([
        "run", "FEDAVG", "--rounds", "2", "--device", "cpu", "--execution",
        "gossip", "--topology", "kregular", "--config-json",
        json.dumps({**cfg, "num_devices": world}), "--storage-path",
        run_dir])
    yaml = os.path.join(case["dir"], f"grid{world}.yaml")
    if rank == 0:
        with open(yaml, "w") as fh:
            fh.write(GRID_YAML.format(world=world))
    dist.barrier()
    rc_file = train.main(["file", yaml, "--max-rounds", "2", "--device",
                          "cpu", "--storage-path",
                          os.path.join(case["dir"], f"file{world}")])
    return {"rc": (rc_run, rc_file)}


GRID_YAML = """\
gossip_mesh:
  run: FEDAVG
  stop:
    training_iteration: 2
  config:
    dataset_config:
      type: mnist
      num_clients: 12
      train_bs: 8
      seed: 3
    global_model: mlp
    execution: gossip
    num_devices: {world}
    topology_config:
      graph: ring
    num_malicious_clients: 1
    adversary_config:
      type: SignFlip
    server_config:
      lr: 0.5
      aggregator:
        type: Median
    client_config:
      lr: 0.1
      num_batch_per_round: 1
"""


# ---------------------------------------------------------------------------
# the parent: inputs, references, tests
# ---------------------------------------------------------------------------


def _jax_round_inputs(n, key, model, faults, round_idx):
    """One round's JAX draws: the batches, the dropout masks and, under
    faults, the edge realization (tests/test_torch_gossip.py's)."""
    import jax
    from test_torch_gossip import _jax_edge_drop, _jax_masks

    from blades_tpu.data.sampler import sample_client_batches_with_keys

    x, y, lengths = _data(n)
    k_sample = jax.random.split(key, 5)[0]
    bx, by = sample_client_batches_with_keys(
        jax.random.split(k_sample, n), x, y, lengths, BATCH, 1)
    masks = _jax_masks(key, n, model)
    return {"bx": torch.from_numpy(np.array(bx)),
            "by": torch.from_numpy(np.array(by)).long(),
            "masks": masks,
            "drop": None if faults is None else _jax_edge_drop(faults, n,
                                                               round_idx)}


def _data(n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, ROWS) + SHAPE).astype(np.float32)
    y = rng.integers(0, 2, size=(n, ROWS)).astype(np.int32)
    lengths = np.full((n,), ROWS, np.int32)
    lengths[-1] = ROWS - 1
    return x, y, lengths


def _jax_params():
    """Flax-initialised MLP parameters (the JAX round's), converted."""
    import jax
    from test_torch_gossip import _rounds

    from blades_tpu_torch.convert import params_from_jax

    jfr, _ = _rounds("Median", "ALIE", 4)
    jstate = jfr.init(jax.random.PRNGKey(0), N)
    return params_from_jax(jax.tree.map(np.asarray, jstate.server.params))


def _cases(tmp):
    import jax

    from blades_tpu_torch.models.mlp import MLP

    model = MLP(16, hidden1=8, hidden2=8, num_classes=2)
    params = _jax_params()
    rng = np.random.default_rng(7)
    trusted = (torch.from_numpy(rng.normal(size=(6,) + SHAPE)
                                .astype(np.float32)),
               torch.from_numpy(rng.integers(0, 2, size=(6,))).long())
    cases = []
    for name, spec in CASES.items():
        n, faults = spec[4], spec[6].get("faults")
        rounds = [_jax_round_inputs(n, jax.random.fold_in(
            jax.random.PRNGKey(9), r), model, faults, r)
            for r in range(ROUNDS + (1 if faults else 0))]
        cases.append({"kind": "test_torch_gossip_mesh:_round_case",
                      "name": name, "spec": spec, "params": params,
                      "rounds": rounds,
                      "trusted": trusted if name == "fltrust" else None})
    cases.append({"kind": "test_torch_gossip_mesh:_driver_case",
                  "dir": str(tmp)})
    cases.append({"kind": "test_torch_gossip_mesh:_cli_case",
                  "dir": str(tmp)})
    return cases


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gossip_mesh")
    cases = _cases(tmp)
    groups = {f"c{w}": (w, cases) for w in WORLDS}
    return start_ranks(groups, tmp), tmp, cases


@pytest.fixture(scope="module")
def jax_ref(launched):
    """JAX's gossip rounds of the headline case on the 8-device CPU mesh,
    computed while the ranks run."""
    return _jax_gossip_rounds(launched[2][0])


def _jax_gossip_rounds(case):
    import jax
    import jax.numpy as jnp
    from test_torch_gossip import _jax_rows, _rounds

    from blades_tpu.parallel.mesh import make_mesh
    from blades_tpu.topology import TopologyConfig as JaxTopologyConfig
    from blades_tpu.topology import gossip_federation as jax_federation
    from blades_tpu.topology import gossip_step as jax_gossip_step

    jfr, _ = _rounds("Median", "ALIE", 4)
    x, y, lengths = (jnp.asarray(a) for a in _data(N))
    mesh = make_mesh(8)
    jstate = jfr.init(jax.random.PRNGKey(0), N)
    jstate, arrays = jax_federation(mesh, jstate, (x, y, lengths))
    jstep, _ = jax_gossip_step(jfr, mesh, JaxTopologyConfig(
        graph="kregular", num_nodes=N, k=4))
    mal = jnp.asarray(np.arange(N) < 4)
    out = []
    for r in range(ROUNDS):
        key = jax.random.fold_in(jax.random.PRNGKey(9), r)
        jstate, jm = jstep(jstate, *arrays, mal, key)
        out.append((jax.tree.map(np.asarray, jm),
                    _jax_rows(jstate.server.params)))
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_ref):
    return launched[0].results()


def _by_name(results, name):
    i = list(CASES).index(name)
    return [res[i] for res in results]


def _rows(params):
    from blades_tpu_torch.utils.tree import FlatLayout

    return FlatLayout({k: v[0] for k, v in params.items()}).ravel_rows(
        params).numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_rank_round_is_the_stacked_round_bit_for_bit(ranks, name, world):
    per_rank = _by_name(ranks[f"c{world}"], name)
    stacked = per_rank[0]["stacked"]
    n = CASES[name][4]
    assert len(stacked) == len(per_rank[0]["rounds"])
    for r, want in enumerate(stacked):
        for rank, res in enumerate(per_rank):
            got = res["rounds"][r]
            for k, v in want["params"].items():
                assert torch.equal(got["params"][k], v), (rank, r, k)
            for k, v in want["metrics"].items():
                if k != "gossip_ici_bytes":
                    assert got["metrics"][k] == v, (rank, r, k)
    # Every rank holds its block of ceil(n / c) nodes, ghosts past n.
    n_local = -(-n // world)
    for rank, res in enumerate(per_rank):
        start, nl, lo, hi = res["lanes"]
        assert (start, nl) == (rank * n_local, n_local)
        assert (lo, hi) == (min(start, n), min(start + nl, n))
        assert all(s[0] == n_local for s in res["shapes"].values())


def test_cases_exercise_their_hazards(ranks):
    """The edge-dropout case partitions some nodes; the eclipse reaches
    only its victim (its replica drifts from the ring's); DnC and FLTrust
    draw per node (a rank that skipped the earlier nodes' draws would
    differ from the stacked round, which the bit-for-bit test holds)."""
    faults = _by_name(ranks["c4"], "trimmed-faults")[0]["stacked"]
    assert any(r["metrics"]["num_partitioned_nodes"] > 0 for r in faults)
    for name in ("dnc", "fltrust"):
        res = _by_name(ranks["c4"], name)[0]["stacked"]
        assert all(np.isfinite(r["metrics"]["agg_norm"]) for r in res)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["median", "trimmed-faults", "padded"])
def test_recorder_equals_both_comm_models(ranks, name, world):
    """Every rank's recorded collectives equal the port's and JAX's
    ``gossip_round_volumes`` for ``(c, 1)`` both ways (labels, kinds,
    payloads, rings, in order), and ``gossip_ici_bytes`` their ring
    total; the one-process round's are the models' for a mesh of one."""
    from blades_tpu.parallel import comm_model as jax_cm
    from blades_tpu_torch.parallel import comm_model as cm

    n = CASES[name][4]
    faults = "faults" in CASES[name][6]
    d = 226
    for model in (cm, jax_cm):
        vols = model.gossip_round_volumes(n, d, (world, 1), faults=faults)
        want = [(v.label, v.kind, v.payload_bytes, k) for v, k in vols]
        total = model.gossip_wire_bytes(vols)
        one = [(v.label, v.kind, v.payload_bytes, k) for v, k in
               model.gossip_round_volumes(n, d, (1,), faults=faults)]
        for res in _by_name(ranks[f"c{world}"], name):
            for rnd in res["rounds"]:
                assert [tuple(e) for e in rnd["events"]] == want
                assert rnd["ici_bytes"] == total
                assert rnd["metrics"]["gossip_ici_bytes"] == total
            for rnd in res["stacked"]:
                assert [tuple(e) for e in rnd["events"]] == one
    assert total > 0


def test_stacked_round_matches_jax_gossip_step(ranks, jax_ref):
    """The headline case (kregular, ALIE on 4, Median) against JAX's
    ``gossip_step`` on the 8-device CPU mesh, with JAX's draws handed in:
    tests/test_torch_gossip.py's tolerances.  The rank rounds equal the
    stacked round bit for bit (above), so they match JAX as closely."""
    stacked = _by_name(ranks["c2"], "median")[0]["stacked"]
    for (jm, jrows), got in zip(jax_ref, stacked):
        np.testing.assert_allclose(_rows(got["params"]), jrows[:N],
                                   rtol=RTOL, atol=ATOL)
        for k in ("train_loss", "update_norm_mean", "agg_norm"):
            np.testing.assert_allclose(got["metrics"][k], float(jm[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        scale = float((jrows[:N].astype(np.float64) ** 2).sum(1).max())
        np.testing.assert_allclose(got["metrics"]["consensus_dist"] ** 2,
                                   float(jm["consensus_dist"]) ** 2, rtol=0,
                                   atol=GRAM_TOL * scale)


def _same_rows(a, b):
    """Driver rows equal, bit for bit, but for the wire bytes and the
    timers."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        ka = {k: v for k, v in ra.items() if k != "gossip_ici_bytes"}
        kb = {k: v for k, v in rb.items() if k != "gossip_ici_bytes"}
        assert ka == kb


def _same_state(a, b):
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    for k, v in a["opt"].items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(b["opt"][k]))


@pytest.mark.parametrize("world", WORLDS)
def test_driver_rows_and_checkpoints(ranks, world):
    """``Fedavg.train()`` with ``num_devices`` ranks writes the
    one-process run's rows (node 0's evaluation included) with the mesh's
    ``gossip_ici_bytes``; the ranks' round-2 checkpoint resumes bit for
    bit on the ranks and in one process."""
    from blades_tpu_torch.parallel.comm_model import (
        gossip_round_volumes,
        gossip_wire_bytes,
    )

    res = ranks[f"c{world}"]
    i = len(CASES)
    one = res[0][i]["one"]
    mesh = res[0][i]["mesh"]
    _same_rows(mesh["rows"], one["rows"])
    _same_state(mesh, one)
    d = sum(int(np.prod(v.shape[1:])) for v in one["params"].values())
    total = gossip_wire_bytes(gossip_round_volumes(12, d, (world, 1)))
    assert all(r["gossip_ici_bytes"] == total for r in mesh["rows"])
    assert all(r["gossip_ici_bytes"] == 0 for r in one["rows"])
    for rank in range(world):
        resumed = res[rank][i]["resumed"]
        _same_rows(resumed["rows"], mesh["rows"][SAVE_AT:])
        _same_state(resumed, one)
    _same_rows(res[0][i]["one_resumed"]["rows"], one["rows"][SAVE_AT:])
    _same_state(res[0][i]["one_resumed"], one)


@pytest.mark.parametrize("world", WORLDS)
def test_cli_run_and_file_on_the_ranks(ranks, world, launched):
    tmp = launched[1]
    for rank_res in ranks[f"c{world}"]:
        assert rank_res[len(CASES) + 1]["rc"] == (0, 0)
    for sub in (f"run{world}", f"file{world}"):
        found = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp / sub)
                 for f in fs if f == "result.json"]
        assert found, sub
        with open(found[0]) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
        assert [r["training_iteration"] for r in rows] == [1, 2]
        assert all(r["gossip_ici_bytes"] > 0 for r in rows)


MESH_REFUSALS = [
    ({"num_devices": 4, "mesh_shape": (2, 2)},
     "execution='gossip' × 2-D mesh_shape"),
    ({"num_devices": 2, "forensics": True},
     "execution='gossip' × defense forensics"),
    ({"num_devices": 2, "codec_config": {"type": "quant", "bits": 8}},
     "execution='gossip' × update codecs"),
    ({"num_devices": 2, "fault_config": {"num_stragglers": 2,
                                         "staleness": 1}},
     "execution='gossip' × straggler faults"),
]


@pytest.mark.parametrize("fields,match", MESH_REFUSALS,
                         ids=[m.split("× ")[1] for _, m in MESH_REFUSALS])
def test_gossip_mesh_refusals_are_the_jax_messages(fields, match):
    """On a mesh the gossip pairs are refused first, in both packages,
    with the same words (the JAX config checks them before the mesh's)."""
    from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
    from blades_tpu_torch.algorithms import FedavgConfig

    msgs = []
    for cls in (JaxFedavgConfig, FedavgConfig):
        cfg = (cls().data(dataset="mnist", num_clients=8, seed=0)
               .training(global_model="mlp", aggregator={"type": "Median"})
               .resources(execution="gossip"))
        for k, v in fields.items():
            setattr(cfg, k, v)
        with pytest.raises(ValueError, match=match) as err:
            cfg.validate()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
