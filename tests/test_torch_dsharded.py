"""The port's width-sharded round (blades_tpu_torch/parallel/dsharded.py,
the ``ShardInfo`` helpers of blades_tpu_torch/ops/layout.py and the shard
forms of the update forges) against the port's one-process dense round and
the JAX package's.

Without processes: ``elision_client_order`` and the elision prefix equal
the JAX package's over a grid; the psum'd layout helpers, summed over
hand-cut column shards, equal JAX's dense ``ops/layout.py`` helpers within
1e-6; the config's refusals of the width-sharded round use JAX's words.

One module-scoped group of 2 gloo ranks (``start_ranks`` of
tests/test_torch_mesh.py; 16 MLP clients, 4 malicious, client blocks of 2)
runs every case below while the parent computes JAX's references:

- each of the ten aggregators under ALIE, and the adversary x aggregator
  pairs of tests/test_dsharded.py, on the width-sharded round against the
  port's one-process dense round of the same seed, 2 rounds: Mean, Median,
  Trimmedmean and DnC bit for bit, the psum'd geometry within ``rtol=1e-5,
  atol=1e-6`` (the stateful aggregators' state too);
- ALIE + Median and SignFlip + Multikrum on JAX-drawn batches against
  JAX's ``FedRound.step_prebatched`` within the same tolerance, and the
  port's dense round bit for bit;
- malicious-lane elision (8 of 16 malicious, the driver's strided layout)
  equal to the non-elided round on that layout bit for bit, for the JAX
  test's three pairs; a mask off the layout raises;
- a NaN lane under the health check: ``num_unhealthy == 1``, ``round_ok``,
  the dense round's parameters bit for bit;
- ``rounds_per_dispatch=2`` through the driver equal to single dispatches,
  and ``dsharded_multi_step`` equal to single steps;
- Noise deterministic per seed (its shard-folded draws are not the dense
  stream);
- a dense checkpoint resumed on the 2-rank elision layout: each client's
  momentum row follows it;
- the mesh example's Median point at reduced width through ``file``;
- no tensor a rank makes in a round holds ``n * d`` elements.
"""

import copy
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_mesh import _cpu, _scalars, start_ranks

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
N, F, WORLD, ROUNDS = 16, 4, 2, 2
BASE = {
    "dataset_config": {"type": "mnist", "num_clients": N, "train_bs": 4},
    "global_model": "mlp", "client_block": 2, "num_malicious_clients": F,
    "evaluation_interval": 100, "adversary_config": {"type": "ALIE"},
}
# GeoMed runs maxiter steps on the width-sharded round: the dense round
# must not stop early either.
AGG_KW = {"GeoMed": {"maxiter": 5, "ftol": -1.0}}
AGGREGATORS = ["Mean", "Median", "Trimmedmean", "GeoMed", "DnC", "Multikrum",
               "Centeredclipping", "Signguard", "Clippedclustering", "FLTrust"]
# tests/test_dsharded.py's adversary x aggregator pairs.
PAIRS = [("ALIE", a) for a in AGGREGATORS] + [
    ("ALIE", "Signguard"), ("MinMax", "Signguard"), ("MinMax", "Median"),
    ("Adaptive", "Trimmedmean"), ("SignGuard", "Signguard"),
    ("Attackclippedclustering", "Clippedclustering"), ("IPM", "Multikrum")]
PAIRS = list(dict.fromkeys(PAIRS))
# Bit for bit on the CPU: the coordinate-wise aggregates (and DnC, whose
# sampled columns are assembled exactly); the rest sum shard partials.
EXACT = {"Mean", "Median", "Trimmedmean", "DnC"}
ELISION_PAIRS = [("ALIE", "Median"), ("IPM", "GeoMed"), ("MinMax", "Signguard")]


def cfg_of(adversary, aggregator, **extra):
    return {**BASE, "adversary_config": {"type": adversary},
            "server_config": {"lr": 1.0, "aggregator": {
                "type": aggregator, **AGG_KW.get(aggregator, {})}},
            **extra}


# ---------------------------------------------------------------------------
# the rank side (run by tests/test_torch_mesh.py as a script)
# ---------------------------------------------------------------------------


def _driver(cfg):
    from blades_tpu_torch.algorithms import FedavgConfig

    return FedavgConfig().update_from_dict(cfg).build(device="cpu")


def _round_of(algo, cfg):
    """``cfg``'s round with ``algo``'s dataset (and its root data)."""
    from blades_tpu_torch.algorithms import FedavgConfig

    c = FedavgConfig().update_from_dict(cfg)
    c.validate()
    fr = c.resolve_augment_for_data(c.get_fed_round(), algo.dataset)
    if getattr(fr.server.aggregator, "expects_trusted_row", False):
        fr = algo._attach_root_data(fr)
    return fr


def _pairs_case(case, rank):
    """Every pair on the width-sharded round from the seed's initial
    state over the sharded driver's lanes; on rank 0 the one-process dense
    round of the same seeds over the whole federation."""
    from blades_tpu_torch.parallel import dsharded_step, shard_federation

    mesh_algo = _driver({**BASE, "num_devices": WORLD, "execution": "dense"})
    dense = _driver(BASE) if rank == 0 else None
    out = {}
    for adv, agg in case["pairs"]:
        cfg = cfg_of(adv, agg)
        fr = _round_of(mesh_algo, cfg)
        state0 = fr.init(0, N, device="cpu")
        state, _ = shard_federation(mesh_algo.mesh, copy.deepcopy(state0), ())
        step = dsharded_step(fr, mesh_algo.mesh)
        for r in range(ROUNDS):
            state, m = step(state, *mesh_algo._train, mesh_algo.malicious,
                            mesh_algo.round_seed(r))
        res = {"params": _cpu(state.server.params), "metrics": _scalars(m),
               "agg_state": _cpu(state.server.agg_state)}
        if dense is not None:
            dstate = copy.deepcopy(state0)
            for r in range(ROUNDS):
                dstate, dm = fr.step(dstate, *dense._train, dense.malicious,
                                     mesh_algo.round_seed(r))
            res["dense"] = {"params": _cpu(dstate.server.params),
                            "metrics": _scalars(dm),
                            "agg_state": _cpu(dstate.server.agg_state)}
        out[(adv, agg)] = res
    mesh_algo.stop()
    return out


def _prebatched_case(case, rank):
    """The width-sharded round over handed-in batches (JAX's), and on
    rank 0 the port's dense round over the same."""
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.core import RoundState
    from blades_tpu_torch.parallel import (
        dsharded_step,
        make_mesh,
        shard_federation,
    )

    cfg = FedavgConfig().update_from_dict(case["config"])
    cfg.validate()
    fr = cfg.get_fed_round()
    params, n = case["params"], case["n"]

    def fresh():
        return RoundState(server=fr.server.init(
            {k: v.clone() for k, v in params.items()}, n),
            client_opt=fr.task.init_client_opt_state(params, n))

    mesh = make_mesh(WORLD)
    step = dsharded_step(fr, mesh)
    state, _ = shard_federation(mesh, fresh(), ())
    out = {"rounds": [], "dense": []}
    mal = case["malicious"]
    for r in case["rounds"]:
        state, m = step.prebatched(state, r["bx"], r["by"], mal, None,
                                   dropout_masks=r.get("masks"))
        out["rounds"].append({"params": _cpu(state.server.params),
                              "metrics": _scalars(m)})
    if rank == 0:
        dstate = fresh()
        for r in case["rounds"]:
            dstate, m = fr.step_prebatched(dstate, r["bx"], r["by"], mal,
                                           None, dropout_masks=r.get("masks"))
            out["dense"].append({"params": _cpu(dstate.server.params),
                                 "metrics": _scalars(m)})
    return out


def _elision_case(case, rank):
    """The driver on the elision layout (8 of 16 malicious): its elided
    step against a step without the prefix from the same state, 2 rounds
    each; then a step with the prefix handed the natural-order mask."""
    from blades_tpu_torch.parallel import dsharded_step

    out = {}
    for adv, agg in ELISION_PAIRS:
        algo = _driver(cfg_of(adv, agg, num_malicious_clients=8,
                              num_devices=WORLD, execution="dsharded"))
        runs = []
        for step in (algo._step, dsharded_step(algo.fed_round, algo.mesh)):
            state = copy.deepcopy(algo.state)
            for r in range(ROUNDS):
                state, m = step(state, *algo._train, algo.malicious,
                                algo.round_seed(r))
            runs.append({"params": _cpu(state.server.params),
                         "metrics": _scalars(m),
                         "elided": m.get("elided_lanes")})
        out[(adv, agg)] = {"runs": runs, "f_local": algo._step.f_local,
                           "order": algo._client_order,
                           "mask": algo.malicious.tolist()}
        if agg == "Median":
            step = dsharded_step(algo.fed_round, algo.mesh,
                                 malicious_prefix=8)
            try:
                step(copy.deepcopy(algo.state), *algo._train,
                     torch.arange(N) < 8, algo.round_seed(0))
                out["wrong_mask"] = None
            except ValueError as e:
                out["wrong_mask"] = str(e)
            signflip = _driver(cfg_of("SignFlip", "Mean",
                                      num_malicious_clients=8,
                                      num_devices=WORLD,
                                      execution="dsharded"))
            out["signflip_f_local"] = signflip._step.f_local
            out["signflip_order"] = signflip._client_order
            signflip.stop()
        algo.stop()
    return out


def _dispatch_case(case, rank):
    """The dsharded driver (4 of 16 ALIE elided) with rounds_per_dispatch
    2 and 1, 4 rounds each; ``dsharded_multi_step`` against two single
    steps; Noise twice from one state and seed, beside the dense round."""
    from blades_tpu_torch.parallel import (
        dsharded_multi_step,
        dsharded_step,
        shard_federation,
    )

    cfg = cfg_of("ALIE", "Median", num_devices=WORLD, execution="dsharded")
    out = {}
    for k in (2, 1):
        algo = _driver({**cfg, "rounds_per_dispatch": k})
        rows = [algo.train() for _ in range(4 // k)]
        out[k] = {"params": _cpu(algo.state.server.params),
                  "rows": [{kk: v for kk, v in r.items()
                            if isinstance(v, (int, float))} for r in rows]}
        if k == 1:
            multi = dsharded_multi_step(algo.fed_round, algo.mesh, 2,
                                        malicious_prefix=F)
            state, ms = multi(copy.deepcopy(algo.state), *algo._train,
                              algo.malicious, [7, 8])
            single = copy.deepcopy(algo.state)
            for seed in (7, 8):
                single, m = algo._step(single, *algo._train, algo.malicious,
                                       seed)
            out["multi"] = (_cpu(state.server.params),
                            _cpu(single.server.params),
                            [_scalars(x) for x in ms], _scalars(m))
        algo.stop()
    mesh_algo = _driver({**BASE, "num_devices": WORLD, "execution": "dense"})
    fr = _round_of(mesh_algo, cfg_of("Noise", "Median"))
    state0 = fr.init(0, N, device="cpu")
    runs = []
    for _ in range(2):
        state, _ = shard_federation(mesh_algo.mesh, copy.deepcopy(state0), ())
        state, m = dsharded_step(fr, mesh_algo.mesh)(
            state, *mesh_algo._train, mesh_algo.malicious, 5)
        runs.append((_cpu(state.server.params), _scalars(m)))
    out["noise"] = runs
    if rank == 0:
        dense = _driver(BASE)
        dstate, _ = fr.step(copy.deepcopy(state0), *dense._train,
                            dense.malicious, 5)
        out["noise_dense"] = _cpu(dstate.server.params)
        dense.stop()
    mesh_algo.stop()
    return out


def _checkpoint_case(case, rank):
    """A one-process dense driver with client momentum trains a round and
    checkpoints (rank 0); both ranks resume it on the width-sharded
    elision layout and train on."""
    import torch.distributed as dist

    cfg = cfg_of("ALIE", "Median", num_malicious_clients=8,
                 client_config={"lr": 0.1, "momentum": 0.9})
    ckpt = os.path.join(case["dir"], "ckpt")
    out = {}
    if rank == 0:
        a = _driver(cfg)
        a.train()
        a.save_checkpoint(ckpt)
        out["dense_opt"] = _cpu(a.state.client_opt)
        a.stop()
    dist.barrier()
    b = _driver({**cfg, "num_devices": WORLD, "execution": "dsharded"})
    b.load_checkpoint(ckpt)
    out["order"] = b._client_order
    out["opt"] = _cpu(b._gathered_state().client_opt)
    row = b.train()
    out["loss"] = row["train_loss"]
    b.stop()
    return out


def _sweep_case(case, rank):
    """``train.main(["file", ...])`` on the mesh example's Median point at
    reduced width."""
    from blades_tpu_torch import train

    rc = train.main(["file", case["yaml"], "--max-rounds", "2", "--device",
                     "cpu", "--storage-path", case["dir"]])
    return {"rc": rc}


def _shapes_case(case, rank):
    """The largest tensor any op makes in one width-sharded round (the
    training included), and whether any is ``(n, d)``-shaped."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from blades_tpu_torch.utils.tree import FlatLayout

    algo = _driver(cfg_of("ALIE", "Median", num_devices=WORLD,
                          execution="dsharded", health_check=True))
    d = FlatLayout(algo.state.server.params).d
    seen = {"max": 0, "nd": False}

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if torch.is_tensor(t):
                    seen["max"] = max(seen["max"], t.numel())
                    seen["nd"] |= (t.dim() == 2 and t.shape[0] >= N
                                   and t.shape[1] >= d)
            return out

    with Shapes():
        algo.train()
    algo.stop()
    return {**seen, "d": d}


def _cases(tmp, ref):
    yaml = tmp / "mesh_median.yaml"
    yaml.write_text(MESH_MEDIAN_YAML)
    nan = copy.deepcopy(ref["alie-median"]["case"])
    nan["config"] = {**nan["config"], "health_check": True}
    bx = nan["rounds"][0]["bx"].clone()
    bx[NAN_CLIENT] = float("nan")
    nan["rounds"] = [dict(nan["rounds"][0], bx=bx)]
    (tmp / "ckpt").mkdir(parents=True, exist_ok=True)
    return [
        {"kind": "test_torch_dsharded:_pairs_case", "pairs": PAIRS},
        ref["alie-median"]["case"], ref["signflip-multikrum"]["case"],
        {"kind": "test_torch_dsharded:_elision_case"},
        nan,
        {"kind": "test_torch_dsharded:_dispatch_case"},
        {"kind": "test_torch_dsharded:_checkpoint_case",
         "dir": str(tmp / "ckpt")},
        {"kind": "test_torch_dsharded:_sweep_case", "yaml": str(yaml),
         "dir": str(tmp / "sweep")},
        {"kind": "test_torch_dsharded:_shapes_case"},
    ]


(PAIRS_I, JAX_MEDIAN_I, JAX_MULTIKRUM_I, ELISION_I, NAN_I, DISPATCH_I,
 CKPT_I, SWEEP_I, SHAPES_I) = range(9)
NAN_CLIENT = 5
# fedavg_cifar10_1000clients_mesh.yaml's Median point at reduced width: the
# MLP, 16 clients (4 ALIE), 2 ranks, 2 rounds in one dispatch.
MESH_MEDIAN_YAML = """\
fedavg_cifar10_1000clients_mesh:
  run: FEDAVG
  stop:
    training_iteration: 2000
  config:
    dataset_config:
      type: cifar10
      num_clients: 16
      iid: False
      alpha: 0.1
      train_bs: 8
      seed: 122
    global_model: mlp
    execution: dsharded
    num_devices: 2
    rounds_per_dispatch: 2
    health_check: True
    num_malicious_clients: 4
    adversary_config:
      type: ALIE
    server_config:
      lr: 0.5
      aggregator:
        type: Median
    client_config:
      lr: 0.1
      num_batch_per_round: 1
    evaluation_interval: 2
"""


# ---------------------------------------------------------------------------
# the parent: references and tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    """JAX-drawn inputs for the two JAX parity cases (16 clients, 4
    malicious)."""
    from test_torch_sharded import jax_inputs

    out = {}
    for name in ("alie-median", "signflip-multikrum"):
        extra = {"n": N, "num_malicious_clients": F}
        inp = jax_inputs(name, extra)
        from test_torch_sharded import run_config

        case = {"kind": "test_torch_dsharded:_prebatched_case",
                "config": run_config(name, **extra), "params": inp["params"],
                "malicious": inp["malicious"], "n": inp["n"],
                "rounds": [{k: r[k] for k in ("bx", "by", "masks")}
                           for r in inp["rounds"]]}
        out[name] = {"inp": inp, "case": case}
    return out


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dsharded")
    return start_ranks({"d2": (WORLD, _cases(tmp, inputs))}, tmp), tmp


@pytest.fixture(scope="module")
def refs(inputs, launched):
    """JAX's dense rounds, computed while the ranks run."""
    from test_torch_sharded import jax_dense_rounds

    return {name: jax_dense_rounds(inputs[name]["inp"]) for name in inputs}


@pytest.fixture(scope="module")
def ranks(launched, refs):
    return launched[0].results()["d2"]


def assert_same(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_close(a, b):
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _tree_close(a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_close(a[k], b[k])
    elif torch.is_tensor(a):
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("adversary,aggregator", PAIRS,
                         ids=[f"{a}-{g}" for a, g in PAIRS])
def test_dsharded_round_is_the_port_dense_round(ranks, adversary,
                                                aggregator):
    got = ranks[0][PAIRS_I][(adversary, aggregator)]
    want = got["dense"]
    if aggregator in EXACT:
        assert_same(got["params"], want["params"])
        for k in ("train_loss", "agg_norm"):
            assert got["metrics"][k] == want["metrics"][k], k
    else:
        assert_close(got["params"], want["params"])
        _tree_close(got["agg_state"], want["agg_state"])
        np.testing.assert_allclose(got["metrics"]["agg_norm"],
                                   want["metrics"]["agg_norm"], rtol=RTOL)
    np.testing.assert_allclose(got["metrics"]["update_norm_mean"],
                               want["metrics"]["update_norm_mean"], rtol=RTOL)
    # Replicated: rank 1 holds rank 0's state bit for bit.
    assert_same(ranks[1][PAIRS_I][(adversary, aggregator)]["params"],
                got["params"])


@pytest.mark.parametrize("name,index", [("alie-median", JAX_MEDIAN_I),
                                        ("signflip-multikrum",
                                         JAX_MULTIKRUM_I)])
def test_dsharded_round_matches_jax_dense(ranks, refs, name, index):
    from jax.flatten_util import ravel_pytree
    from test_torch_sharded import flat

    out = ranks[0][index]
    for got, (jstate, jm) in zip(out["rounds"], refs[name]):
        np.testing.assert_allclose(
            flat(got["params"]), ravel_pytree(jstate.server.params)[0],
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["metrics"]["train_loss"],
                                   float(jm["train_loss"]), rtol=RTOL,
                                   atol=ATOL)
    for got, want in zip(out["rounds"], out["dense"]):
        if name == "alie-median":
            assert_same(got["params"], want["params"])
        else:
            assert_close(got["params"], want["params"])
    assert_same(ranks[1][index]["rounds"][-1]["params"],
                out["rounds"][-1]["params"])


@pytest.mark.parametrize("adversary,aggregator", ELISION_PAIRS,
                         ids=[f"{a}-{g}" for a, g in ELISION_PAIRS])
def test_elision_is_exact_on_the_strided_layout(ranks, adversary,
                                                aggregator):
    from blades_tpu_torch.parallel import elision_client_order

    for r in range(WORLD):
        out = ranks[r][ELISION_I][(adversary, aggregator)]
        elided, full = out["runs"]
        assert out["f_local"] == 4
        assert_same(elided["params"], full["params"])
        for k in ("train_loss", "agg_norm", "update_norm_mean"):
            assert elided["metrics"][k] == full["metrics"][k], k
        assert elided["elided"] == 8 and full["elided"] is None
        np.testing.assert_array_equal(out["order"],
                                      elision_client_order(N, 8, WORLD))
        m = np.asarray(out["mask"]).reshape(WORLD, -1)
        assert m[:, :4].all() and not m[:, 4:].any()


def test_elision_validates_the_mask_and_skips_training_attacks(ranks):
    out = ranks[0][ELISION_I]
    assert "elision promised every rank's first 4 lanes malicious" in \
        out["wrong_mask"]
    # SignFlip trains for real: no elision, no permutation.
    assert out["signflip_f_local"] == 0 and out["signflip_order"] is None


def test_a_nan_lane_is_found_by_the_psum(ranks):
    for r in range(WORLD):
        got = ranks[r][NAN_I]["rounds"][0]
        assert got["metrics"]["num_unhealthy"] == 1
        assert got["metrics"]["round_ok"] == 1
        assert all(bool(torch.isfinite(v).all())
                   for v in got["params"].values())
    got, want = ranks[0][NAN_I]["rounds"][0], ranks[0][NAN_I]["dense"][0]
    assert_same(got["params"], want["params"])
    assert want["metrics"]["num_unhealthy"] == 1


def test_rounds_per_dispatch_on_the_width_sharded_round(ranks):
    for r in range(WORLD):
        out = ranks[r][DISPATCH_I]
        assert_same(out[2]["params"], out[1]["params"])
        assert [row["training_iteration"] for row in out[2]["rows"]] == [2, 4]
        assert out[2]["rows"][-1]["train_loss"] == \
            out[1]["rows"][-1]["train_loss"]
        assert out[2]["rows"][-1]["elided_lanes"] == F
        multi, single, ms, m = out["multi"]
        assert_same(multi, single)
        assert ms[-1] == m and len(ms) == 2
    assert_same(ranks[0][DISPATCH_I][1]["params"],
                ranks[1][DISPATCH_I][1]["params"])


def test_noise_is_deterministic_per_seed(ranks):
    for r in range(WORLD):
        (a, ma), (b, mb) = ranks[r][DISPATCH_I]["noise"]
        assert_same(a, b)
        assert ma == mb and np.isfinite(ma["train_loss"])
    a = ranks[0][DISPATCH_I]["noise"][0][0]
    assert_same(a, ranks[1][DISPATCH_I]["noise"][0][0])
    dense = ranks[0][DISPATCH_I]["noise_dense"]
    assert not all(torch.equal(a[k], dense[k]) for k in a)


def test_checkpoint_realigns_client_state_across_layouts(ranks):
    from blades_tpu_torch.parallel import elision_client_order

    order = elision_client_order(N, 8, WORLD)
    dense = ranks[0][CKPT_I]["dense_opt"]
    for r in range(WORLD):
        out = ranks[r][CKPT_I]
        np.testing.assert_array_equal(out["order"], order)
        for k in dense:
            assert torch.equal(dense[k][torch.from_numpy(order)],
                               out["opt"][k]), k
        assert np.isfinite(out["loss"])


def test_mesh_example_median_point_through_file(ranks, launched):
    from blades_tpu_torch.tune import verify_result_rounds

    assert [ranks[r][SWEEP_I]["rc"] for r in range(WORLD)] == [0, 0]
    trials = sorted((launched[1] / "sweep").rglob("result.json"))
    assert len(trials) == 1
    # rounds_per_dispatch 2: one row for the dispatch.
    assert verify_result_rounds(trials[0]) == [2]
    import json

    rows = [json.loads(line) for line in trials[0].read_text().splitlines()]
    assert rows[-1]["elided_lanes"] == 4 and rows[-1]["round_ok"]
    assert np.isfinite(rows[-1]["train_loss"])


def test_no_rank_holds_an_n_by_d_tensor(ranks):
    for r in range(WORLD):
        out = ranks[r][SHAPES_I]
        assert not out["nd"]
        assert out["max"] < N * out["d"], (out["max"], N * out["d"])


# ---------------------------------------------------------------------------
# without processes
# ---------------------------------------------------------------------------


ORDER_GRID = [(16, 8, 8), (32, 10, 8), (16, 4, 2), (16, 5, 2), (1000, 250, 8),
              (12, 7, 3), (8, 1, 4), (17, 8, 8), (16, 0, 2), (16, 16, 2)]


@pytest.mark.parametrize("n,f,k", ORDER_GRID)
def test_elision_client_order_matches_jax(n, f, k):
    from blades_tpu.parallel.dsharded import elision_client_order as jax_order
    from blades_tpu_torch.parallel import elision_client_order

    def run(fn):
        try:
            return fn(n, f, k).tolist()
        except ValueError as e:
            return str(e)

    assert run(elision_client_order) == run(jax_order)


@pytest.mark.parametrize("adversary", ["ALIE", "SignFlip", "Noise", None])
def test_elision_prefix_matches_jax(adversary):
    import types

    from blades_tpu.algorithms.fedavg import Fedavg as JaxFedavg
    from blades_tpu.adversaries import get_adversary as jax_adversary
    from blades_tpu_torch.adversaries import get_adversary
    from blades_tpu_torch.algorithms.fedavg import dsharded_elision_prefix

    for n, f, k in [(16, 4, 2), (16, 1, 2), (15, 4, 2), (16, 8, 8),
                    (16, 0, 2), (1000, 250, 8)]:
        cfg = types.SimpleNamespace(num_malicious_clients=f, num_clients=n,
                                    num_devices=k, mesh_shape=None)
        kw = dict(num_clients=n, num_byzantine=f)
        jadv = jax_adversary(adversary, **kw) if adversary else None
        adv = get_adversary(adversary, **kw) if adversary else None
        want = JaxFedavg._dsharded_elision_prefix(types.SimpleNamespace(
            config=cfg, fed_round=types.SimpleNamespace(adversary=jadv)))
        assert dsharded_elision_prefix(cfg, adv) == want, (n, f, k)


def test_layout_helpers_over_column_shards_match_jax_dense():
    """Each helper's partials on hand-cut column shards, summed (the psum
    of the round, here ``ShardInfo.reduce``), against JAX's dense
    ``ops/layout.py`` helpers."""
    import jax.numpy as jnp

    from blades_tpu.ops import layout as JL
    from blades_tpu_torch.ops import layout as L

    rng = np.random.default_rng(0)
    n, d, k = 6, 333, 3
    x = (0.05 * rng.normal(size=(n, d))).astype(np.float32)
    v = (0.05 * rng.normal(size=(d,))).astype(np.float32)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    shards = [L.ShardInfo.of(d, k, i) for i in range(k)]
    assert [s.columns for s in shards] == [128, 128, 77]
    assert all(s.d_pad % k == 0 and s.d_pad >= d for s in shards)
    cols = np.concatenate([s.coords().numpy() for s in shards])
    np.testing.assert_array_equal(cols, np.arange(d))
    assert int(shards[-1].valid().sum()) == 77
    pieces = [(xt[:, s.coords()], vt[s.coords()]) for s in shards]

    def summed(fn):
        """``fn(x_piece, v_piece, shard)`` with every shard's psum the sum
        of all shards' partials."""
        parts = [[] for _ in shards]

        def recorder(i):
            return lambda p: parts[i].append(p) or p

        for i, (s, (xp, vp)) in enumerate(zip(shards, pieces)):
            fn(xp, vp, dataclasses.replace(s, reduce=recorder(i)))
        totals = [sum(ps) for ps in zip(*parts)]
        it = iter(totals)
        xp, vp = pieces[0]
        return fn(xp, vp, dataclasses.replace(
            shards[0], reduce=lambda p: next(it)))

    jx, jv = jnp.asarray(x), jnp.asarray(v)
    checks = [
        (lambda xp, vp, s: L.row_sq_norms(xp, s), JL.row_sq_norms(jx)),
        (lambda xp, vp, s: L.row_norms(xp, s), JL.row_norms(jx)),
        (lambda xp, vp, s: L.row_dots(xp, vp, s), JL.row_dots(jx, jv)),
        (lambda xp, vp, s: L.gram(xp, s), JL.gram(jx)),
        (lambda xp, vp, s: L.pairwise_sq_dists(xp, s),
         JL.pairwise_sq_dists(jx)),
    ]
    for fn, want in checks:
        np.testing.assert_allclose(summed(fn).numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    # The clip scales each shard's columns by the global norm.
    want = np.asarray(JL.clip_rows_to_norm(jx, 0.5))
    for i, (s, (xp, vp)) in enumerate(zip(shards, pieces)):
        total = L.row_sq_norms(xt)
        got = L.clip_rows_to_norm(xp, 0.5, dataclasses.replace(
            s, reduce=lambda p: total))
        np.testing.assert_allclose(got.numpy(), want[:, s.coords().numpy()],
                                   rtol=1e-6, atol=1e-6)
    for s in shards:
        np.testing.assert_array_equal(L.slice_to_shard(vt, s).numpy(),
                                      v[s.coords().numpy()])
    # The dense layout is the plain reduction, bit for bit.
    assert torch.equal(L.row_norms(xt), (xt * xt).sum(1).sqrt())


DSHARDED_REFUSALS = [
    dict(execution="dsharded"),
    dict(execution="dsharded", num_devices=2, forensics=True),
    dict(execution="dsharded", num_devices=2,
         fault_config={"dropout_rate": 0.1}),
    dict(execution="dsharded", num_devices=2,
         codec_config={"type": "quant"}),
    dict(execution="dsharded", num_devices=2, control_config={}),
    dict(execution="dsharded", num_devices=2, autotune="on"),
]


@pytest.mark.parametrize("kw", DSHARDED_REFUSALS,
                         ids=["single-chip", "forensics", "faults", "codec",
                              "control", "autotune"])
def test_dsharded_refusals_use_the_jax_words(kw):
    from test_torch_mesh import _configs

    msgs = []
    for cfg in _configs(**kw):
        with pytest.raises(ValueError) as info:
            cfg.validate()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert "dsharded" in msgs[1] or "d-sharded" in msgs[1]
