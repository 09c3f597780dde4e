"""The port's client-sharded dense round (blades_tpu_torch/parallel/sharded.py)
on gloo ranks of the CPU, against the JAX package's one-device dense round.

Two module-scoped groups (2 ranks and 4 ranks, one process each) run every
case; the parent process holds their results against:

- JAX's ``FedRound.step_prebatched`` on the same JAX-drawn batches and
  dropout masks (MLP, ALIE + Median and SignFlip + Multikrum, 8 clients,
  and ALIE + Median at 7 clients, which leaves ghost lanes on both
  meshes), server parameters after each of two rounds within ``rtol=1e-5,
  atol=1e-6`` (tests/test_torch_fedavg.py's tolerance: f32 sums in other
  orders);
- the port's one-process dense round over the same inputs, bit for bit
  where the ranks' client blocks are the dense round's (``client_block``
  2 divides every rank's lanes at 8 clients), and within the same
  tolerance otherwise;
- the port's one-process driver of the same seed: the Fedavg driver on
  the mesh (its own draws: batch uniforms and masks replayed from the
  round seed) equals it bit for bit, and its evaluation
  (``sharded_evaluate``, the ranks' sums added) within 1e-6; a
  ``rounds_per_dispatch=2`` run equals the single-round dispatches bit for
  bit, and so does ``sharded_multi_step``;
- a 2-rank checkpoint (client momentum rows gathered to rank 0) resumed
  on 2 ranks equals the straight run bit for bit;
- ``run_experiments`` of a 2-rank trial writes its files on rank 0 alone;
  a fault planted in rank 0's metrics sink makes both ranks retry
  together (an OSError) or stop together (a SchemaError), not hang;
- ``shard_map_step`` (per-rank draws) is deterministic per seed and is
  not the dense stream.

The ranks' meshes (coordinates, lane blocks) follow the JAX package's
row-major device grid, and ``make_mesh``'s errors on a world of 2 are the
JAX package's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_dense_round import _jax_draws
from test_torch_mesh import start_ranks

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.convert import params_from_jax, params_to_jax

RTOL, ATOL = 1e-5, 1e-6
BATCH = 4
BASE = {
    "dataset_config": {"type": "mnist", "train_bs": BATCH},
    "global_model": "mlp", "client_block": 2,
    "num_malicious_clients": 2,
}
CASES = {
    "alie-median": (8, {"adversary_config": {"type": "ALIE"},
                        "server_config": {"lr": 1.0,
                                          "aggregator": {"type": "Median"}}}),
    "signflip-multikrum": (8, {
        "adversary_config": {"type": "SignFlip"},
        "server_config": {"lr": 1.0, "aggregator": {
            "type": "Multikrum", "num_byzantine": 2, "k": 3}}}),
    "ghost-lanes": (7, {"adversary_config": {"type": "ALIE"},
                        "server_config": {"lr": 1.0,
                                          "aggregator": {"type": "Median"}}}),
}
ROUNDS = 2


def run_config(name, n=None, **extra):
    n0, over = CASES[name]
    cfg = {**BASE, **over, **extra}
    cfg["dataset_config"] = {**BASE["dataset_config"], "num_clients": n or n0}
    return cfg


def jax_inputs(name, extra=None, rounds=ROUNDS, seed=0):
    """A case's inputs from the JAX package: its initial parameters,
    per-round batches, round keys and dropout masks, and the malicious
    mask, in the port's layout; ``jfr`` and its initial state for the
    references (:func:`jax_dense_rounds`)."""
    cfg = run_config(name, **(extra or {}))
    jcfg = JaxFedavgConfig().update_from_dict(
        {k: v for k, v in cfg.items()
         if k not in ("num_devices", "mesh_shape", "execution", "preagg",
                      "bucket_size")})
    jcfg.validate()
    jfr = jcfg.get_fed_round()
    pcfg = FedavgConfig().update_from_dict(
        {k: v for k, v in cfg.items()
         if k not in ("num_devices", "mesh_shape", "execution")})
    pcfg.validate()
    model = pcfg.get_fed_round().task.model
    n = jcfg.num_clients
    f = jcfg.num_malicious_clients
    nb = jfr.num_batches_per_round
    jstate0 = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate0.server.params))
    mal = np.arange(n) < f
    rng = np.random.default_rng(seed)
    ins = []
    for key in jax.random.split(jax.random.PRNGKey(9), rounds):
        bx = rng.normal(size=(n, nb, BATCH) + tuple(jcfg.input_shape)
                        ).astype(np.float32)
        by = rng.integers(0, 10, size=(n, nb, BATCH)).astype(np.int32)
        masks, _ = _jax_draws(key, n, nb, BATCH, model, None)
        ins.append({"bx": torch.from_numpy(bx),
                    "by": torch.from_numpy(by).long(), "masks": masks,
                    "key": key, "jbx": bx, "jby": by})
    return {"params": params, "rounds": ins,
            "malicious": torch.from_numpy(mal), "jfr": jfr,
            "jstate0": jstate0, "n": n}


def jax_dense_rounds(inp):
    """JAX's one-device dense ``step_prebatched`` over a case's inputs,
    chained: the state and metrics after each round."""
    step = jax.jit(inp["jfr"].step_prebatched)
    mal = jnp.asarray(inp["malicious"].numpy())
    jstate, outs = inp["jstate0"], []
    for r in inp["rounds"]:
        jstate, jm = step(jstate, jnp.asarray(r["jbx"]), jnp.asarray(r["jby"]),
                          mal, r["key"])
        outs.append((jstate, jm))
    return outs


def prebatched_case(ref, cfg, dense=True, mesh_errors=()):
    return {"kind": "prebatched", "config": cfg, "params": ref["params"],
            "malicious": ref["malicious"], "dense": dense,
            "mesh_errors": list(mesh_errors),
            "rounds": [{k: r[k] for k in ("bx", "by", "masks")}
                       for r in ref["rounds"]]}


def flat(params):
    return ravel_pytree(params_to_jax(params))[0]


def assert_same(a, b):
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_close(a, b):
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


# Where each driver-level case sits in a group's results (after CASES);
# the 4-rank group runs the first one only.
(DRIVER, DISPATCH, SWEEP, SHARD_MAP, RESUME, SWEEP_RETRY,
 SWEEP_FINAL) = range(len(CASES), len(CASES) + 7)
MESH_ERRORS = [(3, (2, 2)), (None, (4, 2)), (8, None), (None, (0, 1))]


def _expected_mesh_error(world, nd, ms):
    """The JAX package's ``make_mesh`` message on a world of ``world``
    devices (``blades_tpu/parallel/mesh.py:63-102``)."""
    if ms is not None:
        c, d = ms
        if c < 1 or d < 1:
            return f"mesh_shape axes must be >= 1, got {ms}"
        if nd is not None and nd != c * d:
            return (f"mesh_shape {c}x{d} needs exactly {c * d} devices, "
                    f"num_devices requested {nd}")
        return f"mesh_shape {c}x{d} needs {c * d} devices, have {world}"
    return f"requested {nd} devices, have {world}"


@pytest.fixture(scope="module")
def inputs():
    return {name: jax_inputs(name) for name in CASES}


def _cases(world, inputs, tmp):
    cases = [prebatched_case(inputs[name],
                             run_config(name, num_devices=world),
                             mesh_errors=MESH_ERRORS)
             for name in CASES]
    drv = run_config("alie-median", num_devices=world,
                     evaluation_interval=2, seed=3)
    cases.append({"kind": "driver", "config": drv, "rounds": 2,
                  "dense": True})
    if world == 2:
        cases.append({"kind": "driver", "rounds": 4, "dense": True,
                      "config": {**drv, "rounds_per_dispatch": 2}})
        cases.append({"kind": "sweep", "rounds": 2, "dir": str(tmp / "runs"),
                      "config": drv})
        cases.append({"kind": "shard_map", "rounds": 2, "config": drv})
        cases.append({"kind": "driver", "rounds": 3, "resume_at": 2,
                      "dense": True,
                      "dir": str(tmp), "config": {
                          **drv, "client_config": {"momentum": 0.9}}})
        # A fault on rank 0 alone: an OSError at round 2, once (both ranks
        # retry from round 1's checkpoint), and a SchemaError at round 1
        # (both stop).
        cases.append({"kind": "sweep", "rounds": 2, "config": drv,
                      "dir": str(tmp / "retry"), "max_failures": 1,
                      "fault": ("io", 2, 1)})
        cases.append({"kind": "sweep", "rounds": 2, "config": drv,
                      "dir": str(tmp / "final"), "max_failures": 1,
                      "fault": ("schema", 1, 1)})
    return cases


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    """Every case on a group of 2 ranks and on a group of 4, at once."""
    tmp = tmp_path_factory.mktemp("sharded")
    return start_ranks({str(w): (w, _cases(w, inputs, tmp / f"ckpt{w}"))
                        for w in WORLDS}, tmp)


@pytest.fixture(scope="module")
def refs(inputs, launched):
    """JAX's dense rounds, computed while the ranks run."""
    return {name: jax_dense_rounds(inputs[name]) for name in CASES}


@pytest.fixture(scope="module")
def groups(launched, refs):
    out = launched.results()
    return {w: out[str(w)] for w in WORLDS}


WORLDS = (2, 4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_round_matches_jax_dense(groups, refs, name, world):
    res = groups[world]
    i = list(CASES).index(name)
    for r in range(world):
        out = res[r][i]
        for got, (jstate, jm) in zip(out["rounds"], refs[name]):
            np.testing.assert_allclose(
                flat(got["params"]), ravel_pytree(jstate.server.params)[0],
                rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got["metrics"]["agg_norm"],
                                       float(jm["agg_norm"]), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(got["metrics"]["train_loss"],
                                       float(jm["train_loss"]), rtol=RTOL,
                                       atol=ATOL)
        # Replicated: every rank holds rank 0's state bit for bit.
        assert_same(out["rounds"][-1]["params"],
                    res[0][i]["rounds"][-1]["params"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_round_is_the_port_dense_round(groups, name, world):
    """Bit for bit where the ranks' client blocks are the dense round's
    blocks; with ghost lanes the last block trains in another grouping."""
    res = groups[world]
    i = list(CASES).index(name)
    out = res[0][i]
    for got, want in zip(out["rounds"], out["dense"]):
        if name == "ghost-lanes":
            assert_close(got["params"], want["params"])
        else:
            assert_same(got["params"], want["params"])
            assert got["metrics"] == want["metrics"]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_form_the_jax_grid_and_errors(groups, world):
    """Rank ``r`` sits at ``divmod(r, dd)`` of the row-major grid and owns
    the ``clients`` block the JAX package's sharding gives it; a bad
    ``num_devices`` / ``mesh_shape`` raises the JAX package's message."""
    res = groups[world]
    n_local = -(-7 // world)
    for r in range(world):
        out = res[r][list(CASES).index("ghost-lanes")]
        assert out["shape"] == (world, 1) and out["coords"] == (r, 0)
        assert out["lanes"] == (r * n_local, n_local)
        for nd, ms in MESH_ERRORS:
            assert out["mesh_errors"][(nd, ms)] == _expected_mesh_error(
                world, nd, ms)


@pytest.mark.parametrize("world", WORLDS)
def test_driver_on_the_mesh_is_the_dense_driver(groups, world):
    """The Fedavg driver with ``num_devices``: its own draws replayed from
    the round seed, so the parameters equal the one-process driver's bit
    for bit; the ranks' evaluation equals the dense evaluation."""
    res = groups[world]
    out = res[0][DRIVER]
    assert_same(out["mesh"]["params"], out["dense"]["params"])
    for got, want in zip(out["mesh"]["rows"], out["dense"]["rows"]):
        assert got["train_loss"] == want["train_loss"]
        for k in ("test_loss", "test_acc", "test_acc_top3"):
            assert (k in got) == (k in want)
            if k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert "test_acc" in out["mesh"]["rows"][-1]
    for r in range(1, world):
        assert_same(res[r][DRIVER]["mesh"]["params"],
                    out["mesh"]["params"])


def test_rounds_per_dispatch_on_the_mesh(groups):
    """``rounds_per_dispatch=2`` on 2 ranks: two rows of two rounds, the
    one-process driver's parameters bit for bit."""
    out = groups[2][0][DISPATCH]
    assert [r["training_iteration"] for r in out["mesh"]["rows"]] == [2, 4]
    assert_same(out["mesh"]["params"], out["dense"]["params"])


def test_sweep_on_the_mesh_writes_on_rank_0(groups):
    """``run_experiments`` with a ``num_devices=2`` trial on both ranks:
    rank 0 alone writes the trial's files (two rows, the per-round
    checkpoints, which both ranks' gathers fed), and both ranks report the
    same run."""
    from pathlib import Path

    from blades_tpu_torch.tune import verify_result_rounds

    s0, s1 = (groups[2][r][SWEEP]["summaries"] for r in (0, 1))
    assert len(s0) == len(s1) == 1 and "status" not in s0[0]
    assert s0[0]["final"] == s1[0]["final"] and s0[0]["rounds"] == 2
    tdir = Path(s0[0]["dir"])
    assert verify_result_rounds(tdir / "result.json") == [1, 2]
    assert sorted(p.name for p in tdir.iterdir()) == [
        "ckpt_000001", "ckpt_000002", "metrics.jsonl", "params.json",
        "result.json"]
    assert sorted(p.name for p in tdir.parent.iterdir()) == [tdir.name]


def test_shard_map_step_draws_per_rank(groups):
    """``shard_map_step``: each rank draws its lanes' batches from a
    generator of its own (seed, ``clients`` coordinate), so two runs of
    one seed are equal bit for bit, the ranks hold one replicated state,
    and the round is not the dense stream's (``sharded_step``), which
    ``sharded_multi_step`` over the same rounds equals bit for bit."""
    runs = [groups[2][r][SHARD_MAP] for r in range(2)]
    for out in runs:
        first, again, dense_stream, multi = out["runs"]
        assert_same(first, again)
        assert_same(multi, dense_stream)
        assert out["losses"][3] == out["losses"][2]
        assert all(bool(torch.isfinite(v).all()) for v in first.values())
        assert not all(torch.equal(first[k], dense_stream[k])
                       for k in first)
        assert np.isfinite(out["losses"]).all()
    assert_same(runs[0]["runs"][0], runs[1]["runs"][0])


def test_checkpoint_resumed_on_the_mesh(groups):
    """A 2-rank checkpoint after round 2 (the momentum rows gathered to
    rank 0, the one-process format) resumed on 2 ranks: round 3 equals the
    straight run bit for bit, and so do the gathered momentum rows."""
    res = groups[2]
    for r in range(2):
        out = res[r][RESUME]
        assert_same(out["resumed"]["params"], out["mesh"]["params"])
        assert_same(out["resumed"]["client_opt"], out["mesh"]["client_opt"])
        assert len(out["resumed"]["rows"]) == 1
    dense = res[0][RESUME]["dense"]
    assert_same(res[0][RESUME]["mesh"]["params"], dense["params"])
    assert_same(res[0][RESUME]["mesh"]["client_opt"],
                dense["client_opt"])


def test_sweep_ranks_retry_together_after_a_fault_on_rank_0(groups):
    """An OSError in rank 0's metrics sink at round 2 (rank 0 alone):
    both ranks retry from round 1's checkpoint, together, and finish the
    run the straight sweep finishes (the same evaluation), one failure
    written to rank 0's error.txt."""
    from pathlib import Path

    from blades_tpu_torch.tune import verify_result_rounds

    s0, s1 = (groups[2][r][SWEEP_RETRY]["summaries"][0] for r in (0, 1))
    straight = groups[2][0][SWEEP]["summaries"][0]
    for s in (s0, s1):
        assert "status" not in s and s["rounds"] == 2
        assert s["final"] == straight["final"]
    tdir = Path(s0["dir"])
    assert verify_result_rounds(tdir / "result.json") == [1, 2]
    errors = (tdir / "error.txt").read_text()
    assert "attempt 1: OSError" in errors and "attempt 2" not in errors


def test_sweep_ranks_stop_together_after_a_final_fault_on_rank_0(groups):
    """A SchemaError in rank 0's metrics sink at round 1: no retry on
    either rank; rank 0 reports it, rank 1 that another rank failed for
    good."""
    from pathlib import Path

    s0, s1 = (groups[2][r][SWEEP_FINAL]["summaries"][0] for r in (0, 1))
    assert s0["status"] == s1["status"] == "ERROR"
    assert "SchemaError" in s0["error"]
    assert "PeerFailure" in s1["error"] and "for good" in s1["error"]
    assert s0["rounds"] == s1["rounds"] == 1
    errors = (Path(s0["dir"]) / "error.txt").read_text()
    assert "attempt 1: SchemaError" in errors and "attempt 2" not in errors
