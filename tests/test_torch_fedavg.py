"""The port's driver (blades_tpu_torch/algorithms/, blades_tpu_torch/train.py)
against the JAX package's ``FedavgConfig`` / ``Fedavg``.

Both build the same numpy dataset (bit for bit, test subsample included)
from the reference's nested config keys; the result rows carry the same
keys (the JAX rows' compile-cache counters aside: the port has no
compile cache); synthetic MNIST with an MLP, 2 of 6 clients running ALIE
against Median, reaches test accuracy > 0.9 in 3 rounds, as the JAX
driver does.  Fields the port does not have yet raise.

The two drivers' rounds over three chained rounds (ALIE + Median, and
fedavg_dp.yaml's first MLP point), each side carrying its own state, on
JAX-drawn batches with the dropout masks and DP noise handed in: the
server parameters after each round within ``rtol=1e-5, atol=1e-6`` (f32
sums in other orders, as tests/test_torch_dense_round.py holds the MLP).
``rounds_per_dispatch=3`` is three single-round dispatches: the state bit
for bit, one row at stride 3 with the last round's scalars and the health
counts reduced over the three rounds as the JAX driver reduces them.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_dense_round import _jax_draws

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.algorithms import get_algorithm_class as jax_algorithm_class
from blades_tpu_torch.algorithms import FedavgConfig, get_algorithm_class
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import RoundState
from blades_tpu_torch.tune import run_experiments, verify_result_rounds

REPO = Path(__file__).resolve().parents[1]
MLP_RUN = {
    "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 8},
    "global_model": "mlp", "evaluation_interval": 3,
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
}


def test_driver_rows_and_accuracy_match_the_jax_driver():
    jalgo = JaxFedavgConfig().update_from_dict(MLP_RUN).build()
    algo = FedavgConfig().update_from_dict(MLP_RUN).build(device="cpu")
    try:
        jrows = [jalgo.train() for _ in range(3)]
        rows = [algo.train() for _ in range(3)]
    finally:
        jalgo.stop()
        algo.stop()
    for r, jr in zip(rows, jrows):
        assert set(r) == set(jr)
        assert set(r["timers"]) == set(jr["timers"])
    assert "test_acc" not in rows[0] and "test_acc" in rows[2]
    assert rows[2]["test_acc"] > 0.9 and jrows[2]["test_acc"] > 0.9
    assert rows[2]["train_loss"] < rows[0]["train_loss"]


def test_driver_data_equals_the_jax_drivers():
    """Training shards, malicious mask and the subsampled test shards
    (``evaluation_num_samples``) are the JAX driver's arrays."""
    run = {**MLP_RUN, "evaluation_num_samples": 5,
           "dataset_config": {"type": "fashionmnist", "num_clients": 8,
                              "iid": False, "alpha": 0.5, "seed": 3}}
    jalgo = JaxFedavgConfig().update_from_dict(run).build()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    for got, want in zip(algo._train, jalgo._train_arrays):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(algo._test, jalgo._test_arrays):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(algo.malicious.numpy(),
                                  np.asarray(jalgo.malicious))
    assert not algo.streamed
    jalgo.stop()
    algo.stop()


def test_streamed_execution_through_the_driver():
    """``execution='streamed'`` runs the streamed round (ALIE's dead
    malicious blocks elided) with the health check's row fields."""
    run = {**MLP_RUN, "execution": "streamed", "client_block": 2,
           "update_dtype": "float32", "health_check": True,
           "evaluation_interval": 1}
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    row = algo.train()
    assert algo.streamed
    assert row["elided_lanes"] == 2 and row["round_ok"] is True
    assert row["num_unhealthy"] == 0 and np.isfinite(row["test_acc"])
    algo.stop()


def test_client_momentum_and_training_attacks_run_dense():
    run = {**MLP_RUN, "client_config": {"momentum": 0.9},
           "adversary_config": {"type": "LabelFlip"},
           "evaluation_interval": 2}
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    rows = [algo.train() for _ in range(2)]
    assert not algo.streamed
    assert set(algo.state.client_opt) == set(algo.state.server.params)
    assert np.isfinite(rows[1]["test_loss"])
    algo.stop()


def test_client_momentum_runs_streamed():
    """``execution: streamed`` with client momentum: the traces advance for
    the trained lanes and stay zero for the two elided ALIE lanes."""
    run = {**MLP_RUN, "client_config": {"momentum": 0.9},
           "execution": "streamed", "client_block": 2,
           "evaluation_interval": 2}
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    rows = [algo.train() for _ in range(2)]
    assert algo.streamed and rows[1]["elided_lanes"] == 2
    traces = torch.cat([v.flatten(1) for v in
                        algo.state.client_opt.values()], 1)
    assert traces.shape[0] == 6
    assert not traces[:2].any() and bool((traces[2:] != 0).any(1).all())
    assert np.isfinite(rows[1]["test_acc"])
    algo.stop()


@pytest.mark.parametrize("override,error", [
    ({"bucket_size": 0}, ValueError),
    ({"num_devices": 4}, ValueError),  # a world of one process
    ({"mxu_finish": "counts"}, ValueError),
    ({"execution": "dsharded"}, NotImplementedError),
    ({"mesh_shape": [4, 2]}, ValueError),
    ({"preagg": "mean"}, ValueError),
    ({"no_such_field": 1}, KeyError),
    ({"dataset_config": {"no_such_key": 1}}, KeyError),
])
def test_fields_the_port_lacks_raise(override, error):
    with pytest.raises(error):
        cfg = FedavgConfig().update_from_dict({**MLP_RUN, **override})
        cfg.build(device="cpu")


@pytest.mark.parametrize("packing,pack_factor", [
    ("off", None), ("auto", None), (2, 2), (3, 3)])
def test_client_packing_is_accepted(packing, pack_factor):
    """``client_packing`` builds: ``"off"`` and an ineligible ``"auto"``
    (the MLP's 256-wide layer) run unpacked, a forced P packs."""
    cfg = FedavgConfig().update_from_dict(
        {**MLP_RUN, "client_packing": packing})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        algo = cfg.build(device="cpu")
    packing_spec = algo.fed_round.packing
    assert (None if packing_spec is None
            else packing_spec.pack) == pack_factor
    algo.stop()


def test_fluent_setters_build_the_same_config():
    """The builder surface sets the fields the nested dict sets."""
    fluent = (FedavgConfig().data(dataset="mnist", num_clients=6)
              .training(global_model="mlp", train_batch_size=8,
                        aggregator={"type": "Median"}, server_lr=1.0)
              .adversary(num_malicious_clients=2,
                         adversary_config={"type": "ALIE"})
              .evaluation(evaluation_interval=3)
              .client(lr=0.1).resources(execution="dense")
              .fault_tolerance(health_check=False))
    nested = FedavgConfig().update_from_dict({**MLP_RUN,
                                              "execution": "dense"})
    assert fluent.items() == nested.items()
    fluent.freeze()
    with pytest.raises(RuntimeError, match="frozen"):
        fluent.data(num_clients=3)


def test_reference_defaults_of_later_fields_are_accepted():
    """A later field set to the reference's own default changes nothing
    and is accepted (a YAML may spell defaults out)."""
    cfg = FedavgConfig().update_from_dict(
        {**MLP_RUN, "rounds_per_dispatch": 1, "autotune": False})
    assert cfg.validate() is None
    # Client momentum runs on the streamed round too.
    assert FedavgConfig().update_from_dict(
        {**MLP_RUN, "execution": "streamed",
         "client_config": {"momentum": 0.9}}).validate() is None
    cls, cfg = get_algorithm_class("FEDAVG_DP", return_config=True)
    assert cls is get_algorithm_class("FEDAVG")
    assert (cfg.dp_clip_threshold, cfg.dp_epsilon) == (1.0, 1.0)


def test_driver_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedavgConfig().update_from_dict(MLP_RUN).build()


def test_cli_run_on_the_cpu_exits_0(tmp_path):
    cmd = [sys.executable, "-m", "blades_tpu_torch.train", "run", "FEDAVG",
           "--rounds", "2", "--device", "cpu", "--storage-path",
           str(tmp_path), "--config-json",
           json.dumps({**MLP_RUN, "evaluation_interval": 2})]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    # The JAX command's layout: <storage>/<algo>_run/<algo>_run_00000/.
    rows = [json.loads(line) for line in
            (tmp_path / "fedavg_run" / "fedavg_run_00000" / "result.json")
            .read_text().splitlines()]
    assert [r["training_iteration"] for r in rows] == [1, 2]
    assert "test_acc" in rows[1]
    assert "best trial: fedavg_run_00000 test_acc=" in out.stdout


DP_POINT = {  # fedavg_dp.yaml's first grid point
    "dataset_config": {"type": "mnist", "num_clients": 60, "seed": 121},
    "global_model": "mlp", "evaluation_interval": 50, "dp_epsilon": 1.0,
    "dp_delta": 1.0e-6, "dp_clip_threshold": 1.0,
    "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}},
}


@pytest.mark.parametrize("run,config", [("FEDAVG", MLP_RUN),
                                        ("FEDAVG_DP", DP_POINT)],
                         ids=["alie-median", "fedavg_dp"])
def test_three_chained_rounds_match_the_jax_driver(run, config):
    _, jcfg = jax_algorithm_class(run, return_config=True)
    jalgo = jcfg.update_from_dict(config).build()
    _, cfg = get_algorithm_class(run, return_config=True)
    algo = cfg.update_from_dict(config).build(device="cpu")
    jfr, fr = jalgo.fed_round, algo.fed_round
    n = config["dataset_config"]["num_clients"]
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n))
    jstep = jax.jit(jfr.step_prebatched)
    d = sum(p.numel() for p in params.values())
    x, y, lengths = jalgo._train_arrays
    for key in jax.random.split(jax.random.PRNGKey(9), 3):
        bx, by = jfr.sample_round_batches(x, y, lengths, key)
        masks, _ = _jax_draws(key, n, fr.num_batches_per_round,
                              fr.batch_size, fr.task.model, None)
        dp_noise = None
        if fr.dp_clip_threshold is not None:
            dp_noise = torch.from_numpy(np.array(jax.random.normal(
                jax.random.split(key, 5)[4], (n, d), jnp.float32)))
        jstate, jm = jstep(jstate, bx, by, jalgo.malicious, key)
        state, m = fr.step_prebatched(
            state, torch.from_numpy(np.array(bx)),
            torch.from_numpy(np.array(by)).long(), algo.malicious,
            dropout_masks=masks, dp_noise=dp_noise)
        np.testing.assert_allclose(
            ravel_pytree(params_to_jax(state.server.params))[0],
            ravel_pytree(jstate.server.params)[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(m["agg_norm"]), float(jm["agg_norm"]),
                                   rtol=1e-5, atol=1e-6)
    jalgo.stop()
    algo.stop()


def test_rounds_per_dispatch_is_sequential_rounds(tmp_path):
    run = {**MLP_RUN, "health_check": True, "evaluation_interval": 2,
           "server_config": {**MLP_RUN["server_config"],
                             "lr_schedule": [[0, 1.0], [3, 0.5]]}}
    single = FedavgConfig().update_from_dict(run).build(device="cpu")
    chunked = FedavgConfig().update_from_dict(
        {**run, "rounds_per_dispatch": 3}).build(device="cpu")
    rows = [single.train() for _ in range(3)]
    row = chunked.train()
    for k, v in single.state.server.params.items():
        assert torch.equal(v, chunked.state.server.params[k])
    assert chunked.state.server.opt_state["count"] == 3  # lr stepped a round
    assert row["training_iteration"] == chunked.iteration == 3
    for k in ("train_loss", "agg_norm", "update_norm_mean"):
        assert row[k] == rows[-1][k]
    assert row["num_unhealthy"] == sum(r["num_unhealthy"] for r in rows)
    assert row["round_ok"] is all(r["round_ok"] for r in rows)
    # Rounds since the last evaluation: 3 >= 2 evaluates at round 3.
    assert "test_acc" in row and "test_acc" in rows[1]
    single.stop()
    chunked.stop()
    exps = {"rpd": {"run": "FEDAVG", "stop": {"training_iteration": 6},
                    "config": {**run, "rounds_per_dispatch": 3}}}
    (summary,) = run_experiments(exps, storage_path=str(tmp_path),
                                 verbose=0, device="cpu")
    assert summary["rounds"] == 6
    assert verify_result_rounds(tmp_path / "rpd" / "rpd_00000"
                                / "result.json") == [3, 6]


def test_dispatch_rows_reduce_health_counts_as_the_jax_driver():
    """A three-round dispatch's metrics with a lane unhealthy mid-dispatch
    and the last round healthy, finalized by both drivers."""
    from blades_tpu.perf.async_metrics import DEVICE_METRICS_KEY as JKEY
    from blades_tpu_torch.utils.async_metrics import DEVICE_METRICS_KEY

    run = {**MLP_RUN, "health_check": True}
    jalgo = JaxFedavgConfig().update_from_dict(run).build()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    raw = {"train_loss": [2.0, 1.5, 1.25], "agg_norm": [0.5, 0.25, 0.125],
           "update_norm_mean": [1.0, 0.75, 0.5], "num_unhealthy": [0, 2, 0],
           "round_ok": [True, False, True]}
    got = algo.finalize_row({"training_iteration": 3, DEVICE_METRICS_KEY: {
        k: [torch.tensor(v) for v in vs] for k, vs in raw.items()}})
    want = jalgo.finalize_row({"training_iteration": 3, JKEY: {
        k: np.asarray(vs) for k, vs in raw.items()}})
    for k in ("train_loss", "agg_norm", "update_norm_mean", "num_unhealthy",
              "round_ok"):
        assert got[k] == want[k], k
    assert (got["num_unhealthy"], got["round_ok"]) == (2, False)
    jalgo.stop()
    algo.stop()
