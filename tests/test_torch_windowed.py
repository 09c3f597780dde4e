"""The port's participation-window rounds (``state_window``, the driver's
``_windowed_round`` over blades_tpu_torch/state/) against the JAX
package's:

- three windowed rounds of the port's driver (its store, prefetcher and
  write-back) on the JAX driver's cohort ids, batches and dropout masks,
  handed in: server parameters within ``rtol=1e-5, atol=1e-6`` after every
  round, and every registered client's store rows (the momentum traces,
  and under top-k + error feedback the residuals that round-trip through
  the store) within the same tolerance at the end;
- ``state_window=0`` (stateless clients) against the JAX round;
- a windowed run on the disk store and the memmap data store, killed
  after round 2 and resumed from its shard checkpoint, bit-identical to a
  straight run;
- every ``validate()`` refusal of the window and the stores, by name.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_dense_round import _jax_draws

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.state import sample_cohort as jax_sample_cohort
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import RoundState
from blades_tpu_torch.tune import run_experiments, verify_result_rounds

N, W = 8, 4
WINDOWED = {
    "dataset_config": {"type": "mnist", "num_clients": N, "train_bs": 8,
                       "seed": 3},
    "global_model": "mlp", "client_config": {"lr": 0.1, "momentum": 0.9},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}},
    "num_malicious_clients": 1, "adversary_config": {"type": "ALIE"},
    "state_window": W, "evaluation_interval": 0,
}


def _flat(params):
    return np.asarray(ravel_pytree(params_to_jax(params))[0])


@pytest.mark.parametrize("extra", [
    {},
    {"server_config": {"lr": 1.0, "aggregator": {"type": "Median"}}},
    {"codec_config": {"type": "topk", "topk_ratio": 0.05}},
], ids=["mean", "median", "topk-ef"])
def test_windowed_rounds_match_the_jax_driver(extra):
    run = {**WINDOWED, "state_store": "host", **extra}
    jalgo, algo = _lockstep_windowed(run)
    for r in range(3):
        _check_round(jalgo, algo, jalgo.train(), algo.train())
    jalgo._state_pf.flush()
    algo._state_pf.flush()
    jrows = jalgo._state_store.gather(np.arange(N))
    rows = algo._state_store.gather(np.arange(N))
    trace = jrows["client_opt"][0].trace
    want = np.stack([np.asarray(ravel_pytree(jax.tree.map(
        lambda t: t[i], trace))[0]) for i in range(N)])
    np.testing.assert_allclose(rows["client_opt"].numpy(), want, rtol=1e-5,
                               atol=1e-6)
    if "codec_config" in extra:
        res = np.asarray(jrows["residual"])
        assert np.abs(res).sum() > 0
        np.testing.assert_allclose(rows["residual"].numpy(), res,
                                   rtol=1e-5, atol=1e-6)
    jalgo.stop()
    algo.stop()


def _lockstep_windowed(run):
    """Both drivers built from ``run``, the port's cohorts, batches and
    dropout masks the JAX driver's (drawn one round ahead), the port's
    initial parameters the JAX package's."""
    jalgo = JaxFedavgConfig().update_from_dict(run).build()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    fr, jfr = algo.fed_round, jalgo.fed_round
    # The JAX driver's round keys, cohorts and draws, one round ahead.
    keys, k = [], jalgo._key
    for _ in range(4):
        rk, k = jax.random.split(k)
        keys.append(rk)
    ids = [np.asarray(jax_sample_cohort(rk, N, W)) for rk in keys]
    x, y, ln = jalgo._host_train
    draws = []
    for rk, c in zip(keys, ids):
        bx, by = jfr.sample_round_batches(x[c], y[c], ln[c], rk)
        masks, _ = _jax_draws(rk, W, fr.num_batches_per_round,
                              fr.batch_size, fr.task.model, None)
        draws.append((torch.from_numpy(np.array(bx)),
                      torch.from_numpy(np.array(by)).long(), masks))
    algo._state_pf._cohort = lambda r: ids[r]

    def step(state, cx, cy, cln, mal, seed):
        bx, by, masks = draws[algo.iteration]
        return fr.step_prebatched(state, bx, by, mal, dropout_masks=masks)

    algo._step = step
    params = params_from_jax(jax.tree.map(np.asarray,
                                          jalgo.state.server.params))
    algo.state = RoundState(server=fr.server.init(params, W))
    return jalgo, algo


def _check_round(jalgo, algo, jrow, row):
    """One round of the pair: the cohort, the parameters and the loss."""
    np.testing.assert_array_equal(np.asarray(jalgo._window_prev[0]),
                                  algo._window_prev[0])
    np.testing.assert_allclose(
        _flat(algo.state.server.params),
        np.asarray(ravel_pytree(jalgo.state.server.params)[0]),
        rtol=1e-5, atol=1e-6)
    assert row["train_loss"] == pytest.approx(jrow["train_loss"],
                                              rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("aggregator", [
    {"type": "Median"}, {"type": "Multikrum", "k": 2}],
    ids=["median", "multikrum"])
def test_forensic_windowed_rounds_match_the_jax_driver(aggregator):
    """The windowed round's cohort forensics and ledger fold against the
    JAX driver's, 3 rounds of cohorts of 4 of 8 with the resident
    ledger: ``lane_forensics`` (lane i diagnoses registered client
    ``clients[i]``, the sampled cohort), the detection scalars and the
    ledger's round fields.  Masks, client ids, counts and detection
    scalars exactly; scores, update norms and the ledger's floats within
    ``rtol=1e-5, atol=1e-6``."""
    tol = dict(rtol=1e-5, atol=1e-6)
    run = {**WINDOWED, "state_store": "host", "forensics": True,
           "ledger": True,
           "server_config": {"lr": 1.0, "aggregator": aggregator}}
    jalgo, algo = _lockstep_windowed(run)
    flagged = 0
    for r in range(3):
        jrow, row = jalgo.train(), algo.train()
        _check_round(jalgo, algo, jrow, row)
        got, want = row["lane_forensics"], jrow["lane_forensics"]
        assert got["clients"] == [int(c) for c in jalgo._window_prev[0]]
        for k in ("benign_mask", "healthy", "clients"):
            assert got[k] == list(want[k]), k
        for k in ("scores", "update_norms"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
        ledger_keys = set(algo.client_ledger.round_fields())
        assert ledger_keys <= set(row)
        for k in ("byz_precision", "byz_recall", "byz_fpr", "num_flagged",
                  "num_unhealthy", *sorted(ledger_keys)):
            if isinstance(jrow[k], float):
                np.testing.assert_allclose(row[k], jrow[k], err_msg=k,
                                           **tol)
            else:
                assert row[k] == jrow[k], k
        flagged += row["num_flagged"]
    assert (flagged > 0) == (aggregator["type"] != "Median")
    jalgo.stop()
    algo.stop()


def test_stateless_window_0_matches_the_jax_round():
    run = {**WINDOWED, "state_window": 0}
    jalgo = JaxFedavgConfig().update_from_dict(run).build()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    fr, jfr = algo.fed_round, jalgo.fed_round
    assert fr.stateless_clients and algo._state_store is None
    jstate = jalgo.state
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, N),
                       client_opt=fr.task.init_client_opt_state(params, N))
    x, y, ln = jalgo._train_arrays
    step = jax.jit(jfr.step_prebatched)
    for key in jax.random.split(jax.random.PRNGKey(4), 2):
        bx, by = jfr.sample_round_batches(x, y, ln, key)
        masks, _ = _jax_draws(key, N, fr.num_batches_per_round,
                              fr.batch_size, fr.task.model, None)
        jstate, _ = step(jstate, bx, by, jalgo.malicious, key)
        state, _ = fr.step_prebatched(
            state, torch.from_numpy(np.array(bx)),
            torch.from_numpy(np.array(by)).long(), algo.malicious,
            dropout_masks=masks)
        np.testing.assert_allclose(
            _flat(state.server.params),
            np.asarray(ravel_pytree(jstate.server.params)[0]),
            rtol=1e-5, atol=1e-6)
    jalgo.stop()
    algo.stop()


def _experiments(tmp_path, tag):
    cfg = {**WINDOWED, "state_store": "disk", "data_store": "memmap",
           "state_dir": str(tmp_path / tag / "live"),
           "data_dir": str(tmp_path / "shards"), "eval_chunk_clients": 3,
           "evaluation_interval": 2}
    return {"win": {"run": "FEDAVG", "stop": {"training_iteration": 4},
                    "config": cfg}}


def test_windowed_kill_and_resume_is_bit_identical(tmp_path):
    straight = tmp_path / "straight"
    run_experiments(_experiments(tmp_path, "a"), storage_path=str(straight),
                    verbose=0, device="cpu")
    resumed = tmp_path / "resumed"
    (summary,) = run_experiments(
        _experiments(tmp_path, "b"), storage_path=str(resumed), verbose=0,
        checkpoint_freq=1, preempt_after=2, max_failures=1,
        retry_backoff_base=0.0, device="cpu")
    assert "status" not in summary and summary["rounds"] == 4
    assert summary["state_store"]["backend"] == "disk"
    assert summary["state_store"]["window"] == W
    assert summary["data_store"]["eval_chunks"] == 3
    paths = [p / "win" / "win_00000" / "result.json"
             for p in (straight, resumed)]
    assert verify_result_rounds(paths[1]) == [1, 2, 3, 4]
    ckpt = resumed / "win" / "win_00000" / "ckpt_000002" / "client_state"
    assert (ckpt / "manifest.json").exists()
    import json

    rows = [[json.loads(line) for line in p.read_text().splitlines()]
            for p in paths]
    for a, b in zip(*rows):
        for k in ("train_loss", "agg_norm", "update_norm_mean"):
            assert a[k] == b[k], (a["training_iteration"], k)
    assert rows[1][3]["eval_chunks"] == 3
    assert rows[1][3]["test_acc"] == rows[0][3]["test_acc"]


@pytest.mark.parametrize("override,match", [
    ({"state_store": "host", "state_window": None}, "needs a participation"),
    ({"state_store": "tape"}, "state_store must be"),
    ({"state_window": -1}, "state_window must be"),
    ({"state_window": 0, "state_store": "host"}, "STATELESS"),
    ({"state_window": 0, "codec_config": {"type": "topk"}}, "error-feedback"),
    ({"state_window": 0, "execution": "streamed"}, "dense round only"),
    ({"state_window": 9}, "num_clients"),
    ({"execution": "streamed"}, "no windowed formulation"),
    ({"fault_config": {"dropout_rate": 0.1}}, "fault injection"),
    ({"codec_config": {"type": "quant"}, "agg_domain": "wire"},
     "wire-domain"),
    ({"rounds_per_dispatch": 2}, "rounds_per_dispatch"),
    ({"state_window": None, "data_store": "memmap"}, "per-cohort staging"),
    ({"data_store": "tape"}, "data_store must be"),
    ({"data_dir": "/nowhere"}, "data_dir is set"),
    ({"eval_chunk_clients": 0}, "eval_chunk_clients"),
])
def test_validate_refuses_what_the_jax_package_refuses(override, match):
    run = {**WINDOWED, **override}
    for cls in (FedavgConfig, JaxFedavgConfig):
        with pytest.raises(ValueError, match=match):
            cls().update_from_dict(run).validate()


def test_prefetch_values():
    for ok in ("auto", True, False, "on", "off"):
        FedavgConfig().update_from_dict({**WINDOWED, "prefetch": ok}
                                        ).validate()
    with pytest.raises(ValueError, match="prefetch"):
        FedavgConfig().update_from_dict({**WINDOWED, "prefetch": "eager"}
                                        ).validate()
