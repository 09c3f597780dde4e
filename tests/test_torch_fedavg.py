"""The port's driver (blades_tpu_torch/algorithms/, blades_tpu_torch/train.py)
against the JAX package's ``FedavgConfig`` / ``Fedavg``.

Both build the same numpy dataset (bit for bit, test subsample included)
from the reference's nested config keys; the result rows carry the same
keys (the JAX rows' compile-cache counters aside: the port has no
compile cache); synthetic MNIST with an MLP, 2 of 6 clients running ALIE
against Median, reaches test accuracy > 0.9 in 3 rounds, as the JAX
driver does.  Fields the port does not have yet raise.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu_torch.algorithms import FedavgConfig, get_algorithm_class

REPO = Path(__file__).resolve().parents[1]
MLP_RUN = {
    "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 8},
    "global_model": "mlp", "evaluation_interval": 3,
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
}
# The JAX driver's per-trial AOT compile-cache counters; the port
# compiles nothing ahead of time.
JAX_ONLY_KEYS = {"compile_cache_hits", "compile_cache_misses"}


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
        assert set(r) == set(jr) - JAX_ONLY_KEYS
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


@pytest.mark.parametrize("override,error", [
    ({"codec_config": {"type": "quant", "bits": 8}}, NotImplementedError),
    ({"num_devices": 4}, NotImplementedError),
    ({"client_config": {"clip_gradient_norm": 1.0}}, NotImplementedError),
    ({"execution": "dsharded"}, NotImplementedError),
    ({"adversary_config": {"type": "Noise"}}, NotImplementedError),
    ({"global_model": "cct"}, NotImplementedError),
    ({"no_such_field": 1}, KeyError),
    ({"dataset_config": {"no_such_key": 1}}, KeyError),
])
def test_fields_the_port_lacks_raise(override, error):
    with pytest.raises(error):
        cfg = FedavgConfig().update_from_dict({**MLP_RUN, **override})
        cfg.build(device="cpu")


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
        {**MLP_RUN, "rounds_per_dispatch": 1, "forensics": False})
    assert cfg.validate() is None
    with pytest.raises(NotImplementedError, match="client momentum"):
        FedavgConfig().update_from_dict(
            {**MLP_RUN, "execution": "streamed",
             "client_config": {"momentum": 0.9}}).validate()
    with pytest.raises(NotImplementedError):
        get_algorithm_class("FEDAVG_DP")


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
    rows = [json.loads(line) for line in
            (tmp_path / "fedavg_run" / "result.json").read_text().splitlines()]
    assert [r["training_iteration"] for r in rows] == [1, 2]
    assert "test_acc" in rows[1] and "best test_acc=" in out.stdout
