"""The campaign adversaries (blades_tpu_torch/adversaries/campaigns.py)
against the JAX package's: DiurnalALIE and LazyRamp forge the same rows
given the same updates, malicious mask, arrival ticks and (LazyRamp's)
camouflage normals -- f32 benign statistics in other orders, ``rtol=1e-5,
atol=1e-6`` -- including the SignGuard half-negation; both need
``execution='async'``, and both run through the async driver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.adversaries import get_adversary as jax_get_adversary
from blades_tpu.ops.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu_torch.adversaries import (
    DiurnalALIECampaign,
    LazyRampCampaign,
    get_adversary,
)
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.ops.aggregators import get_aggregator

K, D = 10, 37
TICKS = np.array([0, 3, 4, 7, 8, 11, 12, 15, 30, 33], np.int32)


def _inputs():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(K, D)).astype(np.float32)
    mal = np.zeros(K, bool)
    mal[[0, 2, 3, 7]] = True
    return u, mal


@pytest.mark.parametrize("spec", [
    {"type": "DiurnalALIE", "period": 8},
    {"type": "DiurnalALIE", "period": 8, "duty": 0.25, "low": 0.5,
     "high": 2.0, "phase": 3},
    {"type": "LazyRamp", "ramp": [[0, 0.0], [4, 0.5], [12, 1.0]]},
    {"type": "LazyRamp", "ramp": [[0, 0.25], [8, 0.75]], "copy_scale": 0.5,
     "noise_std": 0.1},
], ids=["diurnal", "diurnal-phase", "ramp", "ramp-scaled"])
@pytest.mark.parametrize("aggregator", ["Median", "Signguard"])
def test_campaign_forges_match_the_jax_package(spec, aggregator):
    u, mal = _inputs()
    ctx = dict(num_clients=40, num_byzantine=4)
    jadv = jax_get_adversary(dict(spec), **ctx)
    adv = get_adversary(dict(spec), **ctx)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (K, D), jnp.float32))
    want = np.asarray(jadv.on_updates_ready(
        jnp.asarray(u), jnp.asarray(mal), key,
        aggregator=jax_get_aggregator(aggregator, num_byzantine=4),
        ticks=jnp.asarray(TICKS)))
    got = adv.on_updates_ready(
        torch.from_numpy(u), torch.from_numpy(mal),
        noise=torch.from_numpy(noise),
        aggregator=get_aggregator(aggregator, num_byzantine=4),
        ticks=torch.from_numpy(TICKS)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[~mal], u[~mal])
    assert adv.wants_ticks and adv.requires_virtual_time


def test_schedules_switch_at_their_ticks():
    u, mal = _inputs()
    diurnal = DiurnalALIECampaign(num_clients=40, num_byzantine=4, period=8,
                                  low=0.0)
    out = diurnal.on_updates_ready(torch.from_numpy(u),
                                   torch.from_numpy(mal),
                                   ticks=torch.from_numpy(TICKS))
    mean = torch.from_numpy(u[~mal].mean(0))
    # Lane 3 arrived at tick 7, off-peak (7 mod 8 >= 4): low=0 sends the
    # benign mean; lane 0 arrived at tick 0, in the peak.
    torch.testing.assert_close(out[3], mean, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(out[0], mean)
    ramp = LazyRampCampaign(num_clients=40, num_byzantine=4,
                            ramp=((0, 0.0), (4, 1.0)), noise_std=0.0)
    out = ramp.on_updates_ready(torch.from_numpy(u), torch.from_numpy(mal),
                                ticks=torch.from_numpy(TICKS))
    # Lane 0 arrived before tick 4 and ships its honest row; lanes 2, 3
    # and 7 arrived from tick 4 on and copy the benign mean.
    np.testing.assert_array_equal(out.numpy()[0], u[0])
    for lane in (2, 3, 7):
        torch.testing.assert_close(out[lane], mean, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="start at tick 0"):
        LazyRampCampaign(ramp=((3, 0.5),))
    with pytest.raises(ValueError, match="strictly increasing"):
        LazyRampCampaign(ramp=((0, 0.5), (0, 0.7)))
    with pytest.raises(ValueError, match="in \\[0, 1\\]"):
        LazyRampCampaign(ramp=((0, 1.5),))
    with pytest.raises(ValueError, match="period"):
        DiurnalALIECampaign(period=1)
    with pytest.raises(ValueError, match="duty"):
        DiurnalALIECampaign(duty=1.0)


MLP_ASYNC = {
    "dataset_config": {"type": "mnist", "num_clients": 8, "train_bs": 8},
    "global_model": "mlp", "execution": "async",
    "async_config": {"rate": 0.4, "agg_every": 5, "staleness_cap": 3},
    "num_malicious_clients": 2, "evaluation_interval": 2,
    "server_config": {"lr": 1.0, "aggregator": {"type": "Trimmedmean",
                                                "num_byzantine": 1}},
}


@pytest.mark.parametrize("adversary", [
    {"type": "DiurnalALIE", "period": 4},
    {"type": "LazyRamp", "ramp": [[0, 0.0], [2, 1.0]]},
])
def test_campaigns_need_async_and_run_through_the_driver(adversary):
    run = {**MLP_ASYNC, "adversary_config": adversary}
    with pytest.raises(ValueError, match="virtual arrival time"):
        FedavgConfig().update_from_dict(
            {**run, "execution": "dense", "async_config": None}).validate()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    rows = [algo.train() for _ in range(2)]
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    assert np.isfinite(rows[-1]["test_acc"])
    algo.stop()
