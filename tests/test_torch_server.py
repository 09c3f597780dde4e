"""The port's server, health guard, adversaries, sampler and masked
reductions against the JAX reference on the same numpy-made inputs.

Tolerance ``rtol=1e-6, atol=1e-7`` where both sides run the same f32
arithmetic in possibly different orders (the benign statistics, the
optimizer's momentum); the forges' scalars (``z_max``, the schedule's
values) are Python floats on both sides and compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.adversaries.base import benign_mean_std as jax_benign_stats
from blades_tpu.core import Server as JaxServer
from blades_tpu.core.health import sanitize_updates as jax_sanitize
from blades_tpu.core.server import lr_schedule as jax_schedule
from blades_tpu.ops import masked as jax_masked
from blades_tpu_torch.adversaries import get_adversary
from blades_tpu_torch.adversaries.base import benign_mean_std
from blades_tpu_torch.core import Server
from blades_tpu_torch.core.health import guard_server_state, sanitize_updates
from blades_tpu_torch.core.server import lr_schedule
from blades_tpu_torch.data.sampler import gather_batches, sample_batch_indices
from blades_tpu_torch.ops import masked

RTOL, ATOL = 1e-6, 1e-7


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _matrix(seed, n=9, d=40):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    mal = np.arange(n) < 3
    return x, mal


@pytest.mark.parametrize("points", [None, [[0, 0.5], [4, 0.1], [10, 0.3]],
                                    [[3, 0.2], [6, 0.0]]])
def test_lr_schedule_matches_optax(points):
    want = jax_schedule(0.5, points)
    got = lr_schedule(0.5, points)
    for count in range(14):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6)


@pytest.mark.parametrize("momentum,dampening,weight_decay,points", [
    (0.0, 0.0, 0.0, None),
    (0.9, 0.1, 0.0, None),
    (0.5, 0.0, 0.01, [[0, 1.0], [2, 0.5]]),
])
def test_apply_aggregate_matches_jax(momentum, dampening, weight_decay,
                                     points):
    rng = np.random.default_rng(4)
    params = {"Dense_0": {"bias": rng.normal(size=(3,)).astype(np.float32),
                          "kernel": rng.normal(size=(4, 3)).astype(np.float32)}}
    kw = dict(lr=0.5, momentum=momentum, dampening=dampening,
              weight_decay=weight_decay, lr_schedule_points=points)
    jserver = JaxServer.from_config("Mean", **kw)
    server = Server.from_config("Mean", **kw)
    jstate = jserver.init(jax.tree.map(jnp.asarray, params), 4)
    state = server.init({"Dense_0.bias": torch.from_numpy(
        params["Dense_0"]["bias"]), "Dense_0.weight": torch.from_numpy(
        params["Dense_0"]["kernel"].T.copy())}, 4)
    for step in range(3):
        agg = rng.normal(size=(15,)).astype(np.float32)
        jstate = jserver.apply_aggregate(jstate, jnp.asarray(agg))
        state = server.apply_aggregate(state, torch.from_numpy(agg))
        _close(state.params["Dense_0.bias"], jstate.params["Dense_0"]["bias"])
        _close(state.params["Dense_0.weight"].T,
               jstate.params["Dense_0"]["kernel"])
        assert state.round == int(jstate.round) == step + 1


def test_health_sanitize_and_guard():
    x, _ = _matrix(1)
    x[2, 5] = np.nan
    x[6, 0] = -np.inf
    part = np.ones(9, bool)
    part[6] = False
    clean, healthy = sanitize_updates(torch.from_numpy(x),
                                      torch.from_numpy(part))
    jclean, jhealthy = jax_sanitize(jnp.asarray(x), jnp.asarray(part))
    np.testing.assert_array_equal(clean.numpy(), np.asarray(jclean))
    np.testing.assert_array_equal(healthy.numpy(), np.asarray(jhealthy))
    old = Server.from_config("Mean").init({"Dense_0.bias": torch.zeros(2)}, 2)
    new = Server.from_config("Mean").apply_aggregate(old, torch.ones(2))
    kept = guard_server_state(torch.tensor(False), new, old)
    assert torch.equal(kept.params["Dense_0.bias"], old.params["Dense_0.bias"])
    assert kept.round == new.round == 1
    assert guard_server_state(torch.tensor(True), new, old) is new


def test_benign_stats_ignore_nonfinite_malicious_rows():
    x, mal = _matrix(2)
    x[0, :] = np.nan  # a malicious row that diverged
    mean, std = benign_mean_std(torch.from_numpy(x), torch.from_numpy(mal))
    jmean, jstd = jax_benign_stats(jnp.asarray(x), jnp.asarray(mal))
    _close(mean, jmean)
    _close(std, jstd)
    assert bool(torch.isfinite(mean).all() and torch.isfinite(std).all())


@pytest.mark.parametrize("spec", ["ALIE", {"type": "IPM", "scale": 3.0},
                                  {"type": "Adaptive", "b": 2.0}])
def test_forges_match_jax(spec):
    x, mal = _matrix(3)
    n, f = 9, 3
    jadv = jax_adversary(spec, num_clients=n, num_byzantine=f)
    adv = get_adversary(spec, num_clients=n, num_byzantine=f)
    key = jax.random.PRNGKey(5)
    want = jadv.on_updates_ready(jnp.asarray(x), jnp.asarray(mal), key)
    # The Adaptive forge's uniforms: the reference's draw, passed in.
    noise = torch.from_numpy(np.array(
        jax.random.uniform(key, (x.shape[1],), jnp.float32)))
    got = adv.on_updates_ready(torch.from_numpy(x), torch.from_numpy(mal),
                               noise=noise)
    _close(got, want)
    if spec == "ALIE":
        assert adv.z_max == jadv.z_max


def test_alie_z_max_at_the_headline_scale():
    jadv = jax_adversary("ALIE", num_clients=1000, num_byzantine=250)
    adv = get_adversary("ALIE", num_clients=1000, num_byzantine=250)
    assert adv.z_max == jadv.z_max


def test_masked_reductions_match_jax():
    x, mal = _matrix(6, n=10)
    sel = ~mal
    for fn, jfn in ((masked.masked_mean, jax_masked.masked_mean),
                    (masked.masked_median, jax_masked.masked_median)):
        _close(fn(torch.from_numpy(x), torch.from_numpy(sel)),
               jfn(jnp.asarray(x), jnp.asarray(sel)))
        empty = np.zeros(10, bool)  # degrades to every row
        _close(fn(torch.from_numpy(x), torch.from_numpy(empty)),
               jfn(jnp.asarray(x), jnp.asarray(empty)))
    np.testing.assert_array_equal(masked.median(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_masked.median(jnp.asarray(x))))


def test_sampler_draws_within_each_shard():
    gen = torch.Generator().manual_seed(0)
    lengths = torch.tensor([5, 1, 0, 8])
    idx = sample_batch_indices(gen, lengths, batch_size=64, num_batches=3)
    assert idx.shape == (4, 3, 64) and idx.dtype == torch.int64
    assert bool((idx >= 0).all())
    for i, ln in enumerate(lengths.tolist()):
        assert int(idx[i].max()) < max(ln, 1)
    assert set(idx[0].flatten().tolist()) == set(range(5))
    x = torch.arange(4 * 8).reshape(4, 8, 1).float()
    y = torch.arange(4 * 8).reshape(4, 8)
    bx, by = gather_batches(x, y, idx)
    assert bx.shape == (4, 3, 64, 1)
    assert torch.equal(by, idx + 8 * torch.arange(4)[:, None, None])
