"""The port's buffered-async execution (blades_tpu_torch/arrivals/) against
the JAX package's (blades_tpu/arrivals/).

- staleness weights and the row scale: ``constant`` bit-equal, the other
  schedules within ``rtol=1e-6`` (f32 ``pow`` / division in two
  libraries);
- the bounded buffer and the engine's bookkeeping on JAX's realized
  arrival windows, handed in: the same events, versions, staleness and
  counters, exactly;
- one and three chained cycles against JAX's ``build_cycle`` with the
  events, batches, dropout masks and forge noise handed in (Median +
  ALIE, with client momentum too; Mean + Lazy replay; Median +
  DiurnalALIE and Mean + LazyRamp, which take the events' ticks):
  parameters and the params ring within ``rtol=1e-5, atol=1e-6`` after
  every cycle (f32 sums in other orders);
- ``step_buffered`` under ``constant`` bit-equal to ``step``;
  today's shared-parameter block bit for bit the written-out shared
  computation, and per-lane parameters on identical lanes equal to it to
  f32 rounding;
- the driver: rows carry the async digest, kill-and-resume replays bit
  for bit, and ``validate()`` refuses what the JAX package refuses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.arrivals import ArrivalEvent as JaxEvent
from blades_tpu.arrivals import UpdateBuffer as JaxBuffer
from blades_tpu.arrivals import normalized_row_scale as jax_row_scale
from blades_tpu.arrivals import staleness_weights as jax_weights
from blades_tpu.arrivals.cycle import cycle_agg_key, event_train_key
from blades_tpu.data.sampler import sample_batch
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.arrivals import (
    ArrivalEvent,
    ArrivalProcess,
    AsyncEngine,
    AsyncSpec,
    UpdateBuffer,
    expected_arrivals_per_sec,
    normalized_row_scale,
    size_for_target,
    staleness_weights,
)
from blades_tpu_torch.arrivals.cycle import init_history
from blades_tpu_torch.convert import async_state_from_jax, params_from_jax
from blades_tpu_torch.core import RoundState, Server
from blades_tpu_torch.core.task import TaskSpec

N = 8
ASYNC_RUN = {
    "dataset_config": {"type": "mnist", "num_clients": N, "train_bs": 8,
                       "seed": 7},
    "global_model": "mlp", "execution": "async",
    "async_config": {"rate": 0.4, "agg_every": 4, "staleness_cap": 3},
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
    "evaluation_interval": 3,
}


def _flat(params):
    from blades_tpu_torch.utils.tree import FlatLayout

    return FlatLayout(params).ravel(params).numpy()


@pytest.mark.parametrize("schedule", ["constant", "polynomial", "inverse",
                                      "cutoff"])
def test_staleness_weights_and_row_scale_match_the_jax_package(schedule):
    k = np.array([0, 1, 2, 3, 5, 8, 13, 40], np.int32)
    kw = dict(power=0.7, cutoff=5)
    want = np.asarray(jax_weights(schedule, jnp.asarray(k), **kw))
    got = staleness_weights(schedule, torch.from_numpy(k), **kw)
    scale = normalized_row_scale(got).numpy()
    want_scale = np.asarray(jax_row_scale(jnp.asarray(want)))
    if schedule == "constant":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(scale, want_scale)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(scale, want_scale, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown staleness"):
        staleness_weights("linear", torch.zeros(2))


def test_buffer_matches_the_jax_buffer_on_random_traffic():
    rng = np.random.default_rng(0)
    ours, ref = UpdateBuffer(6), JaxBuffer(6)
    for step in range(300):
        if rng.random() < 0.8:
            ev = (int(rng.integers(0, 9)), step, int(rng.integers(0, 4)),
                  bool(rng.random() < 0.2))
            assert ours.push(ArrivalEvent(*ev)) == ref.push(JaxEvent(*ev))
        else:
            k = int(rng.integers(1, 5))
            if ref.unique_clients() >= k:
                assert ours.take_cycle(k) == [tuple(e) for e in
                                              ref.take_cycle(k)]
            else:
                with pytest.raises(ValueError, match="unique-client"):
                    ours.take_cycle(k)
        assert ours.state() == ref.state()
    restored = UpdateBuffer(6)
    restored.restore(ours.state())
    assert restored.state() == ours.state()
    with pytest.raises(ValueError, match="capacity"):
        UpdateBuffer(1).restore(ours.state() + [[0, 0, 0, False]] * 6)


def test_arrival_process_is_pure_in_seed_and_tick():
    p = ArrivalProcess(seed=3, rate=0.5)
    a = p.arrivals_at(17, 16)
    assert torch.equal(a, ArrivalProcess(seed=3, rate=0.5).arrivals_at(17,
                                                                       16))
    assert not torch.equal(a, p.arrivals_at(18, 16))
    assert not torch.equal(a, ArrivalProcess(seed=4, rate=0.5)
                           .arrivals_at(17, 16))
    torch.rand(4)  # the global generator never enters a realization
    assert torch.equal(a, p.arrivals_at(17, 16))
    win = p.arrivals_window(5, 6, 12)
    assert torch.equal(win, torch.stack([p.arrivals_at(5 + t, 12)
                                         for t in range(6)]))
    sched = ArrivalProcess(rate=0.2, rate_schedule=((20, 0.05), (10, 0.9)))
    assert sched.rate_schedule == ((10, 0.9), (20, 0.05))
    assert [sched.rate_at(t) for t in (0, 10, 19, 25)] == pytest.approx(
        [0.2, 0.9, 0.9, 0.05])
    slow = ArrivalProcess(rate=0.8, slow_fraction=0.5, slow_factor=0.25)
    rates = slow.client_rates(0, 8)
    assert torch.allclose(rates[:4], torch.tensor(0.8)) and torch.allclose(
        rates[4:], torch.tensor(0.2))
    w = slow.arrivals_window(0, 200, 8).float()
    assert w[:, :4].mean() > 2.5 * w[:, 4:].mean()
    for bad in (dict(rate=0.0), dict(slow_factor=1.5),
                dict(rate_schedule=((5, 1.7),))):
        with pytest.raises(ValueError):
            ArrivalProcess(**bad)


def _engines(faults=None, **arrivals):
    run = {**ASYNC_RUN, "async_config": {**ASYNC_RUN["async_config"],
                                         **arrivals}}
    if faults:
        run["fault_config"] = faults
    jalgo = JaxFedavgConfig().update_from_dict(run).build()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    jeng = jalgo._async

    def realize(tick0):
        return tuple(np.asarray(a) for a in jax.device_get(
            jeng._realize(tick0)))

    eng = AsyncEngine(algo.fed_round, algo.config.get_async_spec(), N,
                      train_seed=7, fault_injector=algo.fed_round.faults,
                      arrival_realization=realize)
    return jalgo, algo, jeng, eng


@pytest.mark.parametrize("faults", [None, {"dropout_rate": 0.3,
                                           "corrupt_rate": 0.2}],
                         ids=["clean", "dropout+corruption"])
def test_engine_bookkeeping_on_the_jax_realization(faults):
    jalgo, algo, jeng, eng = _engines(faults, buffer_capacity=5,
                                      rate=0.6, slow_fraction=0.25)
    for _ in range(6):
        jeng.advance_until_ready()
        eng.advance_until_ready()
        jev = jeng.buffer.take_cycle(jeng.agg_every)
        ev = eng.buffer.take_cycle(eng.agg_every)
        assert ev == [tuple(e) for e in jev]
        jeng.version += 1
        eng.version += 1
        assert eng.host_state() == jeng.host_state()
    assert eng.arrivals_total > 0
    if faults:
        assert eng.arrivals_dropped > 0
    jalgo.stop()
    algo.stop()


def _event_inputs(jeng, jfr, ticks, clients, x, y, lengths, model):
    """The JAX cycle's per-event batches and dropout keep-masks."""
    nb, bsz = jfr.num_batches_per_round, jfr.batch_size
    widths = getattr(model, "dropout_widths", ())
    rate = getattr(model, "dropout_rate", 0.0)
    k = len(clients)
    bx, by = [], []
    masks = [np.zeros((k, nb, bsz, w), bool) for w in widths]
    for i, (t, c) in enumerate(zip(ticks, clients)):
        k_sample, k_train = jax.random.split(
            event_train_key(jeng._key_base, int(t), int(c)))
        bkeys = jax.random.split(k_sample, nb)
        cx, cy = jax.vmap(lambda kb: sample_batch(
            kb, x[c], y[c], lengths[c], bsz))(bkeys)
        bx.append(np.asarray(cx))
        by.append(np.asarray(cy))
        for s, ks in enumerate(jax.random.split(k_train, nb)):
            for layer, w in enumerate(widths):
                masks[layer][i, s] = np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(ks, layer), 1.0 - rate, (bsz, w)))
    return ((torch.from_numpy(np.stack(bx)), torch.from_numpy(np.stack(by))),
            tuple(torch.from_numpy(m) for m in masks) or None)


@pytest.mark.parametrize("adversary,aggregator,momentum,cycles,model", [
    ({"type": "ALIE"}, "Median", 0.0, 1, "mlp"),
    ({"type": "ALIE"}, "Median", 0.9, 3, "mlp"),
    ({"type": "Lazy", "mode": "replay"}, "Mean", 0.0, 3, "mlp"),
    ({"type": "DiurnalALIE", "period": 4}, "Median", 0.0, 3, "mlp"),
    ({"type": "LazyRamp", "ramp": [[0, 0.0], [2, 1.0]]}, "Mean", 0.0, 3,
     "mlp"),
    pytest.param({"type": "ALIE"}, "Mean", 0.9, 2, "resnet10",
                 marks=pytest.mark.slow),
], ids=["alie-median-1", "alie-median-momentum-3", "lazy-replay-mean-3",
        "diurnal-median-3", "lazyramp-mean-3",
        "resnet10-alie-mean-momentum-2"])
def test_cycles_match_the_jax_build_cycle(adversary, aggregator, momentum,
                                          cycles, model):
    """ResNet-10 (32x32 synthetic CIFAR-10, one local step, the BN backward
    with per-lane parameters): a freshly initialised ResNet on a batch of
    8 random images is ill-conditioned for some lanes, where any f32
    backward -- the port's shared and per-lane forms, and the JAX
    package's -- lands ~1e-3 of that lane's gradient away from a float64
    one (seen on the CPU).  So the parameters and the ring are held in
    norm, ``|a - b| <= 1e-4 |b|``, the losses within ``rtol=1e-5``."""
    run = {**ASYNC_RUN, "adversary_config": adversary,
           "client_config": {"momentum": momentum},
           "server_config": {"lr": 1.0, "aggregator": {"type": aggregator}}}
    tol = dict(rtol=1e-5, atol=1e-6)
    if model != "mlp":
        run.update(global_model=model, dataset_config={
            **ASYNC_RUN["dataset_config"], "type": "cifar10"})
    for m, jm, _ in _lockstep_cycles(run, cycles, model=model):
        if model == "mlp":
            continue
        for k in ("params", "arrivals"):
            assert np.linalg.norm(m[k] - jm[k]) <= 1e-4 * np.linalg.norm(
                jm[k])
        np.testing.assert_allclose(float(m["train_loss"]),
                                   float(jm["train_loss"]), **tol)
        np.testing.assert_allclose(float(m["agg_norm"]),
                                   float(jm["agg_norm"]), rtol=1e-4)


def _lockstep_cycles(run, cycles, model="mlp"):
    """Drive the JAX engine's ``build_cycle`` and the port's ``_cycle``
    for ``cycles`` cycles on the same events, batches, dropout masks and
    forge noise (the JAX package's draws, handed in).  Yields ``(metrics,
    jax_metrics, (clients, staleness))`` per cycle, each metrics dict with
    ``params`` and ``arrivals`` added; on the MLP the parameters, the
    ring, the loss and the aggregate norm are checked here within
    ``rtol=1e-5, atol=1e-6``."""
    adversary = run["adversary_config"]
    tol = dict(rtol=1e-5, atol=1e-6)
    jalgo = JaxFedavgConfig().update_from_dict(run).build()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    jeng, jst = jalgo._async, jalgo.state
    fr = algo.fed_round
    params = params_from_jax(jax.tree.map(np.asarray, jst.server.params))
    state = RoundState(
        server=fr.server.init(params, N),
        client_opt=fr.task.init_client_opt_state(params, N),
        arrivals=init_history(params, 3))
    x, y, lengths = jalgo._train_arrays
    replay = adversary["type"] == "Lazy"
    ramp = adversary["type"] == "LazyRamp"
    for c in range(cycles):
        jeng.advance_until_ready()
        events = jeng.buffer.take_cycle(jeng.agg_every)
        clients = np.array([e.client for e in events], np.int32)
        ticks = np.array([e.tick for e in events], np.int32)
        stale = np.array([jeng.version - e.version for e in events],
                         np.int32)
        corrupt = np.zeros(len(events), bool)
        mal = np.asarray(jalgo.malicious)[clients]
        k_agg = cycle_agg_key(jeng._key_base, jeng.version)
        jst, jm = jeng._cycle(jst, x, y, lengths, jnp.asarray(clients),
                              jnp.asarray(ticks), jnp.asarray(stale),
                              jnp.asarray(mal), jnp.asarray(corrupt),
                              jeng._key_base, k_agg)
        jeng.version += 1
        batches, masks = _event_inputs(jeng, jalgo.fed_round, ticks,
                                       clients, x, y, lengths, fr.task.model)
        noise = None
        if replay:
            k_pick, k_noise = jax.random.split(jax.random.fold_in(k_agg, 2))
            shape = (len(events), sum(p.numel() for p in params.values()))
            noise = (torch.from_numpy(np.array(jax.random.uniform(
                k_pick, (len(events),)))), torch.from_numpy(np.array(
                    jax.random.normal(k_noise, shape, jnp.float32))))
        elif ramp:
            # LazyRamp's camouflage: normals of the forge key itself.
            shape = (len(events), sum(p.numel() for p in params.values()))
            noise = torch.from_numpy(np.array(jax.random.normal(
                jax.random.fold_in(k_agg, 2), shape, jnp.float32)))
        state, m = algo._async._cycle(
            state, algo._train[:2], clients, ticks, stale, mal, corrupt,
            np.asarray(lengths)[clients], seed=7, version=c,
            prebatched=batches, dropout_masks=masks, forge_noise=noise)
        m = {**m, "params": _flat(state.server.params),
             "arrivals": state.arrivals.numpy()}
        jm = {**jm, "params": np.asarray(ravel_pytree(jst.server.params)[0]),
              "arrivals": np.asarray(jst.arrivals)}
        if model == "mlp":
            for k in ("params", "arrivals", "train_loss", "agg_norm"):
                np.testing.assert_allclose(np.asarray(m[k], np.float32),
                                           np.asarray(jm[k]), **tol)
        yield m, jm, (clients, stale)
    jalgo.stop()
    algo.stop()


@pytest.mark.parametrize("adversary,aggregator", [
    ({"type": "ALIE"}, "Median"),
    ({"type": "DiurnalALIE", "period": 4}, "Trimmedmean"),
    ({"type": "ALIE"}, "Multikrum"),
], ids=["alie-median", "diurnal-trimmedmean", "alie-multikrum"])
def test_forensic_cycles_match_the_jax_build_cycle(adversary, aggregator):
    """The cycle's cohort forensics against the JAX package's on the same
    events (6 a cycle, 2 malicious clients of 8): the health mask taken
    after forge and corruption, the aggregator's bundle on the
    staleness-scaled rows, the update norms before the weighting, and the
    detection scalars on the events' malicious mask.  The kept and
    healthy masks and the detection scalars exactly, the scores and norms
    within ``rtol=1e-5, atol=1e-6``.  Each package's client ledger folds
    its own cycle's lanes, lane i as event client i: the round fields
    agree, the floats within the same tolerance."""
    from blades_tpu.obs.ledger import make_ledger as jax_make_ledger
    from blades_tpu_torch.obs.ledger import make_ledger

    run = {**ASYNC_RUN, "adversary_config": adversary, "forensics": True,
           "ledger": True,
           "async_config": {**ASYNC_RUN["async_config"], "agg_every": 6},
           "server_config": {"lr": 1.0, "aggregator": {"type": aggregator}}}
    tol = dict(rtol=1e-5, atol=1e-6)
    jled, led = jax_make_ledger("resident", N), make_ledger("resident", N)
    flagged = 0
    for c, (m, jm, (clients, stale)) in enumerate(
            _lockstep_cycles(run, 3)):
        for k in ("lane_benign_mask", "lane_healthy", "byz_precision",
                  "byz_recall", "byz_fpr", "num_flagged", "num_unhealthy"):
            np.testing.assert_array_equal(np.asarray(m[k]),
                                          np.asarray(jm[k]), err_msg=k)
        for k in ("lane_scores", "lane_update_norms"):
            np.testing.assert_allclose(np.asarray(m[k]), np.asarray(jm[k]),
                                       err_msg=k, **tol)
        for ledger, out in ((led, m), (jled, jm)):
            ledger.observe(
                clients.astype(np.int64), round=c + 1,
                flagged=np.asarray(out["lane_benign_mask"]) <= 0.5,
                scores=np.asarray(out["lane_scores"], np.float64),
                staleness=stale, norms=np.asarray(out["lane_update_norms"],
                                                  np.float64))
        got, want = led.round_fields(), jled.round_fields()
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, err_msg=k, **tol)
            else:
                assert got[k] == v, k
        flagged += int(m["num_flagged"])
    # Median keeps every lane (its scores are distances); the selection
    # defenses flag someone, so their masks are a real comparison.
    assert (flagged > 0) == (aggregator != "Median")


def test_stale_replay_reads_the_oldest_ring_row():
    """Lazy replay's malicious events train against row H whatever their
    pull; the benign ones against their own version."""
    task = TaskSpec(model="mlp", input_shape=(4, 4, 1)).build()
    seen = []
    orig = task.local_round_batched

    def spy(params, *a, **kw):
        seen.append({k: v.clone() for k, v in params.items()})
        return orig(params, *a, **kw)

    object.__setattr__(task, "local_round_batched", spy)
    from blades_tpu_torch.adversaries import get_adversary
    from blades_tpu_torch.arrivals.cycle import build_cycle
    from blades_tpu_torch.core import FedRound

    fr = FedRound(task=task, server=Server.from_config("Mean"),
                  adversary=get_adversary({"type": "Lazy",
                                           "mode": "replay"}),
                  batch_size=2)
    params = task.init_params(torch.Generator().manual_seed(0))
    hist = torch.stack([init_history(params, 0)[0] + j for j in range(4)])
    cycle = build_cycle(fr, staleness_cap=3, weight_schedule="constant",
                        weight_power=0.5, weight_cutoff=16)
    state = RoundState(server=fr.server.init(params, 4), arrivals=hist)
    x = torch.randn(4, 3, 4, 4, 1)
    cycle(state, (x, torch.zeros(4, 3).long()), [0, 1, 2, 3], [5, 5, 6, 6],
          [0, 1, 0, 2], [True, False, True, False], [False] * 4, [3] * 4,
          seed=1, version=0)
    from blades_tpu_torch.utils.tree import FlatLayout

    lay = FlatLayout(params)
    rows = lay.ravel_rows(seen[0])
    torch.testing.assert_close(rows, hist[[3, 1, 3, 2]], rtol=0, atol=0)


def test_step_buffered_constant_is_step_bit_for_bit():
    server = Server.from_config("Median", lr=0.5)
    params = {"w": torch.randn(3, 5), "b": torch.randn(5)}
    st = server.init(params, 6)
    u = torch.randn(6, 20)
    a, agg_a = server.step(st, u)
    b, agg_b = server.step_buffered(st, u, staleness=torch.arange(6),
                                    schedule="constant")
    assert torch.equal(agg_a, agg_b)
    assert all(torch.equal(a.params[k], b.params[k]) for k in params)
    mean = Server.from_config("Mean")
    _, agg = mean.step_buffered(mean.init(params, 6), u,
                                staleness=torch.arange(6),
                                schedule="inverse")
    w = 1.0 / (1.0 + torch.arange(6.0))
    torch.testing.assert_close(agg, (w[:, None] * u).sum(0) / w.sum(),
                               rtol=1e-6, atol=1e-6)


def _shared_block(task, params, bx, by, opt, masks):
    """Today's shared-parameter block written out: one unbatched
    ``params`` at step 0 (``in_dims=None``), batched from step 1, SGD with
    momentum, updates against the shared start."""
    from torch.func import grad_and_value, vmap

    p, batched, losses = params, False, []
    for s in range(bx.shape[1]):
        m = tuple(mk[:, s] for mk in masks)
        g, loss = vmap(grad_and_value(task.loss_fn),
                       in_dims=(0 if batched else None, 0, 0, 0))(
            p, bx[:, s], by[:, s], m)
        opt = {k: g[k] + 0.9 * opt[k] for k in g}
        p = {k: p[k] + (-task.spec.lr) * opt[k] for k in p}
        batched = True
        losses.append(loss)
    from blades_tpu_torch.utils.tree import FlatLayout

    upd = FlatLayout(params).ravel_rows({k: p[k] - params[k] for k in p})
    return upd, torch.stack(losses, 1).mean(1), opt


def test_lane_params_leave_the_shared_block_unchanged():
    """The shared-parameter block (every round of today) is bit for bit
    the written-out shared computation; per-lane parameters from step 0
    fed the same parameters on every lane agree with it to f32 rounding
    (a batched matmul sums in another order), and each lane's update is
    taken against its own parameters."""
    task = TaskSpec(model="mlp", input_shape=(4, 4, 1),
                    momentum=0.9).build()
    gen = torch.Generator().manual_seed(0)
    params = task.init_params(gen)
    g, nb, b = 3, 2, 4
    bx, by = torch.randn(g, nb, b, 4, 4, 1), torch.randint(0, 10, (g, nb, b))
    masks = task.draw_dropout_masks(gen, (g, nb, b), "cpu")
    opt = task.init_client_opt_state(params, g)
    u0, l0, o0 = task.local_round_batched(params, bx, by, opt_state=opt,
                                          dropout_masks=masks)
    ur, lr, orf = _shared_block(task, params, bx, by, opt, masks)
    assert torch.equal(u0, ur) and torch.equal(l0, lr)
    assert all(torch.equal(o0[k], orf[k]) for k in o0)
    lane = {k: v.expand((g,) + v.shape).clone() for k, v in params.items()}
    u1, l1, o1 = task.local_round_batched(lane, bx, by, opt_state=opt,
                                          dropout_masks=masks,
                                          lane_params=True)
    torch.testing.assert_close(u1, u0, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-7)
    lane["Dense_2.bias"][1] += 1.0
    u2, _, _ = task.local_round_batched(lane, bx, by, opt_state=opt,
                                        dropout_masks=masks,
                                        lane_params=True)
    assert torch.equal(u2[0], u1[0]) and torch.equal(u2[2], u1[2])
    assert not torch.allclose(u2[1], u1[1])


def test_driver_rows_carry_the_async_digest_and_match_the_jax_keys():
    jalgo = JaxFedavgConfig().update_from_dict(ASYNC_RUN).build()
    algo = FedavgConfig().update_from_dict(ASYNC_RUN).build(device="cpu")
    jrows = [jalgo.train() for _ in range(3)]
    rows = [algo.train() for _ in range(3)]
    for r, jr in zip(rows, jrows):
        assert set(r) == set(jr)
    r = rows[-1]
    assert len(r["staleness_hist"]) == 3 + 2
    assert sum(r["staleness_hist"]) == 4 and r["tick"] > 0
    assert r["arrival_seed"] == 7 and r["updates_per_sec"] > 0
    assert np.isfinite(r["test_acc"])
    assert algo.state.arrivals.shape == (4, sum(
        p.numel() for p in algo.state.server.params.values()))
    jalgo.stop()
    algo.stop()


def test_async_kill_and_resume_is_bit_identical(tmp_path):
    run = {**ASYNC_RUN, "client_config": {"momentum": 0.9},
           "fault_config": {"dropout_rate": 0.2, "corrupt_rate": 0.1,
                            "corrupt_mode": "nan"},
           "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}}}
    straight = FedavgConfig().update_from_dict(run).build(device="cpu")
    want = [straight.train() for _ in range(4)]
    first = FedavgConfig().update_from_dict(run).build(device="cpu")
    for _ in range(2):
        first.train()
    first.save_checkpoint(str(tmp_path / "ckpt"))
    first.stop()
    resumed = FedavgConfig().update_from_dict(run).build(device="cpu")
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    got = [resumed.train() for _ in range(2)]
    for g, w in zip(got, want[2:]):
        for k in ("train_loss", "agg_norm", "tick", "staleness_hist",
                  "arrivals_dropped", "buffer_fill"):
            assert g[k] == w[k], k
    for k, v in straight.state.server.params.items():
        assert torch.equal(resumed.state.server.params[k], v)
    assert torch.equal(resumed.state.arrivals, straight.state.arrivals)
    assert all(torch.equal(resumed.state.client_opt[k], v)
               for k, v in straight.state.client_opt.items())
    assert resumed._async.host_state() == straight._async.host_state()
    straight.stop()
    resumed.stop()


def test_async_resume_through_the_runner_replays_the_rows(tmp_path):
    """``run_experiments`` with a checkpoint every cycle and a preemption
    after cycle 2 (one retry): the rows equal a straight run's."""
    from blades_tpu_torch.tune import run_experiments, verify_result_rounds

    run = {**ASYNC_RUN, "client_config": {"momentum": 0.9}}
    exp = {"a": {"run": "FEDAVG", "stop": {"training_iteration": 4},
                 "config": run}}
    run_experiments(exp, storage_path=str(tmp_path / "s"), verbose=0,
                    device="cpu")
    (summary,) = run_experiments(
        exp, storage_path=str(tmp_path / "r"), verbose=0, checkpoint_freq=1,
        preempt_after=2, max_failures=1, retry_backoff_base=0.0,
        device="cpu")
    assert "status" not in summary
    import json

    rows = []
    for root in ("s", "r"):
        path = tmp_path / root / "a" / "a_00000" / "result.json"
        assert verify_result_rounds(path) == [1, 2, 3, 4]
        rows.append([json.loads(line) for line in
                     path.read_text().splitlines()])
    for a, b in zip(*rows):
        for k in ("train_loss", "agg_norm", "tick", "staleness_hist",
                  "buffer_fill"):
            assert a[k] == b[k], (a["training_iteration"], k)


def test_jax_async_state_carries_over():
    """The JAX ring and host state start a port engine where the JAX
    engine stands: the same next events."""
    jalgo = JaxFedavgConfig().update_from_dict(ASYNC_RUN).build()
    algo = FedavgConfig().update_from_dict(ASYNC_RUN).build(device="cpu")
    for _ in range(2):
        jalgo.train()
    ring, host = async_state_from_jax(jalgo.state.arrivals,
                                      jalgo._async.host_state())
    np.testing.assert_array_equal(ring.numpy(),
                                  np.asarray(jalgo.state.arrivals))
    algo._async.restore_host_state(host)
    assert algo._async.host_state() == jalgo._async.host_state()
    jalgo.stop()
    algo.stop()


@pytest.mark.parametrize("override,match", [
    ({"codec_config": {"type": "topk"}}, "update codecs"),
    ({"health_check": True}, "health check"),
    ({"dp_clip_threshold": 1.0}, "client DP"),
    ({"rounds_per_dispatch": 2}, "rounds_per_dispatch"),
    ({"fault_config": {"num_stragglers": 1}}, "straggler"),
    ({"async_config": {"agg_every": 9}}, "agg_every"),
    ({"async_config": {"rate": 0.0}}, "rate"),
    ({"async_config": {"weight_schedule": "linear"}}, "weight_schedule"),
    ({"execution": "dense"}, "async_config is set"),
])
def test_validate_refuses_what_the_jax_package_refuses(override, match):
    run = {**ASYNC_RUN, **override}
    for cls in (FedavgConfig, JaxFedavgConfig):
        with pytest.raises(ValueError, match=match):
            cls().update_from_dict(run).validate()


def test_sizing_helpers_match_the_jax_package():
    from blades_tpu.arrivals import AsyncSpec as JaxSpec
    from blades_tpu.arrivals import expected_arrivals_per_sec as jeaps
    from blades_tpu.arrivals import size_for_target as jsize

    kw = dict(rate=0.1, slow_fraction=0.3, slow_factor=0.5,
              ticks_per_sec=20.0)
    spec, jspec = AsyncSpec(**kw), JaxSpec(**kw)
    assert expected_arrivals_per_sec(spec, 100) == jeaps(jspec, 100)
    got, want = size_for_target(spec, 100, 80.0), jsize(jspec, 100, 80.0)
    assert (got.agg_every, got.buffer_capacity) == (want.agg_every,
                                                    want.buffer_capacity)
    with pytest.raises(ValueError, match="exceeds"):
        size_for_target(spec, 100, 1e6)
    with pytest.raises(ValueError, match="calibrated"):
        expected_arrivals_per_sec(AsyncSpec(), 10)
    assert dataclasses.replace(spec, seed=3).process().seed == 3


def test_live_actuators_ride_the_host_state():
    algo = FedavgConfig().update_from_dict(ASYNC_RUN).build(device="cpu")
    eng = algo._async
    eng.set_buffer_capacity(12)
    eng.set_agg_every(3)
    eng.set_weight_cutoff(2)
    eng.set_quarantine([5])
    algo.train()
    hs = eng.host_state()
    assert (hs["agg_every"], hs["buffer_capacity"], hs["weight_cutoff"],
            hs["quarantine"]) == (3, 12, 2, [5])
    assert 5 not in set(eng.last_clients.tolist())
    for bad in (lambda: eng.set_agg_every(0),
                lambda: eng.set_buffer_capacity(1),
                lambda: eng.set_quarantine(range(7)),
                lambda: eng.set_weight_cutoff(-1)):
        with pytest.raises(ValueError):
            bad()
    eng.cold_reset(4)
    assert eng.version == 4 and eng.tick == 0 and eng.agg_every == 4
    algo.stop()
