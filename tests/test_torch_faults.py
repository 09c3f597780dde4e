"""The port's fault injector (blades_tpu_torch/faults/injector.py), the
participation-aware aggregators (``masked_call``) and the dense round and
driver under faults, against the JAX package's.

The JAX injector realizes its masks from its own PRNG; handed those masks
(``inject(..., realization=)``), the port returns the same faulted matrix
and stale ring bit for bit.  The port's own realizations are a pure
function of ``(seed, round)`` and independent of the round's generator.
``masked_call`` on the same matrix and mask is held against JAX's for
every aggregator (``rtol=2e-4, atol=2e-5`` as tests/test_torch_aggregators.py
holds the dense calls; Median exact); an all-True mask is bit-identical to
the port's dense call; with a NaN lane and no health check the port keeps
JAX's result.  Three chained dense MLP rounds of each driver under
``{dropout_rate: 0.3, num_stragglers: 1, staleness: 2, corrupt_rate: 0.2,
corrupt_mode: nan}`` with the health check and Median, handed JAX's masks,
hold the parameters within ``rtol=1e-5, atol=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_comm import MLP_RUN, assert_round_matches, chained_rounds

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.faults import FaultInjector as JaxInjector
from blades_tpu.ops import aggregators as JA
from blades_tpu.ops import masked as jmasked
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.core import Server
from blades_tpu_torch.faults import FaultInjector
from blades_tpu_torch.ops import aggregators as TA
from blades_tpu_torch.ops import masked as tmasked

RTOL, ATOL = 2e-4, 2e-5
KEY = jax.random.PRNGKey(5)
FAULTS = {"dropout_rate": 0.3, "num_stragglers": 1, "staleness": 2,
          "corrupt_rate": 0.2, "corrupt_mode": "nan"}


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------


def test_injector_validates_as_jax():
    for bad, match in ((dict(dropout_rate=1.0), "dropout_rate"),
                       (dict(corrupt_rate=1.5), "corrupt_rate"),
                       (dict(corrupt_mode="segfault"), "corrupt_mode"),
                       (dict(num_stragglers=-1), "num_stragglers"),
                       (dict(staleness=0), "staleness"),
                       (dict(dropout_schedule=((0, 1.5),)),
                        "dropout_schedule"),
                       (dict(dropout_schedule=((-1, 0.5),)),
                        "dropout_schedule")):
        with pytest.raises(ValueError, match=match):
            FaultInjector(**bad)
        with pytest.raises(ValueError, match=match):
            JaxInjector(**bad)
    inj = FaultInjector(dropout_schedule=[[10, 0.5], [0, 0.1]])
    assert inj.dropout_schedule == ((0, 0.1), (10, 0.5))
    assert inj.dropout_schedule == JaxInjector(
        dropout_schedule=[[10, 0.5], [0, 0.1]]).dropout_schedule
    hash(inj)
    assert not FaultInjector().needs_stale_buffer
    assert FaultInjector(num_stragglers=2).needs_stale_buffer


def test_dropout_schedule_rates_match_jax():
    kw = dict(dropout_rate=0.05, dropout_schedule=((5, 0.9), (12, 0.2)))
    ours, theirs = FaultInjector(**kw), JaxInjector(**kw)
    for r in (0, 4, 5, 6, 11, 12, 99):
        assert ours.dropout_rate_at(r) == pytest.approx(
            float(theirs.dropout_rate_at(jnp.int32(r))))
    assert FaultInjector(dropout_rate=0.3).dropout_rate_at(7) == 0.3


@pytest.mark.parametrize("mode", ["nan", "inf", "overflow"])
def test_inject_given_jax_masks_is_bit_exact(mode):
    """Four chained rounds: the faulted matrix and the advanced ring equal
    JAX's bit for bit, the cold ring's zeros included."""
    n, d = 10, 37
    kw = dict(seed=3, dropout_rate=0.3, num_stragglers=2, staleness=2,
              corrupt_rate=0.3, corrupt_mode=mode)
    ours, theirs = FaultInjector(**kw), JaxInjector(**kw)
    stale, jstale = ours.init_stale_buffer(n, d), theirs.init_stale_buffer(n, d)
    rng = np.random.default_rng(1)
    for r in range(4):
        u = rng.normal(size=(n, d)).astype(np.float32)
        jout, jstale, jp, js, jc = theirs.inject(jnp.asarray(u), jstale,
                                                 jnp.int32(r))
        real = tuple(torch.from_numpy(np.array(v)) for v in (jp, js, jc))
        out, stale, p, s, c = ours.inject(torch.from_numpy(u), stale, r,
                                          realization=real)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(stale.numpy(), np.asarray(jstale))
        for a, b in ((p, jp), (s, js), (c, jc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_realizations_are_pure_in_seed_and_round():
    inj = FaultInjector(seed=5, dropout_rate=0.5, num_stragglers=1,
                        corrupt_rate=0.3)
    a = inj.realize(16, 3)
    torch.manual_seed(123)  # the global stream moves nothing
    torch.rand(50, generator=torch.Generator().manual_seed(5))
    b = inj.realize(16, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = inj.realize(16, 4)
    e = FaultInjector(seed=6, dropout_rate=0.5, num_stragglers=1,
                      corrupt_rate=0.3).realize(16, 3)
    assert not torch.equal(a[0], c[0]) or not torch.equal(a[0], e[0])
    assert bool(a[0].any())
    # The dropout draw does not depend on the other processes' settings.
    plain = FaultInjector(seed=5, dropout_rate=0.5).realize(16, 3)
    assert torch.equal(plain[0], a[0])
    # Stragglers and corrupted lanes are participants.
    assert not bool((a[1] & ~a[0]).any() or (a[2] & ~a[0]).any())
    assert int(a[1].sum()) == 1


def test_an_all_dropped_draw_degrades_to_full_participation():
    inj = FaultInjector(seed=0, dropout_rate=0.999999)
    for r in range(5):
        p, _, _ = inj.realize(4, r)
        assert bool(p.all())


def test_dropout_schedule_takes_effect_from_its_round():
    inj = FaultInjector(dropout_rate=0.0, dropout_schedule=((5, 0.9),))
    assert bool(inj.realize(32, 0)[0].all())
    assert int(inj.realize(32, 50)[0].sum()) < 32


def test_straggler_delivers_its_update_of_staleness_rounds_ago():
    n, d = 4, 3
    inj = FaultInjector(seed=1, num_stragglers=1, staleness=2)
    buf = inj.init_stale_buffer(n, d)
    assert buf.shape == (2, n, d)
    for t in range(4):
        fresh = torch.full((n, d), float(t + 1))
        out, buf, part, strag, _ = inj.inject(fresh, buf, t)
        assert int(strag.sum()) == 1 and bool((strag & part).sum() == 1)
        lane = int(strag.int().argmax())
        want = 0.0 if t < 2 else float(t - 1)
        assert out[lane].tolist() == [want] * d
        assert torch.equal(out[~strag], fresh[~strag])


# ---------------------------------------------------------------------------
# masked ops and masked_call
# ---------------------------------------------------------------------------


def _matrix(seed=0, n=12, d=200):
    """Benign rows around +0.2, three outliers far on the other side."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.5 + 0.2).astype(np.float32)
    x[-3:] = (-(x[:3].mean(0) * 4) - 0.5
              + 0.3 * rng.normal(size=(3, d))).astype(np.float32)
    return x


PART = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0], bool)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_masked_trimmed_mean_and_clip_to_norm_match_jax(k):
    x = _matrix(1)
    x[4, 7] = np.inf  # +inf pads must not meet 0 * inf
    got = tmasked.masked_trimmed_mean(torch.from_numpy(x),
                                      torch.from_numpy(PART), k)
    want = jmasked.masked_trimmed_mean(jnp.asarray(x), jnp.asarray(PART),
                                       jnp.int32(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    v = x[0] * (k + 1)
    np.testing.assert_allclose(
        tmasked.clip_to_norm(torch.from_numpy(v), 3.0).numpy(),
        np.asarray(jmasked.clip_to_norm(jnp.asarray(v), 3.0)), rtol=1e-6)


def test_participant_median_equals_the_padded_sort_with_nan_columns():
    """Compaction ranks what the +inf-padded sort ranks; where a
    participant's NaN reaches the middle, the JAX result (+inf from the pad,
    or NaN) stands, column by column."""
    x = _matrix(2)
    x[1, :5] = np.nan          # one NaN among 9 participants
    x[[0, 1, 3, 4, 5], 5:9] = np.nan  # five NaNs: the middle is NaN
    x[0, 9], x[1, 9] = -np.inf, np.nan
    x[2, 10:12] = np.nan       # a dropped lane's NaN counts for nothing
    mask = torch.from_numpy(PART)
    got = TA.participant_median(torch.from_numpy(x), mask)
    want = np.asarray(jmasked.masked_median(jnp.asarray(x),
                                            jnp.asarray(PART)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isposinf(want[5:9]).all()
    for k in (1, 3):
        got = TA.participant_trimmed_mean(torch.from_numpy(x), mask, k)
        want = np.asarray(jmasked.masked_trimmed_mean(
            jnp.asarray(x), jnp.asarray(PART), jnp.int32(k)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


MASKED = [
    ("Mean", {}), ("Median", {}), ("Trimmedmean", dict(num_byzantine=3)),
    ("GeoMed", dict(maxiter=5)),
    ("DnC", dict(num_byzantine=3, sub_dim=40, num_iters=3)),
    ("Multikrum", dict(num_byzantine=3, k=4)),
    ("Centeredclipping", dict(tau=2.0)), ("Signguard", {}),
    ("Clippedclustering", {}), ("FLTrust", {}),
]


def _dnc_draws(agg, d):
    keys = jax.random.split(KEY, agg.num_iters)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.permutation(k, d)[:agg.sub_dim])(keys)))


@pytest.mark.parametrize("name,kw", MASKED, ids=[n for n, _ in MASKED])
def test_masked_call_matches_jax(name, kw):
    x = _matrix(3)
    part = PART.copy()
    if name == "FLTrust":  # the last row is the trusted one: participates
        part[-1] = True
    ja, ta = getattr(JA, name)(**kw), getattr(TA, name)(**kw)
    n, d = x.shape
    jstate, tstate = ja.init(d, n), ta.init(d, n)
    draws = _dnc_draws(ja, d) if name == "DnC" else None
    for _ in range(2):  # the stateful ones carry their state across calls
        jout, jstate = ja.masked_call(jnp.asarray(x), jnp.asarray(part),
                                      jstate, key=KEY)
        tout, tstate = ta.masked_call(torch.from_numpy(x),
                                      torch.from_numpy(part), tstate,
                                      draws=draws)
        if name == "Median":
            np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        else:
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,kw", MASKED, ids=[n for n, _ in MASKED])
def test_full_participation_is_the_dense_call_bit_for_bit(name, kw):
    x = torch.from_numpy(_matrix(4))
    agg = getattr(TA, name)(**kw)
    n, d = x.shape
    draws = _dnc_draws(agg, d) if name == "DnC" else None
    s1, s2 = agg.init(d, n), agg.init(d, n)
    for _ in range(2):
        dense, s1 = agg(x, s1, draws=draws)
        masked, s2 = agg.masked_call(x, torch.ones(n, dtype=torch.bool), s2,
                                     draws=draws)
        assert torch.equal(dense, masked), name


@pytest.mark.parametrize("name", ["Median", "Trimmedmean", "Mean"])
def test_a_nan_lane_without_the_health_check_keeps_the_jax_result(name):
    x = _matrix(5)
    x[4] = np.nan  # a participant's corrupted lane
    kw = dict(num_byzantine=3) if name == "Trimmedmean" else {}
    ja, ta = getattr(JA, name)(**kw), getattr(TA, name)(**kw)
    jout, _ = ja.masked_call(jnp.asarray(x), jnp.asarray(PART), (), key=KEY)
    tout, _ = ta.masked_call(torch.from_numpy(x), torch.from_numpy(PART))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-7)
    if name == "Median":
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_server_pads_the_participation_mask_for_the_trusted_row():
    x = torch.from_numpy(_matrix(6)[:-1])
    trusted = torch.from_numpy(_matrix(6)[-1])
    srv = Server.from_config("FLTrust", lr=1.0)
    params = {"w": torch.zeros(x.shape[1])}
    state = srv.init(params, x.shape[0])
    part = torch.from_numpy(PART[:-1])
    _, agg = srv.step(state, x, trusted_update=trusted, participation=part)
    want, _ = srv.aggregator._masked(torch.cat([x, trusted[None]]),
                                     torch.cat([part, torch.ones(1, dtype=bool)]))
    assert torch.equal(agg, want)
    _, full = srv.step(state, x, trusted_update=trusted,
                       participation=torch.ones_like(part))
    _, dense = srv.step(state, x, trusted_update=trusted)
    assert torch.equal(full, dense)


# ---------------------------------------------------------------------------
# rounds and the driver
# ---------------------------------------------------------------------------


def test_three_chained_fault_rounds_match_jax():
    config = {**MLP_RUN, "fault_config": FAULTS, "health_check": True}
    seen = set()
    for jstate, jm, state, m, fr in chained_rounds(config):
        assert_round_matches(jstate, jm, state, m,
                             ("agg_norm", "train_loss", "update_norm_mean",
                              "staleness_mean"))
        for k in ("num_participating", "num_dropped", "num_straggled",
                  "num_unhealthy", "staleness_max"):
            assert int(m[k]) == int(jm[k]), k
        assert bool(m["round_ok"]) == bool(jm["round_ok"])
        # The ring holds the clients' own updates: f32 training sums.
        np.testing.assert_allclose(state.stale.numpy(),
                                   np.asarray(jstate.stale), rtol=1e-5,
                                   atol=1e-6)
        seen.add(int(m["num_dropped"]) > 0)
    assert True in seen  # some round really dropped lanes


def test_config_validates_faults_as_jax():
    with pytest.raises(ValueError, match="dropout_rate"):
        FedavgConfig().update_from_dict(
            {**MLP_RUN, "fault_config": {"dropout_rate": 1.0}}).validate()
    cfg = FedavgConfig().update_from_dict(
        {**MLP_RUN, "fault_config": FAULTS, "execution": "streamed"})
    with pytest.raises(ValueError, match="fault injection"):
        cfg.validate()
    jcfg = JaxFedavgConfig().update_from_dict(
        {**MLP_RUN, "fault_config": FAULTS, "execution": "streamed"})
    with pytest.raises(ValueError, match="fault injection"):
        jcfg.validate()
    fluent = FedavgConfig().update_from_dict(MLP_RUN).fault_tolerance(
        health_check=True, faults=FAULTS)
    inj = fluent.get_fault_injector()
    assert inj.seed == fluent.seed and inj.dropout_rate == 0.3
    assert FedavgConfig().update_from_dict(
        {**MLP_RUN, "fault_config": {**FAULTS, "seed": 9}}
    ).get_fault_injector().seed == 9


def test_auto_execution_with_faults_past_the_dense_budget_raises():
    cfg = FedavgConfig().update_from_dict(
        {**MLP_RUN, "fault_config": FAULTS, "execution": "auto"})
    cls = cfg.algo_class
    old = cls._DENSE_MATRIX_LIMIT
    try:
        cls._DENSE_MATRIX_LIMIT = 1
        with pytest.raises(ValueError, match="needs the dense round"):
            cfg.build(device="cpu")
    finally:
        cls._DENSE_MATRIX_LIMIT = old


def test_fault_rows_carry_the_jax_keys_and_a_fresh_ring_on_resume(tmp_path):
    config = {**MLP_RUN, "fault_config": FAULTS, "health_check": True}
    jalgo = JaxFedavgConfig().update_from_dict(config).build()
    algo = FedavgConfig().update_from_dict(config).build(device="cpu")
    try:
        jrow, row = jalgo.train(), algo.train()
    finally:
        jalgo.stop()
    keys = ("num_participating", "num_straggled", "num_dropped",
            "fault_seed", "staleness_mean", "staleness_max")
    assert all(k in row for k in keys) and set(row) - {"timers"} <= set(jrow)
    assert row["fault_seed"] == jrow["fault_seed"]
    assert algo.state.stale.shape == (2, 6, algo._num_params)
    algo.save_checkpoint(str(tmp_path / "ck"))
    again = FedavgConfig().update_from_dict(config).build(device="cpu")
    again.load_checkpoint(str(tmp_path / "ck"))
    assert torch.equal(again.state.stale, algo.state.stale)
    plain = FedavgConfig().update_from_dict(
        {**MLP_RUN, "evaluation_interval": 0}).build(device="cpu")
    plain.save_checkpoint(str(tmp_path / "plain"))
    again.load_checkpoint(str(tmp_path / "plain"))
    assert again.state.stale.shape == (2, 6, algo._num_params)
    assert not again.state.stale.any()
