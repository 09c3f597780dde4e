"""Defense forensics in the port against the JAX package: every
aggregator's ``diagnose`` / ``masked_diagnose``
(blades_tpu_torch/ops/aggregators.py), ``detection_metrics``
(blades_tpu_torch/obs/forensics.py), ``Server.step_diag`` and the dense
round's forensics metrics.

Both packages get the same numpy inputs from a seed.  Tolerances: the
per-lane masks and Trimmedmean's trim fractions exactly (ties included:
both take stable ranks), the scores ``rtol=1e-5, atol=1e-6`` (f32 sums
in other orders), the detection scalars exactly.  The port's
``diagnose`` aggregate equals its ``__call__`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_round import _jax_draws

from blades_tpu.obs.forensics import detection_metrics as jax_detection
from blades_tpu.ops import aggregators as JA
from blades_tpu_torch.obs.forensics import detection_metrics
from blades_tpu_torch.ops import aggregators as TA

KEY = jax.random.PRNGKey(11)
N, D = 12, 257
RTOL, ATOL = 1e-5, 1e-6
PART = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0], bool)

AGGS = [
    ("Mean", {}), ("Median", {}), ("Trimmedmean", dict(num_byzantine=3)),
    ("GeoMed", dict(maxiter=5, ftol=-1.0)),
    ("DnC", dict(num_byzantine=3, sub_dim=60, num_iters=3)),
    ("Multikrum", dict(num_byzantine=3, k=4)),
    ("Centeredclipping", dict(tau=2.0)), ("Signguard", {}),
    ("Clippedclustering", {}), ("FLTrust", {}),
]
IDS = [n for n, _ in AGGS]


def _matrix(seed=0, n=N, d=D, ties=False):
    """Benign rows around +0.2 and three outliers on the other side; with
    ``ties`` every value is rounded to a coarse grid, so columns hold
    repeated values."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 0.5 + 0.2).astype(np.float32)
    x[-3:] = (-(x[:3].mean(0) * 4) - 0.5
              + 0.3 * rng.normal(size=(3, d))).astype(np.float32)
    if ties:
        x = (np.round(x * 2) / 2).astype(np.float32)
    return x


def _draws(agg, d):
    keys = jax.random.split(KEY, agg.num_iters)
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.permutation(k, d)[:agg.sub_dim])(keys)))


def _pair(name, kw):
    return getattr(JA, name)(**kw), getattr(TA, name)(**kw)


def _state(agg):
    return agg.init(D, N)


def _assert_diag(got, want):
    np.testing.assert_array_equal(got["benign_mask"].numpy(),
                                  np.asarray(want["benign_mask"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=RTOL,
                               atol=ATOL)
    assert got["benign_mask"].dtype == torch.bool
    assert got["scores"].dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("name,kw", AGGS, ids=IDS)
def test_diagnose_matches_jax(name, kw, masked):
    x = _matrix(3)
    ja, ta = _pair(name, kw)
    draws = _draws(ta, D) if name == "DnC" else None
    part = PART.copy()
    if name == "FLTrust":  # the last row is the trusted one: participates
        part[-1] = True
    if masked:
        jagg, _, jdiag = ja.masked_diagnose(
            jnp.asarray(x), jnp.asarray(part), ja.init(D, N), key=KEY)
        tagg, _, tdiag = ta.masked_diagnose(
            torch.from_numpy(x), torch.from_numpy(part), _state(ta),
            draws=draws)
    else:
        jagg, _, jdiag = ja.diagnose(jnp.asarray(x), ja.init(D, N), key=KEY)
        tagg, _, tdiag = ta.diagnose(torch.from_numpy(x), _state(ta),
                                     draws=draws)
    _assert_diag(tdiag, jdiag)
    n_lanes = N - 1 if name == "FLTrust" else N
    assert tdiag["benign_mask"].shape == (n_lanes,)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("name,kw", AGGS, ids=IDS)
def test_diagnose_aggregate_is_the_call_bit_for_bit(name, kw, masked):
    x = torch.from_numpy(_matrix(5))
    agg = getattr(TA, name)(**kw)
    draws = _draws(agg, D) if name == "DnC" else None
    s1, s2 = _state(agg), _state(agg)
    part = torch.from_numpy(PART if masked else np.ones(N, bool)).clone()
    part[-1] = True
    for _ in range(2):  # stateful aggregators carry their state across
        a1, s1 = agg.masked_call(x, part, s1, draws=draws)
        a2, s2, _ = agg.masked_diagnose(x, part, s2, draws=draws)
        assert torch.equal(a1, a2), name
    if not masked:
        a3, _ = agg(x, _state(agg), draws=draws)
        a4, _, _ = agg.diagnose(x, _state(agg), draws=draws)
        assert torch.equal(a3, a4), name


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trim_fractions_are_exact_with_ties(seed, masked):
    """Tie-heavy columns: the stable double argsort ranks ties as JAX's
    stable sort does, so the fractions agree to the bit."""
    x = _matrix(seed, ties=True)
    ja, ta = _pair("Trimmedmean", dict(num_byzantine=3))
    if masked:
        _, _, jd = ja.masked_diagnose(jnp.asarray(x), jnp.asarray(PART))
        _, _, td = ta.masked_diagnose(torch.from_numpy(x),
                                      torch.from_numpy(PART))
    else:
        _, _, jd = ja.diagnose(jnp.asarray(x))
        _, _, td = ta.diagnose(torch.from_numpy(x))
    np.testing.assert_array_equal(td["scores"].numpy(),
                                  np.asarray(jd["scores"]))
    np.testing.assert_array_equal(td["benign_mask"].numpy(),
                                  np.asarray(jd["benign_mask"]))


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_trim_fraction_chunks_change_nothing(masked):
    x = torch.from_numpy(_matrix(4, ties=True))
    part = torch.from_numpy(PART) if masked else None
    whole = TA.trim_fraction(x, 4, part)
    for chunk in (1, 7, 64, 256):
        assert torch.equal(TA.trim_fraction(x, 4, part, chunk=chunk), whole)


def test_distance_to_chunks_agree_with_the_whole_difference():
    """One chunk is ``row_norms(x - agg)`` bit for bit; more chunks sum
    the same squares in another order (``rtol=1e-6``)."""
    from blades_tpu_torch.ops.layout import row_norms

    x = torch.from_numpy(_matrix(8))
    agg = x.median(0).values
    whole = row_norms(x - agg[None, :])
    assert torch.equal(TA.distance_to(x, agg), whole)
    for chunk in (1, 7, 64):
        torch.testing.assert_close(TA.distance_to(x, agg, chunk=chunk),
                                   whole, rtol=1e-6, atol=0.0)


def _undiagnosed_masked_aggregate(name, agg, x, part, state, draws):
    """The aggregate of a masked call as written before the aggregators
    had diagnostics, or None where the masked body is the diagnosis's own
    selection (DnC, Multikrum and FLTrust score as they select)."""
    from blades_tpu_torch.ops import masked

    if name == "Mean":
        return masked.masked_mean(x, part)
    if name == "Median":
        return TA.participant_median(x, part)
    if name == "Trimmedmean":
        m = int(part.sum())
        k = min(agg.num_excluded, max((m - 1) // 2, 0))
        return TA.participant_trimmed_mean(x, part, k)
    if name in ("DnC", "Multikrum", "FLTrust"):
        return None
    fill = TA.participant_median(x, part)
    return agg(torch.where(part[:, None], x, fill[None, :]), state,
               draws=draws)[0]


@pytest.mark.parametrize("name,kw", AGGS, ids=IDS)
def test_masked_call_computes_no_lane_scores(name, kw, monkeypatch):
    """A forensics-off round under dropout takes ``masked_call``: it runs
    neither the trim-fraction ranks nor the distance to the aggregate
    (each reads the whole matrix), and its aggregate is the masked
    aggregate as written without diagnostics, bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("a lane score was computed off forensics")

    x = torch.from_numpy(_matrix(9))
    agg = getattr(TA, name)(**kw)
    draws = _draws(agg, D) if name == "DnC" else None
    part = torch.from_numpy(PART).clone()
    part[-1] = True
    want = _undiagnosed_masked_aggregate(name, agg, x, part, _state(agg), draws)
    monkeypatch.setattr(TA, "trim_fraction", refuse)
    monkeypatch.setattr(TA, "distance_to", refuse)
    got, _ = agg.masked_call(x, part, _state(agg), draws=draws)
    if want is not None:
        assert torch.equal(got, want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_part", [False, True])
def test_detection_metrics_are_exact(seed, with_part):
    rng = np.random.default_rng(seed)
    n = 9 + seed
    kept = rng.random(n) < [0.2, 0.5, 0.8, 1.0, 0.0, 0.6][seed]
    mal = rng.random(n) < [0.3, 0.0, 0.5, 0.2, 0.4, 1.0][seed]
    part = rng.random(n) < 0.7 if with_part else None
    want = jax_detection(jnp.asarray(kept), jnp.asarray(mal),
                         None if part is None else jnp.asarray(part))
    got = detection_metrics(torch.from_numpy(kept), torch.from_numpy(mal),
                            None if part is None else torch.from_numpy(part))
    assert set(got) == set(want)
    for k in want:
        assert got[k].item() == np.asarray(want[k]).item(), k
    assert got["num_flagged"].dtype == torch.int32


def test_step_diag_covers_the_client_rows_with_fltrust():
    from blades_tpu.core import Server as JaxServer
    from blades_tpu_torch.core import Server

    x = _matrix(6)
    clients, trusted = x[:-1], x[-1]
    jsrv = JaxServer.from_config("FLTrust", lr=1.0)
    tsrv = Server.from_config("FLTrust", lr=1.0)
    jstate = jsrv.init({"w": jnp.zeros(D)}, N - 1)
    tstate = tsrv.init({"w": torch.zeros(D)}, N - 1)
    part = PART[:-1]
    for p in (None, part):
        _, jagg, jd = jsrv.step_diag(
            jstate, jnp.asarray(clients), trusted_update=jnp.asarray(trusted),
            participation=None if p is None else jnp.asarray(p))
        _, tagg, td = tsrv.step_diag(
            tstate, torch.from_numpy(clients),
            trusted_update=torch.from_numpy(trusted),
            participation=None if p is None else torch.from_numpy(p))
        _assert_diag(td, jd)
        assert td["benign_mask"].shape == (N - 1,)
        _, plain = tsrv.step(
            tstate, torch.from_numpy(clients),
            trusted_update=torch.from_numpy(trusted),
            participation=None if p is None else torch.from_numpy(p))
        assert torch.equal(tagg, plain)


def test_step_buffered_diag_is_step_diag_on_the_scaled_rows():
    from blades_tpu_torch.core import Server

    x = torch.from_numpy(_matrix(7))
    srv = Server.from_config("Trimmedmean", num_byzantine=3, lr=1.0)
    state = srv.init({"w": torch.zeros(D)}, N)
    stale = torch.arange(N) % 4
    _, agg, diag = srv.step_buffered_diag(state, x, staleness=stale,
                                          schedule="polynomial", power=0.5)
    _, plain = srv.step_buffered(state, x, staleness=stale,
                                 schedule="polynomial", power=0.5)
    assert torch.equal(agg, plain)
    _, const, cdiag = srv.step_buffered_diag(state, x, staleness=stale,
                                             schedule="constant")
    _, want, wdiag = srv.step_diag(state, x)
    assert torch.equal(const, want)
    assert torch.equal(cdiag["scores"], wdiag["scores"])
    assert diag["benign_mask"].shape == (N,)


# ---------------------------------------------------------------------------
# the dense round
# ---------------------------------------------------------------------------

LANE_KEYS = ("benign_mask", "scores", "healthy", "update_norms")
BYZ = ("byz_precision", "byz_recall", "byz_fpr", "num_flagged",
       "num_unhealthy")


@pytest.mark.parametrize("aggregator,adversary", [
    ("Trimmedmean", "ALIE"), ("Multikrum", "IPM"), ("Median", "SignFlip")])
def test_dense_round_forensics_match_jax(aggregator, adversary):
    """``step_prebatched`` with forensics on JAX-drawn batches: the
    per-lane bundle and the detection scalars agree with the JAX round's,
    and the parameters equal a forensics-off port round's bit for bit."""
    import dataclasses

    from blades_tpu.adversaries import get_adversary as jax_adversary
    from blades_tpu.core import FedRound as JaxFedRound
    from blades_tpu.core import Server as JaxServer
    from blades_tpu.core import TaskSpec as JaxTaskSpec
    from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
    from blades_tpu_torch.convert import params_from_jax
    from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec

    n, f, shard, batch = 10, 3, 8, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, shard, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, shard)).astype(np.int32)
    lengths = np.full((n,), shard, np.int32)
    spec = dict(model="mlp", input_shape=(8, 8, 1), num_classes=10, lr=0.1)
    adv = {"type": adversary}
    jfr = JaxFedRound(
        task=JaxTaskSpec(**spec).build(),
        server=JaxServer.from_config(aggregator=aggregator, num_byzantine=f,
                                     lr=0.5),
        adversary=jax_adversary(adv, num_clients=n, num_byzantine=f,
                                num_classes=10),
        batch_size=batch, forensics=True)
    fr = FedRound(
        task=TaskSpec(**spec).build(),
        server=Server.from_config(aggregator, num_byzantine=f, lr=0.5),
        adversary=get_adversary(adv, num_clients=n, num_byzantine=f,
                                num_classes=10),
        batch_size=batch, forensics=True)
    plain = dataclasses.replace(fr, forensics=False)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n))
    pstate = RoundState(server=plain.server.init(params, n))
    jstep = jax.jit(jfr.step_prebatched)
    jmal = jnp.arange(n) < f
    mal = make_malicious_mask(n, f)
    for key in jax.random.split(jax.random.PRNGKey(7), 2):
        bx, by = jfr.sample_round_batches(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(lengths), key)
        jstate, jm = jstep(jstate, bx, by, jmal, key)
        tb = (torch.from_numpy(np.array(bx)),
              torch.from_numpy(np.array(by)).long())
        masks, _ = _jax_draws(key, n, 1, batch, fr.task.model, None)
        state, m = fr.step_prebatched(state, *tb, mal, dropout_masks=masks)
        pstate, _ = plain.step_prebatched(pstate, *tb, mal,
                                          dropout_masks=masks)
        for k in BYZ:
            assert m[k].item() == pytest.approx(float(jm[k]), abs=1e-6), k
        for k in LANE_KEYS:
            np.testing.assert_allclose(m["lane_" + k].numpy(),
                                       np.asarray(jm["lane_" + k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        for k, v in state.server.params.items():
            assert torch.equal(v, pstate.server.params[k]), k
