# blades-lint: disable-file=streamed-pass-discipline — the port is held against the JAX decode on purpose
"""The port's wire-domain aggregation (``PassPlanner(row_scale=)``,
``aggregate_wire``, ``Server.step_wire``, ``FedRound._finish_wire``)
against the JAX package's, on the same packed payloads.

The payload is JAX's ``(q int8, scales)``; the port's ``q`` is the same
rows zero-padded to 16 bytes (its codec's layout, see
blades_tpu_torch/comm/codecs.py).  The planner's statistics against the
JAX planner's (its chunk path, and its Pallas kernel in interpret mode):
norms and the Gram exact (integer sums, one scale product), the rest
within ``rtol=1e-5`` of the statistic's scale.  ``aggregate_wire`` for all
ten ``WIRE_AGGREGATORS`` against JAX's: Median exact, Trimmedmean's kept
values exact and their sum in the port's column order, Mean and the
row-geometry seven within ``rtol=1e-5, atol=1e-6`` (GeoMed at
``maxiter=5`` with its early stop off, ``ftol=-1``: the stop compares f32
objectives exactly and flips by an iteration under reassociation; DnC
with JAX's column draws handed in); the padded payload gives what the
unpadded one gives (order statistics bit for bit, sums within the CPU
BLAS's shape-dependent order); the port's wire result matches its own
decode-then-f32 aggregate (Median and Trimmedmean exact); ``hbm_passes`` and
``dequant_rows`` equal JAX's recorder counts.  Three chained dense MLP
rounds of each driver under quant int8 on the wire, ALIE + Multikrum and
ALIE + Median, hold the parameters within ``rtol=1e-5, atol=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_comm import MLP_RUN, QUANT8, assert_round_matches, chained_rounds

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.comm.codecs import CodecConfig as JaxCodec
from blades_tpu.comm.codecs import dequantize as jax_dequantize
from blades_tpu.ops import aggregators as JA
from blades_tpu.parallel import streamed_geometry as JG
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.comm.codecs import dequantize, wire_width
from blades_tpu_torch.ops import aggregators as TA
from blades_tpu_torch.parallel import streamed_geometry as TG

KEY = jax.random.PRNGKey(3)
N, D = 16, 403


def _payload(n=N, d=D, seed=0, bits=8):
    """JAX's packed payload and the port's (rows padded to 16 bytes)."""
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    jq, js, _ = JaxCodec("quant", bits=bits).decode_deferred(
        u, None, jax.random.PRNGKey(7))
    q = torch.zeros((n, wire_width(d)), dtype=torch.int8)
    q[:, :d] = torch.from_numpy(np.array(jq))
    return jq, js, q, torch.from_numpy(np.array(js))


def _close(got, want, rtol=1e-5, what=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.abs(want).max() + 1e-30
    assert np.abs(got - want).max() <= rtol * scale, (
        what, np.abs(got - want).max() / scale)


# ---------------------------------------------------------------------------
# the planner's scale algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jax-chunks", "jax-pallas-interpret"])
def test_row_scale_statistics_match_the_jax_planner(use_kernel):
    jq, js, q, s = _payload()
    rng = np.random.default_rng(1)
    v = rng.normal(size=(D,)).astype(np.float32)
    w = rng.normal(size=(N,)).astype(np.float32)
    jp = JG.PassPlanner(jq, 97, row_scale=js, use_kernel=use_kernel,
                        interpret=use_kernel)
    tp = TG.PassPlanner(q, 97, d=D, row_scale=s)
    jh = [jp.sq_norms(), jp.gram(), jp.sign_counts(), jp.dots(jnp.asarray(v)),
          jp.weighted_sum(jnp.asarray(w)), jp.gram_dot(jnp.asarray(w))]
    th = [tp.sq_norms(), tp.gram(), tp.sign_counts(), tp.dots(
        torch.from_numpy(v)), tp.weighted_sum(torch.from_numpy(w)),
        tp.gram_dot(torch.from_numpy(w))]
    jp.execute()
    tp.execute()
    kinds = ("sq", "gram", "signs", "dots", "wsum", "gram_dot")
    for kind, a, b in zip(kinds, th, jh):
        if kind in ("sq", "gram", "signs"):  # integer sums, one product
            np.testing.assert_array_equal(a.value.numpy(), np.asarray(b.value),
                                          err_msg=kind)
        else:
            _close(a.value.numpy(), b.value, what=kind)


def test_chunk_only_requests_decode_in_flight_as_jax():
    jq, js, q, s = _payload(n=10, d=211)
    mal = np.array([True] * 3 + [False] * 7)
    idx = np.array([0, 5, 210, 100], np.int32)
    jp = JG.PassPlanner(jq, 64, row_scale=js)
    tp = TG.PassPlanner(q, 64, d=211, row_scale=s)
    ones = np.ones((10,), np.float32)
    jh = [jp.gather(jnp.asarray(idx)), jp.col_mean_std(jnp.asarray(mal)),
          jp.masked_median(jnp.asarray(~mal), jnp.asarray(ones)),
          jp.coordwise(JA.Median()), jp.coordwise(JA.Trimmedmean(2))]
    th = [tp.gather(torch.from_numpy(idx).long()),
          tp.col_mean_std(torch.from_numpy(mal)),
          tp.masked_median(torch.from_numpy(~mal), torch.from_numpy(ones)),
          tp.coordwise(TA.Median()), tp.coordwise(TA.Trimmedmean(2))]
    jp.execute()
    tp.execute()
    np.testing.assert_array_equal(th[0].value.numpy(), np.asarray(jh[0].value))
    for a, b in zip(th[1].value, jh[1].value):  # (mean, std)
        _close(a.numpy(), b, what="mean_std")
    for a, b in zip(th[2:4], jh[2:4]):  # order statistics: exact
        np.testing.assert_array_equal(a.value.numpy(), np.asarray(b.value))
    _close(th[4].value.numpy(), jh[4].value, what="trimmed mean")


def test_dequant_rows_accounting_matches_jax():
    jq, js, q, s = _payload(n=10, d=211)
    jrec, trec = JG.PassRecorder(), TG.PassRecorder()
    for p, ones, idx in ((JG.PassPlanner(jq, 64, row_scale=js, recorder=jrec),
                          jnp.ones((10,), jnp.float32),
                          jnp.arange(30, dtype=jnp.int32)),
                         (TG.PassPlanner(q, 64, d=211, row_scale=s,
                                         recorder=trec),
                          torch.ones(10), torch.arange(30))):
        p.weighted_sum(ones)
        p.sq_norms()
        p.gram()
        p.execute()
        p.gather(idx)
        p.col_mean_std(ones > 2)
        p.execute()
    assert (trec.executed, trec.unfused, trec.dequant_rows) == (
        jrec.executed, jrec.unfused, jrec.dequant_rows) == (2, 5, 1 + 2 + 2)


def test_a_shared_weight_vector_stays_shared_under_row_scale():
    """GeoMed's and Centeredclipping's iterates ask a weighted sum and a
    gram_dot of one vector: folding the scales keeps them one tensor, so
    the kernel still takes one column pass for both."""
    _, _, q, s = _payload()
    seen = []
    real = TG.row_stats_bundle

    def spy(*a, **kw):
        seen.append(kw.get("gram_dot_shared"))
        return real(*a, **kw)

    TG.row_stats_bundle = spy
    try:
        p = TG.PassPlanner(q, 97, d=D, row_scale=s)
        w = torch.rand(N)
        p.weighted_sum(w)
        p.gram_dot(w)
        p.execute()
    finally:
        TG.row_stats_bundle = real
    assert seen == [(0,)]


# ---------------------------------------------------------------------------
# aggregate_wire, all ten
# ---------------------------------------------------------------------------


ZOO = [("Mean", {}), ("Median", {}), ("Trimmedmean", dict(num_byzantine=2)),
       ("GeoMed", dict(maxiter=5, ftol=-1.0)), ("Multikrum", dict(num_byzantine=2, k=3)),
       ("DnC", dict(num_byzantine=2, sub_dim=50)),
       ("Centeredclipping", {}), ("Signguard", {}),
       ("Clippedclustering", {}), ("FLTrust", {})]


def _wire_pair(name, kw, d_chunk=128, **pay):
    jq, js, q, s = _payload(**pay)
    n, d = jq.shape
    ja, ta = getattr(JA, name)(**kw), getattr(TA, name)(**kw)
    trusted = np.random.default_rng(9).normal(size=(d,)).astype(np.float32)
    draws = None
    if name == "DnC":
        keys = jax.random.split(KEY, ja.num_iters)
        draws = torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.permutation(k, d)[:ja.sub_dim])(keys)))
    jrec, trec = JG.PassRecorder(), TG.PassRecorder()
    jout, _, jsq = JG.aggregate_wire(
        ja, jq, js, state=ja.init(d, n), key=KEY, trusted=jnp.asarray(trusted),
        d_chunk=d_chunk, recorder=jrec)
    tout, _, tsq = TG.aggregate_wire(
        ta, q, s, state=ta.init(d, n), draws=draws,
        trusted=torch.from_numpy(trusted), d_chunk=d_chunk, d=d,
        recorder=trec)
    return (jout, jsq, jrec), (tout, tsq, trec), (ta, q, s, d, trusted,
                                                  draws)


@pytest.mark.parametrize("name,kw", ZOO, ids=[n for n, _ in ZOO])
def test_aggregate_wire_matches_jax(name, kw):
    (jout, jsq, jrec), (tout, tsq, trec), _ = _wire_pair(name, kw)
    if name == "Median":
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    else:
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(tsq.numpy(), np.asarray(jsq))
    assert (trec.executed, trec.unfused, trec.dequant_rows) == (
        jrec.executed, jrec.unfused, jrec.dequant_rows), name


@pytest.mark.parametrize("name,kw", ZOO, ids=[n for n, _ in ZOO])
def test_aggregate_wire_matches_the_ports_decode_then_f32(name, kw):
    """The wire result against the port's own f32 path over the decoded
    matrix: the streamed planner for the row-geometry seven, the dense
    call for the coordinate-wise three (Median and Trimmedmean exact)."""
    _, (tout, tsq, _), (ta, q, s, d, trusted, draws) = _wire_pair(name, kw)
    dec = dequantize(q, s, d)
    st = ta.init(d, dec.shape[0])
    if isinstance(ta, TG.STREAMED_ROW_AGGREGATORS):
        want, _, sq = TG.aggregate_streamed(
            ta, dec, None, st, draws=draws,
            trusted=torch.from_numpy(trusted), d_chunk=128)
        _close(tsq.numpy(), sq.numpy(), what="sq")
    else:
        want, _ = ta(dec, st)
    if name in ("Median", "Trimmedmean"):
        assert torch.equal(tout, want)
    else:
        np.testing.assert_allclose(tout.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name,kw", ZOO, ids=[n for n, _ in ZOO])
def test_the_padded_payload_aggregates_as_the_unpadded_one(name, kw):
    _, (tout, tsq, trec), (ta, q, s, d, trusted, draws) = _wire_pair(name, kw)
    out, _, sq = TG.aggregate_wire(
        ta, q[:, :d].contiguous(), s, state=ta.init(d, q.shape[0]),
        draws=draws, trusted=torch.from_numpy(trusted), d_chunk=128)
    assert torch.equal(sq, tsq)  # exact integer sums
    if name in ("Median", "Trimmedmean"):
        assert torch.equal(out, tout)
    else:
        np.testing.assert_allclose(out.numpy(), tout.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_wire_aggregators_cover_all_ten():
    assert len(TG.WIRE_AGGREGATORS) == 10
    assert {c.__name__ for c in TG.WIRE_AGGREGATORS} == {
        c.__name__ for c in JG.WIRE_AGGREGATORS}
    with pytest.raises(NotImplementedError, match="wire-domain"):
        TG.aggregate_wire(object(), torch.zeros(2, 16, dtype=torch.int8),
                          torch.ones(2))


def test_an_identity_payload_runs_the_unscaled_statistics():
    u = torch.from_numpy(np.random.default_rng(4).normal(
        size=(8, 100)).astype(np.float32))
    out, _, sq = TG.aggregate_wire(TA.Mean(), u, None, d_chunk=64)
    np.testing.assert_allclose(out.numpy(), u.mean(0).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sq.numpy(), (u * u).sum(1).numpy(), rtol=1e-6)


def test_jax_dequantize_equals_the_ports_on_the_padded_payload():
    jq, js, q, s = _payload(bits=4)
    np.testing.assert_array_equal(dequantize(q, s, D).numpy(),
                                  np.asarray(jax_dequantize(jq, js)))


# ---------------------------------------------------------------------------
# rounds and the driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aggregator", [{"type": "Multikrum"},
                                        {"type": "Median"}],
                         ids=["Multikrum", "Median"])
def test_three_chained_wire_rounds_match_jax(aggregator):
    config = {**MLP_RUN, "codec_config": QUANT8, "agg_domain": "wire",
              "server_config": {"lr": 1.0, "aggregator": aggregator}}
    for jstate, jm, state, m, _ in chained_rounds(config):
        assert_round_matches(jstate, jm, state, m,
                             ("agg_norm", "train_loss", "update_norm_mean"))
        for k in ("hbm_passes", "hbm_passes_unfused", "dequant_rows"):
            assert int(m[k]) == int(jm[k]), k


def test_identity_codec_on_the_wire_is_the_f32_round():
    def rows(domain):
        algo = FedavgConfig().update_from_dict(
            {**MLP_RUN, "codec_config": {"type": "identity"},
             "agg_domain": domain}).build(device="cpu")
        out = [algo.train() for _ in range(2)]
        return out, algo.state.server.params

    (r32, p32), (rw, pw) = rows("f32"), rows("wire")
    assert all(torch.equal(p32[k], pw[k]) for k in p32)
    assert [r["train_loss"] for r in r32] == [r["train_loss"] for r in rw]


def _wire(**over):
    config = {**MLP_RUN, "codec_config": QUANT8, "agg_domain": "wire",
              "server_config": {"lr": 1.0, "aggregator": {
                  "type": "Multikrum", "k": 2}}}
    return {**config, **over}


@pytest.mark.parametrize("over,match", [
    (dict(codec_config=None), "deferrable codec"),
    (dict(codec_config={"type": "topk"}), "deferrable codec"),
    (dict(fault_config={"dropout_rate": 0.3}), "fault injection"),
    (dict(health_check=True), "health check"),
    (dict(dp_clip_threshold=1.0), "DP"),
    (dict(agg_domain="int8"), "agg_domain"),
], ids=["no-codec", "topk", "faults", "health", "dp", "domain"])
def test_validate_gates_the_wire_domain_as_jax(over, match):
    with pytest.raises(ValueError, match=match):
        FedavgConfig().update_from_dict(_wire(**over)).validate()
    with pytest.raises(ValueError, match=match):
        JaxFedavgConfig().update_from_dict(_wire(**over)).validate()


def test_validate_refuses_an_aggregator_without_a_wire_formulation(
        monkeypatch):
    monkeypatch.setattr(TG, "WIRE_AGGREGATORS", (TA.Mean,))
    with pytest.raises(ValueError, match="no wire-domain formulation"):
        FedavgConfig().update_from_dict(_wire()).validate()
    FedavgConfig().update_from_dict(_wire(agg_domain="f32")).validate()


def test_wire_rows_carry_the_jax_drivers_keys():
    jalgo = JaxFedavgConfig().update_from_dict(_wire()).build()
    algo = FedavgConfig().update_from_dict(_wire()).build(device="cpu")
    try:
        jrow, row = jalgo.train(), algo.train()
    finally:
        jalgo.stop()
        algo.stop()
    keys = ("agg_domain", "agg_domain_bits", "dequant_rows", "hbm_passes",
            "hbm_passes_unfused", "comm_bytes_up", "codec_bits",
            "comm_compression_ratio")
    assert {k: row[k] for k in keys} == {k: jrow[k] for k in keys}
    assert (row["agg_domain"], row["agg_domain_bits"]) == ("wire", 8)
    assert set(row) - {"timers"} <= set(jrow)
