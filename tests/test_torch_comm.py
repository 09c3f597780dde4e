"""The port's update codecs (blades_tpu_torch/comm/codecs.py) and the
dense round and driver under them, against the JAX package's.

The JAX codec draws its rounding uniforms from ``fold_in(round key,
CODEC_KEY_FOLD)``; the port takes them as ``draws=``, so the parity cases
hand it JAX's own uniforms.  Given them, the quantization, its decode,
the packed payload (the port's rows zero-padded to 16 bytes) and the
re-quantization of forged rows are bit-exact.  Top-k with error feedback
is exact on distinct magnitudes; on ties ``torch.topk`` may keep another
valid top-k set than ``jax.lax.top_k``, and the sent set is then checked
for being a top-k and for ``p = sent + residual``.  The byte accounting
equals JAX's.  Three chained dense MLP rounds of each driver under quant
int8 (f32 domain, ALIE + Median) and top-k 2% + EF (Median), on JAX-drawn
batches with the codec draws handed in, hold the server parameters (and
the residual) within ``rtol=1e-5, atol=1e-6`` after every round, the f32
reassociation tolerance of tests/test_torch_dense_round.py.  A top-k + EF
trial killed after round 2 and resumed from its round-1 checkpoint ends
bit for bit where the straight run ends, its residual included.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_dense_round import _jax_draws

from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.comm.codecs import CODEC_KEY_FOLD as JAX_CODEC_KEY_FOLD
from blades_tpu.comm.codecs import CodecConfig as JaxCodec
from blades_tpu_torch import train
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.comm import CODEC_KEY_FOLD, CodecConfig, get_codec
from blades_tpu_torch.comm.codecs import (
    codec_generator,
    dequantize,
    wire_width,
)
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import RoundState

MLP_RUN = {
    "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 8},
    "global_model": "mlp", "evaluation_interval": 3,
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
}
QUANT8 = {"type": "quant", "bits": 8}
TOPK2 = {"type": "topk", "topk_ratio": 0.02}


def _matrix(n=16, d=403, seed=0):
    """Rows of spread scales, one all-zero row."""
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(n, d))
         * rng.uniform(1e-3, 1e2, size=(n, 1))).astype(np.float32)
    u[3] = 0.0
    return u


def _uniforms(key, shape):
    return np.array(jax.random.uniform(key, shape))


# ---------------------------------------------------------------------------
# the config surface
# ---------------------------------------------------------------------------


def test_codec_config_validates_as_jax():
    for bad, match in ((dict(name="gzip"), "name"),
                       (dict(name="quant", bits=3), "bits"),
                       (dict(name="topk", topk_ratio=0.0), "topk_ratio"),
                       (dict(name="topk", topk_ratio=1.5), "topk_ratio")):
        with pytest.raises(ValueError, match=match):
            CodecConfig(**bad)
        with pytest.raises(ValueError, match=match):
            JaxCodec(**bad)
    hash(CodecConfig("topk", topk_ratio=0.1))
    assert CODEC_KEY_FOLD == JAX_CODEC_KEY_FOLD


def test_get_codec_resolution():
    assert get_codec(None) is None
    c = get_codec({"type": "quant", "bits": 4})
    assert (c.name, c.bits) == ("quant", 4)
    assert get_codec("identity").name == "identity"
    assert get_codec({"name": "topk"}).name == "topk"
    inst = CodecConfig("topk", topk_ratio=0.5)
    assert get_codec(inst) is inst
    with pytest.raises(ValueError, match="type"):
        get_codec({"bits": 8})


SPECS = [dict(name="identity"), dict(name="quant", bits=8),
         dict(name="quant", bits=4), dict(name="topk", topk_ratio=0.02),
         dict(name="topk", topk_ratio=0.3, error_feedback=False)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(
    str(v) for v in s.values()))
def test_payload_bytes_and_round_metrics_match_jax(spec):
    ours, theirs = CodecConfig(**spec), JaxCodec(**spec)
    for n, d in ((6, 101_770), (1000, 4_903_242), (3, 7)):
        assert ours.payload_bytes(n, d) == theirs.payload_bytes(n, d)
        assert ours.round_metrics(n, d) == theirs.round_metrics(n, d)
        assert ours.topk_k(d) == theirs.topk_k(d)
    for attr in ("needs_residual", "supports_deferred", "storage_bits",
                 "wire_bits"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    res = ours.init_residual(4, 9, device="cpu")
    jres = theirs.init_residual(4, 9)
    assert (res is None) == (jres is None)
    if res is not None:
        assert res.shape == (4, 9) and res.dtype == torch.float32
        assert not res.any()


# ---------------------------------------------------------------------------
# quantization, bit for bit given JAX's uniforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantization_is_bit_exact_given_jax_uniforms(bits, seed):
    u = _matrix(seed=seed)
    key = jax.random.PRNGKey(seed + 10)
    theirs, ours = JaxCodec("quant", bits=bits), CodecConfig("quant", bits=bits)
    jq, js = theirs._quantize_deferred(jnp.asarray(u), key)
    draws = torch.from_numpy(_uniforms(key, u.shape))
    q, s = ours._quantize_deferred(torch.from_numpy(u), draws=draws)
    assert q.dtype == torch.int8 and q.shape == (16, wire_width(403)) == (16, 416)
    np.testing.assert_array_equal(q[:, :403].numpy(), np.asarray(jq))
    assert not q[:, 403:].any()  # the 16-byte row padding is zero
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jdec, _ = theirs.encode_decode(jnp.asarray(u), None, key)
    dec, res = ours.encode_decode(torch.from_numpy(u), None, draws=draws)
    assert res is None
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(dequantize(q, s, 403).numpy(),
                                  np.asarray(jdec))


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_deferred_is_encode_decode_bit_for_bit(bits):
    u = torch.from_numpy(_matrix(seed=5))
    codec = CodecConfig("quant", bits=bits)
    gen = torch.Generator().manual_seed(3)
    q, s, res = codec.decode_deferred(u, None, generator=gen)
    gen = torch.Generator().manual_seed(3)
    dec, _ = codec.encode_decode(u, None, generator=gen)
    assert res is None
    assert torch.equal(dequantize(q, s, u.shape[1]), dec)
    # out= may be the input itself: each block is quantized before it is
    # overwritten, so the result is the same.
    inplace = u.clone()
    gen = torch.Generator().manual_seed(3)
    got, _ = codec.encode_decode(inplace, None, generator=gen, out=inplace)
    assert got is inplace and torch.equal(inplace, dec)


def test_quantization_blocks_of_rows_give_one_result(monkeypatch):
    from blades_tpu_torch.comm import codecs

    u = torch.from_numpy(_matrix(n=9, seed=6))
    draws = torch.rand(u.shape, generator=torch.Generator().manual_seed(1))
    codec = CodecConfig("quant", bits=8)
    whole = codec._quantize_deferred(u, draws=draws)
    monkeypatch.setattr(codecs, "QUANT_BLOCK_BYTES", 2 * 4 * u.shape[1])
    blocks = codec._quantize_deferred(u, draws=draws)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocks))


def test_identity_codec_is_transparent():
    u = torch.from_numpy(_matrix(seed=7))
    codec = CodecConfig("identity")
    dec, res = codec.encode_decode(u, None)
    assert dec is u and res is None
    q, s, _ = codec.decode_deferred(u, None)
    assert q is u and s is None and dequantize(q, s) is u


def test_topk_has_no_deferred_mode():
    with pytest.raises(ValueError, match="sparse"):
        CodecConfig("topk").decode_deferred(torch.zeros(2, 4), None)


def test_requantize_rows_is_bit_exact_and_keeps_benign_payloads():
    u = _matrix(seed=8)
    key = jax.random.PRNGKey(4)
    theirs, ours = JaxCodec("quant", bits=8), CodecConfig("quant", bits=8)
    jq, js = theirs._quantize_deferred(jnp.asarray(u), key)
    q, s = ours._quantize_deferred(
        torch.from_numpy(u), draws=torch.from_numpy(_uniforms(key, u.shape)))
    rows = np.zeros(16, bool)
    rows[[0, 3, 5, 11]] = True
    forged = np.asarray(theirs.encode_decode(jnp.asarray(u), None, key)[0])
    forged = forged * 1.7 + np.linspace(-0.5, 2.5, 403, dtype=np.float32)
    forged[3] = 0.0  # a zero row keeps scale 0
    jq2, js2 = theirs.requantize_rows(jnp.asarray(forged), jq, js,
                                      jnp.asarray(rows))
    q2, s2 = ours.requantize_rows(torch.from_numpy(forged), q, s,
                                  torch.from_numpy(rows))
    np.testing.assert_array_equal(q2[:, :403].numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))
    assert not q2[:, 403:].any()
    assert torch.equal(q2[~torch.from_numpy(rows)], q[~torch.from_numpy(rows)])
    assert torch.equal(q, ours._quantize_deferred(
        torch.from_numpy(u), draws=torch.from_numpy(_uniforms(key, u.shape)))[0])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantization_is_unbiased_over_seeds(bits):
    """E[decode(encode(u))] = u over the rounding draws, within 6 standard
    errors (the Bernoulli rounding's variance is at most scale^2 / 4),
    while deterministic floor rounding fails the same tolerance."""
    codec = CodecConfig("quant", bits=bits)
    u = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 257)).astype(np.float32) * 2.0)
    K = 4096
    gen = torch.Generator().manual_seed(7)
    total = torch.zeros_like(u, dtype=torch.float64)
    for _ in range(K):
        total += codec.encode_decode(u, None, generator=gen)[0].double()
    scale = (u.abs().amax(1, keepdim=True) / (2 ** (bits - 1) - 1)).numpy()
    err = (total / K).numpy() - u.numpy()
    tol = 6.0 * scale / (2.0 * np.sqrt(K))
    assert (np.abs(err) <= tol).all(), np.abs(err / scale).max()
    floor_err = np.floor(u.numpy() / scale) * scale - u.numpy()
    assert (np.abs(floor_err) > tol).mean() > 0.9


def test_quantization_lands_on_the_wire_grid():
    for bits in (8, 4):
        codec = CodecConfig("quant", bits=bits)
        s = 2 ** (bits - 1) - 1
        u = torch.from_numpy(_matrix(n=5, d=130, seed=bits))
        dec = codec.encode_decode(u, None, generator=torch.Generator())[0]
        scale = u.abs().amax(1, keepdim=True) / s
        grid = (dec / torch.where(scale > 0, scale, 1.0)).numpy()
        np.testing.assert_allclose(grid, np.round(grid), atol=1e-4)
        assert np.abs(grid).max() <= s + 1e-4
        assert not dec[3].any()  # the zero row survives (no 0/0)


def test_codec_generator_leaves_the_round_stream_untouched():
    gen = torch.Generator().manual_seed(1234)
    first = torch.rand(4, generator=torch.Generator().manual_seed(1234))
    cgen = codec_generator(gen)
    torch.rand(100, generator=cgen)
    assert torch.equal(torch.rand(4, generator=gen), first)
    again = codec_generator(torch.Generator().manual_seed(1234))
    assert torch.equal(torch.rand(8, generator=again),
                       torch.rand(8, generator=codec_generator(
                           torch.Generator().manual_seed(1234))))
    assert again.initial_seed() == 1234 + CODEC_KEY_FOLD


# ---------------------------------------------------------------------------
# top-k with error feedback
# ---------------------------------------------------------------------------


def test_topk_with_error_feedback_matches_jax_on_distinct_magnitudes():
    n, d = 5, 300
    theirs = JaxCodec("topk", topk_ratio=0.05)
    ours = CodecConfig("topk", topk_ratio=0.05)
    rng = np.random.default_rng(2)
    jres, res = theirs.init_residual(n, d), ours.init_residual(n, d)
    for _ in range(3):  # chained: the residual carries over
        u = rng.normal(size=(n, d)).astype(np.float32)
        jsent, jres = theirs.encode_decode(jnp.asarray(u), jres,
                                           jax.random.PRNGKey(0))
        sent, res = ours.encode_decode(torch.from_numpy(u), res)
        np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    nof = CodecConfig("topk", topk_ratio=0.05, error_feedback=False)
    sent, res = nof.encode_decode(torch.from_numpy(u), None)
    assert res is None and (sent != 0).sum(1).tolist() == [15] * n


def test_topk_ties_keep_a_valid_topk_and_conserve_mass():
    """Eight entries tie at the k-th magnitude of each row (k = 10): the
    sent set is some top-k (every sent magnitude >= every unsent one) and
    sent + residual is the pre-image exactly."""
    n, d = 3, 200
    codec = CodecConfig("topk", topk_ratio=0.05)
    u = np.zeros((n, d), np.float32)
    u[:, :6] = np.arange(6, 0, -1) + 10.0  # six clear winners
    u[:, 6:14] = 2.0                        # eight tied for four places
    u[:, 14:] = np.random.default_rng(0).uniform(-1, 1, size=(n, d - 14))
    p = torch.from_numpy(u)
    res = codec.init_residual(n, d) + 0.0
    sent, new_res = codec.encode_decode(p, res)
    assert (sent != 0).sum(1).tolist() == [10] * n
    for i in range(n):
        kept = sent[i] != 0
        assert p[i, kept].abs().min() >= p[i, ~kept].abs().max()
    assert torch.equal(sent + new_res, p)
    assert torch.equal(torch.where(sent != 0, new_res, sent), sent * 0)


# ---------------------------------------------------------------------------
# rounds: three chained dense MLP rounds of each driver
# ---------------------------------------------------------------------------


def fault_masks(jfr, n, round_idx):
    """The JAX fault injector's ``(participation, straggled, corrupted)``
    for round ``round_idx`` (a pure function of seed, round and n)."""
    faults = jfr.faults
    stale = (jnp.zeros((faults.staleness, n, 1))
             if faults.needs_stale_buffer else None)
    _, _, p, s, c = faults.inject(jnp.zeros((n, 1)), stale,
                                  jnp.int32(round_idx))
    return tuple(torch.from_numpy(np.array(v)) for v in (p, s, c))


def chained_rounds(config, rounds=3):
    """Both drivers' rounds on JAX-drawn batches from one JAX init, each
    side carrying its own state, the port handed JAX's dropout masks,
    codec uniforms and fault masks: yields ``(jstate, jm, state, m,
    fed_round)`` per round."""
    jalgo = JaxFedavgConfig().update_from_dict(config).build()
    algo = FedavgConfig().update_from_dict(config).build(device="cpu")
    try:
        jfr, fr = jalgo.fed_round, algo.fed_round
        n = config["dataset_config"]["num_clients"]
        jstate = jfr.init(jax.random.PRNGKey(0), n)
        params = params_from_jax(jax.tree.map(np.asarray,
                                              jstate.server.params))
        d = sum(p.numel() for p in params.values())
        state = RoundState(
            server=fr.server.init(params, n),
            stale=None if fr.faults is None else fr.faults.init_stale_buffer(
                n, d),
            residual=None if fr.codec is None else fr.codec.init_residual(
                n, d))
        jstep = jax.jit(jfr.step_prebatched)
        x, y, lengths = jalgo._train_arrays
        for key in jax.random.split(jax.random.PRNGKey(9), rounds):
            bx, by = jfr.sample_round_batches(x, y, lengths, key)
            masks, _ = _jax_draws(key, n, fr.num_batches_per_round,
                                  fr.batch_size, fr.task.model, None)
            draws = real = None
            if fr.codec is not None and fr.codec.name == "quant":
                draws = torch.from_numpy(_uniforms(
                    jax.random.fold_in(key, JAX_CODEC_KEY_FOLD), (n, d)))
            if fr.faults is not None:
                real = fault_masks(jfr, n, int(jstate.server.round))
            jstate, jm = jstep(jstate, bx, by, jalgo.malicious, key)
            state, m = fr.step_prebatched(
                state, torch.from_numpy(np.array(bx)),
                torch.from_numpy(np.array(by)).long(), algo.malicious,
                dropout_masks=masks, codec_draws=draws,
                fault_realization=real)
            yield jstate, jm, state, m, fr
    finally:
        jalgo.stop()
        algo.stop()


def assert_round_matches(jstate, jm, state, m, keys=("agg_norm",
                                                      "train_loss")):
    np.testing.assert_allclose(
        ravel_pytree(params_to_jax(state.server.params))[0],
        ravel_pytree(jstate.server.params)[0], rtol=1e-5, atol=1e-6)
    for k in keys:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert int(m["round"]) == int(jm["round"])


def test_three_chained_quant_int8_f32_domain_rounds_match_jax():
    for jstate, jm, state, m, _ in chained_rounds(
            {**MLP_RUN, "codec_config": QUANT8}):
        assert_round_matches(jstate, jm, state, m,
                             ("agg_norm", "train_loss", "update_norm_mean"))
        assert state.residual is None and jstate.residual is None


def test_three_chained_topk_error_feedback_rounds_match_jax():
    for jstate, jm, state, m, _ in chained_rounds(
            {**MLP_RUN, "codec_config": TOPK2}):
        assert_round_matches(jstate, jm, state, m,
                             ("agg_norm", "train_loss", "update_norm_mean"))
        np.testing.assert_allclose(state.residual.numpy(),
                                   np.asarray(jstate.residual), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_config_validates_codecs_as_jax():
    with pytest.raises(ValueError, match="bits"):
        FedavgConfig().update_from_dict(
            {**MLP_RUN, "codec_config": {"type": "quant", "bits": 3}}
        ).validate()
    cfg = (FedavgConfig().update_from_dict(MLP_RUN)
           .communication(codec={"type": "topk"})
           .resources(execution="streamed"))
    with pytest.raises(ValueError, match="codec"):
        cfg.validate()
    with pytest.raises(NotImplementedError, match="num_devices"):
        FedavgConfig().update_from_dict(
            {**MLP_RUN, "codec_config": TOPK2, "num_devices": 2})
    fluent = FedavgConfig().update_from_dict(MLP_RUN).communication(
        codec=TOPK2)
    assert fluent.get_codec() == CodecConfig("topk", topk_ratio=0.02)
    assert FedavgConfig().update_from_dict(
        {**MLP_RUN, "codec_config": TOPK2}).items() == fluent.items()


def test_rows_carry_the_comm_keys_of_the_jax_driver():
    config = {**MLP_RUN, "codec_config": TOPK2}
    jalgo = JaxFedavgConfig().update_from_dict(config).build()
    algo = FedavgConfig().update_from_dict(config).build(device="cpu")
    try:
        jrow, row = jalgo.train(), algo.train()
    finally:
        jalgo.stop()
        algo.stop()
    keys = ("comm_bytes_up", "codec_bits", "comm_compression_ratio",
            "agg_domain", "agg_domain_bits")
    assert {k: row[k] for k in keys} == {k: jrow[k] for k in keys}
    assert set(row) - {"timers"} <= set(jrow)


def _topk_trial(rounds, save_at=None, path=None):
    algo = FedavgConfig().update_from_dict(
        {**MLP_RUN, "codec_config": TOPK2, "evaluation_interval": 0}
    ).build(device="cpu")
    rows = []
    for _ in range(rounds):
        rows.append(algo.train())
        if algo.iteration == save_at:
            algo.save_checkpoint(str(path))
    return algo, rows


def test_topk_trial_killed_and_resumed_matches_the_straight_run(tmp_path):
    """Checkpoint at round 1, run round 2, 'die'; a fresh driver restores
    round 1 and runs rounds 2-3: parameters, residual and rows equal the
    straight run's bit for bit."""
    straight, srows = _topk_trial(3)
    killed, _ = _topk_trial(2, save_at=1, path=tmp_path / "ck")
    killed.stop()
    resumed, _ = _topk_trial(0)
    resumed.load_checkpoint(str(tmp_path / "ck"))
    assert resumed.iteration == 1 and resumed.state.residual.any()
    rrows = [resumed.train() for _ in range(2)]
    assert torch.equal(resumed.state.residual, straight.state.residual)
    for k, v in straight.state.server.params.items():
        assert torch.equal(resumed.state.server.params[k], v), k

    def drop(r):
        return {k: v for k, v in r.items() if k != "timers"}
    assert [drop(r) for r in rrows] == [drop(r) for r in srows[1:]]


def test_file_command_kill_and_resume_under_topk(tmp_path):
    import yaml

    grid = {"topk_grid": {"run": "FEDAVG", "stop": {"training_iteration": 3},
                          "config": {**MLP_RUN, "codec_config": TOPK2}}}
    path = tmp_path / "grid.yaml"
    path.write_text(yaml.safe_dump(grid))
    straight, killed = tmp_path / "straight", tmp_path / "killed"
    assert train.main(["file", str(path), "--device", "cpu",
                       "--storage-path", str(straight)]) == 0
    assert train.main(["file", str(path), "--device", "cpu",
                       "--storage-path", str(killed), "--preempt-after", "2",
                       "--checkpoint-freq", "1", "--max-failures", "1"]) == 0

    def rows(root):
        text = (root / "topk_grid" / "topk_grid_00000" / "result.json"
                ).read_text()
        return [{k: v for k, v in json.loads(line).items() if k != "timers"}
                for line in text.splitlines()]
    assert rows(straight) == rows(killed)
    assert rows(straight)[-1]["comm_bytes_up"] > 0


def test_checkpoint_without_a_residual_starts_it_cold(tmp_path):
    plain = FedavgConfig().update_from_dict(
        {**MLP_RUN, "evaluation_interval": 0}).build(device="cpu")
    plain.train()
    plain.save_checkpoint(str(tmp_path / "ck"))
    assert plain.state.residual is None
    ef, _ = _topk_trial(0)
    ef.load_checkpoint(str(tmp_path / "ck"))
    assert ef.state.residual is not None and not ef.state.residual.any()
    ef.train()
    assert ef.state.residual.any()
