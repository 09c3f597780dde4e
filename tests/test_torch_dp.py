"""Per-client DP in the port against the JAX package, and the forges that
ride on the same slice (Noise, Lazy).

- The chunked finish under DP (``streamed_step(...).finish``) against the
  JAX ``streamed_step(...).finish`` on the same buffer, train-time row
  norms and per-chunk draws (helpers and tolerances of
  tests/test_torch_chunked_finish.py): Mean / Median / Trimmedmean x
  ALIE / IPM / Adaptive / Noise x f32 / bf16 storage, the clip alone
  bit-exact for Median, the tail chunk's overlap under Noise + DP.
- Whole streamed rounds under DP (the port sums each leaf's f32 squares
  for the train-time norms, the JAX round takes ``jnp.linalg.norm`` of
  the block), with JAX's batches, dropout masks and draws handed over.
- The dense round: ``FedRound.apply_dp`` and ``step_prebatched`` under
  DP, Noise and Lazy (both modes) against the JAX ``step_prebatched``,
  with the JAX round's ``k_adv`` / ``k_dp`` draws handed to the port.
- ``FedavgDPConfig.noise_factor`` against the JAX config, and
  ``FEDAVG_DP`` through ``Fedavg.train()`` and the command line.

Tolerance ``rtol=1e-5, atol=1e-6`` wherever an f32 sum or a scaled
normal enters (the row norms, the clip factor from them, the noise add);
bit-exact where the chunked finish's Median sees values both sides form
the same way (test_torch_chunked_finish.py's rule).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_chunked_finish import (
    ATOL,
    D,
    D_CHUNK,
    RTOL,
    SHAPE,
    UNIT_NOISE,
    compare,
    exact,
    finish_pair,
    jax_chunk_draws,
    rounds,
)

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.algorithms.fedavg_dp import FedavgDPConfig as JaxDPConfig
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
from blades_tpu_torch.algorithms import FedavgDPConfig, get_algorithm_class
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec

# -- the chunked finish under DP ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adversary", ["ALIE", "IPM", "Adaptive", "Noise"])
@pytest.mark.parametrize("aggregator", ["Mean", "Median", "Trimmedmean"])
def test_chunked_finish_with_dp_matches_jax(aggregator, adversary, dtype):
    """Clip (tightened by 1 + 2**-8 under bf16 storage) and noise."""
    out = finish_pair(aggregator, adversary, dtype=dtype, dp="noise")
    compare(*out, exact=exact(aggregator, adversary, "noise"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adversary", [None, "Adaptive", "Noise"])
def test_chunked_median_with_dp_clip_is_bit_exact(adversary, dtype):
    """DP's clip alone (no noise factor): the clip factor is a true f32
    division of the threshold by the train-time norm, so the clipped
    values, their Median and the parameters match bit for bit."""
    kw = UNIT_NOISE if adversary == "Noise" else None
    out = finish_pair("Median", adversary, dtype=dtype, dp="clip", adv_kw=kw)
    compare(*out, exact=exact("Median", adversary, "clip", kw))


@pytest.mark.parametrize("dp", ["clip", "noise"])
def test_tail_overlap_follows_both_rules(dp):
    """Noise + DP with a tail chunk that overlaps its predecessor: the
    tail's aggregate overwrites the overlap (its draws differ from the
    middle chunk's), and the row norms count the overlap once.  A port
    that kept the middle chunk's aggregate over the overlap would be off
    by the noise's scale there, far past the tolerance; one that counted
    the overlap twice would be off in ``update_norm_mean``."""
    jserver, jm, server, m = finish_pair("Median", "Noise", dtype="float32",
                                         dp=dp, adv_kw=UNIT_NOISE)
    compare(jserver, jm, server, m, exact=exact("Median", "Noise", dp,
                                                UNIT_NOISE))
    lo, hi = D - D_CHUNK, 2 * D_CHUNK  # the overlap of chunks 1 and 2
    want = np.asarray(ravel_pytree(jserver.params)[0])[lo:hi]
    got = np.asarray(ravel_pytree(params_to_jax(server.params))[0])[lo:hi]
    if dp == "clip":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_chunked_finish_sanitizes_and_zeroes_non_finite_norms():
    """Health check + DP + Noise: the NaN and inf rows are zeroed where
    sanitize sees them and flagged; their train-time norms are non-finite,
    so DP scales both rows to 0 in every chunk."""
    out = finish_pair("Median", "Noise", dtype="bfloat16", dp="clip",
                      adv_kw=UNIT_NOISE, health=True)
    compare(*out, exact=True, health=True)
    assert int(out[3]["num_unhealthy"]) == 2


# -- whole streamed rounds ----------------------------------------------------


def _jax_batches(key, n, lengths, batch_size, model):
    """The batch indices and dropout keep-masks of one JAX streamed round
    (one local step), from its key chain."""
    k_sample, k_train, _, _, _ = jax.random.split(key, 5)
    idx = np.zeros((n, 1, batch_size), np.int64)
    masks = [np.zeros((n, 1, batch_size, w), bool)
             for w in model.dropout_widths]
    for i, (ks, kt) in enumerate(zip(jax.random.split(k_sample, n),
                                     jax.random.split(k_train, n))):
        kb, kd = jax.random.split(ks, 1)[0], jax.random.split(kt, 1)[0]
        idx[i, 0] = np.asarray(jax.random.randint(
            kb, (batch_size,), 0, max(int(lengths[i]), 1)))
        for layer, w in enumerate(model.dropout_widths):
            masks[layer][i, 0] = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(kd, layer), 1.0 - model.dropout_rate,
                (batch_size, w)))
    return torch.from_numpy(idx), tuple(torch.from_numpy(m) for m in masks)


@pytest.mark.parametrize("aggregator,adversary,dtype,num_clients", [
    ("Median", "Noise", "float32", None),
    ("Trimmedmean", "ALIE", "float32", 10),
    ("Median", "Adaptive", "float32", 10),
])
def test_streamed_rounds_with_dp_match_jax(aggregator, adversary, dtype,
                                           num_clients):
    """Two whole streamed rounds under DP, ghost lanes in two cases.  f32
    storage, as tests/test_torch_streamed.py compares whole rounds: the
    two frameworks' trained updates differ in the last f32 ulp, which bf16
    storage can round one bf16 ulp apart; bf16 storage is held above on
    identical buffers."""
    n, f, shard = 12, 3, 8
    jfr, fr, jstep, step = rounds(aggregator, adversary, n=n, f=f,
                                  dp="noise", num_clients=num_clients,
                                  block=4, dtype=dtype)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, shard) + SHAPE).astype(np.float32)
    y = rng.integers(0, 10, size=(n, shard)).astype(np.int32)
    lengths = np.full((n,), shard, np.int32)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n))
    jmal, mal = jnp.arange(n) < f, make_malicious_mask(n, f)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    for r, key in enumerate(jax.random.split(jax.random.PRNGKey(7), 2)):
        idx, masks = _jax_batches(key, n, lengths, 4, fr.task.model)
        _, _, k_adv, _, k_dp = jax.random.split(key, 5)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(lengths), jmal, key)
        state, m = step(state, xt, yt, torch.from_numpy(lengths), mal, r,
                        batch_idx=idx, dropout_masks=masks,
                        draws=jax_chunk_draws(k_adv, k_dp))
        compare(jstate.server, jm, state.server, m, exact=False)
    assert step.routes == {"chunked": 2}


@pytest.mark.parametrize("aggregator,adversary", [
    ({"type": "Multikrum", "num_byzantine": 3}, "Noise"),
    ({"type": "GeoMed", "maxiter": 5}, "ALIE"),
])
def test_streamed_rowgeom_round_with_dp_matches_jax(aggregator, adversary):
    """DP (and the Noise forge) in the row-geometry round's in-place pass:
    each chunk clipped and noised with chunk ``i``'s draws, the pass
    counted in ``hbm_passes``.  Tolerance ``rtol=2e-4, atol=2e-5``, as
    tests/test_torch_streamed.py holds the row-geometry rounds."""
    n, f, shard = 12, 3, 8
    jfr, fr, jstep, step = rounds(aggregator, adversary, n=n, f=f,
                                  dp="noise", block=4)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, shard) + SHAPE).astype(np.float32)
    y = rng.integers(0, 10, size=(n, shard)).astype(np.int32)
    lengths = np.full((n,), shard, np.int32)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n))
    key = jax.random.PRNGKey(3)
    idx, masks = _jax_batches(key, n, lengths, 4, fr.task.model)
    _, _, k_adv, _, k_dp = jax.random.split(key, 5)
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                       jnp.asarray(lengths), jnp.arange(n) < f, key)
    state, m = step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                    torch.from_numpy(lengths), make_malicious_mask(n, f), 0,
                    batch_idx=idx, dropout_masks=masks,
                    draws=jax_chunk_draws(k_adv, k_dp))
    want = np.asarray(ravel_pytree(jstate.server.params)[0])
    got = np.asarray(ravel_pytree(params_to_jax(state.server.params))[0])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for k in ("hbm_passes", "hbm_passes_unfused"):
        assert int(m[k]) == int(jm[k]), k


def test_train_time_norms_are_taken_before_storage_rounding():
    """``local_round_batched(..., sq_out=)`` adds each update's f32 squared
    norm (before the cast to the bf16 buffer) and leaves the buffer as the
    call without it writes it."""
    task = TaskSpec(model="mlp", input_shape=SHAPE, lr=0.1).build()
    params = task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    bx = torch.randn((4, 1, 4) + SHAPE, generator=gen)
    by = torch.randint(0, 10, (4, 1, 4), generator=gen)
    masks = task.draw_dropout_masks(gen, (4, 1, 4), "cpu")
    f32, _, _ = task.local_round_batched(params, bx, by, dropout_masks=masks)
    out = torch.zeros((4, D), dtype=torch.bfloat16)
    sq = torch.zeros((4,))
    task.local_round_batched(params, bx, by, dropout_masks=masks, out=out,
                             sq_out=sq)
    assert torch.equal(out, f32.to(torch.bfloat16))
    np.testing.assert_allclose(sq.numpy(), (f32.double() ** 2).sum(1).numpy(),
                               rtol=RTOL)


# -- the dense round ----------------------------------------------------------


def _dense_pair(adversary, adv_kw=None, *, dp=True, n=8, f=2,
                num_clients=None):
    spec = dict(model="mlp", input_shape=(4, 4, 1), num_classes=10, lr=0.1)
    k = num_clients or n
    common = dict(batch_size=4, num_clients=num_clients,
                  dp_clip_threshold=0.05 if dp else None,
                  dp_noise_factor=0.5 if dp else None)
    adv = None if adversary is None else {"type": adversary,
                                          **(adv_kw or {})}
    jfr = JaxFedRound(
        task=JaxTaskSpec(**spec).build(),
        server=JaxServer.from_config(aggregator="Median", num_byzantine=f,
                                     lr=0.5),
        adversary=None if adv is None else jax_adversary(
            adv, num_clients=k, num_byzantine=f), **common)
    fr = FedRound(
        task=TaskSpec(**spec).build(),
        server=Server.from_config("Median", num_byzantine=f, lr=0.5),
        adversary=None if adv is None else get_adversary(
            adv, num_clients=k, num_byzantine=f), **common)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, 8)).astype(np.int32)
    lengths = np.full((n,), 8, np.int32)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n))
    jstep = jax.jit(jfr.step_prebatched)
    jmal, mal = jnp.arange(n) < f, make_malicious_mask(n, f)
    d = sum(p.numel() for p in params.values())
    for key in jax.random.split(jax.random.PRNGKey(7), 2):
        bx, by = jfr.sample_round_batches(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(lengths), key)
        _, k_train, k_adv, _, k_dp = jax.random.split(key, 5)
        masks = [np.zeros((n, 1, 4, w), bool)
                 for w in fr.task.model.dropout_widths]
        for i, kc in enumerate(jax.random.split(k_train, n)):
            kd = jax.random.split(kc, 1)[0]
            for layer, w in enumerate(fr.task.model.dropout_widths):
                masks[layer][i, 0] = np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(kd, layer),
                    1.0 - fr.task.model.dropout_rate, (4, w)))
        shape = (k, d)
        forge_noise = None
        if adversary == "Noise":
            forge_noise = torch.from_numpy(np.array(
                jax.random.normal(k_adv, shape, jnp.float32)))
        elif adversary == "Lazy":
            k_pick, k_noise = jax.random.split(k_adv)
            forge_noise = (
                torch.from_numpy(np.array(jax.random.uniform(k_pick, (k,)))),
                torch.from_numpy(np.array(
                    jax.random.normal(k_noise, shape, jnp.float32))))
        dp_noise = torch.from_numpy(np.array(
            jax.random.normal(k_dp, shape, jnp.float32)))
        jstate, jm = jstep(jstate, bx, by, jmal, key)
        state, m = fr.step_prebatched(
            state, torch.from_numpy(np.array(bx)),
            torch.from_numpy(np.array(by)).long(), mal,
            dropout_masks=tuple(torch.from_numpy(mk) for mk in masks),
            forge_noise=forge_noise, dp_noise=dp_noise if dp else None)
        compare(jstate.server, jm, state.server, m, exact=False)


@pytest.mark.parametrize("adversary,adv_kw,dp,num_clients", [
    (None, None, True, None),
    ("Noise", None, False, None),
    ("Noise", None, True, 6),
    ("Lazy", {"mode": "copy"}, False, None),
    ("Lazy", {"mode": "copy", "copy_scale": 2.0}, True, 7),
    ("Lazy", {"mode": "replay", "copy_scale": 0.5}, True, None),
    ("ALIE", None, True, None),
])
def test_dense_round_matches_jax(adversary, adv_kw, dp, num_clients):
    """``step_prebatched`` under DP and the Noise / Lazy forges, two
    rounds, with ghost lanes in two cases."""
    _dense_pair(adversary, adv_kw, dp=dp, num_clients=num_clients)


def test_apply_dp_matches_jax():
    """``FedRound.apply_dp`` on its own: rows above and below the
    threshold, the JAX draws handed in."""
    from blades_tpu.core.round import FedRound as JFR

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(16, 3000)) * np.geomspace(1e-3, 1e-1, 16)[:, None]
         ).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = JFR.apply_dp(JFR(task=None, server=None, dp_clip_threshold=1.5,
                            dp_noise_factor=0.3), jnp.asarray(x), key)
    z = torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
    fr = FedRound(task=None, server=None, dp_clip_threshold=1.5,
                  dp_noise_factor=0.3)
    got = fr.apply_dp(torch.from_numpy(x), z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    xt = torch.from_numpy(x)
    assert FedRound(task=None, server=None).apply_dp(xt) is xt
    clip_only = FedRound(task=None, server=None, dp_clip_threshold=1.5)
    norms = np.linalg.norm(clip_only.apply_dp(torch.from_numpy(x)).numpy(),
                           axis=1)
    assert (norms <= 1.5 * (1 + 1e-6)).all() and (norms < 1.4).any()


# -- FedavgDPConfig and FEDAVG_DP ---------------------------------------------


@pytest.mark.parametrize("eps,delta,clip,bs", [
    (1.0, 1e-6, 1.0, 32), (10.0, 1e-6, 1.0, 32), (100.0, 1e-5, 2.5, 8)])
def test_noise_factor_matches_jax(eps, delta, clip, bs):
    want, got = JaxDPConfig(), FedavgDPConfig()
    for cfg in (want, got):
        cfg.privacy(epsilon=eps, delta=delta, clip_threshold=clip)
        cfg.training(train_batch_size=bs)
    assert got.noise_factor == want.noise_factor
    got.validate()
    assert got.dp_noise_factor == want.noise_factor
    fr = got.get_fed_round()
    assert (fr.dp_clip_threshold, fr.dp_noise_factor) == (clip,
                                                          want.noise_factor)


def test_dp_config_refuses_a_bad_budget():
    with pytest.raises(ValueError, match="epsilon"):
        FedavgDPConfig().update_from_dict({"dp_epsilon": 0.0}).validate()
    with pytest.raises(KeyError):
        get_algorithm_class("FEDAVG", return_config=True)[1].update_from_dict(
            {"dp_epsilon": 1.0})


# fedavg_dp.yaml's fields at one grid point, cut to 12 clients.
DP_RUN = {"dataset_config": {"type": "mnist", "num_clients": 12,
                             "train_bs": 8, "seed": 121},
          "global_model": "mlp", "evaluation_interval": 2,
          "dp_epsilon": 10.0, "dp_delta": 1e-6, "dp_clip_threshold": 1.0,
          "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}}}


@pytest.mark.parametrize("execution", ["dense", "streamed"])
def test_fedavg_dp_trains_through_fedavg(execution):
    """``FEDAVG_DP`` from the registry: finite rows, an evaluation; the
    streamed run takes the chunked finish."""
    cls, cfg = get_algorithm_class("FEDAVG_DP", return_config=True)
    assert isinstance(cfg, FedavgDPConfig)
    cfg.update_from_dict({**DP_RUN, "execution": execution,
                          "client_block": 4, "update_dtype": "float32"})
    algo = cfg.build(device="cpu")
    rows = [algo.train() for _ in range(2)]
    assert algo.streamed == (execution == "streamed")
    if algo.streamed:
        assert algo._step.routes == {"chunked": 2}
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    assert np.isfinite(rows[-1]["test_acc"])
    algo.stop()


def test_fedavg_dp_runs_from_the_command_line(tmp_path, capsys):
    from blades_tpu_torch.train import main

    rc = main(["run", "FEDAVG_DP", "--rounds", "2", "--device", "cpu",
               "--storage-path", str(tmp_path),
               "--config-json", json.dumps(DP_RUN)])
    assert rc == 0
    # The JAX command's layout: <storage>/<algo>_run/<algo>_run_00000/.
    rows = [json.loads(line) for line in
            (tmp_path / "fedavg_dp_run" / "fedavg_dp_run_00000"
             / "result.json").read_text().splitlines()]
    assert len(rows) == 2 and np.isfinite(rows[-1]["test_acc"])
    assert "== trial fedavg_dp_run_00000: 2 rounds ==" in \
        capsys.readouterr().out


# -- Noise and Lazy through Fedavg.train() ------------------------------------

ATTACK_RUN = {"dataset_config": {"type": "mnist", "num_clients": 8,
                                 "train_bs": 8},
              "global_model": "mlp", "evaluation_interval": 2,
              "num_malicious_clients": 2, "client_block": 4,
              "server_config": {"lr": 1.0,
                                "aggregator": {"type": "Median"}}}


@pytest.mark.parametrize("adversary,execution,streamed", [
    ({"type": "Noise"}, "streamed", True),
    ({"type": "Noise"}, "auto", False),
    ({"type": "Lazy"}, "dense", False),
    ({"type": "Lazy", "mode": "replay", "copy_scale": 2.0}, "auto", False),
])
def test_noise_and_lazy_train_through_fedavg(adversary, execution,
                                             streamed):
    """Noise on the streamed round (its chunked finish) and on the dense
    one; Lazy (both modes) on the dense round, where 'auto' keeps it."""
    from blades_tpu_torch.algorithms import FedavgConfig

    algo = FedavgConfig().update_from_dict(
        {**ATTACK_RUN, "adversary_config": adversary,
         "execution": execution}).build(device="cpu")
    rows = [algo.train() for _ in range(2)]
    assert algo.streamed == streamed
    if streamed:
        assert algo._step.routes == {"chunked": 2}
    assert all(np.isfinite(r["train_loss"]) for r in rows)
    assert np.isfinite(rows[-1]["test_acc"])
    algo.stop()


def test_lazy_has_no_streamed_formulation():
    from blades_tpu_torch.algorithms import FedavgConfig

    cfg = FedavgConfig().update_from_dict(
        {**ATTACK_RUN, "adversary_config": {"type": "Lazy"},
         "execution": "streamed"})
    with pytest.raises(NotImplementedError, match="no streamed forge"):
        cfg.build(device="cpu")


@pytest.mark.parametrize("adversary,execution", [
    ({"type": "Noise"}, "streamed"),
    ({"type": "Lazy", "mode": "replay"}, "dense"),
])
def test_noise_and_lazy_run_from_the_command_line(tmp_path, adversary,
                                                  execution):
    from blades_tpu_torch.train import main

    run = {**ATTACK_RUN, "adversary_config": adversary,
           "execution": execution}
    assert main(["run", "FEDAVG", "--rounds", "2", "--device", "cpu",
                 "--storage-path", str(tmp_path),
                 "--config-json", json.dumps(run)]) == 0
    rows = (tmp_path / "fedavg_run" / "fedavg_run_00000" / "result.json"
            ).read_text().splitlines()
    assert len(rows) == 2
