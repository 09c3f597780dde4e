"""The port's streamed round (blades_tpu_torch/parallel/streamed.py) against
the JAX ``streamed_step`` (blades_tpu/parallel/streamed.py) over two rounds.

Both sides start from the same flax-initialised parameters (carried across
by blades_tpu_torch/convert.py), see the same numpy-made client data, and
use the same batches and dropout masks: the test recomputes the JAX round's
draws with the same ``jax.random.split`` chain (streamed.py's five-way
round split, data/sampler.py's per-client and per-batch splits, and
layers.keyed_dropout's ``fold_in``) and hands them to the port.  On the
CPU the JAX round finishes through its chunked finish at f32 storage; the
port finishes through the plain versions of its fused finishes, on the
compact branch (block-aligned malicious prefix) and on the full branch.

Tolerance ``rtol=1e-5, atol=1e-6`` on server parameters and metrics: the
benign mean and variance behind the forged row, the trimmed sums and the
row norms are f32 sums taken in different orders.

Row-geometry rounds (the port's planner and row-stats bundles against the
JAX planner's chunk loop) hold ``rtol=2e-4, atol=2e-5``, as the JAX package
holds its streamed row-geometry round against its dense one, and stamp the
same ``hbm_passes`` / ``hbm_passes_unfused`` exactly.  GeoMed runs at
``maxiter=5`` there: its early stop tests whether the f32 objective changed
at all, which reassociation flips by an iteration (see
tests/test_torch_streamed_geometry.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.parallel.streamed import streamed_step as jax_streamed_step
from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec
from blades_tpu_torch.parallel.streamed import streamed_step
from blades_tpu_torch.utils.tree import FlatLayout

RTOL, ATOL = 1e-5, 1e-6
RG_RTOL, RG_ATOL = 2e-4, 2e-5
METRICS = ("train_loss", "update_norm_mean", "agg_norm")


def _jax_draws(key, n, lengths, batch_size, num_batches, model):
    """The batch indices and dropout keep-masks of one JAX streamed round."""
    k_sample, k_train, _, _, _ = jax.random.split(key, 5)
    idx = np.zeros((n, num_batches, batch_size), np.int64)
    widths = getattr(model, "dropout_widths", ())
    rate = getattr(model, "dropout_rate", 0.0)
    masks = [np.zeros((n, num_batches, batch_size, w), bool) for w in widths]
    for i, (ks, kt) in enumerate(zip(jax.random.split(k_sample, n),
                                     jax.random.split(k_train, n))):
        for s, (kb, kd) in enumerate(zip(jax.random.split(ks, num_batches),
                                         jax.random.split(kt, num_batches))):
            idx[i, s] = np.asarray(jax.random.randint(
                kb, (batch_size,), 0, max(int(lengths[i]), 1)))
            for layer, w in enumerate(widths):
                masks[layer][i, s] = np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(kd, layer), 1.0 - rate,
                    (batch_size, w)))
    return (torch.from_numpy(idx),
            tuple(torch.from_numpy(m) for m in masks) or None)


def _run_pair(model, shape, aggregator, adversary, n, f, prefix, block,
              batch_size=4, shard=8, rounds=2, adv_kw=None, fuse=True,
              update_dtype="float32", d_chunk=1 << 17, momentum=0.0):
    adv_kw = adv_kw or {}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, shard) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(n, shard)).astype(np.int32)
    lengths = np.full((n,), shard, np.int32)
    lengths[-1] = shard - 3  # one short shard: indices stay below it

    spec = dict(model=model, input_shape=shape, num_classes=10, lr=0.1,
                momentum=momentum)
    jfr = JaxFedRound(
        task=JaxTaskSpec(**spec).build(),
        server=JaxServer.from_config(aggregator=aggregator, num_byzantine=f,
                                     lr=0.5),
        adversary=jax_adversary({"type": adversary, **adv_kw},
                                num_clients=n, num_byzantine=f),
        batch_size=batch_size)
    fr = FedRound(
        task=TaskSpec(**spec).build(),
        server=Server.from_config(aggregator, num_byzantine=f, lr=0.5),
        adversary=get_adversary({"type": adversary, **adv_kw},
                                num_clients=n, num_byzantine=f),
        batch_size=batch_size)

    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n),
                       client_opt=fr.task.init_client_opt_state(params, n))
    jstep = jax_streamed_step(jfr, client_block=block,
                              update_dtype=getattr(jnp, update_dtype),
                              donate=False, malicious_prefix=prefix,
                              fuse_rowgeom=fuse, d_chunk=d_chunk)
    step = streamed_step(fr, client_block=block,
                         update_dtype=getattr(torch, update_dtype),
                         malicious_prefix=prefix, fuse_rowgeom=fuse,
                         device="cpu")
    jmal = jnp.arange(n) < f
    mal = make_malicious_mask(n, f)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    out = []
    for r, key in enumerate(jax.random.split(jax.random.PRNGKey(7), rounds)):
        idx, masks = _jax_draws(key, n, lengths, batch_size, 1,
                                fr.task.model)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(lengths), jmal, key)
        state, m = step(state, xt, yt, torch.from_numpy(lengths), mal, r,
                        batch_idx=idx, dropout_masks=masks)
        # The round advances the traces in place: keep this round's.
        kept = state if not momentum else RoundState(
            server=state.server,
            client_opt={k: v.clone() for k, v in state.client_opt.items()})
        out.append((jstate, jm, kept, m))
    return out


def _compare(out, elided, rtol=RTOL, atol=ATOL, passes=False):
    for jstate, jm, state, m in out:
        want = np.asarray(ravel_pytree(jstate.server.params)[0])
        got = np.asarray(ravel_pytree(params_to_jax(state.server.params))[0])
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=rtol, atol=atol)
        for k in ("hbm_passes", "hbm_passes_unfused"):
            if passes:
                assert int(m[k]) == int(jm[k]), k
            else:
                assert k not in m
        assert int(m["round"]) == int(jm["round"])
        if elided:
            assert int(m["elided_lanes"]) == int(jm["elided_lanes"])
        else:
            assert "elided_lanes" not in m


@pytest.mark.parametrize("branch", ["compact", "full"])
@pytest.mark.parametrize("aggregator,adversary,adv_kw", [
    ("Median", "ALIE", None),
    ("Trimmedmean", "IPM", {"scale": 2.0}),
])
def test_mlp_two_rounds_match_jax(aggregator, adversary, adv_kw, branch):
    n, f = 12, 4
    prefix = f if branch == "compact" else None
    out = _run_pair("mlp", (8, 8, 1), aggregator, adversary, n, f, prefix,
                    block=4, adv_kw=adv_kw)
    _compare(out, elided=prefix is not None)


@pytest.mark.parametrize("branch", ["compact", "full"])
def test_coordwise_round_finishes_on_the_padded_buffer(monkeypatch, branch):
    """The fused finish gets a ``(rows, d_alloc)`` buffer, d_alloc = d
    rounded up to 512 as the JAX package allocates it, with zero padding
    columns -- the compact branch's buffer comes from ``torch.empty``, here
    filled with NaN so that a pad left unzeroed would show -- and the
    round still matches the JAX round (the MLP's d = 43,914 is not a
    multiple of 512)."""
    from blades_tpu_torch.parallel import streamed

    real_empty = torch.empty

    def nan_empty(*args, **kw):
        t = real_empty(*args, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", nan_empty)
    seen = []

    def spy(name):
        real = getattr(streamed, name)

        def wrapped(buf, *args, **kw):
            seen.append((name, tuple(buf.shape), bool(torch.isfinite(
                buf).all()), float(buf[:, 43_914:].abs().max())))
            return real(buf, *args, **kw)
        return wrapped

    for name in ("fused_finish", "fused_finish_compact"):
        monkeypatch.setattr(streamed, name, spy(name))
    n, f = 12, 4
    out = _run_pair("mlp", (8, 8, 1), "Median", "ALIE", n, f,
                    f if branch == "compact" else None, block=4, rounds=1)
    _compare(out, elided=branch == "compact")
    d = sum(p.numel() for p in out[0][2].server.params.values())
    assert d == 43_914
    name = "fused_finish_compact" if branch == "compact" else "fused_finish"
    rows = n - f if branch == "compact" else n
    assert seen == [(name, (rows, 44_032), True, 0.0)]


def test_unaligned_prefix_takes_the_full_branch():
    """A prefix that is not block-aligned elides the whole blocks inside it
    and finishes on the full matrix (the straddling block trains)."""
    out = _run_pair("mlp", (8, 8, 1), "Median", "ALIE", 12, 5, 5, block=4,
                    rounds=1)
    _compare(out, elided=True)


GEOMED5 = {"type": "GeoMed", "maxiter": 5}


@pytest.mark.parametrize("aggregator", [
    "Multikrum", GEOMED5, "Signguard", "Centeredclipping"],
    ids=["Multikrum", "GeoMed", "Signguard", "Centeredclipping"])
def test_mlp_rowgeom_rounds_match_jax(aggregator):
    """ALIE with the malicious prefix elided, two rounds (Centeredclipping's
    momentum carries across); under Signguard ALIE negates the global first
    half of the deviation."""
    out = _run_pair("mlp", (8, 8, 1), aggregator, "ALIE", 12, 4, 4, block=4)
    _compare(out, elided=True, rtol=RG_RTOL, atol=RG_ATOL, passes=True)
    if aggregator == "Centeredclipping":
        jstate, _, state, _ = out[-1]
        np.testing.assert_allclose(state.server.agg_state.numpy(),
                                   np.asarray(jstate.server.agg_state),
                                   rtol=RG_RTOL, atol=RG_ATOL)


def test_mlp_rowgeom_round_with_overlapping_chunks_matches_jax(monkeypatch):
    """Column chunks of 10,000 over the MLP's 43,914 parameters: the tail
    chunk overlaps its predecessor, the in-place pass writes back only the
    uncovered columns, and ALIE's negated first half under Signguard spans
    chunks by global coordinate."""
    from blades_tpu_torch.parallel import streamed

    monkeypatch.setattr(streamed, "D_CHUNK", 10_000)
    out = _run_pair("mlp", (8, 8, 1), "Signguard", "ALIE", 12, 4, 4,
                    block=4, rounds=1, d_chunk=10_000)
    _compare(out, elided=True, rtol=RG_RTOL, atol=RG_ATOL, passes=True)


@pytest.mark.parametrize("aggregator,adversary", [
    ("Median", "MinMax"), ("Multikrum", "MinMax"), (GEOMED5, "IPM")],
    ids=["Median-MinMax", "Multikrum-MinMax", "GeoMed-IPM"])
def test_mlp_row_forger_and_unfused_rounds_match_jax(aggregator, adversary):
    """A row-geometry forger before a coordinate-wise and a row-geometry
    aggregator, and the unfused planner (one traversal per statistic)."""
    out = _run_pair("mlp", (8, 8, 1), aggregator, adversary, 12, 4, 4,
                    block=4, rounds=1, fuse=adversary == "MinMax")
    _compare(out, elided=True, rtol=RG_RTOL, atol=RG_ATOL, passes=True)


def test_every_row_geometry_aggregator_runs_streamed():
    """Each of the seven under ALIE (FLTrust with root data) runs, stays
    finite and stamps the JAX round's planned traversals.  DnC's and the
    root data's draws come from each side's own generator, so only the
    counts are compared."""
    n, f, shape = 8, 2, (8, 8, 1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, 8) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(n, 8)).astype(np.int32)
    tx = rng.normal(size=(16,) + shape).astype(np.float32)
    ty = rng.integers(0, 10, size=(16,)).astype(np.int32)
    lengths = np.full((n,), 8, np.int32)
    spec = dict(model="mlp", input_shape=shape, num_classes=10, lr=0.1)
    for name in ("GeoMed", "DnC", "Multikrum", "Centeredclipping",
                 "Signguard", "Clippedclustering", "FLTrust"):
        agg = {"type": name}
        if name == "DnC":
            agg["sub_dim"] = 64
        trusted = name == "FLTrust"
        jfr = JaxFedRound(
            task=JaxTaskSpec(**spec).build(),
            server=JaxServer.from_config(aggregator=agg, num_byzantine=f),
            adversary=jax_adversary("ALIE", num_clients=n, num_byzantine=f),
            batch_size=4,
            trusted_data=(jnp.asarray(tx), jnp.asarray(ty)) if trusted
            else None)
        fr = FedRound(
            task=TaskSpec(**spec).build(),
            server=Server.from_config(agg, num_byzantine=f),
            adversary=get_adversary("ALIE", num_clients=n, num_byzantine=f),
            batch_size=4,
            trusted_data=(torch.from_numpy(tx), torch.from_numpy(ty).long())
            if trusted else None)
        jstate = jfr.init(jax.random.PRNGKey(0), n)
        _, jm = jax_streamed_step(jfr, client_block=2, donate=False,
                                  malicious_prefix=f)(
            jstate, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths),
            jnp.arange(n) < f, jax.random.PRNGKey(1))
        step = streamed_step(fr, client_block=2, malicious_prefix=f,
                             device="cpu")
        state, m = step(fr.init(0, n, device="cpu"), torch.from_numpy(x),
                        torch.from_numpy(y).long(), torch.from_numpy(lengths),
                        make_malicious_mask(n, f), 1)
        assert np.isfinite(float(m["train_loss"])), name
        assert all(bool(torch.isfinite(v).all())
                   for v in state.server.params.values()), name
        assert int(m["elided_lanes"]) == int(jm["elided_lanes"]) == f
        for k in ("hbm_passes", "hbm_passes_unfused"):
            assert int(m[k]) == int(jm[k]), (name, k)
        assert step.passes.kernel_bundles >= 1


def _jax_traces(opt):
    """The JAX momentum traces as one ``(n, d)`` array in ravel order."""
    trace = opt[0].trace
    n = jax.tree.leaves(trace)[0].shape[0]
    return np.stack([np.asarray(ravel_pytree(
        jax.tree.map(lambda t: t[i], trace))[0]) for i in range(n)])


@pytest.mark.parametrize("branch", ["compact", "full"])
def test_client_momentum_rounds_match_jax(branch):
    """Client momentum 0.9 on the streamed round: three chained MLP rounds
    under ALIE with a malicious prefix (elided blocks: on the compact
    branch the whole prefix, on the full one its first block).  Server
    parameters, metrics and every client's trace agree with the JAX
    streamed round's; the elided lanes' traces stay zero on both sides."""
    n, f = 12, 4
    block = 4 if branch == "compact" else 3
    out = _run_pair("mlp", (8, 8, 1), "Median", "ALIE", n, f, f, block,
                    rounds=3, momentum=0.9)
    _compare(out, elided=True)
    elided = (f // block) * block
    for jstate, _, state, _ in out:
        layout = FlatLayout(state.server.params)
        got = torch.cat([layout.flat_leaf(lf, state.client_opt[lf.name],
                                          batch_dims=1)
                         for lf in layout.leaves], 1).numpy()
        want = _jax_traces(jstate.client_opt)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert not got[:elided].any() and not want[:elided].any()
        assert np.abs(got[elided:]).max(1).min() > 0  # trained lanes move
    # Momentum moved the second and third rounds (the first is plain SGD:
    # the traces start at zero and there is one local step).
    plain = _run_pair("mlp", (8, 8, 1), "Median", "ALIE", n, f, f, block,
                      rounds=3)
    for r, ((_, _, state, _), (_, _, p_state, _)) in enumerate(
            zip(out, plain)):
        same = all(torch.equal(state.server.params[k], v)
                   for k, v in p_state.server.params.items())
        assert same == (r == 0), r


@pytest.mark.slow  # ~22 s on a CPU, most of it the JAX ResNet-10 compile
def test_resnet10_round_matches_jax():
    """16x16 inputs: at 8x8 the last stage is 1x1 and its BatchNorms over a
    batch of 4 are too ill-conditioned for an f32 comparison (see
    tests/test_torch_models.py)."""
    out = _run_pair("resnet", (16, 16, 3), "Median", "ALIE", 8, 4, 4,
                    block=4, rounds=1)
    _compare(out, elided=True)


@pytest.mark.slow  # ResNet-10 compile on the JAX side, as above
def test_resnet10_rowgeom_round_matches_jax():
    """The row-geometry slice at ResNet-10 width (16x16 inputs): Multikrum
    under ALIE with the prefix elided, one round."""
    out = _run_pair("resnet", (16, 16, 3), "Multikrum", "ALIE", 8, 2, 2,
                    block=2, rounds=1)
    _compare(out, elided=True, rtol=RG_RTOL, atol=RG_ATOL, passes=True)
