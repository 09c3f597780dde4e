"""The port's pass planner (blades_tpu_torch/parallel/streamed_geometry.py)
against the JAX one (blades_tpu/parallel/streamed_geometry.py) on the same
numpy-made buffer.

Each of the seven ``aggregate_streamed`` implementations and the three
``forge_streamed`` forgers runs on both sides.  Random draws are taken from
the JAX key and fed to the port: DnC's column subsamples and
SignGuard-attack's permutation and uniforms.  Tolerance ``rtol=2e-4,
atol=2e-5`` on aggregates and forged rows (as tests/test_pass_fusion.py
holds the kernel path against the chunk path): the statistics are f32 sums
taken in another order.  The planned traversal counts (``PassRecorder``
``executed`` / ``unfused``) must equal the JAX counts exactly.

GeoMed runs at ``maxiter=5`` here: its early stop tests whether the f32
objective changed at all, which reassociation flips by an iteration, and
near the optimum the objective is flat, so one more iteration moves the
median by ~1e-4 (the JAX package's own streamed and dense GeoMed differ by
as much).  The default configuration is held to the JAX one by the
objective it minimizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.adversaries import update_attacks as JU
from blades_tpu.ops import aggregators as JA
from blades_tpu.parallel import streamed_geometry as JG
from blades_tpu_torch.adversaries import update_attacks as TU
from blades_tpu_torch.ops import aggregators as TA
from blades_tpu_torch.parallel import streamed_geometry as TG

RTOL, ATOL = 2e-4, 2e-5
N, D, C = 10, 300, 64  # 300 = 4 * 64 + 44: the tail chunk overlaps

AGGREGATORS = [
    ("GeoMed", dict(maxiter=5)),
    ("Multikrum", dict(num_byzantine=2, k=3)),
    ("DnC", dict(num_byzantine=2, sub_dim=50, num_iters=3)),
    ("Centeredclipping", {}),
    ("Signguard", {}),
    ("Signguard", dict(agg="median")),
    ("Clippedclustering", {}),
    ("Clippedclustering", dict(signguard=True, linkage="single")),
    ("FLTrust", {}),
]


def _buf(seed=1, dtype=np.float32):
    """Benign rows around +0.3 and two outliers far on the other side (not
    duplicates: an angle of 0 between two rows puts ``arccos`` at its
    infinitely ill-conditioned end)."""
    rng = np.random.default_rng(seed)
    b = (rng.normal(size=(N, D)) + 0.3).astype(np.float32)
    b[N - 2:] = (-(b[:2].mean(0) * 5) - 1.0
                 + 0.5 * rng.normal(size=(2, D)).astype(np.float32))
    return b


def _dnc_draws(key, agg):
    keys = jax.random.split(key, agg.num_iters)
    idx = jax.vmap(lambda k: jax.random.permutation(k, D)[:agg.sub_dim])(keys)
    return torch.from_numpy(np.array(idx))


def _run(name, kw, b, *, sq=None, fuse=True, key=jax.random.PRNGKey(3)):
    rng = np.random.default_rng(7)
    trusted = rng.normal(size=(D,)).astype(np.float32)
    ja, ta = getattr(JA, name)(**kw), getattr(TA, name)(**kw)
    jrec, trec = JG.PassRecorder(), TG.PassRecorder()
    jout, jstate, jsq = JG.aggregate_streamed(
        ja, jnp.asarray(b), None if sq is None else jnp.asarray(sq),
        ja.init(D, N), key=key, trusted=jnp.asarray(trusted), d_chunk=C,
        recorder=jrec, fuse=fuse)
    draws = _dnc_draws(key, ja) if name == "DnC" else None
    tout, tstate, tsq = TG.aggregate_streamed(
        ta, torch.from_numpy(b), None if sq is None else torch.from_numpy(sq),
        ta.init(D, N), draws=draws, trusted=torch.from_numpy(trusted),
        d_chunk=C, recorder=trec, fuse=fuse)
    return (jout, jstate, jsq, jrec), (tout, tstate, tsq, trec)


@pytest.mark.parametrize("name,kw", AGGREGATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(AGGREGATORS)])
def test_aggregate_streamed_matches_jax(name, kw):
    (jout, jstate, jsq, jrec), (tout, tstate, tsq, trec) = _run(name, kw, _buf())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=1e-5)
    assert (trec.executed, trec.unfused) == (jrec.executed, jrec.unfused)
    if name == "Centeredclipping":
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                   rtol=RTOL, atol=ATOL)
    if name == "Clippedclustering":
        assert int(tstate["count"]) == int(jstate["count"])
        np.testing.assert_allclose(tstate["norm_history"].numpy(),
                                   np.asarray(jstate["norm_history"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("name,kw", [AGGREGATORS[1], AGGREGATORS[0]],
                         ids=["Multikrum", "GeoMed"])
def test_precomputed_norms_drop_the_norm_request(name, kw):
    """With ``sq`` given (the round's in-place pass took it), the first
    bundle carries no norm request: the counts the round stamps."""
    b = _buf(seed=2)
    sq = (b.astype(np.float64) ** 2).sum(1).astype(np.float32)
    (jout, _, _, jrec), (tout, _, _, trec) = _run(name, kw, b, sq=sq)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    assert (trec.executed, trec.unfused) == (jrec.executed, jrec.unfused)


@pytest.mark.parametrize("name,kw", AGGREGATORS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(AGGREGATORS)])
def test_fused_planner_equals_unfused(name, kw):
    b = _buf(seed=4)
    (_, _, _, jrec), (fused, _, fsq, frec) = _run(name, kw, b)
    (_, _, _, jrec_u), (unfused, _, usq, urec) = _run(name, kw, b, fuse=False)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(fsq.numpy(), usq.numpy(), rtol=1e-6)
    # Unfused, every request is its own traversal.
    assert urec.executed == urec.unfused == frec.unfused
    assert (urec.executed, urec.unfused) == (jrec_u.executed, jrec_u.unfused)


def _geomed_objective(b, median):
    b = b.astype(np.float64)
    return np.sqrt(((b - np.asarray(median, np.float64)) ** 2).sum(1)).mean()


@pytest.mark.parametrize("seed", [1, 2])
def test_default_geomed_reaches_the_jax_objective(seed):
    b = _buf(seed=seed)
    (jout, _, _, jrec), (tout, _, _, trec) = _run("GeoMed", {}, b)
    assert (trec.executed, trec.unfused) == (jrec.executed, jrec.unfused)
    np.testing.assert_allclose(_geomed_objective(b, tout.numpy()),
                               _geomed_objective(b, jout), rtol=1e-6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=2e-3,
                               atol=2e-3)


def test_kernel_bundles_and_loop_iterations_are_counted():
    b = _buf(seed=5)
    _, (_, _, _, rec) = _run("GeoMed", {}, b)
    assert rec.loop_iters >= 1
    # Every GeoMed bundle is of kernel kinds: the initial one and one per
    # Weiszfeld iteration that ran.
    assert rec.kernel_bundles == 1 + rec.loop_iters
    _, (_, _, _, rec) = _run("Signguard", dict(agg="median"), b)
    assert rec.kernel_bundles == 1  # the median bundle is chunk-only


FORGERS = [
    ("MinMaxAdversary", {}, "Multikrum"),
    ("MinMaxAdversary", {}, "Signguard"),
    ("SignGuardAdversary", {}, "Multikrum"),
    ("AttackclippedclusteringAdversary", {}, "Clippedclustering"),
]


@pytest.mark.parametrize("adv,kw,agg", FORGERS,
                         ids=[f"{a}-{g}" for a, _, g in FORGERS])
@pytest.mark.parametrize("with_sq", [False, True])
def test_forge_streamed_matches_jax(adv, kw, agg, with_sq):
    b = _buf(seed=6)
    mal_np = np.arange(N) < 3
    sq = (b.astype(np.float64) ** 2).sum(1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jagg = getattr(JA, agg)(num_byzantine=2) if agg == "Multikrum" \
        else getattr(JA, agg)()
    tagg = getattr(TA, agg)(num_byzantine=2) if agg == "Multikrum" \
        else getattr(TA, agg)()
    jrec, trec = JG.PassRecorder(), TG.PassRecorder()
    jf, jsq = JG.forge_streamed(
        getattr(JU, adv)(**kw), jnp.asarray(b), jnp.asarray(mal_np),
        jnp.asarray(sq) if with_sq else None, key, jagg,
        JG.PassPlanner(jnp.asarray(b), C, recorder=jrec))
    draws = None
    if adv == "SignGuardAdversary":
        k_perm, k_mag = jax.random.split(key)
        draws = (torch.from_numpy(np.array(jax.random.permutation(k_perm, D))),
                 torch.from_numpy(np.array(jax.random.uniform(k_mag, (D,)))))
    tf, tsq = TG.forge_streamed(
        getattr(TU, adv)(**kw), torch.from_numpy(b), torch.from_numpy(mal_np),
        torch.from_numpy(sq) if with_sq else None, tagg,
        TG.PassPlanner(torch.from_numpy(b), C, recorder=trec), draws=draws)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=1e-5)
    assert (trec.executed, trec.unfused) == (jrec.executed, jrec.unfused)


def test_chunk_grid_covers_every_column_once():
    for d, c in [(300, 64), (64, 64), (5, 7), (1000, 333)]:
        c_eff, k, starts = TG.chunk_grid(d, c)
        jc, jk, jstarts = JG.chunk_grid(d, c)
        assert (c_eff, k, starts) == (jc, jk, [int(s) for s in jstarts])
        counted = np.zeros(d, int)
        for i, s in enumerate(starts):
            mask = TG.new_cols(s, i, c_eff).numpy()
            np.testing.assert_array_equal(mask, np.asarray(JG.new_cols(s, i, c_eff)))
            counted[np.arange(s, s + c_eff)[mask]] += 1
        assert (counted == 1).all()


def test_check_applicable_raises_like_jax():
    for agg in (dict(name="Multikrum", num_byzantine=5),
                dict(name="DnC", num_byzantine=20)):
        kw = dict(agg)
        name = kw.pop("name")
        with pytest.raises(ValueError):
            JG.check_applicable(getattr(JA, name)(**kw), 10)
        with pytest.raises(ValueError):
            TG.check_applicable(getattr(TA, name)(**kw), 10)


# ---------------------------------------------------------------------------
# The JAX buffer contract: a (n, d_alloc) buffer, zero past the true width d
# ---------------------------------------------------------------------------

D_ALLOC = 512  # D rounded up to the JAX package's 512-column stripes


def _padded(b):
    out = np.zeros((b.shape[0], D_ALLOC), b.dtype)
    out[:, :D] = b
    return out


def _request(planner, kind, w, v, mal):
    if kind == "sq":
        return planner.sq_norms()
    if kind == "gram":
        return planner.gram()
    if kind == "signs":
        return planner.sign_counts()
    if kind == "dots":
        return planner.dots(v)
    if kind == "wsum":
        return planner.weighted_sum(w)
    if kind == "gram_dot":
        return planner.gram_dot(w)
    return planner.col_mean_std(mal)


@pytest.mark.parametrize("kind", ["sq", "gram", "signs", "dots", "wsum",
                                  "gram_dot", "mean_std"])
def test_padded_planner_matches_jax(kind):
    """``PassPlanner(buf, c, d=d)`` on a zero-padded ``(n, d_alloc)``
    buffer: the port's plain path against the JAX planner on the same
    buffer, its Pallas row-stats kernel in interpret mode for the kernel
    kinds (fed the whole padded buffer with ``d_true = d``) and its chunk
    loop for the benign column moments.  Every result has the true width."""
    b = _padded(_buf(seed=8))
    rng = np.random.default_rng(9)
    w = (rng.random(N) + 0.1).astype(np.float32)
    v = rng.normal(size=(D,)).astype(np.float32)
    mal = np.arange(N) < 2
    jp = JG.PassPlanner(jnp.asarray(b), C, d=D, use_kernel=True,
                        interpret=True)
    jh = _request(jp, kind, jnp.asarray(w), jnp.asarray(v), jnp.asarray(mal))
    jp.execute()
    tp = TG.PassPlanner(torch.from_numpy(b), C, d=D)
    th = _request(tp, kind, torch.from_numpy(w), torch.from_numpy(v),
                  torch.from_numpy(mal))
    tp.execute()
    got = th.value if kind != "mean_std" else torch.stack(th.value)
    want = np.asarray(jh.value if kind != "mean_std" else jnp.stack(jh.value))
    assert tuple(got.shape) == want.shape
    if kind in ("wsum", "mean_std"):
        assert got.shape[-1] == D
    if kind == "signs":
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy().sum(1) == D).all()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,kw", [AGGREGATORS[1], AGGREGATORS[0]],
                         ids=["Multikrum", "GeoMed"])
def test_aggregate_streamed_padded_equals_unpadded(name, kw):
    b = _buf(seed=10)
    outs = []
    for buf, d in ((b, None), (_padded(b), D)):
        rec = TG.PassRecorder()
        agg = getattr(TA, name)(**kw)
        out, _, sq = TG.aggregate_streamed(agg, torch.from_numpy(buf), None,
                                           agg.init(D, N), d_chunk=C, d=d,
                                           recorder=rec)
        outs.append((out, sq, rec))
    (u, usq, urec), (p, psq, prec) = outs
    assert tuple(p.shape) == (D,)
    np.testing.assert_allclose(p.numpy(), u.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(psq.numpy(), usq.numpy(), rtol=1e-6)
    assert ((prec.executed, prec.unfused, prec.kernel_bundles)
            == (urec.executed, urec.unfused, urec.kernel_bundles))


@pytest.mark.parametrize("adv,agg", [("MinMaxAdversary", "Multikrum"),
                                     ("AttackclippedclusteringAdversary",
                                      "Clippedclustering")],
                         ids=["MinMax", "Attackclippedclustering"])
def test_forge_streamed_padded_equals_unpadded(adv, agg):
    """The forged row has the true width on a padded buffer (the
    Attackclippedclustering forge reads one stored row directly)."""
    b = _buf(seed=12)
    mal = torch.from_numpy(np.arange(N) < 3)
    kw = dict(num_byzantine=2) if agg == "Multikrum" else {}
    rows = []
    for buf, d in ((b, None), (_padded(b), D)):
        planner = TG.PassPlanner(torch.from_numpy(buf), C, d=d)
        forged, _ = TG.forge_streamed(getattr(TU, adv)(), torch.from_numpy(buf),
                                      mal, None, getattr(TA, agg)(**kw),
                                      planner)
        rows.append(forged)
    assert tuple(rows[1].shape) == (D,)
    np.testing.assert_allclose(rows[1].numpy(), rows[0].numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("aggregator,adversary", [("Multikrum", "ALIE"),
                                                  ("Median", "MinMax")],
                         ids=["Multikrum-ALIE", "Median-MinMax"])
def test_rowgeom_round_allocates_the_padded_buffer(monkeypatch, aggregator,
                                                   adversary):
    """The MLP's row-geometry round trains into the first d columns of a
    ``(n, d_alloc)`` buffer, d_alloc = d rounded up to 512, and the forge's
    scatter and the in-place pass leave the padding columns zero."""
    from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.parallel import streamed

    seen = []

    def spy(real):
        def wrapped(agg, buf, *args, d=None, **kw):
            seen.append((tuple(buf.shape), d, buf[:, d:].abs().max().item(),
                         buf[:, :d].abs().max().item()))
            return real(agg, buf, *args, d=d, **kw)
        return wrapped

    monkeypatch.setattr(streamed, "aggregate_streamed",
                        spy(streamed.aggregate_streamed))
    monkeypatch.setattr(streamed, "aggregate_coordwise",
                        spy(streamed.aggregate_coordwise))
    n, f, shape = 8, 2, (8, 8, 1)
    fr = FedRound(
        task=TaskSpec(model="mlp", input_shape=shape, num_classes=10,
                      lr=0.1).build(),
        server=Server.from_config(aggregator, num_byzantine=f),
        adversary=get_adversary(adversary, num_clients=n, num_byzantine=f),
        batch_size=4)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(n, 8) + shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(n, 8))).long()
    step = streamed.streamed_step(fr, client_block=2, malicious_prefix=f,
                                  device="cpu")
    _, m = step(fr.init(0, n, device="cpu"), x, y,
                torch.full((n,), 8), make_malicious_mask(n, f), 1)
    assert np.isfinite(float(m["train_loss"]))
    d = sum(p.numel() for p in fr.init(0, n, device="cpu").server.params
            .values())
    d_alloc = -(-d // 512) * 512
    assert d_alloc != d  # the MLP's 43,914 parameters: 118 padding columns
    assert len(seen) == 1
    buf_shape, d_seen, pad_max, body_max = seen[0]
    assert buf_shape == (n, d_alloc) and d_seen == d
    assert pad_max == 0.0 and body_max > 0.0


def test_gram_route_takes_wgmma_only_for_aligned_bf16_rows():
    from blades_tpu_torch.ops._cuda import gram_route

    bf16 = torch.bfloat16
    assert gram_route(bf16, 4_903_424, 0) == "wgmma"  # the padded round
    assert gram_route(bf16, 1008, 1 << 20) == "wgmma"
    assert gram_route(bf16, 4_903_242, 0) == "mma"    # 9,806,484-byte rows
    assert gram_route(bf16, 1004, 0) == "mma"         # 8-byte-aligned rows
    assert gram_route(bf16, 1008, 8) == "mma"         # an unaligned base
    assert gram_route(torch.float32, 1024, 0) == "f32"


@pytest.mark.parametrize("d,address,route", [
    (1024, 0, "wgmma"),           # 16-byte rows on an aligned base
    (4_903_248, 0, "wgmma"),      # the wire payload, wire_width(d)
    (1040, 1 << 20, "wgmma"),
    (1000, 0, "mma"),             # 1000 % 16 == 8
    (1024, 4, "mma"),             # 4-byte cp.async rows
    (1024, 8, "mma"),
])
def test_gram_route_takes_wgmma_for_aligned_int8_rows(d, address, route):
    from blades_tpu_torch.ops._cuda import gram_route

    assert gram_route(torch.int8, d, address) == route
