"""The port's ``row_stats_bundle`` (blades_tpu_torch/ops/rowstats.py) against
the JAX Pallas kernel (blades_tpu/ops/pallas_rowstats.py) run in interpret
mode, on identical numpy-made matrices.

On the CPU the port runs its plain version.  Tolerance ``rtol = atol =
2e-4`` for the f32 sums (as tests/test_pass_fusion.py holds the kernel
against the chunk path): both sides sum in f32, in another order.  Sign
counts, and the int8 self-contractions (``sq``, ``gram``: exact integer
sums on both sides), are compared for equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.ops.pallas_rowstats import row_stats_bundle as jax_bundle
from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.ops.rowstats import row_stats_bundle, row_stats_bundle_plain

TOL = 2e-4
N, D = 9, 700  # ragged: n is no sublane multiple, d no stripe multiple


def _matrix(dtype, seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        x = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        x[:, ::7] = 0  # zeros for the sign census
        return x, jnp.asarray(x), torch.from_numpy(x)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, ::7] = 0.0
    if dtype == "float32":
        return x, jnp.asarray(x), torch.from_numpy(x)
    jx = jnp.asarray(x, jnp.bfloat16)
    return x, jx, torch.from_numpy(x).to(torch.bfloat16)


def _vectors(seed=1, n=N, d=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, d)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=(2, n)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=(2, n)).astype(np.float32))


def _both(jx, tx, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = jax_bundle(jx, interpret=True, **jkw)
    got = row_stats_bundle(tx, **tkw)
    assert set(got) == set(want)
    return {k: (np.asarray(got[k]), np.asarray(want[k])) for k in want}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_every_statistic_matches_jax(dtype):
    _, jx, tx = _matrix(dtype)
    v, w, g = _vectors()
    out = _both(jx, tx, sq=True, gram=True, signs=True, dots=v, weights=w,
                gram_dot=g)
    for name, (got, want) in out.items():
        assert got.shape == want.shape, name
        assert got.dtype == np.float32, name
        if name == "signs" or (dtype == "int8" and name in ("sq", "gram")):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("bundle", [
    dict(sq=True, gram=True, signs=True),
    dict(dots="v"),
    dict(weights="w"),
    dict(gram_dot="g"),
    dict(weights="w", gram_dot="g"),
])
def test_each_bundle_returns_only_what_it_asks(bundle):
    _, jx, tx = _matrix("bfloat16", seed=3)
    v, w, g = _vectors(seed=4)
    pick = {"v": v, "w": w, "g": g}
    kw = {k: pick.get(val, val) if isinstance(val, str) else val
          for k, val in bundle.items()}
    for name, (got, want) in _both(jx, tx, **kw).items():
        if name == "signs":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=name)


def test_sign_zero_count_uses_the_true_width():
    """Columns past ``d_true`` are zero padding: the zero count, and the
    weighted sums' width, follow ``d_true``."""
    x, _, _ = _matrix("float32", seed=5)
    pad = np.concatenate([x, np.zeros((N, 36), np.float32)], axis=1)
    _, w, _ = _vectors()
    out = _both(jnp.asarray(pad), torch.from_numpy(pad), signs=True,
                weights=w, d_true=D)
    np.testing.assert_array_equal(*out["signs"])
    assert out["signs"][0][:, 2].max() <= D
    assert out["wsum"][0].shape == (2, D)
    np.testing.assert_allclose(*out["wsum"], rtol=TOL, atol=TOL)


def test_plain_version_is_what_cpu_tensors_get():
    _, _, tx = _matrix("float32", seed=6)
    a = row_stats_bundle(tx, sq=True, gram=True)
    b = row_stats_bundle_plain(tx, sq=True, gram=True)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_bad_bundles_raise():
    x = torch.zeros(3, 5)
    with pytest.raises(ValueError, match="empty"):
        row_stats_bundle(x)
    with pytest.raises(ValueError, match="not supported"):
        row_stats_bundle(x.double(), sq=True)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _cuda.launch_rowstats("row_stats_bundle", x, sq=True)


# ---- the ring route (rowstats_ring_kernel): route, plan, tall matrices ----


@pytest.mark.parametrize("dtype,d,address,rows,route", [
    (torch.bfloat16, 4_903_424, 0, 1000, "ring"),     # the padded round
    (torch.bfloat16, 4_903_424, 0, 20_000, "ring"),   # no row cap
    (torch.bfloat16, 1008, 1 << 20, 5000, "ring"),
    (torch.bfloat16, 4_903_242, 0, 1000, "slab"),     # 9,806,484-byte rows
    (torch.bfloat16, 1004, 0, 40, "slab"),            # 8-byte-aligned rows
    (torch.bfloat16, 1008, 8, 40, "slab"),            # an unaligned base
    (torch.float32, 1024, 0, 1000, "ring"),
    (torch.float32, 1022, 0, 9, "slab"),
    (torch.float32, 1024, 4, 9, "slab"),
    (torch.int8, 1040, 16, 77, "ring"),               # the wire domain
    (torch.int8, 1000, 0, 1000, "slab"),              # 1000 % 16 == 8
])
def test_rowstats_route_takes_ring_only_for_16_byte_aligned_rows(dtype, d,
                                                                 address,
                                                                 rows, route):
    assert _cuda.rowstats_route(dtype, d, address, rows) == route


# (R dots, U column-pass vectors, G gram_dot vectors, KF float partials,
# integer partials) of the planner's bundles and of the widest smoke bundle.
RING_BUNDLES = {
    "geomed": (0, 1, 1, 1, False),
    "wsum": (0, 1, 0, 0, False),
    "signs": (0, 0, 0, 0, True),
    "sq+dots": (1, 0, 0, 2, False),
    "all": (2, 4, 2, 5, True),
}


@pytest.mark.parametrize("bundle", sorted(RING_BUNDLES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_ring_plan_fits_shared_memory_at_any_row_count(dtype, bundle):
    """The mirror of the kernel's shared-memory layout stays under the
    227 KB a block may use from 1 to 20,000 rows: past what fits, the
    per-row partials move to global memory, never the cap."""
    R, U, G, KF, want_ip = RING_BUNDLES[bundle]
    esize = torch.empty((), dtype=dtype).element_size()
    moved = False
    for rows in range(1, 20_001):
        p = _cuda.ring_plan(dtype, rows, R, U, G, KF, want_ip)
        assert p.smem <= _cuda.RING_SMEM_CAP, (rows, p)
        assert p.smem == _cuda.ring_smem(rows, esize, p.rowb, p.gh, p.ahead,
                                         R, U, G, KF, want_ip, p.part_smem)
        assert p.ahead >= 1
        unit = 8 * 512 // (p.rowb // 16)  # kRgIlp sweeps of the block
        assert p.gh % unit == 0 and p.gh >= unit
        moved |= not p.part_smem
    # 20,000 rows of partials never fit beside the ring (a weighted sum
    # alone keeps none).
    assert moved == bool(KF or want_ip)


# ---- the Gram's plan (_cuda.gram_plan, bt_gram_plan's mirror) -----------

GRAM_PLAN_ROWS = (1, 77, 128, 130, 1000, 2000)
GRAM_PLAN_WIDTHS = (16, 1040, 65_536, 65_552, 200_016, 4_903_248, 21_328_384)


@pytest.mark.parametrize("rows", GRAM_PLAN_ROWS)
def test_int8_wgmma_gram_plan_keeps_every_span_int32_exact(rows):
    """On the H100 (132 SMs, one TMA + wgmma CTA a SM) every int8 span is
    whole 128-column stages and at most 65,536 columns, where a partial is
    at most 65,536 x 128^2 = 2^30 in magnitude; the splits cover d once."""
    nt = -(-rows // 128)
    for d in GRAM_PLAN_WIDTHS:
        p = _cuda.gram_plan(torch.int8, "wgmma", rows, d, per_sm=1, sms=132)
        assert p.tile == 128 and p.npairs == nt * (nt + 1) // 2, (d, p)
        assert p.span % 128 == 0 and 0 < p.span <= _cuda.INT8_SPAN, (d, p)
        assert p.splits * p.span >= d > (p.splits - 1) * p.span, (d, p)
        assert p.span * 128 ** 2 < 2 ** 31


@pytest.mark.parametrize("dtype,rows,d,plan", [
    # bf16: 64-column stages; the wave-filling 11 splits x 14 to stay within
    # 512 stages a CTA (as the kernel has been planned since it was added).
    (torch.bfloat16, 1000, 4_903_424, (128, 36, 154, 31_872)),
    # int8: 128-column stages; 11 x 7 = 77 splits, 21 whole waves.
    (torch.int8, 1000, 4_903_248, (128, 36, 77, 63_744)),
])
def test_wgmma_gram_plan_at_the_rounds_shapes(dtype, rows, d, plan):
    assert tuple(_cuda.gram_plan(dtype, "wgmma", rows, d)) == plan


def test_plain_int8_gram_is_exact_past_int32_and_f32():
    """The plain version's int8 Gram (and norms) is the exact integer X X^T
    rounded to f32 once, at a width where the all -128 row's self-product
    (131,088 x 128^2 = 2,147,745,792) wraps an int32 sum and the random
    rows' self-products lose low-order bits to an f32 sum."""
    d = 131_088
    rng = np.random.default_rng(11)
    alt = np.arange(d) % 2 == 0
    x = np.stack([np.full(d, -128), np.full(d, 127),
                  np.where(alt, 127, -128), np.where(alt, -128, 127),
                  rng.integers(-128, 128, d),
                  rng.integers(-128, 128, d)]).astype(np.int8)
    x64 = x.astype(np.int64)
    exact = x64 @ x64.T
    assert exact[0, 0] == 2_147_745_792 > 2 ** 31 - 1
    f32_sum = np.cumsum(x[4].astype(np.float32) ** 2, dtype=np.float32)[-1]
    assert exact[4, 4] > 2 ** 24 and int(f32_sum) != exact[4, 4]
    got = row_stats_bundle_plain(torch.from_numpy(x), sq=True, gram=True)
    np.testing.assert_array_equal(got["gram"].numpy(),
                                  exact.astype(np.float32))
    np.testing.assert_array_equal(got["sq"].numpy(),
                                  np.diagonal(exact).astype(np.float32))


def test_plain_version_honours_the_shared_weight_map():
    _, _, tx = _matrix("float32", seed=11)
    _, w, g = _vectors(seed=12)
    tw = torch.from_numpy(w)
    gd = torch.stack([tw[0], torch.from_numpy(g)[1]])
    shared = row_stats_bundle(tx, weights=tw, gram_dot=gd,
                              gram_dot_shared=(0, -1))
    apart = row_stats_bundle(tx, weights=tw, gram_dot=gd)
    for k in apart:
        assert torch.equal(shared[k], apart[k]), k
    with pytest.raises(ValueError, match="gram_dot_shared"):
        row_stats_bundle(tx, weights=tw, gram_dot=gd, gram_dot_shared=(2, -1))
    with pytest.raises(ValueError, match="gram_dot_shared"):
        row_stats_bundle(tx, weights=tw, gram_dot=gd, gram_dot_shared=(0,))


TALL_N, TALL_D, TALL_C = 5000, 96, 40  # above the slab route's ~4,820 rows


def _tall(dtype, seed):
    rng = np.random.default_rng(seed)
    b = (rng.normal(size=(TALL_N, TALL_D)) + 0.3).astype(np.float32)
    b[:, ::7] = 0.0
    b[-200:] = -3.0 * b[:200] + rng.normal(size=(200, TALL_D))
    if dtype == "float32":
        return jnp.asarray(b), torch.from_numpy(b)
    return (jnp.asarray(b, jnp.bfloat16),
            torch.from_numpy(b).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_5000_rows_geomed_matches_the_jax_planner(dtype):
    """GeoMed over 5,000 rows, a height the JAX planner serves by its chunk
    loop and the port's kernel route must serve too."""
    from blades_tpu.ops import aggregators as JA
    from blades_tpu.parallel import streamed_geometry as JG
    from blades_tpu_torch.ops import aggregators as TA
    from blades_tpu_torch.parallel import streamed_geometry as TG

    jb, tb = _tall(dtype, seed=21)
    ja, ta = JA.GeoMed(maxiter=5), TA.GeoMed(maxiter=5)
    jrec, trec = JG.PassRecorder(), TG.PassRecorder()
    jout, _, jsq = JG.aggregate_streamed(ja, jb, None, ja.init(TALL_D, TALL_N),
                                         d_chunk=TALL_C, recorder=jrec)
    tout, _, tsq = TG.aggregate_streamed(ta, tb, None, ta.init(TALL_D, TALL_N),
                                         d_chunk=TALL_C, recorder=trec)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL,
                               atol=2e-5)
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=1e-5)
    assert (trec.executed, trec.unfused) == (jrec.executed, jrec.unfused)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_5000_rows_bundle_matches_the_jax_planner(dtype):
    """A weighted sum + norms + sign counts bundle over 5,000 rows through
    both planners."""
    from blades_tpu.parallel import streamed_geometry as JG
    from blades_tpu_torch.parallel import streamed_geometry as TG

    jb, tb = _tall(dtype, seed=22)
    w = np.random.default_rng(23).uniform(0.1, 1.0, TALL_N).astype(np.float32)
    jp, tp = JG.PassPlanner(jb, TALL_C), TG.PassPlanner(tb, TALL_C)
    jh = (jp.weighted_sum(jnp.asarray(w)), jp.sq_norms(), jp.sign_counts())
    th = (tp.weighted_sum(torch.from_numpy(w)), tp.sq_norms(),
          tp.sign_counts())
    jp.execute()
    tp.execute()
    for j, t, name in zip(jh, th, ("wsum", "sq", "signs")):
        got, want = t.value.numpy(), np.asarray(j.value)
        assert got.shape == want.shape, name
        if name == "signs":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=name)


@pytest.mark.parametrize("name", ["GeoMed", "Centeredclipping"])
def test_planner_hands_a_shared_weight_vector_over_once(monkeypatch, name):
    """GeoMed's and Centeredclipping's iterates ask for a weighted sum and a
    Gram-vector product of ONE vector: the planner marks the gram_dot row
    as that weights row (by identity, with no device sync), and the
    aggregate is bit-identical to the one without the mark."""
    from blades_tpu_torch.ops import aggregators as TA
    from blades_tpu_torch.parallel import streamed_geometry as TG

    _, tb = _tall("float32", seed=24)
    tb = tb[:64]
    real = TG.row_stats_bundle
    seen = []

    def spy(buf, **kw):
        seen.append(kw.get("gram_dot_shared"))
        return real(buf, **kw)

    def strip(buf, **kw):
        kw.pop("gram_dot_shared", None)
        return real(buf, **kw)

    outs = []
    for fn in (spy, strip):
        monkeypatch.setattr(TG, "row_stats_bundle", fn)
        agg = (TA.GeoMed(maxiter=3) if name == "GeoMed"
               else TA.Centeredclipping())
        out, _, _ = TG.aggregate_streamed(agg, tb, None, agg.init(TALL_D, 64),
                                          d_chunk=TALL_C)
        outs.append(out)
    assert (0,) in seen and all(s in (None, (0,)) for s in seen)
    assert seen.count((0,)) >= (3 if name == "GeoMed" else 1)
    assert torch.equal(outs[0], outs[1])
