"""The port's fused finish (blades_tpu_torch/ops/fused_finish.py) against the
JAX Pallas kernels (blades_tpu/ops/pallas_round.py) in interpret mode.

Both sides get the same numpy-made matrix.  On a CPU tensor the port's
wrappers run their plain versions, which is what runs here.

Tolerances:

- ``bad`` flags, and the median of a round with no forge (order
  statistics of identical inputs), are compared bit for bit.  Mean and
  trimmed-mean sums are f32 sums in another order and get the tolerance
  below.
- The forged row, and everything that depends on it (the aggregate under a
  forge, row norms), within ``rtol=1e-5, atol=1e-6``: the benign mean and
  variance are f32 sums taken in another order on each side, so they may
  differ in the last ulp.  Row norms are f32 sums over a whole row and get
  ``rtol=1e-5`` against their own size.
- Under bf16 storage the forged row is rounded to bf16, and a last-ulp f32
  difference in the benign mean can move that rounding by one bf16 ulp
  (XLA's CPU backend divides by the benign count as a multiply by its
  reciprocal, the port divides).  One bf16 ulp is at most ``2**-7`` of a
  value, so forged-row-dependent values get ``rtol=2**-6`` (a squared
  norm doubles the relative error) and an absolute slack of ``2**-7``
  times the largest forged magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.ops.pallas_round import fused_finish as jax_fused
from blades_tpu.ops.pallas_round import fused_finish_compact as jax_compact
from blades_tpu_torch.ops import fused_finish as tff

FORGES = [("alie", 0.7), ("ipm", 1.5), ("adaptive", 2.0)]
AGGS = [("mean",), ("median",), ("trimmed", 3)]
D = 1100  # three 512-column stripes, the last one ragged
RTOL, ATOL = 1e-5, 1e-6


def _matrix(seed, rows, dtype):
    """``(torch, jax)`` copies of one matrix; under bf16 both hold the same
    bf16 values (rounded once, by torch)."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t, jnp.asarray(t.numpy())


def _noise(seed, forge):
    if forge is None or forge[0] != "adaptive":
        return None, None
    r = np.random.default_rng(seed + 1000).random(D).astype(np.float32)
    return torch.from_numpy(r), jnp.asarray(r)


def _close(a, b, dtype="f32", forged=None):
    """Compare within the f32 tolerance or, for values that depend on a
    bf16-rounded forged row, within one bf16 ulp of that row, column by
    column (``forged`` is the port's forged row)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if dtype == "bf16" and forged is not None:
        f = np.abs(np.asarray(forged, np.float64))
        slack = ATOL + 2.0 ** -7 * (f if a.shape == f.shape else f.max())
        bad = np.abs(a - b) > slack + 2.0 ** -6 * np.abs(b)
        assert not bad.any(), (np.flatnonzero(bad)[:8], a[bad][:8], b[bad][:8])
        return
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _port_forged(xt, mal, forge, noise):
    """The port's forged row for the benign rows of ``xt``."""
    benign = xt[~torch.as_tensor(mal)]
    return tff.fused_finish_compact(benign, noise, forged_mult=1,
                                    forge=forge, agg=("mean",))[3]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", AGGS, ids=lambda a: a[0])
@pytest.mark.parametrize("forge", FORGES, ids=lambda f: f[0])
def test_compact_matches_pallas(forge, agg, dtype):
    # nb + mult alternates odd / even over the grid.
    nb = 14 + len(forge[0]) % 2
    mult = 5
    xt, xj = _matrix(7 + nb, nb, dtype)
    rt, rj = _noise(7, forge)
    a_t, sq_t, bad_t, f_t = tff.fused_finish_compact(
        xt, rt, forged_mult=mult, forge=forge, agg=agg)
    a_j, sq_j, bad_j, f_j = jax_compact(
        xj, rj, forged_mult=mult, forge=forge, agg=agg, interpret=True)
    _close(f_t, f_j, dtype, f_t)
    _close(a_t, a_j, dtype, f_t)
    _close(sq_t, sq_j)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", AGGS, ids=lambda a: a[0])
@pytest.mark.parametrize("forge", FORGES + [None],
                         ids=lambda f: f[0] if f else "none")
def test_full_matches_pallas(forge, agg, dtype):
    n = 19 if agg[0] == "median" else 20
    xt, xj = _matrix(3 + n, n, dtype)
    mal = np.random.default_rng(n).random(n) < 0.3
    rt, rj = _noise(3, forge)
    a_t, sq_t, bad_t = tff.fused_finish(
        xt, torch.from_numpy(mal), rt, forge=forge, agg=agg)
    a_j, sq_j, bad_j = jax_fused(xj, jnp.asarray(mal), rj, forge=forge,
                                 agg=agg, interpret=True)
    if forge is None and agg[0] == "median":  # exact order statistics
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        _close(sq_t, sq_j)
    else:
        f_t = None if forge is None else _port_forged(xt, mal, forge, rt)
        _close(a_t, a_j, dtype, f_t)
        _close(sq_t[~mal], np.asarray(sq_j)[~mal])
        # A malicious row's squared norm sums d squared forged values.
        _close(sq_t[mal], np.asarray(sq_j)[mal], dtype,
               None if f_t is None else np.zeros(1))
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))


def _poison(xt, xj):
    """A NaN in row 2 inside stripe 1 only, an inf in row 5 inside stripe
    0 only (columns 600 and 7)."""
    xt = xt.clone()
    xt[2, 600] = float("nan")
    xt[5, 7] = float("inf")
    xj = xj.at[2, 600].set(jnp.nan).at[5, 7].set(jnp.inf)
    return xt, xj


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", [("median",), ("trimmed", 2)],
                         ids=lambda a: a[0])
def test_sanitize_is_stripe_local(agg, dtype):
    n = 16
    xt, xj = _matrix(11, n, dtype)
    xt, xj = _poison(xt, xj)
    mal = np.arange(n) < 4
    a_t, sq_t, bad_t = tff.fused_finish(
        xt, torch.from_numpy(mal), forge=None, agg=agg, sanitize=True)
    a_j, sq_j, bad_j = jax_fused(xj, jnp.asarray(mal), forge=None, agg=agg,
                                 sanitize=True, interpret=True)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    assert bad_t.nonzero().flatten().tolist() == [2, 5]
    if agg[0] == "median":
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    else:  # the trimmed sum is taken in another order
        _close(a_t, a_j)
    _close(sq_t, sq_j)
    # Stripe-local: row 2 keeps its stripe-0 values, so its norm is
    # not zero.
    assert float(sq_t[2]) > 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_compact_sanitize_with_forge(dtype):
    nb, mult = 15, 6
    xt, xj = _matrix(23, nb, dtype)
    xt, xj = _poison(xt, xj)
    a_t, sq_t, bad_t, f_t = tff.fused_finish_compact(
        xt, forged_mult=mult, forge=("alie", 1.1), agg=("median",),
        sanitize=True)
    a_j, sq_j, bad_j, f_j = jax_compact(
        xj, forged_mult=mult, forge=("alie", 1.1), agg=("median",),
        sanitize=True, interpret=True)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    assert bool(torch.isfinite(a_t).all())
    _close(f_t, f_j, dtype, f_t)
    _close(a_t, a_j, dtype, f_t)
    _close(sq_t, sq_j)


def test_compact_equals_full_with_prefix():
    """The virtual-multiplicity finish equals the full finish over the
    matrix with the forged prefix scattered in."""
    nb, mult = 12, 4
    xt, _ = _matrix(31, nb, "f32")
    full = torch.cat([torch.zeros(mult, D), xt])
    mal = torch.arange(nb + mult) < mult
    for agg in AGGS:
        a_c, sq_c, _, f_c = tff.fused_finish_compact(
            xt, forged_mult=mult, forge=("alie", 0.9), agg=agg)
        a_f, sq_f, _ = tff.fused_finish(full, mal, forge=("alie", 0.9),
                                        agg=agg)
        _close(a_c, a_f)
        _close(sq_c, sq_f[mult:])
        _close(sq_f[:mult], (f_c * f_c).sum().expand(mult))


def _tie_matrix(kind, seed, rows, dtype, d=D):
    """Tie-heavy ``(torch, jax)`` copies of one matrix: ``levels`` draws
    from five bf16-exact values (long runs of equal keys across both
    trimmed cuts); ``zeros`` mixes +0 and -0 with all-equal columns, where
    ALIE's forged value equals every key, so the forged key is the k-th
    key.  Rows 2 and 5 carry a NaN and an inf inside one stripe each."""
    rng = np.random.default_rng(seed)
    if kind == "levels":
        lv = np.array([-0.5, -0.125, 0.0, 0.125, 0.25], np.float32)
        x = lv[rng.integers(0, 5, size=(rows, d))]
    else:
        x = np.where(rng.random((rows, d)) < 0.5, np.float32(-0.0),
                     np.float32(0.0)).astype(np.float32)
        x[:, 1::3] = 0.375
    x[2, 600], x[5, 7] = np.nan, np.inf
    t = torch.from_numpy(x)
    if dtype == "bf16":
        return t.to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    return t, jnp.asarray(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", [("median",), ("trimmed", 3)],
                         ids=lambda a: a[0])
@pytest.mark.parametrize("kind", ["levels", "zeros"])
@pytest.mark.parametrize("branch", ["compact", "full"])
def test_tie_heavy_matches_pallas(branch, kind, agg, dtype):
    """Ties, signed zeros, all-equal columns and non-finite rows under
    sanitize, through both finishes against the Pallas kernels: bad flags
    bit-exact, and the no-forge median too; the rest within the module's
    tolerances."""
    n = 17
    xt, xj = _tie_matrix(kind, 40 + n, n, dtype)
    forge = ("alie", 0.7)
    if branch == "compact":
        a_t, sq_t, bad_t, f_t = tff.fused_finish_compact(
            xt, forged_mult=6, forge=forge, agg=agg, sanitize=True)
        a_j, sq_j, bad_j, f_j = jax_compact(
            xj, forged_mult=6, forge=forge, agg=agg, sanitize=True,
            interpret=True)
        _close(f_t, f_j, dtype, f_t)
        _close(a_t, a_j, dtype, f_t)
    else:
        mal = np.arange(n) < 4
        a_t, sq_t, bad_t = tff.fused_finish(
            xt, torch.from_numpy(mal), forge=None, agg=agg, sanitize=True)
        a_j, sq_j, bad_j = jax_fused(xj, jnp.asarray(mal), forge=None,
                                     agg=agg, sanitize=True, interpret=True)
        if agg[0] == "median":  # exact order statistics
            np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        else:
            _close(a_t, a_j)
    _close(sq_t, sq_j)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    assert bad_t.nonzero().flatten().tolist() == [2, 5]


@pytest.mark.parametrize("dtype,d,address,rows,route", [
    (torch.bfloat16, 4_903_424, 0, 750, "radix"),      # the padded round
    (torch.bfloat16, 4_903_424, 0, 1000, "radix"),     # the full finish
    (torch.bfloat16, 3000, 1 << 20, 40, "radix"),
    (torch.bfloat16, 1024, 0, 1317, "radix"),          # the most that fit
    (torch.bfloat16, 1024, 0, 1318, "ring"),           # one row too many
    (torch.bfloat16, 4_903_424, 0, 1600, "ring"),      # ResNet-10 x 1600
    (torch.bfloat16, 4_903_424, 0, 1500, "ring"),      # ResNet-10 x 2000
    (torch.bfloat16, 4_903_242, 0, 750, "bitserial"),  # 9,806,484-byte rows
    (torch.bfloat16, 1004, 0, 40, "bitserial"),        # 8-byte-aligned rows
    (torch.bfloat16, 1008, 8, 40, "bitserial"),        # an unaligned base
    (torch.bfloat16, 1004, 0, 1600, "bitserial"),      # unaligned, many rows
    (torch.float32, 1024, 0, 40, "ring"),              # f32: any aligned rows
    (torch.float32, 4_903_424, 0, 750, "ring"),        # an f32 streamed round
    (torch.float32, 1022, 0, 40, "bitserial"),         # 8-byte-aligned rows
    (torch.float32, 1024, 4, 40, "bitserial"),         # an unaligned base
])
def test_finish_route_takes_radix_only_for_aligned_bf16_rows(dtype, d,
                                                             address, rows,
                                                             route):
    """Aligned bf16 rows up to radix's cap take the radix route, every
    other 16-byte-aligned matrix the ring route, the rest the bit-serial
    route."""
    from blades_tpu_torch.ops._cuda import finish_route

    assert finish_route(dtype, d, address, rows) == route


@pytest.mark.parametrize("dtype,cap", [(torch.bfloat16, 7473),
                                       (torch.float32, 4874)])
def test_finish_fits_keeps_todays_row_counts(dtype, cap):
    """The ring route moves no round between the fused and the chunked
    finish: for rows 1 to 8,000 ``finish_fits`` gives what it gave before
    the ring route -- radix's cap, then the bit-serial plan -- which is
    every row count up to 7,473 bf16 / 4,874 f32 rows."""
    from blades_tpu_torch.ops import _cuda

    esize = 2 if dtype == torch.bfloat16 else 4
    for rows in range(1, 8001):
        radix = (dtype == torch.bfloat16
                 and _cuda.radix_smem(rows, 2) <= _cuda.RADIX_SMEM_CAP)
        before = radix or _cuda.bitserial_plan(rows, esize) > 0
        assert _cuda.finish_fits(dtype, rows) == before == (rows <= cap), rows


# -- the ring route's shapes against the Pallas kernels ----------------------

WIDE_D = 1024  # two whole stripes: aligned rows for both dtypes
WIDE_ROWS = {"bf16": 1400, "f32": 600}  # above radix's cap; an f32 matrix


def _wide_matrix(seed, rows, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, WIDE_D)).astype(np.float32)
    x[2, 600], x[5, 7] = np.nan, np.inf  # one stripe each: sanitized
    t = torch.from_numpy(x)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t, jnp.asarray(x)


def _wide_noise(seed, forge):
    if forge[0] != "adaptive":
        return None, None
    r = np.random.default_rng(seed).random(WIDE_D).astype(np.float32)
    return torch.from_numpy(r), jnp.asarray(r)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", [("median",), ("trimmed", 0)],
                         ids=lambda a: a[0])
@pytest.mark.parametrize("forge", FORGES, ids=lambda f: f[0])
def test_ring_shapes_match_pallas(forge, agg, dtype):
    """The plain versions the ring route is held to on the card, at its
    shapes (bf16 above radix's 1,317 rows, f32), against the Pallas
    kernels, sanitize on: the compact finish with a fifth of the rows
    forged, the full one with a quarter malicious.  Trimmed cut: a fifth
    of the rows."""
    rows = WIDE_ROWS[dtype]
    xt, xj = _wide_matrix(rows + len(forge[0]), rows, dtype)
    rt, rj = _wide_noise(rows, forge)
    mult = rows // 4
    cagg = agg if agg[0] == "median" else ("trimmed", (rows + mult) // 5)
    a_t, sq_t, bad_t, f_t = tff.fused_finish_compact(
        xt, rt, forged_mult=mult, forge=forge, agg=cagg, sanitize=True)
    a_j, sq_j, bad_j, f_j = jax_compact(
        xj, rj, forged_mult=mult, forge=forge, agg=cagg, sanitize=True,
        interpret=True)
    _close(f_t, f_j, dtype, f_t)
    _close(a_t, a_j, dtype, f_t)
    _close(sq_t, sq_j)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    assert bad_t.nonzero().flatten().tolist() == [2, 5]
    mal = np.arange(rows) >= rows - rows // 4
    fagg = agg if agg[0] == "median" else ("trimmed", rows // 5)
    a_t, sq_t, bad_t = tff.fused_finish(
        xt, torch.from_numpy(mal), rt, forge=forge, agg=fagg, sanitize=True)
    a_j, sq_j, bad_j = jax_fused(xj, jnp.asarray(mal), rj, forge=forge,
                                 agg=fagg, sanitize=True, interpret=True)
    f_t = _port_forged(xt, mal, forge, rt) if dtype == "bf16" else None
    _close(a_t, a_j, dtype, f_t)
    _close(sq_t[~mal], np.asarray(sq_j)[~mal])
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("agg", [("median",), ("trimmed", 0)],
                         ids=lambda a: a[0])
def test_ring_shapes_tie_heavy_match_pallas(agg, dtype):
    """Five bf16-exact levels (runs of equal keys across both cuts) with a
    NaN and an inf row, at the ring route's shapes, compact under ALIE
    with sanitize on."""
    rows = WIDE_ROWS[dtype]
    xt, xj = _tie_matrix("levels", rows, rows, dtype, d=WIDE_D)
    mult = rows // 4
    cagg = agg if agg[0] == "median" else ("trimmed", (rows + mult) // 5)
    a_t, sq_t, bad_t, f_t = tff.fused_finish_compact(
        xt, forged_mult=mult, forge=("alie", 0.7), agg=cagg, sanitize=True)
    a_j, sq_j, bad_j, f_j = jax_compact(
        xj, forged_mult=mult, forge=("alie", 0.7), agg=cagg, sanitize=True,
        interpret=True)
    _close(f_t, f_j, dtype, f_t)
    _close(a_t, a_j, dtype, f_t)
    _close(sq_t, sq_j)
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sanitize", [False, True])
def test_ring_shapes_nan_column_match_pallas(sanitize, dtype):
    """A column more than half NaN (the median among them), a column of
    -inf and a column of equal values, at the ring route's shapes, no
    forge: the median bit for bit (sanitize off: the NaN is the median;
    on: the NaN rows are zeroed in their stripe)."""
    rows = WIDE_ROWS[dtype]
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, WIDE_D)).astype(np.float32)
    x[: rows // 2 + 1, 700] = np.nan
    x[:, 701] = -np.inf
    x[:, 702] = 0.375
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    if dtype == "bf16":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    mal = np.zeros(rows, dtype=bool)
    a_t, sq_t, bad_t = tff.fused_finish(t, torch.from_numpy(mal), forge=None,
                                        agg=("median",), sanitize=sanitize)
    a_j, sq_j, bad_j = jax_fused(j, jnp.asarray(mal), forge=None,
                                 agg=("median",), sanitize=sanitize,
                                 interpret=True)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert np.isnan(a_t[700].item()) != sanitize
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
    if sanitize:
        _close(sq_t, sq_j)


def test_rejects_bad_arguments():
    x = torch.zeros(6, 8)
    with pytest.raises(ValueError, match="requires a forge"):
        tff.fused_finish_compact(x, forged_mult=2, forge=None)
    with pytest.raises(ValueError, match="needs forge_noise"):
        tff.fused_finish_compact(x, forged_mult=2, forge=("adaptive", 2.0))
    with pytest.raises(ValueError, match="trimmed mean needs"):
        tff.fused_finish(x, torch.zeros(6, dtype=torch.bool),
                         agg=("trimmed", 3))
    with pytest.raises(ValueError, match="not supported"):
        tff.fused_finish(x.double(), torch.zeros(6, dtype=torch.bool))
