"""The port's exact column order statistics
(blades_tpu_torch/ops/column_select.py) against the JAX Pallas kernels
(blades_tpu/ops/pallas_select.py) in interpret mode, bit for bit.

Both sides select exact order statistics of the same monotone keys (NaN of
either sign sorts last), so the median must agree in every bit.  The
trimmed mean's kept-value sum runs over the rows in row order on both sides
here (the Pallas interpreter's column sum and torch's), so it is compared
bit for bit as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.ops.pallas_select import column_median as jax_median
from blades_tpu.ops.pallas_select import column_trimmed_mean as jax_trimmed
from blades_tpu_torch.ops import column_select as tcs
from blades_tpu_torch.ops.aggregators import get_aggregator
from blades_tpu_torch.ops.masked import median as plain_median

D = 700


def _matrix(seed, n, ties=False, nans=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    if ties:  # few distinct values: long duplicate runs across both cuts
        x = np.round(x * 2.0) / 2.0
    if nans:
        x[1, :40] = np.nan
        x[3, 20:60] = -np.nan  # a sign-bit NaN must still sort last
        x[4, 100:110] = np.inf
        x[0, 100:105] = -np.inf
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


CASES = [(9, False, False), (10, False, False), (16, True, False),
         (17, True, False), (12, False, True), (13, True, True)]


@pytest.mark.parametrize("n,ties,nans", CASES)
def test_median_bit_exact(n, ties, nans):
    x = _matrix(n, n, ties, nans)
    got = tcs.column_median(torch.from_numpy(x))
    want = jax_median(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n,ties,nans", CASES)
def test_trimmed_mean_bit_exact(n, ties, nans):
    k = 2 if n < 12 else 4
    x = _matrix(100 + n, n, ties, nans)
    got = tcs.column_trimmed_mean(torch.from_numpy(x), k)
    want = jax_trimmed(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_median_is_the_sorted_midpoint():
    """Even n: the midpoint of the two middle values, which torch.median
    (the lower middle value) is not."""
    x = torch.from_numpy(_matrix(5, 16))
    s = x.sort(0).values
    mid = (s[7] + s[8]) / 2
    torch.testing.assert_close(tcs.column_median(x), mid, rtol=0, atol=0)
    torch.testing.assert_close(plain_median(x), mid, rtol=0, atol=0)
    assert not torch.equal(tcs.column_median(x), x.median(0).values)


def test_trimmed_zero_cut_is_mean_and_overtrim_raises():
    x = torch.from_numpy(_matrix(6, 8))
    torch.testing.assert_close(tcs.column_trimmed_mean(x, 0), x.mean(0))
    with pytest.raises(ValueError, match="need > 8 rows"):
        tcs.column_trimmed_mean(x, 4)


def test_aggregators_route_through_column_select():
    x = torch.from_numpy(_matrix(7, 11))
    med = get_aggregator("Median")
    tm = get_aggregator("Trimmedmean", num_byzantine=3)
    assert tm.num_excluded == 4  # 3 rounded up to even
    torch.testing.assert_close(med(x)[0], tcs.column_median(x), rtol=0,
                               atol=0)
    torch.testing.assert_close(tm(x)[0], tcs.column_trimmed_mean(x, 4),
                               rtol=0, atol=0)
    torch.testing.assert_close(get_aggregator("Mean")(x)[0], x.mean(0))
    with pytest.raises(ValueError, match="requires num_byzantine"):
        get_aggregator("Multikrum")


# ---- the radix select's plan and its row-group boundaries ------------------
#
# On the card the selects take csrc/column_select.cu (``select:radix``),
# laid out by ``_cuda.select_plan``.  The plan is pure Python, so its
# layout and route are checked here; the kernel itself is held against the
# plain versions by chip_smoke.py.  The plain versions are what the kernel
# must reproduce, so they are held against the JAX kernels at the plan's
# boundaries: the 64-row group, the last resident row count and one more
# (the streaming plan), and above the bit-serial kernel's old cap of about
# 4,870 rows.

from blades_tpu.ops import aggregators as jax_aggs  # noqa: E402
from blades_tpu.ops.masked import median as jax_sort_median  # noqa: E402
from blades_tpu_torch.ops import _cuda  # noqa: E402

RESIDENT_ROWS = max(r for r in range(1, 4096)
                    if _cuda.select_plan(r, 8, 0).resident)
BOUNDARY_ROWS = (_cuda.SELECT_GH - 1, _cuda.SELECT_GH, _cuda.SELECT_GH + 1,
                 RESIDENT_ROWS, RESIDENT_ROWS + 1, 5000, 6001)
NARROW = 40


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dmod", [0, 1, 2, 3])
def test_select_plan_fits_every_row_count(dmod, aligned):
    """A valid plan under 227 KB for 1 to 20,000 rows: the ring holds the
    groups in flight plus one (and, resident, the whole slab), and the
    copy width follows the rows' alignment."""
    d = 4096 + dmod
    address = 1 << 20 if aligned else (1 << 20) + 8
    want_vec = (16 if dmod == 0 and aligned
                else 8 if dmod % 2 == 0 else 4)
    for rows in range(1, 20_001):
        plan = _cuda.select_plan(rows, d, address)
        ng = -(-rows // plan.gh)
        assert plan.vec == want_vec
        few = plan.resident and rows <= _cuda.SELECT_FEW_ROWS
        blocks = -(-rows // 32) if plan.resident and not few else 0
        assert plan.smem == _cuda.select_smem(plan.stages, plan.gh, blocks)
        assert plan.smem <= _cuda.SELECT_SMEM_CAP == 232_448
        assert 1 <= plan.ahead <= _cuda.SELECT_MAX_AHEAD
        assert plan.stages >= plan.ahead + 1
        assert bool(plan.resident) == (rows <= RESIDENT_ROWS)
        if plan.resident:
            assert ng + plan.ahead <= plan.stages
            assert plan.ahead >= _cuda.SELECT_RESIDENT_AHEAD


def test_select_plan_layout_and_refusals():
    """The layout the source's ``Layout`` gives: 32 f32 columns a ring
    row, the 256 x 32 histogram, two per-warp buffers, eight state fields,
    two candidate masks of 32-row blocks and two 16-key lists with their
    lengths; the main shapes' plans (the dense trial's 60 rows count their
    ranks: no masks, no lists, and two CTAs fit an SM); refusals name
    their cause."""
    assert _cuda.select_smem(22, 64, 32) == 4 * 32 * (
        22 * 64 + 256 + 32 + 8 + 64 + 34) == 230_656
    main = _cuda.select_plan(1000, 1 << 20, 1 << 20)
    assert main == _cuda.SelectPlan(16, 64, 22, 6, 1, 230_656)
    dense = _cuda.select_plan(60, 4_903_242, 1 << 20)
    assert dense == _cuda.SelectPlan(8, 64, 9, 8, 1, 111_616)
    assert 2 * (dense.smem + 1024) <= 233_472  # two CTAs in 228 KB an SM
    assert _cuda.select_plan(6000, 3000, 0).resident == 0
    with pytest.raises(ValueError, match="do not stay resident"):
        _cuda.select_plan(6000, 3000, 0, resident=True)
    with pytest.raises(ValueError, match="no room for a ring of two"):
        _cuda.select_plan(10, 3000, 0, gh=1024)
    with pytest.raises(ValueError, match="ahead"):
        _cuda.select_plan(10, 3000, 0, ahead=0)
    with pytest.raises(ValueError, match="power of two"):
        _cuda.select_plan(10, 3000, 0, gh=48)


def test_select_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _cuda.launch_select("column_median", torch.zeros((3, 4)), ("median",))


def _boundary_matrix(seed, n):
    """Values on a half-integer grid (exact sums in any order, long
    duplicate runs across both cuts), NaN of both signs and +-inf, an
    all-equal column and a signed-zero column.  A column holds at most one
    NaN, so no cut falls among NaNs: there the Pallas kernel's +inf row
    padding moves the rank (see the NaN-majority test below)."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.normal(size=(n, NARROW)) * 2.0) / 2.0).astype(
        np.float32)
    x[1, :6] = np.nan
    x[3, 6:12] = -np.nan
    x[4, 8:12] = np.inf
    x[0, 12:16] = -np.inf
    x[:, 20] = 0.375
    x[rng.random(n) < 0.5, 21] = -0.0
    x[:, 22] = 0.0
    x[rng.random(n) < 0.3, 22] = -0.0
    return x


@pytest.mark.parametrize("n", BOUNDARY_ROWS)
def test_plain_median_at_plan_boundaries(n):
    x = _boundary_matrix(n, n)
    got = tcs.column_median_plain(torch.from_numpy(x))
    want = jax_median(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n", BOUNDARY_ROWS)
def test_plain_trimmed_mean_at_plan_boundaries(n):
    x = _boundary_matrix(1000 + n, n)
    for k in (1, n // 5, (n - 1) // 2):
        got = tcs.column_trimmed_mean_plain(torch.from_numpy(x), k)
        want = jax_trimmed(jnp.asarray(x), k, interpret=True)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("n", BOUNDARY_ROWS)
def test_plain_median_of_nan_majority_columns(n):
    """Columns whose middle falls among NaNs of either sign or among
    -infs, against the JAX package's sort path (NaN last, as its Pallas
    kernel states it matches).  The Pallas kernel itself pads the rows to
    a multiple of 8 with +inf, which sorts below NaN: where n % 8 != 0 and
    the middle falls among NaNs it returns +inf, so it is not the
    yardstick for these columns."""
    rng = np.random.default_rng(2000 + n)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    h = n // 2 + 1
    x[:h, 0] = -np.nan
    x[:h, 1] = np.nan
    x[rng.permutation(n)[:h], 2] = -np.nan
    x[:h, 3] = -np.inf
    x[:, 4] = -np.nan
    x[: n - h, 5] = np.inf
    got = tcs.column_median_plain(torch.from_numpy(x))
    want = jax_sort_median(jnp.asarray(x))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(got.numpy())[ok], _bits(want)[ok])


@pytest.mark.parametrize("name", ["Median", "Trimmedmean"])
def test_aggregators_above_the_old_row_cap(name):
    """The port's aggregators at 5,000 rows (the bit-serial kernel's plan
    refused more than about 4,870) against the JAX aggregators: the median
    exactly (bit for bit but the sign of a zero median, which ``jnp.sort``
    leaves unordered and the keys order -0 < +0), the trimmed mean within
    f32 reassociation (the JAX aggregator means the sorted slice, the port
    sums in row order and multiplies by the reciprocal)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(5000, 64)).astype(np.float32)
    x[:, :8] = np.round(x[:, :8] * 2.0) / 2.0
    x[:1250, 8] = x[0, 8]  # ALIE: a quarter of the rows identical
    kw = {"num_byzantine": 1250} if name == "Trimmedmean" else {}
    got, _ = get_aggregator(name, **kw)(torch.from_numpy(x))
    want = getattr(jax_aggs, name)(**kw).aggregate(jnp.asarray(x))
    if name == "Median":
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy(), want)
        nz = want != 0
        np.testing.assert_array_equal(_bits(got.numpy())[nz], _bits(want)[nz])
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-6, atol=1e-7)
