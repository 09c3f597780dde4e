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
