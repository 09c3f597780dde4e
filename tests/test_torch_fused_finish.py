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
