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
