"""The port's BatchNorm backward (blades_tpu_torch/ops/bn_backward.py, the
two custom ops ``BNApply.backward`` runs) against the JAX package's
hand-written VJP, ``_bn_apply`` in blades_tpu/models/layers.py.

A small conv + BatchStatsNorm loss runs as ``vmap(grad_and_value)`` over a
block of clients for one and for two local SGD steps: step 0 has unbatched
parameters (functorch folds the clients into the convolution's batch, the
``(G*B, C, H, W)`` layout), step 1 batched ones (a grouped convolution,
``(B, G*C, H, W)``), so the ops' vmap rule sees both physical layouts.
Both sides get the same numpy-made inputs.  Tolerances: f32 gradients
``rtol=1e-4, atol=1e-6`` (sums in another order, on the CPU); bf16 within
2% of the gradients' norm (the two frameworks round their bf16
convolutions differently).

On the CPU the ops run their plain versions; the CUDA kernels are held
against those on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from blades_tpu.models.layers import _bn_apply
from blades_tpu_torch.models.layers import bn_apply
from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.ops import bn_backward as bn

G, B, H, CIN, C = 3, 4, 6, 2, 5
LR = 0.5


def _inputs(seed, steps):
    rng = np.random.default_rng(seed)
    return dict(
        w=(rng.normal(size=(3, 3, CIN, C)) * 0.4).astype(np.float32),
        scale=(1.0 + 0.3 * rng.normal(size=(C,))).astype(np.float32),
        bias=(0.1 * rng.normal(size=(C,))).astype(np.float32),
        x=rng.normal(size=(G, steps, B, H, H, CIN)).astype(np.float32),
        t=rng.normal(size=(G, steps, B, H, H, C)).astype(np.float32),
    )


def _jax_steps(d, steps, dtype):
    dt = jnp.dtype(dtype)

    def loss(p, x, t):
        x = x.astype(dt)
        h = jax.lax.conv_general_dilated(
            x, p["w"].astype(dt), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y = _bn_apply(h, p["scale"].astype(dt), p["bias"].astype(dt), 1e-5)
        return jnp.mean((jax.nn.relu(y).astype(jnp.float32) - t) ** 2)

    p = {k: jnp.asarray(d[k]) for k in ("w", "scale", "bias")}
    grads = []
    for s in range(steps):
        _, gr = jax.vmap(jax.value_and_grad(loss),
                         in_axes=(None if s == 0 else 0, 0, 0))(
            p, jnp.asarray(d["x"][:, s]), jnp.asarray(d["t"][:, s]))
        grads.append({k: np.asarray(v) for k, v in gr.items()})
        p = {k: p[k] - LR * gr[k] for k in p}
    return grads


def _torch_steps(d, steps, dtype):
    dt = getattr(torch, dtype)

    def loss(p, x, t):
        h = F.conv2d(x.to(dt).permute(0, 3, 1, 2), p["w"].to(dt), padding=1)
        y = bn_apply(h, p["scale"].to(dt), p["bias"].to(dt))
        return ((torch.relu(y).float() - t.permute(0, 3, 1, 2)) ** 2).mean()

    p = {"w": torch.from_numpy(d["w"]).permute(3, 2, 0, 1).contiguous(),
         "scale": torch.from_numpy(d["scale"]),
         "bias": torch.from_numpy(d["bias"])}
    grads = []
    for s in range(steps):
        gr, _ = vmap(grad_and_value(loss),
                     in_dims=(None if s == 0 else 0, 0, 0))(
            p, torch.from_numpy(d["x"][:, s]), torch.from_numpy(d["t"][:, s]))
        grads.append({"w": gr["w"].permute(0, 3, 4, 2, 1).numpy(),
                      "scale": gr["scale"].numpy(),
                      "bias": gr["bias"].numpy()})
        p = {k: p[k] - LR * gr[k] for k in p}
    return grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 2], ids=["unbatched", "batched"])
def test_vmapped_backward_matches_jax(steps, dtype):
    d = _inputs(steps, steps)
    want = _jax_steps(d, steps, dtype)
    got = _torch_steps(d, steps, dtype)
    for s in range(steps):
        for k in ("w", "scale", "bias"):
            a, b = got[s][k], want[s][k]
            assert a.shape == b.shape, (k, a.shape, b.shape)
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {s} {k}")
            else:
                rel = np.linalg.norm(a - b) / np.linalg.norm(b)
                assert rel < 2e-2, (s, k, rel)


def _old_backward(x, dy, mean, r, scale):
    """The per-client formulas of ``_bn_apply_bwd`` written out in plain
    torch on one client's NCHW tensors."""
    dims = [0, 2, 3]
    n = dy.numel() // dy.shape[1]
    acc = torch.promote_types(dy.dtype, torch.float32)
    bc = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
    xhat = (x - bc(mean)) * bc(r)
    dbias = dy.to(acc).sum(dims).to(dy.dtype)
    dscale = (dy * xhat).to(acc).sum(dims).to(dy.dtype)
    dxhat = dy * bc(scale)
    mean_dxhat = dxhat.to(acc).sum(dims).to(dy.dtype) / n
    mean_dxhat_xhat = dscale * scale / n
    dx = bc(r) * (dxhat - bc(mean_dxhat) - xhat * bc(mean_dxhat_xhat))
    return dx, dscale, dbias


def _client(seed, dtype, n=6, c=4, h=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, c, h, h)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(n, c, h, h)).astype(np.float32))
    mean = x.mean((0, 2, 3))
    r = torch.rsqrt(x.var((0, 2, 3), unbiased=False) + 1e-5)
    scale = torch.from_numpy(
        (1 + 0.2 * rng.normal(size=(c,))).astype(np.float32))
    return [t.to(dtype) for t in (x, dy, mean, r, scale)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_match_the_plain_formulas(dtype):
    """The two ops, composed as ``BNApply.backward`` composes them, give
    the per-client formulas' dx, dscale and dbias (f32 sums of one order:
    rtol 1e-6; bf16 results exact up to a sum landing on a rounding
    boundary, so within one bf16 ulp)."""
    x, dy, mean, r, scale = _client(0, dtype)
    want = _old_backward(x, dy, mean, r, scale)
    n = dy.numel() // dy.shape[1]
    g4 = lambda t: t.reshape(t.shape[0], t.shape[1], -1)[None]  # noqa: E731
    vec = [v[None] for v in (mean, r, scale)]
    s_bias, s_scale, s_dxhat = bn.bn_bwd_reduce(g4(x), g4(dy), *vec)
    dscale, dbias = s_scale.to(dtype), s_bias.to(dtype)
    dx = bn.bn_bwd_dx(g4(x), g4(dy), *vec, s_dxhat.to(dtype) / n,
                      dscale * vec[2] / n).reshape(x.shape)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-3)
    for a, b in zip((dx, dscale[0], dbias[0]), want):
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.parametrize("bdim", [0, 1])
def test_vmap_rule_matches_a_loop_over_clients(bdim):
    """The registered vmap rule (one call over the block, the vmapped axis
    at ``bdim`` of the physical tensors, scale unbatched) gives what
    calling each client alone gives, bit for bit."""
    rng = np.random.default_rng(3)
    g, n, c, s = 4, 5, 3, 7
    shape = (g, n, c, s) if bdim == 0 else (n, g, c, s)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    mean = torch.from_numpy(rng.normal(size=(g, 1, c)).astype(np.float32))
    r = torch.from_numpy(rng.uniform(0.5, 2, (g, 1, c)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(size=(1, c)).astype(np.float32))
    md = torch.from_numpy(rng.normal(size=(g, 1, c)).astype(np.float32))
    mdx = torch.from_numpy(rng.normal(size=(g, 1, c)).astype(np.float32))
    one = lambda t: t.unsqueeze(0)  # noqa: E731
    in_dims = (bdim, bdim, 0, 0, None)
    red = vmap(lambda *a: bn.bn_bwd_reduce(one(a[0]), one(a[1]), *a[2:]),
               in_dims=in_dims)(x, dy, mean, r, scale)
    dx = vmap(lambda *a: bn.bn_bwd_dx(one(a[0]), one(a[1]), *a[2:]),
              in_dims=in_dims + (0, 0))(x, dy, mean, r, scale, md, mdx)
    for i in range(g):
        xi, dyi = x.select(bdim, i), dy.select(bdim, i)
        want = bn.bn_bwd_reduce(one(xi), one(dyi), mean[i], r[i], scale)
        for a, b in zip(red, want):
            assert torch.equal(a[i], b)
        want_dx = bn.bn_bwd_dx(one(xi), one(dyi), mean[i], r[i], scale,
                               md[i], mdx[i])
        assert torch.equal(dx[i], want_dx)


def test_bn_apply_gradcheck_in_f64():
    """The hand-written backward is the derivative of the forward (f64,
    the CPU's plain path)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 2, 2, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    scale = torch.randn(3, generator=gen, dtype=torch.float64,
                        requires_grad=True)
    bias = torch.randn(3, generator=gen, dtype=torch.float64,
                       requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b, c: bn_apply(a, b, c),
                                    (x, scale, bias))


def test_ops_register_fake_and_schema():
    """``torch.library.opcheck``: schema, fake (meta) implementation and
    dispatch registrations of both ops."""
    x, dy, mean, r, scale = _client(1, torch.float32)
    g4 = lambda t: t.reshape(t.shape[0], t.shape[1], -1)[None]  # noqa: E731
    vec = [v[None] for v in (mean, r, scale)]
    torch.library.opcheck(bn.bn_bwd_reduce, (g4(x), g4(dy), *vec))
    torch.library.opcheck(bn.bn_bwd_dx, (g4(x), g4(dy), *vec, vec[0],
                                         vec[1]))
    torch.library.opcheck(bn.bn_bwd, (g4(x), g4(dy), *vec))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_composite_is_the_two_ops(dtype):
    """``bn_bwd`` (what ``BNApply.backward`` calls) is the reduction op,
    the coefficients in the compute dtype, then the dx op, bit for bit."""
    x, dy, mean, r, scale = _client(4, dtype)
    g4 = lambda t: t.reshape(t.shape[0], t.shape[1], -1)[None]  # noqa: E731
    vec = [v[None] for v in (mean, r, scale)]
    n = x.numel() // x.shape[1]
    s_bias, s_scale, s_dxhat = bn.bn_bwd_reduce(g4(x), g4(dy), *vec)
    dscale = s_scale.to(dtype)
    want = (bn.bn_bwd_dx(g4(x), g4(dy), *vec, s_dxhat.to(dtype) / n,
                         dscale * vec[2] / n), dscale, s_bias.to(dtype))
    for a, b in zip(bn.bn_bwd(g4(x), g4(dy), *vec), want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_launchers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA launchers raise on a CPU tensor (the ops route CPU tensors
    to the plain versions before they reach them); no launch is counted
    on the CPU path."""
    x, dy, mean, r, scale = _client(2, torch.float32)
    g4 = x.reshape(6, 4, -1)[None]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _cuda.launch_bn_reduce("bn_bwd_reduce", g4, g4, mean[None],
                               r[None], scale[None])
    _cuda.reset_launches()
    bn.bn_bwd_reduce(g4, g4, mean[None], r[None], scale[None])
    assert dict(_cuda.LAUNCHES) == {}
