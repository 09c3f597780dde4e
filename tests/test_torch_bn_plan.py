"""The host-side launch plan of the BatchNorm-backward kernels
(``blades_tpu_torch/ops/_cuda.py::bn_plan``) and the composite op on the CPU.

``bn_plan`` picks, from shape, strides, element size and pointer alignment,
the kernels' thread map (vector channel-inner, scalar channel-inner or
spatial-inner), the vector width, the channel groups and the split count;
the CUDA source checks the plan again and refuses one that does not fit.
The kernels themselves run only on the card (``chip_smoke.py``); here the
plan is held to what the kernels need, and ``bn_bwd``'s CPU registration
to ``_compose`` of the plain ops and to the JAX package's coefficients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.ops import bn_backward as bn

SMS = 132
STAGES = ((64, 32), (128, 16), (256, 8), (512, 4))  # ResNet-10, (C, H = W)
LAYOUTS = ("fold", "grouped", "fold-cl", "grouped-cl")
DTYPES = (torch.float32, torch.bfloat16)


def _view(layout, g, b, c, h, w, device="meta"):
    """The ``(G, B, C, S)`` view of one physical layout of a client
    block's activations (as ``chip_smoke.py`` builds them)."""
    shape = (g * b, c, h, w) if layout.startswith("fold") else (b, g * c, h, w)
    t = torch.empty(shape, device=device)
    if layout.endswith("-cl"):
        t = t.contiguous(memory_format=torch.channels_last)
    if layout.startswith("fold"):
        return t.view(g, b, c, h * w)
    return t.view(b, g, c, h * w).transpose(0, 1)


def _plan(x, itemsize, offsets=(0, 0)):
    return _cuda.bn_plan(tuple(x.shape), (x.stride(), x.stride()), itemsize,
                         offsets)


def _check_cover(plan, shape):
    """The grid covers every (client, channel, position) once."""
    g, n, c, s = shape
    length = n * s
    assert plan.splits >= 1 and plan.chunk >= 1
    assert plan.splits * plan.chunk >= length > (plan.splits - 1) * plan.chunk
    if plan.map == 0:
        assert plan.groups == c and plan.width == 1
    elif plan.map == 1:
        assert plan.groups == -(-c // 32) and plan.width == 32
    else:
        assert plan.tc in (1, 2, 4, 8, 16, 32)
        assert plan.groups * plan.width >= c > (plan.groups - 1) * plan.width
        assert plan.chunk % (4 * 8 * (32 // plan.tc)) == 0


@pytest.mark.parametrize("stage", STAGES, ids=lambda s: f"C{s[0]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stage_shapes_take_the_vector_or_spatial_map(layout, dtype, stage):
    """At the main round's stage shapes (G = 50, B = 32) the channels-last
    layouts take the vector map -- 16-byte vectors, one flat position
    stride -- with a grid of at least two CTAs per SM of the H100; NCHW
    takes the spatial-inner map."""
    c, hw = stage
    x = _view(layout, 50, 32, c, hw, hw)
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = _plan(x, itemsize)
    _check_cover(plan, x.shape)
    if layout.endswith("-cl"):
        assert _cuda.BN_MAPS[plan.map] == "vector"
        assert plan.vec * itemsize == 16
        g, n, _, s = x.shape
        assert x.stride(1) == s * x.stride(3)  # one flat position stride
        assert g * plan.groups * plan.splits >= 2 * SMS
    else:
        assert _cuda.BN_MAPS[plan.map] == "spatial"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", [3, 5, 7])
def test_ragged_channels_take_the_scalar_map(c, dtype):
    x = _view("fold-cl", 4, 8, c, 6, 6)
    plan = _plan(x, torch.empty((), dtype=dtype).element_size())
    assert _cuda.BN_MAPS[plan.map] == "scalar"
    _check_cover(plan, x.shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_offset_base_pointer_takes_the_scalar_map(dtype):
    """``x[..., 1:33, :]`` of 40 channels starts one element past a
    16-byte boundary; its width and strides alone would allow vectors."""
    x = _view("fold-cl", 4, 8, 40, 6, 6, device="cpu").to(dtype)[..., 1:33, :]
    offsets = (x.data_ptr() % 16,) * 2
    assert offsets[0] != 0
    plan = _plan(x, x.element_size(), offsets)
    assert _cuda.BN_MAPS[plan.map] == "scalar"
    # The same view at an aligned base would take the vector map.
    assert _cuda.BN_MAPS[_plan(x, x.element_size()).map] == "vector"


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_non_flat_positions_take_the_scalar_map(dtype):
    """Positions cut short (``x[..., :S-1]``): the n stride is no longer S
    times the s stride, so (n, s) is not one flat index."""
    x = _view("grouped-cl", 4, 8, 64, 6, 6)[..., :35]
    assert x.stride(1) != x.shape[3] * x.stride(3)
    plan = _plan(x, torch.empty((), dtype=dtype).element_size())
    assert _cuda.BN_MAPS[plan.map] == "scalar"


@pytest.mark.parametrize("shape", [(1, 32, 64, 1024), (3, 5, 8, 25),
                                   (2, 3, 24, 15), (3, 2, 40, 36),
                                   (4, 16, 512, 1), (1, 1, 256, 1),
                                   (50, 32, 8, 16), (2, 2, 1024, 4)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_vector_plans_cover_the_shape(shape, dtype):
    """Channels-last, aligned, flat: the vector map whenever C is a
    multiple of the vector width, and its grid covers the shape."""
    g, n, c, s = shape
    st = (n * s * c, s * c, 1, c)
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = _cuda.bn_plan(shape, (st, st), itemsize, (0, 0))
    _check_cover(plan, shape)
    assert _cuda.BN_MAPS[plan.map] == "vector"
    assert plan.width == plan.tc * plan.vec


def test_plan_is_a_function_of_the_shape():
    """The split count -- hence the order of the sums -- depends on the
    shape, strides, dtype and alignment only."""
    st = (32 * 64 * 64, 64 * 64, 1, 64)
    a = _cuda.bn_plan((50, 32, 64, 64), (st, st), 2, (0, 0))
    _cuda.bn_plan.cache_clear()
    assert _cuda.bn_plan((50, 32, 64, 64), (st, st), 2, (0, 0)) == a


def _operands(layout, dtype, g=3, b=4, c=8, h=5, w=5, seed=0):
    rng = np.random.default_rng(seed)
    x = _view(layout, g, b, c, h, w, device="cpu")
    dy = torch.empty_like(x)
    x.copy_(torch.from_numpy(rng.normal(size=tuple(x.shape))))
    dy.copy_(torch.from_numpy(rng.normal(size=tuple(x.shape))))
    x, dy = x.to(dtype), dy.to(dtype)
    xf = x.float()
    mean = xf.mean((1, 3))
    r = torch.rsqrt(xf.var((1, 3), unbiased=False) + 1e-5)
    scale = torch.from_numpy(1 + 0.2 * rng.normal(size=(g, c))).float()
    return x, dy, mean.to(dtype), r.to(dtype), scale.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_composite_on_cpu_is_compose_of_the_plain_ops(layout, dtype):
    """``bn_bwd``'s CPU registration: ``_compose`` of the plain versions,
    bit for bit, in every layout."""
    ops = _operands(layout, dtype)
    want = bn._compose(bn.bn_bwd_reduce_plain, bn.bn_bwd_dx_plain, *ops)
    for a, b in zip(bn.bn_bwd(*ops), want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_coefficients_match_the_jax_formulas(dtype):
    """``bn_coefs`` forms dscale, dbias, mean(dxhat) and
    mean(dxhat * xhat) from the f32 sums as ``_bn_apply_bwd`` does (the
    CPU's true division on both sides)."""
    rng = np.random.default_rng(7)
    n = 1536
    sums = [(rng.normal(size=(3, 16)) * 100).astype(np.float32)
            for _ in range(3)]
    scale = (1 + 0.3 * rng.normal(size=(3, 16))).astype(np.float32)
    dt = jnp.dtype(dtype)
    js = jnp.asarray(scale).astype(dt)
    jdscale = jnp.asarray(sums[1]).astype(dt)
    want = (jdscale, jnp.asarray(sums[0]).astype(dt),
            jnp.asarray(sums[2]).astype(dt) / n, jdscale * js / n)
    got = bn.bn_coefs([torch.from_numpy(s) for s in sums],
                      torch.from_numpy(scale).to(getattr(torch, dtype)), n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))


def test_composite_launcher_refuses_cpu_tensors_and_counts_nothing():
    """The composite's CUDA launcher raises on a CPU tensor; the CPU path
    counts no launch and no thread map."""
    ops = _operands("fold-cl", torch.float32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _cuda.launch_bn_bwd(*ops)
    _cuda.reset_launches()
    bn.bn_bwd(*ops)
    assert dict(_cuda.LAUNCHES) == {} and dict(_cuda.MAPS) == {}
