"""The per-client BatchNorm backward as two custom ops (counterpart of the
two Pallas bodies of ``artifacts/perf_r4/time_bn_pallas.py``, computing
the VJP the JAX package trains with, ``blades_tpu/models/layers.py``
``_bn_apply_bwd``).

Operands are ``(G, N, C, S)`` views (clients, rows, channels, spatial)
taken through their strides, and per-(client, channel) vectors ``(G, C)``
of the compute dtype:

- :func:`bn_bwd_reduce` returns the f32 sums ``(dbias, dscale, dxhat)``,
  ``dbias = sum dy``, ``dscale = sum dy * xhat`` and ``sum dy * scale``
  with ``xhat = (x - mean) * r``, each product rounded to the compute
  dtype before it is summed;
- :func:`bn_bwd_dx` returns ``dx = r * (dy * scale - mean_dxhat - xhat *
  mean_dxhat_xhat)``, rounded to the compute dtype after each operation.

Both are ``torch.library.custom_op``s: the CPU implementation is the plain
PyTorch version, the CUDA implementation launches the kernel of
``csrc/bn_backward.cu`` or raises.  Their vmap rule folds the vmapped axis
into the client axis, so a client block under ``torch.func.vmap`` is ONE
launch of each, whatever layout functorch hands over (``(G*B, C, H, W)``
while the parameters are unbatched, ``(B, G*C, H, W)`` once they are,
channels-last from cuDNN): the kernels read through strides and nothing is
copied.  f64 runs on the CPU only (for ``gradcheck``).

:func:`bn_bwd` is the whole backward as one more custom op -- the two
passes with the coefficients ``mean_dxhat = T(sum dxhat) / n`` and
``mean_dxhat_xhat = T(dscale) * scale / n`` between them, in the compute
dtype T -- so that ``BNApply.backward`` crosses functorch's Python vmap
machinery once per layer: that crossing costs more host time than the
kernels take on the card.  On the card it is one host call
(``_cuda.launch_bn_bwd``): the reduction kernel forms the coefficients,
``dscale`` and ``dbias`` in its own launch, and the dx kernel follows; no
PyTorch elementwise op runs between them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from blades_tpu_torch.ops import _cuda


def _acc(t: Tensor) -> Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _chan(v: Tensor) -> Tensor:
    """``(G, C)`` -> ``(G, 1, C, 1)``, broadcasting over ``(G, N, C, S)``."""
    return v[:, None, :, None]


def _check(x: Tensor, dy: Tensor, *vecs: Tensor) -> None:
    if x.dim() != 4 or dy.shape != x.shape:
        raise ValueError(f"need x and dy of one (G, N, C, S) shape, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    for v in vecs:
        if v.shape != (x.shape[0], x.shape[2]):
            raise ValueError(f"per-channel operand of shape {tuple(v.shape)},"
                             f" expected {(x.shape[0], x.shape[2])}")


def bn_bwd_reduce_plain(x, dy, mean, r, scale) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of :func:`bn_bwd_reduce`."""
    _check(x, dy, mean, r, scale)
    xhat = (x - _chan(mean)) * _chan(r)
    dims = (1, 3)
    return (_acc(dy).sum(dims), _acc(dy * xhat).sum(dims),
            _acc(dy * _chan(scale)).sum(dims))


def bn_bwd_dx_plain(x, dy, mean, r, scale, mean_dxhat,
                    mean_dxhat_xhat) -> Tensor:
    """Plain PyTorch version of :func:`bn_bwd_dx`."""
    _check(x, dy, mean, r, scale, mean_dxhat, mean_dxhat_xhat)
    xhat = (x - _chan(mean)) * _chan(r)
    dxhat = dy * _chan(scale)
    return _chan(r) * (dxhat - _chan(mean_dxhat)
                       - xhat * _chan(mean_dxhat_xhat))


@torch.library.custom_op("blades_tpu_torch::bn_bwd_reduce", mutates_args=(),
                         device_types="cpu")
def bn_bwd_reduce(x: Tensor, dy: Tensor, mean: Tensor, r: Tensor,
                  scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-(client, channel) sums ``(dbias, dscale, dxhat)`` in f32 (f64
    for f64 inputs), each ``(G, C)``."""
    return bn_bwd_reduce_plain(x, dy, mean, r, scale)


@bn_bwd_reduce.register_kernel("cuda")
def _bn_bwd_reduce_cuda(x, dy, mean, r, scale):
    return _cuda.launch_bn_reduce("bn_bwd_reduce", x, dy, mean, r, scale)


@bn_bwd_reduce.register_fake
def _bn_bwd_reduce_fake(x, dy, mean, r, scale):
    dt = torch.promote_types(x.dtype, torch.float32)
    g, _, c, _ = x.shape
    return tuple(x.new_empty((g, c), dtype=dt) for _ in range(3))


@torch.library.custom_op("blades_tpu_torch::bn_bwd_dx", mutates_args=(),
                         device_types="cpu")
def bn_bwd_dx(x: Tensor, dy: Tensor, mean: Tensor, r: Tensor, scale: Tensor,
              mean_dxhat: Tensor, mean_dxhat_xhat: Tensor) -> Tensor:
    """``dx`` of ``x``'s shape and dtype."""
    return bn_bwd_dx_plain(x, dy, mean, r, scale, mean_dxhat,
                           mean_dxhat_xhat)


@bn_bwd_dx.register_kernel("cuda")
def _bn_bwd_dx_cuda(x, dy, mean, r, scale, mean_dxhat, mean_dxhat_xhat):
    return _cuda.launch_bn_dx("bn_bwd_dx", x, dy, mean, r, scale, mean_dxhat,
                              mean_dxhat_xhat)


@bn_bwd_dx.register_fake
def _bn_bwd_dx_fake(x, dy, mean, r, scale, mean_dxhat, mean_dxhat_xhat):
    return torch.empty_like(x)


def _fold(info, t: Tensor, bdim) -> Tensor:
    """The physical operand with the vmapped axis merged into the client
    axis: ``(V, G, ...)`` -> ``(V * G, ...)``, a view for the layouts a
    client block produces (there G == 1)."""
    t = (t.expand((info.batch_size,) + t.shape) if bdim is None
         else t.movedim(bdim, 0))
    return t.flatten(0, 1)


def _unfold(info, t: Tensor) -> Tensor:
    return t.unflatten(0, (info.batch_size, -1))


def _bn_bwd_reduce_vmap(info, in_dims, *args):
    out = bn_bwd_reduce(*(_fold(info, a, d) for a, d in zip(args, in_dims)))
    return tuple(_unfold(info, o) for o in out), (0, 0, 0)


def _bn_bwd_dx_vmap(info, in_dims, *args):
    dx = bn_bwd_dx(*(_fold(info, a, d) for a, d in zip(args, in_dims)))
    return _unfold(info, dx), 0


bn_bwd_reduce.register_vmap(_bn_bwd_reduce_vmap)
bn_bwd_dx.register_vmap(_bn_bwd_dx_vmap)


def bn_coefs(sums, scale: Tensor, n: int):
    """``(dscale, dbias, mean_dxhat, mean_dxhat_xhat)`` in the compute
    dtype of ``scale`` from the f32 ``sums`` (dbias, dscale, sum dxhat), as
    ``_bn_apply_bwd`` forms them.  The reduction kernel's finish computes
    the same on the card, where ``/ n`` is a multiply by the f32
    reciprocal of ``n``."""
    s_bias, s_scale, s_dxhat = sums
    dt = scale.dtype
    dscale = s_scale.to(dt)
    return dscale, s_bias.to(dt), s_dxhat.to(dt) / n, dscale * scale / n


def _compose(reduce, dx_pass, x, dy, mean, r, scale):
    """The backward from a reduction and a dx pass, with the
    coefficients of :func:`bn_coefs` between them."""
    dscale, dbias, md, mdx = bn_coefs(reduce(x, dy, mean, r, scale), scale,
                                      x.shape[1] * x.shape[3])
    return dx_pass(x, dy, mean, r, scale, md, mdx), dscale, dbias


def bn_bwd_plain(x, dy, mean, r, scale):
    """Plain PyTorch version of :func:`bn_bwd`."""
    return _compose(bn_bwd_reduce_plain, bn_bwd_dx_plain, x, dy, mean, r,
                    scale)


def _bn_bwd_impl(x, dy, mean, r, scale):
    """What the vmap rule runs on the folded operands."""
    return bn_bwd(x, dy, mean, r, scale)


@torch.library.custom_op("blades_tpu_torch::bn_bwd", mutates_args=(),
                         device_types="cpu")
def bn_bwd(x: Tensor, dy: Tensor, mean: Tensor, r: Tensor,
           scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The BatchNorm backward over ``(G, N, C, S)`` operands: ``(dx,
    dscale (G, C), dbias (G, C))`` in ``x``'s dtype: on the CPU
    :func:`bn_bwd_plain`, on the card the two kernels from one host
    call."""
    return bn_bwd_plain(x, dy, mean, r, scale)


@bn_bwd.register_kernel("cuda")
def _bn_bwd_cuda(x, dy, mean, r, scale):
    return _cuda.launch_bn_bwd(x, dy, mean, r, scale)[:3]


@bn_bwd.register_fake
def _bn_bwd_fake(x, dy, mean, r, scale):
    g, _, c, _ = x.shape
    return (torch.empty_like(x), x.new_empty((g, c)), x.new_empty((g, c)))


def _bn_bwd_vmap(info, in_dims, *args):
    out = _bn_bwd_impl(*(_fold(info, a, d) for a, d in zip(args, in_dims)))
    return tuple(_unfold(info, o) for o in out), (0, 0, 0)


bn_bwd.register_vmap(_bn_bwd_vmap)
