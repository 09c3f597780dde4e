"""Batch-statistics normalisation with a hand-written backward.

The reference pins ``track_running_stats=False`` on every BatchNorm, so a
layer normalises by the current batch's statistics and carries no state:
models stay pure functions of their parameters, which is what lets a client
block run as one ``torch.func.vmap``.

The statistics accumulate in f32 with a two-pass centered variance (the
one-pass ``E[x^2] - mean^2`` form loses the variance to rounding when
``|mean| / std`` is large).  The backward is the standard BN backward
written out (two reductions, ``dscale`` reused for the ``dx`` projection),
saving the input ``x`` rather than ``xhat``, as
``blades_tpu/models/layers.py`` does.  It runs as
:func:`blades_tpu_torch.ops.bn_backward.bn_bwd`, the two custom ops of that
module (the CUDA kernels on the card), whose vmap rule makes a vmapped
client block one launch of each.
Channels are on dim 1 (NCHW).
"""

from __future__ import annotations

import torch
from torch import nn

from blades_tpu_torch.ops.bn_backward import bn_bwd


def _dims(x: torch.Tensor):
    return [0] + list(range(2, x.dim()))


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: f32, or f64 for f64 inputs."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bn_normalize(x: torch.Tensor, eps: float):
    """``(xhat, mean, r)``: f32 statistics, cast back to ``x.dtype``."""
    dims = _dims(x)
    xf = _acc(x)
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    r = torch.rsqrt(var + eps)
    mean, r = mean.to(x.dtype), r.to(x.dtype)
    return (x - mean) * r, mean, r


def _as_gncs(t: torch.Tensor) -> torch.Tensor:
    """``(N, C, *spatial)`` -> the ops' ``(1, N, C, S)`` view."""
    return t.reshape(t.shape[0], t.shape[1], -1).unsqueeze(0)


class BNApply(torch.autograd.Function):
    """``y = xhat * scale + bias`` with the hand-written backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, scale, bias, eps):
        xhat, mean, r = bn_normalize(x, eps)
        return xhat * _bcast(scale, x) + _bcast(bias, x), mean, r

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _, _ = inputs
        _, mean, r = output
        ctx.save_for_backward(x, mean, r, scale)
        ctx.mark_non_differentiable(mean, r)

    @staticmethod
    def backward(ctx, dy, _dmean, _dr):
        x, mean, r, scale = ctx.saved_tensors
        vec = [v.reshape(1, -1) for v in (mean, r, scale)]
        # torch.func.grad runs this backward with grad mode on; the ops
        # have no backward of their own, and none is needed.
        with torch.no_grad():
            dx, dscale, dbias = bn_bwd(_as_gncs(x), _as_gncs(dy), *vec)
        return dx.reshape(x.shape), dscale[0], dbias[0], None


def bn_apply(x, scale, bias, eps: float = 1e-5):
    return BNApply.apply(x, scale, bias, eps)[0]


class BatchStatsNorm(nn.Module):
    """Batch-statistics-only normalisation with learned scale (``weight``)
    and ``bias``; the flat layout names them ``scale`` and ``bias``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_apply(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.eps)
