"""Client callbacks (counterpart of ``blades_tpu/core/callbacks.py``): the
reference's hook chain as functions over a client block.

Four hook points, in the reference's order: ``on_round_begin(params,
opt_state, malicious)``, ``on_batch_begin(x, y, malicious)``,
``on_backward_end(grads, malicious)`` and ``on_round_end(update,
malicious)``.  In the JAX package each hook acts on one vmapped lane; in
the port it acts on a whole client block, as the adversary's hooks do
(:mod:`blades_tpu_torch.core.task`): ``malicious`` is the block's ``(G,)``
bool mask, and the batches and the gradients carry a leading client axis.
The rounds run ``on_batch_begin`` and ``on_backward_end``; a callback
that changes ``on_round_begin`` or ``on_round_end`` raises
``NotImplementedError`` (no ported callback does).

:class:`ClippingCallback` is the reference's benign gradient clipping
(``client_config: {clip_gradient_norm: ...}`` or a ``{type: Clipping}``
callback).  The chain composes BEFORE the adversary's hooks
(:meth:`blades_tpu_torch.core.round.FedRound.hooks`), as the reference
appends the attack callback last.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ClientCallback:
    """Base callback: all four hooks are the identity."""

    def on_round_begin(self, params, opt_state, malicious):
        del malicious
        return params, opt_state

    def on_batch_begin(self, x, y, malicious):
        del malicious
        return x, y

    def on_backward_end(self, grads, malicious):
        del malicious
        return grads

    def on_round_end(self, update, malicious):
        del malicious
        return update


def overrides(cb: ClientCallback, hook: str) -> bool:
    """Whether ``cb`` (a chain: any of its callbacks) changes ``hook``."""
    if isinstance(cb, CallbackChain):
        return any(overrides(c, hook) for c in cb.callbacks)
    return getattr(type(cb), hook) is not getattr(ClientCallback, hook)


@dataclasses.dataclass(frozen=True)
class CallbackChain(ClientCallback):
    """Folds a tuple of callbacks in order."""

    callbacks: Tuple[ClientCallback, ...] = ()

    def on_round_begin(self, params, opt_state, malicious):
        for cb in self.callbacks:
            params, opt_state = cb.on_round_begin(params, opt_state, malicious)
        return params, opt_state

    def on_batch_begin(self, x, y, malicious):
        for cb in self.callbacks:
            x, y = cb.on_batch_begin(x, y, malicious)
        return x, y

    def on_backward_end(self, grads, malicious):
        for cb in self.callbacks:
            grads = cb.on_backward_end(grads, malicious)
        return grads

    def on_round_end(self, update, malicious):
        for cb in self.callbacks:
            update = cb.on_round_end(update, malicious)
        return update


@dataclasses.dataclass(frozen=True)
class ClippingCallback(ClientCallback):
    """Benign gradient clipping after backward: scale each client's
    gradients so that their global L2 norm, over all of its leaves, is at
    most ``clip_threshold`` (``clip_grad_norm_`` semantics, the norm
    floored at 1e-12).  Applies to every lane."""

    clip_threshold: float = 1.0

    def on_backward_end(self, grads, malicious):
        del malicious
        sq = sum((g * g).flatten(1).sum(1) for g in grads.values())
        norm = sq.clamp(min=0.0).sqrt()
        # A true division (a Python scalar over a tensor would multiply by
        # the reciprocal).
        thr = torch.full_like(norm, self.clip_threshold)
        scale = (thr / norm.clamp(min=1e-12)).clamp(max=1.0)
        return {k: g * scale.view((-1,) + (1,) * (g.dim() - 1))
                for k, g in grads.items()}


CALLBACKS = {"Clipping": ClippingCallback}


def get_callback(spec) -> ClientCallback:
    """Resolve ``{"type": ..., **kwargs}``, a name or an instance."""
    if isinstance(spec, ClientCallback):
        return spec
    if isinstance(spec, str):
        spec = {"type": spec}
    spec = dict(spec)
    name = spec.pop("type")
    if name not in CALLBACKS:
        raise KeyError(f"unknown callback {name!r}; known: {sorted(CALLBACKS)}")
    return CALLBACKS[name](**spec)
