"""Task = model + loss + the local-SGD round (counterpart of
``blades_tpu/core/task.py``).

Parameters are a ``{name: tensor}`` dict in torch layout, applied with
``torch.func.functional_call``; a client block trains as one
``torch.func.vmap`` of ``grad_and_value`` over the client axis.  The update
a client sends is ``params_after - incoming_global`` per leaf, cast to the
storage dtype and laid out in the reference's flat order
(:mod:`blades_tpu_torch.utils.tree`).

Local training is plain SGD (``p + (-lr) * g`` per step, as optax.sgd with
no momentum).  Under ``compute_dtype="bfloat16"`` the forward and backward
run in bf16 (parameters are cast inside the loss, so gradients and the
master parameters stay f32) and the logits are cast to f32 for the
cross-entropy, which is clamped to ``[0, loss_clamp]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from blades_tpu_torch.models.catalog import get_model
from blades_tpu_torch.utils.tree import FlatLayout

_DTYPES = {None: None, "bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Declarative task config, the reference's fields."""

    model: Any = "mlp"
    num_classes: int = 10
    input_shape: Tuple[int, ...] = (28, 28, 1)
    lr: float = 0.1
    momentum: float = 0.0
    loss_clamp: float = 1e6
    augment: Any = None
    compute_dtype: Any = None  # e.g. "bfloat16"

    def build(self) -> "Task":
        if self.momentum:
            raise NotImplementedError(
                "client momentum is not in the port yet (a later slice "
                "brings per-client optimizer state)")
        if self.augment is not None:
            raise NotImplementedError(
                "train-time augmentation is not in the port yet (a later "
                "slice, with the data pipeline)")
        model = get_model(self.model, self.num_classes, self.input_shape)
        return Task(spec=self, model=model)


@dataclasses.dataclass(frozen=True, eq=False)
class Task:
    spec: TaskSpec
    model: nn.Module

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return _DTYPES[self.spec.compute_dtype]

    def init_params(self, generator: torch.Generator,
                    device=None) -> Dict[str, torch.Tensor]:
        """Fresh parameters drawn from ``generator`` (a CPU generator) as
        flax initialises them: lecun-normal kernels (truncated at two
        standard deviations), zero biases, unit norm scales."""
        params = {}
        for name, p in self.model.named_parameters():
            t = torch.empty(p.shape, dtype=torch.float32)
            if name.endswith("weight") and p.dim() > 1:
                fan_in = math.prod(p.shape[1:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif name.endswith("weight"):
                t.fill_(1.0)
            else:
                t.zero_()
            params[name] = t.to(device) if device is not None else t
        return params

    def loss_fn(self, params, x, y, dropout_masks=None):
        dt = self.compute_dtype
        if dt is not None:
            params = {k: v.to(dt) for k, v in params.items()}
            x = x.to(dt)
        logits = functional_call(self.model, params, (x,),
                                 {"dropout_masks": dropout_masks})
        ce = F.cross_entropy(logits.float(), y)
        return ce.clamp(0.0, self.spec.loss_clamp)

    def draw_dropout_masks(self, generator, shape, device):
        """Keep-masks ``(*shape, width)`` per dropout layer, or None."""
        rate = getattr(self.model, "dropout_rate", 0.0)
        if not rate:
            return None
        if generator is None:
            raise ValueError("train-mode dropout needs a generator")
        return tuple(torch.rand(shape + (w,), generator=generator,
                                device=device) >= rate
                     for w in self.model.dropout_widths)

    def local_round_batched(
        self,
        global_params: Dict[str, torch.Tensor],
        batches_x: torch.Tensor,
        batches_y: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        dropout_masks=None,
        out: Optional[torch.Tensor] = None,
        out_dtype: Optional[torch.dtype] = None,
    ):
        """A client block's local rounds: ``(G, nb, B, ...)`` batches ->
        ``(updates (G, d), losses (G,))``.

        ``dropout_masks`` (one ``(G, nb, B, width)`` bool keep-mask per
        dropout layer) replaces the draw from ``generator``.

        With ``out`` (a ``(G, d)`` view of the round's update buffer) the
        updates are written into it in place, leaf by leaf, and ``out`` is
        returned; this saves the block's f32 ``(G, d)`` concatenation.
        """
        g_count, nb = batches_x.shape[:2]
        layout = FlatLayout(global_params)
        masks = dropout_masks
        if masks is None:
            masks = self.draw_dropout_masks(
                generator, (g_count, nb, batches_x.shape[2]),
                batches_x.device)
        lr = self.spec.lr
        params, batched = global_params, False
        losses = []
        for s in range(nb):
            m = None if masks is None else tuple(mk[:, s] for mk in masks)
            step = vmap(grad_and_value(self.loss_fn),
                        in_dims=(0 if batched else None, 0, 0,
                                 None if m is None else 0))
            grads, loss = step(params, batches_x[:, s], batches_y[:, s], m)
            params = {k: params[k] + (-lr) * grads[k] for k in params}
            batched = True
            losses.append(loss)
        if out is None:
            out = torch.empty((g_count, layout.d),
                              dtype=out_dtype or torch.float32,
                              device=batches_x.device)
        for lf in layout.leaves:
            upd = params[lf.name] - global_params[lf.name]
            out[:, lf.offset:lf.offset + lf.size] = layout.flat_leaf(
                lf, upd, batch_dims=1).to(out.dtype)
        return out, torch.stack(losses, 1).mean(1)

    def local_round(self, global_params, batches_x, batches_y, *,
                    generator=None, dropout_masks=None, out_dtype=None):
        """One client's local round: ``(nb, B, ...)`` batches ->
        ``(update (d,), mean loss)``; ``dropout_masks`` holds one
        ``(nb, B, width)`` keep-mask per dropout layer."""
        masks = (None if dropout_masks is None
                 else tuple(m[None] for m in dropout_masks))
        upd, loss = self.local_round_batched(
            global_params, batches_x[None], batches_y[None],
            generator=generator, dropout_masks=masks, out_dtype=out_dtype)
        return upd[0], loss[0]
