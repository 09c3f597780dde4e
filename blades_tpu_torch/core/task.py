"""Task = model + loss + the local-SGD round + evaluation (counterpart of
``blades_tpu/core/task.py``).

Parameters are a ``{name: tensor}`` dict in torch layout, applied with
``torch.func.functional_call``; a client block trains as one
``torch.func.vmap`` of ``grad_and_value`` over the client axis.  The update
a client sends is ``params_after - incoming_global`` per leaf, cast to the
storage dtype and laid out in the reference's flat order
(:mod:`blades_tpu_torch.utils.tree`).

Local training is optax.sgd: ``p + (-lr) * g`` per step, or with client
momentum ``m`` the trace rule ``t = g + m * t; p + (-lr) * t`` (the trace
starts at zero and is per-client state carried across rounds).  Each step
runs, in the reference's order, train-time augmentation, the adversary's
``data_hook``, the vmapped backward, the adversary's ``grad_hook``, then
the optimizer.  The hooks act on the whole block, branchless: a
``(G,)`` malicious mask selects the attacked lanes.

Under ``compute_dtype="bfloat16"`` the forward and backward run in bf16
(parameters are cast inside the loss, so gradients and the master
parameters stay f32) and the logits are cast to f32 for the
cross-entropy, which is clamped to ``[0, loss_clamp]``.  Evaluation runs
in f32, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from collections import namedtuple
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from blades_tpu_torch.data.augment import draw_crop_flip, get_augmentation
from blades_tpu_torch.models.catalog import get_model
from blades_tpu_torch.utils.tree import FlatLayout

_DTYPES = {None: None, "bfloat16": torch.bfloat16, "float32": torch.float32}

#: Per-block training hooks (the client callbacks, then the adversary's):
#: ``data(x, y, malicious) -> (x, y)`` and ``grad(grads, malicious) ->
#: grads`` over a client block, ``malicious`` the block's ``(G,)`` bool
#: mask.
Hooks = namedtuple("Hooks", ["data", "grad"])


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
        get_augmentation(self.augment)  # an unknown name fails here
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
        standard deviations; the fan-in of a flax-layout kernel is its
        module's ``kernel_fan_in``), zero biases, unit norm scales, and
        CCT's ``pos_embed`` from ``truncated_normal(0.2)`` (a normal of
        std 0.2 cut at two of them)."""
        fan_ins = {f"{m}.weight": mod.kernel_fan_in
                   for m, mod in self.model.named_modules()
                   if hasattr(mod, "kernel_fan_in")}
        params = {}
        for name, p in self.model.named_parameters():
            t = torch.empty(p.shape, dtype=torch.float32)
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and p.dim() > 1:
                fan_in = fan_ins.get(name, math.prod(p.shape[1:]))
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif leaf == "weight":
                t.fill_(1.0)
            elif leaf == "bias":
                t.zero_()
            elif leaf == "pos_embed":
                nn.init.trunc_normal_(t, 0.0, 0.2, -0.4, 0.4,
                                      generator=generator)
            else:
                raise ValueError(f"no initializer for parameter {name!r}")
            params[name] = t.to(device) if device is not None else t
        return params

    def init_client_opt_state(self, params, num_clients: int):
        """Per-client optimizer state: ``None`` under plain SGD, else the
        momentum traces, ``{name: zeros (num_clients, *shape)}``."""
        if not self.spec.momentum:
            return None
        return {k: torch.zeros((num_clients,) + v.shape, dtype=v.dtype,
                               device=v.device) for k, v in params.items()}

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
        """One keep-mask per dropout site of the model, for batches of
        ``shape`` (G, nb, B): ``(G, nb, *site_shape)``, kept with
        probability ``1 - rate``, in site order; or None.  A model states
        its sites as ``dropout_sites(B) -> ((site_shape, rate), ...)``
        (the MLP's ``((B, width), rate)`` per layer; CCT's ``(q, kv)``
        attention masks and ``(B,)`` stochastic-depth draws)."""
        sites_of = getattr(self.model, "dropout_sites", None)
        sites = sites_of(shape[-1]) if sites_of is not None else ()
        if not sites:
            return None
        if generator is None:
            raise ValueError("train-mode dropout needs a generator")
        return tuple(torch.rand(tuple(shape[:-1]) + tuple(s),
                                generator=generator, device=device) >= rate
                     for s, rate in sites)

    def draw_augment(self, generator, shape, device):
        """The augmentation's draws ``(offsets (*shape, 2), flips
        (*shape,))`` for batches of ``shape`` (G, nb, B), or None."""
        if get_augmentation(self.spec.augment) is None:
            return None
        if generator is None:
            raise ValueError("train-time augmentation needs a generator")
        return draw_crop_flip(generator, shape, device=device)

    def local_round_batched(
        self,
        global_params: Dict[str, torch.Tensor],
        batches_x: torch.Tensor,
        batches_y: torch.Tensor,
        *,
        opt_state=None,
        malicious: Optional[torch.Tensor] = None,
        hooks: Optional[Hooks] = None,
        generator: Optional[torch.Generator] = None,
        dropout_masks=None,
        aug_draws=None,
        out: Optional[torch.Tensor] = None,
        out_dtype: Optional[torch.dtype] = None,
        sq_out: Optional[torch.Tensor] = None,
    ):
        """A client block's local rounds: ``(G, nb, B, ...)`` batches ->
        ``(updates (G, d), losses (G,), opt_state)``.

        ``opt_state`` is the block's momentum traces (``{name: (G,
        *shape)}``, required under client momentum) and comes back
        advanced.  ``hooks`` with the block's ``malicious (G,)`` mask are
        the training hooks (:class:`Hooks`).  ``dropout_masks`` (one ``(G, nb,
        *site_shape)`` bool keep-mask per dropout site, as
        :meth:`draw_dropout_masks` draws them) and ``aug_draws``
        (``(offsets (G, nb, B, 2), flips (G, nb, B))``) replace the draws
        from ``generator``.

        With ``out`` (a ``(G, d)`` view of the round's update buffer) the
        updates are written into it in place, leaf by leaf, and ``out`` is
        returned; this saves the block's f32 ``(G, d)`` concatenation.
        With ``sq_out`` (a ``(G,)`` f32 tensor) each update's f32 squared
        norm, taken before the cast to ``out``'s dtype, is added into it
        leaf by leaf (what the streamed round's DP clip needs).
        """
        g_count, nb = batches_x.shape[:2]
        shape = (g_count, nb, batches_x.shape[2])
        layout = FlatLayout(global_params)
        masks = dropout_masks
        if masks is None:
            masks = self.draw_dropout_masks(generator, shape, batches_x.device)
        aug = aug_draws
        if aug is None:
            aug = self.draw_augment(generator, shape, batches_x.device)
        momentum = self.spec.momentum
        if momentum and opt_state is None:
            raise ValueError("client momentum needs the block's opt_state")
        if hooks is not None and malicious is None:
            raise ValueError("adversary hooks need the block's malicious mask")
        lr = self.spec.lr
        params, batched = global_params, False
        losses = []
        for s in range(nb):
            x, y = batches_x[:, s], batches_y[:, s]
            if aug is not None:
                x = get_augmentation(self.spec.augment)(
                    x, offsets=aug[0][:, s], flips=aug[1][:, s])
            if hooks is not None:
                x, y = hooks.data(x, y, malicious)
            m = None if masks is None else tuple(mk[:, s] for mk in masks)
            step = vmap(grad_and_value(self.loss_fn),
                        in_dims=(0 if batched else None, 0, 0,
                                 None if m is None else 0))
            grads, loss = step(params, x, y, m)
            if hooks is not None:
                grads = hooks.grad(grads, malicious)
            if momentum:
                opt_state = {k: grads[k] + momentum * opt_state[k]
                             for k in grads}
                grads = opt_state
            params = {k: params[k] + (-lr) * grads[k] for k in params}
            batched = True
            losses.append(loss)
        if out is None:
            out = torch.empty((g_count, layout.d),
                              dtype=out_dtype or torch.float32,
                              device=batches_x.device)
        for lf in layout.leaves:
            upd = layout.flat_leaf(
                lf, params[lf.name] - global_params[lf.name], batch_dims=1)
            if sq_out is not None:
                sq_out += (upd * upd).sum(1)
            out[:, lf.offset:lf.offset + lf.size] = upd.to(out.dtype)
        return out, torch.stack(losses, 1).mean(1), opt_state

    def local_round(self, global_params, batches_x, batches_y, *,
                    generator=None, dropout_masks=None, out_dtype=None):
        """One client's local round from a fresh optimizer state:
        ``(nb, B, ...)`` batches -> ``(update (d,), mean loss)``;
        ``dropout_masks`` holds one ``(nb, *site_shape)`` keep-mask per
        dropout site."""
        masks = (None if dropout_masks is None
                 else tuple(m[None] for m in dropout_masks))
        upd, loss, _ = self.local_round_batched(
            global_params, batches_x[None], batches_y[None],
            opt_state=self.init_client_opt_state(global_params, 1),
            generator=generator, dropout_masks=masks, out_dtype=out_dtype)
        return upd[0], loss[0]

    @torch.no_grad()
    def evaluate(self, params, x, y, mask) -> Dict[str, torch.Tensor]:
        """Masked f32 evaluation of a block of clients' padded test shards
        ``x (G, cap, ...)``, ``y (G, cap)``, ``mask (G, cap)``: per-client
        summed cross-entropy, top-1 and top-3 correct counts and sample
        count, each ``(G,)``.  Batch-statistics layers normalise over each
        client's whole shard, padding included, as the reference's do."""
        def logits_of(cx):
            return functional_call(self.model, params, (cx,))

        logits = vmap(logits_of)(x.float()).float()
        ce = F.cross_entropy(logits.flatten(0, 1), y.flatten().long(),
                             reduction="none").view(y.shape)
        m = mask.float()
        top1 = (logits.argmax(-1) == y).float()
        k = min(3, logits.shape[-1])
        topk = (logits.topk(k, -1).indices == y[..., None]).any(-1).float()
        return {"ce_sum": (ce * m).sum(1), "top1_sum": (top1 * m).sum(1),
                "top3_sum": (topk * m).sum(1), "count": m.sum(1)}
