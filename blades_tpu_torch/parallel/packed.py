"""Client lane-packing: P clients' local rounds in one lane of grouped
kernels (counterpart of ``blades_tpu/parallel/packed.py``).

The dense round trains a client block as one ``vmap`` over clients
(:meth:`~blades_tpu_torch.core.task.Task.local_round_batched`).  Packing
folds ``P`` clients into one vmapped lane by concatenating their
parameters along the channel / feature axis and running grouped kernels:

- convolutions become ``groups=P`` convolutions on channel-concatenated
  activations (:class:`~blades_tpu_torch.models.cnn.PackedFashionCNN`,
  :class:`~blades_tpu_torch.models.resnet.PackedResNet`): a grouped
  convolution is the clients' own convolutions, reassociated;
- dense layers become the pack-axis product ``(B, P, fin) x (P, fin,
  fout)`` (:class:`~blades_tpu_torch.models.layers.PackedDense`);
- ``BatchStatsNorm`` runs over the ``P * C`` channels (through the BN
  backward ops of :mod:`blades_tpu_torch.ops.bn_backward`): its
  statistics are per channel, and the channels are partitioned by
  client, so no activation crosses packed clients;
- dropout keep-masks are the unpacked round's draws, each client's own
  (:func:`~blades_tpu_torch.models.layers.packed_keyed_dropout`).

**The contract**: pack and unpack wrap the local round alone.  Updates
come back as the canonical ``(n, d)`` matrix before codecs, faults, DP,
forging and aggregation, and ``RoundState`` stays unpacked, so a
checkpoint of any pack factor resumes under any other.  A packed round
differs from the unpacked one by f32 reassociation in the grouped
kernels only.

Pack rules, by the parameter's module name (the last segment naming a
packable module decides, so momentum traces, which carry the
parameters' names, pack alike), in torch layout:

==================  =========================  ==========================
module              client leaf                packed leaf
==================  =========================  ==========================
``Conv_i``          weight ``(co, ci, kh, kw)``  concat -> ``(P*co, ...)``
``Conv_i``          bias ``(co,)``             concat -> ``(P*co,)``
``BatchStatsNorm``  weight / bias ``(c,)``     concat -> ``(P*c,)``
``Dense_i``         weight ``(fo, fi)``        stack of ``(fi, fo)`` ->
                                               ``(P, fi, fo)``
``Dense_i``         bias ``(fo,)``             stack -> ``(P, fo)``
==================  =========================  ==========================

The packed dense kernel keeps flax's ``(in, out)`` layout, so a packed
parameter dict converts to and from the JAX package's packed tree through
:mod:`blades_tpu_torch.convert` unchanged.
"""

from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from blades_tpu_torch.adversaries.base import trains_corrupted
from blades_tpu_torch.data.augment import get_augmentation
from blades_tpu_torch.utils.tree import FlatLayout

#: The width the "auto" heuristic packs up to: the JAX package's rule (a
#: TPU vector register's 128 lanes), kept so that both packages decide
#: alike and stamp the same ``pack_factor``; it is not a fact about the
#: H100.
LANE_WIDTH = 128

_CONCAT_RE = re.compile(r"^(Conv|BatchStatsNorm)_\d+$")
_STACK_RE = re.compile(r"^Dense_\d+$")


@dataclasses.dataclass(frozen=True)
class ClientPacking:
    """The packing spec a :class:`~blades_tpu_torch.core.round.FedRound`
    carries: ``pack`` clients per lane."""

    pack: int


class PackingUnsupported(ValueError):
    """The model or config has no packed formulation."""


# ---------------------------------------------------------------------------
# pack / unpack: pure layout transforms
# ---------------------------------------------------------------------------


def _path_rule(name: str) -> str:
    """``"concat"`` or ``"stack"`` for the parameter ``name``."""
    rule = None
    for seg in name.split(".")[:-1]:
        if _CONCAT_RE.match(seg):
            rule = "concat"
        elif _STACK_RE.match(seg):
            rule = "stack"
    if rule is None:
        raise PackingUnsupported(
            f"param path {name!r} belongs to no packable module "
            "(Conv/Dense/BatchStatsNorm)")
    return rule


def _is_kernel(name: str, x: torch.Tensor, batch_dims: int) -> bool:
    return name.endswith("weight") and x.dim() - batch_dims == 2


def pack_replicated(params: Dict[str, torch.Tensor], pack: int
                    ) -> Dict[str, torch.Tensor]:
    """P copies of the global parameters, packed (every client starts the
    round from them)."""
    out = {}
    for name, x in params.items():
        if _path_rule(name) == "concat":
            out[name] = torch.cat([x] * pack, 0)
        else:
            y = x.t() if _is_kernel(name, x, 0) else x
            out[name] = y[None].expand((pack,) + y.shape).contiguous()
    return out


def pack_stacked(tree: Dict[str, torch.Tensor], pack: int
                 ) -> Dict[str, torch.Tensor]:
    """A client-stacked dict, leaves ``(n, *s)``, packed per lane: leaves
    ``(n // pack, *packed)``."""
    out = {}
    for name, x in tree.items():
        lanes = x.shape[0] // pack
        if _path_rule(name) == "concat":
            out[name] = x.reshape((lanes, pack * x.shape[1]) + x.shape[2:])
        else:
            y = x.reshape((lanes, pack) + x.shape[1:])
            out[name] = (y.transpose(-1, -2).contiguous()
                         if _is_kernel(name, x, 1) else y)
    return out


def unpack_stacked(tree: Dict[str, torch.Tensor], pack: int
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_stacked` (exact): lane-packed leaves back to
    the client-stacked ``(n, *s)`` layout."""
    out = {}
    for name, x in tree.items():
        n = x.shape[0] * pack
        if _path_rule(name) == "concat":
            out[name] = x.reshape((n, x.shape[1] // pack) + x.shape[2:])
        else:
            if _is_kernel(name, x, 2):
                x = x.transpose(-1, -2)
            out[name] = x.reshape((n,) + x.shape[2:])
    return out


def unpack_tree(tree: Dict[str, torch.Tensor], pack: int
                ) -> Dict[str, torch.Tensor]:
    """One lane's packed dict to per-client leaves ``(P, *s)``."""
    out = {}
    for name, x in tree.items():
        if _path_rule(name) == "concat":
            out[name] = x.reshape((pack, x.shape[0] // pack) + x.shape[1:])
        else:
            out[name] = x.transpose(-1, -2) if _is_kernel(name, x, 1) else x
    return out


# ---------------------------------------------------------------------------
# packed model construction
# ---------------------------------------------------------------------------


def build_packed_model(model, pack: int):
    """The grouped-kernel counterpart of a supported model (the same
    parameter names, packed shapes), built on the meta device: the packed
    round runs it through ``functional_call`` on packed parameters."""
    from blades_tpu_torch.models.cnn import FashionCNN, PackedFashionCNN
    from blades_tpu_torch.models.mlp import MLP, PackedMLP
    from blades_tpu_torch.models.resnet import (
        BasicBlock,
        PackedResNet,
        ResNet,
    )

    with torch.device("meta"):
        if isinstance(model, MLP):
            return PackedMLP(pack, model.Dense_0.in_features,
                             model.Dense_0.out_features,
                             model.Dense_1.out_features,
                             model.Dense_2.out_features, model.dropout_rate)
        if isinstance(model, FashionCNN):
            return PackedFashionCNN(pack, model.Dense_2.out_features,
                                    model.Conv_0.in_channels, model.input_hw)
        if isinstance(model, ResNet):
            if model.block is not BasicBlock:
                raise PackingUnsupported(
                    "only BasicBlock ResNets have a packed formulation "
                    "(Bottleneck stages fail the width heuristic "
                    "regardless)")
            return PackedResNet(pack, model.stage_sizes,
                                model.Dense_0.out_features,
                                model.Conv_0.in_channels)
    raise PackingUnsupported(
        f"model {type(model).__name__} has no packed formulation "
        "(supported: MLP, FashionCNN, BasicBlock ResNets)")


def _feature_widths(task) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(convolution channel widths, dense feature widths) of one client's
    model, from its parameter shapes."""
    conv, dense = [], []
    for name, p in task.model.named_parameters():
        if name.endswith("weight"):
            if p.dim() == 4:
                conv.append(int(p.shape[0]))
            elif p.dim() == 2:
                dense.append(int(p.shape[0]))
    return tuple(conv), tuple(dense)


# ---------------------------------------------------------------------------
# eligibility: the "auto" heuristic and its loud fallback
# ---------------------------------------------------------------------------


def resolve_client_packing(
    fed_round,
    requested,
    *,
    num_clients: int,
    num_devices: Optional[int] = None,
    execution: str = "auto",
) -> Tuple[Any, Optional[dict]]:
    """Resolve a ``client_packing`` request against the round, as the JAX
    package does.

    ``requested``: ``"off"`` / None / 1 (no packing, silent), ``"auto"``
    (pack 2 iff eligible, else a ``RuntimeWarning`` with the reason and
    the unpacked round) or an int ``P >= 2`` (forced: what cannot run
    raises :class:`PackingUnsupported`; the width heuristic is advisory).

    Eligible: ``num_clients % P == 0``; the dense single-card round; a
    model with a packed form; no training hook (an adversary's data /
    grad hooks, client callbacks: update-forging adversaries such as
    ALIE and IPM run after the unpack and compose); and, under
    ``"auto"``, the narrowest and the widest layer each at most
    :data:`LANE_WIDTH` once multiplied by P.

    Returns ``(fed_round', decision)``, ``decision`` the dict the sweep's
    summaries carry (``requested``, ``pack_factor``, ``packed_lanes``,
    ``fallback`` reason or None), or None when packing was not
    requested.
    """
    if requested in (None, "off", False, 1):
        return fed_round, None
    auto = requested == "auto"
    if not auto:
        try:
            pack = int(requested)
        except (TypeError, ValueError):
            raise ValueError(
                f"client_packing must be 'off', 'auto' or an int >= 2, "
                f"got {requested!r}")
        if pack < 2:
            raise ValueError(f"client_packing int must be >= 2, got {pack}")
    else:
        pack = 2

    def fallback(reason: str):
        if not auto:
            raise PackingUnsupported(
                f"client_packing={requested!r} cannot run: {reason}")
        warnings.warn(
            f"client_packing='auto' falling back to unpacked execution: "
            f"{reason}", RuntimeWarning, stacklevel=3)
        return fed_round, {"requested": requested, "pack_factor": 1,
                           "packed_lanes": num_clients, "fallback": reason}

    if num_devices and num_devices > 1:
        return fallback("lane packing is single-chip (no mesh formulation)")
    if execution in ("streamed", "dsharded"):
        return fallback(
            f"lane packing needs the dense round, not execution="
            f"{execution!r}")
    if num_clients % pack:
        return fallback(
            f"num_clients={num_clients} is not divisible by pack_factor="
            f"{pack}")
    adv = fed_round.adversary
    if trains_corrupted(adv):
        return fallback(
            f"adversary {type(adv).__name__} hooks local training "
            "(data/grad hooks run per client inside the lane); only "
            "update-forging adversaries compose with packing")
    if fed_round.client_callbacks:
        return fallback(
            "client callbacks hook local training per client; the packed "
            "lane has no per-client callback formulation")
    try:
        build_packed_model(fed_round.task.model, pack)
    except PackingUnsupported as exc:
        return fallback(str(exc))
    if auto:
        conv, dense = _feature_widths(fed_round.task)
        widths = conv or dense
        if not widths:
            return fallback("model exposes no packable feature widths")
        if min(widths) * pack > LANE_WIDTH:
            return fallback(
                f"narrowest layer ({min(widths)} channels) already fills "
                f"a {LANE_WIDTH}-lane vreg at pack_factor={pack} — "
                "nothing to reclaim")
        if max(widths) * pack > LANE_WIDTH:
            return fallback(
                f"wide stages ({max(widths)} channels x pack_factor="
                f"{pack} > {LANE_WIDTH} lanes) would overflow the vreg "
                "tile and regress")
    fed_round = dataclasses.replace(fed_round,
                                    packing=ClientPacking(pack=pack))
    return fed_round, {"requested": requested, "pack_factor": pack,
                       "packed_lanes": num_clients // pack, "fallback": None}


# ---------------------------------------------------------------------------
# the packed local round
# ---------------------------------------------------------------------------


def packed_local_round_batched(
    task,
    pack: int,
    global_params: Dict[str, torch.Tensor],
    batches_x: torch.Tensor,
    batches_y: torch.Tensor,
    *,
    opt_state=None,
    generator: Optional[torch.Generator] = None,
    dropout_masks=None,
    aug_draws=None,
    out: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
):
    """Grouped-kernel replacement for ``Task.local_round_batched`` on a
    hook-free client block: ``(G, nb, B, ...)`` batches in, ``(updates
    (G, d), losses (G,), opt_state)`` out in client order, clients
    ``[l*P, (l+1)*P)`` in vmapped lane ``l`` (``G % P == 0``).

    The block's dropout masks and augmentation draws are drawn from
    ``generator`` (or handed in) exactly as the unpacked block draws
    them, so each client trains on its unpacked draws; what remains is
    the grouped kernels' f32 reassociation.  Each lane's loss is the sum
    of its clients' clamped cross-entropies: their parameters are
    disjoint, so its gradient is each client's own.
    """
    g_count, nb = batches_x.shape[:2]
    if g_count % pack:
        raise ValueError(f"a block of {g_count} clients does not split into "
                         f"lanes of {pack}")
    lanes = g_count // pack
    shape = (g_count, nb, batches_x.shape[2])
    dev = batches_x.device
    layout = FlatLayout(global_params)
    masks = dropout_masks
    if masks is None:
        masks = task.draw_dropout_masks(generator, shape, dev)
    aug = aug_draws
    if aug is None:
        aug = task.draw_augment(generator, shape, dev)
    momentum = task.spec.momentum
    if momentum and opt_state is None:
        raise ValueError("client momentum needs the block's opt_state")
    pm = build_packed_model(task.model, pack)
    packed_global = pack_replicated(global_params, pack)
    opt = None if opt_state is None else pack_stacked(opt_state, pack)
    dt, lr, clamp = task.compute_dtype, task.spec.lr, task.spec.loss_clamp

    def loss_fn(pp, x, y, m):
        # x (P, B, ...), y (P, B), m one (P, B, F) mask per site
        if dt is not None:
            pp = {k: v.to(dt) for k, v in pp.items()}
            x = x.to(dt)
        logits = functional_call(pm, pp, (pm.pack_inputs(x),),
                                 {"dropout_masks": m})
        ce = F.cross_entropy(logits.float().permute(1, 2, 0), y,
                             reduction="none")
        ce_g = ce.mean(1).clamp(0.0, clamp)
        return ce_g.sum(), ce_g

    def lanes_of(t):
        return t.reshape((lanes, pack) + t.shape[1:])

    params, batched = packed_global, False
    losses = []
    for s in range(nb):
        x, y = batches_x[:, s], batches_y[:, s]
        if aug is not None:
            x = get_augmentation(task.spec.augment)(
                x, offsets=aug[0][:, s], flips=aug[1][:, s])
        m = None if masks is None else tuple(lanes_of(mk[:, s])
                                             for mk in masks)
        step = vmap(grad_and_value(loss_fn, has_aux=True),
                    in_dims=(0 if batched else None, 0, 0,
                             None if m is None else 0))
        grads, (_, loss) = step(params, lanes_of(x), lanes_of(y), m)
        if momentum:
            opt = {k: grads[k] + momentum * opt[k] for k in grads}
            grads = opt
        params = {k: params[k] + (-lr) * grads[k] for k in params}
        batched = True
        losses.append(loss.reshape(g_count))
    delta = unpack_stacked({k: params[k] - packed_global[k] for k in params},
                           pack)
    if out is None:
        out = torch.empty((g_count, layout.d),
                          dtype=out_dtype or torch.float32, device=dev)
    for lf in layout.leaves:
        out[:, lf.offset:lf.offset + lf.size] = layout.flat_leaf(
            lf, delta[lf.name], batch_dims=1).to(out.dtype)
    return (out, torch.stack(losses, 1).mean(1),
            None if opt is None else unpack_stacked(opt, pack))
