"""Server: robust aggregate + optimizer step (counterpart of
``blades_tpu/core/server.py``).

The optimizer descends on ``-aggregate``: ``grads = -agg``, then optional
weight decay, optional torch-style momentum (``buf = m * buf + (1 -
dampening) * g``, the first step seeding ``buf = g`` undamped), then
``p + (-lr(count)) * u`` with the RLlib-style piecewise-linear schedule
over rounds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from blades_tpu_torch.ops.aggregators import Aggregator, get_aggregator
from blades_tpu_torch.utils.tree import FlatLayout


def lr_schedule(lr: float, schedule: Optional[Sequence[Tuple[int, float]]]
                ) -> Callable[[int], float]:
    """Piecewise-linear schedule ``[[round, lr], ...]`` as optax's
    ``piecewise_interpolate_schedule("linear", ...)`` computes it: values
    are products of ratios between consecutive points."""
    if not schedule:
        return lambda count: lr
    pts = sorted((int(r), float(v)) for r, v in schedule)
    if pts[0][0] != 0:
        pts.insert(0, (0, lr))
    init = pts[0][1]
    bounds, scales, prev = [], [], init
    for r, v in pts[1:]:
        bounds.append(r)
        scales.append(v / prev if prev != 0 else 0.0)
        prev = v
    if not bounds:
        return lambda count: init
    values = [init]
    for s in scales:
        values.append(values[-1] * s)
    edges = [0] + bounds

    def sched(count: int) -> float:
        for i in range(len(edges) - 1):
            if edges[i] <= count < edges[i + 1]:
                pct = (count - edges[i]) / (edges[i + 1] - edges[i])
                return pct * (values[i + 1] - values[i]) + values[i]
        return values[-1]

    return sched


@dataclasses.dataclass
class ServerState:
    """Global state threaded through rounds."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    agg_state: Any
    round: int


@dataclasses.dataclass(frozen=True)
class Server:
    """Static server config: optimizer + aggregator."""

    aggregator: Aggregator
    lr: float = 0.1
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    schedule: Optional[Tuple[Tuple[int, float], ...]] = None

    @staticmethod
    def from_config(aggregator="Mean", num_byzantine: Optional[int] = None,
                    lr: float = 0.1, momentum: float = 0.0,
                    dampening: float = 0.0, weight_decay: float = 0.0,
                    lr_schedule_points=None) -> "Server":
        agg = get_aggregator(aggregator, num_byzantine=num_byzantine)
        sched = (tuple(tuple(p) for p in lr_schedule_points)
                 if lr_schedule_points else None)
        return Server(agg, lr, momentum, dampening, weight_decay, sched)

    def init(self, params: Dict[str, torch.Tensor],
             num_clients: int) -> ServerState:
        opt = {"count": 0}
        if self.momentum:
            opt["buf"] = {k: torch.zeros_like(v) for k, v in params.items()}
            opt["step"] = 0
        device = next(iter(params.values())).device
        return ServerState(
            params=params, opt_state=opt,
            agg_state=self.aggregator.init(FlatLayout(params).d, num_clients,
                                           device=device),
            round=0)

    def step(self, state: ServerState, updates: torch.Tensor, *,
             generator=None, trusted_update=None, participation=None
             ) -> Tuple[ServerState, torch.Tensor]:
        """Aggregate the ``(n, d)`` update matrix and apply one optimizer
        step: ``(new_state, aggregate)``.  A trust-bootstrapped aggregator
        (FLTrust) takes ``trusted_update``, the server's root-data update,
        as the matrix's last row.  ``participation`` (the fault
        injector's ``(n,)`` mask) routes through the aggregator's
        ``masked_call``; the trusted row always participates."""
        if getattr(self.aggregator, "expects_trusted_row", False):
            if trusted_update is None:
                raise ValueError(
                    f"{type(self.aggregator).__name__} requires "
                    "trusted_update= (the server's root-data update); "
                    "without it the last client row would become the root "
                    "of trust")
            updates = torch.cat([updates, trusted_update[None, :].to(
                updates.dtype)])
        if participation is None:
            agg, agg_state = self.aggregator(updates, state.agg_state,
                                             generator=generator)
        else:
            part = participation.to(device=updates.device, dtype=torch.bool)
            if updates.shape[0] == part.shape[0] + 1:
                part = torch.cat([part, part.new_ones((1,))])
            agg, agg_state = self.aggregator.masked_call(
                updates, part, state.agg_state, generator=generator)
        return self.apply_aggregate(state, agg, agg_state), agg

    def step_buffered(self, state: ServerState, updates: torch.Tensor, *,
                      staleness, generator=None, trusted_update=None,
                      schedule: str = "polynomial", power: float = 0.5,
                      cutoff: int = 16
                      ) -> Tuple[ServerState, torch.Tensor]:
        """:meth:`step` for a buffered-async aggregation batch: the ``(K,
        d)`` rows are scaled by the mean-normalized staleness weight
        ``w(k) / mean(w)`` before the aggregator runs (``staleness`` the
        ``(K,)`` ints ``server_version - pulled version``), so Mean
        returns the staleness-weighted average.  Under ``constant`` the
        scale is exactly 1 and the rows pass unscaled: this is
        :meth:`step`, bit for bit.  No participation mask: every buffered
        row was delivered."""
        from blades_tpu_torch.arrivals.weights import (
            normalized_row_scale,
            staleness_weights,
        )

        if schedule != "constant":
            w = staleness_weights(schedule, staleness, power=power,
                                  cutoff=cutoff).to(updates.device)
            updates = updates * normalized_row_scale(w)[:, None]
        return self.step(state, updates, generator=generator,
                         trusted_update=trusted_update)

    def step_wire(self, state: ServerState, q: torch.Tensor, scales, *,
                  d: Optional[int] = None, generator=None,
                  trusted_update=None, d_chunk: int = 1 << 17,
                  recorder=None):
        """:meth:`step` on a packed wire payload (``agg_domain="wire"``):
        the aggregate of ``q`` (int8, ``d`` true columns) scaled row-wise
        by ``scales``, by
        :func:`~blades_tpu_torch.parallel.streamed_geometry.aggregate_wire`
        without the dense f32 matrix.  Returns ``(new_state, aggregate,
        sq)``, ``sq`` the decoded rows' squared norms.  FLTrust's trusted
        row is passed beside the payload (it never rides the wire)."""
        from blades_tpu_torch.parallel.streamed_geometry import aggregate_wire

        agg, agg_state, sq = aggregate_wire(
            self.aggregator, q, scales, state=state.agg_state,
            generator=generator, trusted=trusted_update, d_chunk=d_chunk,
            d=d, recorder=recorder)
        return self.apply_aggregate(state, agg, agg_state), agg, sq

    def apply_aggregate(self, state: ServerState, agg: torch.Tensor,
                        agg_state: Any = None) -> ServerState:
        """Descend on ``-agg`` (the optimizer half of a server step)."""
        grads = FlatLayout(state.params).unravel(-agg)
        opt = dict(state.opt_state)
        if self.weight_decay:
            grads = {k: g + self.weight_decay * state.params[k]
                     for k, g in grads.items()}
        if self.momentum:
            scale = 1.0 if opt["step"] == 0 else 1.0 - self.dampening
            buf = {k: self.momentum * opt["buf"][k] + scale * g
                   for k, g in grads.items()}
            opt["buf"], opt["step"] = buf, opt["step"] + 1
            grads = buf
        step_size = -lr_schedule(self.lr, self.schedule)(opt["count"])
        opt["count"] += 1
        params = {k: state.params[k] + step_size * g for k, g in grads.items()}
        return ServerState(
            params=params, opt_state=opt,
            agg_state=state.agg_state if agg_state is None else agg_state,
            round=state.round + 1)
