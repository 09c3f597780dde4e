"""The hierarchical round: per-rank pre-aggregation, then one gather
(counterpart of ``blades_tpu/parallel/hier.py``).

On a ``(clients, d)`` mesh (:func:`blades_tpu_torch.parallel.mesh.make_mesh`
with ``mesh_shape=(c, dd)``) every rank trains its ``clients`` block of
lanes, reduces its ``(n_local, d)`` update block to ``m`` representatives
(:mod:`blades_tpu_torch.ops.preagg`: bucketing or nearest-neighbor
mixing), and the robust aggregator runs replicated over the gathered
``(c * m, d)`` matrix.  The gather runs over the ``clients`` ranks, in two
phases when ``dd > 1``: each rank gathers its column slice of the
representatives over ``clients``, then the slices over ``d``.

RNG discipline: the round replays the one-process dense round's draws
(:class:`~blades_tpu_torch.parallel.sharded.MeshRound`), so every real lane
trains as the dense round trains it, and at ``bucket_size=1`` (the identity
pre-aggregation of both flavors) the round is the dense round: bit for bit
where the ranks' client blocks are the dense round's.

Wire accounting: every collective the round issues is recorded on the
:class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder` with the
comm model's ``(label, kind, payload)`` vocabulary (the ring factors
applied per rank); ``recorder.ici_events`` holds the last round's events,
and the metrics carry ``ici_bytes`` and ``preagg_kept``.  The events
reconcile with :func:`~blades_tpu_torch.parallel.comm_model.hier_round_volumes`
in both directions.
"""

from __future__ import annotations

from typing import Optional

import torch

from blades_tpu_torch.core.round import FedRound, RoundState
from blades_tpu_torch.ops.preagg import (
    PREAGG_FLAVORS,
    bucket_count,
    bucket_representatives,
    nnm_representatives,
)
from blades_tpu_torch.parallel.mesh import (
    CLIENTS_AXIS,
    D_AXIS,
    Mesh,
    all_gather_rows,
    pad_to_multiple,
)
from blades_tpu_torch.parallel.sharded import MeshRound, _params_device
from blades_tpu_torch.parallel.streamed_geometry import PassRecorder


def _real_lanes(n_real: int, n_local: int, c: int):
    """Real (non-ghost) lanes per rank: rank ``i`` owns lanes ``[i *
    n_local, (i + 1) * n_local)`` and the ghosts are the global tail, so
    it holds ``clip(n_real - i * n_local, 0, n_local)``."""
    return [min(max(int(n_real) - i * int(n_local), 0), int(n_local))
            for i in range(int(c))]


def hier_kept_counts(n_real: int, n_local: int, c: int, bucket_size: int):
    """Per-rank real-representative counts under bucketing: a rank with
    ``r_i`` real lanes emits ``ceil(r_i / b)`` real representatives; the
    gathered matrix's real rows are a prefix of their sum."""
    b = int(bucket_size)
    return [-(-r // b) for r in _real_lanes(n_real, n_local, c)]


def _check_supported(preagg: str, bucket_size: int) -> None:
    """The round's own arguments; the FedRound's attributes are refused by
    :class:`~blades_tpu_torch.parallel.sharded.MeshRound`, and the
    config's pairs by ``FedavgConfig.validate``."""
    if preagg not in PREAGG_FLAVORS:
        raise ValueError(f"unknown preagg flavor {preagg!r}; use one of "
                         f"{PREAGG_FLAVORS}")
    if bucket_size < 1:
        raise ValueError(f"bucket_size must be >= 1, got {bucket_size}")


class HierStep(MeshRound):
    """The hierarchical round (see the module docstring)."""

    def __init__(self, fr: FedRound, mesh: Mesh, preagg: str = "bucket",
                 bucket_size: int = 1,
                 recorder: Optional[PassRecorder] = None):
        _check_supported(preagg, bucket_size)
        super().__init__(fr, mesh)
        self.preagg, self.b = preagg, int(bucket_size)
        self.recorder = recorder if recorder is not None else PassRecorder()
        c, n_local, n_real, b = self.c, self.n_local, self.n, self.b
        if n_real > self.n_pad or n_real < 1:
            raise ValueError(f"num_clients={n_real} incompatible with {c} "
                             f"chips × {n_local} lanes")
        if preagg == "nnm":
            self.m, self.kept = n_local, n_real
            rmin = min(r for r in _real_lanes(n_real, n_local, c) if r > 0)
            if rmin < b:
                raise ValueError(
                    f"nnm bucket_size={b} exceeds the smallest chip-local "
                    f"real-lane count ({rmin}) — shrink bucket_size or "
                    f"rebalance mesh_shape")
        else:
            self.m = bucket_count(n_local, b)
            self.kept = sum(hier_kept_counts(n_real, n_local, c, b))
        if fr.faults is not None and self.kept != n_real:
            raise ValueError(
                "hier × faults needs an identity-height pre-aggregation "
                f"(kept={self.kept} != num_clients={n_real}) — set "
                "bucket_size=1 or disable the fault processes")

    def _gather(self, reps: torch.Tensor) -> torch.Tensor:
        """The ``(c * m, d)`` representatives of every ``clients`` rank,
        recorded on the recorder."""
        rec, mesh, c, m = self.recorder, self.mesh, self.c, self.m
        d, dd = reps.shape[1], mesh.dd
        if dd == 1:
            return all_gather_rows(mesh, reps, CLIENTS_AXIS, recorder=rec,
                                   label="reps_gather_clients")
        d_pad = -(-d // dd) * dd
        col = d_pad // dd
        di = mesh.coords[1]
        reps_p = torch.nn.functional.pad(reps, (0, d_pad - d))
        g1 = all_gather_rows(mesh, reps_p[:, di * col:(di + 1) * col]
                             .contiguous(), CLIENTS_AXIS, recorder=rec,
                             label="reps_gather_clients")
        # (dd * c * m, col)
        g2 = all_gather_rows(mesh, g1, D_AXIS, recorder=rec,
                             label="reps_gather_d")
        return g2.view(dd, c * m, col).transpose(0, 1).reshape(
            c * m, d_pad)[:, :d]

    def round(self, state: RoundState, bx, by, malicious, generator, masks,
              aug, *, forge_noise=None, dp_noise=None):
        fr, rec = self.fr, self.recorder
        c, n_local, n_real, m, b = self.c, self.n_local, self.n, self.m, self.b
        rec.ici_events.clear()
        rec.ici_bytes = 0
        dev = _params_device(state)
        malicious = malicious.to(device=dev, dtype=torch.bool)
        upd, opt, losses_local = self.train_local(state, bx, by, malicious,
                                                  masks, aug)
        real = (self.start + torch.arange(n_local, device=dev)) < n_real
        if self.preagg == "nnm":
            reps = nnm_representatives(upd, real, b)
        else:
            reps = bucket_representatives(upd, real, b)
        del upd
        updates = self._gather(reps)[:self.kept]
        losses = all_gather_rows(self.mesh, losses_local, CLIENTS_AXIS,
                                 recorder=rec, label="losses_gather")[:n_real]
        # The representatives' malicious mask: bucketing flags a
        # representative when any member is malicious (b = 1: the lanes'
        # own mask); NNM keeps the height, so each keeps its lane's flag.
        if self.preagg == "nnm":
            rep_mal = malicious
        else:
            per_rank = pad_to_multiple(malicious, c).view(c, n_local)
            per_rank = torch.cat([per_rank, per_rank.new_zeros(
                (c, m * b - n_local))], 1)
            rep_mal = per_rank.view(c, m, b).any(-1).reshape(c * m)
            rep_mal = rep_mal[:self.kept]
        participation = straggled = None
        stale = state.stale
        if fr.faults is not None:
            updates, stale, participation, straggled, _ = fr.faults.inject(
                updates, stale, int(state.server.round))
        new_state, metrics = fr.finish_dense(
            state, updates, opt, losses, rep_mal, generator,
            forge_noise=forge_noise, dp_noise=dp_noise,
            participation=participation, straggled=straggled, stale=stale,
            loss_benign=~malicious)
        metrics["ici_bytes"] = torch.tensor(rec.ici_bytes, dtype=torch.int64)
        metrics["preagg_kept"] = torch.tensor(self.kept, dtype=torch.int64)
        return new_state, metrics


def hier_step(fr: FedRound, mesh: Mesh, preagg: str = "bucket",
              bucket_size: int = 1,
              recorder: Optional[PassRecorder] = None) -> tuple:
    """The hierarchical round of ``fr`` on ``mesh``: ``(step, recorder)``,
    ``step(state, x, y, lengths, malicious, seed) -> (state, metrics)``
    over this rank's shards and the replicated, unpadded ``(n,)`` mask
    (``step.prebatched(...)`` as
    :meth:`~blades_tpu_torch.parallel.sharded.MeshRound.prebatched`)."""
    step = HierStep(fr, mesh, preagg, bucket_size, recorder)
    return step, step.recorder
