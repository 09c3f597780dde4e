"""The client-sharded dense round over the ranks of a process group
(counterpart of ``blades_tpu/parallel/sharded.py``).

Every rank trains its own block of client lanes, one all-gather of the
``(n_local, d)`` update rows (and of the losses) forms the ``(n, d)``
matrix on every rank, and the aggregation tail
(:meth:`~blades_tpu_torch.core.FedRound.finish_dense`: health check, DP,
forge, robust aggregate, server step) runs replicated, from the same
generator state on every rank.  Parameters are born replicated, and only
the update rows cross between ranks, once a round.

RNG discipline (:func:`sharded_step`): the round replays the draws of the
one-process dense round of the same seed.  Every rank takes the batch
uniforms of all ``n`` clients, then, client block by client block of
``client_block`` exactly as :meth:`FedRound.train_clients` takes them,
the dropout masks and the augmentation draws, and keeps its own lanes'
rows; its training then draws nothing, and its generator stands where the
dense round's stands before the finish.  So every lane trains on the
dense round's batches and masks, and the finish's draws (DP noise,
forges, the aggregator's) are the dense round's.  Where the ranks' client
blocks are the dense round's blocks (``n_local`` a multiple of
``client_block``), the round equals the dense round bit for bit; other
blocks train the same lanes in other vmapped groupings.

:func:`shard_map_step` is the other formulation of the JAX package: each
rank draws its lanes' batches and DP noise from a generator of its own,
seeded from the round seed and its ``clients`` coordinate.  It is
deterministic per seed and is not the dense stream.

The malicious mask is replicated and unpadded (``(n,)``) on every rank;
data and client state are this rank's lanes
(:func:`~blades_tpu_torch.parallel.mesh.shard_federation`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from blades_tpu_torch.core.round import FedRound, RoundState, round_generator
from blades_tpu_torch.data.sampler import gather_batches, indices_from_uniforms
from blades_tpu_torch.parallel.mesh import (
    CLIENTS_AXIS,
    LaneBlock,
    Mesh,
    all_gather_rows,
    all_reduce_sum,
)
from blades_tpu_torch.utils.seeds import seed_of


def _params_device(state: RoundState) -> torch.device:
    return next(iter(state.server.params.values())).device


def _rows(t, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a draw (a tensor, a tuple of them, or None),
    copied, so that the rest of its block is freed."""
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(v[lo:hi].clone() for v in t)
    return t[lo:hi].clone()


def _cat(parts, rows: int):
    """Concatenate kept draws (tensors, tuples of them, or None) and pad
    them with zero rows up to ``rows``: the ghost lanes."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], tuple):
        return tuple(_cat(list(p), rows) for p in zip(*parts))
    out = torch.cat(parts)
    return torch.cat([out, out.new_zeros((rows - out.shape[0],)
                                         + tuple(out.shape[1:]))])


def block_batches(fr: FedRound, lanes: LaneBlock, generator, data_x, data_y,
                  lengths):
    """The batches of the rank's ``lanes`` in the one-process dense round
    of ``lanes.n`` clients: the batch uniforms of every client drawn from
    ``generator`` (f64, as that round draws them), the rank's kept, and
    indexed into its shards ``data_x`` / ``data_y`` (``lengths`` its
    lanes')."""
    u = torch.rand((lanes.n, fr.num_batches_per_round, fr.batch_size),
                   generator=generator, device=generator.device,
                   dtype=torch.float64)
    idx = indices_from_uniforms(lanes.lanes(u), lengths)
    return gather_batches(data_x, data_y, idx.to(data_x.device))


def dense_block_draws(fr: FedRound, lanes: LaneBlock, nb: int, batch: int,
                      generator, device, *, masks=None, aug=None):
    """The rank's ``lanes`` of the dropout masks and augmentation draws the
    one-process dense round of ``lanes.n`` clients takes from
    ``generator`` while it trains, client block by client block of
    ``client_block`` (masks first, then augmentation, per block).  Every
    block is drawn, so the generator ends where the dense round's does;
    only the rank's rows of each are kept, so the draws held at once are
    one block's and the rank's, not the federation's.  ``masks`` / ``aug``
    handed in (the whole federation's) are not drawn, and their lanes are
    cut.  Lanes past ``n`` are zero rows.  ``(masks, aug)``, ``None`` where
    the model or task draws none."""
    n, start, n_local = lanes.n, lanes.start, lanes.n_local
    block = min(fr.client_block or n, n)
    end = start + n_local
    mask_parts, aug_parts = [], []
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        shape = (r1 - r0, nb, batch)
        lo, hi = min(max(start, r0), r1) - r0, min(max(end, r0), r1) - r0
        if masks is None:
            mask_parts.append(_rows(fr.task.draw_dropout_masks(
                generator, shape, device), lo, hi))
        if aug is None:
            aug_parts.append(_rows(fr.task.draw_augment(
                generator, shape, device), lo, hi))
    lo, hi = min(start, n), min(end, n)
    return (_cat(mask_parts if masks is None else [_rows(masks, lo, hi)],
                 n_local),
            _cat(aug_parts if aug is None else [_rows(aug, lo, hi)],
                 n_local))


class MeshRound:
    """What the sharded and the hierarchical rounds share: the lane block,
    the dense-stream draws cut to this rank's lanes, and the local
    training.  ``fr.num_clients`` is the true federation size."""

    _refused = (("packing", "client lane-packing"),
                ("codec", "an update codec"))

    def __init__(self, fr: FedRound, mesh: Mesh, n: Optional[int] = None):
        for attr, what in self._refused:
            if getattr(fr, attr, None) is not None:
                raise ValueError(
                    f"the {type(self).__name__} runs without {what}: its "
                    "per-lane stage has no sharded formulation here")
        if fr.agg_domain != "f32":
            raise ValueError("the mesh rounds aggregate in the f32 domain")
        self.fr, self.mesh = fr, mesh
        self.n = int(n if n is not None else fr.num_clients)
        if fr.num_clients is not None and int(fr.num_clients) != self.n:
            raise ValueError(f"num_clients={fr.num_clients} but the round "
                             f"was built for {self.n}")
        self.block = LaneBlock.of(mesh, self.n)
        self.c, self.start = self.block.c, self.block.start
        self.n_local, self.n_pad = self.block.n_local, self.block.n_pad

    def lanes(self, t):
        return self.block.lanes(t)

    def _check_local(self, rows: int, what: str) -> None:
        if rows != self.n_local:
            raise ValueError(
                f"{what} holds {rows} lanes; rank {self.mesh.rank} owns "
                f"{self.n_local} of the {self.n_pad} padded lanes")

    def __call__(self, state: RoundState, data_x, data_y, lengths, malicious,
                 seed):
        """One round over this rank's shards ``data_x (n_local, shard,
        ...)``, ``data_y``, ``lengths (n_local,)`` and the replicated
        ``(n,)`` mask, the dense round's draws replayed from ``seed``."""
        self._check_local(data_x.shape[0], "data_x")
        fr = self.fr
        dev = _params_device(state)
        gen = round_generator(seed, dev)
        bx, by = block_batches(fr, self.block, gen, data_x, data_y, lengths)
        masks, aug = dense_block_draws(fr, self.block, bx.shape[1],
                                       bx.shape[2], gen, dev)
        return self.round(state, bx, by, malicious, gen, masks, aug)

    def prebatched(self, state: RoundState, bx, by, malicious,
                   generator=None, *, dropout_masks=None, aug_draws=None,
                   forge_noise=None, dp_noise=None):
        """The round with every client's batches drawn: ``bx (n, nb, B,
        ...)`` / ``by`` and ``dropout_masks`` / ``aug_draws`` (as
        :meth:`FedRound.step_prebatched` takes them) cover the whole
        federation, and this rank takes its lanes; ``forge_noise`` and
        ``dp_noise`` are replicated.  Draws not handed in come from
        ``generator`` in the dense round's order."""
        fr = self.fr
        dev = _params_device(state)
        if isinstance(generator, int):
            generator = round_generator(generator, dev)
        masks, aug = dense_block_draws(
            fr, self.block, bx.shape[1], bx.shape[2], generator, dev,
            masks=dropout_masks, aug=aug_draws)
        return self.round(state, self.lanes(bx[:self.n]),
                          self.lanes(by[:self.n]), malicious, generator,
                          masks, aug, forge_noise=forge_noise,
                          dp_noise=dp_noise)

    def train_local(self, state: RoundState, bx, by, malicious, masks, aug):
        """This rank's lanes' local rounds: ``(updates (n_local, d),
        client_opt, losses (n_local,))``; nothing is drawn."""
        dev = _params_device(state)
        mal = self.lanes(malicious.to(device=dev, dtype=torch.bool))
        return self.fr.train_clients(state, bx, by, mal, None,
                                     dropout_masks=masks, aug_draws=aug)


class ShardedStep(MeshRound):
    """The client-sharded dense round (see the module docstring)."""

    _refused = MeshRound._refused + (("faults", "fault injection"),)

    def round(self, state: RoundState, bx, by, malicious, generator, masks,
              aug, *, forge_noise=None, dp_noise=None):
        fr, n = self.fr, self.n
        dev = _params_device(state)
        malicious = malicious.to(device=dev, dtype=torch.bool)
        upd, opt, losses = self.train_local(state, bx, by, malicious, masks,
                                            aug)
        # The round's collectives: the update rows, then the losses.
        updates = all_gather_rows(self.mesh, upd)[:n]
        losses = all_gather_rows(self.mesh, losses)[:n]
        return fr.finish_dense(state, updates, opt, losses, malicious,
                               generator, forge_noise=forge_noise,
                               dp_noise=dp_noise)


def sharded_step(fr: FedRound, mesh: Mesh) -> Callable:
    """The client-sharded dense round of ``fr`` on ``mesh``:
    ``step(state, x, y, lengths, malicious, seed) -> (state, metrics)``
    over this rank's shards, and ``step.prebatched(...)`` (see
    :class:`MeshRound`)."""
    return ShardedStep(fr, mesh)


def sharded_multi_step(fr: FedRound, mesh: Mesh, num_rounds: int
                       ) -> Callable:
    """``num_rounds`` sharded rounds in one dispatch (:func:`multi_dispatch`
    of :class:`ShardedStep`)."""
    return multi_dispatch(ShardedStep(fr, mesh), num_rounds)


def multi_dispatch(step: MeshRound, num_rounds: int) -> Callable:
    """``num_rounds`` rounds of ``step`` in one dispatch: ``multi(state, x,
    y, lengths, malicious, seeds) -> (state, [metrics per round])``, round
    ``i`` from ``seeds[i]``; ``multi.step`` is ``step``."""

    def multi(state, data_x, data_y, lengths, malicious, seeds):
        if len(seeds) != num_rounds:
            raise ValueError(f"{len(seeds)} seeds for {num_rounds} rounds")
        out: List[dict] = []
        for seed in seeds:
            state, m = step(state, data_x, data_y, lengths, malicious, seed)
            out.append(m)
        return state, out

    multi.step = step
    return multi


def sharded_evaluate(fr: FedRound, mesh: Mesh, eval_rows: int = 2048
                     ) -> Callable:
    """Evaluation over the ranks' test shards: each rank sums the
    cross-entropy, top-1, top-3 and sample counts of its lanes (ghost
    lanes count nothing), the sums are added over the ``clients`` axis,
    and every rank returns :meth:`FedRound.evaluate`'s ratios."""

    @torch.no_grad()
    def evaluate(state: RoundState, test_x, test_y, lengths) -> dict:
        dev = _params_device(state)
        n, cap = test_x.shape[:2]
        mask = (torch.arange(cap, device=lengths.device)[None, :]
                < lengths[:, None])
        chunk = max(1, eval_rows // max(cap, 1))
        sums = torch.zeros((4,), dtype=torch.float64, device=dev)
        for c0 in range(0, n, chunk):
            ev = fr.task.evaluate(state.server.params,
                                  test_x[c0:c0 + chunk].to(dev),
                                  test_y[c0:c0 + chunk].to(dev),
                                  mask[c0:c0 + chunk].to(dev))
            sums += torch.stack([ev["ce_sum"].sum(), ev["top1_sum"].sum(),
                                 ev["top3_sum"].sum(),
                                 ev["count"].sum()]).double()
        ce, top1, top3, count = all_reduce_sum(mesh, sums, CLIENTS_AXIS)
        total = count.clamp(min=1.0)
        return {"test_loss": (ce / total).float(),
                "test_acc": (top1 / total).float(),
                "test_acc_top3": (top3 / total).float(),
                "num_samples": total.float()}

    return evaluate


def shard_map_step(fr: FedRound, mesh: Mesh) -> Callable:
    """The per-rank-draw formulation: ``step(state, x, y, lengths,
    malicious, seed)`` (``seed`` an int).  Each rank draws its lanes'
    batches, training draws and DP noise from a generator seeded with
    ``(seed, clients coordinate)``; the gather and the replicated tail
    (forge, aggregate, server step) draw from the round generator of
    ``seed``, as :func:`sharded_step`'s do."""
    guard = ShardedStep(fr, mesh)
    tail = dataclasses.replace(fr, dp_clip_threshold=None,
                               dp_noise_factor=None)

    def step(state: RoundState, data_x, data_y, lengths, malicious, seed):
        guard._check_local(data_x.shape[0], "data_x")
        dev = _params_device(state)
        gen = round_generator(int(seed), dev)
        local = torch.Generator(device=dev)
        local.manual_seed(seed_of(int(seed), mesh.coords[0]))
        malicious = malicious.to(device=dev, dtype=torch.bool)
        bx, by = fr.sample_round_batches(data_x, data_y, lengths, local)
        upd, opt, losses = fr.train_clients(state, bx, by,
                                            guard.lanes(malicious), local)
        upd = fr.apply_dp(upd, generator=local)
        n = guard.n
        updates = all_gather_rows(mesh, upd)[:n]
        losses = all_gather_rows(mesh, losses)[:n]
        return tail.finish_dense(state, updates, opt, losses, malicious, gen)

    return step
