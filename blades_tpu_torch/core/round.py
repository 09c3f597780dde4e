"""The dense federated round (counterpart of ``blades_tpu/core/round.py``):

    sample batches -> local rounds of every client (vmapped client blocks)
    -> health check -> DP -> adversary forge -> robust aggregate -> server step

The ``(n, d)`` f32 update matrix is the round's one large buffer; clients
train into it in blocks of ``client_block`` (all at once when None), which
bounds the activations of a block and changes no result, since every
client's local round is independent.  Per-client optimizer state (client
momentum) lives in ``RoundState.client_opt`` and is carried across rounds.

Every draw of a round comes from ONE ``torch.Generator`` in a fixed order:
the batch indices, then per block the dropout masks and augmentation
draws, then the DP noise, the forge's, the trusted update's and the
aggregator's.  A caller that must reproduce another package's draws
passes them in (``step_prebatched(..., dropout_masks=, aug_draws=,
forge_noise=, dp_noise=)``).

Per-client DP (``dp_clip_threshold``, ``dp_noise_factor``) clips each row
to the threshold and adds Gaussian noise of std ``noise_factor *
threshold`` after the health check and before the forge, as the
reference's DP client does in honest training.

Client callbacks (``client_callbacks``, :mod:`blades_tpu_torch.core.callbacks`)
compose with the adversary's training hooks, callbacks first.

An update codec (``codec``, :mod:`blades_tpu_torch.comm.codecs`) runs on
the matrix as the updates leave the clients, before fault injection and
forging; the fault injector (``faults``,
:mod:`blades_tpu_torch.faults.injector`) as they arrive at the server,
before the health check.  Under ``agg_domain="wire"`` a quant codec's
payload stays packed: the forge reads the decoded matrix, its rows
re-enter the int8 wire, and the server aggregates the packed payload
(:meth:`~blades_tpu_torch.core.server.Server.step_wire`).  The codec's
rounding uniforms come from a generator of their own
(:func:`~blades_tpu_torch.comm.codecs.codec_generator`) and the faults'
from ``(fault seed, round)``, so neither moves the round's other draws;
``step_prebatched(..., codec_draws=, fault_realization=)`` replaces them.
Under a participation window the round runs over the sampled cohort's
rows (``client_opt`` / ``residual`` hold the cohort's, ``cohort`` its
ids; :meth:`init_windowed`), and ``stateless_clients`` starts every lane
from a fresh optimizer state.  With ``forensics`` the server aggregates
through the aggregator's ``diagnose`` (the same aggregate) and the
metrics gain the detection scalars (``byz_precision`` / ``byz_recall`` /
``byz_fpr`` / ``num_flagged``, :mod:`blades_tpu_torch.obs.forensics`),
``num_unhealthy`` and the per-lane bundle under ``lane_`` keys
(``benign_mask``, ``scores``, ``healthy``, ``update_norms``).  Under
client lane-packing (``packing``, :mod:`blades_tpu_torch.parallel.packed`)
P clients train in one lane of grouped kernels, and their updates come
back as the canonical ``(n, d)`` matrix before codecs, faults, DP,
forging and aggregation; ``RoundState`` stays unpacked.  The streamed
round is
:func:`blades_tpu_torch.parallel.streamed.streamed_step`, the
buffered-async cycle :mod:`blades_tpu_torch.arrivals.cycle`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from blades_tpu_torch.adversaries.base import forges, trains_corrupted
from blades_tpu_torch.adversaries.update_attacks import (
    ALIEAdversary,
    IPMAdversary,
)
from blades_tpu_torch.comm.codecs import codec_generator, dequantize
from blades_tpu_torch.core.callbacks import CallbackChain, overrides
from blades_tpu_torch.core.health import guard_server_state, sanitize_updates
from blades_tpu_torch.core.server import Server, ServerState
from blades_tpu_torch.core.task import Hooks, Task
from blades_tpu_torch.data.sampler import sample_client_batches
from blades_tpu_torch.device import resolve_device
from blades_tpu_torch.obs.forensics import detection_metrics
from blades_tpu_torch.ops.layout import ChunkInfo, clip_rows_to_norm
from blades_tpu_torch.utils.tree import FlatLayout

# Forges the wire round runs column chunk by column chunk on the decoded
# payload (deterministic and coordinate-wise); any other forge reads the
# whole decoded matrix at once.
_CHUNKED_WIRE_FORGERS = (ALIEAdversary, IPMAdversary)


@dataclasses.dataclass
class RoundState:
    """Training state: the server's state, the per-client optimizer state
    (``None`` under plain local SGD, which keeps none), the fault
    injector's ``(staleness, n, d)`` stale-update ring and the top-k
    codec's ``(n, d)`` error-feedback residual (each ``None`` when off, so
    the state of a codec- and fault-free run is unchanged).

    ``arrivals`` is the buffered-async ``(H+1, d)`` params-history ring
    (row ``j`` the global parameters of ``j`` versions ago;
    :mod:`blades_tpu_torch.arrivals`) and ``cohort`` the participation
    window's ``(window,)`` registered ids, whose rows ``client_opt`` and
    ``residual`` then hold (:mod:`blades_tpu_torch.state`); both ``None``
    when off."""

    server: ServerState
    client_opt: Any = None
    stale: Any = None
    residual: Any = None
    arrivals: Any = None
    cohort: Any = None


def round_generator(seed, device) -> torch.Generator:
    """The round's generator on ``device``, seeded with ``seed`` (an int),
    or ``seed`` itself when it already is a generator."""
    if isinstance(seed, torch.Generator):
        return seed
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def lane_forensics(diag, malicious, healthy, norms, participation=None
                   ) -> dict:
    """The forensics metrics of one aggregation: the detection scalars of
    ``diag["benign_mask"]`` against ``malicious`` (conditioned on
    ``participation``) and the per-lane bundle under ``lane_`` keys, f32:
    the kept mask, the scores, the health mask and the update norms of
    the rows the aggregator judged."""
    out = detection_metrics(diag["benign_mask"], malicious,
                            participation=participation)
    out["lane_benign_mask"] = diag["benign_mask"].float()
    out["lane_scores"] = diag["scores"].float()
    out["lane_healthy"] = healthy.float()
    out["lane_update_norms"] = norms.float()
    return out


def _rows(t, r0, r1):
    """Rows ``[r0, r1)`` of a tensor, or of each tensor of a tuple or
    dict."""
    if t is None:
        return None
    if isinstance(t, tuple):
        return tuple(v[r0:r1] for v in t)
    if isinstance(t, dict):
        return {k: v[r0:r1] for k, v in t.items()}
    return t[r0:r1]


@dataclasses.dataclass(frozen=True)
class FedRound:
    """Static round config binding task, server and (optional) adversary."""

    task: Task
    server: Server
    adversary: Any = None
    batch_size: int = 32
    num_batches_per_round: int = 1
    # True federation size; None means every data row is a client.
    num_clients: Optional[int] = None
    # Zero non-finite client rows before aggregation and keep the old
    # server state when the aggregate is non-finite; adds num_unhealthy
    # and round_ok to the metrics.
    health_check: bool = False
    # Server root dataset (x (m, H, W, C), y (m,)) for trust-bootstrapped
    # aggregators (FLTrust): each round the server runs its own local round
    # on it and the result is the trusted reference update.
    trusted_data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    # Clients per vmapped training block of the dense round (None = all).
    client_block: Optional[int] = None
    # Per-client DP: clip each update row to this L2 norm, then add
    # Gaussian noise of std dp_noise_factor * dp_clip_threshold.
    dp_clip_threshold: Optional[float] = None
    dp_noise_factor: Optional[float] = None
    # Client callback chain (ClientCallback instances), applied to every
    # lane before the adversary's hooks.
    client_callbacks: Tuple = ()
    # Fault injector (faults.FaultInjector) and update codec
    # (comm.CodecConfig); None keeps the round unchanged.
    faults: Any = None
    codec: Any = None
    # "f32" decodes the codec's payload before the defenses; "wire" keeps
    # a quant payload packed through them (Server.step_wire), whose
    # statistics walk column chunks of agg_d_chunk.
    agg_domain: str = "f32"
    agg_d_chunk: int = 1 << 17
    # Stateless clients (the participation window's window=0 case): every
    # round starts each lane from a fresh optimizer state instead of the
    # carried one.  False keeps the round unchanged.
    stateless_clients: bool = False
    # Defense forensics: aggregate through the aggregator's diagnose()
    # (the same aggregate) and add the detection metrics and the per-lane
    # bundle.  False keeps the round unchanged.
    forensics: bool = False
    # Client lane-packing (parallel.packed.ClientPacking): P clients per
    # lane of grouped kernels in the local round alone.  None keeps the
    # round unchanged.
    packing: Any = None

    def init(self, seed: int, num_clients: int, device=None) -> RoundState:
        """Fresh parameters from ``seed``, the server's initial state, the
        clients' optimizer state and (when configured) the stale ring and
        the residual on ``device`` (``None`` = the card)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = self.task.init_params(gen, dev)
        # The ring's and the residual's rows match the matrix after the
        # ghost lanes are sliced off.
        rows, d = self.num_clients or num_clients, FlatLayout(params).d
        return RoundState(
            server=self.server.init(params, num_clients),
            client_opt=self.task.init_client_opt_state(params, num_clients),
            stale=(None if self.faults is None
                   else self.faults.init_stale_buffer(rows, d, dev)),
            residual=(None if self.codec is None
                      else self.codec.init_residual(rows, d, dev)))

    def init_windowed(self, seed: int, window: int, device=None):
        """:meth:`init` for a participation-window run: the per-client
        stacks are not made (the store holds them).  Returns ``(state,
        template)``: ``state`` carries the server alone, its aggregator
        state sized to ``window`` (the matrix it aggregates every round),
        and ``template`` is one client's persistent row
        (:func:`~blades_tpu_torch.state.store.client_state_template`)."""
        from blades_tpu_torch.state.store import client_state_template

        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = self.task.init_params(gen, dev)
        return (RoundState(server=self.server.init(params, window)),
                client_state_template(self, params))

    def hooks(self) -> Optional[Hooks]:
        """The client callback chain composed with the adversary's
        training hooks (callbacks first, as the reference appends the
        attack callback last), or None when neither has any."""
        adv = self.adversary if trains_corrupted(self.adversary) else None
        if not self.client_callbacks:
            return None if adv is None else Hooks(adv.data_hook,
                                                  adv.grad_hook)
        chain = CallbackChain(tuple(self.client_callbacks))
        for hook in ("on_round_begin", "on_round_end"):
            if overrides(chain, hook):
                raise NotImplementedError(
                    f"a client callback's {hook} is not in the port yet "
                    "(no ported callback has one)")

        def data(x, y, malicious):
            x, y = chain.on_batch_begin(x, y, malicious)
            return (x, y) if adv is None else adv.data_hook(x, y, malicious)

        def grad(grads, malicious):
            grads = chain.on_backward_end(grads, malicious)
            return grads if adv is None else adv.grad_hook(grads, malicious)

        return Hooks(data, grad)

    def sample_round_batches(self, data_x, data_y, lengths, generator):
        """The batch-sampling half of :meth:`step`: every client's
        ``(num_batches, batch_size)`` batches, drawn from ``generator``."""
        return sample_client_batches(generator, data_x, data_y, lengths,
                                     self.batch_size,
                                     self.num_batches_per_round)

    def step(self, state: RoundState, data_x, data_y, lengths, malicious,
             seed) -> Tuple[RoundState, dict]:
        """One round over the stacked client shards ``data_x (n, shard,
        ...)``, ``data_y (n, shard)`` with true sizes ``lengths (n,)`` and
        the ``(n,)`` bool ``malicious`` mask; ``seed`` seeds the round's
        generator (or is one)."""
        dev = next(iter(state.server.params.values())).device
        gen = round_generator(seed, dev)
        bx, by = self.sample_round_batches(data_x, data_y, lengths, gen)
        return self.step_prebatched(state, bx, by, malicious, gen)

    def step_prebatched(self, state: RoundState, bx, by, malicious,
                        generator=None, *, dropout_masks=None,
                        aug_draws=None, forge_noise=None,
                        dp_noise=None, codec_draws=None,
                        fault_realization=None) -> Tuple[RoundState, dict]:
        """:meth:`step` with every client's batches already drawn: ``bx
        (n, num_batches, batch, ...)``, ``by (n, num_batches, batch)``.
        ``dropout_masks`` (one ``(n, num_batches, *site_shape)`` keep-mask
        per dropout site, as ``Task.draw_dropout_masks`` draws them) and
        ``aug_draws`` (``(offsets (n, nb, B, 2), flips (n, nb, B))``)
        replace those draws from ``generator``;
        ``forge_noise`` (the adversary's ``noise=``) and ``dp_noise``
        (``(k, d)`` standard normals, ``k`` the true federation size)
        replace the finish's; ``codec_draws`` (the quant codec's ``(k, d)``
        uniforms) and ``fault_realization`` (``(participation, straggled,
        corrupted)`` ``(k,)`` masks) replace the codec's and the fault
        injector's."""
        params = state.server.params
        dev = next(iter(params.values())).device
        if isinstance(generator, int):
            generator = round_generator(generator, dev)
        malicious = malicious.to(device=dev, dtype=torch.bool)
        updates, new_opt, losses = self.train_clients(
            state, bx, by, malicious, generator,
            dropout_masks=dropout_masks, aug_draws=aug_draws)
        k = self.num_clients
        if k is not None and k < bx.shape[0]:  # ghost (padding) lanes
            updates, losses, malicious = updates[:k], losses[:k], malicious[:k]
        residual = state.residual
        if self.codec is not None:
            cgen = (None if codec_draws is not None or generator is None
                    else codec_generator(generator))
            if self.agg_domain == "wire":
                q, scales, residual = self.codec.decode_deferred(
                    updates, residual, draws=codec_draws, generator=cgen)
                if scales is not None:
                    del updates  # the f32 matrix goes: only q lives on
                    return self._finish_wire(
                        state, q, scales, residual, new_opt, losses,
                        malicious, generator, forge_noise=forge_noise)
                updates = q  # the identity wire is the f32 matrix
            else:
                updates, residual = self.codec.encode_decode(
                    updates, residual, draws=codec_draws, generator=cgen,
                    out=updates)
        participation = straggled = None
        stale = state.stale
        if self.faults is not None:
            updates, stale, participation, straggled, _ = self.faults.inject(
                updates, stale, int(state.server.round),
                realization=fault_realization)
        return self.finish_dense(state, updates, new_opt, losses, malicious,
                                 generator, forge_noise=forge_noise,
                                 dp_noise=dp_noise,
                                 participation=participation,
                                 straggled=straggled, stale=stale,
                                 residual=residual)

    def train_clients(self, state: RoundState, bx, by, malicious,
                      generator=None, *, dropout_masks=None, aug_draws=None,
                      out=None):
        """The local rounds of every client, block by block: ``(updates
        (n, d) f32, client_opt, losses (n,))``, the updates written into
        ``out`` (an ``(n, d)`` view) when given.  Under ``packing`` each
        block trains in lanes of P clients
        (:func:`~blades_tpu_torch.parallel.packed.packed_local_round_batched`);
        its blocks are ``client_block`` rounded down to a multiple of P, so
        a ``client_block`` that P divides draws what the unpacked round
        draws."""
        params = state.server.params
        dev = next(iter(params.values())).device
        n = bx.shape[0]
        block = min(self.client_block or n, n)
        hooks = self.hooks()
        pack = None if self.packing is None else self.packing.pack
        if pack is not None:
            if hooks is not None:
                raise ValueError("client lane-packing runs hook-free local "
                                 "rounds only (resolve_client_packing gates "
                                 "training hooks out)")
            from blades_tpu_torch.parallel.packed import (
                packed_local_round_batched,
            )

            block = max(pack, block // pack * pack)
        opt = state.client_opt
        if self.stateless_clients:
            # Every lane starts from a fresh optimizer state.
            opt = self.task.init_client_opt_state(params, n)
        new_opt = (None if opt is None
                   else {k: torch.empty_like(v) for k, v in opt.items()})
        updates = out if out is not None else torch.empty(
            (n, FlatLayout(params).d), dtype=torch.float32, device=dev)
        losses = torch.empty((n,), dtype=torch.float32, device=dev)
        for r0 in range(0, n, block):
            r1 = min(n, r0 + block)
            kw = dict(opt_state=_rows(opt, r0, r1), generator=generator,
                      dropout_masks=_rows(dropout_masks, r0, r1),
                      aug_draws=_rows(aug_draws, r0, r1), out=updates[r0:r1])
            if pack is None:
                _, loss, opt_b = self.task.local_round_batched(
                    params, bx[r0:r1].to(dev), by[r0:r1].to(dev),
                    malicious=malicious[r0:r1], hooks=hooks, **kw)
            else:
                _, loss, opt_b = packed_local_round_batched(
                    self.task, pack, params, bx[r0:r1].to(dev),
                    by[r0:r1].to(dev), **kw)
            losses[r0:r1] = loss
            if new_opt is not None:
                for k, v in opt_b.items():
                    new_opt[k][r0:r1] = v
        return updates, new_opt, losses

    def finish_dense(self, state: RoundState, updates, client_opt, losses,
                     malicious, generator=None, *, forge_noise=None,
                     dp_noise=None, participation=None, straggled=None,
                     stale=None, residual=None, loss_benign=None
                     ) -> Tuple[RoundState, dict]:
        """The aggregation tail of :meth:`step_prebatched` over the
        assembled ``(n, d)`` update matrix: health check, DP, forge,
        trusted row, robust aggregate, server step and the metrics.
        ``participation`` / ``straggled`` are the fault injector's masks:
        the server aggregates the participants, and the loss and norm
        summaries cover them; ``stale`` and ``residual`` are carried into
        the new state.  ``loss_benign`` is the benign mask of ``losses``
        where the matrix's rows are not the lanes (the hierarchical
        round's representatives); ``~malicious`` by default."""
        updates, healthy = self.prepare_rows(
            updates, malicious, generator, participation=participation,
            forge_noise=forge_noise, dp_noise=dp_noise)
        trusted = self.compute_trusted_update(state.server.params, generator)
        diag = None
        if self.forensics:
            server, agg, diag = self.server.step_diag(
                state.server, updates, generator=generator,
                trusted_update=trusted, participation=participation)
        else:
            server, agg = self.server.step(state.server, updates,
                                           generator=generator,
                                           trusted_update=trusted,
                                           participation=participation)
        # Plain sums of squares: torch's CPU vector_norm loses ~1e-4
        # relative over millions of f32 terms.
        norms = (updates * updates).sum(1).sqrt()
        return self.close_round(
            state, server, agg, norms, losses, malicious,
            participation=participation, straggled=straggled,
            healthy=healthy, diag=diag, client_opt=client_opt, stale=stale,
            residual=residual, loss_benign=loss_benign)

    def prepare_rows(self, updates, malicious, generator=None, *,
                     participation=None, forge_noise=None, dp_noise=None):
        """The rows the aggregator reads: the health check (or, under
        forensics, its predicate), DP, then the forge.  Returns
        ``(updates, healthy)``, ``healthy`` None when neither asks for
        it."""
        healthy = None
        if self.health_check:
            updates, healthy = sanitize_updates(updates, participation)
        elif self.forensics:
            # The health check's predicate at the same point of the round,
            # without its repair: num_unhealthy means the same either way.
            healthy = torch.isfinite(updates).all(1)
            if participation is not None:
                healthy = healthy | ~participation
        updates = self.apply_dp(updates, dp_noise, generator)
        if forges(self.adversary):
            updates = self.adversary.on_updates_ready(
                updates, malicious, noise=forge_noise, generator=generator,
                aggregator=self.server.aggregator)
        return updates, healthy

    def close_round(self, state: RoundState, server, agg, norms, losses,
                    malicious, *, participation=None, straggled=None,
                    healthy=None, diag=None, client_opt=None, stale=None,
                    residual=None, loss_benign=None
                    ) -> Tuple[RoundState, dict]:
        """The new state and the metrics of a round whose server step
        gave ``server`` and ``agg``; ``norms`` are the aggregated rows'
        L2 norms.  Under the health check a non-finite aggregate keeps
        ``state``'s server."""
        benign = (~malicious if loss_benign is None else loss_benign).float()
        if participation is None:
            update_norm_mean = norms.mean()
        else:
            # A dropped lane's numbers never reached the server.
            p = participation.float()
            benign = benign * p
            update_norm_mean = (norms * p).sum() / p.sum().clamp(min=1.0)
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(min=1.0),
            "update_norm_mean": update_norm_mean,
            "agg_norm": (agg * agg).sum().sqrt(),
            "round": server.round,
        }
        if self.faults is not None:
            metrics["num_participating"] = participation.sum()
            metrics["num_dropped"] = (~participation).sum()
            metrics["num_straggled"] = straggled.sum()
            if self.faults.needs_stale_buffer:
                # A straggler delivered the update of `staleness` rounds
                # ago, every other participant a fresh one (age 0).
                age = straggled.float() * float(self.faults.staleness)
                metrics["staleness_mean"] = (
                    age.sum() / participation.float().sum().clamp(min=1.0))
                metrics["staleness_max"] = age.max()
        if self.health_check:
            ok = torch.isfinite(agg).all()
            server = guard_server_state(ok, server, state.server)
            metrics["num_unhealthy"] = (~healthy).sum()
            metrics["round_ok"] = ok
        if self.forensics:
            metrics.update(lane_forensics(diag, malicious, healthy, norms,
                                          participation))
            if not self.health_check:
                metrics["num_unhealthy"] = (~healthy).sum()
        return RoundState(server=server, client_opt=client_opt, stale=stale,
                          residual=residual,
                          cohort=getattr(state, "cohort", None)), metrics

    def _finish_wire(self, state: RoundState, q, scales, residual,
                     client_opt, losses, malicious, generator=None, *,
                     forge_noise=None) -> Tuple[RoundState, dict]:
        """The wire-domain tail of :meth:`step_prebatched` over the packed
        payload ``(q, scales)``: the forge reads the decoded matrix
        post-codec and its rows re-enter the int8 wire
        (``requantize_rows``: deterministic round-to-nearest), then the
        server aggregates the payload.  ALIE and IPM (and the identity
        forge of an adversary that forges nothing) run column chunk by
        column chunk, so only one decoded chunk and the forged rows are
        ever f32; any other forge reads the whole decoded matrix.  The
        metrics add the planner's ``hbm_passes`` and the ``dequant_rows``
        decoded (the forge's full read included)."""
        from blades_tpu_torch.parallel.streamed_geometry import PassRecorder

        n = q.shape[0]
        d = FlatLayout(state.server.params).d
        dequant_extra = 0
        if self.adversary is not None:
            adv, agg = self.adversary, self.server.aggregator
            idx = malicious.nonzero().flatten()
            if not forges(adv) or isinstance(adv, _CHUNKED_WIRE_FORGERS):
                c = min(self.agg_d_chunk, d)
                forged = torch.empty((idx.numel(), d), dtype=torch.float32,
                                     device=q.device)
                for i, c0 in enumerate(range(0, d, c)):
                    c1 = min(c0 + c, d)
                    dec = dequantize(q[:, c0:c1], scales)
                    if forges(adv):
                        dec = adv.on_updates_ready(
                            dec, malicious, generator=generator,
                            aggregator=agg, shard=ChunkInfo(
                                global_d=d, width=c1 - c0, start=c0,
                                index=i))
                    forged[:, c0:c1] = dec[idx]
                    del dec
            else:
                dec = adv.on_updates_ready(
                    dequantize(q, scales, d), malicious, noise=forge_noise,
                    generator=generator, aggregator=agg)
                forged = dec[idx]
                del dec
            self.codec.requantize_into(q, scales, idx, forged)
            del forged
            dequant_extra = n
        trusted = self.compute_trusted_update(state.server.params, generator)
        recorder = PassRecorder()
        server, agg, sq = self.server.step_wire(
            state.server, q, scales, d=d, generator=generator,
            trusted_update=trusted, d_chunk=self.agg_d_chunk,
            recorder=recorder)
        benign = (~malicious).float()
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(min=1.0),
            # The decoded rows' norms from the statistics bundle.
            "update_norm_mean": sq.clamp(min=0.0).sqrt().mean(),
            "agg_norm": (agg * agg).sum().sqrt(),
            "round": server.round,
            "hbm_passes": recorder.executed,
            "hbm_passes_unfused": recorder.unfused,
            "dequant_rows": recorder.dequant_rows + dequant_extra,
        }
        return RoundState(server=server, client_opt=client_opt,
                          stale=state.stale, residual=residual,
                          cohort=getattr(state, "cohort", None)), metrics

    def apply_dp(self, updates, noise=None, generator=None):
        """Per-client DP: clip each row of ``updates`` (n, d) to
        ``dp_clip_threshold``, then add ``dp_noise_factor *
        dp_clip_threshold`` times ``noise`` (``(n, d)`` standard normals,
        drawn from ``generator`` when None).  The identity without DP.
        Runs before the forge: malicious rows are overwritten after it."""
        if self.dp_clip_threshold is None:
            return updates
        clipped = clip_rows_to_norm(updates, self.dp_clip_threshold)
        if self.dp_noise_factor is not None:
            sigma = self.dp_noise_factor * self.dp_clip_threshold
            z = noise if noise is not None else torch.randn(
                updates.shape, generator=generator, device=updates.device)
            clipped = clipped + sigma * z.to(updates.device)
        return clipped

    def compute_trusted_update(self, global_params, generator):
        """The server's local round on its root data (FLTrust's trusted
        reference), its batches drawn from ``generator``; None when the
        aggregator takes none."""
        if self.trusted_data is None or not getattr(
                self.server.aggregator, "expects_trusted_row", False):
            return None
        tx, ty = self.trusted_data
        idx = torch.randint(
            0, tx.shape[0], (self.num_batches_per_round, self.batch_size),
            generator=generator, device=generator.device).to(tx.device)
        dev = next(iter(global_params.values())).device
        update, _ = self.task.local_round(global_params, tx[idx].to(dev),
                                          ty[idx].to(dev), generator=generator)
        return update

    def skip_trusted_update(self, generator, device) -> None:
        """Take from ``generator`` what :meth:`compute_trusted_update`
        takes, in its order (the batch indices, then its local round's
        dropout masks and augmentation draws), without the training: a
        rank that aggregates a later node replays an earlier node's
        draws."""
        if self.trusted_data is None or not getattr(
                self.server.aggregator, "expects_trusted_row", False):
            return
        shape = (1, self.num_batches_per_round, self.batch_size)
        torch.randint(0, self.trusted_data[0].shape[0], shape[1:],
                      generator=generator, device=generator.device)
        self.task.draw_dropout_masks(generator, shape, device)
        self.task.draw_augment(generator, shape, device)

    @torch.no_grad()
    def evaluate(self, state: RoundState, test_x, test_y, lengths,
                 eval_rows: int = 2048) -> dict:
        """Per-client evaluation of the global model over the padded test
        shards ``test_x (n, cap, ...)``, weighted by the true sizes
        ``lengths``; clients go through in chunks of about ``eval_rows``
        rows.  Returns f32 scalars ``test_loss``, ``test_acc``,
        ``test_acc_top3`` and ``num_samples``."""
        params = state.server.params
        dev = next(iter(params.values())).device
        n, cap = test_x.shape[:2]
        mask = (torch.arange(cap, device=lengths.device)[None, :]
                < lengths[:, None])
        chunk = max(1, eval_rows // max(cap, 1))
        parts = []
        for c0 in range(0, n, chunk):
            ev = self.task.evaluate(params, test_x[c0:c0 + chunk].to(dev),
                                    test_y[c0:c0 + chunk].to(dev),
                                    mask[c0:c0 + chunk].to(dev))
            parts.append(torch.stack([ev["ce_sum"], ev["top1_sum"],
                                      ev["top3_sum"], ev["count"]]))
        ce, top1, top3, count = torch.cat(parts, 1).sum(1)
        total = count.clamp(min=1.0)
        return {"test_loss": ce / total, "test_acc": top1 / total,
                "test_acc_top3": top3 / total, "num_samples": total}
