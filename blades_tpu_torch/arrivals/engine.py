"""AsyncEngine: the host driver of buffered-async execution (counterpart of
``blades_tpu/arrivals/engine.py``).

The engine owns the virtual tick clock, the version vector (which global
model version each client last pulled), the bounded arrival buffer and
the fault injector's per-tick dropout / corruption over arrivals: plain
host ints and short lists, checkpointed by :meth:`host_state` and
restored bit for bit.  One :meth:`run_cycle` is one server round:

1. advance the clock, realizing arrivals (pure in ``(arrival seed,
   tick)``) and dropout / corruption (pure in ``(fault seed, tick)``) a
   window of ticks at a time; a dropped arrival never reaches the buffer,
   a corrupted one rides its event; every arriving client pulls the
   current version;
2. once the buffer holds ``agg_every`` unique-client events, pop them and
   run one cycle (:mod:`.cycle`);
3. keep the ingest digest in :attr:`last_info`.

``arrival_realization`` replaces the port's own draws: a callable
``tick0 -> (arrivals, dropped, corrupted)``, each ``(W, n)`` bool for
ticks ``tick0 .. tick0 + W - 1`` (W = 64), how the tests hand in the JAX
package's windows.  With a state store (``state_store``) the event
cohort's optimizer rows are gathered from it per cycle and scattered
back, and with a data prefetcher (``data_store``) so are the cohort's
shards.  No realization reads a wall clock; only the staging telemetry
(``state_stage_ms``) does.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from blades_tpu_torch.arrivals.buffer import ArrivalEvent, UpdateBuffer
from blades_tpu_torch.arrivals.cycle import build_cycle, init_history
from blades_tpu_torch.arrivals.process import ArrivalProcess
from blades_tpu_torch.arrivals.weights import (
    STALENESS_SCHEDULES,
    staleness_weights,
)
from blades_tpu_torch.obs.trace import now

#: Ticks realized per window while filling the buffer.
_REALIZE_WINDOW = 64


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """Static buffered-async config (``FedavgConfig.async_config``).

    Attributes:
        seed: arrival-process seed (the trial seed by default).
        rate / rate_schedule / slow_fraction / slow_factor: the
            :class:`~blades_tpu_torch.arrivals.process.ArrivalProcess`
            knobs.
        agg_every: K, the server aggregates every K buffered arrivals.
        buffer_capacity: bounded-buffer capacity B >= K (0 = ``2*K``).
        staleness_cap: H, the params-history depth; an update older than
            H versions is computed against the oldest retained params.
        weight_schedule / weight_power / weight_cutoff: the staleness
            discount (:mod:`blades_tpu_torch.arrivals.weights`).
        max_ticks_per_cycle: a cycle that cannot collect K unique-client
            arrivals within this many ticks raises.
        ticks_per_sec: wall-clock calibration of the virtual tick (0 =
            uncalibrated); a sizing aid that never enters a realization.
    """

    seed: int = 0
    rate: float = 0.25
    rate_schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    slow_fraction: float = 0.0
    slow_factor: float = 0.25
    agg_every: int = 8
    buffer_capacity: int = 0
    staleness_cap: int = 8
    weight_schedule: str = "polynomial"
    weight_power: float = 0.5
    weight_cutoff: int = 16
    max_ticks_per_cycle: int = 100_000
    ticks_per_sec: float = 0.0

    def __post_init__(self):
        if self.agg_every < 1:
            raise ValueError(f"agg_every must be >= 1, got {self.agg_every}")
        if self.ticks_per_sec < 0:
            raise ValueError(
                f"ticks_per_sec must be >= 0 (0 = uncalibrated), got "
                f"{self.ticks_per_sec}")
        if self.buffer_capacity and self.buffer_capacity < self.agg_every:
            raise ValueError(
                f"buffer_capacity={self.buffer_capacity} < agg_every="
                f"{self.agg_every}: the buffer could never hold one "
                "aggregation batch")
        if self.staleness_cap < 1:
            raise ValueError(
                f"staleness_cap must be >= 1, got {self.staleness_cap}")
        if self.weight_schedule not in STALENESS_SCHEDULES:
            raise ValueError(
                f"weight_schedule must be one of {STALENESS_SCHEDULES}, "
                f"got {self.weight_schedule!r}")
        if self.weight_power <= 0:
            raise ValueError(
                f"weight_power must be > 0, got {self.weight_power}")
        if self.weight_cutoff < 0:
            raise ValueError(
                f"weight_cutoff must be >= 0, got {self.weight_cutoff}")
        if self.max_ticks_per_cycle < 1:
            raise ValueError("max_ticks_per_cycle must be >= 1")
        self.process()  # the process knobs' range checks

    @property
    def effective_capacity(self) -> int:
        return self.buffer_capacity or 2 * self.agg_every

    def process(self) -> ArrivalProcess:
        return ArrivalProcess(
            seed=self.seed, rate=self.rate, rate_schedule=self.rate_schedule,
            slow_fraction=self.slow_fraction, slow_factor=self.slow_factor)


def expected_arrivals_per_sec(spec: AsyncSpec, num_clients: int) -> float:
    """Expected wall-clock arrival supply of a calibrated spec
    (``ticks_per_sec > 0``), at the schedule-free base rate."""
    if spec.ticks_per_sec <= 0:
        raise ValueError(
            "expected_arrivals_per_sec needs a calibrated spec: set "
            "ticks_per_sec > 0")
    n_slow = int(spec.slow_fraction * num_clients)
    n_fast = num_clients - n_slow
    per_tick = n_fast * spec.rate + n_slow * spec.rate * spec.slow_factor
    return float(per_tick * spec.ticks_per_sec)


def size_for_target(spec: AsyncSpec, num_clients: int,
                    target_updates_per_sec: float, *,
                    agg_interval_sec: float = 1.0) -> AsyncSpec:
    """``agg_every`` / ``buffer_capacity`` sized so one cycle ingests about
    ``agg_interval_sec`` of the targeted traffic (with a ``2*K`` buffer);
    raises when the target exceeds the spec's expected supply.  The
    realization knobs are untouched, so the traffic replays."""
    supply = expected_arrivals_per_sec(spec, num_clients)
    if target_updates_per_sec <= 0:
        raise ValueError(
            f"target_updates_per_sec must be > 0, got "
            f"{target_updates_per_sec}")
    if agg_interval_sec <= 0:
        raise ValueError(
            f"agg_interval_sec must be > 0, got {agg_interval_sec}")
    if target_updates_per_sec > supply:
        raise ValueError(
            f"target_updates_per_sec={target_updates_per_sec:g} exceeds "
            f"the spec's expected arrival supply {supply:g}/s "
            f"(rate={spec.rate}, ticks_per_sec={spec.ticks_per_sec}, "
            f"{num_clients} clients) -- raise the rate/fleet or lower "
            "the target")
    agg_every = int(np.clip(
        round(target_updates_per_sec * agg_interval_sec), 1, num_clients))
    return dataclasses.replace(
        spec, agg_every=agg_every, buffer_capacity=2 * agg_every)


class AsyncEngine:
    """Host driver pairing an :class:`AsyncSpec` with a ``FedRound``."""

    def __init__(self, fed_round, spec: AsyncSpec, num_clients: int, *,
                 train_seed: int, fault_injector=None, state_store=None,
                 data_store=None, client_block: int = 50,
                 arrival_realization: Optional[Callable] = None):
        if spec.agg_every > num_clients:
            raise ValueError(
                f"agg_every={spec.agg_every} > num_clients={num_clients}: "
                "a cycle aggregates at most one event per client")
        if fault_injector is not None and fault_injector.num_stragglers:
            raise ValueError(
                "the async arrival model subsumes the straggler fault "
                "process (staleness is first-class); configure "
                "num_stragglers=0 under execution='async'")
        from blades_tpu_torch.state.store import StoreStats

        self.fed_round = fed_round
        self.spec = spec
        self.num_clients = int(num_clients)
        self.process = spec.process()
        self.faults = fault_injector
        self.state_store = state_store
        self.data_store = data_store
        self.store_stats = StoreStats()
        self.train_seed = int(train_seed)
        self.client_block = int(client_block)
        self._realization = arrival_realization
        self._corrupt_mode = (fault_injector.corrupt_mode
                              if fault_injector is not None
                              and fault_injector.corrupt_rate > 0.0 else None)
        # Live actuator values: the spec's statics until a setter moves
        # them; host_state carries them.
        self.agg_every = int(spec.agg_every)
        self.weight_cutoff = int(spec.weight_cutoff)
        self.quarantine: frozenset = frozenset()
        self.arrivals_quarantined = 0
        self._build_cycle()
        self.tick = 0                      # next virtual tick to realize
        self.version = 0                   # global model version
        self.client_versions = np.zeros(self.num_clients, np.int64)
        self.buffer = UpdateBuffer(spec.effective_capacity)
        self.arrivals_total = 0
        self.arrivals_dropped = 0          # fault dropout (never buffered)
        self.buffer_overflow = 0           # full-buffer drops
        self.last_info: Dict[str, Any] = {}
        self.last_clients: Any = None      # (K,) registered ids
        self.last_staleness: Any = None    # (K,) staleness

    def _build_cycle(self) -> None:
        self._cycle = build_cycle(
            self.fed_round, staleness_cap=self.spec.staleness_cap,
            weight_schedule=self.spec.weight_schedule,
            weight_power=self.spec.weight_power,
            weight_cutoff=self.weight_cutoff,
            corrupt_mode=self._corrupt_mode,
            windowed_state=self.state_store is not None,
            client_block=self.client_block)

    # -- live actuators (plain setters; every value rides host_state) --------

    def set_agg_every(self, k: int) -> None:
        """The aggregation cadence K."""
        k = int(k)
        if not (1 <= k <= self.num_clients):
            raise ValueError(
                f"agg_every must be in [1, {self.num_clients}], got {k}")
        if self.buffer.capacity < k:
            raise ValueError(
                f"agg_every={k} exceeds buffer capacity "
                f"{self.buffer.capacity}")
        self.agg_every = k

    def set_buffer_capacity(self, capacity: int) -> None:
        """Resize the arrival buffer, carrying the pending events."""
        capacity = int(capacity)
        if capacity < max(self.agg_every, self.buffer.fill):
            raise ValueError(
                f"buffer capacity {capacity} < max(agg_every="
                f"{self.agg_every}, pending fill {self.buffer.fill})")
        pending = self.buffer.state()
        self.buffer = UpdateBuffer(capacity)
        self.buffer.restore(pending)

    def set_weight_cutoff(self, cutoff: int) -> None:
        """The staleness weight cutoff."""
        cutoff = int(cutoff)
        if cutoff < 0:
            raise ValueError(f"weight_cutoff must be >= 0, got {cutoff}")
        if cutoff != self.weight_cutoff:
            self.weight_cutoff = cutoff
            self._build_cycle()

    def set_quarantine(self, clients) -> None:
        """Discard a client set's arrivals at ingest (counted in
        ``arrivals_quarantined``; the client still pulls)."""
        q = frozenset(int(c) for c in clients)
        bad = sorted(c for c in q if not (0 <= c < self.num_clients))
        if bad:
            raise ValueError(f"quarantine ids out of range: {bad}")
        if self.num_clients - len(q) < self.agg_every:
            raise ValueError(
                f"quarantining {len(q)}/{self.num_clients} clients "
                f"leaves fewer than agg_every={self.agg_every} eligible "
                "-- the cycle could never fill")
        self.quarantine = q

    # -- realization ---------------------------------------------------------

    def _realize_window(self, tick0: int):
        """``(W, n)`` bool arrivals / dropped / corrupted for ticks
        ``tick0 .. tick0 + W - 1``, each pure in its own ``(seed, tick)``
        stream."""
        if self._realization is not None:
            return tuple(np.asarray(a, bool)
                         for a in self._realization(tick0))
        n, w = self.num_clients, _REALIZE_WINDOW
        arrivals = self.process.arrivals_window(tick0, w, n).numpy()
        if self.faults is None:
            flat = np.zeros((w, n), bool)
            return arrivals, flat, flat
        drops, corrupts = zip(*(self.faults.realize_tick(n, tick0 + i)
                                for i in range(w)))
        return (arrivals, torch.stack(drops).numpy(),
                torch.stack(corrupts).numpy())

    def advance_until_ready(self) -> None:
        """Advance the clock until the buffer holds ``agg_every``
        unique-client events."""
        k = self.agg_every
        start = self.tick
        while self.buffer.unique_clients() < k:
            if self.tick - start > self.spec.max_ticks_per_cycle:
                raise RuntimeError(
                    f"arrival starvation: {self.tick - start} ticks "
                    f"without {k} unique-client arrivals (rate="
                    f"{self.spec.rate}, buffer capacity "
                    f"{self.buffer.capacity}) -- raise the rate or shrink "
                    "agg_every/buffer pressure")
            arrivals, drops, corrupts = self._realize_window(self.tick)
            for w in range(arrivals.shape[0]):
                tick = self.tick
                self.tick += 1
                for c in map(int, np.nonzero(arrivals[w])[0]):
                    self.arrivals_total += 1
                    if c in self.quarantine:
                        self.arrivals_quarantined += 1
                        self.client_versions[c] = self.version
                        continue
                    if drops[w, c]:
                        # Lost in flight: the client still pulls.
                        self.arrivals_dropped += 1
                        self.client_versions[c] = self.version
                        continue
                    self.buffer_overflow += self.buffer.push(ArrivalEvent(
                        client=c, tick=tick,
                        version=int(self.client_versions[c]),
                        corrupt=bool(corrupts[w, c])))
                    self.client_versions[c] = self.version
                if self.buffer.unique_clients() >= k:
                    break

    # -- the cycle -----------------------------------------------------------

    def run_cycle(self, state, train_arrays, malicious, host_lengths, *,
                  prebatched=None, dropout_masks=None, aug_draws=None,
                  forge_noise=None) -> Tuple[Any, dict]:
        """One buffered-async server round: ``(new_state, device
        metrics)``; the ingest digest lands in :attr:`last_info`.
        ``train_arrays`` is ``(x, y)`` over the registered clients (unused
        with a data prefetcher), ``malicious`` the ``(n,)`` host bool mask,
        ``host_lengths`` the ``(n,)`` true shard sizes on the host; the
        keywords replace the cycle's draws (:func:`.cycle.build_cycle`)."""
        spec = self.spec
        cycle_start = self.tick
        self.advance_until_ready()
        events = self.buffer.take_cycle(self.agg_every)
        staleness = np.asarray([self.version - ev.version for ev in events],
                               np.int64)
        clients = np.asarray([ev.client for ev in events], np.int64)
        ticks = np.asarray([ev.tick for ev in events], np.int64)
        corrupt = np.asarray([ev.corrupt for ev in events], bool)
        mal = np.asarray(malicious, bool)[clients]
        lengths = np.asarray(host_lengths)[clients]
        if spec.weight_schedule == "cutoff" and float(staleness_weights(
                "cutoff", staleness, cutoff=self.weight_cutoff).sum()) == 0:
            warnings.warn(
                f"async cycle at version {self.version}: every buffered "
                f"row exceeds weight_cutoff={self.weight_cutoff} "
                f"(staleness {staleness.tolist()}) -- the aggregation "
                "batch is discarded and the server takes a zero step",
                RuntimeWarning, stacklevel=2)
        kw = dict(seed=self.train_seed, version=self.version,
                  prebatched=prebatched, dropout_masks=dropout_masks,
                  aug_draws=aug_draws, forge_noise=forge_noise)
        if self.state_store is not None:
            state, metrics = self._run_windowed(state, train_arrays, clients,
                                                ticks, staleness, mal,
                                                corrupt, lengths, kw)
        else:
            state, metrics = self._cycle(
                state, train_arrays, clients, ticks, staleness, mal,
                corrupt, lengths, **kw)
        self.version += 1
        self.last_clients = clients
        self.last_staleness = staleness
        hist = np.bincount(np.clip(staleness, 0, spec.staleness_cap + 1),
                           minlength=spec.staleness_cap + 2)
        self.last_info = {
            "tick": int(self.tick),
            "events": int(self.agg_every),
            "staleness_mean": float(staleness.mean()),
            "staleness_max": int(staleness.max()),
            # Buckets 0..H plus one ">H" bucket.
            "staleness_hist": [int(v) for v in hist],
            "buffer_fill": int(self.buffer.fill),
            "arrivals_total": int(self.arrivals_total),
            "arrivals_dropped": int(self.arrivals_dropped),
            "buffer_overflow": int(self.buffer_overflow),
            "arrival_seed": int(spec.seed),
            "cycle_ticks": int(self.tick - cycle_start),
            "arrivals_quarantined": int(self.arrivals_quarantined),
        }
        return state, metrics

    def _run_windowed(self, state, train_arrays, clients, ticks, staleness,
                      mal, corrupt, lengths, kw):
        """The out-of-core event cohort: gather the ``K`` events' state
        rows (and, with a data prefetcher, their shards), run the cycle on
        them, scatter the advanced rows back."""
        store = self.state_store
        dev = state.arrivals.device
        from blades_tpu_torch.obs.trace import now

        t0 = now()
        rows = store.gather(clients, device=dev)
        if self.data_store is not None:
            ex, ey, _ = self.data_store.gather(clients, device=dev)
        else:
            x, y = train_arrays
            idx = torch.as_tensor(clients, device=x.device)
            ex, ey = x[idx].to(dev), y[idx].to(dev)
        data_bytes = (ex.numel() * ex.element_size()
                      + ey.numel() * ey.element_size())
        self.store_stats.observe(
            now() - t0, len(clients) * store.row_bytes
            + data_bytes, store.device_bytes()
            + 2 * len(clients) * store.row_bytes + data_bytes)
        opt = rows_to_opt(self.fed_round, state, rows)
        state = dataclasses.replace(state, client_opt=opt)
        state, metrics = self._cycle(state, (ex, ey), clients, ticks,
                                     staleness, mal, corrupt, lengths, **kw)
        store.scatter(clients, opt_to_rows(state, rows))
        return dataclasses.replace(state, client_opt=None), metrics

    # -- state bootstrap / checkpointing -------------------------------------

    def init_history(self, params) -> torch.Tensor:
        """The ``RoundState.arrivals`` ring at init."""
        return init_history(params, self.spec.staleness_cap)

    def host_state(self) -> Dict[str, Any]:
        """The deterministic host state, for the checkpoint payload."""
        return {
            "tick": int(self.tick),
            "version": int(self.version),
            "client_versions": [int(v) for v in self.client_versions],
            "buffer": self.buffer.state(),
            "arrivals_total": int(self.arrivals_total),
            "arrivals_dropped": int(self.arrivals_dropped),
            "buffer_overflow": int(self.buffer_overflow),
            "agg_every": int(self.agg_every),
            "buffer_capacity": int(self.buffer.capacity),
            "weight_cutoff": int(self.weight_cutoff),
            "quarantine": sorted(self.quarantine),
            "arrivals_quarantined": int(self.arrivals_quarantined),
        }

    def restore_host_state(self, payload: Dict[str, Any]) -> None:
        versions = payload["client_versions"]
        if len(versions) != self.num_clients:
            raise ValueError(
                f"checkpointed version vector covers {len(versions)} "
                f"clients, this federation has {self.num_clients}")
        self.tick = int(payload["tick"])
        self.version = int(payload["version"])
        self.client_versions = np.asarray(versions, np.int64)
        self.agg_every = int(payload.get("agg_every", self.spec.agg_every))
        self.quarantine = frozenset(
            int(c) for c in payload.get("quarantine") or ())
        self.arrivals_quarantined = int(
            payload.get("arrivals_quarantined", 0))
        cutoff = int(payload.get("weight_cutoff", self.spec.weight_cutoff))
        if cutoff != self.weight_cutoff:
            self.weight_cutoff = cutoff
            self._build_cycle()
        self.buffer = UpdateBuffer(int(payload.get(
            "buffer_capacity", self.spec.effective_capacity)))
        self.buffer.restore(payload.get("buffer") or [])
        self.arrivals_total = int(payload.get("arrivals_total", 0))
        self.arrivals_dropped = int(payload.get("arrivals_dropped", 0))
        self.buffer_overflow = int(payload.get("buffer_overflow", 0))
        self.last_info = {}

    def cold_reset(self, iteration: int) -> None:
        """Resume without a checkpointed arrivals payload: a fresh clock
        with the version counter synced to the restored round counter
        (the traffic is not the original run's)."""
        self.tick = 0
        self.version = int(iteration)
        self.client_versions = np.full(self.num_clients, int(iteration),
                                       np.int64)
        self.buffer = UpdateBuffer(self.spec.effective_capacity)
        self.arrivals_total = 0
        self.arrivals_dropped = 0
        self.buffer_overflow = 0
        self.agg_every = int(self.spec.agg_every)
        self.quarantine = frozenset()
        self.arrivals_quarantined = 0
        if self.weight_cutoff != int(self.spec.weight_cutoff):
            self.weight_cutoff = int(self.spec.weight_cutoff)
            self._build_cycle()
        self.last_info = {}


def rows_to_opt(fed_round, state, rows: Dict[str, torch.Tensor]):
    """A store's flat ``client_opt`` rows ``(K, d)`` as the round's
    optimizer-state dict ``{name: (K, *shape)}`` (None without one)."""
    from blades_tpu_torch.utils.tree import FlatLayout

    flat = rows.get("client_opt")
    if flat is None:
        return None
    return FlatLayout(state.server.params).unravel_rows(flat)


def opt_to_rows(state, rows: Dict[str, torch.Tensor]):
    """The advanced optimizer state of ``state`` back in the store's flat
    row form, beside the other leaves of ``rows``."""
    from blades_tpu_torch.utils.tree import FlatLayout

    out = dict(rows)
    if state.client_opt is not None:
        out["client_opt"] = FlatLayout(state.server.params).ravel_rows(
            state.client_opt)
    return out
