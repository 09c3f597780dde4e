"""Fedavg driver (counterpart of ``blades_tpu/algorithms/fedavg.py``).

``train()`` runs one dispatch of ``rounds_per_dispatch`` rounds and returns
its result row, with the periodic evaluation folded in (``train_raw()`` /
``finalize_row()`` split off the fetch of the metrics);
``evaluate()`` is the weighted per-client evaluation;
``save_checkpoint()`` / ``load_checkpoint()`` hold the resident state.
Setup builds the dataset (numpy, then onto the device), the malicious mask
(the first ``num_malicious_clients`` lanes), the initial state, and picks
the round: the dense :meth:`FedRound.step`, or the streamed round
(:func:`blades_tpu_torch.parallel.streamed.streamed_step`) when
``execution="streamed"``, or under ``"auto"`` when the dense f32 ``(n, d)``
update matrix would take more than 3/8 of the device's memory (a codec or
the fault injector needs the dense round, and then raises there).

Under ``execution="async"`` one ``train()`` is one buffered-async cycle
(:class:`~blades_tpu_torch.arrivals.AsyncEngine`); its rows carry the
ingest digest (``tick``, ``staleness_mean`` / ``_max`` / ``_hist``,
``buffer_fill``, ``buffer_overflow``, ``arrivals_dropped``,
``arrival_seed``, ``cycle_ticks``, ``arrivals_quarantined``) and
``updates_per_sec``, and ``RoundState.arrivals`` carries the params
ring.  Under a participation window (``state_window >= 1``) each round
runs the dense round over a sampled cohort whose state rows come from a
:mod:`~blades_tpu_torch.state` store, staged by a
:class:`~blades_tpu_torch.state.StatePrefetcher`; its rows carry
``state_store``, ``cohort_size``, ``state_stage_ms``,
``state_bytes_staged`` and ``state_peak_hbm_bytes``, and with a data
store ``data_store``, ``data_stage_ms``, ``data_bytes_staged`` (and
``eval_chunks`` where the memmap data store streams the evaluation).
``state_window=0`` runs stateless clients.  Under ``execution="gossip"``
the round is the decentralized gossip round
(:mod:`blades_tpu_torch.topology.gossip`): ``RoundState.server`` holds one
replica per node (leaves ``(n, *shape)``), evaluation scores node 0's
replica, and the rows carry ``gossip_ici_bytes``,
``num_partitioned_nodes``, ``consensus_dist`` and the graph's
provenance (``topology``, ``graph_seed``, ``spectral_gap``).

Under client lane-packing (``client_packing``) the rows carry
``pack_factor`` and ``packed_lanes`` and :attr:`Fedavg.packing_summary`
the decision; an ``"auto"`` request whose ``execution="auto"`` resolves
to the streamed round falls back to the unpacked round with a warning.
Rows of a codec run carry ``comm_bytes_up``, ``codec_bits``,
``comm_compression_ratio``, ``agg_domain`` and ``agg_domain_bits``, and in
the wire domain ``dequant_rows`` and ``hbm_passes``; rows of a fault run
``num_participating``, ``num_dropped``, ``num_straggled``, ``fault_seed``
and, with stragglers, ``staleness_mean`` / ``staleness_max``.
With ``forensics`` the rows carry ``byz_precision`` / ``byz_recall`` /
``byz_fpr``, ``num_flagged``, ``num_unhealthy`` and ``lane_forensics``
(``benign_mask``, ``healthy``, ``scores``, ``update_norms`` and
``clients``: lane i diagnoses registered client ``clients[i]``, the
identity on the dense round, the event clients on the async cycle, the
cohort under a window).  The client ledger (``ledger``,
:mod:`blades_tpu_torch.obs.ledger`) folds each row's cohort into one
record per registered client and stamps the fleet fields
(``suspected_fraction``, ``flagged_churn``, ``reputation_p*``,
``ledger_clients_seen``, ``ledger_top_suspects``).  The control plane
(``control_config``, :mod:`blades_tpu_torch.control`) runs the driver's
own watchdog over each finished row, stamps ``watchdog_events``, journals
the controller's actions (``control_actions``, ``control_actions_total``,
``quarantine_size``) and applies them to the async engine's setters.
These run when a row is finalized, i.e. when its metrics are fetched.

Checkpoints carry the residual and the stale ring in the ``RoundState``
(under gossip the per-node stacks, which ``torch.load`` puts back on the
device verbatim), the async engine's host state, the watchdog's windows
and the controller's state, a windowed store's rows as shard files
(``client_state/``) and the ledger's (``ledger/``).

Each round draws from a ``torch.Generator`` seeded by
``SeedSequence([seed, round])``, so a run is reproducible per seed on one
device (the draws are not the JAX package's).
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from blades_tpu_torch.adversaries import make_malicious_mask
from blades_tpu_torch.adversaries.base import forges
from blades_tpu_torch.arrivals import AsyncEngine
from blades_tpu_torch.arrivals.engine import opt_to_rows, rows_to_opt
from blades_tpu_torch.data.datasets import DatasetCatalog
from blades_tpu_torch.data.store import make_data_store
from blades_tpu_torch.data.stream import (
    DataPrefetcher,
    make_chunk_evaluator,
    streaming_evaluate,
)
from blades_tpu_torch.device import resolve_device
from blades_tpu_torch.ops.aggregators import Mean, Median, Trimmedmean
from blades_tpu_torch.parallel.streamed import (
    _COORDWISE_FORGERS,
    streamed_step,
)
from blades_tpu_torch.parallel.streamed_geometry import (
    STREAMED_ROW_AGGREGATORS,
    STREAMED_ROW_FORGERS,
)
from blades_tpu_torch.state import (
    StatePrefetcher,
    make_store,
    read_checkpoint_rows,
    sample_cohort,
)
from blades_tpu_torch.topology import (
    gossip_federation,
    gossip_step,
    node_head,
)
from blades_tpu_torch.utils.async_metrics import DEVICE_METRICS_KEY
from blades_tpu_torch.utils.async_metrics import fetch as fetch_tree
from blades_tpu_torch.utils.seeds import seed_of
from blades_tpu_torch.obs.trace import now
from blades_tpu_torch.utils.timers import Timers
from blades_tpu_torch.utils.tree import FlatLayout

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: Key under which a row created on a cohort path carries its cohort
#: ``(client ids, staleness or None)`` until :meth:`Fedavg.finalize_row`.
_COHORT_KEY = "_cohort"


def eval_arrays(cfg, dataset, device, host: bool = False):
    """The per-client test shards of ``dataset`` on ``device`` (numpy
    arrays with ``host``), each subsampled to ``cfg``'s
    ``evaluation_num_samples`` rows (a seeded random subset of the
    client's true rows, as the reference draws it)."""
    test = dataset.test
    tx, ty, tln = test.x, test.y, test.lengths
    cap = cfg.evaluation_num_samples
    if cap is not None and cap < tx.shape[1]:
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        n = tx.shape[0]
        pick = np.zeros((n, cap), np.int32)
        for i in range(n):
            k = int(tln[i])
            pick[i] = (rng.choice(k, size=cap, replace=False)
                       if k >= cap else np.arange(cap) % max(k, 1))
        tx = np.take_along_axis(
            tx, pick.reshape((n, cap) + (1,) * (tx.ndim - 2)), axis=1)
        ty = np.take_along_axis(ty, pick, axis=1)
        tln = np.minimum(tln, cap)
    if host:
        return tx, ty, tln
    return (torch.from_numpy(np.ascontiguousarray(tx)).to(device),
            torch.from_numpy(np.ascontiguousarray(ty)).long().to(device),
            torch.from_numpy(np.asarray(tln)).long().to(device))


class Fedavg:
    """FedAvg with Byzantine clients and a robust server."""

    # The 'auto' dense budget: 3/8 of the device's memory for the f32
    # (n, d) matrix, or 6 GiB where the device reports none (the CPU).
    _DENSE_MATRIX_FRACTION = 3 / 8
    _DENSE_MATRIX_LIMIT = 6 * (1 << 30)

    def __init__(self, config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._setup()

    def _setup(self) -> None:
        cfg = self.config
        dev = self.device
        self.dataset = DatasetCatalog.get_dataset(
            cfg.dataset, num_clients=cfg.num_clients, iid=cfg.iid,
            alpha=cfg.dirichlet_alpha, seed=cfg.seed)
        self.fed_round = cfg.resolve_augment_for_data(cfg.get_fed_round(),
                                                      self.dataset)
        if getattr(self.fed_round.server.aggregator, "expects_trusted_row",
                   False):
            self.fed_round = self._attach_root_data(self.fed_round)
        self.malicious = make_malicious_mask(
            cfg.num_clients, cfg.num_malicious_clients, device=dev)
        self._malicious_host = (np.arange(cfg.num_clients)
                                < cfg.num_malicious_clients)
        # Out-of-core client state: a participation window, or an async
        # run whose event cohort's rows live behind a host / disk store.
        # Then the per-client stacks are never made whole.
        sw = cfg.state_window
        self._windowed = sw is not None and sw >= 1
        ooc_async = (cfg.execution == "async"
                     and cfg.state_store != "resident")
        cohort = self._windowed or ooc_async
        self._state_store = None
        self._state_pf = None
        self._window_prev = None
        self._async = None
        self._data_store = None
        self._data_pf = None
        self._eval_chunks = 0
        template = None
        if cohort:
            rows = (int(sw) if self._windowed
                    else cfg.get_async_spec().agg_every)
            self.state, template = self.fed_round.init_windowed(
                cfg.seed, rows, device=dev)
        else:
            self.state = self.fed_round.init(cfg.seed, cfg.num_clients,
                                             device=dev)
        self._num_params = FlatLayout(self.state.server.params).d

        train = self.dataset.train
        self._host_train = (train.x, train.y, train.lengths)
        self._streamed = (not cohort and cfg.execution != "async"
                          and self._use_streamed())
        if cohort:
            # The shards stay on the host; each cohort's rows are
            # gathered through the data store.
            self._train = None
            self._data_store = make_data_store(
                cfg.data_store, self._host_train, directory=cfg.data_dir,
                device=dev)
            self._data_pf = DataPrefetcher(self._data_store)
        else:
            x = torch.from_numpy(train.x)
            cd = self.fed_round.task.compute_dtype
            if self._streamed and cd is not None:
                # bf16 compute casts the inputs down anyway: keep the
                # resident training images in that dtype (half the memory
                # at 1000 CIFAR clients, which the bf16 update matrix
                # needs back).
                x = x.to(cd)
            self._train = (x.to(dev),
                           torch.from_numpy(train.y).long().to(dev),
                           torch.from_numpy(train.lengths).long().to(dev))
        # The memmap data plane keeps the test stack on the host too and
        # evaluates it in chunks.
        self._streaming_eval = (self._data_store is not None
                                and self._data_store.backend == "memmap")
        self._test = eval_arrays(cfg, self.dataset, dev,
                                 host=self._streaming_eval)
        self._topology = self._gossip_recorder = None
        if cfg.execution == "async":
            if ooc_async:
                self._state_store = make_store(
                    cfg.state_store, cfg.num_clients, template,
                    directory=cfg.state_dir, device=dev)
            self._async = AsyncEngine(
                self.fed_round, cfg.get_async_spec(), cfg.num_clients,
                train_seed=int(cfg.seed),
                fault_injector=cfg.get_fault_injector(),
                state_store=self._state_store, data_store=self._data_pf,
                client_block=max(1, int(cfg.client_block)))
            self.state = dataclasses.replace(
                self.state, arrivals=self._async.init_history(
                    self.state.server.params))
            self._step = None
        elif self._windowed:
            self._setup_windowed_pipeline(template)
        elif cfg.execution == "gossip":
            # Every node keeps its own replica: one round is local
            # training -> neighborhood exchange -> per-node robust
            # aggregation -> mixing.  Evaluation reads node 0's replica.
            self._topology = cfg.get_topology()
            self.state = gossip_federation(self.state, cfg.num_clients)
            self._step, self._gossip_recorder = gossip_step(
                self.fed_round, self._topology)
        elif self._streamed:
            self._step = streamed_step(
                self.fed_round, client_block=self._streamed_block(),
                update_dtype=_DTYPES[str(cfg.update_dtype)],
                malicious_prefix=cfg.num_malicious_clients,
                d_chunk=cfg.d_chunk, device=dev)
        else:
            self._step = self.fed_round.step
        self._setup_observability()
        self.timers = Timers(sync=dev.type == "cuda")
        self._chunk = max(1, int(cfg.rounds_per_dispatch))
        self._iteration = 0
        self._rounds_since_eval = 0
        self._last_eval: Dict = {}

    def _setup_observability(self) -> None:
        """The client ledger (one record per registered client) and the
        control plane: the driver's own watchdog over finished rows and a
        controller whose actions move the async engine's actuators (the
        synchronous driver has none of them; a replan needs the
        autotuner, which the port does not have)."""
        from blades_tpu_torch.control import Controller
        from blades_tpu_torch.obs.ledger import make_ledger
        from blades_tpu_torch.obs.watchdog import Watchdog

        cfg = self.config
        self._ledger = (None if not cfg.ledger_backend else make_ledger(
            cfg.ledger_backend, cfg.num_clients, directory=cfg.ledger_dir))
        self._controller = self._watchdog = None
        if not cfg.control_enabled:
            return
        self._watchdog = Watchdog(cfg.get_watchdog_rules())
        eng = self._async
        if eng is None:
            self._controller = Controller(cfg.get_control_policy(),
                                          num_clients=cfg.num_clients)
            return
        self._controller = Controller(
            cfg.get_control_policy(), num_clients=cfg.num_clients,
            agg_every=int(eng.agg_every),
            buffer_capacity=int(eng.buffer.capacity),
            weight_cutoff=int(eng.weight_cutoff),
            # Under a state store the event cohort is the participation
            # window, which only the shrink-only window family moves.
            window=(int(eng.agg_every) if self._state_store is not None
                    else None))

    def _setup_windowed_pipeline(self, template) -> None:
        """The participation window on one card: each round gathers the
        sampled cohort's state and data rows, runs the dense round over
        them and scatters the state rows back, while the prefetcher
        stages the next cohort (``prefetch``: on the card by default,
        forced either way by ``True`` / ``"on"`` or ``False`` /
        ``"off"``; the values are the same)."""
        cfg = self.config
        n, w = cfg.num_clients, int(cfg.state_window)
        self._state_store = make_store(
            cfg.state_store, n, template, directory=cfg.state_dir,
            device=self.device)
        self._state_pf = StatePrefetcher(
            self._state_store, self._data_pf, self._malicious_host,
            lambda r: sample_cohort(self.round_seed(r), n, w),
            device=self.device, async_staging=self._resolve_prefetch())
        self._step = self.fed_round.step

    def _resolve_prefetch(self) -> bool:
        want = self.config.prefetch
        if want in (False, "off"):
            return False
        if want in (True, "on"):
            return True
        return self.device.type == "cuda"

    @classmethod
    def dense_matrix_limit(cls, device) -> int:
        """The 'auto' execution's budget for the dense f32 matrix on
        ``device`` (the laned matrix's too)."""
        device = torch.device(device)
        if device.type == "cuda":
            total = torch.cuda.get_device_properties(device).total_memory
            return int(total * cls._DENSE_MATRIX_FRACTION)
        return cls._DENSE_MATRIX_LIMIT

    def _streamed_supported(self) -> bool:
        fr = self.fed_round
        if not isinstance(fr.server.aggregator,
                          (Mean, Median, Trimmedmean) + STREAMED_ROW_AGGREGATORS):
            return False
        adv = fr.adversary
        return not forges(adv) or isinstance(
            adv, _COORDWISE_FORGERS + STREAMED_ROW_FORGERS)

    def _use_streamed(self) -> bool:
        cfg = self.config
        if cfg.execution != "auto":
            return cfg.execution == "streamed"
        if not self._streamed_supported():
            return False
        limit = self.dense_matrix_limit(self.device)
        if cfg.num_clients * self._num_params * 4 <= limit:
            return False
        if (self.fed_round.packing is not None
                and cfg.client_packing == "auto"):
            # resolve_client_packing refuses an explicit streamed request
            # only; an 'auto' request keeps its loud fallback here.
            reason = ("'auto' execution resolved to streaming at "
                      f"num_clients={cfg.num_clients} (dense (n, d) "
                      "matrix would strain device memory); lane packing "
                      "needs the dense round")
            warnings.warn(
                f"client_packing='auto' falling back to unpacked "
                f"execution: {reason}", RuntimeWarning, stacklevel=3)
            self.fed_round = dataclasses.replace(self.fed_round,
                                                 packing=None)
            cfg._packing_decision = {
                "requested": "auto", "pack_factor": 1,
                "packed_lanes": cfg.num_clients, "fallback": reason}
        if (cfg.fault_config or cfg.codec_config or cfg.forensics
                or self.fed_round.packing is not None):
            what = ("fault injection" if cfg.fault_config
                    else "the update codec" if cfg.codec_config
                    else "defense forensics" if cfg.forensics
                    else "client lane-packing")
            raise ValueError(
                f"{what} needs the dense round but 'auto' execution "
                "resolved to streaming (the dense (n, d) matrix would "
                f"strain device memory at num_clients={cfg.num_clients}); "
                f"shrink the federation for this pass or disable {what}")
        return True

    def _streamed_block(self) -> int:
        """The largest divisor of num_clients no larger than client_block
        (the streamed round needs an exact tiling)."""
        n, want = self.config.num_clients, max(1, self.config.client_block)
        block = next(b for b in range(min(want, n), 0, -1) if n % b == 0)
        if block < max(2, want // 4) and n > want:
            warnings.warn(
                f"num_clients={n} has no divisor near client_block={want}; "
                f"the streamed round degrades to {block}-client blocks",
                stacklevel=2)
        return block

    def _attach_root_data(self, fed_round):
        """A clean server root dataset for FLTrust: a few rows of every
        client's training shard, round-robin, up to ``fltrust_root_size``
        samples."""
        part = self.dataset.train
        size = self.config.fltrust_root_size
        per = max(1, -(-size // part.num_clients))
        take = [min(per, int(part.lengths[i]))
                for i in range(part.num_clients)]
        tx = np.concatenate([part.x[i, :take[i]]
                             for i in range(part.num_clients)])[:size]
        ty = np.concatenate([part.y[i, :take[i]]
                             for i in range(part.num_clients)])[:size]
        return dataclasses.replace(
            fed_round, trusted_data=(torch.from_numpy(tx).to(self.device),
                                     torch.from_numpy(ty).long()
                                     .to(self.device)))

    def round_seed(self, r: int) -> int:
        """The seed of round ``r``'s generator."""
        return seed_of(self.config.seed, r)

    # -- the trainable surface ----------------------------------------------

    @property
    def iteration(self) -> int:
        return self._iteration

    @property
    def streamed(self) -> bool:
        """Whether the rounds run through the streamed round."""
        return self._streamed

    def train(self) -> Dict:
        """One dispatch (``rounds_per_dispatch`` FL rounds, 1 by default),
        plus the evaluation when its cadence is due; returns the result
        row."""
        return self.finalize_row(self.train_raw())

    def train_raw(self) -> Dict:
        """:meth:`train` without the fetch of the round's scalar metrics:
        they stay device tensors under ``DEVICE_METRICS_KEY`` until
        :meth:`finalize_row` (or
        :func:`~blades_tpu_torch.utils.async_metrics.flush_rows`, which
        batches the copy over rows) turns the row into its host form.  On
        the card the ``training_step`` timer still syncs the device at the
        end of the dispatch, so deferring saves copies, not syncs."""
        raw = {}
        t0 = now()
        with self.timers.time("training_step"):
            # Each round draws from its own round seed, so K rounds of one
            # dispatch are exactly K single-round dispatches.
            for _ in range(self._chunk):
                if self._async is not None:
                    # One buffered-async cycle; its draws are pure in
                    # (seed, tick, client), so no seed chain advances.
                    self.state, m = self._async.run_cycle(
                        self.state, None if self._train is None
                        else self._train[:2], self._malicious_host,
                        self._host_train[2])
                elif self._state_pf is not None:
                    m = self._windowed_round()
                else:
                    seed = self.round_seed(self._iteration)
                    self.state, m = self._step(self.state, *self._train,
                                               self.malicious, seed)
                self._iteration += 1
                for k, v in m.items():
                    raw.setdefault(k, []).append(v)
        self._rounds_since_eval += self._chunk
        row = {"training_iteration": self._iteration,
               DEVICE_METRICS_KEY: raw,
               "timers": self.timers.summary()}
        if self._async is not None:
            info = self._async.last_info
            for k in ("tick", "staleness_max", "buffer_fill",
                      "arrivals_dropped", "buffer_overflow", "arrival_seed",
                      "cycle_ticks", "arrivals_quarantined"):
                row[k] = int(info[k])
            row["staleness_mean"] = float(info["staleness_mean"])
            row["staleness_hist"] = list(info["staleness_hist"])
            elapsed = max(now() - t0, 1e-9)
            row["updates_per_sec"] = round(info["events"] / elapsed, 3)
            # Lane i of this cycle's forensics is event client i; taken
            # now, before a later cycle moves the engine's columns.
            row[_COHORT_KEY] = (np.asarray(self._async.last_clients),
                                np.asarray(self._async.last_staleness))
        elif self._state_pf is not None:
            row[_COHORT_KEY] = (np.asarray(self._window_prev[0]), None)
        if self._state_store is not None:
            stats = (self._state_pf.stats if self._state_pf is not None
                     else self._async.store_stats)
            row["state_store"] = self._state_store.backend
            row["cohort_size"] = self._cohort_size()
            row["state_stage_ms"] = round(stats.last_stage_ms, 3)
            row["state_bytes_staged"] = int(stats.last_bytes_staged)
            row["state_peak_hbm_bytes"] = int(stats.peak_hbm_bytes)
        if self._data_store is not None:
            dstats = self._data_pf.stats
            row["data_store"] = self._data_store.backend
            row["data_stage_ms"] = round(dstats.last_stage_ms, 3)
            row["data_bytes_staged"] = int(dstats.last_bytes_staged)
        # The rounds-since-eval cadence: a rounds_per_dispatch that does
        # not divide the interval still evaluates.
        if (self.config.evaluation_interval
                and self._rounds_since_eval >= self.config.evaluation_interval):
            self._rounds_since_eval = 0
            row.update(self.evaluate())
        elif self._last_eval:
            row.update(self._last_eval)
        return row

    def _cohort_size(self) -> int:
        return (int(self.config.state_window) if self._state_pf is not None
                else int(self._async.agg_every))

    def _windowed_round(self) -> Dict:
        """One participation-window round: take the staged cohort (state
        rows, shards, malicious mask), run the dense round over it, then
        start staging the next cohort (it leaves this cohort's ids out)
        and queue this one's rows for the store.  Returns the device
        metrics."""
        r = self._iteration
        ids, rows, data, mal = self._state_pf.take(r, self._window_prev)
        state = dataclasses.replace(
            self.state, client_opt=rows_to_opt(self.fed_round, self.state,
                                               rows),
            residual=rows.get("residual"),
            cohort=torch.as_tensor(ids))
        self.state, m = self._step(state, *data, mal, self.round_seed(r))
        out = opt_to_rows(self.state, {})
        if self.state.residual is not None:
            out["residual"] = self.state.residual
        self._state_pf.stage(r + 1, prev_ids=ids)
        self._state_pf.writeback(ids, out)
        self._window_prev = (ids, out)
        return m

    @property
    def state_summary(self) -> Optional[Dict]:
        """The client-state store's digest (backend, window, row and total
        bytes, peak), or None without one."""
        if self._state_store is None:
            return None
        stats = (self._state_pf.stats if self._state_pf is not None
                 else self._async.store_stats)
        return {
            "backend": self._state_store.backend,
            "window": self._cohort_size(),
            "n_registered": self._state_store.n_registered,
            "row_bytes": int(self._state_store.row_bytes),
            "total_bytes": int(self._state_store.total_bytes()),
            "peak_hbm_bytes": int(stats.peak_hbm_bytes),
        }

    @property
    def data_summary(self) -> Optional[Dict]:
        """The data store's digest, or None on the resident data plane."""
        if self._data_store is None:
            return None
        stats = self._data_pf.stats
        return {
            "backend": self._data_store.backend,
            "n_clients": int(self._data_store.n_clients),
            "row_bytes": int(self._data_store.row_bytes),
            "total_bytes": int(self._data_store.total_bytes()),
            "last_stage_ms": round(stats.last_stage_ms, 3),
            "last_bytes_staged": int(stats.last_bytes_staged),
            "eval_chunks": int(self._eval_chunks),
        }

    def finalize_row(self, row: Dict) -> Dict:
        """A (possibly deferred) row's metrics in host form: the scalars of
        the dispatch's last round, the health counts reduced over all of
        its rounds (a lane that went non-finite mid-dispatch shows even if
        the last round recovered)."""
        raw = row.pop(DEVICE_METRICS_KEY, None)
        if raw is None:
            return row
        raw = fetch_tree(raw)
        cohort_ids, cohort_staleness = row.pop(_COHORT_KEY, (None, None))
        lanes = {k[len("lane_"):]: np.asarray(v[-1])
                 for k, v in raw.items() if k.startswith("lane_")}
        for k in ("train_loss", "agg_norm", "update_norm_mean"):
            row[k] = float(raw[k][-1])
        for k in ("hbm_passes", "hbm_passes_unfused", "elided_lanes",
                  "dequant_rows"):
            if k in raw:
                row[k] = int(raw[k][-1])
        packing = self.fed_round.packing
        if packing is not None:
            # Static per round: clients per lane and the lanes they fill.
            row["pack_factor"] = int(packing.pack)
            row["packed_lanes"] = int(self.config.num_clients
                                      // packing.pack)
        codec = self.fed_round.codec
        if codec is not None:
            # Static per round, from the config alone; under a window only
            # the cohort sends.
            uplink = (int(self.config.state_window)
                      if self._state_pf is not None
                      else self.config.num_clients)
            row.update(codec.round_metrics(uplink, self._num_params))
            domain = self.fed_round.agg_domain
            row["agg_domain"] = domain
            row["agg_domain_bits"] = (codec.storage_bits
                                      if domain == "wire" else 32)
        faults = self.fed_round.faults
        if faults is not None:
            # An async cycle has no participation mask (a dropped arrival
            # never reaches the buffer): the seed alone.
            if "num_participating" in raw:
                for k in ("num_participating", "num_straggled",
                          "num_dropped"):
                    row[k] = int(raw[k][-1])
            row["fault_seed"] = int(faults.seed)
            if "staleness_mean" in raw:
                row["staleness_mean"] = float(raw["staleness_mean"][-1])
                row["staleness_max"] = int(raw["staleness_max"][-1])
        if "gossip_ici_bytes" in raw:
            # The exchange's wire bytes, the partition count, the replicas'
            # consensus diameter, and the graph's provenance (static per
            # run, stamped on every row).
            row["gossip_ici_bytes"] = int(raw["gossip_ici_bytes"][-1])
            row["num_partitioned_nodes"] = int(
                raw["num_partitioned_nodes"][-1])
            row["consensus_dist"] = float(raw["consensus_dist"][-1])
            prov = self._topology.provenance()
            row["topology"] = str(prov["topology"])
            row["graph_seed"] = int(prov["graph_seed"])
            row["spectral_gap"] = float(prov["spectral_gap"])
        if self.config.health_check or self.config.forensics:
            row["num_unhealthy"] = int(sum(raw["num_unhealthy"]))
        if self.config.health_check:
            row["round_ok"] = bool(all(raw["round_ok"]))
        if self.config.forensics:
            for k in ("byz_precision", "byz_recall", "byz_fpr"):
                row[k] = float(raw[k][-1])
            row["num_flagged"] = int(raw["num_flagged"][-1])
            if cohort_ids is None:
                cohort_ids = np.arange(len(lanes["benign_mask"]))
            row["lane_forensics"] = {
                "benign_mask": [bool(b > 0.5) for b in lanes["benign_mask"]],
                "healthy": [bool(h > 0.5) for h in lanes["healthy"]],
                "scores": [float(s) for s in lanes["scores"]],
                "clients": [int(c) for c in cohort_ids],
                "update_norms": [float(x) for x in lanes["update_norms"]],
            }
        if self._ledger is not None:
            # Without forensics only participation and recency accrue.
            flagged = scores = norms = None
            if self.config.forensics:
                flagged = lanes["benign_mask"] <= 0.5
                scores = lanes["scores"].astype(np.float64)
                norms = lanes["update_norms"].astype(np.float64)
            if cohort_ids is None:
                cohort_ids = np.arange(self.config.num_clients)
            self._ledger.observe(
                cohort_ids, round=int(row["training_iteration"]),
                tick=row.get("tick"), flagged=flagged, scores=scores,
                staleness=cohort_staleness, norms=norms)
            row.update(self._ledger.round_fields())
        if self._controller is not None:
            # Last, so the watchdog and the policy see the whole row.
            self._control_round(row, lanes, cohort_ids)
        return row

    def _control_round(self, row: Dict, lanes: Dict, cohort_ids) -> None:
        """One control step over a finished row: the driver's watchdog
        observes it (``watchdog_events``), the controller journals its
        decisions, they are applied to the engine, and the row carries
        ``control_actions``, ``control_actions_total`` and
        ``quarantine_size``."""
        events = [e.as_dict() for e in self._watchdog.observe(row)]
        row["watchdog_events"] = events
        participants = flagged = ()
        if cohort_ids is not None and "benign_mask" in lanes:
            ids = np.asarray(cohort_ids, np.int64)
            participants = tuple(int(c) for c in ids)
            flagged = tuple(int(c) for c in ids[lanes["benign_mask"] <= 0.5])
        actions = self._controller.step(
            round_idx=int(row["training_iteration"]),
            tick=int(row.get("tick", row["training_iteration"])),
            events=events, suspects=row.get("ledger_top_suspects") or (),
            participants=participants, flagged=flagged)
        for act in actions:
            self._apply_control_action(act)
        row["control_actions"] = [a.as_dict() for a in actions]
        row["control_actions_total"] = int(self._controller.actions_total)
        row["quarantine_size"] = len(self._controller.quarantine)

    def _apply_control_action(self, act) -> None:
        """Move the async engine's actuator for one journaled action.  An
        engine that refuses the move warns: the journal keeps the intent.
        ``replan`` needs the execution autotuner, which the port does not
        have, so it moves nothing (the controller offers none without
        it)."""
        eng = self._async
        if eng is None:
            return
        try:
            if act.actuator in ("agg_every", "window"):
                # Under a state store the event cohort is the window.
                eng.set_agg_every(int(act.new))
            elif act.actuator == "buffer_capacity":
                eng.set_buffer_capacity(int(act.new))
            elif act.actuator == "weight_cutoff":
                eng.set_weight_cutoff(int(act.new))
            elif act.actuator in ("quarantine", "probe", "readmit",
                                  "requarantine"):
                eng.set_quarantine(self._controller.quarantined_clients())
        except ValueError as exc:
            warnings.warn(
                f"control action {act.actuator} (seq {act.seq}) was "
                f"journaled but the engine rejected it: {exc}",
                RuntimeWarning, stacklevel=2)

    @property
    def packing_summary(self) -> Optional[Dict]:
        """The packing decision ``get_fed_round()`` resolved (requested,
        pack_factor, packed_lanes, fallback reason), or None when packing
        was not requested; the sweep puts it in the trial's summary."""
        return getattr(self.config, "_packing_decision", None)

    @property
    def client_ledger(self):
        """The live :class:`~blades_tpu_torch.obs.ledger.ClientLedger`, or
        None (the sweep hands it to the flight recorder)."""
        return self._ledger

    @property
    def ledger_summary(self) -> Optional[Dict]:
        """The ledger's fleet digest, or None without a ledger."""
        return None if self._ledger is None else self._ledger.summary()

    @property
    def control_summary(self) -> Optional[Dict]:
        """The controller's digest (actions journaled, actuator values,
        quarantine and probation sets, the driver watchdog's event
        count), or None without the control plane."""
        if self._controller is None:
            return None
        out = self._controller.summary()
        out["watchdog_events"] = len(self._watchdog.events)
        return out

    # -- checkpoints --------------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        """Write the resident state into ``checkpoint_dir``: the round
        counter, the eval cadence and the last evaluation, the
        :class:`~blades_tpu_torch.core.round.RoundState` (server parameters
        and optimizer state, aggregator state, client optimizer rows, the
        async params ring) and the config; the async engine's host state
        (``arrivals``); a windowed store's rows as shard files under
        ``client_state/`` (the write-backs flushed first).  The round and
        event generators are pure in ``(seed, round)`` and ``(seed, tick,
        client)``, so nothing else is needed to replay the run."""
        path = Path(checkpoint_dir)
        path.mkdir(parents=True, exist_ok=True)
        state = self.state
        if self._state_store is not None:
            if self._state_pf is not None:
                self._state_pf.flush()
            state = dataclasses.replace(state, client_opt=None,
                                        residual=None, cohort=None)
            self._state_store.save(path / "client_state")
        payload = {
            "iteration": self._iteration,
            "rounds_since_eval": self._rounds_since_eval,
            "last_eval": dict(self._last_eval),
            "state": state,
            "config_dict": {k: v for k, v in self.config.items()
                            if not callable(v)},
            "state_store": None if self._state_store is None else {
                "backend": self._state_store.backend,
                "window": self._cohort_size(),
                "n_registered": self._state_store.n_registered,
                "template": dict(zip(self._state_store.names,
                                     self._state_store._template))},
            "data_store": None if self._data_store is None else {
                "backend": self._data_store.backend,
                "dir": getattr(self._data_store, "directory", None),
                "n_clients": int(self._data_store.n_clients)},
            "arrivals": (None if self._async is None
                         else self._async.host_state()),
            # RoundState is unpacked on every path, so any pack factor
            # resumes any other; recorded for the audit.
            "pack_factor": (1 if self.fed_round.packing is None
                            else int(self.fed_round.packing.pack)),
            "control": (None if self._controller is None else {
                "watchdog": self._watchdog.state(),
                "controller": self._controller.state()}),
        }
        file = path / "algorithm_state.pkl"
        torch.save(payload, file)
        if self._ledger is not None:
            self._ledger.save(path / "ledger")
        return str(file)

    def load_checkpoint(self, checkpoint_path: str) -> None:
        """Restore what :meth:`save_checkpoint` wrote (a checkpoint
        directory or its file) onto this driver's device."""
        p = Path(checkpoint_path)
        if p.is_dir():
            p = p / "algorithm_state.pkl"
        payload = torch.load(p, map_location=self.device, weights_only=False)
        self._iteration = payload["iteration"]
        self._rounds_since_eval = payload["rounds_since_eval"]
        self._last_eval = dict(payload["last_eval"])
        state = payload["state"]
        for k in ("arrivals", "cohort"):  # checkpoints before these fields
            if not hasattr(state, k):
                setattr(state, k, None)
        state = self._restore_client_rows(state, payload, p.parent)
        if self._async is not None:
            if payload.get("arrivals"):
                self._async.restore_host_state(payload["arrivals"])
            else:
                warnings.warn(
                    "resumed a checkpoint without the async engine's host "
                    "state under execution='async': the arrival clock "
                    "restarts (the traffic is not the original run's)",
                    stacklevel=2)
                self._async.cold_reset(self._iteration)
            if state.arrivals is None:
                state = dataclasses.replace(
                    state, arrivals=self._async.init_history(
                        state.server.params))
        self._restore_observability(payload, p.parent)
        # A checkpoint of a run without stragglers or error feedback,
        # resumed under them: start the ring or the residual cold (zeros),
        # as a fresh init does.
        rows = self.config.num_clients
        fr = self.fed_round
        if (self._state_store is None and getattr(state, "stale", None)
                is None and fr.faults is not None):
            state = dataclasses.replace(state, stale=fr.faults.init_stale_buffer(
                rows, self._num_params, self.device))
        if (self._state_store is None and getattr(state, "residual", None)
                is None and fr.codec is not None):
            state = dataclasses.replace(state, residual=fr.codec.init_residual(
                rows, self._num_params, self.device))
        self.state = state

    def _restore_observability(self, payload, ckpt_dir: Path) -> None:
        """The watchdog's windows, the controller's state (re-asserted on
        the engine where an older payload left its defaults) and the
        ledger's shards; a checkpoint without them starts each cold, with
        a warning."""
        if self._controller is not None:
            ctl = payload.get("control")
            if ctl:
                self._watchdog.restore_state(ctl.get("watchdog") or {})
                self._controller.restore(ctl.get("controller") or {})
                eng = self._async
                if eng is not None:
                    v = self._controller.values
                    want_k = v.get("window") or v.get("agg_every")
                    if want_k and int(want_k) != eng.agg_every:
                        eng.set_agg_every(int(want_k))
                    if (v.get("weight_cutoff") is not None
                            and int(v["weight_cutoff"]) != eng.weight_cutoff):
                        eng.set_weight_cutoff(int(v["weight_cutoff"]))
                    held = self._controller.quarantined_clients()
                    if held != eng.quarantine:
                        eng.set_quarantine(held)
            else:
                warnings.warn(
                    "checkpoint carries no control payload; the "
                    f"controller starts cold at round {self._iteration} "
                    "(the action journal before it is not recoverable)",
                    RuntimeWarning, stacklevel=2)
        if self._ledger is not None:
            if (ckpt_dir / "ledger" / "manifest.json").exists():
                self._ledger.load(ckpt_dir / "ledger")
            else:
                warnings.warn(
                    "checkpoint carries no ledger/ shards; the client "
                    f"ledger starts cold at round {self._iteration} "
                    "(longitudinal records before it are not "
                    "recoverable)", RuntimeWarning, stacklevel=2)

    def _restore_client_rows(self, state, payload, ckpt_dir: Path):
        """The client rows of a checkpoint into this run's layout: a
        store's shard files into this run's store (or, without one, into
        the resident stacks), and a resident checkpoint's stacks into
        this run's store."""
        saved = payload.get("state_store")
        store = self._state_store
        if store is not None:
            if self._state_pf is not None:
                self._state_pf.invalidate()
            self._window_prev = None
            if saved is not None:
                store.load(ckpt_dir / "client_state")
            else:
                rows = {}
                layout = FlatLayout(state.server.params)
                if state.client_opt is not None and "client_opt" in \
                        store.names:
                    rows["client_opt"] = layout.ravel_rows(state.client_opt)
                if state.residual is not None and "residual" in store.names:
                    rows["residual"] = state.residual
                if rows:
                    store.scatter(np.arange(store.n_registered), rows)
            return dataclasses.replace(state, client_opt=None, residual=None,
                                       cohort=None)
        if saved is not None:
            rows = read_checkpoint_rows(ckpt_dir / "client_state",
                                        saved["template"],
                                        saved["n_registered"])
            dev = self.device
            if "client_opt" in rows:
                state = dataclasses.replace(
                    state, client_opt=FlatLayout(
                        state.server.params).unravel_rows(
                            rows["client_opt"].to(dev)))
            if "residual" in rows:
                state = dataclasses.replace(
                    state, residual=rows["residual"].to(dev))
            state = dataclasses.replace(state, cohort=None)
        return state

    def evaluate(self) -> Dict:
        """Weighted per-client evaluation of the global model (under the
        memmap data store, streamed in ``eval_chunk_clients`` chunks)."""
        with self.timers.time("evaluate"):
            if self._streaming_eval:
                ev, self._eval_chunks = streaming_evaluate(
                    make_chunk_evaluator(self.fed_round.task),
                    self.state.server.params, self._test,
                    self.config.eval_chunk_clients, device=self.device)
            else:
                state = (self.state if self._topology is None
                         else node_head(self.state))
                ev = self.fed_round.evaluate(state, *self._test)
            self._last_eval = {k: float(ev[k]) for k in
                               ("test_loss", "test_acc", "test_acc_top3")}
            if self._streaming_eval:
                self._last_eval["eval_chunks"] = int(self._eval_chunks)
        return dict(self._last_eval)

    def stop(self) -> None:
        """Release the run's device memory and its stores (idempotent)."""
        if self._state_pf is not None:
            self._state_pf.close()
        for store in (self._state_store, self._data_pf, self._ledger):
            if store is not None:
                store.close()
        self._state_pf = self._state_store = self._data_pf = None
        self._ledger = None
        self._data_store = self._window_prev = None
        self.state = self._train = self._test = self._step = None
        self.malicious = self.fed_round = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
