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

The execution autotuner (``autotune``, :mod:`blades_tpu_torch.perf.autotune`)
resolves the plan -- the ``tuned_plan`` pin, the plan cache's winner, a
measured selection on the card or the ranked heuristic off it -- and
writes it into the config's knobs before the pipeline is built;
:attr:`Fedavg.plan` / :attr:`Fedavg.plan_summary` hold it and its
provenance, and the rows carry ``plan_id``, ``autotune_cache_hit``,
``autotune_timed`` and ``autotune_candidates``.  A ``replan`` control
action re-resolves it on the dense path.  The dense and windowed rounds'
rows carry the kernel build cache's ``compile_cache_hits`` /
``compile_cache_misses``.  With ``prefetch`` on (on the card by default)
the dense single-round path draws round ``r+1``'s batches on a side
stream while round ``r`` computes
(:class:`~blades_tpu_torch.data.prefetch.BatchPrefetcher`).
:meth:`Fedavg.cost_analysis` counts one dispatch's operations and bytes.

With ``num_devices > 1`` the rounds run on the ranks of a
``torch.distributed`` process group, one process per rank
(:mod:`blades_tpu_torch.parallel.mesh`): each rank holds its lanes' data
and client state on its device (``cuda:{local_rank}``, or the device the
caller names) and runs the client-sharded dense round
(:func:`~blades_tpu_torch.parallel.sharded.sharded_step`) or, under
``execution="hier"``, the hierarchical round
(:func:`~blades_tpu_torch.parallel.hier.hier_step`, whose rows carry
``ici_bytes``, ``preagg_kept`` and ``mesh_shape``); the evaluation sums
the ranks' test shards.  Every rank computes every row; checkpoints
gather the client optimizer rows to rank 0, which alone writes, in the
one-process format (a resume on any number of ranks re-shards).  Where
the replicated ``(n, d)`` matrix would exceed the dense budget,
``execution="auto"`` raises: the width-sharded round is not ported.

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
import hashlib
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
from blades_tpu_torch.data.prefetch import BatchPrefetcher
from blades_tpu_torch.data.store import make_data_store
from blades_tpu_torch.data.stream import (
    DataPrefetcher,
    make_chunk_evaluator,
    streaming_evaluate,
)
from blades_tpu_torch.device import resolve_device
from blades_tpu_torch.ops.aggregators import Mean, Median, Trimmedmean
from blades_tpu_torch.parallel.mesh import rank_device
from blades_tpu_torch.parallel.streamed import (
    _COORDWISE_FORGERS,
    chunk_invariant,
    coordwise_route,
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
from blades_tpu_torch.perf import autotune as at
from blades_tpu_torch.perf import compile_cache
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
        self._multi = bool(config.num_devices and config.num_devices > 1)
        self.device = (rank_device(device) if self._multi
                       else resolve_device(device))
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
        # The execution autotuner writes its plan into the config's knobs
        # before anything below reads them.
        self._plan = self._plan_provenance = None
        if cfg.autotune_mode:
            self._plan, self._plan_provenance = self._resolve_autotune_plan()
            self._apply_plan(self._plan)
        self._chunk = max(1, int(cfg.rounds_per_dispatch))
        self._prefetcher = None
        self._mesh = self._hier_recorder = None
        if (self._multi and cfg.execution == "auto"
                and cfg.num_clients * self._num_params * 4
                > self.dense_matrix_limit(dev)):
            raise NotImplementedError(
                f"execution='auto' on num_devices={cfg.num_devices} resolves "
                "to the width-sharded round here (the replicated (n, d) "
                f"f32 matrix of {cfg.num_clients} x {self._num_params} "
                "exceeds the dense budget), which is not in the port yet "
                "(ROADMAP Queue A 9b); shrink the federation, or set "
                "execution='dense' or 'hier'")

        train = self.dataset.train
        self._host_train = (train.x, train.y, train.lengths)
        self._streamed = (not cohort and cfg.execution != "async"
                          and not self._multi and self._use_streamed())
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
            # On a mesh the stacks are cut to this rank's lanes on the
            # host first (the setup below), then moved.
            put = (lambda t: t) if self._multi else (lambda t: t.to(dev))
            self._train = (put(x), put(torch.from_numpy(train.y).long()),
                           put(torch.from_numpy(train.lengths).long()))
        # The memmap data plane keeps the test stack on the host too and
        # evaluates it in chunks.
        self._streaming_eval = (self._data_store is not None
                                and self._data_store.backend == "memmap")
        self._test = eval_arrays(cfg, self.dataset,
                                 "cpu" if self._multi else dev,
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
        elif self._multi:
            self._setup_mesh()
        elif self._streamed:
            self._step = streamed_step(
                self.fed_round, client_block=self._streamed_block(),
                update_dtype=_DTYPES[str(cfg.update_dtype)],
                malicious_prefix=cfg.num_malicious_clients,
                d_chunk=cfg.d_chunk, device=dev)
        else:
            self._setup_dense_pipeline()
        # The kernel build cache's counters ride the rows of the paths
        # whose JAX counterparts run an ahead-of-time compiled program.
        self._stamps_cache = (self._async is None and self._topology is None
                              and not self._streamed and self._mesh is None)
        self._setup_observability()
        self.timers = Timers(sync=dev.type == "cuda")
        self._iteration = 0
        self._rounds_since_eval = 0
        self._last_eval: Dict = {}

    def _setup_observability(self) -> None:
        """The client ledger (one record per registered client) and the
        control plane: the driver's own watchdog over finished rows and a
        controller whose actions move the async engine's actuators (the
        synchronous driver has one, the replan, which re-resolves the
        autotuned plan on the dense path)."""
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
            # A replan is the synchronous driver's one actuator; the
            # windowed store and prefetcher are not rebuilt mid-run.
            self._controller = Controller(
                cfg.get_control_policy(), num_clients=cfg.num_clients,
                allow_replan=bool(cfg.autotune_mode
                                  and self._state_pf is None))
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

    def _setup_mesh(self) -> None:
        """The rounds on the process group's ranks: this rank's lanes of
        the state, the training and the test stacks on its device, the
        sharded round or the hierarchical one, and the ranks' evaluation."""
        from blades_tpu_torch.parallel import (
            hier_step,
            make_mesh,
            shard_federation,
            sharded_step,
        )
        from blades_tpu_torch.parallel.mesh import local_lanes
        from blades_tpu_torch.parallel.sharded import sharded_evaluate

        cfg, dev, fr = self.config, self.device, self.fed_round
        self._mesh = make_mesh(cfg.num_devices, cfg.mesh_shape)
        self.state, train = shard_federation(self._mesh, self.state,
                                             self._train)
        self._train = tuple(a.to(dev) for a in train)
        self._test = tuple(local_lanes(self._mesh, a).to(dev)
                           for a in self._test)
        if cfg.execution == "hier":
            self._step, self._hier_recorder = hier_step(
                fr, self._mesh, preagg=cfg.preagg,
                bucket_size=int(cfg.bucket_size))
        else:
            self._step = sharded_step(fr, self._mesh)
        self._mesh_evaluate = sharded_evaluate(fr, self._mesh)

    @property
    def mesh(self):
        """The :class:`~blades_tpu_torch.parallel.mesh.Mesh` of a
        multi-rank run, or None."""
        return self._mesh

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

    def _setup_dense_pipeline(self) -> None:
        """The dense round, with the next round's batches staged while a
        round computes when ``prefetch`` resolves on (single-round
        dispatches only)."""
        if self._prefetcher is not None:
            self._prefetcher.close()
        self._prefetcher = None
        self._step = self.fed_round.step
        if self._chunk == 1 and self._resolve_prefetch():
            self._prefetcher = BatchPrefetcher(
                lambda gen: self.fed_round.sample_round_batches(
                    *self._train, gen),
                self.round_seed, self.device)

    def _resolve_prefetch(self) -> bool:
        """Whether ``prefetch`` resolves on: ``"auto"`` is on on the card
        (the JAX package's baseline: on off the CPU)."""
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
                elif self._prefetcher is not None:
                    r = self._iteration
                    gen, bx, by = self._prefetcher.take(r)
                    self._prefetcher.stage(r + 1)
                    self.state, m = self.fed_round.step_prebatched(
                        self.state, bx, by, self.malicious, gen)
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
        if self._stamps_cache:
            stats = compile_cache.cache_stats()
            row["compile_cache_hits"] = int(stats["hits"])
            row["compile_cache_misses"] = int(stats["misses"])
        if self._plan is not None:
            # Static per trial: the plan and how it was selected (the
            # candidates' timings ride the sweep summary).
            prov = self._plan_provenance or {}
            row["plan_id"] = self._plan.plan_id
            row["autotune_cache_hit"] = bool(prov.get("cache_hit"))
            row["autotune_timed"] = bool(prov.get("timed"))
            row["autotune_candidates"] = len(prov.get("candidates") or [])
        # The rounds-since-eval cadence: a rounds_per_dispatch that does
        # not divide the interval still evaluates.
        if (self.config.evaluation_interval
                and self._rounds_since_eval >= self.config.evaluation_interval):
            self._rounds_since_eval = 0
            row.update(self.evaluate())
        elif self._last_eval:
            row.update(self._last_eval)
        return row

    def train_rows(self, per_round: bool = False) -> list:
        """One dispatch as result rows: ``[self.train()]``, or with
        ``per_round`` and ``rounds_per_dispatch > 1`` one row per FL round
        (the sweep's scan windows): each carries its own round's metrics
        and the dispatch's static fields; rows before the window's last
        carry the previous evaluation, the last one what the dispatch
        attached."""
        if not per_round or self._chunk == 1:
            return [self.train()]
        prev_eval = dict(self._last_eval)
        start = self._iteration
        tail = self.train_raw()
        raw = tail.pop(DEVICE_METRICS_KEY)
        eval_keys = {k: tail.pop(k) for k in
                     ("test_loss", "test_acc", "test_acc_top3", "eval_chunks")
                     if k in tail}
        for k in prev_eval:
            tail.pop(k, None)
        rows = []
        for r in range(self._chunk):
            row = dict(tail, training_iteration=start + r + 1)
            row[DEVICE_METRICS_KEY] = {k: [v[r]] for k, v in raw.items()}
            row.update(eval_keys if r == self._chunk - 1 else prev_eval)
            rows.append(self.finalize_row(row))
        return rows

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
        if "ici_bytes" in raw:
            # The hierarchical round's wire bytes and matrix height, and
            # the ranks' layout.
            row["ici_bytes"] = int(raw["ici_bytes"][-1])
            row["preagg_kept"] = int(raw["preagg_kept"][-1])
            c, dd = self._mesh.shape
            row["mesh_shape"] = f"{int(c)}x{int(dd)}"
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
        """Move the actuator of one journaled action: a ``replan``
        re-resolves the autotuned plan (:meth:`_replan_runtime`; the
        controller offers one only to an autotuned synchronous run), the
        others move the async engine's setters.  An engine that refuses
        the move warns: the journal keeps the intent."""
        eng = self._async
        if act.actuator == "replan":
            self._replan_runtime()
            return
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

    # -- the execution autotuner (perf/autotune.py) --------------------------

    def _d_chunk_exact(self) -> bool:
        """Whether the streamed finish's result is invariant to the
        ``d_chunk`` partition bit for bit (the JAX package's gate,
        :func:`~blades_tpu_torch.parallel.streamed.chunk_invariant`)."""
        return chunk_invariant(self.fed_round)

    def _takes_chunked_finish(self) -> bool:
        """Whether the streamed round takes the chunked finish, the one
        route that reads ``d_chunk`` (the fused finish's kernel covers the
        whole buffer): the port's gate on the chunk ladder."""
        cfg = self.config
        route, _ = coordwise_route(
            self.fed_round, cfg.num_clients,
            client_block=self._streamed_block(),
            update_dtype=_DTYPES[str(cfg.update_dtype)],
            malicious_prefix=cfg.num_malicious_clients)
        return route == "chunked"

    def _plan_space(self, allow_reassociating: bool):
        """This trial's legal execution plans
        (:func:`~blades_tpu_torch.perf.autotune.enumerate_plans`), each
        knob's list ordered current-resolution first and collapsed to one
        entry where the user set the knob, as the JAX package enumerates
        them; the port offers no MXU finish, and the ``d_chunk`` ladder
        only where the round takes the chunked finish."""
        cfg = self.config
        explicit = getattr(cfg, "_explicit", set()) or set()
        baseline_streamed = self._use_streamed()
        windowed = self._windowed
        stateless = bool(getattr(self.fed_round, "stateless_clients", False))
        dense_features = (cfg.forensics or cfg.fault_config
                          or cfg.codec_config or windowed or stateless)
        packing = self.fed_round.packing
        base_pack = int(packing.pack) if packing is not None else 1
        dense_bytes = cfg.num_clients * self._num_params * 4

        if cfg.execution in ("dense", "streamed"):
            execs = [cfg.execution]
        else:
            execs = ["streamed" if baseline_streamed else "dense"]
            if allow_reassociating:
                if (baseline_streamed and not dense_features
                        and dense_bytes
                        <= self.dense_matrix_limit(self.device)):
                    execs.append("dense")
                elif (not baseline_streamed and self._streamed_supported()
                      and not dense_features and base_pack == 1):
                    execs.append("streamed")
        streamed_in_space = "streamed" in execs

        d_chunks = [int(cfg.d_chunk)]
        if (streamed_in_space and "d_chunk" not in explicit
                and self._d_chunk_exact() and self._takes_chunked_finish()):
            seen = {min(int(cfg.d_chunk), self._num_params)}
            for c in at.D_CHUNK_LADDER:
                eff = min(int(c), self._num_params)
                if eff not in seen:
                    seen.add(eff)
                    d_chunks.append(int(c))

        packs = [base_pack]
        if (allow_reassociating and "dense" in execs and not windowed
                and not isinstance(cfg.client_packing, int)
                and (cfg.client_packing == "auto"
                     or "client_packing" not in explicit)):
            from blades_tpu_torch.parallel.packed import (
                resolve_client_packing,
            )

            for p in (1, 2, 4, 8):
                if p in packs or cfg.num_clients % p:
                    continue
                if p == 1:
                    packs.append(1)
                    continue
                try:
                    stripped = dataclasses.replace(self.fed_round,
                                                   packing=None)
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        _, dec = resolve_client_packing(
                            stripped, p, num_clients=cfg.num_clients,
                            execution="dense")
                except Exception:
                    continue
                if dec and int(dec.get("pack_factor", 1)) == p:
                    packs.append(p)

        rpd = int(cfg.rounds_per_dispatch or 1)
        windows = ([rpd] if rpd != 1 else
                   [int(w) for w in (cfg._autotune_windows or (1,))])

        base_pre = self._resolve_prefetch()
        prefetch_options = [base_pre]
        if cfg.prefetch == "auto" and "prefetch" not in explicit:
            prefetch_options.append(not base_pre)

        agg_domains = [cfg.agg_domain]
        if (allow_reassociating and "dense" in execs and not windowed
                and "agg_domain" not in explicit
                and cfg.agg_domain == "f32" and cfg.codec_config
                and not (cfg.fault_config or cfg.health_check
                         or cfg.forensics or cfg.dp_clip_threshold)):
            from blades_tpu_torch.parallel.streamed_geometry import (
                WIRE_AGGREGATORS,
            )

            codec = cfg.get_codec()
            if (codec is not None and codec.supports_deferred
                    and codec.name != "identity"
                    and isinstance(self.fed_round.server.aggregator,
                                   WIRE_AGGREGATORS)):
                agg_domains.append("wire")

        state_stores = [cfg.state_store]
        if (allow_reassociating and windowed
                and "state_store" not in explicit):
            for alt in ("host", "resident"):
                if alt not in state_stores:
                    state_stores.append(alt)

        return at.enumerate_plans(
            executions=execs, d_chunks=d_chunks, mxu_modes=[""],
            pack_factors=packs, scan_windows=windows,
            prefetch_options=prefetch_options, agg_domains=agg_domains,
            state_stores=state_stores,
            state_windows=[cfg.state_window],
            allow_reassociating=allow_reassociating)

    def _program_fingerprint(self) -> Optional[str]:
        """The config fields that steer the program, digested (the plan
        cache's key): every field but ``seed`` and the autotune request,
        a dataset object by its name, FLTrust's root data by value;
        ``None`` where a field holds a value no stable digest captures (a
        callable, an object)."""

        def plain(v) -> bool:
            if isinstance(v, (str, int, float, bool, type(None))):
                return True
            if isinstance(v, (list, tuple)):
                return all(plain(x) for x in v)
            if isinstance(v, dict):
                return all(isinstance(k, str) and plain(x)
                           for k, x in v.items())
            return False

        items: Dict = {"__class__": type(self).__name__,
                       "__augment__": str(self.fed_round.task.spec.augment)}
        for k, v in self.config.items():
            if k in ("seed", "autotune", "autotune_cache_dir", "tuned_plan"):
                continue
            if k == "dataset" and not isinstance(v, (str, dict)):
                v = f"<dataset:{getattr(v, 'name', type(v).__name__)}>"
            if not plain(v):
                return None
            items[k] = v
        td = self.fed_round.trusted_data
        if td is not None:
            h = hashlib.sha1()
            for a in td:
                h.update(a.detach().cpu().numpy().tobytes())
            items["__trusted_digest__"] = h.hexdigest()
        return compile_cache.fingerprint(items)

    def _select(self, space):
        """The measured selection on the card (each candidate its own
        driver, stopped before the next), the ranked heuristic off it."""
        measure = (at.timed_measure_fn(self.config, device=self.device)
                   if at.timing_available(self.device) else None)
        plan, prov = at.select_plan(space, measure_fn=measure)
        self.candidate_peaks = dict(getattr(measure, "peaks", {}) or {})
        return plan, prov

    def _resolve_autotune_plan(self):
        """This trial's plan: the ``tuned_plan`` pin, the plan cache's
        winner (when it is still in this run's space), or a selection
        (then cached).  Returns ``(Plan, provenance)``."""
        cfg = self.config
        mode = cfg.autotune_mode
        self.candidate_peaks = {}
        if cfg.tuned_plan:
            plan = at.Plan.from_dict(cfg.tuned_plan)
            return plan, {
                "mode": "pinned", "timed": False, "cache_hit": False,
                "winner": plan.as_dict(), "winner_id": plan.plan_id,
                "candidates": [], "truncated": 0,
            }
        space = self._plan_space(
            allow_reassociating=(mode == "reassociating"))
        cache = at.PlanCache(cfg.autotune_cache_dir)
        fp = self._program_fingerprint()
        key = at.cache_key(fp, tier=mode) if fp else None
        cache_stale = False
        if key is not None:
            entry = cache.get(key)
            if entry is not None:
                plan = at.Plan.from_dict(entry["plan"])
                if plan in space.candidates:
                    prov = dict(entry.get("provenance") or {})
                    prov.update({"mode": "cache", "cache_hit": True,
                                 "winner": plan.as_dict(),
                                 "winner_id": plan.plan_id})
                    return plan, prov
                # The cached winner is outside this run's space (another
                # round budget's scan windows): re-tune and overwrite.
                cache_stale = True
        plan, prov = self._select(space)
        if cache_stale:
            prov["cache_stale"] = True
        if key is not None:
            cache.put(key, plan, prov)
        return plan, prov

    def _apply_plan(self, plan) -> None:
        """Write the plan into the config's knobs, and re-resolve lane
        packing where its pack factor differs from the round's."""
        cfg = self.config
        at.apply_plan(cfg, plan)
        packing = self.fed_round.packing
        cur = int(packing.pack) if packing is not None else 1
        want = int(plan.client_packing or 1)
        if want == cur:
            return
        fr = dataclasses.replace(self.fed_round, packing=None)
        if want >= 2:
            from blades_tpu_torch.parallel.packed import (
                resolve_client_packing,
            )

            fr, decision = resolve_client_packing(
                fr, want, num_clients=cfg.num_clients,
                execution=plan.execution)
            cfg._packing_decision = decision
        else:
            cfg._packing_decision = {
                "requested": cfg.client_packing, "pack_factor": 1,
                "packed_lanes": cfg.num_clients,
                "fallback": "autotune plan selected unpacked execution",
            }
        self.fed_round = fr

    def _replan_runtime(self) -> None:
        """Re-run the autotuner and rebuild the dense pipeline when the
        winner changed (the synchronous dense path only: autotune is
        refused with async and gossip, and the windowed store is not
        rebuilt mid-run)."""
        cfg = self.config
        if (not cfg.autotune_mode or self._async is not None
                or self._state_pf is not None or self._topology is not None):
            return
        space = self._plan_space(
            allow_reassociating=(cfg.autotune_mode == "reassociating"))
        plan, prov = self._select(space)
        prov["mode"] = "replan"
        self._plan_provenance = prov
        if self._plan is not None and plan.as_dict() == self._plan.as_dict():
            return  # the standing plan won again
        if plan.execution == "streamed" or self._streamed:
            warnings.warn("replan resolved a streamed plan mid-run; "
                          "keeping the standing pipeline",
                          RuntimeWarning, stacklevel=2)
            return
        self._plan = plan
        self._apply_plan(plan)
        self._chunk = max(1, int(cfg.rounds_per_dispatch))
        self._setup_dense_pipeline()

    @property
    def plan(self):
        """The resolved :class:`~blades_tpu_torch.perf.autotune.Plan`, or
        None when autotune is off."""
        return self._plan

    @property
    def plan_summary(self) -> Optional[Dict]:
        """The autotuner's provenance for sweep summaries (mode, the
        candidates' medians, the winner, the cache hit), or None when
        autotune is off."""
        return self._plan_provenance

    def cost_analysis(self) -> Optional[Dict]:
        """The operations and bytes of ONE dispatch, counted: ``{"flops":
        ..., "bytes_accessed": ...}``.  The dispatch runs on a copy of the
        state at the current round's seed; aten operations count by
        ``torch.utils.flop_counter``'s formulas and their operands' bytes
        (views move nothing), the hand-written kernels by what their
        bounds count (``ops/_cuda.py::COST``).  A count, not a compiler
        estimate.  Memoized; the trial's state, round counter and launch
        counts are left as they were; ``None`` (never an exception) where
        the path has no single dispatch to count (async, the window).
        ``cost_by_op`` then holds the flops by aten operation (and the
        hand-written kernels' as ``"cuda kernels"``).  A grouped
        convolution's weight gradient (a vmapped client block is one)
        counts its own products (:func:`_conv_backward_flop`)."""
        if hasattr(self, "_cost_analysis"):
            return self._cost_analysis
        cost = None
        if self._step is not None and self._state_pf is None:
            from blades_tpu_torch.ops import _cuda

            launches, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
            routes = dict(getattr(self._step, "routes", {}) or {})
            try:
                cost = _count_dispatch(self)
            except Exception:
                cost = None
            finally:
                _cuda.COST = None
                _cuda.LAUNCHES.clear()
                _cuda.LAUNCHES.update(launches)
                _cuda.MAPS.clear()
                _cuda.MAPS.update(maps)
                if hasattr(self._step, "routes"):
                    self._step.routes.clear()
                    self._step.routes.update(routes)
        self._cost_analysis = cost
        return cost

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
        client)``, so nothing else is needed to replay the run.  On a mesh
        every rank calls it (the client rows are gathered) and rank 0
        alone writes."""
        path = Path(checkpoint_dir)
        state = self.state
        if self._mesh is not None:
            state = self._gathered_state()
            if self._mesh.rank != 0:
                return str(path / "algorithm_state.pkl")
        path.mkdir(parents=True, exist_ok=True)
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
            # The plan the checkpoint was written under: the sweep pins it
            # back (config.tuned_plan) before a retry or resume rebuilds.
            "plan": (self._plan.as_dict() if self._plan is not None
                     else None),
            "control": (None if self._controller is None else {
                "watchdog": self._watchdog.state(),
                "controller": self._controller.state()}),
        }
        file = path / "algorithm_state.pkl"
        torch.save(payload, file)
        if self._ledger is not None:
            self._ledger.save(path / "ledger")
        return str(file)

    def _gathered_state(self):
        """The state with every rank's client optimizer rows gathered
        into the whole federation's stacks (ghost lanes dropped): the
        one-process layout."""
        from blades_tpu_torch.parallel.mesh import all_gather_rows

        opt = self.state.client_opt
        if opt is None:
            return self.state
        n = self.config.num_clients
        return dataclasses.replace(self.state, client_opt={
            k: all_gather_rows(self._mesh, v)[:n] for k, v in opt.items()})

    def load_checkpoint(self, checkpoint_path: str) -> None:
        """Restore what :meth:`save_checkpoint` wrote (a checkpoint
        directory or its file) onto this driver's device."""
        p = Path(checkpoint_path)
        if p.is_dir():
            p = p / "algorithm_state.pkl"
        payload = torch.load(p, map_location=self.device, weights_only=False)
        saved_plan = payload.get("plan")
        cur_plan = self._plan.as_dict() if self._plan is not None else None
        if saved_plan is not None and saved_plan != cur_plan:
            warnings.warn(
                f"checkpoint was written under execution plan {saved_plan} "
                f"but this instance resolved {cur_plan}; pin the saved plan "
                "via FedavgConfig.resources(tuned_plan=...) to replay it "
                "identically", RuntimeWarning, stacklevel=2)
        if self._prefetcher is not None:
            self._prefetcher.invalidate()
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
        if self._mesh is not None and state.client_opt is not None:
            # The checkpoint holds the whole federation's rows: re-shard.
            from blades_tpu_torch.parallel.mesh import local_lanes

            state = dataclasses.replace(state, client_opt={
                k: local_lanes(self._mesh, v)
                for k, v in state.client_opt.items()})
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
            elif self._mesh is not None:
                ev = self._mesh_evaluate(self.state, *self._test)
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
        if self._prefetcher is not None:
            self._prefetcher.close()
        self._prefetcher = None
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


def _conv_backward_flop(*args, out_val=None, **kwargs) -> int:
    """``torch.utils.flop_counter``'s convolution-backward formula with the
    weight gradient divided by ``groups``: the library counts a grouped
    convolution's weight gradient as if every input channel met every
    output channel, ``groups`` times its products (a vmapped client block
    of G clients is a convolution of G groups).  Takes the operation's own
    arguments (``aten.convolution_backward``'s)."""
    from torch.utils.flop_counter import conv_backward_flop

    head, groups, mask, rest = args[:9], args[9], args[10], args[11:]
    grad_input = conv_backward_flop(*head, groups, [mask[0], False, False],
                                    *rest, out_val=out_val, **kwargs)
    grad_weight = conv_backward_flop(*head, groups, [False, mask[1], False],
                                     *rest, out_val=out_val, **kwargs)
    return grad_input + grad_weight // max(1, int(groups))


_conv_backward_flop._get_raw = True  # FlopCounterMode passes the operands


def _count_dispatch(algo) -> Dict:
    """Run one dispatch of ``algo``'s round on a copy of its state at the
    current round's seed, counting operations and bytes (see
    :meth:`Fedavg.cost_analysis`)."""
    import copy

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    from blades_tpu_torch.ops import _cuda

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                leaves, _ = tree_flatten((args, kwargs, out))
                self.total += sum(t.numel() * t.element_size()
                                  for t in leaves if torch.is_tensor(t))
            return out

    state = copy.deepcopy(algo.state)
    _cuda.COST = kernels = {"bytes": 0, "flops": 0}
    flops = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flop})
    nbytes = _Bytes()
    with flops, nbytes:
        for r in range(algo._chunk):
            seed = algo.round_seed(algo.iteration + r)
            if algo._prefetcher is not None:
                gen = torch.Generator(device=algo.device)
                gen.manual_seed(int(seed))
                bx, by = algo.fed_round.sample_round_batches(*algo._train,
                                                             gen)
                state, _ = algo.fed_round.step_prebatched(
                    state, bx, by, algo.malicious, gen)
            else:
                state, _ = algo._step(state, *algo._train, algo.malicious,
                                      seed)
    if algo.device.type == "cuda":
        torch.cuda.synchronize(algo.device)
    del state
    by_op = {str(op): int(n) for op, n in
             flops.get_flop_counts().get("Global", {}).items()}
    by_op["cuda kernels"] = int(kernels["flops"])
    algo.cost_by_op = by_op
    return {"flops": float(flops.get_total_flops() + kernels["flops"]),
            "bytes_accessed": float(nbytes.total + kernels["bytes"])}
