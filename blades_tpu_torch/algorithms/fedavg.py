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
update matrix would take more than 3/8 of the device's memory.

Each round draws from a ``torch.Generator`` seeded by
``SeedSequence([seed, round])``, so a run is reproducible per seed on one
device (the draws are not the JAX package's).
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from blades_tpu_torch.adversaries import make_malicious_mask
from blades_tpu_torch.adversaries.base import forges
from blades_tpu_torch.data.datasets import DatasetCatalog
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
from blades_tpu_torch.utils.async_metrics import DEVICE_METRICS_KEY
from blades_tpu_torch.utils.async_metrics import fetch as fetch_tree
from blades_tpu_torch.utils.timers import Timers
from blades_tpu_torch.utils.tree import FlatLayout

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
        self.state = self.fed_round.init(cfg.seed, cfg.num_clients,
                                         device=dev)
        self._num_params = FlatLayout(self.state.server.params).d

        train = self.dataset.train
        x = torch.from_numpy(train.x)
        self._streamed = self._use_streamed()
        cd = self.fed_round.task.compute_dtype
        if self._streamed and cd is not None:
            # bf16 compute casts the inputs down anyway: keep the resident
            # training images in that dtype (half the memory at 1000
            # CIFAR clients, which the bf16 update matrix needs back).
            x = x.to(cd)
        self._train = (x.to(dev), torch.from_numpy(train.y).long().to(dev),
                       torch.from_numpy(train.lengths).long().to(dev))
        self._test = self._test_arrays()
        if self._streamed:
            self._step = streamed_step(
                self.fed_round, client_block=self._streamed_block(),
                update_dtype=_DTYPES[str(cfg.update_dtype)],
                malicious_prefix=cfg.num_malicious_clients,
                d_chunk=cfg.d_chunk, device=dev)
        else:
            self._step = self.fed_round.step
        self.timers = Timers(sync=dev.type == "cuda")
        self._chunk = max(1, int(cfg.rounds_per_dispatch))
        self._iteration = 0
        self._rounds_since_eval = 0
        self._last_eval: Dict = {}

    def _test_arrays(self):
        """The per-client test shards on the device, each subsampled to
        ``evaluation_num_samples`` rows (a seeded random subset of the
        client's true rows, as the reference draws it)."""
        cfg = self.config
        test = self.dataset.test
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
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(tx)).to(dev),
                torch.from_numpy(np.ascontiguousarray(ty)).long().to(dev),
                torch.from_numpy(np.asarray(tln)).long().to(dev))

    def dense_matrix_limit(self) -> int:
        """The 'auto' execution's budget for the dense f32 matrix."""
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            return int(total * self._DENSE_MATRIX_FRACTION)
        return self._DENSE_MATRIX_LIMIT

    def _streamed_supported(self) -> bool:
        fr = self.fed_round
        if not isinstance(fr.server.aggregator,
                          (Mean, Median, Trimmedmean) + STREAMED_ROW_AGGREGATORS):
            return False
        adv = fr.adversary
        if forges(adv) and not isinstance(
                adv, _COORDWISE_FORGERS + STREAMED_ROW_FORGERS):
            return False
        return not fr.task.spec.momentum

    def _use_streamed(self) -> bool:
        cfg = self.config
        if cfg.execution != "auto":
            return cfg.execution == "streamed"
        if not self._streamed_supported():
            return False
        return cfg.num_clients * self._num_params * 4 > self.dense_matrix_limit()

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
        ss = np.random.SeedSequence([int(self.config.seed), int(r)])
        return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)

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
        with self.timers.time("training_step"):
            # Each round draws from its own round seed, so K rounds of one
            # dispatch are exactly K single-round dispatches.
            for _ in range(self._chunk):
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
        # The rounds-since-eval cadence: a rounds_per_dispatch that does
        # not divide the interval still evaluates.
        if (self.config.evaluation_interval
                and self._rounds_since_eval >= self.config.evaluation_interval):
            self._rounds_since_eval = 0
            row.update(self.evaluate())
        elif self._last_eval:
            row.update(self._last_eval)
        return row

    def finalize_row(self, row: Dict) -> Dict:
        """A (possibly deferred) row's metrics in host form: the scalars of
        the dispatch's last round, the health counts reduced over all of
        its rounds (a lane that went non-finite mid-dispatch shows even if
        the last round recovered)."""
        raw = row.pop(DEVICE_METRICS_KEY, None)
        if raw is None:
            return row
        raw = fetch_tree(raw)
        for k in ("train_loss", "agg_norm", "update_norm_mean"):
            row[k] = float(raw[k][-1])
        for k in ("hbm_passes", "hbm_passes_unfused", "elided_lanes"):
            if k in raw:
                row[k] = int(raw[k][-1])
        if self.config.health_check:
            row["num_unhealthy"] = int(sum(raw["num_unhealthy"]))
            row["round_ok"] = bool(all(raw["round_ok"]))
        return row

    # -- checkpoints --------------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        """Write the resident state into ``checkpoint_dir``: the round
        counter, the eval cadence and the last evaluation, the
        :class:`~blades_tpu_torch.core.round.RoundState` (server parameters
        and optimizer state, aggregator state, client optimizer rows) and
        the config.  The round generators are pure in ``(seed, round)``,
        and neither round keeps state between rounds outside the
        ``RoundState``, so nothing else is needed to replay the run."""
        path = Path(checkpoint_dir)
        path.mkdir(parents=True, exist_ok=True)
        payload = {
            "iteration": self._iteration,
            "rounds_since_eval": self._rounds_since_eval,
            "last_eval": dict(self._last_eval),
            "state": self.state,
            "config_dict": {k: v for k, v in self.config.items()
                            if not callable(v)},
        }
        file = path / "algorithm_state.pkl"
        torch.save(payload, file)
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
        self.state = payload["state"]

    def evaluate(self) -> Dict:
        """Weighted per-client evaluation of the global model."""
        with self.timers.time("evaluate"):
            ev = self.fed_round.evaluate(self.state, *self._test)
            self._last_eval = {k: float(ev[k]) for k in
                               ("test_loss", "test_acc", "test_acc_top3")}
        return dict(self._last_eval)

    def stop(self) -> None:
        """Release the run's device memory (idempotent)."""
        self.state = self._train = self._test = self._step = None
        self.malicious = self.fed_round = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
