"""Divergence flight recorder: the last K rounds, durable on failure
(counterpart of ``blades_tpu/obs/flightrec.py``; the dump format is the
JAX package's, so either package's :func:`validate_flightrec` reads the
other's dumps).

Without it a failed trial leaves nothing behind but a truncated
``metrics.jsonl`` — no answer to *which round* diverged, *what the
update matrix looked like*, or *how to re-execute it*.  The recorder
keeps a bounded host-side ring of per-round digests
(the finalized metrics row: norms, aggregate norm, diagnose masks,
fault realization, codec stats — whatever the round produced) plus the
RNG provenance that makes the trajectory a pure function of config:
the trial seed and the round tick.  On a trigger it dumps the ring
atomically (``faults/host.atomic_write_json``: tmp + fsync +
``os.replace``) to ``flightrec.json`` in the trial directory.

Triggers (all host-side, zero extra device syncs — they read the
already-fetched row):

- **non-finite aggregate** (:meth:`FlightRecorder.check`): ``agg_norm``
  / ``train_loss`` / ``update_norm_mean`` NaN or Inf;
- **watchdog event** (:mod:`blades_tpu_torch.obs.watchdog` rules firing);
- **uncaught exception / preemption** (the sweep's trial fault handler
  calls :meth:`dump` before retry/abort; ``SimulatedPreemption`` rides
  the same path).

Replay contract: every execution path is deterministic in
``(config, seed)`` on one device — the fault stream is pure in
``(fault_seed, round)`` and round ``r`` draws from a generator seeded by
``SeedSequence([seed, r])`` — so a replay rebuilds the config from the
dump, re-runs to the recorded tick and compares the digest.  No model
state needs to ride the dump.  ``python -m
blades_tpu_torch.tools.replay_round <flightrec.json>`` replays a port
dump through the port's driver (the JAX package's
``tools/replay_round.py`` replays JAX dumps).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

FLIGHTREC_VERSION = 1

#: Row fields whose non-finiteness marks the round as diverged.
_FINITE_FIELDS = ("agg_norm", "train_loss", "update_norm_mean")

#: Digest fields a replay compares bit-for-bit:
#: deterministic outputs of the round, never wall-clock.  The async
#: ingest fields are deterministic too (virtual-tick clock, pure
#: arrival realizations) — only updates_per_sec, the one wall-clock
#: stamp, is deliberately absent.
REPLAY_FIELDS = (
    "train_loss", "agg_norm", "update_norm_mean",
    "num_participating", "num_straggled", "num_dropped",
    "num_unhealthy", "byz_precision", "byz_recall", "byz_fpr",
    "num_flagged",
    "tick", "staleness_mean", "staleness_max", "buffer_fill",
    "buffer_overflow", "arrivals_dropped",
    # Client-ledger fleet fields (obs/ledger.py) — pure functions of
    # the diagnosis stream, so replay reproduces them bit-for-bit.
    "suspected_fraction", "flagged_churn", "reputation_p10",
    "reputation_p50", "reputation_p90", "ledger_clients_seen",
    # Control plane (blades_tpu_torch/control): the deterministic ingest
    # sensor and the controller's journal/quarantine telemetry — all
    # pure in (config, seed, event stream), so a replayed controlled
    # trajectory reproduces them bit-for-bit.
    "cycle_ticks", "arrivals_quarantined", "control_actions_total",
    "quarantine_size",
    # The decentralized gossip round (blades_tpu_torch/topology): the
    # edge-dropout realization is pure in (fault_seed, round) and the
    # peer graph in topology_config, so these replay bit-for-bit too.
    "gossip_ici_bytes", "num_partitioned_nodes", "consensus_dist",
    "spectral_gap", "graph_seed",
)

#: Wall-clock / run-shape fields dropped from digests — they vary run to
#: run and would bloat every dump.
_DIGEST_DROP = ("timers", "watchdog_events")


def _config_seed(config: Dict[str, Any]) -> int:
    """The training seed as a trial-config dict spells it (flat ``seed``
    or the nested ``dataset_config.seed`` the YAML surface uses)."""
    if isinstance(config.get("seed"), int):
        return config["seed"]
    dc = config.get("dataset_config")
    if isinstance(dc, dict) and isinstance(dc.get("seed"), int):
        return dc["seed"]
    return 0


class FlightRecorder:
    """Bounded ring of round digests + atomic dump-on-trigger.

    One recorder per trial.  ``record()`` every finalized row;
    ``check()`` the row for divergence (returns a trigger dict or
    None); ``dump()`` on any trigger.  Dumps are rate-limited per
    trigger kind (a 2000-round all-NaN run must not rewrite the file
    2000 times) except terminal kinds (exception / preemption), which
    always rewrite so the dump carries the freshest ring.
    """

    _ALWAYS_DUMP_KINDS = ("exception", "preemption")

    def __init__(self, path, capacity: int = 16, *,
                 experiment: Optional[str] = None,
                 trial: Optional[str] = None,
                 algo: Optional[str] = None,
                 config: Optional[Dict] = None,
                 max_rounds: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = path
        self.capacity = int(capacity)
        self.experiment = experiment
        self.trial = trial
        self.algo = algo
        self.config = dict(config or {})
        self.max_rounds = max_rounds
        self._ring: deque = deque(maxlen=self.capacity)
        self._dumped_kinds: set = set()
        self.dumps = 0
        # Optional ClientLedger handle (obs/ledger.py): when the sweep
        # attaches one, every dump carries the fleet fingerprint
        # (ledger.digest(): seen/flagged totals + column CRC32) so a
        # forensic dump identifies WHICH longitudinal state it was
        # taken against, not just which round.
        self.ledger = None

    # -- recording -----------------------------------------------------------

    def record(self, row: Dict[str, Any]) -> None:
        """Append one finalized row's digest to the ring."""
        self._ring.append({k: v for k, v in row.items()
                           if k not in _DIGEST_DROP})

    def rewind(self, rows) -> None:
        """Checkpoint-restore support: rebuild the ring from the
        TRUNCATED on-disk rows (the surviving trajectory) and re-arm the
        per-kind dump rate limit.  Without this, a retry would append
        re-executed rounds after the failed attempt's stale digests —
        out-of-order ticks the validator rejects and replay refuses."""
        self._ring.clear()
        self._dumped_kinds.clear()
        for row in rows:
            self.record(row)

    def check(self, row: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The non-finite-aggregate trigger: a NaN/Inf in any of the
        round's scalar health fields."""
        for field in _FINITE_FIELDS:
            v = row.get(field)
            if isinstance(v, (int, float)) and not math.isfinite(v):
                return {"kind": "nonfinite", "field": field,
                        "value": float(v),
                        "round": row.get("training_iteration")}
        return None

    # -- dumping -------------------------------------------------------------

    def dump(self, trigger: Dict[str, Any]) -> Optional[str]:
        """Atomically publish the ring to ``flightrec.json``; returns
        the path, or None when this trigger kind already dumped (rate
        limit — terminal kinds always dump)."""
        kind = str(trigger.get("kind", "unknown"))
        if kind in self._dumped_kinds \
                and kind not in self._ALWAYS_DUMP_KINDS:
            return None
        self._dumped_kinds.add(kind)
        from blades_tpu_torch.faults.host import atomic_write_json

        self.dumps += 1
        return atomic_write_json(self.as_dump(trigger), self.path)

    def as_dump(self, trigger: Dict[str, Any]) -> Dict[str, Any]:
        ledger_digest = None
        if self.ledger is not None:
            try:
                ledger_digest = self.ledger.digest()
            except Exception as exc:  # a torn ledger must not lose the dump
                ledger_digest = {"error": f"{type(exc).__name__}: {exc}"}
        return {
            "version": FLIGHTREC_VERSION,
            "experiment": self.experiment,
            "trial": self.trial,
            "algo": self.algo,
            "trigger": dict(trigger),
            # RNG provenance: with `config` (which carries the training
            # seed and any fault seed) this is everything replay needs —
            # round r's keys are the r-th links of the split chain of
            # PRNGKey(seed), and fault realizations are pure in
            # (fault_seed, round).
            "rng": {
                "seed": _config_seed(self.config),
                "tick": (self._ring[-1].get("training_iteration")
                         if self._ring else None),
                "discipline": "round r draws from "
                              "SeedSequence([seed, r])",
            },
            "max_rounds": self.max_rounds,
            "config": self.config,
            "capacity": self.capacity,
            "ledger": ledger_digest,
            "rounds": list(self._ring),
        }


# ---------------------------------------------------------------------------
# offline validation
# ---------------------------------------------------------------------------


def validate_flightrec(path) -> Tuple[int, List[str]]:
    """Schema-check a flight-recorder dump: returns ``(num_rounds,
    errors)``.  Matches the metrics.jsonl torn-write contract: an
    unreadable/torn file is ONE reported error, never an exception.
    (Dumps are written atomically, so a torn ``flightrec.json`` means
    the artifact was produced by something else — report, don't crash.)
    """
    import json

    errors: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        return 0, [f"unreadable flightrec JSON: {exc}"]
    if not isinstance(doc, dict):
        return 0, ["flightrec dump must be a JSON object"]
    if doc.get("version") != FLIGHTREC_VERSION:
        errors.append(f"unknown version {doc.get('version')!r} "
                      f"(expected {FLIGHTREC_VERSION})")
    trigger = doc.get("trigger")
    if not isinstance(trigger, dict) or "kind" not in trigger:
        errors.append("trigger must be an object with a 'kind'")
    rng = doc.get("rng")
    if not isinstance(rng, dict) or not isinstance(rng.get("seed"), int):
        errors.append("rng must be an object with an int 'seed'")
    if not isinstance(doc.get("config"), dict):
        errors.append("config must be an object")
    rounds = doc.get("rounds")
    if not isinstance(rounds, list):
        errors.append("rounds must be a list")
        rounds = []
    for i, r in enumerate(rounds):
        if not isinstance(r, dict):
            errors.append(f"rounds[{i}]: not an object")
        elif not isinstance(r.get("training_iteration"), int):
            errors.append(f"rounds[{i}]: missing int training_iteration")
    ticks = [r.get("training_iteration") for r in rounds
             if isinstance(r, dict)
             and isinstance(r.get("training_iteration"), int)]
    if ticks != sorted(ticks):
        errors.append("rounds are not in ascending tick order")
    return len(rounds), errors
