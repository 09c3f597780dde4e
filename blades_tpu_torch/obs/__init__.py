"""Observability (counterpart of ``blades_tpu/obs``): forensics, metrics,
tracing, flight recording, the watchdog and the client ledger.

- **forensics** (:mod:`.forensics`): every aggregator's per-lane
  keep/trim/trust decision (``Aggregator.diagnose``), scored against the
  malicious-lane mask in the round, on the card: detection
  precision/recall/FPR per round; a forensics-off round runs none of it.
- **metrics** (:mod:`.metrics`, :mod:`.schema`): a ``MetricsLogger``
  with JSONL / CSV / stdout sinks writing one schema-validated record per
  round, wired into :func:`blades_tpu_torch.tune.sweep.run_experiments`.
- **spans** (:mod:`.trace`): the host span tree (sweep -> trial -> round
  -> phase) with ``torch.profiler`` correlation and Chrome/Perfetto
  export per trial (``--trace-dir``).
- **flight recorder** (:mod:`.flightrec`): a bounded ring of the last K
  rounds' digests, dumped atomically to ``flightrec.json`` on a NaN
  aggregate, an exception or a preemption.
- **watchdog** (:mod:`.watchdog`): schema-driven rules over the fetched
  rows (NaN aggregate, norm spike, FPR collapse, rounds/s regression),
  emitting ``watchdog_events`` and triggering the flight-recorder dump.
- **client ledger** (:mod:`.ledger`): one longitudinal record per
  registered client, updated on the host from the cohort-indexed
  diagnosis lanes, with resident and disk-memmap backends and shard
  checkpoints in the JAX package's format.
"""

from blades_tpu_torch.obs.flightrec import (  # noqa: F401
    FlightRecorder,
    validate_flightrec,
)
from blades_tpu_torch.obs.forensics import detection_metrics  # noqa: F401
from blades_tpu_torch.obs.ledger import (  # noqa: F401
    ClientLedger,
    DiskLedger,
    LedgerError,
    ResidentLedger,
    make_ledger,
    read_ledger,
    validate_ledger_checkpoint,
)
from blades_tpu_torch.obs.metrics import (  # noqa: F401
    CsvSink,
    JsonlSink,
    MetricsLogger,
    Sink,
    StdoutSink,
)
from blades_tpu_torch.obs.schema import (  # noqa: F401
    ROUND_RECORD_FIELDS,
    SchemaError,
    validate_jsonl,
    validate_record,
)
from blades_tpu_torch.obs.trace import (  # noqa: F401
    Timers,
    Tracer,
    validate_chrome_trace,
)
from blades_tpu_torch.obs.watchdog import (  # noqa: F401
    Watchdog,
    WatchdogEvent,
    WatchdogRule,
    default_rules,
)
