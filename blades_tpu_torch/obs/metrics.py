"""Host-side metrics pipeline: one logger, pluggable sinks (counterpart
of ``blades_tpu/obs/metrics.py``).

The device half of observability (``Aggregator.diagnose``,
``FedRound.step`` forensics scalars) surfaces per-round facts; this module
is where they land on the host.  ``MetricsLogger`` fans each round record
out to sinks:

- :class:`JsonlSink` — the canonical machine-readable stream, one
  schema-validated record per round (``metrics.jsonl`` next to Tune's
  ``result.json``).
- :class:`CsvSink` — flat scalar columns for spreadsheet/pandas triage.
- :class:`StdoutSink` — a human heartbeat line every N rounds.

Sinks swallow nothing: a record that fails schema validation raises
:class:`~blades_tpu_torch.obs.schema.SchemaError` so drift is caught at write
time, not at the grader.
"""

from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional, Sequence

from blades_tpu_torch.obs.schema import ROUND_RECORD_FIELDS, validate_record


class Sink:
    """One destination for round records."""

    def emit(self, record: Dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _seal_torn_tail(path, out_f) -> None:
    """A SIGKILLed writer can leave a torn final line with no newline;
    appending straight onto it would fuse two records into one invalid
    line.  Write a newline to ``out_f`` (opened for append) if ``path``
    is non-empty and does not end with one."""
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            if f.tell():
                f.seek(-1, 2)
                if f.read(1) != b"\n":
                    out_f.write("\n")
    except OSError:
        pass


class JsonlSink(Sink):
    """Append one schema-validated JSON line per record, flushed per write
    so a killed run's stream is tailable and loses at most a torn line."""

    def __init__(self, path, mode: str = "w", strict: bool = True):
        self.path = path
        self.strict = strict
        self._f = open(path, mode)
        if "a" in mode:
            _seal_torn_tail(path, self._f)

    def emit(self, record: Dict) -> None:
        if self.strict:
            validate_record(record)
        self._f.write(json.dumps(record, default=str) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# The CSV column set: every scalar field of the round-record schema, in
# schema order.  Fixed up front — NOT inferred from the first record —
# because eval metrics (test_loss/test_acc) first appear mid-run, after
# the header is already on disk; CSV has no schema evolution.  Nested
# containers (timers, lane_forensics, watchdog_events) stay out.
_CSV_COLUMNS = [
    name for name, (types, _) in ROUND_RECORD_FIELDS.items()
    if dict not in types and list not in types
]


class CsvSink(Sink):
    """Flat scalar columns (the schema's scalar fields, header written with
    the first record); nested dicts (timers, lane_forensics) and
    unregistered keys are skipped by construction."""

    def __init__(self, path, mode: str = "w"):
        self.path = path
        # newline="" + csv.writer: the stdlib module owns ALL escaping
        # (commas, quotes, embedded newlines) so the stream stays readable
        # by the csv.reader consumers (sweep._truncate_csv, pandas).
        self._f = open(path, mode, newline="")
        self._w = csv.writer(self._f, lineterminator="\n")
        self._columns: Optional[List[str]] = None
        if "a" in mode:
            _seal_torn_tail(path, self._f)
            try:
                with open(path, newline="") as f:
                    header = next(csv.reader(f), None)
                if header:
                    self._columns = header
            except OSError:
                pass

    def emit(self, record: Dict) -> None:
        if self._columns is None:
            self._columns = list(_CSV_COLUMNS)
            self._w.writerow(self._columns)
        row = []
        for k in self._columns:
            v = record.get(k, "")
            row.append("" if v is None else v)
        self._w.writerow(row)
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StdoutSink(Sink):
    """Heartbeat: one line every ``every`` ROUNDS (by the record's
    ``training_iteration`` — one record can advance several rounds under
    ``rounds_per_dispatch``; falls back to record count when absent) and
    always the first, so a long sweep shows life without drowning the
    console."""

    def __init__(self, every: int = 10):
        self.every = max(1, int(every))
        self._seen = 0
        self._last_bucket: Optional[int] = None

    def emit(self, record: Dict) -> None:
        self._seen += 1
        rounds = record.get("training_iteration", self._seen)
        bucket = int(rounds) // self.every
        if self._seen != 1 and bucket == self._last_bucket:
            return
        self._last_bucket = bucket
        parts = [f"[{record.get('experiment', '?')}/{record.get('trial', '?')}]",
                 f"round {record.get('training_iteration', '?')}"]
        for key, fmt in (("train_loss", "loss={:.4f}"), ("test_acc", "acc={:.4f}"),
                         ("byz_precision", "byzP={:.2f}"),
                         ("byz_recall", "byzR={:.2f}"),
                         ("num_participating", "part={}"),
                         ("num_straggled", "stale={}"),
                         ("num_unhealthy", "unhealthy={}")):
            if key in record:
                parts.append(fmt.format(record[key]))
        # Compile-cache traffic once, on the first heartbeat (rows of the
        # JAX package carry it; the port's never do).
        if self._seen == 1 and "compile_cache_misses" in record:
            parts.append("cc=" + ("hit" if record["compile_cache_misses"] == 0
                                  else f"{record['compile_cache_misses']}miss"))
        print(" ".join(parts), flush=True)


class MetricsLogger:
    """Fan each round record out to every sink, stamped with base fields
    (experiment/trial identity).  Usable as a context manager."""

    def __init__(self, sinks: Sequence[Sink], base: Optional[Dict] = None):
        self.sinks = list(sinks)
        self.base = dict(base or {})

    def log(self, record: Dict) -> Dict:
        rec = {**self.base, **record}
        for sink in self.sinks:
            sink.emit(rec)
        return rec

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
