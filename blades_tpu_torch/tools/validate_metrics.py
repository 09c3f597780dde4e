"""Offline artifact validator of the port (counterpart of
``tools/validate_metrics.py``, which loads the JAX package): metrics
streams, flight-recorder dumps, span traces, ledger checkpoints and
data-store shard directories, through the port's own validators, so it
runs where JAX is not installed.  Its verdicts and output are the JAX
tool's on the same files.

- default: ``metrics.jsonl`` streams against the round-record schema
  (delegates to :func:`blades_tpu_torch.obs.schema.validate_jsonl`), plus the
  async-row ordering contract: rows stamped by the buffered-async path
  (blades_tpu/arrivals) are TICK-indexed on top of round-indexed, and
  the virtual arrival clock only moves forward — a ``tick`` that goes
  backwards between consecutive records means interleaved or
  re-ordered streams and is reported as an error — and the pod-scale
  row contract: ``ici_bytes`` / ``preagg_kept`` / ``mesh_shape`` are
  stamped together by the hierarchical driver, so a partial stamp is
  an error — and the decentralized-round contract: ``gossip_ici_bytes``
  travels with the topology provenance and the per-round gossip
  counters (blades_tpu_torch/topology), same partial-stamp rule;
- ``--flightrec``: ``flightrec.json`` dumps
  (:func:`blades_tpu_torch.obs.flightrec.validate_flightrec`);
- ``--trace``: Chrome/Perfetto span-trace exports
  (:func:`blades_tpu_torch.obs.trace.validate_chrome_trace`);
- ``--ledger``: client-ledger checkpoint directories
  (:func:`blades_tpu_torch.obs.ledger.validate_ledger_checkpoint`) —
  manifest CRCs against the shard files, layout drift, torn shards;
- ``--datastore``: data-store shard directories
  (:func:`blades_tpu_torch.data.store.validate_datastore_dir`).

Torn-write tolerance matches the metrics.jsonl contract everywhere: a
torn final JSONL line (a killed writer) or an unreadable JSON artifact
is a REPORTED error with a nonzero exit code, never an exception —
and an orphaned ``*.tmp`` sibling (an atomic write a SIGKILL
interrupted) is flagged as exactly that, since the published file next
to it is still the newest complete artifact.

Usage::

    python -m blades_tpu_torch.tools.validate_metrics <trial>/metrics.jsonl
    python -m blades_tpu_torch.tools.validate_metrics --flightrec \\
        <trial>/flightrec.json
    python -m blades_tpu_torch.tools.validate_metrics --trace \\
        traces/*.trace.json
    python -m blades_tpu_torch.tools.validate_metrics --ledger <ckpt>/ledger
    python -m blades_tpu_torch.tools.validate_metrics --datastore <dir>
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _async_tick_errors(path):
    """Tick-monotonicity over a metrics.jsonl stream: the virtual
    arrival clock (async rows' ``tick``) must be non-decreasing in file
    order.  Rows without a ``tick`` (synchronous trials) are ignored;
    unparseable lines are the schema validator's findings, not ours."""
    import json

    errors = []
    last = None
    last_line = None
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            tick = rec.get("tick") if isinstance(rec, dict) else None
            if not isinstance(tick, int) or isinstance(tick, bool):
                continue
            if last is not None and tick < last:
                errors.append((lineno,
                               f"async tick went backwards: {tick} after "
                               f"{last} (line {last_line}) — the virtual "
                               "arrival clock only moves forward"))
            last, last_line = tick, lineno
    return errors


def _mesh_row_errors(path):
    """Pod-scale row consistency over a metrics.jsonl stream: the three
    hierarchical-round stamps travel together (a row with ``ici_bytes``
    must carry ``preagg_kept`` and a ``"CxD"``-shaped ``mesh_shape``),
    and both counters are non-negative — a partial stamp means the
    driver and the recorder disagreed about which path ran."""
    import json
    import re

    errors = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or "ici_bytes" not in rec:
                continue
            missing = [k for k in ("preagg_kept", "mesh_shape")
                       if k not in rec]
            if missing:
                errors.append((lineno,
                               f"hierarchical row missing {missing}: "
                               "ici_bytes/preagg_kept/mesh_shape are "
                               "stamped together by the hier driver"))
                continue
            if rec["ici_bytes"] < 0 or rec["preagg_kept"] < 1:
                errors.append((lineno,
                               f"hierarchical counters out of range: "
                               f"ici_bytes={rec['ici_bytes']}, "
                               f"preagg_kept={rec['preagg_kept']}"))
            if not re.fullmatch(r"\d+x\d+", str(rec["mesh_shape"])):
                errors.append((lineno,
                               f"mesh_shape must be 'CxD', got "
                               f"{rec['mesh_shape']!r}"))
    return errors


def _gossip_row_errors(path):
    """Decentralized-round row consistency over a metrics.jsonl stream:
    the six gossip stamps travel together (a row with
    ``gossip_ici_bytes`` must carry the topology provenance and both
    per-round counters), counters are in range, and the graph family is
    one the topology subsystem builds — a partial stamp means the driver
    and the gossip recorder disagreed about which path ran."""
    import json

    errors = []
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict) or "gossip_ici_bytes" not in rec:
                continue
            missing = [k for k in ("topology", "graph_seed", "spectral_gap",
                                   "num_partitioned_nodes", "consensus_dist")
                       if k not in rec]
            if missing:
                errors.append((lineno,
                               f"gossip row missing {missing}: the six "
                               "gossip stamps are stamped together by the "
                               "gossip driver"))
                continue
            if (rec["gossip_ici_bytes"] < 0
                    or rec["num_partitioned_nodes"] < 0):
                errors.append((lineno,
                               "gossip counters out of range: "
                               f"gossip_ici_bytes={rec['gossip_ici_bytes']}, "
                               "num_partitioned_nodes="
                               f"{rec['num_partitioned_nodes']}"))
            if not 0.0 <= float(rec["spectral_gap"]) <= 1.0:
                errors.append((lineno,
                               "spectral_gap must be in [0, 1], got "
                               f"{rec['spectral_gap']!r}"))
            from blades_tpu_torch.topology.graph import GRAPHS

            if rec["topology"] not in GRAPHS:
                errors.append((lineno,
                               f"unknown topology {rec['topology']!r}; "
                               f"the subsystem builds {GRAPHS}"))
    return errors


def _report(path, num_ok: int, what: str, errors) -> int:
    print(f"{path}: {num_ok} valid {what}, {len(errors)} error(s)")
    for err in errors:
        if isinstance(err, tuple):
            lineno, msg = err
            print(f"  line {lineno}: {msg}")
        else:
            print(f"  {err}")
    p = Path(path)
    if p.is_dir():
        # Directory artifacts (ledger checkpoints): any *.tmp inside is
        # an interrupted shard/manifest write the atomic-rename protocol
        # never published — the named files are still complete.
        orphans = sorted(t.name for t in p.glob("*.tmp"))
        if orphans:
            print(f"  note: orphaned {', '.join(orphans)} inside (atomic "
                  "writes were interrupted; the published files are the "
                  "newest complete artifacts)")
    else:
        tmp = Path(str(path) + ".tmp")
        if tmp.exists():
            print(f"  note: orphaned {tmp.name} alongside (an atomic write "
                  "was interrupted; the published file is the newest "
                  "complete artifact)")
    return 1 if errors else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.validate_metrics",
        description="schema-check observability artifacts: metrics.jsonl "
                    "(default), flight-recorder dumps (--flightrec), "
                    "span traces (--trace), ledger checkpoints "
                    "(--ledger), data-store shard dirs (--datastore)",
    )
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--flightrec", action="store_true",
                      help="validate flightrec.json dump(s)")
    mode.add_argument("--trace", action="store_true",
                      help="validate Chrome/Perfetto trace export(s)")
    mode.add_argument("--ledger", action="store_true",
                      help="validate client-ledger checkpoint "
                           "director(ies)")
    mode.add_argument("--datastore", action="store_true",
                      help="validate out-of-core data-store shard "
                           "director(ies): manifest walk + per-shard "
                           "size/dtype/CRC checks")
    p.add_argument("paths", nargs="+")
    args = p.parse_args(argv)

    rc = 0
    for path in args.paths:
        if not Path(path).exists():
            print(f"{path}: no such file")
            rc = 1
            continue
        if args.flightrec:
            from blades_tpu_torch.obs.flightrec import validate_flightrec

            num, errors = validate_flightrec(path)
            rc |= _report(path, num, "recorded round(s)", errors)
        elif args.trace:
            from blades_tpu_torch.obs.trace import validate_chrome_trace

            num, errors = validate_chrome_trace(path)
            rc |= _report(path, num, "span event(s)", errors)
        elif args.ledger:
            from blades_tpu_torch.obs.ledger import validate_ledger_checkpoint

            num, errors = validate_ledger_checkpoint(path)
            rc |= _report(path, num, "shard file(s)", errors)
        elif args.datastore:
            from blades_tpu_torch.data.store import validate_datastore_dir

            num, errors = validate_datastore_dir(path)
            rc |= _report(path, num, "shard file(s)", errors)
        else:
            from blades_tpu_torch.obs.schema import validate_jsonl

            num, errors = validate_jsonl(path)
            errors = (list(errors) + _async_tick_errors(path)
                      + _mesh_row_errors(path) + _gossip_row_errors(path))
            rc |= _report(path, num, "record(s)", errors)
    return rc


if __name__ == "__main__":
    sys.exit(main())
