"""Query CLI over client-ledger checkpoints (counterpart of
``tools/ledger_report.py``, on the port's
:func:`~blades_tpu_torch.obs.ledger.read_ledger`, so it loads no JAX):
fleet summary, top-N suspects, per-client longitudinal records and
timelines.  Its output is the JAX tool's on the same files.

The ledger (:mod:`blades_tpu_torch.obs.ledger`) persists ONE record per
registered client; this tool is the offline read path over a saved
``ledger/`` shard directory (``<ckpt>/ledger`` under a trial, or
whatever ``--ledger-dir`` pointed the disk backend at).  Three views:

- default: the fleet summary plus the top-N suspect table (lifetime
  flag rate, score EWMA, staleness/norm running stats);
- ``--client ID``: that client's full record; add ``--metrics
  <trial>/metrics.jsonl`` to join the per-round forensics lanes into a
  round-by-round timeline (round, flagged, score, update norm) — the
  lanes are cohort-shaped, so the join matches ``ID`` against each
  row's ``lane_forensics["clients"]`` id-vector;
- ``--json``: machine-readable export of whichever view was selected.

Usage::

    python -m blades_tpu_torch.tools.ledger_report <ckpt>/ledger
    python -m blades_tpu_torch.tools.ledger_report <ckpt>/ledger --top 20
    python -m blades_tpu_torch.tools.ledger_report <ckpt>/ledger \\
        --client 17 --metrics <trial>/metrics.jsonl
    python -m blades_tpu_torch.tools.ledger_report <ckpt>/ledger --json
"""

from __future__ import annotations

import argparse
import json
import sys


def client_timeline(metrics_path, client_id: int):
    """Scan a metrics.jsonl stream for rounds whose forensics lanes
    cover ``client_id``: the lanes are cohort-shaped (lane ``i``
    diagnoses ``lane_forensics["clients"][i]``), so membership — not
    position — decides whether the client appears in a round.  Torn or
    unparseable lines are skipped (the schema validator's findings)."""
    events = []
    with open(metrics_path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            lanes = rec.get("lane_forensics") if isinstance(rec, dict) \
                else None
            if not isinstance(lanes, dict):
                continue
            clients = lanes.get("clients")
            masks = lanes.get("benign_mask")
            if not isinstance(clients, list) or not isinstance(masks, list):
                continue
            try:
                lane = clients.index(client_id)
            except ValueError:
                continue  # client not in this round's cohort
            ev = {
                "round": rec.get("training_iteration"),
                "flagged": bool(masks[lane] <= 0.5),
            }
            if rec.get("tick") is not None:
                ev["tick"] = rec["tick"]
            scores = lanes.get("scores")
            if isinstance(scores, list) and lane < len(scores):
                ev["score"] = scores[lane]
            norms = lanes.get("update_norms")
            if isinstance(norms, list) and lane < len(norms):
                ev["update_norm"] = norms[lane]
            events.append(ev)
    return events


def _fmt_suspect_row(rec) -> str:
    return (f"  {rec['client']:>8d}  {rec['participation']:>6d}  "
            f"{rec['flagged']:>7d}  {rec['flag_rate']:>9.4f}  "
            f"{rec['score_ewma']:>10.4f}  {rec['stale_mean']:>10.3f}  "
            f"{rec['norm_mean']:>10.4f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.ledger_report",
        description="query a client-ledger checkpoint: fleet summary, "
                    "top-N suspects, per-client records/timelines",
    )
    p.add_argument("ledger_dir",
                   help="ledger checkpoint directory (holds manifest.json "
                        "+ shard files)")
    p.add_argument("--top", type=int, default=10, metavar="K",
                   help="suspects to list in the fleet view (default 10)")
    p.add_argument("--client", type=int, default=None, metavar="ID",
                   help="print one client's longitudinal record instead "
                        "of the fleet view")
    p.add_argument("--metrics", default=None, metavar="JSONL",
                   help="with --client: join this metrics.jsonl stream "
                        "into a round-by-round timeline")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the selected view as JSON on stdout")
    args = p.parse_args(argv)

    from blades_tpu_torch.obs.ledger import LedgerError, read_ledger

    try:
        ledger = read_ledger(args.ledger_dir)
    except LedgerError as exc:
        print(f"{args.ledger_dir}: {exc}", file=sys.stderr)
        return 1

    try:
        if args.client is not None:
            try:
                record = ledger.client_record(args.client)
            except LedgerError as exc:
                print(f"{args.ledger_dir}: {exc}", file=sys.stderr)
                return 1
            out = {"ledger": str(args.ledger_dir), "record": record}
            if args.metrics:
                out["timeline"] = client_timeline(args.metrics, args.client)
            if args.as_json:
                print(json.dumps(out, indent=2, sort_keys=True))
                return 0
            print(f"client {record['client']} "
                  f"({args.ledger_dir}):")
            for key in ("participation", "flagged", "flag_rate",
                        "last_flagged", "score_ewma", "last_round",
                        "last_tick", "stale_count", "stale_mean",
                        "stale_var", "norm_count", "norm_mean",
                        "norm_var"):
                print(f"  {key:>13s}: {record[key]}")
            if args.metrics:
                tl = out["timeline"]
                print(f"timeline ({len(tl)} diagnosed round(s) in "
                      f"{args.metrics}):")
                for ev in tl:
                    bits = [f"round {ev['round']}"]
                    if "tick" in ev:
                        bits.append(f"tick {ev['tick']}")
                    bits.append("FLAGGED" if ev["flagged"] else "benign")
                    if "score" in ev:
                        bits.append(f"score {ev['score']:.4f}")
                    if "update_norm" in ev:
                        bits.append(f"norm {ev['update_norm']:.4f}")
                    print("  " + "  ".join(bits))
            return 0

        summary = ledger.summary()
        suspects = ledger.top_suspects(args.top)
        if args.as_json:
            print(json.dumps(
                {"ledger": str(args.ledger_dir), "summary": summary,
                 "top_suspects": suspects},
                indent=2, sort_keys=True))
            return 0
        print(f"{args.ledger_dir}: {summary['n_registered']} registered, "
              f"{summary['clients_seen']} seen, "
              f"{summary['total_flagged']} lifetime flag(s)")
        print(f"  suspected_fraction: {summary['suspected_fraction']:.4f}  "
              f"reputation p10/p50/p90: {summary['reputation_p10']:.4f}/"
              f"{summary['reputation_p50']:.4f}/"
              f"{summary['reputation_p90']:.4f}")
        if suspects:
            print(f"top {len(suspects)} suspect(s):")
            print("    client   part.  flagged  flag_rate  score_ewma  "
                  "stale_mean   norm_mean")
            for rec in suspects:
                print(_fmt_suspect_row(rec))
        else:
            print("no clients flagged yet")
        return 0
    finally:
        ledger.close()


if __name__ == "__main__":
    sys.exit(main())
