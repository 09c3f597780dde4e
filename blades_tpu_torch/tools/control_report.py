"""Offline report over a controlled run's action journal (counterpart of
``tools/control_report.py``; plain Python, no JAX): the action timeline,
per-actuator/per-rule tallies, and per-client quarantine lifecycle
histories.  Its output is the JAX tool's on the same files.

The control plane (:mod:`blades_tpu_torch.control`) journals every runtime
action into the metrics rows as ``control_actions`` — and the flight
recorder's digests retain them — so this tool reads EITHER artifact:

- ``<trial>/metrics.jsonl``: the full run's journal, one row per round;
- ``<trial>/flightrec.json``: the last-K-rounds ring (crash forensics —
  what was the controller doing when the run died?).

Three views:

- default: the chronological action timeline (round, tick, rule,
  actuator, old -> new / clients) plus per-actuator and per-rule
  tallies;
- ``--client ID``: that client's quarantine lifecycle — every
  quarantine / probe / readmit / requarantine interval it appears in;
- ``--json``: machine-readable export of whichever view was selected.

Verification is ``blades_tpu_torch.tools.replay_round --action``'s job
(re-derive each action from its recorded inputs); this tool only reads
and arranges.

Usage::

    python -m blades_tpu_torch.tools.control_report <trial>/metrics.jsonl
    python -m blades_tpu_torch.tools.control_report \\
        <trial>/flightrec.json --client 4
    python -m blades_tpu_torch.tools.control_report \\
        <trial>/metrics.jsonl --json
"""

from __future__ import annotations

import argparse
import json
import sys


def load_rows(path: str):
    """Rows carrying journal entries, from either artifact.  A
    ``.jsonl`` suffix selects the metrics-stream reader (torn lines
    skipped, the validator's findings); anything else is parsed as a
    flight-recorder dump and its ``rounds`` ring is returned."""
    if str(path).endswith(".jsonl"):
        rows = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    rows.append(rec)
        return rows
    with open(path) as f:
        dump = json.load(f)
    if not isinstance(dump, dict) or "rounds" not in dump:
        raise ValueError(f"{path} is neither a metrics.jsonl stream nor "
                         "a flight-recorder dump (no 'rounds' key)")
    return [r for r in dump["rounds"] if isinstance(r, dict)]


def collect_actions(rows):
    """Flatten the per-row journals into one seq-ordered action list."""
    actions = []
    for row in rows:
        for entry in row.get("control_actions") or []:
            if isinstance(entry, dict):
                actions.append(entry)
    actions.sort(key=lambda a: a.get("seq", 0))
    return actions


def client_history(actions, client_id: int):
    """The quarantine-lifecycle events naming ``client_id``."""
    return [a for a in actions
            if client_id in (a.get("clients") or ())]


def tallies(actions):
    by_actuator: dict = {}
    by_rule: dict = {}
    for a in actions:
        by_actuator[a.get("actuator")] = \
            by_actuator.get(a.get("actuator"), 0) + 1
        by_rule[a.get("rule")] = by_rule.get(a.get("rule"), 0) + 1
    return by_actuator, by_rule


def _fmt_action(a) -> str:
    bits = [f"round {a.get('round'):>4}", f"tick {a.get('tick'):>5}",
            f"seq {a.get('seq'):>3}",
            f"{a.get('rule')} -> {a.get('actuator')}"]
    if a.get("old") is not None or a.get("new") is not None:
        bits.append(f"{a.get('old')} -> {a.get('new')}")
    if a.get("clients"):
        bits.append(f"clients {list(a['clients'])}")
    if a.get("until", -1) >= 0:
        bits.append(f"until round {a['until']}")
    return "  ".join(str(b) for b in bits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.control_report",
        description="report over a controlled run's action journal: "
                    "timeline, tallies, per-client quarantine history",
    )
    p.add_argument("path",
                   help="<trial>/metrics.jsonl or <trial>/flightrec.json")
    p.add_argument("--client", type=int, default=None, metavar="ID",
                   help="print one client's quarantine-lifecycle events "
                        "instead of the full timeline")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the selected view as JSON on stdout")
    args = p.parse_args(argv)

    try:
        rows = load_rows(args.path)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"{args.path}: {exc}", file=sys.stderr)
        return 1
    actions = collect_actions(rows)
    controlled = any("control_actions" in r for r in rows)
    if not controlled:
        print(f"{args.path}: no control journal in any row — was the "
              "run controlled? (.control() / control_config)",
              file=sys.stderr)
        return 1

    if args.client is not None:
        history = client_history(actions, args.client)
        if args.as_json:
            print(json.dumps({"path": args.path, "client": args.client,
                              "history": history},
                             indent=2, sort_keys=True))
            return 0
        print(f"client {args.client} ({args.path}): "
              f"{len(history)} lifecycle event(s)")
        for a in history:
            print("  " + _fmt_action(a))
        return 0

    by_actuator, by_rule = tallies(actions)
    events_total = sum(len(r.get("watchdog_events") or [])
                      for r in rows)
    last = rows[-1] if rows else {}
    summary = {
        "rows": len(rows),
        "actions": len(actions),
        "watchdog_events": events_total,
        "by_actuator": by_actuator,
        "by_rule": by_rule,
        "final_quarantine_size": last.get("quarantine_size"),
        "final_actions_total": last.get("control_actions_total"),
    }
    if args.as_json:
        print(json.dumps({"path": args.path, "summary": summary,
                          "timeline": actions},
                         indent=2, sort_keys=True))
        return 0
    print(f"{args.path}: {len(rows)} row(s), {len(actions)} action(s), "
          f"{events_total} watchdog event(s)")
    if last.get("control_actions_total") is not None:
        print(f"  final journal length {last['control_actions_total']}, "
              f"final quarantine size {last.get('quarantine_size')}")
    if by_actuator:
        print("  by actuator: " + ", ".join(
            f"{k}={v}" for k, v in sorted(by_actuator.items())))
        print("  by rule:     " + ", ".join(
            f"{k}={v}" for k, v in sorted(by_rule.items())))
    print(f"timeline ({len(actions)} action(s)):")
    for a in actions:
        print("  " + _fmt_action(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
