"""Replay a flight-recorder dump's round through the port, bit for bit
(counterpart of ``tools/replay_round.py``, which re-runs the JAX driver).

Every execution path of the port is deterministic in ``(config, seed)``
on one device: round ``r`` draws from a generator seeded by
``SeedSequence([seed, r])``, the fault realizations are pure in
``(fault_seed, round)``, async events in ``(seed, tick, client)``.  That
includes decentralized gossip rounds (``execution="gossip"``): the peer
graph rebuilds from ``topology_config`` (``graph_seed`` pins the random
families), the edge-dropout realization is pure in ``(fault_seed,
round)``, and the per-node replica stack replays through the same round
seeds, so ``gossip_ici_bytes`` / ``num_partitioned_nodes`` /
``consensus_dist`` compare bit for bit like every other digest field.  A
flight-recorder dump (:mod:`blades_tpu_torch.obs.flightrec`) therefore
carries everything needed to re-execute the failing round: this CLI
rebuilds the trial config from the dump, re-runs the PORT's driver to the
recorded tick, and compares the replayed round's digest against the
recorded one bit for bit (NaN matches NaN; exact float equality
everywhere else).

On the card the replay runs cuDNN's deterministic algorithms and full
f32 (no TF32), so it reproduces a run made under the same settings (as
``chip_smoke.py`` runs its phases); a run with nondeterministic
convolutions can differ in its last bits.

Usage::

    python -m blades_tpu_torch.tools.replay_round <flightrec.json> \\
        [--tick N] [--device cpu] [--quiet]
    python -m blades_tpu_torch.tools.replay_round <flightrec.json> --action

``--tick`` defaults to the dump's trigger round (falling back to the
newest recorded round); ``--device`` defaults to the card.  Exit code 0 =
every compared field matched bit for bit; 1 = mismatch or unusable dump.
"""

from __future__ import annotations

import argparse
import json
import math
import struct
import sys


def _bits(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", float(x)))[0]


def bit_equal(a, b) -> bool:
    """Bit-identical float comparison: NaN == NaN (a NaN-corrupted round
    must replay as the same NaN), otherwise exact representation
    equality."""
    fa, fb = float(a), float(b)
    if math.isnan(fa) and math.isnan(fb):
        return True
    return _bits(fa) == _bits(fb)


def _deterministic(device) -> None:
    """cuDNN's deterministic algorithms and full f32 on the card."""
    import torch

    if torch.device(device).type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def replay(dump: dict, tick=None, device=None):
    """Re-run the dump's trajectory to ``tick`` through the port's driver
    on ``device`` (None = the card); returns ``(replayed row, recorded
    digest)``.  Raises ``ValueError`` when the dump records nothing
    usable.

    Async rows are TICK-indexed on top of round-indexed: ``tick`` first
    matches a recorded row's ``training_iteration`` (every execution
    path), then — async rows only — a row's virtual arrival-clock
    ``tick`` field; either way the replay re-runs rounds to the matched
    row's ``training_iteration``."""
    from blades_tpu_torch.algorithms import get_algorithm_class

    rounds = dump.get("rounds") or []
    by_iter = {r.get("training_iteration"): r for r in rounds
               if isinstance(r, dict)}
    # Consecutive cycles CAN share a virtual tick (a cycle fired from
    # leftover buffered events does not advance the clock), so only
    # unambiguous ticks resolve.
    vtick_rows: dict = {}
    for r in rounds:
        if isinstance(r, dict) and isinstance(r.get("tick"), int):
            vtick_rows.setdefault(r["tick"], []).append(r)
    by_vtick = {t: rs[0] for t, rs in vtick_rows.items() if len(rs) == 1}
    if tick is None:
        trig = dump.get("trigger") or {}
        tick = trig.get("round") or (dump.get("rng") or {}).get("tick")
    recorded = by_iter.get(tick)
    if recorded is None and tick in vtick_rows and tick not in by_vtick:
        raise ValueError(
            f"virtual tick {tick} matches {len(vtick_rows[tick])} "
            "recorded rounds "
            f"{[r.get('training_iteration') for r in vtick_rows[tick]]} "
            "(cycles fired from leftover buffered events share a tick) "
            "— disambiguate with --tick <training_iteration>")
    if recorded is None:
        recorded = by_vtick.get(tick)
    if recorded is None:
        window = sorted(by_iter)
        vwindow = sorted(by_vtick)
        raise ValueError(
            f"tick {tick!r} is not in the dump's recorded window "
            f"(rounds {window}"
            + (f", arrival ticks {vwindow}" if vwindow else "")
            + f") — the ring only holds the last "
            f"{dump.get('capacity')} rounds")
    target = recorded["training_iteration"]

    _, config = get_algorithm_class(dump["algo"], return_config=True)
    config.update_from_dict(json.loads(json.dumps(dump.get("config", {}))))
    algo = config.build(device=device)
    row = None
    try:
        while algo.iteration < target:
            row = algo.train()
    finally:
        algo.stop()
    if row is None or row.get("training_iteration") != target:
        raise ValueError(
            f"replay stopped at iteration {algo.iteration} "
            f"(rounds_per_dispatch overshoots round {target}?)")
    return row, recorded


def compare(row: dict, recorded: dict):
    """``(matches, mismatches, skipped)`` over the replay-comparable digest
    fields present in the recording."""
    from blades_tpu_torch.obs.flightrec import REPLAY_FIELDS

    matches, mismatches, skipped = [], [], []
    for field in REPLAY_FIELDS:
        if field not in recorded:
            continue
        want = recorded[field]
        if not isinstance(want, (int, float)) or isinstance(want, bool):
            skipped.append(field)
            continue
        have = row.get(field)
        if not isinstance(have, (int, float)) or isinstance(have, bool):
            mismatches.append((field, want, have))
        elif bit_equal(want, have):
            matches.append(field)
        else:
            mismatches.append((field, want, have))
    return matches, mismatches, skipped


def rederive_actions(dump: dict, quiet: bool = False) -> int:
    """``--action``: re-derive every journaled control action from the
    dump's policy config and each action's recorded decision inputs
    (``pre`` + the row's ledger suspects), and diff against the journal
    entry, byte for byte over the serialized dicts.  No training is
    re-run.  Returns an exit code (0 = every action re-derived
    identically)."""
    from blades_tpu_torch.control import ControlPolicy, rederive_action

    cfg = dump.get("config") or {}
    control_cfg = cfg.get("control_config")
    if not control_cfg:
        print("dump's config has no control_config — nothing to "
              "re-derive (run was uncontrolled)", file=sys.stderr)
        return 1
    policy = ControlPolicy.from_config(dict(control_cfg))
    # The flight recorder nests the fleet size under dataset_config;
    # accept the flat key too.
    num_clients = int(
        cfg.get("num_clients")
        or (cfg.get("dataset_config") or {}).get("num_clients")
        or 0)
    checked = diverged = 0
    for row in dump.get("rounds") or []:
        if not isinstance(row, dict):
            continue
        suspects = row.get("ledger_top_suspects") or ()
        for entry in row.get("control_actions") or []:
            rederived = rederive_action(
                policy, entry, suspects=suspects,
                num_clients=num_clients)
            checked += 1
            want = json.dumps(entry, sort_keys=True)
            have = (None if rederived is None
                    else json.dumps(rederived, sort_keys=True))
            if want != have:
                diverged += 1
                print(f"  round {row.get('training_iteration')} seq "
                      f"{entry.get('seq')} [{entry.get('actuator')}]: "
                      f"recorded {want}\n    != rederived {have}  "
                      "MISMATCH")
            elif not quiet:
                print(f"  round {row.get('training_iteration')} seq "
                      f"{entry.get('seq')} [{entry.get('actuator')}] "
                      f"{entry.get('rule')}: rederived OK")
    if diverged:
        print(f"{diverged}/{checked} control action(s) DIVERGED — the "
              "control plane's determinism contract is broken",
              file=sys.stderr)
        return 1
    if not checked:
        print("no control actions recorded in the dump's window "
              "(controlled run, but every ring round was action-free)")
        return 0
    print(f"all {checked} control action(s) re-derived bit-identically")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.replay_round",
        description="re-execute a flight-recorded round through the port "
                    "from (config, seed, tick) and verify the digest bit "
                    "for bit")
    p.add_argument("dump", help="path to a flightrec.json dump")
    p.add_argument("--tick", type=int, default=None,
                   help="round to replay (default: the trigger round)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--action", action="store_true",
                   help="instead of re-running the round, re-derive "
                   "every journaled control action from the dump's policy "
                   "config and each action's recorded decision inputs, "
                   "and diff against the journal; no training happens")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    from blades_tpu_torch.obs.flightrec import validate_flightrec

    num_rounds, errors = validate_flightrec(args.dump)
    if errors:
        for e in errors:
            print(f"{args.dump}: {e}", file=sys.stderr)
        return 1
    with open(args.dump) as f:
        dump = json.load(f)
    if args.action:
        return rederive_actions(dump, quiet=args.quiet)
    from blades_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"replay failed: {exc}", file=sys.stderr)
        return 1
    _deterministic(device)
    try:
        row, recorded = replay(dump, tick=args.tick, device=device)
    except (ValueError, KeyError, NotImplementedError) as exc:
        print(f"replay failed: {exc}", file=sys.stderr)
        return 1
    matches, mismatches, skipped = compare(row, recorded)
    tick = recorded.get("training_iteration")
    if not args.quiet:
        trig = (dump.get("trigger") or {}).get("kind", "?")
        print(f"{args.dump}: trial {dump.get('trial')!r}, trigger "
              f"{trig!r}, replayed round {tick} "
              f"({num_rounds} recorded round(s) in the ring)")
        for field in matches:
            print(f"  {field}: {recorded[field]!r}  == replay  OK")
        for field, want, have in mismatches:
            print(f"  {field}: recorded {want!r} != replayed {have!r}  "
                  "MISMATCH")
        if skipped:
            print(f"  (skipped non-scalar fields: {skipped})")
    if mismatches:
        print(f"replay DIVERGED on {len(mismatches)} field(s) — the "
              "determinism contract is broken for this config",
              file=sys.stderr)
        return 1
    if not matches:
        print("nothing to compare (recorded digest has no replay "
              "fields)", file=sys.stderr)
        return 1
    print(f"replay of round {tick} is bit-identical "
          f"({len(matches)} field(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
