"""Inspect and invalidate the port's plan cache (counterpart of the JAX
package's ``tools/show_plan.py``).

The port's autotuner (:mod:`blades_tpu_torch.perf.autotune`) keeps each
winning plan in one JSON file per ``(config fingerprint, tier, device
name, torch and CUDA versions)`` key under
``$BLADES_TPU_TORCH_PLAN_CACHE_DIR`` (or
``~/.cache/blades_tpu_torch/plans``):

- ``list`` (default): one line per entry — digest, winner ``plan_id``,
  selection mode, tier, device, torch / CUDA, age.  Files the corrupt-tolerant
  reader rejects (torn writes, stale ``version`` stamps) are listed as
  ``CORRUPT/STALE`` rather than hidden — they cost a re-tune on next
  use, which an operator may want to know about.
- ``show <digest>``: the full entry — key, plan dict (paste-able into
  ``FedavgConfig.resources(tuned_plan=...)`` to pin it), and the
  selection provenance (per-candidate timings or the
  heuristic-fallback marker).
- ``invalidate [digest]``: delete one entry (plus its orphaned
  ``.tmp``), or ``--all`` to clear the cache; the next autotuned run
  re-tunes.

Usage::

    python -m blades_tpu_torch.tools.show_plan                  # list
    python -m blades_tpu_torch.tools.show_plan show 3f2a        # one entry
    python -m blades_tpu_torch.tools.show_plan invalidate 3f2a  # drop one
    python -m blades_tpu_torch.tools.show_plan invalidate --all # clear
    python -m blades_tpu_torch.tools.show_plan --cache-dir /tmp/p
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _age(created) -> str:
    try:
        secs = max(0.0, time.time() - float(created))  # blades-lint: disable=trace-discipline — a cache entry's wall-clock age for display, not a duration measurement
    except (TypeError, ValueError):
        return "?"
    if secs < 3600:
        return f"{secs / 60:.0f}m"
    if secs < 86400:
        return f"{secs / 3600:.1f}h"
    return f"{secs / 86400:.1f}d"


def cmd_list(cache) -> int:
    entries = cache.entries()
    if not entries:
        print(f"plan cache {cache.dir}: empty")
        return 0
    print(f"plan cache {cache.dir}: {len(entries)} entr"
          f"{'y' if len(entries) == 1 else 'ies'}")
    for digest, entry in entries:
        if entry is None:
            print(f"  {digest[:12]}  CORRUPT/STALE (will re-tune; "
                  "'invalidate' to drop)")
            continue
        key = entry.get("key", {})
        prov = entry.get("provenance", {})
        plan_id = prov.get("winner_id") or "?"
        print(f"  {digest[:12]}  {plan_id:<40s} mode={prov.get('mode', '?')}"
              f" tier={key.get('tier', '?')}"
              f" device={key.get('device_kind', '?')!r}"
              f" torch={key.get('torch', '?')} cuda={key.get('cuda', '?')}"
              f" age={_age(entry.get('created_unix'))}")
    return 0


def cmd_show(cache, digest: str) -> int:
    for d, entry in cache.entries():
        if d.startswith(digest):
            if entry is None:
                print(f"{d}: corrupt or stale-version entry "
                      "(unreadable; 'invalidate' to drop)")
                return 1
            print(json.dumps(entry, indent=2, sort_keys=True))
            return 0
    print(f"no cache entry matching {digest!r} under {cache.dir}")
    return 1


def cmd_invalidate(cache, digest, all_: bool) -> int:
    if not all_ and not digest:
        print("invalidate: pass a digest (prefix ok) or --all")
        return 2
    if digest and not all_:
        matches = [d for d, _ in cache.entries() if d.startswith(digest)]
        if not matches:
            print(f"no cache entry matching {digest!r} under {cache.dir}")
            return 1
        removed = []
        for d in matches:
            removed += cache.invalidate(d)
    else:
        removed = cache.invalidate()
    for name in removed:
        print(f"removed {cache.dir / name}")
    if not removed:
        print(f"plan cache {cache.dir}: nothing to remove")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.show_plan",
        description="dump / invalidate the port's plan cache")
    parser.add_argument("--cache-dir", default=None, metavar="DIR",
                        help="cache location (default "
                        "$BLADES_TPU_TORCH_PLAN_CACHE_DIR or "
                        "~/.cache/blades_tpu_torch/plans)")
    sub = parser.add_subparsers(dest="cmd")
    sub.add_parser("list", help="one line per entry (default)")
    p_show = sub.add_parser("show", help="dump one entry as JSON")
    p_show.add_argument("digest", help="entry digest (prefix ok)")
    p_inv = sub.add_parser("invalidate", help="delete entries")
    p_inv.add_argument("digest", nargs="?", default=None,
                       help="entry digest (prefix ok)")
    p_inv.add_argument("--all", action="store_true",
                       help="clear every entry (and orphaned .tmp files)")
    args = parser.parse_args(argv)

    from blades_tpu_torch.perf.autotune import PlanCache

    cache = PlanCache(args.cache_dir)
    if args.cmd == "show":
        return cmd_show(cache, args.digest)
    if args.cmd == "invalidate":
        return cmd_invalidate(cache, args.digest, args.all)
    return cmd_list(cache)


if __name__ == "__main__":
    sys.exit(main())
