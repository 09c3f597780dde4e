"""Re-stamp accuracy-curve artifacts under reference-grid semantics
(counterpart of ``tools/restamp_curves.py``).

``complete: true`` in a ``curves.json`` means the REFERENCE grid ran —
all nine reference aggregators at {0,10,20,30}% malicious for the
artifact's client count (``REFERENCE_AGGREGATORS`` /
``REFERENCE_MALICIOUS_FRACS`` of
``blades_tpu_torch/benchmarks/accuracy_curves.py``) — not merely "the
rows the invocation planned".

This tool recomputes the completeness block — ``complete``,
``reference_grid``, ``reference_cells_missing``, and
``planned_complete`` where a plan is recorded — from the artifact's own
rows, REWRITING only those stamps (rows and run-config keys are
untouched).  The ``artifact-stamps`` lint pass
(``python -m blades_tpu_torch.tools.lint``) refuses stale stamps; this
is its fixer.

Usage::

    python -m blades_tpu_torch.tools.restamp_curves <dir>/curves.json ...
    python -m blades_tpu_torch.tools.restamp_curves --all   # every curves.json under artifacts/
    python -m blades_tpu_torch.tools.restamp_curves --check <...>  # report, do not rewrite
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from blades_tpu_torch.tools.lint.passes.artifacts import (
    CURVES_MODULE,
    recompute_stamps,
    reference_grid,
)

REPO = Path(__file__).resolve().parents[2]


def restamp(path: Path, aggregators, fracs, check: bool) -> bool:
    """Returns True when the artifact was (or would be) changed."""
    data = json.loads(path.read_text())
    if not isinstance(data, dict) or "rows" not in data:
        print(f"{path}: not a curves table, skipped")
        return False
    want = recompute_stamps(data, aggregators, fracs)
    changed = any(data.get(k) != v for k, v in want.items())
    old = data.get("complete")
    if not changed:
        print(f"{path}: stamps already current (complete={old})")
        return False
    missing = want["reference_cells_missing"]
    print(f"{path}: complete {old} -> {want['complete']} "
          f"({len(missing)} reference cell(s) missing"
          + (f", e.g. {missing[0]}" if missing else "") + ")")
    if check:
        return True
    data.update(want)
    path.write_text(json.dumps(data, indent=2) + "\n")
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.restamp_curves",
        description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="*", type=Path)
    p.add_argument("--all", action="store_true",
                   help="restamp every curves.json under artifacts/")
    p.add_argument("--check", action="store_true",
                   help="report stale stamps without rewriting (exit 1 "
                        "when any are stale)")
    args = p.parse_args(argv)
    grid = reference_grid(REPO)
    if grid is None:
        print(f"cannot read the reference grid from {CURVES_MODULE}",
              file=sys.stderr)
        return 2
    paths = list(args.paths)
    if args.all:
        paths.extend(sorted((REPO / "artifacts").rglob("curves.json")))
    if not paths:
        p.error("pass artifact paths or --all")
    changed = sum(restamp(path, *grid, check=args.check) for path in paths)
    return 1 if (args.check and changed) else 0


if __name__ == "__main__":
    sys.exit(main())
