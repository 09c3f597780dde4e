"""blades-lint CLI for the port:
``python -m blades_tpu_torch.tools.lint [--changed] [--json] [paths]``.

Exit 0 = no unsuppressed ERROR findings (warnings never fail); 1 =
findings; 2 = usage error.  ``--json`` emits machine-readable findings
(a list of finding dicts under ``"findings"`` plus a ``"summary"``
block).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from blades_tpu_torch.tools.lint.core import (
    ERROR,
    EXCLUDE_PARTS,
    changed_files,
    run_passes,
)
from blades_tpu_torch.tools.lint.passes import ALL_PASSES


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.lint",
        description="blades-lint: static analysis for the port's "
                    "load-bearing invariants",
    )
    p.add_argument("paths", nargs="*",
                   help="restrict to these files (default: the port's tree "
                        "— blades_tpu_torch/, chip_smoke.py, "
                        "tests/test_torch_*.py)")
    p.add_argument("--changed", action="store_true",
                   help="lint only files changed vs HEAD (+ untracked)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable findings on stdout")
    p.add_argument("--root", default=".",
                   help="repo root (default: cwd)")
    p.add_argument("--list-passes", action="store_true",
                   help="print the registered passes and exit")
    args = p.parse_args(argv)

    root = Path(args.root).resolve()
    if args.list_passes:
        for pa in ALL_PASSES:
            print(f"{pa.name:24s} {pa.doc}")
        return 0
    only = None
    if args.paths:
        only = [Path(pp).resolve() for pp in args.paths]
    elif args.changed:
        # Unlike explicit operands, --changed keeps the tree-scan
        # exclusions: touching a lint FIXTURE (a deliberate violation)
        # must not fail the changed-files gate.
        only = [p for p in changed_files(root)
                if not any(part in EXCLUDE_PARTS for part in p.parts)]
    if only is not None:
        # Drop non-lintable operands HERE so the summary line counts the
        # files actually parsed, not every changed artifact/markdown.
        only = [p for p in only if p.suffix == ".py" and p.is_file()]
        if not only and args.changed:
            print("blades-lint: no changed python files")
            return 0
    try:
        findings = run_passes(root, ALL_PASSES, only=only)
    except ValueError as exc:  # e.g. a path outside --root
        print(f"blades-lint: {exc}", file=sys.stderr)
        return 2
    errors = [f for f in findings if f.severity == ERROR]
    warnings = [f for f in findings if f.severity != ERROR]
    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "summary": {"errors": len(errors), "warnings": len(warnings),
                        "passes": [pa.name for pa in ALL_PASSES]},
        }, indent=2))
    else:
        for f in findings:
            print(f.render())
        scope = (f"{len(only)} file(s)" if only is not None else "full tree")
        print(f"blades-lint: {len(errors)} error(s), {len(warnings)} "
              f"warning(s) over {scope} ({len(ALL_PASSES)} passes)")
    return 1 if errors else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
