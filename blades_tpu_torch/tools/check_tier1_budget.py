"""Tier-1 wall-time guard (counterpart of ``tools/check_tier1_budget.py``).

Parse a tier-1 pytest log (the ``tee /tmp/_t1.log`` stream of the tier-1
command, ideally produced with ``--durations=N``) and FAIL when the
projected tier-1 wall time exceeds ``--threshold`` (default 85%) of the
``--cap`` (default 1470 s, the tier-1 command's ``timeout``).  The
projection prefers pytest's own summary total ("... in 823.70s"); when
the log only carries ``--durations`` lines (e.g. a partial run), their
sum stands in.  Failing at 85% leaves headroom for box-speed variance
before the hard timeout kills the run mid-suite.

The JAX guard's second check, the slow-marker audit of tests that build
the 8-device JAX mesh, is left out: it delegates to the JAX lint's
``slow-markers`` pass, which already audits every file under ``tests/``,
the port's included (``python -m tools.lint``).

Exit code 0 = within budget; 1 = over budget or no usable log; 2 =
usage error.

Usage::

    python -m blades_tpu_torch.tools.check_tier1_budget --log /tmp/_t1.log
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import List, Optional, Tuple

CAP_SECONDS = 1470.0
THRESHOLD = 0.85

_DURATION_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)s\s+(call|setup|teardown)\s+(\S+)"
)
# pytest summary: "== 359 passed, 3 skipped in 823.70s (0:13:43) =="
_TOTAL_RE = re.compile(r"\bin\s+(\d+(?:\.\d+)?)s\b")


def parse_durations(text: str) -> List[Tuple[float, str, str]]:
    """``--durations`` lines as ``(seconds, phase, test id)``."""
    out = []
    for line in text.splitlines():
        m = _DURATION_RE.match(line)
        if m:
            out.append((float(m.group(1)), m.group(2), m.group(3)))
    return out


def parse_total_seconds(text: str) -> Optional[float]:
    """The wall total from pytest's final summary line, if present."""
    total = None
    for line in text.splitlines():
        if ("passed" in line or "failed" in line or "error" in line) and (
            line.strip().startswith("=") or " in " in line
        ):
            m = _TOTAL_RE.search(line)
            if m:
                total = float(m.group(1))
    return total


def projected_tier1_seconds(text: str) -> Tuple[Optional[float], str]:
    """(projection, provenance) for a tier-1 log."""
    total = parse_total_seconds(text)
    if total is not None:
        return total, "pytest summary wall total"
    durations = parse_durations(text)
    if durations:
        return sum(d[0] for d in durations), (
            f"sum of {len(durations)} --durations entries (no summary "
            "line found — partial log?)"
        )
    return None, "no pytest summary or --durations lines found"


def check_budget(log_path: Path, cap: float, threshold: float) -> List[str]:
    """Violation messages (empty = within budget)."""
    try:
        text = log_path.read_text(errors="replace")
    except OSError as exc:
        return [f"cannot read {log_path}: {exc}"]
    projected, provenance = projected_tier1_seconds(text)
    if projected is None:
        return [f"{log_path}: {provenance}"]
    budget = cap * threshold
    print(f"tier-1 projection: {projected:.1f}s ({provenance}); "
          f"budget {budget:.1f}s = {threshold:.0%} of the {cap:.0f}s cap")
    if projected > budget:
        heavy = sorted(parse_durations(text), reverse=True)[:10]
        hints = "".join(f"\n    {s:7.1f}s {phase:8s} {tid}"
                        for s, phase, tid in heavy)
        return [
            f"projected tier-1 time {projected:.1f}s exceeds "
            f"{threshold:.0%} of the {cap:.0f}s cap ({budget:.1f}s) — "
            f"move compile-heavy cases to the slow lane.  Heaviest:"
            + (hints or " (no --durations in log)")
        ]
    return []


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="blades_tpu_torch.tools.check_tier1_budget",
        description="tier-1 wall-time guard",
    )
    p.add_argument("--log", default="/tmp/_t1.log",
                   help="tier-1 pytest log (the tier-1 command's tee; add "
                   "--durations=N for hotspot hints)")
    p.add_argument("--cap", type=float, default=CAP_SECONDS,
                   help=f"tier-1 hard timeout in seconds (default "
                   f"{CAP_SECONDS:.0f})")
    p.add_argument("--threshold", type=float, default=THRESHOLD,
                   help="fail when projection exceeds this fraction of "
                   f"the cap (default {THRESHOLD})")
    args = p.parse_args(argv)

    problems = check_budget(Path(args.log), args.cap, args.threshold)
    for msg in problems:
        print(f"FAIL: {msg}", file=sys.stderr)
    if not problems:
        print("tier-1 budget: OK")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
