"""artifact-stamps: committed curves.json completeness claims must hold.

``complete: true`` in an accuracy-curve artifact means THE REFERENCE
GRID ran — all nine reference aggregators at {0,10,20,30}% malicious
for the artifact's client count — not merely "the rows this invocation
planned".  This pass recomputes the claim from the artifact's own rows
and refuses stale stamps; :mod:`blades_tpu_torch.tools.restamp_curves`
rewrites them.  It reads the artifacts and never writes them.

The reference-grid constants are read from the port's
``blades_tpu_torch/benchmarks/accuracy_curves.py`` by AST (single source
of truth, no torch import at lint time).
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from blades_tpu_torch.tools.lint.core import Finding, LintContext, LintPass

CURVES_MODULE = "blades_tpu_torch/benchmarks/accuracy_curves.py"
_FIXER = "python -m blades_tpu_torch.tools.restamp_curves "


def reference_grid(root: Path) -> Optional[Tuple[List[str], List[float]]]:
    """(REFERENCE_AGGREGATORS, REFERENCE_MALICIOUS_FRACS) parsed from the
    curves module, or None when the module is absent/unreadable."""
    path = root / CURVES_MODULE
    if not path.is_file():
        return None
    try:
        tree = ast.parse(path.read_text())
    except SyntaxError:
        return None
    found = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("REFERENCE_AGGREGATORS", "REFERENCE_MALICIOUS_FRACS"):
                try:
                    found[name] = ast.literal_eval(node.value)
                except ValueError:
                    return None
    if len(found) != 2:
        return None
    return found["REFERENCE_AGGREGATORS"], found["REFERENCE_MALICIOUS_FRACS"]


def reference_cells(aggregators: List[str], fracs: List[float],
                    num_clients: int) -> List[Tuple[str, int]]:
    mal = sorted({int(round(f * num_clients)) for f in fracs})
    return [(a, m) for a in aggregators for m in mal]


def recompute_stamps(data: dict, aggregators: List[str],
                     fracs: List[float]) -> dict:
    """The completeness stamps this artifact SHOULD carry, from its rows."""
    n = int(data.get("num_clients") or 0)
    cells = reference_cells(aggregators, fracs, n)
    ran = {(r.get("aggregator"), r.get("num_malicious"))
           for r in data.get("rows", [])}
    missing = sorted(f"{a}@{m}" for a, m in cells if (a, m) not in ran)
    stamps = {
        "reference_grid": {
            "aggregators": list(aggregators),
            "malicious": sorted({int(round(f * n)) for f in fracs}),
        },
        "reference_cells_missing": missing,
        "complete": not missing,
    }
    planned = data.get("planned")
    if isinstance(planned, dict):
        stamps["planned_complete"] = all(
            (a, m) in ran for a in planned.get("aggregators", [])
            for m in planned.get("malicious", []))
    return stamps


class ArtifactStampsPass(LintPass):
    name = "artifact-stamps"
    doc = "curves.json completeness stamps recomputed against their rows"

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        # Artifacts are repo-wide state, not files in the scanned set: a
        # partial scan (--changed, explicit paths) must not fail on a
        # curves.json nobody asked about — e.g. one a running sweep is
        # legitimately mid-rewrite.
        if ctx.partial:
            return []
        grid = reference_grid(ctx.root)
        art_dir = ctx.root / "artifacts"
        if grid is None or not art_dir.is_dir():
            return []
        aggregators, fracs = grid
        findings: List[Finding] = []
        for path in sorted(art_dir.rglob("curves.json")):
            rel = path.relative_to(ctx.root).as_posix()
            try:
                data = json.loads(path.read_text())
            except (OSError, json.JSONDecodeError) as exc:
                findings.append(Finding(
                    self.name, rel, 1, f"unreadable artifact: {exc}"))
                continue
            if not isinstance(data, dict) or "rows" not in data:
                continue
            want = recompute_stamps(data, aggregators, fracs)
            if "complete" not in data:
                findings.append(Finding(
                    self.name, rel, 1,
                    "artifact predates completeness stamping",
                    fix_hint=_FIXER + rel))
                continue
            if bool(data["complete"]) != want["complete"]:
                findings.append(Finding(
                    self.name, rel, 1,
                    f"stale complete: {data['complete']} stamp — the "
                    f"reference grid has {len(want['reference_cells_missing'])}"
                    " missing cell(s) "
                    f"{want['reference_cells_missing'][:4]}...",
                    fix_hint=_FIXER + rel))
            elif "reference_cells_missing" not in data:
                findings.append(Finding(
                    self.name, rel, 1,
                    "complete stamp predates reference-grid semantics "
                    "(no reference_cells_missing provenance)",
                    fix_hint=_FIXER + rel))
            elif sorted(data["reference_cells_missing"]) != \
                    want["reference_cells_missing"]:
                findings.append(Finding(
                    self.name, rel, 1,
                    "reference_cells_missing disagrees with the rows "
                    "actually present",
                    fix_hint=_FIXER + rel))
        return findings
