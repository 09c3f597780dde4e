"""schema-drift: round-record keys vs the port's obs schema, both
directions.

``blades_tpu_torch/obs/schema.py`` is the contract every downstream
consumer (the validators, the report tools, dashboards) parses; the
strict validator already rejects unknown keys AT RUNTIME — but only on
code paths a test happens to drive.  This pass closes the gap
statically, in both directions:

* **stamped-but-unregistered (error)** — a constant string key stored
  into a host-side round-record dict (``row[...] = ``, ``row.update({``
  ``...})``, the codec's ``round_metrics`` literal, the logger's
  ``base=`` stamp) that ``ROUND_RECORD_FIELDS`` does not register would
  fail schema validation the first time that config runs.
* **registered-but-never-stamped (warning)** — a registered key no
  stamp site produces is either dead weight or stamped through a
  dynamic path the analysis cannot see; the registration line carries a
  pragma naming that path when it is the latter.

Stamp collection covers: constant-key subscript stores and dict
literals bound to row-like names (``row``/``comm_row``/``rec``/
``_last_eval``), ``row.update({...})`` literals, ``for k in ("a", "b"):
row[k] = ...`` literal loops, dict literals returned by functions named
``round_metrics``, and ``base={...}`` logger keywords.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from blades_tpu_torch.tools.lint import astutil
from blades_tpu_torch.tools.lint.core import (
    WARNING,
    Finding,
    LintContext,
    LintPass,
)

SCHEMA_MODULE = "blades_tpu_torch/obs/schema.py"
SCHEMA_TABLE = "ROUND_RECORD_FIELDS"

# Host modules that stamp round-record (metrics.jsonl / result.json row)
# keys.  Device-side metrics dicts (core/round.py) are NOT records — the
# trainer copies the schema'd subset host-side.
STAMP_MODULES = (
    "blades_tpu_torch/algorithms/fedavg.py",
    "blades_tpu_torch/tune/sweep.py",
    "blades_tpu_torch/tune/lanes.py",
    "blades_tpu_torch/comm/codecs.py",
    # round_fields() builds the per-round ledger stamp (`rec` dict
    # literal) that fedavg merges into the row verbatim.
    "blades_tpu_torch/obs/ledger.py",
)
_ROW_NAMES = {"row", "comm_row", "rec", "record", "_last_eval"}
_DICT_RETURN_FNS = {"round_metrics"}


def _basename(path: str) -> str:
    return path.split(".")[-1]


class SchemaDriftPass(LintPass):
    name = "schema-drift"
    doc = "metric keys stamped into rows vs obs/schema.py registrations"

    def __init__(self, schema_module: str = SCHEMA_MODULE,
                 stamp_modules: Optional[Sequence[str]] = None):
        self.schema_module = schema_module
        self.stamp_modules = (tuple(stamp_modules)
                              if stamp_modules is not None else STAMP_MODULES)

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        schema_src = ctx.file(self.schema_module)
        if schema_src is None or schema_src.tree is None:
            return []  # partial scan without the schema: nothing to check
        registered = self._registered(schema_src.tree)
        if not registered:
            return []
        stamped: Dict[str, Tuple[str, int]] = {}
        findings: List[Finding] = []
        all_stamp_modules_seen = True
        for rel in self.stamp_modules:
            src = ctx.file(rel)
            if src is None or src.tree is None:
                all_stamp_modules_seen = False
                continue
            for key, line in self._stamped_keys(src.nodes):
                stamped.setdefault(key, (src.rel, line))
        for key, (rel, line) in sorted(stamped.items()):
            if key not in registered:
                findings.append(Finding(
                    self.name, rel, line,
                    f"metric key '{key}' is stamped into round records "
                    "but not registered in obs/schema.py — strict "
                    "validation rejects the row at runtime",
                    fix_hint="register it in ROUND_RECORD_FIELDS (types + "
                             "required flag) or rename to a registered key"))
        # The never-stamped direction needs EVERY stamp module in view —
        # on a partial scan (--changed) absent modules would make every
        # registered key look orphaned.
        if not all_stamp_modules_seen:
            return findings
        for key, line in sorted(registered.items()):
            if key not in stamped:
                findings.append(Finding(
                    self.name, self.schema_module, line,
                    f"registered metric key '{key}' is never stamped by "
                    "any known round-record site",
                    fix_hint="drop the registration, or pragma the line "
                             "naming the dynamic stamp path",
                    severity=WARNING))
        return findings

    # -- schema side --------------------------------------------------------

    def _registered(self, tree: ast.Module) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for node in tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t for t in node.targets
                           if isinstance(t, ast.Name)]
                value = node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = ([node.target]
                           if isinstance(node.target, ast.Name) else [])
                value = node.value
            else:
                continue
            if not any(t.id == SCHEMA_TABLE for t in targets):
                continue
            if isinstance(value, ast.Dict):
                for k in value.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                            k.value, str):
                        out[k.value] = k.lineno
        return out

    # -- stamp side ---------------------------------------------------------

    def _stamped_keys(self, nodes) -> Iterable[Tuple[str, int]]:
        # Literal `for k in ("a", "b")` loop vars, scoped by loop node: a
        # `row[k] = ...` store takes the keys of the loop that binds its k.
        loop_keys: Dict[int, List[str]] = {}
        for node in nodes:
            if isinstance(node, ast.For) and isinstance(
                    node.target, ast.Name):
                lits = self._const_str_seq(node.iter)
                if not lits:
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Subscript) and isinstance(
                            sub.slice, ast.Name) \
                            and sub.slice.id == node.target.id:
                        loop_keys.setdefault(id(sub), []).extend(lits)
        for node in nodes:
            # row["key"] = ... / row[k] = ... inside a literal loop
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        base = astutil.dotted(t.value)
                        if base is None or _basename(base) not in _ROW_NAMES:
                            continue
                        if isinstance(t.slice, ast.Constant) and isinstance(
                                t.slice.value, str):
                            yield t.slice.value, t.lineno
                        else:
                            for key in loop_keys.get(id(t), []):
                                yield key, t.lineno
                    else:
                        base = astutil.dotted(t)
                        if base is not None \
                                and _basename(base) in _ROW_NAMES:
                            yield from self._dict_keys(node.value)
            # row.update({...})
            elif isinstance(node, ast.Call):
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "update":
                    base = astutil.dotted(node.func.value)
                    if base is not None and _basename(base) in _ROW_NAMES \
                            and node.args:
                        yield from self._dict_keys(node.args[0])
                for kw in node.keywords:
                    if kw.arg == "base":
                        yield from self._dict_keys(kw.value)
        # dict literals returned from round_metrics-style functions
        for fn in astutil.function_defs(nodes):
            if fn.name not in _DICT_RETURN_FNS:
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    yield from self._dict_keys(sub.value)

    @classmethod
    def _dict_keys(cls, d: ast.AST) -> Iterable[Tuple[str, int]]:
        """Constant keys of a dict literal, or of a comprehension over a
        literal key tuple (``{k: ev[k] for k in ("a", "b")}``)."""
        if isinstance(d, ast.Dict):
            for k in d.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    yield k.value, k.lineno
        elif isinstance(d, ast.DictComp) and len(d.generators) == 1:
            gen = d.generators[0]
            if isinstance(d.key, ast.Name) and isinstance(
                    gen.target, ast.Name) and d.key.id == gen.target.id:
                for key in cls._const_str_seq(gen.iter):
                    yield key, d.lineno

    @staticmethod
    def _const_str_seq(node: ast.AST) -> List[str]:
        if isinstance(node, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.elts):
            return [e.value for e in node.elts]
        return []
