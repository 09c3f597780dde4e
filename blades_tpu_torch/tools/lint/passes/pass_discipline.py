"""streamed-pass-discipline: raw full traversals and decodes stay behind
the pass planner.

The port's row statistics are one kernel launch over the whole streamed
update matrix: :func:`blades_tpu_torch.ops.rowstats.row_stats_bundle`
(and its plain version) reads every row once, however many statistics it
is handed.  The pass planner
(``blades_tpu_torch/parallel/streamed_geometry.py``'s ``PassPlanner``)
exists so that the statistics an aggregator needs at the same point of
its dataflow go into ONE bundle; a direct bundle call from outside the
planner silently re-introduces a dedicated traversal, the regression the
``hbm_passes`` metric counts.

The same discipline covers the wire domain's decode-to-f32 primitive
(:func:`blades_tpu_torch.comm.codecs.dequantize`): a wire-domain round
aggregates the PACKED int8 payload, and a stray full-matrix
``dequantize()`` call outside the codec module and the planner module
silently reverts its 4x memory saving, the regression the
``dequant_rows`` metric counts.  The sanctioned non-planner sites (the
round's forge materialization in ``core/round.py``) carry the pragma
with its justification.

Detection is import-based, so same-named helpers in other modules never
false-positive: a call is flagged only when the name was imported from
the primitive's module (the row-statistics module, the planner module,
or the codec module for ``dequantize``), or accessed as an attribute of
it.  Reference and kernel tests that exercise the raw primitives on
purpose carry the unified pragma
(``# blades-lint: disable=streamed-pass-discipline — <why>``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List

from blades_tpu_torch.tools.lint import astutil
from blades_tpu_torch.tools.lint.core import Finding, LintContext, LintPass

#: The planner module — the only place raw traversals may be spelled.
PLANNER_MODULE = "blades_tpu_torch/parallel/streamed_geometry.py"

#: Raw single-bundle traversal primitives by home module (each call = one
#: full pass over the matrix).  The planner's ``aggregate_streamed`` /
#: ``forge_streamed`` / ``aggregate_coordwise`` / ``aggregate_wire`` are
#: sanctioned planner-counted entry points and deliberately absent.
RAW_PRIMITIVES: Dict[str, frozenset] = {
    "blades_tpu_torch.ops.rowstats": frozenset({
        "row_stats_bundle", "row_stats_bundle_plain"}),
}

#: The codec module — home of the wire domain's decode-to-f32 primitive.
#: ``dequantize`` may be spelled there and in the planner module (whose
#: scale algebra IS the sanctioned dequantization); anywhere else a call
#: is a full-matrix f32 materialization that defeats the wire domain.
CODEC_MODULE = "blades_tpu_torch/comm/codecs.py"
_DECODERS = frozenset({"dequantize"})
RAW_DECODERS: Dict[str, frozenset] = {
    "blades_tpu_torch.comm.codecs": _DECODERS,
}

_HINT = ("submit the statistic as a PassPlanner request "
         "(streamed_geometry.PassPlanner) so it shares the round's one "
         "bundle, or pragma the line if it is a deliberate "
         "reference-path use")

_DECODE_HINT = ("aggregate the packed payload through "
                "streamed_geometry.aggregate_wire (the planner applies "
                "the wire scales algebraically, per statistic) instead "
                "of materializing the dense f32 matrix, or pragma the "
                "line if the full decode is deliberate and counted")


class PassDisciplinePass(LintPass):
    name = "streamed-pass-discipline"
    doc = ("raw row-statistics traversals (and the codec decode-to-f32 "
           "primitive) called outside the pass planner / codec modules")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for src in ctx.files:
            if src.rel == PLANNER_MODULE or src.tree is None:
                continue
            table = dict(RAW_PRIMITIVES)
            if src.rel != CODEC_MODULE:
                table.update(RAW_DECODERS)
            fn_aliases, mod_aliases = self._imports(src.imports, table)
            if not (fn_aliases or mod_aliases):
                continue
            for call in src.calls:
                cn = astutil.call_name(call)
                if cn is None:
                    continue
                head, _, tail = cn.rpartition(".")
                name = fn_aliases.get(cn) or (
                    tail if tail in mod_aliases.get(head, ()) else None)
                if name is None:
                    continue
                if name in _DECODERS:
                    findings.append(Finding(
                        self.name, src.rel, call.lineno,
                        f"raw decode-to-f32 call {cn}() (full-matrix "
                        "dequantization) outside the codec/planner "
                        "modules", fix_hint=_DECODE_HINT))
                else:
                    findings.append(Finding(
                        self.name, src.rel, call.lineno,
                        f"direct raw-traversal call {cn}() (one full pass "
                        "over the matrix) outside the pass planner module",
                        fix_hint=_HINT))
        return findings

    @staticmethod
    def _imports(imports, table: Dict[str, frozenset]):
        """({alias: primitive name}, {module alias: its primitive names})
        bound in this file — including ``import ... as`` renames, ``from
        <package> import <module>`` and the dotted module paths."""
        fn_aliases: Dict[str, str] = {}
        mod_aliases: Dict[str, frozenset] = {}
        for node in imports:
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if alias.name in table.get(node.module, ()):
                        fn_aliases[bound] = alias.name
                    full = f"{node.module}.{alias.name}"
                    if full in table:
                        mod_aliases[bound] = table[full]
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name in table:
                        mod_aliases[alias.asname or alias.name] = \
                            table[alias.name]
        return fn_aliases, mod_aliases
