"""trace-discipline: every measured second of the port flows through the
span layer.

:mod:`blades_tpu_torch.obs.trace` is the port's single timing source of
truth: phase durations are spans (they aggregate, nest and export to
Chrome traces), and the sanctioned raw clock is ``obs.trace.now()``.  A
raw ``time.time()`` / ``time.perf_counter()`` / ``time.monotonic()`` call
anywhere else under ``blades_tpu_torch/`` produces a duration nobody can
see in a trace.

Scope: ``blades_tpu_torch/`` only (``chip_smoke.py`` is a measuring
harness outside the traced training loop, as ``bench.py`` is for the JAX
lint).  The span layer itself is the allowed home.  Detection covers the
module-attribute form (``time.perf_counter()``), ``from time import
perf_counter`` aliases, and the ``_ns`` variants; ``time.sleep`` is not a
measurement and stays legal, as does passing ``time.perf_counter`` itself
as an injectable clock default (a reference, not a call).  Genuinely
sanctioned wall-clock stamps (the autotuner plan cache's
``created_unix``) carry the unified pragma with a reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set

from blades_tpu_torch.tools.lint import astutil
from blades_tpu_torch.tools.lint.core import Finding, LintContext, LintPass

#: Where raw clock reads are legal: the span layer.
TIMER_MODULES = ("blades_tpu_torch/obs/trace.py",)

#: ``time`` module attributes whose CALL is a duration/wall-clock read.
RAW_CLOCKS = frozenset({
    "time", "perf_counter", "monotonic",
    "time_ns", "perf_counter_ns", "monotonic_ns",
})

_HINT = ("time the block with a blades_tpu_torch.obs.trace span "
         "(Tracer.span/time, or start/finish around non-nestable "
         "blocks), or read obs.trace.now() for a bare elapsed delta; "
         "pragma the line only for a sanctioned wall-clock metadata "
         "stamp")


class TraceDisciplinePass(LintPass):
    name = "trace-discipline"
    doc = ("raw time.time()/perf_counter()/monotonic() calls in "
           "blades_tpu_torch/ outside the span layer")

    def __init__(self, prefixes: Optional[Sequence[str]] = None):
        self.prefixes = tuple(prefixes) if prefixes is not None \
            else ("blades_tpu_torch",)

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for src in ctx.matching(self.prefixes):
            if src.rel in TIMER_MODULES or src.tree is None:
                continue
            time_mods, clock_aliases = self._imports(src.imports)
            if not time_mods and not clock_aliases:
                continue
            for call in src.calls:
                cn = astutil.call_name(call)
                if cn is None:
                    continue
                if cn in clock_aliases:
                    findings.append(Finding(
                        self.name, src.rel, call.lineno,
                        f"raw clock call {cn}() (imported from the time "
                        "module) outside the span layer",
                        fix_hint=_HINT))
                    continue
                head, _, tail = cn.rpartition(".")
                if head in time_mods and tail in RAW_CLOCKS:
                    findings.append(Finding(
                        self.name, src.rel, call.lineno,
                        f"raw clock call {cn}() outside the span layer "
                        "— this duration is invisible to the span tree",
                        fix_hint=_HINT))
        return findings

    @staticmethod
    def _imports(imports):
        """(names the ``time`` module is bound to, names its clock
        functions are bound to) in this file — import-based, so a local
        variable or another module named ``time`` cannot false-positive."""
        time_mods: Set[str] = set()
        clock_aliases: Dict[str, str] = {}
        for node in imports:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        time_mods.add(alias.asname or alias.name)
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in RAW_CLOCKS:
                        clock_aliases[alias.asname or alias.name] = \
                            alias.name
        return time_mods, clock_aliases
