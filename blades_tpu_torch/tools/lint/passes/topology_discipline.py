"""topology-discipline: every cross-rank exchange goes through the
counted helpers of ``parallel/mesh.py``.

The port's multi-rank rounds (client-sharded, hierarchical,
width-sharded, gossip) move their bytes through the helpers of
``blades_tpu_torch/parallel/mesh.py``, which the recorders count, so the
``ici_bytes`` / ``gossip_ici_bytes`` stamps reconcile against the comm
model (``parallel/comm_model.py``).  A raw ``torch.distributed``
collective anywhere else in the port is an UNCOUNTED exchange: the bytes
a row reports stop covering the bytes the round moved.  This is the
counterpart of the JAX lint's pass of the same name, which confines raw
``lax`` collectives against the topology tables to the gossip program;
in the port every collective is a host call, so the rule covers them all.

Detection is import-based: a call is flagged when its callee is a
collective reached through ``torch.distributed`` (``import
torch.distributed as dist``, ``from torch import distributed``, ``from
torch.distributed import all_reduce``, or the dotted path).  Scope:
``blades_tpu_torch/`` (``chip_smoke.py``'s rank checks are not round
code).  A collective that moves no bytes the rows report carries the
unified pragma (``# blades-lint: disable=topology-discipline — <why>``).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from blades_tpu_torch.tools.lint import astutil
from blades_tpu_torch.tools.lint.core import Finding, LintContext, LintPass

#: The one module whose helpers may spell raw collectives.
MESH_MODULE = "blades_tpu_torch/parallel/mesh.py"

_DIST = "torch.distributed"
#: Collective names, by prefix (``all_gather`` covers
#: ``all_gather_object`` / ``all_gather_into_tensor`` ...).
_PREFIXES = ("all_gather", "all_reduce", "all_to_all", "broadcast",
             "gather", "scatter", "reduce", "barrier", "monitored_barrier")
_EXACT = frozenset({"send", "recv", "isend", "irecv", "batch_isend_irecv"})

_HINT = ("route the exchange through a parallel/mesh.py helper (counted "
         "on the round's recorder, so ici_bytes keeps reconciling "
         "against parallel/comm_model.py), or pragma the line if the "
         "collective moves no bytes the rows report")


def _is_collective(name: str) -> bool:
    return name in _EXACT or name.startswith(_PREFIXES)


class TopologyDisciplinePass(LintPass):
    name = "topology-discipline"
    doc = ("raw torch.distributed collectives in blades_tpu_torch/ "
           "outside the counted helpers of parallel/mesh.py")

    def __init__(self, prefixes: Optional[Sequence[str]] = None):
        self.prefixes = tuple(prefixes) if prefixes is not None \
            else ("blades_tpu_torch",)

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for src in ctx.matching(self.prefixes):
            if src.rel == MESH_MODULE or src.tree is None:
                continue
            mods, fns = self._imports(src.imports)
            if not mods and not fns:
                continue
            for call in src.calls:
                cn = astutil.call_name(call)
                if cn is None:
                    continue
                head, _, tail = cn.rpartition(".")
                if cn in fns or (head in mods and _is_collective(tail)):
                    findings.append(Finding(
                        self.name, src.rel, call.lineno,
                        f"raw collective {cn}() outside parallel/mesh.py "
                        "— an exchange the round's recorder does not count",
                        fix_hint=_HINT))
        return findings

    @staticmethod
    def _imports(imports) -> Tuple[Set[str], Set[str]]:
        """(names ``torch.distributed`` is bound to, names its collectives
        are bound to) in this file."""
        mods: Set[str] = set()
        fns: Set[str] = set()
        for node in imports:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == _DIST:
                        mods.add(alias.asname or alias.name)
                    elif alias.name.startswith(_DIST + ".") \
                            or alias.name == "torch":
                        # `import torch` binds torch.distributed's path.
                        mods.add(_DIST)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "torch":
                    mods.update(a.asname or a.name for a in node.names
                                if a.name == "distributed")
                elif node.module == _DIST:
                    fns.update(a.asname or a.name for a in node.names
                               if _is_collective(a.name))
        return mods, fns
