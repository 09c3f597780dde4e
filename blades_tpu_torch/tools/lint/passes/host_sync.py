"""host-sync: no card->host round trips inside the port's round modules.

Every ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
``.to("cpu")`` / ``synchronize()`` / numpy conversion /
``float(<tensor expr>)`` inside the modules whose code runs inside (or
builds) the round blocks the host until the card's queue drains, so the
next launches wait on the host instead of queueing behind the work in
flight — once a round, or worse, once a chunk.  The calls whose output
shape depends on the data (``.nonzero()``, ``torch.nonzero``,
``masked_select``, ``torch.unique``) sync the same way on CUDA: the host
must read the count before it can allocate the result.  Sanctioned flush
points live in HOST modules (``Fedavg.finalize_row``, the sweep's
batched emit, ``utils/async_metrics``), which are not scanned; a round
module's line that must sync carries
``# blades-lint: disable=host-sync — <why>``.

What it does not see: boolean-mask indexing (``x[mask]``, which syncs
on the mask's count like ``masked_select``), the implicit truth value of
a tensor (``if t:`` / ``while t.any():``, a ``.item()`` in disguise),
``print`` / f-string formatting of a tensor, ``.to(device)`` where the
device is a variable that names the CPU, and syncs inside a helper
defined in a module outside the list.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence

from blades_tpu_torch.tools.lint import astutil
from blades_tpu_torch.tools.lint.core import Finding, LintContext, LintPass

# Modules whose code runs inside (or builds) the round: the port
# counterpart of each of the JAX lint's DEVICE_SIDE modules, in its order.
DEVICE_SIDE = (
    "blades_tpu_torch/core/round.py",
    "blades_tpu_torch/core/server.py",
    "blades_tpu_torch/core/task.py",
    "blades_tpu_torch/core/health.py",
    "blades_tpu_torch/core/callbacks.py",
    "blades_tpu_torch/data/sampler.py",
    "blades_tpu_torch/data/augment.py",
    "blades_tpu_torch/adversaries/base.py",
    "blades_tpu_torch/adversaries/update_attacks.py",
    "blades_tpu_torch/adversaries/training_attacks.py",
    "blades_tpu_torch/faults/injector.py",
    "blades_tpu_torch/comm/codecs.py",
    # Buffered async: the cycle and the realization/weight modules run
    # inside the cycle; the host engine (arrivals/engine.py) is NOT here —
    # its fetch of the realization windows is the host boundary.
    "blades_tpu_torch/arrivals/cycle.py",
    "blades_tpu_torch/arrivals/process.py",
    "blades_tpu_torch/arrivals/weights.py",
    # Out-of-core state staging: the store + prefetcher ARE the staging
    # hot path; its host copies carry per-line pragmas.
    "blades_tpu_torch/state/store.py",
    "blades_tpu_torch/state/prefetch.py",
    # Out-of-core training data: the data store + the chunked evaluator.
    "blades_tpu_torch/data/store.py",
    "blades_tpu_torch/data/stream.py",
    # The client ledger's observe() runs once a round between rounds over
    # already-fetched rows; its coercions of those rows carry pragmas.
    "blades_tpu_torch/obs/ledger.py",
    # Control plane: decisions are pure over already-fetched sensor rows.
    "blades_tpu_torch/control/policy.py",
    "blades_tpu_torch/control/controller.py",
    "blades_tpu_torch/ops/aggregators.py",
    "blades_tpu_torch/ops/clustering.py",
    "blades_tpu_torch/ops/layout.py",
    "blades_tpu_torch/ops/masked.py",
    # The JAX package's three Pallas modules (pallas_round, pallas_rowstats,
    # pallas_select) map to the port's kernel wrappers: the finish and
    # the BN backward (pallas_round's pair), the row statistics, the
    # column selects.
    "blades_tpu_torch/ops/fused_finish.py",
    "blades_tpu_torch/ops/bn_backward.py",
    "blades_tpu_torch/ops/rowstats.py",
    "blades_tpu_torch/ops/column_select.py",
    "blades_tpu_torch/parallel/streamed.py",
    "blades_tpu_torch/parallel/streamed_geometry.py",
    "blades_tpu_torch/parallel/sharded.py",
    "blades_tpu_torch/parallel/dsharded.py",
    "blades_tpu_torch/parallel/packed.py",
    # Port only: the JAX rounds' collectives are traced into the program,
    # the port's are calls into these helpers from inside the round.
    "blades_tpu_torch/parallel/mesh.py",
    # The gossip round's per-node program.  graph.py is NOT here: it is
    # host-side numpy by design (tables are built once at setup).
    "blades_tpu_torch/topology/gossip.py",
)

_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "torch.cuda.synchronize"}
#: Methods that copy to the host (``.item()`` ... with no arguments).
_FETCH_METHODS = {"item", "tolist", "cpu", "numpy"}
#: Calls whose output shape depends on the data: the host reads a count.
_DATA_SHAPED = {"nonzero", "masked_select", "unique"}
#: Attribute roots whose presence inside a float()/int()/bool() argument
#: marks the argument as a tensor expression.
_ARRAY_ROOTS = {"torch"}
_REDUCTIONS = {"sum", "mean", "max", "min", "all", "any", "prod", "norm",
               "amax", "amin", "count_nonzero"}

_HINT = ("move the fetch to a sanctioned flush point (Fedavg's "
         "finalize_row / the sweep's batched emit / utils.async_metrics), "
         "or pragma the line if it is genuinely setup-time, a "
         "once-per-round flush, or host staging")


def _is_array_expr(node: ast.AST) -> bool:
    """Heuristic: does this expression produce a tensor?  True when it
    mentions a ``torch.`` attribute or calls a tensor reduction method
    (``x.sum()`` ...)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            root = sub
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id in _ARRAY_ROOTS:
                return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _REDUCTIONS:
            return True
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` (any further arguments)."""
    vals = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)


def _sync_message(call: ast.Call) -> Optional[str]:
    """What kind of host sync this call is, or None."""
    cn = astutil.call_name(call)
    if cn in _SYNC_CALLS:
        return f"host-sync call {cn}() in a round module"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        bare = not call.args and not call.keywords
        if attr in _FETCH_METHODS and bare:
            return f".{attr}() in a round module"
        if attr == "synchronize":
            return f"{cn or attr}() drains the card's queue in a round module"
        if attr == "to" and _to_cpu(call):
            return '.to("cpu") in a round module'
        if attr in _DATA_SHAPED and (cn or "").split(".")[0] not in (
                "np", "numpy"):
            return (f"{cn or attr}() has a data-dependent shape and syncs "
                    "on the card in a round module")
    if (isinstance(call.func, ast.Name)
            and call.func.id in ("float", "int", "bool")
            and len(call.args) == 1 and _is_array_expr(call.args[0])):
        return (f"{call.func.id}() on a tensor expression forces a sync "
                "in a round module")
    return None


class HostSyncPass(LintPass):
    name = "host-sync"
    doc = ("card->host sync (.item() / .cpu() / .tolist() / np.asarray / "
           "synchronize() / float(tensor) / nonzero()) in round modules")

    def __init__(self, modules: Optional[Sequence[str]] = None):
        self.modules = tuple(modules) if modules is not None else DEVICE_SIDE

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        scanning_repo = (ctx.root / "blades_tpu_torch").is_dir() \
            and self.modules is DEVICE_SIDE
        for rel in self.modules:
            src = ctx.file(rel)
            if src is None:
                # Partial scans (--changed / explicit paths) simply skip
                # absent modules; a module GONE from disk on a full scan
                # means this list went stale.
                if scanning_repo and not (ctx.root / rel).exists():
                    findings.append(Finding(
                        self.name, rel, 1,
                        "host-sync module list is stale: file is gone",
                        fix_hint="update DEVICE_SIDE in blades_tpu_torch/"
                                 "tools/lint/passes/host_sync.py"))
                continue
            if src.tree is None:
                continue
            for call in src.calls:
                msg = _sync_message(call)
                if msg is not None:
                    findings.append(Finding(
                        self.name, src.rel, call.lineno, msg,
                        fix_hint=_HINT))
        return findings
