"""blades-lint for the port: static analysis of the PyTorch port's
load-bearing invariants (counterpart of the JAX package's ``tools/lint``).

The bug classes here are the ones that cost the card time or make a
number wrong without failing a test: a host sync inside the round (the
launch queue drains once a round), a raw clock outside the span layer, a
collective the recorders do not count, a full traversal or a decode to
f32 outside the pass planner, a metric key the schema does not register,
and a stale artifact stamp.

CLI::

    python -m blades_tpu_torch.tools.lint              # the port's tree
    python -m blades_tpu_torch.tools.lint --changed    # files changed vs HEAD
    python -m blades_tpu_torch.tools.lint --json       # machine-readable

Tier-1 enforcement: ``tests/test_torch_lint.py`` runs every pass over
the tree and fails on new ERROR findings.  Suppression:
``# blades-lint: disable=<pass> — <reason>`` (see
:mod:`blades_tpu_torch.tools.lint.core`).  Nothing here imports ``torch``
or JAX.
"""

from blades_tpu_torch.tools.lint.core import (  # noqa: F401
    ERROR,
    WARNING,
    Finding,
    LintContext,
    LintPass,
    SourceFile,
    collect_files,
    run_passes,
)
