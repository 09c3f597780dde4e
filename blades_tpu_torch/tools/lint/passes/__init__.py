"""blades-lint pass registry for the port.

Adding a pass: subclass :class:`blades_tpu_torch.tools.lint.core.LintPass`
in a module here, set ``name`` (the pragma token) and ``doc``, implement
``run``, and append an instance to :data:`ALL_PASSES`.  Fixture coverage
in ``tests/test_torch_lint.py`` (a known-bad + known-good pair under
``tests/lint_fixtures/torch/``) is part of the definition of done.

The passes keep the JAX lint's names, so one pragma serves both lints
where both scan a file (``tests/test_torch_*.py``).  Passes of the JAX
lint left out here:

- ``use-after-donate``, ``static-config``, ``prng-reuse`` and
  ``jit-purity`` are about ``jax.jit``, buffer donation and JAX keys;
  the port has no jit, donates nothing, and draws from
  ``torch.Generator`` objects, so they have no torch counterpart.
- ``slow-markers`` stays with the JAX lint, which already audits every
  file under ``tests/``, the port's tests included.
"""

from blades_tpu_torch.tools.lint.passes.artifacts import ArtifactStampsPass
from blades_tpu_torch.tools.lint.passes.host_sync import HostSyncPass
from blades_tpu_torch.tools.lint.passes.pass_discipline import (
    PassDisciplinePass,
)
from blades_tpu_torch.tools.lint.passes.schema_drift import SchemaDriftPass
from blades_tpu_torch.tools.lint.passes.topology_discipline import (
    TopologyDisciplinePass,
)
from blades_tpu_torch.tools.lint.passes.trace_discipline import (
    TraceDisciplinePass,
)

ALL_PASSES = (
    HostSyncPass(),
    SchemaDriftPass(),
    PassDisciplinePass(),
    TopologyDisciplinePass(),
    TraceDisciplinePass(),
    ArtifactStampsPass(),
)
