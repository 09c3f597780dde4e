"""Round-pipeline performance layer (counterpart of ``blades_tpu/perf``).

- :mod:`blades_tpu_torch.perf.autotune` -- the execution autotuner:
  measured plan selection over the round pipeline's knobs (execution
  path, streamed ``d_chunk``, lane-packing, scan windows, prefetch) with
  a persistent on-disk plan cache.
- :mod:`blades_tpu_torch.perf.compile_cache` -- the kernel build cache's
  directory and hit / miss counters, and the static-config
  :func:`fingerprint` that keys the plan cache.  The port has no
  ahead-of-time compile, so the JAX module's executable cache, its
  ``cached_jit`` and the persistent XLA cache have no counterpart.
- :func:`flush_rows` (:mod:`blades_tpu_torch.utils.async_metrics`) --
  batched device-to-host fetches of deferred rows.
- :class:`blades_tpu_torch.data.prefetch.BatchPrefetcher` (sibling) --
  the dense round's next-round batch staging.
"""

from blades_tpu_torch.perf.autotune import (  # noqa: F401
    Plan,
    PlanCache,
    PlanSpace,
    apply_plan,
    enumerate_plans,
    select_plan,
    timed_measure_fn,
)
from blades_tpu_torch.perf.compile_cache import (  # noqa: F401
    cache_stats,
    clear_cache,
    fingerprint,
    set_cache_dir,
)
from blades_tpu_torch.utils.async_metrics import flush_rows  # noqa: F401
