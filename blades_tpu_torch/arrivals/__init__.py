"""Buffered-async execution (counterpart of ``blades_tpu/arrivals``):
serve continuous update traffic, not lockstep rounds.

- :mod:`.process`: the discrete-time Poisson arrival process, pure in
  ``(seed, tick)``;
- :mod:`.weights`: staleness weight schedules;
- :mod:`.buffer`: the bounded arrival buffer (events, not rows);
- :mod:`.cycle`: the aggregation cycle (per-event local rounds against
  the pulled params version from the history ring, staleness-weighted
  robust aggregation);
- :mod:`.engine`: the host driver (virtual clock, version vector, fault
  composition, checkpointable host state).

Configure with ``FedavgConfig().resources(execution="async").arrivals(...)``.
"""

from blades_tpu_torch.arrivals.buffer import ArrivalEvent, UpdateBuffer  # noqa: F401
from blades_tpu_torch.arrivals.engine import (  # noqa: F401
    AsyncEngine,
    AsyncSpec,
    expected_arrivals_per_sec,
    size_for_target,
)
from blades_tpu_torch.arrivals.process import ArrivalProcess  # noqa: F401
from blades_tpu_torch.arrivals.weights import (  # noqa: F401
    STALENESS_SCHEDULES,
    normalized_row_scale,
    staleness_weights,
)
