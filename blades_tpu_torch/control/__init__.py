"""Closed-loop control plane (counterpart of ``blades_tpu/control``):
watchdog events -> bounded actuator moves.

- :mod:`blades_tpu_torch.control.policy` — the PURE decision layer: a
  frozen :class:`ControlPolicy` rule table mapping watchdog rule names to
  bounded, one-directional actuator moves, plus the ``decide_*``
  functions shared by the live path and :func:`rederive_action`.
- :mod:`blades_tpu_torch.control.controller` — the per-trial
  :class:`Controller`: cooldowns, the quarantine-and-probe state
  machine, and the action journal, all threaded through checkpoints.

Arm it with ``config.control(enabled=True, ...)``; the driver applies
the actions to the async engine's setters
(:class:`~blades_tpu_torch.arrivals.AsyncEngine`).
"""

from blades_tpu_torch.control.controller import Controller  # noqa: F401
from blades_tpu_torch.control.policy import (  # noqa: F401
    ACTION_ACTUATORS,
    ACTUATOR_FAMILIES,
    DEFAULT_RULE_TABLE,
    LIFECYCLE_RULE,
    ControlAction,
    ControlPolicy,
    rederive_action,
)
