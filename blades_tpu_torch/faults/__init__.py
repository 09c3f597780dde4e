"""Faults (counterpart of ``blades_tpu/faults/``): the in-round fault
injector (:mod:`~blades_tpu_torch.faults.injector`) and the sweep
runner's host-level fault handling (:mod:`~blades_tpu_torch.faults.host`)."""

from blades_tpu_torch.faults.injector import FaultInjector  # noqa: F401
