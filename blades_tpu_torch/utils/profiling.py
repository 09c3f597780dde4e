"""Profiler capture and named regions (counterpart of
``blades_tpu/utils/profiling.py``, a shim over the span layer):
:func:`~blades_tpu_torch.obs.trace.trace` captures a ``torch.profiler``
trace into a directory, :func:`~blades_tpu_torch.obs.trace.annotate`
names a region inside it.  The JAX shim's ``xla_dump_flags`` (an
``XLA_FLAGS`` value that dumps HLO) has no counterpart: the port compiles
no XLA program."""

from blades_tpu_torch.obs.trace import annotate, trace  # noqa: F401
