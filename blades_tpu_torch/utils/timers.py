"""The driver's phase timers: :class:`~blades_tpu_torch.obs.trace.Timers`,
an un-armed span tracer (``time(name)`` as a context manager,
``summary()`` as ``{name: {mean_s, total_s, count}}``), as the JAX
package's ``utils/timers.py`` re-exports its span layer's."""

from blades_tpu_torch.obs.trace import Timers  # noqa: F401
