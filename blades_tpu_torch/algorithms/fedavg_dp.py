"""FedAvg-DP (counterpart of ``blades_tpu/algorithms/fedavg_dp.py``).

The differential-privacy variant of :class:`FedavgConfig`: from the
privacy budget ``(epsilon, delta)`` and the clip threshold it sets the
round's per-client clip + Gaussian noise
(:meth:`~blades_tpu_torch.core.round.FedRound.apply_dp`), with the
reference's noise multiplier ``sigma = sensitivity * sqrt(2 ln(1.25 /
delta)) / epsilon``, ``sensitivity = 2 * clip / train_batch_size``.
"""

from __future__ import annotations

import math

from blades_tpu_torch.algorithms.config import FedavgConfig


class FedavgDPConfig(FedavgConfig):
    """:class:`FedavgConfig` with the privacy budget: ``dp_epsilon``
    (default 1.0), ``dp_delta`` (1e-6) and ``dp_clip_threshold`` (1.0)."""

    _EXTRA_FIELDS = {"dp_epsilon": 1.0, "dp_delta": 1e-6}

    def __init__(self, algo_class=None):
        super().__init__(algo_class)
        self.dp_clip_threshold = 1.0

    def privacy(self, *, epsilon=None, delta=None, clip_threshold=None):
        return self._set(dp_epsilon=epsilon, dp_delta=delta,
                         dp_clip_threshold=clip_threshold)

    @property
    def noise_factor(self) -> float:
        """The noise std over the clip threshold: the round scales it by
        the threshold, so the product is the reference's sigma."""
        sensitivity = 2.0 * self.dp_clip_threshold / self.train_batch_size
        sigma = (sensitivity * math.sqrt(2.0 * math.log(1.25 / self.dp_delta))
                 / self.dp_epsilon)
        return sigma / self.dp_clip_threshold

    def validate(self) -> None:
        super().validate()
        if self.dp_epsilon <= 0 or not 0 < self.dp_delta < 1:
            raise ValueError("DP requires epsilon > 0 and 0 < delta < 1")
        self.dp_noise_factor = self.noise_factor
