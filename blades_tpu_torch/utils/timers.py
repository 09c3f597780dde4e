"""Phase timers for the driver's result rows (counterpart of the
``Timers`` surface of ``blades_tpu/obs/trace.py``): ``time(name)`` as a
context manager, ``summary()`` as ``{name: {mean_s, total_s, count}}``.

On the card a phase ends with ``torch.cuda.synchronize()`` (``sync=True``),
so a host-clock phase time covers the device work it launched.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator

import torch


class Timers:
    def __init__(self, sync: bool = False):
        self._sync = sync
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def mean(self, name: str) -> float:
        c = self._counts.get(name, 0)
        return self._totals.get(name, 0.0) / c if c else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"mean_s": self.mean(k), "total_s": self._totals[k],
                    "count": self._counts[k]} for k in self._totals}
