"""Seeds pure in a few integer words: the port's own random streams (the
round's, the fault injector's, the arrival process's, the async events',
the participation window's cohorts) each draw from a generator seeded
with :func:`seed_of` of the words that name them."""

from __future__ import annotations

import numpy as np
import torch


def seed_of(*words) -> int:
    """A 63-bit seed from non-negative integer ``words`` through numpy's
    ``SeedSequence`` (a word is taken modulo ``2**63``)."""
    ss = np.random.SeedSequence([int(w) & (2**63 - 1) for w in words])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


def generator_of(*words) -> torch.Generator:
    """A CPU generator seeded with :func:`seed_of` of ``words``."""
    return torch.Generator().manual_seed(seed_of(*words))
