"""Defense forensics: Byzantine-detection quality as device scalars
(counterpart of ``blades_tpu/obs/forensics.py``).

Every robust aggregator makes a per-lane keep/trim/trust decision each
round (``Aggregator.diagnose`` in :mod:`blades_tpu_torch.ops.aggregators`).
Against the ground truth -- the ``malicious`` lane mask the round already
carries -- that decision is a binary classifier, and its confusion matrix
is a handful of tensor reductions on the card: ``benign_mask`` says whom
the defense kept, ``malicious`` whom it should have dropped.

Scoring convention: a lane OUTSIDE ``benign_mask`` counts as *flagged*
(predicted Byzantine).  Coordinate-wise aggregators that never exclude a
whole lane (Mean, Median, GeoMed) flag nobody and score recall 0: that is
the finding ("this defense cannot attribute blame"), not a metrics bug.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def detection_metrics(benign_mask: torch.Tensor, malicious: torch.Tensor,
                      participation: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Confusion-matrix scalars of one round's lane decision.

    ``benign_mask`` (n,) bool: the lanes the aggregator kept;
    ``malicious`` (n,) bool: the Byzantine lanes.  With ``participation``
    (the fault injector's (n,) mask) only the lanes that delivered an
    update are scored: a malicious client that dropped out was neither
    caught nor missed.

    Returns f32 scalars ``byz_precision`` (of the flagged lanes, the share
    truly malicious; 1.0 when none is flagged), ``byz_recall`` (of the
    malicious lanes, the share flagged; 1.0 when there are none),
    ``byz_fpr`` (the share of benign lanes flagged) and the int32
    ``num_flagged``.
    """
    flagged = ~benign_mask.bool()
    mal = malicious.to(flagged.device).bool()
    if participation is not None:
        part = participation.to(flagged.device).bool()
        flagged = flagged & part
        mal = mal & part
        benign_lanes = part & ~mal
    else:
        benign_lanes = ~mal
    tp = (flagged & mal).sum().float()
    fp = (flagged & ~mal).sum().float()
    n_flagged = tp + fp
    n_mal = mal.sum().float()
    n_benign = benign_lanes.sum().float()
    one = torch.ones((), device=flagged.device)
    # Tensor divisors: ATen divides by a scalar as a multiply by its
    # reciprocal, which is not a division.
    return {
        "byz_precision": torch.where(n_flagged > 0,
                                     tp / n_flagged.clamp(min=1.0), one),
        "byz_recall": torch.where(n_mal > 0, tp / n_mal.clamp(min=1.0), one),
        "byz_fpr": fp / n_benign.clamp(min=1.0),
        "num_flagged": n_flagged.to(torch.int32),
    }
