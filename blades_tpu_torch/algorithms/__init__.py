"""Algorithm layer: the configs (FedAvg, FedAvg-DP) and the ``Fedavg``
algorithm (counterpart of ``blades_tpu/algorithms/``).  ``FedavgConfig`` (or
``FedavgDPConfig``) -> ``.build()`` -> ``Fedavg``, whose ``train()`` runs
one round and returns its result row."""

from blades_tpu_torch.algorithms.config import FedavgConfig  # noqa: F401
from blades_tpu_torch.algorithms.fedavg import Fedavg  # noqa: F401
from blades_tpu_torch.algorithms.fedavg_dp import FedavgDPConfig  # noqa: F401
from blades_tpu_torch.algorithms.registry import (  # noqa: F401
    ALGORITHMS,
    get_algorithm_class,
)
