"""Algorithm layer: the config builder and the FedAvg driver (counterpart of
``blades_tpu/algorithms/``).  ``FedavgConfig`` -> ``.build()`` ->
``Fedavg``, whose ``train()`` runs one round and returns its result row."""

from blades_tpu_torch.algorithms.config import FedavgConfig  # noqa: F401
from blades_tpu_torch.algorithms.fedavg import Fedavg  # noqa: F401
from blades_tpu_torch.algorithms.registry import (  # noqa: F401
    ALGORITHMS,
    get_algorithm_class,
)
