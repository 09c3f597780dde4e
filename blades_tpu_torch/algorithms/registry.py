"""Algorithm registry (counterpart of ``blades_tpu/algorithms/registry.py``)."""

from __future__ import annotations


def _fedavg():
    from blades_tpu_torch.algorithms.config import FedavgConfig
    from blades_tpu_torch.algorithms.fedavg import Fedavg

    return Fedavg, FedavgConfig


ALGORITHMS = {"FEDAVG": _fedavg}
_LATER = {"FEDAVG_DP"}


def get_algorithm_class(name: str, return_config: bool = False):
    """The driver class of ``name`` (with a fresh config when
    ``return_config``)."""
    key = name.upper()
    if key in _LATER:
        raise NotImplementedError(f"{name} is not in the port yet (a later "
                                  "slice)")
    if key not in ALGORITHMS:
        raise KeyError(f"unknown algorithm {name!r}; known: "
                       f"{sorted(ALGORITHMS)}")
    cls, cfg_cls = ALGORITHMS[key]()
    if return_config:
        return cls, cfg_cls()
    return cls
