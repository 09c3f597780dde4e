"""Decentralized gossip federation (counterpart of ``blades_tpu/topology``):
static peer graphs with doubly-stochastic mixing
(:mod:`blades_tpu_torch.topology.graph`) and the per-node robust gossip
round behind ``execution="gossip"`` (:mod:`blades_tpu_torch.topology.gossip`).
"""

from blades_tpu_torch.faults.injector import EDGE_FOLD  # noqa: F401
from blades_tpu_torch.topology.graph import (  # noqa: F401
    GRAPHS,
    MIXINGS,
    NeighborTables,
    TopologyConfig,
    get_topology,
)
from blades_tpu_torch.topology.gossip import (  # noqa: F401
    GossipStep,
    gossip_evaluate,
    gossip_federation,
    gossip_step,
    node_head,
)
