"""Topology-scoped adversaries for the decentralized gossip round
(counterpart of ``blades_tpu/adversaries/topology_attacks.py``).

Centralized attacks are broadcast by construction: one forged ``(n, d)``
matrix is what the single server aggregates.  On a peer graph a
malicious node controls only what IT transmits — its out-edges — so the
natural threat model is per-RECEIVER: every benign node sees a different
update matrix, forged rows appearing only where an attacker's edge
points.  :class:`TopologyAttackAdversary` expresses exactly that: it
wraps any registered update-FORGING attack (default ALIE) for the forged
row content, and exposes the receiver restriction
(:meth:`receiver_mask`) that :mod:`blades_tpu_torch.topology.gossip`
applies when it builds each node's neighborhood matrix:

- **out-edge poisoning** (default): node ``j``'s forged row reaches
  receiver ``i`` iff the edge ``j -> i`` exists.  An attacker's own
  neighborhood view keeps its clean self-row (it knows its own model).
- **eclipse targeting** (``eclipse_target=i``): the forged rows reach
  ONLY node ``i`` — the attackers throw their whole weight at eclipsing
  one victim's neighborhood while looking benign to everyone else.

The training hooks delegate to the wrapped attack, so a training-side
base (SignFlip) also composes: its corruption happens in-lane and the
receiver mask is then irrelevant (every receiver sees the one truthful,
already-corrupted update).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from blades_tpu_torch.adversaries.base import Adversary


@dataclasses.dataclass(frozen=True)
class TopologyAttackAdversary(Adversary):
    """Per-receiver poisoning over the gossip peer graph.

    base: the wrapped attack — a registered adversary name / spec dict /
        instance (``get_adversary`` resolution).  Its
        ``on_updates_ready`` supplies the forged row CONTENT; this class
        supplies the receiver SCOPE.
    eclipse_target: restrict the forged rows to this one receiver node
        (None = every out-edge neighbor).
    """

    num_clients: int = 60
    num_byzantine: int = 0
    base: Any = "ALIE"
    eclipse_target: Optional[int] = None
    #: The gossip round keys its per-receiver matrices on this marker.
    topology_scoped = True

    def __post_init__(self):
        from blades_tpu_torch.adversaries import get_adversary

        if (self.eclipse_target is not None
                and not 0 <= int(self.eclipse_target) < self.num_clients):
            raise ValueError(
                f"eclipse_target={self.eclipse_target} is not a node index "
                f"in [0, {self.num_clients})")
        resolved = get_adversary(self.base, num_clients=self.num_clients,
                                 num_byzantine=self.num_byzantine)
        if isinstance(resolved, TopologyAttackAdversary):
            raise ValueError("TopologyAttack cannot wrap itself")
        object.__setattr__(self, "_base", resolved)

    # -- delegated hooks -----------------------------------------------------

    def data_hook(self, x, y, malicious):
        return self._base.data_hook(x, y, malicious)

    def grad_hook(self, grads, malicious):
        return self._base.grad_hook(grads, malicious)

    def on_updates_ready(self, updates, malicious, *, noise=None,
                         generator=None, aggregator=None, shard=None):
        return self._base.on_updates_ready(
            updates, malicious, noise=noise, generator=generator,
            aggregator=aggregator, shard=shard)

    # -- receiver scope ------------------------------------------------------

    def receiver_mask(self, adjacency: np.ndarray) -> np.ndarray:
        """``(n, n)`` bool: ``mask[i, j]`` — does receiver ``i`` see the
        FORGED row of sender ``j`` (given ``j`` is malicious)?  Pure
        numpy over the static adjacency."""
        n = adjacency.shape[0]
        if self.num_clients != n:
            raise ValueError(
                f"TopologyAttack num_clients={self.num_clients} != "
                f"topology num_nodes={n}")
        # Receiver i sees sender j's row via the edge j -> i; the
        # adjacency is symmetric so that is adjacency[j, i].T == A.
        mask = np.array(adjacency, bool).T
        if self.eclipse_target is not None:
            only = np.zeros((n, 1), bool)
            only[int(self.eclipse_target), 0] = True
            mask = mask & only
        return mask
