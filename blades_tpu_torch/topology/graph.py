"""Peer graphs for the decentralized gossip round (counterpart of
``blades_tpu/topology/graph.py``; plain numpy, so the arrays are the JAX
package's, element for element).

A :class:`TopologyConfig` names a static peer graph over the federation's
nodes (ring / torus / k-regular circulant / seeded Erdős–Rényi /
complete), builds its adjacency as a plain numpy matrix, and derives a
symmetric doubly-stochastic mixing matrix from it (Metropolis–Hastings or
max-degree/uniform weights — both classic gossip-averaging choices,
e.g. Boyd et al. "Randomized gossip algorithms").  Everything here is
host-side provenance: the gossip round
(:mod:`blades_tpu_torch.topology.gossip`) reads the tables this module
emits.

Determinism contract: every builder is a pure function of the config
fields (``graph_seed`` drives the one random family), so two processes
with the same :class:`TopologyConfig` build the identical round — the
property checkpoints and ``blades_tpu_torch.tools.replay_round`` rely on.

The one load-bearing ordering convention lives in
:meth:`TopologyConfig.neighbor_tables`: each node's neighborhood slots
(its neighbors PLUS itself) are sorted by **ascending global node index**,
padded to the max closed-neighborhood size with duplicates of the node's
own index.  On the complete graph every node's slot row is therefore
exactly ``0..n-1`` — the same row order as the centralized ``(n, d)``
update matrix — which is what makes the complete-graph + Mean gossip
aggregation equal bit for bit to the dense server round's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

GRAPHS = ("ring", "torus", "kregular", "erdos", "complete")
MIXINGS = ("metropolis", "uniform")


@dataclasses.dataclass(frozen=True)
class NeighborTables:
    """Static per-node neighborhood tables the gossip round reads.

    nbr_idx: ``(n, k1)`` int32 — node ``i``'s closed neighborhood
        (neighbors + itself) sorted by ASCENDING global index, padded to
        ``k1 = max_i (deg_i + 1)`` with copies of ``i`` (self-duplication
        padding: a pad slot aggregates the node's own row, the
        static-shape analogue of a masked row).
    valid: ``(n, k1)`` bool — True on the real (non-pad) slots.
    w_slot: ``(n, k1)`` float32 — the mixing weight ``W[i, nbr_idx[i,s]]``
        for valid NON-self slots, 0 elsewhere.  The self weight never
        appears: mixing runs in deviation form
        ``θ_i + Σ_s w_slot[i,s] (θ_{nbr} − θ_i)``, where the self/pad
        deviations are exact zeros.
    self_slot: ``(n,)`` int32 — the slot holding ``i`` itself.
    """

    nbr_idx: np.ndarray
    valid: np.ndarray
    w_slot: np.ndarray
    self_slot: np.ndarray


def _ring(n: int) -> np.ndarray:
    a = np.zeros((n, n), bool)
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = True
    a[(idx + 1) % n, idx] = True
    return a


def _torus(n: int) -> np.ndarray:
    # Largest divisor <= sqrt(n) gives the squarest (rows, cols) grid.
    rows = max(r for r in range(1, int(np.sqrt(n)) + 1) if n % r == 0)
    cols = n // rows
    if rows < 2 or cols < 2:
        raise ValueError(
            f"torus needs a 2-D grid: num_nodes={n} only factors as "
            f"{rows}x{cols} — use a composite node count (>= 4, not "
            "prime), or a ring/kregular graph")
    a = np.zeros((n, n), bool)
    for i in range(n):
        r, c = divmod(i, cols)
        for rr, cc in (((r + 1) % rows, c), ((r - 1) % rows, c),
                       (r, (c + 1) % cols), (r, (c - 1) % cols)):
            j = rr * cols + cc
            if j != i:
                a[i, j] = a[j, i] = True
    return a


def _kregular(n: int, k: int) -> np.ndarray:
    # Circulant graph: each node links to its k//2 nearest on each side.
    if k % 2 or not 2 <= k < n:
        raise ValueError(
            f"kregular degree k={k} must be even with 2 <= k < "
            f"num_nodes={n} (circulant construction links k/2 "
            "neighbors per side)")
    a = np.zeros((n, n), bool)
    idx = np.arange(n)
    for off in range(1, k // 2 + 1):
        a[idx, (idx + off) % n] = True
        a[(idx + off) % n, idx] = True
    return a


def _erdos(n: int, p: float, seed: int) -> np.ndarray:
    # Seeded G(n, p) PLUS a ring backbone: gossip over a disconnected
    # graph never reaches consensus, so connectivity is guaranteed by
    # construction and the spectral gap reports how well-mixed the draw
    # actually is.
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"erdos edge probability p={p} must be in [0, 1]")
    rng = np.random.default_rng(seed)
    u = rng.random((n, n))
    a = np.triu(u < p, k=1)
    a = a | a.T | _ring(n)
    np.fill_diagonal(a, False)
    return a


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Frozen spec of the gossip peer graph + mixing weights.

    graph: one of :data:`GRAPHS`.
    num_nodes: federation size (nodes == clients on the gossip path).
    k: circulant degree for ``graph="kregular"`` (even, ``2 <= k < n``).
    p: edge probability for ``graph="erdos"`` (a ring backbone keeps the
        draw connected).
    graph_seed: the Erdős–Rényi draw's seed — part of the config, so the
        topology is replayable provenance, never ambient randomness.
    mixing: ``"metropolis"`` (Metropolis–Hastings weights
        ``1 / (1 + max(deg_i, deg_j))``) or ``"uniform"`` (max-degree
        weights ``1 / (1 + max_deg)``) — both symmetric doubly-stochastic
        with non-negative self weights.
    """

    graph: str = "ring"
    num_nodes: int = 8
    k: int = 4
    p: float = 0.3
    graph_seed: int = 0
    mixing: str = "metropolis"

    def __post_init__(self):
        if self.graph not in GRAPHS:
            raise ValueError(
                f"unknown topology graph {self.graph!r}; use one of "
                f"{GRAPHS}")
        if self.mixing not in MIXINGS:
            raise ValueError(
                f"unknown mixing scheme {self.mixing!r}; use one of "
                f"{MIXINGS}")
        if not isinstance(self.num_nodes, int) or self.num_nodes < 2:
            raise ValueError(
                f"topology needs num_nodes >= 2, got {self.num_nodes!r}")
        # Build once now so a bad (graph, knob) pair fails at config
        # time, not mid-run — the faults/codec fail-fast discipline.
        self.adjacency()

    # -- graph ---------------------------------------------------------------

    def adjacency(self) -> np.ndarray:
        """Symmetric ``(n, n)`` bool adjacency, no self loops."""
        n = self.num_nodes
        if self.graph == "ring":
            return _ring(n)
        if self.graph == "torus":
            return _torus(n)
        if self.graph == "kregular":
            return _kregular(n, self.k)
        if self.graph == "erdos":
            return _erdos(n, self.p, self.graph_seed)
        a = np.ones((n, n), bool)
        np.fill_diagonal(a, False)
        return a

    def mixing_matrix(self) -> np.ndarray:
        """Symmetric doubly-stochastic ``(n, n)`` float64 mixing matrix."""
        a = self.adjacency()
        deg = a.sum(axis=1)
        if self.mixing == "metropolis":
            w = np.where(a, 1.0 / (1.0 + np.maximum(deg[:, None],
                                                    deg[None, :])), 0.0)
        else:
            w = np.where(a, 1.0 / (1.0 + deg.max()), 0.0)
        np.fill_diagonal(w, 1.0 - w.sum(axis=1))
        return w

    @property
    def spectral_gap(self) -> float:
        """``1 - max(|λ2|, |λn|)`` of the mixing matrix — the consensus
        contraction rate, reported as provenance on every gossip row."""
        lam = np.linalg.eigvalsh(self.mixing_matrix())
        lam = np.sort(np.abs(lam))[::-1]
        return float(1.0 - (lam[1] if lam.size > 1 else 0.0))

    # -- tables --------------------------------------------------------------

    def neighbor_tables(self) -> NeighborTables:
        """The static slot tables the gossip round reads — see
        :class:`NeighborTables` for the ascending-global-index ordering
        contract the bit-identity pin rests on."""
        a = self.adjacency()
        w = self.mixing_matrix()
        n = self.num_nodes
        closed = [np.flatnonzero(a[i] | (np.arange(n) == i))
                  for i in range(n)]
        k1 = max(len(c) for c in closed)
        nbr = np.empty((n, k1), np.int32)
        valid = np.zeros((n, k1), bool)
        wslot = np.zeros((n, k1), np.float32)
        self_slot = np.empty((n,), np.int32)
        for i, c in enumerate(closed):
            d_i = len(c)
            nbr[i, :d_i] = c
            nbr[i, d_i:] = i
            valid[i, :d_i] = True
            wslot[i, :d_i] = np.where(c == i, 0.0, w[i, c])
            self_slot[i] = int(np.flatnonzero(c == i)[0])
        return NeighborTables(nbr_idx=nbr, valid=valid, w_slot=wslot,
                              self_slot=self_slot)

    def provenance(self) -> dict:
        """The host-side stamps every gossip metrics row carries."""
        a = self.adjacency()
        return {
            "topology": self.graph,
            "graph_seed": int(self.graph_seed),
            "spectral_gap": self.spectral_gap,
            "num_nodes": int(self.num_nodes),
            "num_edges": int(a.sum() // 2),
            "max_degree": int(a.sum(axis=1).max()),
            "mixing": self.mixing,
        }


def get_topology(spec, num_nodes: int) -> TopologyConfig:
    """Resolve a topology from a name / dict / instance (the
    ``get_adversary`` resolution shape), pinning ``num_nodes``."""
    if isinstance(spec, TopologyConfig):
        return spec
    if spec is None:
        spec = {}
    if isinstance(spec, str):
        spec = {"graph": spec}
    return TopologyConfig(num_nodes=num_nodes, **dict(spec))
