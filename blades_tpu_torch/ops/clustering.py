"""Clustering primitives of the row-geometry defenses (counterpart of
``blades_tpu/ops/clustering.py``).

``kmeans_majority`` (SignGuard's 2-means over sign features) and
``agglomerative_majority`` (Clippedclustering's 2-cluster linkage over a
cosine-distance matrix) return the boolean mask of the larger cluster,
the only thing the aggregators consume.  Same algorithms, constants and
tie rules as the reference:

- k-means: farthest-point initialisation, ``num_iters`` Lloyd steps,
  empty clusters keep their center, ties go to the cluster of point 0;
- single linkage: Prim's minimum spanning tree with its heaviest edge cut;
- average linkage: the exact Lance-Williams merge loop up to
  ``exact_threshold`` points (n - 2 sequential steps), a spectral
  bipartition beyond.

Every loop here is a Python loop of small tensor steps: ``argmin`` /
``argmax`` return the first extremum, as ``jnp``'s do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from blades_tpu_torch.ops.layout import row_norms


def sign_features(updates: torch.Tensor) -> torch.Tensor:
    """Fractions of positive / negative / zero coordinates per row (n, 3)."""
    d = updates.shape[1]
    return torch.stack([(updates > 0).sum(1) / d, (updates < 0).sum(1) / d,
                        (updates == 0).sum(1) / d], 1).to(updates.dtype)


def _majority_of(in_one: torch.Tensor) -> torch.Tensor:
    """The larger side of a 2-partition; a tie goes to point 0's side."""
    n = in_one.shape[0]
    n_one = in_one.sum()
    one = torch.where(2 * n_one == n, in_one[0], n_one > n - n_one)
    return torch.where(one, in_one, ~in_one)


def kmeans_majority(features: torch.Tensor, num_iters: int = 10
                    ) -> torch.Tensor:
    """2-means over ``features`` (n, f); True for points in the larger
    cluster."""
    mu = features.mean(0)
    c0 = features[row_norms(features - mu).argmax()]
    c1 = features[row_norms(features - c0).argmax()]
    centers = torch.stack([c0, c1])

    def assign(centers):
        diff = features[:, None, :] - centers[None, :, :]
        return (diff * diff).sum(-1).sqrt().argmin(1)

    for _ in range(num_iters):
        onehot = F.one_hot(assign(centers), 2).to(features.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ features) / counts.clamp(min=1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, centers)
    return _majority_of(assign(centers) == 1)


def _mst_single_linkage_majority(dist: torch.Tensor) -> torch.Tensor:
    """Exact single-linkage 2-clustering: Prim's MST, cut the heaviest
    edge, membership by pointer doubling over the parent links."""
    n = dist.shape[0]
    dev = dist.device
    idx = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dev)
    D = torch.where(torch.eye(n, dtype=torch.bool, device=dev), inf, dist)
    in_tree = idx == 0
    mindist = D[0].clone()
    minsrc = torch.zeros((n,), dtype=torch.int64, device=dev)
    parent = torch.zeros((n,), dtype=torch.int64, device=dev)
    edge_w = torch.zeros((n,), dtype=dist.dtype, device=dev)
    for _ in range(n - 1):
        md = torch.where(in_tree, inf, mindist)
        v = md.argmin()
        parent[v] = minsrc[v]
        edge_w[v] = md[v]
        in_tree[v] = True
        row = D[v]
        minsrc = torch.where(row < mindist, v, minsrc)
        mindist = torch.minimum(mindist, row)
    member = idx == edge_w.argmax()
    anc = parent
    for _ in range(max(1, (n - 1).bit_length())):
        member = member | member[anc]
        anc = anc[anc]
    n_one = member.sum()
    return torch.where(n_one > n - n_one, member, ~member)


def _spectral_bipartition_majority(dist: torch.Tensor, num_iters: int = 100
                                   ) -> torch.Tensor:
    """Normalized spectral 2-partition of a distance matrix: the Fiedler
    direction of ``D^-1/2 S D^-1/2`` (``S = 2 - dist``) by deflated power
    iteration, split by sign."""
    n = dist.shape[0]
    S = torch.clamp(2.0 - dist, min=0.0)
    deg = S.sum(1)
    dinv = 1.0 / deg.clamp(min=1e-12).sqrt()
    u1 = deg.clamp(min=0.0).sqrt()
    u1 = u1 / row_norms(u1[None])[0].clamp(min=1e-12)
    x = torch.cos(torch.arange(n, dtype=dist.dtype, device=dist.device)
                  * 0.7) + 0.1
    x = x - (u1 @ x) * u1
    for _ in range(num_iters):
        y = dinv * (S @ (dinv * x))
        y = y - (u1 @ y) * u1
        x = y / row_norms(y[None])[0].clamp(min=1e-12)
    return _majority_of(x > 0)


def agglomerative_majority(dist: torch.Tensor, linkage: str = "average",
                           exact_threshold: int = 2048) -> torch.Tensor:
    """2-cluster agglomerative clustering of a symmetric (n, n) distance
    matrix; the mask of the larger cluster (ties: point 0's cluster)."""
    if linkage not in ("average", "single"):
        raise ValueError(f"unsupported linkage: {linkage}")
    n = dist.shape[0]
    if linkage == "single":
        return _mst_single_linkage_majority(dist)
    if n > exact_threshold:
        return _spectral_bipartition_majority(dist)
    dev = dist.device
    idx = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dev)
    D = torch.where(torch.eye(n, dtype=torch.bool, device=dev), inf, dist)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    member = torch.eye(n, dtype=torch.bool, device=dev)
    sizes = torch.ones((n,), dtype=dist.dtype, device=dev)
    for _ in range(n - 2):
        flat = D.argmin()
        r, c = flat // n, flat % n
        a, b = torch.minimum(r, c), torch.maximum(r, c)
        sa, sb = sizes[a], sizes[b]
        new_row = (sa * D[a] + sb * D[b]) / (sa + sb)
        dead = (~active) | (idx == a) | (idx == b)
        new_row = torch.where(dead, inf, new_row)
        D[a] = new_row
        D[:, a] = new_row
        D[b] = inf
        D[:, b] = inf
        member[a] = member[a] | member[b]
        member[b] = False
        sizes[a] = sa + sb
        active[b] = False
    order = torch.argsort((~active).to(torch.int8), stable=True)
    c0, c1 = order[0], order[1]
    return torch.where(sizes[c1] > sizes[c0], member[c1], member[c0])
