"""Analytic collective byte accounting (counterpart of the gossip and
hierarchical parts of ``blades_tpu/parallel/comm_model.py``; the rest
comes with the width-sharded round).

:func:`gossip_round_volumes` and :func:`hier_round_volumes` list every
collective one gossip or hierarchical round issues, as
``(CollectiveVolume, ring_size)`` pairs, with the JAX package's
arithmetic; the round's
:class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder`
records the same events as the round runs
(:mod:`blades_tpu_torch.topology.gossip`,
:mod:`blades_tpu_torch.parallel.hier`), and the tests reconcile the two
inventories event by event, in both directions.

Ring-collective wire cost per device, payload ``P`` bytes (the classic
ring results):

- ``all_to_all``: ``P * (k-1)/k`` bytes on the wire;
- ``all_gather``: ``P_out * (k-1)/k``, ``P_out`` the gathered size;
- ``psum`` (all-reduce): ``2 * P * (k-1)/k``.

On one device every ring has size 1 and moves nothing: the port's gossip
round runs on one card, so its ``gossip_ici_bytes`` is 0, as the JAX
package computes it on a mesh of one.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class CollectiveVolume:
    """One collective op's per-device payload.

    kind: ``all_to_all`` | ``all_gather`` | ``psum``.
    payload_bytes: bytes per device entering the op (for ``all_gather``,
        the gathered OUTPUT size — that is what rides the wire).
    count: how many times the round executes it.
    """

    label: str
    kind: str
    payload_bytes: int
    count: int = 1


def gossip_round_volumes(n: int, d: int, mesh_shape, *,
                         faults: bool = False) -> List[tuple]:
    """Every collective one gossip round issues, as ``(CollectiveVolume,
    ring_size)`` pairs, from the round geometry (a 1-D clients mesh of
    ``mesh_shape[0]`` devices, nodes padded to a multiple of it): two
    ``(n_pad, d)`` f32 gathers (updates, parameters), two ``(n_pad,)``
    scalar gathers (losses, aggregate norms) and, with an edge-fault
    process armed, one scalar psum for the partition count.  The volume
    does not depend on the graph: the neighborhoods are selected locally
    from the gathered matrices."""
    c = int(mesh_shape[0])
    f4 = 4
    n_local = -(-n // c)
    n_pad = c * n_local
    vols = [
        (CollectiveVolume("updates_gather", "all_gather",
                          n_pad * d * f4), c),
        (CollectiveVolume("params_gather", "all_gather",
                          n_pad * d * f4), c),
        (CollectiveVolume("losses_gather", "all_gather", n_pad * f4), c),
        (CollectiveVolume("aggnorm_gather", "all_gather", n_pad * f4), c),
    ]
    if faults:
        vols.append((CollectiveVolume("partitioned_psum", "psum", f4), c))
    return vols


def hier_round_volumes(n: int, d: int, mesh_shape, *, preagg: str = "bucket",
                       bucket_size: int = 1) -> List[tuple]:
    """Every collective one hierarchical round issues, as
    ``(CollectiveVolume, ring_size)`` pairs, from the round geometry
    alone (client padding, bucket arithmetic, the ``d`` axis's column
    padding): the representatives' gather over ``clients`` (and, with a
    ``d`` axis, its second phase over ``d``) and the losses' gather.  The
    rings run over different axes (``clients`` of size ``c``, ``d`` of
    size ``dd``), hence the ring size per event."""
    c, dd = int(mesh_shape[0]), int(mesh_shape[1])
    b = int(bucket_size)
    f4 = 4
    n_local = -(-n // c)
    n_pad = c * n_local
    m = n_local if preagg == "nnm" else -(-n_local // b)
    vols = []
    if dd > 1:
        d_pad = -(-d // dd) * dd
        col = d_pad // dd
        vols.append((CollectiveVolume("reps_gather_clients", "all_gather",
                                      c * m * col * f4), c))
        vols.append((CollectiveVolume("reps_gather_d", "all_gather",
                                      c * m * d_pad * f4), dd))
    else:
        vols.append((CollectiveVolume("reps_gather_clients", "all_gather",
                                      c * m * d * f4), c))
    vols.append((CollectiveVolume("losses_gather", "all_gather",
                                  n_pad * f4), c))
    return vols


def gossip_wire_bytes(volumes: List[tuple]) -> int:
    """Per-device ring wire total for :func:`gossip_round_volumes` pairs,
    in :func:`hier_wire_bytes`'s integer arithmetic, so the
    reconciliation against the recorder is an equality."""
    return hier_wire_bytes(volumes)


def hier_wire_bytes(volumes: List[tuple]) -> int:
    """Per-device ring wire total of ``(CollectiveVolume, ring_size)``
    pairs: exact integer ring arithmetic (``factor * P * (k-1) // k``),
    the recorder's, so totals reconcile exactly."""
    total = 0
    for v, k in volumes:
        factor = 2 if v.kind == "psum" else 1
        total += factor * v.count * v.payload_bytes * (k - 1) // k
    return total
