"""Analytic collective byte accounting (counterpart of
``blades_tpu/parallel/comm_model.py``).

Each function lists every collective one round of the port's multi-rank
rounds issues, from the round geometry alone: the width-sharded round
(:func:`dsharded_round_volumes`), the gossip round
(:func:`gossip_round_volumes`) and the hierarchical round
(:func:`hier_round_volumes`, ``(CollectiveVolume, ring_size)`` pairs, as
their rings run over different axes).  The rounds record the same events
on a :class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder` as
they run (:mod:`blades_tpu_torch.parallel.dsharded`,
:mod:`blades_tpu_torch.topology.gossip`,
:mod:`blades_tpu_torch.parallel.hier`), and the tests reconcile the two
inventories.  Where the port's round issues a collective the JAX round
does not, or the reverse, the model describes the port's program
(tests/test_torch_comm_model.py names each such label against the JAX
model): its width-sharded round's update matrix is f32, ``d`` is padded
to a multiple of ``64 k`` (``ops/layout.py::SHARD_ALIGN``), its psums are
issued one geometry term at a time, and the malicious mask is replicated,
not gathered.  The control messages of
:mod:`~blades_tpu_torch.parallel.mesh` (``all_ranks_ok``,
``all_ranks_max``, ``broadcast_object``: the autotuner's and the sweep
runner's agreements between rounds) carry no model data and are left out.

Ring-collective wire cost per device, payload ``P`` bytes (the classic
ring results):

- ``all_to_all``: ``P * (k-1)/k`` bytes on the wire;
- ``all_gather``: ``P_out * (k-1)/k``, ``P_out`` the gathered size;
- ``psum`` (all-reduce): ``2 * P * (k-1)/k``.

On one device every ring has size 1 and moves nothing.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from blades_tpu_torch.ops.layout import SHARD_ALIGN

# One-way NVLink bandwidth of one H100 SXM, bytes/s: NVIDIA's data-sheet
# figure of 900 GB/s NVLink (both directions together), halved.  A
# data-sheet peak, not a measurement: the card's machine has one H100, so
# no link between two cards was ever timed.  A ring drives one link pair.
H100_NVLINK_BYTES_PER_SEC = 4.5e11


@dataclasses.dataclass(frozen=True)
class CollectiveVolume:
    """One collective op's per-device payload.

    kind: ``all_to_all`` | ``all_gather`` | ``psum``.
    payload_bytes: bytes per device entering the op (for ``all_gather``,
        the gathered OUTPUT size — that is what rides the wire).
    count: how many times the round executes it (wire bytes scale by
        this).
    in_loop: the op runs inside a loop of ``count`` iterations (the JAX
        round's ``lax.fori_loop`` body, where it appears once in the
        compiled program); :attr:`static_bytes` counts it once.
    """

    label: str
    kind: str
    payload_bytes: int
    count: int = 1
    in_loop: bool = False

    @property
    def static_bytes(self) -> int:
        """Bytes of the op as a compiled program states it: once for a
        loop body, ``count`` times otherwise."""
        return self.payload_bytes * (1 if self.in_loop else self.count)

    def wire_bytes(self, k: int) -> int:
        """Ring-transmitted bytes per device for a ring of ``k``."""
        if self.kind == "psum":
            factor = 2.0 * (k - 1) / k
        elif self.kind in ("all_to_all", "all_gather"):
            factor = (k - 1) / k
        else:
            raise ValueError(f"unknown collective kind {self.kind!r}")
        return int(self.count * self.payload_bytes * factor)


def _aggregator_volumes(
    aggregator: str, n: int, d_pad: int, *,
    geomed_maxiter: int = 100, dnc_num_iters: int = 5,
    dnc_sub_dim: int = 10000, cc_n_iter: int = 5,
    clustering_signguard: bool = False, d: Optional[int] = None,
) -> List[CollectiveVolume]:
    """The psums (and gathers) of the aggregator's global geometry on the
    width shards, as :func:`blades_tpu_torch.parallel.dsharded.
    aggregate_dshard` issues them (the keyword defaults are the port's
    aggregators'); f32 partials, int64 sign counts.  ``d`` (the true
    width, default ``d_pad``) bounds DnC's subsample."""
    f4, i8 = 4, 8
    sub = min(int(dnc_sub_dim), int(d if d is not None else d_pad))
    census = [CollectiveVolume("sign_census_pos", "psum", n * i8),
              CollectiveVolume("sign_census_neg", "psum", n * i8)]
    A = {
        "Mean": [],
        "Median": [],
        "Trimmedmean": [],
        # The squared row norms, then the Gram.
        "Multikrum": [CollectiveVolume("row_sq_norms", "psum", n * f4),
                      CollectiveVolume("gram", "psum", n * n * f4)],
        # The row norms of every Weiszfeld step.
        "GeoMed": [CollectiveVolume("weiszfeld_row_norms", "psum", n * f4,
                                    count=geomed_maxiter, in_loop=True)],
        # One psum of the (num_iters, n, sub_dim) sampled-column stack.
        "DnC": [CollectiveVolume("sampled_columns", "psum",
                                 dnc_num_iters * n * sub * f4)],
        # The trusted row's norm, the rows' norms, their dots with it.
        "FLTrust": [CollectiveVolume("trust_s_norm", "psum", f4),
                    CollectiveVolume("trust_row_norms", "psum", n * f4),
                    CollectiveVolume("trust_row_dots", "psum", n * f4)],
        # The clip's row norms each inner iteration, then the momentum
        # gathered back to the replicated (d,) state.
        "Centeredclipping": [
            CollectiveVolume("clip_row_norms", "psum", n * f4,
                             count=cc_n_iter, in_loop=True),
            CollectiveVolume("momentum_gather", "all_gather", d_pad * f4),
        ],
        # The row norms, the clip's, and the sign census.
        "Signguard": [CollectiveVolume("row_norms", "psum", n * f4),
                      CollectiveVolume("clip_row_norms", "psum", n * f4),
                      *census],
        # The row norms, the clip's, the clipped rows', the normalized
        # Gram (and the sign census with ``signguard``).
        "Clippedclustering": [
            CollectiveVolume("row_norms", "psum", n * f4),
            CollectiveVolume("clip_row_norms", "psum", n * f4),
            CollectiveVolume("clipped_row_norms", "psum", n * f4),
            CollectiveVolume("gram", "psum", n * n * f4),
            *(census if clustering_signguard else [])],
    }
    if aggregator not in A:
        raise ValueError(f"no comm model for aggregator {aggregator!r}")
    return list(A[aggregator])


def _adversary_volumes(adversary: Optional[str], n: int,
                       d_pad: int) -> List[CollectiveVolume]:
    """Update forges' psum'd global geometry on the width shards, per the
    registered names (:data:`blades_tpu_torch.adversaries.ADVERSARIES`)
    and :mod:`blades_tpu_torch.adversaries.update_attacks`.  The
    coordinate-stat forges (ALIE, IPM, Adaptive, Noise), the training
    attacks (SignFlip, LabelFlip), Lazy (a lane draw and per-coordinate
    noise), the campaigns built on them and the topology-scoped wrapper
    (a per-receiver mask inside the gossip round) issue none."""
    f4, i8 = 4, 8
    if adversary in (None, "ALIE", "IPM", "Adaptive", "Noise", "SignFlip",
                     "LabelFlip", "Lazy", "DiurnalALIE", "LazyRamp",
                     "TopologyAttack"):
        return []
    if adversary == "MinMax":
        # The benign pairwise distances, then one row-norm psum a
        # bisection step (MinMaxAdversary.iters = 12).
        return [
            CollectiveVolume("minmax_pairwise", "psum", n * n * f4),
            CollectiveVolume("minmax_bisection_norms", "psum", n * f4,
                             count=12, in_loop=True),
        ]
    if adversary == "SignGuard":
        # The benign mean's positive and negative counts (int64 scalars).
        return [CollectiveVolume("signguard_census_pos", "psum", i8),
                CollectiveVolume("signguard_census_neg", "psum", i8)]
    if adversary == "Attackclippedclustering":
        # The rows' norms, the benign mean's norm, the normalized Gram,
        # the rows' dots with the unit mean, the mean's norm again.
        return [
            CollectiveVolume("acc_row_norms", "psum", n * f4),
            CollectiveVolume("acc_mean_norm", "psum", f4),
            CollectiveVolume("acc_gram", "psum", n * n * f4),
            CollectiveVolume("acc_mean_dots", "psum", n * f4),
            CollectiveVolume("acc_mean_norm", "psum", f4),
        ]
    raise ValueError(f"no comm model for adversary {adversary!r}")


def uplink_bytes(n: int, d: int, codec=None, update_bytes: int = 4) -> int:
    """Client-to-server uplink bytes of one round, with its own arithmetic
    (not a call into :meth:`blades_tpu_torch.comm.CodecConfig.
    payload_bytes`), so the metric and the model check each other.

    ``codec=None`` (or identity) is the uncompressed wire, ``n * d *
    update_bytes``; the quantization codec ships a packed ``bits``-wide
    grid plus one f32 scale per row; top-k ships ``k`` (f32 value, int32
    index) pairs per row."""
    if codec is None or codec.name == "identity":
        return n * d * update_bytes
    if codec.name == "quant":
        return n * ((d * codec.bits + 7) // 8 + 4)
    if codec.name == "topk":
        return n * codec.topk_k(d) * 8
    raise ValueError(f"no uplink model for codec {codec.name!r}")


def dsharded_d_pad(d: int, n_dev: int) -> int:
    """The width-sharded round's padded width: ``d`` rounded up to a
    multiple of ``SHARD_ALIGN * n_dev`` (``ShardInfo.of(d, n_dev).d_pad``)."""
    step = SHARD_ALIGN * int(n_dev)
    return -(-int(d) // step) * step


def dsharded_round_volumes(
    n: int, d: int, n_dev: int, *, update_bytes: int = 4,
    aggregator: str = "Median", adversary: Optional[str] = "ALIE",
    health_check: bool = False, codec=None, **agg_kw,
) -> List[CollectiveVolume]:
    """Every collective one width-sharded round issues, per rank, in the
    order :class:`~blades_tpu_torch.parallel.dsharded.DshardedStep`
    issues them: the axis swap of the rank's ``(n_local, d_pad)`` f32
    rows, the losses' gather, the health verdicts' psum, the forge's and
    the aggregator's geometry, the ``(d_pad,)`` aggregate's gather and the
    update norms' psum.  ``codec`` models the swap carrying the codec's
    payload instead of dense rows (a what-if: the round itself is
    uncompressed)."""
    d_pad = dsharded_d_pad(d, n_dev)
    n_local = -(-n // n_dev)
    f4 = 4
    vols = [
        CollectiveVolume("update_matrix_swap", "all_to_all",
                         uplink_bytes(n_local, d_pad, codec,
                                      update_bytes=update_bytes)),
        CollectiveVolume("losses_gather", "all_gather",
                         n_dev * n_local * f4),
    ]
    if health_check:
        vols.append(CollectiveVolume("row_health", "psum", n * 4))
    vols += _adversary_volumes(adversary, n, d_pad)
    vols += _aggregator_volumes(aggregator, n, d_pad, d=d, **agg_kw)
    vols += [
        CollectiveVolume("aggregate_gather", "all_gather", d_pad * f4),
        CollectiveVolume("metrics_row_norms", "psum", n * f4),
    ]
    return vols


def gossip_round_volumes(n: int, d: int, mesh_shape, *,
                         faults: bool = False) -> List[tuple]:
    """Every collective one gossip round issues, as ``(CollectiveVolume,
    ring_size)`` pairs, from the round geometry (a 1-D clients mesh of
    ``mesh_shape[0]`` ranks, nodes padded to a multiple of it): two
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
    the recorder's, so totals reconcile exactly
    (:meth:`CollectiveVolume.wire_bytes`'s float factor can differ by a
    byte on rings that are not a power of two)."""
    total = 0
    for v, k in volumes:
        factor = 2 if v.kind == "psum" else 1
        total += factor * v.count * v.payload_bytes * (k - 1) // k
    return total


def wire_bytes_per_chip(volumes: List[CollectiveVolume], n_dev: int) -> int:
    """Per-device ring wire total of one ring of ``n_dev``."""
    return sum(v.wire_bytes(n_dev) for v in volumes)


def ici_seconds(volumes: List[CollectiveVolume], n_dev: int,
                ici_bytes_per_sec: float = H100_NVLINK_BYTES_PER_SEC
                ) -> float:
    """The wire time of ``volumes`` at ``ici_bytes_per_sec`` one way
    (the H100 data-sheet NVLink figure unless given)."""
    return wire_bytes_per_chip(volumes, n_dev) / ici_bytes_per_sec


def project_multichip_rounds_per_sec(
    measured_rps: float, n_benign_measured: int,
    n_target: int, n_dev: int, d: int, *, update_bytes: int = 4,
    aggregator: str = "Median", adversary: Optional[str] = "ALIE",
    num_malicious: int = 0,
    ici_bytes_per_sec: float = H100_NVLINK_BYTES_PER_SEC,
) -> dict:
    """A projection of the width-sharded round on ``n_dev`` cards from a
    measured one-card rate, with a derived comm term.

    Model: the round's time on ``n_dev`` cards is the measured time scaled
    by the trained client-rounds per card (training is client-parallel,
    the width-sharded finish column-parallel), plus the wire time of every
    collective of :func:`dsharded_round_volumes` at ``ici_bytes_per_sec``.
    No compute/comm overlap is assumed.  ``floor(f / n_dev)`` malicious
    lanes a card are elided under the runtime's own gates: a forging
    adversary (the registered class overrides ``on_updates_ready``),
    ``n_dev <= f < n`` and ``n`` a multiple of ``n_dev``.  Returns the
    projection and its provenance."""
    t_measured = 1.0 / measured_rps
    if adversary is None:
        forging = False
    else:
        from blades_tpu_torch.adversaries import ADVERSARIES
        from blades_tpu_torch.adversaries.base import Adversary

        cls = ADVERSARIES[adversary]
        forging = cls.on_updates_ready is not Adversary.on_updates_ready
    elides = (forging and n_dev <= num_malicious < n_target
              and n_target % n_dev == 0)
    trained_per_chip = (-(-n_target // n_dev)
                        - (num_malicious // n_dev if elides else 0))
    t_compute = t_measured * trained_per_chip / n_benign_measured
    vols = dsharded_round_volumes(
        n_target, d, n_dev, update_bytes=update_bytes,
        aggregator=aggregator, adversary=adversary)
    t_comm = ici_seconds(vols, n_dev, ici_bytes_per_sec)
    rps = 1.0 / (t_compute + t_comm)
    return {
        "rounds_per_sec": round(rps, 2),
        "kind": "derived_bound",
        "t_compute_s": round(t_compute, 4),
        "t_ici_s": round(t_comm, 4),
        "wire_bytes_per_chip": wire_bytes_per_chip(vols, n_dev),
        "ici_bytes_per_sec": ici_bytes_per_sec,
        "dominant_collective": max(
            vols, key=lambda v: v.wire_bytes(n_dev)).label,
        "trained_lanes_per_chip": trained_per_chip,
        "assumptions": (
            "no compute/comm overlap; one ring at the given one-way link "
            "rate (by default the H100 SXM data-sheet NVLink figure, not "
            "a measurement); trained-client throughput scaling from the "
            "measured one-card round, floor(f/n_dev) malicious lanes "
            "elided a card; the collective inventory reconciled with the "
            "round's recorder (tests/test_torch_comm_model.py)"
        ),
    }
