"""Ranks of a process group as the federation's device mesh (counterpart of
``blades_tpu/parallel/mesh.py``).

One process drives one device (a rank); ``num_devices`` ranks form a
``(clients, d)`` grid, row-major (rank ``ci * dd + di``).  Client-stacked
tensors (data shards, per-client optimizer state) are padded to a
multiple of the ``clients`` axis and each rank keeps its own contiguous
block of lanes; server state is replicated, born equal on every rank from
the seed and checked once at setup.  The ``d`` axis replicates the client
block: the ranks of one ``clients`` coordinate train the same lanes, and
the hierarchical round splits its representative gather column-wise along
``d`` (:mod:`blades_tpu_torch.parallel.hier`).

The collectives run over ``torch.distributed``: NCCL on the card, gloo on
the CPU, or the backend the caller names.  A rank whose tensors lie on the
card under gloo stages its collectives through the host
(:func:`all_gather_rows`); that follows from the named backend alone.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

CLIENTS_AXIS = "clients"
# The second axis of the 2-D layout: the model width.  Client blocks train
# data-parallel along ``clients``; the hierarchical round's gather splits
# its columns along ``d`` (two phases instead of one long ring).
D_AXIS = "d"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group (the counterpart of ``jax.distributed``'s
    bring-up).

    With ``coordinator_address`` (``host:port``, or a URL such as
    ``file:///path``) the rendezvous is that address with
    ``num_processes`` ranks, this one ``process_id``.  Without one,
    torchrun's environment (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``)
    is read.  Otherwise, and when a group already exists, nothing
    happens: a single-process run.  ``backend`` defaults to NCCL where the
    card is present and gloo otherwise."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id))
        return
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and "RANK" in env:
        dist.init_process_group(backend, init_method="env://")
        return
    if num_processes is not None and int(num_processes) > 1:
        raise ValueError(
            f"num_processes={num_processes} needs a coordinator address "
            "(--coordinator HOST:PORT) or torchrun's environment "
            "(MASTER_ADDR, RANK, WORLD_SIZE)")


def local_rank() -> int:
    """This process's index among the ranks of its host: torchrun's
    ``LOCAL_RANK``, else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    count = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(count, 1)


def rank_device(device=None) -> torch.device:
    """The device this rank's tensors live on: ``device`` where the caller
    names one (``cpu``, or ``cuda:0`` for ranks sharing a card), else
    ``cuda:{local_rank}``.  Never the CPU unless asked for."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "absent")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", local_rank())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the ``(clients, d)`` grid: the world size, its
    rank and ``(clients, d)`` coordinates, and the subgroups of the ranks
    along each axis (``None`` where the axis is the whole world or has
    one rank)."""

    world_size: int
    rank: int
    shape: tuple
    coords: tuple
    clients_group: Any = None
    d_group: Any = None
    backend: Optional[str] = None

    @property
    def num_clients_shards(self) -> int:
        return int(self.shape[0])

    @property
    def dd(self) -> int:
        return int(self.shape[1])

    def axis_size(self, axis: str) -> int:
        return int(self.shape[0] if axis == CLIENTS_AXIS else self.shape[1])


def mesh_grid(num_devices: Optional[int] = None,
              mesh_shape: Optional[Sequence[int]] = None) -> tuple:
    """``(c, dd)``, the ``(clients, d)`` grid :func:`make_mesh` lays over
    the process group for these arguments, or its error: a check that
    creates nothing."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shape is not None:
        c, dd = (int(mesh_shape[0]), int(mesh_shape[1]))
        if c < 1 or dd < 1:
            raise ValueError(f"mesh_shape axes must be >= 1, got {mesh_shape}")
        want = c * dd
        if num_devices is not None and num_devices != want:
            raise ValueError(
                f"mesh_shape {c}x{dd} needs exactly {want} devices, "
                f"num_devices requested {num_devices}")
        if want > world:
            raise ValueError(
                f"mesh_shape {c}x{dd} needs {want} devices, have {world}")
    else:
        want = world if num_devices is None else int(num_devices)
        if want > world:
            raise ValueError(f"requested {want} devices, have {world}")
        c, dd = want, 1
    if want != world:
        raise ValueError(
            f"num_devices={want} must equal the process group's world size "
            f"{world}: the port runs one process per rank")
    return c, dd


def make_mesh(num_devices: Optional[int] = None,
              mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over the process group's ranks: 1-D ``(clients,)`` by
    default (``mesh_shape=(k, 1)``), or ``mesh_shape=(c, dd)``.  Every
    rank calls it, in the same order (it creates the axis subgroups).
    ``num_devices`` must be the world size: one process per rank."""
    c, dd = mesh_grid(num_devices, mesh_shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    ci, di = divmod(rank, dd)
    clients_group = d_group = None
    if world > 1 and dd > 1:
        # Every rank creates every subgroup, in the same order.
        for j in range(dd):
            g = dist.new_group([i * dd + j for i in range(c)])
            if j == di:
                clients_group = g
        for i in range(c):
            g = dist.new_group([i * dd + j for j in range(dd)])
            if i == ci:
                d_group = g
    return Mesh(world_size=world, rank=rank, shape=(c, dd), coords=(ci, di),
                clients_group=clients_group, d_group=d_group,
                backend=dist.get_backend() if dist.is_initialized() else None)


def pad_to_multiple(tensor: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a tensor's leading (client) axis up to a multiple."""
    pad = (-tensor.shape[0]) % int(multiple)
    if pad == 0:
        return tensor
    return torch.cat([tensor,
                      tensor.new_zeros((pad,) + tuple(tensor.shape[1:]))])


@dataclasses.dataclass(frozen=True)
class LaneBlock:
    """This rank's contiguous block ``[start, start + n_local)`` of an
    ``n``-lane stack padded to ``n_pad = c * n_local`` lanes over the ``c``
    ranks of the ``clients`` axis; without a mesh every lane (``c = 1``).
    Lanes past ``n`` are ghosts."""

    n: int
    c: int
    start: int
    n_local: int

    @classmethod
    def of(cls, mesh: Optional[Mesh], n: int) -> "LaneBlock":
        c = 1 if mesh is None else mesh.num_clients_shards
        n_local = -(-int(n) // c)
        coord = 0 if mesh is None else mesh.coords[0]
        return cls(int(n), c, coord * n_local, n_local)

    @property
    def n_pad(self) -> int:
        return self.c * self.n_local

    @property
    def real(self) -> tuple:
        """``(lo, hi)``: the real (non-ghost) lanes of the block."""
        return min(self.start, self.n), min(self.start + self.n_local, self.n)

    def lanes(self, t):
        """The block's lanes of a whole-stack tensor (a tuple of them, or
        None), zero rows past its rows."""
        if t is None:
            return None
        if isinstance(t, tuple):
            return tuple(self.lanes(v) for v in t)
        return pad_to_multiple(t, self.c)[self.start:self.start
                                          + self.n_local]


def local_lanes(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """This rank's block of a client-stacked tensor (padded first)."""
    return LaneBlock.of(mesh, tensor.shape[0]).lanes(tensor)


def _stage(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The tensor a collective hands the backend: a host copy under gloo
    for a tensor on the card, else the tensor itself."""
    if mesh.backend == "gloo" and tensor.is_cuda:
        return tensor.cpu()  # blades-lint: disable=host-sync — gloo stages a card tensor through the host: the copy is the collective's transport
    return tensor.contiguous()


def _axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.axis_size(axis)


def _alone(mesh: Optional[Mesh], axis: str) -> bool:
    """Whether a collective along ``axis`` has nothing to do: there is no
    mesh (one device outside any group), or the axis has one rank and
    that rank is not a whole process group of one (whose collective still
    runs, the backend's identity)."""
    return mesh is None or (mesh.axis_size(axis) == 1
                            and not (dist.is_initialized()
                                     and mesh.world_size == 1))


def _count(recorder, label: Optional[str], kind: str, payload_bytes: int,
           ring: int) -> None:
    if recorder is not None:
        recorder.count_ici(label or kind, kind, payload_bytes, ring)


def all_gather_rows(mesh: Optional[Mesh], tensor: torch.Tensor,
                    axis: str = CLIENTS_AXIS, recorder=None,
                    label: Optional[str] = None) -> torch.Tensor:
    """The ranks' ``(rows, ...)`` blocks along ``axis``, stacked in rank
    order into one contiguous ``(k * rows, ...)`` tensor on ``tensor``'s
    device.  ``dist.all_gather`` into row views of one output: one
    collective, the same call on gloo and NCCL and on every torch
    release, and no copy after it (``all_gather_into_tensor`` warns as
    deprecated on recent releases).  Without a mesh, ``tensor`` itself.
    A ``recorder``
    (:class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder`)
    counts it under ``label`` (default the kind): the gathered bytes over
    the axis's ring."""
    k = _axis_size(mesh, axis)
    _count(recorder, label, "all_gather",
           k * tensor.numel() * tensor.element_size(), k)
    if _alone(mesh, axis):
        return tensor
    group = mesh.clients_group if axis == CLIENTS_AXIS else mesh.d_group
    src = _stage(mesh, tensor)
    out = src.new_empty((k * src.shape[0],) + tuple(src.shape[1:]))
    rows = src.shape[0]
    dist.all_gather([out[i * rows:(i + 1) * rows] for i in range(k)], src,
                    group=group)
    return out.to(tensor.device)


def rows_to_width_shard(mesh: Mesh, rows: torch.Tensor, recorder=None,
                        label: Optional[str] = None) -> torch.Tensor:
    """The axis swap of the width-sharded round: this rank's ``(n_local,
    d_pad)`` rows (``d_pad`` a multiple of the ``k`` ranks along the
    ``clients`` axis)
    become every rank's rows on this rank's ``d_pad / k`` columns, ``(k *
    n_local, d_pad / k)``, the rows in rank order (as
    :func:`all_gather_rows` stacks them).  ``all_to_all_single`` sends the
    ``j``-th slab of dim 0 to rank ``j``, so the block is first laid out
    as ``(k, n_local, width)``: one copy of it (on the host under gloo
    for rows on the card, the staging copy itself).  One collective,
    counted on ``recorder`` under ``label``: the block's bytes over the
    ring."""
    k = mesh.axis_size(CLIENTS_AXIS)
    n_local, d_pad = rows.shape
    if d_pad % k:
        raise ValueError(f"{d_pad} columns do not split over {k} ranks: "
                         "zero-pad them to a multiple first")
    _count(recorder, label, "all_to_all", rows.numel() * rows.element_size(),
           k)
    if _alone(mesh, CLIENTS_AXIS):
        return rows
    width = d_pad // k
    blocks = rows.view(n_local, k, width).transpose(0, 1)
    if mesh.backend == "gloo" and rows.is_cuda:
        src = torch.empty(blocks.shape, dtype=rows.dtype)
        src.copy_(blocks)
    else:
        src = blocks.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.clients_group)
    del src
    return out.view(k * n_local, width).to(rows.device)


def all_reduce_sum(mesh: Optional[Mesh], tensor: torch.Tensor,
                   axis: str = CLIENTS_AXIS, recorder=None,
                   label: Optional[str] = None) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks along ``axis``; without a mesh,
    ``tensor`` itself (counted on ``recorder`` under ``label``: its bytes
    over the ring)."""
    _count(recorder, label, "psum", tensor.numel() * tensor.element_size(),
           _axis_size(mesh, axis))
    if _alone(mesh, axis):
        return tensor
    group = mesh.clients_group if axis == CLIENTS_AXIS else mesh.d_group
    src = _stage(mesh, tensor).clone()
    dist.all_reduce(src, group=group)
    return src.to(tensor.device)


def _all_ranks(mesh: Optional[Mesh], value: int, op) -> int:
    """``op`` of the ranks' ``value`` over the whole process group (one
    int64 all-reduce: on the card under NCCL, else on the host)."""
    if mesh is None or mesh.world_size == 1 or not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device="cuda" if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(t, op=op)
    return int(t.item())  # blades-lint: disable=host-sync — the all-reduced int is the helper's result: one scalar, in the sweep's and the autotuner's lockstep, not in a round


def all_ranks_max(mesh: Mesh, value: int) -> int:
    """The largest of the ranks' ``value`` over the whole process group."""
    return _all_ranks(mesh, value, dist.ReduceOp.MAX)


# The two agreement messages below steer the ranks (who decided, whether
# a step went through everywhere); they carry no model data, and the comm
# models (parallel/comm_model.py) leave them out.  A recorder still counts
# them, under their own labels, so that its inventory is complete.


def all_ranks_ok(mesh: Optional[Mesh], ok: bool, recorder=None,
                 label: Optional[str] = None) -> bool:
    """Whether ``ok`` holds on every rank of the process group: a MIN
    all-reduce of one int64 (on the card under NCCL, else on the host).
    Every rank must call it; without a group, ``ok`` itself."""
    _count(recorder, label, "psum", 8, 1 if mesh is None else mesh.world_size)
    return bool(_all_ranks(mesh, int(bool(ok)), dist.ReduceOp.MIN))


def broadcast_object(mesh: Optional[Mesh], obj: Any, src: int = 0,
                     recorder=None, label: Optional[str] = None) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank
    (``dist.broadcast_object_list``; the other ranks' ``obj`` is ignored).
    Every rank must call it; without a group, ``obj`` itself.  Counted on
    ``recorder`` as the pickled bytes over the ring."""
    if mesh is not None and mesh.world_size > 1 and dist.is_initialized():
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        obj = box[0]
    if recorder is not None:
        recorder.count_ici(label or "broadcast", "broadcast",
                           len(pickle.dumps(obj)),
                           1 if mesh is None else mesh.world_size)
    return obj


def params_digest(params) -> str:
    """A digest of a parameter dict's bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())  # blades-lint: disable=host-sync — a replication check at setup (shard_federation), never per round
    return h.hexdigest()


def check_replicated(mesh: Mesh, params) -> None:
    """Raise unless every rank holds the same parameters bit for bit:
    each rank's digest is gathered and compared."""
    if mesh.world_size == 1:
        return
    digests = [None] * mesh.world_size
    dist.all_gather_object(digests, params_digest(params))
    if len(set(digests)) != 1:
        raise RuntimeError(
            "the server state differs across ranks (parameter digests "
            f"{digests}): every rank must build it from the same seed")


def shard_federation(mesh: Mesh, round_state, data_arrays: Sequence[Any]):
    """This rank's share of a :class:`~blades_tpu_torch.core.RoundState`
    and the client data: the server state stays (checked replicated), the
    client optimizer stacks and every data array are padded to a multiple
    of the ``clients`` axis and cut to this rank's lanes.  Ghost (padding)
    lanes have empty shards (``lengths = 0``) and zeroed optimizer state;
    the round slices them away before the aggregate
    (:attr:`~blades_tpu_torch.core.FedRound.num_clients`)."""
    check_replicated(mesh, round_state.server.params)
    opt = round_state.client_opt
    if opt is not None:
        opt = {k: local_lanes(mesh, v) for k, v in opt.items()}
    state = dataclasses.replace(round_state, client_opt=opt)
    return state, tuple(local_lanes(mesh, a) for a in data_arrays)


def broadcast_from(mesh: Mesh, tensor: torch.Tensor, src: int = 0
                   ) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank (every rank passes one of
    the same shape and dtype), on ``tensor``'s device."""
    if not dist.is_initialized():
        return tensor
    buf = _stage(mesh, tensor).clone()
    dist.broadcast(buf, src=src)
    return buf.to(tensor.device)


def _block(mesh: Mesh, v, n: int):
    """Lanes of this rank's block of a per-node stack ``v`` (a tensor, a
    numpy vector, or a list of per-node states), padded past ``n``: zero
    rows, zero counters, and the first node's state."""
    block = LaneBlock.of(mesh, n)
    if isinstance(v, torch.Tensor):
        return block.lanes(v[:n])
    lo, hi = block.real
    if isinstance(v, np.ndarray):
        out = np.zeros((block.n_local,), v.dtype)
        out[:hi - lo] = v[lo:hi]
        return out
    out = list(v[lo:hi])
    return out + [v[0]] * (block.n_local - len(out))


def shard_gossip_state(mesh: Mesh, round_state, data_arrays: Sequence[Any],
                       num_nodes: int):
    """The gossip placement: this rank's block of a gossip state's
    per-node stacks and of the client data (counterpart of JAX's
    ``gossip_federation`` and ``reshard_gossip_state``).  ``round_state``
    holds the whole federation's ``(n, ...)`` stacks (as
    :func:`~blades_tpu_torch.topology.gossip.gossip_federation` makes them
    from the replicated initial state, or as a checkpoint holds them);
    each rank keeps the contiguous block of ``n_local = ceil(n / c)``
    nodes its ``clients`` coordinate owns, so a stack re-lays onto any
    rank count without a broadcast.  Ghost (padding) nodes hold zero
    parameters and counters, train nothing and are no node's
    neighbor."""
    n = int(num_nodes)
    srv = round_state.server
    opt = {k: (_block(mesh, v, n) if not isinstance(v, dict)
               else {kk: _block(mesh, vv, n) for kk, vv in v.items()})
           for k, v in srv.opt_state.items()}
    agg_state = srv.agg_state
    if isinstance(agg_state, list):
        agg_state = _block(mesh, agg_state, n)
    server = dataclasses.replace(
        srv, params={k: _block(mesh, v, n) for k, v in srv.params.items()},
        opt_state=opt, agg_state=agg_state)
    client_opt = round_state.client_opt
    if client_opt is not None:
        client_opt = {k: _block(mesh, v, n) for k, v in client_opt.items()}
    state = dataclasses.replace(round_state, server=server,
                                client_opt=client_opt)
    return state, tuple(local_lanes(mesh, a) for a in data_arrays)


def gather_gossip_state(mesh: Mesh, round_state, num_nodes: int):
    """The whole federation's unpadded ``(n, ...)`` stacks of a placed
    gossip state, on every rank (each rank's block gathered, ghost nodes
    dropped): the one-process layout a checkpoint holds."""
    n = int(num_nodes)
    srv = round_state.server
    dev = next(iter(srv.params.values())).device

    def rows(v):
        if isinstance(v, torch.Tensor):
            return all_gather_rows(mesh, v)[:n]
        if isinstance(v, np.ndarray):
            t = all_gather_rows(mesh, torch.from_numpy(v).to(dev))
            return t.cpu().numpy()[:n]  # blades-lint: disable=host-sync — gathers the gossip state to the host once, at the end of a run
        return {k: rows(vv) for k, vv in v.items()}

    agg_state = srv.agg_state
    if isinstance(agg_state, list):
        parts = [None] * mesh.world_size
        dist.all_gather_object(parts, [_host(s) for s in agg_state])
        agg_state = [_to(s, dev) for p in parts for s in p][:n]
    server = dataclasses.replace(
        srv, params={k: rows(v) for k, v in srv.params.items()},
        opt_state={k: rows(v) for k, v in srv.opt_state.items()},
        agg_state=agg_state)
    opt = round_state.client_opt
    return dataclasses.replace(
        round_state, server=server,
        client_opt=None if opt is None else {k: rows(v)
                                             for k, v in opt.items()})


def _host(s):
    if isinstance(s, torch.Tensor):
        return s.cpu()  # blades-lint: disable=host-sync — gloo objects travel through the host: the aggregator state, once at the end of a run
    if isinstance(s, tuple):
        return tuple(_host(v) for v in s)
    return s


def _to(s, dev):
    if isinstance(s, torch.Tensor):
        return s.to(dev)
    if isinstance(s, tuple):
        return tuple(_to(v, dev) for v in s)
    return s
