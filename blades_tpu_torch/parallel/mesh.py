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
from typing import Any, Optional, Sequence

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


def make_mesh(num_devices: Optional[int] = None,
              mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over the process group's ranks: 1-D ``(clients,)`` by
    default (``mesh_shape=(k, 1)``), or ``mesh_shape=(c, dd)``.  Every
    rank calls it, in the same order (it creates the axis subgroups).
    ``num_devices`` must be the world size: one process per rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
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


def lane_block(mesh: Mesh, n: int) -> tuple:
    """``(start, n_local)``: this rank's lanes of an ``n``-client stack
    padded to a multiple of the ``clients`` axis."""
    n_local = -(-int(n) // mesh.num_clients_shards)
    return mesh.coords[0] * n_local, n_local


def local_lanes(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """This rank's block of a client-stacked tensor (padded first)."""
    start, n_local = lane_block(mesh, tensor.shape[0])
    return pad_to_multiple(tensor, mesh.num_clients_shards)[
        start:start + n_local]


def _stage(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The tensor a collective hands the backend: a host copy under gloo
    for a tensor on the card, else the tensor itself."""
    if mesh.backend == "gloo" and tensor.is_cuda:
        return tensor.cpu()
    return tensor.contiguous()


def _alone(mesh: Mesh, axis: str) -> bool:
    """Whether a collective along ``axis`` has nothing to do: the axis has
    one rank, and that rank is not a whole process group of one (whose
    collective still runs, the backend's identity)."""
    return mesh.axis_size(axis) == 1 and not (dist.is_initialized()
                                              and mesh.world_size == 1)


def all_gather_rows(mesh: Mesh, tensor: torch.Tensor, axis: str = CLIENTS_AXIS
                    ) -> torch.Tensor:
    """The ranks' ``(rows, ...)`` blocks along ``axis``, stacked in rank
    order into one contiguous ``(k * rows, ...)`` tensor on ``tensor``'s
    device.  ``dist.all_gather`` into row views of one output: one
    collective, the same call on gloo and NCCL and on every torch
    release, and no copy after it (``all_gather_into_tensor`` warns as
    deprecated on recent releases)."""
    if _alone(mesh, axis):
        return tensor
    k = mesh.axis_size(axis)
    group = mesh.clients_group if axis == CLIENTS_AXIS else mesh.d_group
    src = _stage(mesh, tensor)
    out = src.new_empty((k * src.shape[0],) + tuple(src.shape[1:]))
    rows = src.shape[0]
    dist.all_gather([out[i * rows:(i + 1) * rows] for i in range(k)], src,
                    group=group)
    return out.to(tensor.device)


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor,
                   axis: str = CLIENTS_AXIS) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks along ``axis``."""
    if _alone(mesh, axis):
        return tensor
    group = mesh.clients_group if axis == CLIENTS_AXIS else mesh.d_group
    src = _stage(mesh, tensor).clone()
    dist.all_reduce(src, group=group)
    return src.to(tensor.device)


def all_ranks_max(mesh: Mesh, value: int) -> int:
    """The largest of the ranks' ``value`` over the whole process group
    (one int64 all-reduce: on the card under NCCL, else on the host)."""
    if mesh.world_size == 1 or not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device="cuda" if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def params_digest(params) -> str:
    """A digest of a parameter dict's bytes, in name order."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
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
