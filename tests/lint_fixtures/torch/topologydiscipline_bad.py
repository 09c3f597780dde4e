"""Seeded topology-discipline violations of the port (never imported):
raw torch.distributed collectives outside parallel/mesh.py."""

import torch
import torch.distributed as dist
from torch import distributed as tdist
from torch.distributed import all_gather_object as gather_objs


def uncounted_exchange(t, objs, group):
    dist.all_reduce(t, group=group)  # BAD
    tdist.broadcast(t, src=0)  # BAD: `from torch import distributed`
    gather_objs(objs, t)  # BAD: aliased from-import
    torch.distributed.all_to_all_single(t, t)  # BAD: dotted path
    dist.barrier()  # BAD
    return dist.get_rank()  # not a collective
