"""Clean twin of topologydiscipline_bad.py: the exchange goes through the
counted mesh helpers; rank queries and a pragma'd barrier stay legal."""

import torch.distributed as dist

from blades_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum


def counted_exchange(mesh, t, recorder):
    rows = all_gather_rows(mesh, t, recorder=recorder, label="rows")
    total = all_reduce_sum(mesh, t, recorder=recorder, label="sum")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dist.barrier()  # blades-lint: disable=topology-discipline — fixture: a barrier moves no bytes the rows report
    return rows, total, rank
