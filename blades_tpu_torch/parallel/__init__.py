"""The port's execution layer (counterpart of ``blades_tpu/parallel``).

- :func:`sharded_step` / :func:`shard_map_step`: the client-sharded dense
  round over the ranks of a process group (:mod:`.sharded`);
- :func:`hier_step`: the hierarchical round, per-rank pre-aggregation
  then one gather (:mod:`.hier`);
- :func:`dsharded_step` / :func:`dsharded_multi_step`: the width-sharded
  round, one all-to-all to ``(n, d / k)`` shards (:mod:`.dsharded`);
- :func:`~blades_tpu_torch.parallel.streamed.streamed_step`: the
  one-card round for federations whose ``(n, d)`` matrix does not fit;
- :mod:`.packed`: client lane-packing on the dense round.

Ranks join through :func:`init_distributed` and form the mesh through
:func:`make_mesh` (:mod:`.mesh`).
"""

from blades_tpu_torch.parallel.mesh import (  # noqa: F401
    init_distributed,
    make_mesh,
    shard_federation,
)
from blades_tpu_torch.parallel.dsharded import (  # noqa: F401
    dsharded_multi_step,
    dsharded_step,
    elision_client_order,
)
from blades_tpu_torch.parallel.hier import hier_step  # noqa: F401
from blades_tpu_torch.parallel.sharded import (  # noqa: F401
    shard_map_step,
    sharded_step,
)
