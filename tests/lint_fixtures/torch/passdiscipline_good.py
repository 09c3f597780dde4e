"""Clean twin of passdiscipline_bad.py: the planner's requests, the
sanctioned wire path, and a same-named helper of another module."""

from blades_tpu_torch.parallel.streamed_geometry import (
    PassPlanner,
    aggregate_wire,
)


def row_stats_bundle(buf):
    return buf.sum()  # this module's own helper, not the kernel wrapper


def planned(buf, agg, q, scales, c):
    pl = PassPlanner(buf, c)
    sq, g = pl.sq_norms(), pl.gram()
    pl.execute()
    wire = aggregate_wire(agg, q, scales, c)
    return sq.value, g.value, wire, row_stats_bundle(buf)
