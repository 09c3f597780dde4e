"""Seeded streamed-pass-discipline violations of the port (never
imported): raw row-statistics traversals and decodes outside the
planner."""

import blades_tpu_torch.ops.rowstats as rs
from blades_tpu_torch.comm import codecs as cc
from blades_tpu_torch.comm.codecs import dequantize
from blades_tpu_torch.ops import rowstats
from blades_tpu_torch.ops.rowstats import row_stats_bundle as bundle


def extra_traversals(buf, q, scales):
    sq = bundle(buf, sq=True)  # BAD: aliased from-import
    g = rowstats.row_stats_bundle(buf, gram=True)  # BAD: module attribute
    p = rs.row_stats_bundle_plain(buf, sq=True)  # BAD: `import ... as`
    dec = dequantize(q, scales)  # BAD: raw decode
    dec2 = cc.dequantize(q, scales)  # BAD: codec-module alias
    return sq, g, p, dec, dec2
