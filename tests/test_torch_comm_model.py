"""The port's comm model (blades_tpu_torch/parallel/comm_model.py) against
the JAX package's and against the collectives the port's width-sharded
round issues.

Against JAX's model: ``uplink_bytes`` (and the codec's own
``payload_bytes``), ``CollectiveVolume.wire_bytes`` / ``static_bytes``,
``wire_bytes_per_chip``, ``ici_seconds`` and
``project_multichip_rounds_per_sec`` are equal, the link rate passed to
both.  ``dsharded_round_volumes`` describes the port's program: for every
registered aggregator (and the forges with geometry) at a width that is a
multiple of ``64 k`` (so both packages pad it alike) it equals JAX's but
for the labels named in ``PORT_ONLY`` / ``JAX_ONLY``, each stated with the
reason (FLTrust's split psums move the same wire bytes; Multikrum's move
``n`` floats more).

Against the port's round: one group of 2 gloo ranks (started through
tests/test_torch_mesh.py's rank program) runs one width-sharded round per
aggregator on an MLP federation, and each rank's recorder equals the
port's model event by event: label, kind, payload bytes and ring, in the
order the round issues them.
"""

import numpy as np
import pytest
import torch
from test_torch_mesh import start_ranks

WORLD = 2
N, F = 8, 2
SHAPE = (4, 4, 1)
ROWS = 4
AGGREGATORS = ("Mean", "Median", "Trimmedmean", "GeoMed", "DnC",
               "Multikrum", "Centeredclipping", "Signguard",
               "Clippedclustering", "FLTrust")
# (aggregator, adversary, health check, clients): every aggregator under
# ALIE, the forges whose geometry is psum'd under Mean, the health psum,
# and a client count the ranks pad.
POINTS = ([(agg, "ALIE", False, N) for agg in AGGREGATORS]
          + [("Mean", adv, False, N)
             for adv in ("MinMax", "SignGuard", "Attackclippedclustering")]
          + [("Median", "SignFlip", True, N), ("Multikrum", "ALIE", False, 7)])

# Collectives one package's width-sharded round issues and the other's
# does not (as labelled by each model), per aggregator or forge.
JAX_ONLY = {
    # The port's rounds hold the malicious mask replicated on every rank.
    None: {"malicious_gather"},
    # JAX psums the assembled pairwise-distance partial once (n*n
    # floats); the port psums the squared norms and the Gram (n more).
    "Multikrum": {"pairwise_sq_dists"},
    # JAX psums the three trust terms in one (1 + 2n) vector.
    "FLTrust": {"trust_geometry"},
    # JAX's census is one int32 (2, n) psum.
    "Signguard": {"sign_census"},
    "SignGuard": {"signguard_sign_census"},
    "Attackclippedclustering": {"acc_mean_angles"},
}
PORT_ONLY = {
    "Multikrum": {"row_sq_norms", "gram"},
    "FLTrust": {"trust_s_norm", "trust_row_norms", "trust_row_dots"},
    # The clip's own norms psum (JAX reuses the row norms); the census as
    # two int64 (n,) psums.
    "Signguard": {"clip_row_norms", "sign_census_pos", "sign_census_neg"},
    # The clip's norms and the clipped rows' norms.
    "Clippedclustering": {"clip_row_norms", "clipped_row_norms"},
    # Two int64 scalar psums.
    "SignGuard": {"signguard_census_pos", "signguard_census_neg"},
    # The mean's norm (twice) and the dots, one psum each.
    "Attackclippedclustering": {"acc_mean_norm", "acc_mean_dots"},
}
# Split psums: the same wire bytes in both packages.
SAME_WIRE = {"FLTrust"}


def _kw(agg):
    """The aggregator's own loop counts, handed to both models."""
    from blades_tpu_torch.ops.aggregators import get_aggregator

    a = get_aggregator(agg, num_byzantine=F)
    return dict(geomed_maxiter=getattr(a, "maxiter", 100),
                dnc_num_iters=getattr(a, "num_iters", 5),
                dnc_sub_dim=getattr(a, "sub_dim", 10000),
                cc_n_iter=getattr(a, "n_iter", 5))


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------


def _dsharded_case(case, rank):
    """One width-sharded round per point: each rank's recorded events."""
    from blades_tpu_torch.adversaries import get_adversary, \
        make_malicious_mask
    from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec
    from blades_tpu_torch.models.mlp import MLP
    from blades_tpu_torch.parallel import (
        dsharded_step,
        make_mesh,
        shard_federation,
    )

    mesh = make_mesh()
    out = []
    for agg, adv, health, n in case["points"]:
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.normal(size=(n, ROWS) + SHAPE)
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 2, size=(n, ROWS))).long()
        lengths = torch.full((n,), ROWS, dtype=torch.long)
        fr = FedRound(
            task=TaskSpec(model=MLP(16, hidden1=8, hidden2=8, num_classes=2),
                          num_classes=2, input_shape=SHAPE, lr=0.1).build(),
            server=Server.from_config(agg, num_byzantine=F, lr=0.5),
            adversary=get_adversary(adv, num_clients=n, num_byzantine=F),
            batch_size=2, num_batches_per_round=1, num_clients=n,
            health_check=health,
            trusted_data=(x[0], y[0]) if agg == "FLTrust" else None)
        params = fr.task.init_params(torch.Generator().manual_seed(0))
        state = RoundState(server=fr.server.init(params, n),
                           client_opt=fr.task.init_client_opt_state(params,
                                                                    n))
        state, data = shard_federation(mesh, state, (x, y, lengths))
        step = dsharded_step(fr, mesh)
        step(state, *data, make_malicious_mask(n, F), 7)
        out.append({"events": list(step.recorder.ici_events),
                    "ici_bytes": step.recorder.ici_bytes,
                    "d": sum(v.numel() for v in params.values())})
    return out


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm_model")
    case = {"kind": "test_torch_comm_model:_dsharded_case", "points": POINTS}
    return start_ranks({"d2": (WORLD, [case])}, tmp).results()["d2"]


def _expand(vols, k):
    return [(v.label, v.kind, v.payload_bytes, k) for v in vols
            for _ in range(v.count)]


@pytest.mark.parametrize("point", POINTS,
                         ids=[f"{a}-{b}-{'health' if h else 'plain'}-{n}"
                              for a, b, h, n in POINTS])
def test_recorder_equals_the_port_model(ranks, point):
    """Every collective each rank's width-sharded round issues, counted
    under its label by the helpers it calls (the swap, the gathers,
    ShardInfo's psums and gathers), equals ``dsharded_round_volumes``
    event by event, in order, and the recorder's wire total the
    model's."""
    from blades_tpu_torch.parallel.comm_model import (
        dsharded_round_volumes,
        hier_wire_bytes,
    )

    agg, adv, health, n = point
    i = POINTS.index(point)
    for res in ranks:
        got = res[0][i]
        vols = dsharded_round_volumes(n, got["d"], WORLD, aggregator=agg,
                                      adversary=adv, health_check=health,
                                      **_kw(agg))
        assert [tuple(e) for e in got["events"]] == _expand(vols, WORLD)
        assert got["ici_bytes"] == hier_wire_bytes([(v, WORLD)
                                                    for v in vols])


def _as_jax(vols):
    from blades_tpu.parallel.comm_model import CollectiveVolume as JV

    return [JV(v.label, v.kind, v.payload_bytes, v.count, v.in_loop)
            for v in vols]


def _entries(vols, drop):
    return sorted((v.label, v.kind, v.payload_bytes, v.count, v.in_loop)
                  for v in vols if v.label not in drop)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("agg,adv", [(a, "ALIE") for a in AGGREGATORS]
                         + [("Mean", a) for a in
                            ("MinMax", "SignGuard",
                             "Attackclippedclustering", None)])
def test_dsharded_volumes_match_jax_but_named_labels(agg, adv, k):
    """At ``d`` a multiple of ``64 k`` both models pad alike; with the f32
    update matrix and the aggregator's own loop counts handed to both,
    every entry agrees but the labels named above (a split psum moves the
    same wire bytes)."""
    from blades_tpu.parallel import comm_model as J
    from blades_tpu_torch.parallel import comm_model as P

    d, n = 64 * k * 200, 24
    kw = _kw(agg)
    mine = P.dsharded_round_volumes(n, d, k, aggregator=agg, adversary=adv,
                                    **kw)
    theirs = J.dsharded_round_volumes(
        n, d, k, update_bytes=4, aggregator=agg, adversary=adv,
        health_check=False, **kw)
    port_only = PORT_ONLY.get(agg, set()) | PORT_ONLY.get(adv, set())
    jax_only = (JAX_ONLY[None] | JAX_ONLY.get(agg, set())
                | JAX_ONLY.get(adv, set()))
    if agg == "DnC":
        # One psum of the (num_iters, n, sub) stack against num_iters of
        # (n, sub): the same bytes.
        port_only, jax_only = port_only | {"sampled_columns"}, \
            jax_only | {"sampled_columns"}
        (a,) = [v for v in mine if v.label == "sampled_columns"]
        (b,) = [v for v in theirs if v.label == "sampled_columns"]
        assert a.wire_bytes(k) == b.wire_bytes(k)
    assert _entries(mine, port_only) == _entries(theirs, jax_only)
    assert {v.label for v in mine} >= port_only
    assert {v.label for v in theirs} >= jax_only
    for name in SAME_WIRE & {agg, adv}:
        pw = sum(v.wire_bytes(k) for v in mine if v.label in PORT_ONLY[name])
        jw = sum(v.wire_bytes(k) for v in theirs
                 if v.label in JAX_ONLY[name])
        assert pw == jw, name


@pytest.mark.parametrize("n,d", [(1, 1), (7, 1000), (64, 4_903_242),
                                 (1000, 11_173_962)])
def test_uplink_bytes_match_jax_and_the_codec(n, d):
    from blades_tpu.comm import CodecConfig as JaxCodec
    from blades_tpu.parallel.comm_model import uplink_bytes as jax_uplink
    from blades_tpu_torch.comm import CodecConfig
    from blades_tpu_torch.parallel.comm_model import uplink_bytes

    assert uplink_bytes(n, d) == jax_uplink(n, d, update_bytes=4) \
        == n * d * 4
    assert uplink_bytes(n, d, update_bytes=2) == jax_uplink(
        n, d, update_bytes=2)
    for kw in ({"name": "identity"}, {"name": "quant", "bits": 8},
               {"name": "quant", "bits": 4},
               {"name": "topk", "topk_ratio": 0.01},
               {"name": "topk", "topk_ratio": 0.3}):
        mine, theirs = CodecConfig(**kw), JaxCodec(**kw)
        assert uplink_bytes(n, d, mine) == jax_uplink(n, d, theirs) \
            == mine.payload_bytes(n, d), kw


def test_wire_arithmetic_matches_jax():
    from blades_tpu.parallel import comm_model as J
    from blades_tpu_torch.parallel import comm_model as P

    vols = []
    for kind in ("all_to_all", "all_gather", "psum"):
        for count, loop in ((1, False), (3, False), (12, True)):
            vols.append(P.CollectiveVolume(f"{kind}{count}", kind,
                                           1_000_003 * count, count, loop))
    jvols = _as_jax(vols)
    for v, jv in zip(vols, jvols):
        assert v.static_bytes == jv.static_bytes
        for k in (1, 2, 3, 4, 7, 8):
            assert v.wire_bytes(k) == jv.wire_bytes(k)
    for k in (2, 3, 4, 8):
        assert P.wire_bytes_per_chip(vols, k) == J.wire_bytes_per_chip(
            jvols, k)
        for rate in (1e9, P.H100_NVLINK_BYTES_PER_SEC):
            assert P.ici_seconds(vols, k, rate) == J.ici_seconds(jvols, k,
                                                                 rate)
    with pytest.raises(ValueError, match="unknown collective kind"):
        P.CollectiveVolume("x", "scatter", 4).wire_bytes(2)


@pytest.mark.parametrize("adv,f", [("ALIE", 250), ("SignFlip", 250),
                                   (None, 0), ("ALIE", 1), ("MinMax", 100)])
def test_projection_matches_jax(monkeypatch, adv, f):
    """The projection's arithmetic and its elision gate equal JAX's on the
    same collective inventory (JAX's model handed the port's), the link
    rate passed to both."""
    from blades_tpu.parallel import comm_model as J
    from blades_tpu_torch.parallel import comm_model as P

    n, k, d, rate = 1000, 8, 11_173_962, 2.0e11
    kw = dict(aggregator="Median", adversary=adv, num_malicious=f,
              ici_bytes_per_sec=rate)
    mine = P.project_multichip_rounds_per_sec(1.3, 750, n, k, d, **kw)
    inventory = P.dsharded_round_volumes(n, d, k, aggregator="Median",
                                         adversary=adv)
    monkeypatch.setattr(J, "dsharded_round_volumes",
                        lambda *a, **kw: _as_jax(inventory))
    theirs = J.project_multichip_rounds_per_sec(1.3, 750, n, k, d, **kw)
    for key in ("rounds_per_sec", "kind", "t_compute_s", "t_ici_s",
                "wire_bytes_per_chip", "ici_bytes_per_sec",
                "dominant_collective", "trained_lanes_per_chip"):
        assert mine[key] == theirs[key], key
    assert (mine["trained_lanes_per_chip"]
            == n // k - (f // k if adv in ("ALIE", "MinMax") and f >= k
                         else 0))


def test_no_tpu_figure_in_the_port_model():
    """The port's default link rate is the H100 SXM data-sheet NVLink
    figure, one way; the JAX package's TPU constant does not enter it."""
    import inspect

    from blades_tpu_torch.parallel import comm_model as P

    assert P.H100_NVLINK_BYTES_PER_SEC == 4.5e11
    src = inspect.getsource(P)
    assert "V5E" not in src and "9.0e10" not in src
    sig = inspect.signature(P.ici_seconds)
    assert sig.parameters["ici_bytes_per_sec"].default == 4.5e11
