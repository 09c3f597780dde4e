"""The port's hierarchical round (blades_tpu_torch/parallel/hier.py) and its
pre-aggregation (blades_tpu_torch/ops/preagg.py) against the JAX package's.

``bucket_representatives`` / ``nnm_representatives`` equal JAX's on the
same rows and ghost masks (the identity at ``bucket_size=1`` bit for bit,
``rtol=1e-6`` otherwise: f32 sums in another order).  Two gloo groups run
at once, one process a rank: a ``(2, 1)`` mesh of 2 ranks and a ``(2, 2)``
mesh of 4 (the representatives gathered over ``clients``, then over
``d``).  On both:

- at ``bucket_size=1`` the round over JAX-drawn batches and dropout masks
  (MLP, ALIE + Median, 8 clients) matches JAX's one-device dense
  ``FedRound.step_prebatched`` within ``rtol=1e-5, atol=1e-6`` and equals
  the port's one-process dense round bit for bit; so does the Fedavg
  driver with ``execution="hier"`` against the one-process driver;
- at ``bucket_size=2`` (bucket at 8 and 7 clients, nnm at 8) the round
  matches a reference built from the JAX package's own parts with no
  mesh: ``task.local_round_batched`` over the dense keys, JAX's
  pre-aggregation per rank block, then ``FedRound.finish_dense`` with the
  representatives' malicious mask, as ``blades_tpu/parallel/hier.py``
  composes them;
- the recorder's events equal the port's ``hier_round_volumes`` in both
  directions, and those equal the JAX package's; the rows carry
  ``ici_bytes = hier_wire_bytes(hier_round_volumes(...))``,
  ``preagg_kept`` and ``mesh_shape``.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_mesh import start_ranks
from test_torch_sharded import (
    ATOL,
    RTOL,
    assert_same,
    flat,
    jax_dense_rounds,
    jax_inputs,
    prebatched_case,
    run_config,
)

from blades_tpu.ops import preagg as jax_preagg
from blades_tpu.parallel.comm_model import \
    hier_round_volumes as jax_hier_round_volumes
from blades_tpu.parallel.hier import hier_kept_counts
from blades_tpu_torch.ops.preagg import (
    PREAGG_FLAVORS,
    bucket_count,
    bucket_representatives,
    nnm_representatives,
)
from blades_tpu_torch.parallel.comm_model import (
    hier_round_volumes,
    hier_wire_bytes,
)

MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
# (name, preagg, bucket_size, clients)
ROUND_CASES = [("identity", "bucket", 1, 8), ("bucket2", "bucket", 2, 8),
               ("bucket2-ghost", "bucket", 2, 7), ("nnm2", "nnm", 2, 8)]


@pytest.mark.parametrize("bucket_size", [1, 2, 3])
@pytest.mark.parametrize("flavor", PREAGG_FLAVORS)
@pytest.mark.parametrize("ghosts", [0, 2])
def test_preagg_matches_jax(flavor, bucket_size, ghosts):
    rng = np.random.default_rng(bucket_size + 10 * ghosts)
    x = rng.normal(size=(7, 9)).astype(np.float32)
    real = np.arange(7) < 7 - ghosts
    if ghosts:
        x[~real] = np.nan  # a ghost never reaches a real representative
    fn = {"bucket": (bucket_representatives,
                     jax_preagg.bucket_representatives),
          "nnm": (nnm_representatives, jax_preagg.nnm_representatives)}
    port, jx = fn[flavor]
    got = port(torch.from_numpy(x), torch.from_numpy(real), bucket_size)
    want = np.asarray(jx(jnp.asarray(x), jnp.asarray(real), bucket_size))
    assert got.shape == want.shape
    if flavor == "bucket":
        assert got.shape[0] == bucket_count(7, bucket_size) \
            == jax_preagg.bucket_count(7, bucket_size)
        keep = np.repeat(np.arange(got.shape[0]), bucket_size)[:7][real]
        rows = np.unique(keep)
    else:
        rows = np.flatnonzero(real)
    if bucket_size == 1:
        np.testing.assert_array_equal(got.numpy()[rows], want[rows])
        np.testing.assert_array_equal(got.numpy()[rows], x[rows])
    else:
        np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=1e-6,
                                   atol=1e-7)
    assert np.isfinite(got.numpy()[rows]).all()


@pytest.mark.parametrize("bucket_size", [2, 3])
def test_nnm_over_column_slices_matches_jax(monkeypatch, bucket_size):
    """NNM's distances summed over column slices of 2 (the slice a
    ``(7, 7, cols)`` difference of at most 98 values gives) select the
    neighbors JAX's whole-width distances select."""
    from blades_tpu_torch.ops import preagg

    monkeypatch.setattr(preagg, "_PAIR_ELEMS", 2 * 7 * 7)
    rng = np.random.default_rng(bucket_size)
    x = rng.normal(size=(7, 9)).astype(np.float32)
    real = np.arange(7) < 5
    x[~real] = np.nan
    got = nnm_representatives(torch.from_numpy(x), torch.from_numpy(real),
                              bucket_size)
    want = np.asarray(jax_preagg.nnm_representatives(
        jnp.asarray(x), jnp.asarray(real), bucket_size))
    np.testing.assert_allclose(got.numpy()[real], want[real], rtol=1e-6,
                               atol=1e-7)


def jax_hier_reference(ref, c, b, preagg):
    """``blades_tpu/parallel/hier.py:197-249`` with no mesh: the dense
    keys' local rounds, JAX's pre-aggregation over each rank's block of
    the padded matrix, then ``finish_dense`` over the representatives with
    their malicious mask."""
    jfr, state, n = ref["jfr"], ref["jstate0"], ref["n"]
    mal = jnp.asarray(ref["malicious"].numpy())
    n_local = -(-n // c)
    n_pad = c * n_local
    hooks = jfr._hooks()
    fn = (jax_preagg.nnm_representatives if preagg == "nnm"
          else jax_preagg.bucket_representatives)
    if preagg == "nnm":
        kept = n
    else:
        m = jax_preagg.bucket_count(n_local, b)
        kept = sum(hier_kept_counts(n, n_local, c, b))

    @jax.jit
    def one_round(state, bx, by, key):
        _, k_train, k_adv, k_agg, k_dp = jax.random.split(key, 5)
        upd, opt, losses = jfr.task.local_round_batched(
            state.server.params, state.client_opt, bx, by,
            jax.random.split(k_train, n), mal, *hooks)
        upd = jnp.pad(upd, ((0, n_pad - n), (0, 0)))
        real = jnp.arange(n_pad) < n
        reps = jnp.concatenate([
            fn(upd[i * n_local:(i + 1) * n_local],
               real[i * n_local:(i + 1) * n_local], b) for i in range(c)])
        if preagg == "nnm":
            rep_mal = mal
        else:
            per = jnp.pad(mal, (0, n_pad - n)).reshape(c, n_local)
            per = jnp.pad(per, ((0, 0), (0, m * b - n_local)))
            rep_mal = per.reshape(c, m, b).any(-1).reshape(c * m)[:kept]
        return jfr.finish_dense(
            state, reps[:kept], opt, losses, rep_mal, k_adv, k_agg, k_dp,
            loss_benign=~mal)

    out = []
    for r in ref["rounds"]:
        state, metrics = one_round(state, jnp.asarray(r["jbx"]),
                                   jnp.asarray(r["jby"]), r["key"])
        out.append((state, metrics, kept))
    return out


@pytest.fixture(scope="module")
def inputs():
    return {8: jax_inputs("alie-median"), 7: jax_inputs("ghost-lanes")}


def _hier_cfg(n, mesh, preagg, b, **extra):
    c, dd = mesh
    return run_config("ghost-lanes" if n == 7 else "alie-median",
                      num_devices=c * dd, mesh_shape=mesh, execution="hier",
                      preagg=preagg, bucket_size=b, **extra)


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier")
    spec = {}
    for name, mesh in MESHES.items():
        cases = [prebatched_case(inputs[n], _hier_cfg(n, mesh, p, b),
                                 dense=(b == 1))
                 for _, p, b, n in ROUND_CASES]
        drv = dict(evaluation_interval=2, seed=5)
        b = 1 if name == "2x1" else 2
        cases.append({"kind": "driver", "rounds": 2, "dense": b == 1,
                      "config": _hier_cfg(8, mesh, "bucket", b, **drv)})
        spec[name] = (mesh[0] * mesh[1], cases)
    return start_ranks(spec, tmp)


@pytest.fixture(scope="module")
def refs(inputs, launched):
    """JAX's dense rounds at 8 clients and the JAX-parts references of
    the bucketed cases (both meshes have two ``clients`` ranks, so one
    reference serves both), computed while the ranks run."""
    assert {c for c, _ in MESHES.values()} == {2}
    out = {name: jax_hier_reference(inputs[n], 2, b, p)
           for name, p, b, n in ROUND_CASES[1:]}
    out["dense"] = jax_dense_rounds(inputs[8])
    return out


@pytest.fixture(scope="module")
def groups(launched, refs):
    return launched.results()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_identity_hier_matches_jax_and_the_dense_round(groups, refs, mesh):
    res = groups[mesh]
    for r in range(len(res)):
        out = res[r][0]
        for got, (jstate, jm) in zip(out["rounds"], refs["dense"]):
            np.testing.assert_allclose(
                flat(got["params"]), ravel_pytree(jstate.server.params)[0],
                rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got["metrics"]["agg_norm"],
                                       float(jm["agg_norm"]), rtol=RTOL,
                                       atol=ATOL)
            assert got["metrics"]["preagg_kept"] == 8
        assert_same(out["rounds"][-1]["params"],
                    res[0][0]["rounds"][-1]["params"])
    for got, want in zip(res[0][0]["rounds"], res[0][0]["dense"]):
        assert_same(got["params"], want["params"])
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == v, k


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", [c[0] for c in ROUND_CASES[1:]])
def test_bucketed_hier_matches_the_jax_parts(groups, refs, mesh, case):
    i = [c[0] for c in ROUND_CASES].index(case)
    want = refs[case]
    for rank_res in groups[mesh]:
        for got, (jstate, jm, kept) in zip(rank_res[i]["rounds"], want):
            np.testing.assert_allclose(
                flat(got["params"]), ravel_pytree(jstate.server.params)[0],
                rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got["metrics"]["train_loss"],
                                       float(jm["train_loss"]), rtol=RTOL,
                                       atol=ATOL)
            assert got["metrics"]["preagg_kept"] == kept


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("case", [c[0] for c in ROUND_CASES])
def test_recorder_reconciles_with_the_comm_model(groups, mesh, case):
    """Every recorded collective is in the model and every modelled one
    was recorded (as multisets of ``(label, kind, payload, ring)``), the
    port's model is the JAX package's, and ``ici_bytes`` is the model's
    ring wire total."""
    i = [c[0] for c in ROUND_CASES].index(case)
    _, preagg, b, n = ROUND_CASES[i]
    d = sum(v.numel() for v in groups[mesh][0][i]["rounds"][0]["params"]
            .values())
    vols = hier_round_volumes(n, d, MESHES[mesh], preagg=preagg,
                              bucket_size=b)
    jvols = jax_hier_round_volumes(n, d, MESHES[mesh], preagg=preagg,
                                   bucket_size=b)
    model = Counter((v.label, v.kind, v.payload_bytes, k) for v, k in vols)
    assert model == Counter((v.label, v.kind, v.payload_bytes, k)
                            for v, k in jvols)
    for rank_res in groups[mesh]:
        for rnd in rank_res[i]["rounds"]:
            assert Counter(rnd["events"]) == model
            assert rnd["ici_bytes"] == rnd["metrics"]["ici_bytes"] \
                == hier_wire_bytes(vols)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_hier_driver_rows(groups, mesh):
    """The Fedavg driver with ``execution="hier"``: at ``bucket_size=1``
    (2x1) the one-process driver's parameters bit for bit; at 2 (2x2)
    rows stamped with the model's wire bytes, the kept height and the
    mesh; both evaluate."""
    out = groups[mesh][0][len(ROUND_CASES)]
    rows = out["mesh"]["rows"]
    assert "test_acc" in rows[-1]
    assert rows[-1]["mesh_shape"] == mesh
    d = sum(v.numel() for v in out["mesh"]["params"].values())
    b = 1 if mesh == "2x1" else 2
    vols = hier_round_volumes(8, d, MESHES[mesh], bucket_size=b)
    assert all(r["ici_bytes"] == hier_wire_bytes(vols) for r in rows)
    assert rows[-1]["preagg_kept"] == (8 if b == 1 else 4)
    if b == 1:
        assert_same(out["mesh"]["params"], out["dense"]["params"])
        for got, want in zip(rows, out["dense"]["rows"]):
            assert got["train_loss"] == want["train_loss"]
