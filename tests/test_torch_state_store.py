"""The port's participation-window store (blades_tpu_torch/state/):

- the ``resident``, ``host`` and ``disk`` backends move rows bit for bit
  (gather / scatter, any id order, across shards) and their streaming
  shard checkpoints restore under any backend;
- a torn, truncated or corrupt shard and a missing manifest raise
  ``StateStoreError``; orphaned ``.tmp`` files are removed;
- a JAX-written store checkpoint is read into a port store
  (``convert.store_from_jax_checkpoint``): the rows equal the JAX rows;
- through the driver, the three backends give bit-identical parameters and
  store rows (staging forced on for ``host``, so prefetch on/off rides the
  same check), and so does an async run whose event cohort's rows live in
  a ``host`` store against the resident async run.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.convert import store_from_jax_checkpoint
from blades_tpu_torch.state import (
    DiskStore,
    HostStore,
    StatePrefetcher,
    StateStoreError,
    make_store,
    read_checkpoint_rows,
    sample_cohort,
)

WINDOWED = {
    "dataset_config": {"type": "mnist", "num_clients": 8, "train_bs": 8,
                       "seed": 3},
    "global_model": "mlp", "client_config": {"lr": 0.1, "momentum": 0.9},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}},
    "state_window": 4, "evaluation_interval": 0,
}


def _template(d=5):
    return {"client_opt": torch.zeros(d), "residual": torch.full((d,), 0.5)}


def _stores(tmp_path, n=11, shard_rows=None):
    t = _template()
    disk = (DiskStore(n, t, directory=str(tmp_path / "live"),
                      shard_rows=shard_rows) if shard_rows
            else make_store("disk", n, t, directory=str(tmp_path / "live")))
    return [make_store("resident", n, t, device="cpu"),
            make_store("host", n, t), disk]


def test_sample_cohort_is_sorted_distinct_and_pure():
    a = sample_cohort(123, 50, 10)
    assert np.array_equal(a, sample_cohort(123, 50, 10))
    assert np.array_equal(a, np.sort(a)) and len(set(a.tolist())) == 10
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 50
    assert not np.array_equal(a, sample_cohort(124, 50, 10))
    assert len(sample_cohort(1, 5, 5)) == 5
    for bad in (0, 6):
        with pytest.raises(ValueError, match="window"):
            sample_cohort(1, 5, bad)


def test_backends_move_rows_bit_for_bit(tmp_path):
    stores = _stores(tmp_path, shard_rows=3)
    rng = np.random.default_rng(0)
    for _ in range(4):
        ids = rng.permutation(11)[:6]  # any order, across shards
        rows = {"client_opt": torch.from_numpy(
            rng.normal(size=(6, 5)).astype(np.float32)),
            "residual": torch.from_numpy(
                rng.normal(size=(6, 5)).astype(np.float32))}
        for s in stores:
            s.scatter(ids, rows)
    every = np.arange(11)
    want = stores[0].gather(every)
    for s in stores[1:]:
        got = s.gather(every)
        assert all(torch.equal(got[k], want[k]) for k in want)
        back = s.gather(np.array([9, 2, 7]))
        assert torch.equal(back["client_opt"], want["client_opt"][[9, 2, 7]])
    assert stores[0].row_bytes == 40 and stores[2].total_bytes() == 440
    for s in stores:
        s.close()


def test_shard_checkpoints_restore_under_any_backend(tmp_path):
    src = make_store("host", 11, _template())
    rng = np.random.default_rng(1)
    src.scatter(np.arange(11), {k: torch.from_numpy(rng.normal(
        size=(11, 5)).astype(np.float32)) for k in ("client_opt",
                                                     "residual")})
    src.save(tmp_path / "ckpt", shard_rows=4)
    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert manifest["num_shards"] == 3 and len(manifest["files"]) == 6
    want = src.gather(np.arange(11))
    for dst in _stores(tmp_path):
        dst.load(tmp_path / "ckpt")
        got = dst.gather(np.arange(11))
        assert all(torch.equal(got[k], want[k]) for k in want)
        dst.close()
    stacked = read_checkpoint_rows(tmp_path / "ckpt", _template(), 11)
    assert torch.equal(stacked["residual"], want["residual"])
    with pytest.raises(StateStoreError, match="registered"):
        HostStore(12, _template()).load(tmp_path / "ckpt")
    with pytest.raises(StateStoreError, match="row layout"):
        HostStore(11, {"client_opt": torch.zeros(6)}).load(tmp_path / "ckpt")


@pytest.mark.parametrize("damage", ["truncate", "flip", "delete",
                                    "manifest"])
def test_torn_or_corrupt_shards_raise_and_orphans_go(tmp_path, damage):
    src = make_store("host", 9, _template())
    src.scatter(np.arange(9), {k: torch.randn(9, 5)
                               for k in ("client_opt", "residual")})
    ckpt = tmp_path / "ckpt"
    src.save(ckpt, shard_rows=4)
    (ckpt / "shard-00009.l00.npy.tmp").write_bytes(b"partial")
    victim = ckpt / "shard-00001.l01.npy"
    if damage == "truncate":
        victim.write_bytes(victim.read_bytes()[:-7])
        match = "torn"
    elif damage == "flip":
        raw = bytearray(victim.read_bytes())
        raw[-3] ^= 0xFF
        victim.write_bytes(bytes(raw))
        match = "CRC32"
    elif damage == "delete":
        victim.unlink()
        match = "missing shard"
    else:
        (ckpt / "manifest.json").unlink()
        match = "no manifest"
    with pytest.raises(StateStoreError, match=match):
        HostStore(9, _template()).load(ckpt)
    if damage != "manifest":
        assert not list(ckpt.glob("*.tmp"))


def _jax_windowed_store(tmp_path, codec):
    from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig

    run = {**WINDOWED, "state_store": "host"}
    if codec:
        run["codec_config"] = codec
    jalgo = JaxFedavgConfig().update_from_dict(run).build()
    for _ in range(2):
        jalgo.train()
    jalgo._state_pf.flush()
    store = jalgo._state_store
    path = tmp_path / "jax_ckpt"
    store.save(path, shard_rows=3)
    rows = store.gather(np.arange(8))
    jalgo.stop()
    return path, rows


@pytest.mark.parametrize("codec", [None, {"type": "topk", "topk_ratio": 0.1}],
                         ids=["momentum", "momentum+topk-ef"])
def test_a_jax_store_checkpoint_is_read_by_the_port(tmp_path, codec):
    path, jrows = _jax_windowed_store(tmp_path, codec)
    run = {**WINDOWED, "state_store": "disk"}
    if codec:
        run["codec_config"] = codec
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    store = algo._state_store
    store_from_jax_checkpoint(path, store)
    got = store.gather(np.arange(8))
    trace = jrows["client_opt"][0].trace
    want_opt = np.stack([np.asarray(ravel_pytree(jax.tree.map(
        lambda t: t[i], trace))[0]) for i in range(8)])
    np.testing.assert_array_equal(got["client_opt"].numpy(), want_opt)
    assert np.abs(want_opt).sum() > 0
    if codec:
        np.testing.assert_array_equal(got["residual"].numpy(),
                                      np.asarray(jrows["residual"]))
    algo.stop()
    with pytest.raises(StateStoreError, match="values a row"):
        store_from_jax_checkpoint(path, HostStore(8, {"residual":
                                                      torch.zeros(3)}))


def test_prefetcher_surfaces_a_failed_writeback():
    class Broken(HostStore):
        def _put(self, ids, arrays):
            raise OSError("disk full")

    pf = StatePrefetcher(Broken(4, _template()),
                         (np.zeros((4, 2, 3)), np.zeros((4, 2)),
                          np.full(4, 2)), np.zeros(4, bool),
                         lambda r: np.array([0, 2]), device="cpu",
                         async_staging=True)
    pf.writeback(np.array([0, 2]), {k: torch.zeros(2, 5)
                                    for k in ("client_opt", "residual")})
    with pytest.raises(OSError, match="disk full"):
        pf.flush()
    pf.close()


def _run(backend, rounds=3, **extra):
    run = {**WINDOWED, "state_store": backend, **extra}
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    rows = [algo.train() for _ in range(rounds)]
    if algo._state_pf is not None:
        algo._state_pf.flush()
    params = {k: v.clone() for k, v in algo.state.server.params.items()}
    store = algo._state_store.gather(np.arange(algo.config.num_clients))
    algo.stop()
    return rows, params, store


@pytest.mark.parametrize("aggregator", ["Mean", "Median"])
def test_the_three_backends_are_bit_identical_through_the_driver(aggregator):
    runs = {}
    for backend, prefetch in (("resident", False), ("host", True),
                              ("disk", False)):
        runs[backend] = _run(backend, prefetch=prefetch,
                             server_config={"lr": 1.0, "aggregator":
                                            {"type": aggregator}})
    rows0, params0, store0 = runs["resident"]
    for backend in ("host", "disk"):
        rows, params, store = runs[backend]
        assert [r["train_loss"] for r in rows] == [r["train_loss"]
                                                   for r in rows0]
        assert all(torch.equal(params[k], params0[k]) for k in params0)
        assert torch.equal(store["client_opt"], store0["client_opt"])
        assert rows[-1]["state_store"] == backend
        assert rows[-1]["cohort_size"] == 4
        assert rows[-1]["state_bytes_staged"] > 0
    # Some rows moved, the others are still the zero template.
    moved = store0["client_opt"].abs().sum(1) > 0
    assert 0 < int(moved.sum()) <= 8


def test_async_event_cohort_through_a_host_store_equals_resident():
    run = {"dataset_config": {"type": "mnist", "num_clients": 8,
                              "train_bs": 8},
           "global_model": "mlp", "execution": "async",
           "async_config": {"rate": 0.4, "agg_every": 4},
           "client_config": {"momentum": 0.9},
           "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
           "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
           "evaluation_interval": 0}
    out = {}
    for store in ("resident", "host", "disk"):
        algo = FedavgConfig().update_from_dict(
            {**run, "state_store": store}).build(device="cpu")
        rows = [algo.train() for _ in range(3)]
        opt = algo.state.client_opt
        if store != "resident":
            flat = algo._state_store.gather(np.arange(8))["client_opt"]
            from blades_tpu_torch.utils.tree import FlatLayout

            opt = FlatLayout(algo.state.server.params).unravel_rows(flat)
            assert rows[-1]["state_store"] == store
            assert rows[-1]["cohort_size"] == 4
        out[store] = (rows, {k: v.clone() for k, v in
                             algo.state.server.params.items()}, opt)
        algo.stop()
    rows0, p0, o0 = out["resident"]
    for store in ("host", "disk"):
        rows, p, o = out[store]
        assert [r["train_loss"] for r in rows] == [r["train_loss"]
                                                   for r in rows0]
        assert all(torch.equal(p[k], p0[k]) for k in p0)
        assert all(torch.equal(o[k], o0[k]) for k in o0)


def test_staging_worker_under_thread_pressure_equals_inline_staging():
    """Ten windowed rounds with the staging worker on, the interpreter
    switching threads every microsecond, against inline staging: the same
    parameters and store rows (the write-back of round r lands before any
    stage that revisits its ids)."""
    import sys
    import time

    t0 = time.perf_counter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = [_run("host", rounds=10, prefetch=on,
                    dataset_config={**WINDOWED["dataset_config"],
                                    "num_clients": 6})
               for on in (True, False)]
    finally:
        sys.setswitchinterval(old)
    (r0, p0, s0), (r1, p1, s1) = out
    assert [r["train_loss"] for r in r0] == [r["train_loss"] for r in r1]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(s0["client_opt"], s1["client_opt"])
    assert time.perf_counter() - t0 < 120
