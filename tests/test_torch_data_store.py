"""The port's out-of-core training data (blades_tpu_torch/data/store.py,
data/stream.py):

- the ``resident`` and ``memmap`` backends assemble the same rows bit for
  bit, in any id order and across shards, and so do windowed rounds on
  either;
- a verified shard set under a named directory is reused, a torn or
  corrupt one is rebuilt from the source, and
  ``validate_datastore_dir`` names what is wrong; a shard set the JAX
  package wrote is reused as is (the same format);
- streaming evaluation against the monolithic one within float
  tolerance (``rtol=1e-5``: f32 sums in chunks, then float64), two
  streaming walks bit for bit, and against the JAX package's walk.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.core import FedRound, Server, TaskSpec
from blades_tpu_torch.data.store import (
    MemmapDataStore,
    make_data_store,
    validate_datastore_dir,
)
from blades_tpu_torch.data.stream import (
    DataPrefetcher,
    make_chunk_evaluator,
    streaming_evaluate,
)

WINDOWED = {
    "dataset_config": {"type": "mnist", "num_clients": 8, "train_bs": 8,
                       "seed": 3},
    "global_model": "mlp", "client_config": {"lr": 0.1, "momentum": 0.9},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}},
    "state_window": 4, "evaluation_interval": 2,
}


def _source(n=10, shard=3, feat=(2, 2, 1), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, shard) + feat).astype(np.float32),
            rng.integers(0, 4, size=(n, shard)).astype(np.int32),
            rng.integers(1, shard + 1, size=(n,)).astype(np.int32))


def test_backends_take_the_same_rows(tmp_path):
    src = _source()
    res = make_data_store("resident", src)
    mm = MemmapDataStore(src, directory=str(tmp_path / "d"), shard_rows=4)
    for ids in (np.arange(10), np.array([9, 0, 4, 3, 8]), np.array([5])):
        for a, b, s in zip(res.take(ids), mm.take(ids), src):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, s[ids])
        g = mm.gather(ids, device="cpu")
        assert torch.equal(g[0], torch.from_numpy(src[0][ids]))
    pf = DataPrefetcher(mm)
    x, y, ln = pf.gather(np.array([2, 7]), device="cpu")
    assert y.dtype == torch.int64 and ln.dtype == torch.int64
    assert pf.stats.last_bytes_staged == 2 * mm.row_bytes
    assert mm.total_bytes() == 10 * mm.row_bytes
    pf.close()
    with pytest.raises(ValueError, match="data_store"):
        make_data_store("tape", src)


def test_verified_sets_are_reused_and_broken_ones_rebuilt(tmp_path):
    src = _source()
    d = tmp_path / "d"
    first = MemmapDataStore(src, directory=str(d), shard_rows=4)
    assert first.rebuilt
    stamp = os.stat(d / "shard-00000.l00.npy").st_mtime_ns
    again = MemmapDataStore(src, directory=str(d), shard_rows=4)
    assert not again.rebuilt
    assert os.stat(d / "shard-00000.l00.npy").st_mtime_ns == stamp
    victim = d / "shard-00001.l00.npy"
    raw = bytearray(victim.read_bytes())
    raw[-2] ^= 0x55
    victim.write_bytes(bytes(raw))
    (d / "shard-00002.l01.npy.tmp").write_bytes(b"x")
    n, errors = validate_datastore_dir(d)
    assert n == 9 and any("CRC32" in e for e in errors)
    assert any("orphaned" in e for e in errors)
    rebuilt = MemmapDataStore(src, directory=str(d), shard_rows=4)
    assert rebuilt.rebuilt and validate_datastore_dir(d) == (9, [])
    np.testing.assert_array_equal(rebuilt.take(np.arange(10))[0], src[0])
    victim.write_bytes(victim.read_bytes()[:-5])
    assert any("torn" in e for e in validate_datastore_dir(d)[1])
    (d / "manifest.json").unlink()
    assert "no manifest" in validate_datastore_dir(d)[1][0]
    assert MemmapDataStore(src, directory=str(d), shard_rows=4).rebuilt


def test_a_jax_written_shard_set_is_reused(tmp_path):
    from blades_tpu.data.store import MemmapDataStore as JaxMemmap

    src = _source()
    JaxMemmap(src, directory=str(tmp_path / "d"), shard_rows=4)
    ours = MemmapDataStore(src, directory=str(tmp_path / "d"), shard_rows=4)
    assert not ours.rebuilt
    for a, s in zip(ours.take(np.arange(10)), src):
        np.testing.assert_array_equal(a, s)


def _eval_round(n=9, cap=6):
    rng = np.random.default_rng(1)
    task = TaskSpec(model="mlp", input_shape=(28, 28, 1)).build()
    fr = FedRound(task=task, server=Server.from_config("Mean"))
    state = fr.init(0, n, device="cpu")
    tx = rng.normal(size=(n, cap, 28, 28, 1)).astype(np.float32)
    ty = rng.integers(0, 10, size=(n, cap)).astype(np.int32)
    tln = rng.integers(1, cap + 1, size=(n,)).astype(np.int32)
    return fr, state, (tx, ty, tln)


def test_streaming_eval_matches_the_monolithic_eval():
    fr, state, (tx, ty, tln) = _eval_round()
    mono = fr.evaluate(state, torch.from_numpy(tx),
                       torch.from_numpy(ty).long(),
                       torch.from_numpy(tln).long())
    fn = make_chunk_evaluator(fr.task)
    got, chunks = streaming_evaluate(fn, state.server.params, (tx, ty, tln),
                                     chunk_clients=4)
    again, _ = streaming_evaluate(fn, state.server.params, (tx, ty, tln),
                                  chunk_clients=4)
    assert chunks == 3 and got == again
    for k in ("test_loss", "test_acc", "test_acc_top3", "num_samples"):
        assert got[k] == pytest.approx(float(mono[k]), rel=1e-5)
    one, n1 = streaming_evaluate(fn, state.server.params, (tx, ty, tln),
                                 chunk_clients=99)
    assert n1 == 1 and one["num_samples"] == got["num_samples"]


def test_streaming_walk_matches_the_jax_walk():
    from blades_tpu.data.stream import streaming_evaluate as jax_walk

    def jfn(params, cx, cy, lengths):
        m = jnp.asarray(lengths, jnp.float32)
        return {"ce_sum": 2.0 * m.sum(), "top1_sum": m.sum(),
                "top3_sum": 0.5 * m.sum(), "count": m.sum()}

    def fn(params, cx, cy, lengths):
        m = lengths.float()
        return {"ce_sum": 2.0 * m.sum(), "top1_sum": m.sum(),
                "top3_sum": 0.5 * m.sum(), "count": m.sum()}

    arrays = (np.zeros((8, 2, 3), np.float32), np.zeros((8, 2), np.int32),
              np.arange(1, 9, dtype=np.int32))
    for chunk in (3, 8, 99):
        assert streaming_evaluate(fn, None, arrays, chunk) == jax_walk(
            jfn, None, arrays, chunk)


def test_windowed_rounds_are_bit_identical_on_either_data_store(tmp_path):
    out = {}
    for backend in ("resident", "memmap"):
        run = {**WINDOWED, "data_store": backend, "eval_chunk_clients": 3}
        if backend == "memmap":
            run["data_dir"] = str(tmp_path / "shards")
        algo = FedavgConfig().update_from_dict(run).build(device="cpu")
        rows = [algo.train() for _ in range(2)]
        out[backend] = (rows, {k: v.clone() for k, v in
                               algo.state.server.params.items()})
        assert algo.data_summary["backend"] == backend
        algo.stop()
    (r0, p0), (r1, p1) = out["resident"], out["memmap"]
    assert [r["train_loss"] for r in r0] == [r["train_loss"] for r in r1]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert r1[1]["eval_chunks"] == 3 and "eval_chunks" not in r0[1]
    assert r1[1]["data_store"] == "memmap" and r1[1]["data_bytes_staged"] > 0
    assert r1[1]["test_acc"] == pytest.approx(r0[1]["test_acc"], rel=1e-5)
    assert validate_datastore_dir(tmp_path / "shards")[1] == []
