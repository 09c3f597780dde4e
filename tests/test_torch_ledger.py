"""The client ledger (blades_tpu_torch/obs/ledger.py) against the JAX
package's (blades_tpu/obs/ledger.py): the same cohort observations give
identical fleet fields, client records and digests on both backends, and
a shard checkpoint one package writes, the other reads and validates
(the same manifest, shard files and CRC32s).  Everything is host numpy:
equality is exact."""

import json

import numpy as np
import pytest

from blades_tpu.obs import ledger as JL
from blades_tpu_torch.obs import ledger as TL

N = 37


def _stream(seed=0, rounds=9, window=11):
    """Cohorts (distinct ids), flags, scores, staleness and norms of a
    run, from a seed."""
    rng = np.random.default_rng(seed)
    for r in range(1, rounds + 1):
        ids = rng.choice(N, size=window, replace=False)
        yield dict(ids=ids, round=r, tick=3 * r + 1,
                   flagged=rng.random(window) < 0.3 + 0.05 * (ids % 3),
                   scores=rng.normal(size=window),
                   staleness=rng.integers(0, 5, size=window),
                   norms=rng.gamma(2.0, size=window))


def _feed(ledger, seed=0, partial=False):
    out = []
    for obs in _stream(seed):
        kw = dict(obs)
        ids = kw.pop("ids")
        if partial:  # a ledger without forensics: participation only
            kw = dict(round=kw["round"], tick=kw["tick"])
        ledger.observe(ids, **kw)
        out.append(ledger.round_fields())
    return out


@pytest.mark.parametrize("partial", [False, True], ids=["full", "no-diag"])
@pytest.mark.parametrize("backend", ["resident", "disk"])
def test_same_observations_same_fields_and_digest(backend, partial, tmp_path):
    jl = JL.make_ledger(backend, N, directory=None)
    tl = TL.make_ledger(backend, N, directory=None)
    assert _feed(tl, partial=partial) == _feed(jl, partial=partial)
    assert tl.digest() == jl.digest()
    assert tl.summary() == jl.summary()
    assert tl.top_suspects(4) == jl.top_suspects(4)
    for c in (0, 5, N - 1):
        assert tl.client_record(c) == jl.client_record(c)
    assert tl.host_bytes() == jl.host_bytes()
    jl.close()
    tl.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_read(writer, tmp_path):
    """A checkpoint of either package passes the other's
    ``validate_ledger_checkpoint`` and restores through its
    ``read_ledger`` to the same digest."""
    w, r = (TL, JL) if writer == "port" else (JL, TL)
    src = w.make_ledger("disk", N, directory=str(tmp_path / "live"))
    _feed(src, seed=3)
    src.save(tmp_path / "ckpt", shard_rows=16)
    num_ok, errors = r.validate_ledger_checkpoint(tmp_path / "ckpt")
    assert errors == [] and num_ok == 3 * len(JL.LEDGER_COLUMNS)
    assert w.validate_ledger_checkpoint(tmp_path / "ckpt") == (num_ok, [])
    back = r.read_ledger(tmp_path / "ckpt")
    assert back.digest()["crc32"] == src.digest()["crc32"]
    # flagged_churn is the last observe()'s, re-derived by the next one.
    want = dict(src.round_fields(), flagged_churn=0)
    assert back.round_fields() == want
    restored = r.make_ledger("resident", N)
    restored.load(tmp_path / "ckpt")
    assert restored.digest() == back.digest()
    src.close()


def test_same_file_layout_and_manifest(tmp_path):
    jl, tl = JL.ResidentLedger(N), TL.ResidentLedger(N)
    _feed(jl, seed=1)
    _feed(tl, seed=1)
    jl.save(tmp_path / "j", shard_rows=8)
    tl.save(tmp_path / "t", shard_rows=8)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in names:
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "t" / name).read_bytes()), name
    assert (json.loads((tmp_path / "j" / "manifest.json").read_text())
            == json.loads((tmp_path / "t" / "manifest.json").read_text()))


def test_torn_and_corrupt_shards_are_reported_and_refused(tmp_path):
    led = TL.ResidentLedger(N)
    _feed(led)
    led.save(tmp_path / "c", shard_rows=16)
    shard = tmp_path / "c" / "shard-00001.l03.npy"
    data = bytearray(shard.read_bytes())
    data[-1] ^= 0xFF
    shard.write_bytes(bytes(data))
    for validate in (TL.validate_ledger_checkpoint,
                     JL.validate_ledger_checkpoint):
        num_ok, errors = validate(tmp_path / "c")
        assert len(errors) == 1 and "CRC32" in errors[0]
    with pytest.raises(TL.LedgerError, match="CRC32"):
        TL.ResidentLedger(N).load(tmp_path / "c")
    shard.write_bytes(bytes(data[:-4]))
    assert "torn" in TL.validate_ledger_checkpoint(tmp_path / "c")[1][0]
    (tmp_path / "c" / "manifest.json").unlink()
    assert TL.validate_ledger_checkpoint(tmp_path / "c")[0] == 0
    with pytest.raises(TL.LedgerError, match="manifest"):
        TL.read_ledger(tmp_path / "c")


def test_observe_refuses_bad_cohorts():
    led = TL.ResidentLedger(5)
    with pytest.raises(TL.LedgerError, match="duplicates"):
        led.observe([1, 1], round=1)
    with pytest.raises(TL.LedgerError, match="out of range"):
        led.observe([5], round=1)
    with pytest.raises(ValueError, match="backend"):
        TL.make_ledger("ram", 5)
