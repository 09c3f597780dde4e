"""The port's offline tools (blades_tpu_torch/tools/) against the JAX
package's (tools/).

Three trials run through the port's ``file`` command, each preempted
after round 3 so the flight recorder dumps its ring: a dense forensic MLP
trial with the ledger, an async MLP trial with forensics, the ledger and
the control plane, and a gossip trial under edge dropout.  The port's
``replay_round`` re-runs each dump's round through the port's driver on
the CPU and finds every digest field equal bit for bit; a doctored dump
fails.  On every artifact of those runs (and on doctored streams) the
port's ``validate_metrics``, ``ledger_report`` and ``control_report``
print what the JAX tools print and exit with their codes.
"""

import json
import math
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blades_tpu_torch import train
from blades_tpu_torch.tools import control_report, ledger_report
from blades_tpu_torch.tools import replay_round, validate_metrics

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools import control_report as jax_control_report  # noqa: E402
from tools import ledger_report as jax_ledger_report  # noqa: E402
from tools import replay_round as jax_replay_round  # noqa: E402
from tools import validate_metrics as jax_validate_metrics  # noqa: E402

MLP = {"dataset_config": {"type": "mnist", "num_clients": 12, "train_bs": 8},
       "global_model": "mlp", "evaluation_interval": 2,
       "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
       "server_config": {"lr": 1.0, "aggregator": {"type": "Trimmedmean"}}}
GRID = {
    "dense": {**MLP, "forensics": True, "ledger": True},
    "async": {**MLP, "execution": "async",
              "async_config": {"rate": 0.5, "agg_every": 6,
                               "buffer_capacity": 12},
              "forensics": True, "ledger": True,
              "control_config": {"cooldown_rounds": 1,
                                 "quarantine_rounds": 2,
                                 "rules": {"fpr_collapse": "quarantine"}}},
    "gossip": {**MLP, "execution": "gossip",
               "topology_config": {"graph": "kregular", "k": 4},
               "adversary_config": {"type": "TopologyAttack",
                                    "base": "ALIE"},
               "server_config": {"lr": 1.0, "aggregator": {"type":
                                                           "Median"}},
               "fault_config": {"dropout_rate": 0.4, "seed": 11}},
}
KINDS = tuple(GRID)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small torch ops: with
    several test workers on a few cores, the thread pools contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each trial of :data:`GRID` through the port's ``file`` command,
    preempted after round 3, with a checkpoint each round, spans and the
    flight recorder: ``{kind: trial directory}``."""
    root = tmp_path_factory.mktemp("tools")
    out = {}
    for kind, config in GRID.items():
        grid = {kind: {"run": "FEDAVG", "stop": {"training_iteration": 4},
                       "config": config}}
        path = root / f"{kind}.yaml"
        path.write_text(json.dumps(grid))
        assert train.main(["file", str(path), "--device", "cpu",
                           "--storage-path", str(root / "s"),
                           "--preempt-after", "3", "--checkpoint-freq", "1",
                           "--flightrec-rounds", "4", "--trace-dir",
                           str(root / "spans")]) == 0
        out[kind] = root / "s" / kind / f"{kind}_00000"
    out["spans"] = root / "spans"
    return out


def _dump(runs, kind):
    return json.loads((runs[kind] / "flightrec.json").read_text())


@pytest.mark.parametrize("kind", KINDS)
def test_replay_reproduces_a_port_dump_bit_for_bit(runs, kind, capsys):
    dump = _dump(runs, kind)
    assert dump["trigger"]["kind"] == "preemption"
    assert replay_round.main([str(runs[kind] / "flightrec.json"),
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "replay of round 3 is bit-identical" in out
    if kind == "gossip":
        for field in ("num_partitioned_nodes", "consensus_dist",
                      "gossip_ici_bytes", "spectral_gap"):
            assert f"  {field}: " in out and "MISMATCH" not in out
    if kind == "async":
        assert "  tick: " in out


def _next_float(x):
    bits = struct.unpack("<q", struct.pack("<d", x))[0]
    return struct.unpack("<d", struct.pack("<q", bits + 1))[0]


@pytest.mark.parametrize("kind", KINDS)
def test_replay_fails_on_a_doctored_dump(runs, kind, tmp_path, capsys):
    """One ulp (of a double) on the recorded ``agg_norm`` of the trigger
    round is a mismatch; a tick outside the ring is an unusable dump."""
    dump = _dump(runs, kind)
    row = next(r for r in dump["rounds"]
               if r["training_iteration"] == dump["trigger"]["round"])
    row["agg_norm"] = _next_float(row["agg_norm"])
    path = tmp_path / "doctored.json"
    path.write_text(json.dumps(dump))
    assert replay_round.main([str(path), "--device", "cpu", "--quiet"]) == 1
    assert "DIVERGED on 1 field(s)" in capsys.readouterr().err
    assert replay_round.main([str(runs[kind] / "flightrec.json"),
                              "--device", "cpu", "--tick", "99"]) == 1
    assert "is not in the dump's recorded window" in capsys.readouterr().err


def test_replay_bit_equality_treats_nan_as_equal():
    assert replay_round.bit_equal(float("nan"), float("nan"))
    assert not replay_round.bit_equal(0.0, -0.0)
    assert replay_round.bit_equal(1.5, 1.5)
    assert not replay_round.bit_equal(1.0, _next_float(1.0))


def _both(port_main, jax_main, argv, capsys):
    """Each tool's exit code and standard output on the same argv."""
    rc = port_main(list(argv))
    ours = capsys.readouterr().out
    jrc = jax_main(list(argv))
    theirs = capsys.readouterr().out
    return (rc, ours), (jrc, theirs)


def test_replay_action_rederives_the_journal_as_the_jax_tool(runs, capsys):
    path = str(runs["async"] / "flightrec.json")
    ours, theirs = _both(replay_round.main, jax_replay_round.main,
                         [path, "--action"], capsys)
    assert ours == theirs and ours[0] == 0
    assert "control action(s) re-derived bit-identically" in ours[1] or \
        "no control actions recorded" in ours[1]
    # An uncontrolled run has nothing to re-derive: exit 1 in both.
    assert replay_round.main([str(runs["dense"] / "flightrec.json"),
                              "--action"]) == 1
    capsys.readouterr()


def _artifacts(runs):
    out = []
    for kind in KINDS:
        out.append(([], runs[kind] / "metrics.jsonl"))
        out.append((["--flightrec"], runs[kind] / "flightrec.json"))
        out.append((["--ledger"], runs[kind] / "ckpt_000002" / "ledger"))
    out += [(["--trace"], p) for p in sorted(runs["spans"].glob("*.json"))]
    return out


def test_validate_metrics_prints_the_jax_verdicts_on_every_artifact(
        runs, capsys):
    cases = [c for c in _artifacts(runs) if c[1].exists()]
    assert len(cases) >= 3 * 2 + 2 + 3  # streams, dumps, ledgers, spans
    for flags, path in cases:
        ours, theirs = _both(validate_metrics.main, jax_validate_metrics.main,
                             [*flags, str(path)], capsys)
        assert ours == theirs, (flags, path)
        assert ours[0] == 0, ours[1]


def _doctor(src, dst, edit):
    rows = [json.loads(line) for line in src.read_text().splitlines()]
    rows = edit(rows)
    dst.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return dst


def _drop_key(key):
    def edit(rows):
        del rows[1][key]
        return rows
    return edit


def _set(key, value, i=1):
    def edit(rows):
        rows[i][key] = value
        return rows
    return edit


DOCTORED = {
    "gossip-partial-stamp": ("gossip", _drop_key("topology")),
    "gossip-bad-gap": ("gossip", _set("spectral_gap", 1.5)),
    "gossip-unknown-graph": ("gossip", _set("topology", "smallworld")),
    "gossip-negative-count": ("gossip", _set("num_partitioned_nodes", -1)),
    "async-tick-backwards": ("async", _set("tick", -1, i=2)),
    "mesh-partial-stamp": ("dense", _set("ici_bytes", 5)),
}


@pytest.mark.parametrize("case", sorted(DOCTORED))
def test_validate_metrics_flags_doctored_streams_as_the_jax_tool(
        runs, case, tmp_path, capsys):
    kind, edit = DOCTORED[case]
    path = _doctor(runs[kind] / "metrics.jsonl", tmp_path / "m.jsonl", edit)
    ours, theirs = _both(validate_metrics.main, jax_validate_metrics.main,
                         [str(path)], capsys)
    assert ours == theirs
    assert ours[0] == 1 and "error(s)" in ours[1]


def test_validate_metrics_reads_a_data_store_as_the_jax_tool(tmp_path,
                                                             capsys):
    from blades_tpu_torch.data.store import make_data_store

    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(6, 4, 2)).astype(np.float32),
              rng.integers(0, 3, size=(6, 4)).astype(np.int32),
              np.full((6,), 4, np.int32))
    store = make_data_store("memmap", arrays, directory=str(tmp_path / "ds"),
                            shard_rows=4)
    store.close()
    ours, theirs = _both(validate_metrics.main, jax_validate_metrics.main,
                         ["--datastore", str(tmp_path / "ds")], capsys)
    assert ours == theirs and ours[0] == 0
    missing = ["--flightrec", str(tmp_path / "nope.json")]
    ours, theirs = _both(validate_metrics.main, jax_validate_metrics.main,
                         missing, capsys)
    assert ours == theirs and ours[0] == 1


@pytest.mark.parametrize("kind", ["dense", "async"])
@pytest.mark.parametrize("view", ["fleet", "top3", "client", "json",
                                  "client-json"])
def test_ledger_report_prints_the_jax_report(runs, kind, view, capsys):
    ledger = str(runs[kind] / "ckpt_000002" / "ledger")
    metrics = str(runs[kind] / "metrics.jsonl")
    argv = {"fleet": [ledger], "top3": [ledger, "--top", "3"],
            "client": [ledger, "--client", "0", "--metrics", metrics],
            "json": [ledger, "--json"],
            "client-json": [ledger, "--client", "1", "--metrics", metrics,
                            "--json"]}[view]
    ours, theirs = _both(ledger_report.main, jax_ledger_report.main, argv,
                         capsys)
    assert ours == theirs and ours[0] == 0
    assert ours[1]


def test_ledger_report_refuses_a_broken_ledger_as_the_jax_tool(
        runs, tmp_path, capsys):
    import shutil

    broken = tmp_path / "ledger"
    shutil.copytree(runs["dense"] / "ckpt_000002" / "ledger", broken)
    (broken / "manifest.json").write_text("{")
    rc = ledger_report.main([str(broken)])
    jrc = jax_ledger_report.main([str(broken)])
    assert rc == jrc == 1
    capsys.readouterr()


@pytest.mark.parametrize("source", ["metrics.jsonl", "flightrec.json"])
@pytest.mark.parametrize("view", ["timeline", "client", "json"])
def test_control_report_prints_the_jax_report(runs, source, view, capsys):
    path = str(runs["async"] / source)
    argv = {"timeline": [path], "json": [path, "--json"],
            "client": [path, "--client", "1"]}[view]
    ours, theirs = _both(control_report.main, jax_control_report.main, argv,
                         capsys)
    assert ours == theirs and ours[0] == 0


def test_control_report_refuses_an_uncontrolled_run_as_the_jax_tool(
        runs, capsys):
    path = str(runs["gossip"] / "metrics.jsonl")
    assert control_report.main([path]) == jax_control_report.main([path]) == 1
    capsys.readouterr()
