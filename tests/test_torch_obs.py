"""The port's metrics pipeline, spans, watchdog and flight recorder
(blades_tpu_torch/obs) against the JAX package's (blades_tpu/obs).

Format parity: each package's ``validate_record`` / ``validate_jsonl``,
``validate_chrome_trace`` and ``validate_flightrec`` accept the files the
other writes (from real trials of both on the same grid).  The port's
rows carry no key the JAX schema lacks: ``PORT_ONLY_KEYS`` names them,
and is empty.  The same row streams give identical watchdog events.
Everything compared here is host data: equality is exact.
"""

import csv
import json
import math

import numpy as np
import pytest
import torch

from blades_tpu.obs import flightrec as JF
from blades_tpu.obs import metrics as JM
from blades_tpu.obs import schema as JS
from blades_tpu.obs import trace as JT
from blades_tpu.obs import watchdog as JW
from blades_tpu_torch import train
from blades_tpu_torch.obs import flightrec as TF
from blades_tpu_torch.obs import metrics as TM
from blades_tpu_torch.obs import schema as TS
from blades_tpu_torch.obs import trace as TT
from blades_tpu_torch.obs import watchdog as TW

#: Row keys the port stamps that the JAX package's schema does not know.
PORT_ONLY_KEYS = set()

GRID = {"obs_grid": {
    "run": "FEDAVG", "stop": {"training_iteration": 3},
    "config": {
        "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 8},
        "global_model": "mlp", "evaluation_interval": 3,
        "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
        "forensics": True, "ledger": True,
        "server_config": {"lr": 1.0, "aggregator": {"grid_search": [
            {"type": "Trimmedmean"}, {"type": "Multikrum"}]}}}}}
FLAGS = ["--watchdog", "--metrics-csv", "--flightrec-rounds", "4"]


def _write(tmp_path, grid):
    path = tmp_path / "grid.json"
    path.write_text(json.dumps(grid))
    return path


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    """The forensics grid run by both packages' CLIs, with spans, the
    watchdog, the CSV sink and the flight recorder armed."""
    from blades_tpu import train as jax_train

    root = tmp_path_factory.mktemp("obs")
    grid = _write(root, GRID)
    ours, theirs = root / "port", root / "jax"
    assert train.main(["file", str(grid), "--device", "cpu",
                       "--storage-path", str(ours), "--trace-dir",
                       str(ours / "spans"), *FLAGS]) == 0
    assert jax_train.main(["file", str(grid), "--storage-path", str(theirs),
                           "--trace-dir", str(theirs / "spans"),
                           "--no-cost-analysis", "--no-lanes", *FLAGS]) == 0
    return ours, theirs


def _trial_dirs(root):
    return sorted((root / "obs_grid").iterdir())


def test_schema_is_the_jax_schema():
    assert TS.ROUND_RECORD_FIELDS == JS.ROUND_RECORD_FIELDS
    assert TS._LANE_FIELDS == JS._LANE_FIELDS
    assert TM._CSV_COLUMNS == JM._CSV_COLUMNS


def test_each_validator_accepts_the_other_packages_rows(trials):
    ours, theirs = trials
    for root in (ours, theirs):
        for tdir in _trial_dirs(root):
            for validate in (TS.validate_jsonl, JS.validate_jsonl):
                assert validate(tdir / "metrics.jsonl") == (3, [])
    for tdir in _trial_dirs(ours):
        rows = [json.loads(x) for x in
                (tdir / "metrics.jsonl").read_text().splitlines()]
        keys = set().union(*rows)
        assert keys - set(JS.ROUND_RECORD_FIELDS) == PORT_ONLY_KEYS
        lanes = rows[-1]["lane_forensics"]
        assert lanes["clients"] == list(range(6))
        assert {"byz_recall", "ledger_top_suspects", "num_unhealthy"} <= keys


def test_rows_carry_the_jax_rows_keys(trials):
    """Both packages stamp the same keys on the same grid (the values
    differ: the port draws its own batches)."""
    ours, theirs = trials
    for t, j in zip(_trial_dirs(ours), _trial_dirs(theirs)):
        rows = [json.loads(x) for x in
                (t / "metrics.jsonl").read_text().splitlines()]
        jrows = [json.loads(x) for x in
                 (j / "metrics.jsonl").read_text().splitlines()]
        drop = {"compile_cache_hits", "compile_cache_misses"}
        for r, jr in zip(rows, jrows):
            assert set(r) == set(jr) - drop
            assert set(r["lane_forensics"]) == set(jr["lane_forensics"])
        header = next(csv.reader(open(t / "metrics.csv")))
        assert header == next(csv.reader(open(j / "metrics.csv")))


def test_each_validator_accepts_the_other_packages_spans(trials):
    for root in trials:
        traces = sorted((root / "spans").glob("*.trace.json"))
        assert len(traces) == 2
        for path in traces:
            n_port, e_port = TT.validate_chrome_trace(path)
            n_jax, e_jax = JT.validate_chrome_trace(path)
            assert e_port == e_jax == [] and n_port == n_jax > 3
    names = {ev["name"] for ev in json.loads(sorted(
        (trials[0] / "spans").glob("*.json"))[0].read_text())["traceEvents"]}
    assert {"trial", "compile", "round", "training_step"} <= names


def test_nan_aggregate_dumps_a_flightrec_both_validators_read(tmp_path):
    """The fault injector's NaN corruption with the health check off: the
    watchdog fires nan_aggregate and the recorder dumps."""
    grid = {"nan": {**GRID["obs_grid"], "config": {
        **GRID["obs_grid"]["config"],
        "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}},
        "fault_config": {"corrupt_rate": 1.0, "corrupt_mode": "nan"}}}}
    assert train.main(["file", str(_write(tmp_path, grid)), "--device",
                       "cpu", "--storage-path", str(tmp_path / "o"),
                       "--watchdog", "--flightrec-rounds", "2"]) == 0
    tdir = tmp_path / "o" / "nan" / "nan_00000"
    rows = [json.loads(x) for x in
            (tdir / "result.json").read_text().splitlines()]
    assert math.isnan(rows[0]["agg_norm"])
    assert "nan_aggregate" in {e["rule"] for e in rows[0]["watchdog_events"]}
    # The first non-finite round dumps (one per trigger kind): its ring
    # holds that round.
    for validate in (TF.validate_flightrec, JF.validate_flightrec):
        assert validate(tdir / "flightrec.json") == (1, [])
    dump = json.loads((tdir / "flightrec.json").read_text())
    assert dump["trigger"]["kind"] == "nonfinite"
    assert dump["ledger"]["n_registered"] == 6


def test_port_validators_read_jax_dumps(tmp_path):
    for mod, other in ((JF, TF), (TF, JF)):
        rec = mod.FlightRecorder(tmp_path / "d.json", capacity=3,
                                 config={"seed": 4})
        for r in range(1, 6):
            rec.record({"training_iteration": r, "agg_norm": float(r),
                        "timers": {}})
        rec.dump({"kind": "exception", "round": 5})
        assert other.validate_flightrec(tmp_path / "d.json") == (3, [])
    (tmp_path / "torn.json").write_text('{"version": 1, "rou')
    assert TF.validate_flightrec(tmp_path / "torn.json")[0] == 0


def _stream(seed):
    rng = np.random.default_rng(seed)
    for r in range(1, 60):
        yield {
            "training_iteration": r,
            "agg_norm": float("nan") if r in (17, 40) else float(
                rng.gamma(2.0)),
            "train_loss": float("inf") if r == 33 else float(rng.normal()),
            "update_norm_mean": float(rng.gamma(2.0)
                                      * (40.0 if r % 12 == 0 else 1.0)),
            "byz_fpr": float(rng.random()),
            "staleness_max": int(rng.integers(0, 80)),
            "updates_per_sec": float(rng.gamma(5.0)
                                     / (30.0 if r % 14 == 0 else 1.0)),
            "cycle_ticks": int(rng.integers(2, 5) * (8 if r % 9 == 0
                                                     else 1)),
            "reputation_p50": float(1.0 / (1 + (r % 8 == 0) * 4)),
            "flagged_churn": int(rng.integers(1, 3) * (7 if r % 10 == 0
                                                       else 1)),
            "timers": {"training_step": {"total_s": 0.2 * r + (
                5.0 if r > 45 else 0.0)}},
        }


RULES = [None, [{"name": "acc", "kind": "collapse", "field": "test_acc"},
                {"name": "loss", "kind": "spike", "field": "train_loss",
                 "window": 3, "min_points": 2, "factor": 2.0}]]


@pytest.mark.parametrize("ri", range(len(RULES)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_rows_same_watchdog_events(seed, ri):
    rows = list(_stream(seed))
    jw = JW.Watchdog(JW.rules_from_config(RULES[ri]))
    tw = TW.Watchdog(TW.rules_from_config(RULES[ri]))
    got = [[e.as_dict() for e in tw.observe(r)] for r in rows]
    want = [[e.as_dict() for e in jw.observe(r)] for r in rows]
    assert got == want
    assert sum(map(len, got)) > (5 if ri == 0 else 0)
    assert tw.state() == jw.state()
    # Warming from the written rows rebuilds the same windows.
    stamped = [dict(r, watchdog_events=e) for r, e in zip(rows, got)]
    tw2, jw2 = TW.Watchdog(tw.rules), JW.Watchdog(jw.rules)
    tw2.warm(stamped[:30])
    jw2.warm(stamped[:30])
    assert tw2.state() == jw2.state()
    assert [e.as_dict() for e in tw2.events] == [
        e.as_dict() for e in jw2.events]


@pytest.mark.parametrize("specs", [
    [{"name": "a", "kind": "spike", "field": "no_such_field"}],
    [{"name": "a", "kind": "wobble", "field": "agg_norm"}],
    [{"name": "a", "kind": "spike"}],
    [{"name": "a", "kind": "spike", "field": "agg_norm", "colour": 1}],
    [{"name": "a", "kind": "spike", "field": "agg_norm"}] * 2,
])
def test_bad_rules_fail_like_jax(specs, tmp_path):
    with pytest.raises(ValueError) as jexc:
        JW.rules_from_config(specs)
    with pytest.raises(ValueError) as texc:
        TW.rules_from_config(specs)
    assert str(texc.value) == str(jexc.value)
    with pytest.raises(SystemExit):
        train.main(["file", str(_write(tmp_path, GRID)), "--device", "cpu",
                    "--watchdog-rules", json.dumps(specs)])


def test_sinks_write_what_the_jax_sinks_write(tmp_path):
    rows = [{"experiment": "e", "trial": "t", "training_iteration": i,
             "train_loss": 0.5 / i, "byz_recall": 1.0, "timers": {},
             "lane_forensics": {"benign_mask": [True], "scores": [0.1]},
             "watchdog_events": []} for i in range(1, 4)]
    for name, mod in (("j", JM), ("t", TM)):
        with mod.MetricsLogger([mod.JsonlSink(tmp_path / f"{name}.jsonl"),
                                mod.CsvSink(tmp_path / f"{name}.csv")]) as lg:
            for r in rows:
                lg.log(r)
    for ext in ("jsonl", "csv"):
        assert ((tmp_path / f"t.{ext}").read_text()
                == (tmp_path / f"j.{ext}").read_text())
    with pytest.raises(TS.SchemaError, match="unknown keys"):
        TM.JsonlSink(tmp_path / "x.jsonl").emit({**rows[0], "bogus": 1})
    assert TS.main([str(tmp_path / "t.jsonl")]) == 0


def test_tracer_records_a_tree_only_when_armed(tmp_path):
    clock = iter(range(100)).__next__
    armed = TT.Tracer(record=True, clock=lambda: float(clock()))
    with armed.span("trial"):
        with armed.span("round", step=0):
            with armed.time("training_step"):
                pass
    armed.export(tmp_path / "t.json")
    assert TT.validate_chrome_trace(tmp_path / "t.json") == (3, [])
    assert JT.validate_chrome_trace(tmp_path / "t.json") == (3, [])
    plain = TT.Timers()
    with plain.time("training_step"):
        pass
    assert plain.to_chrome_trace()["traceEvents"][2:] == []
    assert set(plain.summary()["training_step"]) == {"mean_s", "total_s",
                                                     "count"}
    (tmp_path / "bad.json").write_text("{")
    assert TT.validate_chrome_trace(tmp_path / "bad.json")[0] == 0


def test_trace_flag_writes_a_profiler_trace(tmp_path):
    grid = {"obs_grid": {**GRID["obs_grid"],
                         "stop": {"training_iteration": 1}}}
    assert train.main(["file", str(_write(tmp_path, grid)), "--device",
                       "cpu", "--storage-path", str(tmp_path / "o"),
                       "--max-rounds", "1", "--trace",
                       str(tmp_path / "prof")]) == 0
    doc = json.loads((tmp_path / "prof" / "profile.trace.json").read_text())
    assert doc["traceEvents"]


def test_forensics_and_spans_leave_the_parameters_unchanged():
    """A forensics trial under an armed tracer ends on the parameters of
    a plain one, bit for bit."""
    from blades_tpu_torch.algorithms.config import FedavgConfig

    cfg = dict(GRID["obs_grid"]["config"],
               server_config={"lr": 1.0, "aggregator": {
                   "type": "Trimmedmean"}})
    plain = FedavgConfig().update_from_dict(
        {**cfg, "forensics": False, "ledger": False}).build(device="cpu")
    armed = FedavgConfig().update_from_dict(cfg).build(device="cpu")
    armed.timers = TT.Timers(record=True)
    for _ in range(3):
        plain.train()
        armed.train()
    for k, v in plain.state.server.params.items():
        assert torch.equal(v, armed.state.server.params[k]), k
