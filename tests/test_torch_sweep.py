"""The port's ``file`` entry point (blades_tpu_torch/tune/,
blades_tpu_torch/faults/host.py, blades_tpu_torch/train.py) against the
JAX package's.

- The YAML reader gives what ``yaml.safe_load`` gives, on every tuned
  example and on PyYAML's YAML 1.1 resolver edge cases, and refuses what
  it does not take by name.
- Each tuned example expands to JAX's trials, in JAX's order; every grid
  point of all thirteen (CCT's and the 8-device mesh example's among them)
  resolves through the port's config and round (on the meta device); the
  mesh example resolves to three width-sharded trials with JAX's elision
  layout, and one process refuses it by ``make_mesh``'s world-size words
  before any trial writes a file.
- A two-point MLP grid through ``train.main(["file", ...])`` on the CPU
  writes the JAX command's layout and trial names, rows whose keys are
  JAX's, and reaches test accuracy > 0.9 on both sides.
- Kill and resume: a run preempted after round 2 and retried from its
  checkpoint writes the straight run's ``result.json`` (bit for bit,
  apart from the wall-clock ``timers`` field of each row); ``--resume``
  skips a finished trial, restores an in-flight one and deletes an
  orphaned ``ckpt_*.tmp``; ``--checkpoint-keep-num`` keeps the best;
  ``--metrics-every 3`` writes the rows of ``--metrics-every 1``.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from blades_tpu import train as jax_train
from blades_tpu.tune.sweep import expand_grid as jax_expand_grid
from blades_tpu.tune.sweep import load_experiments_from_file as jax_load
from blades_tpu_torch import train
from blades_tpu_torch.tune import (
    expand_grid,
    load_experiments_from_file,
    run_experiments,
    verify_result_rounds,
)
from blades_tpu_torch.tune import yaml_subset
from blades_tpu_torch.tune.sweep import (
    _latest_checkpoint,
    _prune_checkpoints,
    resolve_trial,
)

REPO = Path(__file__).resolve().parents[1]
TUNED = sorted((REPO / "blades_tpu" / "tuned_examples").glob("*.yaml"))
MESH_EXAMPLE = REPO / "blades_tpu" / "tuned_examples" / (
    "fedavg_cifar10_1000clients_mesh.yaml")

EDGE_CASES = """\
# PyYAML's YAML 1.1 resolver on plain scalars
exponent_without_dot: 1e-6
exponent_with_dot: 1.0e-6
unsigned_exponent: 1.0e6
leading_dot: .5
trailing_dot: 6.
negative_inf: -.inf
bools: [True, false, yes, No, on, OFF]
nulls: [null, ~, Null]
empty:
ints: [0x1F, 017, 0b101, 1_000, 1:30, -7]
quoted: ['1.0', "True", 'it''s', "tab\\there"]
flow_lists_of_lists: [[0, 0.1], [1500, [0.1, 0.01]]]
flow_map: {type: IPM, scale: 100.0, note: a#b}  # a trailing comment
block:
  - type: Mean
    weight: 2
  - {type: Median}
  - - 1
    - 2
  -
    nested: true
"""


def test_no_port_module_imports_yaml():
    """The card's machine has no PyYAML: the port reads experiment files
    with its own reader, always."""
    files = sorted((REPO / "blades_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [(f.name, m) for m in names if m.split(".")[0] == "yaml"]
    assert not bad, bad


@pytest.mark.parametrize("path", TUNED, ids=lambda p: p.stem)
def test_reader_matches_safe_load_on_the_tuned_examples(path):
    text = path.read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)


def test_reader_matches_safe_load_on_the_resolver_edge_cases():
    got = yaml_subset.load(EDGE_CASES)
    assert got == yaml.safe_load(EDGE_CASES)
    assert got["exponent_without_dot"] == "1e-6"
    assert got["exponent_with_dot"] == 1e-6
    assert got["unsigned_exponent"] == "1.0e6"
    assert got["flow_lists_of_lists"] == [[0, 0.1], [1500, [0.1, 0.01]]]


@pytest.mark.parametrize("text,construct", [
    ("a: &x 1\nb: *x\n", "anchors"),
    ("a: *x\n", "aliases"),
    ("a: !!float 1\n", "tags"),
    ("a: |\n  text\n", "block scalars"),
    ("a: >\n  text\n", "block scalars"),
    ("---\na: 1\n---\nb: 2\n", "several documents"),
    ("%YAML 1.1\na: 1\n", "directives"),
    ("a: {b: 1,\n  c: 2}\n", "multi-line flow"),
    ("a: one\n  two\n", "multi-line plain"),
    ("a: 2001-12-14\n", "timestamps"),
])
def test_reader_refuses_constructs_by_name(text, construct):
    with pytest.raises(yaml_subset.YamlSubsetError, match=construct):
        yaml_subset.load(text)


@pytest.mark.parametrize("path", TUNED, ids=lambda p: p.stem)
def test_grids_expand_to_the_jax_trials(path):
    ours, theirs = load_experiments_from_file(path), jax_load(str(path))
    assert ours == theirs  # the defaults of stop and config included
    for name, spec in ours.items():
        trials = expand_grid(spec["config"])
        assert trials == jax_expand_grid(theirs[name]["config"])
        assert len(trials) >= 1


@pytest.mark.parametrize("path", TUNED, ids=lambda p: p.stem)
def test_every_grid_point_resolves_in_the_port(path):
    """Config and round on the meta device for each point: no dataset, no
    training (fedavg_cifar10_resnet_noniid has 1,260 points)."""
    for spec in load_experiments_from_file(path).values():
        for trial in expand_grid(spec["config"]):
            resolve_trial(spec["run"], trial)


def test_mesh_example_resolves_to_three_dsharded_trials():
    """Median, Multikrum and Signguard on the width-sharded round of 8
    ranks, 4 rounds a dispatch, the 250 ALIE lanes elided on JAX's strided
    layout."""
    from blades_tpu.parallel.dsharded import (
        elision_client_order as jax_order,
    )
    from blades_tpu_torch.algorithms.fedavg import dsharded_elision_prefix
    from blades_tpu_torch.parallel import elision_client_order

    (spec,) = load_experiments_from_file(MESH_EXAMPLE).values()
    trials = expand_grid(spec["config"])
    aggs = []
    for trial in trials:
        cfg = resolve_trial(spec["run"], trial)
        assert (cfg.execution, cfg.num_devices, cfg.rounds_per_dispatch) == (
            "dsharded", 8, 4)
        assert dsharded_elision_prefix(cfg, cfg.get_adversary()) == 250
        aggs.append(trial["server_config"]["aggregator"]["type"])
    assert aggs == ["Median", "Multikrum", "Signguard"]
    order = elision_client_order(1000, 250, 8)
    assert order.tolist() == jax_order(1000, 250, 8).tolist()
    lanes = (np.arange(1000) < 250)[order].reshape(8, 125)
    assert lanes[:, :31].all() and lanes[:, 31:].sum() == 2


def test_mesh_example_is_refused_in_one_process(tmp_path):
    """One process is a world of one: the 8-rank trials are refused by
    ``make_mesh``'s words before any trial writes a file."""
    exps = load_experiments_from_file(MESH_EXAMPLE)
    with pytest.raises(ValueError, match="requested 8 devices, have 1"):
        run_experiments(exps, storage_path=str(tmp_path), device="cpu")
    assert not any(tmp_path.iterdir())


MLP_GRID = {
    "mlp_grid": {
        "run": "FEDAVG",
        "stop": {"training_iteration": 3},
        "config": {
            "dataset_config": {"type": "mnist", "num_clients": 6,
                               "train_bs": 8},
            "global_model": "mlp", "evaluation_interval": 3,
            "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
            "server_config": {"lr": 1.0, "aggregator": {"grid_search": [
                {"type": "Median"}, {"type": "Trimmedmean"}]}},
        },
    },
}


def _write_grid(tmp_path, grid=MLP_GRID):
    path = tmp_path / "grid.yaml"
    path.write_text(yaml.safe_dump(grid))
    return path


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def _rows(root, trial="mlp_grid_00000", drop=("timers",)):
    path = Path(root) / "mlp_grid" / trial / "result.json"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in drop} for r in rows]


def test_file_command_writes_the_jax_layout_rows_and_accuracy(tmp_path,
                                                              capsys):
    grid = _write_grid(tmp_path)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert train.main(["file", str(grid), "--device", "cpu",
                       "--storage-path", str(ours)]) == 0
    assert "best trial: mlp_grid_0000" in capsys.readouterr().out
    assert jax_train.main(["file", str(grid), "--storage-path", str(theirs),
                           "--no-cost-analysis", "--no-lanes"]) == 0
    assert _files(ours) == _files(theirs)
    assert [p.name for p in sorted((ours / "mlp_grid").iterdir())] == [
        "mlp_grid_00000", "mlp_grid_00001"]
    for trial in ("mlp_grid_00000", "mlp_grid_00001"):
        params = [json.loads((root / "mlp_grid" / trial / "params.json")
                             .read_text()) for root in (ours, theirs)]
        assert params[0] == params[1]
        rows = _rows(ours, trial, drop=())
        jrows = _rows(theirs, trial, drop=())
        assert [r["training_iteration"] for r in rows] == [1, 2, 3]
        for r, jr in zip(rows, jrows):
            assert set(r) <= set(jr)
            assert r["trial"] == jr["trial"] == trial
        assert rows[-1]["test_acc"] > 0.9 and jrows[-1]["test_acc"] > 0.9


@pytest.mark.parametrize("extra", [
    {"codec_config": {"type": "quant", "bits": 8}, "agg_domain": "wire"},
    {"fault_config": {"dropout_rate": 0.3, "num_stragglers": 1,
                      "staleness": 2, "dropout_schedule": [[1, 0.5]]},
     "health_check": True},
], ids=["codec", "faults"])
def test_codec_and_fault_trials_run_through_file(tmp_path, extra):
    """A YAML trial with ``codec_config`` (on the wire) and one with
    ``fault_config`` (its schedule a YAML list of lists) resolve and run
    through ``file``, as the JAX command takes them, their rows carrying
    the JAX rows' keys."""
    config = {**MLP_GRID["mlp_grid"]["config"], **extra}
    config["server_config"] = {"lr": 1.0, "aggregator": {"type": "Median"}}
    grid = {"mlp_grid": {**MLP_GRID["mlp_grid"], "config": config,
                         "stop": {"training_iteration": 2}}}
    path = _write_grid(tmp_path, grid)
    spec = load_experiments_from_file(path)["mlp_grid"]
    assert spec == jax_load(str(path))["mlp_grid"]
    (trial,) = expand_grid(spec["config"])
    resolve_trial(spec["run"], trial)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert train.main(["file", str(path), "--device", "cpu",
                       "--storage-path", str(ours)]) == 0
    assert jax_train.main(["file", str(path), "--storage-path", str(theirs),
                           "--no-cost-analysis", "--no-lanes"]) == 0
    rows, jrows = _rows(ours, drop=()), _rows(theirs, drop=())
    assert [r["training_iteration"] for r in rows] == [1, 2]
    for r, jr in zip(rows, jrows):
        assert set(r) <= set(jr)
    key = "agg_domain" if "codec_config" in extra else "fault_seed"
    assert rows[-1][key] == jrows[-1][key]


ASYNC_TRIAL = {"execution": "async",
               "async_config": {"rate": 0.5, "agg_every": 3,
                                "staleness_cap": 2,
                                "weight_schedule": "inverse"},
               "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}}}
WINDOW_TRIAL = {"state_window": 4, "state_store": "disk",
                "data_store": "memmap", "eval_chunk_clients": 4,
                "client_config": {"momentum": 0.9},
                "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}}}


@pytest.mark.parametrize("extra", [ASYNC_TRIAL, WINDOW_TRIAL],
                         ids=["async", "window"])
def test_async_and_windowed_trials_run_through_file(tmp_path, extra):
    """An async grid point and a windowed one (disk store, memmap data
    store) resolve and run through ``file``, as the JAX command takes them,
    their rows carrying the async digest or the staging digest."""
    config = {**MLP_GRID["mlp_grid"]["config"], **extra,
              "dataset_config": {"type": "mnist", "num_clients": 8,
                                 "train_bs": 8}}
    grid = {"mlp_grid": {**MLP_GRID["mlp_grid"], "config": config,
                         "stop": {"training_iteration": 3}}}
    path = _write_grid(tmp_path, grid)
    spec = load_experiments_from_file(path)["mlp_grid"]
    assert spec == jax_load(str(path))["mlp_grid"]
    (trial,) = expand_grid(spec["config"])
    resolve_trial(spec["run"], trial)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert train.main(["file", str(path), "--device", "cpu",
                       "--storage-path", str(ours)]) == 0
    assert jax_train.main(["file", str(path), "--storage-path", str(theirs),
                           "--no-cost-analysis", "--no-lanes"]) == 0
    rows, jrows = _rows(ours, drop=()), _rows(theirs, drop=())
    assert [r["training_iteration"] for r in rows] == [1, 2, 3]
    for r, jr in zip(rows, jrows):
        assert set(r) <= set(jr)
    if "async_config" in extra:
        assert len(rows[-1]["staleness_hist"]) == 4
        assert rows[-1]["arrival_seed"] == jrows[-1]["arrival_seed"]
    else:
        assert rows[-1]["state_store"] == "disk"
        assert rows[-1]["cohort_size"] == 4
        assert rows[-1]["eval_chunks"] == jrows[-1]["eval_chunks"] == 2


def test_run_command_takes_the_async_flags(tmp_path):
    """``run FEDAVG --execution async --arrivals-json ...`` on the MLP
    writes rows carrying the async digest."""
    assert train.main([
        "run", "FEDAVG", "--rounds", "2", "--device", "cpu",
        "--storage-path", str(tmp_path), "--execution", "async",
        "--arrivals-json", json.dumps({"rate": 0.5, "agg_every": 3}),
        "--config-json", json.dumps(MLP_GRID["mlp_grid"]["config"] | {
            "server_config": {"lr": 1.0}})]) == 0
    path = tmp_path / "fedavg_run" / "fedavg_run_00000" / "result.json"
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["training_iteration"] for r in rows] == [1, 2]
    for key in ("tick", "staleness_mean", "staleness_max", "staleness_hist",
                "buffer_fill", "buffer_overflow", "arrivals_dropped",
                "arrival_seed", "cycle_ticks", "updates_per_sec"):
        assert key in rows[-1], key
    assert train.main([
        "run", "FEDAVG", "--rounds", "1", "--device", "cpu",
        "--storage-path", str(tmp_path / "w"), "--window", "3",
        "--state-store", "host", "--data-store", "memmap", "--data-dir",
        str(tmp_path / "shards"), "--config-json",
        json.dumps(MLP_GRID["mlp_grid"]["config"])]) == 0
    (row,) = [json.loads(line) for line in (
        tmp_path / "w" / "fedavg_run" / "fedavg_run_00000" / "result.json"
    ).read_text().splitlines()]
    assert (row["state_store"], row["cohort_size"], row["data_store"]) == (
        "host", 3, "memmap")


def test_best_trial_line_says_when_no_trial_was_evaluated(tmp_path, capsys):
    """Two rounds of the grid whose evaluation falls due at round 3: no
    row holds a test accuracy, so no trial is named best at 0."""
    grid = _write_grid(tmp_path)
    assert train.main(["file", str(grid), "--device", "cpu", "--max-rounds",
                       "2", "--storage-path", str(tmp_path / "runs")]) == 0
    assert "best trial: no trial evaluated" in capsys.readouterr().out
    assert all("test_acc" not in r for r in _rows(tmp_path / "runs"))


def test_run_command_writes_the_jax_run_layout(tmp_path):
    assert train.main([
        "run", "FEDAVG", "--rounds", "1", "--device", "cpu",
        "--storage-path", str(tmp_path), "--config-json",
        json.dumps(MLP_GRID["mlp_grid"]["config"] | {
            "server_config": {"lr": 1.0}})]) == 0
    assert _files(tmp_path) == ["fedavg_run/fedavg_run_00000/metrics.jsonl",
                                "fedavg_run/fedavg_run_00000/params.json",
                                "fedavg_run/fedavg_run_00000/result.json"]


def test_flags_the_port_lacks_are_refused(tmp_path):
    """The multi-process flags exist now: a coordinator without the
    process counts is refused by the parser, and the mesh flags on one
    process by the config's validation, with the JAX package's words."""
    grid = _write_grid(tmp_path)
    with pytest.raises(SystemExit):
        train.main(["file", str(grid), "--device", "cpu", "--coordinator",
                    "localhost:1234"])
    with pytest.raises(ValueError, match="pre-aggregates per chip"):
        train.main(["run", "FEDAVG", "--device", "cpu", "--execution",
                    "hier"])
    with pytest.raises(ValueError, match="mesh_shape × single-chip"):
        train.main(["run", "FEDAVG", "--device", "cpu", "--mesh-shape",
                    "4x2"])


def test_kill_and_resume_writes_the_straight_runs_rows(tmp_path):
    grid = _write_grid(tmp_path)
    straight, killed = tmp_path / "straight", tmp_path / "killed"
    assert train.main(["file", str(grid), "--device", "cpu",
                       "--storage-path", str(straight)]) == 0
    assert train.main(["file", str(grid), "--device", "cpu",
                       "--storage-path", str(killed), "--preempt-after", "2",
                       "--checkpoint-freq", "1", "--max-failures", "1"]) == 0
    tdir = killed / "mlp_grid" / "mlp_grid_00000"
    assert "SimulatedPreemption" in (tdir / "error.txt").read_text()
    for trial in ("mlp_grid_00000", "mlp_grid_00001"):
        assert verify_result_rounds(killed / "mlp_grid" / trial
                                    / "result.json") == [1, 2, 3]
        a, b = _rows(straight, trial), _rows(killed, trial)
        assert json.dumps(a) == json.dumps(b)


def test_resume_skips_finished_trials_and_restores_in_flight_ones(tmp_path):
    grid = _write_grid(tmp_path)
    root = tmp_path / "runs"
    exps = load_experiments_from_file(grid)
    first = run_experiments(exps, storage_path=str(root), verbose=0,
                            checkpoint_freq=1, preempt_after=2,
                            device="cpu")
    assert first[0]["status"] == "ERROR"  # no retries: marked failed
    assert "status" not in first[1]  # the hook fires once per sweep
    tdir = root / "mlp_grid" / "mlp_grid_00000"
    (tdir / "ckpt_000009.tmp").mkdir()  # a write a kill interrupted
    second = run_experiments(exps, storage_path=str(root), verbose=0,
                             checkpoint_freq=1, resume=True, device="cpu")
    # The preemption fired between round 2's row and its checkpoint.
    assert second[0]["resumed"] == "from round 1"
    assert second[1]["resumed"] == "skipped"
    assert not (tdir / "ckpt_000009.tmp").exists()
    assert verify_result_rounds(tdir / "result.json") == [1, 2, 3]
    straight = tmp_path / "straight"
    run_experiments(exps, storage_path=str(straight), verbose=0,
                    device="cpu")
    assert json.dumps(_rows(root)) == json.dumps(_rows(straight))


def test_latest_checkpoint_deletes_orphans(tmp_path):
    for name in ("ckpt_000002", "ckpt_000004", "ckpt_000006.tmp",
                 "ckpt_final"):
        (tmp_path / name).mkdir()
    assert _latest_checkpoint(tmp_path).name == "ckpt_000004"
    assert not (tmp_path / "ckpt_000006.tmp").exists()
    assert (tmp_path / "ckpt_final").exists()


def test_checkpoint_keep_num_keeps_the_best(tmp_path):
    grid = _write_grid(tmp_path)
    root = tmp_path / "runs"
    assert train.main(["file", str(grid), "--device", "cpu",
                       "--storage-path", str(root), "--checkpoint-freq", "1",
                       "--checkpoint-keep-num", "2",
                       "--checkpoint-score-attr", "train_loss"]) == 0
    losses = {r["training_iteration"]: r["train_loss"] for r in _rows(root)}
    best = sorted(losses, key=lambda it: (losses[it], it))[-2:]
    tdir = root / "mlp_grid" / "mlp_grid_00000"
    assert sorted(p.name for p in tdir.glob("ckpt_*")) == sorted(
        f"ckpt_{it:06d}" for it in best)
    ties = tmp_path / "ties"
    for p in ("ckpt_000001", "ckpt_000002", "ckpt_000003"):
        (ties / p).mkdir(parents=True)
    _prune_checkpoints(ties, 1, {"ckpt_000001": 1.0, "ckpt_000002": 3.0,
                                 "ckpt_000003": 3.0})
    assert [p.name for p in ties.iterdir()] == ["ckpt_000003"]  # newest


def test_metrics_every_3_writes_the_rows_of_metrics_every_1(tmp_path):
    grid = {"mlp_grid": {**MLP_GRID["mlp_grid"],
                         "stop": {"training_iteration": 5}}}
    path = _write_grid(tmp_path, grid)
    for every in ("1", "3"):
        assert train.main(["file", str(path), "--device", "cpu",
                           "--storage-path", str(tmp_path / every),
                           "--metrics-every", every]) == 0
    for trial in ("mlp_grid_00000", "mlp_grid_00001"):
        a, b = _rows(tmp_path / "1", trial), _rows(tmp_path / "3", trial)
        assert [r["training_iteration"] for r in b] == [1, 2, 3, 4, 5]
        assert json.dumps(a) == json.dumps(b)


def test_verify_result_rounds_rejects_duplicates_and_gaps(tmp_path):
    p = tmp_path / "result.json"
    for its in ((1, 2, 2, 3), (1, 2, 4)):
        p.write_text("".join(json.dumps({"training_iteration": i}) + "\n"
                             for i in its))
        with pytest.raises(ValueError, match="duplicates or gaps"):
            verify_result_rounds(p)
    p.write_text("".join(json.dumps({"training_iteration": i}) + "\n"
                         for i in (10, 20, 30)))  # rounds_per_dispatch 10
    assert verify_result_rounds(p) == [10, 20, 30]


def test_host_fault_helpers_match_the_jax_ones(tmp_path):
    from blades_tpu.faults import host as jax_host
    from blades_tpu_torch.faults import host

    for attempt in (1, 2, 3, 9):
        assert host.retry_backoff(attempt, "t:0", base=0.5, cap=30.0) == \
            jax_host.retry_backoff(attempt, "t:0", base=0.5, cap=30.0)
    with pytest.raises(ValueError):
        host.retry_backoff(0, "t:0")
    hook = host.PreemptionHook(2)
    hook.check(1)
    with pytest.raises(host.SimulatedPreemption):
        hook.check(2)
    hook.check(3)  # fires once

    def save(tag):
        def _save(d):
            Path(d).mkdir(parents=True)
            (Path(d) / "v.txt").write_text(tag)
        return _save

    host.atomic_checkpoint(save("old"), tmp_path / "ckpt_000002")
    host.atomic_checkpoint(save("new"), tmp_path / "ckpt_000002")
    assert (tmp_path / "ckpt_000002" / "v.txt").read_text() == "new"
    assert not (tmp_path / "ckpt_000002.tmp").exists()
    host.atomic_write_json({"x": float("nan")}, tmp_path / "a.json")
    assert "NaN" in (tmp_path / "a.json").read_text()


def test_checkpoint_round_trip_restores_the_state_bit_for_bit(tmp_path):
    from blades_tpu_torch.algorithms import FedavgConfig

    cfg = {**MLP_GRID["mlp_grid"]["config"],
           "server_config": {"lr": 1.0, "momentum": 0.9,
                             "aggregator": {"type": "Centeredclipping"}},
           "client_config": {"momentum": 0.5}, "evaluation_interval": 2}
    a = FedavgConfig().update_from_dict(cfg).build(device="cpu")
    rows = [a.train() for _ in range(2)]
    a.save_checkpoint(str(tmp_path / "ckpt"))
    b = FedavgConfig().update_from_dict(cfg).build(device="cpu")
    b.load_checkpoint(str(tmp_path / "ckpt"))
    assert b.iteration == 2 and b._last_eval == a._last_eval
    for k, v in a.state.server.params.items():
        assert torch.equal(v, b.state.server.params[k])
    for k, v in a.state.client_opt.items():
        assert torch.equal(v, b.state.client_opt[k])
    ra, rb = a.train(), b.train()
    for r in (ra, rb):
        r.pop("timers")
    assert ra == rb and "test_acc" in rows[1] and "test_acc" in ra
