"""The port's performance layer against the JAX package's: dense batch
prefetch (blades_tpu_torch/data/prefetch.py), the kernel build cache and
the program fingerprint (blades_tpu_torch/perf/compile_cache.py), the
counted ``Fedavg.cost_analysis()``, per-round rows from a windowed
dispatch, and the result tools (the accuracy curves' ``curves.json``,
``tune/visualize.py``, the gossip curves, the centralized trainer, the
profiling shim).  Exact comparisons unless a test states a tolerance.
"""

import json
import warnings
from pathlib import Path

import pytest
import torch

from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.data.prefetch import BatchPrefetcher
from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.perf import compile_cache

MNIST = {"dataset_config": {"type": "mnist", "num_clients": 6,
                            "train_bs": 8, "seed": 3},
         "global_model": "mlp", "evaluation_interval": 2,
         "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
         "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}}}


def _build(**extra):
    return FedavgConfig().update_from_dict({**MNIST, **extra}).build(
        device="cpu")


def _params(algo):
    return {k: v.detach().clone() for k, v in
            algo.state.server.params.items()}


# ---------------------------------------------------------------------------
# dense batch prefetch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    {}, {"codec_config": {"type": "quant", "bits": 8}},
    {"global_model": "cnn", "dataset_config": {"type": "fashionmnist",
                                               "num_clients": 4,
                                               "train_bs": 8}},
])
def test_prefetch_on_and_off_train_bit_for_bit_the_same(extra):
    runs = {}
    for pre in (False, True):
        algo = _build(prefetch=pre, **extra)
        assert (algo._prefetcher is not None) is pre
        rows = [algo.train() for _ in range(2)]
        runs[pre] = (_params(algo), [r["train_loss"] for r in rows],
                     rows[-1]["test_acc"])
        algo.stop()
    (p0, l0, a0), (p1, l1, a1) = runs[False], runs[True]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert l0 == l1 and a0 == a1


def test_prefetch_auto_is_on_only_on_the_card_and_single_round():
    algo = _build()
    assert algo._prefetcher is None  # "auto" on the CPU
    algo.stop()
    algo = _build(prefetch=True, rounds_per_dispatch=2)
    assert algo._prefetcher is None  # nothing to stage inside a window
    algo.stop()


def test_the_prefetcher_hands_over_the_generator_past_its_draws():
    seeds = {0: 11, 1: 12, 2: 13}
    drawn = []

    def sample(gen):
        drawn.append(1)
        return torch.rand(3, generator=gen), torch.rand(2, generator=gen)

    pf = BatchPrefetcher(sample, seeds.__getitem__, "cpu")
    pf.stage(1)
    gen, bx, by = pf.take(1)  # the staged entry
    ref = torch.Generator().manual_seed(12)
    assert torch.equal(bx, torch.rand(3, generator=ref))
    assert torch.equal(by, torch.rand(2, generator=ref))
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=ref))
    pf.stage(2)
    gen, bx, _ = pf.take(0)  # another index: drawn now
    assert torch.equal(bx, torch.rand(3, generator=torch.Generator()
                                      .manual_seed(11)))
    pf.stage(2)
    pf.invalidate()
    n = len(drawn)
    pf.take(2)
    assert len(drawn) == n + 1
    pf.close()


def test_a_checkpoint_restore_drops_the_staged_batches(tmp_path):
    algo = _build(prefetch=True)
    straight = _build(prefetch=True)
    for _ in range(2):
        algo.train()
        straight.train()
    algo.save_checkpoint(str(tmp_path / "ck"))
    algo.train()  # stages round 4 ...
    algo.load_checkpoint(str(tmp_path / "ck"))  # ... then rewinds to 2
    a, b = algo.train(), straight.train()
    assert a["train_loss"] == b["train_loss"]
    assert all(torch.equal(x, y) for x, y in
               zip(_params(algo).values(), _params(straight).values()))
    algo.stop()
    straight.stop()


# ---------------------------------------------------------------------------
# the kernel build cache and the fingerprint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("obj", [
    {"a": 1, "b": [1, 2.5, None]}, {"b": 1, "a": {"z": "x", "y": True}},
    [1, "two", 3.0], "plain", {"dataset": "<dataset:mnist>"},
])
def test_fingerprint_is_the_jax_packages(obj):
    from blades_tpu.perf.compile_cache import fingerprint as jax_fp

    assert compile_cache.fingerprint(obj) == jax_fp(obj)


def test_kernel_builds_count_hits_and_misses(tmp_path, monkeypatch):
    """Finding the library in the build directory is a hit; running nvcc
    (missing here, so the build raises) a miss; ``--compile-cache`` names
    the directory."""
    compile_cache.clear_cache()
    monkeypatch.setattr(compile_cache, "_cache_dir", None)
    assert compile_cache.set_cache_dir(str(tmp_path)) == str(tmp_path)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()
    assert compile_cache.cache_stats() == {"hits": 0, "misses": 1}
    import hashlib

    h = hashlib.sha1()
    for src in _cuda._sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = tmp_path / f"libblades_kernels_{h.hexdigest()[:12]}.so"
    lib.write_bytes(b"")
    assert _cuda.build() == lib
    assert compile_cache.cache_stats() == {"hits": 1, "misses": 1}
    compile_cache.clear_cache()


def test_the_cache_directory_comes_from_the_environment(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(compile_cache, "_cache_dir", None)
    monkeypatch.delenv(compile_cache.ENV_CACHE_DIR, raising=False)
    assert compile_cache.cache_dir(Path("build")) == Path("build")
    assert compile_cache.set_cache_dir(None) is None
    monkeypatch.setenv(compile_cache.ENV_CACHE_DIR, str(tmp_path))
    assert compile_cache.cache_dir(Path("build")) == tmp_path.resolve()


@pytest.mark.parametrize("extra,stamped", [
    ({}, True),
    ({"execution": "streamed", "client_block": 2}, False),
    ({"state_window": 3}, True),
    ({"execution": "async", "async_config": {"rate": 0.5,
                                             "agg_every": 3}}, False),
    ({"execution": "gossip", "num_malicious_clients": 0,
      "adversary_config": None}, False),
])
def test_rows_carry_the_build_counters_where_jax_rows_carry_its(
        extra, stamped):
    """The dense and windowed rounds' rows carry ``compile_cache_hits`` /
    ``compile_cache_misses``, as the JAX driver's AOT-compiled paths do."""
    from blades_tpu.algorithms import FedavgConfig as JaxConfig

    run = {**MNIST, **extra}
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    jalgo = JaxConfig().update_from_dict(run).build()
    try:
        row, jrow = algo.train(), jalgo.train()
    finally:
        algo.stop()
        jalgo.stop()
    keys = {"compile_cache_hits", "compile_cache_misses"}
    assert (keys <= set(row)) is stamped
    assert (keys <= set(jrow)) is stamped


def test_sweep_summaries_carry_the_trials_build_delta(tmp_path,
                                                      monkeypatch):
    from blades_tpu_torch.tune import run_experiments

    def fake_setup(self, _orig=FedavgConfig.build):
        compile_cache.record(hit=True)
        return _orig(self, device="cpu")

    exp = {"cc": {"run": "FEDAVG", "stop": {"training_iteration": 1},
                  "config": MNIST}}
    (plain,) = run_experiments(exp, storage_path=str(tmp_path / "a"),
                               verbose=0, device="cpu", cost_analysis=False)
    assert "compile_cache" not in plain
    monkeypatch.setattr(FedavgConfig, "build",
                        lambda self, device=None: fake_setup(self))
    (s,) = run_experiments(exp, storage_path=str(tmp_path / "b"), verbose=0,
                           device="cpu", cost_analysis=False,
                           compile_cache_dir=str(tmp_path / "k"))
    assert s["compile_cache"] == {"hits": 1, "misses": 0}


# ---------------------------------------------------------------------------
# cost analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    {"prefetch": True}, {"execution": "streamed", "client_block": 2},
    {"client_config": {"momentum": 0.9}, "rounds_per_dispatch": 2},
])
def test_cost_analysis_counts_and_leaves_the_trial_untouched(extra):
    algo = _build(**extra)
    algo.train()
    before = _params(algo)
    opt = (None if algo.state.client_opt is None else
           {k: v.clone() for k, v in algo.state.client_opt.items()})
    it = algo.iteration
    launches = dict(_cuda.LAUNCHES)
    cost = algo.cost_analysis()
    assert set(cost) == {"flops", "bytes_accessed"}
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert algo.cost_analysis() is cost  # memoized
    assert algo.iteration == it and dict(_cuda.LAUNCHES) == launches
    after = _params(algo)
    assert all(torch.equal(before[k], after[k]) for k in before)
    if opt is not None:
        assert all(torch.equal(opt[k], algo.state.client_opt[k])
                   for k in opt)
    # The next round is the round it would have been.
    twin = _build(**extra)
    twin.train()
    assert algo.train()["train_loss"] == twin.train()["train_loss"]
    algo.stop()
    twin.stop()


def test_cost_analysis_counts_a_grouped_convolution_once():
    """A vmapped client block is a convolution of G groups; its weight
    gradient counts its own products, so a ResNet-10 round counts the
    same flops in blocks of 1, 2 or 4 clients (forward, input and weight
    gradients: 3 forward passes less the first layer's input
    gradient)."""
    run = {"dataset_config": {"type": "cifar10", "num_clients": 4,
                              "train_bs": 8},
           "global_model": "resnet10", "execution": "streamed",
           "server_config": {"aggregator": {"type": "Median"}},
           "evaluation_interval": 0}
    counts = []
    for block in (2, 4):
        algo = FedavgConfig().update_from_dict(
            {**run, "client_block": block}).build(device="cpu")
        counts.append((algo.cost_analysis()["flops"],
                       algo.cost_by_op["aten.convolution_backward"],
                       algo.cost_by_op["aten.convolution"]))
        algo.stop()
    assert counts[0] == counts[1]
    _, backward, forward = counts[0]
    assert 1.9 * forward < backward < 2.0 * forward


def test_cost_analysis_counts_the_matmuls():
    """The MLP's dense round, by ``torch.utils.flop_counter``'s formulas:
    each layer's forward product and its weight gradient over every
    client's batch, and the input gradient of all but the first layer (2
    flops per multiply-add); nothing else in the round is a product."""
    algo = _build(rounds_per_dispatch=1)
    n, b = 6, 8
    widths = [(784, 128), (128, 256), (256, 10)]
    want = sum(2 * (2 if j == 0 else 3) * n * b * i * o
               for j, (i, o) in enumerate(widths))
    assert algo.cost_analysis()["flops"] == want
    algo.stop()


def test_cost_analysis_is_none_without_a_single_dispatch():
    algo = _build(execution="async", async_config={"rate": 0.5,
                                                   "agg_every": 3})
    assert algo.cost_analysis() is None
    algo.stop()
    algo = _build(state_window=3)
    assert algo.cost_analysis() is None
    algo.stop()


def test_kernel_launches_book_their_bounds_into_cost():
    _cuda.COST = {"bytes": 0, "flops": 0}
    try:
        _cuda._charge(_cuda._nbytes(torch.zeros(4, 3), None), 7 * 12)
    finally:
        got, _cuda.COST = _cuda.COST, None
    assert got == {"bytes": 48, "flops": 84}
    _cuda._charge(10, 10)  # no sink: nothing happens


def test_sweep_summaries_carry_the_cost(tmp_path):
    from blades_tpu_torch.tune import run_experiments

    exp = {"c": {"run": "FEDAVG", "stop": {"training_iteration": 2},
                 "config": MNIST}}
    (s,) = run_experiments(exp, storage_path=str(tmp_path), verbose=0,
                           device="cpu")
    assert s["cost"]["flops"] > 0 and s["cost"]["bytes_accessed"] > 0
    (s,) = run_experiments(exp, storage_path=str(tmp_path / "n"),
                           verbose=0, device="cpu", cost_analysis=False)
    assert "cost" not in s


# ---------------------------------------------------------------------------
# per-round rows from a windowed dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [2, 3])
def test_train_rows_per_round_are_the_sequential_rows(window):
    drop = ("timers",)
    seq = _build(evaluation_interval=6, ledger=True)
    rows = [seq.train() for _ in range(6)]
    seq.stop()
    win = _build(evaluation_interval=6, ledger=True,
                 rounds_per_dispatch=window)
    got = []
    while win.iteration < 6:
        got += win.train_rows(per_round=True)
    win.stop()
    strip = [{k: v for k, v in r.items() if k not in drop} for r in rows]
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in got] == strip


# ---------------------------------------------------------------------------
# the result tools
# ---------------------------------------------------------------------------


def test_curves_json_has_the_jax_key_set(tmp_path):
    from blades_tpu.benchmarks import accuracy_curves as jax_curves
    from blades_tpu_torch.benchmarks import accuracy_curves

    argv = ["--dataset", "mnist", "--rounds", "1", "--num-clients", "6",
            "--aggregators", "Median", "--malicious", "0", "1",
            "--rounds-per-dispatch", "1"]
    assert accuracy_curves.main(argv + ["--out", str(tmp_path / "t"),
                                        "--device", "cpu"]) == 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert jax_curves.main(argv + ["--out", str(tmp_path / "j")]) == 0
    ours = json.loads((tmp_path / "t" / "curves.json").read_text())
    theirs = json.loads((tmp_path / "j" / "curves.json").read_text())
    assert set(ours) == set(theirs)
    assert [set(r) for r in ours["rows"]] == [set(r) for r in theirs["rows"]]
    for k in ("source", "planned", "planned_complete", "reference_grid",
              "reference_cells_missing", "complete"):
        assert ours[k] == theirs[k], k
    assert ours["rows"][0]["synthetic_data"] is True
    assert (tmp_path / "t" / "curves.png").exists()


def test_curves_without_matplotlib_write_the_table_and_say_so(
        tmp_path, monkeypatch, capsys):
    import builtins

    from blades_tpu_torch.benchmarks import accuracy_curves

    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("no matplotlib")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    assert accuracy_curves.main([
        "--dataset", "mnist", "--rounds", "1", "--num-clients", "6",
        "--aggregators", "Mean", "--malicious", "0",
        "--out", str(tmp_path), "--device", "cpu"]) == 0
    assert "curves.png not written" in capsys.readouterr().out
    assert (tmp_path / "curves.json").exists()
    assert not (tmp_path / "curves.png").exists()


def test_curves_resume_skips_finished_cells(tmp_path, capsys):
    from blades_tpu_torch.benchmarks import accuracy_curves

    argv = ["--dataset", "mnist", "--rounds", "1", "--num-clients", "6",
            "--aggregators", "Mean", "--malicious", "0",
            "--out", str(tmp_path), "--device", "cpu"]
    assert accuracy_curves.main(argv) == 0
    capsys.readouterr()
    assert accuracy_curves.main(argv + ["--resume-from",
                                        str(tmp_path / "curves.json")]) == 0
    out = capsys.readouterr().out
    assert "resumed 1 cells" in out and '"aggregator"' not in out
    with pytest.raises(SystemExit, match="mismatch on 'rounds'"):
        accuracy_curves.main([*argv[:3], "2", *argv[4:], "--resume-from",
                              str(tmp_path / "curves.json")])


def _sweep_dir(tmp_path):
    from blades_tpu_torch.tune import run_experiments

    cfg = {**MNIST, "num_malicious_clients": {"grid_search": [0, 2]}}
    run_experiments({"v": {"run": "FEDAVG",
                           "stop": {"training_iteration": 2},
                           "config": cfg}},
                    storage_path=str(tmp_path), verbose=0, device="cpu",
                    cost_analysis=False)
    return tmp_path


def test_visualize_reads_the_jax_tables_rows(tmp_path):
    pd = pytest.importorskip("pandas")
    from blades_tpu.tune import visualize as jax_vis
    from blades_tpu_torch.tune import visualize

    root = _sweep_dir(tmp_path)
    rows = visualize.load_results(str(root))
    frame = jax_vis.load_results(str(root))
    assert len(rows) == len(frame) == 4
    for r, (_, jr) in zip(rows, frame.iterrows()):
        for k, v in r.items():
            jv = jr[k]
            assert v == jv or (v is None and pd.isna(jv)), k
    final = visualize.final_rows(rows)
    jfinal = frame.dropna(subset=["test_acc"]).groupby("trial").tail(1)
    assert [r["trial"] for r in final] == list(jfinal["trial"])
    assert [r["test_acc"] for r in final] == list(jfinal["test_acc"])


def test_visualize_prints_and_plots(tmp_path, capsys):
    from blades_tpu_torch.tune import visualize

    root = _sweep_dir(tmp_path)
    assert visualize.main([str(root), "--plot",
                           str(tmp_path / "grid.png")]) == 0
    out = capsys.readouterr().out
    assert "v_00000" in out and "v_00001" in out
    assert (tmp_path / "grid.png").exists()
    assert visualize.main([str(tmp_path / "none")]) == 1


def test_gossip_curves_write_the_table(tmp_path, capsys):
    from blades_tpu_torch.tools import gossip_curves

    out = tmp_path / "g" / "curves.json"
    assert gossip_curves.main(["--rounds", "2", "--graphs", "ring",
                               "--device", "cpu", "--out", str(out)]) == 0
    table = json.loads(out.read_text())
    assert table["complete"] is False
    assert len(table["rows"]) == 4
    paths = [r["path"] for r in table["rows"]]
    assert paths == ["centralized"] * 2 + ["gossip_ring"] * 2
    ring = table["rows"][2]
    assert ring["gossip_ici_bytes"] == 0 and len(ring["test_acc_curve"]) == 2
    assert 0.0 < ring["spectral_gap"] <= 1.0
    missing = table["reference_cells_missing"]
    assert "Median@0" not in missing and "Mean@0" in missing


def test_the_centralized_trainer_learns(capsys):
    from blades_tpu_torch.benchmarks import main as bench_main

    assert bench_main.main(["--model", "mlp", "--dataset", "mnist",
                            "--epochs", "1", "--batch-size", "256",
                            "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    accs = [float(x.split("test_acc=")[1].split()[0]) for x in lines]
    assert len(accs) == 1 and accs[-1] > 0.9


def test_the_profiling_shim_is_the_span_layers(tmp_path):
    from blades_tpu_torch.obs import trace as tr
    from blades_tpu_torch.utils import profiling

    assert profiling.trace is tr.trace and profiling.annotate is tr.annotate
    assert not hasattr(profiling, "xla_dump_flags")
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("blades-region"):
            torch.ones(4).sum()
    doc = json.loads((tmp_path / "profile.trace.json").read_text())
    assert any(e.get("name") == "blades-region"
               for e in doc["traceEvents"])


def test_perf_exports_the_jax_names_the_port_has():
    import blades_tpu.perf as jperf
    import blades_tpu_torch.perf as perf

    for name in ("Plan", "PlanCache", "PlanSpace", "apply_plan",
                 "enumerate_plans", "select_plan", "timed_measure_fn",
                 "cache_stats", "clear_cache", "fingerprint", "flush_rows"):
        assert hasattr(perf, name) and hasattr(jperf, name), name
    # The AOT executable cache has no counterpart on the card.
    for name in ("CachedFunction", "cached_jit",
                 "enable_persistent_compilation_cache"):
        assert hasattr(jperf, name) and not hasattr(perf, name)
