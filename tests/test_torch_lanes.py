"""Trial lanes in the port (blades_tpu_torch/tune/lanes.py and the lane
groups of blades_tpu_torch/tune/sweep.py) against the port's sequential
trials and the JAX package's ``run_lanes``.

- A laned trial reproduces its sequential trial: bit for bit under Mean
  (lane by lane) and under Median and Trimmedmean (one column select over
  the client-major ``(n, L * d)`` matrix) -- the rows and the final
  parameters -- since each lane draws from its sequential trial's
  generators and its client blocks are its own;
- the DP epsilon x seed grid runs as one group from the experiment file
  path with rows equal to ``lanes=False``;
- with JAX's draws handed in (its initial parameters, batches, dropout
  masks and DP noise, recomputed from ``run_lanes``'s key chain), seed
  lanes and a DP epsilon group match JAX ``run_lanes`` rows within
  ``rtol=1e-4`` (f32 sums in other orders, and XLA's vmapped lanes: the
  JAX package's own lane-against-sequential tolerance);
- ``lane_groups``, ``_lane_signature`` and ``_lanes_eligible`` give the
  JAX runner's answers; ``server_lr`` lanes under an ``lr_schedule`` and a
  failing group fail as in JAX (loudly, then sequentially), and a
  kernel's failure is not swallowed;
- ``--no-lanes`` and ``--client-packing`` parse and reach the runner.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_round import _jax_draws

from blades_tpu.algorithms import get_algorithm_class as jax_algorithm_class
from blades_tpu.data import DatasetCatalog as JaxDatasetCatalog
from blades_tpu.tune import lanes as jlanes
from blades_tpu.tune import sweep as jsweep
from blades_tpu_torch import train
from blades_tpu_torch.algorithms import get_algorithm_class
from blades_tpu_torch.convert import params_from_jax
from blades_tpu_torch.tune import lanes, sweep

ROW_KEYS = ("train_loss", "agg_norm", "update_norm_mean")
JAX_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread under the parallel test
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_cfg(aggregator="Mean", **extra):
    return {
        "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 16},
        "global_model": "mlp", "evaluation_interval": 2,
        "server_config": {"lr": 1.0, "aggregator": {"type": aggregator}},
        **extra,
    }


def _config(run="FEDAVG", **kw):
    _, cfg = get_algorithm_class(run, return_config=True)
    return cfg.update_from_dict(_run_cfg(**kw))


def _dp_experiment(rounds, seeds, epsilons):
    """fedavg_dp.yaml's grid at a test's size."""
    return {"fedavg_dp_ci": {
        "run": "FEDAVG_DP", "stop": {"training_iteration": rounds},
        "config": {
            "dataset_config": {"type": "mnist", "num_clients": 6,
                               "train_bs": 16,
                               "seed": {"grid_search": seeds}},
            "global_model": "mlp", "evaluation_interval": 2,
            "dp_epsilon": {"grid_search": epsilons}, "dp_delta": 1.0e-6,
            "dp_clip_threshold": 1.0,
            "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}},
        }}}


# ---------------------------------------------------------------------------
# laned == sequential in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aggregator,adversary", [
    ("Mean", None), ("Median", "ALIE"), ("Trimmedmean", "IPM")])
def test_seed_lanes_match_sequential_trials(aggregator, adversary):
    """Lane i of a seed group is seed i's sequential trial bit for bit:
    rows and final parameters (Mean lane by lane; Median and Trimmedmean
    through one select over the laned matrix)."""
    seeds, rounds = [121, 122, 5], 3
    extra = {}
    if adversary:
        extra = {"num_malicious_clients": 2,
                 "adversary_config": {"type": adversary}}
    rows, states = lanes.run_lanes(
        lambda: _config(aggregator=aggregator, **extra),
        [{"seed": s} for s in seeds], rounds, device="cpu",
        return_states=True)
    cfg = _config(aggregator=aggregator, **extra)
    cfg.validate()
    fr = cfg.get_fed_round()
    assert lanes.batches_lanes(fr) == (aggregator != "Mean")
    for i, seed in enumerate(seeds):
        cfg = _config(aggregator=aggregator, **extra)
        cfg.seed = seed
        algo = cfg.build(device="cpu")
        for r in range(rounds):
            row = algo.train()
            lane_row = rows[i][r]
            assert lane_row["training_iteration"] == row["training_iteration"]
            assert lane_row["seed"] == seed
            for k in ROW_KEYS + ("test_acc", "test_loss"):
                if k in row:
                    assert lane_row[k] == row[k], (seed, r, k)
        for k, v in algo.state.server.params.items():
            assert torch.equal(states[i].server.params[k], v), (seed, k)
        algo.stop()
    assert rows[0][0]["train_loss"] != rows[1][0]["train_loss"]
    if aggregator == "Mean":
        # run_seed_lanes: the seed-only form of the same program.
        seed_rows = lanes.run_seed_lanes(
            _config(aggregator=aggregator, **extra), seeds[:2], 1,
            device="cpu")
        assert [r[0] for r in seed_rows] == [r[0] for r in rows[:2]]


def test_client_lr_lanes_match_sequential_trials():
    """``client_lr`` and ``server_lr`` lanes (one seed) reproduce their
    sequential trials bit for bit."""
    overrides = [{"client_lr": 0.1, "server_lr": 1.0},
                 {"client_lr": 0.05, "server_lr": 0.5}]
    rows = lanes.run_lanes(lambda: _config(aggregator="Median"), overrides,
                           2, device="cpu")
    for i, ov in enumerate(overrides):
        cfg = _config(aggregator="Median")
        for k, v in ov.items():
            setattr(cfg, k, v)
        algo = cfg.build(device="cpu")
        for r in range(2):
            row = algo.train()
            for k in ROW_KEYS:
                assert rows[i][r][k] == row[k], (i, r, k)
            assert rows[i][r]["client_lr"] == ov["client_lr"]
        algo.stop()


def test_dp_grid_runs_as_lanes_with_result_parity(tmp_path):
    """The DP epsilon x seed grid from the experiment path: one group of
    four, every row equal to its ``lanes=False`` trial's."""
    rounds = 3
    exp = _dp_experiment(rounds, seeds=[121, 122], epsilons=[1.0, 100.0])
    s_lanes = sweep.run_experiments(exp, storage_path=str(tmp_path / "l"),
                                    verbose=0, device="cpu")
    assert all(s.get("lanes") == 4 for s in s_lanes), s_lanes
    s_seq = sweep.run_experiments(exp, storage_path=str(tmp_path / "s"),
                                  verbose=0, device="cpu", lanes=False)
    assert not any("lanes" in s for s in s_seq)
    for sl, ss in zip(s_lanes, s_seq):
        rows_l = [json.loads(line) for line in
                  open(f"{sl['dir']}/result.json")]
        rows_s = [json.loads(line) for line in
                  open(f"{ss['dir']}/result.json")]
        assert len(rows_l) == len(rows_s) == rounds
        for rl, rs in zip(rows_l, rows_s):
            for k in ("training_iteration",) + ROW_KEYS:
                assert rl[k] == rs[k], k
            if "test_acc" in rs:
                assert rl["test_acc"] == rs["test_acc"]
        assert sl["rounds_per_sec"] > 0 and sl["best_test_acc"] == \
            ss["best_test_acc"]


# ---------------------------------------------------------------------------
# against JAX run_lanes on its own draws
# ---------------------------------------------------------------------------


def _jax_lane_draws(jcfgs, model):
    """JAX ``run_lanes``'s per-lane draws: its key chain (``PRNGKey(seed)``
    split into the init key and the round carry), the initial parameters
    from the init key, and per round the batches, dropout masks (for the
    port's ``model``'s dropout sites) and DP noise its ``step`` draws from
    the round key."""
    base = jcfgs[0]
    jfr = base.get_fed_round()
    n = base.num_clients
    init, data, carries = [], [], []
    for c in jcfgs:
        k_init, carry = jax.random.split(jax.random.PRNGKey(c.seed))
        state = jfr.init(k_init, n)
        init.append(params_from_jax(jax.tree.map(np.asarray,
                                                 state.server.params)))
        ds = JaxDatasetCatalog.get_dataset(
            base.dataset, num_clients=n, iid=base.iid,
            alpha=base.dirichlet_alpha, seed=c.seed)
        data.append(tuple(jnp.asarray(a) for a in (
            ds.train.x, ds.train.y, ds.train.lengths)))
        carries.append(carry)
    d = sum(v.numel() for v in init[0].values())
    keys = {}

    def draws(lane, r):
        if (lane, r) not in keys:
            prev = carries[lane] if r == 1 else keys[lane, r - 1][1]
            keys[lane, r] = tuple(jax.random.split(prev))
        key = keys[lane, r][0]
        bx, by = jfr.sample_round_batches(*data[lane], key)
        masks, _ = _jax_draws(key, n, jfr.num_batches_per_round,
                              jfr.batch_size, model, None)
        out = {"batches": (torch.from_numpy(np.array(bx)),
                           torch.from_numpy(np.array(by)).long()),
               "dropout_masks": masks}
        if jfr.dp_clip_threshold is not None:
            out["dp_noise"] = torch.from_numpy(np.array(jax.random.normal(
                jax.random.split(key, 5)[4], (n, d), jnp.float32)))
        return out

    return draws, init


@pytest.mark.parametrize("run,overrides", [
    ("FEDAVG", [{"seed": 121}, {"seed": 122}]),
    ("FEDAVG_DP", [{"seed": 121, "dp_epsilon": 1.0},
                   {"seed": 121, "dp_epsilon": 100.0},
                   {"seed": 122, "dp_epsilon": 10.0}]),
], ids=["seed-lanes", "dp-epsilon"])
def test_lanes_match_jax_run_lanes_on_its_draws(run, overrides):
    """Seed lanes and a DP epsilon group of the MLP against JAX
    ``run_lanes`` with its draws handed in: every row's train_loss,
    agg_norm, update_norm_mean and test accuracy within ``rtol=1e-4``."""
    rounds = 3
    extra = {"dp_delta": 1e-6, "dp_clip_threshold": 1.0} \
        if run == "FEDAVG_DP" else {}

    def jbuild():
        _, c = jax_algorithm_class(run, return_config=True)
        return c.update_from_dict(_run_cfg(**extra))

    want = jlanes.run_lanes(jbuild, overrides, rounds)
    jcfgs = []
    for o in overrides:
        c = jbuild()
        for k, v in o.items():
            setattr(c, k, v)
        c.validate()
        jcfgs.append(c)
    cfg = _config(run, **extra)
    cfg.validate()
    draws, init = _jax_lane_draws(jcfgs, cfg.get_fed_round().task.model)
    got = lanes.run_lanes(lambda: _config(run, **extra), overrides, rounds,
                          device="cpu", draws=draws, init_params=init)
    for lane in range(len(overrides)):
        for rg, rw in zip(got[lane], want[lane]):
            assert rg["training_iteration"] == rw["training_iteration"]
            for k in ROW_KEYS + ("test_acc", "test_loss"):
                if k in rw:
                    np.testing.assert_allclose(rg[k], rw[k], rtol=JAX_RTOL,
                                               atol=1e-6, err_msg=k)
            assert {k for k in rw if k not in ("dp_noise_factor",)} <= set(rg)


# ---------------------------------------------------------------------------
# grouping and eligibility: the JAX runner's answers
# ---------------------------------------------------------------------------

GROUP_TRIALS = [
    [{"global_model": "mlp", "seed": 1, "server_config": {"lr": 1.0}},
     {"global_model": "mlp", "seed": 2, "server_config": {"lr": 1.0}},
     {"global_model": "mlp", "seed": 1, "server_config": {"lr": 0.5}},
     {"global_model": "cnn", "seed": 1, "server_config": {"lr": 1.0}}],
    [{"seed": 1, "dataset_config": {"type": "mnist", "seed": 7}},
     {"seed": 2, "dataset_config": {"type": "mnist", "seed": 9}}],
    [{"seed": 5, "dataset_config": {"type": "mnist", "seed": 5}},
     {"seed": 6, "dataset_config": {"type": "mnist", "seed": 6}}],
    [{"dp_epsilon": e, "client_config": {"lr": lr},
      "adversary_config": {"type": "IPM", "scale": s}}
     for e in (1.0, 10.0) for lr in (0.1, 0.2) for s in (0.1, 100.0)],
]


@pytest.mark.parametrize("trials", GROUP_TRIALS)
def test_lane_groups_and_signatures_match_jax(trials):
    assert sweep.lane_groups(trials) == jsweep.lane_groups(trials)
    for t in trials:
        assert sweep._lane_signature(t) == jsweep._lane_signature(t)


def test_lane_signature_seed_path_conflict_stays_sequential():
    t1 = {"seed": 1, "dataset_config": {"type": "mnist", "seed": 7}}
    t2 = {"seed": 2, "dataset_config": {"type": "mnist", "seed": 9}}
    sig1, ov1 = sweep._lane_signature(t1)
    assert ov1 == {} and "__lane_conflict__" in sig1
    assert {tuple(g) for g in sweep.lane_groups([t1, t2])} == {(0,), (1,)}
    t3 = {"seed": 5, "dataset_config": {"type": "mnist", "seed": 5}}
    assert sweep._lane_signature(t3)[1].get("seed") == 5


ELIGIBLE = [
    # the dense budget: 200 clients x 11.2M parameters x 4 B per lane
    ({"dataset_config": {"type": "cifar10", "num_clients": 200, "seed": 1},
      "global_model": "resnet18",
      "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}}}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6, "seed": 1},
      "global_model": "mlp",
      "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}}}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6, "seed": 1},
      "global_model": "mlp"}, 1),
    ({"dataset_config": {"type": "mnist", "num_clients": 300}}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6},
      "forensics": True}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6},
      "execution": "streamed"}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6},
      "fault_config": {"dropout_rate": 0.1}}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6},
      "state_window": 3}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6},
      "rounds_per_dispatch": 2}, 2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6},
      "server_config": {"lr": 1.0, "lr_schedule": [[0, 1.0], [5, 0.1]]}},
     2),
    ({"dataset_config": {"type": "mnist", "num_clients": 6},
      "codec_config": {"type": "quant", "bits": 8}}, 2),
]


@pytest.mark.parametrize("trial,size", ELIGIBLE)
def test_lanes_eligible_matches_jax(trial, size):
    """Singletons, the 200-client cap, forensics, streamed execution,
    faults, windows, fused dispatches, ``server_lr`` lanes under a
    schedule and the ``L * n * d * 4`` dense budget (6 GiB on the CPU):
    the JAX runner's verdict."""
    group = list(range(size))
    got = sweep._lanes_eligible("FEDAVG", trial, group, device="cpu")
    assert got == jsweep._lanes_eligible("FEDAVG", trial, group)


def test_lanes_eligible_refuses_ledger_and_control():
    """The laned program carries neither the client ledger nor the control
    plane: such groups run sequentially."""
    base = {"dataset_config": {"type": "mnist", "num_clients": 6}}
    assert sweep._lanes_eligible("FEDAVG", base, [0, 1], device="cpu")
    for extra in ({"ledger": True}, {"control_config": {}}):
        assert not sweep._lanes_eligible("FEDAVG", {**base, **extra},
                                         [0, 1], device="cpu")


# ---------------------------------------------------------------------------
# refusals and the loud fallback
# ---------------------------------------------------------------------------


def test_server_lr_lanes_reject_lr_schedule():
    def builder():
        cfg = _config()
        cfg.lr_schedule = [[0, 1.0], [10, 0.1]]
        return cfg

    with pytest.raises(ValueError, match="lr_schedule"):
        lanes.run_lanes(builder, [{"server_lr": 1.0}, {"server_lr": 0.5}],
                        1, device="cpu")


@pytest.mark.parametrize("overrides,match", [
    ([{"seed": 1}, {"client_lr": 0.1}], "same keys"),
    ([{"momentum": 0.1}, {"momentum": 0.2}], "not lane-traceable"),
])
def test_run_lanes_refuses_as_jax(overrides, match):
    with pytest.raises(ValueError, match=match):
        lanes.run_lanes(_config, overrides, 1, device="cpu")
    with pytest.raises(ValueError, match=match):
        jlanes.run_lanes(lambda: jax_algorithm_class(
            "FEDAVG", return_config=True)[1].update_from_dict(_run_cfg()),
            overrides, 1)


def test_trusted_aggregators_are_not_laned():
    with pytest.raises(ValueError, match="trust-bootstrapped"):
        lanes.run_lanes(lambda: _config(aggregator="FLTrust"),
                        [{"seed": 1}, {"seed": 2}], 1, device="cpu")


def test_lane_group_failure_is_loud(tmp_path, monkeypatch):
    """A failing group warns, stamps its trials' summaries and runs them
    one by one."""
    def boom(*a, **k):
        raise RuntimeError("lane boom")

    monkeypatch.setattr(sweep, "_run_lane_group", boom)
    exp = _dp_experiment(2, seeds=[121, 122], epsilons=[1.0])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        summaries = sweep.run_experiments(exp, storage_path=str(tmp_path),
                                          verbose=0, device="cpu")
    assert any("fell back to sequential" in str(x.message) for x in w)
    assert all(s.get("lane_fallback", "").endswith("lane boom")
               for s in summaries), summaries
    assert all(s["rounds"] == 2 and "lanes" not in s for s in summaries)


def test_kernel_failure_in_a_lane_group_raises(tmp_path, monkeypatch):
    """A failure raised from the kernels' module is not a fallback: the
    sweep raises it."""
    from blades_tpu_torch.ops import _cuda

    code = compile("def kernel_boom(*a, **k):\n"
                   "    raise RuntimeError('nvcc failed')\n",
                   _cuda.__file__, "exec")
    scope = {}
    exec(code, scope)
    monkeypatch.setattr(sweep, "_run_lane_group", scope["kernel_boom"])
    exp = _dp_experiment(1, seeds=[121, 122], epsilons=[1.0])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sweep.run_experiments(exp, storage_path=str(tmp_path), verbose=0,
                              device="cpu")


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _grid(tmp_path):
    path = tmp_path / "grid.yaml"
    path.write_text(
        "g:\n  run: FEDAVG\n  stop: {training_iteration: 1}\n  config:\n"
        "    dataset_config:\n      type: mnist\n      num_clients: 6\n"
        "      train_bs: 8\n      seed: {grid_search: [1, 2]}\n"
        "    global_model: mlp\n    evaluation_interval: 1\n")
    return path


@pytest.mark.parametrize("flag,laned", [([], True), (["--no-lanes"], False)])
def test_no_lanes_flag(tmp_path, monkeypatch, flag, laned):
    seen = {}
    real = sweep.run_experiments

    def spy(experiments, **kw):
        seen.update(kw)
        return real(experiments, **kw)

    monkeypatch.setattr(sweep, "run_experiments", spy)
    monkeypatch.setattr("blades_tpu_torch.tune.run_experiments", spy)
    assert train.main(["file", str(_grid(tmp_path)), "--device", "cpu",
                       "--storage-path", str(tmp_path / "r")] + flag) == 0
    assert seen["lanes"] is laned
    rows = [json.loads(line) for line in
            (tmp_path / "r" / "g" / "g_00000" / "result.json").open()]
    assert ("seed" in rows[0]) is laned


@pytest.mark.parametrize("value,want", [("auto", "auto"), ("2", 2),
                                        ("off", "off")])
def test_client_packing_flag(tmp_path, value, want):
    assert train.main([
        "run", "FEDAVG", "--rounds", "1", "--device", "cpu",
        "--client-packing", value, "--storage-path", str(tmp_path),
        "--config-json", json.dumps(_run_cfg())]) == 0
    params = json.loads((tmp_path / "fedavg_run" / "fedavg_run_00000"
                         / "params.json").read_text())
    assert params["client_packing"] == want
    rows = [json.loads(line) for line in
            (tmp_path / "fedavg_run" / "fedavg_run_00000"
             / "result.json").open()]
    assert rows[0].get("pack_factor") == (2 if want == 2 else None)
