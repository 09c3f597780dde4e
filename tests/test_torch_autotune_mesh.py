"""The port's execution autotuner on the ranks of a process group
(``Fedavg._plan_space`` / ``_resolve_autotune_plan`` with ``num_devices``,
``perf/autotune.py::timed_measure_fn`` / ``select_plan`` with a mesh, the
agreement helpers of ``parallel/mesh.py``) against the JAX package's plan
space and its refusals.

One module-scoped group of 2 gloo ranks (``start_ranks`` of
tests/test_torch_mesh.py; an MLP federation of 8 MNIST clients, 2 of them
ALIE, Median) runs the cases below while the parent computes JAX's plan
spaces.  The measured path runs as on the card: ``timing_available`` is
patched to True and each rank's ``timed_measure_fn`` gets a fake clock
whose seconds depend on the plan (and, where a case says so, on the rank).

- the agreement helpers: ``all_ranks_ok`` is a MIN over the ranks,
  ``broadcast_object`` hands rank 0's object to all, each counted on a
  recorder under its label;
- (a) the plan ids and tiers of ``_plan_space`` on the ranks equal JAX's
  ``Fedavg._plan_space`` on 2 of the 8 CPU devices, with and without
  ``mesh_shape=(2, 1)``, in the default and the reassociating tier;
- (b) with clocks under which rank 1 alone would pick another plan, both
  ranks adopt rank 0's winner and provenance (rank 0's medians), and each
  rank still timed every candidate itself;
- (c) a candidate that fails on rank 1 alone, in its build or in a timed
  round, is dropped on both ranks, and the ranks go on together;
- (d) only rank 0 reads and writes the plan cache (each rank is handed its
  own directory): a second run is a cache hit on both ranks with no
  candidate built, though rank 1's directory is empty;
- (e) three rounds of a tuned run equal, bit for bit, three rounds of a run
  pinned to its winner (``tuned_plan``): the default tier's winner and the
  reassociating tier's hierarchical winner, which runs the hierarchical
  round (``mesh_shape`` ``2x1`` in its rows);
- an autotuned sweep trial resumed from its checkpoint pins the
  checkpoint's plan on every rank, and a ``tuned_plan`` that differs
  across ranks is refused on every rank;
- ``train file --autotune reassociating`` with the process flags on the
  ranks writes rows stamped with the winner, and every rank's summary
  carries rank 0's ``autotune`` record.

Without processes: (f) the refusals (``execution='hier'`` / ``'dsharded'``
pins, ``"auto"`` resolving to the width-sharded round) are JAX's, word for
word.
"""

import itertools
import json
import os
import warnings

import pytest
import torch
from test_torch_mesh import _cpu, start_ranks

WORLD = 2
ROUNDS = 3
MLP = {
    "dataset_config": {"type": "mnist", "num_clients": 8, "train_bs": 8,
                       "seed": 3},
    "global_model": "mlp", "evaluation_interval": 0,
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.1, "num_batch_per_round": 1},
}
SPACE_CONFIGS = {"flat": {}, "mesh-2x1": {"mesh_shape": (2, 1)}}
HIER_ID = "dense|c131072|p1|mxu=off|w1|nopre|mesh=2x1|hier"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the rank programs
# ---------------------------------------------------------------------------


class _FakeTiming:
    """The measured path on the CPU: ``timing_available`` True and every
    candidate measured by the real ``timed_measure_fn`` (a warm-up and one
    timed round) under a clock that advances ``seconds(plan)`` a call, so
    its median is that.  ``fail``
    (``(plan_id, where)``, where ``"build"`` or ``"train"``) raises on
    this rank after the candidate's build or its first timed round went
    through.  Records each plan this rank measured and its own median."""

    def __init__(self, seconds, fail=None):
        from blades_tpu_torch.perf import autotune as at

        self.at, self.seconds, self.fail = at, seconds, fail
        self.local, self.built = {}, []

    def __enter__(self):
        at = self.at
        self._saved = at.timed_measure_fn, at.timing_available
        real = at.timed_measure_fn

        def fake(config, **kw):
            def measure(plan):
                self.built.append(plan.plan_id)
                ticks = itertools.count(0.0, self.seconds(plan))
                m = real(config, reps=1, clock=lambda: next(ticks),
                         build=self._build(plan), **kw)
                self.local[plan.plan_id] = m(plan)
                return self.local[plan.plan_id]

            measure.peaks = {}
            return measure

        at.timed_measure_fn = fake
        at.timing_available = lambda device=None: True
        return self

    def __exit__(self, *exc):
        self.at.timed_measure_fn, self.at.timing_available = self._saved

    def _build(self, plan):
        fail = self.fail if self.fail and self.fail[0] == plan.plan_id \
            else None

        def build(cand):
            algo = cand.build(device="cpu")
            if fail and fail[1] == "build":
                algo.stop()
                raise RuntimeError("a failure planted on this rank")
            if fail and fail[1] == "train":
                real_train = algo.train

                def train():
                    real_train()
                    if algo.iteration >= 2:
                        raise RuntimeError("a failure planted on this rank")

                algo.train = train
            return algo

        return build


def _tuned(cfg, rounds=ROUNDS):
    """Build ``cfg`` on the ranks and run ``rounds`` rounds: the plan, its
    provenance, the parameters and the rows' scalars."""
    from blades_tpu_torch.algorithms import FedavgConfig

    algo = FedavgConfig().update_from_dict(cfg).build(device="cpu")
    try:
        rows = [algo.train() for _ in range(rounds)]
        return {"plan": None if algo.plan is None else algo.plan.as_dict(),
                "prov": algo.plan_summary,
                "params": _cpu(algo.state.server.params),
                "hier": algo._hier_recorder is not None,
                "rows": [{k: v for k, v in r.items()
                          if isinstance(v, (int, float, str, bool))}
                         for r in rows]}
    finally:
        algo.stop()


def _space_case(case, rank):
    """(a) the port's plan space on the ranks, for each config and tier;
    and the agreement helpers once each, counted on a recorder."""
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.parallel.mesh import (
        all_ranks_ok,
        broadcast_object,
        make_mesh,
    )
    from blades_tpu_torch.parallel.streamed_geometry import PassRecorder

    mesh, rec = make_mesh(WORLD), PassRecorder()
    out = {"ok": all_ranks_ok(mesh, rank == 0, recorder=rec, label="ok"),
           "all_ok": all_ranks_ok(mesh, True),
           "got": broadcast_object(mesh, {"rank": rank}, recorder=rec,
                                   label="who"),
           "events": list(rec.ici_events)}
    for name, extra in SPACE_CONFIGS.items():
        algo = FedavgConfig().update_from_dict(
            {**MLP, "num_devices": WORLD, **extra}).build(device="cpu")
        try:
            for reassoc in (False, True):
                space = algo._plan_space(allow_reassociating=reassoc)
                out[name, reassoc] = [(p.plan_id, p.tier)
                                      for p in space.candidates]
        finally:
            algo.stop()
    return out


def _decide_case(case, rank):
    """(b) + (e): rank-dependent clocks, then the tuned run against the run
    pinned to its winner, for the default and the reassociating tier."""
    import torch.distributed as dist

    out = {}
    for tier in ("on", "reassociating"):
        cfg = {**MLP, "num_devices": WORLD, "autotune": tier,
               "autotune_cache_dir": os.path.join(case["dir"], f"b-{tier}")}

        def seconds(plan, tier=tier):
            # Rank 0 favours the last candidate (under the reassociating
            # tier the hierarchical round), rank 1 the first.
            fast = (plan.collective == "hier" if tier == "reassociating"
                    else plan.prefetch)
            return (0.25 if fast else 0.5) if rank == 0 else \
                (0.75 if fast else 0.125)

        with _FakeTiming(seconds) as ft:
            tuned = _tuned(cfg)
        dist.barrier()
        pinned = _tuned({**cfg, "tuned_plan": tuned["plan"]})
        out[tier] = {"tuned": tuned, "pinned": pinned, "local": ft.local,
                     "built": ft.built}
    return out


def _fail_case(case, rank):
    """(c) the hierarchical candidate fails on rank 1 alone, in its build,
    then in a timed round; rank 0's clock would pick it."""
    out = {}
    for where in ("build", "train"):
        cfg = {**MLP, "num_devices": WORLD, "autotune": "reassociating",
               "autotune_cache_dir": os.path.join(case["dir"], f"c-{where}")}
        fail = (HIER_ID, where) if rank == 1 else None
        with warnings.catch_warnings(record=True) as caught, \
                _FakeTiming(lambda p: 0.25 if p.collective == "hier"
                            else 0.5, fail=fail) as ft:
            warnings.simplefilter("always")
            run = _tuned(cfg, rounds=1)
        out[where] = {"run": run, "local": ft.local, "built": ft.built,
                      "warned": [str(w.message) for w in caught
                                 if HIER_ID in str(w.message)]}
    return out


def _resume_case(case, rank):
    """An autotuned trial through ``run_experiments`` on the ranks,
    checkpointed each round and stopped after round 2, then resumed to
    round 3: the resume pins the checkpoint's plan on every rank.  Then
    a ``tuned_plan`` that differs across ranks: every rank raises."""
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.tune import run_experiments

    root = os.path.join(case["dir"], "resume")
    out = {}
    for stop, resume in ((2, False), (3, True)):
        exps = {"tuned": {"run": "FEDAVG", "stop": {"training_iteration":
                                                     stop},
                          "config": {**MLP, "num_devices": WORLD,
                                     "autotune": "reassociating",
                                     "autotune_cache_dir": os.path.join(
                                         root, f"plans{rank}")}}}
        with _FakeTiming(lambda p: 0.25 if p.collective == "hier" else 0.5):
            summaries = run_experiments(
                exps, storage_path=root, device="cpu", checkpoint_freq=1,
                verbose=0, resume=resume)
        out[stop] = [s.get("autotune") for s in summaries]
    flat = {"execution": "dense", "d_chunk": 131072}
    pin = (flat if rank == 0 else
           {**flat, "mesh_shape": (2, 1), "collective": "hier",
            "tier": "reassociating"})
    try:
        FedavgConfig().update_from_dict(
            {**MLP, "num_devices": WORLD, "autotune": "reassociating",
             "tuned_plan": pin}).build(device="cpu")
        out["pin_error"] = None
    except RuntimeError as exc:
        out["pin_error"] = str(exc)
    return out


def _cache_case(case, rank):
    """(d) each rank its own cache directory: a measured run, then a second
    run of the same config."""
    cache_dir = os.path.join(case["dir"], f"d-rank{rank}")
    cfg = {**MLP, "num_devices": WORLD, "autotune": "reassociating",
           "autotune_cache_dir": cache_dir}
    with _FakeTiming(lambda p: 0.25 if p.collective == "hier" else 0.5):
        first = _tuned(cfg, rounds=1)
    files_after_first = sorted(os.listdir(cache_dir)) \
        if os.path.isdir(cache_dir) else []
    with _FakeTiming(lambda p: 1.0) as ft:
        second = _tuned(cfg, rounds=1)
    return {"first": first, "second": second, "built": ft.built,
            "files": files_after_first,
            "files_after": sorted(os.listdir(cache_dir))
            if os.path.isdir(cache_dir) else []}


def _cli_case(case, rank):
    """``train file --autotune reassociating`` with the process flags on
    the ranks (the group already joined, so the flags join nothing); the
    sweep's summaries kept on the way out."""
    import torch.distributed as dist

    import blades_tpu_torch.tune as tune
    from blades_tpu_torch import train

    yaml = os.path.join(case["dir"], "grid.yaml")
    if rank == 0:
        with open(yaml, "w") as fh:
            fh.write(GRID_YAML.format(world=WORLD))
    dist.barrier()
    real, kept = tune.run_experiments, []

    def keep(*a, **kw):
        kept.extend(real(*a, **kw))
        return kept

    tune.run_experiments = keep
    try:
        with _FakeTiming(lambda p: 0.25 if p.collective == "hier" else 0.5):
            rc = train.main([
                "file", yaml, "--max-rounds", "2", "--device", "cpu",
                "--autotune", "reassociating", "--plan-cache-dir",
                os.path.join(case["dir"], f"cli-plans{rank}"),
                "--coordinator", case["url"], "--num-processes", str(WORLD),
                "--process-id", str(rank), "--storage-path",
                os.path.join(case["dir"], "cli")])
    finally:
        tune.run_experiments = real
    return {"rc": rc, "autotune": [s.get("autotune") for s in kept]}


GRID_YAML = """\
autotune_mesh:
  run: FEDAVG
  stop:
    training_iteration: 2
  config:
    dataset_config:
      type: mnist
      num_clients: 8
      train_bs: 8
      seed: 3
    global_model: mlp
    num_devices: {world}
    num_malicious_clients: 2
    adversary_config:
      type: ALIE
    server_config:
      lr: 1.0
      aggregator:
        type: Median
    client_config:
      lr: 0.1
      num_batch_per_round: 1
"""

CASES = ["_space_case", "_decide_case", "_fail_case", "_cache_case",
         "_resume_case", "_cli_case"]


# ---------------------------------------------------------------------------
# the parent: references, tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("autotune_mesh")
    url = f"file://{tmp / 'cli-rendezvous'}"
    cases = [{"kind": f"test_torch_autotune_mesh:{name}", "dir": str(tmp),
              "url": url} for name in CASES]
    return start_ranks({"c2": (WORLD, cases)}, tmp), tmp


@pytest.fixture(scope="module")
def jax_spaces(launched):
    """JAX's plan spaces for the configs of (a), on 2 of the 8 CPU
    devices, computed while the ranks run."""
    from blades_tpu.algorithms import FedavgConfig as JaxConfig

    out = {}
    for name, extra in SPACE_CONFIGS.items():
        algo = JaxConfig().update_from_dict(
            {**MLP, "num_devices": WORLD, "mxu_finish": "", **extra}).build()
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for reassoc in (False, True):
                    space = algo._plan_space(allow_reassociating=reassoc)
                    out[name, reassoc] = [(p.plan_id, p.tier)
                                          for p in space.candidates]
        finally:
            algo.stop()
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_spaces):
    return launched[0].results()["c2"]


def _case(ranks, name):
    i = CASES.index(name)
    return [res[i] for res in ranks]


@pytest.mark.parametrize("reassoc", [False, True],
                         ids=["default", "reassociating"])
@pytest.mark.parametrize("name", sorted(SPACE_CONFIGS))
def test_plan_space_on_the_ranks_is_the_jax_drivers(ranks, jax_spaces, name,
                                                    reassoc):
    ours = _case(ranks, "_space_case")
    assert ours[0][name, reassoc] == ours[1][name, reassoc]
    assert ours[0][name, reassoc] == jax_spaces[name, reassoc]
    ids = [i for i, _ in ours[0][name, reassoc]]
    want_base = "|mesh=2x1" if name == "mesh-2x1" else "|nopre"
    assert ids[0].endswith(want_base) and not ids[0].endswith("|hier")
    assert (HIER_ID in ids) is reassoc
    assert not any(i.startswith("streamed") for i in ids)


def test_the_agreement_helpers(ranks):
    """``all_ranks_ok`` holds only where every rank's flag does, and
    ``broadcast_object`` hands rank 0's object to every rank; a recorder
    counts each under its label (one int64 psum, the pickled bytes)."""
    import pickle

    for r in _case(ranks, "_space_case"):
        assert r["ok"] is False and r["all_ok"] is True
        assert r["got"] == {"rank": 0}
        assert r["events"] == [
            ("ok", "psum", 8, WORLD),
            ("who", "broadcast", len(pickle.dumps({"rank": 0})), WORLD)]


@pytest.mark.parametrize("tier", ["on", "reassociating"])
def test_rank_0_decides_for_every_rank(ranks, tier):
    per_rank = [r[tier] for r in _case(ranks, "_decide_case")]
    t0, t1 = (r["tuned"] for r in per_rank)
    assert t0["plan"] == t1["plan"] and t0["prov"] == t1["prov"]
    prov = t0["prov"]
    assert prov["mode"] == "measured" and prov["timed"] is True
    # Every rank timed every candidate; rank 0's medians decided.
    ids = [c["plan_id"] for c in prov["candidates"]]
    for r in per_rank:
        assert r["built"] == ids
    assert [c["median_s"] for c in prov["candidates"]] == \
        [per_rank[0]["local"][i] for i in ids]
    local1 = per_rank[1]["local"]
    assert min(local1, key=local1.get) != prov["winner_id"]
    if tier == "reassociating":
        assert prov["winner_id"] == HIER_ID
    else:
        assert prov["winner_id"].endswith("|pre") and len(ids) == 2
    for r in (t0, t1):
        assert {row["plan_id"] for row in r["rows"]} == {prov["winner_id"]}
        assert all(row["autotune_timed"] is True
                   and row["autotune_candidates"] == len(ids)
                   and row["autotune_cache_hit"] is False
                   for row in r["rows"])


@pytest.mark.parametrize("tier", ["on", "reassociating"])
def test_a_tuned_run_equals_its_pinned_run(ranks, tier):
    for rank, res in enumerate(_case(ranks, "_decide_case")):
        tuned, pinned = res[tier]["tuned"], res[tier]["pinned"]
        assert pinned["prov"]["mode"] == "pinned"
        assert pinned["plan"] == tuned["plan"]
        for k, v in tuned["params"].items():
            assert torch.equal(v, pinned["params"][k]), (rank, k)
        keys = ("train_loss", "agg_norm", "update_norm_mean")
        assert [[r[k] for k in keys] for r in tuned["rows"]] == \
            [[r[k] for k in keys] for r in pinned["rows"]]
        hier = tier == "reassociating"
        assert tuned["hier"] is pinned["hier"] is hier
        assert all((r.get("mesh_shape") == "2x1") is hier
                   for r in tuned["rows"] + pinned["rows"])
    # The ranks hold the same replicated parameters.
    a, b = (res[tier]["tuned"]["params"]
            for res in _case(ranks, "_decide_case"))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("where", ["build", "train"])
def test_a_candidate_failing_on_one_rank_is_dropped_on_all(ranks, where):
    per_rank = [r[where] for r in _case(ranks, "_fail_case")]
    ids = per_rank[0]["built"]
    assert HIER_ID in ids
    for rank, r in enumerate(per_rank):
        assert r["built"] == ids  # the ranks went on together
        assert r["local"][HIER_ID] is None
        assert all(r["local"][i] is not None for i in ids if i != HIER_ID)
        prov = r["run"]["prov"]
        med = {c["plan_id"]: c["median_s"] for c in prov["candidates"]}
        assert med[HIER_ID] is None and prov["winner_id"] != HIER_ID
        assert r["warned"], rank
    assert "planted" in per_rank[1]["warned"][0]
    assert "on another rank" in per_rank[0]["warned"][0]
    assert per_rank[0]["run"]["plan"] == per_rank[1]["run"]["plan"]


def test_only_rank_0_reads_and_writes_the_plan_cache(ranks):
    r0, r1 = _case(ranks, "_cache_case")
    assert len(r0["files"]) == 1 and r0["files"][0].endswith(".json")
    assert r1["files"] == [] and r1["files_after"] == []
    assert r0["first"]["prov"]["mode"] == "measured"
    for r in (r0, r1):
        assert r["built"] == []  # no candidate built on the second run
        prov = r["second"]["prov"]
        assert prov["mode"] == "cache" and prov["cache_hit"] is True
        assert r["second"]["plan"] == r0["first"]["plan"]
        assert all(row["autotune_cache_hit"] is True
                   for row in r["second"]["rows"])
    assert r0["second"]["prov"] == r1["second"]["prov"]


def test_a_resumed_trial_pins_the_checkpointed_plan_on_every_rank(ranks):
    per_rank = _case(ranks, "_resume_case")
    first, resumed = ([r[stop] for r in per_rank] for stop in (2, 3))
    assert first[0] == first[1] and first[0][0]["winner_id"] == HIER_ID
    assert first[0][0]["mode"] == "measured"
    assert resumed[0] == resumed[1]
    assert resumed[0][0]["mode"] == "pinned"
    assert resumed[0][0]["winner_id"] == HIER_ID
    # A pin that differs across ranks is refused on every rank.
    for r in per_rank:
        assert "differs across ranks" in r["pin_error"]


def test_file_autotune_runs_on_the_ranks(ranks, launched):
    tmp = launched[1]
    assert [r["rc"] for r in _case(ranks, "_cli_case")] == [0, 0]
    found = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp / "cli")
             for f in fs if f == "result.json"]
    assert len(found) == 1
    with open(found[0]) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    assert [r["training_iteration"] for r in rows] == [1, 2]
    assert {r["plan_id"] for r in rows} == {HIER_ID}
    assert all(r["mesh_shape"] == "2x1" and r["autotune_timed"]
               for r in rows)
    # Every rank's summary carries rank 0's selection record.
    records = [r["autotune"] for r in _case(ranks, "_cli_case")]
    assert records[0] == records[1] and len(records[0]) == 1
    assert records[0][0]["winner_id"] == HIER_ID
    assert records[0][0]["mode"] == "measured"


# ---------------------------------------------------------------------------
# (f) the refusals, without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution", ["hier", "dsharded"])
def test_autotune_pins_are_refused_in_jax_words(execution):
    from blades_tpu.algorithms import FedavgConfig as JaxConfig
    from blades_tpu_torch.algorithms import FedavgConfig

    msgs = []
    for cls in (JaxConfig, FedavgConfig):
        cfg = cls().update_from_dict({
            **MLP, "num_devices": WORLD, "execution": execution,
            "autotune": "on"})
        with pytest.raises(ValueError, match=f"autotune × execution="
                           f"'{execution}' is an unsupported pair") as err:
            cfg.validate()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_auto_resolving_to_dsharded_is_refused_in_jax_words(monkeypatch):
    """Past the dense budget ``"auto"`` on a mesh resolves to the
    width-sharded round; the tuner refuses it before it touches the
    process group, with the JAX driver's words."""
    from blades_tpu.algorithms import FedavgConfig as JaxConfig
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.algorithms.fedavg import Fedavg

    jalgo = JaxConfig().update_from_dict(
        {**MLP, "num_devices": WORLD, "mxu_finish": ""}).build()
    try:
        monkeypatch.setattr(jalgo, "_dsharded_auto", lambda: True)
        with pytest.raises(ValueError, match="resolved-to-dsharded") as want:
            jalgo._plan_space(allow_reassociating=True)
    finally:
        jalgo.stop()
    monkeypatch.setattr(Fedavg, "_DENSE_MATRIX_LIMIT", 1024)
    cfg = FedavgConfig().update_from_dict(
        {**MLP, "num_devices": WORLD, "autotune": "reassociating"})
    with pytest.raises(ValueError, match="resolved-to-dsharded") as got:
        cfg.build(device="cpu")
    assert str(got.value) == str(want.value)
