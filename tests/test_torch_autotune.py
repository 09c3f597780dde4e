"""The port's execution autotuner (blades_tpu_torch/perf/autotune.py)
against the JAX package's (blades_tpu/perf/autotune.py), in one process.

- The pure parts are held equal, exactly: ``Plan`` validation and its dict
  round trip, ``plan_id``, ``enumerate_plans`` (ids, tiers, truncation),
  ``apply_plan`` and ``select_plan`` under one injected fake clock.
- The driver's plan space (``Fedavg._plan_space``) gives the JAX
  driver's candidates (JAX built with ``mxu_finish=""``: the port has no
  MXU route) for a coordinate-wise streamed config, a dense packable
  config and a wire-codec config.  One deviation: the port offers the
  ``d_chunk`` ladder only where its round takes the chunked finish (the
  fused kernel ignores ``d_chunk``); with that route forced the ladder is
  JAX's.
- Default-tier plans reproduce the untuned trajectory bit for bit (the
  heuristic winner, a pinned prefetch plan, the chunk ladder on the
  chunked finish), and the plan cache survives torn, garbage and stale
  entries by re-tuning.
- Sweep integration: provenance in rows and summaries, resume pins the
  checkpointed plan, scan windows write the round-per-dispatch rows, the
  CLI flags run, and the control plane's engine moves and a ``replan``
  follow the JAX driver's on identical row streams.
Every comparison is exact (tolerance zero) unless a test says otherwise.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from blades_tpu.algorithms import FedavgConfig as JaxConfig
from blades_tpu.perf import autotune as jat
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.perf import autotune as at
from blades_tpu_torch.perf.autotune import (
    PLAN_CACHE_VERSION,
    Plan,
    PlanCache,
    cache_key,
)

REPO = Path(__file__).resolve().parents[1]
AUTOTUNE_PY = REPO / "blades_tpu_torch" / "perf" / "autotune.py"
MNIST = {"dataset_config": {"type": "mnist", "num_clients": 6,
                            "train_bs": 8, "seed": 3},
         "global_model": "mlp", "evaluation_interval": 0,
         "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}}}
ALIE_MEDIAN = {**MNIST, "num_malicious_clients": 2,
               "adversary_config": {"type": "ALIE"},
               "server_config": {"lr": 1.0,
                                 "aggregator": {"type": "Median"}}}


def tiny(run=None, **extra):
    return FedavgConfig().update_from_dict({**(run or MNIST), **extra})


def _params(algo):
    return {k: v.detach().clone() for k, v in
            algo.state.server.params.items()}


def _run(cfg, rounds=3):
    algo = cfg.build(device="cpu")
    try:
        rows = [algo.train() for _ in range(rounds)]
        return rows, _params(algo), algo.plan, algo.plan_summary
    finally:
        algo.stop()


def _same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the pure parts, against the JAX module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"execution": "warp"}, {"mxu_finish": "sometimes"},
    {"tier": "experimental"}, {"d_chunk": 512}, {"client_packing": 0},
    {"rounds_per_dispatch": 0}, {"agg_domain": "int8"},
    {"state_store": "tape"}, {"state_window": -1},
    {"collective": "tree"}, {"collective": "hier"},
    {"mesh_shape": (2, 0)},
])
def test_plan_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jexc:
        jat.Plan(**kw)
    with pytest.raises(ValueError) as texc:
        Plan(**kw)
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("kw", [
    {}, {"prefetch": True}, {"execution": "streamed", "d_chunk": 1 << 16},
    {"execution": "streamed", "mxu_finish": "counts"},
    {"client_packing": 2, "tier": "reassociating"},
    {"rounds_per_dispatch": 4}, {"agg_domain": "wire",
                                 "tier": "reassociating"},
    {"state_store": "host", "state_window": 6, "tier": "reassociating"},
    {"mesh_shape": (4, 2), "collective": "hier", "tier": "reassociating"},
])
def test_plan_ids_and_dict_round_trip_match_jax(kw):
    p, jp = Plan(**kw), jat.Plan(**kw)
    assert p.plan_id == jp.plan_id
    assert p.as_dict() == jp.as_dict()
    assert Plan.from_dict(json.loads(json.dumps(p.as_dict()))) == p
    with pytest.raises(ValueError, match="unknown plan fields"):
        Plan.from_dict({**p.as_dict(), "warp_factor": 9})
    with pytest.raises(ValueError, match="dict"):
        Plan.from_dict("dense")


ENUMERATIONS = [
    dict(executions=["dense"], d_chunks=[1 << 17],
         prefetch_options=[False, True]),
    dict(executions=["streamed", "dense"], d_chunks=[1 << 17, 1 << 16],
         mxu_modes=["", "counts", "all"], pack_factors=[1, 2]),
    dict(executions=["dense", "streamed"], d_chunks=[1 << 17],
         pack_factors=[1, 2, 4], scan_windows=[4, 2, 1],
         prefetch_options=[True, False], agg_domains=["f32", "wire"]),
    dict(executions=["dense"], d_chunks=[1 << 17],
         prefetch_options=[False, False, True]),
    dict(executions=["streamed"], d_chunks=list(jat.D_CHUNK_LADDER),
         mxu_modes=["", "counts"], max_candidates=4),
    dict(executions=["dense"], d_chunks=[1 << 17],
         state_stores=["resident", "host"], state_windows=[6]),
    dict(executions=["dense"], d_chunks=[1 << 17],
         mesh_shapes=[None, (4, 2)], collectives=["ring", "hier"],
         num_devices=8),
]


@pytest.mark.parametrize("reassoc", [False, True])
@pytest.mark.parametrize("i", range(len(ENUMERATIONS)))
def test_enumerate_plans_matches_jax(i, reassoc):
    kw = dict(ENUMERATIONS[i], allow_reassociating=reassoc)
    space, jspace = at.enumerate_plans(**kw), jat.enumerate_plans(**kw)
    assert [(p.plan_id, p.tier) for p in space.candidates] == \
        [(p.plan_id, p.tier) for p in jspace.candidates]
    assert space.truncated == jspace.truncated
    assert space.baseline.as_dict() == jspace.baseline.as_dict()
    if not reassoc:
        assert all(p.tier == "default" for p in space.candidates)


def test_enumerate_refuses_what_jax_refuses():
    for kw in (dict(executions=[], d_chunks=[1 << 17]),
               dict(executions=["dense"], d_chunks=[]),
               dict(executions=["dense"], d_chunks=[1 << 17],
                    mesh_shapes=[(2, 2)]),
               dict(executions=["dense"], d_chunks=[1 << 17],
                    mesh_shapes=[(2, 2)], num_devices=8)):
        with pytest.raises(ValueError) as jexc:
            jat.enumerate_plans(**kw)
        with pytest.raises(ValueError) as texc:
            at.enumerate_plans(**kw)
        assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("kw,rpd", [
    ({"execution": "streamed", "d_chunk": 1 << 16}, 1),
    ({"rounds_per_dispatch": 4, "client_packing": 2}, 1),
    ({"rounds_per_dispatch": 4}, 4),
    ({"prefetch": True}, 1),
    ({"agg_domain": "wire", "tier": "reassociating"}, 1),
    ({"state_store": "host", "state_window": 6,
      "tier": "reassociating"}, 1),
])
def test_apply_plan_sets_the_jax_fields(kw, rpd):
    fields = ("execution", "d_chunk", "client_packing", "mxu_finish",
              "rounds_per_dispatch", "chained_dispatch", "prefetch",
              "agg_domain", "state_store", "state_window")
    cfg = tiny(rounds_per_dispatch=rpd)
    jcfg = JaxConfig().update_from_dict({**MNIST,
                                         "rounds_per_dispatch": rpd})
    at.apply_plan(cfg, Plan(**kw))
    jat.apply_plan(jcfg, jat.Plan(**kw))
    assert {f: getattr(cfg, f) for f in fields} == \
        {f: getattr(jcfg, f) for f in fields}


@pytest.mark.parametrize("times", [
    {False: 0.5, True: 0.2}, {False: 0.3, True: 0.3},
    {False: None, True: None}, {False: None, True: 0.7},
])
def test_select_plan_with_a_fake_clock_matches_jax(times):
    kw = dict(executions=["dense"], d_chunks=[1 << 17],
              prefetch_options=[False, True])
    space, jspace = at.enumerate_plans(**kw), jat.enumerate_plans(**kw)
    plan, prov = at.select_plan(space, measure_fn=lambda p: times[p.prefetch])
    jplan, jprov = jat.select_plan(jspace,
                                   measure_fn=lambda p: times[p.prefetch])
    assert plan.as_dict() == jplan.as_dict()
    assert set(prov) == set(jprov)
    assert prov == jprov
    plan, prov = at.select_plan(space)
    jplan, jprov = jat.select_plan(jspace)
    assert prov == jprov and prov["mode"] == "heuristic"


def test_timed_measure_fn_under_an_injected_clock():
    """Warm-up dispatches are not timed, the median of the reps is
    reported per FL round, a candidate that fails outside a kernel is
    ranked out loudly, and each candidate is stopped before the next is
    built."""
    ticks = iter(range(1000))
    built, stopped = [], []

    class FakeAlgo:
        def __init__(self, cand):
            built.append(cand)

        def train(self):
            pass

        def stop(self):
            stopped.append(len(built))

    cfg = tiny()
    cfg.validate()
    measure = at.timed_measure_fn(cfg, warmup=1, reps=3,
                                  clock=lambda: float(next(ticks)),
                                  build=FakeAlgo, device="cpu")
    assert measure(Plan()) == 1.0
    assert measure(Plan(rounds_per_dispatch=4)) == 0.25
    assert stopped == [1, 2]
    assert built[0].autotune is False and built[0].tuned_plan is None
    assert built[1].rounds_per_dispatch == 4

    def broken(cand):
        raise RuntimeError("out of memory")

    bad = at.timed_measure_fn(cfg, clock=lambda: 0.0, build=broken,
                              device="cpu")
    with pytest.warns(RuntimeWarning, match="out of memory"):
        assert bad(Plan()) is None
    with pytest.raises(ValueError, match="warmup"):
        at.timed_measure_fn(cfg, warmup=-1)


def test_a_kernel_failure_in_a_candidate_propagates():
    """A failure raised in ``ops/_cuda.py`` (a kernel that does not build
    or launch) is not ranked out: it would hide the kernel behind a plan
    that avoids it.  The candidate is still stopped."""
    from blades_tpu_torch.ops import _cuda

    stopped = []

    class KernelAlgo:
        def __init__(self, cand):
            pass

        def train(self):
            # The wrapper's own refusal, raised inside ops/_cuda.py.
            _cuda.launch_finish("fused_finish", torch.zeros((2, 4)))

        def stop(self):
            stopped.append(True)

    cfg = tiny()
    cfg.validate()
    measure = at.timed_measure_fn(cfg, clock=lambda: 0.0, build=KernelAlgo,
                                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="needs a CUDA tensor") as err:
            measure(Plan())
    assert _cuda.raised_in_kernel(err.value)
    assert stopped == [True]
    assert not _cuda.raised_in_kernel(RuntimeError("out of memory"))


def test_timing_is_available_only_on_the_card(monkeypatch):
    assert at.timing_available("cpu") is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert at.timing_available("cuda") is True
    assert at.timing_available("cpu") is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert at.timing_available("cuda") is False


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------


def _key(tier="default", kind="cpu"):
    return cache_key("fp-abc", tier=tier, device_kind=kind,
                     torch_version="0.0-test", cuda_version="12.test")


def test_cache_key_names_the_card_and_the_torch_build(monkeypatch):
    key = cache_key("fp")
    assert set(key) == {"fingerprint", "tier", "device_kind", "torch",
                        "cuda"}
    assert key["device_kind"] == "cpu" and key["torch"] == torch.__version__
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert cache_key("fp")["device_kind"] == "NVIDIA H100 80GB HBM3"


def test_the_default_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(at.ENV_CACHE_DIR, raising=False)
    assert PlanCache().dir == Path("~/.cache/blades_tpu_torch/plans"
                                   ).expanduser()
    assert PlanCache().dir != PlanCache(jat._DEFAULT_CACHE_DIR).dir
    monkeypatch.setenv(at.ENV_CACHE_DIR, str(tmp_path))
    assert PlanCache().dir == tmp_path
    assert at.ENV_CACHE_DIR != jat.ENV_CACHE_DIR


def test_cache_round_trip_and_key_scoping(tmp_path):
    cache = PlanCache(tmp_path)
    key = _key()
    assert cache.get(key) is None
    path = cache.put(key, Plan(prefetch=True), {"mode": "measured"})
    assert path is not None and Path(path).is_file()
    entry = cache.get(key)
    assert Plan.from_dict(entry["plan"]) == Plan(prefetch=True)
    assert entry["provenance"]["mode"] == "measured"
    assert cache.get(_key(tier="reassociating")) is None
    assert cache.get(_key(kind="NVIDIA H100 80GB HBM3")) is None


def test_cache_deletes_an_orphaned_tmp(tmp_path):
    cache = PlanCache(tmp_path)
    key = _key()
    tmp = cache._path(key).with_name(cache._path(key).name + ".tmp")
    tmp.parent.mkdir(parents=True, exist_ok=True)
    tmp.write_text('{"half": "written')
    assert cache.get(key) is None and not tmp.exists()
    cache.put(key, Plan())
    tmp.write_text("garbage")
    assert cache.get(key) is not None and not tmp.exists()


@pytest.mark.parametrize("poison", [
    "not json at all {{{",
    json.dumps(["a", "list"]),
    json.dumps({"version": PLAN_CACHE_VERSION + 1, "key": {},
                "plan": Plan().as_dict()}),
    json.dumps({"version": PLAN_CACHE_VERSION, "key": {},
                "plan": {"execution": "warp"}}),
    json.dumps({"version": PLAN_CACHE_VERSION, "key": {"other": "key"},
                "plan": Plan().as_dict()}),
])
def test_torn_garbage_and_stale_entries_retune(tmp_path, poison):
    cache = PlanCache(tmp_path)
    key = _key()
    cache._path(key).parent.mkdir(parents=True, exist_ok=True)
    cache._path(key).write_text(poison)
    assert cache.get(key) is None
    cache.put(key, Plan(prefetch=True))
    assert Plan.from_dict(cache.get(key)["plan"]).prefetch is True


def test_a_poisoned_entry_retunes_the_driver(tmp_path):
    """A garbage file in the driver's slot is a miss: the build re-tunes
    (heuristic on the CPU), overwrites it and the next build hits."""
    cfg = tiny(autotune=True, autotune_cache_dir=str(tmp_path))
    algo = cfg.build(device="cpu")
    ((digest, _),) = PlanCache(tmp_path).entries()
    algo.stop()
    (tmp_path / f"{digest}.json").write_text("torn {")
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    assert algo.plan_summary["mode"] == "heuristic"
    algo.stop()
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    assert algo.plan_summary["cache_hit"] is True
    algo.stop()


def test_cache_entries_surface_corruption_and_invalidate(tmp_path):
    cache = PlanCache(tmp_path)
    key = _key()
    cache.put(key, Plan())
    (tmp_path / "deadbeef.json").write_text("torn")
    entries = dict(cache.entries())
    assert entries["deadbeef"] is None
    assert entries[PlanCache.digest(key)] is not None
    assert cache.invalidate("deadbeef") == ["deadbeef.json"]
    assert cache.invalidate() == [f"{PlanCache.digest(key)}.json"]
    assert cache.entries() == []


def test_cache_hit_across_processes(tmp_path):
    """The module loads standalone (stdlib at module level) in another
    interpreter and serves the entry written here."""
    PlanCache(tmp_path).put(_key(), Plan(prefetch=True), {"mode": "x"})
    script = f"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("at_sub", {str(AUTOTUNE_PY)!r})
at = importlib.util.module_from_spec(spec)
sys.modules["at_sub"] = at
spec.loader.exec_module(at)
key = at.cache_key("fp-abc", tier="default", device_kind="cpu",
                   torch_version="0.0-test", cuda_version="12.test")
entry = at.PlanCache({str(tmp_path)!r}).get(key)
assert entry is not None, "cross-process miss"
print(json.dumps(entry["plan"]))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert Plan.from_dict(json.loads(out.stdout)) == Plan(prefetch=True)


def test_show_plan_lists_shows_and_invalidates(tmp_path, capsys):
    from blades_tpu_torch.tools.show_plan import main as show_plan

    cache = PlanCache(tmp_path)
    key = _key(kind="NVIDIA H100 80GB HBM3")
    cache.put(key, Plan(prefetch=True),
              {"mode": "measured", "winner_id": Plan(prefetch=True).plan_id})
    (tmp_path / "deadbeef.json").write_text("torn")
    digest = PlanCache.digest(key)
    assert show_plan(["--cache-dir", str(tmp_path)]) == 0
    listing = capsys.readouterr().out
    assert digest[:12] in listing and "CORRUPT/STALE" in listing
    assert Plan(prefetch=True).plan_id in listing
    assert "H100" in listing and "torch=0.0-test" in listing
    assert show_plan(["--cache-dir", str(tmp_path), "show", digest[:8]]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert Plan.from_dict(shown["plan"]) == Plan(prefetch=True)
    assert show_plan(["--cache-dir", str(tmp_path), "invalidate",
                      digest[:8]]) == 0
    capsys.readouterr()
    assert show_plan(["--cache-dir", str(tmp_path), "show", digest[:8]]) == 1
    assert show_plan(["--cache-dir", str(tmp_path), "invalidate"]) == 2
    assert show_plan(["--cache-dir", str(tmp_path), "invalidate",
                      "--all"]) == 0
    assert cache.entries() == []
    out = subprocess.run(
        [sys.executable, "-m", "blades_tpu_torch.tools.show_plan",
         "--cache-dir", str(tmp_path), "list"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "empty" in out.stdout


# ---------------------------------------------------------------------------
# the config surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [True, 1, "on", "default", False, None, 0,
                                   "off", "", "reassociating"])
def test_autotune_mode_normalizes_as_jax(value):
    cfg, jcfg = tiny(), JaxConfig()
    cfg.autotune = jcfg.autotune = value
    assert cfg.autotune_mode == jcfg.autotune_mode


@pytest.mark.parametrize("extra,match", [
    ({"autotune": "sometimes"}, "autotune must be"),
    ({"tuned_plan": {"execution": "warp"}}, "plan execution"),
    ({"tuned_plan": {"warp": 1}}, "unknown plan fields"),
    ({"mxu_finish": "sometimes"}, "mxu_finish must be"),
])
def test_bad_autotune_settings_raise_the_jax_error(extra, match):
    with pytest.raises(ValueError, match=match) as jexc:
        JaxConfig().update_from_dict({**MNIST, **extra}).validate()
    with pytest.raises(ValueError, match=match) as texc:
        tiny(**extra).validate()
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("extra", [
    {"mxu_finish": "counts"}, {"mxu_finish": "all"},
    {"tuned_plan": {"execution": "streamed", "mxu_finish": "counts"}},
    {"autotune": True, "tuned_plan": {"execution": "streamed",
                                      "mxu_finish": "all",
                                      "tier": "reassociating"}},
])
def test_the_mxu_finishes_are_refused_by_name(extra):
    JaxConfig().update_from_dict({**MNIST, **extra}).validate()
    with pytest.raises(ValueError, match="no MXU route"):
        tiny(**extra).validate()


@pytest.mark.parametrize("extra", [
    {"donate_buffers": True}, {"donate_buffers": False},
    {"mxu_finish": ""}, {"mxu_finish": None}, {"autotune": "off"},
    {"autotune": True, "autotune_cache_dir": "/nonexistent/plans"},
    {"tuned_plan": Plan(prefetch=True).as_dict()},
])
def test_accepted_values_build_and_train(extra, tmp_path):
    if "autotune_cache_dir" in extra:
        extra = {**extra, "autotune_cache_dir": str(tmp_path / "p")}
    rows, params, _, _ = _run(tiny(**extra), rounds=1)
    assert np.isfinite(rows[0]["train_loss"])


@pytest.mark.parametrize("extra", [
    {"execution": "async", "async_config": {"rate": 0.5, "agg_every": 3}},
    {"execution": "gossip"},
])
def test_autotune_with_async_or_gossip_raises_the_jax_error(extra):
    run = {**MNIST, **extra, "autotune": True}
    with pytest.raises(ValueError) as jexc:
        JaxConfig().update_from_dict(run).validate()
    with pytest.raises(ValueError) as texc:
        FedavgConfig().update_from_dict(run).validate()
    def norm(e):
        return str(e.value).replace("×", "x").replace("—", "--")

    assert norm(texc) == norm(jexc)


# ---------------------------------------------------------------------------
# the driver's plan space, against the JAX driver's
# ---------------------------------------------------------------------------

SPACES = {
    "streamed-coordwise": ({**ALIE_MEDIAN, "execution": "streamed",
                            "client_block": 2}, False),
    "dense-default": (ALIE_MEDIAN, False),
    "dense-packable": ({"dataset_config": {"type": "fashionmnist",
                                           "num_clients": 4,
                                           "train_bs": 8},
                        "global_model": "cnn", "evaluation_interval": 0,
                        "server_config": {"aggregator": {"type": "Median"}}},
                       True),
    "wire-codec": ({**ALIE_MEDIAN,
                    "codec_config": {"type": "quant", "bits": 8}}, True),
    "auto-reassociating": (ALIE_MEDIAN, True),
}


def _spaces(run, reassoc):
    jalgo = JaxConfig().update_from_dict({**run, "mxu_finish": ""}).build()
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jspace = jalgo._plan_space(allow_reassociating=reassoc)
            space = algo._plan_space(allow_reassociating=reassoc)
        return ([(p.plan_id, p.tier) for p in space.candidates],
                [(p.plan_id, p.tier) for p in jspace.candidates],
                algo._takes_chunked_finish())
    finally:
        jalgo.stop()
        algo.stop()


@pytest.mark.parametrize("name", sorted(SPACES))
def test_plan_space_is_the_jax_drivers(name):
    run, reassoc = SPACES[name]
    ours, theirs, chunked = _spaces(run, reassoc)
    if chunked:
        assert ours == theirs
    else:
        # The route gate: the fused finish ignores d_chunk, so the port
        # offers the configured width alone.
        want = [(i, t) for i, t in theirs if "|c131072|" in i]
        assert ours == want
    assert ours and ours[0][1] == "default"


def test_the_chunk_ladder_is_the_jax_drivers_on_the_chunked_finish(
        monkeypatch):
    from blades_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "finish_fits", lambda dtype, rows: False)
    ours, theirs, chunked = _spaces(SPACES["streamed-coordwise"][0], False)
    assert chunked and ours == theirs
    assert {i.split("|")[1] for i, _ in ours} == {"c65536", "c131072",
                                                  "c262144"}


# ---------------------------------------------------------------------------
# default-tier plans are the untuned trajectory, bit for bit
# ---------------------------------------------------------------------------


def test_heuristic_selection_is_the_untuned_resolution(tmp_path):
    cfg = tiny(ALIE_MEDIAN, autotune=True, autotune_cache_dir=str(tmp_path))
    algo = cfg.build(device="cpu")
    prov = algo.plan_summary
    assert prov["mode"] == "heuristic" and prov["cache_hit"] is False
    assert algo.plan.execution == "dense" and algo.plan.tier == "default"
    assert prov["candidates"][0]["plan_id"] == algo.plan.plan_id
    algo.stop()
    algo2 = tiny(ALIE_MEDIAN, autotune=True,
                 autotune_cache_dir=str(tmp_path)).build(device="cpu")
    assert algo2.plan == algo.plan
    assert algo2.plan_summary["mode"] == "cache"
    row = algo2.train()
    assert row["plan_id"] == algo2.plan.plan_id
    assert row["autotune_cache_hit"] is True
    assert row["autotune_timed"] is False
    assert row["autotune_candidates"] == len(prov["candidates"])
    algo2.stop()


@pytest.mark.parametrize("run", [MNIST, ALIE_MEDIAN], ids=["mean", "alie"])
def test_heuristic_autotuned_rounds_equal_untuned_rounds(run, tmp_path):
    rows0, p0, _, _ = _run(tiny(run))
    rows1, p1, plan, prov = _run(tiny(run, autotune=True,
                                      autotune_cache_dir=str(tmp_path)))
    assert prov["mode"] == "heuristic"
    _same_params(p0, p1)
    assert [r["train_loss"] for r in rows0] == \
        [r["train_loss"] for r in rows1]


def test_a_pinned_prefetch_plan_is_bit_identical(tmp_path):
    rows0, p0, _, _ = _run(tiny(ALIE_MEDIAN))
    cfg = tiny(ALIE_MEDIAN, autotune=True,
               tuned_plan=Plan(prefetch=True).as_dict(),
               autotune_cache_dir=str(tmp_path))
    algo = cfg.build(device="cpu")
    assert algo.plan_summary["mode"] == "pinned"
    assert algo._prefetcher is not None
    rows1 = [algo.train() for _ in range(3)]
    _same_params(p0, _params(algo))
    algo.stop()
    assert [r["train_loss"] for r in rows0] == \
        [r["train_loss"] for r in rows1]


@pytest.mark.parametrize("aggregator,forge,dtype", [
    ("Median", "ALIE", "float32"), ("Trimmedmean", "ALIE", "float32"),
    ("Mean", "ALIE", "float32"), ("Median", "IPM", "float32"),
    ("Mean", "IPM", "float32"), ("Median", "ALIE", "bfloat16"),
])
def test_the_chunk_ladder_is_bit_identical_on_the_chunked_finish(
        monkeypatch, tmp_path, aggregator, forge, dtype):
    """A default-tier plan moving ``d_chunk`` off the baseline on the
    chunked finish (forced here: the MLP's rows fit the fused kernel)
    trains the untuned streamed rounds bit for bit, parameters and row
    metrics, f32 storage and the rung wider than the model (one chunk)
    included: the statistics come from ``STAT_WIDTH``-wide column slices
    whatever the chunk, the row norms from the model's ``STAT_WIDTH``
    blocks."""
    from blades_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "finish_fits", lambda dtype, rows: False)
    run = {**ALIE_MEDIAN, "execution": "streamed", "client_block": 2,
           "update_dtype": dtype, "adversary_config": {"type": forge},
           "server_config": {"lr": 1.0, "aggregator": {"type": aggregator}}}
    rows0, p0, _, _ = _run(tiny(run), rounds=1)
    for c in (1 << 16, 1 << 18):
        cfg = tiny(run, autotune=True,
                   tuned_plan=Plan(execution="streamed",
                                   d_chunk=c).as_dict(),
                   autotune_cache_dir=str(tmp_path))
        rows1, p1, plan, _ = _run(cfg, rounds=1)
        assert plan.d_chunk == c
        _same_params(p0, p1)
        for key in ("train_loss", "update_norm_mean", "agg_norm"):
            assert [r[key] for r in rows0] == [r[key] for r in rows1], key


@pytest.mark.parametrize("c,want", [
    (1000, [(0, 1000)]), (1 << 16, [(0, 1 << 16)]),
    (1 << 17, [(0, 1 << 16), (1 << 16, 1 << 16)]),
    (135946, [(0, 1 << 16), (1 << 16, 1 << 16), (135946 - (1 << 16),
                                                  1 << 16)]),
])
def test_statistics_slices_are_full_width_and_cover_the_chunk(c, want):
    from blades_tpu_torch.parallel.streamed import STAT_WIDTH, stat_slices

    assert stat_slices(c) == want
    covered = set()
    for a, w in stat_slices(c):
        assert w == min(c, STAT_WIDTH)
        covered.update(range(a, a + w))
    assert covered == set(range(c))


def test_explicit_knobs_are_never_varied(tmp_path):
    algo = tiny(prefetch="off", autotune=True,
                autotune_cache_dir=str(tmp_path)).build(device="cpu")
    assert "prefetch" in algo.config._explicit
    assert len(algo.plan_summary["candidates"]) == 1
    assert algo.plan.prefetch is False
    algo.stop()
    algo = tiny(autotune="reassociating", client_packing="off",
                autotune_cache_dir=str(tmp_path / "r")).build(device="cpu")
    assert all("|p1|" in c["plan_id"]
               for c in algo.plan_summary["candidates"])
    algo.stop()


def test_a_stale_cached_window_plan_retunes(tmp_path):
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    valid = algo.plan
    algo.stop()
    cache = PlanCache(tmp_path)
    for _, entry in cache.entries():
        cache.put(entry["key"], Plan(rounds_per_dispatch=8),
                  {"mode": "measured"})
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    assert algo.plan == valid
    assert algo.plan_summary["cache_stale"] is True
    assert algo.config.rounds_per_dispatch == 1
    algo.stop()
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    assert algo.plan_summary["cache_hit"] is True
    algo.stop()


def test_the_measured_path_picks_the_fastest_and_caches_it(tmp_path,
                                                           monkeypatch):
    fake = {False: 0.9, True: 0.4}
    monkeypatch.setattr(at, "timing_available", lambda device=None: True)
    monkeypatch.setattr(at, "timed_measure_fn",
                        lambda config, **kw: (lambda p: fake[p.prefetch]))
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    assert algo.plan.prefetch is True
    prov = algo.plan_summary
    assert prov["mode"] == "measured" and prov["timed"] is True
    assert [c["median_s"] for c in prov["candidates"]] == [0.9, 0.4]
    assert algo.train()["autotune_timed"] is True
    algo.stop()
    monkeypatch.undo()
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    assert algo.plan.prefetch is True and algo.plan_summary["mode"] == "cache"
    algo.stop()


def test_lanes_gate_reads_the_normalized_mode():
    from blades_tpu.tune.sweep import _lanes_eligible as jax_eligible
    from blades_tpu_torch.tune.sweep import _lanes_eligible

    trial = {"dataset_config": {"type": "mnist", "num_clients": 6,
                                "train_bs": 8, "seed": 3},
             "global_model": "mlp", "server_config": {"lr": 1.0},
             "autotune": "off"}
    for value, want in (("off", True), ("on", False),
                        ("reassociating", False)):
        t = {**trial, "autotune": value}
        assert _lanes_eligible("FEDAVG", t, [0, 1], device="cpu") is want
        assert jax_eligible("FEDAVG", t, [0, 1]) is want


# ---------------------------------------------------------------------------
# the sweep: provenance, resume, scan windows, the CLI
# ---------------------------------------------------------------------------


def _experiments(rounds=4, **extra):
    return {"at": {"run": "FEDAVG", "stop": {"training_iteration": rounds},
                   "config": {"dataset_config": {"type": "mnist",
                                                 "num_clients": 6,
                                                 "train_bs": 8, "seed": 3},
                              "global_model": "mlp",
                              "evaluation_interval": 2,
                              "server_config": {"lr": 1.0}, **extra}}}


def _rows(tdir, name="metrics.jsonl"):
    return [json.loads(x) for x in (tdir / name).read_text().splitlines()]


def test_sweep_autotune_provenance_and_schema(tmp_path):
    from blades_tpu_torch.obs import validate_jsonl
    from blades_tpu_torch.tune import run_experiments

    kw = dict(verbose=0, autotune=True, device="cpu",
              plan_cache_dir=str(tmp_path / "plans"), cost_analysis=False)
    (s,) = run_experiments(_experiments(),
                           storage_path=str(tmp_path / "a"), **kw)
    assert "status" not in s
    prov = s["autotune"]
    assert prov["mode"] == "heuristic" and prov["cache_hit"] is False
    # The sweep handed the space its windows: 4, 2 and 1 (eval every 2).
    ids = [c["plan_id"] for c in prov["candidates"]]
    assert any("|w2|" in i for i in ids) and any("|w1|" in i for i in ids)
    tdir = tmp_path / "a" / "at" / "at_00000"
    num, errors = validate_jsonl(tdir / "metrics.jsonl")
    assert errors == [] and num == 4
    assert all(r["plan_id"] == prov["winner_id"] for r in _rows(tdir))
    (s2,) = run_experiments(_experiments(),
                            storage_path=str(tmp_path / "b"), **kw)
    assert s2["autotune"]["mode"] == "cache"
    assert s2["autotune"]["cache_hit"] is True


def test_a_resumed_trial_pins_the_checkpointed_plan(tmp_path):
    from blades_tpu_torch.tune import run_experiments, verify_result_rounds

    plans = tmp_path / "plans"
    kw = dict(verbose=0, autotune=True, device="cpu",
              plan_cache_dir=str(plans), checkpoint_freq=2,
              cost_analysis=False)
    (first,) = run_experiments(_experiments(rounds=8),
                               storage_path=str(tmp_path / "s"),
                               preempt_after=5, **kw)
    assert first.get("status") == "ERROR"
    tdir = tmp_path / "s" / "at" / "at_00000"
    saved = torch.load(sorted(tdir.glob("ckpt_*"))[-1]
                       / "algorithm_state.pkl", weights_only=False)["plan"]
    assert saved is not None and Plan.from_dict(saved).tier == "default"
    cache = PlanCache(plans)
    drifted = Plan(**{**saved, "prefetch": not saved["prefetch"]})
    for _, entry in cache.entries():
        cache.put(entry["key"], drifted, {"mode": "measured"})
    (s,) = run_experiments(_experiments(rounds=8),
                           storage_path=str(tmp_path / "s"), resume=True,
                           **kw)
    assert "status" not in s and s["rounds"] == 8
    assert s["autotune"]["mode"] == "pinned"
    assert s["autotune"]["winner"] == saved
    assert verify_result_rounds(tdir / "result.json") == list(range(1, 9))
    assert all(r["plan_id"] == Plan.from_dict(saved).plan_id
               for r in _rows(tdir))


def test_a_retried_trial_pins_the_checkpointed_plan(tmp_path):
    from blades_tpu_torch.tune import run_experiments, verify_result_rounds

    (s,) = run_experiments(
        _experiments(rounds=6), storage_path=str(tmp_path / "s"),
        verbose=0, autotune=True, device="cpu",
        plan_cache_dir=str(tmp_path / "plans"), checkpoint_freq=2,
        preempt_after=3, max_failures=1, retry_backoff_base=0.0,
        cost_analysis=False)
    assert "status" not in s
    assert s["autotune"]["mode"] == "pinned"
    tdir = tmp_path / "s" / "at" / "at_00000"
    assert verify_result_rounds(tdir / "result.json") == list(range(1, 7))


def test_direct_resume_warns_on_plan_drift(tmp_path):
    algo = tiny(autotune=True, autotune_cache_dir=str(tmp_path)).build(
        device="cpu")
    algo.train()
    algo.save_checkpoint(str(tmp_path / "ck"))
    pin = Plan(prefetch=not algo.plan.prefetch).as_dict()
    algo.stop()
    algo2 = tiny(autotune=True, tuned_plan=pin,
                 autotune_cache_dir=str(tmp_path)).build(device="cpu")
    with pytest.warns(RuntimeWarning, match="pin the saved plan"):
        algo2.load_checkpoint(str(tmp_path / "ck"))
    algo2.stop()


WINDOW_CONFIGS = [
    {},
    {"rounds_per_dispatch": 2},
    {"forensics": True},
    {"execution": "streamed"},
    {"execution": "gossip"},
    {"evaluation_interval": 3},
    {"state_window": 3},
]


@pytest.mark.parametrize("freq", [0, 4])
@pytest.mark.parametrize("rounds", [8, 6, 1])
@pytest.mark.parametrize("i", range(len(WINDOW_CONFIGS)))
def test_eligible_scan_windows_match_jax(i, rounds, freq):
    from blades_tpu.tune.sweep import _eligible_scan_windows as jax_windows
    from blades_tpu_torch.tune.sweep import _eligible_scan_windows

    run = {**MNIST, "evaluation_interval": 2, **WINDOW_CONFIGS[i]}
    cfg, jcfg = tiny(run), JaxConfig().update_from_dict(run)
    assert _eligible_scan_windows(cfg, rounds, freq) == \
        jax_windows(jcfg, rounds, freq)


def test_scan_windows_skip_control_trials():
    """``validate()`` refuses control with rounds_per_dispatch > 1, so a
    control trial offers no window (the JAX gate offers one and its
    build then raises)."""
    from blades_tpu_torch.tune.sweep import _eligible_scan_windows

    cfg = tiny(control_config={"quarantine_rounds": 0})
    assert _eligible_scan_windows(cfg, 8, 0) == (1,)


def test_scan_windows_write_the_round_per_dispatch_rows(tmp_path):
    from blades_tpu_torch.tune import run_experiments

    exp = _experiments(rounds=6, num_malicious_clients=2,
                       adversary_config={"type": "ALIE"}, ledger=True)
    drop = ("timers", "trial")
    out = {}
    for w in (1, "auto"):
        (s,) = run_experiments(exp, storage_path=str(tmp_path / str(w)),
                               verbose=0, device="cpu", scan_window=w,
                               cost_analysis=False)
        assert s.get("scan_window") == (None if w == 1 else 2)
        out[w] = [{k: v for k, v in r.items() if k not in drop}
                  for r in _rows(tmp_path / str(w) / "at" / "at_00000",
                                 "result.json")]
    assert [r["training_iteration"] for r in out["auto"]] == list(range(1, 7))
    assert out["auto"] == out[1]


@pytest.mark.parametrize("flags", [
    ["--autotune"], ["--autotune", "reassociating"],
    ["--autotune", "--plan-cache-dir", "{tmp}/plans"],
    ["--compile-cache", "{tmp}/kernels"], ["--scan-window", "2"],
    ["--no-cost-analysis"],
])
def test_the_perf_flags_run_through_file(tmp_path, flags):
    from blades_tpu_torch import train

    grid = tmp_path / "grid.yaml"
    grid.write_text(
        "at:\n  run: FEDAVG\n  stop:\n    training_iteration: 2\n"
        "  config:\n    dataset_config:\n      type: mnist\n"
        "      num_clients: 6\n      train_bs: 8\n"
        "    global_model: mlp\n    evaluation_interval: 2\n")
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    extra = ([] if "--plan-cache-dir" in flags
             else ["--plan-cache-dir", str(tmp_path / "p")])
    assert train.main(["file", str(grid), "--device", "cpu",
                       "--storage-path", str(tmp_path / "s"), *flags,
                       *extra]) == 0
    rows = _rows(tmp_path / "s" / "at" / "at_00000")
    assert [r["training_iteration"] for r in rows] == [1, 2]
    if "--autotune" in flags:
        assert all("plan_id" in r for r in rows)
    if "--plan-cache-dir" in flags:
        assert PlanCache(tmp_path / "plans").entries()


# ---------------------------------------------------------------------------
# the control plane's engine moves and the replan, against the JAX driver
# ---------------------------------------------------------------------------

CTL_MLP = {"dataset_config": {"type": "mnist", "num_clients": 12,
                              "train_bs": 8},
           "global_model": "mlp", "evaluation_interval": 2,
           "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
           "server_config": {"lr": 1.0,
                             "aggregator": {"type": "Trimmedmean"}}}
CTL_ASYNC = {**CTL_MLP, "execution": "async",
             "async_config": {"rate": 0.5, "agg_every": 6,
                              "buffer_capacity": 12},
             "forensics": True, "ledger": True,
             "control_config": {"cooldown_rounds": 1,
                                "quarantine_rounds": 2}}


def _control_rows(seed, n, rounds=30):
    """A row stream whose sensors trip the async rules (staleness
    runaway, ingest stall and collapse, FPR collapse, round-time
    regression), with the cohort each row diagnosed."""
    rng = np.random.default_rng(seed)
    for r in range(1, rounds + 1):
        ids = np.sort(rng.choice(n, size=6, replace=False))
        mask = (rng.random(6) > 0.4).astype(np.float32)
        yield {
            "training_iteration": r, "tick": 5 * r,
            "train_loss": float(rng.normal()),
            "agg_norm": float(rng.gamma(2.0)),
            "update_norm_mean": float(rng.gamma(2.0)
                                      * (30.0 if r % 13 == 0 else 1.0)),
            "staleness_max": int(rng.integers(0, 90)),
            "cycle_ticks": int(rng.integers(2, 6) * (9 if r % 7 == 0 else 1)),
            "updates_per_sec": float(rng.gamma(5.0)
                                     / (20.0 if r % 11 == 0 else 1.0)),
            "byz_fpr": float(rng.random()),
            "reputation_p50": float(1.0 / (1 + (r % 9 == 0) * 5)),
            "flagged_churn": int(rng.integers(0, 3)),
            "ledger_top_suspects": [int(c) for c in
                                    rng.choice(n, 3, replace=False)],
            "timers": {"training_step": {"total_s": 0.1 * r * (
                1 + (r >= 20) * 9), "mean_s": 0.1, "count": r}},
        }, {"benign_mask": mask}, ids


def _engine_view(algo):
    eng = algo._async
    if eng is None:
        return None
    return (int(eng.agg_every), int(eng.buffer.capacity),
            int(eng.weight_cutoff), sorted(int(c) for c in eng.quarantine))


def _drive_control(algo, rows):
    journal, views = [], []
    for row, lanes, ids in rows:
        row = json.loads(json.dumps(row))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            algo._control_round(row, lanes, ids)
        journal.append((row["watchdog_events"], row["control_actions"],
                        row["control_actions_total"],
                        row["quarantine_size"]))
        views.append(_engine_view(algo))
    return journal, views


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_engine_moves_follow_the_jax_driver(seed):
    rows = list(_control_rows(seed, 12))
    jalgo = JaxConfig().update_from_dict(CTL_ASYNC).build()
    algo = FedavgConfig().update_from_dict(CTL_ASYNC).build(device="cpu")
    try:
        jj, jv = _drive_control(jalgo, rows)
        tj, tv = _drive_control(algo, rows)
    finally:
        jalgo.stop()
        algo.stop()
    assert tj == jj
    assert tv == jv
    assert any(a for _, a, _, _ in tj)
    assert len(set(map(str, tv))) > 1  # the engine really moved
    assert algo.control_summary == jalgo.control_summary


def test_a_replan_reresolves_the_plan_as_the_jax_driver(tmp_path):
    run = {**CTL_MLP, "control_config": {"quarantine_rounds": 0},
           "autotune": True}
    rows = list(_control_rows(4, 12))
    jalgo = JaxConfig().update_from_dict(
        {**run, "mxu_finish": "", "autotune_cache_dir":
         str(tmp_path / "j")}).build()
    algo = FedavgConfig().update_from_dict(
        {**run, "autotune_cache_dir": str(tmp_path / "t")}).build(
            device="cpu")
    try:
        assert algo._controller.allow_replan is True
        assert jalgo._controller.allow_replan is True
        before = algo.plan
        jj, _ = _drive_control(jalgo, rows)
        tj, _ = _drive_control(algo, rows)
        acts = [a for _, day, _, _ in tj for a in day]
        assert any(a["actuator"] == "replan" for a in acts)
        assert tj == jj
        assert algo.plan_summary["mode"] == "replan"
        assert jalgo.plan_summary["mode"] == "replan"
        assert algo.plan == before
        assert algo.plan.plan_id == jalgo.plan.plan_id
        assert [c["plan_id"] for c in algo.plan_summary["candidates"]] == \
            [c["plan_id"] for c in jalgo.plan_summary["candidates"]]
        assert np.isfinite(algo.train()["train_loss"])
    finally:
        jalgo.stop()
        algo.stop()


def test_a_replan_that_changes_the_plan_rebuilds_the_pipeline(
        tmp_path, monkeypatch):
    """A replan whose measured winner differs (here: lane-packing, which
    the reassociating tier keeps offering after the first plan was
    written into the config) rebuilds the dense round under it."""
    run = {**CTL_MLP, "control_config": {"quarantine_rounds": 0},
           "autotune": "reassociating", "autotune_cache_dir": str(tmp_path)}
    algo = FedavgConfig().update_from_dict(run).build(device="cpu")
    assert algo.fed_round.packing is None
    rows0 = [algo.train() for _ in range(2)]
    monkeypatch.setattr(at, "timing_available", lambda device=None: True)
    monkeypatch.setattr(at, "timed_measure_fn", lambda config, **kw: (
        lambda p: 0.1 if p.client_packing == 2 else 0.9))
    algo._replan_runtime()
    assert algo.plan.client_packing == 2
    assert algo.fed_round.packing.pack == 2
    assert algo.plan_summary["mode"] == "replan"
    row = algo.train()
    assert row["plan_id"] == algo.plan.plan_id and row["pack_factor"] == 2
    assert row["training_iteration"] == rows0[-1]["training_iteration"] + 1
    assert np.isfinite(row["train_loss"])
    algo.stop()
