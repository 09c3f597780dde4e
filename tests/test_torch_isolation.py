"""The port stands alone: ``blades_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port's entry points run on the
card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
# The root ``tools`` package is the JAX package's tooling (its lint included).
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "blades_tpu", "tools"}


def _port_files():
    files = sorted((REPO / "blades_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_the_port():
    files = _port_files()
    assert len(files) > 30 and all(f.exists() for f in files)
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"blades_tpu_torch/algorithms/fedavg.py",
            "blades_tpu_torch/ops/bn_backward.py",
            "blades_tpu_torch/data/datasets.py",
            "blades_tpu_torch/train.py",
            "blades_tpu_torch/tune/sweep.py",
            "blades_tpu_torch/tune/yaml_subset.py",
            "blades_tpu_torch/faults/host.py",
            "blades_tpu_torch/faults/injector.py",
            "blades_tpu_torch/comm/codecs.py",
            "blades_tpu_torch/core/callbacks.py",
            "blades_tpu_torch/arrivals/engine.py",
            "blades_tpu_torch/arrivals/cycle.py",
            "blades_tpu_torch/arrivals/process.py",
            "blades_tpu_torch/state/store.py",
            "blades_tpu_torch/state/prefetch.py",
            "blades_tpu_torch/data/store.py",
            "blades_tpu_torch/data/stream.py",
            "blades_tpu_torch/adversaries/campaigns.py",
            "blades_tpu_torch/obs/schema.py",
            "blades_tpu_torch/obs/trace.py",
            "blades_tpu_torch/obs/ledger.py",
            "blades_tpu_torch/obs/forensics.py",
            "blades_tpu_torch/control/controller.py",
            "blades_tpu_torch/control/policy.py",
            "blades_tpu_torch/topology/graph.py",
            "blades_tpu_torch/topology/gossip.py",
            "blades_tpu_torch/adversaries/topology_attacks.py",
            "blades_tpu_torch/parallel/comm_model.py",
            "blades_tpu_torch/tools/replay_round.py",
            "blades_tpu_torch/tools/validate_metrics.py",
            "blades_tpu_torch/tools/ledger_report.py",
            "blades_tpu_torch/tools/control_report.py",
            "blades_tpu_torch/tune/lanes.py",
            "blades_tpu_torch/parallel/packed.py",
            "blades_tpu_torch/parallel/mesh.py",
            "blades_tpu_torch/parallel/sharded.py",
            "blades_tpu_torch/parallel/hier.py",
            "blades_tpu_torch/ops/preagg.py",
            "blades_tpu_torch/models/layers.py",
            "blades_tpu_torch/models/mlp.py",
            "blades_tpu_torch/models/cnn.py",
            "blades_tpu_torch/models/resnet.py",
            "blades_tpu_torch/perf/__init__.py",
            "blades_tpu_torch/perf/autotune.py",
            "blades_tpu_torch/perf/compile_cache.py",
            "blades_tpu_torch/data/prefetch.py",
            "blades_tpu_torch/utils/profiling.py",
            "blades_tpu_torch/tune/visualize.py",
            "blades_tpu_torch/benchmarks/__init__.py",
            "blades_tpu_torch/benchmarks/main.py",
            "blades_tpu_torch/benchmarks/accuracy_curves.py",
            "blades_tpu_torch/tools/show_plan.py",
            "blades_tpu_torch/tools/gossip_curves.py",
            "blades_tpu_torch/tools/check_tier1_budget.py",
            "blades_tpu_torch/tools/restamp_curves.py"} <= names
    lint = {str(f.relative_to(REPO)) for f in
            (REPO / "blades_tpu_torch" / "tools" / "lint").rglob("*.py")}
    assert {"blades_tpu_torch/tools/lint/core.py",
            "blades_tpu_torch/tools/lint/cli.py",
            "blades_tpu_torch/tools/lint/passes/host_sync.py",
            "blades_tpu_torch/tools/lint/passes/artifacts.py"} <= lint <= names
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, blades_tpu_torch, blades_tpu_torch.parallel.streamed, "
            "blades_tpu_torch.convert, blades_tpu_torch.algorithms, "
            "blades_tpu_torch.train, blades_tpu_torch.data.datasets, "
            "blades_tpu_torch.data.augment, blades_tpu_torch.models.cnn, "
            "blades_tpu_torch.ops.bn_backward, "
            "blades_tpu_torch.adversaries.training_attacks, "
            "blades_tpu_torch.tune.sweep, blades_tpu_torch.tune.yaml_subset, "
            "blades_tpu_torch.faults.host, blades_tpu_torch.core.callbacks, "
            "blades_tpu_torch.faults.injector, blades_tpu_torch.comm.codecs, "
            "blades_tpu_torch.arrivals, blades_tpu_torch.state, "
            "blades_tpu_torch.data.store, blades_tpu_torch.data.stream, "
            "blades_tpu_torch.adversaries.campaigns, blades_tpu_torch.obs, "
            "blades_tpu_torch.control, blades_tpu_torch.topology, "
            "blades_tpu_torch.parallel.comm_model, "
            "blades_tpu_torch.tools.replay_round, "
            "blades_tpu_torch.tools.validate_metrics, "
            "blades_tpu_torch.tools.ledger_report, "
            "blades_tpu_torch.tools.control_report, "
            "blades_tpu_torch.tune.lanes, blades_tpu_torch.parallel.packed, "
            "blades_tpu_torch.models.mlp, blades_tpu_torch.models.resnet, "
            "blades_tpu_torch.models.layers, blades_tpu_torch.perf, "
            "blades_tpu_torch.perf.autotune, "
            "blades_tpu_torch.perf.compile_cache, "
            "blades_tpu_torch.data.prefetch, "
            "blades_tpu_torch.utils.profiling, "
            "blades_tpu_torch.tune.visualize, blades_tpu_torch.benchmarks, "
            "blades_tpu_torch.benchmarks.main, "
            "blades_tpu_torch.benchmarks.accuracy_curves, "
            "blades_tpu_torch.tools.show_plan, "
            "blades_tpu_torch.tools.gossip_curves\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("argv", [
    ["blades_tpu_torch.tools.lint", "--list-passes"],
    ["blades_tpu_torch.tools.check_tier1_budget", "--help"],
    ["blades_tpu_torch.tools.restamp_curves", "--help"],
])
def test_the_port_tools_load_no_jax(argv):
    """The lint, the budget guard and the restamper run as ``python -m``
    entry points without loading JAX or the JAX package's tools."""
    code = ("import runpy, sys\n"
            f"sys.argv = {argv!r}\n"
            "try:\n"
            f"    runpy.run_module({argv[0]!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code in (0, None), e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, capture_output=True)


def test_no_module_level_pandas_or_matplotlib_import():
    """The card's machine has neither pandas nor matplotlib: no port
    module imports them at module level (a plot imports matplotlib inside
    the function that draws it, and skips where it is missing)."""
    bad = []
    for f in _port_files():
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            bad += [(str(f.relative_to(REPO)), n) for n in names
                    if n.split(".")[0] in ("pandas", "matplotlib",
                                           "seaborn")]
    assert not bad, bad


@pytest.mark.parametrize("module,argv", [
    ("blades_tpu_torch.benchmarks.main", ["--model", "mlp", "--dataset",
                                          "mnist", "--epochs", "1"]),
    ("blades_tpu_torch.benchmarks.accuracy_curves", ["--dataset", "mnist",
                                                     "--rounds", "1"]),
    ("blades_tpu_torch.tools.gossip_curves", ["--rounds", "1"]),
])
def test_new_entry_points_need_the_card_unless_cpu_is_asked(
        monkeypatch, tmp_path, module, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(module).main(argv)


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch):
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.parallel.streamed import streamed_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fr = FedRound(task=TaskSpec(model="mlp", input_shape=(4, 4, 1)).build(),
                  server=Server.from_config("Median"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fr.init(0, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streamed_step(fr, client_block=2)
    with pytest.raises(RuntimeError, match="CUDA is absent"):
        streamed_step(fr, client_block=2, device="cuda")
    state = fr.init(0, 4, device="cpu")
    assert state.server.params["Dense_0.weight"].device.type == "cpu"


def test_out_of_slice_configs_name_the_later_slice():
    """The autotuner on a mesh, once refused by name as a later slice,
    validates now, and the width-sharded round refuses one process with the
    JAX package's words; TopologyAttack resolves by both
    of its names now; forensics
    resolves now, refusing the streamed round with the JAX package's
    error; the campaign adversaries resolve; Noise, Lazy and ghost lanes
    on the streamed coordinate-wise round (the chunked finish) run, and
    so does streamed client momentum, which needs one trace row per data
    row."""
    from blades_tpu_torch.algorithms.config import FedavgConfig
    from blades_tpu_torch.adversaries import (
        DiurnalALIECampaign,
        LazyAdversary,
        LazyRampCampaign,
        NoiseAdversary,
        TopologyAttackAdversary,
        get_adversary,
    )
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.parallel.streamed import streamed_step

    assert FedavgConfig().update_from_dict(
        {"num_devices": 4, "autotune": True}).validate() is None
    with pytest.raises(ValueError, match="execution='dsharded' width-shards"):
        FedavgConfig().update_from_dict({"execution": "dsharded"}).validate()
    FedavgConfig().update_from_dict({"forensics": True}).validate()
    # Client lane-packing resolves now.
    cfg = FedavgConfig().update_from_dict(
        {"client_packing": 2, "global_model": "cnn",
         "dataset_config": {"type": "fashionmnist", "num_clients": 4}})
    cfg.validate()
    assert cfg.get_fed_round().packing.pack == 2
    with pytest.raises(ValueError, match="forensics × execution='streamed' "
                       "is an unsupported pair"):
        FedavgConfig().update_from_dict(
            {"forensics": True, "execution": "streamed"}).validate()
    task = TaskSpec(model="mlp", input_shape=(4, 4, 1)).build()
    for name in ("TopologyAttack", "TopologyAttackAdversary"):
        assert isinstance(get_adversary(name, num_clients=6),
                          TopologyAttackAdversary)
    assert isinstance(get_adversary("DiurnalALIE"), DiurnalALIECampaign)
    assert isinstance(get_adversary("LazyRampCampaign"), LazyRampCampaign)
    assert isinstance(get_adversary("Noise"), NoiseAdversary)
    assert get_adversary({"type": "Lazy", "mode": "replay"}).mode == "replay"
    assert isinstance(get_adversary("LazyAdversary"), LazyAdversary)
    fr = FedRound(task=task, server=Server.from_config("Median"),
                  num_clients=3)
    step = streamed_step(fr, client_block=2, device="cpu")
    x = torch.zeros(4, 2, 4, 4, 1)
    _, m = step(fr.init(0, 4, device="cpu"), x, torch.zeros(4, 2).long(),
                torch.full((4,), 2), torch.zeros(4, dtype=torch.bool), 0)
    assert step.routes == {"chunked": 1} and int(m["round"]) == 1
    momentum = TaskSpec(model="mlp", input_shape=(4, 4, 1),
                        momentum=0.9).build()
    mfr = FedRound(task=momentum, server=Server.from_config("Median"))
    step = streamed_step(mfr, client_block=2, device="cpu")
    args = (x, torch.zeros(4, 2).long(), torch.full((4,), 2),
            torch.zeros(4, dtype=torch.bool), 0)
    state, _ = step(mfr.init(0, 4, device="cpu"), *args)
    assert all(v.shape[0] == 4 for v in state.client_opt.values())
    assert any(v.any() for v in state.client_opt.values())
    with pytest.raises(ValueError, match="one trace row per data row"):
        step(mfr.init(0, 3, device="cpu"), *args)


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    """A CUDA-only launch path: on the CPU the launcher raises, it never
    falls back (the wrappers route CPU tensors to the plain versions
    before they reach it)."""
    from blades_tpu_torch.ops import _cuda

    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _cuda.launch_finish("fused_finish", torch.zeros(4, 8))
