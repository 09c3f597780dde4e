"""The port's mesh layer (blades_tpu_torch/parallel/mesh.py), config fields
and CLI flags against the JAX package's, without processes; and the rank
program that tests/test_torch_sharded.py and tests/test_torch_hier.py
start on gloo ranks.

``make_mesh``'s errors, ``pad_to_multiple``, the lane blocks and
``hier_kept_counts`` equal the JAX package's; every validation message of
JAX's ``test_pod_scale_validation_messages`` comes back from the port's
``validate()`` (``execution="dsharded"`` and the autotuner on a mesh raise
``NotImplementedError`` by name); ``--mesh-shape`` / ``--preagg`` /
``--bucket-size`` and ``--coordinator`` / ``--num-processes`` /
``--process-id`` reach the config and the process group.

Run as a script (``python tests/test_torch_mesh.py RANK WORLD URL IN
OUT``) this file is one rank: it joins the gloo group at ``URL``, runs the
cases of ``IN`` (a ``torch.save`` of ``{"cases": [...]}``) and writes
``OUT<rank>.pt``.  :func:`start_ranks` starts the ranks, and waiting for them
has a deadline, so a hung collective fails its test.
"""

import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
RANK_DEADLINE_S = 150


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------


def _cpu(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    return tree


def _scalars(metrics):
    return {k: (float(v) if v.dtype.is_floating_point else int(v))
            for k, v in metrics.items()
            if torch.is_tensor(v) and v.numel() == 1}


def _prebatched_case(case, rank):
    """The mesh round (sharded or hierarchical) over handed-in batches,
    and on rank 0 the port's one-process dense round over the same."""
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.core import RoundState
    from blades_tpu_torch.parallel import (
        hier_step,
        make_mesh,
        shard_federation,
        sharded_step,
    )

    cfg = FedavgConfig().update_from_dict(case["config"])
    cfg.validate()
    fr = cfg.get_fed_round()
    n = cfg.num_clients
    params = case["params"]

    def fresh():
        return RoundState(server=fr.server.init(
            {k: v.clone() for k, v in params.items()}, n),
            client_opt=fr.task.init_client_opt_state(params, n))

    mesh = make_mesh(cfg.num_devices, cfg.mesh_shape)
    errors = {}
    for nd, ms in case.get("mesh_errors", ()):
        try:
            make_mesh(nd, ms)
        except ValueError as e:
            errors[(nd, ms)] = str(e)
    rec = None
    if cfg.execution == "hier":
        step, rec = hier_step(fr, mesh, preagg=cfg.preagg,
                              bucket_size=cfg.bucket_size)
    else:
        step = sharded_step(fr, mesh)
    state, _ = shard_federation(mesh, fresh(), ())
    out = {"rounds": [], "dense": [], "coords": mesh.coords,
           "shape": mesh.shape, "lanes": (step.start, step.n_local),
           "mesh_errors": errors}
    mal = case["malicious"]
    for r in case["rounds"]:
        kw = dict(dropout_masks=r.get("masks"), aug_draws=r.get("aug"),
                  dp_noise=r.get("dp_noise"))
        state, m = step.prebatched(state, r["bx"], r["by"], mal, None, **kw)
        out["rounds"].append({
            "params": _cpu(state.server.params), "metrics": _scalars(m),
            "events": list(rec.ici_events) if rec is not None else None,
            "ici_bytes": rec.ici_bytes if rec is not None else None})
    if rank == 0 and case.get("dense"):
        dstate = fresh()
        for r in case["rounds"]:
            dstate, m = fr.step_prebatched(
                dstate, r["bx"], r["by"], mal, None,
                dropout_masks=r.get("masks"), aug_draws=r.get("aug"),
                dp_noise=r.get("dp_noise"))
            out["dense"].append({"params": _cpu(dstate.server.params),
                                 "metrics": _scalars(m)})
    return out


def _driver_rows(cfg_dict, rounds, ckpt=None, save_at=None):
    from blades_tpu_torch.algorithms import FedavgConfig

    algo = FedavgConfig().update_from_dict(cfg_dict).build(device="cpu")
    rows = []
    try:
        if ckpt is not None and save_at is None:
            algo.load_checkpoint(ckpt)
        while algo.iteration < rounds:
            rows.append(algo.train())
            if save_at is not None and algo.iteration == save_at:
                algo.save_checkpoint(ckpt)
        opt = (None if algo.state.client_opt is None
               else algo._gathered_state().client_opt
               if algo.mesh is not None else algo.state.client_opt)
        return {"params": _cpu(algo.state.server.params), "rows": rows,
                "client_opt": _cpu(opt)}
    finally:
        algo.stop()


def _driver_case(case, rank):
    """The Fedavg driver on the mesh; with ``resume_at`` also killed after
    that round's checkpoint and resumed by a fresh driver; on rank 0 the
    one-process driver of the same config."""
    import torch.distributed as dist

    cfg, rounds = case["config"], case["rounds"]
    out = {}
    if case.get("resume_at"):
        ckpt = os.path.join(case["dir"], "ckpt")
        out["mesh"] = _driver_rows(cfg, rounds, ckpt, case["resume_at"])
        dist.barrier()
        out["resumed"] = _driver_rows(cfg, rounds, ckpt)
    else:
        out["mesh"] = _driver_rows(cfg, rounds)
    if rank == 0 and case.get("dense"):
        one = {k: v for k, v in cfg.items()
               if k not in ("num_devices", "mesh_shape")}
        if one.get("execution") == "hier":
            one["execution"] = "dense"
        out["dense"] = _driver_rows(one, rounds)
    return out


def _sweep_case(case, rank):
    """``run_experiments`` of one mesh trial on every rank, checkpointed
    each round: the summaries.  With ``fault`` (``(kind, round, times)``)
    rank 0's metrics sink raises on that round's row, ``times`` times: an
    OSError (``io``) or a SchemaError (``schema``), on rank 0 alone."""
    import blades_tpu_torch.obs as obs
    from blades_tpu_torch.obs import SchemaError
    from blades_tpu_torch.tune import run_experiments

    sink = obs.JsonlSink
    if case.get("fault") and rank == 0:
        kind, at, times = case["fault"]
        left = [times]

        class FaultySink(sink):
            def emit(self, record):
                if record.get("training_iteration") == at and left[0]:
                    left[0] -= 1
                    raise (SchemaError if kind == "schema" else OSError)(
                        "a fault planted on rank 0")
                super().emit(record)

        obs.JsonlSink = FaultySink
    root = Path(case["dir"])
    exps = {"mesh": {"run": "FEDAVG", "config": case["config"],
                     "stop": {"training_iteration": case["rounds"]}}}
    try:
        summaries = run_experiments(
            exps, storage_path=str(root), device="cpu", checkpoint_freq=1,
            verbose=0, max_failures=case.get("max_failures", 0),
            retry_backoff_base=0.0)
    finally:
        obs.JsonlSink = sink
    return {"summaries": summaries}


def _shard_map_case(case, rank):
    """``shard_map_step`` (per-rank draws) twice from one state and seed,
    beside ``sharded_step`` (the dense stream) from the same, and
    ``sharded_multi_step`` over the same rounds in one call."""
    import copy

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.parallel import shard_map_step, sharded_step
    from blades_tpu_torch.parallel.sharded import sharded_multi_step

    algo = FedavgConfig().update_from_dict(case["config"]).build(device="cpu")
    try:
        out = {"runs": []}
        for step in (shard_map_step(algo.fed_round, algo.mesh),) * 2 + (
                sharded_step(algo.fed_round, algo.mesh),):
            state = copy.deepcopy(algo.state)
            for r in range(case["rounds"]):
                state, m = step(state, *algo._train, algo.malicious,
                                algo.round_seed(r))
            out["runs"].append(_cpu(state.server.params))
            out.setdefault("losses", []).append(float(m["train_loss"]))
        multi = sharded_multi_step(algo.fed_round, algo.mesh, case["rounds"])
        state, ms = multi(copy.deepcopy(algo.state), *algo._train,
                          algo.malicious,
                          [algo.round_seed(r) for r in range(case["rounds"])])
        out["runs"].append(_cpu(state.server.params))
        out["losses"].append(float(ms[-1]["train_loss"]))
        return out
    finally:
        algo.stop()


def _rank_main(argv):
    rank, world, url, inp, out = (int(argv[0]), int(argv[1]), argv[2],
                                  argv[3], argv[4])
    torch.set_num_threads(1)
    try:
        from blades_tpu_torch.parallel import init_distributed

        init_distributed(url, world, rank, backend="gloo")
        cases = torch.load(inp, weights_only=False)["cases"]
        results = []
        for case in cases:
            run = {"prebatched": _prebatched_case, "driver": _driver_case,
                   "sweep": _sweep_case,
                   "shard_map": _shard_map_case}[case["kind"]]
            results.append(run(case, rank))
        torch.save({"results": results}, f"{out}{rank}.pt")
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        Path(f"{out}{rank}.err").write_text(traceback.format_exc())
        raise


class Ranks:
    """Groups of gloo ranks started by :func:`start_ranks`;
    :meth:`results` waits for them."""

    def __init__(self, procs, deadline_s):
        self.procs = procs
        self.end = time.monotonic() + deadline_s
        self.deadline_s = deadline_s

    def results(self):
        """``{name: [results of rank r]}``.  A rank that fails, or a rank
        still running at the deadline, fails the caller (every rank is
        killed first)."""
        every = [p for _, ps in self.procs.values() for p in ps]
        try:
            for p in every:
                p.wait(timeout=max(1.0, self.end - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in every:
                p.kill()
            logs = [p.communicate()[0].decode(errors="replace")[-2000:]
                    for p in every]
            pytest.fail(f"ranks still running after {self.deadline_s} s: "
                        f"{logs}")
        results = {}
        for name, (out, ps) in self.procs.items():
            logs = [p.communicate()[0].decode(errors="replace") for p in ps]
            for r, p in enumerate(ps):
                if p.returncode != 0:
                    err = Path(f"{out}{r}.err")
                    why = err.read_text() if err.exists() else logs[r][-3000:]
                    pytest.fail(f"rank {r} of group {name} exited "
                                f"{p.returncode}: {why}")
            results[name] = [torch.load(f"{out}{r}.pt",
                                        weights_only=False)["results"]
                             for r in range(len(ps))]
        return results


def start_ranks(groups, tmp_path, deadline_s=RANK_DEADLINE_S) -> Ranks:
    """Start each group's cases on its own gloo ranks, every group at
    once: ``groups`` maps a name to ``(world, cases)``; each rank is one
    process and each group a ``file://`` rendezvous in ``tmp_path``."""
    tmp_path = Path(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for name, (world, cases) in groups.items():
        gdir = tmp_path / name
        gdir.mkdir(parents=True, exist_ok=True)
        inp = gdir / "cases.pt"
        torch.save({"cases": cases}, inp)
        url = f"file://{gdir / 'rendezvous'}"
        out = str(gdir / "out")
        procs[name] = (out, [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), url, str(inp),
             out], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(world)])
    return Ranks(procs, deadline_s)


# ---------------------------------------------------------------------------
# tests without processes
# ---------------------------------------------------------------------------


def _errors(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


MESH_ERROR_CASES = [(None, (0, 1)), (3, (2, 2)), (None, (4, 2)), (2, None),
                    (8, (4, 2))]


@pytest.mark.slow  # builds JAX meshes; the ranks check the layout in tier 1
@pytest.mark.parametrize("num_devices,mesh_shape", MESH_ERROR_CASES)
def test_make_mesh_errors_match_jax(num_devices, mesh_shape):
    """One process is a world of one device: the port's errors are the
    JAX package's on one device, word for word."""
    import jax

    from blades_tpu.parallel import make_mesh as jax_make_mesh
    from blades_tpu_torch.parallel import make_mesh

    want = _errors(lambda: jax_make_mesh(num_devices, jax.devices()[:1],
                                         mesh_shape=mesh_shape))
    got = _errors(lambda: make_mesh(num_devices, mesh_shape))
    assert want is not None and got == want


@pytest.mark.slow  # a mesh call; the ranks check their meshes in tier 1
def test_one_process_mesh():
    from blades_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    assert (mesh.world_size, mesh.rank, mesh.shape, mesh.coords) == (
        1, 0, (1, 1), (0, 0))
    assert make_mesh(1, (1, 1)).shape == (1, 1)


@pytest.mark.parametrize("n,k", [(8, 2), (7, 2), (7, 4), (5, 4), (1, 3)])
def test_padding_and_lanes_match_jax(n, k):
    """``pad_to_multiple`` and the rank's lane block equal the JAX
    package's padding and its block-sharded leading axis."""
    import jax.numpy as jnp

    from blades_tpu.parallel.mesh import pad_to_multiple as jax_pad
    from blades_tpu_torch.parallel.mesh import Mesh, local_lanes, \
        pad_to_multiple

    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    want = np.asarray(jax_pad(jnp.asarray(x), k))
    np.testing.assert_array_equal(pad_to_multiple(torch.from_numpy(x), k)
                                  .numpy(), want)
    per = want.shape[0] // k
    for ci in range(k):
        mesh = Mesh(world_size=k, rank=ci, shape=(k, 1), coords=(ci, 0))
        np.testing.assert_array_equal(
            local_lanes(mesh, torch.from_numpy(x)).numpy(),
            want[ci * per:(ci + 1) * per])


def test_hier_kept_counts_match_jax():
    from blades_tpu.parallel.hier import hier_kept_counts as jax_kept
    from blades_tpu_torch.parallel.hier import hier_kept_counts

    for n in range(1, 13):
        for c in (1, 2, 3, 4):
            n_local = -(-n // c)
            for b in (1, 2, 3, 5):
                assert hier_kept_counts(n, n_local, c, b) == jax_kept(
                    n, n_local, c, b), (n, c, b)


def _configs(**kw):
    from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
    from blades_tpu_torch.algorithms import FedavgConfig

    out = []
    for cls in (JaxFedavgConfig, FedavgConfig):
        cfg = (cls().data(dataset="mnist", num_clients=8, seed=0)
               .training(global_model="mlp", aggregator={"type": "Median"}))
        for k, v in kw.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


# JAX's test_pod_scale_validation_messages (tests/test_hier.py) and the
# num_devices pairs of the JAX config's other gates.
POD_SCALE_CASES = [
    ("mesh_shape × single-chip is an unsupported pair",
     dict(mesh_shape=(4, 2))),
    ("must tile exactly", dict(mesh_shape=(4, 2), num_devices=16)),
    (r"mesh_shape must be a \(clients, d\) pair",
     dict(mesh_shape=(4, 2, 1), num_devices=8)),
    ("pre-aggregates per chip and gathers", dict(execution="hier")),
    ("rounds_per_dispatch>1 is an unsupported pair",
     dict(execution="hier", num_devices=8, rounds_per_dispatch=2)),
    ("preagg must be one of", dict(preagg="mean")),
    ("bucket_size must be an int >= 1", dict(bucket_size=0)),
    ("autotune × execution='hier' is an unsupported pair",
     dict(execution="hier", num_devices=8, autotune="on")),
    ("straggler faults is an unsupported pair",
     dict(execution="hier", num_devices=8,
          fault_config={"dropout_rate": 0.1, "num_stragglers": 1})),
    ("identity-height pre-aggregation",
     dict(execution="hier", num_devices=8, bucket_size=2,
          fault_config={"dropout_rate": 0.1})),
    ("execution='streamed' × num_devices>1",
     dict(execution="streamed", num_devices=2)),
    ("forensics × num_devices>1", dict(num_devices=2, forensics=True)),
    ("fault injection × num_devices>1",
     dict(num_devices=2, fault_config={"dropout_rate": 0.1})),
    ("update codecs are single-chip",
     dict(num_devices=2, codec_config={"type": "quant"})),
    (r"window=0 \(stateless clients\) × num_devices>1",
     dict(num_devices=2, state_window=0)),
    ("cohort gather/scatter has no mesh formulation",
     dict(num_devices=2, state_window=4)),
    ("client_packing × num_devices>1",
     dict(num_devices=2, client_packing=2)),
    ("chained_dispatch .* has no mesh formulation",
     dict(num_devices=2, chained_dispatch=True)),
]


@pytest.mark.parametrize("match,kw", POD_SCALE_CASES,
                         ids=[m[:32] for m, _ in POD_SCALE_CASES])
def test_pod_scale_validation_messages(match, kw):
    """Both configs refuse the pair, with the same words."""
    import re

    msgs = []
    for cfg in _configs(**kw):
        with pytest.raises(ValueError, match=match) as info:
            cfg.validate()
        msgs.append(str(info.value))
    assert re.search(match, msgs[1])


@pytest.mark.parametrize("kw,named", [
    (dict(execution="dsharded", num_devices=8), "9b"),
    (dict(execution="dsharded", num_devices=8, autotune="on"), "9b"),
    (dict(num_devices=2, autotune="on"), "lockstep"),
    (dict(num_devices=2, execution="gossip"), "gossip"),
])
def test_later_mesh_paths_raise_by_name(kw, named):
    cfg = _configs(**kw)[1]
    with pytest.raises(NotImplementedError, match=named):
        cfg.validate()


def test_mesh_fields_are_accepted():
    cfg = _configs()[1].resources(num_devices=4, mesh_shape=(2, 2),
                                  execution="hier", preagg="nnm",
                                  bucket_size=2)
    assert cfg.validate() is None
    assert (cfg.num_devices, cfg.mesh_shape, cfg.preagg, cfg.bucket_size) \
        == (4, (2, 2), "nnm", 2)


def test_auto_resolving_to_dsharded_raises(monkeypatch):
    """Where the JAX driver's 'auto' would pick the width-sharded round
    (the replicated (n, d) matrix over the dense budget), the port raises
    before it builds a mesh."""
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.algorithms.fedavg import Fedavg

    monkeypatch.setattr(Fedavg, "_DENSE_MATRIX_LIMIT", 1024)
    cfg = FedavgConfig().update_from_dict({
        "dataset_config": {"type": "mnist", "num_clients": 4},
        "global_model": "mlp", "num_devices": 2})
    with pytest.raises(NotImplementedError, match="9b"):
        cfg.build(device="cpu")


def test_cli_mesh_flags(monkeypatch, tmp_path):
    """``run``'s --mesh-shape / --preagg / --bucket-size reach the trial
    config (and ``run`` joins a group from torchrun's environment alone);
    ``file``'s --coordinator / --num-processes / --process-id reach the
    process group's bring-up before anything else runs."""
    import blades_tpu_torch.parallel as parallel
    import blades_tpu_torch.tune as tune
    from blades_tpu_torch import train

    seen = {}
    monkeypatch.setattr(tune, "run_experiments",
                        lambda exps, **kw: seen.setdefault("exps", exps)
                        and [])
    monkeypatch.setattr(tune, "load_experiments_from_file",
                        lambda path: {"x": {"run": "FEDAVG", "config": {}}})
    monkeypatch.setattr(parallel, "init_distributed",
                        lambda *a, **kw: seen.setdefault("init", a))
    assert train.main(["run", "FEDAVG", "--rounds", "1", "--execution",
                       "hier", "--mesh-shape", "2x2", "--preagg", "nnm",
                       "--bucket-size", "2"]) == 0
    cfg = seen.pop("exps")["fedavg_run"]["config"]
    assert (cfg["execution"], cfg["mesh_shape"], cfg["preagg"],
            cfg["bucket_size"]) == ("hier", (2, 2), "nnm", 2)
    assert seen.pop("init") == ()  # torchrun's environment alone
    assert train.main(["file", str(tmp_path / "grid.yaml"), "--coordinator",
                       "localhost:29500", "--num-processes", "2",
                       "--process-id", "1"]) == 0
    assert seen["init"] == ("localhost:29500", 2, 1)
    with pytest.raises(SystemExit):
        train.main(["run", "FEDAVG", "--mesh-shape", "2by2"])


def test_init_distributed_is_a_noop_alone(monkeypatch):
    from blades_tpu_torch.parallel import init_distributed

    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    init_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(None, 2, 0)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
