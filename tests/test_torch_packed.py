"""Client lane-packing in the port (blades_tpu_torch/parallel/packed.py,
the packed models) against the JAX package's (blades_tpu/parallel/
packed.py).

- pack / unpack are exact inverses, and equal the JAX transforms on the
  JAX packed models' parameters carried across by convert.py;
- the packed modules compute the JAX packed modules' logits;
- a packed client applies the dropout mask its unpacked self applies;
- the packed round (MLP, CNN, ResNet-10) matches the JAX packed round on
  JAX-drawn batches and masks, and the port's unpacked round;
- ``"auto"`` decides as the JAX package decides, with its words, and a
  forced P that cannot run raises the JAX package's errors;
- rows and summaries carry ``pack_factor`` / ``packed_lanes``; a packed
  trial killed and resumed unpacked equals the straight unpacked run.

Tolerances: the MLP ``rtol=1e-5, atol=1e-6`` (f32 sums in other orders);
the convolutional models ``rtol=1e-4, atol=1e-4``, as
tests/test_torch_dense_round.py holds the two frameworks' f32
convolutions (grouped convolutions are the clients' own, reassociated);
packed against unpacked in the port ``rtol=atol=1e-4`` (the JAX
package's ``RTOL`` for the same comparison).
"""

import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_dense_round import _jax_draws

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.algorithms.config import FedavgConfig as JaxFedavgConfig
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.models import MLP as JaxMLP
from blades_tpu.models.cnn import PackedFashionCNN as JaxPackedCNN
from blades_tpu.models.mlp import PackedMLP as JaxPackedMLP
from blades_tpu.models.resnet import PackedResNet as JaxPackedResNet
from blades_tpu.parallel import packed as jpacked
from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.algorithms.fedavg import Fedavg
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec
from blades_tpu_torch.models.cnn import PackedFashionCNN
from blades_tpu_torch.models.mlp import MLP, PackedMLP
from blades_tpu_torch.models.resnet import PackedResNet
from blades_tpu_torch.obs.schema import main as schema_main
from blades_tpu_torch.parallel.packed import (
    ClientPacking,
    PackingUnsupported,
    build_packed_model,
    pack_replicated,
    pack_stacked,
    resolve_client_packing,
    unpack_stacked,
    unpack_tree,
)
from blades_tpu_torch.tune import run_experiments, verify_result_rounds

MLP_TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
PACKED_TOL = dict(rtol=1e-4, atol=1e-4)

# (model spec per package, input shape, JAX packed module, port packed
# module), at the JAX tests' sizes.
MODELS = {
    "mlp": (lambda: JaxMLP(hidden1=8, hidden2=8, num_classes=4),
            lambda: MLP(64, hidden1=8, hidden2=8, num_classes=4), (8, 8, 1),
            lambda p: JaxPackedMLP(pack=p, hidden1=8, hidden2=8,
                                   num_classes=4),
            lambda p: PackedMLP(p, 64, 8, 8, 4)),
    "cnn": (lambda: "cnn", lambda: "cnn", (12, 12, 1),
            lambda p: JaxPackedCNN(pack=p, num_classes=4),
            lambda p: PackedFashionCNN(p, 4, 1, (12, 12))),
    "resnet10": (lambda: "resnet10", lambda: "resnet10", (8, 8, 3),
                 lambda p: JaxPackedResNet(pack=p, stage_sizes=(1, 1, 1, 1),
                                           num_classes=4),
                 lambda p: PackedResNet(p, (1, 1, 1, 1), 4, 3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread under the parallel test
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_packed_params(name, pack=2):
    _, _, shape, jmod, _ = MODELS[name]
    m = jmod(pack)
    x = jnp.zeros((pack, 2) + shape, jnp.float32)
    return m, _np(m.init(jax.random.PRNGKey(1), m.pack_inputs(x))["params"])


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pack_unpack_roundtrip_exact(name):
    """The JAX packed model's parameters load into the port's packed module
    (same names and shapes); the port's pack of P client trees equals the
    JAX pack of the same trees, and unpacks back exactly."""
    jspec, spec, shape, _, tmod = MODELS[name]
    _, jpk = _jax_packed_params(name)
    tmod(2).load_state_dict(params_from_jax(jpk), strict=True)
    jtask = JaxTaskSpec(model=jspec(), input_shape=shape, num_classes=4,
                        momentum=0.9).build()
    jparams = _np(jtask.init_params(jax.random.PRNGKey(1)))
    jstacked = jax.tree.map(lambda p: np.stack([p + i for i in range(4)]),
                            jparams)
    stacked = {k: torch.stack([v + i for i in range(4)])
               for k, v in params_from_jax(jparams).items()}
    packed = pack_stacked(stacked, 2)
    want = _np(jpacked.pack_stacked(jstacked, 2))
    for lane in range(2):
        got = params_to_jax({k: v[lane] for k, v in packed.items()})
        for a, b in zip(jax.tree.leaves(got),
                        jax.tree.leaves(jax.tree.map(lambda t: t[lane],
                                                     want))):
            np.testing.assert_array_equal(a, b)
    back = unpack_stacked(packed, 2)
    for k, v in stacked.items():
        assert torch.equal(back[k], v), k
    # momentum traces pack by the same rules
    traces = {k: torch.stack([v, 2.0 * v]) for k, v in
              params_from_jax(jparams).items()}
    rt = unpack_stacked(pack_stacked(traces, 2), 2)
    assert all(torch.equal(rt[k], v) for k, v in traces.items())
    # replicated global parameters unpack to P copies
    params = params_from_jax(jparams)
    rep = pack_replicated(params, 2)
    np.testing.assert_array_equal(
        ravel_pytree(params_to_jax(rep))[0],
        ravel_pytree(_np(jpacked.pack_replicated(jparams, 2)))[0])
    per = unpack_tree(rep, 2)
    for k, v in params.items():
        assert torch.equal(per[k][0], v) and torch.equal(per[k][1], v), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packed_module_matches_jax(name):
    """The packed modules' logits on the JAX packed parameters (inference:
    batch statistics, no dropout)."""
    _, _, shape, _, tmod = MODELS[name]
    jm, jpk = _jax_packed_params(name)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5) + shape).astype(np.float32)
    want = np.asarray(jm.apply({"params": jpk},
                               jm.pack_inputs(jnp.asarray(x))))
    m = tmod(2)
    m.load_state_dict(params_from_jax(jpk))
    with torch.no_grad():
        got = m(m.pack_inputs(torch.from_numpy(x))).numpy()
    tol = MLP_TOL if name == "mlp" else CONV_TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_keyed_dropout_discipline(name):
    """Each packed client applies its own unpacked mask: the packed logits
    of clients (0, 1) under their stacked masks are the unpacked model's
    under each client's mask; without masks (evaluation) the packed
    module is deterministic."""
    _, spec, shape, _, _ = MODELS[name]
    task = TaskSpec(model=spec(), input_shape=shape, num_classes=4).build()
    params = task.init_params(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(5)
    masks = task.draw_dropout_masks(gen, (2, 1, 3), "cpu")
    x = torch.randn((2, 3) + shape, generator=gen)
    pm = build_packed_model(task.model, 2)
    packed = pack_replicated(params, 2)
    func = torch.func.functional_call
    got = func(pm, packed, (pm.pack_inputs(x),),
               {"dropout_masks": tuple(m[:, 0] for m in masks)})
    for g in range(2):
        want = func(task.model, params, (x[g],),
                    {"dropout_masks": tuple(m[g, 0] for m in masks)})
        torch.testing.assert_close(got[:, g], want, **PACKED_TOL)
    a = func(pm, packed, (pm.pack_inputs(x),))
    b = func(pm, packed, (pm.pack_inputs(x),))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the packed round against the JAX packed round and the unpacked round
# ---------------------------------------------------------------------------


def _rounds(name, aggregator, adversary, *, packing, momentum=0.0, nb=2,
            n=6, f=2, batch=4, shard=8, rounds=2):
    """Two rounds of the JAX round (packed with ``packing``) and of the
    port's, on JAX-drawn batches and masks.  ResNet-10 runs one round of
    one local step on 16x16 inputs, batches of 8 from shards of 16, 4
    clients (1 malicious), the conditioning tests/test_torch_dense_round.py
    pins: at 8x8 its last stage normalizes 8 values per channel, and both
    packages' f32 results move by 1e-3 under reassociation."""
    jspec, spec, shape, _, _ = MODELS[name]
    if name == "resnet10":
        shape, n, f, nb, batch, shard, rounds = (16, 16, 3), 4, 1, 1, 8, 16, 1
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, shard) + shape).astype(np.float32)
    y = rng.integers(0, 4, size=(n, shard)).astype(np.int32)
    lengths = np.full((n,), shard, np.int32)
    kw = dict(input_shape=shape, num_classes=4, lr=0.1, momentum=momentum)
    fr_kw = dict(batch_size=batch, num_batches_per_round=nb, num_clients=n)
    jfr = JaxFedRound(
        task=JaxTaskSpec(model=jspec(), **kw).build(),
        server=JaxServer.from_config(aggregator=aggregator, num_byzantine=f,
                                     lr=0.5),
        adversary=jax_adversary({"type": adversary}, num_clients=n,
                                num_byzantine=f),
        packing=jpacked.ClientPacking(packing) if packing else None,
        **fr_kw)
    fr = FedRound(
        task=TaskSpec(model=spec(), **kw).build(),
        server=Server.from_config(aggregator, num_byzantine=f, lr=0.5),
        adversary=get_adversary({"type": adversary}, num_clients=n,
                                num_byzantine=f),
        packing=ClientPacking(packing) if packing else None, **fr_kw)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(_np(jstate.server.params))
    state = RoundState(server=fr.server.init(params, n),
                       client_opt=fr.task.init_client_opt_state(params, n))
    jstep = jax.jit(jfr.step_prebatched)
    jmal, mal = jnp.arange(n) < f, make_malicious_mask(n, f)
    out = []
    for key in jax.random.split(jax.random.PRNGKey(7), rounds):
        bx, by = jfr.sample_round_batches(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(lengths), key)
        masks, _ = _jax_draws(key, n, nb, batch, fr.task.model, None)
        jstate, jm = jstep(jstate, bx, by, jmal, key)
        state, m = fr.step_prebatched(
            state, torch.from_numpy(np.array(bx)),
            torch.from_numpy(np.array(by)).long(), mal, dropout_masks=masks)
        out.append((jstate, jm, state, m))
    return out


def _flat(state):
    return np.asarray(ravel_pytree(params_to_jax(state.server.params))[0])


@pytest.mark.parametrize("name,aggregator,momentum", [
    ("mlp", "Mean", 0.0), ("mlp", "Median", 0.9), ("cnn", "Mean", 0.0),
    ("resnet10", "Median", 0.0)])
def test_packed_round_matches_jax_and_unpacked(name, aggregator, momentum):
    """The packed round (P = 2, ALIE on 2 of 6, train-mode dropout) against
    the JAX packed round on the same batches and masks, and against the
    port's unpacked round: server parameters and metrics after each of
    two rounds (and the momentum traces)."""
    tol = MLP_TOL if name == "mlp" else CONV_TOL
    packed = _rounds(name, aggregator, "ALIE", packing=2, momentum=momentum)
    plain = _rounds(name, aggregator, "ALIE", packing=None,
                    momentum=momentum)
    for (jstate, jm, state, m), (_, _, ustate, um) in zip(packed, plain):
        np.testing.assert_allclose(
            _flat(state), np.asarray(ravel_pytree(jstate.server.params)[0]),
            **tol)
        np.testing.assert_allclose(_flat(state), _flat(ustate), **PACKED_TOL)
        for k in ("train_loss", "update_norm_mean", "agg_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **tol,
                                       err_msg=k)
            np.testing.assert_allclose(float(m[k]), float(um[k]),
                                       **PACKED_TOL, err_msg=k)
        if momentum:
            for k, v in state.client_opt.items():
                torch.testing.assert_close(v, ustate.client_opt[k],
                                           **PACKED_TOL)


def test_packed_blocks_draw_the_unpacked_masks():
    """With ``client_block`` a multiple of P the packed round's blocks are
    the unpacked round's, and so are the dropout draws from the round's
    generator: the two rounds agree; an odd block rounds down to P's
    multiple."""
    def fr_for(packing, block):
        return FedRound(
            task=TaskSpec(model=MODELS["mlp"][1](), input_shape=(8, 8, 1),
                          num_classes=4, lr=0.1).build(),
            server=Server.from_config("Mean", lr=0.5), batch_size=4,
            num_clients=6, client_block=block,
            packing=ClientPacking(2) if packing else None)

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(6, 8, 8, 8, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, size=(6, 8))).long()
    ln = torch.full((6,), 8)
    mal = torch.zeros(6, dtype=torch.bool)
    out = {}
    for packing, block in ((False, 4), (True, 4), (True, 5)):
        fr = fr_for(packing, block)
        state = fr.init(3, 6, device="cpu")
        out[packing, block] = fr.step(state, x, y, ln, mal, 11)
    (su, mu), (sp, mp) = out[False, 4], out[True, 4]
    for k, v in su.server.params.items():
        torch.testing.assert_close(sp.server.params[k], v, **PACKED_TOL)
    np.testing.assert_allclose(float(mp["train_loss"]),
                               float(mu["train_loss"]), **PACKED_TOL)
    s5, _ = out[True, 5]
    assert all(torch.equal(s5.server.params[k], sp.server.params[k])
               for k in sp.server.params)


# ---------------------------------------------------------------------------
# eligibility: auto falls back loudly, forced raises -- the JAX words
# ---------------------------------------------------------------------------


def _decide(cfg_cls, **cfg_kw):
    cfg = cfg_cls()
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    cfg.client_packing = "auto"
    cfg.validate()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fr = cfg.get_fed_round()
    return (None if fr.packing is None else fr.packing.pack,
            cfg._packing_decision,
            [str(x.message) for x in w if "falling back" in str(x.message)])


@pytest.mark.parametrize("kw", [
    dict(dataset="fashionmnist", num_clients=8, global_model="cnn"),
    dict(dataset="cifar10", num_clients=8, global_model="resnet18"),
    dict(dataset="cifar10", num_clients=8, global_model="resnet10"),
    dict(dataset="cifar10", num_clients=8, global_model="resnet50"),
    dict(dataset="fashionmnist", num_clients=7, global_model="cnn"),
    dict(dataset="fashionmnist", num_clients=8, global_model="mlp"),
    dict(dataset="cifar10", num_clients=8, global_model="cct_2_3x2_32"),
])
def test_auto_decides_as_jax(kw):
    """``"auto"`` packs the eligible CNN (pack 2, 4 lanes) and falls back
    loudly elsewhere, with the JAX package's decision and warning."""
    got = _decide(FedavgConfig, **kw)
    want = _decide(JaxFedavgConfig, **kw)
    assert got == want
    if got[0] is None:
        assert got[1]["pack_factor"] == 1 and len(got[2]) == 1


def test_auto_fallback_on_training_hook_adversary():
    """A training-hook adversary: ``"auto"`` declines with the JAX
    reason, a forced P raises it."""
    cfg = FedavgConfig().update_from_dict({
        "dataset_config": {"type": "mnist", "num_clients": 6},
        "num_malicious_clients": 2, "adversary_config": {"type": "SignFlip"}})
    cfg.validate()
    fr = cfg.get_fed_round()
    jcfg = JaxFedavgConfig().update_from_dict({
        "dataset_config": {"type": "mnist", "num_clients": 6},
        "num_malicious_clients": 2, "adversary_config": {"type": "SignFlip"}})
    jcfg.validate()
    jfr = jcfg.get_fed_round()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        fr2, dec = resolve_client_packing(fr, "auto", num_clients=6)
        _, jdec = jpacked.resolve_client_packing(jfr, "auto", num_clients=6)
    assert fr2.packing is None and dec == jdec
    assert "hooks local training" in dec["fallback"]
    with pytest.raises(PackingUnsupported) as exc:
        resolve_client_packing(fr, 2, num_clients=6)
    with pytest.raises(jpacked.PackingUnsupported) as jexc:
        jpacked.resolve_client_packing(jfr, 2, num_clients=6)
    assert str(exc.value) == str(jexc.value)


@pytest.mark.parametrize("setup", [
    dict(num_clients=7, client_packing=2),
    dict(client_packing=0),
    dict(client_packing="two"),
    dict(num_clients=8, execution="streamed", client_packing=2),
    dict(num_clients=8, execution="async", client_packing=2),
    dict(num_clients=8, execution="gossip", client_packing="auto"),
    dict(num_clients=8, state_window=4, client_packing=2),
])
def test_forced_packing_validation_errors(setup):
    """The forced-P checks and the refused pairs raise the JAX package's
    ``ValueError`` with its words."""
    msgs = []
    for cls in (FedavgConfig, JaxFedavgConfig):
        cfg = cls()
        for k, v in setup.items():
            setattr(cfg, k, v)
        with pytest.raises(ValueError) as exc:
            cfg.validate()
        # The port's async messages spell the JAX package's "×" and "—"
        # in ASCII.
        msgs.append(str(exc.value).replace("×", "x").replace("—", "--"))
    assert msgs[0] == msgs[1]


def test_auto_fallback_when_auto_execution_resolves_streamed(monkeypatch):
    """``"auto"`` packing keeps its loud fallback when ``execution="auto"``
    resolves to the streamed round: the driver warns, strips the packing,
    records the reason and trains unpacked; a forced P raises."""
    monkeypatch.setattr(Fedavg, "_DENSE_MATRIX_LIMIT", 0)
    run = {"dataset_config": {"type": "fashionmnist", "num_clients": 8,
                              "train_bs": 8},
           "global_model": "cnn", "evaluation_interval": 0,
           "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}}}
    cfg = FedavgConfig().update_from_dict({**run, "client_packing": "auto"})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        algo = cfg.build(device="cpu")
    assert any("falling back" in str(x.message)
               and "streaming" in str(x.message) for x in w)
    assert algo.streamed and algo.fed_round.packing is None
    dec = algo.packing_summary
    assert dec["pack_factor"] == 1 and "streaming" in dec["fallback"]
    assert np.isfinite(algo.train()["train_loss"])
    algo.stop()
    with pytest.raises(ValueError, match="client lane-packing needs the "
                       "dense round"):
        FedavgConfig().update_from_dict(
            {**run, "client_packing": 2}).build(device="cpu")


# ---------------------------------------------------------------------------
# the sweep: rows, summaries, kill-and-resume across layouts
# ---------------------------------------------------------------------------


def _experiments(client_packing, rounds=3, **cfg):
    return {"packed": {
        "run": "FEDAVG", "stop": {"training_iteration": rounds},
        "config": {"dataset_config": {"type": "mnist", "num_clients": 6,
                                      "train_bs": 8},
                   "global_model": "mlp", "evaluation_interval": rounds,
                   "server_config": {"lr": 1.0},
                   "client_packing": client_packing, **cfg}}}


def _rows(summary):
    return [json.loads(line) for line in
            (Path(summary["dir"]) / "result.json").read_text().splitlines()]


def test_packed_trial_streams_and_summarises(tmp_path):
    """``pack_factor`` / ``packed_lanes`` in every metrics.jsonl row
    (schema-valid) and the decision in the summary."""
    [s] = run_experiments(_experiments(2), storage_path=str(tmp_path),
                          verbose=0, device="cpu")
    assert "status" not in s
    assert s["packing"] == {"requested": 2, "pack_factor": 2,
                            "packed_lanes": 3, "fallback": None}
    tdir = Path(s["dir"])
    assert schema_main([str(tdir / "metrics.jsonl")]) == 0
    rows = [json.loads(line) for line in
            (tdir / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 3 and all(
        r["pack_factor"] == 2 and r["packed_lanes"] == 3 for r in rows)


def test_packed_kill_and_resume_to_unpacked(tmp_path):
    """A packed trial killed after round 5 (checkpoints every 2) and
    resumed unpacked: no duplicated or missing round, and every row
    within the packed tolerance of the straight unpacked run."""
    kw = dict(verbose=0, device="cpu")
    [b] = run_experiments(_experiments("off", rounds=6),
                          storage_path=str(tmp_path / "base"), **kw)
    [k] = run_experiments(_experiments(2, rounds=6),
                          storage_path=str(tmp_path / "kill"),
                          checkpoint_freq=2, preempt_after=5, **kw)
    assert k.get("status") == "ERROR"
    [r] = run_experiments(_experiments("off", rounds=6),
                          storage_path=str(tmp_path / "kill"),
                          checkpoint_freq=2, resume=True, **kw)
    assert "status" not in r and r["rounds"] == 6
    assert r.get("resumed") == "from round 4"
    assert verify_result_rounds(Path(r["dir"]) / "result.json") == list(
        range(1, 7))
    rows_b, rows_r = _rows(b), _rows(r)
    for rb, rr in zip(rows_b, rows_r):
        assert rb["training_iteration"] == rr["training_iteration"]
        np.testing.assert_allclose(rr["train_loss"], rb["train_loss"],
                                   **PACKED_TOL)
    np.testing.assert_allclose(rows_r[-1]["test_acc"],
                               rows_b[-1]["test_acc"], atol=1e-3)
    assert "pack_factor" in rows_r[3] and "pack_factor" not in rows_r[4]


def test_laned_trials_carry_packing_stamps(tmp_path):
    """Laned trials run the packed local round in each lane and stamp
    ``pack_factor`` / ``packed_lanes`` into every row; their summaries
    carry the packing slice."""
    exps = _experiments(2, rounds=2, evaluation_interval=0)
    exps["packed"]["config"]["dataset_config"]["seed"] = {
        "grid_search": [1, 2]}
    summaries = run_experiments(exps, storage_path=str(tmp_path), verbose=0,
                                device="cpu")
    assert len(summaries) == 2
    for s in summaries:
        assert s.get("lanes") == 2, s
        assert s["packing"] == {"pack_factor": 2, "packed_lanes": 3}
        rows = [json.loads(line) for line in
                (Path(s["dir"]) / "metrics.jsonl").read_text().splitlines()]
        assert rows and all(r["pack_factor"] == 2 for r in rows)


def test_bn_plan_takes_the_packed_stage():
    """ResNet-10's last stage packed by 2 hands the BN pair 1,024 channels
    at G = n / P: the vector map covers it in the channels-last layout
    cuDNN returns, and the scalar map otherwise, within the kernels'
    grid."""
    from blades_tpu_torch.ops._cuda import bn_plan

    g, n, c, s = 30, 64, 1024, 16
    cl = (n * c * s, c * s, 1, c)  # channels-last (g, n, c, s) strides
    plan = bn_plan((g, n, c, s), (cl, cl, cl), 4, (0, 0, 0))
    assert plan.map == 2 and plan.groups * plan.width == c
    assert plan.splits * plan.chunk >= n * s
    nchw = (n * c * s, c * s, s, 1)
    plan = bn_plan((g, n, c, s), (nchw, nchw, nchw), 4, (0, 0, 0))
    assert plan.map == 0 and plan.groups == c
