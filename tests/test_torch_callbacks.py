"""The port's client callbacks (blades_tpu_torch/core/callbacks.py) against
the JAX package's (blades_tpu/core/callbacks.py).

- ``ClippingCallback`` on a client block's gradients (leading client axis)
  against the JAX callback vmapped over the same clients: each client
  clipped by its own global L2 norm over all of its leaves, a client under
  the threshold and an all-zero one untouched; ``rtol=1e-6, atol=1e-7``
  (an f32 sum of squares over the leaves in another order).
- The chain composes before the adversary's hooks: a shifting callback
  with SignFlip gives ``-(g + 1)`` on both sides, not ``1 - g``.
- Two dense MLP rounds with clipping (and SignFlip) through
  ``step_prebatched`` on JAX-drawn batches and dropout masks match the JAX
  round: ``rtol=1e-5, atol=1e-6`` as tests/test_torch_dense_round.py
  holds the MLP.
- The config's ``clip_gradient_norm`` and ``client_config.callbacks`` give
  the JAX chain; both streamed rounds and the dense round call it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_dense_round import _jax_draws

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.algorithms import FedavgConfig as JaxFedavgConfig
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.core import callbacks as jcb
from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
from blades_tpu_torch.algorithms import FedavgConfig
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec
from blades_tpu_torch.core import callbacks as cb
from blades_tpu_torch.parallel.streamed import streamed_step

MLP_RUN = {
    "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 8},
    "global_model": "mlp", "evaluation_interval": 3,
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
}


def _mlp_grads(g, seed=0):
    """A block of ``g`` clients' MLP-shaped gradients in torch layout,
    client 1 scaled under the threshold and client 2 all zero."""
    task = TaskSpec(model="mlp", input_shape=(8, 8, 1)).build()
    params = task.init_params(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    grads = {k: torch.randn((g,) + v.shape, generator=gen)
             for k, v in params.items()}
    for v in grads.values():
        v[1] *= 1e-3
        v[2] = 0.0
    return grads


@pytest.mark.parametrize("threshold", [0.5, 10.0, 1e4])
def test_clipping_callback_matches_jax_per_client(threshold):
    g = 5
    grads = _mlp_grads(g)
    got = cb.ClippingCallback(threshold).on_backward_end(
        grads, torch.zeros(g, dtype=torch.bool))
    jgrads = [params_to_jax({k: v[i] for k, v in grads.items()})
              for i in range(g)]
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jgrads)
    want = jax.vmap(jcb.ClippingCallback(threshold).on_backward_end)(
        jstack, jnp.zeros(g, bool))
    for i in range(g):
        np.testing.assert_allclose(
            ravel_pytree(params_to_jax({k: v[i] for k, v in got.items()}))[0],
            ravel_pytree(jax.tree.map(lambda a: a[i], want))[0],
            rtol=1e-6, atol=1e-7)
    norms = torch.cat([v.flatten(1) for v in got.values()], 1).norm(dim=1)
    assert float(norms.max()) <= threshold * (1 + 1e-6)
    for k, v in got.items():
        assert torch.equal(v[1], grads[k][1]) and torch.equal(v[2], grads[k][2])


@dataclasses.dataclass(frozen=True)
class _JaxShift(jcb.ClientCallback):
    def on_backward_end(self, grads, malicious):
        return jax.tree.map(lambda v: v + 1.0, grads)


@dataclasses.dataclass(frozen=True)
class _Shift(cb.ClientCallback):
    def on_backward_end(self, grads, malicious):
        return {k: v + 1.0 for k, v in grads.items()}


def test_the_chain_runs_before_the_adversarys_hooks():
    task = TaskSpec(model="mlp", input_shape=(8, 8, 1)).build()
    fr = FedRound(task=task, server=Server.from_config("Mean"),
                  adversary=get_adversary("SignFlip"),
                  client_callbacks=(_Shift(),))
    hooks = fr.hooks()
    g = {"w": torch.full((2, 3), 2.0)}
    out = hooks.grad(g, torch.tensor([True, False]))["w"]
    assert out[0].tolist() == [-3.0] * 3 and out[1].tolist() == [3.0] * 3
    jfr = JaxFedRound(task=JaxTaskSpec(model="mlp",
                                       input_shape=(8, 8, 1)).build(),
                      server=JaxServer.from_config(aggregator="Mean"),
                      adversary=jax_adversary("SignFlip"),
                      client_callbacks=(_JaxShift(),))
    jout = jfr._hooks()[1]({"w": jnp.full((3,), 2.0)}, jnp.array(True))
    assert np.asarray(jout["w"]).tolist() == [-3.0] * 3


@pytest.mark.parametrize("adversary", ["SignFlip", None])
def test_clipped_dense_rounds_match_jax(adversary):
    n, f, nb, batch, shard, thr = 6, 2, 2, 4, 8, 0.05
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, shard, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=(n, shard)).astype(np.int32)
    lengths = np.full((n,), shard, np.int32)
    spec = dict(model="mlp", input_shape=(8, 8, 1), num_classes=10, lr=0.1)
    kw = dict(batch_size=batch, num_batches_per_round=nb)
    adv = None if adversary is None else {"type": adversary}
    jfr = JaxFedRound(
        task=JaxTaskSpec(**spec).build(),
        server=JaxServer.from_config(aggregator="Mean", lr=0.5),
        adversary=jax_adversary(adv, num_clients=n, num_byzantine=f),
        client_callbacks=(jcb.ClippingCallback(thr),), **kw)
    fr = FedRound(
        task=TaskSpec(**spec).build(),
        server=Server.from_config("Mean", lr=0.5),
        adversary=get_adversary(adv, num_clients=n, num_byzantine=f),
        client_callbacks=(cb.ClippingCallback(thr),), client_block=4, **kw)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n))
    jstep = jax.jit(jfr.step_prebatched)
    jmal, mal = jnp.arange(n) < f, make_malicious_mask(n, f)
    for key in jax.random.split(jax.random.PRNGKey(7), 2):
        bx, by = jfr.sample_round_batches(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(lengths), key)
        masks, _ = _jax_draws(key, n, nb, batch, fr.task.model, None)
        jstate, jm = jstep(jstate, bx, by, jmal, key)
        state, m = fr.step_prebatched(
            state, torch.from_numpy(np.array(bx)),
            torch.from_numpy(np.array(by)).long(), mal, dropout_masks=masks)
        np.testing.assert_allclose(
            ravel_pytree(params_to_jax(state.server.params))[0],
            ravel_pytree(jstate.server.params)[0], rtol=1e-5, atol=1e-6)
        for k in ("train_loss", "update_norm_mean", "agg_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # Clipping binds: each local step moves a client by at most lr * thr.
    assert float(m["update_norm_mean"]) <= nb * 0.1 * thr * (1 + 1e-5)


@dataclasses.dataclass(frozen=True)
class _RoundEnd(cb.ClientCallback):
    def on_round_end(self, update, malicious):
        return update


def test_round_boundary_hooks_are_refused_by_name():
    fr = FedRound(task=TaskSpec(model="mlp", input_shape=(8, 8, 1)).build(),
                  server=Server.from_config("Mean"),
                  client_callbacks=(cb.ClippingCallback(1.0), _RoundEnd()))
    with pytest.raises(NotImplementedError, match="on_round_end"):
        fr.hooks()


def test_config_builds_the_jax_chain():
    run = {**MLP_RUN, "client_config": {
        "clip_gradient_norm": 2.0,
        "callbacks": [{"type": "Clipping", "clip_threshold": 10.0}]}}
    ours = FedavgConfig().update_from_dict(run).get_client_callbacks()
    theirs = JaxFedavgConfig().update_from_dict(run).get_client_callbacks()
    assert [(type(c).__name__, c.clip_threshold) for c in ours] == [
        (type(c).__name__, c.clip_threshold) for c in theirs] == [
        ("ClippingCallback", 10.0), ("ClippingCallback", 2.0)]
    cfg = FedavgConfig().update_from_dict(run)
    cfg.validate()
    assert cfg.get_fed_round().client_callbacks == ours
    with pytest.raises(KeyError, match="unknown callback"):
        FedavgConfig().update_from_dict(
            {**MLP_RUN, "client_config": {"callbacks": [{"type": "Nope"}]}}
        ).validate()


@dataclasses.dataclass(frozen=True)
class _Counting(cb.ClippingCallback):
    calls: list = dataclasses.field(default_factory=list, compare=False)

    def on_backward_end(self, grads, malicious):
        self.calls.append(int(malicious.shape[0]))
        return super().on_backward_end(grads, malicious)


@pytest.mark.parametrize("execution,aggregator", [
    ("dense", "Median"), ("streamed", "Median"), ("streamed", "Multikrum")])
def test_every_round_runs_the_chain(execution, aggregator):
    """The dense round, the streamed coordinate-wise round and the streamed
    row-geometry round each call the chain once per block and local step;
    the clipped round differs from the unclipped one."""
    counting = _Counting(1e-3)
    n, f, nb = 6, 2, 2
    outs = []
    for cbs in ((counting,), ()):
        fr = FedRound(
            task=TaskSpec(model="mlp", input_shape=(8, 8, 1)).build(),
            server=Server.from_config(aggregator, num_byzantine=f, lr=0.5),
            adversary=get_adversary("ALIE", num_clients=n, num_byzantine=f),
            batch_size=4, num_batches_per_round=nb, client_block=2,
            client_callbacks=cbs)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((n, 8, 8, 8, 1), generator=gen)
        y = torch.randint(0, 10, (n, 8), generator=gen)
        state = fr.init(0, n, device="cpu")
        step = (fr.step if execution == "dense" else streamed_step(
            fr, client_block=2, update_dtype=torch.float32, device="cpu"))
        state, _ = step(state, x, y, torch.full((n,), 8),
                        make_malicious_mask(n, f), 5)
        outs.append(state.server.params)
    assert counting.calls == [2] * (n // 2) * nb
    assert any(not torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
