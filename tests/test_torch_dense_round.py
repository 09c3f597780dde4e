"""The port's dense round (blades_tpu_torch/core/round.py,
``FedRound.step_prebatched``) against the JAX package's over two rounds.

Both sides start from the same flax-initialised parameters (carried across
by blades_tpu_torch/convert.py) and train on the same JAX-drawn batches
(``FedRound.sample_round_batches``).  The port is also handed the JAX
round's other draws, recomputed with the same ``jax.random.split`` chain:
``step_prebatched``'s five-way round split, one key per client and per
local step, the augmentation's ``k_aug`` split and crop/flip draws, and
``keyed_dropout``'s ``fold_in`` masks.  The cases cover Mean, Median,
Trimmedmean and Multikrum under SignFlip, LabelFlip and ALIE, client
momentum 0.9 (its per-client traces compared too), the health check, the
MLP, the CNN, ResNet-10 with CIFAR crop + flip over two local steps, and
a narrow CCT registered in both packages.

Tolerances: the MLP ``rtol=1e-5, atol=1e-6`` (f32 sums in other orders);
the convolutional models ``rtol=1e-4`` as tests/test_torch_models.py holds
the two frameworks' f32 convolutions, with ``atol=1e-4`` (the momentum
traces are sums of gradients of magnitude up to ~4, and the absolute
differences of their near-zero entries follow that scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.models import register_model as jax_register_model
from blades_tpu.models.cct import CCT as JaxCCT
from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec
from blades_tpu_torch.models import register_model
from blades_tpu_torch.models.cct import CCT
from blades_tpu_torch.utils.tree import FlatLayout

METRICS = ("train_loss", "update_norm_mean", "agg_norm")


def _jax_draws(key, n, nb, batch, model, augment):
    """The dropout keep-masks and augmentation draws of one JAX
    ``step_prebatched`` (None where the model or task has none)."""
    _, k_train, _, _, _ = jax.random.split(key, 5)
    widths = getattr(model, "dropout_widths", ())
    rate = getattr(model, "dropout_rate", 0.0)
    masks = [np.zeros((n, nb, batch, w), bool) for w in widths]
    offs = np.zeros((n, nb, batch, 2), np.int64)
    flips = np.zeros((n, nb, batch), bool)
    for i, kc in enumerate(jax.random.split(k_train, n)):
        for s, k in enumerate(jax.random.split(kc, nb)):
            if augment:
                k_aug, k = jax.random.split(k)
                k_off, k_flip = jax.random.split(k_aug)
                offs[i, s] = np.asarray(jax.random.randint(
                    k_off, (batch, 2), 0, 9))
                flips[i, s] = np.asarray(jax.random.bernoulli(
                    k_flip, 0.5, (batch,)))
            for layer, w in enumerate(widths):
                masks[layer][i, s] = np.asarray(jax.random.bernoulli(
                    jax.random.fold_in(k, layer), 1.0 - rate, (batch, w)))
    aug = ((torch.from_numpy(offs), torch.from_numpy(flips))
           if augment else None)
    return tuple(torch.from_numpy(m) for m in masks) or None, aug


def _traces(opt):
    """The JAX momentum traces as one ``(n, d)`` array in ravel order."""
    trace = opt[0].trace
    n = jax.tree.leaves(trace)[0].shape[0]
    return np.stack([np.asarray(ravel_pytree(
        jax.tree.map(lambda t: t[i], trace))[0]) for i in range(n)])


def _run(model, shape, aggregator, adversary, *, momentum=0.0, nb=1,
         augment=None, health_check=False, n=8, f=2, batch=4, shard=8,
         rounds=2, block=None):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, shard) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(n, shard)).astype(np.int32)
    lengths = np.full((n,), shard, np.int32)
    lengths[-1] = shard - 3
    spec = dict(model=model, input_shape=shape, num_classes=10, lr=0.1,
                momentum=momentum, augment=augment)
    fr_kw = dict(batch_size=batch, num_batches_per_round=nb,
                 health_check=health_check)
    jfr = JaxFedRound(
        task=JaxTaskSpec(**spec).build(),
        server=JaxServer.from_config(aggregator=aggregator, num_byzantine=f,
                                     lr=0.5, momentum=0.5),
        adversary=jax_adversary({"type": adversary}, num_clients=n,
                                num_byzantine=f, num_classes=10), **fr_kw)
    fr = FedRound(
        task=TaskSpec(**spec).build(),
        server=Server.from_config(aggregator, num_byzantine=f, lr=0.5,
                                  momentum=0.5),
        adversary=get_adversary({"type": adversary}, num_clients=n,
                                num_byzantine=f, num_classes=10),
        client_block=block, **fr_kw)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n),
                       client_opt=fr.task.init_client_opt_state(params, n))
    jstep = jax.jit(jfr.step_prebatched)
    jmal = jnp.arange(n) < f
    mal = make_malicious_mask(n, f)
    out = []
    for key in jax.random.split(jax.random.PRNGKey(7), rounds):
        bx, by = jfr.sample_round_batches(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(lengths), key)
        masks, aug = _jax_draws(key, n, nb, batch, fr.task.model, augment)
        jstate, jm = jstep(jstate, bx, by, jmal, key)
        state, m = fr.step_prebatched(
            state, torch.from_numpy(np.array(bx)),
            torch.from_numpy(np.array(by)).long(), mal,
            dropout_masks=masks, aug_draws=aug)
        out.append((jstate, jm, state, m))
    return out


def _compare(out, rtol, atol, momentum, health_check=False):
    for jstate, jm, state, m in out:
        want = np.asarray(ravel_pytree(jstate.server.params)[0])
        got = np.asarray(ravel_pytree(params_to_jax(state.server.params))[0])
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       atol=atol, err_msg=k)
        assert int(m["round"]) == int(jm["round"])
        if health_check:
            assert int(m["num_unhealthy"]) == int(jm["num_unhealthy"])
            assert bool(m["round_ok"]) == bool(jm["round_ok"])
        if momentum:
            layout = FlatLayout(state.server.params)
            n = next(iter(state.client_opt.values())).shape[0]
            got_t = torch.stack([layout.ravel(
                {k: v[i] for k, v in state.client_opt.items()})
                for i in range(n)]).numpy()
            np.testing.assert_allclose(got_t, _traces(jstate.client_opt),
                                       rtol=rtol, atol=atol)
        else:
            assert state.client_opt is None


MLP_CASES = [
    ("Mean", "SignFlip", 0.9, False),
    ("Median", "ALIE", 0.0, True),
    ("Trimmedmean", "LabelFlip", 0.9, False),
    ("Multikrum", "ALIE", 0.9, False),
]


@pytest.mark.parametrize("aggregator,adversary,momentum,health", MLP_CASES,
                         ids=[f"{a}-{b}" for a, b, _, _ in MLP_CASES])
def test_mlp_dense_rounds_match_jax(aggregator, adversary, momentum, health):
    out = _run("mlp", (8, 8, 1), aggregator, adversary, momentum=momentum,
               health_check=health, block=3)
    _compare(out, 1e-5, 1e-6, momentum, health)


def test_cnn_dense_rounds_match_jax():
    """The CNN (keyed dropout after ``Dense_0``) under LabelFlip with
    client momentum, two local steps."""
    out = _run("cnn", (12, 12, 1), "Median", "LabelFlip", momentum=0.9,
               nb=2)
    _compare(out, 1e-4, 1e-4, 0.9)


def test_cct_dense_rounds_match_jax():
    """A narrow CCT (embed 32, two layers, two heads, 16x16 inputs: 16
    tokens) registered in both packages through ``register_model``, two
    rounds of Median under ALIE.  Attention dropout and stochastic depth
    are off: the JAX round draws its masks inside ``jit``, where they
    cannot be recorded (tests/test_torch_cct.py holds the masked model)."""
    kw = dict(embed_dim=32, num_layers=2, num_heads=2, attn_dropout=0.0,
              stochastic_depth=0.0)
    jax_register_model("cct_narrow_round", lambda num_classes=10: JaxCCT(
        num_classes=num_classes, **kw))
    register_model("cct_narrow_round",
                   lambda num_classes=10, input_shape=None: CCT(
                       num_classes=num_classes, input_shape=input_shape, **kw))
    out = _run("cct_narrow_round", (16, 16, 3), "Median", "ALIE")
    assert out[0][2].server.params["pos_embed"].shape == (1, 16, 32)
    _compare(out, 1e-4, 1e-5, 0.0)


def test_resnet10_dense_round_matches_jax():
    """ResNet-10 at 16x16 with CIFAR crop + flip and client momentum, two
    local steps (both layouts of the BatchNorm backward), SignFlip and
    Median, in client blocks of 2; one round.

    The second local step of a freshly initialised ResNet on a batch of a
    few random images can be ill-conditioned for a client whose draw
    leaves a BatchNorm channel nearly constant: there both packages' f32
    results for that client move by percents under reassociation (seen
    with batches of 4 and 16 here; every one-step case agrees to 1e-7).
    This case's draws (batches of 8 from shards of 16) are well
    conditioned: every client's momentum trace agrees to ~2e-6 of its
    norm."""
    out = _run("resnet", (16, 16, 3), "Median", "SignFlip", momentum=0.9,
               nb=2, augment="cifar", n=4, f=1, batch=8, shard=16, rounds=1,
               block=2)
    _compare(out, 1e-4, 1e-5, 0.9)
