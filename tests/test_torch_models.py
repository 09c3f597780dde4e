"""The port's models (blades_tpu_torch/models/) against the flax reference:
logits and parameter gradients on the same weights (carried across by
blades_tpu_torch/convert.py) and the same numpy-made inputs, in f32.

Tolerance ``rtol=1e-4, atol=1e-5``: the two frameworks' f32 convolutions
and matrix products sum in different orders, and batch-statistics
normalisation over small batches amplifies those last-ulp differences in
the gradients.  ResNet-10 runs on 16x16 inputs: at 8x8 its last stage is
1x1, so with a batch of 2 each BatchNorm there normalises two values per
channel: there the two f32 results differ by hundreds of times this
tolerance, and each lies as far from an f64 run, which is conditioning
and not a difference between them.  The hand-written BatchNorm backward
is also checked on its own with ``torch.autograd.gradcheck`` in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad, vmap

from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.models.catalog import _RESNETS as JAX_RESNETS
from blades_tpu.models.catalog import ModelCatalog
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import TaskSpec
from blades_tpu_torch.models.catalog import get_model
from blades_tpu_torch.models.layers import BNApply, bn_apply

RTOL, ATOL = 1e-4, 1e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _jax_masks(key, batch, widths, rate):
    """The MLP's keyed-dropout keep-masks, as layers.keyed_dropout draws
    them: ``bernoulli(fold_in(key, layer), 1 - rate, (B, width))``."""
    return tuple(
        np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i),
                                        1.0 - rate, (batch, w)))
        for i, w in enumerate(widths))


@pytest.mark.parametrize("model,shape", [("resnet", (16, 16, 3)),
                                         ("mlp", (8, 8, 1))])
def test_logits_and_grads_match_flax(model, shape):
    spec = dict(model=model, input_shape=shape, num_classes=10)
    jtask = JaxTaskSpec(**spec).build()
    jparams = jtask.init_params(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2,) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(2,)).astype(np.int32)
    dkey = jax.random.PRNGKey(3)

    def jloss(p):
        return jtask.loss_fn(p, jnp.asarray(x), jnp.asarray(y), dkey)

    jlogits = jtask.apply(jparams, jnp.asarray(x), train=True,
                          dropout_key=dkey)
    jgrads = jax.grad(jloss)(jparams)

    task = TaskSpec(**spec).build()
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    masks = None
    if model == "mlp":
        masks = tuple(torch.from_numpy(m.copy()) for m in _jax_masks(
            dkey, 2, task.model.dropout_widths, task.model.dropout_rate))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    logits = functional_call(task.model, params, (xt,),
                             {"dropout_masks": masks})
    _close(logits.detach(), jlogits)
    grads = grad(task.loss_fn)(params, xt, yt, masks)
    want = jax.tree.map(np.asarray, jgrads)
    got = params_to_jax(grads)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in flat_w:
        _close(flat_g[path], w)


def test_local_round_matches_jax():
    """One client's local SGD over two batches (the MLP with its dropout
    masks fed from the reference's key chain): the flat update and the
    mean loss."""
    spec = dict(model="mlp", input_shape=(8, 8, 1), num_classes=10, lr=0.1)
    jtask = JaxTaskSpec(**spec).build()
    jparams = jtask.init_params(jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    bx = rng.normal(size=(2, 3, 8, 8, 1)).astype(np.float32)
    by = rng.integers(0, 10, size=(2, 3)).astype(np.int32)
    key = jax.random.PRNGKey(6)
    jupd, _, jloss = jtask.local_round(
        jparams, jtask.init_client_opt_state(jparams), jnp.asarray(bx),
        jnp.asarray(by), key, jnp.asarray(False))

    task = TaskSpec(**spec).build()
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    per_step = [_jax_masks(k, 3, task.model.dropout_widths,
                           task.model.dropout_rate)
                for k in jax.random.split(key, 2)]
    masks = tuple(torch.from_numpy(np.stack([m[i] for m in per_step]))
                  for i in range(2))
    upd, loss = task.local_round(params, torch.from_numpy(bx),
                                 torch.from_numpy(by).long(),
                                 dropout_masks=masks)
    _close(upd, jupd)
    _close(loss, jloss)


def test_bn_backward_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 5, 5, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    scale = torch.randn(4, generator=gen, dtype=torch.float64,
                        requires_grad=True)
    bias = torch.randn(4, generator=gen, dtype=torch.float64,
                       requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, s, b: BNApply.apply(a, s, b, 1e-5)[0], (x, scale, bias))


def test_bn_vmap_matches_loop():
    """A client block runs as one vmap over the custom Function."""
    gen = torch.Generator().manual_seed(1)
    xs = torch.randn(3, 2, 4, 3, 3, generator=gen)
    scale = torch.randn(4, generator=gen)
    bias = torch.randn(4, generator=gen)

    def loss(s, x):
        return (bn_apply(x, s, bias) ** 3).sum()

    batched = vmap(grad(loss), in_dims=(None, 0))(scale, xs)
    looped = torch.stack([grad(loss)(scale, x) for x in xs])
    torch.testing.assert_close(batched, looped, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(JAX_RESNETS))
def test_resnet_names_resolve_to_their_own_depth(name):
    """Every exact ResNet name of the reference builds, in the port, a
    model with the reference's parameter count, or raises: none falls
    through to another depth (the "resnet" substring rule is ResNet-10)."""
    try:
        model = get_model(name, num_classes=10, input_shape=(32, 32, 3))
    except NotImplementedError as e:
        assert "Queue A 6" in str(e)
        return
    shapes = jax.eval_shape(
        ModelCatalog.get_model(name, num_classes=10).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want
