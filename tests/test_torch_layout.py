"""Flat-vector layout of the port (blades_tpu_torch/utils/tree.py) and the
weight converter (blades_tpu_torch/convert.py) against
``jax.flatten_util.ravel_pytree`` over flax-initialised parameters.

The port's flat vector must equal the reference's exactly: same leaf order
(sorted flax paths), conv kernels in HWIO, dense kernels in (in, out).  A
pure permutation of the same f32 values, so the comparison is bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import TaskSpec
from blades_tpu_torch.utils.tree import FlatLayout

SPECS = {
    "resnet": dict(model="resnet", input_shape=(8, 8, 3)),
    "mlp": dict(model="mlp", input_shape=(8, 8, 1)),
}


@pytest.fixture(scope="module", params=sorted(SPECS))
def pair(request):
    spec = SPECS[request.param]
    jparams = JaxTaskSpec(**spec).build().init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return request.param, spec, jparams, tree


def test_flat_vector_equals_ravel_pytree(pair):
    _, _, jparams, tree = pair
    flat_ref = np.asarray(ravel_pytree(jparams)[0])
    flat = FlatLayout(params_from_jax(tree)).ravel(params_from_jax(tree))
    assert flat.shape == flat_ref.shape
    np.testing.assert_array_equal(flat.numpy(), flat_ref)


def test_unravel_round_trips(pair):
    _, _, _, tree = pair
    params = params_from_jax(tree)
    layout = FlatLayout(params)
    back = layout.unravel(layout.ravel(params))
    assert back.keys() == params.keys()
    for k in params:
        assert back[k].shape == params[k].shape
        torch.testing.assert_close(back[k], params[k], rtol=0, atol=0)


def test_converter_round_trips_and_fits_the_model(pair):
    _, spec, _, tree = pair
    params = params_from_jax(tree)
    model = TaskSpec(**spec).build().model
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert shapes == {k: tuple(v.shape) for k, v in params.items()}
    back = params_to_jax(params)
    flat_a, _ = ravel_pytree(back)
    flat_b, _ = ravel_pytree(tree)
    np.testing.assert_array_equal(np.asarray(flat_a), np.asarray(flat_b))


def test_resnet10_width_and_leaf_order(pair):
    name, _, _, tree = pair
    layout = FlatLayout(params_from_jax(tree))
    paths = [lf.path for lf in layout.leaves]
    assert paths == sorted(paths)
    if name == "resnet":
        # ResNet-10 on 3-channel inputs: the headline model's d.
        assert layout.d == 4_903_242
        assert paths[0] == ("BasicBlock_0", "BatchStatsNorm_0", "bias")
        assert paths[-1] == ("Dense_0", "kernel")
