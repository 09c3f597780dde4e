"""The port's CCT / CVT (blades_tpu_torch/models/cct.py) and its catalog
against the flax reference (blades_tpu/models/cct.py).

- Every name in ``VARIANTS`` has JAX's width ``d`` and ``ravel_pytree``
  order (``jax.eval_shape`` of ``init``: nothing compiles), with each
  leaf's shape in flax layout.
- Weights carried across by blades_tpu_torch/convert.py round-trip bit
  for bit, and the port's flat vector equals ``ravel_pytree``'s.
- Logits and parameter gradients in train mode with dropout on, within
  ``rtol=1e-4, atol=1e-5`` (the convolutional models' tolerance in
  tests/test_torch_models.py: f32 products summed in another order).  The
  masks are JAX's own: the flax ``apply`` runs eagerly with
  ``jax.random.bernoulli`` wrapped to record each draw in call order, and
  the port takes them in its site order, which checks the ``(1, 1, q,
  kv)`` attention broadcast and where stochastic depth draws.
- The sinusoidal embedding, a 28x28x1 input (49 tokens), ``num_classes=None``
  on the ``_c100`` presets, ``register_model`` and callable specs.
- ``.npz`` files written by either package load in the other, with the
  ``pos_embed`` resize up and down, the head skip and the error cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree
from torch.func import functional_call, grad

from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.models import MLP as JaxMLP
from blades_tpu.models import cct as jcct
from blades_tpu.models import register_model as jax_register_model
from blades_tpu.models.catalog import ModelCatalog
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import TaskSpec
from blades_tpu_torch.models import cct, get_model, register_model
from blades_tpu_torch.utils.tree import FlatLayout

RTOL, ATOL = 1e-4, 1e-5


def _img(name):
    return 384 if "_384" in name else 224 if "_224" in name else 32


def _jax_params(model, shape, seed=1):
    """A flax-initialised parameter tree (numpy leaves) for NHWC
    ``shape``; ``init`` runs under ``jit``."""
    init = jax.jit(lambda k: model.init({"params": k, "dropout": k},
                                        jnp.zeros((1,) + shape))["params"])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name", sorted(jcct.VARIANTS))
def test_every_variant_has_the_jax_flat_layout(name):
    img = _img(name)
    jm = jcct.VARIANTS[name]()
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, img, img, 3))))["params"]
    want = [(tuple(k.key for k in p), tuple(leaf.shape))
            for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)]
    with torch.device("meta"):
        model = cct.VARIANTS[name](input_shape=(img, img, 3))
    layout = FlatLayout(dict(model.named_parameters()))
    got = [(lf.path, tuple(lf.shape[p] for p in lf.perm)
            if lf.perm else tuple(lf.shape)) for lf in layout.leaves]
    assert got == want
    assert layout.d == sum(int(np.prod(s)) for _, s in want)


def test_cct_2_width_is_the_tuned_examples():
    with torch.device("meta"):
        model = get_model("cct", 10, (32, 32, 3))
    assert FlatLayout(dict(model.named_parameters())).d == 284_491


@pytest.mark.parametrize("name", ["cct_2_3x2_32", "cvt_2_4_32"])
def test_weights_round_trip_bit_exact(name):
    jp = _jax_params(jcct.VARIANTS[name](), (32, 32, 3))
    params = params_from_jax(jp)
    back = params_to_jax(params)
    flat_w = traverse_util.flatten_dict(jp)
    flat_b = traverse_util.flatten_dict(back)
    assert flat_w.keys() == flat_b.keys()
    for k, v in flat_w.items():
        np.testing.assert_array_equal(flat_b[k], v)
    np.testing.assert_array_equal(
        FlatLayout(params).ravel(params).numpy(),
        np.asarray(ravel_pytree(jp)[0]))


def _recorded_masks(monkeypatch, fn):
    """Run ``fn`` with ``jax.random.bernoulli`` recording each draw."""
    drawn = []
    orig = jax.random.bernoulli

    def spy(*a, **kw):
        out = orig(*a, **kw)
        drawn.append(np.array(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    out = fn()
    monkeypatch.setattr(jax.random, "bernoulli", orig)
    return out, drawn


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _train_parity(monkeypatch, jtask, task, shape, batch=2, seed=2):
    """Logits and gradients of both tasks in train mode on the same
    weights, inputs and (JAX-drawn) dropout masks."""
    jparams = jax.jit(jtask.init_params)(jax.random.PRNGKey(1))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch,) + shape).astype(np.float32)
    y = rng.integers(0, 10, size=(batch,)).astype(np.int32)
    dkey = jax.random.PRNGKey(3)
    jlogits, drawn = _recorded_masks(monkeypatch, lambda: jtask.apply(
        jparams, jnp.asarray(x), train=True, dropout_key=dkey))
    jgrads = jax.jit(jax.grad(lambda p: jtask.loss_fn(
        p, jnp.asarray(x), jnp.asarray(y), dkey)))(jparams)

    sites = task.model.dropout_sites(batch)
    assert len(drawn) == len(sites)
    for m, (s, _) in zip(drawn, sites):
        assert m.size == int(np.prod(s))
    masks = tuple(torch.from_numpy(m.reshape(s)) for m, (s, _) in
                  zip(drawn, sites))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    logits = functional_call(task.model, params, (xt,),
                             {"dropout_masks": masks})
    _close(logits.detach(), jlogits)
    got = dict(jax.tree_util.tree_leaves_with_path(
        params_to_jax(grad(task.loss_fn)(params, xt, yt, masks))))
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jgrads)):
        _close(got[path], w)
    return drawn


@pytest.mark.parametrize("model,shape", [
    ("cct_2_3x2_32", (32, 32, 3)),
    ("cvt_2_4_32", (32, 32, 3)),
    ("cct_2_3x2_32_sine", (32, 32, 3)),
    ("cct", (28, 28, 1)),
])
def test_train_mode_logits_and_grads_match_flax(monkeypatch, model, shape):
    spec = dict(model=model, input_shape=shape, num_classes=10)
    drawn = _train_parity(monkeypatch, JaxTaskSpec(**spec).build(),
                          TaskSpec(**spec).build(), shape)
    seq = 49 if shape[0] == 28 else 64
    # Block 0 draws its attention mask only (drop-path rate 0), block 1
    # its attention mask and one stochastic-depth draw per branch.
    assert [m.shape for m in drawn] == [(1, 1, seq, seq)] * 2 + [(2, 1, 1)] * 2
    assert not all(m.all() for m in drawn)


def test_every_dropout_site_matches_flax(monkeypatch):
    """A CCT with ``dropout`` on (the zoo leaves it at 0): flax's
    ``Dropout`` after the positional embedding, after attention, after
    the GELU and after the MLP, in its draw order."""
    kw = dict(embed_dim=32, num_layers=2, num_heads=2, mlp_ratio=2.0,
              dropout=0.2, attn_dropout=0.1, stochastic_depth=0.3)
    jm = jcct.CCT(**kw)
    jax_register_model("cct_all_sites_test", lambda num_classes=10: jm)
    register_model("cct_all_sites_test",
                   lambda num_classes=10, input_shape=None: cct.CCT(
                       **kw, num_classes=num_classes,
                       input_shape=input_shape))
    spec = dict(model="cct_all_sites_test", input_shape=(16, 16, 3))
    drawn = _train_parity(monkeypatch, JaxTaskSpec(**spec).build(),
                          TaskSpec(**spec).build(), (16, 16, 3), batch=3)
    # The root's site, block 0's four (drop-path rate 0), block 1's six.
    assert len(drawn) == 1 + 4 + 6


def test_sinusoidal_embedding_matches_jax():
    for seq, dim in ((64, 128), (49, 256), (7, 10)):
        np.testing.assert_allclose(
            cct.sinusoidal_embedding(seq, dim).numpy(),
            np.asarray(jcct.sinusoidal_embedding(seq, dim)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,tokens", [((32, 32, 3), 64),
                                          ((28, 28, 1), 49),
                                          ((16, 16, 3), 16)])
def test_token_count_comes_from_the_input_shape(shape, tokens):
    for name in ("cct_2_3x2_32", "cct_7_3x1_32", "cvt_2_4_32"):
        with torch.device("meta"):
            model = get_model(name, 10, shape)
        jm = ModelCatalog.get_model(name, 10)
        pe = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1,) + shape)))["params"][
                "pos_embed"]
        assert tuple(model.pos_embed.shape) == pe.shape
        if name != "cct_7_3x1_32":  # one tokenizer stage: 4x the tokens
            assert model.seq_len == tokens


def test_num_classes_none_keeps_the_builders_default():
    for name, classes in (("cct_7_3x1_32_c100", 100),
                          ("cct_7_3x1_32_sine_c100", 100),
                          ("cct_2_3x2_32", 10)):
        with torch.device("meta"):
            model = get_model(name, None, (32, 32, 3))
        assert model.Dense_1.out_features == classes
        assert ModelCatalog.get_model(name, None).num_classes == classes
    with torch.device("meta"):
        assert get_model("cct_7_3x1_32_c100", 10,
                         (32, 32, 3)).Dense_1.out_features == 10
    assert get_model("resnet10", None, (32, 32, 3)).Dense_0.out_features == 10


def test_register_model_and_callable_specs():
    seen = {}

    def builder(num_classes=10, input_shape=None):
        seen["args"] = (num_classes, input_shape)
        return cct.CCT(num_classes=num_classes, embed_dim=16, num_layers=1,
                       num_heads=2, input_shape=input_shape)

    register_model("My_CCT", builder)
    model = get_model("my_cct", 7, (16, 16, 3))
    assert seen["args"] == (7, (16, 16, 3))
    assert model.Dense_1.out_features == 7 and model.seq_len == 16
    # A builder without input_shape gets num_classes only.
    register_model("tiny_mlp", lambda num_classes=10: cct.CCT(
        num_classes=num_classes, embed_dim=16, num_layers=1))
    assert get_model("tiny_mlp", 3).Dense_1.out_features == 3
    # A registered name wins over a built-in one, as in the JAX catalog.
    register_model("cct_2_3x2_32", builder)
    try:
        assert get_model("cct_2_3x2_32", 5, (32, 32, 3)).embed_dim == 16
    finally:
        from blades_tpu_torch.models import catalog
        catalog._CUSTOM.pop("cct_2_3x2_32")
    assert get_model("cct_2_3x2_32", 5, (32, 32, 3)).embed_dim == 128
    # Callable specs are called; modules are returned as they are.
    made = get_model(lambda: builder(4, (32, 32, 3)))
    assert made.Dense_1.out_features == 4
    assert get_model(made) is made
    with pytest.raises(KeyError):
        get_model("no_such_model")


def _port_params(name, shape, seed=0, **kw):
    task = TaskSpec(model=name, input_shape=shape, **kw).build()
    return task.init_params(torch.Generator().manual_seed(seed))


def test_init_params_draws_pos_embed_and_attention_kernels():
    params = _port_params("cct_2_3x2_32", (32, 32, 3))
    pe = params["pos_embed"]
    assert pe.abs().max() <= 0.4 and 0.15 < pe.std() < 0.25
    q = params["EncoderBlock_0.MultiHeadDotProductAttention_0.query.weight"]
    o = params["EncoderBlock_0.MultiHeadDotProductAttention_0.out.weight"]
    # lecun-normal with flax's fan-in: 128 for q/k/v, heads x head_dim
    # (128) for out; truncated at two standard deviations.
    for w in (q, o):
        std = (1 / 128) ** 0.5
        assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
        assert 0.8 * std < w.std() < 1.2 * std
    for k, v in params.items():
        if k.endswith("bias"):
            assert not v.any()


def test_npz_written_by_the_port_loads_in_jax_and_back(tmp_path):
    params = _port_params("cct_2_3x2_32", (32, 32, 3))
    path = tmp_path / "port.npz"
    cct.save_params(params, path)
    jp = _jax_params(jcct.cct_2_3x2_32(), (32, 32, 3), seed=5)
    merged = jcct.load_pretrained_params(jp, path)
    want = params_to_jax(params)
    for k, v in traverse_util.flatten_dict(want).items():
        np.testing.assert_array_equal(
            np.asarray(traverse_util.flatten_dict(merged)[k]), v)
    back = cct.load_pretrained_params(_port_params("cct_2_3x2_32",
                                                   (32, 32, 3), seed=9),
                                      path)
    for k, v in params.items():
        assert torch.equal(back[k], v)


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    jp = _jax_params(jcct.VARIANTS["cvt_2_4_32"](), (32, 32, 3))
    path = tmp_path / "jax.npz"
    jcct.save_params(jp, path)
    loaded = cct.load_pretrained_params(
        _port_params("cvt_2_4_32", (32, 32, 3)), path)
    for k, v in traverse_util.flatten_dict(params_to_jax(loaded)).items():
        np.testing.assert_array_equal(
            v, np.asarray(traverse_util.flatten_dict(jp)[k]))


@pytest.mark.parametrize("img", [48, 16])
def test_pos_embed_resize_matches_jax(tmp_path, img):
    """64 tokens resized to 144 (48x48 inputs) and to 16 (16x16): the
    port's antialiased bilinear against ``jax.image.resize``."""
    jp = _jax_params(jcct.cct_2_3x2_32(), (32, 32, 3))
    path = tmp_path / "src.npz"
    jcct.save_params(jp, path)
    shape = (img, img, 3)
    jdst = _jax_params(jcct.cct_2_3x2_32(), shape, seed=2)
    want = jcct.load_pretrained_params(jdst, path)
    got = cct.load_pretrained_params(_port_params("cct_2_3x2_32", shape),
                                     path)
    tokens = (img // 4) ** 2
    assert got["pos_embed"].shape == (1, tokens, 128)
    np.testing.assert_allclose(got["pos_embed"].numpy(),
                               np.asarray(want["pos_embed"]), rtol=1e-5,
                               atol=1e-6)
    for k, v in traverse_util.flatten_dict(params_to_jax(got)).items():
        if k != ("pos_embed",):
            np.testing.assert_array_equal(
                v, np.asarray(traverse_util.flatten_dict(want)[k]))


def test_head_skip_keeps_a_fresh_head_and_loads_the_body(tmp_path):
    params = _port_params("cct_2_3x2_32", (32, 32, 3))
    path = tmp_path / "c10.npz"
    cct.save_params(params, path)
    fresh = _port_params("cct_2_3x2_32", (32, 32, 3), seed=3,
                         num_classes=100)
    merged = cct.load_pretrained_params(fresh, path)
    for k, v in merged.items():
        want = fresh[k] if k.startswith("Dense_1.") else params[k]
        assert torch.equal(v, want), k
    with pytest.raises(ValueError, match="shape mismatch"):
        cct.load_pretrained_params(fresh, path, skip_mismatched_head=False)


def test_load_errors(tmp_path):
    params = _port_params("cct_2_3x2_32", (32, 32, 3))
    # A wider backbone kernel raises; only the head may be skipped.
    flat = {"/".join(k): v for k, v in traverse_util.flatten_dict(
        params_to_jax(params)).items()}
    key = "EncoderBlock_0/Dense_0/kernel"
    flat[key] = np.zeros(flat[key].shape[:-1] + (flat[key].shape[-1] + 8,),
                         np.float32)
    np.savez(tmp_path / "wide.npz", **flat)
    with pytest.raises(ValueError, match="shape mismatch"):
        cct.load_pretrained_params(params, tmp_path / "wide.npz")
    # Another family: the MLP's Dense_0 collides with SeqPool's Dense_0.
    mp = jax.tree.map(np.asarray, JaxMLP().init(
        jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 1)))["params"])
    jcct.save_params(mp, tmp_path / "mlp.npz")
    with pytest.raises(ValueError, match="shape mismatch|matched NO"):
        cct.load_pretrained_params(params, tmp_path / "mlp.npz")
    np.savez(tmp_path / "none.npz", other=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="matched NO parameter"):
        cct.load_pretrained_params(params, tmp_path / "none.npz")
    # A non-square token grid cannot be resized: 32x16 inputs, 8x4 tokens.
    cct.save_params(params, tmp_path / "square.npz")
    with pytest.raises(ValueError, match="non-square"):
        cct.load_pretrained_params(
            _port_params("cct_2_3x2_32", (32, 16, 3)),
            tmp_path / "square.npz")
    with pytest.raises(NotImplementedError, match="msgpack"):
        cct.load_pretrained_params(params, tmp_path / "x.msgpack")
    with pytest.raises(ValueError, match="unsupported checkpoint format"):
        cct.load_pretrained_params(params, tmp_path / "x.pt")
