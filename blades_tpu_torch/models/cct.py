"""Compact Convolutional Transformer and Compact Vision Transformer
(counterpart of ``blades_tpu/models/cct.py``).

CCT: a convolutional tokenizer (``n_conv_layers`` of conv k x k without
bias -> ReLU -> 3x3 / stride 2 max-pool with padding 1), a learnable or
sinusoidal positional embedding, pre-norm encoder blocks (multi-head
attention, then a GELU MLP, each residual branch under stochastic depth)
and sequence pooling (``Dense_0`` -> softmax over the tokens -> weighted
sum) before the head ``Dense_1``.  CVT swaps the tokenizer for one patch
convolution with bias at the root (``Conv_0``).

Module names equal flax's auto-names, so the flat layout
(:class:`~blades_tpu_torch.utils.tree.FlatLayout`) is ``ravel_pytree``'s:
``Tokenizer_0.Conv_i``, ``pos_embed`` at the root, ``EncoderBlock_i``
holding ``LayerNorm_0``, ``MultiHeadDotProductAttention_0`` (``query``,
``key``, ``value``, ``out``), ``LayerNorm_1``, ``Dense_0`` and
``Dense_1``; then the root's ``LayerNorm_0``, ``Dense_0``, ``Dense_1``.
The attention projections keep flax's ``DenseGeneral`` layout
(:class:`DenseGeneral`): ``query`` / ``key`` / ``value`` kernels ``(in,
heads, head_dim)`` with ``(heads, head_dim)`` biases, ``out`` ``(heads,
head_dim, out)``.  A ``(out, in)`` matrix would lose the head count that
the flax layout needs on the way back.

The token count, and so ``pos_embed``'s shape, follows from
``input_shape`` by arithmetic, as flax infers it at init, never from
``img_size``: 32 -> 16 -> 8 gives 64 tokens, 28 -> 14 -> 7 gives 49, a
4 x 4 patch on 32 x 32 gives 64.

Flax's numerics are kept: LayerNorm ``epsilon=1e-6``; ``nn.gelu``'s tanh
form; the query divided by sqrt(head_dim) before the product, softmax
over the keys, attention dropout as ``weights * (keep / keep_prob)`` with
one ``(q, kv)`` keep-mask broadcast over the batch and the heads (flax's
``broadcast_dropout``); stochastic depth as ``where(mask, x / keep, 0)``
with one draw per sample, at rate ``stochastic_depth * i / max(L - 1,
1)`` in block ``i`` (so block 0 draws nothing).

Dropout takes its keep-masks as an argument (``dropout_masks``: one
bool tensor per dropout site, in the order flax draws them, for one
client's step); :meth:`CCT.dropout_sites` states each site's shape and
rate for a batch.  Evaluation passes no masks, which is flax's
``train=False``.

:func:`load_pretrained_params` / :func:`save_params` read and write flat
``.npz`` files with ``"a/b/c"`` keys in flax names and layouts, the JAX
package's format, so a file either package writes loads in the other.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon


def sinusoidal_embedding(num_pos: int, dim: int,
                         device=None) -> torch.Tensor:
    """``(1, num_pos, dim)`` f32: ``sin`` on even features, ``cos`` on odd
    ones, of ``pos / 10000 ** (2 * (i // 2) / dim)``."""
    pos = torch.arange(num_pos, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, (2 * torch.floor(i / 2)) / dim)
    emb = torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))
    return emb[None]


def token_count(input_shape: Sequence[int], kernel_size: int,
                n_conv_layers: Optional[int]) -> int:
    """Tokens a CCT tokenizer (``n_conv_layers`` given) or a CVT patch
    embedding (``None``) makes from an NHWC ``input_shape``."""
    h, w = input_shape[0], input_shape[1]
    k = kernel_size
    if n_conv_layers is None:  # VALID conv, stride k
        return ((h - k) // k + 1) * ((w - k) // k + 1)
    for _ in range(n_conv_layers):
        # conv with padding k // 2, then the 3x3 / 2 pool with padding 1
        h, w = h + 2 * (k // 2) - k + 1, w + 2 * (k // 2) - k + 1
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return h * w


class DenseGeneral(nn.Module):
    """flax's ``DenseGeneral`` in flax's layout: ``weight`` (the flax
    ``kernel``) ``(*in_shape, *out_shape)``, ``bias`` ``out_shape``.
    ``kernel_fan_in`` is flax's fan-in for its lecun-normal init."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(tuple(in_shape)
                                               + tuple(out_shape)))
        self.bias = nn.Parameter(torch.zeros(tuple(out_shape)))
        self.kernel_fan_in = math.prod(in_shape)
        self._n_in = len(in_shape)

    def forward(self, x):
        n_in = self._n_in
        w = self.weight.reshape(self.kernel_fan_in, -1)
        y = x.reshape(x.shape[:x.dim() - n_in] + (-1,)) @ w
        return y.reshape(y.shape[:-1] + self.bias.shape) + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax's self-attention with its parameter layout and numerics."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embed dim {dim} is not divisible by "
                             f"{num_heads} heads")
        hd = dim // num_heads
        self.head_dim = hd
        self.dropout_rate = dropout_rate
        self.query = DenseGeneral((dim,), (num_heads, hd))
        self.key = DenseGeneral((dim,), (num_heads, hd))
        self.value = DenseGeneral((dim,), (num_heads, hd))
        self.out = DenseGeneral((num_heads, hd), (dim,))

    def forward(self, x, keep=None):
        q = self.query(x)  # (B, q, heads, head_dim)
        k = self.key(x)
        v = self.value(x)
        q = q / math.sqrt(self.head_dim)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k).softmax(-1)
        if keep is not None:  # one (q, kv) mask for every sample and head
            keep_prob = 1.0 - self.dropout_rate
            w = w * (keep.to(w.dtype) / keep_prob)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class StochasticDepth(nn.Module):
    """Per-sample residual drop: ``where(mask, x / keep, 0)`` with one
    keep draw per sample (``mask`` of shape ``(B,)``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, mask=None):
        if mask is None:
            return x
        mask = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


def _dropout(x, mask, rate):
    """flax's ``nn.Dropout``: ``where(mask, x / keep, 0)``."""
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


class _Masks:
    """Hands out the keep-masks of one step in site order; every site
    asks, and a site of rate 0 (or a call without masks) gets None."""

    def __init__(self, masks):
        self._it = None if masks is None else iter(masks)

    def take(self, rate: float):
        if self._it is None or rate == 0.0:
            return None
        return next(self._it)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.0,
                 attn_dropout: float = 0.1, dropout: float = 0.1,
                 drop_path: float = 0.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.rates = (attn_dropout, dropout, drop_path)
        self.hidden = hidden
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, num_heads, attn_dropout)
        self.StochasticDepth_0 = StochasticDepth(drop_path)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = nn.Linear(dim, hidden)
        self.Dense_1 = nn.Linear(hidden, dim)
        self.StochasticDepth_1 = StochasticDepth(drop_path)

    def sites(self, batch: int, seq: int, dim: int):
        """``(shape, rate)`` of each dropout site, in flax's draw order."""
        attn, drop, path = self.rates
        return ((((seq, seq), attn), ((batch, seq, dim), drop),
                 ((batch,), path), ((batch, seq, self.hidden), drop),
                 ((batch, seq, dim), drop), ((batch,), path)))

    def forward(self, x, masks: _Masks):
        attn, drop, path = self.rates
        y = self.LayerNorm_0(x)
        y = self.MultiHeadDotProductAttention_0(y, masks.take(attn))
        y = _dropout(y, masks.take(drop), drop)
        x = x + self.StochasticDepth_0(y, masks.take(path))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        y = _dropout(y, masks.take(drop), drop)
        y = _dropout(self.Dense_1(y), masks.take(drop), drop)
        return x + self.StochasticDepth_1(y, masks.take(path))


class Tokenizer(nn.Module):
    """``n_conv_layers`` of (conv k x k, no bias, padding k // 2 -> ReLU ->
    3x3 / 2 max-pool, padding 1), flattened to ``(B, H*W, C)`` in
    row-major ``(h, w)`` order."""

    def __init__(self, in_channels: int, embed_dim: int, kernel_size: int = 3,
                 n_conv_layers: int = 2):
        super().__init__()
        prev = in_channels
        for i in range(n_conv_layers):
            f = embed_dim // (2 ** (n_conv_layers - 1 - i))
            setattr(self, f"Conv_{i}", nn.Conv2d(
                prev, f, kernel_size, padding=kernel_size // 2, bias=False))
            prev = f
        self.n_conv_layers = n_conv_layers

    def forward(self, x):  # x: NCHW
        for i in range(self.n_conv_layers):
            x = torch.relu(getattr(self, f"Conv_{i}")(x))
            x = F.max_pool2d(x, 3, 2, padding=1)
        return x.flatten(2).transpose(1, 2)


class CCT(nn.Module):
    """CCT for NHWC inputs of ``input_shape``."""

    def __init__(self, num_classes: int = 10, embed_dim: int = 128,
                 num_layers: int = 2, num_heads: int = 2,
                 mlp_ratio: float = 1.0, kernel_size: int = 3,
                 n_conv_layers: int = 2,
                 positional_embedding: str = "learnable",
                 dropout: float = 0.0, attn_dropout: float = 0.1,
                 stochastic_depth: float = 0.1, img_size: int = 32,
                 input_shape: Sequence[int] = None):
        super().__init__()
        if positional_embedding not in ("learnable", "sine", "none"):
            raise ValueError("positional_embedding must be learnable|sine|"
                             f"none, got {positional_embedding!r}")
        input_shape = tuple(input_shape or (img_size, img_size, 3))
        self.embed_dim = embed_dim
        self.positional_embedding = positional_embedding
        self.dropout = dropout
        self.seq_len = self._make_tokenizer(input_shape, embed_dim,
                                            kernel_size, n_conv_layers)
        if positional_embedding == "learnable":
            self.pos_embed = nn.Parameter(
                torch.zeros(1, self.seq_len, embed_dim))
        dpr = [stochastic_depth * i / max(num_layers - 1, 1)
               for i in range(num_layers)]
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"EncoderBlock_{i}", EncoderBlock(
                embed_dim, num_heads, mlp_ratio, attn_dropout, dropout,
                dpr[i]))
        self.LayerNorm_0 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.Dense_0 = nn.Linear(embed_dim, 1)
        self.Dense_1 = nn.Linear(embed_dim, num_classes)

    def _make_tokenizer(self, input_shape, embed_dim, kernel_size,
                        n_conv_layers) -> int:
        self.Tokenizer_0 = Tokenizer(input_shape[-1], embed_dim, kernel_size,
                                     n_conv_layers)
        return token_count(input_shape, kernel_size, n_conv_layers)

    def tokenize(self, x):
        return self.Tokenizer_0(x)

    def _blocks(self):
        return [getattr(self, f"EncoderBlock_{i}")
                for i in range(self.num_layers)]

    def dropout_sites(self, batch: int):
        """``(shape, rate)`` of every dropout site of one client's step on
        a batch of ``batch``, in the order the masks are consumed (flax's
        draw order); sites of rate 0 are left out."""
        sites = [((batch, self.seq_len, self.embed_dim), self.dropout)]
        for blk in self._blocks():
            sites += blk.sites(batch, self.seq_len, self.embed_dim)
        return tuple(s for s in sites if s[1] > 0.0)

    def forward(self, x, dropout_masks=None):
        masks = _Masks(dropout_masks)
        x = self.tokenize(x.permute(0, 3, 1, 2))  # NHWC -> NCHW -> tokens
        if self.positional_embedding == "learnable":
            x = x + self.pos_embed
        elif self.positional_embedding == "sine":
            x = x + sinusoidal_embedding(x.shape[1], self.embed_dim,
                                         x.device).to(x.dtype)
        x = _dropout(x, masks.take(self.dropout), self.dropout)
        for blk in self._blocks():
            x = blk(x, masks)
        x = self.LayerNorm_0(x)
        attn = self.Dense_0(x).softmax(1)  # (B, seq, 1)
        x = torch.einsum("bso,bsd->bd", attn, x)
        return self.Dense_1(x)


class CVT(CCT):
    """CCT's encoder and pooling behind a patch embedding: one conv with
    stride = kernel = patch size (default 4), with bias, no pooling."""

    def __init__(self, *args, kernel_size: int = 4, **kwargs):
        super().__init__(*args, kernel_size=kernel_size, **kwargs)

    def _make_tokenizer(self, input_shape, embed_dim, kernel_size,
                        n_conv_layers) -> int:
        k = kernel_size
        self.Conv_0 = nn.Conv2d(input_shape[-1], embed_dim, k, stride=k)
        return token_count(input_shape, k, None)

    def tokenize(self, x):
        return self.Conv_0(x).flatten(2).transpose(1, 2)


# ---------------------------------------------------------------------------
# The variant zoo: <tier>_<kernel>x<n_conv>_<img> for CCT, <tier>_<patch>_
# <img> for CVT; `_sine` names fix sinusoidal embeddings, `_c100` names
# default to 100 classes.  A builder takes ``num_classes``,
# ``positional_embedding`` and ``input_shape`` (default ``(img, img, 3)``).
# ---------------------------------------------------------------------------

# tier -> (num_layers, num_heads, mlp_ratio, embed_dim)
_TIERS = {
    2: (2, 2, 1.0, 128),
    4: (4, 2, 1.0, 128),
    6: (6, 4, 2.0, 256),
    7: (7, 4, 2.0, 256),
    14: (14, 6, 3.0, 384),
}

# (tier, kernel_size, n_conv_layers, img_size)
_CCT_VARIANTS = [
    (2, 3, 2, 32),
    (4, 3, 2, 32),
    (6, 3, 1, 32),
    (6, 3, 2, 32),
    (7, 3, 1, 32),
    (7, 3, 2, 32),
    (7, 7, 2, 224),
    (14, 7, 2, 224),
    (14, 7, 2, 384),
]

# (tier, patch_size, img_size)
_CVT_VARIANTS = [(2, 4, 32), (4, 4, 32), (6, 4, 32), (7, 4, 32)]

VARIANTS = {}


def _make_cct(tier, kernel, n_conv, img, pe, default_classes=10):
    layers, heads, mlp, dim = _TIERS[tier]

    def build(num_classes: int = default_classes,
              positional_embedding: str = pe, input_shape=None) -> CCT:
        return CCT(num_classes=num_classes, embed_dim=dim, num_layers=layers,
                   num_heads=heads, mlp_ratio=mlp, kernel_size=kernel,
                   n_conv_layers=n_conv,
                   positional_embedding=positional_embedding, img_size=img,
                   input_shape=input_shape)

    return build


def _make_cvt(tier, patch, img, pe):
    layers, heads, mlp, dim = _TIERS[tier]

    def build(num_classes: int = 10, positional_embedding: str = pe,
              input_shape=None) -> CVT:
        return CVT(num_classes=num_classes, embed_dim=dim, num_layers=layers,
                   num_heads=heads, mlp_ratio=mlp, kernel_size=patch,
                   positional_embedding=positional_embedding, img_size=img,
                   input_shape=input_shape)

    return build


for _t, _k, _c, _s in _CCT_VARIANTS:
    _base = f"cct_{_t}_{_k}x{_c}_{_s}"
    VARIANTS[_base] = _make_cct(_t, _k, _c, _s, "learnable")
    VARIANTS[f"{_base}_sine"] = _make_cct(_t, _k, _c, _s, "sine")
for _t, _p, _s in _CVT_VARIANTS:
    _base = f"cvt_{_t}_{_p}_{_s}"
    VARIANTS[_base] = _make_cvt(_t, _p, _s, "learnable")
    VARIANTS[f"{_base}_sine"] = _make_cvt(_t, _p, _s, "sine")
VARIANTS["cct_7_3x1_32_c100"] = _make_cct(7, 3, 1, 32, "learnable",
                                          default_classes=100)
VARIANTS["cct_7_3x1_32_sine_c100"] = _make_cct(7, 3, 1, 32, "sine",
                                               default_classes=100)

globals().update(VARIANTS)

cct_2_3x2_32 = VARIANTS["cct_2_3x2_32"]
cct_4_3x2_32 = VARIANTS["cct_4_3x2_32"]
cct_7_3x1_32 = VARIANTS["cct_7_3x1_32"]
cvt_7_4_32 = VARIANTS["cvt_7_4_32"]


# ---------------------------------------------------------------------------
# Pretrained weights: flat .npz files in flax names and layouts.
# ---------------------------------------------------------------------------


def _to_flat_flax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    from blades_tpu_torch.convert import params_to_jax

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), v

    return dict(walk(params_to_jax(params), ()))


def _from_flat_flax(flat: Dict[str, np.ndarray], like):
    from blades_tpu_torch.convert import params_from_jax

    tree = {}
    for key, v in flat.items():
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    out = params_from_jax(tree)
    return {k: out[k].to(device=t.device, dtype=t.dtype)
            for k, t in like.items()}


def _resize_grid(src: np.ndarray, g_new: int) -> np.ndarray:
    """``(1, g*g, dim)`` -> ``(1, g_new*g_new, dim)``: bilinear over the
    square token grid, antialiased when it shrinks, as
    ``jax.image.resize(..., "bilinear")`` resizes."""
    g_old = int(math.sqrt(src.shape[1]))
    grid = torch.from_numpy(np.asarray(src, np.float32)).reshape(
        1, g_old, g_old, src.shape[-1]).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(g_new, g_new), mode="bilinear",
                         align_corners=False, antialias=True)
    return grid.permute(0, 2, 3, 1).reshape(1, g_new * g_new,
                                            src.shape[-1]).numpy()


def load_pretrained_params(params: Dict[str, torch.Tensor], path, *,
                           resize_pos_embed: bool = True,
                           skip_mismatched_head: bool = True):
    """Merge a saved CCT/CVT parameter file into ``params`` (the port's
    ``{name: tensor}`` dict); returns the merged dict (same names, shapes,
    devices and dtypes).

    - ``.npz``: a flat ``{"a/b/c": array}`` mapping in flax names and
      layouts, as :func:`save_params` (or the JAX package's) writes it.
      ``.msgpack`` needs flax's serialization and raises
      ``NotImplementedError``.
    - A ``pos_embed`` whose token count differs is resized bilinearly
      over the square token grid when ``resize_pos_embed``; a non-square
      grid raises.
    - With ``skip_mismatched_head``, the head (the highest-numbered root
      ``Dense_*``) keeps its fresh values when the class count differs;
      any other shape mismatch raises, and so does a file that matches no
      parameter.
    """
    p = Path(path)
    if p.suffix == ".msgpack":
        raise NotImplementedError(
            ".msgpack checkpoints need flax's serialization, which the port "
            "does not carry; save them as .npz")
    if p.suffix != ".npz":
        raise ValueError(f"unsupported checkpoint format: {p.suffix!r} "
                         "(use .npz)")
    with np.load(p) as z:
        flat_src = {k: z[k] for k in z.files}
    flat_dst = _to_flat_flax(params)
    root_dense = sorted(
        (k.split("/")[0] for k in flat_dst
         if k.count("/") == 1 and k.startswith("Dense_")
         and k.split("/")[0].split("_")[-1].isdigit()),
        key=lambda s: int(s.split("_")[-1]))
    head_module = root_dense[-1] if root_dense else None
    out, matched, skipped = {}, 0, []
    for name, dst in flat_dst.items():
        if name not in flat_src:
            skipped.append(name)
            out[name] = dst
            continue
        src = np.asarray(flat_src[name])
        leaf = name.split("/")[-1]
        if src.shape == dst.shape:
            out[name] = src.astype(dst.dtype)
            matched += 1
            continue
        if (resize_pos_embed and leaf == "pos_embed"
                and src.shape[-1] == dst.shape[-1]):
            g_old = int(math.sqrt(src.shape[1]))
            g_new = int(math.sqrt(dst.shape[1]))
            if g_old * g_old != src.shape[1] or g_new * g_new != dst.shape[1]:
                raise ValueError(
                    f"cannot resize pos_embed {src.shape} -> {dst.shape}: "
                    "non-square token grids")
            out[name] = _resize_grid(src, g_new).astype(dst.dtype)
            matched += 1
            continue
        if (skip_mismatched_head and name.split("/")[0] == head_module
                and leaf in ("kernel", "bias")
                and src.shape[-1] != dst.shape[-1]):
            skipped.append(name)
            out[name] = dst
            continue
        raise ValueError(f"shape mismatch for {name}: checkpoint "
                         f"{src.shape} vs model {dst.shape}")
    if matched == 0:
        raise ValueError(
            f"checkpoint {p} matched NO parameter of the target model "
            f"({len(flat_dst)} leaves; first unmatched: {skipped[:3]}) -- "
            "wrong model family or naming scheme")
    return _from_flat_flax(out, params)


def save_params(params: Dict[str, torch.Tensor], path) -> None:
    """Write the port's parameter dict as a flat ``.npz`` in flax names and
    layouts (the format :func:`load_pretrained_params` reads)."""
    np.savez(path, **_to_flat_flax(params))
