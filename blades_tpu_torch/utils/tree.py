"""Parameter dict <-> flat-vector layout.

Client updates travel as flat ``(d,)`` vectors, so aggregators are plain
``(n, d) -> (d,)`` tensor programs.  The coordinates follow the JAX
reference's ``jax.flatten_util.ravel_pytree`` order over the flax param
tree exactly, so a row of the port's update matrix and a row of the
reference's can be compared coordinate by coordinate:

- leaves ordered by their flax path with dict keys sorted at every level
  (``BasicBlock_0 < BatchStatsNorm_0 < Conv_0 < Dense_0``; ``bias < kernel
  < scale`` inside a module);
- conv kernels flattened in flax's HWIO layout (a torch OIHW weight is
  permuted before flattening and back on unravel);
- dense kernels flattened in ``(in, out)`` layout (a torch ``(out, in)``
  weight is transposed).

A torch parameter name ``"A.B.weight"`` maps to the flax path
``("A", "B", "kernel")`` for a weight of two or more dimensions and to
``("A", "B", "scale")`` for a 1-D (normalisation) weight; ``bias`` and any
other leaf name (CCT's root-level ``pos_embed``) keep their names.  Only
4-D and 2-D weights change layout; the others (the attention kernels of
:class:`~blades_tpu_torch.models.cct.DenseGeneral`) are stored in flax's.
Module names in the port's models equal flax's auto-names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

# torch layout -> flax layout, by weight rank
_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0)}


def flax_path(name: str, ndim: int) -> Tuple[str, ...]:
    """The flax path of the torch parameter ``name`` of rank ``ndim``."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    elif leaf in ("kernel", "scale"):
        raise ValueError(f"no flax counterpart for parameter {name!r}")
    return tuple(mods) + (leaf,)


def torch_name(path: Tuple[str, ...]) -> str:
    """Inverse of :func:`flax_path`."""
    leaf = "weight" if path[-1] in ("kernel", "scale") else path[-1]
    return ".".join(path[:-1] + (leaf,))


def to_flax_perm(name: str, ndim: int):
    """Permutation taking the torch tensor to flax layout (None: same)."""
    return _TO_FLAX.get(ndim) if name.endswith("weight") else None


def _inverse(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


@dataclass(frozen=True)
class Leaf:
    name: str              # torch parameter name
    path: Tuple[str, ...]  # flax path
    shape: torch.Size      # torch shape
    perm: tuple            # torch -> flax permutation, or None
    offset: int
    size: int


class FlatLayout:
    """The flat layout of a ``{name: tensor}`` parameter dict (torch
    layout).  Built from the dict itself, like the reference's
    ``ravel_fn(example)``."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        items = sorted(params.items(),
                       key=lambda kv: flax_path(kv[0], kv[1].dim()))
        leaves: List[Leaf] = []
        off = 0
        for name, t in items:
            leaves.append(Leaf(name, flax_path(name, t.dim()), t.shape,
                               to_flax_perm(name, t.dim()), off, t.numel()))
            off += t.numel()
        self.leaves = tuple(leaves)
        self.d = off

    def flat_leaf(self, leaf: Leaf, t: torch.Tensor, batch_dims: int = 0):
        """``t`` (torch layout, ``batch_dims`` leading dims) flattened in
        flax order: ``(*batch, size)``."""
        if leaf.perm is not None:
            lead = tuple(range(batch_dims))
            t = t.permute(lead + tuple(p + batch_dims for p in leaf.perm))
        return t.reshape(t.shape[:batch_dims] + (leaf.size,))

    def ravel(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``(d,)`` flat vector of ``params`` in the reference's order."""
        return torch.cat([self.flat_leaf(lf, params[lf.name])
                          for lf in self.leaves])

    def unravel(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`ravel`: a dict in torch layout."""
        out = {}
        for lf in self.leaves:
            seg = vec[lf.offset:lf.offset + lf.size]
            if lf.perm is None:
                out[lf.name] = seg.reshape(lf.shape)
            else:
                fshape = tuple(lf.shape[p] for p in lf.perm)
                out[lf.name] = seg.reshape(fshape).permute(
                    _inverse(lf.perm)).contiguous()
        return out
