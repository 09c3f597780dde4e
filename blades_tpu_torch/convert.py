"""Weights carried across between the JAX reference and the port.

:func:`params_from_jax` turns a flax param tree, given as nested dicts of
numpy arrays, into the port's ``{name: tensor}`` dict (torch layout);
:func:`params_to_jax` goes the other way.  Conv kernels move between flax
HWIO and torch OIHW, dense kernels between ``(in, out)`` and
``(out, in)``; biases (the CNN's convolutions have them) and norm scales
keep their layout.  See :mod:`blades_tpu_torch.utils.tree` for the
naming rule.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from blades_tpu_torch.utils.tree import flax_path, to_flax_perm, torch_name


def _walk(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree: Any, device=None) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves) -> the port's parameter dict."""
    out = {}
    for path, v in _walk(tree):
        arr = np.asarray(v)
        name = torch_name(path)
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        perm = to_flax_perm(name, arr.ndim)
        if perm is not None:  # flax layout -> torch layout
            inv = [0] * len(perm)
            for i, p in enumerate(perm):
                inv[p] = i
            t = t.permute(inv)
        out[name] = t.contiguous().to(device) if device else t.contiguous()
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's parameter dict -> a flax param tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, t in params.items():
        path = flax_path(name, t.dim())
        perm = to_flax_perm(name, t.dim())
        t = t.detach().float().cpu()
        if perm is not None:
            t = t.permute(perm)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.contiguous().numpy()
    return tree
