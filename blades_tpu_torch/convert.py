"""Weights carried across between the JAX reference and the port.

:func:`params_from_jax` turns a flax param tree, given as nested dicts of
numpy arrays, into the port's ``{name: tensor}`` dict (torch layout);
:func:`params_to_jax` goes the other way;
:func:`async_state_from_jax` carries the async engine's params ring and
host state over, and :func:`store_from_jax_checkpoint` reads a JAX
state-store shard checkpoint into a port store.  Conv kernels move between flax
HWIO and torch OIHW, dense kernels between ``(in, out)`` and
``(out, in)``; biases (the CNN's convolutions have them), norm scales,
CCT's ``pos_embed`` and its attention kernels (stored in flax's layout)
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


def async_state_from_jax(history, host_state, device=None):
    """The JAX async engine's ``(H+1, d)`` params-history ring and its
    ``host_state()`` for the port: the ring is in the JAX package's ravel
    order, which is the port's flat layout order, so it carries over as
    is; the host state is plain ints and lists, copied for
    :meth:`~blades_tpu_torch.arrivals.AsyncEngine.restore_host_state`."""
    import copy

    ring = torch.from_numpy(np.array(history, dtype=np.float32))
    return (ring.to(device) if device else ring), copy.deepcopy(
        dict(host_state))


def store_from_jax_checkpoint(directory, store) -> None:
    """A JAX state-store shard checkpoint (``shard-<s>.l<j>.npy`` plus
    ``manifest.json``) into a port store.  The JAX row splits the
    optimizer state into one leaf per parameter (flax layout, ravel
    order), then the codec's residual; the port keeps the optimizer state
    as one flat ``client_opt`` leaf in that same order, so the JAX leaves
    of a shard are joined row by row.  Every file's size, shape and CRC32
    is verified as :meth:`ClientStateStore.load` verifies the port's."""
    from pathlib import Path

    from blades_tpu_torch.state.store import (
        StateStoreError,
        iter_shards,
        read_manifest,
    )

    directory = Path(directory)
    manifest = read_manifest(directory, store.n_registered)
    leaves = manifest["leaves"]
    sizes = [int(np.prod(leaf["shape"])) for leaf in leaves]
    has_res = "residual" in store.names
    opt_leaves = len(leaves) - (1 if has_res else 0)
    want = dict(zip(store.names, (int(np.prod(s)) for s in store._shapes)))
    got = {}
    if opt_leaves or "client_opt" in store.names:
        got["client_opt"] = sum(sizes[:opt_leaves])
    if has_res:
        got["residual"] = sizes[-1]
    if got != want:
        raise StateStoreError(
            f"JAX state-store checkpoint {directory} holds leaves of "
            f"{sizes} values a row; this store's template takes {want}")
    for _, lo, hi, arrays in iter_shards(directory, manifest):
        rows = {}
        if "client_opt" in store.names:
            rows["client_opt"] = torch.from_numpy(np.concatenate(
                [a.reshape(hi - lo, -1) for a in arrays[:opt_leaves]],
                axis=1).astype(np.float32))
        if has_res:
            rows["residual"] = torch.from_numpy(
                arrays[-1].reshape(hi - lo, -1))
        store._put(np.arange(lo, hi, dtype=np.int64),
                   [rows[k] for k in store.names])
