"""Batched device-to-host metric fetches for the training loop
(counterpart of ``blades_tpu/perf/async_metrics.py``).

A round's scalar metrics stay device tensors in a *deferred row*, under
``DEVICE_METRICS_KEY``, until :func:`flush_rows` fetches every pending
row's tensors in one copy.  The sweep flushes every ``metrics_every``
rows, before every checkpoint save and before the preemption hook fires
(a checkpoint must never cover a round whose row is not on disk), and at
the end of a trial.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

#: Key under which a deferred row carries its un-fetched device metrics.
DEVICE_METRICS_KEY = "_device_metrics"


def fetch(tree):
    """The host form of ``tree`` (dicts, lists and tuples of tensors and
    Python values): each tensor a Python scalar or nested list, all of one
    device's tensors copied to the host in one transfer."""
    leaves: List[torch.Tensor] = []

    def collect(t):
        if torch.is_tensor(t):
            leaves.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                collect(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                collect(v)

    collect(tree)
    host = {}
    by_device: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(leaves):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        flat = torch.cat([leaves[i].detach().reshape(-1).double()
                          for i in idx]).cpu()
        off = 0
        for i in idx:
            n = leaves[i].numel()
            host[id(leaves[i])] = flat[off:off + n].reshape(
                leaves[i].shape).to(leaves[i].dtype)
            off += n

    def rebuild(t):
        if torch.is_tensor(t):
            v = host[id(t)]
            return v.item() if v.dim() == 0 else v.tolist()
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return t

    return rebuild(tree)


def flush_rows(rows: List[Dict],
               finalize: Optional[Callable[[Dict], Dict]] = None
               ) -> List[Dict]:
    """Fetch every pending device value across ``rows`` in one transfer,
    then finalize each row (in order) into its host form."""
    pending = [r.get(DEVICE_METRICS_KEY) for r in rows]
    if any(p is not None for p in pending):
        fetched = fetch(pending)
        for row, host in zip(rows, fetched):
            if host is not None:
                row[DEVICE_METRICS_KEY] = host
    if finalize is None:
        return list(rows)
    return [finalize(r) for r in rows]
