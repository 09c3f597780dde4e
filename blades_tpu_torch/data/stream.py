"""Cohort data staging and streaming evaluation over the out-of-core data
store (counterpart of ``blades_tpu/data/stream.py``).

- :class:`DataPrefetcher` is the data plane's staging adapter: the
  windowed round hands it to the
  :class:`~blades_tpu_torch.state.prefetch.StatePrefetcher`, so cohort
  shards ride the same worker (and copy stream) as the state rows; the
  async cycle gathers event shards through it inline.  It is the one
  place ``data_stage_ms`` / ``data_bytes_staged`` are observed.
- :func:`streaming_evaluate` walks the test set in chunks of
  ``eval_chunk_clients`` clients instead of putting the whole stack on
  the card: per chunk the four per-client sums, accumulated on the host
  in float64, then the monolithic evaluation's ratios.  It differs from
  :meth:`~blades_tpu_torch.core.round.FedRound.evaluate` only in the
  order of summation; two streaming walks at the same chunking agree bit
  for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from blades_tpu_torch.data.store import DataStats, DataStore
from blades_tpu_torch.obs.trace import now

#: The per-client sums ``Task.evaluate`` returns.
EVAL_SUM_KEYS = ("ce_sum", "top1_sum", "top3_sum", "count")

#: Default clients per evaluation chunk.
DEFAULT_EVAL_CHUNK_CLIENTS = 256


class DataPrefetcher:
    """Cohort shards from a :class:`DataStore`, with staging telemetry.
    Training data never changes, so a gather cannot race a write."""

    def __init__(self, store: DataStore):
        self._store = store
        self.stats = DataStats()

    @property
    def store(self) -> DataStore:
        return self._store

    def gather(self, ids: np.ndarray, device=None
               ) -> Tuple[torch.Tensor, ...]:
        """``(x, y, lengths)`` of ``ids`` on ``device``; ``y`` and
        ``lengths`` as int64, as the rounds index with them."""
        t0 = now()
        x, y, ln = self._store.gather(ids, device=device)
        rows = (x, y.long(), ln.long())
        self.stats.observe(now() - t0,
                           sum(t.numel() * t.element_size()
                               for t in (x, y, ln)))
        return rows

    def close(self) -> None:
        self._store.close()


def make_chunk_evaluator(task) -> Callable:
    """``chunk_sums(params, cx, cy, lengths) -> {key: f32 scalar}``: the
    masked per-client evaluation of one chunk reduced to the four
    :data:`EVAL_SUM_KEYS` sums (zero-length padding clients add exact
    zeros)."""

    def chunk_sums(params, cx, cy, lengths):
        cap = cx.shape[1]
        mask = (torch.arange(cap, device=lengths.device)[None, :]
                < lengths[:, None])
        per_client = task.evaluate(params, cx, cy, mask)
        return {k: per_client[k].sum() for k in EVAL_SUM_KEYS}

    return chunk_sums


def streaming_evaluate(chunk_fn, params, test_arrays,
                       chunk_clients: int = DEFAULT_EVAL_CHUNK_CLIENTS,
                       device=None) -> Tuple[Dict[str, float], int]:
    """Walk host test arrays ``(x, y, lengths)`` through ``chunk_fn`` in
    ``chunk_clients``-client chunks (the last one padded with zero-length
    clients), one chunk on ``device`` at a time, the sums added on the
    host in float64.  Returns ``(metrics, number of chunks)``."""
    tx, ty, tln = test_arrays
    n = int(np.shape(tx)[0])
    chunk_clients = max(1, min(int(chunk_clients), n))
    totals = {k: 0.0 for k in EVAL_SUM_KEYS}
    n_chunks = -(-n // chunk_clients)
    for c in range(n_chunks):
        lo, hi = c * chunk_clients, min((c + 1) * chunk_clients, n)
        cx, cy, cln = tx[lo:hi], ty[lo:hi], tln[lo:hi]
        if hi - lo < chunk_clients:
            pad = chunk_clients - (hi - lo)
            cx = np.concatenate(
                [cx, np.zeros((pad,) + np.shape(cx)[1:], cx.dtype)])
            cy = np.concatenate(
                [cy, np.zeros((pad,) + np.shape(cy)[1:], cy.dtype)])
            cln = np.concatenate([cln, np.zeros((pad,), cln.dtype)])
        sums = chunk_fn(params, torch.from_numpy(np.ascontiguousarray(cx))
                        .to(device).float(),
                        torch.from_numpy(np.ascontiguousarray(cy)).to(
                            device).long(),
                        torch.from_numpy(np.ascontiguousarray(cln)).to(
                            device).long())
        for k in EVAL_SUM_KEYS:
            totals[k] += float(sums[k])
    total = max(totals["count"], 1.0)
    return {
        "test_loss": totals["ce_sum"] / total,
        "test_acc": totals["top1_sum"] / total,
        "test_acc_top3": totals["top3_sum"] / total,
        "num_samples": total,
    }, n_chunks
