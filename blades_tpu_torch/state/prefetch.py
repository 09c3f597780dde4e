"""Double-buffered staging for the participation window (counterpart of
``blades_tpu/state/prefetch.py``).

While round ``r`` computes, one worker stages round ``r+1``'s cohort --
its state rows from the :class:`~blades_tpu_torch.state.store.ClientStateStore`,
its data shards and its malicious-mask rows -- and writes round ``r``'s
updated rows back.  The cohort function is pure in the round index, so
the next cohort is known before the round ends.

**Write-read hazard.**  Consecutive cohorts overlap; a row gathered for
round ``r+1`` before round ``r``'s write-back lands would be stale.  The
stage job gathers only the ids not in the previous cohort; the
overlapping rows are patched in at :meth:`StatePrefetcher.take` from
round ``r``'s output rows, device to device.  Jobs run in order on one
worker, so a stage that revisits round ``r``'s ids runs after its
write-back.

**On the card it is also a CUDA stream hazard.**  The worker moves rows
on a copy stream of its own.  A staged cohort carries an event recorded
on that stream after its copies; :meth:`~StatePrefetcher.take` makes the
round's stream wait on it before the round reads the cohort (and marks
the tensors as used there, so the allocator does not hand their memory
back to the copy stream early).  :meth:`~StatePrefetcher.writeback`
records an event on the round's stream after the round, and the copy
stream waits on it before it reads the rows, so the write-back never
reads rows the round is still writing.  Prefetch on or off changes when
rows move, never their values.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from blades_tpu_torch.obs.trace import now
from blades_tpu_torch.state.store import ClientStateStore, StoreStats


@dataclasses.dataclass
class StagedCohort:
    """One staged participation window, ready for assembly."""

    index: int
    ids: np.ndarray                 # (w,) ascending registered ids
    new_pos: np.ndarray             # cohort positions gathered from the store
    new_rows: Dict[str, torch.Tensor]
    old_pos: np.ndarray             # cohort positions patched from round r
    prev_pos: np.ndarray            # their positions in round r's cohort
    data: Tuple[torch.Tensor, ...]  # (x, y, lengths) cohort shards
    malicious: torch.Tensor         # (w,) bool
    bytes_staged: int
    stage_seconds: float
    event: Any = None               # the copy stream's event on the card


def _tensors(sc: StagedCohort):
    yield from sc.new_rows.values()
    yield from sc.data
    yield sc.malicious


class StatePrefetcher:
    """Stage round ``r+1``'s cohort while round ``r`` computes, and write
    round ``r``'s rows back, on one in-order worker.

    ``data`` is ``(x, y, lengths)`` host arrays or a
    :class:`~blades_tpu_torch.data.stream.DataPrefetcher`; ``cohort_fn``
    maps a round index to its sorted ids.  ``async_staging=False`` runs
    every job inline on the caller's thread (the values are the same).
    """

    def __init__(self, store: ClientStateStore, data, malicious: np.ndarray,
                 cohort_fn: Callable[[int], np.ndarray], *, device,
                 async_staging: bool = False):
        self._store = store
        self._data = data if hasattr(data, "gather") else tuple(data)
        self._malicious = np.asarray(malicious, bool)  # blades-lint: disable=host-sync — setup: the malicious mask is copied to the host once per prefetcher
        self._cohort = cohort_fn
        self.device = torch.device(device)
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="blades-state")
                      if async_staging else None)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._staged: Optional[Tuple[int, Future]] = None
        self._pending: list = []
        self.stats = StoreStats()

    def _submit(self, fn, *args) -> Future:
        if self._pool is None:
            f: Future = Future()
            f.set_result(fn(*args))
            return f
        return self._pool.submit(fn, *args)

    def _on_copy_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _stage_job(self, index: int, prev_ids: Optional[np.ndarray]
                   ) -> StagedCohort:
        t0 = now()
        ids = np.asarray(self._cohort(index), np.int64)  # blades-lint: disable=host-sync — sanctioned staging boundary: cohort ids must be host ints to index the out-of-core store; runs in the prefetcher, overlapping the in-flight round
        new_mask = (np.ones(len(ids), bool) if prev_ids is None
                    else ~np.isin(ids, prev_ids))
        new_pos = np.nonzero(new_mask)[0]
        old_pos = np.nonzero(~new_mask)[0]
        prev_pos = (np.searchsorted(prev_ids, ids[old_pos])
                    if prev_ids is not None else np.zeros(0, np.int64))
        dev = self.device
        with self._on_copy_stream():
            new_rows = self._store.gather(ids[new_pos], device=dev)
            if hasattr(self._data, "gather"):
                data = self._data.gather(ids, device=dev)
            else:
                data = tuple(torch.from_numpy(np.ascontiguousarray(a[ids]))
                             .to(dev) for a in self._data)
            mal = torch.from_numpy(self._malicious[ids]).to(dev)
            event = None
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
        staged = (len(new_pos) * self._store.row_bytes
                  + sum(t.numel() * t.element_size() for t in data))
        return StagedCohort(
            index=index, ids=ids, new_pos=new_pos, new_rows=new_rows,
            old_pos=old_pos, prev_pos=prev_pos, data=data, malicious=mal,
            bytes_staged=int(staged), stage_seconds=now() - t0,
            event=event)

    # -- driver API ----------------------------------------------------------

    def stage(self, index: int, prev_ids: Optional[np.ndarray]) -> None:
        """Start staging round ``index``; ``prev_ids`` is the in-flight
        round's cohort, whose rows the store gather leaves out."""
        self._staged = (index, self._submit(self._stage_job, index,
                                            prev_ids))

    def take(self, index: int, prev: Optional[Tuple[np.ndarray, Dict]]):
        """Round ``index``'s assembled cohort: the staged one when the
        index matches, else a gather now.  ``prev`` is ``(prev_ids,
        prev_rows)`` of the previous round's output (the overlap rows come
        from there).  Returns ``(ids, state rows, (x, y, lengths),
        malicious)``, ready on the current stream."""
        staged, self._staged = self._staged, None
        sc = None
        if staged is not None and staged[0] == index:
            sc = staged[1].result()
        if sc is None:
            sc = self._stage_job(index, prev[0] if prev is not None
                                 else None)
        if sc.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(sc.event)
            for t in _tensors(sc):
                t.record_stream(cur)
        rows = sc.new_rows
        if len(sc.old_pos):
            prev_rows = prev[1]
            new_pos = torch.as_tensor(sc.new_pos, device=self.device)
            old_pos = torch.as_tensor(sc.old_pos, device=self.device)
            prev_pos = torch.as_tensor(sc.prev_pos, device=self.device)
            rows = {}
            for k, v in sc.new_rows.items():
                buf = torch.empty((len(sc.ids),) + v.shape[1:],
                                  dtype=v.dtype, device=self.device)
                buf[new_pos] = v
                buf[old_pos] = prev_rows[k][prev_pos]
                rows[k] = buf
        hbm = (self._store.device_bytes()
               + 3 * len(sc.ids) * self._store.row_bytes
               + sum(t.numel() * t.element_size() for t in sc.data))
        self.stats.observe(sc.stage_seconds, sc.bytes_staged, hbm)
        return sc.ids, rows, sc.data, sc.malicious

    def _reap(self, wait: bool = False) -> None:
        """Re-raise a failed write-back (a disk or memmap error must fail
        the trial, not serve stale rows)."""
        still = []
        for f in self._pending:
            if wait or f.done():
                f.result()
            else:
                still.append(f)
        self._pending = still

    def writeback(self, ids: np.ndarray, rows: Dict[str, torch.Tensor]
                  ) -> None:
        """Queue the round's updated cohort rows for the store, behind
        the round's work on the card."""
        self._reap()
        event = None
        if self._stream is not None and rows:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            for t in rows.values():
                t.record_stream(self._stream)

        def job():
            with self._on_copy_stream():
                if event is not None:
                    self._stream.wait_event(event)
                self._store.scatter(ids, rows)

        self._pending.append(self._submit(job))

    def flush(self) -> None:
        """Drain the worker: every write-back has reached the store (and
        any failure re-raised) before a checkpoint streams shards."""
        self._reap(wait=True)
        self._submit(lambda: None).result()
        if self._stream is not None:
            self._stream.synchronize()  # blades-lint: disable=host-sync — drain before a checkpoint: the staging stream finishes its write-backs before shards stream, never per round

    def invalidate(self) -> None:
        """Drop staged work (after a checkpoint restore)."""
        self.flush()
        self._staged = None

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
