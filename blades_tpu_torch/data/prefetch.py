"""Dense-round batch staging: draw round ``r+1``'s batches while ``r``
computes (counterpart of ``blades_tpu/data/prefetch.py``).

:class:`BatchPrefetcher` is the dense single-round path's ``prefetch``
knob.  A round's draws all come from one generator seeded by its round
seed, batch indices first; the prefetcher builds round ``r+1``'s
generator, draws its batches (``sample_fn(generator) -> (bx, by)``) and
hands the generator over with them, so the round goes on drawing from it
exactly where the round program would have.  Prefetch on or off changes
when the batches are drawn, never which: the parameters are equal bit for
bit.

**On the card it is a CUDA stream hazard too.**  The staging runs on a
side stream of its own, ordered after the work already queued on the
round's stream (``wait_stream``).
A staged entry carries an event recorded on the side stream after its
draws; :meth:`BatchPrefetcher.take` makes the round's stream wait on it
before the round reads the batches, and marks them as used there, so the
allocator does not hand their memory back to the side stream early.

The prefetcher is keyed by the driver's round index;
:meth:`BatchPrefetcher.invalidate` drops a staged entry where the round
counter moves otherwise (a checkpoint restore).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch


class BatchPrefetcher:
    """Double-buffered per-client batch staging for the dense round.

    ``sample_fn(generator) -> (bx, by)`` draws every client's batches from
    ``generator``; ``seed_fn(index)`` is round ``index``'s seed.  The
    driver calls :meth:`take` for the round it is about to run and
    :meth:`stage` for the round after it; an entry staged for another
    index (or dropped by :meth:`invalidate`) is discarded and the batches
    drawn now."""

    def __init__(self, sample_fn: Callable[[torch.Generator], Tuple],
                 seed_fn: Callable[[int], int], device):
        self._sample = sample_fn
        self._seed = seed_fn
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._staged: Optional[Tuple[int, torch.Generator, Tuple, object]] = None

    def _draw(self, index: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self._seed(index)))
        return gen, self._sample(gen)

    def take(self, index: int) -> Tuple[torch.Generator, torch.Tensor,
                                        torch.Tensor]:
        """Round ``index``'s ``(generator, bx, by)``: the staged entry
        when its index matches, else a draw now; ready on the current
        stream, the generator past the batch draws."""
        staged, self._staged = self._staged, None
        if staged is None or staged[0] != index:
            gen, (bx, by) = self._draw(index)
            return gen, bx, by
        _, gen, (bx, by), event = staged
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            bx.record_stream(cur)
            by.record_stream(cur)
        return gen, bx, by

    def stage(self, index: int) -> None:
        """Draw round ``index``'s batches (on the side stream on the card)
        and hold them for :meth:`take`."""
        if self._stream is None:
            self._staged = (index, *self._draw(index), None)
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            gen, batches = self._draw(index)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._staged = (index, gen, batches, event)

    def invalidate(self) -> None:
        """Drop the staged batches (the round counter moved)."""
        self._staged = None

    def close(self) -> None:
        self._staged = None
        if self._stream is not None:
            with contextlib.suppress(RuntimeError):
                self._stream.synchronize()
