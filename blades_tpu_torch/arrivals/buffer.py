"""Host-side bounded arrival buffer: the server's FedBuff accumulator
(counterpart of ``blades_tpu/arrivals/buffer.py``, pure Python, as is).

Arrivals land here as lightweight EVENTS — ``(client, tick, version,
corrupt)`` — not update rows: the simulator computes each event's update
inside the cycle dispatch that consumes it (against the params version
the client pulled, via the history ring), so the buffer itself is pure
host metadata: a handful of ints, trivially checkpointed next to the
version vector and bit-identically restored.

Bounded-buffer semantics: ``push`` on a full buffer drops ONE event (the
loss is counted as ``buffer_overflow`` by the engine) — but which event
depends on whether the arrival grows the unique-client set.  A full
buffer whose unique-client count is below the cycle size would otherwise
be an ABSORBING state: duplicate-client backlog can only leave via
``take_cycle`` (which needs the very unique clients the full buffer keeps
bouncing), so a new DISTINCT client's arrival evicts the oldest
duplicate-client event instead of being rejected — progress toward a
fireable cycle is always possible.  An arrival whose client is already
buffered is simply rejected (its earlier event is the fresher claim on a
cycle slot anyway).

``take_cycle(k)`` pops the first ``k`` events in FIFO order with one
constraint: at most ONE event per client per cycle — a client arriving
twice before the server fires would otherwise race its own optimizer
state inside one dispatch; the second arrival simply stays buffered for
the next cycle, in its original order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence


class ArrivalEvent(NamedTuple):
    """One buffered arrival.

    ``version`` is the global model version the client's in-flight
    update was computed against (its last pull); staleness at
    aggregation time is ``server_version - version``.  ``corrupt`` marks
    the chaos layer's lane-corruption realization for this delivery
    (pure in ``(fault_seed, tick, client)``)."""

    client: int
    tick: int
    version: int
    corrupt: bool = False


class UpdateBuffer:
    """Bounded FIFO of :class:`ArrivalEvent`."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events: List[ArrivalEvent] = []

    @property
    def fill(self) -> int:
        return len(self._events)

    def push(self, event: ArrivalEvent) -> int:
        """Append; returns the number of events LOST doing so (0 = clean
        insert, 1 = an overflow drop).

        Full-buffer policy (see module docstring): an arrival from a
        client NOT yet buffered evicts the oldest duplicate-client event
        (so the unique-client set can always grow toward a fireable
        cycle — a full buffer below ``k`` unique clients would otherwise
        deadlock); an arrival from an already-buffered client, or a full
        buffer with no duplicates to evict, drops the new event."""
        if len(self._events) < self.capacity:
            self._events.append(event)
            return 0
        clients = [e.client for e in self._events]
        if event.client not in clients:
            counts: dict = {}
            for c in clients:
                counts[c] = counts.get(c, 0) + 1
            for i, e in enumerate(self._events):
                if counts[e.client] > 1:
                    del self._events[i]
                    self._events.append(event)
                    return 1
        return 1

    def take_cycle(self, k: int) -> List[ArrivalEvent]:
        """Pop the first ``k`` events (FIFO) with unique clients; events
        whose client already fired this cycle stay buffered in order.
        Raises if fewer than ``k`` unique-client events are available —
        the engine only fires a cycle once the buffer holds one."""
        taken: List[ArrivalEvent] = []
        seen = set()
        rest: List[ArrivalEvent] = []
        for ev in self._events:
            if len(taken) < k and ev.client not in seen:
                taken.append(ev)
                seen.add(ev.client)
            else:
                rest.append(ev)
        if len(taken) < k:
            raise ValueError(
                f"buffer holds {len(taken)} unique-client event(s), "
                f"cycle needs {k}")
        self._events = rest
        return taken

    def unique_clients(self) -> int:
        return len({ev.client for ev in self._events})

    # -- checkpointing -------------------------------------------------------

    def state(self) -> List[List[int]]:
        """JSON/pickle-able buffer contents (ordered)."""
        return [[int(e.client), int(e.tick), int(e.version),
                 bool(e.corrupt)] for e in self._events]

    def restore(self, rows: Sequence[Sequence]) -> None:
        self._events = [
            ArrivalEvent(int(c), int(t), int(v), bool(corr))
            for c, t, v, corr in rows
        ]
        if len(self._events) > self.capacity:
            raise ValueError(
                f"restored {len(self._events)} events into a buffer of "
                f"capacity {self.capacity}")
