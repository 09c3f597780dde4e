"""Clean twin of tracediscipline_bad.py: the span layer's clock, a
sleep, an injectable clock reference, and a pragma'd wall-clock stamp."""

import time

from blades_tpu_torch.obs.trace import now


def stage_rows(store, ids):
    t0 = now()
    rows = store.gather(ids)
    return rows, now() - t0


def backoff():
    time.sleep(0)


def timed(fn, clock=time.perf_counter):
    return clock


def stamp():
    return {"created_unix": time.time()}  # blades-lint: disable=trace-discipline — fixture: wall-clock metadata stamp, not a duration
