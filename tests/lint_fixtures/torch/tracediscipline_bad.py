"""Seeded trace-discipline violations of the port (never imported): a
staging path timed with raw clocks."""

import time
from time import monotonic as mono
from time import perf_counter


def stage_rows(store, ids):
    t0 = time.perf_counter()  # BAD: module-attribute form
    rows = store.gather(ids)
    return rows, time.perf_counter() - t0  # BAD


def stage_wall(store, ids):
    t0 = perf_counter()  # BAD: from-import form
    store.gather(ids)
    return mono() - t0, time.time_ns()  # BAD: alias, BAD: _ns variant
