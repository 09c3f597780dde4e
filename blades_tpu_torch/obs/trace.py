"""Span tracing: the host-side timing source of truth (counterpart of
``blades_tpu/obs/trace.py``).

A :class:`Tracer` records a TREE of named spans (sweep -> trial -> round
-> phase: training_step / evaluate / checkpoint), aggregates per-name
phase statistics in the shape of the ``timers`` field of every metrics
row (``{name: {mean_s, total_s, count}}``), and exports the tree as
Chrome/Perfetto trace JSON per trial (``--trace-dir``).

Device correlation: when a tracer is **armed** (``record=True``) every
span also enters ``torch.profiler.record_function``, so a run that also
captures a profiler trace (``--trace DIR``, :func:`trace`) shows the
card's kernels under the right host span.  An un-armed tracer (the
default everywhere) records no tree, enters no annotations and writes no
files: it is the phase accumulator the driver's rows always carried.

On the card a span ends with ``torch.cuda.synchronize()`` (``sync=True``),
so a host-clock phase time covers the device work it launched.

Clock discipline: :func:`now` is the duration clock every measured
second of the port flows through.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Span", "Tracer", "Timers", "now", "trace", "validate_chrome_trace",
]


def now() -> float:
    """Monotonic seconds — the single sanctioned duration clock
    (``trace-discipline`` lint).  Use span contexts where a phase tree
    is wanted; ``now()`` directly where only an elapsed delta is."""
    return time.perf_counter()


# Recorded-span cap: a pathological million-round sweep must degrade to
# aggregation-only (the old Timers behavior), never OOM the host.  The
# cap is per tracer; dropped spans are counted in the export metadata.
MAX_RECORDED_SPANS = 200_000


@dataclasses.dataclass
class Span:
    """One timed region.  ``attrs`` carries provenance (plan_id,
    hbm_passes, agg_domain, comm_bytes_up, ...) merged in via
    :meth:`Tracer.annotate` / :meth:`Tracer.stamp_latest`."""

    name: str
    start_s: float
    end_s: Optional[float] = None
    step: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        return (self.end_s if self.end_s is not None else self.start_s) \
            - self.start_s


def _profiler_annotation(name: str, step: Optional[int]):
    """The profiler annotation of an armed span: a
    ``torch.profiler.record_function`` named after the span (and its step
    number), or None where the profiler is unavailable."""
    try:
        import torch.profiler as tp

        return tp.record_function(name if step is None
                                  else f"{name}#{int(step)}")
    except Exception:
        return None


class Tracer:
    """Span recorder + phase aggregator.

    ``record=False`` (default): aggregation only — the old ``Timers``
    semantics, near-zero overhead, nothing retained per span.
    ``record=True`` (armed): additionally keeps the span TREE for
    Chrome-trace export and enters profiler annotations so device work
    correlates.  ``sync=True`` ends every span with
    ``torch.cuda.synchronize()``.  ``clock`` is injectable for
    deterministic tests.
    """

    def __init__(self, record: bool = False, clock=now, sync: bool = False):
        self.record = bool(record)
        self._clock = clock
        self._sync = bool(sync)
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._roots: List[Span] = []
        self._stack: List[Span] = []
        self._latest: Dict[str, Span] = {}
        self._recorded = 0
        self._dropped = 0

    # -- span lifecycle ------------------------------------------------------

    def start(self, name: str, step: Optional[int] = None,
              **attrs) -> Span:
        """Open a span (pair with :meth:`finish`).  Works un-armed too:
        the returned :class:`Span` always carries real start/end times,
        so ``finish(span); span.duration`` is the sanctioned way to
        measure a block the ``with`` form cannot wrap cleanly."""
        span = Span(name=name, start_s=self._clock(), step=step,
                    attrs=dict(attrs))
        if self.record:
            if self._recorded < MAX_RECORDED_SPANS:
                self._recorded += 1
                (self._stack[-1].children if self._stack
                 else self._roots).append(span)
                self._stack.append(span)
                ann = _profiler_annotation(name, step)
                if ann is not None:
                    span.attrs.setdefault("_ann", None)
                    try:
                        ann.__enter__()
                        span.attrs["_ann"] = ann
                    except Exception:
                        span.attrs.pop("_ann", None)
            else:
                self._dropped += 1
        return span

    def finish(self, span: Span) -> Span:
        if self._sync:
            import torch

            torch.cuda.synchronize()
        span.end_s = self._clock()
        self._totals[span.name] = self._totals.get(span.name, 0.0) \
            + span.duration
        self._counts[span.name] = self._counts.get(span.name, 0) + 1
        if self.record:
            ann = span.attrs.pop("_ann", None)
            if ann is not None:
                try:
                    ann.__exit__(None, None, None)
                except Exception:
                    pass
            if self._stack and self._stack[-1] is span:
                self._stack.pop()
            elif span in self._stack:
                # Out-of-order finish (a crash unwound past an explicit
                # start/finish pair): close everything above it too.
                while self._stack and self._stack[-1] is not span:
                    self._stack.pop()
                if self._stack:
                    self._stack.pop()
            self._latest[span.name] = span
        return span

    @contextmanager
    def span(self, name: str, step: Optional[int] = None,
             **attrs) -> Iterator[Span]:
        sp = self.start(name, step=step, **attrs)
        try:
            yield sp
        finally:
            self.finish(sp)

    def time(self, name: str, step: Optional[int] = None, **attrs):
        """Alias of :meth:`span`: the ``Timers.time`` phase API."""
        return self.span(name, step=step, **attrs)

    # -- provenance ----------------------------------------------------------

    def annotate(self, **attrs) -> None:
        """Merge attrs into the innermost OPEN span (no-op un-armed or
        outside any span)."""
        if self._stack:
            self._stack[-1].attrs.update(attrs)

    def stamp_latest(self, name: str, attrs: Dict[str, Any]) -> None:
        """Merge attrs into the most recently FINISHED span named
        ``name`` — the driver stamps round provenance (plan_id,
        hbm_passes, agg_domain, comm_bytes_up) after the row is
        finalized, which is after the dispatch span closed."""
        span = self._latest.get(name)
        if span is not None:
            span.attrs.update(attrs)

    def stamp_latest_of(self, names, attrs: Dict[str, Any]) -> None:
        """:meth:`stamp_latest` over alternatives: stamp whichever of
        ``names`` finished most recently (the driver's dispatch span is
        named ``compile`` the first time and ``round`` after)."""
        spans = [self._latest[n] for n in names if n in self._latest]
        if spans:
            max(spans, key=lambda s: s.end_s or 0.0).attrs.update(attrs)

    # -- aggregation (the old Timers surface) --------------------------------

    def mean(self, name: str) -> float:
        c = self._counts.get(name, 0)
        return self._totals.get(name, 0.0) / c if c else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"mean_s": self.mean(k), "total_s": self._totals[k],
                "count": self._counts[k]}
            for k in self._totals
        }

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The span tree as Chrome/Perfetto trace JSON (``ph: "X"``
        complete events, microsecond timestamps; nesting is recovered by
        the viewer from containment on one tid)."""
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "blades_tpu_torch"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
             "args": {"name": "host spans"}},
        ]

        def emit(span: Span) -> None:
            # A still-open span (export mid-run / from a crash handler)
            # contributes no event of its own, but its FINISHED children
            # must still be walked — they are the tree being salvaged.
            if span.end_s is not None:
                args = {k: v for k, v in span.attrs.items()
                        if not k.startswith("_")}
                if span.step is not None:
                    args["step"] = span.step
                events.append({
                    "ph": "X", "name": span.name, "cat": "blades",
                    "ts": round(span.start_s * 1e6, 3),
                    "dur": round(span.duration * 1e6, 3),
                    "pid": 1, "tid": 1, "args": args,
                })
            for c in span.children:
                emit(c)

        for root in self._roots:
            emit(root)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"format": "blades_tpu.obs.trace", "version": 1,
                         "spans_recorded": self._recorded,
                         "spans_dropped": self._dropped},
        }

    def export(self, path) -> str:
        """Atomically write the Chrome trace JSON (tmp + fsync +
        ``os.replace``); returns the published path."""
        from blades_tpu_torch.faults.host import atomic_write_json

        return atomic_write_json(self.to_chrome_trace(), path)


class Timers(Tracer):
    """The driver's phase timers (``utils/timers.py`` re-exports this): a
    plain un-armed tracer."""


# ---------------------------------------------------------------------------
# the profiler capture (``--trace DIR``)
# ---------------------------------------------------------------------------


@contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host, and the card's kernels
    where CUDA is present) and export it as Chrome trace JSON into
    ``log_dir`` on exit.  Armed tracers' span annotations land inside
    this capture, so ``--trace`` and ``--trace-dir`` compose."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "profile.trace.json"))


# ---------------------------------------------------------------------------
# offline validation
# ---------------------------------------------------------------------------


def validate_chrome_trace(path) -> Tuple[int, List[str]]:
    """Schema-check an exported trace file: returns ``(num_span_events,
    errors)``.  Tolerant the same way the metrics validator is: a
    torn/unparseable file is ONE reported error, never an exception."""
    import json

    errors: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        return 0, [f"unreadable trace JSON: {exc}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return 0, ["missing 'traceEvents' list"]
    num_spans = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str) or ph not in ("X", "M"):
            errors.append(f"event {i}: needs a str name and ph in {{X, M}}")
            continue
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) \
                    or not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({ev['name']}): X events need "
                              "numeric ts and dur >= 0")
                continue
            if not isinstance(ev.get("args", {}), dict):
                errors.append(f"event {i} ({ev['name']}): args must be "
                              "an object")
                continue
            num_spans += 1
    return num_spans, errors
