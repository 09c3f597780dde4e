"""Anomaly watchdog: schema-driven rules over already-fetched rows.

Every rule is evaluated HOST-side on the finalized metrics row the
driver fetched anyway — zero extra device syncs, and arming the
watchdog cannot perturb the trajectory (the rounds are untouched).
Counterpart of ``blades_tpu/obs/watchdog.py``: the same rows give the
same events in both packages.  Firing rules land in the row as the schema-registered
``watchdog_events`` field and trigger the flight-recorder dump
(:mod:`blades_tpu_torch.obs.flightrec`).

Schema-driven: a rule names the row field it watches, and construction
fails fast when that field is not registered in
``obs/schema.py::ROUND_RECORD_FIELDS`` — a watchdog watching a field no
round ever stamps is a config bug, caught before the sweep compiles
anything.

Rule kinds:

===================  =======================================================
``nonfinite``        field is NaN/Inf (the NaN-aggregate trigger)
``spike``            field > ``factor`` x rolling median of the last
                     ``window`` values (warms up: silent until
                     ``min_points`` values seen)
``ceiling``          field >= ``threshold`` (detection-FPR collapse:
                     the defense started flagging the benign cohort;
                     staleness runaway: the async buffer is serving
                     ancient work)
``collapse``         field < rolling median / ``factor`` — the low-side
                     twin of ``spike`` (ingest-rate regression: the
                     async server's ``updates_per_sec`` fell off a
                     cliff / buffer starvation)
``round_time_regression``
                     per-round wall time (the delta of the row's
                     ``timers.training_step.total_s``) > ``factor`` x
                     rolling median — a rounds/s regression, from data
                     already in the row
===================  =======================================================

Determinism across kill-and-resume: rolling state is per trial and the
sweep rebuilds it from the truncated on-disk rows at restore
(:meth:`Watchdog.warm`), so a resumed trial sees the same windows a
straight-through run would.  (``round_time_regression`` reads wall
clock and is inherently run-specific; the data-derived rules replay
identically.)
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from blades_tpu_torch.obs.schema import ROUND_RECORD_FIELDS

_KINDS = ("nonfinite", "spike", "ceiling", "collapse",
          "round_time_regression")


@dataclasses.dataclass(frozen=True)
class WatchdogRule:
    """One anomaly rule (frozen: rules are static config, like the
    fault injector)."""

    name: str
    kind: str
    field: str
    window: int = 8
    min_points: int = 4
    factor: float = 10.0
    threshold: float = 0.5

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"rule {self.name!r}: kind must be one of {_KINDS}, "
                f"got {self.kind!r}")
        if self.field not in ROUND_RECORD_FIELDS:
            raise ValueError(
                f"rule {self.name!r} watches {self.field!r}, which is "
                "not registered in obs/schema.py::ROUND_RECORD_FIELDS — "
                "watchdog rules are schema-driven; register the field "
                "or fix the rule")
        if self.window < 1 or self.min_points < 1:
            raise ValueError(
                f"rule {self.name!r}: window/min_points must be >= 1")
        if self.factor <= 0:
            raise ValueError(f"rule {self.name!r}: factor must be > 0")


@dataclasses.dataclass(frozen=True)
class WatchdogEvent:
    """One firing: which rule, where, observed vs limit."""

    rule: str
    kind: str
    field: str
    round: Optional[int]
    value: float
    limit: Optional[float]
    message: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def default_rules() -> tuple:
    """The standing rule set ``--watchdog`` arms."""
    return (
        WatchdogRule(name="nan_aggregate", kind="nonfinite",
                     field="agg_norm"),
        WatchdogRule(name="nan_loss", kind="nonfinite",
                     field="train_loss"),
        WatchdogRule(name="update_norm_spike", kind="spike",
                     field="update_norm_mean", window=8, min_points=4,
                     factor=10.0),
        WatchdogRule(name="fpr_collapse", kind="ceiling",
                     field="byz_fpr", threshold=0.5),
        WatchdogRule(name="round_time_regression",
                     kind="round_time_regression", field="timers",
                     window=8, min_points=4, factor=3.0),
        # Buffered-async ingest health (blades_tpu_torch/arrivals): both rules
        # watch fields only async rows stamp, so they are inert on
        # synchronous trials (absent field => skipped) and warm-on-
        # resume like every other rule.
        WatchdogRule(name="staleness_runaway", kind="ceiling",
                     field="staleness_max", threshold=64.0),
        WatchdogRule(name="ingest_collapse", kind="collapse",
                     field="updates_per_sec", window=8, min_points=4,
                     factor=4.0),
        # ingest_stall: the deterministic twin of ingest_collapse —
        # virtual ticks consumed filling the aggregation buffer this
        # cycle (cycle_ticks) spiked vs the rolling median, i.e. the
        # arrival process needed far more simulated time to produce a
        # cohort.  Pure in (seed, tick), so controller responses keyed
        # to it replay bit-identically (updates_per_sec reads the span
        # clock and cannot).
        WatchdogRule(name="ingest_stall", kind="spike",
                     field="cycle_ticks", window=8, min_points=4,
                     factor=3.0),
        # Client-lifetime ledger (obs/ledger.py): reputation drift.
        # Inert unless the ledger stamps its fields (absent => skipped).
        # reputation_collapse: the fleet's median reputation fell off a
        # cliff vs its own rolling history — the defense started
        # flagging broad swaths of the registered population (an
        # adaptive attack dragging benign clients across the detection
        # boundary, or a detection regression).  factor is tight (2x)
        # because reputation is a slow lifetime average: halving the
        # median in one window is already catastrophic.
        WatchdogRule(name="reputation_collapse", kind="collapse",
                     field="reputation_p50", window=8, min_points=4,
                     factor=2.0),
        # flagger_churn: the set of flagged clients is thrashing —
        # many clients flipping flag status per round vs the rolling
        # median churn (BLADE-FL-style intermittent attackers toggling
        # in and out of detection, or an unstable defense boundary).
        WatchdogRule(name="flagger_churn", kind="spike",
                     field="flagged_churn", window=8, min_points=4,
                     factor=4.0),
    )


def rules_from_config(specs) -> tuple:
    """Build a rule tuple from config data (the ``watchdog_rules`` knob
    / ``--watchdog-rules`` JSON): a sequence of dicts (or ready
    :class:`WatchdogRule` instances), fail-fast on unknown keys — and,
    via ``WatchdogRule.__post_init__``, on unknown kinds and fields not
    registered in the schema.  Called at config.validate() time so a
    typo'd rule dies before anything compiles."""
    if specs is None:
        return default_rules()
    allowed = {f.name for f in dataclasses.fields(WatchdogRule)}
    rules = []
    for i, spec in enumerate(specs):
        if isinstance(spec, WatchdogRule):
            rules.append(spec)
            continue
        if not isinstance(spec, dict):
            raise ValueError(
                f"watchdog_rules[{i}] must be a dict of WatchdogRule "
                f"fields, got {type(spec).__name__}")
        unknown = set(spec) - allowed
        if unknown:
            raise ValueError(
                f"watchdog_rules[{i}]: unknown key(s) {sorted(unknown)}; "
                f"allowed: {sorted(allowed)}")
        missing = {"name", "kind", "field"} - set(spec)
        if missing:
            raise ValueError(
                f"watchdog_rules[{i}]: missing required key(s) "
                f"{sorted(missing)}")
        rules.append(WatchdogRule(**spec))
    names = [r.name for r in rules]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(
            f"watchdog_rules: duplicate rule name(s) {dupes} — rolling "
            "windows are keyed by name")
    return tuple(rules)


def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class Watchdog:
    """Per-trial rule evaluator with rolling state.

    ``observe(row)`` evaluates every rule against one finalized row,
    updates rolling windows, and returns the events that fired (empty
    list almost always).  ``warm(rows)`` replays already-on-disk rows
    into the rolling state WITHOUT emitting events — the kill-and-resume
    path, so a restored trial's windows match a straight-through run's.
    """

    def __init__(self, rules: Optional[Sequence[WatchdogRule]] = None):
        self.rules = tuple(rules if rules is not None else default_rules())
        self._windows: Dict[str, deque] = {
            r.name: deque(maxlen=r.window) for r in self.rules}
        self._last_step_total: Optional[float] = None
        self.events: List[WatchdogEvent] = []

    def reset(self) -> None:
        for w in self._windows.values():
            w.clear()
        self._last_step_total = None

    def warm(self, rows: Sequence[Dict[str, Any]]) -> None:
        """Rebuild rolling windows AND the event log from the surviving
        on-disk rows.  Events come from the rows' stamped
        ``watchdog_events`` (the durable record), not from re-running
        the rules — re-evaluation would re-fire data-derived events
        (double counts) and could never reproduce timing-derived ones."""
        self.reset()
        self.events = []
        for row in rows:
            self._evaluate(row)
            for ev in row.get("watchdog_events") or []:
                if isinstance(ev, dict):
                    self.events.append(WatchdogEvent(
                        rule=str(ev.get("rule", "")),
                        kind=str(ev.get("kind", "")),
                        field=str(ev.get("field", "")),
                        round=ev.get("round"),
                        value=float(ev.get("value", 0.0)),
                        limit=ev.get("limit"),
                        message=str(ev.get("message", "")),
                    ))

    def observe(self, row: Dict[str, Any]) -> List[WatchdogEvent]:
        events = self._evaluate(row)
        self.events.extend(events)
        return events

    # -- checkpoint threading (the controller path: the driver owns the
    # watchdog and has no on-disk rows to warm() from, so rolling state
    # rides the training checkpoint explicitly) --------------------------

    def state(self) -> Dict[str, Any]:
        return {
            "windows": {name: list(w) for name, w in self._windows.items()},
            "last_step_total": self._last_step_total,
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        self.reset()
        for name, values in (state.get("windows") or {}).items():
            window = self._windows.get(name)
            if window is None:
                continue  # rule set changed across resume; start cold
            window.extend(float(v) for v in values)
        last = state.get("last_step_total")
        self._last_step_total = None if last is None else float(last)

    # -- evaluation ----------------------------------------------------------

    def _evaluate(self, row: Dict[str, Any]) -> List[WatchdogEvent]:
        events: List[WatchdogEvent] = []
        tick = row.get("training_iteration")
        for rule in self.rules:
            if rule.kind == "round_time_regression":
                value = self._round_time(row)
            else:
                raw = row.get(rule.field)
                value = float(raw) if isinstance(raw, (int, float)) \
                    and not isinstance(raw, bool) else None
            if value is None:
                continue  # field absent this round (e.g. no forensics)
            ev = self._apply(rule, value, tick)
            if ev is not None:
                events.append(ev)
        return events

    def _apply(self, rule: WatchdogRule, value: float,
               tick) -> Optional[WatchdogEvent]:
        if rule.kind == "nonfinite":
            if not math.isfinite(value):
                return WatchdogEvent(
                    rule=rule.name, kind=rule.kind, field=rule.field,
                    round=tick, value=value, limit=None,
                    message=f"{rule.field} is non-finite ({value!r})")
            return None
        if rule.kind == "ceiling":
            if value >= rule.threshold:
                return WatchdogEvent(
                    rule=rule.name, kind=rule.kind, field=rule.field,
                    round=tick, value=value, limit=rule.threshold,
                    message=f"{rule.field}={value:.4g} breached the "
                            f"{rule.threshold:.4g} ceiling")
            return None
        # Rolling-median kinds: spike / collapse /
        # round_time_regression.  A non-finite value never enters the
        # window (it would poison the median) — the nonfinite rule owns
        # that pathology.
        window = self._windows[rule.name]
        event = None
        if math.isfinite(value):
            if len(window) >= rule.min_points:
                med = _median(window)
                if rule.kind == "collapse":
                    limit = med / rule.factor
                    if med > 0 and value < limit:
                        event = WatchdogEvent(
                            rule=rule.name, kind=rule.kind,
                            field=rule.field, round=tick, value=value,
                            limit=limit,
                            message=f"{rule.field}={value:.4g} < rolling "
                                    f"median ({med:.4g}) / {rule.factor:g}")
                else:
                    limit = rule.factor * med
                    if med > 0 and value > limit:
                        what = ("round wall-time"
                                if rule.kind == "round_time_regression"
                                else rule.field)
                        event = WatchdogEvent(
                            rule=rule.name, kind=rule.kind,
                            field=rule.field, round=tick, value=value,
                            limit=limit,
                            message=f"{what}={value:.4g} > "
                                    f"{rule.factor:g}x rolling median "
                                    f"({med:.4g})")
            window.append(value)
        return event

    def _round_time(self, row: Dict[str, Any]) -> Optional[float]:
        """Per-round wall time from the row's own timers block (the
        cumulative ``training_step`` total differenced against the
        previous row) — no clock reads of its own."""
        timers = row.get("timers")
        if not isinstance(timers, dict):
            return None
        step = timers.get("training_step")
        if not isinstance(step, dict):
            return None
        total = step.get("total_s")
        if not isinstance(total, (int, float)):
            return None
        prev, self._last_step_total = self._last_step_total, float(total)
        if prev is None:
            return None
        return max(float(total) - prev, 0.0)
