"""Control policy: watchdog event kinds -> bounded actuator moves.

Everything in this module is PURE: a decision is a function of
(policy, recorded pre-state, recorded sensor data, round, tick) and
nothing else — no clocks, no RNG draws, no engine handles.  The live
controller (:mod:`blades_tpu_torch.control.controller`) and the offline
re-derivation path (:func:`rederive_action`) both route through the
same ``decide_*`` functions, so a recorded action is re-derivable
bit-identically from the flight recorder by construction.
(Counterpart of ``blades_tpu/control/policy.py``.)

The policy maps watchdog RULE NAMES (not kinds — two ceiling rules can
demand different responses) to actuator families:

=====================  ===================================================
``agg_every``          staleness runaway: shrink ``agg_every`` (aggregate
                       more often, floor ``min_agg_every``) so buffered
                       work stops aging
``buffer``             ingest collapse/stall: grow the arrival buffer
                       (cap ``max_buffer_capacity``); at the cap, relax
                       the staleness ``weight_cutoff`` instead (cap
                       ``max_weight_cutoff``) so old-but-real work still
                       counts
``quarantine``         detection-health collapse: quarantine-and-probe —
                       mask the ledger's top suspects out of aggregation
                       for ``quarantine_rounds`` rounds, then probe
                       (re-admit on a clean diagnosis, re-quarantine on a
                       flagged one)
``replan``             round-time regression: re-run the execution
                       autotuner against observed cohort geometry
                       (sync driver only — async x autotune is a
                       forbidden pair in config.validate())
``window``             out-of-core staging pressure: shrink the async
                       event-cohort window (floor ``min_window``) so a
                       round's staged rows + data shards fit the host
                       budget.  This is the ONLY agg-cadence family
                       admitted under ``state_store != "resident"`` —
                       it moves the same engine knob as ``agg_every``
                       but is one-directional DOWN, so a journaled
                       window trajectory can only ever tighten the
                       out-of-core working set, never blow it up
=====================  ===================================================

Hysteresis by construction: every move is ONE-DIRECTIONAL and bounded
(`agg_every` only shrinks, buffer/cutoff only grow), and each family
carries a ``cooldown_rounds`` rate limit, so an A->B->A oscillation
within a cooldown window is structurally impossible — there is no move
that could produce the second A.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Actuator families a rule may map to ("off" disables a rule's response).
ACTUATOR_FAMILIES = ("agg_every", "buffer", "quarantine", "replan",
                     "window")

#: Concrete actuator labels that appear in journaled actions.  The
#: ``buffer`` family emits either ``buffer_capacity`` or
#: ``weight_cutoff`` (the at-cap fallback); quarantine lifecycle steps
#: (``probe``/``readmit``/``requarantine``) are scheduled consequences
#: of an earlier ``quarantine`` action, not event-driven moves.
ACTION_ACTUATORS = ("agg_every", "buffer_capacity", "weight_cutoff",
                    "quarantine", "probe", "readmit", "requarantine",
                    "replan", "window")

#: Rule-name -> actuator-family table the default policy ships.  The
#: names match obs/watchdog.py::default_rules(); user rules (the
#: ``watchdog_rules`` config knob) join via the ``rules`` override in
#: ``control_config``.
DEFAULT_RULE_TABLE: Tuple[Tuple[str, str], ...] = (
    ("staleness_runaway", "agg_every"),
    ("ingest_collapse", "buffer"),
    ("ingest_stall", "buffer"),
    ("fpr_collapse", "quarantine"),
    ("reputation_collapse", "quarantine"),
    ("round_time_regression", "replan"),
)

#: Journal marker for quarantine lifecycle steps (they have no
#: triggering watchdog rule).
LIFECYCLE_RULE = "quarantine_lifecycle"


@dataclasses.dataclass(frozen=True)
class ControlAction:
    """One journaled controller decision.

    ``pre`` records the decision's inputs that are NOT recoverable from
    the row it rides (live actuator values, the exclusion set, probe
    membership), which is what makes offline re-derivation
    self-contained: ``rederive_action(policy, action, suspects)`` needs
    only the action itself plus the row's ``ledger_top_suspects``.
    """

    seq: int
    round: int
    tick: int
    rule: str
    actuator: str
    old: Optional[int] = None
    new: Optional[int] = None
    clients: Tuple[int, ...] = ()
    until: int = -1
    pre: Optional[Dict[str, Any]] = None
    message: str = ""

    def __post_init__(self):
        if self.actuator not in ACTION_ACTUATORS:
            raise ValueError(
                f"action actuator must be one of {ACTION_ACTUATORS}, "
                f"got {self.actuator!r}")

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["clients"] = list(self.clients)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ControlAction":
        d = dict(d)
        d["clients"] = tuple(int(c) for c in d.get("clients") or ())
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ControlPolicy:
    """Frozen rule table + bounds + rate limits (static config, like
    the fault injector and the watchdog rules)."""

    rule_table: Tuple[Tuple[str, str], ...] = DEFAULT_RULE_TABLE
    cooldown_rounds: int = 8
    quarantine_rounds: int = 8
    quarantine_max: int = 2
    max_quarantine_fraction: float = 0.5
    min_agg_every: int = 2
    agg_every_factor: int = 2
    buffer_factor: int = 2
    max_buffer_capacity: int = 256
    cutoff_factor: int = 2
    max_weight_cutoff: int = 256
    min_window: int = 4
    window_factor: int = 2
    seed: int = 0

    def __post_init__(self):
        for rule, family in self.rule_table:
            if family not in ACTUATOR_FAMILIES:
                raise ValueError(
                    f"control rule {rule!r} maps to unknown actuator "
                    f"family {family!r}; known: {ACTUATOR_FAMILIES} "
                    "(or 'off' in the config form to disable)")
        if self.cooldown_rounds < 1:
            raise ValueError("cooldown_rounds must be >= 1 (a cooldown "
                             "of 0 would let one noisy sensor re-fire "
                             "an actuator every round)")
        if self.quarantine_rounds < 0:
            raise ValueError("quarantine_rounds must be >= 0 "
                             "(0 disables quarantine moves)")
        if self.quarantine_max < 1:
            raise ValueError("quarantine_max must be >= 1")
        if not (0.0 < self.max_quarantine_fraction <= 1.0):
            raise ValueError("max_quarantine_fraction must be in (0, 1]")
        for knob in ("agg_every_factor", "buffer_factor", "cutoff_factor",
                     "window_factor"):
            if getattr(self, knob) < 2:
                raise ValueError(f"{knob} must be >= 2 (a factor of 1 "
                                 "is a no-op move that would still burn "
                                 "the cooldown)")
        if self.min_agg_every < 1:
            raise ValueError("min_agg_every must be >= 1")
        if self.min_window < 1:
            raise ValueError("min_window must be >= 1 (an empty window "
                             "would stage no cohort at all)")

    def actuator_for(self, rule_name: str) -> Optional[str]:
        for rule, family in self.rule_table:
            if rule == rule_name:
                return family
        return None

    @classmethod
    def from_config(cls, cfg: Optional[Dict[str, Any]]) -> "ControlPolicy":
        """Build from the ``control_config`` dict, fail-fast on unknown
        keys.  ``rules`` merges over the default table; mapping a rule
        to ``"off"`` removes its response."""
        if cfg is None:
            return cls()
        if isinstance(cfg, ControlPolicy):
            return cfg
        if not isinstance(cfg, dict):
            raise ValueError(
                f"control_config must be a dict, got {type(cfg).__name__}")
        cfg = dict(cfg)
        cfg.pop("enabled", None)  # the arming knob, consumed by config
        rules = cfg.pop("rules", None)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(cfg) - (fields - {"rule_table"})
        if unknown:
            raise ValueError(
                f"control_config: unknown key(s) {sorted(unknown)}; "
                f"allowed: {sorted((fields - {'rule_table'}) | {'rules', 'enabled'})}")
        table = dict(DEFAULT_RULE_TABLE)
        if rules is not None:
            if not isinstance(rules, dict):
                raise ValueError("control_config['rules'] must map rule "
                                 "names to actuator families")
            for rule, family in rules.items():
                if family == "off":
                    table.pop(rule, None)
                else:
                    table[rule] = family  # validated in __post_init__
        return cls(rule_table=tuple(sorted(table.items())), **cfg)

    def as_config(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["rules"] = dict(d.pop("rule_table"))
        return d


# -- pure decision functions (shared by live controller and --action) -------

def decide_agg_every(policy: ControlPolicy, *, seq: int, round_idx: int,
                     tick: int, rule: str,
                     pre: Dict[str, Any]) -> Optional[ControlAction]:
    """Shrink ``agg_every`` toward ``min_agg_every`` (aggregate more
    often => less staleness).  ``pre = {"old": current agg_every}``."""
    old = pre.get("old")
    if old is None:
        return None  # sync driver: no agg cadence to move
    new = max(policy.min_agg_every, int(old) // policy.agg_every_factor)
    if new >= old:
        return None  # at the floor — bounded means silent, not clamped
    return ControlAction(
        seq=seq, round=round_idx, tick=tick, rule=rule,
        actuator="agg_every", old=int(old), new=new, pre=dict(pre),
        message=f"shrink agg_every {old}->{new} (floor "
                f"{policy.min_agg_every})")


def decide_window(policy: ControlPolicy, *, seq: int, round_idx: int,
                  tick: int, rule: str,
                  pre: Dict[str, Any]) -> Optional[ControlAction]:
    """Shrink the out-of-core event-cohort window toward ``min_window``
    (smaller staged working set per aggregation).  ``pre = {"old":
    current window}``.  Mirrors :func:`decide_agg_every` — one
    direction, silent at the floor — but is admitted under
    ``state_store != "resident"`` where the agg_every/buffer families
    are config-rejected (growing either would grow the staged set)."""
    old = pre.get("old")
    if old is None:
        return None  # sync / non-ooc driver: no window to move
    new = max(policy.min_window, int(old) // policy.window_factor)
    if new >= old:
        return None  # at the floor — bounded means silent, not clamped
    return ControlAction(
        seq=seq, round=round_idx, tick=tick, rule=rule,
        actuator="window", old=int(old), new=new, pre=dict(pre),
        message=f"shrink window {old}->{new} (floor "
                f"{policy.min_window})")


def decide_buffer(policy: ControlPolicy, *, seq: int, round_idx: int,
                  tick: int, rule: str,
                  pre: Dict[str, Any]) -> Optional[ControlAction]:
    """Grow the arrival buffer; at the cap, relax the staleness weight
    cutoff instead.  ``pre = {"old": buffer_capacity, "cutoff":
    weight_cutoff}``."""
    old = pre.get("old")
    if old is None:
        return None
    new = min(policy.max_buffer_capacity, int(old) * policy.buffer_factor)
    if new > old:
        return ControlAction(
            seq=seq, round=round_idx, tick=tick, rule=rule,
            actuator="buffer_capacity", old=int(old), new=new,
            pre=dict(pre),
            message=f"grow buffer {old}->{new} (cap "
                    f"{policy.max_buffer_capacity})")
    cutoff = pre.get("cutoff")
    if cutoff is None:
        return None
    new_cut = min(policy.max_weight_cutoff,
                  int(cutoff) * policy.cutoff_factor)
    if new_cut <= cutoff:
        return None  # both bounds hit — no further relief available
    return ControlAction(
        seq=seq, round=round_idx, tick=tick, rule=rule,
        actuator="weight_cutoff", old=int(cutoff), new=new_cut,
        pre=dict(pre),
        message=f"buffer at cap; relax weight_cutoff {cutoff}->{new_cut} "
                f"(cap {policy.max_weight_cutoff})")


def decide_quarantine(policy: ControlPolicy, *, seq: int, round_idx: int,
                      tick: int, rule: str, pre: Dict[str, Any],
                      suspects: Sequence[Sequence[Any]],
                      num_clients: int) -> Optional[ControlAction]:
    """Quarantine the ledger's top suspects not already held.

    ``pre = {"excluded": sorted client ids already quarantined or on
    probation, "active": current quarantine size}``; ``suspects`` is the
    row's ``ledger_top_suspects`` (client ids, worst reputation first).
    """
    if policy.quarantine_rounds <= 0:
        return None
    excluded = set(int(c) for c in pre.get("excluded") or ())
    active = int(pre.get("active") or 0)
    ceiling = int(policy.max_quarantine_fraction * num_clients)
    room = max(0, ceiling - active)
    picks = []
    for entry in suspects:
        c = int(entry[0]) if isinstance(entry, (list, tuple)) else int(entry)
        if c in excluded:
            continue
        picks.append(c)
        if len(picks) >= min(policy.quarantine_max, room):
            break
    picks = picks[:min(policy.quarantine_max, room)]
    if not picks:
        return None
    until = round_idx + policy.quarantine_rounds
    return ControlAction(
        seq=seq, round=round_idx, tick=tick, rule=rule,
        actuator="quarantine", old=active, new=active + len(picks),
        clients=tuple(picks), until=until, pre=dict(pre),
        message=f"quarantine {picks} until round {until} "
                f"(fleet ceiling {ceiling})")


def decide_replan(policy: ControlPolicy, *, seq: int, round_idx: int,
                  tick: int, rule: str,
                  pre: Dict[str, Any]) -> Optional[ControlAction]:
    """Re-run the execution autotuner.  The DECISION is journaled (and
    re-derivable); the measured plan outcome is wall-clock-dependent
    and rides the row's plan-provenance fields instead, so the journal
    stays byte-identical across runs."""
    if not pre.get("allowed", False):
        return None  # async engine / autotuner disarmed
    return ControlAction(
        seq=seq, round=round_idx, tick=tick, rule=rule,
        actuator="replan", pre=dict(pre),
        message="re-run autotuner against observed cohort geometry")


def decide_probe(policy: ControlPolicy, *, seq: int, round_idx: int,
                 tick: int, pre: Dict[str, Any]) -> Optional[ControlAction]:
    """Quarantine term expired: release to probation.  ``pre = {"due":
    sorted client ids whose release round <= round_idx, "active":
    quarantine size before release}``."""
    due = tuple(int(c) for c in pre.get("due") or ())
    if not due:
        return None
    active = int(pre.get("active") or 0)
    return ControlAction(
        seq=seq, round=round_idx, tick=tick, rule=LIFECYCLE_RULE,
        actuator="probe", old=active, new=max(0, active - len(due)),
        clients=due, pre=dict(pre),
        message=f"release {list(due)} to probation (probe on next "
                "participation)")


def decide_probation(policy: ControlPolicy, *, round_idx: int, tick: int,
                     pre: Dict[str, Any],
                     seq0: int) -> List[ControlAction]:
    """Diagnose probationers who participated this round.

    ``pre = {"probation": sorted ids on probation, "participants":
    sorted ids in this round's cohort, "flagged": sorted participant ids
    the defense flagged}``.  Flagged probationers are re-quarantined;
    clean ones are re-admitted.  Emitted in (requarantine, readmit)
    order with consecutive seqs.
    """
    probation = set(int(c) for c in pre.get("probation") or ())
    participants = set(int(c) for c in pre.get("participants") or ())
    flagged = set(int(c) for c in pre.get("flagged") or ())
    seen = probation & participants
    if not seen:
        return []
    bad = tuple(sorted(seen & flagged))
    good = tuple(sorted(seen - flagged))
    actions: List[ControlAction] = []
    seq = seq0
    if bad:
        until = round_idx + policy.quarantine_rounds
        actions.append(ControlAction(
            seq=seq, round=round_idx, tick=tick, rule=LIFECYCLE_RULE,
            actuator="requarantine", clients=bad, until=until,
            pre=dict(pre),
            message=f"probe failed: re-quarantine {list(bad)} until "
                    f"round {until}"))
        seq += 1
    if good:
        actions.append(ControlAction(
            seq=seq, round=round_idx, tick=tick, rule=LIFECYCLE_RULE,
            actuator="readmit", clients=good, pre=dict(pre),
            message=f"probe clean: re-admit {list(good)}"))
    return actions


def rederive_action(policy: ControlPolicy, action: Dict[str, Any], *,
                    suspects: Sequence[Sequence[Any]] = (),
                    num_clients: int = 0) -> Optional[Dict[str, Any]]:
    """Re-derive a recorded action from its own ``pre`` block + the
    row's ``ledger_top_suspects`` — the offline re-derivation
    path.  Returns the re-derived action as a dict (bit-comparable to
    the record) or None if the decision functions would not have fired.
    """
    pre = action.get("pre") or {}
    seq = int(action["seq"])
    round_idx = int(action["round"])
    tick = int(action["tick"])
    rule = str(action["rule"])
    actuator = str(action["actuator"])
    if actuator == "agg_every":
        out = decide_agg_every(policy, seq=seq, round_idx=round_idx,
                               tick=tick, rule=rule, pre=pre)
    elif actuator == "window":
        out = decide_window(policy, seq=seq, round_idx=round_idx,
                            tick=tick, rule=rule, pre=pre)
    elif actuator in ("buffer_capacity", "weight_cutoff"):
        out = decide_buffer(policy, seq=seq, round_idx=round_idx,
                            tick=tick, rule=rule, pre=pre)
    elif actuator == "quarantine":
        out = decide_quarantine(policy, seq=seq, round_idx=round_idx,
                                tick=tick, rule=rule, pre=pre,
                                suspects=suspects,
                                num_clients=num_clients)
    elif actuator == "replan":
        out = decide_replan(policy, seq=seq, round_idx=round_idx,
                            tick=tick, rule=rule, pre=pre)
    elif actuator == "probe":
        out = decide_probe(policy, seq=seq, round_idx=round_idx,
                           tick=tick, pre=pre)
    elif actuator in ("requarantine", "readmit"):
        matches = [a for a in decide_probation(
            policy, round_idx=round_idx, tick=tick, pre=pre, seq0=seq)
            if a.actuator == actuator]
        # seq0 above assumed this action led the pair; if it was the
        # trailing readmit, its recorded seq is authoritative — rebuild
        # with it so the comparison is over decision content, not pair
        # ordering arithmetic.
        out = dataclasses.replace(matches[0], seq=seq) if matches else None
    else:
        raise ValueError(f"unknown actuator {actuator!r} in recorded "
                         "action")
    return out.as_dict() if out is not None else None
