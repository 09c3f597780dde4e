"""Closed-loop controller: watchdog events -> journaled actuator moves.

Host-side bookkeeping around the pure decision functions in
:mod:`blades_tpu_torch.control.policy`.  The controller never touches the
engine itself — it RETURNS actions and the driver applies them (engine
setters for async actuators; a ``replan`` is journaled only, since the
port has no autotuner) — so the decision layer stays testable and
replayable in isolation.  Counterpart of
``blades_tpu/control/controller.py``: the same row streams give the
same journals in both packages.

Time discipline: all decisions are keyed to the ROUND INDEX and the
async VIRTUAL TICK stamped in the row.  No wall clock enters a policy
decision; the one wall-derived
sensor (``round_time_regression``) only ever maps to a ``replan``, whose
journaled decision carries no timing payload.

Determinism: controller state (cooldowns, quarantine/probation sets,
journal, seq counter) rides the training checkpoint via
``state()``/``restore()``, so kill-and-resume continues the exact
journal a straight-through run would produce.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

from blades_tpu_torch.control.policy import (
    ControlAction,
    ControlPolicy,
    decide_agg_every,
    decide_buffer,
    decide_probation,
    decide_probe,
    decide_quarantine,
    decide_replan,
    decide_window,
)

logger = logging.getLogger(__name__)


class Controller:
    """Per-trial closed-loop controller.

    ``values`` holds the controller's view of the live actuator values
    (``agg_every``/``buffer_capacity``/``weight_cutoff``/``window``;
    None on the sync driver, which has none of the four).  ``window``
    is only seeded on out-of-core async drivers — it names the same
    engine knob as ``agg_every`` but is the shrink-only family admitted
    under ``state_store != "resident"``.  The driver seeds them at
    build time and applies every returned action back to the engine, so
    view and engine can only diverge if the driver drops an action —
    which the apply helpers log loudly.
    """

    def __init__(self, policy: ControlPolicy, *, num_clients: int,
                 agg_every: Optional[int] = None,
                 buffer_capacity: Optional[int] = None,
                 weight_cutoff: Optional[int] = None,
                 window: Optional[int] = None,
                 allow_replan: bool = False):
        self.policy = policy
        self.num_clients = int(num_clients)
        self.allow_replan = bool(allow_replan)
        self.values: Dict[str, Optional[int]] = {
            "agg_every": agg_every,
            "buffer_capacity": buffer_capacity,
            "weight_cutoff": weight_cutoff,
            "window": window,
        }
        self._cooldown_until: Dict[str, int] = {}
        self.quarantine: Dict[int, int] = {}  # client -> release round
        self.probation: Dict[int, int] = {}   # client -> probe-start round
        self.journal: List[Dict[str, Any]] = []
        self._seq = 0

    # -- queries -------------------------------------------------------------

    def quarantined_clients(self) -> frozenset:
        return frozenset(self.quarantine)

    @property
    def actions_total(self) -> int:
        return len(self.journal)

    def summary(self) -> Dict[str, Any]:
        return {
            "actions": len(self.journal),
            "quarantined": sorted(self.quarantine),
            "probation": sorted(self.probation),
            "values": dict(self.values),
        }

    # -- the control step ----------------------------------------------------

    def step(self, *, round_idx: int, tick: int,
             events: Sequence[Any] = (),
             suspects: Sequence[Sequence[Any]] = (),
             participants: Sequence[int] = (),
             flagged: Sequence[int] = ()) -> List[ControlAction]:
        """One control step over a finalized round.

        ``events`` are this round's watchdog events (objects or dicts);
        ``suspects`` the row's ``ledger_top_suspects``; ``participants``
        /``flagged`` the cohort client ids and the defense-flagged
        subset (probe diagnoses).  Returns the actions taken, already
        journaled and applied to the controller's own state — the
        caller applies them to the engine.
        """
        actions: List[ControlAction] = []
        # 1) quarantine expiries -> probation (probe on next sighting).
        due = sorted(c for c, rel in self.quarantine.items()
                     if rel <= round_idx)
        if due:
            act = decide_probe(
                self.policy, seq=self._seq, round_idx=round_idx,
                tick=tick,
                pre={"due": due, "active": len(self.quarantine)})
            if act is not None:
                self._commit(act)
                actions.append(act)
                for c in due:
                    self.quarantine.pop(c, None)
                    self.probation[c] = round_idx
        # 2) probe diagnoses for probationers who participated.
        if self.probation and len(participants):
            pre = {"probation": sorted(self.probation),
                   "participants": sorted(int(c) for c in participants),
                   "flagged": sorted(int(c) for c in flagged)}
            for act in decide_probation(self.policy, round_idx=round_idx,
                                        tick=tick, pre=pre,
                                        seq0=self._seq):
                self._commit(act)
                actions.append(act)
                for c in act.clients:
                    self.probation.pop(c, None)
                    if act.actuator == "requarantine":
                        self.quarantine[c] = act.until
        # 3) event-driven moves, rate-limited per actuator family.
        for ev in events:
            act = self._respond(ev, round_idx=round_idx, tick=tick,
                                suspects=suspects)
            if act is not None:
                actions.append(act)
        return actions

    def _respond(self, event, *, round_idx: int, tick: int,
                 suspects) -> Optional[ControlAction]:
        rule = event.get("rule") if isinstance(event, dict) \
            else getattr(event, "rule", None)
        if not rule:
            return None
        family = self.policy.actuator_for(str(rule))
        if family is None:
            return None  # rule has no mapped response
        if round_idx < self._cooldown_until.get(family, -1):
            return None  # hysteresis: family is cooling down
        if family == "agg_every":
            act = decide_agg_every(
                self.policy, seq=self._seq, round_idx=round_idx,
                tick=tick, rule=str(rule),
                pre={"old": self.values["agg_every"]})
        elif family == "window":
            act = decide_window(
                self.policy, seq=self._seq, round_idx=round_idx,
                tick=tick, rule=str(rule),
                pre={"old": self.values["window"]})
        elif family == "buffer":
            act = decide_buffer(
                self.policy, seq=self._seq, round_idx=round_idx,
                tick=tick, rule=str(rule),
                pre={"old": self.values["buffer_capacity"],
                     "cutoff": self.values["weight_cutoff"]})
        elif family == "quarantine":
            excluded = sorted(set(self.quarantine) | set(self.probation))
            act = decide_quarantine(
                self.policy, seq=self._seq, round_idx=round_idx,
                tick=tick, rule=str(rule),
                pre={"excluded": excluded,
                     "active": len(self.quarantine)},
                suspects=suspects or (),
                num_clients=self.num_clients)
        else:  # replan
            act = decide_replan(
                self.policy, seq=self._seq, round_idx=round_idx,
                tick=tick, rule=str(rule),
                pre={"allowed": self.allow_replan})
        if act is None:
            return None
        self._commit(act)
        self._cooldown_until[family] = round_idx + self.policy.cooldown_rounds
        if act.actuator in self.values:
            self.values[act.actuator] = act.new
        if act.actuator == "quarantine":
            for c in act.clients:
                self.quarantine[c] = act.until
        return act

    def _commit(self, act: ControlAction) -> None:
        self.journal.append(act.as_dict())
        self._seq = act.seq + 1

    # -- checkpoint threading ------------------------------------------------

    def state(self) -> Dict[str, Any]:
        """JSON-able state for the training checkpoint (int keys go
        through str for json round-trip safety)."""
        return {
            "values": dict(self.values),
            "cooldown_until": dict(self._cooldown_until),
            "quarantine": {str(c): r for c, r in self.quarantine.items()},
            "probation": {str(c): r for c, r in self.probation.items()},
            "journal": [dict(a) for a in self.journal],
            "seq": self._seq,
        }

    def restore(self, state: Dict[str, Any]) -> None:
        self.values.update(state.get("values") or {})
        self._cooldown_until = {
            str(k): int(v)
            for k, v in (state.get("cooldown_until") or {}).items()}
        self.quarantine = {
            int(c): int(r)
            for c, r in (state.get("quarantine") or {}).items()}
        self.probation = {
            int(c): int(r)
            for c, r in (state.get("probation") or {}).items()}
        self.journal = [dict(a) for a in state.get("journal") or []]
        self._seq = int(state.get("seq") or len(self.journal))
