"""Execution autotuner: measured plan selection for the round pipeline
(counterpart of ``blades_tpu/perf/autotune.py``).

The round pipeline has several performance knobs -- the execution path
(``execution="auto"``), client lane-packing (``client_packing="auto"``),
scan windows (``rounds_per_dispatch``), the streamed chunk width
``d_chunk`` and dense batch prefetch -- each resolved by its own
heuristic.  This module picks them by measurement: enumerate the legal
plans, time each on the card, cache the winner.

- **Plan space** (:class:`Plan`, :func:`enumerate_plans`), field for field
  the JAX package's: a **default tier** of knobs that reproduce the
  untuned trajectory bit for bit (chunk widths on chunk-invariant
  rounds, scan windows, prefetch) and an opt-in **reassociating tier**
  (dense <-> streamed, lane-packing, the wire domain, the state store).
  The ``mxu_finish`` field stays in the plan's vocabulary so the plan
  dicts and ``plan_id`` s are the JAX package's; the port has no MXU route
  and offers only ``""``.
- **Trial harness** (:func:`timed_measure_fn`, :func:`select_plan`): on
  the card each candidate is built as its own
  :class:`~blades_tpu_torch.algorithms.fedavg.Fedavg`, runs ``warmup``
  dispatches and reports the median of ``reps`` timed ones (``train()``
  syncs the card at the end of each dispatch), per FL round; it is then
  stopped and its buffers released before the next candidate is built,
  so the peak device memory is one candidate's.  Off the card (the CPU
  tests) selection falls back to the deterministic ranked heuristic:
  ``candidates[0]``, the plan today's heuristics resolve.  Tests inject a
  fake clock through ``clock=``.  On a mesh (``num_devices > 1``, one
  process a rank) every rank builds and times each candidate together:
  the ranks agree after each step whether it still stands (a candidate
  that fails on one rank is dropped on all), and rank 0's medians decide
  the winner, which every rank adopts with rank 0's provenance.
- **Plan cache** (:class:`PlanCache`): winners persist to one JSON file
  per key ``(config fingerprint, tier, device name, torch and CUDA
  versions)`` under ``$BLADES_TPU_TORCH_PLAN_CACHE_DIR`` or
  ``~/.cache/blades_tpu_torch/plans`` (the port's own directory: a TPU
  entry never serves the card), written atomically (tmp + fsync +
  ``os.replace``).  A torn, corrupt or stale entry means a re-tune, never
  a crash.  On a mesh only rank 0 reads and writes it (the ranks may not
  share a filesystem) and broadcasts what it read.
  ``python -m blades_tpu_torch.tools.show_plan`` lists, shows and
  invalidates entries.

The driver's side is
:meth:`blades_tpu_torch.algorithms.fedavg.Fedavg._resolve_autotune_plan`.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import statistics
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

PLAN_CACHE_VERSION = 1
ENV_CACHE_DIR = "BLADES_TPU_TORCH_PLAN_CACHE_DIR"
_DEFAULT_CACHE_DIR = "~/.cache/blades_tpu_torch/plans"

# Streamed d_chunk candidates around the historical hard-coded default
# (1 << 17).  Small on purpose: the chunk knob trades scan-carry size
# against dispatch count, and the knee sits within one octave of the
# default on every geometry measured so far.
D_CHUNK_LADDER = (1 << 16, 1 << 17, 1 << 18)

# Enumeration ceiling.  The knob grid is small by construction, but a
# pathological composition (reassociating tier x windows x ladder) must
# not turn one trial's tuning into a compile marathon; the drop count is
# recorded in the provenance so the cap is never silent.
MAX_CANDIDATES = 32

DEFAULT_TIER = "default"
REASSOCIATING_TIER = "reassociating"


@dataclasses.dataclass(frozen=True)
class Plan:
    """One resolved execution configuration for the round pipeline.

    Every field materialises a knob the ``"auto"`` heuristics used to
    resolve independently; :func:`apply_plan` writes them back into a
    :class:`~blades_tpu_torch.algorithms.config.FedavgConfig` before the
    driver builds its dispatch pipeline.
    """

    execution: str = "dense"          # resolved path — never "auto"
    d_chunk: int = 1 << 17            # streamed finish chunk width
    client_packing: int = 1           # clients per grouped-kernel lane
    mxu_finish: str = ""              # "" | "counts" | "all" (streamed)
    rounds_per_dispatch: int = 1      # chained scan window; 1 = per-round
    prefetch: bool = False            # dense single-round batch staging
    agg_domain: str = "f32"           # "f32" | "wire" (dense + quant codec)
    # Participation-window store (blades_tpu/state): where off-cohort
    # per-client rows live and the pinned cohort size (None = no
    # window — the pre-store program).  Backends are bit-identical by
    # contract; the knob still rides the reassociating tier because it
    # reshapes the staging pipeline rather than the numerics tiering
    # the default tier was defined over.
    state_store: str = "resident"     # "resident" | "host" | "disk"
    state_window: Optional[int] = None
    # Multi-device knobs.  ``mesh_shape=None`` is the single-
    # chip / config-resolved-mesh baseline — the plan does not touch the
    # device layout at all, so every pre-mesh plan_id stays byte-
    # identical.  A ``(c, dd)`` pair pins the 2-D ``(clients, d)`` mesh;
    # ``collective="hier"`` switches the round to the hierarchical
    # pre-aggregating path (parallel/hier.py) — reassociating tier by
    # construction, since bucketing reassociates the defense.
    mesh_shape: Optional[Tuple[int, int]] = None
    collective: str = "ring"          # "ring" | "hier"
    tier: str = DEFAULT_TIER          # numerics tier this plan belongs to

    def __post_init__(self):
        if self.execution not in ("dense", "streamed"):
            raise ValueError(f"plan execution must be dense|streamed, "
                             f"got {self.execution!r}")
        if self.mesh_shape is not None:
            ms = tuple(int(v) for v in self.mesh_shape)
            if len(ms) != 2 or min(ms) < 1:
                raise ValueError(f"plan mesh_shape must be a (clients, d) "
                                 f"pair of positive ints, got "
                                 f"{self.mesh_shape!r}")
            # Normalise (JSON round-trips lists; the frozen dataclass
            # must still hash/compare by value for dedupe).
            object.__setattr__(self, "mesh_shape", ms)
        if self.collective not in ("ring", "hier"):
            raise ValueError(f"plan collective must be ring|hier, "
                             f"got {self.collective!r}")
        if self.collective == "hier" and self.mesh_shape is None:
            raise ValueError("plan collective='hier' needs a mesh_shape "
                             "— the hierarchical path is defined by its "
                             "(clients, d) mesh")
        if self.state_store not in ("resident", "host", "disk"):
            raise ValueError(f"plan state_store must be resident|host|"
                             f"disk, got {self.state_store!r}")
        if self.state_window is not None and int(self.state_window) < 0:
            raise ValueError(f"plan state_window must be None or >= 0, "
                             f"got {self.state_window}")
        if self.agg_domain not in ("f32", "wire"):
            raise ValueError(f"plan agg_domain must be f32|wire, "
                             f"got {self.agg_domain!r}")
        if self.mxu_finish not in ("", "counts", "all"):
            raise ValueError(f"plan mxu_finish must be ''|'counts'|'all', "
                             f"got {self.mxu_finish!r}")
        if self.tier not in (DEFAULT_TIER, REASSOCIATING_TIER):
            raise ValueError(f"unknown plan tier {self.tier!r}")
        if int(self.d_chunk) < 1024:
            raise ValueError(f"plan d_chunk must be >= 1024, "
                             f"got {self.d_chunk}")
        if int(self.client_packing) < 1:
            raise ValueError(f"plan client_packing must be >= 1, "
                             f"got {self.client_packing}")
        if int(self.rounds_per_dispatch) < 1:
            raise ValueError(f"plan rounds_per_dispatch must be >= 1, "
                             f"got {self.rounds_per_dispatch}")

    @property
    def plan_id(self) -> str:
        """Compact stable identifier, stamped per round (``plan_id``).
        The wire-domain marker is appended only when engaged, so every
        f32-domain id is byte-identical to the pre-knob format."""
        return (f"{self.execution}|c{int(self.d_chunk)}"
                f"|p{int(self.client_packing)}"
                f"|mxu={self.mxu_finish or 'off'}"
                f"|w{int(self.rounds_per_dispatch)}"
                f"|{'pre' if self.prefetch else 'nopre'}"
                + ("|wire" if self.agg_domain == "wire" else "")
                # Window-store marker only when engaged: every
                # store-free id stays byte-identical to the pre-knob
                # format (the agg_domain discipline).
                + (f"|ss={self.state_store}w{int(self.state_window)}"
                   if self.state_window is not None else "")
                # Mesh markers follow the same only-when-engaged
                # discipline: mesh-free plan ids are byte-identical to
                # the pre-pod format (regression-pinned).
                + (f"|mesh={self.mesh_shape[0]}x{self.mesh_shape[1]}"
                   if self.mesh_shape is not None else "")
                + ("|hier" if self.collective == "hier" else ""))

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Plan":
        """Parse a plan dict (checkpoint payloads, cache entries, the
        ``tuned_plan`` config pin).  Unknown keys raise — a cache entry
        written by a FUTURE plan layout must read as stale, not be
        half-applied."""
        if not isinstance(d, dict):
            raise ValueError(f"plan must be a dict, got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown plan fields {unknown}")
        return cls(**d)


def apply_plan(config, plan: Plan) -> None:
    """Materialise ``plan`` into the config's knob fields (the driver
    then builds its pipeline from those exactly as an untuned run
    would).  Composition contract: a knob the user set EXPLICITLY was
    never varied by the plan space, so writing the plan back either
    repeats the user's value or resolves an ``"auto"``.
    """
    config.execution = plan.execution
    config.d_chunk = int(plan.d_chunk)
    if plan.mesh_shape is not None:
        # Pod-scale plan: pin the 2-D device layout, and the hierarchical
        # collective switches the execution path outright (the "hier"
        # round is a distinct program, not a dense variant).
        config.mesh_shape = tuple(int(v) for v in plan.mesh_shape)
        if plan.collective == "hier":
            config.execution = "hier"
    if plan.state_window is not None:
        # Window pinned by construction (the plan space never varies
        # it); the backend may have been probed, so materialise it.
        config.state_store = plan.state_store
        config.state_window = int(plan.state_window)
    if plan.execution == "dense":
        config.client_packing = (int(plan.client_packing)
                                 if plan.client_packing >= 2 else "off")
        if plan.rounds_per_dispatch == 1:
            config.prefetch = bool(plan.prefetch)
        # Wire-domain aggregation (dense + deferrable codec only; the
        # plan space never offers "wire" elsewhere, and an explicit
        # user agg_domain pins its list to one entry).
        config.agg_domain = plan.agg_domain
    else:
        config.client_packing = "off"
        config.mxu_finish = plan.mxu_finish
    rpd = int(plan.rounds_per_dispatch)
    prior = int(getattr(config, "rounds_per_dispatch", 1) or 1)
    config.rounds_per_dispatch = rpd
    if rpd > 1 and prior != rpd:
        # The chained key discipline is what makes windowed rows
        # bit-identical to round-per-dispatch execution; every
        # window the plan space INTRODUCES comes from the sweep's
        # eligibility gate, which only ever engages chained windows.  A
        # window the USER pinned (prior == rpd — the plan space never
        # varies it) keeps the user's own chained_dispatch setting: the
        # plain multi_step discipline is a legal explicit choice the
        # tuner must not silently rewrite.
        config.chained_dispatch = True


# ---------------------------------------------------------------------------
# plan-space enumeration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanSpace:
    """Ordered candidate plans.  ``candidates[0]`` is ALWAYS the plan
    the current hand-written heuristics resolve (the heuristic-fallback
    winner); the rest follow in deterministic enumeration order.
    ``truncated`` counts candidates dropped by :data:`MAX_CANDIDATES`.
    """

    candidates: Tuple[Plan, ...]
    truncated: int = 0

    @property
    def baseline(self) -> Plan:
        return self.candidates[0]


def enumerate_plans(
    *,
    executions: Sequence[str],
    d_chunks: Sequence[int],
    mxu_modes: Sequence[str] = ("",),
    pack_factors: Sequence[int] = (1,),
    scan_windows: Sequence[int] = (1,),
    prefetch_options: Sequence[bool] = (False,),
    agg_domains: Sequence[str] = ("f32",),
    state_stores: Sequence[str] = ("resident",),
    state_windows: Sequence[Optional[int]] = (None,),
    mesh_shapes: Sequence[Optional[Tuple[int, int]]] = (None,),
    collectives: Sequence[str] = ("ring",),
    num_devices: int = 1,
    allow_reassociating: bool = False,
    max_candidates: int = MAX_CANDIDATES,
) -> PlanSpace:
    """Enumerate legal plans from per-knob candidate lists.

    Every list is ordered **baseline value first** — the caller derives
    the lists from the config's constraints (explicit settings collapse
    a list to one entry) — so the nested enumeration yields the current
    heuristic resolution as ``candidates[0]`` by construction.

    Tier assignment: switching the execution path, packing clients,
    aggregating in the quantized wire domain, or enabling the
    ``stats_mxu`` finish ("all") reassociates float reductions and
    lands in :data:`REASSOCIATING_TIER`; chunk sizes, the bit-exact
    radix counts ("counts"), chained scan windows and prefetch stay
    :data:`DEFAULT_TIER`.  Without ``allow_reassociating`` the
    reassociating tier is not enumerated at all — an un-opted run can
    never be handed one.  ``agg_domains`` applies to the dense path
    only (codecs are dense-path features; the caller gates "wire" on a
    deferrable quant codec and the absence of f32-domain-only stages).
    """
    if not executions:
        raise ValueError("executions must name at least the baseline path")
    if not d_chunks:
        raise ValueError("d_chunks must hold at least the baseline chunk")
    for ms in mesh_shapes:
        if ms is None:
            continue
        if int(num_devices) <= 1:
            raise ValueError(
                f"mesh_shape {tuple(ms)} candidates need num_devices > 1 "
                f"(got {num_devices}) — the pod-scale tier is only legal "
                "on a multi-chip run")
        if int(ms[0]) * int(ms[1]) != int(num_devices):
            raise ValueError(
                f"mesh_shape {tuple(ms)} must tile exactly "
                f"{num_devices} devices")
    plans: List[Plan] = []
    # Mesh knobs enumerate OUTERMOST, baseline (no-mesh, ring) first:
    # with the default (None,)/("ring",) lists the loop collapses to one
    # iteration and the enumeration order — hence candidates[0] and
    # every plan_id — is byte-identical to the pre-pod tuner.
    for ms in mesh_shapes:
        for coll in collectives:
            if coll == "hier" and ms is None:
                continue  # the hierarchical path is defined by its mesh
            mesh_tier = (DEFAULT_TIER
                         if ms == mesh_shapes[0] and coll == collectives[0]
                         else REASSOCIATING_TIER)
            for exe in executions:
                exe_tier = (mesh_tier if exe == executions[0]
                            else REASSOCIATING_TIER)
                if exe == "streamed" and ms is not None:
                    continue  # streamed × mesh does not exist
                for w in scan_windows:
                    if coll == "hier" and int(w) != 1:
                        continue  # hier is dispatched per-round (no scan)
                    if exe == "streamed":
                        for dc in d_chunks:
                            for mxu in mxu_modes:
                                tier = exe_tier
                                if mxu == "all" and mxu_modes[0] != "all":
                                    tier = REASSOCIATING_TIER
                                plans.append(Plan(
                                    execution="streamed", d_chunk=int(dc),
                                    client_packing=1, mxu_finish=mxu,
                                    rounds_per_dispatch=int(w), prefetch=False,
                                    tier=tier))
                    else:
                        for p in pack_factors:
                            for ad in agg_domains:
                                for ss in state_stores:
                                    for sw in state_windows:
                                        if coll == "hier" and (
                                                int(p) != 1 or ad != "f32"
                                                or sw is not None):
                                            # packing / wire-domain /
                                            # window store have no
                                            # hierarchical formulation
                                            continue
                                        tier = exe_tier
                                        if p != pack_factors[0]:
                                            tier = REASSOCIATING_TIER
                                        if ad != agg_domains[0]:
                                            # Quantized-domain statistics
                                            # reassociate f32 reductions AND
                                            # rank on the int8 grid — never a
                                            # default-tier handout.
                                            tier = REASSOCIATING_TIER
                                        if (ss != state_stores[0]
                                                or sw != state_windows[0]):
                                            # Store backends are bit-identical,
                                            # but reshaping the staging pipeline
                                            # is an opt-in probe, not
                                            # a default-tier handout.
                                            tier = REASSOCIATING_TIER
                                        pres = (prefetch_options
                                                if int(w) == 1
                                                and coll != "hier"
                                                else (False,))
                                        for pre in pres:
                                            plans.append(Plan(
                                                execution="dense",
                                                d_chunk=int(d_chunks[0]),
                                                client_packing=int(p),
                                                mxu_finish="",
                                                rounds_per_dispatch=int(w),
                                                prefetch=bool(pre),
                                                agg_domain=str(ad),
                                                state_store=str(ss),
                                                state_window=(None if sw is None
                                                              else int(sw)),
                                                mesh_shape=ms,
                                                collective=str(coll),
                                                tier=tier))
    if not allow_reassociating:
        plans = [p for p in plans if p.tier == DEFAULT_TIER]
    # Dedupe preserving order (e.g. a chunk ladder whose entries clamp
    # to the same effective width on a small model).
    plans = list(dict.fromkeys(plans))
    truncated = max(0, len(plans) - max_candidates)
    if truncated:
        plans = plans[:max_candidates]
    return PlanSpace(candidates=tuple(plans), truncated=truncated)


# ---------------------------------------------------------------------------
# trial harness
# ---------------------------------------------------------------------------


def timing_available(device=None) -> bool:
    """Whether wall-clock candidate trials mean anything: on the card they
    time the round pipeline; on the CPU (the tests, laptops) selection
    uses the deterministic heuristic ranking instead."""
    import torch

    try:
        return torch.device(device if device is not None else "cuda").type \
            == "cuda" and torch.cuda.is_available()
    except (RuntimeError, TypeError, ValueError):
        return False


def timed_measure_fn(
    config,
    *,
    warmup: int = 1,
    reps: int = 3,
    clock: Optional[Callable[[], float]] = None,
    build: Optional[Callable[[Any], Any]] = None,
    device=None,
    mesh=None,
) -> Callable[[Plan], Optional[float]]:
    """Build the measured-trial function: plan -> median seconds per **FL
    round** (or ``None`` when the candidate fails to build or run; a
    failure raised in a kernel's build or launch,
    :func:`~blades_tpu_torch.ops._cuda.raised_in_kernel`, propagates, on a
    mesh from every rank).

    One ``train()`` dispatch advances ``plan.rounds_per_dispatch`` rounds,
    so the dispatch median is divided by the window width.  The candidate
    config is a copy with ``autotune`` off and the plan materialised,
    built as its own driver on ``device`` (``build`` replaces
    ``candidate.build(device=device)``); ``train()`` syncs the card at the
    end of each dispatch, so ``clock`` (``time.perf_counter`` unless
    injected) times finished work.  Each candidate is stopped, dropped and
    the allocator's cache emptied before the next one is built, so the
    peak device memory is one candidate's; on the card ``measure.peaks``
    maps each ``plan_id`` to its peak allocated bytes (this rank's).

    On a mesh (``config.num_devices > 1``) every rank of the process group
    calls ``measure`` on the same plans in the same order, and the
    candidate's driver runs its rounds on all of them, in lockstep.  After
    the build and after each warm-up and timed ``train()`` the ranks agree
    (:func:`~blades_tpu_torch.parallel.mesh.all_ranks_ok`, on ``mesh``,
    the whole group's, made from ``config.num_devices`` unless given)
    whether the candidate still stands: one that raised on any rank is
    dropped on every rank (``None``), and they go on to the next candidate
    together.  A barrier between the build and the first warm-up keeps
    the skew of the ranks' setup out of the timed window.  Each rank
    returns its own median; the caller takes rank 0's (:func:`select_plan`
    with ``mesh``).  A rank can drop out only between
    collectives: a failure that leaves a rank inside one (a rank-local
    error in the middle of a round, while the others wait in its gather)
    cannot be recovered, and ends as the process group's timeout error,
    not as a silent hang.
    """
    clock = clock or time.perf_counter
    if warmup < 0 or reps < 1:
        raise ValueError(f"need warmup >= 0, reps >= 1; got {warmup}/{reps}")
    multi = int(getattr(config, "num_devices", None) or 1) > 1

    def measure(plan: Plan) -> Optional[float]:
        import torch

        from blades_tpu_torch.ops import _cuda
        from blades_tpu_torch.parallel.mesh import all_ranks_ok, make_mesh

        group = None
        if multi:
            group = (mesh if mesh is not None
                     else make_mesh(int(config.num_devices)))
        cand = config.copy()
        cand.autotune = False
        cand.tuned_plan = None
        cand._autotune_windows = None
        apply_plan(cand, plan)
        on_card = torch.device(device if device is not None
                               else "cuda").type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        algo = None

        def attempt(fn, what):
            """``fn()``; whether it went through on every rank.  A
            candidate that fails is ranked out, loudly; a kernel's failure
            is never hidden behind another plan: on a mesh the ranks then
            agree once more, and every rank raises."""
            err = None
            try:
                fn()
            except Exception as exc:
                if group is None and _cuda.raised_in_kernel(exc):
                    raise
                err = exc
            ok = err is None
            if group is not None:
                label = f"autotune:{what}"
                ok = all_ranks_ok(group, ok, label=label)
                kernel = err is not None and _cuda.raised_in_kernel(err)
                if not ok and not all_ranks_ok(group, not kernel,
                                               label=label):
                    if kernel:
                        raise err
                    raise RuntimeError(
                        f"autotune candidate {plan.plan_id}: a kernel "
                        f"failed on another rank in its {what}")
            if err is not None:
                warnings.warn(
                    f"autotune candidate {plan.plan_id} failed and was "
                    f"skipped: {type(err).__name__}: {err}", RuntimeWarning)
            elif not ok:
                warnings.warn(
                    f"autotune candidate {plan.plan_id} failed on another "
                    f"rank in its {what} and was skipped", RuntimeWarning)
            return ok

        def built():
            nonlocal algo
            algo = (build(cand) if build is not None
                    else cand.build(device=device))

        times = []

        def timed_train():
            t0 = clock()
            algo.train()
            times.append(clock() - t0)

        try:
            if not attempt(built, "build"):
                return None
            if group is not None:
                import torch.distributed as dist

                dist.barrier()  # blades-lint: disable=topology-discipline — a barrier moves no bytes the rows report: it lines the ranks up before a candidate's timed steps
            for _ in range(warmup):
                if not attempt(algo.train, "warmup"):
                    return None
            for _ in range(reps):
                if not attempt(timed_train, "timed"):
                    return None
        finally:
            if algo is not None and callable(getattr(algo, "stop", None)):
                algo.stop()
            algo = None
            gc.collect()
            if on_card:
                measure.peaks[plan.plan_id] = int(
                    torch.cuda.max_memory_allocated())
                torch.cuda.empty_cache()
        return float(statistics.median(times)) / max(
            1, int(plan.rounds_per_dispatch))

    measure.peaks = {}
    return measure


def select_plan(
    space: PlanSpace,
    *,
    measure_fn: Optional[Callable[[Plan], Optional[float]]] = None,
    mesh=None,
) -> Tuple[Plan, Dict[str, Any]]:
    """Pick the winner from ``space``.

    With a ``measure_fn``: every candidate is measured, the fastest
    median wins (heuristic rank breaks exact ties, so selection is
    deterministic under an injected clock).  Without one — or when
    every measurement fails — the deterministic ranked heuristic wins:
    ``space.candidates[0]``, the plan the current resolution order
    produces, marked ``"mode": "heuristic"`` in the provenance.

    With ``mesh`` (a process group's), every rank measures in lockstep
    (:func:`timed_measure_fn`) and rank 0's medians decide: the winner and
    the provenance are rank 0's on every rank
    (:func:`~blades_tpu_torch.parallel.mesh.broadcast_object`).
    """
    timings: List[Optional[float]] = []
    if measure_fn is not None:
        for plan in space.candidates:
            timings.append(measure_fn(plan))
    else:
        timings = [None] * len(space.candidates)
    measured = [(t, i) for i, t in enumerate(timings) if t is not None]
    if measured:
        _, win = min(measured)
        mode, timed = "measured", True
    else:
        win, mode, timed = 0, "heuristic", False
    winner = space.candidates[win]
    provenance = {
        "mode": mode,                  # "measured" | "heuristic"
        "timed": timed,
        "cache_hit": False,
        "winner": winner.as_dict(),
        "winner_id": winner.plan_id,
        "candidates": [
            {"rank": i, "plan_id": p.plan_id, "tier": p.tier,
             "median_s": timings[i]}
            for i, p in enumerate(space.candidates)
        ],
        "truncated": space.truncated,
    }
    if mesh is not None:
        from blades_tpu_torch.parallel.mesh import broadcast_object

        provenance = broadcast_object(mesh, provenance,
                                      label="autotune:winner")
        winner = Plan.from_dict(provenance["winner"])
    return winner, provenance


# ---------------------------------------------------------------------------
# persistent plan cache
# ---------------------------------------------------------------------------


def cache_key(
    config_fingerprint: str,
    tier: str = DEFAULT_TIER,
    device_kind: Optional[str] = None,
    torch_version: Optional[str] = None,
    cuda_version: Optional[str] = None,
) -> Dict[str, str]:
    """The plan-cache key: a plan tuned for one program on one card under
    one torch / CUDA build is evidence about exactly that.  The config
    fingerprint leaves out ``seed`` (a seed grid shares one plan) and the
    autotune fields; ``tier`` keeps a reassociating-tier winner from ever
    serving a default-tier run.  ``device_kind`` defaults to
    ``torch.cuda.get_device_name()`` (``"cpu"`` without a card)."""
    import torch

    if device_kind is None:
        try:
            device_kind = (torch.cuda.get_device_name()
                           if torch.cuda.is_available() else "cpu")
        except RuntimeError:
            device_kind = "unknown"
    if torch_version is None:
        torch_version = str(torch.__version__)
    if cuda_version is None:
        cuda_version = str(torch.version.cuda)
    return {
        "fingerprint": str(config_fingerprint),
        "tier": str(tier),
        "device_kind": str(device_kind),
        "torch": torch_version,
        "cuda": cuda_version,
    }


class PlanCache:
    """On-disk winner cache: one JSON file per key under ``cache_dir``
    (``$BLADES_TPU_TORCH_PLAN_CACHE_DIR`` or
    ``~/.cache/blades_tpu_torch/plans``).

    Durability follows :func:`blades_tpu_torch.faults.host.atomic_checkpoint`
    scaled down to a file: write ``<entry>.json.tmp``, fsync, one
    ``os.replace``.  A SIGKILL mid-write leaves either the previous
    entry or an orphaned ``.tmp`` that the next read deletes — never a
    torn entry.  Reads are corrupt-tolerant by contract: any
    undecodable / version-stale / key-mismatched / unparsable-plan file
    is treated as a miss (re-tune), never an exception.
    """

    def __init__(self, cache_dir=None):
        cache_dir = (cache_dir
                     or os.environ.get(ENV_CACHE_DIR)
                     or _DEFAULT_CACHE_DIR)
        self.dir = Path(cache_dir).expanduser()

    @staticmethod
    def digest(key: Dict[str, str]) -> str:
        return hashlib.sha1(
            json.dumps(key, sort_keys=True).encode()).hexdigest()

    def _path(self, key: Dict[str, str]) -> Path:
        return self.dir / f"{self.digest(key)}.json"

    def get(self, key: Dict[str, str]) -> Optional[Dict[str, Any]]:
        """The cached entry for ``key``, or ``None`` (miss / corrupt /
        stale / mismatched).  Also deletes this key's orphaned ``.tmp``
        (a writer killed before its ``os.replace``)."""
        path = self._path(key)
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
        entry = self._read_entry(path)
        if entry is None:
            return None
        if entry.get("key") != key:
            # sha1 collision or a hand-moved file: the stored key is the
            # source of truth, the filename just locates it.
            return None
        return entry

    @staticmethod
    def _read_entry(path: Path) -> Optional[Dict[str, Any]]:
        try:
            entry = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(entry, dict):
            return None
        if entry.get("version") != PLAN_CACHE_VERSION:
            return None
        try:
            Plan.from_dict(entry.get("plan"))
        except (ValueError, TypeError):
            return None
        return entry

    def put(self, key: Dict[str, str], plan: Plan,
            provenance: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Persist a winner atomically; returns the entry path, or
        ``None`` when the filesystem refuses (an unwritable cache must
        degrade to tune-per-process, never fail the trial)."""
        entry = {
            "version": PLAN_CACHE_VERSION,
            "key": dict(key),
            "plan": plan.as_dict(),
            "provenance": dict(provenance or {}),
            "created_unix": time.time(),  # blades-lint: disable=trace-discipline — wall-clock cache metadata stamp, not a duration measurement
        }
        path = self._path(key)
        tmp = path.with_name(path.name + ".tmp")
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(entry, f, indent=2, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError as exc:
            warnings.warn(f"plan cache write failed ({exc}); the plan "
                          "will be re-tuned next process", RuntimeWarning)
            try:
                tmp.unlink()
            except OSError:
                pass
            return None
        return str(path)

    def entries(self) -> List[Tuple[str, Optional[Dict[str, Any]]]]:
        """Every ``(digest, entry-or-None)`` in the cache dir, sorted;
        ``None`` marks a file the tolerant reader rejected (corrupt or
        stale-version) — surfaced so ``show_plan`` can report
        rather than hide them."""
        if not self.dir.is_dir():
            return []
        out = []
        for p in sorted(self.dir.glob("*.json")):
            out.append((p.stem, self._read_entry(p)))
        return out

    def invalidate(self, digest: Optional[str] = None) -> List[str]:
        """Delete one entry by digest, or every entry (and orphaned
        ``.tmp``) when ``digest`` is None.  Returns the removed names."""
        if not self.dir.is_dir():
            return []
        removed = []
        pats = ([f"{digest}.json", f"{digest}.json.tmp"] if digest
                else ["*.json", "*.json.tmp"])
        for pat in pats:
            for p in sorted(self.dir.glob(pat)):
                try:
                    p.unlink()
                    removed.append(p.name)
                except OSError:
                    pass
        return removed
