"""Grid expansion and the sequential trial runner (counterpart of
``blades_tpu/tune/sweep.py``).

An experiment file maps names to ``{run, stop, config}`` specs; every
``{"grid_search": [...]}`` node in ``config``, at any depth, expands to
the cartesian product of trials in the JAX package's depth-first order.
Each trial runs in ``<storage>/<experiment>/<experiment>_<i:05d>/`` and
writes ``params.json`` (its config), ``result.json`` (one JSON row per
dispatch) and ``metrics.jsonl`` (the same rows, each validated against
:mod:`blades_tpu_torch.obs.schema`; ``metrics.csv`` beside it on
request), with atomic checkpoints ``ckpt_<round:06d>/``, resume, retries
from the latest checkpoint and the simulated-preemption hook, as the JAX
runner does.  The observability layer is the JAX runner's too: a span
tree per trial exported as Chrome trace JSON (``trace_dir``), the anomaly
watchdog over the written rows (``watchdog``; it defers to rows the
driver's own control-plane watchdog already stamped) and the flight
recorder (``flightrec_rounds``; ``<trial>/flightrec.json`` on a
non-finite aggregate, a watchdog event, an exception or a preemption).

Trial lanes (``lanes=True``, the default, as in the JAX runner): the
trials of an experiment that differ only in lane knobs (seed, client or
server lr, DP epsilon or clip, IPM's scale: :func:`lane_groups`) run as
the lanes of one program (:func:`blades_tpu_torch.tune.lanes.run_lanes`)
when the group is eligible (:func:`_lanes_eligible`: two or more fresh
dense trials of at most 200 clients, one round per dispatch, no
forensics, faults, participation window, ledger or control plane, and the
``L * n * d * 4`` bytes of the laned matrix within the dense budget of
``Fedavg.dense_matrix_limit``) and the sweep neither resumes, checkpoints
nor retries.  Each laned trial writes the files a sequential one writes;
its summary carries ``lanes`` and ``rounds_per_sec = rounds * L / wall``.
A group that fails warns, stamps its trials' summaries
(``lane_fallback``) and runs them one by one, except where the failure
came from a kernel's build or launch, which raises.

Scan windows (``scan_window="auto"``, the default, as in the JAX
runner): a fresh straight-line sweep (no resume, retries or preemption
hook) runs each eligible trial with ``rounds_per_dispatch`` set to the
largest window that divides the round budget, the evaluation interval
and the checkpoint frequency (:func:`_eligible_scan_windows`, at most 8
rounds), and still writes one row per FL round
(``Fedavg.train_rows(per_round=True)``); each round draws from its own
round seed, so the rows are the round-per-dispatch rows.  ``autotune``
arms the execution autotuner (:mod:`blades_tpu_torch.perf.autotune`) on
every trial that does not set its own: autotuned trials run one by one,
the sweep hands the plan space the eligible windows, retries and resumes
pin the plan their latest checkpoint recorded
(:func:`_pin_checkpoint_plan`), and the summary carries the selection
record as ``"autotune"``.  ``compile_cache_dir`` names the directory the
CUDA kernels build into and load from
(:mod:`blades_tpu_torch.perf.compile_cache`); a trial whose kernel
build looked it up carries ``"compile_cache"`` (hits, misses).
``cost_analysis`` (on by default) adds ``"cost"``: one dispatch's counted
operations and bytes (``Fedavg.cost_analysis``).  Before the first trial
runs, every trial's config is resolved (the config and its round, built
on the meta device), so a field the port lacks raises before any round
is paid for.

Under a ``torch.distributed`` process group every rank runs every trial
(a trial with ``num_devices`` runs on the ranks; checkpoints are
collective), and rank 0 alone writes the trial's files: ``params.json``,
``result.json``, the metrics streams, the flight recorder, checkpoints,
``error.txt`` and the span trace.  The other ranks read the checkpoints
to resume.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import itertools
import json
import os
import shutil
import time
import traceback
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from blades_tpu_torch.ops._cuda import raised_in_kernel
from blades_tpu_torch.parallel.mesh import mesh_grid
from blades_tpu_torch.tune import yaml_subset

def _is_primary() -> bool:
    """Whether this process writes the trials' files: a lone process, or
    rank 0 of a process group."""
    import torch.distributed as dist

    return (not (dist.is_available() and dist.is_initialized())
            or dist.get_rank() == 0)


class PeerFailure(RuntimeError):
    """A trial attempt failed on another rank of the mesh; ``final`` when
    it failed there for good (a retry would fail the same way)."""

    def __init__(self, final: bool):
        super().__init__("the trial attempt failed on another rank"
                         + (" for good" if final else ""))
        self.final = final


def _final_failure(exc: BaseException) -> bool:
    """Whether a retry cannot cure ``exc``: schema drift is deterministic
    (a retry fails the same way on its first row)."""
    from blades_tpu_torch.obs import SchemaError

    return (isinstance(exc, SchemaError)
            or isinstance(exc, PeerFailure) and exc.final)


@contextlib.contextmanager
def _as_one(algo):
    """Every rank of ``algo``'s mesh leaves the block with one outcome.
    Rank 0 alone writes a trial's rows, sinks and files, so a failure there
    (an I/O error, a schema error) is one rank's: the ranks all-reduce the
    worst outcome (0 none, 1 a retry may cure it, 2 for good), and a rank
    whose block went through raises :class:`PeerFailure`, so that the ranks
    retry or stop together instead of one waiting in a collective the
    others never reach.  Off a mesh the block runs as it is.  A failure
    inside a collective (a round, a checkpoint's gather) is not covered."""
    from blades_tpu_torch.parallel.mesh import all_ranks_max

    mesh = getattr(algo, "mesh", None)
    if mesh is None or mesh.world_size == 1:
        yield
        return
    try:
        yield
    except Exception as exc:
        own = 2 if _final_failure(exc) else 1
        if all_ranks_max(mesh, own) > own:
            raise PeerFailure(final=True) from exc
        raise
    worst = all_ranks_max(mesh, 0)
    if worst:
        raise PeerFailure(final=worst == 2)


def _checkpoint(algo, path: Path, primary: bool) -> None:
    """Save ``algo`` to ``path``: atomically on the writing rank; on the
    others the call takes part in the collective gather and writes
    nothing."""
    from blades_tpu_torch.faults.host import atomic_checkpoint

    if primary:
        atomic_checkpoint(algo.save_checkpoint, path)
    else:
        algo.save_checkpoint(str(path))


# ---------------------------------------------------------------------------
# grid_search expansion (Tune-compatible)
# ---------------------------------------------------------------------------


def _find_grids(node: Any, path: Tuple = ()) -> List[Tuple[Tuple, List]]:
    """Every ``{"grid_search": [...]}`` node, depth-first."""
    grids = []
    if isinstance(node, dict):
        if set(node.keys()) == {"grid_search"}:
            return [(path, node["grid_search"])]
        for k, v in node.items():
            grids.extend(_find_grids(v, path + (k,)))
    elif isinstance(node, list):
        for i, v in enumerate(node):
            grids.extend(_find_grids(v, path + (i,)))
    return grids


def _set_path(cfg: Any, path: Tuple, value: Any) -> None:
    node = cfg
    for p in path[:-1]:
        node = node[p]
    node[path[-1]] = value


def expand_grid(config: Dict) -> List[Dict]:
    """The cartesian product over every grid_search node, in a fixed
    order (the last grid varies fastest)."""
    grids = _find_grids(config)
    if not grids:
        return [copy.deepcopy(config)]
    paths = [g[0] for g in grids]
    values = [g[1] for g in grids]
    trials = []
    for combo in itertools.product(*values):
        trial = copy.deepcopy(config)
        for path, v in zip(paths, combo):
            _set_path(trial, path, copy.deepcopy(v))
        trials.append(trial)
    return trials


def load_experiments_from_file(path: str) -> Dict[str, Dict]:
    """An experiment file ``{name: {run, stop, config, ...}}``, read by
    :mod:`~blades_tpu_torch.tune.yaml_subset`; ``stop`` defaults to 100
    rounds and ``config`` to empty."""
    experiments = yaml_subset.load_file(path)
    if not isinstance(experiments, dict):
        raise ValueError(f"{path} must map experiment names to specs")
    for name, spec in experiments.items():
        if "run" not in spec:
            raise ValueError(f"experiment {name!r} missing 'run' (algorithm "
                             "name)")
        spec.setdefault("stop", {"training_iteration": 100})
        spec.setdefault("config", {})
    return experiments


# ---------------------------------------------------------------------------
# lane grouping: which trials can share one laned program?
# ---------------------------------------------------------------------------

# Trial-dict paths a lane may vary, mapped to tune.lanes flat keys.
_LANE_PATHS = {
    ("dataset_config", "seed"): "seed",
    ("seed",): "seed",
    ("client_config", "lr"): "client_lr",
    ("client_lr",): "client_lr",
    ("server_config", "lr"): "server_lr",
    ("server_lr",): "server_lr",
    ("dp_epsilon",): "dp_epsilon",
    ("dp_clip_threshold",): "dp_clip_threshold",
    ("adversary_config", "scale"): "adversary_scale",
}
_LANE_SENTINEL = "__LANE__"


def _get_path(cfg, path):
    node = cfg
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None, False
        node = node[p]
    return node, True


def _lane_signature(trial: Dict):
    """``(signature json, {lane key: value})``: trials with equal
    signatures differ only in lane knobs.  A trial that sets one lane knob
    through two paths with different values (``seed`` and
    ``dataset_config.seed``) is signed by its whole config, so it is
    never laned."""
    present_paths = {}
    conflict = False
    for path, key in _LANE_PATHS.items():
        val, present = _get_path(trial, path)
        if present and not isinstance(val, (dict, list)):
            if key in present_paths and present_paths[key][1] != val:
                conflict = True
            else:
                present_paths[key] = (path, val)
    if conflict:
        sig = dict(trial, __lane_conflict__=True)
        return json.dumps(sig, sort_keys=True, default=str), {}
    sig = copy.deepcopy(trial)
    overrides = {}
    for key, (path, val) in present_paths.items():
        overrides[key] = val
        _set_path(sig, path, _LANE_SENTINEL)
    return json.dumps(sig, sort_keys=True, default=str), overrides


def lane_groups(trials: List[Dict]) -> List[List[int]]:
    """Trial indices grouped by :func:`_lane_signature` (same static
    config, differing only in lane knobs); a singleton runs
    sequentially."""
    by_sig: Dict[str, List[int]] = {}
    for i, t in enumerate(trials):
        sig, _ = _lane_signature(t)
        by_sig.setdefault(sig, []).append(i)
    return list(by_sig.values())


def _lanes_eligible(spec_run: str, trial: Dict, group: List[int],
                    device=None) -> bool:
    """Whether the group may run as lanes: the JAX runner's gate (dense
    trials of at most 200 clients, one round per dispatch, no forensics,
    faults or participation window, no ``server_lr`` lanes under an
    ``lr_schedule``, and the laned ``L * n * d * 4`` bytes within the
    dense budget on ``device``, no autotune), and no client ledger or
    control plane, which the laned program does not carry."""
    if len(group) < 2:
        return False
    try:
        cfg = _build_config(spec_run, copy.deepcopy(trial))
        cfg.validate()
    except Exception:
        return False
    if not (cfg.execution in ("auto", "dense")
            and cfg.num_clients <= 200
            and not cfg.num_devices
            and int(cfg.rounds_per_dispatch or 1) == 1):
        return False
    if (cfg.forensics or cfg.fault_config or cfg.state_window is not None
            or cfg.ledger_backend or cfg.control_enabled):
        return False
    if cfg.autotune_mode:
        # The laned program has no plan machinery: an autotuned trial runs
        # on its own, so its plan, provenance and checkpoint record engage.
        return False
    if cfg.lr_schedule and "server_lr" in _lane_signature(trial)[1]:
        return False
    from blades_tpu_torch.algorithms.fedavg import Fedavg
    from blades_tpu_torch.device import resolve_device

    try:
        with torch.device("meta"):
            d = sum(p.numel() for p in
                    cfg.get_task_spec().build().model.parameters())
        limit = Fedavg.dense_matrix_limit(resolve_device(device))
    except Exception as exc:
        warnings.warn(f"lane eligibility probe failed for group {group}: "
                      f"{type(exc).__name__}: {exc}", RuntimeWarning)
        return False
    return len(group) * cfg.num_clients * d * 4 <= limit


# ---------------------------------------------------------------------------
# scan windows and the autotuner's checkpointed plan
# ---------------------------------------------------------------------------

_SCAN_WINDOW_CAP = 8


def _eligible_scan_windows(config, max_rounds: int, checkpoint_freq: int,
                           cap: int = _SCAN_WINDOW_CAP) -> Tuple[int, ...]:
    """Every dispatch window ``w`` (``<= cap``, descending, 1 last) whose
    windowed execution writes the round-per-dispatch rows: ``w`` divides
    the round budget, the evaluation interval and the checkpoint
    frequency.  A trial that pins ``rounds_per_dispatch``, a forensics,
    participation-window or control-plane trial (the controller acts
    between rounds; ``validate()`` refuses it with windows) and any
    execution but ``auto`` / ``dense`` offer no window.  The head is
    ``scan_window="auto"``'s pick, the whole list the autotuner's
    candidates."""
    if int(getattr(config, "rounds_per_dispatch", 1) or 1) != 1:
        return (1,)
    if getattr(config, "forensics", False):
        return (1,)
    if getattr(config, "state_window", None) is not None \
            and config.state_window >= 1:
        return (1,)
    if getattr(config, "num_devices", None):
        return (1,)
    if getattr(config, "control_enabled", False):
        return (1,)
    if getattr(config, "execution", "auto") not in ("auto", "dense"):
        return (1,)
    interval = int(getattr(config, "evaluation_interval", 0) or 0)
    out = []
    for w in range(min(cap, max_rounds), 1, -1):
        if max_rounds % w:
            continue
        if interval and interval % w:
            continue
        if checkpoint_freq and checkpoint_freq % w:
            continue
        out.append(w)
    out.append(1)
    return tuple(out)


def _auto_scan_window(config, max_rounds: int, checkpoint_freq: int,
                      cap: int = _SCAN_WINDOW_CAP) -> int:
    """The largest eligible dispatch window; 1 when none qualifies."""
    return _eligible_scan_windows(config, max_rounds, checkpoint_freq,
                                  cap)[0]


def _pin_checkpoint_plan(config, tdir: Path) -> None:
    """Pin an autotuned trial's plan to the one its latest checkpoint was
    written under (``config.tuned_plan``), so a retry or resume replays it
    instead of re-tuning mid-trajectory.  A no-op without autotune, a
    checkpoint or a recorded plan."""
    if not getattr(config, "autotune_mode", None):
        return
    ckpt = _latest_checkpoint(tdir)
    if ckpt is None:
        return
    try:
        payload = torch.load(ckpt / "algorithm_state.pkl", map_location="cpu",
                             weights_only=False, mmap=True)
        plan = payload.get("plan")
    except Exception:
        return  # the restore itself will surface an unreadable checkpoint
    if plan:
        config.tuned_plan = plan


# ---------------------------------------------------------------------------
# result rows and checkpoints on disk
# ---------------------------------------------------------------------------


def _trial_name(base: str, idx: int, trial_cfg: Dict) -> str:
    return f"{base}_{idx:05d}"


def _read_results(path: Path) -> List[Dict]:
    """A trial's ``result.json`` rows, up to a torn final line."""
    rows = []
    if not path.exists():
        return rows
    for line in path.read_text().splitlines():
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            break
    return rows


def _truncate_results(path: Path, upto_round: int) -> None:
    """Drop the rows past ``upto_round`` (and any torn fragment) before a
    restored run appends, so no round is written twice.  Every line is
    parsed on its own: a fragment mid-stream does not hide the valid rows
    after it."""
    if not path.exists():
        return
    kept, dirty = [], False
    for line in path.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            dirty = True
            continue
        if r.get("training_iteration", 0) <= upto_round:
            kept.append(line)
        else:
            dirty = True
    if dirty:
        with open(path, "w") as f:
            for line in kept:
                f.write(line + "\n")


def _truncate_csv(path: Path, upto_round: int) -> None:
    """:func:`_truncate_results` for ``metrics.csv``, by its
    ``training_iteration`` column; a row whose iteration does not parse
    (a torn final line) is kept: truncation never destroys data it
    cannot read."""
    if not path.exists():
        return
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows or "training_iteration" not in rows[0]:
        return
    col = rows[0].index("training_iteration")
    kept = [rows[0]]
    for row in rows[1:]:
        try:
            if int(float(row[col])) > upto_round:
                continue
        except (IndexError, ValueError):
            pass
        kept.append(row)
    if len(kept) != len(rows):
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows(kept)


def _truncate_streams(tdir: Path, upto_round: int) -> None:
    """Cut ``result.json``, ``metrics.jsonl`` and ``metrics.csv`` back to
    ``upto_round`` before a restored run appends."""
    _truncate_results(tdir / "result.json", upto_round)
    _truncate_results(tdir / "metrics.jsonl", upto_round)
    _truncate_csv(tdir / "metrics.csv", upto_round)


def _latest_checkpoint(tdir: Path) -> Optional[Path]:
    """The newest periodic checkpoint (``ckpt_<round>``).  Orphaned
    ``ckpt_*.tmp`` directories, an atomic write a kill interrupted, are
    deleted here and never restored."""
    ckpts = []
    for p in tdir.glob("ckpt_*"):
        if p.name.endswith(".tmp"):
            shutil.rmtree(p, ignore_errors=True)
        elif p.name != "ckpt_final":
            ckpts.append(p)
    ckpts.sort(key=lambda p: p.name)
    return ckpts[-1] if ckpts else None


def verify_result_rounds(path) -> List[int]:
    """The no-duplicate, no-gap check of a trial's ``result.json``:
    ``training_iteration`` strictly increasing with one stride (1, or
    ``rounds_per_dispatch``).  Returns the iterations, or raises
    ``ValueError``."""
    rows = _read_results(Path(path))
    its = [r.get("training_iteration") for r in rows]
    if any(i is None for i in its):
        raise ValueError(f"{path}: rows missing training_iteration")
    if not its:
        return its
    stride = its[1] - its[0] if len(its) > 1 else 1
    expected = list(range(its[0], its[0] + stride * len(its), stride))
    if stride < 1 or its != expected:
        shown = f"{its[:20]}..." if len(its) > 20 else f"{its}"
        raise ValueError(f"{path}: round sequence has duplicates or gaps: "
                         f"{shown}")
    return its


def _prune_checkpoints(tdir: Path, keep_num: Optional[int],
                       scores: Dict[str, float]) -> None:
    """Keep the ``keep_num`` best checkpoints by recorded score, the newest
    winning ties."""
    if not keep_num:
        return
    ckpts = [p for p in tdir.glob("ckpt_*") if p.name != "ckpt_final"]
    if len(ckpts) <= keep_num:
        return
    ckpts.sort(key=lambda p: (scores.get(p.name, float("-inf")), p.name))
    for p in ckpts[:len(ckpts) - keep_num]:
        shutil.rmtree(p, ignore_errors=True)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def _build_config(run: str, trial_cfg: Dict):
    from blades_tpu_torch.algorithms import get_algorithm_class

    _, config = get_algorithm_class(run, return_config=True)
    config.update_from_dict(trial_cfg)
    return config


#: Row fields stamped onto the span that dispatched the row.
_TRACE_ROW_ATTRS = (
    "training_iteration", "hbm_passes", "hbm_passes_unfused",
    "agg_domain", "agg_domain_bits", "comm_bytes_up", "codec_bits",
    "comm_compression_ratio", "elided_lanes", "dequant_rows",
    "num_participating", "num_dropped", "num_straggled",
)


def _resolve_watchdog(watchdog):
    """The ``watchdog`` request as a rule tuple, or None: ``True`` /
    ``"on"`` arms ``default_rules()``; a sequence of rule dicts or
    :class:`~blades_tpu_torch.obs.watchdog.WatchdogRule` supplies its
    own (unknown keys, kinds and fields fail here)."""
    if not watchdog:
        return None
    from blades_tpu_torch.obs.watchdog import default_rules, rules_from_config

    if watchdog is True or watchdog == "on":
        return default_rules()
    return rules_from_config(list(watchdog))


def _run_lane_group(
    spec_run: str,
    trials: List[Dict],
    group: List[int],
    max_rounds: int,
    exp_name: str,
    root: Path,
    verbose: int,
    *,
    device=None,
    metrics_csv: bool = False,
    strict_metrics: bool = True,
    metrics_every: int = 1,
    trace_dir: Optional[str] = None,
    wd_rules=None,
    flightrec_rounds: int = 0,
) -> Dict[int, Dict]:
    """Run one lane group as one laned program; write each member trial's
    ``params.json``, ``result.json`` and metrics streams as the sequential
    path writes them and return its summaries by trial index.  The
    watchdog and the flight recorder read each trial's rows after the
    group finishes, with fresh per-trial state."""
    from blades_tpu_torch.obs import CsvSink, JsonlSink, MetricsLogger
    from blades_tpu_torch.obs.flightrec import FlightRecorder
    from blades_tpu_torch.obs.trace import Timers
    from blades_tpu_torch.obs.watchdog import Watchdog
    from blades_tpu_torch.tune.lanes import run_lanes

    sig_cfg = None
    overrides = []
    for i in group:
        sig, ov = _lane_signature(trials[i])
        overrides.append(ov)
        sig_cfg = sig_cfg or json.loads(sig)

    def strip_sentinels(node):
        if isinstance(node, dict):
            return {k: strip_sentinels(v) for k, v in node.items()
                    if v != _LANE_SENTINEL}
        if isinstance(node, list):
            return [strip_sentinels(v) for v in node]
        return node

    shared = strip_sentinels(sig_cfg)

    def builder():
        return _build_config(spec_run, copy.deepcopy(shared))

    if verbose:
        print(f"== lane group {exp_name}[{group[0]}..{group[-1]}]: "
              f"{len(group)} trials x {max_rounds} rounds as one program ==",
              flush=True)
    tracer = Timers(record=bool(trace_dir))
    gspan = tracer.start("lane_group", experiment=exp_name,
                         trials=len(group), rounds=max_rounds)
    results = run_lanes(builder, overrides, max_rounds, device=device,
                        metrics_every=metrics_every, tracer=tracer)
    tracer.finish(gspan)
    wall = gspan.duration
    if trace_dir:
        tracer.export(Path(trace_dir).expanduser()
                      / f"{exp_name}_lanes_{group[0]:05d}-{group[-1]:05d}"
                        ".trace.json")
    out: Dict[int, Dict] = {}
    for lane, i in enumerate(group):
        tname = _trial_name(exp_name, i, trials[i])
        tdir = root / exp_name / tname
        tdir.mkdir(parents=True, exist_ok=True)
        for p in tdir.glob("ckpt_*"):
            shutil.rmtree(p, ignore_errors=True)
        for p in (tdir / "metrics.csv", tdir / "flightrec.json"):
            p.unlink(missing_ok=True)
        with open(tdir / "params.json", "w") as f:
            json.dump(trials[i], f, indent=2, default=str)
        rows = results[lane]
        sinks: List = [JsonlSink(tdir / "metrics.jsonl",
                                 strict=strict_metrics)]
        if metrics_csv:
            sinks.append(CsvSink(tdir / "metrics.csv"))
        wd = Watchdog(wd_rules) if wd_rules is not None else None
        flightrec = (FlightRecorder(
            tdir / "flightrec.json", capacity=flightrec_rounds,
            experiment=exp_name, trial=tname, algo=spec_run,
            config=trials[i], max_rounds=max_rounds)
            if flightrec_rounds else None)
        logger = MetricsLogger(sinks, base={"experiment": exp_name,
                                            "trial": tname})
        try:
            with open(tdir / "result.json", "w") as f:
                for row in rows:
                    events = [e.as_dict() for e in
                              (wd.observe(row) if wd is not None else [])]
                    if events:
                        row["watchdog_events"] = events
                    f.write(json.dumps({**row, "trial": tname}) + "\n")
                    logger.log(row)
                    if flightrec is not None:
                        flightrec.record(row)
                        trig = flightrec.check(row)
                        if trig is None and events:
                            trig = {"kind": "watchdog",
                                    "rules": [e["rule"] for e in events],
                                    "round": row.get("training_iteration")}
                        if trig is not None:
                            flightrec.dump(trig)
        finally:
            logger.close()
        best = max((r.get("test_acc", 0.0) for r in rows), default=0.0)
        final = {k: rows[-1][k] for k in ("test_loss", "test_acc",
                                          "test_acc_top3")
                 if k in rows[-1]} if rows else {}
        out[i] = {
            "trial": tname, "rounds": max_rounds,
            "wall_s": round(wall, 2),
            "rounds_per_sec": (round(max_rounds * len(group) / wall, 2)
                               if wall else None),
            "best_test_acc": best,
            "evaluated": any("test_acc" in r for r in rows),
            "final": final, "dir": str(tdir), "lanes": len(group),
        }
        packing = _packing_summary(rows[-1] if rows else {})
        if packing:
            out[i]["packing"] = packing
    return out


def _packing_summary(row: Dict) -> Optional[Dict]:
    """The packing stamps of a laned trial's last row (static per round);
    a sequential trial's summary carries the fuller decision of
    ``Fedavg.packing_summary`` instead."""
    packing = {k: row[k] for k in ("pack_factor", "packed_lanes")
               if k in row}
    return packing or None


def resolve_trial(run: str, trial_cfg: Dict):
    """Build and validate one trial's config and its round on the meta
    device (no data, no memory, no training): a field, model, aggregator,
    attack or callback the port lacks raises here.  Returns the config."""
    config = _build_config(run, trial_cfg)
    config.validate()
    with torch.device("meta"):
        config.get_fed_round()
    return config


def run_experiments(
    experiments: Dict[str, Dict],
    storage_path: str = "~/blades_tpu_results",
    verbose: int = 1,
    checkpoint_freq: int = 0,
    checkpoint_at_end: bool = False,
    max_rounds_override: Optional[int] = None,
    resume: bool = False,
    checkpoint_keep_num: Optional[int] = None,
    checkpoint_score_attr: str = "training_iteration",
    max_failures: int = 0,
    retry_backoff_base: float = 0.5,
    retry_backoff_cap: float = 30.0,
    preempt_after: Optional[int] = None,
    metrics_every: int = 1,
    metrics_csv: bool = False,
    heartbeat_every: int = 10,
    strict_metrics: bool = True,
    trace_dir: Optional[str] = None,
    watchdog=False,
    flightrec_rounds: int = 16,
    device=None,
    lanes: bool = True,
    scan_window="auto",
    cost_analysis: bool = True,
    compile_cache_dir: Optional[str] = None,
    autotune=None,
    plan_cache_dir: Optional[str] = None,
) -> List[Dict]:
    """Run every trial of every experiment in turn on ``device`` (``None``
    = the card); returns one summary per trial (``trial``, ``rounds``,
    ``wall_s``, ``rounds_per_sec``, ``best_test_acc`` (0.0 until a row
    holds a ``test_acc``; ``evaluated`` says whether one did), ``final``,
    ``dir``, ``state_store`` / ``data_store`` (the stores' digests) where a
    trial has them, and ``status`` / ``error`` for a trial that failed,
    ``resumed`` for one that was restored or skipped).

    ``resume``: a trial whose ``result.json`` reached the stop round is
    skipped; one in flight restores its latest checkpoint and appends.
    ``checkpoint_freq`` saves every that many rounds (atomically: a
    ``.tmp`` directory, fsynced, then renamed), ``checkpoint_at_end`` a
    ``ckpt_final``, ``checkpoint_keep_num`` keeps the best by
    ``checkpoint_score_attr``.  ``max_failures``: a trial that raises is
    rebuilt and restored from its latest checkpoint up to that many times
    (the error appended to ``error.txt``), after an exponential backoff
    with deterministic jitter; a trial out of retries is marked failed and
    the rest still run.  ``preempt_after=N`` raises a
    ``SimulatedPreemption`` once, the first time a trial finishes round N,
    between its row write and its checkpoint save.  ``metrics_every=N``
    fetches the rounds' scalar metrics N rows at a time (flushed before
    every checkpoint and before the preemption hook): it sets when rows
    are written and batches their device-to-host copies.  It does not cut
    the host syncs on the card, where the ``training_step`` timer ends
    every dispatch with a device sync.  The driver's forensics, ledger
    and controller read a row when it is fetched, so under
    ``metrics_every=N`` they see (and act on) N rows at once.

    Observability: every row also goes to ``metrics.jsonl``, validated
    (a schema violation fails the trial at once, without retries; pass
    ``strict_metrics=False`` for a custom trainable), to ``metrics.csv``
    with ``metrics_csv`` and, at ``verbose > 1``, to a heartbeat line
    every ``heartbeat_every`` rounds.  ``trace_dir`` arms the span tracer
    and writes ``<trace_dir>/<trial>.trace.json``; ``watchdog`` (True or
    a rule list) arms the watchdog, whose events land in the row as
    ``watchdog_events`` and trigger the flight recorder;
    ``flightrec_rounds`` (0 = off) sizes the recorder's ring.  A resumed
    or retried trial rebuilds the watchdog's windows and the recorder's
    ring from the surviving rows.

    ``lanes=True`` (the default) runs each eligible lane group of a fresh
    sweep (no ``resume``, checkpoints or ``max_failures``) as one laned
    program (see the module docstring); its trials' summaries carry
    ``lanes`` instead of ``timers``.  ``lanes=False`` runs every trial on
    its own.  A trial whose packing was requested carries the decision
    as ``packing``.

    ``scan_window`` (``"auto"``, an int cap, or 1 to disable),
    ``autotune`` (True / ``"on"`` or ``"reassociating"``; a trial's own
    ``autotune`` wins), ``plan_cache_dir``, ``compile_cache_dir`` and
    ``cost_analysis``: see the module docstring.  A windowed trial's
    summary carries ``scan_window``.
    """
    from blades_tpu_torch.faults.host import (
        PreemptionHook,
        SimulatedPreemption,
        retry_backoff,
    )
    from blades_tpu_torch.obs import (
        CsvSink,
        JsonlSink,
        MetricsLogger,
        StdoutSink,
    )
    from blades_tpu_torch.obs.flightrec import FlightRecorder
    from blades_tpu_torch.obs.trace import Timers
    from blades_tpu_torch.obs.watchdog import Watchdog
    from blades_tpu_torch.utils.async_metrics import flush_rows

    from blades_tpu_torch.perf import compile_cache

    compile_cache.set_cache_dir(compile_cache_dir)
    wd_rules = _resolve_watchdog(watchdog)
    flightrec_rounds = int(flightrec_rounds or 0)

    def apply_autotune(config) -> bool:
        """The sweep's autotune request on a trial config (the trial's
        own settings win); whether the trial is autotuned."""
        if autotune and not config.autotune:
            config.autotune = autotune if isinstance(autotune, str) else True
        if plan_cache_dir and not config.autotune_cache_dir:
            config.autotune_cache_dir = plan_cache_dir
        return bool(config.autotune_mode)

    # Windows move dispatch boundaries, which is safe only on a fresh
    # straight-line sweep: a restore can land inside a window, and the
    # preemption hook fires between per-round dispatches.
    windows_ok = (scan_window not in (1, None, False) and not resume
                  and max_failures == 0 and preempt_after is None)
    window_cap = (_SCAN_WINDOW_CAP if scan_window == "auto"
                  else int(scan_window or 1))

    plans = []
    for exp_name, spec in experiments.items():
        trials = expand_grid(spec.get("config", {}))
        for trial_cfg in trials:
            config = resolve_trial(spec["run"], trial_cfg)
            if (getattr(config, "num_devices", None) or 1) > 1:
                # The process group must hold the trial's ranks.
                mesh_grid(config.num_devices, config.mesh_shape)
        plans.append((exp_name, spec, trials))

    preempt_hook = PreemptionHook(preempt_after) if preempt_after else None
    root = Path(storage_path).expanduser()
    primary = _is_primary()
    summaries = []
    for exp_name, spec, trials in plans:
        stop = spec.get("stop", {})
        max_rounds = int(max_rounds_override
                         or stop.get("training_iteration", 100))
        laned: Dict[int, Dict] = {}
        lane_failed: Dict[int, str] = {}
        if (lanes and not resume and not checkpoint_freq
                and not checkpoint_at_end and max_failures == 0
                and not autotune):
            for group in lane_groups(trials):
                if not _lanes_eligible(spec["run"], trials[group[0]], group,
                                       device=device):
                    continue
                try:
                    laned.update(_run_lane_group(
                        spec["run"], trials, group, max_rounds, exp_name,
                        root, verbose, device=device,
                        metrics_csv=metrics_csv,
                        strict_metrics=strict_metrics,
                        metrics_every=metrics_every, trace_dir=trace_dir,
                        wd_rules=wd_rules,
                        flightrec_rounds=flightrec_rounds))
                except Exception as exc:
                    if raised_in_kernel(exc):
                        raise
                    # Loud: the group warns, its trials' summaries say
                    # why, and they run one by one.
                    msg = f"{type(exc).__name__}: {exc}"
                    warnings.warn(
                        f"lane group {exp_name}{group} fell back to "
                        f"sequential execution ({msg})", RuntimeWarning)
                    print(f"   !! lane group {group} fell back to "
                          f"sequential ({msg})", flush=True)
                    for i in group:
                        lane_failed[i] = msg
        for i, trial_cfg in enumerate(trials):
            if i in laned:
                summaries.append(laned[i])
                if verbose:
                    print(f"   -> {laned[i]}", flush=True)
                continue
            tname = _trial_name(exp_name, i, trial_cfg)
            tdir = root / exp_name / tname
            if primary:
                tdir.mkdir(parents=True, exist_ok=True)
            if not resume and primary:
                # A fresh run must not restore a previous sweep's state,
                # nor keep its streams or its flight-recorder dump.
                for p in tdir.glob("ckpt_*"):
                    shutil.rmtree(p, ignore_errors=True)
                for p in (tdir / "metrics.jsonl", tdir / "metrics.csv",
                          tdir / "flightrec.json"):
                    p.unlink(missing_ok=True)
            prior = _read_results(tdir / "result.json") if resume else []
            best_acc = max((r.get("test_acc", 0.0) for r in prior),
                           default=0.0)
            evaluated = any("test_acc" in r for r in prior)
            done = prior[-1].get("training_iteration", 0) if prior else 0
            if resume and done >= max_rounds:
                if verbose:
                    print(f"== trial {tname}: finished ({done} rounds), "
                          "skipping ==", flush=True)
                summaries.append({
                    "trial": tname, "rounds": done, "wall_s": 0.0,
                    "rounds_per_sec": None, "best_test_acc": best_acc,
                    "evaluated": evaluated, "final": {}, "dir": str(tdir),
                    "resumed": "skipped"})
                continue
            config = _build_config(spec["run"], trial_cfg)
            autotuned = apply_autotune(config)
            scan_w = (_auto_scan_window(config, max_rounds, checkpoint_freq,
                                        window_cap) if windows_ok else 1)
            if autotuned:
                # The autotuner owns the window: it gets the eligible set,
                # and the effective window is read off the plan.
                if windows_ok:
                    config._autotune_windows = _eligible_scan_windows(
                        config, max_rounds, checkpoint_freq, window_cap)
                scan_w = 1
            elif scan_w > 1:
                config.rounds_per_dispatch = scan_w
                config.chained_dispatch = True
            cache_before = compile_cache.cache_stats()
            if resume and autotuned:
                _pin_checkpoint_plan(config, tdir)
            algo = config.build(device=device)
            if autotuned and algo.plan is not None:
                scan_w = int(algo.plan.rounds_per_dispatch)
            resumed_from = None
            with _as_one(algo):
                if resume:
                    ckpt = _latest_checkpoint(tdir)
                    if ckpt is not None:
                        algo.load_checkpoint(str(ckpt))
                        resumed_from = algo.iteration
                        if primary:
                            _truncate_streams(tdir, algo.iteration)
                if primary:
                    with open(tdir / "params.json", "w") as f:
                        json.dump(trial_cfg, f, indent=2, default=str)
            if verbose:
                tag = (f" (resumed @ round {resumed_from})"
                       if resumed_from else "")
                print(f"== trial {tname}: {max_rounds} rounds{tag} ==",
                      flush=True)
            timers = Timers(record=bool(trace_dir),
                            sync=algo.device.type == "cuda")
            if trace_dir:
                # One span tree per trial: the driver's phases nest in
                # the trial and round spans.
                algo.timers = timers
            trial_span = timers.start("trial", experiment=exp_name,
                                      trial=tname)
            start_round = algo.iteration
            ckpt_scores: Dict[str, float] = {}
            failures = 0
            failed_error = None
            last_row: Dict = {}
            compiled = False
            wd = Watchdog(wd_rules) if wd_rules is not None else None
            flightrec = (FlightRecorder(
                tdir / "flightrec.json", capacity=flightrec_rounds,
                experiment=exp_name, trial=tname, algo=spec["run"],
                config=trial_cfg, max_rounds=max_rounds)
                if flightrec_rounds and primary else None)
            if flightrec is not None:
                flightrec.ledger = algo.client_ledger

            def rewind():
                """The watchdog's windows and the recorder's ring from
                the rows that survived a restore."""
                surviving = _read_results(tdir / "result.json")
                if wd is not None:
                    wd.warm(surviving)
                if flightrec is not None:
                    flightrec.rewind(surviving)

            if resumed_from:
                rewind()
            while True:
                mode = "a" if (resumed_from or failures) else "w"
                logger = None
                try:
                    with _as_one(algo):
                        # A rank that does not write validates nothing
                        # twice.
                        sinks: List = ([JsonlSink(tdir / "metrics.jsonl",
                                                  mode=mode,
                                                  strict=strict_metrics)]
                                       if primary else [])
                        if metrics_csv and primary:
                            sinks.append(CsvSink(tdir / "metrics.csv",
                                                 mode=mode))
                        if verbose > 1:
                            sinks.append(StdoutSink(every=heartbeat_every))
                        logger = MetricsLogger(
                            sinks,
                            base={"experiment": exp_name, "trial": tname})
                        rows_file = open(tdir / "result.json" if primary
                                         else os.devnull, mode)
                    # One row per FL round from a windowed dispatch; the
                    # deferred fetch only for round-per-dispatch trials.
                    per_round_rows = scan_w > 1
                    pending: List[Dict] = []
                    with rows_file as f:

                        def emit(rows):
                            nonlocal best_acc, evaluated, last_row
                            for result in rows:
                                result["trial"] = tname
                                if "watchdog_events" in result:
                                    # The controlled driver's own
                                    # watchdog stamped them: observing
                                    # again would double-fire its rules.
                                    events = list(
                                        result["watchdog_events"] or [])
                                else:
                                    events = [e.as_dict() for e in (
                                        wd.observe(result) if wd is not None
                                        else [])]
                                    if events:
                                        result["watchdog_events"] = events
                                f.write(json.dumps(result) + "\n")
                                logger.log(result)
                                if flightrec is not None:
                                    flightrec.record(result)
                                    trig = flightrec.check(result)
                                    if trig is None and events:
                                        trig = {"kind": "watchdog",
                                                "rules": [e["rule"]
                                                          for e in events],
                                                "round": result.get(
                                                    "training_iteration")}
                                    if trig is not None:
                                        flightrec.dump(trig)
                                if trace_dir:
                                    timers.stamp_latest_of(
                                        ("round", "compile"),
                                        {k: result[k]
                                         for k in _TRACE_ROW_ATTRS
                                         if k in result})
                                best_acc = max(best_acc,
                                               result.get("test_acc", 0.0))
                                evaluated |= "test_acc" in result
                                last_row = result

                        def flush_pending():
                            nonlocal pending
                            if pending:
                                emit(flush_rows(pending, algo.finalize_row))
                                pending = []

                        # The stop criterion counts FL rounds; one call
                        # runs rounds_per_dispatch of them.
                        while algo.iteration < max_rounds:
                            # The first dispatch builds the kernels and
                            # the caches: its span is "compile".
                            with timers.time("round" if compiled
                                             else "compile",
                                             step=algo.iteration):
                                if per_round_rows:
                                    rows = algo.train_rows(per_round=True)
                                else:
                                    rows = None
                                    pending.append(algo.train_raw())
                            compiled = True
                            checkpoint_due = bool(
                                checkpoint_freq
                                and algo.iteration % checkpoint_freq == 0)
                            with _as_one(algo):
                                if rows is not None:
                                    emit(rows)
                                elif (len(pending) >= metrics_every
                                      or algo.iteration >= max_rounds):
                                    flush_pending()
                                if (preempt_hook is not None
                                        or checkpoint_due):
                                    flush_pending()
                                if preempt_hook is not None:
                                    # Between the row write and the
                                    # checkpoint save: the restore must
                                    # come from an older checkpoint.
                                    preempt_hook.check(algo.iteration)
                                if checkpoint_due:
                                    # Every round a checkpoint covers is
                                    # on disk first.
                                    f.flush()
                                    if primary:
                                        os.fsync(f.fileno())
                            if checkpoint_due:
                                name = f"ckpt_{algo.iteration:06d}"
                                with _as_one(algo):
                                    with timers.time("checkpoint"):
                                        _checkpoint(algo, tdir / name,
                                                    primary)
                                    ckpt_scores[name] = float(
                                        last_row.get(checkpoint_score_attr,
                                                     algo.iteration))
                                    if primary:
                                        _prune_checkpoints(
                                            tdir, checkpoint_keep_num,
                                            ckpt_scores)
                        with _as_one(algo):
                            flush_pending()
                    break
                except KeyboardInterrupt:
                    raise
                except Exception as exc:
                    failures += 1
                    if primary:
                        with open(tdir / "error.txt", "a") as ef:
                            ef.write(f"attempt {failures}: {exc!r}\n")
                            ef.write(traceback.format_exc() + "\n")
                    if flightrec is not None:
                        flightrec.dump({
                            "kind": ("preemption"
                                     if isinstance(exc, SimulatedPreemption)
                                     else "exception"),
                            "error": repr(exc), "round": algo.iteration})
                    # Schema drift is deterministic: a retry would fail
                    # the same way on its first row.
                    if _final_failure(exc) or failures > max_failures:
                        failed_error = repr(exc)
                        if verbose:
                            print(f"   !! trial {tname} FAILED after "
                                  f"{failures} attempt(s): {exc!r}",
                                  flush=True)
                        break
                    delay = retry_backoff(
                        failures,
                        trial_seed=f"{tname}:{trial_cfg.get('seed', 0)}",
                        base=retry_backoff_base, cap=retry_backoff_cap)
                    if delay > 0:
                        time.sleep(delay)
                    # A fresh build restored from the latest checkpoint,
                    # under the plan that checkpoint recorded.
                    algo.stop()
                    config = _build_config(spec["run"], trial_cfg)
                    if apply_autotune(config):
                        _pin_checkpoint_plan(config, tdir)
                    algo = config.build(device=device)
                    if trace_dir:
                        algo.timers = timers
                    compiled = False
                    ckpt = _latest_checkpoint(tdir)
                    if ckpt is not None:
                        algo.load_checkpoint(str(ckpt))
                    with _as_one(algo):
                        if primary:
                            _truncate_streams(tdir, algo.iteration)
                        if flightrec is not None:
                            flightrec.ledger = algo.client_ledger
                        rewind()
                    if verbose:
                        print(f"   .. retrying {tname} from round "
                              f"{algo.iteration} (failure {failures}/"
                              f"{max_failures})", flush=True)
                finally:
                    if logger is not None:
                        logger.close()
            if checkpoint_at_end and failed_error is None:
                with _as_one(algo), timers.time("checkpoint"):
                    _checkpoint(algo, tdir / "ckpt_final", primary)
            timers.finish(trial_span)
            wall = trial_span.duration
            if trace_dir and primary:
                timers.stamp_latest("trial", {"rounds": algo.iteration,
                                              "failures": failures})
                timers.export(Path(trace_dir).expanduser()
                              / f"{tname}.trace.json")
            new_rounds = algo.iteration - start_round
            summary = {
                "trial": tname, "rounds": algo.iteration,
                "wall_s": round(wall, 2),
                "rounds_per_sec": round(new_rounds / wall, 2) if wall else None,
                "best_test_acc": best_acc, "evaluated": evaluated,
                "final": dict(algo._last_eval),
                "dir": str(tdir), "timers": algo.timers.summary(),
            }
            # The out-of-core stores' digests (backend, window, bytes,
            # staging peak; the data store's last gather and eval chunks),
            # the ledger's fleet digest and the controller's.
            for key, block in (("state_store", algo.state_summary),
                               ("data_store", algo.data_summary),
                               ("ledger", algo.ledger_summary),
                               ("control", algo.control_summary)):
                if block:
                    summary[key] = block
            if algo.packing_summary:
                # Present whenever packing was requested: a fallback shows
                # pack_factor 1 and its reason.
                summary["packing"] = algo.packing_summary
            cache_after = compile_cache.cache_stats()
            cache_delta = {k: cache_after[k] - cache_before[k]
                           for k in ("hits", "misses")}
            if cache_delta["hits"] or cache_delta["misses"]:
                summary["compile_cache"] = cache_delta
            if scan_w > 1:
                summary["scan_window"] = scan_w
            if algo.plan_summary:
                # The selection record: mode, every candidate's median,
                # the winner, the cache hit.
                summary["autotune"] = algo.plan_summary
            if cost_analysis and failed_error is None:
                cost = algo.cost_analysis()
                if cost:
                    summary["cost"] = cost
            if i in lane_failed:
                summary["lane_fallback"] = lane_failed[i]
            if wd is not None and wd.events:
                summary["watchdog"] = {
                    "events": len(wd.events),
                    "rules": sorted({e.rule for e in wd.events})}
            if flightrec is not None and flightrec.dumps:
                summary["flightrec"] = {"dumps": flightrec.dumps,
                                        "path": str(tdir / "flightrec.json")}
            algo.stop()
            if failed_error is not None:
                summary["status"] = "ERROR"
                summary["error"] = failed_error
            if resumed_from is not None:
                summary["resumed"] = f"from round {resumed_from}"
            if verbose:
                print(f"   -> {summary}", flush=True)
            summaries.append(summary)
    return summaries
