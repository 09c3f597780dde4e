"""Grid expansion and the sequential trial runner (counterpart of
``blades_tpu/tune/sweep.py``).

An experiment file maps names to ``{run, stop, config}`` specs; every
``{"grid_search": [...]}`` node in ``config``, at any depth, expands to
the cartesian product of trials in the JAX package's depth-first order.
Each trial runs in ``<storage>/<experiment>/<experiment>_<i:05d>/`` and
writes ``params.json`` (its config) and ``result.json`` (one JSON row per
dispatch), with atomic checkpoints ``ckpt_<round:06d>/``, resume, retries
from the latest checkpoint and the simulated-preemption hook, as the JAX
runner does.

The JAX runner's vmapped lanes, scan windows, autotuner and plan cache,
compile cache, cost analysis, ``metrics.jsonl`` / ``metrics.csv`` and
their schema, spans, watchdog and flight recorder are not in the port.
Before the first trial runs, every trial's config is resolved (the config
and its round, built on the meta device), so a field the port lacks
raises before any round is paid for.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import shutil
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from blades_tpu_torch.tune import yaml_subset

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


def resolve_trial(run: str, trial_cfg: Dict) -> None:
    """Build and validate one trial's config and its round on the meta
    device (no data, no memory, no training): a field, model, aggregator,
    attack or callback the port lacks raises here."""
    config = _build_config(run, trial_cfg)
    config.validate()
    with torch.device("meta"):
        config.get_fed_round()


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
    device=None,
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
    every dispatch with a device sync.
    """
    from blades_tpu_torch.faults.host import (
        PreemptionHook,
        atomic_checkpoint,
        retry_backoff,
    )
    from blades_tpu_torch.utils.async_metrics import flush_rows

    plans = []
    for exp_name, spec in experiments.items():
        trials = expand_grid(spec.get("config", {}))
        for trial_cfg in trials:
            resolve_trial(spec["run"], trial_cfg)
        plans.append((exp_name, spec, trials))

    preempt_hook = PreemptionHook(preempt_after) if preempt_after else None
    root = Path(storage_path).expanduser()
    summaries = []
    for exp_name, spec, trials in plans:
        stop = spec.get("stop", {})
        max_rounds = int(max_rounds_override
                         or stop.get("training_iteration", 100))
        for i, trial_cfg in enumerate(trials):
            tname = _trial_name(exp_name, i, trial_cfg)
            tdir = root / exp_name / tname
            tdir.mkdir(parents=True, exist_ok=True)
            if not resume:
                # A fresh run must not restore a previous sweep's state.
                for p in tdir.glob("ckpt_*"):
                    shutil.rmtree(p, ignore_errors=True)
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
            algo = _build_config(spec["run"], trial_cfg).build(device=device)
            resumed_from = None
            if resume:
                ckpt = _latest_checkpoint(tdir)
                if ckpt is not None:
                    algo.load_checkpoint(str(ckpt))
                    resumed_from = algo.iteration
                    _truncate_results(tdir / "result.json", algo.iteration)
            with open(tdir / "params.json", "w") as f:
                json.dump(trial_cfg, f, indent=2, default=str)
            if verbose:
                tag = (f" (resumed @ round {resumed_from})"
                       if resumed_from else "")
                print(f"== trial {tname}: {max_rounds} rounds{tag} ==",
                      flush=True)
            t_start = time.perf_counter()
            start_round = algo.iteration
            ckpt_scores: Dict[str, float] = {}
            failures = 0
            failed_error = None
            last_row: Dict = {}
            while True:
                mode = "a" if (resumed_from or failures) else "w"
                try:
                    pending: List[Dict] = []
                    with open(tdir / "result.json", mode) as f:

                        def emit(rows):
                            nonlocal best_acc, evaluated, last_row
                            for result in rows:
                                result["trial"] = tname
                                f.write(json.dumps(result) + "\n")
                                best_acc = max(best_acc,
                                               result.get("test_acc", 0.0))
                                evaluated |= "test_acc" in result
                                last_row = result
                                if verbose > 1:
                                    print(f"   {tname} round "
                                          f"{result['training_iteration']}:"
                                          f" train_loss "
                                          f"{result['train_loss']:.4f}",
                                          flush=True)

                        def flush_pending():
                            nonlocal pending
                            if pending:
                                emit(flush_rows(pending, algo.finalize_row))
                                pending = []

                        # The stop criterion counts FL rounds; one call
                        # runs rounds_per_dispatch of them.
                        while algo.iteration < max_rounds:
                            pending.append(algo.train_raw())
                            if (len(pending) >= metrics_every
                                    or algo.iteration >= max_rounds):
                                flush_pending()
                            checkpoint_due = bool(
                                checkpoint_freq
                                and algo.iteration % checkpoint_freq == 0)
                            if preempt_hook is not None or checkpoint_due:
                                flush_pending()
                            if preempt_hook is not None:
                                # Between the row write and the checkpoint
                                # save: the restore must come from an older
                                # checkpoint.
                                preempt_hook.check(algo.iteration)
                            if checkpoint_due:
                                # Every round a checkpoint covers is on
                                # disk first.
                                f.flush()
                                os.fsync(f.fileno())
                                name = f"ckpt_{algo.iteration:06d}"
                                atomic_checkpoint(algo.save_checkpoint,
                                                  tdir / name)
                                ckpt_scores[name] = float(last_row.get(
                                    checkpoint_score_attr, algo.iteration))
                                _prune_checkpoints(tdir, checkpoint_keep_num,
                                                   ckpt_scores)
                        flush_pending()
                    break
                except KeyboardInterrupt:
                    raise
                except Exception as exc:
                    failures += 1
                    with open(tdir / "error.txt", "a") as ef:
                        ef.write(f"attempt {failures}: {exc!r}\n")
                        ef.write(traceback.format_exc() + "\n")
                    if failures > max_failures:
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
                    # A fresh build restored from the latest checkpoint.
                    algo.stop()
                    algo = _build_config(spec["run"], trial_cfg).build(
                        device=device)
                    ckpt = _latest_checkpoint(tdir)
                    if ckpt is not None:
                        algo.load_checkpoint(str(ckpt))
                    _truncate_results(tdir / "result.json", algo.iteration)
                    if verbose:
                        print(f"   .. retrying {tname} from round "
                              f"{algo.iteration} (failure {failures}/"
                              f"{max_failures})", flush=True)
            if checkpoint_at_end and failed_error is None:
                atomic_checkpoint(algo.save_checkpoint, tdir / "ckpt_final")
            wall = time.perf_counter() - t_start
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
            # staging peak; the data store's last gather and eval chunks).
            for key, block in (("state_store", algo.state_summary),
                               ("data_store", algo.data_summary)):
                if block:
                    summary[key] = block
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
