"""Host-level fault hardening for the sweep runner (counterpart of
``blades_tpu/faults/host.py``; the port keeps its own copy, since
importing any ``blades_tpu`` module loads JAX).  It covers the host
process around a trial, the Tune-trial analogue of preemptible-VM
reality:

- :func:`atomic_checkpoint`: SIGKILL-safe checkpoint directories (tmp +
  fsync + ``os.replace``).  A kill mid-write leaves either the previous
  complete checkpoint or an orphaned ``.tmp`` the restore path
  skips/deletes — never a torn ``ckpt_<round>`` that
  ``_latest_checkpoint`` would happily restore.
- :func:`retry_backoff`: exponential backoff with deterministic jitter
  between trial restarts, so ``max_failures`` retries stop hammering a
  persistently failing trial at full speed.
- :class:`PreemptionHook`: a test hook that raises
  :class:`SimulatedPreemption` mid-trial, exercising kill-and-resume
  end-to-end without an actual SIGKILL.
- :func:`atomic_write_json`: the file-level analogue of
  :func:`atomic_checkpoint` for single-file artifacts: tmp + fsync + one
  ``os.replace``, so a reader never sees a torn file.
"""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
from pathlib import Path
from typing import Callable


class SimulatedPreemption(RuntimeError):
    """Raised by :class:`PreemptionHook` to simulate the host being
    preempted mid-trial.  Handled like any trial crash: retried from the
    latest checkpoint (``max_failures``) or resumed by a later sweep."""


@dataclasses.dataclass
class PreemptionHook:
    """Raise :class:`SimulatedPreemption` once, the first time the trial's
    round counter reaches ``after_rounds`` (0/None disables).  Fires
    between the result-row write and the checkpoint save — the widest
    window a real preemption lands in — so restore must come from an
    OLDER checkpoint and the no-duplicate/no-gap round-sequence property
    is genuinely exercised."""

    after_rounds: int = 0
    fired: bool = False

    def check(self, iteration: int) -> None:
        if self.after_rounds and not self.fired and iteration >= self.after_rounds:
            self.fired = True
            raise SimulatedPreemption(
                f"simulated preemption at round {iteration} "
                f"(--preempt-after {self.after_rounds})"
            )


def retry_backoff(
    attempt: int, trial_seed, base: float = 0.5, cap: float = 30.0
) -> float:
    """Delay before retry ``attempt`` (1-based): ``min(cap, base * 2^(a-1))``
    scaled by a deterministic jitter in ``[0.5, 1.5)`` seeded from
    ``(trial_seed, attempt)``.

    Deterministic on purpose: a re-run of the same failing sweep produces
    the same retry timeline (reproducible logs), while distinct trials
    restarting after a shared-cause crash still de-synchronize — the
    thundering-herd property randomized jitter exists for, without the
    irreproducibility.
    """
    if attempt < 1:
        raise ValueError(f"attempt is 1-based, got {attempt}")
    delay = min(cap, base * (2 ** (attempt - 1)))
    # str seeding is version-2 (sha512) — stable across processes, unlike
    # hash() of a str under PYTHONHASHSEED randomization.
    jitter = 0.5 + random.Random(f"{trial_seed}:{attempt}").random()
    return delay * jitter


def _fsync_tree(root: Path) -> None:
    """fsync every regular file under ``root``, then every directory —
    the data must be durable BEFORE the rename publishes it."""
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
    for dirpath, _dirnames, _filenames in os.walk(root, topdown=False):
        _fsync_dir(Path(dirpath))


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without O_RDONLY dir opens; rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_json(obj, final_path) -> str:
    """Write ``obj`` as JSON to ``final_path`` atomically (tmp + fsync +
    ``os.replace``).  A SIGKILL at any point leaves either the previous
    complete file (possibly plus an orphaned ``.tmp`` the next write
    overwrites) or the new complete file — never a torn one.  ``NaN`` /
    ``Inf`` floats are serialized in Python's JSON dialect (``NaN``,
    ``Infinity``) on purpose: a record of a NaN aggregate must be able to
    hold it.  Returns the published path."""
    import json

    final_path = Path(final_path)
    final_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = final_path.with_name(final_path.name + ".tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final_path)
    _fsync_dir(final_path.parent)
    return str(final_path)


def atomic_checkpoint(save_fn: Callable[[str], object], final_dir) -> None:
    """Write a checkpoint directory atomically: ``save_fn`` writes into
    ``<final>.tmp``, every byte is fsynced, then one ``os.replace``
    publishes it.

    A SIGKILL at ANY point leaves the trial dir in one of exactly two
    states: the previous complete checkpoint set (possibly plus an
    orphaned ``.tmp`` that restore deletes), or the new complete
    checkpoint.  There is no torn ``ckpt_<round>``.
    """
    final_dir = Path(final_dir)
    tmp = final_dir.with_name(final_dir.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    save_fn(str(tmp))
    _fsync_tree(tmp)
    if final_dir.exists():
        # Re-checkpointing the same round after a resume: drop the old dir
        # first (rename onto a non-empty dir fails on POSIX).  A kill in
        # the gap leaves only the complete .tmp — restore falls back to
        # the previous round's checkpoint, still never a torn one.
        shutil.rmtree(final_dir)
    os.replace(tmp, final_dir)
    _fsync_dir(final_dir.parent)
