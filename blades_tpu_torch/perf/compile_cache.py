"""The kernel build cache and the program fingerprint (counterpart of
``blades_tpu/perf/compile_cache.py``, reduced to what the card has).

The JAX package compiles each round program ahead of time and shares the
executable across sweep trials; the port has no ahead-of-time compile.
Its one compile is the hand-written kernels' ``nvcc`` build
(:func:`blades_tpu_torch.ops._cuda.build`): every ``csrc/*.cu`` into one
library named by a hash over the sources, under ``build/`` at the
checkout root, or under the directory :func:`set_cache_dir` names (the
CLI's ``--compile-cache DIR``, or ``$BLADES_TPU_TORCH_COMPILE_CACHE_DIR``).
Finding that library is a **hit**, running ``nvcc`` is a **miss**;
:func:`cache_stats` returns the process's counts, which the dense and
windowed rounds' rows carry as ``compile_cache_hits`` /
``compile_cache_misses`` and sweep summaries as a per-trial
``compile_cache`` delta.  A process loads the library once, so its later
trials count nothing.

:func:`fingerprint` digests a JSON-able static config; the driver's
program fingerprint (config fields that steer the program, without
``seed`` and the autotune fields) keys the plan cache.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

ENV_CACHE_DIR = "BLADES_TPU_TORCH_COMPILE_CACHE_DIR"

_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0}
_cache_dir: Optional[Path] = None


def fingerprint(static_config: Any) -> str:
    """Stable digest of a JSON-able static-config object (dicts, lists,
    scalars; unknown types stringify)."""
    blob = json.dumps(static_config, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def set_cache_dir(cache_dir=None) -> Optional[str]:
    """Point the kernel build at ``cache_dir`` (or
    ``$BLADES_TPU_TORCH_COMPILE_CACHE_DIR``; ``None`` and neither set keeps
    the default ``build/``).  Returns the directory in effect, or ``None``
    for the default.  A library already loaded in this process stays
    loaded."""
    global _cache_dir
    cache_dir = cache_dir or os.environ.get(ENV_CACHE_DIR)
    if cache_dir:
        _cache_dir = Path(cache_dir).expanduser().resolve()
    return None if _cache_dir is None else str(_cache_dir)


def cache_dir(default: Path) -> Path:
    """The kernel build directory: :func:`set_cache_dir`'s, else
    ``$BLADES_TPU_TORCH_COMPILE_CACHE_DIR``, else ``default``."""
    if _cache_dir is None and os.environ.get(ENV_CACHE_DIR):
        set_cache_dir()
    return _cache_dir if _cache_dir is not None else default


def record(hit: bool) -> None:
    """Count one kernel-library lookup: found (hit) or built (miss)."""
    with _lock:
        _stats["hits" if hit else "misses"] += 1


def cache_stats() -> Dict[str, int]:
    """The process's kernel build counts: ``{"hits": n, "misses": n}``."""
    with _lock:
        return dict(_stats)


def clear_cache() -> None:
    """Reset the counters (tests)."""
    with _lock:
        _stats.update(hits=0, misses=0)
