"""Client-lifetime ledger: longitudinal per-client telemetry.

Counterpart of ``blades_tpu/obs/ledger.py``, with the same on-disk
checkpoint format (manifest, shard files and CRC32s), so a ledger that
one package writes, the other reads.

Every per-round forensic signal dies at the end of its round — nothing
else tracks *which client* was flagged, how often, or how its behavior
drifts, which is exactly what detection-centric defenses presuppose
when adversaries adapt over time (BLADE-FL's lazy free-riders activate
only when detection relaxes) and exactly what the quarantine-and-probe
controller (:mod:`blades_tpu_torch.control`) needs to act on.  The
:class:`ClientLedger` holds ONE longitudinal record per *registered*
client:

- ``participation`` / ``flagged`` counts and the client's flag status
  at its last participation (``last_flagged`` — the churn baseline);
- a detection-score EWMA (``score_ewma``, alpha = 1/8 so the update is
  exact in binary floating point);
- staleness and update-norm running stats (Welford count/mean/M2, so
  variance is a derived quantity and the update is one vectorized
  pass);
- last-seen round and arrival tick.

Update discipline is the watchdog's: ledger updates run HOST-side on
rows the driver already fetched plus the per-lane diagnosis masks the
forensics pass already emits, re-indexed by the round's cohort
id-vector — **zero extra device syncs**: ``observe()`` takes
already-host data (fetched rows and engine columns), never a tensor on
the card.

Backends mirror the state-store contract
(:mod:`blades_tpu_torch.state.store`):

- ``resident``: plain host numpy columns (the ledger is host-side by
  design, so "resident" means RAM, not HBM);
- ``disk``: one ``.npy`` memmap per column under a trial directory —
  100k+ registered clients cost page cache, not RSS; ``observe()``
  touches only the cohort's rows.

Checkpoints are the store's streaming per-shard files:
``shard-<s>.l<j>.npy`` row-range files written atomically (tmp + fsync
+ ``os.replace``) with per-file size + CRC32 recorded in a
``manifest.json`` published LAST — kill-and-resume restores the ledger
bit-identically, and :func:`validate_ledger_checkpoint` is the
non-raising offline validator.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

LEDGER_BACKENDS = ("resident", "disk")

LEDGER_FORMAT_VERSION = 1

#: Rows per checkpoint shard — the state store's value, so one ledger
#: checkpoint directory reads exactly like a ``client_state/`` one.
DEFAULT_SHARD_ROWS = 4096

#: Detection-score EWMA smoothing.  1/8 is a power of two: the update
#: ``(1-a)*ewma + a*score`` is exact in binary floating point, which
#: keeps kill-and-resume bit-identity trivially true on every platform.
LEDGER_EWMA_ALPHA = 0.125

#: The longitudinal record's columns: ``name -> (dtype, init value)``.
#: Order is the checkpoint leaf order (``shard-<s>.l<j>.npy`` indexes
#: into this tuple), so appending a column bumps the format version.
LEDGER_COLUMNS: Tuple[Tuple[str, Any, Any], ...] = (
    ("participation", np.int64, 0),
    ("flagged", np.int64, 0),
    ("last_flagged", np.uint8, 0),      # flag status at last participation
    ("score_ewma", np.float64, 0.0),
    ("last_round", np.int64, -1),
    ("last_tick", np.int64, -1),
    ("stale_count", np.int64, 0),       # Welford running stats
    ("stale_mean", np.float64, 0.0),
    ("stale_m2", np.float64, 0.0),
    ("norm_count", np.int64, 0),
    ("norm_mean", np.float64, 0.0),
    ("norm_m2", np.float64, 0.0),
)

_COLUMN_NAMES = tuple(name for name, _, _ in LEDGER_COLUMNS)

#: Suspects surfaced per round in the ``ledger_top_suspects`` row field
#: (list-typed — the CSV sink skips it like ``watchdog_events``).
TOP_SUSPECTS_PER_ROUND = 5

#: A seen client whose lifetime flag rate exceeds this is "suspected"
#: (the ``suspected_fraction`` numerator).
SUSPECT_FLAG_RATE = 0.5


class LedgerError(RuntimeError):
    """A ledger update or checkpoint that cannot be trusted: duplicate
    cohort ids, missing manifest, layout drift, or a torn/corrupt
    shard file."""


class ClientLedger:
    """Base class: the longitudinal per-client ledger protocol.

    Subclasses implement the host row primitives ``_take`` / ``_put``
    and full-column reads (``_column``); :meth:`observe` wraps them
    into the one cohort-shaped update per round, and :meth:`save` /
    :meth:`load` stream the registered population through per-shard
    checkpoint files shared by both backends (a checkpoint written
    under one backend restores under the other).
    """

    backend = "abstract"

    def __init__(self, n_registered: int):
        if n_registered < 1:
            raise ValueError(
                f"n_registered must be >= 1, got {n_registered}")
        self.n_registered = int(n_registered)
        self.row_bytes = sum(np.dtype(dt).itemsize
                             for _, dt, _ in LEDGER_COLUMNS)
        # flagged_churn of the LAST observed round: cohort clients whose
        # flag status flipped vs their own previous participation.
        # Recomputed by every observe() from the persistent
        # ``last_flagged`` column, so a resumed trial re-derives the
        # identical value — nothing transient to checkpoint.
        self._last_churn = 0

    # -- backend primitives (host-side rows) ---------------------------------

    def _take(self, ids: np.ndarray) -> List[np.ndarray]:
        raise NotImplementedError

    def _put(self, ids: np.ndarray, arrays: Sequence[np.ndarray]) -> None:
        raise NotImplementedError

    def _column(self, name: str) -> np.ndarray:
        """Read-only view of one full column (fleet statistics)."""
        raise NotImplementedError

    def host_bytes(self) -> int:
        """Bytes of ledger state this backend keeps resident in host
        RAM (0 for ``disk`` — the columns are memmaps; page cache is
        the kernel's, not this process's working set)."""
        return 0

    def total_bytes(self) -> int:
        return self.row_bytes * self.n_registered

    @property
    def num_leaves(self) -> int:
        return len(LEDGER_COLUMNS)

    def close(self) -> None:
        pass

    # -- the one update per round --------------------------------------------

    def observe(self, ids, *, round: int, tick: Optional[int] = None,
                flagged=None, scores=None, staleness=None,
                norms=None) -> None:
        """Fold one round's cohort into the ledger.

        ``ids`` is the round's cohort id-vector (registered client ids,
        one per lane — ``arange(n)`` dense, the sampled window ids
        windowed, the event clients buffered-async).  ``flagged`` /
        ``scores`` are the diagnosis mask/scores in the SAME lane
        order; ``staleness`` / ``norms`` likewise.  All inputs are
        already-host data (fetched rows and engine columns) — this is
        the sanctioned boundary, never a device fetch.
        """
        ids = np.asarray(ids, dtype=np.int64)  # blades-lint: disable=host-sync — sanctioned ledger boundary: cohort ids arrive as already-fetched host data (fetched rows / engine columns), never a card fetch
        if ids.ndim != 1 or not len(ids):
            raise LedgerError(
                f"cohort ids must be a non-empty 1-D vector, got shape "
                f"{ids.shape}")
        if ids.min() < 0 or ids.max() >= self.n_registered:
            raise LedgerError(
                f"cohort ids out of range [0, {self.n_registered}): "
                f"[{ids.min()}, {ids.max()}]")
        if len(np.unique(ids)) != len(ids):
            raise LedgerError(
                "cohort ids contain duplicates — every execution path "
                "samples/buffers distinct clients per round, so a "
                "duplicate means mis-indexed lanes")
        cols = dict(zip(_COLUMN_NAMES, self._take(ids)))
        first = cols["participation"] == 0
        cols["participation"] = cols["participation"] + 1
        cols["last_round"][:] = int(round)
        if tick is not None:
            cols["last_tick"][:] = int(tick)
        churn = 0
        if flagged is not None:
            fl = np.asarray(flagged, dtype=bool)  # blades-lint: disable=host-sync — sanctioned ledger boundary: the diagnosis mask is a slice of the row Fedavg already fetched
            cols["flagged"] = cols["flagged"] + fl
            # Churn vs each client's OWN previous participation (a
            # first-timer's baseline is "not flagged"): cohort-local
            # (O(window), not O(n_registered)) and persistent through
            # the last_flagged column, so kill-and-resume re-derives it.
            churn = int((fl != (cols["last_flagged"] > 0)).sum())  # blades-lint: disable=host-sync — sanctioned ledger boundary: numpy reduction over host columns, no card tensor in sight
            cols["last_flagged"] = fl.astype(np.uint8)
        if scores is not None:
            sc = np.asarray(scores, dtype=np.float64)  # blades-lint: disable=host-sync — sanctioned ledger boundary: diagnosis scores are a slice of the already-fetched row
            a = LEDGER_EWMA_ALPHA
            cols["score_ewma"] = np.where(
                first, sc, (1.0 - a) * cols["score_ewma"] + a * sc)
        if staleness is not None:
            self._welford(cols, "stale", np.asarray(staleness, np.float64))  # blades-lint: disable=host-sync — sanctioned ledger boundary: staleness is the engine's host event column
        if norms is not None:
            self._welford(cols, "norm", np.asarray(norms, np.float64))  # blades-lint: disable=host-sync — sanctioned ledger boundary: per-lane norms are a slice of the already-fetched row
        self._put(ids, [cols[name] for name in _COLUMN_NAMES])
        self._last_churn = churn

    @staticmethod
    def _welford(cols: Dict[str, np.ndarray], prefix: str,
                 x: np.ndarray) -> None:
        """Vectorized one-sample Welford update of the
        ``<prefix>_count/mean/m2`` running stats."""
        cnt = cols[prefix + "_count"] + 1
        delta = x - cols[prefix + "_mean"]
        mean = cols[prefix + "_mean"] + delta / cnt
        cols[prefix + "_count"] = cnt
        cols[prefix + "_mean"] = mean
        cols[prefix + "_m2"] = cols[prefix + "_m2"] + delta * (x - mean)

    # -- fleet views ----------------------------------------------------------

    def round_fields(self) -> Dict[str, Any]:
        """The per-round ledger row fields (schema-registered in
        ``obs/schema.py``), computed over every client seen so far."""
        part = np.asarray(self._column("participation"))  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column read
        seen = part > 0
        n_seen = int(seen.sum())  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column reduction
        rec = {
            "suspected_fraction": 0.0,
            "flagged_churn": int(self._last_churn),
            "reputation_p10": 1.0,
            "reputation_p50": 1.0,
            "reputation_p90": 1.0,
            "ledger_clients_seen": n_seen,
            "ledger_top_suspects": [],
        }
        if not n_seen:
            return rec
        flag_rate = (np.asarray(self._column("flagged"))[seen]  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column read
                     / part[seen].astype(np.float64))
        rec["suspected_fraction"] = float(  # blades-lint: disable=host-sync — sanctioned ledger boundary: numpy reduction over a host column
            (flag_rate > SUSPECT_FLAG_RATE).mean())
        rep = 1.0 - flag_rate
        p10, p50, p90 = np.percentile(rep, [10.0, 50.0, 90.0])
        rec["reputation_p10"] = float(p10)
        rec["reputation_p50"] = float(p50)
        rec["reputation_p90"] = float(p90)
        seen_ids = np.nonzero(seen)[0]
        ew = np.asarray(self._column("score_ewma"))[seen]  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column read
        # Highest flag rate first, score EWMA then id as deterministic
        # tie-breaks (np.lexsort keys are last-is-primary).
        order = np.lexsort((seen_ids, -ew, -flag_rate))
        top = [int(seen_ids[i]) for i in order[:TOP_SUSPECTS_PER_ROUND]
               if flag_rate[i] > 0]
        rec["ledger_top_suspects"] = top
        return rec

    def client_record(self, client_id: int) -> Dict[str, Any]:
        """One client's full longitudinal record plus derived stats."""
        if not 0 <= int(client_id) < self.n_registered:
            raise LedgerError(
                f"client id {client_id} out of range "
                f"[0, {self.n_registered})")
        ids = np.asarray([int(client_id)], np.int64)  # blades-lint: disable=host-sync — sanctioned ledger boundary: wraps a python int, offline query path
        vals = dict(zip(_COLUMN_NAMES, (a[0] for a in self._take(ids))))
        part = int(vals["participation"])
        out = {
            "client": int(client_id),
            "participation": part,
            "flagged": int(vals["flagged"]),
            "flag_rate": (int(vals["flagged"]) / part) if part else 0.0,
            "last_flagged": bool(vals["last_flagged"]),
            "score_ewma": float(vals["score_ewma"]),
            "last_round": int(vals["last_round"]),
            "last_tick": int(vals["last_tick"]),
        }
        for prefix in ("stale", "norm"):
            cnt = int(vals[prefix + "_count"])
            out[prefix + "_count"] = cnt
            out[prefix + "_mean"] = float(vals[prefix + "_mean"])
            out[prefix + "_var"] = (float(vals[prefix + "_m2"]) / cnt
                                    if cnt else 0.0)
        return out

    def top_suspects(self, k: int = 10) -> List[Dict[str, Any]]:
        """The ``k`` seen clients with the highest lifetime flag rate
        (score EWMA then id break ties), as full records."""
        part = np.asarray(self._column("participation"))  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column read, offline query path
        seen_ids = np.nonzero(part > 0)[0]
        if not len(seen_ids):
            return []
        flag_rate = (np.asarray(self._column("flagged"))[seen_ids]  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column read, offline query path
                     / part[seen_ids].astype(np.float64))
        ew = np.asarray(self._column("score_ewma"))[seen_ids]  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column read, offline query path
        order = np.lexsort((seen_ids, -ew, -flag_rate))
        return [self.client_record(int(seen_ids[i]))
                for i in order[:int(k)]]

    def summary(self) -> Dict[str, Any]:
        """The sweep's ``summary["ledger"]`` block."""
        rf = self.round_fields()
        return {
            "backend": self.backend,
            "n_registered": self.n_registered,
            "clients_seen": rf["ledger_clients_seen"],
            "total_flagged": int(np.asarray(self._column("flagged")).sum()),  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column reduction, end-of-trial path
            "suspected_fraction": rf["suspected_fraction"],
            "reputation_p10": rf["reputation_p10"],
            "reputation_p50": rf["reputation_p50"],
            "reputation_p90": rf["reputation_p90"],
            "row_bytes": int(self.row_bytes),
            "total_bytes": int(self.total_bytes()),
        }

    def digest(self) -> Dict[str, Any]:
        """A compact fleet fingerprint for flight-recorder dumps: seen/
        flagged totals plus a CRC32 over every column, computed shard
        by shard (bounded memory at any population size)."""
        crc = 0
        for _, lo, hi in self._shard_ranges(DEFAULT_SHARD_ROWS):
            for arr in self._take(np.arange(lo, hi, dtype=np.int64)):
                crc = zlib.crc32(
                    memoryview(np.ascontiguousarray(arr)).cast("B"), crc)
        part = np.asarray(self._column("participation"))  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column read, dump path
        return {
            "backend": self.backend,
            "n_registered": self.n_registered,
            "clients_seen": int((part > 0).sum()),  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column reduction, dump path
            "participation_total": int(part.sum()),  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column reduction, dump path
            "flagged_total": int(np.asarray(self._column("flagged")).sum()),  # blades-lint: disable=host-sync — sanctioned ledger boundary: host column reduction, dump path
            "crc32": crc & 0xFFFFFFFF,
        }

    # -- streaming shard checkpoints (the state store's contract) ------------

    def _shard_ranges(self, shard_rows: int):
        for s, lo in enumerate(range(0, self.n_registered, shard_rows)):
            yield s, lo, min(lo + shard_rows, self.n_registered)

    def save(self, directory, shard_rows: int = DEFAULT_SHARD_ROWS) -> str:
        """Stream the registered population into per-shard checkpoint
        files under ``directory``: ``shard-<s>.l<j>.npy`` per column
        row-range, written atomically (tmp + fsync + ``os.replace``),
        ``manifest.json`` (sizes + CRC32 per file) published LAST."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for orphan in directory.glob("*.tmp"):
            orphan.unlink()
        files: Dict[str, Dict[str, int]] = {}
        for s, lo, hi in self._shard_ranges(shard_rows):
            arrays = self._take(np.arange(lo, hi, dtype=np.int64))
            for j, arr in enumerate(arrays):
                arr = np.ascontiguousarray(arr)
                name = f"shard-{s:05d}.l{j:02d}.npy"
                path = directory / name
                tmp = directory / (name + ".tmp")
                with open(tmp, "wb") as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                files[name] = {
                    "bytes": path.stat().st_size,
                    "crc32": zlib.crc32(memoryview(arr).cast("B"))
                    & 0xFFFFFFFF,
                }
        from blades_tpu_torch.faults.host import atomic_write_json

        atomic_write_json({
            "version": LEDGER_FORMAT_VERSION,
            "kind": "client_ledger",
            "backend": self.backend,
            "n_registered": self.n_registered,
            "shard_rows": int(shard_rows),
            "num_shards": -(-self.n_registered // shard_rows),
            "leaves": [{"name": name, "dtype": str(np.dtype(dt))}
                       for name, dt, _ in LEDGER_COLUMNS],
            "files": files,
        }, directory / "manifest.json")
        return str(directory)

    def _read_manifest(self, directory: Path) -> Dict[str, Any]:
        mpath = directory / "manifest.json"
        if not mpath.exists():
            raise LedgerError(
                f"ledger checkpoint {directory} has no manifest.json "
                "(torn checkpoint write — restore from an older one)")
        try:
            manifest = json.loads(mpath.read_text())
        except Exception as exc:
            raise LedgerError(
                f"ledger manifest {mpath} is unreadable: {exc}")
        if manifest.get("version") != LEDGER_FORMAT_VERSION:
            raise LedgerError(
                f"ledger checkpoint {directory} has format version "
                f"{manifest.get('version')!r}; this build reads "
                f"{LEDGER_FORMAT_VERSION}")
        if int(manifest["n_registered"]) != self.n_registered:
            raise LedgerError(
                f"ledger checkpoint covers {manifest['n_registered']} "
                f"registered clients, this federation has "
                f"{self.n_registered}")
        saved = [(l["name"], str(np.dtype(l["dtype"])))
                 for l in manifest["leaves"]]
        ours = [(name, str(np.dtype(dt))) for name, dt, _ in LEDGER_COLUMNS]
        if saved != ours:
            raise LedgerError(
                "ledger checkpoint column layout does not match this "
                f"build: saved {saved}, expected {ours}")
        return manifest

    def load(self, directory) -> None:
        """Restore the population from a shard checkpoint written by
        :meth:`save` (either backend's).  Orphaned ``.tmp`` files are
        deleted; a missing, truncated or corrupt shard raises
        :class:`LedgerError` naming the file."""
        directory = Path(directory)
        manifest = self._read_manifest(directory)
        for orphan in directory.glob("*.tmp"):
            orphan.unlink()
        shard_rows = int(manifest["shard_rows"])
        files = manifest["files"]
        dtypes = [np.dtype(dt) for _, dt, _ in LEDGER_COLUMNS]
        for s, lo, hi in self._shard_ranges(shard_rows):
            arrays = []
            for j in range(self.num_leaves):
                name = f"shard-{s:05d}.l{j:02d}.npy"
                path = directory / name
                rec = files.get(name)
                if rec is None or not path.exists():
                    raise LedgerError(
                        f"ledger checkpoint {directory} is missing shard "
                        f"file {name}")
                if path.stat().st_size != int(rec["bytes"]):
                    raise LedgerError(
                        f"ledger shard {name} is torn: "
                        f"{path.stat().st_size} bytes on disk, manifest "
                        f"recorded {rec['bytes']}")
                arr = np.load(path, allow_pickle=False)
                if arr.shape != (hi - lo,) or arr.dtype != dtypes[j]:
                    raise LedgerError(
                        f"ledger shard {name} has shape "
                        f"{arr.shape}/{arr.dtype}, expected "
                        f"{(hi - lo,)}/{dtypes[j]}")
                crc = zlib.crc32(
                    memoryview(np.ascontiguousarray(arr)).cast("B"))
                if (crc & 0xFFFFFFFF) != int(rec["crc32"]):
                    raise LedgerError(
                        f"ledger shard {name} fails its CRC32 check "
                        "(corrupt shard — restore from an older "
                        "checkpoint)")
                arrays.append(arr)
            self._put(np.arange(lo, hi, dtype=np.int64), arrays)


class ResidentLedger(ClientLedger):
    """Host-RAM backend: plain numpy columns.  ~100 bytes per
    registered client, so this is the default at any federation the
    dense paths can run."""

    backend = "resident"

    def __init__(self, n_registered: int):
        super().__init__(n_registered)
        self._arrays = {
            name: np.full(n_registered, init, dtype=dt)
            for name, dt, init in LEDGER_COLUMNS
        }

    def _take(self, ids: np.ndarray) -> List[np.ndarray]:
        return [np.ascontiguousarray(self._arrays[name][ids])
                for name in _COLUMN_NAMES]

    def _put(self, ids: np.ndarray, arrays: Sequence[np.ndarray]) -> None:
        for name, rows in zip(_COLUMN_NAMES, arrays):
            self._arrays[name][ids] = rows

    def _column(self, name: str) -> np.ndarray:
        return self._arrays[name]

    def host_bytes(self) -> int:
        return sum(a.nbytes for a in self._arrays.values())


class DiskLedger(ClientLedger):
    """Disk backend: one ``.npy`` memmap per column (``live.l<j>.npy``)
    under a trial directory.  A 100k+ registered population costs open
    file handles and page cache, not RSS; ``observe()`` touches only
    the cohort's pages and fleet statistics stream through the kernel's
    cache."""

    backend = "disk"

    def __init__(self, n_registered: int,
                 directory: Optional[str] = None):
        super().__init__(n_registered)
        self._owns_dir = directory is None
        self._dir = Path(directory or tempfile.mkdtemp(
            prefix="blades_ledger_"))
        self._dir.mkdir(parents=True, exist_ok=True)
        self._maps: Dict[str, np.memmap] = {}
        for j, (name, dt, init) in enumerate(LEDGER_COLUMNS):
            mm = np.lib.format.open_memmap(
                self._dir / f"live.l{j:02d}.npy", mode="w+",
                dtype=np.dtype(dt), shape=(n_registered,))
            mm[:] = init
            self._maps[name] = mm

    def _take(self, ids: np.ndarray) -> List[np.ndarray]:
        return [np.ascontiguousarray(self._maps[name][ids])
                for name in _COLUMN_NAMES]

    def _put(self, ids: np.ndarray, arrays: Sequence[np.ndarray]) -> None:
        for name, rows in zip(_COLUMN_NAMES, arrays):
            self._maps[name][ids] = rows

    def _column(self, name: str) -> np.ndarray:
        return self._maps[name]

    def close(self) -> None:
        self._maps = {}  # drops the memmap refs (CPython closes them)
        if self._owns_dir:
            shutil.rmtree(self._dir, ignore_errors=True)


def make_ledger(backend: str, n_registered: int, *,
                directory: Optional[str] = None) -> ClientLedger:
    """Build a :class:`ClientLedger` by backend name.  ``directory``
    applies to ``disk`` only (``None`` = a private temp dir removed on
    :meth:`~ClientLedger.close`)."""
    if backend == "resident":
        return ResidentLedger(n_registered)
    if backend == "disk":
        return DiskLedger(n_registered, directory=directory)
    raise ValueError(
        f"ledger backend must be one of {LEDGER_BACKENDS}, got "
        f"{backend!r}")


def read_ledger(directory) -> ClientLedger:
    """Materialise a ledger checkpoint as a :class:`ResidentLedger`
    (the offline read path): the manifest names the
    population size, the shard restore validates sizes/CRCs exactly
    like :meth:`ClientLedger.load`."""
    directory = Path(directory)
    mpath = directory / "manifest.json"
    if not mpath.exists():
        raise LedgerError(
            f"ledger checkpoint {directory} has no manifest.json")
    try:
        manifest = json.loads(mpath.read_text())
    except Exception as exc:
        raise LedgerError(f"ledger manifest {mpath} is unreadable: {exc}")
    try:
        n = int(manifest["n_registered"])
    except (KeyError, TypeError, ValueError):
        raise LedgerError(
            f"ledger manifest {mpath} has no integer n_registered")
    ledger = ResidentLedger(n)
    ledger.load(directory)
    return ledger


# ---------------------------------------------------------------------------
# offline validation
# ---------------------------------------------------------------------------


def validate_ledger_checkpoint(directory) -> Tuple[int, List[str]]:
    """Walk a ledger checkpoint directory WITHOUT raising: returns
    ``(num_ok_files, errors)``.  Matches the metrics.jsonl torn-write
    contract — a missing manifest, a torn shard (size mismatch), a
    CRC failure or layout drift are REPORTED errors, never exceptions;
    orphaned ``*.tmp`` siblings are the caller's note (the published
    files next to them are still the newest complete artifact)."""
    directory = Path(directory)
    errors: List[str] = []
    mpath = directory / "manifest.json"
    if not mpath.exists():
        return 0, ["no manifest.json (torn checkpoint write — the "
                   "shard set was never published)"]
    try:
        manifest = json.loads(mpath.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        return 0, [f"unreadable manifest.json: {exc}"]
    if not isinstance(manifest, dict):
        return 0, ["manifest.json must be a JSON object"]
    if manifest.get("version") != LEDGER_FORMAT_VERSION:
        errors.append(f"unknown format version "
                      f"{manifest.get('version')!r} (expected "
                      f"{LEDGER_FORMAT_VERSION})")
    n = manifest.get("n_registered")
    if not isinstance(n, int) or n < 1:
        errors.append(f"n_registered must be a positive int, got {n!r}")
        return 0, errors
    saved = [(l.get("name"), l.get("dtype"))
             for l in manifest.get("leaves", [])
             if isinstance(l, dict)]
    ours = [(name, str(np.dtype(dt))) for name, dt, _ in LEDGER_COLUMNS]
    if saved != ours:
        errors.append(
            f"column layout drift: manifest records {saved}, this build "
            f"reads {ours}")
    shard_rows = manifest.get("shard_rows")
    if not isinstance(shard_rows, int) or shard_rows < 1:
        errors.append(
            f"shard_rows must be a positive int, got {shard_rows!r}")
        return 0, errors
    files = manifest.get("files")
    if not isinstance(files, dict):
        return 0, errors + ["files must be an object"]
    num_ok = 0
    num_shards = -(-n // shard_rows)
    for s in range(num_shards):
        lo = s * shard_rows
        hi = min(lo + shard_rows, n)
        for j, (_, dt, _) in enumerate(LEDGER_COLUMNS):
            name = f"shard-{s:05d}.l{j:02d}.npy"
            path = directory / name
            rec = files.get(name)
            if rec is None:
                errors.append(f"{name}: not recorded in the manifest")
                continue
            if not path.exists():
                errors.append(f"{name}: missing shard file")
                continue
            if path.stat().st_size != int(rec.get("bytes", -1)):
                errors.append(
                    f"{name}: torn shard ({path.stat().st_size} bytes "
                    f"on disk, manifest recorded {rec.get('bytes')})")
                continue
            try:
                arr = np.load(path, allow_pickle=False)
            except Exception as exc:
                errors.append(f"{name}: unreadable ({exc})")
                continue
            if arr.shape != (hi - lo,) or arr.dtype != np.dtype(dt):
                errors.append(
                    f"{name}: shape/dtype drift ({arr.shape}/{arr.dtype},"
                    f" expected {(hi - lo,)}/{np.dtype(dt)})")
                continue
            crc = zlib.crc32(
                memoryview(np.ascontiguousarray(arr)).cast("B"))
            if (crc & 0xFFFFFFFF) != int(rec.get("crc32", -1)):
                errors.append(f"{name}: CRC32 mismatch (corrupt shard)")
                continue
            num_ok += 1
    extra = sorted(set(files) - {
        f"shard-{s:05d}.l{j:02d}.npy"
        for s in range(num_shards) for j in range(len(LEDGER_COLUMNS))})
    for name in extra:
        errors.append(f"{name}: recorded in the manifest but not part "
                      "of the shard layout")
    return num_ok, errors
