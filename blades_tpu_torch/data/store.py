"""Out-of-core training data: the cohort-gather client data store
(counterpart of ``blades_tpu/data/store.py``).

The state store's data-plane sibling: only the sampled cohort's training
shards are assembled on the host and copied to the card; the registered
population lives behind a :class:`DataStore`:

- ``resident``: the dataset's host arrays, ``take`` a fancy index;
- ``memmap``: sharded memory-mapped ``.npy`` files under a directory, so
  a large population costs page cache, not resident memory.

The two move rows without arithmetic, so they are bit-identical.  The
shard files follow the state store's discipline (``shard-<s>.l<j>.npy``
written atomically, sizes and CRC32 in ``manifest.json``, published
last), in the JAX package's format.  Training data is immutable and
derived from the dataset, so a shard set is a cache: a torn, corrupt or
incomplete set found at open time is rebuilt from the source, and a
verified set under a named ``data_dir`` is reused (the resume path).
:func:`validate_datastore_dir` is the strict walk that names what is
wrong with a directory.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blades_tpu_torch.faults.host import atomic_write_json
from blades_tpu_torch.state.store import by_shard

DATA_STORE_BACKENDS = ("resident", "memmap")

#: Client rows per shard file.
DEFAULT_DATA_SHARD_ROWS = 4096

DATA_STORE_FORMAT_VERSION = 1

#: Leaf order of one client's training row.
DATA_LEAF_NAMES = ("x", "y", "lengths")


class DataStoreError(RuntimeError):
    """A shard directory that cannot be served faithfully."""


class DataStore:
    """The cohort-gather protocol over three stacked leaves -- ``x (n,
    max_shard, *feat)``, ``y (n, max_shard)``, ``lengths (n,)``: :meth:`take`
    assembles host rows for a cohort, :meth:`gather` puts them on the
    card.  Rows never change, so there is no write-back."""

    backend = "abstract"

    def __init__(self, n_clients: int, shapes: Sequence[tuple],
                 dtypes: Sequence[np.dtype], *, pin: bool = False):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        if len(shapes) != len(DATA_LEAF_NAMES):
            raise ValueError(
                f"a data row has {len(DATA_LEAF_NAMES)} leaves "
                f"{DATA_LEAF_NAMES}, got {len(shapes)}")
        self.n_clients = int(n_clients)
        self._shapes = [tuple(sh) for sh in shapes]
        self._dtypes = [np.dtype(dt) for dt in dtypes]
        self.row_bytes = sum(math.prod(sh) * dt.itemsize
                             for sh, dt in zip(self._shapes, self._dtypes))
        self.pin = bool(pin)

    def _fill(self, ids: np.ndarray, out: Sequence[np.ndarray]) -> None:
        """Write the rows of ``ids`` (any order) into ``out``."""
        raise NotImplementedError

    def take(self, ids: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Host rows ``(x, y, lengths)`` of ``ids`` (any order)."""
        ids = np.asarray(ids, np.int64)  # blades-lint: disable=host-sync — cohort ids are host ints: numpy over host data, no card read
        out = tuple(np.empty((len(ids),) + sh, dt)
                    for sh, dt in zip(self._shapes, self._dtypes))
        self._fill(ids, out)
        return out

    def gather(self, ids: np.ndarray, device=None
               ) -> Tuple[torch.Tensor, ...]:
        """The :meth:`take` rows on ``device``: assembled in host buffers
        (pinned when the store serves the card) and copied
        ``non_blocking`` on the current stream."""
        ids = np.asarray(ids, np.int64)  # blades-lint: disable=host-sync — cohort ids are host ints: numpy over host data, no card read
        bufs = [torch.empty((len(ids),) + sh, pin_memory=self.pin,
                            dtype=torch.from_numpy(np.empty(0, dt)).dtype)
                for sh, dt in zip(self._shapes, self._dtypes)]
        self._fill(ids, [b.numpy() for b in bufs])  # blades-lint: disable=host-sync — numpy views of the host staging buffers, no card read
        return tuple(b.to(device, non_blocking=self.pin) for b in bufs)

    def total_bytes(self) -> int:
        return self.row_bytes * self.n_clients

    @property
    def num_leaves(self) -> int:
        return len(self._shapes)

    def close(self) -> None:
        pass


def _check_leaves(arrays) -> int:
    x, y, lengths = arrays
    n = int(np.shape(x)[0])
    if int(np.shape(y)[0]) != n or int(np.shape(lengths)[0]) != n:
        raise ValueError(
            "data leaves disagree on the client axis: "
            f"x={np.shape(x)[0]}, y={np.shape(y)[0]}, "
            f"lengths={np.shape(lengths)[0]}")
    return n


class ResidentDataStore(DataStore):
    """The dataset's host arrays behind the store protocol."""

    backend = "resident"

    def __init__(self, arrays: Sequence[np.ndarray], *, pin: bool = False):
        n = _check_leaves(arrays)
        super().__init__(n, [tuple(np.shape(a)[1:]) for a in arrays],
                         [np.dtype(a.dtype) for a in arrays], pin=pin)
        self._arrays = tuple(arrays)

    def _fill(self, ids, out):
        for a, o in zip(self._arrays, out):
            np.take(a, ids, axis=0, out=o)


class MemmapDataStore(DataStore):
    """Sharded memory-mapped training shards under ``directory``
    (``shard-<s>.l<j>.npy``, opened read-only).  Construction streams the
    source to disk one shard at a time unless ``directory`` already holds
    a manifest whose layout, sizes and CRC32s all verify; any mismatch
    rebuilds from the source."""

    backend = "memmap"

    def __init__(self, arrays: Sequence[np.ndarray],
                 directory: Optional[str] = None,
                 shard_rows: int = DEFAULT_DATA_SHARD_ROWS, *,
                 pin: bool = False):
        n = _check_leaves(arrays)
        super().__init__(n, [tuple(np.shape(a)[1:]) for a in arrays],
                         [np.dtype(a.dtype) for a in arrays], pin=pin)
        self._owns_dir = directory is None
        self._dir = Path(directory or tempfile.mkdtemp(prefix="blades_data_"))
        self._dir.mkdir(parents=True, exist_ok=True)
        self.shard_rows = int(shard_rows)
        self.rebuilt = not self._shards_verify()
        if self.rebuilt:
            self._write_shards(arrays)
        self._maps: Dict[Tuple[int, int], np.memmap] = {}
        for s, _, _ in self._shard_ranges():
            for j in range(self.num_leaves):
                self._maps[(s, j)] = np.lib.format.open_memmap(
                    self._dir / f"shard-{s:05d}.l{j:02d}.npy", mode="r")

    @property
    def directory(self) -> str:
        return str(self._dir)

    def _shard_ranges(self):
        for s, lo in enumerate(range(0, self.n_clients, self.shard_rows)):
            yield s, lo, min(lo + self.shard_rows, self.n_clients)

    def _shards_verify(self) -> bool:
        """Whether ``directory`` holds a complete shard set of this
        population's layout, every file passing size and CRC32."""
        mpath = self._dir / "manifest.json"
        if not mpath.exists():
            return False
        try:
            manifest = json.loads(mpath.read_text())
        except Exception:
            return False
        if (manifest.get("version") != DATA_STORE_FORMAT_VERSION
                or int(manifest.get("n_clients", -1)) != self.n_clients
                or int(manifest.get("shard_rows", -1)) != self.shard_rows):
            return False
        saved = [(tuple(leaf["shape"]), str(leaf["dtype"]))
                 for leaf in manifest.get("leaves", [])]
        if saved != [(sh, str(dt))
                     for sh, dt in zip(self._shapes, self._dtypes)]:
            return False
        files = manifest.get("files", {})
        for s, _, _ in self._shard_ranges():
            for j in range(self.num_leaves):
                if f"shard-{s:05d}.l{j:02d}.npy" not in files:
                    return False
        for name, rec in files.items():
            path = self._dir / name
            if not path.exists() or path.stat().st_size != int(rec["bytes"]):
                return False
            try:
                arr = np.load(path, allow_pickle=False, mmap_mode="r")
            except Exception:
                return False
            crc = zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))
            if (crc & 0xFFFFFFFF) != int(rec["crc32"]):
                return False
        return True

    def _write_shards(self, arrays: Sequence[np.ndarray]) -> None:
        """Stream the population to per-shard files (tmp + fsync +
        ``os.replace`` each), ``manifest.json`` last."""
        for orphan in self._dir.glob("*.tmp"):
            orphan.unlink()
        stale = self._dir / "manifest.json"
        if stale.exists():
            stale.unlink()
        files: Dict[str, Dict[str, int]] = {}
        for s, lo, hi in self._shard_ranges():
            for j, src in enumerate(arrays):
                block = np.ascontiguousarray(src[lo:hi])
                name = f"shard-{s:05d}.l{j:02d}.npy"
                path = self._dir / name
                tmp = self._dir / (name + ".tmp")
                with open(tmp, "wb") as f:
                    np.lib.format.write_array(f, block, allow_pickle=False)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                files[name] = {
                    "bytes": path.stat().st_size,
                    "crc32": zlib.crc32(memoryview(block).cast("B"))
                    & 0xFFFFFFFF,
                }
        atomic_write_json({
            "version": DATA_STORE_FORMAT_VERSION,
            "backend": self.backend,
            "n_clients": self.n_clients,
            "shard_rows": self.shard_rows,
            "num_shards": -(-self.n_clients // self.shard_rows),
            "leaves": [{"shape": list(sh), "dtype": str(dt)}
                       for sh, dt in zip(self._shapes, self._dtypes)],
            "files": files,
        }, self._dir / "manifest.json")

    def _fill(self, ids, out):
        if len(ids):
            for s, pos, local in by_shard(ids, self.shard_rows):
                for j in range(self.num_leaves):
                    out[j][pos] = self._maps[(s, j)][local]

    def close(self) -> None:
        self._maps = {}
        if self._owns_dir:
            shutil.rmtree(self._dir, ignore_errors=True)


class DataStats:
    """Staging telemetry the driver stamps into rows (``data_stage_ms``,
    ``data_bytes_staged``)."""

    def __init__(self):
        self.last_stage_ms = 0.0
        self.last_bytes_staged = 0

    def observe(self, stage_seconds: float, bytes_staged: int) -> None:
        self.last_stage_ms = stage_seconds * 1e3
        self.last_bytes_staged = int(bytes_staged)


def make_data_store(backend: str, arrays: Sequence[np.ndarray], *,
                    directory: Optional[str] = None,
                    shard_rows: int = DEFAULT_DATA_SHARD_ROWS,
                    device=None) -> DataStore:
    """A :class:`DataStore` by backend name over the ``(x, y, lengths)``
    partition; ``directory`` applies to ``memmap`` (None = a private
    temporary directory removed on close)."""
    pin = device is not None and torch.device(device).type == "cuda"
    if backend == "resident":
        return ResidentDataStore(arrays, pin=pin)
    if backend == "memmap":
        return MemmapDataStore(arrays, directory=directory,
                               shard_rows=shard_rows, pin=pin)
    raise ValueError(
        f"data_store must be one of {DATA_STORE_BACKENDS}, got {backend!r}")


def validate_datastore_dir(directory) -> Tuple[int, List[str]]:
    """The strict walk over one shard directory: the manifest and every
    recorded file (existence, size, shape and dtype, CRC32), plus
    orphaned ``*.tmp`` and unmanifested ``shard-*.npy`` files.  Returns
    ``(files checked, errors)``; no errors means it restores faithfully."""
    directory = Path(directory)
    errors: List[str] = []
    checked = 0
    mpath = directory / "manifest.json"
    if not mpath.exists():
        return 0, [f"{directory}: no manifest.json (torn shard-set write "
                   "-- the store will rebuild from source)"]
    try:
        manifest = json.loads(mpath.read_text())
    except Exception as exc:
        return 0, [f"{mpath}: unreadable manifest: {exc}"]
    if manifest.get("version") != DATA_STORE_FORMAT_VERSION:
        return 0, [f"{mpath}: format version {manifest.get('version')!r}; "
                   f"this build reads {DATA_STORE_FORMAT_VERSION}"]
    leaves = manifest.get("leaves", [])
    files = manifest.get("files", {})
    n_clients = int(manifest.get("n_clients", 0))
    shard_rows = int(manifest.get("shard_rows", 1))
    for name, rec in sorted(files.items()):
        checked += 1
        path = directory / name
        if not path.exists():
            errors.append(f"{name}: missing shard file")
            continue
        if path.stat().st_size != int(rec["bytes"]):
            errors.append(
                f"{name}: torn shard -- {path.stat().st_size} bytes on "
                f"disk, manifest recorded {rec['bytes']}")
            continue
        try:
            arr = np.load(path, allow_pickle=False, mmap_mode="r")
        except Exception as exc:
            errors.append(f"{name}: unreadable shard: {exc}")
            continue
        s, j = int(name[6:11]), int(name[13:15])
        lo = s * shard_rows
        expect = ((min(lo + shard_rows, n_clients) - lo,)
                  + tuple(leaves[j]["shape"]))
        if arr.shape != expect or arr.dtype != np.dtype(leaves[j]["dtype"]):
            errors.append(
                f"{name}: shape {arr.shape}/{arr.dtype}, manifest "
                f"expects {expect}/{leaves[j]['dtype']}")
            continue
        crc = zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))
        if (crc & 0xFFFFFFFF) != int(rec["crc32"]):
            errors.append(f"{name}: fails its CRC32 check (corrupt shard)")
    for orphan in sorted(directory.glob("*.tmp")):
        errors.append(f"{orphan.name}: orphaned atomic-write temp file "
                      "(interrupted shard write)")
    for stray in sorted(directory.glob("shard-*.npy")):
        if stray.name not in files:
            errors.append(f"{stray.name}: orphaned shard not in manifest")
    return checked, errors
