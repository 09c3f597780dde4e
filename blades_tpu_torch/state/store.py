"""Out-of-core per-client state: the participation-window client store
(counterpart of ``blades_tpu/state/store.py``).

Only the sampled cohort's state rows are ever on the card: ``window``
rows a round, sampled by :func:`sample_cohort`; the registered
population lives behind a :class:`ClientStateStore`:

- ``resident``: the dense ``(n, ...)`` stack on the card, gather and
  scatter as device index ops (the reference the others are held to);
- ``host``: the stack in pinned host memory, so a gather is an index
  into a pinned staging buffer and one ``non_blocking`` host-to-device
  copy, a scatter the reverse;
- ``disk``: sharded memory-mapped ``.npy`` files under a directory.

The backends move rows without arithmetic, so they are bit-identical.
One client's row is the template of :func:`client_state_template`: its
optimizer state (the momentum trace) as one flat ``(d,)`` f32 leaf in
the reference's flat order, then the codec's ``(d,)`` error-feedback
residual, each only when the run has one.

Checkpoints stream per shard (:meth:`ClientStateStore.save`): each
``shard-<s>.l<j>.npy`` covers one leaf's row range and is written
atomically (tmp + fsync + ``os.replace``); ``manifest.json`` (sizes and
CRC32 of every file) is published last, so a kill leaves either no
manifest or a fully verified shard set.  :meth:`ClientStateStore.load`
deletes orphaned ``.tmp`` files and raises :class:`StateStoreError` on a
missing, torn or corrupt shard.  The format is the JAX package's (the
same manifest, names and ``.npy`` files); its leaves split the
optimizer state per parameter where the port keeps one flat leaf, and
:func:`blades_tpu_torch.convert.store_from_jax_checkpoint` joins them.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blades_tpu_torch.faults.host import atomic_write_json
from blades_tpu_torch.utils.seeds import seed_of
from blades_tpu_torch.utils.tree import FlatLayout

STORE_BACKENDS = ("resident", "host", "disk")

#: Salt of the cohort-sampling stream (drawn from the round's seed).
COHORT_KEY_FOLD = 0x5707

#: Rows per checkpoint shard (and per live disk-store shard).
DEFAULT_SHARD_ROWS = 4096

STORE_FORMAT_VERSION = 1


class StateStoreError(RuntimeError):
    """A store checkpoint that cannot be restored faithfully: missing
    manifest, layout drift, or a torn or corrupt shard file."""


def cohort_seed(round_seed: int) -> int:
    """The cohort-sampling seed of one round."""
    return seed_of(round_seed, COHORT_KEY_FOLD)


def sample_cohort(round_seed: int, n_registered: int,
                  window: int) -> np.ndarray:
    """The participation window of one round: ``window`` distinct
    registered ids, a prefix of a permutation drawn from a CPU generator
    seeded from the round's seed, sorted ascending (sequential disk reads,
    and overlap with the previous cohort is a merge).  The JAX package's
    ids come from its own PRNG; the prefetcher takes a cohort function,
    which is how tests hand them in."""
    if not 1 <= window <= n_registered:
        raise ValueError(
            f"window must be in [1, n_registered={n_registered}], "
            f"got {window}")
    gen = torch.Generator().manual_seed(cohort_seed(round_seed))
    ids = torch.randperm(n_registered, generator=gen)[:window].numpy()  # blades-lint: disable=host-sync — the cohort draw is a CPU generator's: no card read
    return np.sort(ids).astype(np.int32)


def client_state_template(fed_round, params) -> Dict[str, torch.Tensor]:
    """One client's persistent row for ``fed_round``: ``client_opt`` (the
    momentum trace, flat ``(d,)`` f32) under client momentum, and
    ``residual`` (the codec's row) under error feedback."""
    d = FlatLayout(params).d
    template: Dict[str, torch.Tensor] = {}
    if fed_round.task.spec.momentum:
        template["client_opt"] = torch.zeros((d,), dtype=torch.float32)
    codec = getattr(fed_round, "codec", None)
    if codec is not None and codec.needs_residual:
        template["residual"] = codec.init_residual_row(d)
    return template


def by_shard(ids: np.ndarray, shard_rows: int):
    """Group ``ids`` (any order) by ``shard_rows``-row shard: yields
    ``(shard, positions in ids, rows within the shard)``."""
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    shard = sorted_ids // shard_rows
    first, last = int(shard[0]), int(shard[-1])
    bounds = np.searchsorted(shard, np.arange(first, last + 2))
    for s in range(first, last + 1):
        lo, hi = int(bounds[s - first]), int(bounds[s - first + 1])
        if lo < hi:
            yield s, order[lo:hi], sorted_ids[lo:hi] - s * shard_rows


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return np.dtype(torch.empty((), dtype=dt).numpy().dtype)  # blades-lint: disable=host-sync — dtype probe on a CPU scalar at setup


class ClientStateStore:
    """The participation-window store protocol: the rows of
    ``n_registered`` clients, one ``template`` (a ``{name: tensor}`` dict
    describing one client) each, leaves in sorted name order.  Backends
    implement the host-side row primitives ``_take`` / ``_put``;
    :meth:`gather` / :meth:`scatter` move rows to and from the card, and
    :meth:`save` / :meth:`load` stream shard checkpoints that restore
    under any backend."""

    backend = "abstract"

    def __init__(self, n_registered: int, template: Dict[str, torch.Tensor],
                 *, pin: bool = False):
        if n_registered < 1:
            raise ValueError(f"n_registered must be >= 1, got {n_registered}")
        self.n_registered = int(n_registered)
        self.names = sorted(template)
        self._template = [template[k].detach().cpu() for k in self.names]  # blades-lint: disable=host-sync — store INIT only: the one-row template is fetched once to seed the host population, never per round
        self._shapes = [tuple(t.shape) for t in self._template]
        self._dtypes = [t.dtype for t in self._template]
        self.row_bytes = sum(t.numel() * t.element_size()
                             for t in self._template)
        self.pin = bool(pin)

    # -- backend primitives (host rows) --------------------------------------

    def _take(self, ids: np.ndarray) -> List[torch.Tensor]:
        raise NotImplementedError

    def _put(self, ids: np.ndarray, arrays: Sequence[torch.Tensor]) -> None:
        raise NotImplementedError

    def _staging(self, rows: int) -> List[torch.Tensor]:
        """Host buffers for ``rows`` rows of every leaf, pinned when the
        store serves the card."""
        return [torch.empty((rows,) + sh, dtype=dt, pin_memory=self.pin)
                for sh, dt in zip(self._shapes, self._dtypes)]

    # -- staging API ---------------------------------------------------------

    def gather(self, ids: np.ndarray, device=None) -> Dict[str, torch.Tensor]:
        """The rows of ``ids`` on ``device``, ``{name: (len(ids), ...)}``
        (host copies are ``non_blocking`` from pinned buffers on the
        current stream)."""
        host = self._take(np.asarray(ids, np.int64))  # blades-lint: disable=host-sync — sanctioned staging boundary: cohort ids are host ints indexing the out-of-core store
        return {k: t.to(device, non_blocking=self.pin) if device is not None
                else t for k, t in zip(self.names, host)}

    def scatter(self, ids: np.ndarray, rows: Dict[str, torch.Tensor]) -> None:
        """Write rows back for ``ids`` (device rows are copied to the
        host on the current stream, which is synchronized first)."""
        host = []
        for k in self.names:
            r = rows[k]
            if r.is_cuda:
                buf = torch.empty(r.shape, dtype=r.dtype,
                                  pin_memory=self.pin)
                buf.copy_(r, non_blocking=self.pin)
                host.append(buf)
            else:
                host.append(r)
        if any(rows[k].is_cuda for k in self.names):
            torch.cuda.current_stream().synchronize()  # blades-lint: disable=host-sync — sanctioned staging boundary: the cohort write-back must land in the host buffers before they are stored; in the prefetcher worker when staging is async
        self._put(np.asarray(ids, np.int64), host)  # blades-lint: disable=host-sync — sanctioned staging boundary: cohort ids are host ints indexing the out-of-core store

    def device_bytes(self) -> int:
        """Bytes of client state the store itself keeps on the card."""
        return 0

    def total_bytes(self) -> int:
        return self.row_bytes * self.n_registered

    @property
    def num_leaves(self) -> int:
        return len(self.names)

    def close(self) -> None:
        pass

    # -- streaming shard checkpoints -----------------------------------------

    def _shard_ranges(self, shard_rows: int):
        for s, lo in enumerate(range(0, self.n_registered, shard_rows)):
            yield s, lo, min(lo + shard_rows, self.n_registered)

    def save(self, directory, shard_rows: int = DEFAULT_SHARD_ROWS) -> str:
        """Stream the population into per-shard files under
        ``directory``, each written atomically, ``manifest.json`` last."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        for orphan in directory.glob("*.tmp"):
            orphan.unlink()
        files: Dict[str, Dict[str, int]] = {}
        for s, lo, hi in self._shard_ranges(shard_rows):
            arrays = self._take(np.arange(lo, hi, dtype=np.int64))
            for j, t in enumerate(arrays):
                arr = np.ascontiguousarray(t.numpy())  # blades-lint: disable=host-sync — checkpoint streaming only (save()): host shard rows, never in the round hot path
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
        atomic_write_json({
            "version": STORE_FORMAT_VERSION,
            "backend": self.backend,
            "n_registered": self.n_registered,
            "shard_rows": int(shard_rows),
            "num_shards": -(-self.n_registered // shard_rows),
            "leaves": [{"shape": list(sh), "dtype": str(_np_dtype(dt))}
                       for sh, dt in zip(self._shapes, self._dtypes)],
            "files": files,
        }, directory / "manifest.json")
        return str(directory)

    def load(self, directory) -> None:
        """Restore the population from :meth:`save`'s files (any
        backend's); orphaned ``.tmp`` files are deleted, and a missing,
        truncated or corrupt shard raises :class:`StateStoreError`."""
        directory = Path(directory)
        manifest = read_manifest(directory, self.n_registered)
        saved = [(tuple(leaf["shape"]), np.dtype(leaf["dtype"]))
                 for leaf in manifest["leaves"]]
        ours = [(sh, _np_dtype(dt))
                for sh, dt in zip(self._shapes, self._dtypes)]
        if saved != ours:
            raise StateStoreError(
                "state-store checkpoint row layout does not match this "
                f"run's client-state template: saved {saved}, expected "
                f"{ours} (model/optimizer/codec drift between save and "
                "restore)")
        for s, lo, hi, arrays in iter_shards(directory, manifest):
            self._put(np.arange(lo, hi, dtype=np.int64),
                      [torch.from_numpy(a) for a in arrays])


def read_manifest(directory: Path, n_registered: int) -> Dict:
    """A shard checkpoint's manifest, checked against the population;
    orphaned ``.tmp`` files are removed."""
    mpath = directory / "manifest.json"
    if not mpath.exists():
        raise StateStoreError(
            f"state-store checkpoint {directory} has no manifest.json "
            "(torn checkpoint write -- restore from an older one)")
    try:
        manifest = json.loads(mpath.read_text())
    except Exception as exc:
        raise StateStoreError(
            f"state-store manifest {mpath} is unreadable: {exc}")
    if manifest.get("version") != STORE_FORMAT_VERSION:
        raise StateStoreError(
            f"state-store checkpoint {directory} has format version "
            f"{manifest.get('version')!r}; this build reads "
            f"{STORE_FORMAT_VERSION}")
    if int(manifest["n_registered"]) != n_registered:
        raise StateStoreError(
            f"state-store checkpoint covers {manifest['n_registered']} "
            f"registered clients, this federation has {n_registered}")
    for orphan in directory.glob("*.tmp"):
        orphan.unlink()
    return manifest


def iter_shards(directory: Path, manifest: Dict):
    """``(shard, lo, hi, [leaf arrays])`` of every shard, each file's size,
    shape, dtype and CRC32 verified against the manifest."""
    shard_rows = int(manifest["shard_rows"])
    n = int(manifest["n_registered"])
    leaves = manifest["leaves"]
    files = manifest["files"]
    for s, lo in enumerate(range(0, n, shard_rows)):
        hi = min(lo + shard_rows, n)
        arrays = []
        for j, leaf in enumerate(leaves):
            name = f"shard-{s:05d}.l{j:02d}.npy"
            path = directory / name
            rec = files.get(name)
            if rec is None or not path.exists():
                raise StateStoreError(
                    f"state-store checkpoint {directory} is missing shard "
                    f"file {name}")
            if path.stat().st_size != int(rec["bytes"]):
                raise StateStoreError(
                    f"state-store shard {name} is torn: "
                    f"{path.stat().st_size} bytes on disk, manifest "
                    f"recorded {rec['bytes']}")
            arr = np.load(path, allow_pickle=False)
            expect = (hi - lo,) + tuple(leaf["shape"])
            if arr.shape != expect or arr.dtype != np.dtype(leaf["dtype"]):
                raise StateStoreError(
                    f"state-store shard {name} has shape {arr.shape}/"
                    f"{arr.dtype}, expected {expect}/{leaf['dtype']}")
            crc = zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))
            if (crc & 0xFFFFFFFF) != int(rec["crc32"]):
                raise StateStoreError(
                    f"state-store shard {name} fails its CRC32 check "
                    "(corrupt shard -- restore from an older checkpoint)")
            arrays.append(arr)
        yield s, lo, hi, arrays


class ResidentStore(ClientStateStore):
    """The dense stack on the card behind the store protocol: gather and
    scatter are device index ops (the bit-identical reference of the
    out-of-core backends)."""

    backend = "resident"

    def __init__(self, n_registered: int, template, *, device=None):
        super().__init__(n_registered, template)
        self._stack = [t.to(device).expand((n_registered,) + t.shape)
                       .contiguous() for t in self._template]

    def gather(self, ids, device=None):
        idx = torch.as_tensor(np.asarray(ids, np.int64)).to(  # blades-lint: disable=host-sync — cohort ids are host ints: the index goes to the card, nothing comes back
            self._stack[0].device if self._stack else "cpu")
        return {k: s.index_select(0, idx) for k, s in zip(self.names,
                                                            self._stack)}

    def scatter(self, ids, rows):
        for k, s in zip(self.names, self._stack):
            idx = torch.as_tensor(np.asarray(ids, np.int64)).to(s.device)  # blades-lint: disable=host-sync — cohort ids are host ints: the index goes to the card, nothing comes back
            s.index_copy_(0, idx, rows[k].to(s.device))

    def device_bytes(self) -> int:
        on_card = self._stack and self._stack[0].is_cuda
        return self.total_bytes() if on_card else 0

    def _take(self, ids):
        return [s[torch.as_tensor(ids).to(s.device)].cpu()  # blades-lint: disable=host-sync — checkpoint streaming only (save()): one bounded shard slice per fetch, never in the round hot path
                for s in self._stack]

    def _put(self, ids, arrays):
        for s, a in zip(self._stack, arrays):
            s[torch.as_tensor(ids).to(s.device)] = a.to(s.device)


class HostStore(ClientStateStore):
    """Host-memory backend: the population in (pinned) host tensors; only
    the gathered cohort rows reach the card."""

    backend = "host"

    def __init__(self, n_registered: int, template, *, pin: bool = False):
        super().__init__(n_registered, template, pin=pin)
        self._arrays = []
        for t in self._template:
            a = torch.empty((n_registered,) + t.shape, dtype=t.dtype,
                            pin_memory=self.pin)
            a.copy_(t.expand_as(a))
            self._arrays.append(a)

    def _take(self, ids):
        idx = torch.from_numpy(np.asarray(ids, np.int64))  # blades-lint: disable=host-sync — cohort ids are host ints indexing the host store
        out = self._staging(len(ids))
        for a, buf in zip(self._arrays, out):
            torch.index_select(a, 0, idx, out=buf)
        return out

    def _put(self, ids, arrays):
        idx = torch.from_numpy(np.asarray(ids, np.int64))  # blades-lint: disable=host-sync — cohort ids are host ints indexing the host store
        for a, rows in zip(self._arrays, arrays):
            a.index_copy_(0, idx, rows.to(a.dtype))


class DiskStore(ClientStateStore):
    """Disk backend: each leaf's rows split into ``shard_rows``-row
    ``.npy`` memmaps (``live-<s>.l<j>.npy``) under ``directory`` (a
    private temporary directory, removed on :meth:`close`, when None)."""

    backend = "disk"

    def __init__(self, n_registered: int, template,
                 directory: Optional[str] = None,
                 shard_rows: int = DEFAULT_SHARD_ROWS, *, pin: bool = False):
        super().__init__(n_registered, template, pin=pin)
        self._owns_dir = directory is None
        self._dir = Path(directory or tempfile.mkdtemp(
            prefix="blades_state_"))
        self._dir.mkdir(parents=True, exist_ok=True)
        self.shard_rows = int(shard_rows)
        self._maps: Dict[Tuple[int, int], np.memmap] = {}
        for s, lo, hi in self._shard_ranges(self.shard_rows):
            for j, t in enumerate(self._template):
                mm = np.lib.format.open_memmap(
                    self._dir / f"live-{s:05d}.l{j:02d}.npy", mode="w+",
                    dtype=_np_dtype(self._dtypes[j]),
                    shape=(hi - lo,) + self._shapes[j])
                mm[:] = t.numpy()  # blades-lint: disable=host-sync — store INIT only: the template row seeds the on-disk population, never per round
                self._maps[(s, j)] = mm

    def _take(self, ids):
        out = self._staging(len(ids))
        views = [b.numpy() for b in out]  # blades-lint: disable=host-sync — numpy views of the host staging buffers, no card read
        if len(ids):
            for s, pos, local in by_shard(np.asarray(ids), self.shard_rows):  # blades-lint: disable=host-sync — cohort ids are host ints indexing the on-disk shards
                for j in range(self.num_leaves):
                    views[j][pos] = self._maps[(s, j)][local]
        return out

    def _put(self, ids, arrays):
        if not len(ids):
            return
        views = [a.numpy() for a in arrays]  # blades-lint: disable=host-sync — numpy views of the host staging buffers, no card read
        for s, pos, local in by_shard(np.asarray(ids), self.shard_rows):  # blades-lint: disable=host-sync — cohort ids are host ints indexing the on-disk shards
            for j in range(self.num_leaves):
                self._maps[(s, j)][local] = views[j][pos]

    def close(self) -> None:
        self._maps = {}
        if self._owns_dir:
            shutil.rmtree(self._dir, ignore_errors=True)


class StoreStats:
    """Staging telemetry the driver stamps into rows (``state_stage_ms``,
    ``state_bytes_staged``, ``state_peak_hbm_bytes``)."""

    def __init__(self):
        self.last_stage_ms = 0.0
        self.last_bytes_staged = 0
        self.peak_hbm_bytes = 0

    def observe(self, stage_seconds: float, bytes_staged: int,
                hbm_bytes: int) -> None:
        self.last_stage_ms = stage_seconds * 1e3
        self.last_bytes_staged = int(bytes_staged)
        self.peak_hbm_bytes = max(self.peak_hbm_bytes, int(hbm_bytes))


def make_store(backend: str, n_registered: int, template, *,
               directory: Optional[str] = None,
               device=None) -> ClientStateStore:
    """A :class:`ClientStateStore` by backend name, serving ``device``
    (the host and disk stores pin their staging buffers for a CUDA
    device); ``directory`` applies to ``disk``."""
    pin = device is not None and torch.device(device).type == "cuda"
    if backend == "resident":
        return ResidentStore(n_registered, template, device=device)
    if backend == "host":
        return HostStore(n_registered, template, pin=pin)
    if backend == "disk":
        return DiskStore(n_registered, template, directory=directory,
                         pin=pin)
    raise ValueError(
        f"state_store must be one of {STORE_BACKENDS}, got {backend!r}")


def read_checkpoint_rows(directory, template, n_registered: int
                         ) -> Dict[str, torch.Tensor]:
    """A shard checkpoint as one stacked host dict (``(n_registered,
    ...)`` per leaf), verified as :meth:`ClientStateStore.load` verifies
    it: how a run without a window resumes a windowed checkpoint."""
    store = HostStore(n_registered, template)
    store.load(directory)
    return dict(zip(store.names, store._arrays))
