"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled on first use with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and linked into ONE shared
library with a plain C interface under ``build/`` at the checkout root,
named by a hash over all the sources so an edited or added source
rebuilds, and bound with :mod:`ctypes`.  Nothing here runs at import time:
a machine without ``nvcc`` or a card imports this module and never calls
it.

``LAUNCHES`` counts, per wrapper name, the kernel launches the wrappers
made, and ``MAPS`` the BatchNorm-backward launches per (wrapper name,
thread map), the Gram launches per (wrapper name, ``gram:`` + route), the
row-statistics launches per (wrapper name, ``rowstats:`` + route), the
finish launches per (wrapper name, ``finish:`` + route) and the column
selects per (wrapper name, ``select:radix``); :func:`reset_launches` sets
every count to 0.  While ``COST`` is a dict (``Fedavg.cost_analysis``),
each launch adds to its ``"bytes"`` and ``"flops"`` what the kernel's
bound counts: each input byte read once, each output byte written once,
and its operations per element.

The library's directory is :func:`blades_tpu_torch.perf.compile_cache.cache_dir`
(``build/`` unless ``--compile-cache`` names another); finding the
library there counts as a compile-cache hit, running ``nvcc`` as a miss.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
MAPS: collections.Counter = collections.Counter()
#: Where launches book their bytes and operations, or None.
COST = None
_lib = None
_HERE = os.path.abspath(__file__)

FORGES = {None: 0, "alie": 1, "ipm": 2, "adaptive": 3}
AGGS = {"mean": 0, "median": 1, "trimmed": 2}
ROWSTATS_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    LAUNCHES.clear()
    MAPS.clear()


def raised_in_kernel(exc: BaseException) -> bool:
    """Whether ``exc`` came out of a kernel's build or launch (a frame of
    this module): such a failure is never a fallback's or a tuner's to
    hide."""
    tb = exc.__traceback__
    while tb is not None:
        if os.path.abspath(tb.tb_frame.f_code.co_filename) == _HERE:
            return True
        tb = tb.tb_next
    return False


def _charge(nbytes: int, ops: int) -> None:
    """Book one launch's bytes and operations into ``COST``."""
    if COST is not None:
        COST["bytes"] += int(nbytes)
        COST["flops"] += int(ops)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile every kernel source into one library in ``build/`` (skipped
    when the library for these source texts already exists) and return the
    library's path.  Each source compiles in its own ``nvcc`` process, all
    at once; ptxas's report of every kernel lands beside the library."""
    from blades_tpu_torch.perf import compile_cache

    srcs = _sources()
    h = hashlib.sha1()
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    build_dir = compile_cache.cache_dir(BUILD_DIR)
    out = build_dir / f"libblades_kernels_{h.hexdigest()[:12]}.so"
    if out.exists():
        compile_cache.record(hit=True)
        return out
    compile_cache.record(hit=False)
    build_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=build_dir))
    try:
        nvcc = _nvcc()
        jobs = []
        for src in srcs:
            obj = work / f"{src.stem}.o"
            jobs.append((src, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        reports = []
        for src, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{err}")
            reports.append(f"== {src.name}\n{err}")
        tmp = work / "lib.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp),
             *(str(work / f"{s.stem}.o") for s in srcs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link:\n{link.stderr}")
        os.replace(tmp, out)
        (build_dir / f"{out.stem}.ptxas.txt").write_text("".join(reports))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        llp = ctypes.POINTER(ctypes.c_longlong)
        lib.bt_finish_plan.argtypes = [i, i, i, ll, ip, ip, ip]
        lib.bt_finish_plan.restype = i
        lib.bt_finish.argtypes = [p, i, i, i, ll, p, p, p, p, p, p, p, p, i,
                                  i, i, i, i, i, i, i, i,
                                  ctypes.POINTER(ctypes.c_float), p]
        lib.bt_finish.restype = i
        lib.bt_rowstats_plan.argtypes = [i, i, ll, i, i, i, i, ip, ip, ip]
        lib.bt_rowstats_plan.restype = i
        lib.bt_rowstats.argtypes = [p, i, i, ll, ll, i, i, p, i, p, i, i, p, p,
                                    p, i, i, i, i, p, p, p, p, p]
        lib.bt_rowstats.restype = i
        lib.bt_rowstats_ring_plan.argtypes = [i, i, ll, i, i, i, i, i, ip, ip,
                                              ip]
        lib.bt_rowstats_ring_plan.restype = i
        lib.bt_rowstats_ring.argtypes = [p, i, i, ll, ll, i, i, p, i, p, i, i,
                                         i, ip, p, p, p, i, ip, i, i, p, p, p,
                                         p, p]
        lib.bt_rowstats_ring.restype = i
        lib.bt_gram_plan.argtypes = [i, i, i, ll, ip, ip, ip, llp]
        lib.bt_gram_plan.restype = i
        lib.bt_gram.argtypes = [p, i, i, i, ll, i, i, i, ll, p, p, p]
        lib.bt_gram.restype = i
        lib.bt_select_plan.argtypes = [i, ll, i, i, i, i, i, ip, ip]
        lib.bt_select_plan.restype = i
        lib.bt_select.argtypes = [p, i, ll, i, i, i, i, i, i, i, i, i, i, p,
                                  p]
        lib.bt_select.restype = i
        pp = ctypes.POINTER(ctypes.c_void_p)
        for fn in (lib.bt_bn_reduce, lib.bt_bn_dx, lib.bt_bn_bwd):
            fn.argtypes = [llp, pp, p]
            fn.restype = i
        lib.bt_error_string.argtypes = [i]
        lib.bt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.bt_error_string(err).decode()})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def forge_constants(forge) -> list:
    """The f32 constants each forge multiplies by, computed in double as
    the reference's Python scalars are before they meet f32 arrays."""
    if forge is None:
        return [0.0] * 6
    kind, p = forge[0], float(forge[1])
    if kind == "alie":
        return [p, 0.0, 0.0, 0.0, 0.0, 0.0]
    if kind == "ipm":
        return [-p, 0.0, 0.0, 0.0, 0.0, 0.0]
    return [p - 1.0, 1.0 / p - 1.0, 1.0 - 1.0 / p, 1.0 - p, p, p]


FINISH_ROUTES = {"bitserial": 0, "radix": 1}  # bt_finish's route codes
RADIX_SMEM_CAP = 226 * 1024  # kRSmemCap in csrc/fused_finish.cu


def radix_smem(rows: int, stages: int) -> int:
    """Dynamic shared memory of ``radix_kernel`` over ``rows`` rows with a
    ring of ``stages`` slabs, laid out as ``RSmem`` lays it out: the ring of
    32-column bf16 slabs, the 256-bin x 32-column histogram, three int
    arrays and two byte arrays a row, and the per-warp and per-column
    reduction buffers (16 warps, 10 column fields)."""
    cols, bins, warps, fields = 32, 256, 16, 10
    total = (stages * rows * cols * 2 + bins * cols * 4 + 3 * rows * 4
             + 5 * warps * cols * 4 + fields * cols * 4 + 2 * rows)
    return -(-total // 16) * 16


def finish_route(dtype: torch.dtype, d: int, address: int, rows: int) -> str:
    """The finish kernel for a ``(rows, d)`` matrix of ``dtype`` at device
    ``address``: ``radix`` (``radix_kernel``: 16-byte ``cp.async`` slabs,
    two 8-bit digit passes) for bf16 rows that are 16-byte aligned --
    ``d % 8 == 0`` and a 16-byte-aligned base -- and few enough that a
    two-slab ring of them fits one CTA's shared memory (1,317 rows); else
    ``bitserial`` (``finish_kernel``: f32, unaligned bf16, more rows)."""
    if (dtype == torch.bfloat16 and d % 8 == 0 and address % 16 == 0
            and radix_smem(rows, 2) <= RADIX_SMEM_CAP):
        return "radix"
    return "bitserial"


BITSERIAL_THREADS = 256  # kThreads in csrc/fused_finish.cu
BITSERIAL_COLS = (64, 32, 16, 8)  # pick_cols' slab widths, widest first
BITSERIAL_TWO_CTA = 110 * 1024  # a slab this small leaves room for two CTAs
BITSERIAL_SMEM_CAP = 226 * 1024  # the one-CTA cap of pick_cols


def bitserial_smem(rows: int, cols: int, esize: int) -> int:
    """Dynamic shared memory of ``finish_kernel`` over ``rows`` rows of a
    ``cols``-column slab of ``esize``-byte elements, laid out as ``Smem``
    lays it out: the slab (rows padded to an odd word stride), two int or
    float arrays a row, the count and reduction buffers (4 and 3 words a
    thread), the forged slab row and two byte arrays a row."""
    stride = cols + 4 // esize
    total = -(-rows * stride * esize // 16) * 16
    total += 2 * rows * 4 + 7 * BITSERIAL_THREADS * 4 + cols * 4 + 2 * rows
    return -(-total // 16) * 16


def bitserial_plan(rows: int, esize: int) -> int:
    """``pick_cols``: the widest slab whose shared memory leaves room for
    two CTAs an SM, else 8 columns where they fit one CTA, else 0 (the
    rows do not fit: ``bt_finish_plan`` refuses them)."""
    for cols in BITSERIAL_COLS:
        if bitserial_smem(rows, cols, esize) <= BITSERIAL_TWO_CTA:
            return cols
    return 8 if bitserial_smem(rows, 8, esize) <= BITSERIAL_SMEM_CAP else 0


def finish_fits(dtype: torch.dtype, rows: int) -> bool:
    """Whether the fused finish's kernel takes a ``(rows, d_alloc)``
    buffer of ``dtype`` as the streamed round allocates it (``d_alloc`` a
    multiple of 512 and a fresh, 16-byte-aligned allocation): on the
    radix route, or else on the bit-serial one.  A pure function of shape
    and dtype, the same on the CPU and on the card; the streamed round
    sends every other buffer to its chunked finish."""
    if finish_route(dtype, 512, 0, rows) == "radix":
        return True
    esize = 2 if dtype == torch.bfloat16 else 4
    return dtype in (torch.float32, torch.bfloat16) and bitserial_plan(
        rows, esize) > 0


def launch_finish(name: str, x: torch.Tensor, *, active=None, noise=None,
                  mult: int = 0, forge=None, agg=("median",),
                  sanitize: bool = False, compact: bool = False,
                  want_sq: bool = True, want_forged: bool = False):
    """Launch the finish kernel of :func:`finish_route` on ``x`` (rows, d)
    and return ``(agg (d,), sq (rows,) or None, bad (rows,) bool, forged
    (d,) or None)``.

    ``active`` (rows,) bool selects the rows the statistics and the order
    statistics read (None = every row); the forged row's virtual
    multiplicity is then the inactive row count, formed on the device with
    the ranks, so nothing here waits for the device.  Without ``active``
    it is ``mult``.  Raises on a tensor the kernel does not take.
    """
    if not x.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 2-D matrix, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         "(float32 or bfloat16)")
    rows, d = x.shape
    dev = x.device
    act = None
    if active is not None:
        if active.shape != (rows,):
            raise ValueError(f"{name}: active mask must be ({rows},)")
        act = active.to(device=dev, dtype=torch.uint8).contiguous()
    nz = None
    if noise is not None:
        if noise.shape != (d,):
            raise ValueError(f"{name}: forge_noise must be ({d},), got "
                             f"{tuple(noise.shape)}")
        nz = noise.to(device=dev, dtype=torch.float32).contiguous()
    k_cut = int(agg[1]) if agg[0] == "trimmed" else 0
    dtype = 1 if x.dtype == torch.bfloat16 else 0
    route = finish_route(x.dtype, d, x.data_ptr(), rows)

    lib = library()
    geom, smem, grid = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(dev):
        _check(lib, lib.bt_finish_plan(dtype, FINISH_ROUTES[route], rows, d,
                                       ctypes.byref(geom), ctypes.byref(smem),
                                       ctypes.byref(grid)),
               f"{name}: no {route} launch geometry for {rows} rows")
        g = grid.value
        agg_out = torch.empty((d,), dtype=torch.float32, device=dev)
        forged = (torch.empty((d,), dtype=torch.float32, device=dev)
                  if want_forged else None)
        sq = torch.empty((rows,), dtype=torch.float32, device=dev) if want_sq else None
        sq_part = (torch.empty((g, rows + 1), dtype=torch.float32, device=dev)
                   if want_sq else None)
        bad = torch.empty((rows,), dtype=torch.uint8, device=dev)
        bad_part = torch.empty((g, rows), dtype=torch.uint8, device=dev)
        fc = (ctypes.c_float * 6)(*forge_constants(forge))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bt_finish(
            x.data_ptr(), dtype, FINISH_ROUTES[route], rows, d, _ptr(act),
            _ptr(nz), agg_out.data_ptr(), _ptr(forged), _ptr(sq),
            bad.data_ptr(), _ptr(sq_part), bad_part.data_ptr(), geom.value, g,
            smem.value, mult, FORGES[None if forge is None else forge[0]],
            AGGS[agg[0]], k_cut, int(sanitize), int(compact), fc, stream)
        _check(lib, err, f"{name}: {route} launch failed")
    LAUNCHES[name] += 1
    MAPS[name, "finish:" + route] += 1
    # Per element: mean 1, variance 3, row norm 2, selection 1.
    _charge(_nbytes(x, act, nz, agg_out, forged, sq, bad), 7 * rows * d)
    return agg_out, sq, bad.bool(), forged


# ---- the column selects (csrc/column_select.cu) ----------------------------

SELECT_AGGS = {"median": 1, "trimmed": 2}  # bt_select's agg codes
SELECT_SMEM_CAP = 232_448  # kSmemCap in csrc/column_select.cu: 227 KB a block
# kCols, kBins, kWarps, kFields, kList, kMaxAhead of the source.
_SEL_COLS, _SEL_BINS, _SEL_WARPS, _SEL_FIELDS, _SEL_LIST = 32, 256, 16, 8, 16
SELECT_MAX_AHEAD = 16
SELECT_PACKED_ROWS = 65_536  # kPackedRows: fewer rows pack two counts a word
SELECT_FEW_ROWS = 64  # kFewRows: up to this many rows, ranks by counting
# The default geometry: rows per group, groups in flight, and the fewest
# groups in flight a resident slab may leave (four 8 KB groups: 32 KB a CTA
# in flight, about what one SM's share of HBM's rate needs).
SELECT_GH, SELECT_AHEAD, SELECT_RESIDENT_AHEAD = 64, 8, 4


class SelectPlan(NamedTuple):
    """How ``select_kernel`` covers a ``(rows, d)`` f32 matrix: bytes per
    ``cp.async`` (16, 8 or 4), rows per group, groups the ring holds,
    groups in flight, whether every group of a slab stays in the ring
    (``resident``; else each pass streams the slab again), and the dynamic
    shared memory in bytes."""
    vec: int
    gh: int
    stages: int
    ahead: int
    resident: int
    smem: int


def select_vec(d: int, address: int) -> int:
    """Bytes per copy of ``select_kernel`` for f32 rows of ``d`` columns at
    device ``address``: 16 when the rows are 16-byte aligned (``d % 4 ==
    0`` and a 16-byte-aligned base), 8 when they are 8-byte aligned (``d``
    even, as the dense ResNet-10 trial's ``d % 4 == 2``), else 4."""
    if d % 4 == 0 and address % 16 == 0:
        return 16
    if d % 2 == 0 and address % 8 == 0:
        return 8
    return 4


def select_smem(stages: int, gh: int, blocks: int = 0) -> int:
    """Dynamic shared memory of ``select_kernel``, laid out as ``Layout``
    of the source lays it out: ``stages`` groups of ``gh`` rows x 32 f32
    columns, the 256-bin x 32-column histogram, two per-warp column
    buffers, the per-column select state and, on the resident plan, two
    candidate masks of ``blocks`` 32-row blocks x 32 columns and two short
    key lists of 16 keys x 32 columns with their lengths."""
    lists = 2 * _SEL_LIST + 2 if blocks else 0
    return 4 * _SEL_COLS * (stages * gh + _SEL_BINS + 2 * _SEL_WARPS
                            + _SEL_FIELDS + 2 * blocks + lists)


def select_plan(rows: int, d: int, address: int, *, gh: int = SELECT_GH,
                ahead: int = SELECT_AHEAD, resident=None) -> SelectPlan:
    """The geometry of ``select_kernel`` for ``rows`` rows of ``d`` f32
    columns at device ``address``: the copy width of :func:`select_vec`;
    resident (the ring holds a slab's ``ceil(rows / gh)`` groups and
    ``ahead`` more of the next slab, fewer where room is short) when at
    least ``SELECT_RESIDENT_AHEAD`` groups in flight fit beside them and
    the masks and lists (up to 1,152 rows at the defaults; up to 64 rows
    in one group the kernel counts ranks and needs neither), else
    streaming (a ring of ``ahead + 1`` groups).  ``resident`` True / False
    asks for one.  A pure function of its arguments.  Raises only when a
    ring of two groups of ``gh`` rows does not fit, or a resident slab is
    asked for that does not fit: any row count has a plan at the default
    ``gh``."""
    if rows < 1 or d < 1:
        raise ValueError(f"column select: need rows >= 1 and d >= 1, got "
                         f"({rows}, {d})")
    if not 1 <= ahead <= SELECT_MAX_AHEAD or gh < 1 or gh & (gh - 1):
        raise ValueError(f"column select: ahead {ahead} outside 1.."
                         f"{SELECT_MAX_AHEAD}, or gh {gh} not a power of two")
    stage = 4 * _SEL_COLS * gh
    ng, nb = -(-rows // gh), -(-rows // 32)
    smax = (SELECT_SMEM_CAP - select_smem(0, gh)) // stage
    if smax < 2:
        raise ValueError(f"column select: groups of {gh} rows leave no room "
                         "for a ring of two in 227 KB")
    rmax = (SELECT_SMEM_CAP - select_smem(0, gh, nb)) // stage
    fits = (ng + min(ahead, SELECT_RESIDENT_AHEAD) <= rmax
            and rows < SELECT_PACKED_ROWS)
    if resident is None:
        resident = fits
    elif resident and not fits:
        raise ValueError(f"column select: {rows} rows in {ng} groups of {gh} "
                         "do not stay resident in 227 KB")
    if resident:
        ahead = min(ahead, rmax - ng)
        stages = ng + ahead
        if rows <= min(SELECT_FEW_ROWS, gh):
            nb = 0  # ranks by counting: no masks, no lists
    else:
        ahead, nb = min(ahead, smax - 1), 0
        stages = ahead + 1
    return SelectPlan(select_vec(d, address), gh, stages, ahead,
                      int(resident), select_smem(stages, gh, nb))


def launch_select(name: str, x: torch.Tensor, agg, *, geometry=None,
                  probe: int = 0) -> torch.Tensor:
    """Launch ``csrc/column_select.cu`` on the contiguous f32 ``x`` (rows,
    d) and return the ``(d,)`` median (``agg=("median",)``) or trimmed mean
    (``("trimmed", k)``) of its columns.  ``geometry`` (keywords of
    :func:`select_plan`) and ``probe`` (1: the loads without the passes,
    2: the passes without the loads; the result is then meaningless) serve
    measurements.  Raises on a tensor the kernel does not take."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor")
    if (x.dim() != 2 or not x.is_contiguous() or x.dtype != torch.float32
            or x.shape[0] < 1):
        raise ValueError(f"{name}: need a contiguous (rows >= 1, d) float32 "
                         f"matrix, got {tuple(x.shape)} {x.dtype}")
    rows, d = x.shape
    k_cut = int(agg[1]) if agg[0] == "trimmed" else 0
    plan = select_plan(rows, d, x.data_ptr(), **(geometry or {}))
    lib = library()
    dev = x.device
    smem, grid = ctypes.c_int(), ctypes.c_int()
    with _on_device(dev):
        _check(lib, lib.bt_select_plan(rows, d, plan.vec, plan.gh,
                                       plan.stages, plan.ahead, plan.resident,
                                       ctypes.byref(smem), ctypes.byref(grid)),
               f"{name}: no select geometry {plan} for ({rows}, {d})")
        if smem.value != plan.smem:
            raise RuntimeError(f"{name}: the kernel lays out {smem.value} "
                               f"bytes, select_smem {plan.smem}")
        out = torch.empty((d,), dtype=torch.float32, device=dev)
        _check(lib, lib.bt_select(
            x.data_ptr(), rows, d, plan.vec, plan.gh, plan.stages, plan.ahead,
            plan.resident, SELECT_AGGS[agg[0]], k_cut, int(probe), smem.value,
            grid.value, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream),
            f"{name}: select launch failed")
    LAUNCHES[name] += 1
    MAPS[name, "select:radix"] += 1
    # Per element: a compare for the median, a compare and an add for the
    # trimmed mean.
    _charge(_nbytes(x, out), (1 if agg[0] == "median" else 2) * rows * d)
    return out


def _weights(name, m, cols, dev):
    """``m`` as a contiguous ``(k, cols)`` f32 matrix on ``dev`` (k may be
    0 for None)."""
    if m is None:
        return torch.empty((0, cols), dtype=torch.float32, device=dev)
    if m.dim() != 2 or m.shape[1] != cols:
        raise ValueError(f"{name}: expected a (k, {cols}) matrix, got "
                         f"{tuple(m.shape)}")
    return m.to(device=dev, dtype=torch.float32).contiguous()


def gram_route(dtype: torch.dtype, d: int, address: int) -> str:
    """The Gram kernel for a ``(rows, d)`` matrix of ``dtype`` at device
    ``address``: ``wgmma`` (``gram_wgmma_kernel``, TMA-fed) for bf16 rows
    that are 16-byte aligned -- ``d % 8 == 0`` and a 16-byte-aligned base,
    as TMA's row stride must be -- else ``mma`` (``gram_mma_kernel``: int8,
    unaligned bf16) or ``f32`` (``gram_f32_kernel``)."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16 and d % 8 == 0 and address % 16 == 0:
        return "wgmma"
    return "mma"


ROWSTATS_ROUTES = {"slab": 0, "ring": 1}
RING_SMEM_CAP = 232_448  # kSmemMax in csrc/rowstats.cu: 227 KB a block
# kRgThreads, kRgWarps, kRgVecs, kRgIlp
_RING_THREADS, _RING_WARPS, _RING_VECS, _RING_ILP = 512, 16, 2, 8
RING_MAX_G = 16  # kRgMaxG
# The ring's default geometry: bytes of a slab row, rows per group, groups
# in flight (chosen on the H100, PERF.md section 6).
RING_ROWB, RING_GH, RING_AHEAD = 256, 256, 2


class RingPlan(NamedTuple):
    """How ``rowstats_ring_kernel`` covers a matrix: bytes per slab row,
    rows per group, groups in flight (the ring holds one more), whether the
    per-row partials sit in shared memory, and the dynamic shared memory
    in bytes."""
    rowb: int
    gh: int
    ahead: int
    part_smem: int
    smem: int


def rowstats_route(dtype: torch.dtype, d: int, address: int,
                   rows: int) -> str:
    """The row-statistics kernel for a ``(rows, d)`` matrix of ``dtype`` at
    device ``address``: ``ring`` (``rowstats_ring_kernel``: row groups
    through a 16-byte ``cp.async`` ring, any row count) for rows that are
    16-byte aligned -- ``d * itemsize % 16 == 0`` and a 16-byte-aligned
    base: f32 with ``d % 4 == 0``, bf16 with ``d % 8 == 0``, int8 with
    ``d % 16 == 0`` -- else ``slab`` (``rowstats_kernel``, which holds every
    row of a slab in one CTA's shared memory).  ``rows`` does not move the
    choice: the ring takes any height."""
    del rows
    esize = torch.empty((), dtype=dtype).element_size()
    if (d * esize) % 16 == 0 and address % 16 == 0:
        return "ring"
    return "slab"


def ring_smem(rows: int, esize: int, rowb: int, gh: int, ahead: int,
              R: int, U: int, G: int, KF: int, want_ip: bool,
              part_smem: bool) -> int:
    """Dynamic shared memory of ``rowstats_ring_kernel``, laid out as the
    kernel lays it out (``ring_smem`` of the source): ``ahead + 1`` groups
    of ``gh`` rows x ``rowb`` bytes, the slab's ``R`` dots and ``G`` gram_dot
    vectors and the column reduction buffer (f32 per slab column), and with
    ``part_smem`` the per-row partials (``KF`` floats, 3 ints with
    ``want_ip``)."""
    cols = rowb // esize
    total = ((ahead + 1) * gh * rowb + (R + G) * cols * 4
             + (_RING_VECS * _RING_WARPS * cols * 4 if U else 0))
    if part_smem:
        total += rows * (KF + (3 if want_ip else 0)) * 4
    return total


def ring_plan(dtype: torch.dtype, rows: int, R: int, U: int, G: int,
              KF: int, want_ip: bool, *, rowb: int = RING_ROWB,
              gh: int = RING_GH, ahead: int = RING_AHEAD) -> RingPlan:
    """The geometry of ``rowstats_ring_kernel`` for ``rows`` rows of
    ``dtype`` with ``R`` dots vectors, ``U`` column-pass vectors, ``G``
    gram_dot vectors and ``KF`` float partials a row: ``rowb`` bytes a slab
    row, ``gh`` rows a group (rounded to whole units of ``kRgIlp`` sweeps
    of the block, and no more units than ``rows`` needs), ``ahead`` groups
    in flight (fewer when the vectors leave no room); the per-row partials
    in shared memory when they fit beside the ring.  A pure function of
    its arguments.  Raises when the vectors alone leave no room."""
    esize = torch.empty((), dtype=dtype).element_size()
    unit = _RING_ILP * _RING_THREADS // (rowb // 16)
    gh = max(unit, min(gh, -(-rows // unit) * unit) // unit * unit)
    stage = gh * rowb
    # The vectors and buffers without the ring (ahead + 1 = 0 groups), and
    # the per-row partials alone.
    base = ring_smem(rows, esize, rowb, gh, -1, R, U, G, KF, want_ip, False)
    part = ring_smem(rows, esize, rowb, gh, -1, 0, 0, 0, KF, want_ip, True)
    while ahead > 1 and base + (ahead + 1) * stage > RING_SMEM_CAP:
        ahead -= 1
    if base + (ahead + 1) * stage > RING_SMEM_CAP:
        raise ValueError(f"row statistics: {R} dots and {G} gram_dot "
                         "vectors leave no room for the ring")
    part_smem = base + part + (ahead + 1) * stage <= RING_SMEM_CAP
    return RingPlan(rowb, gh, ahead, int(part_smem),
                    ring_smem(rows, esize, rowb, gh, ahead, R, U, G, KF,
                              want_ip, part_smem))


def _ring_vectors(name, w, g, shared):
    """The ring kernel's column-pass vectors ``(U, rows)`` -- the wsum
    weights, then each gram_dot vector that shares none -- and, per
    gram_dot vector, the row of them its ``t`` comes from."""
    W, G = w.shape[0], g.shape[0]
    if shared is None:
        shared = [-1] * G
    shared = [int(j) for j in shared]
    if len(shared) != G or not all(-1 <= j < W for j in shared):
        raise ValueError(f"{name}: gram_dot_shared {shared} must give, for "
                         f"each of {G} gram_dot vectors, a weights row "
                         f"below {W} or -1")
    own = [k for k in range(G) if shared[k] < 0]
    u = torch.cat([w, g[own]]) if own else w
    gsrc = [j if j >= 0 else W + own.index(k) for k, j in enumerate(shared)]
    return u.contiguous(), gsrc


def launch_rowstats(name: str, x: torch.Tensor, *, sq: bool = False,
                    gram: bool = False, signs: bool = False, dots=None,
                    weights=None, gram_dot=None, gram_dot_shared=None,
                    d_true=None, geometry=None, probe: int = 0) -> dict:
    """Launch the row-statistics kernels of ``csrc/rowstats.cu`` on ``x``
    (rows, d) and return the requested statistics (see
    :func:`blades_tpu_torch.ops.rowstats.row_stats_bundle`): the kernel of
    :func:`rowstats_route` for everything but the Gram, the tile kernel of
    :func:`gram_route` for the Gram, each followed by its deterministic
    reduction.  ``gram_dot_shared[k] = j`` says gram_dot vector k is
    weights row j: the ring route then takes one column pass for both.
    ``geometry`` (keywords of :func:`ring_plan`) and ``probe`` (1: the
    ring's loads without its passes, 2: its passes without its loads; the
    results are then meaningless) serve measurements.  Raises on a tensor
    the kernels do not take."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor")
    if x.dim() != 2 or not x.is_contiguous() or x.shape[0] < 1:
        raise ValueError(f"{name}: need a contiguous (rows >= 1, d) matrix, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in ROWSTATS_DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         "(float32, bfloat16 or int8)")
    rows, d = x.shape
    dev = x.device
    dt = ROWSTATS_DTYPES[x.dtype]
    d_true = d if d_true is None else int(d_true)
    v = _weights(name, dots, d, dev)
    w = _weights(name, weights, rows, dev)
    g = _weights(name, gram_dot, rows, dev)
    R, W, G = v.shape[0], w.shape[0], g.shape[0]
    out = {}
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if sq or signs or R or W or G:
            route = rowstats_route(x.dtype, d, x.data_ptr(), rows)
            kf = (1 if sq and dt != 2 else 0) + R + G
            want_ip = bool(signs or (sq and dt == 2))
            smem, grid = ctypes.c_int(), ctypes.c_int()
            if route == "ring":
                if G > RING_MAX_G:
                    raise ValueError(f"{name}: at most {RING_MAX_G} gram_dot "
                                     f"vectors a launch, got {G}")
                u, gsrc = _ring_vectors(name, w, g, gram_dot_shared)
                U = u.shape[0]
                plan = ring_plan(x.dtype, rows, R, U, G, kf, want_ip,
                                 **(geometry or {}))
                geom = (ctypes.c_int * 5)(plan.rowb, plan.gh, plan.ahead,
                                          plan.part_smem, int(probe))
                _check(lib, lib.bt_rowstats_ring_plan(
                    dt, rows, d, R, U, G, kf, int(want_ip), geom,
                    ctypes.byref(smem), ctypes.byref(grid)),
                    f"{name}: no ring geometry {plan} for ({rows}, {d})")
                if smem.value != plan.smem:
                    raise RuntimeError(f"{name}: the kernel lays out "
                                       f"{smem.value} bytes, ring_smem "
                                       f"{plan.smem}")
            else:
                rowb = ctypes.c_int()
                err = lib.bt_rowstats_plan(dt, rows, d, R, W, G, kf,
                                           ctypes.byref(rowb),
                                           ctypes.byref(smem),
                                           ctypes.byref(grid))
                if err == 1:  # cudaErrorInvalidValue: the slab does not fit
                    raise ValueError(
                        f"{name}: {rows} rows of {d} x {x.dtype} are not "
                        "16-byte aligned (the ring route's condition), and "
                        "the slab route for such rows holds every row of a "
                        "slab in one CTA's shared memory: they do not fit")
                _check(lib, err, f"{name}: no launch geometry")
            gr = grid.value
            fpart = torch.empty((gr, rows, max(kf, 1)), dtype=torch.float32,
                                device=dev)
            ipart = torch.empty((gr, rows, 3), dtype=torch.int32, device=dev)
            f32 = dict(dtype=torch.float32, device=dev)
            sq_out = torch.empty((rows,), **f32) if sq else None
            signs_out = torch.empty((rows, 3), **f32) if signs else None
            dots_out = torch.empty((rows, R), **f32) if R else None
            gd_out = torch.empty((rows, G), **f32) if G else None
            wsum_out = torch.empty((W, d), **f32) if W else None
            if route == "ring":
                err = lib.bt_rowstats_ring(
                    x.data_ptr(), dt, rows, d, d_true, int(sq), int(signs),
                    _ptr(v) if R else None, R, _ptr(u) if U else None, U, W,
                    G, (ctypes.c_int * max(G, 1))(*gsrc), _ptr(wsum_out),
                    fpart.data_ptr(), ipart.data_ptr(), kf, geom,
                    smem.value, gr, _ptr(sq_out), _ptr(signs_out),
                    _ptr(dots_out), _ptr(gd_out), stream)
            else:
                wg = torch.cat([w, g]) if W + G else None
                err = lib.bt_rowstats(
                    x.data_ptr(), dt, rows, d, d_true, int(sq), int(signs),
                    _ptr(v) if R else None, R, _ptr(wg), W, G,
                    _ptr(wsum_out), fpart.data_ptr(), ipart.data_ptr(), kf,
                    rowb.value, smem.value, gr, _ptr(sq_out),
                    _ptr(signs_out), _ptr(dots_out), _ptr(gd_out), stream)
            _check(lib, err, f"{name}: {route} row-statistics launch failed")
            MAPS[name, "rowstats:" + route] += 1
            for key, val in (("sq", sq_out), ("signs", signs_out),
                             ("dots", dots_out), ("gram_dot", gd_out)):
                if val is not None:
                    out[key] = val
            if wsum_out is not None:
                out["wsum"] = wsum_out[:, :d_true]
        if gram:
            route = gram_route(x.dtype, d, x.data_ptr())
            rc = int(route == "wgmma")  # bt_gram's route code
            tile, npairs, splits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            span = ctypes.c_longlong()
            _check(lib, lib.bt_gram_plan(dt, rc, rows, d, ctypes.byref(tile),
                                         ctypes.byref(npairs),
                                         ctypes.byref(splits),
                                         ctypes.byref(span)),
                   f"{name}: no Gram launch geometry")
            part = torch.empty(
                (splits.value, npairs.value, tile.value, tile.value),
                dtype=torch.int32 if dt == 2 else torch.float32, device=dev)
            gram_out = torch.empty((rows, rows), dtype=torch.float32,
                                   device=dev)
            _check(lib, lib.bt_gram(x.data_ptr(), dt, rc, rows, d,
                                    tile.value, npairs.value, splits.value,
                                    span.value, part.data_ptr(),
                                    gram_out.data_ptr(), stream),
                   f"{name}: Gram launch failed")
            out["gram"] = gram_out
            MAPS[name, "gram:" + route] += 1
    LAUNCHES[name] += 1
    # A multiply and an add per element for each row statistic and each
    # vector, and per row pair of the Gram.
    per = int(sq) + int(signs) + R + W + G
    _charge(_nbytes(x, v, w, g) + sum(
        _nbytes(t) for t in out.values() if torch.is_tensor(t)),
        2 * rows * d_true * per
        + (rows * (rows + 1) // 2 * d_true * 2 if gram else 0))
    return out


# ---- the BatchNorm backward (csrc/bn_backward.cu) -------------------------

BN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BN_MAPS = ("spatial", "scalar", "vector")  # the kernels' thread maps
# Positions per split of the two scalar maps (256 threads x 16 elements;
# 8 warps x 64 positions), and the vector map's grid: about four waves of
# the H100's 132 SMs at two resident 256-thread CTAs each.
_BN_SPATIAL_CHUNK, _BN_SCALAR_CHUNK = 4096, 512
_BN_TARGET_CTAS = 4 * 2 * 132
_BN_UNROLL, _BN_WARPS, _BN_TILE_C = 4, 8, 32


class BnPlan(NamedTuple):
    """How the BN-backward kernels cover a ``(G, N, C, S)`` operand set:
    the thread map (an index into :data:`BN_MAPS`), the vector width in
    elements, ``tc`` (vector map: lanes per position, a power of two <=
    32), channel groups per client, splits per (client, group) and
    positions per split."""
    map: int
    vec: int
    tc: int
    groups: int
    splits: int
    chunk: int

    @property
    def width(self) -> int:
        """Channels per group: the row width of the split partials."""
        return (self.tc * self.vec if self.map == 2
                else _BN_TILE_C if self.map == 1 else 1)

    def partials(self, g: int) -> int:
        """f32 words of the split partials for ``g`` clients."""
        return g * self.groups * self.splits * 3 * self.width


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def bn_plan(shape, strides, itemsize: int, offsets) -> BnPlan:
    """The launch plan of the BN-backward kernels for operands of
    ``shape`` (G, N, C, S) with element ``strides`` (one 4-tuple per
    tensor: x, dy and, for the dx pass, dx), ``itemsize`` bytes per element
    and ``offsets`` (each tensor's ``data_ptr() % 16``).  A pure function
    of its arguments, so the split count -- and the order of the sums --
    is fixed by the shape.

    - channel stride 1 everywhere, C a multiple of the 16-byte vector
      width, (n, s) one flat position (the n stride S times the s stride),
      16-byte aligned pointers and client / position strides: the vector
      map, split so the grid is about ``_BN_TARGET_CTAS`` CTAs;
    - channel stride 1 otherwise: the scalar channel-inner map;
    - else the spatial-inner map.
    """
    g, n, c, s = shape
    length = n * s
    if not all(st[2] == 1 for st in strides):
        return BnPlan(0, 0, 0, c, _ceil(length, _BN_SPATIAL_CHUNK),
                      _BN_SPATIAL_CHUNK)
    vec = 16 // itemsize

    def fits(st, off):
        pos = st[3] if s > 1 else st[1]
        return (off == 0 and (n == 1 or s == 1 or st[1] == s * st[3])
                and (g == 1 or st[0] % vec == 0)
                and (length == 1 or pos % vec == 0))

    if c % vec or not all(fits(st, o) for st, o in zip(strides, offsets)):
        return BnPlan(1, 0, 0, _ceil(c, _BN_TILE_C),
                      _ceil(length, _BN_SCALAR_CHUNK), _BN_SCALAR_CHUNK)
    cv = c // vec
    tc = min(32, 1 << (cv - 1).bit_length())
    groups = _ceil(cv, tc)
    unit = _BN_UNROLL * _BN_WARPS * (32 // tc)  # one unrolled CTA step
    splits = max(1, min(_ceil(length, unit),
                        _ceil(_BN_TARGET_CTAS, g * groups)))
    chunk = _ceil(_ceil(length, splits), unit) * unit
    return BnPlan(2, vec, tc, groups, _ceil(length, chunk), chunk)


def _bn_check(name, x, dy, vecs) -> None:
    """The BN launches take ``(G, N, C, S)`` CUDA tensors ``x`` and ``dy``
    of one dtype and per-(client, channel) ``(G, C)`` vectors of that
    dtype, all through their strides; nothing is copied."""
    if not (x.is_cuda and dy.is_cuda):
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors")
    if x.dtype not in BN_DTYPES or dy.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes {x.dtype}/{dy.dtype} not supported "
                         "(float32 or bfloat16, the same for x and dy)")
    if x.dim() != 4 or dy.shape != x.shape:
        raise ValueError(f"{name}: need x and dy of one (G, N, C, S) shape, "
                         f"got {tuple(x.shape)} and {tuple(dy.shape)}")
    g, _, c, _ = x.shape
    for v in vecs:
        if v.shape != (g, c) or v.dtype != x.dtype or v.device != x.device:
            raise ValueError(f"{name}: per-channel operand {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}, expected {(g, c)} "
                             f"{x.dtype} on {x.device}")


_NO_STRIDES = (0, 0, 0, 0)
_NO_PLAN = (0,) * 6


@functools.lru_cache(maxsize=1024)
def _bn_layout(dtype, shape, strides, vstrides, offsets):
    """The plans and the packed integers of ``bt_bn_*`` (``enum Arg`` of
    the source) for one operand layout: ``strides`` of x, dy and dx (None
    for the bare reduction), ``vstrides`` of the per-channel vectors,
    ``offsets`` the tensors' ``data_ptr() % 16``.  Cached: a client block
    meets a few layouts over and over, and building the array costs more
    host time than the launch."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    red = bn_plan(shape, strides[:2], itemsize, offsets[:2])
    dxp = (None if strides[2] is None
           else bn_plan(shape, strides, itemsize, offsets))
    vs = [st for v in vstrides for st in v]
    args = (ctypes.c_longlong * 39)(
        BN_DTYPES[dtype], *shape, *strides[0], *strides[1],
        *(strides[2] or _NO_STRIDES), *vs, *[0] * (10 - len(vs)), *red,
        *(dxp or _NO_PLAN))
    return red, dxp, args


def _bn_layout_of(x, dy, dx, vecs):
    ts = (x, dy) if dx is None else (x, dy, dx)
    return _bn_layout(x.dtype, tuple(x.shape),
                      (x.stride(), dy.stride(), None if dx is None
                       else dx.stride()),
                      tuple(v.stride() for v in vecs),
                      tuple(t.data_ptr() % 16 for t in ts))


def _bn_ptrs(*ptrs):
    """The 16 pointers of ``bt_bn_*`` (``enum Ptr`` of the source)."""
    return (ctypes.c_void_p * 16)(*ptrs)


_BN_COUNTERS: dict = {}


def _bn_counter(dev, n: int) -> torch.Tensor:
    """The device's ticket counters (zeros; each launch leaves them zero),
    at least ``n``.  One buffer per device: the port launches on one
    stream, and two streams would need a buffer each."""
    buf = _BN_COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        size = max(n, 4096, 0 if buf is None else 2 * buf.numel())
        buf = _BN_COUNTERS[dev] = torch.zeros((size,), dtype=torch.int32,
                                              device=dev)
    return buf


def _count(name: str, plan: BnPlan) -> None:
    LAUNCHES[name] += 1
    MAPS[name, BN_MAPS[plan.map]] += 1


def _on_device(dev):
    """The device context for a launch, a no-op when ``dev`` is current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def launch_bn_reduce(name: str, x, dy, mean, r, scale):
    """Launch the reduction of ``csrc/bn_backward.cu``: per (client,
    channel) f32 sums ``(dbias, dscale, sum dxhat)``, each ``(G, C)``."""
    vecs = (mean, r, scale)
    _bn_check(name, x, dy, vecs)
    g, _, c, _ = x.shape
    plan, _, args = _bn_layout_of(x, dy, None, vecs)
    lib = library()
    dev = x.device
    with _on_device(dev):
        sums = [torch.empty((g, c), dtype=torch.float32, device=dev)
                for _ in range(3)]
        part = torch.empty((plan.partials(g),), dtype=torch.float32,
                           device=dev)
        err = lib.bt_bn_reduce(
            args, _bn_ptrs(x.data_ptr(), dy.data_ptr(), None,
                           *(v.data_ptr() for v in vecs), None, None,
                           part.data_ptr(),
                           _bn_counter(dev, g * plan.groups).data_ptr(),
                           *(t.data_ptr() for t in sums)),
            torch.cuda.current_stream(dev).cuda_stream)
        _check(lib, err, f"{name}: launch failed")
    _count(name, plan)
    # A subtract, 3 multiplies and 3 adds per element.
    _charge(_nbytes(x, dy, *vecs, *sums), 7 * x.numel())
    return tuple(sums)


def launch_bn_dx(name: str, x, dy, mean, r, scale, mean_dxhat,
                 mean_dxhat_xhat):
    """Launch the dx pass of ``csrc/bn_backward.cu``: ``dx`` of ``x``'s
    shape, dtype and (dense) strides."""
    vecs = (mean, r, scale, mean_dxhat, mean_dxhat_xhat)
    _bn_check(name, x, dy, vecs)
    lib = library()
    dev = x.device
    with _on_device(dev):
        dx = torch.empty_like(x)
        _, plan, args = _bn_layout_of(x, dy, dx, vecs)
        err = lib.bt_bn_dx(args, _bn_ptrs(x.data_ptr(), dy.data_ptr(),
                                          dx.data_ptr(),
                                          *(v.data_ptr() for v in vecs)),
                           torch.cuda.current_stream(dev).cuda_stream)
        _check(lib, err, f"{name}: launch failed")
    _count(name, plan)
    # A subtract, 4 multiplies and 2 subtracts per element.
    _charge(_nbytes(x, dy, dx, *vecs), 7 * x.numel())
    return dx


def launch_bn_bwd(x, dy, mean, r, scale):
    """The whole BN backward of one layer from one host call: the
    reduction with its finish, then the dx pass, counted as one launch of
    ``bn_bwd_reduce`` and one of ``bn_bwd_dx``.  Returns ``(dx, dscale,
    dbias, scratch)``: ``dscale`` and ``dbias`` ``(G, C)`` in ``x``'s
    dtype; :func:`bn_scratch_parts` reads the f32 sums and the
    coefficients out of ``scratch``."""
    vecs = (mean, r, scale)
    _bn_check("bn_bwd", x, dy, vecs)
    g, _, c, _ = x.shape
    lib = library()
    dev = x.device
    gc = g * c
    with _on_device(dev):
        dx = torch.empty_like(x)
        red, dxp, args = _bn_layout_of(x, dy, dx, vecs)
        dscale = torch.empty((g, c), dtype=x.dtype, device=dev)
        dbias = torch.empty((g, c), dtype=x.dtype, device=dev)
        # Scratch, f32 words: the sums (3 G C), the coefficients (2 G C
        # elements of the dtype, 4-byte aligned), the split partials.
        cw = _ceil(2 * gc * x.element_size(), 4)
        scratch = torch.empty((3 * gc + cw + red.partials(g),),
                              dtype=torch.float32, device=dev)
        base = scratch.data_ptr()
        err = lib.bt_bn_bwd(
            args, _bn_ptrs(
                x.data_ptr(), dy.data_ptr(), dx.data_ptr(), mean.data_ptr(),
                r.data_ptr(), scale.data_ptr(), None, None,
                base + 4 * (3 * gc + cw),
                _bn_counter(dev, g * red.groups).data_ptr(),
                base, base + 4 * gc, base + 8 * gc, dscale.data_ptr(),
                dbias.data_ptr(), base + 12 * gc),
            torch.cuda.current_stream(dev).cuda_stream)
        _check(lib, err, "bn_bwd: launch failed")
    _count("bn_bwd_reduce", red)
    _count("bn_bwd_dx", dxp)
    # The two passes: x and dy read twice, dx written, the (G, C) sums
    # and coefficients; 7 operations per element each.
    _charge(2 * _nbytes(x, dy) + _nbytes(dx, dscale, dbias, *vecs)
            + 5 * gc * 4, 14 * x.numel())
    return dx, dscale, dbias, scratch


def bn_scratch_parts(scratch, x):
    """``(sums, coefs)`` of a :func:`launch_bn_bwd` on ``x``: the f32 sums
    ``(3, G, C)`` (dbias, dscale, sum dxhat) and the coefficients
    ``(2, G, C)`` (``mean_dxhat``, ``mean_dxhat_xhat``) in ``x``'s dtype,
    as views of ``scratch``."""
    g, _, c, _ = x.shape
    gc = g * c
    cw = _ceil(2 * gc * x.element_size(), 4)
    return (scratch[:3 * gc].view(3, g, c),
            scratch[3 * gc:3 * gc + cw].view(x.dtype)[:2 * gc].view(2, g, c))
