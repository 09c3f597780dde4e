"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/`` at the checkout
root, named by a hash of the source so an edited source rebuilds, and
bound with :mod:`ctypes`.  Nothing here runs at import time: a machine
without ``nvcc`` or a card imports this module and never calls it.

``LAUNCHES`` counts, per wrapper name, the kernel launches the wrappers
made; :func:`reset_launches` sets every count to 0.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_SOURCE = "fused_finish.cu"

LAUNCHES: collections.Counter = collections.Counter()
_lib = None

FORGES = {None: 0, "alie": 1, "ipm": 2, "adaptive": 3}
AGGS = {"mean": 0, "median": 1, "trimmed": 2}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile the kernel source into ``build/`` (skipped when the library
    for this source text already exists) and return the library's path."""
    src = CSRC / _SOURCE
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v",
           "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        ip = ctypes.POINTER(ctypes.c_int)
        lib.bt_finish_plan.argtypes = [i, i, ll, ip, ip, ip]
        lib.bt_finish_plan.restype = i
        lib.bt_finish.argtypes = [p, i, i, ll, p, p, p, p, p, p, p, p, i, i, i,
                                  i, i, i, i, i, i, i, f,
                                  ctypes.POINTER(ctypes.c_float), p]
        lib.bt_finish.restype = i
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


def launch_finish(name: str, x: torch.Tensor, *, active=None, noise=None,
                  mult: int = 0, forge=None, agg=("median",),
                  sanitize: bool = False, compact: bool = False,
                  want_sq: bool = True, want_forged: bool = False):
    """Launch the finish kernel on ``x`` (rows, d) and return
    ``(agg (d,), sq (rows,) or None, bad (rows,) bool, forged (d,) or None)``.

    ``active`` (rows,) bool selects the rows the statistics and the order
    statistics read (None = every row); ``mult`` counts the forged row's
    virtual multiplicity.  Raises on a tensor the kernel does not take.
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
    na = rows if act is None else int(act.sum().item())
    n_true = na + mult
    k_cut = int(agg[1]) if agg[0] == "trimmed" else 0
    dtype = 1 if x.dtype == torch.bfloat16 else 0

    lib = library()
    cols, smem, grid = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(dev):
        _check(lib, lib.bt_finish_plan(dtype, rows, d, ctypes.byref(cols),
                                       ctypes.byref(smem), ctypes.byref(grid)),
               f"{name}: no launch geometry for {rows} rows")
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
            x.data_ptr(), dtype, rows, d, _ptr(act), _ptr(nz),
            agg_out.data_ptr(), _ptr(forged), _ptr(sq), bad.data_ptr(),
            _ptr(sq_part), bad_part.data_ptr(), cols.value, g, smem.value,
            mult, n_true, FORGES[None if forge is None else forge[0]],
            AGGS[agg[0]], k_cut, int(sanitize), int(compact),
            float(max(na, 1)), fc, stream)
        _check(lib, err, f"{name}: launch failed")
    LAUNCHES[name] += 1
    return agg_out, sq, bad.bool(), forged
