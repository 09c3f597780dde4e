"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled on first use with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and linked into ONE shared
library with a plain C interface under ``build/`` at the checkout root,
named by a hash over all the sources so an edited or added source
rebuilds, and bound with :mod:`ctypes`.  Nothing here runs at import time:
a machine without ``nvcc`` or a card imports this module and never calls
it.

``LAUNCHES`` counts, per wrapper name, the kernel launches the wrappers
made; :func:`reset_launches` sets every count to 0.
"""

from __future__ import annotations

import collections
import contextlib
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
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
_lib = None

FORGES = {None: 0, "alie": 1, "ipm": 2, "adaptive": 3}
AGGS = {"mean": 0, "median": 1, "trimmed": 2}
ROWSTATS_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile every kernel source into one library in ``build/`` (skipped
    when the library for these source texts already exists) and return the
    library's path.  Each source compiles in its own ``nvcc`` process, all
    at once; ptxas's report of every kernel lands beside the library."""
    srcs = _sources()
    h = hashlib.sha1()
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    out = BUILD_DIR / f"libblades_kernels_{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
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
        (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text("".join(reports))
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
        lib.bt_finish_plan.argtypes = [i, i, ll, ip, ip, ip]
        lib.bt_finish_plan.restype = i
        lib.bt_finish.argtypes = [p, i, i, ll, p, p, p, p, p, p, p, p, i, i, i,
                                  i, i, i, i, i, i, i, f,
                                  ctypes.POINTER(ctypes.c_float), p]
        lib.bt_finish.restype = i
        lib.bt_rowstats_plan.argtypes = [i, i, ll, i, i, i, i, ip, ip, ip]
        lib.bt_rowstats_plan.restype = i
        lib.bt_rowstats.argtypes = [p, i, i, ll, ll, i, i, p, i, p, i, i, p, p,
                                    p, i, i, i, i, p, p, p, p, p]
        lib.bt_rowstats.restype = i
        lib.bt_gram_plan.argtypes = [i, i, ll, ip, ip, ip, llp]
        lib.bt_gram_plan.restype = i
        lib.bt_gram.argtypes = [p, i, i, ll, i, i, i, ll, p, p, p]
        lib.bt_gram.restype = i
        lib.bt_bn_splits.argtypes = [ll, ll, ll]
        lib.bt_bn_splits.restype = i
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.bt_bn_reduce.argtypes = [p, p, i, i, i, i, i, llp, llp, pp, llp, p,
                                     p, p, p, p]
        lib.bt_bn_reduce.restype = i
        lib.bt_bn_dx.argtypes = [p, p, p, i, i, i, i, i, llp, llp, llp, pp,
                                 llp, p]
        lib.bt_bn_dx.restype = i
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


def _weights(name, m, cols, dev):
    """``m`` as a contiguous ``(k, cols)`` f32 matrix on ``dev`` (k may be
    0 for None)."""
    if m is None:
        return torch.empty((0, cols), dtype=torch.float32, device=dev)
    if m.dim() != 2 or m.shape[1] != cols:
        raise ValueError(f"{name}: expected a (k, {cols}) matrix, got "
                         f"{tuple(m.shape)}")
    return m.to(device=dev, dtype=torch.float32).contiguous()


def launch_rowstats(name: str, x: torch.Tensor, *, sq: bool = False,
                    gram: bool = False, signs: bool = False, dots=None,
                    weights=None, gram_dot=None, d_true=None) -> dict:
    """Launch the row-statistics kernels of ``csrc/rowstats.cu`` on ``x``
    (rows, d) and return the requested statistics (see
    :func:`blades_tpu_torch.ops.rowstats.row_stats_bundle`): the slab
    kernel for everything but the Gram, the tile kernel for the Gram, each
    followed by its deterministic reduction.  Raises on a tensor the
    kernels do not take."""
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
            kf = (1 if sq and dt != 2 else 0) + R + G
            rowb, smem, grid = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            err = lib.bt_rowstats_plan(dt, rows, d, R, W, G, kf,
                                       ctypes.byref(rowb), ctypes.byref(smem),
                                       ctypes.byref(grid))
            if err == 1:  # cudaErrorInvalidValue: the slab does not fit
                raise ValueError(f"{name}: {rows} rows do not fit one CTA's "
                                 "shared memory")
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
            wg = torch.cat([w, g]) if W + G else None
            err = lib.bt_rowstats(
                x.data_ptr(), dt, rows, d, d_true, int(sq), int(signs),
                _ptr(v) if R else None, R, _ptr(wg), W, G, _ptr(wsum_out),
                fpart.data_ptr(), ipart.data_ptr(), kf, rowb.value,
                smem.value, gr, _ptr(sq_out), _ptr(signs_out),
                _ptr(dots_out), _ptr(gd_out), stream)
            _check(lib, err, f"{name}: row-statistics launch failed")
            for key, val in (("sq", sq_out), ("signs", signs_out),
                             ("dots", dots_out), ("gram_dot", gd_out)):
                if val is not None:
                    out[key] = val
            if wsum_out is not None:
                out["wsum"] = wsum_out[:, :d_true]
        if gram:
            tile, npairs, splits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            span = ctypes.c_longlong()
            _check(lib, lib.bt_gram_plan(dt, rows, d, ctypes.byref(tile),
                                         ctypes.byref(npairs),
                                         ctypes.byref(splits),
                                         ctypes.byref(span)),
                   f"{name}: no Gram launch geometry")
            part = torch.empty(
                (splits.value, npairs.value, tile.value, tile.value),
                dtype=torch.int32 if dt == 2 else torch.float32, device=dev)
            gram_out = torch.empty((rows, rows), dtype=torch.float32,
                                   device=dev)
            _check(lib, lib.bt_gram(x.data_ptr(), dt, rows, d, tile.value,
                                    npairs.value, splits.value, span.value,
                                    part.data_ptr(), gram_out.data_ptr(),
                                    stream),
                   f"{name}: Gram launch failed")
            out["gram"] = gram_out
    LAUNCHES[name] += 1
    return out


BN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bn_operands(name, x, dy, vecs):
    """Checks of the BatchNorm-backward launches: ``x`` and ``dy`` are
    ``(G, N, C, S)`` CUDA tensors of one dtype, and the per-(client,
    channel) vectors ``(G, C)`` tensors of that dtype; all are taken
    through their strides, nothing is copied.  Returns the vectors'
    pointer and stride arrays."""
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
    ptrs = (ctypes.c_void_p * len(vecs))(*(v.data_ptr() for v in vecs))
    strides = (ctypes.c_longlong * (2 * len(vecs)))(
        *(st for v in vecs for st in v.stride()))
    return ptrs, strides


def _strides(t):
    return (ctypes.c_longlong * 4)(*t.stride())


def _on_device(dev):
    """The device context for a launch, a no-op when ``dev`` is current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def launch_bn_reduce(name: str, x, dy, mean, r, scale):
    """Launch the reduction pass of ``csrc/bn_backward.cu``: per (client,
    channel) f32 sums ``(dbias, dscale, dxhat)``, each ``(G, C)``."""
    vp, vs = _bn_operands(name, x, dy, (mean, r, scale))
    g, n, c, s = x.shape
    lib = library()
    dev = x.device
    with _on_device(dev):
        splits = lib.bt_bn_splits(n * s, x.stride(2), dy.stride(2))
        part = torch.empty((g * c * splits * 3,), dtype=torch.float32,
                           device=dev)
        outs = [torch.empty((g, c), dtype=torch.float32, device=dev)
                for _ in range(3)]
        err = lib.bt_bn_reduce(
            x.data_ptr(), dy.data_ptr(), BN_DTYPES[x.dtype], g, n, c, s,
            _strides(x), _strides(dy), vp, vs, part.data_ptr(),
            *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(dev).cuda_stream)
        _check(lib, err, f"{name}: launch failed")
    LAUNCHES[name] += 1
    return tuple(outs)


def launch_bn_dx(name: str, x, dy, mean, r, scale, mean_dxhat,
                 mean_dxhat_xhat):
    """Launch the dx pass of ``csrc/bn_backward.cu``: ``dx`` of ``x``'s
    shape, dtype and (dense) strides."""
    vp, vs = _bn_operands(name, x, dy, (mean, r, scale, mean_dxhat,
                                        mean_dxhat_xhat))
    g, n, c, s = x.shape
    lib = library()
    dev = x.device
    with _on_device(dev):
        dx = torch.empty_like(x)
        err = lib.bt_bn_dx(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), BN_DTYPES[x.dtype], g,
            n, c, s, _strides(x), _strides(dy), _strides(dx), vp, vs,
            torch.cuda.current_stream(dev).cuda_stream)
        _check(lib, err, f"{name}: launch failed")
    LAUNCHES[name] += 1
    return dx
