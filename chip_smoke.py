#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``blades_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases build,small   # a short compile-and-check

Phases, each printing its lines before the last:

1. ``build``: the card's name and power limit (``nvidia-smi``), then the
   CUDA kernels built from ``blades_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a`` into ``build/``.
2. ``small``: every kernel wrapper against its plain PyTorch version on a
   grid of forges x aggregators x storage types x sanitize, with a NaN row
   confined to one 512-column stripe, ``row_stats_bundle`` on a grid of
   dtypes x bundles x ragged shapes, and the BatchNorm-backward pair on a
   grid of f32/bf16 x four physical layouts (the folded and the grouped
   vmap layouts, each NCHW and channels-last) x ragged shapes; then a
   vmapped ResNet-10 client block over two local steps with every
   BN-backward launch audited against the plain version on its real
   strides (12 launches of each kernel per step); then small MLP rounds
   on the card against the same rounds on the CPU (Median, and each of
   the seven row-geometry aggregators under ALIE).
3. ``kernels``: each kernel against its plain version at the main path's
   shapes, with its time, the plain version's time and its bound; for
   ``row_stats_bundle`` the two bundles of the row-geometry round (the
   Multikrum Gram, the GeoMed weighted sum + Gram-vector product); for the
   BN pair the four stage layers of ResNet-10 at G = 50, B = 32, bf16,
   channels-last, beside ``native_batch_norm_backward``.
4. ``main``: the headline round -- ResNet-10, 1000 clients of CIFAR-10
   shapes, the first 250 running ALIE, exact coordinate-wise Median, bf16
   compute and storage, ``client_block=50``, ``malicious_prefix=250`` --
   one warm-up round and 3 timed rounds through the compact fused finish;
   180 launches of each BN kernel per round.
5. ``full``: one ResNet-10 round at 200 clients with no malicious prefix,
   through the full fused finish.
6. ``aggregators``: the ``Median`` and ``Trimmedmean`` aggregators on a
   ``(1000, 1 << 20)`` f32 matrix, through the column-select kernels.
7. ``rowgeom``: the row-geometry round -- the ``main`` configuration with
   ``Multikrum(num_byzantine=250)`` in place of Median, one warm-up and 2
   timed rounds, then one round of ``GeoMed()`` -- through the pass
   planner's ``row_stats_bundle`` calls; and the average-linkage
   clustering loop at 1000 clients, timed.
8. ``fedavg``: the Fedavg driver through ``FedavgConfig``: the dense
   ResNet-10 trial of ``fedavg_cifar10_resnet_noniid.yaml`` (60 clients,
   Dirichlet 0.1, 15 SignFlip then 15 LabelFlip, Median, f32, two local
   steps, 3 rounds and an evaluation), the 1000-client streamed trial of
   ``fedavg_cifar10_1000clients.yaml`` (ALIE, Median, bf16, 2 rounds and
   an evaluation), and the MLP accuracy check (test accuracy >= 0.9 after
   3 rounds); each prints rounds/s, losses, accuracy and peak memory.
9. ``profile`` (only when named): one more main-path round, and one
   Multikrum round of phase 7, under ``torch.profiler``; device time by
   kernel goes to ``chiprun_out/profile_main.txt`` and
   ``chiprun_out/profile_rowgeom.txt``.

Launch counts are set to 0 just before each of phases 4-8 (and before
each round of phase 7 and each trial of phase 8) and read just after; a
kernel of the phase that did not launch, or launched another number of
times than its path must, fails the run.  The last
three lines are the card (``nvidia-smi``), one JSON object with every
kernel's numbers, and ``{"ok": true, "device": ...}``.  Any failure exits
non-zero before those lines.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "small", "kernels", "main", "full", "aggregators",
          "rowgeom", "fedavg")
EXTRA_PHASES = ("profile",)  # run only when named

# H100 SXM peaks (NVIDIA's data sheet): device-memory rate, and the f32
# rate outside the tensor cores, which is where these kernels' arithmetic
# (sums, compares) runs.  A kernel's bound counts each input byte it must
# read once and each output byte once, and the operations the function
# needs per element (statistics, row norms, at least one compare per
# element for a selection).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12  # the Gram's bf16 products on the tensor cores

# Tolerances of a kernel against its plain version on the same inputs.
# Order statistics, counts and flags are exact.  Values computed from the
# benign mean/variance (the forged row and what the aggregate takes from
# it) are f32 sums in another order: rtol 1e-5 / atol 1e-6 under f32
# storage; under bf16 storage the forged row is rounded to bf16, so a
# last-ulp f32 difference can move it by one bf16 ulp (at most 2**-7 of
# it).  Row norms are f32 sums over up to 4.9M terms in another order:
# rtol 1e-4.  Trimmed means are f32 sums over the kept values in another
# order: rtol 1e-5, atol 1e-5 (inputs of unit scale).
RTOL, ATOL = 1e-5, 1e-6
SQ_RTOL = 1e-4
TRIM_TOL = 1e-5
# Row statistics (sums over up to 4.9M terms, the kernel's split and order
# against the plain chunk loop's): within 1e-4 of the magnitude of the
# summands, |X| in place of X.
ROW_RTOL = 1e-4

TIMED_ROUNDS = 3  # main-path rounds timed after one warm-up round
# BN-backward launches of each kernel per headline round: 750 trained
# clients / 50 per block x 12 BN layers x 1 local step.
BN_PER_ROUND = 15 * 12
ROWGEOM_ROUNDS = 2  # Multikrum rounds timed after one warm-up round
REPS = 5          # timed launches per kernel, after one warm-up launch


def log(msg: str) -> None:
    print(msg, flush=True)


class Failure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Comparisons
# --------------------------------------------------------------------------

def max_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = (a - b).abs().masked_fill(both_nan, 0.0)
    return float(d.max()) if d.numel() else 0.0


def same(a, b, what: str) -> float:
    import torch

    if not a.is_floating_point():
        ok = torch.equal(a, b)
    else:
        ok = torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.masked_fill(a.isnan(), 0), b.masked_fill(b.isnan(), 0))
    check(ok, f"{what}: not bit-exact (max err {max_err(a, b)})")
    return 0.0


def close(a, b, what: str, rtol=RTOL, atol=ATOL, forged=None,
          bf16=False) -> float:
    """``|a - b| <= atol + rtol |b|``; with ``forged`` under bf16 storage
    the slack grows by one bf16 ulp of the forged value, per column."""
    import torch

    a, b = a.double(), b.double()
    slack = atol + rtol * b.abs()
    if bf16 and forged is not None:
        slack = slack + 2.0 ** -7 * forged.double().abs() + 2.0 ** -6 * b.abs()
    bad = ~((a - b).abs() <= slack) & ~(a.isnan() & b.isnan())
    if bool(bad.any()):
        i = torch.nonzero(bad).flatten()[:5].tolist()
        raise Failure(f"{what}: {int(bad.sum())} values out of tolerance, "
                      f"e.g. at {i}: {a.flatten()[i].tolist()} vs "
                      f"{b.flatten()[i].tolist()}")
    return max_err(a, b)


def timed(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_build():
    from blades_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib = _cuda.build()
    _cuda.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = lib.parent / f"{lib.stem}.ptxas.txt"
    if ptxas.exists():
        # The whole report goes to chiprun_out/ptxas.txt; the log names the
        # kernel count and every kernel that spills.
        text = ptxas.read_text()
        out = os.path.join(HERE, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "ptxas.txt"), "w") as fh:
            fh.write(text)
        entry, kernels = None, 0
        for line in text.splitlines():
            if "entry function" in line:
                entry, kernels = line.split("'")[1], kernels + 1
            elif "spill" in line and not line.strip().startswith("0 bytes"):
                log(f"  ptxas: {entry}: {line.strip()}")
        log(f"  ptxas: {kernels} kernels (report in chiprun_out/ptxas.txt)")


def _small_matrix(gen, rows, d, dtype, poison):
    import torch

    x = torch.randn((rows, d), generator=gen, device="cuda") * 0.05
    if poison:
        x[2, 600] = float("nan")      # stripe 1 only
        x[5, 7] = float("inf")        # stripe 0 only
        x[rows - 1, d - 1] = -float("nan")  # the ragged last stripe
    return x.to(dtype).contiguous()


def phase_small():
    """Every wrapper against its plain version on small shapes."""
    import torch

    from blades_tpu_torch.ops import column_select as cs
    from blades_tpu_torch.ops import fused_finish as ff

    gen = torch.Generator(device="cuda").manual_seed(0)
    d = 3000  # six stripes, the last ragged
    forges = [None, ("alie", 0.7), ("ipm", 1.5), ("adaptive", 2.0)]
    aggs = [("mean",), ("median",), ("trimmed", 3)]
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for sanitize in (False, True):
            for rows in (37, 40):
                x = _small_matrix(gen, rows, d, dtype, sanitize)
                noise = torch.rand((d,), generator=gen, device="cuda")
                mal = torch.rand((rows,), generator=gen,
                                 device="cuda") < 0.3
                for forge in forges:
                    for agg in aggs:
                        tag = f"{dtype} rows={rows} san={sanitize} " \
                              f"forge={forge} agg={agg}"
                        nz = noise if forge and forge[0] == "adaptive" \
                            else None
                        got = ff.fused_finish(x, mal, nz, forge=forge,
                                              agg=agg, sanitize=sanitize)
                        want = ff.fused_finish_plain(
                            x, mal, nz, forge=forge, agg=agg,
                            sanitize=sanitize)
                        same(got[2], want[2], f"full bad {tag}")
                        fw = None
                        if forge is not None:
                            fw = ff.fused_finish_compact_plain(
                                x[~mal], nz, forged_mult=1, forge=forge,
                                agg=("mean",), sanitize=sanitize)[3]
                        if forge is None and agg[0] == "median":
                            same(got[0], want[0], f"full agg {tag}")
                        else:
                            close(got[0], want[0], f"full agg {tag}",
                                  forged=fw, bf16=bf16)
                        close(got[1], want[1], f"full sq {tag}",
                              rtol=SQ_RTOL, forged=None if fw is None
                              else fw.square().sum().reshape(1), bf16=bf16)
                        if forge is None:
                            cases += 1
                            continue
                        mult = 9
                        got = ff.fused_finish_compact(
                            x, nz, forged_mult=mult, forge=forge, agg=agg,
                            sanitize=sanitize)
                        want = ff.fused_finish_compact_plain(
                            x, nz, forged_mult=mult, forge=forge, agg=agg,
                            sanitize=sanitize)
                        same(got[2], want[2], f"compact bad {tag}")
                        close(got[3], want[3], f"compact forged {tag}",
                              forged=want[3], bf16=bf16)
                        close(got[0], want[0], f"compact agg {tag}",
                              forged=want[3], bf16=bf16)
                        close(got[1], want[1], f"compact sq {tag}",
                              rtol=SQ_RTOL)
                        cases += 2
    # Column selects: NaNs of both signs, ties across the cuts, odd/even n.
    for rows in (33, 34):
        x = torch.randn((rows, d), generator=gen, device="cuda")
        x = torch.round(x * 2) / 2  # long duplicate runs
        x[1, :40] = float("nan")
        x[3, 20:60] = -float("nan")
        x[4, 100:110] = float("inf")
        same(cs.column_median(x), cs.column_median_plain(x),
             f"column_median rows={rows}")
        close(cs.column_trimmed_mean(x, 5),
              cs.column_trimmed_mean_plain(x, 5),
              f"column_trimmed_mean rows={rows}", rtol=TRIM_TOL,
              atol=TRIM_TOL)
        cases += 2
    torch.cuda.synchronize()
    log(f"small: {cases} kernel-vs-plain cases agree")
    _small_rowstats(gen)
    _small_bn(gen)
    _small_bn_vmap()
    _small_round()


def _abs_scales(x, kw):
    """Per-entry magnitudes of each statistic's summands: the same bundle
    over |X|, |v|, |w|, |g|.  An f32 sum in another order differs by a
    small multiple of the rounding unit times these."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    akw = {k: v.abs() if torch.is_tensor(v) else v for k, v in kw.items()}
    return rs.row_stats_bundle_plain(x.abs(), **akw)


def rowstats_agree(got, want, x, kw, what, rtol=ROW_RTOL) -> float:
    """Kernel vs plain: sign counts and int8 self-contractions exact, every
    f32 sum within ``rtol`` of its summands' magnitude."""
    import torch

    check(set(got) == set(want), f"{what}: keys {sorted(got)} vs "
          f"{sorted(want)}")
    scales = None
    err = 0.0
    for k in want:
        a, b = got[k], want[k]
        check(a.shape == b.shape and a.dtype == torch.float32,
              f"{what} {k}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)}")
        if k == "signs" or (x.dtype == torch.int8 and k in ("sq", "gram")):
            same(a, b, f"{what} {k}")
            continue
        if scales is None:
            scales = _abs_scales(x, kw)
        diff = (a.double() - b.double()).abs()
        bad = ~(diff <= rtol * scales[k].double() + 1e-6)
        if bool(bad.any()):
            i = torch.nonzero(bad).flatten()[:4].tolist()
            raise Failure(f"{what} {k}: {int(bad.sum())} entries out of "
                          f"tolerance, e.g. {a.flatten()[i].tolist()} vs "
                          f"{b.flatten()[i].tolist()}")
        err = max(err, max_err(a, b))
    return err


ROWSTAT_BUNDLES = {
    "sq+gram+signs": dict(sq=True, gram=True, signs=True),
    "dots": dict(dots=True),
    "wsum": dict(weights=True),
    "gram_dot": dict(gram_dot=True),
    "all": dict(sq=True, gram=True, signs=True, dots=True, weights=True,
                gram_dot=True),
}


def _small_rowstats(gen):
    """``row_stats_bundle`` against its plain version: dtype x bundle x
    ragged rows, at an even and an odd width (the odd width loads element by
    element), plus one wide matrix that walks many slabs per CTA."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    cases = 0
    shapes = [(9, 1001), (77, 1001), (1000, 1000), (77, 300_002)]
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for rows, d in shapes:
            if dtype == torch.int8:
                x = torch.randint(-127, 128, (rows, d), generator=gen,
                                  device="cuda", dtype=torch.int8)
            else:
                x = torch.randn((rows, d), generator=gen,
                                device="cuda").to(dtype)
            x[:, ::5] = 0
            v = torch.randn((2, d), generator=gen, device="cuda")
            w = torch.rand((2, rows), generator=gen, device="cuda") + 0.1
            g = torch.rand((2, rows), generator=gen, device="cuda") + 0.1
            for bname, flags in ROWSTAT_BUNDLES.items():
                kw = dict(sq=flags.get("sq", False),
                          gram=flags.get("gram", False),
                          signs=flags.get("signs", False),
                          dots=v if flags.get("dots") else None,
                          weights=w if flags.get("weights") else None,
                          gram_dot=g if flags.get("gram_dot") else None)
                got = rs.row_stats_bundle(x, **kw)
                want = rs.row_stats_bundle_plain(x, **kw)
                rowstats_agree(got, want, x, kw,
                               f"row_stats_bundle {dtype} ({rows}, {d}) "
                               f"{bname}")
                cases += 1
    torch.cuda.synchronize()
    log(f"small: {cases} row_stats_bundle kernel-vs-plain cases agree "
        "(signs and int8 sq/gram exact)")


def _small_round():
    """Small MLP rounds (f32 compute and storage) on the card against the
    same rounds on the CPU: Median through both fused finishes, then each
    of the seven row-geometry aggregators under ALIE through the planner
    (GeoMed at ``maxiter=5``: its early stop compares f32 objectives
    exactly, which reassociation can move by an iteration).  DnC and
    FLTrust draw from each device's own generator, so for those two only
    finiteness and the planned traversals are compared."""
    import torch

    from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.parallel.streamed import streamed_step

    n, f, shape = 16, 4, (8, 8, 1)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((n, 8) + shape, generator=gen)
    y = torch.randint(0, 10, (n, 8), generator=gen)
    lengths = torch.full((n,), 8)
    idx = torch.randint(0, 8, (n, 1, 4), generator=gen)
    tx = torch.randn((16,) + shape, generator=gen)
    ty = torch.randint(0, 10, (16,), generator=gen)
    mal = make_malicious_mask(n, f)
    task = TaskSpec(model="mlp", input_shape=shape, lr=0.1).build()
    masks = tuple(torch.rand((n, 1, 4, w), generator=gen) >= 0.2
                  for w in task.model.dropout_widths)
    runs = [("Median", f), ("Median", None)] + [
        (name, f) for name in ("Multikrum", {"type": "GeoMed", "maxiter": 5},
                               "Signguard", "Centeredclipping",
                               "Clippedclustering", "DnC", "FLTrust")]
    for agg, prefix in runs:
        name = agg if isinstance(agg, str) else agg["type"]
        fr = FedRound(task=task,
                      server=Server.from_config(agg, num_byzantine=f, lr=0.5),
                      adversary=get_adversary("ALIE", num_clients=n,
                                              num_byzantine=f),
                      batch_size=4,
                      trusted_data=(tx, ty) if name == "FLTrust" else None)
        out = {}
        for dev in ("cpu", "cuda"):
            state = fr.init(0, n, device=dev)
            step = streamed_step(fr, client_block=4,
                                 update_dtype=torch.float32,
                                 malicious_prefix=prefix, device=dev)
            state, m = step(state, x.to(dev), y.to(dev), lengths, mal, 0,
                            batch_idx=idx, dropout_masks=masks)
            out[dev] = (state.server.params, m)
        for k, v in out["cuda"][0].items():
            check(bool(torch.isfinite(v).all()), f"small round {name} {k}")
            if name not in ("DnC", "FLTrust"):
                close(v.cpu(), out["cpu"][0][k], f"small round {name} "
                      f"param {k}", rtol=1e-4, atol=1e-5)
        keys = ("train_loss", "agg_norm", "update_norm_mean")
        if name in ("DnC", "FLTrust"):
            keys = ("train_loss",)
        for k in keys:
            close(out["cuda"][1][k].cpu().reshape(1),
                  out["cpu"][1][k].reshape(1), f"small round {name} {k}",
                  rtol=1e-4, atol=1e-5)
        for k in ("hbm_passes", "hbm_passes_unfused"):
            check(out["cuda"][1].get(k) == out["cpu"][1].get(k),
                  f"small round {name} {k}: {out['cuda'][1].get(k)} vs "
                  f"{out['cpu'][1].get(k)}")
    log("small: MLP rounds on the card match the CPU rounds (Median on "
        "the compact and full branches; GeoMed, DnC, Multikrum, "
        "Centeredclipping, Signguard, Clippedclustering, FLTrust under ALIE)")


# --------------------------------------------------------------------------
# The BatchNorm-backward pair
# --------------------------------------------------------------------------

BN_SRC = "blades_tpu_torch/csrc/bn_backward.cu"
BN_TPU = {"bn_bwd_reduce": "artifacts/perf_r4/time_bn_pallas.py:56",
          "bn_bwd_dx": "artifacts/perf_r4/time_bn_pallas.py:76"}
# The per-channel sums are f32 sums in another order than the plain
# version's: within 1e-5 of the sum of their terms' magnitudes.
BN_SUM_RTOL = 1e-5
# ResNet-10's four stages in the main round: (C, H = W), G = 50, B = 32.
BN_STAGES = ((64, 32), (128, 16), (256, 8), (512, 4))
BN_LAYOUTS = ("fold", "grouped", "fold-cl", "grouped-cl")


def _bn_operands(gen, layout, dtype, g, b, c, h, w, device="cuda"):
    """``x``, ``dy`` as the ``(G, B, C, S)`` views of one physical layout
    of a client block's activations -- ``fold``: (G*B, C, H, W) as
    functorch makes it while the parameters are unbatched; ``grouped``:
    (B, G*C, H, W), the grouped convolution's, once they are; ``-cl``:
    channels-last strides -- and per-(client, channel) ``mean``, ``r`` and
    ``scale`` values of the dtype."""
    import torch

    def phys():
        shape = (g * b, c, h, w) if layout.startswith("fold") else (b, g * c, h, w)
        t = (torch.randn(shape, generator=gen, device=device) * 1.5
             + 0.3).to(dtype)
        if layout.endswith("-cl"):
            t = t.contiguous(memory_format=torch.channels_last)
        if layout.startswith("fold"):
            return t.view(g, b, c, h * w)
        return t.view(b, g, c, h * w).transpose(0, 1)

    x, dy = phys(), phys()
    xf = x.float()
    mean = xf.mean((1, 3))
    var = (xf - mean[:, None, :, None]).square().mean((1, 3))
    r = torch.rsqrt(var + 1e-5)
    scale = 1.0 + 0.2 * torch.randn((g, c), generator=gen, device=device)
    return x, dy, mean.to(dtype), r.to(dtype), scale.to(dtype)


def _bn_coefs(sums, scale, n):
    """``mean_dxhat`` and ``mean_dxhat_xhat`` in the compute dtype, as
    ``BNApply.backward`` forms them from the sums."""
    _, s_scale, s_dxhat = sums
    dt = scale.dtype
    return s_dxhat.to(dt) / n, s_scale.to(dt) * scale / n


def _bn_sums_agree(got, want, x, dy, mean, r, scale, what):
    """The kernel's three sums against the plain version's: within
    ``BN_SUM_RTOL`` of the sums of their terms' magnitudes (the terms
    rounded as the plain version rounds them)."""
    import torch

    xhat = (x - mean[:, None, :, None]) * r[:, None, :, None]
    mags = (dy.float().abs().sum((1, 3)), (dy * xhat).float().abs().sum((1, 3)),
            (dy * scale[:, None, :, None]).float().abs().sum((1, 3)))
    err = 0.0
    for k, (a, b, m) in enumerate(zip(got, want, mags)):
        check(a.dtype == torch.float32 and a.shape == b.shape,
              f"{what}: sum {k} {a.dtype} {tuple(a.shape)}")
        bad = ~((a.double() - b.double()).abs() <= BN_SUM_RTOL * m.double())
        if bool(bad.any()):
            i = torch.nonzero(bad).flatten()[:4].tolist()
            raise Failure(f"{what}: sum {k}: {int(bad.sum())} out of "
                          f"tolerance, e.g. {a.flatten()[i].tolist()} vs "
                          f"{b.flatten()[i].tolist()}")
        err = max(err, max_err(a, b))
    return err


def _bn_agree(x, dy, mean, r, scale, what):
    """The kernel pair against the plain pair on the same operands: the
    sums by :func:`_bn_sums_agree`; dx, fed the same coefficients, bit for
    bit, in the layout of ``x``."""
    from blades_tpu_torch.ops import bn_backward as bn

    n = x.shape[1] * x.shape[3]
    want = bn.bn_bwd_reduce_plain(x, dy, mean, r, scale)
    err = _bn_sums_agree(bn.bn_bwd_reduce(x, dy, mean, r, scale), want, x,
                         dy, mean, r, scale, what)
    md, mdx = _bn_coefs(want, scale, n)
    dx = bn.bn_bwd_dx(x, dy, mean, r, scale, md, mdx)
    check(dx.stride() == x.stride() or not x.is_non_overlapping_and_dense(),
          f"{what}: dx strides {dx.stride()} vs x {x.stride()}")
    same(dx, bn.bn_bwd_dx_plain(x, dy, mean, r, scale, md, mdx), f"{what} dx")
    return err


def _small_bn(gen):
    """The BatchNorm-backward pair against its plain version: f32 and bf16
    x the four physical layouts x ragged shapes (a pair's elements in one
    or several splits with a ragged last one, odd spatial sizes, S = 1)."""
    import torch

    shapes = [(3, 5, 7, 5, 5), (2, 9, 4, 33, 33), (4, 16, 3, 1, 1),
              (50, 32, 8, 4, 4)]
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for layout in BN_LAYOUTS:
            for g, b, c, h, w in shapes:
                ops = _bn_operands(gen, layout, dtype, g, b, c, h, w)
                _bn_agree(*ops, f"bn pair {dtype} {layout} "
                          f"{(g, b, c, h, w)}")
                cases += 1
    torch.cuda.synchronize()
    log(f"small: {cases} BatchNorm-backward kernel-vs-plain cases agree "
        "(dx bit-exact, sums within f32 reassociation)")


class _BnAudit:
    """Wraps the two launchers while a vmapped block trains on the card:
    every launch is also computed by the plain version on the same
    physical operands (the layouts functorch and cuDNN really hand over)
    and held to :func:`_bn_agree`'s tolerances; the strides seen are
    kept."""

    def __init__(self):
        from blades_tpu_torch.ops import _cuda

        self._cuda = _cuda
        self.layouts = set()
        self.err = 0.0
        self.calls = 0

    def __enter__(self):
        from blades_tpu_torch.ops import bn_backward as bn

        cu = self._cuda
        self._saved = cu.launch_bn_reduce, cu.launch_bn_dx
        red, dxl = self._saved

        def reduce(name, x, dy, mean, r, scale):
            out = red(name, x, dy, mean, r, scale)
            self.layouts.add((x.dtype, tuple(x.shape), x.stride()))
            self.err = max(self.err, _bn_sums_agree(
                out, bn.bn_bwd_reduce_plain(x, dy, mean, r, scale), x, dy,
                mean, r, scale, f"audit {tuple(x.shape)} {x.stride()}"))
            self.calls += 1
            return out

        def dx(name, x, dy, *vecs):
            out = dxl(name, x, dy, *vecs)
            same(out, bn.bn_bwd_dx_plain(x, dy, *vecs),
                 f"audit dx {tuple(x.shape)} {x.stride()}")
            self.calls += 1
            return out

        cu.launch_bn_reduce, cu.launch_bn_dx = reduce, dx
        return self

    def __exit__(self, *exc):
        self._cuda.launch_bn_reduce, self._cuda.launch_bn_dx = self._saved


def _small_bn_vmap():
    """Two local steps of a small ResNet-10 client block on the card --
    step 0 with unbatched parameters, step 1 with batched ones, so both
    physical layouts reach the ops through their vmap rule.  Every launch
    is audited against the plain version on its own operands; each BN
    layer must launch each kernel exactly once per step (a per-client loop
    would launch G times); the updates are compared with the same block
    with the plain ops in the kernels' place (on the card, cuDNN set
    deterministic) and with the CPU's."""
    import torch

    from blades_tpu_torch.core import TaskSpec
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import bn_backward as bn

    g, nb, b = 3, 2, 8
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((g, nb, b, 32, 32, 3), generator=gen)
    y = torch.randint(0, 10, (g, nb, b), generator=gen)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for cd in ("float32", "bfloat16"):
            task = TaskSpec(model="resnet", input_shape=(32, 32, 3), lr=0.1,
                            compute_dtype=cd).build()
            params = task.init_params(torch.Generator().manual_seed(0))
            out = {}
            for run in ("cuda", "cuda-plain", "cpu"):
                dev = run.split("-")[0]
                saved = bn._bn_bwd_impl
                if run.endswith("plain"):
                    bn._bn_bwd_impl = bn.bn_bwd_plain
                try:
                    _cuda.reset_launches()
                    p = {k: v.to(dev) for k, v in params.items()}
                    if run == "cuda":
                        with _BnAudit() as audit:
                            upd, _, _ = task.local_round_batched(
                                p, x.to(dev), y.to(dev))
                            torch.cuda.synchronize()
                    else:
                        upd, _, _ = task.local_round_batched(
                            p, x.to(dev), y.to(dev))
                finally:
                    bn._bn_bwd_impl = saved
                out[run] = (upd.cpu(), dict(_cuda.LAUNCHES))
            want = {"bn_bwd_reduce": 12 * nb, "bn_bwd_dx": 12 * nb}
            check(out["cuda"][1] == want, f"bn vmap {cd}: launches "
                  f"{out['cuda'][1]}, expected {want} (one per BN layer and "
                  "step)")
            check(out["cpu"][1] == {} and out["cuda-plain"][1] == {},
                  "bn vmap: a plain path launched kernels")
            check(audit.calls == 2 * 12 * nb, f"bn vmap {cd}: audited "
                  f"{audit.calls} launches")
            a = out["cuda"][0]
            check(bool(torch.isfinite(a).all()), f"bn vmap {cd}: non-finite")
            rel = {ref: float((a - out[ref][0]).norm() / out[ref][0].norm())
                   for ref in ("cuda-plain", "cpu")}
            # Two SGD steps of a freshly initialised ResNet amplify sums
            # taken in another order (f32 about 1e-3 of the update's norm
            # measured on the card, bf16 about 6e-2): a loose sanity guard
            # only; the per-launch audit is the check.
            check(rel["cuda-plain"] < 0.25, f"bn vmap {cd}: updates differ "
                  f"from the plain ops' by {rel['cuda-plain']:.3g}")
            strides = sorted({(s[2], s[1]) for s in audit.layouts})
            log(f"small: ResNet-10 block (G={g}, 2 local steps, {cd}) on the "
                f"card: 12 launches of each BN kernel per step, all "
                f"{audit.calls} audited against the plain version (dx "
                f"bit-exact, sums max err {audit.err:.3g}); updates differ "
                f"from the plain ops' on the card by {rel['cuda-plain']:.3g} "
                f"and from the CPU's by {rel['cpu']:.3g} of their norm; "
                f"(G, N, C, S) strides seen: {strides}")
    finally:
        torch.backends.cudnn.deterministic = det


def _bn_records(gen):
    """The BN pair at the main round's four stage shapes (G = 50, B = 32,
    bf16, the one-step layout (G*B, C, H, W) channels-last, as cuDNN hands
    bf16 activations over): time, plain time, the library's one-call
    backward on the channels-last (B, G*C, H, W) view, and the bound.  The
    records hold the sums over the four stages (one BN layer each); the
    kernels' time in the NCHW layout is logged beside them."""
    import torch

    from blades_tpu_torch.ops import bn_backward as bn

    g, b = 50, 32
    tot = {k: dict(ms=0.0, plain=0.0, lib=0.0, bytes=0.0, ops=0.0, err=0.0)
           for k in ("bn_bwd_reduce", "bn_bwd_dx")}
    lib_ok = True
    for c, hw in BN_STAGES:
        x, dy, mean, r, scale = _bn_operands(gen, "fold-cl", torch.bfloat16,
                                             g, b, c, hw, hw)
        n = b * hw * hw
        elems = g * n * c
        err = _bn_agree(x, dy, mean, r, scale, f"bn stage C={c}")
        sums = bn.bn_bwd_reduce(x, dy, mean, r, scale)
        md, mdx = _bn_coefs(sums, scale, n)
        t_red = timed(lambda: bn.bn_bwd_reduce(x, dy, mean, r, scale), REPS)
        t_dx = timed(lambda: bn.bn_bwd_dx(x, dy, mean, r, scale, md, mdx),
                     REPS)
        p_red = timed(lambda: bn.bn_bwd_reduce_plain(x, dy, mean, r, scale),
                      REPS)
        p_dx = timed(lambda: bn.bn_bwd_dx_plain(x, dy, mean, r, scale, md,
                                                mdx), REPS)
        # One PyTorch call computing the same backward: the library's
        # batch-norm backward on the grouped view, saved mean / invstd in
        # f32 (its own layout: the operands copied once, untimed).
        cl = torch.channels_last
        xg = x.transpose(0, 1).reshape(b, g * c, hw, hw).contiguous(
            memory_format=cl)
        dyg = dy.transpose(0, 1).reshape(b, g * c, hw, hw).contiguous(
            memory_format=cl)
        sm, si = mean.float().flatten(), r.float().flatten()
        wt = scale.flatten()
        l_red = l_dx = 0.0
        if lib_ok:
            try:
                def lib(mask):
                    return torch.ops.aten.native_batch_norm_backward(
                        dyg, xg, wt, None, None, sm, si, True, 1e-5, mask)
                l_red = timed(lambda: lib([False, True, True]), REPS)
                l_dx = timed(lambda: lib([True, True, True]), REPS)
            except (RuntimeError, TypeError) as e:
                lib_ok = False
                log(f"kernel bn: library_ms null: native_batch_norm_backward "
                    f"refused the operands ({type(e).__name__}: {e})")
        del xg, dyg
        # The same operands in NCHW strides (the spatial-inner thread map).
        xn, dyn = (t.contiguous() for t in (x, dy))
        n_red = timed(lambda: bn.bn_bwd_reduce(xn, dyn, mean, r, scale), REPS)
        n_dx = timed(lambda: bn.bn_bwd_dx(xn, dyn, mean, r, scale, md, mdx),
                     REPS)
        del xn, dyn
        log(f"kernel bn stage C={c} {hw}x{hw} (NCHW): reduce {n_red:.3f} ms, "
            f"dx {n_dx:.3f} ms")
        log(f"kernel bn stage C={c} {hw}x{hw}: reduce {t_red:.3f} ms (plain "
            f"{p_red:.3f}, library {l_red:.3f}, bound "
            f"{elems * 4 / HBM_BYTES_PER_S * 1e3:.3f}); dx {t_dx:.3f} ms "
            f"(plain {p_dx:.3f}, library full backward {l_dx:.3f}, bound "
            f"{elems * 6 / HBM_BYTES_PER_S * 1e3:.3f})")
        # Reduce: read x and dy (2 B each), write 3 (G, C) f32 sums; per
        # element a subtract, 3 multiplies, 3 adds.  dx: read x and dy,
        # write dx; a subtract, 4 multiplies, 2 subtracts.
        for k, t, pt, lt, nbytes, ops in (
                ("bn_bwd_reduce", t_red, p_red, l_red,
                 elems * 4 + 3 * g * c * 4, 7 * elems),
                ("bn_bwd_dx", t_dx, p_dx, l_dx, elems * 6 + 5 * g * c * 4,
                 7 * elems)):
            a = tot[k]
            a["ms"] += t
            a["plain"] += pt
            a["lib"] += lt
            a["bytes"] += nbytes
            a["ops"] += ops
            a["err"] = max(a["err"], err if k == "bn_bwd_reduce" else 0.0)
        del x, dy
        torch.cuda.empty_cache()
    return {k: _record(k, BN_SRC, BN_TPU[k], a["ms"], a["plain"], a["bytes"],
                       a["ops"], a["err"], a["lib"] if lib_ok else None)
            for k, a in tot.items()}


def _record(name, source, replaces, ms, plain_ms, bytes_moved, ops, err,
            library_ms=None, ops_per_s=F32_OPS_PER_S):
    """One kernel's line.  ``library_ms`` is the time of one PyTorch call
    computing the same function on the same inputs, or null where there
    is none (no call forges or sanitizes, and ``torch.median`` returns the
    lower middle value)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


SRC = "blades_tpu_torch/csrc/fused_finish.cu"


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from blades_tpu_torch.adversaries import ALIEAdversary
    from blades_tpu_torch.ops import column_select as cs
    from blades_tpu_torch.ops import fused_finish as ff

    d = 4_903_242
    z = ALIEAdversary(num_clients=1000, num_byzantine=250).z_max
    forge, agg = ("alie", z), ("median",)
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = {}

    # 1. The compact finish over the benign rows, as the main path calls it.
    x = (torch.randn((750, d), generator=gen, device="cuda") * 1e-3).to(
        torch.bfloat16)
    got = ff.fused_finish_compact(x, forged_mult=250, forge=forge, agg=agg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ff.fused_finish_compact_plain(x, forged_mult=250, forge=forge,
                                         agg=agg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same(got[2], want[2], "compact bad (main shape)")
    close(got[3], want[3], "compact forged (main shape)", forged=want[3],
          bf16=True)
    err = close(got[0], want[0], "compact agg (main shape)",
                forged=want[3], bf16=True)
    close(got[1], want[1], "compact sq (main shape)", rtol=SQ_RTOL)
    ms = timed(lambda: ff.fused_finish_compact(
        x, forged_mult=250, forge=forge, agg=agg), REPS)
    nbytes = 750 * d * 2 + 2 * d * 4 + 750 * 5
    # Per element: mean 1, variance 3, row norm 2, selection 1.
    records["fused_finish_compact"] = _record(
        "fused_finish_compact", SRC, "blades_tpu/ops/pallas_round.py:502",
        ms, plain_ms, nbytes, 7 * 750 * d, err)
    del x, got, want

    # 2. The full finish over all 1000 rows, the first 250 forged.
    x = (torch.randn((1000, d), generator=gen, device="cuda") * 1e-3).to(
        torch.bfloat16)
    mal = torch.arange(1000, device="cuda") < 250
    got = ff.fused_finish(x, mal, forge=forge, agg=agg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ff.fused_finish_plain(x, mal, forge=forge, agg=agg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    fw = ff.fused_finish_compact_plain(x[250:], forged_mult=250,
                                       forge=forge, agg=agg)[3]
    same(got[2], want[2], "full bad (main shape)")
    err = close(got[0], want[0], "full agg (main shape)", forged=fw,
                bf16=True)
    close(got[1], want[1], "full sq (main shape)", rtol=SQ_RTOL,
          forged=fw.square().sum().reshape(1), bf16=True)
    ms = timed(lambda: ff.fused_finish(x, mal, forge=forge, agg=agg), REPS)
    # The forged rows replace the malicious ones, so the function reads
    # only the 750 benign rows (and the mask).
    nbytes = 750 * d * 2 + 1000 + d * 4 + 1000 * 5
    records["fused_finish"] = _record(
        "fused_finish", SRC, "blades_tpu/ops/pallas_round.py:628", ms,
        plain_ms, nbytes, 7 * 750 * d, err)
    del x, got, want, fw

    # 3-4. The column selects on a (1000, 1 << 20) f32 matrix.
    x = torch.randn((1000, 1 << 20), generator=gen, device="cuda")
    nbytes = 1000 * (1 << 20) * 4 + (1 << 20) * 4
    # Per element: one compare for the median, a compare and an add for
    # the trimmed mean.
    for name, fn, plain, replaces, per_elem in (
            ("column_median", cs.column_median, cs.column_median_plain,
             "blades_tpu/ops/pallas_select.py:206", 1),
            ("column_trimmed_mean", lambda a: cs.column_trimmed_mean(a, 250),
             lambda a: cs.column_trimmed_mean_plain(a, 250),
             "blades_tpu/ops/pallas_select.py:220", 2)):
        got = fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if name == "column_median":
            err = same(got, want, f"{name} (main shape)")
        else:
            err = close(got, want, f"{name} (main shape)", rtol=TRIM_TOL,
                        atol=TRIM_TOL)
        ms = timed(lambda: fn(x), REPS)
        lib_ms = None
        if name == "column_median":
            # On NaN-free columns the midpoint median is the 0.5 quantile
            # with linear interpolation: one PyTorch call, the yardstick.
            lib_ms = timed(lambda: torch.quantile(x, 0.5, dim=0), REPS)
        records[name] = _record(name, SRC, replaces, ms, plain_ms, nbytes,
                                per_elem * 1000 * (1 << 20), err, lib_ms)
    del x
    torch.cuda.empty_cache()
    records.update(_bundle_records(gen, d))
    records.update(_bn_records(gen))
    for r in records.values():
        lib = r["library_ms"]
        log(f"kernel {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.1f}"
            f" ms, bound {r['bound_ms']:.3f} ms, library "
            f"{'none' if lib is None else f'{lib:.3f} ms'}), max_abs_err "
            f"{r['max_abs_err']:.3g} vs plain")
    return records


ROWSTATS_SRC = "blades_tpu_torch/csrc/rowstats.cu"
ROWSTATS_TPU = "blades_tpu/ops/pallas_rowstats.py:167"
GRAM_RECORD = "row_stats_bundle:gram"
GEOMED_RECORD = "row_stats_bundle:wsum+gram_dot"


def _bundle_records(gen, d):
    """``row_stats_bundle`` at the row-geometry round's shape, (1000, d)
    bf16: Multikrum's Gram bundle (its norms come from the round's in-place
    pass) and GeoMed's weighted sum + Gram-vector product."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    n = 1000
    x = (torch.randn((n, d), generator=gen, device="cuda") * 1e-3).to(
        torch.bfloat16)
    w = torch.full((1, n), 1.0 / n, device="cuda")
    records = {}
    for name, kw in ((GRAM_RECORD, dict(gram=True)),
                     (GEOMED_RECORD, dict(weights=w, gram_dot=w))):
        got = rs.row_stats_bundle(x, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rs.row_stats_bundle_plain(x, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = rowstats_agree(got, want, x, kw, f"{name} (main shape)")
        del got, want
        ms = timed(lambda: rs.row_stats_bundle(x, **kw), REPS)
        lib_ms = None
        if name == GRAM_RECORD:
            # X X^T of bf16 rows with f32 output, where torch takes out_dtype.
            try:
                torch.mm(x[:2, :8], x[:2, :8].t(), out_dtype=torch.float32)
            except (TypeError, RuntimeError) as e:
                log(f"kernel {name}: library_ms null: torch.mm takes no "
                    f"out_dtype here ({type(e).__name__}: {e})")
            else:
                lib_ms = timed(lambda: torch.mm(x, x.t(),
                                                out_dtype=torch.float32), REPS)
            records[name] = _record(
                name, ROWSTATS_SRC, ROWSTATS_TPU, ms, plain_ms,
                n * d * 2 + n * n * 4, n * (n + 1) // 2 * d * 2, err, lib_ms,
                ops_per_s=BF16_TENSOR_OPS_PER_S)
        else:
            log(f"kernel {name}: library_ms null: no one PyTorch call "
                "computes a weighted row sum and a Gram-vector product")
            # w^T X (2nd), t = g^T X (2nd), X t (2nd), on the f32 cores.
            records[name] = _record(
                name, ROWSTATS_SRC, ROWSTATS_TPU, ms, plain_ms,
                n * d * 2 + d * 4 + 3 * n * 4, 6 * n * d, err, lib_ms)
    del x
    torch.cuda.empty_cache()
    return records


def _headline_round(n, f, prefix, rounds, block=50, hw=32, device=None,
                    profile_to=None, aggregator="Median"):
    """Build the headline configuration at ``n`` clients (with
    ``aggregator`` in place of Median) and run ``rounds`` rounds; return
    the per-round losses, seconds, last metrics and the step.
    ``block``, ``hw`` and ``device`` shrink it for a rehearsal.  With
    ``profile_to`` (a directory) the last round runs under
    ``torch.profiler`` and its kernel table is written there."""
    import torch

    from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.parallel.streamed import streamed_step

    shard, batch = 32, 32
    dev = device or "cuda"
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    fr = FedRound(
        task=TaskSpec(model="resnet", input_shape=(hw, hw, 3),
                      num_classes=10, lr=0.1,
                      compute_dtype="bfloat16").build(),
        server=Server.from_config(aggregator, num_byzantine=f, lr=0.5),
        adversary=get_adversary("ALIE", num_clients=n, num_byzantine=f),
        batch_size=batch, num_batches_per_round=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, shard, hw, hw, 3), generator=gen, device=dev)
    y = torch.randint(0, 10, (n, shard), generator=gen, device=dev)
    lengths = torch.full((n,), shard, device=dev)
    mal = make_malicious_mask(n, f, device=dev)
    state = fr.init(0, n, device=device)
    step = streamed_step(fr, client_block=block, malicious_prefix=prefix,
                         device=device)
    losses, secs = [], []
    for r in range(rounds):
        prof = None
        if profile_to and r == rounds - 1:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        sync()
        t0 = time.perf_counter()
        state, m = step(state, x, y, lengths, mal, r)
        sync()
        secs.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            _write_profile(prof, secs[-1], profile_to,
                           "main" if aggregator == "Median" else "rowgeom")
        losses.append(float(m["train_loss"]))
        check(math.isfinite(losses[-1]), f"round {r}: loss {losses[-1]}")
        check(math.isfinite(float(m["agg_norm"])),
              f"round {r}: agg_norm {float(m['agg_norm'])}")
    for k, v in state.server.params.items():
        check(bool(torch.isfinite(v).all()), f"non-finite parameter {k}")
    return losses, secs, m, step


def _write_profile(prof, wall_s, out_dir, tag):
    """Device time by kernel over one profiled round: the table goes to
    ``out_dir/profile_<tag>.txt``; the device's busy share and the time by
    kind of kernel are printed."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.key_averages():
        # Device-side events only (kernels, memcpy, memset): the host ops
        # that launched them carry the same time again.
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            events.append((us, e.count, e.key))
    events.sort(reverse=True)
    kernel_us = sum(us for us, _, _ in events)
    # Busy time: the union of the device events' intervals (events on
    # different streams may overlap, so the sum can exceed the wall).
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, cur_start, cur_end = 0.0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    kinds = {}
    for us, _, key in events:
        k = key.lower()
        if "rowstats" in k or "gram_" in k:
            kind = "row statistics"
        elif "bn_reduce" in k or "bn_dx" in k:
            kind = "bn backward"
        elif "finish_kernel" in k or "finalize_kernel" in k:
            kind = "fused finish"
        elif any(w in k for w in ("conv", "cudnn", "xmma", "gemm", "cutlass",
                                  "wgrad", "dgrad", "sm90")):
            kind = "convolution / matmul"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + us
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{tag}.txt")
    with open(path, "w") as fh:
        fh.write(f"round wall {wall_s * 1e3:.1f} ms under the profiler, "
                 f"device busy {busy_us / 1e3:.1f} ms, kernel time summed "
                 f"{kernel_us / 1e3:.1f} ms\n")
        for us, count, key in events:
            fh.write(f"{us / 1e3:10.3f} ms {count:7d}x  {key}\n")
    log(f"profile {tag}: round {wall_s * 1e3:.1f} ms under the profiler, device "
        f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}"
        f"% of the wall), kernel time summed {kernel_us / 1e3:.1f} ms; by "
        f"kind: " + ", ".join(
            f"{k} {v / 1e3:.1f} ms" for k, v in sorted(
                kinds.items(), key=lambda kv: -kv[1])))
    for us, count, key in events[:8]:
        log(f"profile {tag}:   {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    log(f"profile {tag}: table in {path}")


def phase_profile(out_dir: str):
    """One warm-up and one profiled round of the main path, then of the
    row-geometry round (Multikrum)."""
    _headline_round(1000, 250, 250, 2, profile_to=out_dir)
    _headline_round(1000, 250, 250, 2, profile_to=out_dir,
                    aggregator={"type": "Multikrum", "num_byzantine": 250})


def phase_main():
    import torch

    from blades_tpu_torch.ops import _cuda

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    losses, secs, m, _ = _headline_round(1000, 250, 250, 1 + TIMED_ROUNDS)
    counts = dict(_cuda.LAUNCHES)
    rounds = 1 + TIMED_ROUNDS
    want = {"fused_finish_compact": rounds,
            **{k: BN_PER_ROUND * rounds for k in BN_TPU}}
    check(counts == want, f"main: launches {counts} over {rounds} rounds, "
          f"expected {want}")
    check(int(m["elided_lanes"]) == 250, "main: elision did not engage")
    rps = TIMED_ROUNDS / sum(secs[1:])
    log(f"main: ResNet-10 x 1000 clients (250 ALIE), Median, bf16; "
        f"{TIMED_ROUNDS} timed rounds at {rps:.4f} rounds/s "
        f"(round seconds {[round(s, 3) for s in secs]}, first is warm-up)")
    log(f"main: train_loss per round {losses}; compact finish launches "
        f"{counts['fused_finish_compact']}, BN backward launches "
        f"{counts['bn_bwd_reduce']} + {counts['bn_bwd_dx']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, rps


def phase_full():
    from blades_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    losses, secs, m, _ = _headline_round(200, 50, None, 1)
    counts = dict(_cuda.LAUNCHES)
    # 200 clients, none elided: 4 blocks of 50, 12 BN layers each.
    want = {"fused_finish": 1, **{k: 4 * 12 for k in BN_TPU}}
    check(counts == want, f"full: launches {counts}, expected {want}")
    check("elided_lanes" not in m, "full: elision engaged without a prefix")
    log(f"full: ResNet-10 x 200 clients, no prefix: loss {losses[0]}, "
        f"{secs[0]:.3f} s, full finish launches {counts['fused_finish']}")
    return {"fused_finish": counts["fused_finish"]}


def phase_aggregators():
    """The dense aggregator path: ``Median`` and ``Trimmedmean`` on a CUDA
    update matrix go through the column-select kernels."""
    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops.aggregators import get_aggregator

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((1000, 1 << 20), generator=gen, device="cuda")
    _cuda.reset_launches()
    med, _ = get_aggregator("Median")(x)
    tm, _ = get_aggregator("Trimmedmean", num_byzantine=250)(x)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    check(counts == {"column_median": 1, "column_trimmed_mean": 1},
          f"aggregators: launches {counts}")
    check(bool(torch.isfinite(med).all() and torch.isfinite(tm).all()),
          "aggregators: non-finite aggregate")
    log(f"aggregators: Median and Trimmedmean launches {counts}")
    return counts


def phase_rowgeom():
    """The row-geometry round at 1000 clients: Multikrum (1 warm-up + 2
    timed rounds), then one GeoMed round.  Each bundle of the planner's is
    one ``row_stats_bundle`` launch: Multikrum's Gram and its weighted sum
    per round; GeoMed's first bundle and one per Weiszfeld iteration."""
    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops.clustering import agglomerative_majority

    counts = {}
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    rounds = 1 + ROWGEOM_ROUNDS
    losses, secs, m, step = _headline_round(
        1000, 250, 250, rounds,
        aggregator={"type": "Multikrum", "num_byzantine": 250})
    launches = dict(_cuda.LAUNCHES)
    check(step.passes.kernel_bundles == 2,
          f"rowgeom: Multikrum served {step.passes.kernel_bundles} bundles "
          "by the kernel, expected 2 (Gram, weighted sum)")
    want = {"row_stats_bundle": 2 * rounds,
            **{k: BN_PER_ROUND * rounds for k in BN_TPU}}
    check(launches == want, f"rowgeom: Multikrum launches {launches} over "
          f"{rounds} rounds, expected {want}")
    # As the CPU tests pin against the JAX round: the in-place pass, the
    # Gram bundle, the weighted-sum bundle.
    check(int(m["hbm_passes"]) == 3 and int(m["hbm_passes_unfused"]) == 3,
          f"rowgeom: hbm_passes {m['hbm_passes']} / "
          f"{m['hbm_passes_unfused']}, expected 3 / 3")
    check(int(m["elided_lanes"]) == 250, "rowgeom: elision did not engage")
    counts[GRAM_RECORD] = launches["row_stats_bundle"]
    rps = ROWGEOM_ROUNDS / sum(secs[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"rowgeom: Multikrum(250), ALIE, bf16, 1000 clients: "
        f"{ROWGEOM_ROUNDS} timed rounds at {rps:.4f} rounds/s (round "
        f"seconds {[round(t, 3) for t in secs]}, first is warm-up); "
        f"train_loss {losses}; row_stats_bundle launches "
        f"{launches['row_stats_bundle']} ({step.passes.kernel_bundles} per "
        f"round), BN backward launches {launches['bn_bwd_reduce']} + "
        f"{launches['bn_bwd_dx']}; hbm_passes {int(m['hbm_passes'])}; peak "
        "memory "
        f"{peak:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    losses, secs, m, step = _headline_round(1000, 250, 250, 1,
                                            aggregator="GeoMed")
    launches = dict(_cuda.LAUNCHES)
    iters = step.passes.loop_iters
    want = {"row_stats_bundle": 1 + iters,
            **{k: BN_PER_ROUND for k in BN_TPU}}
    check(launches == want, f"rowgeom: GeoMed launches {launches}, expected "
          f"{want} (1 + {iters} Weiszfeld iterations)")
    check(int(m["hbm_passes"]) == 102 and int(m["hbm_passes_unfused"]) == 203,
          f"rowgeom: GeoMed hbm_passes {m['hbm_passes']} / "
          f"{m['hbm_passes_unfused']}, expected 102 / 203")
    counts[GEOMED_RECORD] = launches["row_stats_bundle"]
    log(f"rowgeom: GeoMed, ALIE, bf16, 1000 clients: one round "
        f"{secs[0]:.3f} s ({1 / secs[0]:.4f} rounds/s), {iters} Weiszfeld "
        f"iterations, row_stats_bundle launches "
        f"{launches['row_stats_bundle']}; train_loss {losses}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The exact average-linkage loop (Clippedclustering) at 1000 clients:
    # n - 2 sequential steps in eager torch, not a kernel.
    gen = torch.Generator(device="cuda").manual_seed(4)
    u = torch.randn((1000, 64), generator=gen, device="cuda")
    u = u / (u * u).sum(1, keepdim=True).sqrt()
    dist = 1.0 - (u @ u.T).clamp(-1.0, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maj = agglomerative_majority(dist, linkage="average")
    torch.cuda.synchronize()
    log(f"rowgeom: average-linkage clustering at 1000 clients "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (majority "
        f"{int(maj.sum())})")
    return counts


# The fedavg phase's trials: the reference's configuration files at one
# point each, through FedavgConfig / Fedavg.train() / Fedavg.evaluate().
# From blades_tpu/tuned_examples/fedavg_cifar10_resnet_noniid.yaml, with
# num_batch_per_round 2 (so the second local step's grouped-convolution
# layout runs at full width) and 3 rounds then one evaluation.
DENSE_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": 60, "iid": False,
                       "alpha": 0.1, "train_bs": 64},
    "global_model": "resnet10",
    "client_config": {"lr": 1.0, "num_batch_per_round": 2},
    "server_config": {"lr": 0.1, "aggregator": {"type": "Median"},
                      "lr_schedule": [[0, 0.1], [1500, 0.1], [2000, 0.01]]},
    "num_malicious_clients": 15,
    "evaluation_interval": 3,
}
# From blades_tpu/tuned_examples/fedavg_cifar10_1000clients.yaml at its
# Median point: 2 rounds, one evaluation on 10 test rows per client.
STREAMED_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": 1000, "iid": False,
                       "alpha": 0.1, "train_bs": 32, "seed": 122},
    "global_model": "resnet10", "compute_dtype": "bfloat16",
    "execution": "streamed", "client_block": 25, "d_chunk": 131072,
    "update_dtype": "bfloat16", "health_check": True,
    "num_malicious_clients": 250, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.1, "num_batch_per_round": 1},
    "evaluation_interval": 2, "evaluation_num_samples": 10,
}
# The verification flow of .claude/skills/verify/SKILL.md: synthetic MNIST,
# MLP, 6 clients, 2 running ALIE, Median, 3 rounds.
MLP_TRIAL = {
    "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 8},
    "global_model": "mlp", "evaluation_interval": 3,
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
}
MLP_MIN_ACC = 0.9


def _fedavg_trial(name, overrides, rounds):
    """Build the driver from ``overrides``, run ``rounds`` rounds (the last
    one evaluates), print rounds/s, losses, accuracy and peak memory, and
    return the last row."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algo = FedavgConfig().update_from_dict(overrides).build()
    setup_s = time.perf_counter() - t0
    rows, secs = [], []
    try:
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows.append(algo.train())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        streamed = algo.streamed
    finally:
        algo.stop()
    last = rows[-1]
    losses = [r["train_loss"] for r in rows]
    check(all(math.isfinite(v) for v in losses),
          f"fedavg {name}: train losses {losses}")
    for k in ("test_loss", "test_acc", "test_acc_top3"):
        check(k in last and math.isfinite(last[k]),
              f"fedavg {name}: no finite {k} in the last row {sorted(last)}")
    # The last round includes the evaluation; rounds/s counts the rounds
    # before it, after the first (warm-up).
    train_s = [r["timers"]["training_step"]["total_s"] for r in rows[-1:]][0]
    rps = ((rounds - 1) / (train_s - rows[0]["timers"]["training_step"]
                           ["total_s"]) if rounds > 1 else float("nan"))
    log(f"fedavg {name}: {'streamed' if streamed else 'dense'} round, setup "
        f"{setup_s:.1f} s, {rps:.4f} rounds/s over rounds 2-{rounds} "
        f"(wall per train() incl. evaluation {[round(t, 3) for t in secs]}); "
        f"train_loss {losses}; test_loss {last['test_loss']:.4f}, test_acc "
        f"{last['test_acc']:.4f}, top-3 {last['test_acc_top3']:.4f}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return last, streamed


def phase_fedavg():
    """The Fedavg driver on the card: the dense ResNet-10 trial under
    SignFlip and under LabelFlip, the 1000-client streamed trial, and the
    MLP accuracy check."""
    from blades_tpu_torch.ops import _cuda

    for adv in ("SignFlip", "LabelFlip"):
        _cuda.reset_launches()
        _, streamed = _fedavg_trial(
            f"ResNet-10 x 60 {adv} Median f32",
            {**DENSE_TRIAL, "adversary_config": {"type": adv}}, 3)
        counts = dict(_cuda.LAUNCHES)
        # 60 clients in blocks of 50 and 10, 12 BN layers, 2 local steps,
        # 3 rounds; the dense Median goes through the column select.
        want = {"column_median": 3,
                **{k: 3 * 2 * 2 * 12 for k in BN_TPU}}
        check(not streamed and counts == want,
              f"fedavg {adv}: launches {counts}, expected {want} on the "
              "dense round")
    _cuda.reset_launches()
    _, streamed = _fedavg_trial("ResNet-10 x 1000 ALIE Median bf16",
                                STREAMED_TRIAL, 2)
    counts = dict(_cuda.LAUNCHES)
    # 750 trained clients in blocks of 25, 12 BN layers, 2 rounds.
    want = {"fused_finish_compact": 2, **{k: 2 * 30 * 12 for k in BN_TPU}}
    check(streamed and counts == want,
          f"fedavg streamed: launches {counts}, expected {want}")
    last, _ = _fedavg_trial("MLP x 6 ALIE Median", MLP_TRIAL, 3)
    check(last["test_acc"] >= MLP_MIN_ACC,
          f"fedavg MLP: test accuracy {last['test_acc']} < {MLP_MIN_ACC}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         f"{','.join(PHASES + EXTRA_PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import blades_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    # Full f32 where f32 is asked for (cuDNN would take TF32 otherwise).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi()
    log(f"card: {card}")
    records = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    try:
        if "build" in phases:
            run("build", phase_build)
        if "small" in phases:
            run("small", phase_small)
        if "kernels" in phases:
            records = run("kernels", phase_kernels)
        launches = {}
        if "main" in phases:
            launches.update(run("main", phase_main)[0])
        if "full" in phases:
            launches.update(run("full", phase_full))
        if "aggregators" in phases:
            launches.update(run("aggregators", phase_aggregators))
        if "rowgeom" in phases:
            launches.update(run("rowgeom", phase_rowgeom))
        if "fedavg" in phases:
            run("fedavg", phase_fedavg)
        if "profile" in phases:
            run("profile", phase_profile, os.path.join(HERE, "chiprun_out"))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for name, r in records.items():
        r["launches"] = launches.get(name, 0)
    if set(PHASES) <= set(phases):
        missing = [n for n, r in records.items() if r["launches"] < 1]
        if missing:
            print(f"chip_smoke: FAILED: kernels never launched on their "
                  f"path: {missing}", file=sys.stderr)
            return 1
    kernels = {"kernels": list(records.values())}
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
