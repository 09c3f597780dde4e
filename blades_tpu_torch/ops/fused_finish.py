"""The streamed round's fused finish: sanitize, forge, aggregate and row
norms in one pass over the stored update matrix.

Counterpart of ``blades_tpu/ops/pallas_round.py``.  Two entry points:

- :func:`fused_finish_compact` over the BENIGN-ONLY matrix of a round whose
  malicious prefix skipped training: the forged row enters the aggregate as
  a virtual row of multiplicity ``forged_mult``.
- :func:`fused_finish` over the full ``(n, d)`` matrix with a ``malicious``
  mask: the forged row replaces the malicious rows (forge optional).

On a CUDA tensor each launches a hand-written kernel of
``csrc/fused_finish.cu`` (built on first use) or raises: for rows that
are 16-byte aligned (the streamed round pads its buffer so) the radix
route when they are bf16 and few enough to fit its shared memory (1,317),
else the ring route; the bit-serial route for other rows
(:func:`blades_tpu_torch.ops._cuda.finish_route`).  None waits for the
device.  On a CPU tensor
each runs its plain PyTorch version, :func:`fused_finish_compact_plain` /
:func:`fused_finish_plain`, which also serve as the kernel's yardstick on
the card: they walk the columns in chunks of ``1 << 17`` so their workspace
stays bounded at full size.

Semantics kept exactly from the TPU kernels:

- sanitize is stripe-local: a row holding a non-finite value inside a
  512-column stripe starting at a multiple of 512 is zeroed inside that
  stripe only, and flagged;
- the forged row comes from the active (benign) rows' statistics: ALIE
  ``mean + z * std`` (ddof 1, ``nb = max(#benign, 1)``), IPM
  ``-scale * mean``, or Adaptive (Fang) from uniforms the caller drew; under
  bf16 storage it is rounded to bf16;
- Median and Trimmedmean select exact order statistics over monotone keys
  (NaN of either sign last), with the trimmed mean's tie correction at both
  cuts.

``forge``: ``None``, ``("alie", z)``, ``("ipm", scale)`` or
``("adaptive", b)``.  ``agg``: ``("mean",)``, ``("median",)`` or
``("trimmed", k_cut)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.ops.keys import CHUNK, STRIPE, keys_of, kth_keys, vals_of


def _check_args(n_tot: int, d: int, forge, agg, forge_noise) -> None:
    if agg[0] not in ("mean", "median", "trimmed"):
        raise ValueError(f"unknown aggregator {agg[0]!r}")
    if agg[0] == "trimmed" and n_tot <= 2 * agg[1]:
        raise ValueError(f"trimmed mean needs > {2 * agg[1]} rows, "
                         f"got {n_tot}")
    if forge is not None and forge[0] not in ("alie", "ipm", "adaptive"):
        raise ValueError(f"unknown forge {forge[0]!r}")
    if forge is not None and forge[0] == "adaptive":
        if forge_noise is None:
            raise ValueError("('adaptive', b) forging needs forge_noise")
        if tuple(forge_noise.shape) != (d,):
            raise ValueError(f"forge_noise must be ({d},), got "
                             f"{tuple(forge_noise.shape)}")


def _sanitize_chunk(xc: torch.Tensor):
    """Zero each row inside every 512-column stripe where it holds a
    non-finite value; return the chunk and the rows flagged."""
    rows, w = xc.shape
    nonfin = ~torch.isfinite(xc)
    pad = (-w) % STRIPE
    if pad:
        nonfin = torch.nn.functional.pad(nonfin, (0, pad))
    stripe_bad = nonfin.view(rows, -1, STRIPE).any(-1)
    zero = stripe_bad.repeat_interleave(STRIPE, dim=1)[:, :w]
    return torch.where(zero, torch.zeros_like(xc), xc), stripe_bad.any(1)


def _forged_row(xa: torch.Tensor, forge, noise, keys16: bool) -> torch.Tensor:
    """The forged row from the active rows ``xa`` (f32), as
    ``pallas_round._forged_stripe`` computes it."""
    kind, p = forge
    nb = float(max(xa.shape[0], 1))
    mean = xa.sum(0) / nb
    if kind == "alie":
        var = ((xa - mean) ** 2).sum(0)
        forged = mean + p * torch.sqrt(var / max(nb - 1.0, 1.0))
    elif kind == "ipm":
        forged = -p * mean
    else:
        b, r = p, noise
        if xa.shape[0]:  # max/min propagate NaN, as jnp.max/jnp.min do
            mx, mn = xa.max(0).values, xa.min(0).values
        else:
            mx = torch.full_like(mean, -float("inf"))
            mn = torch.full_like(mean, float("inf"))
        neg_pos = r * ((b - 1.0) * mx) + mx
        neg_neg = r * ((1.0 / b - 1.0) * mx) + mx
        pos_pos = r * ((1.0 - 1.0 / b) * mn) + mn / b
        pos_neg = r * ((1.0 - b) * mn) + mn * b
        forged = torch.where(
            mean < 0, torch.where(mx > 0, neg_pos, neg_neg),
            torch.where(mean > 0, torch.where(mn > 0, pos_pos, pos_neg),
                        mean))
    if keys16:
        forged = forged.to(torch.bfloat16).float()
    return forged


def _select_agg(xa, agg, forged, mult: int, n_true: int, keys16: bool,
                compact: bool) -> torch.Tensor:
    """The aggregate of ``xa`` (active rows) + ``mult`` x ``forged``."""
    if agg[0] == "mean":
        s = xa.sum(0)
        if mult:
            s = s + mult * forged
        return s / n_true
    keys = keys_of(xa, keys16)
    skeys = keys.sort(0).values
    fkey = keys_of(forged, keys16) if mult else None
    if agg[0] == "median":
        k1, k2 = (n_true - 1) // 2, n_true // 2
        v1 = kth_keys(skeys, k1, fkey, mult)
        if k1 == k2:
            return vals_of(v1, keys16)
        v2 = kth_keys(skeys, k2, fkey, mult)
        return (vals_of(v1, keys16) + vals_of(v2, keys16)) * 0.5
    k = agg[1]
    vlo = kth_keys(skeys, k, fkey, mult)
    vhi = kth_keys(skeys, n_true - 1 - k, fkey, mult)
    flo, fhi = vals_of(vlo, keys16), vals_of(vhi, keys16)
    between = (keys > vlo) & (keys < vhi)
    # A running f32 sum down the column in row order, as the reference's
    # column reduction takes it (torch's cumsum accumulates in double).
    kept_vals = torch.where(between, xa, torch.zeros_like(xa))
    sum_mid = torch.zeros_like(flo)
    for row in kept_vals:
        sum_mid = sum_mid + row
    lt_lo, eq_lo = (keys < vlo).sum(0), (keys == vlo).sum(0)
    lt_hi, eq_hi = (keys < vhi).sum(0), (keys == vhi).sum(0)
    if mult:
        fb = (fkey > vlo) & (fkey < vhi)
        if compact:
            sum_mid = sum_mid + (mult * forged) * fb.float()
        else:
            sum_mid = sum_mid + torch.where(fb, mult * forged,
                                            torch.zeros_like(forged))
        lt_lo = lt_lo + mult * (fkey < vlo)
        eq_lo = eq_lo + mult * (fkey == vlo)
        lt_hi = lt_hi + mult * (fkey < vhi)
        eq_hi = eq_hi + mult * (fkey == vhi)
    lo_keep = ((lt_lo + eq_lo).clamp(max=n_true - k)
               - lt_lo.clamp(min=k)).clamp(min=0)
    hi_keep = ((lt_hi + eq_hi).clamp(max=n_true - k)
               - lt_hi.clamp(min=k)).clamp(min=0)
    kept = n_true - 2 * k
    total = sum_mid + lo_keep.float() * flo + hi_keep.float() * fhi
    total = torch.where(vlo == vhi, flo * kept, total)
    # Times the f32 reciprocal, as XLA lowers a division by a constant.
    return total * float(np.float32(1.0) / np.float32(kept))


def _finish_plain(x, active, mult, forge, agg, sanitize, noise,
                  compact: bool):
    """Shared plain body: ``(agg, sq, bad, forged)`` over column chunks."""
    rows, d = x.shape
    keys16 = x.dtype == torch.bfloat16
    n_true = (rows if active is None else int(active.sum())) + mult  # blades-lint: disable=host-sync — the plain version, taken only for CPU tensors (on the card the wrapper launches the kernel)
    agg_vec = torch.empty((d,), dtype=torch.float32, device=x.device)
    forged_vec = (torch.zeros((d,), dtype=torch.float32, device=x.device)
                  if forge is not None else None)
    sq = torch.zeros((rows,), dtype=torch.float32, device=x.device)
    bad = torch.zeros((rows,), dtype=torch.bool, device=x.device)
    fsq = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, d, CHUNK):
        c1 = min(c0 + CHUNK, d)
        xc = x[:, c0:c1].float()
        if sanitize:
            xc, flagged = _sanitize_chunk(xc)
            bad |= flagged
        xa = xc if active is None else xc[active]
        forged = None
        if forge is not None:
            r = None if noise is None else noise[c0:c1].float()
            forged = _forged_row(xa, forge, r, keys16)
            forged_vec[c0:c1] = forged
            fsq = fsq + (forged * forged).sum()
        sq_c = (xc * xc).sum(1)
        sq += sq_c if active is None else torch.where(active, sq_c, 0.0)
        agg_vec[c0:c1] = _select_agg(xa, agg, forged, mult, n_true, keys16,
                                     compact)
    if active is not None and forge is not None and not compact:
        sq = torch.where(active, sq, fsq)
    return agg_vec, sq, bad, forged_vec


def _check_matrix(updates: torch.Tensor) -> None:
    if updates.dim() != 2:
        raise ValueError(f"need a (rows, d) matrix, got {tuple(updates.shape)}")
    if updates.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype {updates.dtype} not supported "
                         "(float32 or bfloat16)")


def _check_compact(updates, forge_noise, forged_mult, forge, agg):
    _check_matrix(updates)
    if forge is None:
        raise ValueError("compact finish requires a forge (elision is only "
                         "sound when forged rows replace training)")
    if forged_mult <= 0:
        raise ValueError(f"forged_mult must be positive, got {forged_mult}")
    _check_args(updates.shape[0] + forged_mult, updates.shape[1], forge, agg,
                forge_noise)


def fused_finish_compact_plain(
    updates: torch.Tensor,
    forge_noise: Optional[torch.Tensor] = None,
    *,
    forged_mult: int,
    forge: tuple,
    agg: tuple = ("median",),
    sanitize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_finish_compact`."""
    _check_compact(updates, forge_noise, forged_mult, forge, agg)
    return _finish_plain(updates, None, forged_mult, forge, agg, sanitize,
                         forge_noise, compact=True)


def fused_finish_compact(
    updates: torch.Tensor,
    forge_noise: Optional[torch.Tensor] = None,
    *,
    forged_mult: int,
    forge: tuple,
    agg: tuple = ("median",),
    sanitize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forge + aggregate over a BENIGN-ONLY update matrix in one pass.

    The stored ``(nb, d)`` matrix holds the benign rows; the forged row is
    a virtual row of multiplicity ``forged_mult``.  Returns
    ``(agg (d,) f32, sq_norms (nb,) f32, bad (nb,) bool, forged (d,) f32)``;
    the caller takes the malicious rows' norms as ``||forged||^2``.
    """
    if not updates.is_cuda:
        return fused_finish_compact_plain(
            updates, forge_noise, forged_mult=forged_mult, forge=forge,
            agg=agg, sanitize=sanitize)
    _check_compact(updates, forge_noise, forged_mult, forge, agg)
    agg_vec, sq, bad, forged = _cuda.launch_finish(
        "fused_finish_compact", updates, noise=forge_noise, mult=forged_mult,
        forge=forge, agg=agg, sanitize=sanitize, compact=True,
        want_forged=True)
    return agg_vec, sq, bad, forged


def _check_full(updates, malicious, forge_noise, forge, agg):
    """Check the arguments' shapes; return ``active``, the rows the
    statistics read (None = all, when nothing is forged).  The forged row's
    multiplicity is the count of the other rows; nothing here reads the
    mask's values, so the card's wrapper does not wait for the device."""
    _check_matrix(updates)
    if tuple(malicious.shape) != (updates.shape[0],):
        raise ValueError(f"malicious mask must be ({updates.shape[0]},), got "
                         f"{tuple(malicious.shape)}")
    _check_args(updates.shape[0], updates.shape[1], forge, agg, forge_noise)
    if forge is None:
        return None
    return ~malicious.to(device=updates.device, dtype=torch.bool)


def fused_finish_plain(
    updates: torch.Tensor,
    malicious: torch.Tensor,
    forge_noise: Optional[torch.Tensor] = None,
    *,
    forge: Optional[tuple] = None,
    agg: tuple = ("median",),
    sanitize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_finish`."""
    active = _check_full(updates, malicious, forge_noise, forge, agg)
    mult = 0 if active is None else int((~active).sum())  # blades-lint: disable=host-sync — the plain version, taken only for CPU tensors (on the card the wrapper launches the kernel)
    agg_vec, sq, bad, _ = _finish_plain(updates, active, mult, forge, agg,
                                        sanitize, forge_noise, compact=False)
    return agg_vec, sq, bad


def fused_finish(
    updates: torch.Tensor,
    malicious: torch.Tensor,
    forge_noise: Optional[torch.Tensor] = None,
    *,
    forge: Optional[tuple] = None,
    agg: tuple = ("median",),
    sanitize: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forge + aggregate the full ``(n, d)`` update matrix in one pass.

    ``malicious`` ``(n,)`` bool marks the rows the forged row replaces.
    Returns ``(agg (d,) f32, sq_norms (n,) f32, bad (n,) bool)``: the
    post-forge rows' squared norms and the rows sanitize flagged.
    """
    if not updates.is_cuda:
        return fused_finish_plain(updates, malicious, forge_noise,
                                  forge=forge, agg=agg, sanitize=sanitize)
    active = _check_full(updates, malicious, forge_noise, forge, agg)
    agg_vec, sq, bad, _ = _cuda.launch_finish(
        "fused_finish", updates, active=active, noise=forge_noise,
        forge=forge, agg=agg, sanitize=sanitize, compact=False)
    return agg_vec, sq, bad
