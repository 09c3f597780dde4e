"""The single-device streamed round (counterpart of
``blades_tpu/parallel/streamed.py``), the port's main path.

Clients train in blocks of ``client_block`` into one ``(rows, d)`` update
buffer in the storage dtype (bf16 by default): each block's updates are
written into its rows in place, leaf by leaf, which the port does to keep
a single copy of the matrix.  A coordinate-wise round (Mean, Median,
Trimmedmean) then finishes in one of two ways, chosen before the buffer
is allocated:

- the fused finish, ONE kernel over the buffer
  (:mod:`blades_tpu_torch.ops.fused_finish`): sanitize, forge, aggregate
  and row norms.  It runs when the round has a fused spec (no DP, a
  forge among ALIE / IPM / Adaptive or none), no ghost lanes, and the
  kernel's shared-memory plan takes the buffer's rows and dtype
  (:func:`blades_tpu_torch.ops._cuda.finish_fits`: up to 1,317 bf16 rows
  on the radix route, then up to 7,473 bf16 or 4,874 f32 rows, the
  bit-serial plan's rows, on the ring route);
- otherwise the chunked finish (``step.finish``, the JAX package's
  ``_finish``): per column chunk of width ``d_chunk`` (the tail chunk
  overlaps its predecessor), an f32 copy of the chunk is sanitized,
  clipped and noised by DP against the train-time row norms, forged
  (ALIE, IPM, Adaptive, Noise) with per-chunk draws, and aggregated by
  the aggregator's own call (Median / Trimmedmean launch the column
  select on a card); the row norms count only not-yet-covered columns,
  while the tail chunk's aggregate overwrites the overlap.  On a round
  whose result does not depend on the chunk grid (:func:`chunk_invariant`),
  ALIE's and IPM's statistics and a Mean aggregate are taken over
  ``STAT_WIDTH``-wide column slices of the chunk, and the row
  norms over the model's ``STAT_WIDTH``-wide column blocks, so the
  finish gives the same parameters and metrics, bit for bit, for every
  ``d_chunk`` that is a multiple of ``STAT_WIDTH`` or covers the model.

The buffer is ``(rows, d_alloc)`` on every route, the model width ``d``
rounded up to a multiple of 512 as the JAX package allocates it whenever
its fused finish runs, so a bf16 buffer of up to 1,317 rows takes the
fused finish's radix route;
the aggregate and the forged row are sliced back to ``d``, and the chunked
finish walks only the first ``d`` columns.  Ghost (padding) lanes, rows
past ``FedRound.num_clients``, are cut off as a contiguous view before the
chunked finish.

Per-client DP (``FedRound.dp_clip_threshold``) needs each row's full f32
norm before storage rounding: training adds each leaf's f32 sum of
squares into a ``(n,)`` vector as it writes the buffer (only under DP).
The clip is tightened to ``threshold / (1 + 2**-8)`` under bf16 storage,
so the stored row's norm still respects the bound; a row with a
non-finite norm is scaled to 0.  The chunked finish's random inputs come
from ``draws(kind, i, shape)`` (``kind`` ``"dp"``, ``"noise"`` or
``"adaptive"``, chunk ``i``), by default from the round's generator.

``malicious_prefix`` is the caller's promise that the malicious mask marks
exactly the first ``malicious_prefix`` lanes.  When the adversary forges
updates from benign statistics, the malicious clients' training is dead
work, so blocks that lie wholly inside the prefix are skipped (checked once
per mask object).  When the prefix is block-aligned and the round takes
the fused finish, the buffer holds ONLY the benign rows and the forged row
enters the aggregate as a virtual row of multiplicity ``malicious_prefix``
(``fused_finish_compact``); otherwise the full matrix goes through
``fused_finish``.

The row-geometry aggregators (GeoMed, Multikrum, DnC, Centeredclipping,
Signguard, Clippedclustering, FLTrust) and forges (MinMax, SignGuard,
Attackclippedclustering) take the full matrix instead, allocated as the
JAX package allocates it: ``(n, d_alloc)`` with ``d_alloc`` the model
width ``d`` rounded up to a multiple of 512, clients training into the
first ``d`` columns and the padding columns zero throughout, so that every
row starts 16-byte aligned for the row-stats kernels.  A column-chunk pass
sanitizes, applies DP and a coordinate-wise forge IN PLACE (writing back
only each chunk's not-yet-covered columns) and accumulates the row norms; a
row-geometry forge then computes its forged row through the pass planner
and scatters it into the malicious lanes; the aggregator runs as fused
statistics bundles over the buffer
(:mod:`blades_tpu_torch.parallel.streamed_geometry`), each bundle of
kernel kinds one call of the row-stats kernel.  These rounds stamp
``hbm_passes`` / ``hbm_passes_unfused``: the planned full-matrix
traversals of the fused plan and of one traversal per statistic, plus one
for the in-place pass and one for the scatter.  A row-geometry forge with
Mean, Median or Trimmedmean finishes chunk by chunk.

The training hooks (the client callbacks, then LabelFlip's or SignFlip's)
run inside each block's local rounds.  Under client momentum each block
takes its rows of the per-client traces (``RoundState.client_opt``, one
row per data row), runs its local round from them and writes the
advanced traces back in place, as the JAX package's ``_train_block``
does with its donated traces; elided blocks never train, so their traces
stay as they are.  The Lazy forge has no streamed formulation, and ghost
lanes enter no row-geometry round, as in the JAX package.
"""

from __future__ import annotations

import collections
from typing import Callable, Tuple

import torch

from blades_tpu_torch.adversaries.base import forges
from blades_tpu_torch.adversaries.update_attacks import (
    AdaptiveAdversary,
    ALIEAdversary,
    IPMAdversary,
    NoiseAdversary,
)
from blades_tpu_torch.core.health import guard_server_state, sanitize_updates
from blades_tpu_torch.core.round import FedRound, RoundState
from blades_tpu_torch.data.sampler import gather_batches, sample_batch_indices
from blades_tpu_torch.device import resolve_device
from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.ops.aggregators import Mean, Median, Trimmedmean
from blades_tpu_torch.ops.fused_finish import fused_finish, fused_finish_compact
from blades_tpu_torch.ops.keys import STRIPE
from blades_tpu_torch.ops.layout import ChunkInfo
from blades_tpu_torch.parallel.streamed_geometry import (
    STREAMED_ROW_AGGREGATORS,
    STREAMED_ROW_FORGERS,
    PassPlanner,
    PassRecorder,
    aggregate_coordwise,
    aggregate_streamed,
    check_applicable,
    chunk_grid,
    forge_streamed,
)
from blades_tpu_torch.utils.tree import FlatLayout

D_CHUNK = 1 << 17  # columns per step of the column-chunk passes
_COORDWISE_FORGERS = (ALIEAdversary, IPMAdversary, NoiseAdversary,
                      AdaptiveAdversary)
_COORDWISE_AGGREGATORS = (Mean, Median, Trimmedmean)
# bf16 storage rounds each coordinate by at most half an ulp (2**-8
# relative), so a row clipped to thr / (1 + 2**-8) stays within thr.
_BF16_CLIP = 1.0 + 2.0 ** -8


def _fused_spec(fr: FedRound):
    """``(forge, agg)`` specs of the fused finish for this round, or None
    when the round needs the chunked finish (DP, the keyed Noise forge)."""
    if fr.dp_clip_threshold is not None:
        return None
    agg = fr.server.aggregator
    if isinstance(agg, Median):
        aspec = ("median",)
    elif isinstance(agg, Trimmedmean):
        aspec = ("trimmed", agg.num_excluded)
    elif isinstance(agg, Mean):
        aspec = ("mean",)
    else:
        return None
    adv = fr.adversary
    if not forges(adv):
        fspec = None
    elif isinstance(adv, ALIEAdversary):
        fspec = ("alie", float(adv.z_max))
    elif isinstance(adv, IPMAdversary):
        fspec = ("ipm", float(adv.scale))
    elif isinstance(adv, AdaptiveAdversary):
        fspec = ("adaptive", float(adv.b))
    else:
        return None
    return fspec, aspec


#: The column width of the chunked finish's column statistics on a
#: chunk-invariant round: the deterministic forges' (ALIE, IPM) and a
#: Mean aggregate come from reductions over ``(rows, STAT_WIDTH)`` column
#: slices of a chunk (its last slice overlapping its predecessor), and
#: the row norms from the model's ``STAT_WIDTH``-wide column blocks in
#: order, so the finish is invariant to ``d_chunk`` bit for bit.  A CUDA
#: column reduction splits its rows across thread blocks by the number of
#: columns it reduces, and orders them by the input's strides: over the
#: whole chunk its sums would move with the chunk width, and a Mean over a
#: strided slice with the chunk's stride, so a Mean's slice is made
#: contiguous.  The forges and the norms reduce elementwise results,
#: which are contiguous whatever the slice's stride.
STAT_WIDTH = 1 << 16


def chunk_invariant(fr: FedRound) -> bool:
    """Whether the streamed finish's result can be invariant to the
    ``d_chunk`` partition bit for bit (the JAX package's gate on the chunk
    ladder): a coordinate-wise aggregator under a deterministic
    coordinate-wise forge, without DP (per-chunk noise), the Noise and
    Adaptive forges (per-chunk draws) or the health check (chunk-local
    sanitize)."""
    if fr.dp_clip_threshold is not None or fr.health_check:
        return False
    if not isinstance(fr.server.aggregator, _COORDWISE_AGGREGATORS):
        return False
    adv = fr.adversary
    if forges(adv):
        if isinstance(adv, (AdaptiveAdversary, NoiseAdversary)):
            return False
        if not isinstance(adv, _COORDWISE_FORGERS):
            return False
    return True


def stat_slices(c: int):
    """The starts of the ``STAT_WIDTH``-wide column slices covering ``c``
    columns (one slice of ``c`` when ``c <= STAT_WIDTH``; the last one
    overlaps its predecessor)."""
    if c <= STAT_WIDTH:
        return [(0, c)]
    starts = list(range(0, c - STAT_WIDTH + 1, STAT_WIDTH))
    if starts[-1] + STAT_WIDTH < c:
        starts.append(c - STAT_WIDTH)
    return [(a, STAT_WIDTH) for a in starts]


def _by_slices(fn, chunk, out):
    """``fn`` (column-local) over ``chunk``'s statistics slices into
    ``out``, column for column."""
    for a, w in stat_slices(chunk.shape[1]):
        out[..., a:a + w] = fn(chunk[:, a:a + w])
    return out


def _add_sq_by_blocks(sq, chunk, start, lo):
    """Add the squared norms of ``chunk``'s columns ``lo:`` (model columns
    from ``start + lo``) to ``sq``, one model ``STAT_WIDTH`` block at a
    time: the same sums in the same order whenever the chunk grid's
    boundaries fall on block boundaries."""
    g, end = start + lo, start + chunk.shape[1]
    while g < end:
        b = min((g // STAT_WIDTH + 1) * STAT_WIDTH, end)
        x = chunk[:, g - start:b - start]
        sq += (x * x).sum(1)
        g = b


def coordwise_route(fr: FedRound, n: int, *, client_block: int,
                    update_dtype: torch.dtype,
                    malicious_prefix: int | None) -> Tuple[str, int]:
    """The finish a coordinate-wise streamed round over ``n`` data rows
    takes, decided before its buffer exists: ``("fused_compact", rows
    elided)``, ``("fused", 0)`` or ``("chunked", 0)``.  The fused finish
    runs where it can express the round (:func:`_fused_spec`, no ghost
    lanes) and its kernel plan takes the buffer's rows
    (:func:`~blades_tpu_torch.ops._cuda.finish_fits`); compact when a
    forging round's malicious prefix is whole blocks."""
    adv = fr.adversary
    forging = forges(adv) and isinstance(
        adv, _COORDWISE_FORGERS + STREAMED_ROW_FORGERS)
    skip_blocks = (malicious_prefix // client_block
                   if malicious_prefix and forging else 0)
    ghosts = fr.num_clients is not None and fr.num_clients != n
    fused = _fused_spec(fr) is not None and not ghosts
    compact = (fused and skip_blocks > 0
               and malicious_prefix % client_block == 0)
    row_shift = malicious_prefix if compact else 0
    if not (fused and _cuda.finish_fits(update_dtype, n - row_shift)):
        return "chunked", 0
    return ("fused_compact", row_shift) if compact else ("fused", 0)


def generator_draws(generator: torch.Generator) -> Callable:
    """The chunked finish's default random inputs, ``draws(kind, i,
    shape)``: standard normals of ``shape`` for DP and the Noise forge,
    uniforms for Adaptive's ``(c,)``, from ``generator`` in call order."""
    def draws(kind, i, shape):
        del i
        if kind == "adaptive":
            return torch.rand(shape, generator=generator,
                              device=generator.device)
        return torch.randn(shape, generator=generator,
                           device=generator.device)
    return draws


def streamed_step(
    fr: FedRound,
    *,
    client_block: int = 50,
    update_dtype: torch.dtype = torch.bfloat16,
    malicious_prefix: int | None = None,
    fuse_rowgeom: bool = True,
    d_chunk: int | None = None,
    device=None,
) -> Callable:
    """Build the streamed round on ``device`` (``None`` = the card).

    ``step(state, x, y, lengths, malicious, seed, batch_idx=None,
    dropout_masks=None, draws=None) -> (state, metrics)``: ``x (n, shard,
    H, W, C)`` and ``y (n, shard)`` are the stacked client shards,
    ``lengths (n,)`` their true sizes, ``malicious (n,)`` the bool mask,
    and ``seed`` seeds the round's generator (batch indices, dropout
    masks, the forges', DP's and DnC's draws, the trusted update's
    batches).  ``batch_idx (n, num_batches, batch_size)`` replaces the
    index draw, ``dropout_masks`` (one ``(n, num_batches, *site_shape)``
    bool keep-mask per dropout site) the mask draw, and
    ``draws(kind, i, shape)`` the per-chunk draws of the chunked finish
    and of the row-geometry round's in-place pass (``kind`` ``"dp"`` or
    ``"noise"``: standard normals; ``"adaptive"``: the chunked finish's
    ``(c,)`` uniforms).

    ``fuse_rowgeom=False`` runs the row-geometry statistics one traversal
    per request (the unfused comparator).  ``d_chunk`` is the column width
    of the chunk passes (default ``D_CHUNK``).  After each row-geometry round
    ``step.passes`` holds its
    :class:`~blades_tpu_torch.parallel.streamed_geometry.PassRecorder`.
    ``step.routes`` counts the coordinate-wise rounds by finish
    (``"fused_compact"``, ``"fused"``, ``"chunked"``), and ``step.finish``
    is the chunked finish itself, ``finish(server_state, buf, malicious,
    losses, row_norms=None, *, d=None, draws=None) -> (server_state,
    metrics)`` over a ``(n, >= d)`` buffer (``draws`` as above; required
    when the round draws, under DP, Noise or Adaptive).
    """
    dev = resolve_device(device)
    momentum = bool(fr.task.spec.momentum)
    d_chunk = d_chunk or D_CHUNK
    hooks = fr.hooks()
    agg, adv = fr.server.aggregator, fr.adversary
    row_geom = isinstance(agg, STREAMED_ROW_AGGREGATORS)
    coord_forges = forges(adv) and isinstance(adv, _COORDWISE_FORGERS)
    row_forges = forges(adv) and isinstance(adv, STREAMED_ROW_FORGERS)
    rowgeom_path = row_geom or row_forges
    dp = fr.dp_clip_threshold is not None
    invariant = chunk_invariant(fr)
    if getattr(agg, "expects_trusted_row", False) and fr.trusted_data is None:
        raise ValueError(
            f"{type(agg).__name__} requires FedRound.trusted_data (the "
            "server's root data): without it the defense has no root of "
            "trust")
    if not row_geom and not isinstance(agg, _COORDWISE_AGGREGATORS):
        raise NotImplementedError(
            f"{type(agg).__name__} has no streamed formulation")
    if forges(adv) and not (coord_forges or row_forges):
        raise NotImplementedError(
            f"{type(adv).__name__} has no streamed forge formulation (as in "
            "the JAX package); use execution='dense'")
    spec = None if rowgeom_path else _fused_spec(fr)
    forging = coord_forges or row_forges
    # The in-place chunk pass rewrites the buffer only when something
    # changes it; otherwise the row norms fuse into the first bundle.
    rewrites = coord_forges or fr.health_check or dp
    checked_mask = [None]  # the last mask object validated

    def _serve_aggregate(state, agg_vec, malicious, losses, sq, bad,
                         agg_state=None):
        server = fr.server.apply_aggregate(state.server, agg_vec, agg_state)
        benign = (~malicious).float()
        metrics = {
            "train_loss": (losses * benign).sum() / benign.sum().clamp(min=1.0),
            "update_norm_mean": sq.clamp(min=0.0).sqrt().mean(),
            # A plain sum of squares: torch's CPU vector_norm loses ~1e-4
            # relative over millions of f32 terms.
            "agg_norm": (agg_vec * agg_vec).sum().sqrt(),
            "round": server.round,
        }
        if fr.health_check:
            ok = torch.isfinite(agg_vec).all()
            server = guard_server_state(ok, server, state.server)
            metrics["num_unhealthy"] = bad.sum()
            metrics["round_ok"] = ok
        return server, metrics

    def _dp_scale(row_norms):
        """Each row's DP clip factor from its full-row f32 norm: 0 for a
        non-finite norm, the bf16-tightened threshold under bf16."""
        thr = fr.dp_clip_threshold
        if update_dtype != torch.float32:
            thr = thr / _BF16_CLIP
        thr_t = torch.full((), thr, dtype=torch.float32, device=dev)
        scale = torch.div(thr_t, row_norms.clamp(min=1e-12)).clamp(max=1.0)
        return torch.where(torch.isfinite(row_norms), scale,
                           torch.zeros_like(scale))

    def _dp_chunk(chunk, scale, draws, i):
        """DP on one chunk: the clip, then ``sigma`` times chunk ``i``'s
        normals."""
        chunk = chunk * scale[:, None]
        if fr.dp_noise_factor is not None:
            sigma = fr.dp_noise_factor * fr.dp_clip_threshold
            chunk = chunk + sigma * draws("dp", i, tuple(chunk.shape)).to(
                device=chunk.device, dtype=chunk.dtype)
        return chunk

    def _forge_noise(draws, i, shape):
        """A coordinate-wise forge's random input for chunk ``i`` of
        ``shape`` (rows, c), or None."""
        if isinstance(adv, NoiseAdversary):
            return draws("noise", i, shape)
        if isinstance(adv, AdaptiveAdversary):
            return draws("adaptive", i, shape[1:])
        return None

    def finish(server_state, buf, malicious, losses, row_norms=None, *,
               d=None, draws=None):
        """The chunked finish over the first ``d`` columns (default all)
        of ``buf`` (n, >= d): per chunk, an f32 copy, sanitize, DP (clip
        against ``row_norms``, the train-time full-row f32 norms), the
        coordinate-wise forge, the aggregator's own call; row norms over
        each chunk's not-yet-covered columns.  Ghost lanes (rows past
        ``fr.num_clients``) are cut off first."""
        n = buf.shape[0]
        k = fr.num_clients
        if k is not None and k < n:  # ghost (padding) lanes: row views
            buf, losses, malicious = buf[:k], losses[:k], malicious[:k]
            row_norms = None if row_norms is None else row_norms[:k]
        rows = buf.shape[0]
        d = d or buf.shape[1]
        scale = _dp_scale(row_norms) if dp else None
        c, _, starts = chunk_grid(d, d_chunk)
        agg_vec = torch.empty((d,), dtype=torch.float32, device=buf.device)
        sq = torch.zeros((rows,), dtype=torch.float32, device=buf.device)
        bad = torch.zeros((rows,), dtype=torch.bool, device=buf.device)
        for i, start in enumerate(starts):
            chunk = torch.empty((rows, c), dtype=torch.float32,
                                device=buf.device)
            chunk.copy_(buf[:, start:start + c])
            if fr.health_check:
                chunk, healthy = sanitize_updates(chunk)
                bad |= ~healthy
            if dp:
                chunk = _dp_chunk(chunk, scale, draws, i)
            if coord_forges and invariant:
                # ALIE, IPM: the forged row from statistics slices (their
                # reductions run over the contiguous results of masking
                # the slice, whatever its stride), written into the
                # malicious rows in place.
                forged = torch.empty((c,), dtype=chunk.dtype,
                                     device=chunk.device)
                _by_slices(lambda x: adv.forged_row(x, malicious), chunk,
                           forged)
                torch.where(malicious[:, None], forged[None, :], chunk,
                            out=chunk)
            elif coord_forges:
                chunk = adv.on_updates_ready(
                    chunk, malicious, aggregator=agg,
                    noise=_forge_noise(draws, i, (rows, c)))
            # The tail chunk overlaps its predecessor: its aggregate
            # overwrites the overlap, its norms count only new columns.
            # On an invariant round Mean reduces contiguous statistics
            # slices; the column selects of Median and Trimmedmean are
            # column-local on any width.
            if invariant and isinstance(agg, Mean):
                _by_slices(lambda x: agg(x.contiguous())[0], chunk,
                           agg_vec[start:start + c])
            else:
                agg_vec[start:start + c] = agg(chunk)[0]
            lo = max(i * c - start, 0)
            if invariant:
                _add_sq_by_blocks(sq, chunk, start, lo)
            else:
                fresh = chunk[:, lo:]
                sq += (fresh * fresh).sum(1)
        return _serve_aggregate(RoundState(server=server_state), agg_vec,
                                malicious, losses, sq, bad)

    def _rowgeom_mat_chunk(buf, sq, bad, malicious, scale, adaptive, draws,
                           d, i, start, c):
        """Sanitize, DP and forge chunk ``i`` in place: write back only its
        not-yet-covered columns, and accumulate their squared norms."""
        raw = buf[:, start:start + c]
        chunk = raw.float()
        if fr.health_check:
            chunk, healthy = sanitize_updates(chunk)
            bad |= ~healthy
        if dp:
            chunk = _dp_chunk(chunk, scale, draws, i)
        if coord_forges:
            # Adaptive takes its full-width uniforms sliced to the chunk.
            noise = (_forge_noise(draws, i, tuple(chunk.shape))
                     if adaptive is None else adaptive[start:start + c])
            chunk = adv.on_updates_ready(
                chunk, malicious, aggregator=agg, noise=noise,
                shard=ChunkInfo(global_d=d, width=c, start=start, index=i))
        lo = max(i * c - start, 0)  # the tail chunk overlaps its predecessor
        fresh = chunk[:, lo:]
        sq += (fresh * fresh).sum(1)
        raw[:, lo:] = fresh.to(buf.dtype)

    def _forge_row(buf, malicious, sq, gen, d, recorder):
        """The row-geometry forge's statistics bundles -> the forged (d,)
        row and the post-forge row squared norms."""
        planner = PassPlanner(buf, d_chunk, d=d, recorder=recorder,
                              fuse=fuse_rowgeom)
        forged, sq = forge_streamed(adv, buf, malicious, sq, agg, planner,
                                    generator=gen)
        return forged, torch.where(malicious, forged @ forged, sq)

    def _scatter_chunk(buf, forged, rows, start, c):
        """The forged row's columns into the malicious rows of one chunk."""
        buf[rows, start:start + c] = forged[start:start + c].to(buf.dtype)

    def _rowgeom_aggregate(state, buf, malicious, losses, sq, bad, gen, d,
                           recorder):
        trusted = fr.compute_trusted_update(state.server.params, gen)
        agg_vec, agg_state, sq = aggregate_streamed(
            agg, buf, sq, state.server.agg_state, generator=gen,
            trusted=trusted, d_chunk=d_chunk, d=d, recorder=recorder,
            fuse=fuse_rowgeom)
        return _serve_aggregate(state, agg_vec, malicious, losses, sq, bad,
                                agg_state=agg_state)

    def _coordwise_after_forge(state, buf, malicious, losses, sq, bad, d,
                               recorder):
        agg_vec = aggregate_coordwise(agg, buf, d_chunk, d=d,
                                      recorder=recorder)
        return _serve_aggregate(state, agg_vec, malicious, losses, sq, bad)

    def _finish_rowgeom(state, buf, malicious, losses, row_norms, gen, draws,
                        d):
        """The row-geometry finish over the ``(n, d_alloc)`` buffer; every
        pass is bounded to the model width ``d``."""
        n = buf.shape[0]
        recorder = PassRecorder()
        c, _, starts = chunk_grid(d, d_chunk)
        if rewrites:
            sq = torch.zeros((n,), dtype=torch.float32, device=dev)
            bad = torch.zeros((n,), dtype=torch.bool, device=dev)
            scale = _dp_scale(row_norms) if dp else None
            adaptive = (torch.rand((d,), generator=gen, device=dev)
                        if isinstance(adv, AdaptiveAdversary) else None)
            for i, start in enumerate(starts):
                _rowgeom_mat_chunk(buf, sq, bad, malicious, scale, adaptive,
                                   draws, d, i, start, c)
        else:
            sq, bad = None, torch.zeros((n,), dtype=torch.bool, device=dev)
        if row_forges:
            forged, sq = _forge_row(buf, malicious, sq, gen, d, recorder)
            rows = malicious.nonzero().flatten()  # blades-lint: disable=host-sync — known round-time sync: the malicious lanes' indices, once a round on the row-geometry forge
            for start in starts:
                _scatter_chunk(buf, forged, rows, start, c)
        if row_geom:
            server, metrics = _rowgeom_aggregate(state, buf, malicious,
                                                 losses, sq, bad, gen, d,
                                                 recorder)
        else:
            server, metrics = _coordwise_after_forge(state, buf, malicious,
                                                     losses, sq, bad, d,
                                                     recorder)
        fixed = int(rewrites) + int(row_forges)
        metrics["hbm_passes"] = recorder.executed + fixed
        metrics["hbm_passes_unfused"] = recorder.unfused + fixed
        step.passes = recorder
        return server, metrics

    def _finish_fused(state, buf, malicious, losses, gen, compact, d,
                      d_alloc):
        """The fused finish kernel over the buffer (compact: the benign
        rows only, the forged row a virtual row of multiplicity
        ``malicious_prefix``)."""
        forge, aspec = spec
        noise = None
        if forge is not None and forge[0] == "adaptive":
            # Zero over the padding, whose all-zero columns forge to 0.
            noise = torch.zeros((d_alloc,), device=dev)
            noise[:d] = torch.rand((d,), generator=gen, device=dev)
        if compact:
            agg_vec, sq_b, bad_b, forged = fused_finish_compact(
                buf, noise, forged_mult=malicious_prefix, forge=forge,
                agg=aspec, sanitize=fr.health_check)
            agg_vec, forged = agg_vec[:d], forged[:d]
            fsq = (forged * forged).sum()
            sq = torch.cat([fsq.expand(malicious_prefix), sq_b])
            bad = torch.cat([torch.zeros((malicious_prefix,),
                                         dtype=torch.bool, device=dev),
                             bad_b])
        else:
            agg_vec, sq, bad = fused_finish(buf, malicious, noise,
                                            forge=forge, agg=aspec,
                                            sanitize=fr.health_check)
            agg_vec = agg_vec[:d]
        return _serve_aggregate(state, agg_vec, malicious, losses, sq, bad)

    def step(state: RoundState, data_x, data_y, lengths, malicious, seed,
             batch_idx=None, dropout_masks=None, draws=None):
        n = data_x.shape[0]
        if n % client_block:
            raise ValueError(f"{n} clients not divisible by block "
                             f"{client_block}")
        ghosts = fr.num_clients is not None and fr.num_clients != n
        if rowgeom_path:  # before training burns a full pass
            if ghosts:
                raise ValueError(
                    f"the streamed row-geometry finish needs num_clients "
                    f"({fr.num_clients}) == data rows ({n}): ghost lanes "
                    "would enter the row geometry; pick a client_block "
                    "that divides num_clients")
            check_applicable(agg, n)
        opt = state.client_opt
        if momentum:
            rows = {v.shape[0] for v in (opt or {}).values()}
            if rows != {n}:
                raise ValueError(
                    f"client momentum needs one trace row per data row "
                    f"({n}), got state.client_opt rows {sorted(rows)}")
        malicious = malicious.to(device=dev, dtype=torch.bool)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        if draws is None:
            draws = generator_draws(gen)
        if batch_idx is None:
            batch_idx = sample_batch_indices(
                gen, lengths.to(dev), fr.batch_size, fr.num_batches_per_round)
        batch_idx = batch_idx.to(device=data_x.device, dtype=torch.int64)

        skip_blocks = 0
        if malicious_prefix and forging:
            skip_blocks = malicious_prefix // client_block
            if skip_blocks and checked_mask[0] is not malicious:
                mal = malicious.cpu()  # blades-lint: disable=host-sync — once per mask object, by design (the elision check)
                if not (bool(mal[:skip_blocks * client_block].all())  # blades-lint: disable=host-sync — once per mask object, by design (the elision check)
                        and not bool(mal[malicious_prefix:].any())):  # blades-lint: disable=host-sync — once per mask object, by design (the elision check)
                    raise ValueError(
                        f"malicious_prefix={malicious_prefix} promised "
                        "exactly the first lanes malicious, but the mask "
                        "disagrees: elision would zero benign updates")
                checked_mask[0] = malicious
        # The route, decided before the buffer exists (compact and full
        # buffers differ in shape).
        route, row_shift = coordwise_route(
            fr, n, client_block=client_block, update_dtype=update_dtype,
            malicious_prefix=malicious_prefix)
        fused = not rowgeom_path and route != "chunked"
        compact = route == "fused_compact"

        params = state.server.params
        d = FlatLayout(params).d
        # Padded to the JAX package's 512-column stripes on every path, so
        # every row starts 16-byte aligned; training writes only the first
        # d columns.
        d_alloc = -(-d // STRIPE) * STRIPE
        shape = (n - row_shift, d_alloc)
        # Compact: training writes every row's first d columns, and the
        # padding is zeroed here (a NaN left in it would flag a healthy row
        # in the last sanitize stripe and corrupt its norm).  Otherwise
        # elided rows stay zero (finite, and the forge replaces them).
        if compact:
            buf = torch.empty(shape, dtype=update_dtype, device=dev)
            buf[:, d:].zero_()
        else:
            buf = torch.zeros(shape, dtype=update_dtype, device=dev)
        losses = torch.zeros((n,), dtype=torch.float32, device=dev)
        # Under DP: each row's f32 squared norm, taken before storage
        # rounding (elided rows keep 0).
        sq_rows = (torch.zeros((n,), dtype=torch.float32, device=dev)
                   if dp else None)
        for b in range(skip_blocks, n // client_block):
            r0, r1 = b * client_block, (b + 1) * client_block
            bx, by = gather_batches(data_x[r0:r1], data_y[r0:r1],
                                    batch_idx[r0:r1])
            masks = (None if dropout_masks is None else
                     tuple(m[r0:r1].to(dev) for m in dropout_masks))
            _, loss, opt_b = fr.task.local_round_batched(
                params, bx.to(dev), by.to(dev),
                opt_state=(None if not momentum else
                           {k: v[r0:r1] for k, v in opt.items()}),
                malicious=malicious[r0:r1],
                hooks=hooks, generator=gen, dropout_masks=masks,
                out=buf[r0 - row_shift:r1 - row_shift, :d],
                sq_out=None if sq_rows is None else sq_rows[r0:r1])
            losses[r0:r1] = loss
            if momentum:  # the block's advanced traces, in place
                for k, v in opt_b.items():
                    opt[k][r0:r1] = v
        row_norms = None if sq_rows is None else sq_rows.sqrt()

        if rowgeom_path:
            server, metrics = _finish_rowgeom(state, buf, malicious, losses,
                                              row_norms, gen, draws, d)
        elif fused:
            server, metrics = _finish_fused(state, buf, malicious, losses,
                                            gen, compact, d, d_alloc)
        else:
            server, metrics = step.finish(state.server, buf, malicious,
                                          losses, row_norms, d=d,
                                          draws=draws)
        if not rowgeom_path:
            step.routes[route] += 1
        del buf
        if skip_blocks:
            metrics["elided_lanes"] = skip_blocks * client_block
        return RoundState(server=server, client_opt=opt), metrics

    step.finish = finish
    step.routes = collections.Counter()
    return step
