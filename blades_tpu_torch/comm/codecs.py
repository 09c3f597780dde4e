"""Compressed update codecs on the client->server uplink (counterpart of
``blades_tpu/comm/codecs.py``).

A codec is a frozen-dataclass config whose transform runs on the stacked
``(n, d)`` update matrix after the local rounds and before fault
injection, forging and aggregation, so every aggregator sees the
compressed geometry and the adversary forges post-codec.

- ``identity``: the round is unchanged (the transform returns its input).
- ``quant``: stochastic uniform quantization to a symmetric int8 / int4
  grid with one f32 scale per client row.  ``floor(x) + (u < frac(x))``
  with uniforms ``u`` is unbiased: ``E[decode(encode(u))] = u``.
- ``topk``: magnitude top-k per row with client-side error feedback: each
  client adds its carried residual before selection and keeps what it
  could not send (``RoundState.residual``, ``None`` when the codec keeps
  none).

Randomness: the JAX package draws the rounding uniforms from a fold of the
round key; the port cannot reproduce that stream, so the uniforms are an
argument (``draws=``, ``(n, d)`` f32) or come from ``generator``.  The
round passes :func:`codec_generator`, a generator of its own seeded from
the round generator's seed plus :data:`CODEC_KEY_FOLD`: a codec draws
nothing from the round's stream, so every other draw of the round is the
one a codec-free round makes, as in JAX.

Deferred decode (the wire domain): :meth:`CodecConfig.decode_deferred`
returns the packed payload ``(q int8, scales f32)`` with
``dequantize(q, scales, d)`` bit for bit what ``encode_decode`` returns.
The port's ``q`` is ``(n, wire_width(d))``: each row zero-padded to a
multiple of :data:`WIRE_ALIGN` bytes, where JAX's is ``(n, d)``.  The
card's row-statistics ring takes int8 rows only when they are 16-byte
aligned, and ResNet-10's d = 4,903,242 is 10 mod 16; the zero columns
change no statistic (norms, Gram, dots, weighted sums; sign counts take
the true width), and :func:`dequantize` reads the true ``d`` columns.

Quantization runs over blocks of rows (:data:`QUANT_BLOCK_BYTES` of f32
each) so that its temporaries stay a block's size at 1000 ResNet-10 rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

CODEC_NAMES = ("identity", "quant", "topk")

# The seed offset of the codec's generator from the round generator's
# seed (JAX folds this constant into the round key).
CODEC_KEY_FOLD = 0xC0DE

# Bytes of a packed wire row are a multiple of this (the card's int8 row
# statistics read 16-byte pieces).
WIRE_ALIGN = 16

# f32 bytes of the update rows one quantization block covers.
QUANT_BLOCK_BYTES = 1 << 30


def wire_width(d: int) -> int:
    """Columns of a packed int8 wire row of ``d`` values."""
    return -(-int(d) // WIRE_ALIGN) * WIRE_ALIGN


def codec_generator(generator: torch.Generator) -> torch.Generator:
    """The codec's generator for a round whose generator is
    ``generator``: seeded from its seed plus :data:`CODEC_KEY_FOLD`, on
    its device; ``generator`` itself is not advanced."""
    gen = torch.Generator(device=generator.device)
    gen.manual_seed((generator.initial_seed() + CODEC_KEY_FOLD)
                    % (1 << 63))
    return gen


def dequantize(q: torch.Tensor, scales: Optional[torch.Tensor],
               d: Optional[int] = None) -> torch.Tensor:
    """The dense f32 ``(n, d)`` matrix of a wire payload: ``q * scales``
    row-wise over the first ``d`` columns (default all).  ``scales is
    None`` (the identity codec's f32 wire) returns ``q`` unchanged."""
    if scales is None:
        return q
    d = q.shape[1] if d is None else int(d)
    return q[:, :d].float() * scales[:, None]


def _row_block(n: int, d: int) -> int:
    return max(1, min(n, QUANT_BLOCK_BYTES // max(4 * d, 1)))


def _true_div(num: torch.Tensor, s: float) -> torch.Tensor:
    """``num / s`` as a true division: ATen divides by a scalar as a
    multiply by its reciprocal, which can differ in the last bit."""
    return num / torch.full_like(num, s)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static codec config.

    Attributes:
        name: ``"identity" | "quant" | "topk"``.
        bits: quantization width (``quant``): 8 or 4, a symmetric signed
            grid with ``2**(bits-1) - 1`` positive levels.
        topk_ratio: fraction of coordinates each client sends (``topk``):
            ``k = max(1, round(topk_ratio * d))``.
        error_feedback: carry the unsent remainder as a per-client
            residual added before the next round's selection (``topk``).
    """

    name: str = "identity"
    bits: int = 8
    topk_ratio: float = 0.01
    error_feedback: bool = True

    def __post_init__(self):
        if self.name not in CODEC_NAMES:
            raise ValueError(
                f"codec name must be one of {CODEC_NAMES}, got {self.name!r}")
        if self.name == "quant" and self.bits not in (4, 8):
            raise ValueError(
                f"quant bits must be 4 or 8 (int4/int8 wire grids), got "
                f"{self.bits}")
        if self.name == "topk" and not 0.0 < self.topk_ratio <= 1.0:
            raise ValueError(
                f"topk_ratio must be in (0, 1], got {self.topk_ratio}")

    # -- static properties ---------------------------------------------------

    @property
    def needs_residual(self) -> bool:
        """Whether the round state carries the ``(n, d)`` residual."""
        return self.name == "topk" and self.error_feedback

    def topk_k(self, d: int) -> int:
        """Coordinates sent per client row (``topk``)."""
        return min(d, max(1, int(round(self.topk_ratio * d))))

    @property
    def supports_deferred(self) -> bool:
        """Whether :meth:`decode_deferred` has a packed (or pass-through)
        wire: the quant grids and identity; top-k's wire is sparse f32."""
        return self.name in ("identity", "quant")

    @property
    def storage_bits(self) -> int:
        """Bits per element of the wire-domain matrix the defenses
        traverse (``agg_domain_bits``): 8 for the quant grids (int4 rides
        int8 storage), 32 for identity."""
        return 8 if self.name == "quant" else 32

    @property
    def wire_bits(self) -> int:
        """Bits per sent coordinate value (``codec_bits``)."""
        return self.bits if self.name == "quant" else 32

    def payload_bytes(self, n: int, d: int) -> int:
        """Uplink bytes of one round of ``n`` clients with ``d``-wide
        updates: identity ``n d 4``; quant ``n (ceil(d bits / 8) + 4)``;
        topk ``n k 8`` (f32 value + int32 index)."""
        if self.name == "quant":
            return n * ((d * self.bits + 7) // 8 + 4)
        if self.name == "topk":
            return n * self.topk_k(d) * 8
        return n * d * 4

    def round_metrics(self, n: int, d: int) -> dict:
        """The per-round comm fields ``comm_bytes_up``, ``codec_bits`` and
        ``comm_compression_ratio`` (host-side, from the config alone)."""
        dense = n * d * 4
        up = self.payload_bytes(n, d)
        return {
            "comm_bytes_up": int(up),
            "codec_bits": int(self.wire_bits),
            "comm_compression_ratio": round(dense / up, 4),
        }

    # -- state ---------------------------------------------------------------

    def init_residual(self, num_clients: int, num_params: int, device=None):
        """Zeros ``(n, d)`` f32 residual, or ``None`` when the codec
        carries none."""
        if not self.needs_residual:
            return None
        return torch.zeros((num_clients, num_params), dtype=torch.float32,
                           device=device)

    def init_residual_row(self, num_params: int) -> torch.Tensor:
        """One client's zero ``(d,)`` f32 residual row: the
        participation-window store's template
        (:func:`~blades_tpu_torch.state.store.client_state_template`), so
        under a windowed store only the cohort's rows are ever gathered
        into ``RoundState.residual``.  Callers gate on
        :attr:`needs_residual`."""
        return torch.zeros((num_params,), dtype=torch.float32)

    # -- the transform -------------------------------------------------------

    def encode_decode(self, updates: torch.Tensor, residual=None, *,
                      draws: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One round of the wire: ``(decoded, new_residual)``.

        ``draws`` are the quant codec's ``(n, d)`` rounding uniforms
        (from ``generator`` when None).  ``out`` (quant only) receives
        the decoded rows and may be ``updates`` itself: each block of
        rows is quantized before it is overwritten."""
        if self.name == "identity":
            return updates, residual
        if self.name == "quant":
            if out is None:
                out = torch.empty_like(updates, dtype=torch.float32)
            d = updates.shape[1]
            for r0, qb, sb in self._blocks(updates, draws, generator):
                out[r0:r0 + qb.shape[0]] = dequantize(qb, sb, d)
            return out, residual
        return self._topk(updates, residual)

    def _blocks(self, u, draws, generator):
        """Yield ``(first row, q block (rows, d) int8, scales block)`` of
        the stochastic quantization of ``u``, block by block."""
        n, d = u.shape
        s = float(2 ** (self.bits - 1) - 1)
        rb = _row_block(n, d)
        if draws is None and generator is None:
            raise ValueError("quant codec: pass draws= (the rounding "
                             "uniforms) or generator=")
        for r0 in range(0, n, rb):
            ub = u[r0:r0 + rb].float()
            scale = _true_div(ub.abs().amax(1), s)
            x = ub / torch.where(scale > 0, scale,
                                 torch.ones_like(scale))[:, None]
            del ub
            lo = torch.floor(x)
            r = (draws[r0:r0 + rb].to(x.device) if draws is not None
                 else torch.rand(x.shape, generator=generator,
                                 device=x.device))
            qb = lo + (r < (x - lo))
            del x, lo, r
            yield r0, qb.clamp_(-s, s).to(torch.int8), scale

    def _quantize_deferred(self, u: torch.Tensor, *,
                          draws: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(q int8 (n, wire_width(d)), scales f32 (n,))``, zero past
        ``d``, with ``dequantize(q, scales, d)`` equal to the quant
        codec's ``encode_decode`` bit for bit (JAX's
        ``_quantize_deferred``)."""
        n, d = u.shape
        q = torch.zeros((n, wire_width(d)), dtype=torch.int8,
                        device=u.device)
        scales = torch.empty((n,), dtype=torch.float32, device=u.device)
        for r0, qb, sb in self._blocks(u, draws, generator):
            q[r0:r0 + qb.shape[0], :d] = qb
            scales[r0:r0 + qb.shape[0]] = sb
        return q, scales

    def decode_deferred(self, updates: torch.Tensor, residual=None, *,
                        draws: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
        """The wire-domain round's ``encode_decode``: ``(q, scales,
        new_residual)`` without the dense f32 matrix.  quant: the packed
        int8 grid and the row scales; identity: ``q`` is ``updates`` and
        ``scales`` None (the f32 path).  Top-k raises."""
        if self.name == "identity":
            return updates, None, residual
        if self.name == "quant":
            q, scales = self._quantize_deferred(updates, draws=draws,
                                               generator=generator)
            return q, scales, residual
        raise ValueError(
            "decode_deferred: the top-k wire is sparse f32 (value+index "
            "pairs), with no packed-integer matrix for wire-domain "
            "aggregation; use encode_decode (agg_domain='f32')")

    def requantize_into(self, q: torch.Tensor, scales: torch.Tensor,
                        idx: torch.Tensor, rows: torch.Tensor) -> None:
        """Write fresh wire payloads of the f32 ``rows`` ``(k, d)`` into
        rows ``idx`` of ``q`` and ``scales`` in place: deterministic
        round-to-nearest (half to even) on the row's own scale."""
        if idx.numel() == 0:
            return
        s = float(2 ** (self.bits - 1) - 1)
        rows = rows.float()
        rescale = _true_div(rows.abs().amax(1), s)
        x = rows / torch.where(rescale > 0, rescale,
                               torch.ones_like(rescale))[:, None]
        rq = torch.round(x).clamp_(-s, s).to(torch.int8)
        q[idx, :rows.shape[1]] = rq
        scales[idx] = rescale

    def requantize_rows(self, dec: torch.Tensor, q: torch.Tensor,
                        scales: torch.Tensor, rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Re-encode the rows of ``dec`` (n, d) where ``rows`` (n,) is
        True onto the wire grid (how forged lanes re-enter the wire); the
        other rows keep their payload.  Returns new ``(q, scales)``."""
        q, scales = q.clone(), scales.clone()
        idx = rows.nonzero().flatten()  # blades-lint: disable=host-sync — known round-time sync: the forged lanes' indices size dec[idx]; once a wire round with a forge
        self.requantize_into(q, scales, idx, dec[idx])
        return q, scales

    def _topk(self, u: torch.Tensor, residual):
        """Magnitude top-k per row over ``u + residual``; the unsent rest
        is the new residual.  On ties at the k-th magnitude ``torch.topk``
        may keep another valid top-k set than ``jax.lax.top_k``;
        ``p = sent + residual`` holds either way."""
        k = self.topk_k(u.shape[1])
        p = u + residual if residual is not None else u
        idx = torch.topk(p.abs(), k, dim=1, sorted=False).indices
        sent = torch.zeros_like(p).scatter_(1, idx, p.gather(1, idx))
        return sent, (p - sent if residual is not None else residual)


def get_codec(spec) -> Optional[CodecConfig]:
    """Resolve a codec from a name, a ``{"type": ..., **kwargs}`` dict
    (``"name"`` accepted too), an instance, or ``None``."""
    if spec is None or isinstance(spec, CodecConfig):
        return spec
    if isinstance(spec, str):
        spec = {"type": spec}
    spec = dict(spec)
    name = spec.pop("type", None) or spec.pop("name", None)
    if name is None:
        raise ValueError(
            f"codec spec needs a 'type' (one of {CODEC_NAMES}): {spec!r}")
    spec.pop("name", None)
    return CodecConfig(name=name, **spec)
