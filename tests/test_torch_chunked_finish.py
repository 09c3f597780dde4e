"""The port's chunked finish (``streamed_step(...).finish``,
blades_tpu_torch/parallel/streamed.py) against the JAX package's
(``blades_tpu.parallel.streamed.streamed_step(...).finish``, which on the
CPU is the finish every JAX streamed coordinate-wise round takes), and the
route gate that sends a round to it.  The DP cases are in
tests/test_torch_dp.py, which shares the helpers here.

Both finishes get the same server state (flax-initialised parameters
carried across by blades_tpu_torch/convert.py), the same numpy-made update
buffer in the storage dtype, the same losses and the same train-time row
norms.  The JAX finish draws per chunk from ``fold_in(k_adv, i)`` (Noise's
normals, Adaptive's uniforms) and ``fold_in(k_dp, i)`` (DP's normals); the
port is handed those very draws, regenerated with ``jax.random`` from the
same keys, through its ``draws(kind, i, shape)`` provider.  The model is
the MLP on 2x2 inputs (d = 36,234) under ``d_chunk`` 16,384: three
chunks, the last starting at d - 16,384 and overlapping the second.

Tolerances: an order statistic over values both sides compute the same
way is bit-exact, and so are the server parameters built from it
(``params + agg`` at lr 1): Median under no forge, Adaptive (an affine map
of the benign max / min and the uniforms) or a unit Noise forge (mean 0,
std 1: the normals themselves), with no DP or DP's clip alone (a true
division for the clip factor, one product).  A scaled normal is not
reproducible bit for bit: inside the JAX finish XLA folds the scale into
the normal's ``sqrt(2) * erfinv(u)`` and contracts the add, so Noise's
``mean + std * z`` and DP's ``x + sigma * z`` differ from the same
expressions over the drawn ``z`` in the last ulp.  Those cases, and every
case whose aggregate or forged row is an f32 sum (Mean, Trimmedmean,
ALIE's and IPM's benign mean and variance), hold ``rtol=1e-5,
atol=1e-6``, the tolerance tests/test_torch_streamed.py states for the
streamed round; so do the row-norm and aggregate-norm metrics, sums
everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.adversaries import get_adversary as jax_adversary
from blades_tpu.core import FedRound as JaxFedRound
from blades_tpu.core import Server as JaxServer
from blades_tpu.core import TaskSpec as JaxTaskSpec
from blades_tpu.parallel.streamed import streamed_step as jax_streamed_step
from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
from blades_tpu_torch.convert import params_from_jax, params_to_jax
from blades_tpu_torch.core import FedRound, RoundState, Server, TaskSpec
from blades_tpu_torch.ops import _cuda
from blades_tpu_torch.parallel.streamed import streamed_step

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (2, 2, 1)  # MLP width d = 36,234
D = 36_234
D_ALLOC = 36_352  # D rounded up to 512 columns
D_CHUNK = 16_384
THRESHOLD = 1.0
NOISE_FACTOR = 0.25
UNIT_NOISE = {"mean": 0.0, "std": 1.0}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def jax_chunk_draws(k_adv, k_dp):
    """The JAX chunked finish's per-chunk draws, as the port's provider."""
    def draws(kind, i, shape):
        key = jax.random.fold_in(k_dp if kind == "dp" else k_adv, i)
        if kind == "adaptive":
            arr = jax.random.uniform(key, shape, jnp.float32)
        else:
            arr = jax.random.normal(key, shape, jnp.float32)
        return torch.from_numpy(np.array(arr))
    return draws


def exact(aggregator, adversary, dp=None, adv_kw=None):
    """Whether the case is bit-exact (the module docstring's rule)."""
    unit = adversary == "Noise" and adv_kw == UNIT_NOISE
    return (aggregator == "Median" and dp != "noise"
            and (adversary in (None, "Adaptive") or unit))


def rounds(aggregator, adversary, *, n, f, dp=None, adv_kw=None,
           health=False, num_clients=None, block=None, dtype="float32",
           d_chunk=D_CHUNK):
    """The JAX and port FedRounds and their streamed steps; ``dp`` is None,
    ``"clip"`` (the clip alone) or ``"noise"`` (clip and noise)."""
    spec = dict(model="mlp", input_shape=SHAPE, num_classes=10, lr=0.1)
    k = num_clients or n
    common = dict(batch_size=4, num_clients=num_clients, health_check=health,
                  dp_clip_threshold=None if dp is None else THRESHOLD,
                  dp_noise_factor=NOISE_FACTOR if dp == "noise" else None)
    adv = (None if adversary is None
           else {"type": adversary, **(adv_kw or {})})
    jfr = JaxFedRound(
        task=JaxTaskSpec(**spec).build(),
        server=JaxServer.from_config(aggregator=aggregator, num_byzantine=f,
                                     lr=1.0),
        adversary=None if adv is None else jax_adversary(
            adv, num_clients=k, num_byzantine=f), **common)
    fr = FedRound(
        task=TaskSpec(**spec).build(),
        server=Server.from_config(aggregator, num_byzantine=f, lr=1.0),
        adversary=None if adv is None else get_adversary(
            adv, num_clients=k, num_byzantine=f), **common)
    tdt, jdt = DTYPES[dtype]
    jstep = jax_streamed_step(jfr, client_block=block or n,
                              update_dtype=jdt, donate=False,
                              d_chunk=d_chunk)
    step = streamed_step(fr, client_block=block or n, update_dtype=tdt,
                         d_chunk=d_chunk, device="cpu")
    return jfr, fr, jstep, step


def _buffer(n, dtype, health, seed=0):
    """``(stored (n, D) numpy f32 holding the storage dtype's values, the
    f32 row norms before storage rounding (n,))``: rows of spread scales,
    so that the clip shrinks some and keeps others; with ``health`` a NaN
    in row 3 (first chunk) and an inf in row 5 (second chunk, outside the
    overlap)."""
    rng = np.random.default_rng(seed)
    scales = np.geomspace(2e-3, 2e-2, n).astype(np.float32)
    upd = (rng.normal(size=(n, D)).astype(np.float32) * scales[:, None])
    if health:
        upd[3, 100] = np.nan
        upd[5, 17_000] = np.inf
    norms = np.sqrt((upd.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    stored = torch.from_numpy(upd).to(DTYPES[dtype][0]).float().numpy()
    return stored, norms


def finish_pair(aggregator, adversary, *, dtype, dp=None, adv_kw=None,
                n=24, f=6, health=False, num_clients=None):
    """Both finishes on one buffer: ``(jax server, jax metrics, port
    server, port metrics)``."""
    jfr, fr, jstep, step = rounds(aggregator, adversary, n=n, f=f, dp=dp,
                                  adv_kw=adv_kw, health=health,
                                  num_clients=num_clients, dtype=dtype)
    jstate = jfr.init(jax.random.PRNGKey(0), n)
    params = params_from_jax(jax.tree.map(np.asarray, jstate.server.params))
    state = RoundState(server=fr.server.init(params, n))
    stored, norms = _buffer(n, dtype, health)
    losses = np.linspace(0.5, 2.0, n).astype(np.float32)
    mal = np.arange(n) < f
    k_adv, k_dp = jax.random.split(jax.random.PRNGKey(11))
    jserver, jm = jstep.finish(
        jstate.server, jnp.asarray(stored).astype(DTYPES[dtype][1]),
        jnp.asarray(mal), jnp.asarray(losses), jnp.asarray(norms), k_adv,
        k_dp)
    # The port's buffer is padded to 512-column stripes, as the streamed
    # round allocates it; the finish walks the first D columns.
    buf = torch.zeros((n, D_ALLOC), dtype=DTYPES[dtype][0])
    buf[:, :D] = torch.from_numpy(stored).to(buf.dtype)
    server, m = step.finish(state.server, buf, torch.from_numpy(mal),
                            torch.from_numpy(losses),
                            torch.from_numpy(norms), d=D,
                            draws=jax_chunk_draws(k_adv, k_dp))
    return jserver, jm, server, m


def compare(jserver, jm, server, m, exact, health=False):
    """The server parameters bit for bit (``exact``) or within the
    tolerance, the metrics within the tolerance."""
    want = np.asarray(ravel_pytree(jserver.params)[0])
    got = np.asarray(ravel_pytree(params_to_jax(server.params))[0])
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for key in ("train_loss", "update_norm_mean", "agg_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert int(m["round"]) == int(jm["round"])
    if health:
        assert int(m["num_unhealthy"]) == int(jm["num_unhealthy"])
        assert bool(m["round_ok"]) == bool(jm["round_ok"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adversary", ["ALIE", "IPM", "Adaptive", "Noise"])
@pytest.mark.parametrize("aggregator", ["Mean", "Median", "Trimmedmean"])
def test_chunked_finish_matches_jax(aggregator, adversary, dtype):
    out = finish_pair(aggregator, adversary, dtype=dtype)
    compare(*out, exact=exact(aggregator, adversary))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("adversary", [None, "Noise"])
def test_chunked_median_is_bit_exact(adversary, dtype):
    """No forge, and a unit Noise forge (its rows are JAX's normals
    themselves, overwriting the tail's overlap with the tail chunk's own
    draws): the Median and the parameters built from it bit for bit."""
    kw = UNIT_NOISE if adversary else None
    out = finish_pair("Median", adversary, dtype=dtype, adv_kw=kw)
    compare(*out, exact=exact("Median", adversary, adv_kw=kw))


@pytest.mark.parametrize("aggregator", ["Median", "Trimmedmean"])
def test_chunked_finish_sanitizes_chunk_locally(aggregator):
    """Health check + Noise: sanitize zeroes the NaN row and the inf row
    in the chunks that hold the value only (the JAX finish keeps their
    other chunks) and flags both."""
    out = finish_pair(aggregator, "Noise", dtype="bfloat16", health=True,
                      adv_kw=UNIT_NOISE)
    compare(*out, exact=exact(aggregator, "Noise", adv_kw=UNIT_NOISE),
            health=True)
    assert int(out[3]["num_unhealthy"]) == 2


@pytest.mark.parametrize("aggregator,adversary", [
    ("Median", "Noise"), ("Median", None), ("Trimmedmean", "ALIE"),
    ("Mean", "IPM")])
def test_ghost_lanes_are_cut_off(aggregator, adversary):
    """``num_clients`` < buffer rows: the rows past it (ghost lanes) enter
    nothing, on both sides."""
    out = finish_pair(aggregator, adversary, dtype="float32", n=24, f=5,
                      num_clients=19)
    compare(*out, exact=exact(aggregator, adversary))


# -- the route gate ---------------------------------------------------------


def test_gate_keeps_every_round_the_fused_kernel_takes():
    """``main``'s compact buffer (750 bf16 rows) and the full (200,
    4,903,424) one take the fused kernel; f32 and bf16 rows above the
    bit-serial plan do not, and the gate flips exactly at its last row."""
    assert _cuda.finish_fits(torch.bfloat16, 750)
    assert _cuda.finish_fits(torch.bfloat16, 200)
    assert _cuda.finish_route(torch.bfloat16, 4_903_424, 0, 750) == "radix"
    assert _cuda.finish_fits(torch.float32, 4_874)
    assert not _cuda.finish_fits(torch.float32, 4_875)
    assert not _cuda.finish_fits(torch.float32, 6_000)
    assert _cuda.finish_fits(torch.bfloat16, 7_473)
    assert not _cuda.finish_fits(torch.bfloat16, 7_474)


@pytest.mark.parametrize("dtype,esize", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
def test_bitserial_plan_fits_exactly_where_it_says(dtype, esize):
    """For 1 to 20,000 rows the Python mirror of ``pick_cols`` says
    "fits" exactly where its slab stays within the 226 KB it allows one
    CTA (under the card's 227 KB), and picks the widest slab that leaves
    room for two CTAs an SM where one does."""
    cap, two_cta = _cuda.BITSERIAL_SMEM_CAP, _cuda.BITSERIAL_TWO_CTA
    assert cap <= 227 * 1024
    for rows in range(1, 20_001):
        cols = _cuda.bitserial_plan(rows, esize)
        if cols:
            assert _cuda.bitserial_smem(rows, cols, esize) <= cap
            wider = [c for c in _cuda.BITSERIAL_COLS if c > cols]
            assert all(_cuda.bitserial_smem(rows, c, esize) > two_cta
                       for c in wider)
        else:
            assert _cuda.bitserial_smem(rows, 8, esize) > cap
        assert _cuda.finish_fits(dtype, rows) == (
            cols > 0 or _cuda.finish_route(dtype, 512, 0, rows) == "radix")


@pytest.mark.parametrize("esize", [2, 4])
def test_ring_finish_plan_fits_exactly_where_it_says(esize):
    """The Python mirror of the ring route's plan (``gplan`` of
    ``csrc/fused_finish.cu``) against the layout its source states: the
    ring of 8 KB groups (128 bf16 / 64 f32 rows), the 256 x 32 histogram
    (32 KB), four int or float arrays of 16 warps x 32 columns, eight
    per-column fields, then 4 + 4 + 1 + 1 bytes a row, rounded to 16.  For
    1 to 20,000 rows: within the 226 KB cap; resident exactly when a
    slab's groups and four more fit, with as many in flight as fit up to
    eight; else streaming with as many as fit; refused only where two
    groups do not fit."""
    cap, group = _cuda.RING_FINISH_SMEM_CAP, _cuda.RING_FINISH_GROUP
    assert cap <= 227 * 1024 and group == 8192
    gh = 8192 // (32 * esize)

    def layout(rows, stages):
        total = stages * 8192 + 256 * 32 * 4 + 4 * 16 * 32 * 4 + 8 * 32 * 4
        return -(-(total + 10 * rows) // 16) * 16

    refused = []
    for rows in range(1, 20_001):
        if layout(rows, 2) > cap:
            with pytest.raises(ValueError, match="ring route"):
                _cuda.ring_finish_plan(rows, esize)
            refused.append(rows)
            continue
        plan = _cuda.ring_finish_plan(rows, esize)
        assert plan.gh == gh
        assert plan.smem == layout(rows, plan.stages) == _cuda.ring_finish_smem(
            rows, plan.stages) <= cap
        room = (cap - layout(rows, 0)) // 8192  # groups that fit
        ng = -(-rows // gh)
        if plan.resident:
            assert plan.stages == ng + plan.ahead and 4 <= plan.ahead <= 8
            assert plan.ahead == min(8, room - ng)
        else:
            assert ng + 4 > room
            assert plan.stages == plan.ahead + 1
            assert plan.ahead == min(8, room - 1) >= 1
    # The streamed round's buffers at the fused finish's caps, and above.
    assert _cuda.ring_finish_plan(7473, 2).resident == 0
    assert _cuda.ring_finish_plan(4874, 4).resident == 0
    assert _cuda.ring_finish_plan(1500, 2).resident == 1
    assert _cuda.ring_finish_plan(750, 4).resident == 1
    assert refused and min(refused) > 17_000


def _spied_round(monkeypatch, n, f, *, adversary="ALIE", dp=None,
                 num_clients=None, dtype="bfloat16", prefix=None):
    """One streamed MLP round; returns the route counts and what each
    finish was handed ``(name, buffer shape)``."""
    from blades_tpu_torch.parallel import streamed

    seen = []
    for name in ("fused_finish", "fused_finish_compact"):
        real = getattr(streamed, name)

        def spy(buf, *a, real=real, name=name, **kw):
            seen.append((name, tuple(buf.shape)))
            return real(buf, *a, **kw)
        monkeypatch.setattr(streamed, name, spy)
    _, fr, _, step = rounds("Median", adversary, n=n, f=f, dp=dp,
                             num_clients=num_clients, block=4, dtype=dtype)
    wrapped = streamed.streamed_step(
        fr, client_block=4, update_dtype=DTYPES[dtype][0],
        malicious_prefix=prefix, d_chunk=D_CHUNK, device="cpu")
    real_finish = wrapped.finish

    def finish_spy(server, buf, *a, **kw):
        seen.append(("chunked", tuple(buf.shape)))
        return real_finish(server, buf, *a, **kw)
    wrapped.finish = finish_spy
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, 4) + SHAPE).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(n, 4))).long()
    state = fr.init(0, n, device="cpu")
    state, m = wrapped(state, x, y, torch.full((n,), 4),
                       make_malicious_mask(n, f), 0)
    assert np.isfinite(float(m["train_loss"]))
    return dict(wrapped.routes), seen


@pytest.mark.parametrize("case,want", [
    ("main-like", ("fused_compact", ("fused_finish_compact", (8, 36_352)))),
    ("full", ("fused", ("fused_finish", (12, 36_352)))),
    ("dp", ("chunked", ("chunked", (12, 36_352)))),
    ("noise", ("chunked", ("chunked", (12, 36_352)))),
    ("ghosts", ("chunked", ("chunked", (12, 36_352)))),
])
def test_gate_picks_the_finish_before_allocating(monkeypatch, case, want):
    """The route and the buffer it is allocated for: compact and full
    fused buffers where the kernel can express the round, the full padded
    buffer (no compaction) for DP, Noise and ghost lanes even with a
    block-aligned malicious prefix."""
    kw = {"main-like": dict(prefix=4), "full": dict(),
          "dp": dict(dp="noise", prefix=4), "noise": dict(adversary="Noise",
                                                       prefix=4),
          "ghosts": dict(num_clients=10, prefix=4)}[case]
    routes, seen = _spied_round(monkeypatch, 12, 4, **kw)
    assert routes == {want[0]: 1}
    assert seen == [want[1]]


def test_5000_row_f32_round_takes_the_chunked_finish(monkeypatch):
    """An f32 round of 5,000 clients (above the bit-serial plan's 4,874
    rows, where the fused kernel raised on a card) goes through the gate
    to the chunked finish over the full padded buffer, on the CPU as on
    the card."""
    n, f = 5_000, 1_250
    _, fr, _, step = rounds("Median", "ALIE", n=n, f=f, block=1_000)
    assert not _cuda.finish_fits(torch.float32, n)
    seen = []
    real = step.finish

    def spy(server, buf, *a, **kw):
        seen.append(tuple(buf.shape))
        return real(server, buf, *a, **kw)
    step.finish = spy
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(n, 2) + SHAPE).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(n, 2))).long()
    state = fr.init(0, n, device="cpu")
    _, m = step(state, x, y, torch.full((n,), 2), make_malicious_mask(n, f),
                0)
    assert step.routes == {"chunked": 1}
    assert seen == [(n, 36_352)]
    assert np.isfinite(float(m["agg_norm"]))
