// Fused streamed-round finish and exact column order statistics for Hopper.
//
// One kernel source serves two wrappers (blades_tpu_torch/ops/):
//
//   fused_finish_compact  replaces blades_tpu/ops/pallas_round.py
//                         _fused_finish_compact_jit / _compact_kernel
//   fused_finish          replaces pallas_round.py fused_finish / _fused_kernel
//
// The column selects (pallas_select.py column_median / column_trimmed_mean)
// have their own kernel, csrc/column_select.cu; chip_smoke.py still times
// this source's bit-serial route on them beside it.
//
// What it computes, per column of a row-major (rows, d) matrix of bf16 or
// f32 values: stripe-local sanitize (a row holding a non-finite value inside
// a 512-column stripe that starts at a multiple of 512 is zeroed inside that
// stripe and flagged), the forged row from the statistics of the active rows
// (ALIE mean + z*std with ddof 1, IPM -s*mean, or the Fang/Adaptive directed
// deviation from uniforms the caller drew), rounded to bf16 under bf16
// storage, then the aggregate over the multiset {active rows} + mult x
// {forged row}: the mean, the exact median (midpoint of the two middle order
// statistics) or the trimmed mean with exact tie correction at both cuts.
// It also accumulates each row's squared norm and unhealthy flag.
//
// "Active" rows are the benign rows when a forge runs over the full matrix
// (the malicious rows are then counted as the virtual forged row of
// multiplicity mult = #malicious), every row of the benign-only compact
// matrix (mult = the elided malicious prefix), and every row when nothing
// is forged (mult = 0).
//
// Three routes (ops/_cuda.py::finish_route picks one from the layout):
//  - radix (radix_kernel, below finish_kernel): bf16 rows that are 16-byte
//    aligned, as the streamed round's padded buffer is, up to 1,317 rows.
//    Two 8-bit digit passes select the order statistics; see its own note.
//  - ring (ring_kernel, below radix_kernel): every other 16-byte-aligned
//    matrix -- f32 storage, and bf16 above radix's rows -- through a ring
//    of row groups, any row count; see its own note.
//  - bitserial (finish_kernel): rows that are not 16-byte aligned.
//
// Bound on the H100: the bytes of one read of the matrix (bf16: 2 B per
// element) against 3.35 TB/s, unless the select's compare-and-count work
// (bit-serial: 16 steps over bf16 keys, 32 over f32 keys, each touching
// every element once) outruns it, which a plain implementation does.
//
// Design of finish_kernel, the bit-serial route:
//  - Each CTA owns whole 512-column stripes (the sanitize granularity) and
//    walks them persistently (stripe s, s + gridDim.x, ...). Inside a stripe
//    it loads sub-slabs of C columns x all active rows into shared memory
//    with cp.async, converts them in place to monotone keys, and runs every
//    per-column pass (statistics, radix select, trimmed sums) out of shared
//    memory: the matrix is read from device memory once (twice for the
//    stripe's rows when sanitize is on: the flag pass, then the slab loads).
//  - Keys are the order-preserving map of pallas_select._keys_of: negatives
//    bit-flipped, positives offset past them, every NaN the maximum key.
//    Under bf16 storage only the top 16 bits carry order (_keys16_of), so
//    the select runs 16 steps.
//  - The two order statistics a median or trimmed mean needs are searched
//    together: one pass over the keys per bit counts both candidates.  For
//    an even-n median the second one is the (n/2)-th key itself, which is
//    what the reference's "next key above, unless the run of v1 covers
//    rank n/2" rule selects.
//  - Threads map to (column c = tid % C, row group g = tid / C). Per-column
//    partial sums and counts reduce over the G row groups in a fixed order,
//    so results do not depend on scheduling.
//  - Row norms and flags accumulate per CTA in shared memory (each row owned
//    by one thread), are written as (grid, rows) partials, and a second tiny
//    kernel reduces them in CTA order: no float atomics, deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStripe = 512;
constexpr int kThreads = 256;

enum Forge { kForgeNone = 0, kForgeAlie = 1, kForgeIpm = 2, kForgeAdaptive = 3 };
enum Agg { kAggMean = 0, kAggMedian = 1, kAggTrimmed = 2 };

struct Args {
  const void* x;
  int rows;
  long long d;
  const uint8_t* active;  // (rows,) or null = every row active
  const float* noise;     // (d,) Adaptive uniforms or null
  float* agg_out;         // (d,)
  float* forged_out;      // (d,) or null
  float* sq_part;         // (grid, rows + 1) or null; column `rows` = ||forged||^2
  uint8_t* bad_part;      // (grid, rows)
  int mult;               // forged-row multiplicity when `active` is null;
                          // with a mask it is rows - #active, formed on the device
  int forge;
  int agg;
  int k_cut;
  int sanitize;
  int compact;            // arithmetic of the compact kernel for the trimmed sum
  int aligned;            // rows start on 4-byte boundaries: cp.async path
  float fc[6];            // forge constants, see forge_constants() in the wrapper
  int stages;             // ring route: groups the ring holds,
  int ahead;              //   groups in flight,
  int resident;           //   and whether a slab's groups stay in the ring
};

__device__ __forceinline__ uint32_t key32_of_bits(uint32_t b) {
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return 0xFFFFFFFFu;  // NaN, either sign
  return (b >> 31) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ uint32_t key32_of(float v) {
  return key32_of_bits(__float_as_uint(v));
}
__device__ __forceinline__ float val32_of(uint32_t k) {
  return __uint_as_float((k >> 31) ? (k & 0x7FFFFFFFu) : ~k);
}

template <typename T>
struct Tr;

template <>
struct Tr<uint16_t> {  // bf16 storage, 16-bit keys
  static constexpr int kBits = 16;
  static constexpr uint32_t kZeroKey = 0x8000u;
  __device__ static bool finite(uint32_t b) { return (b & 0x7F80u) != 0x7F80u; }
  __device__ static uint32_t key_bits(uint32_t b) {
    if ((b & 0x7FFFu) > 0x7F80u) return 0xFFFFu;
    return (b >> 15) ? (~b & 0xFFFFu) : (b | 0x8000u);
  }
  __device__ static float val(uint32_t k) {
    uint32_t k32 = k << 16;
    if ((k >> 15) == 0) k32 |= 0xFFFFu;
    return val32_of(k32);
  }
  __device__ static uint32_t key_f(float v) { return key32_of(v) >> 16; }
  __device__ static float round_store(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float fval(uint32_t b) { return __uint_as_float(b << 16); }
};

template <>
struct Tr<uint32_t> {  // f32 storage, 32-bit keys
  static constexpr int kBits = 32;
  static constexpr uint32_t kZeroKey = 0x80000000u;
  __device__ static bool finite(uint32_t b) {
    return (b & 0x7F800000u) != 0x7F800000u;
  }
  __device__ static uint32_t key_bits(uint32_t b) { return key32_of_bits(b); }
  __device__ static float val(uint32_t k) { return val32_of(k); }
  __device__ static uint32_t key_f(float v) { return key32_of(v); }
  __device__ static float round_store(float v) { return v; }
  __device__ static float fval(uint32_t b) { return __uint_as_float(b); }
};

// Shared-memory layout of one CTA, shared by host and device.
struct Smem {
  size_t tile, act, sqs, cnt, red, fcol, flag, badacc, total;
  __host__ __device__ Smem(int rows, int c, int elem) {
    int stride = c + 4 / elem;  // padded row: odd word stride, no bank conflicts
    size_t o = 0;
    tile = o;
    o += ((size_t)rows * stride * elem + 15) / 16 * 16;
    act = o;
    o += (size_t)rows * 4;
    sqs = o;
    o += (size_t)rows * 4;
    cnt = o;
    o += 4 * kThreads * 4;
    red = o;
    o += 3 * kThreads * 4;
    fcol = o;
    o += (size_t)c * 4;
    flag = o;
    o += rows;
    badacc = o;
    o += rows;
    total = (o + 15) / 16 * 16;
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// NaN-propagating max/min, as jnp.max/jnp.min reduce.
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || a >= b) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || a <= b) ? a : b;
}

// The forged value of one column, before rounding to the storage dtype,
// from the active rows' statistics: ALIE mean + z sd (ddof 1 over nb rows,
// from the summed squared deviations `var`), IPM -scale mean, Adaptive
// (Fang) its four sign cases from the column's max/min and uniform `r`.
__device__ __forceinline__ float forge_value(int forge, float mean, float var, float nb,
                                             float mx, float mn, float r, const float* fc) {
  if (forge == kForgeAlie) return mean + fc[0] * sqrtf(var / fmaxf(nb - 1.f, 1.f));
  if (forge == kForgeIpm) return fc[0] * mean;
  const float neg_pos = r * (fc[0] * mx) + mx;
  const float neg_neg = r * (fc[1] * mx) + mx;
  const float pos_pos = r * (fc[2] * mn) + mn / fc[4];
  const float pos_neg = r * (fc[3] * mn) + mn * fc[5];
  if (mean < 0.f) return mx > 0.f ? neg_pos : neg_neg;
  if (mean > 0.f) return mn > 0.f ? pos_pos : pos_neg;
  return mean;
}

// The trimmed mean of one column of n values (the forged row's `mult`
// copies among them) cut k from each end, from the two cut keys' values
// flo/fhi, the counts strictly below and equal to each, and `sm`, the sum
// of the stored values strictly between them: the forged row's share is
// added here, then the tie correction at both cuts.
__device__ __forceinline__ float trimmed_value(float sm, int mult, float forged, bool f_inside,
                                               int compact, int lt_lo, int eq_lo, int lt_hi,
                                               int eq_hi, int n, int k, float flo, float fhi,
                                               bool same_cut) {
  if (mult) {
    if (compact)
      sm += ((float)mult * forged) * (f_inside ? 1.f : 0.f);
    else if (f_inside)
      sm += (float)mult * forged;
  }
  const int lo_keep = max(min(lt_lo + eq_lo, n - k) - max(lt_lo, k), 0);
  const int hi_keep = max(min(lt_hi + eq_hi, n - k) - max(lt_hi, k), 0);
  const int kept = n - 2 * k;
  float total = sm + (float)lo_keep * flo + (float)hi_keep * fhi;
  if (same_cut) total = flo * (float)kept;
  return total * (1.0f / (float)kept);  // as XLA lowers x / const
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) finish_kernel(Args a) {
  using TR = Tr<T>;
  constexpr int G = kThreads / C;
  constexpr int S = C + 4 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(a.rows, C, (int)sizeof(T));
  T* tile = reinterpret_cast<T*>(smem + L.tile);
  int* act = reinterpret_cast<int*>(smem + L.act);
  float* sqs = reinterpret_cast<float*>(smem + L.sqs);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* fcol = reinterpret_cast<float*>(smem + L.fcol);
  uint8_t* flag = smem + L.flag;
  uint8_t* badacc = smem + L.badacc;
  __shared__ int na_sh;

  const T* X = static_cast<const T*>(a.x);
  const int tid = threadIdx.x;
  const int c = tid % C;
  const int g = tid / C;
  const int rows = a.rows;
  const long long d = a.d;

  if (tid == 0) {
    int na = 0;
    for (int r = 0; r < rows; ++r)
      if (a.active == nullptr || a.active[r]) act[na++] = r;
    na_sh = na;
  }
  for (int r = tid; r < rows; r += kThreads) {
    sqs[r] = 0.f;
    flag[r] = 0;
    badacc[r] = 0;
  }
  __syncthreads();
  const int na = na_sh;
  // Counts and ranks come from the device-side active list: no host sync.
  const int mult = a.active != nullptr ? rows - na : a.mult;
  const int n_true = na + mult;
  const float nb = (float)max(na, 1);
  const bool want_sq = a.sq_part != nullptr;
  const bool need_sum = a.forge != kForgeNone || a.agg == kAggMean;
  float fsq_acc = 0.f;  // thread 0 only

  const long long nstripes = (d + kStripe - 1) / kStripe;
  for (long long s = blockIdx.x; s < nstripes; s += gridDim.x) {
    const long long s0 = s * kStripe;
    if (a.sanitize) {
      const int warp = tid / 32, lane = tid % 32;
      const int sw = (int)min((long long)kStripe, d - s0);
      for (int r = warp; r < rows; r += kThreads / 32) {
        const T* row = X + (size_t)r * d + s0;
        bool bad = false;
        for (int j = lane; j < sw; j += 32) bad |= !TR::finite(row[j]);
        bad = __any_sync(0xFFFFFFFFu, bad);
        if (lane == 0) {
          flag[r] = bad;
          if (bad) badacc[r] = 1;
        }
      }
      __syncthreads();
    }
    for (int j0 = 0; j0 < kStripe; j0 += C) {
      const long long c0 = s0 + j0;
      if (c0 >= d) break;
      const int w = (int)min((long long)C, d - c0);

      // Load the sub-slab of active rows.
      if (a.aligned) {
        constexpr int E = 4 / (int)sizeof(T);
        constexpr int U = C / E;
        for (int u = tid; u < na * U; u += kThreads) {
          const int i = u / U, cu = (u % U) * E;
          if (cu < w) cp_async4(tile + i * S + cu, X + (size_t)act[i] * d + c0 + cu);
        }
        cp_async_wait_all();
      } else {
        for (int e = tid; e < na * C; e += kThreads) {
          const int i = e / C, cc = e % C;
          if (cc < w) tile[i * S + cc] = X[(size_t)act[i] * d + c0 + cc];
        }
      }
      __syncthreads();

      // Values -> keys in place; sanitized rows and padding columns are +0.
      for (int e = tid; e < na * C; e += kThreads) {
        const int i = e / C, cc = e % C;
        uint32_t k = TR::kZeroKey;
        if (cc < w && !(a.sanitize && flag[act[i]])) k = TR::key_bits(tile[i * S + cc]);
        tile[i * S + cc] = (T)k;
      }
      __syncthreads();

      if (want_sq) {
        for (int i = tid; i < na; i += kThreads) {
          float acc = 0.f;
          for (int cc = 0; cc < w; ++cc) {
            const float v = TR::val(tile[i * S + cc]);
            acc += v * v;
          }
          sqs[i] += acc;
        }
      }

      // Per-column statistics and the forged row.
      float colsum = 0.f, forged = 0.f;
      uint32_t fkey = 0;
      if (need_sum) {
        float ps = 0.f;
        for (int i = g; i < na; i += G) ps += TR::val(tile[i * S + c]);
        red[tid] = ps;
        __syncthreads();
        for (int gg = 0; gg < G; ++gg) colsum += red[gg * C + c];
        __syncthreads();
      }
      if (a.forge != kForgeNone) {
        const float mean = colsum / nb;
        float var = 0.f, mx = -INFINITY, mn = INFINITY, r = 0.f;
        if (a.forge == kForgeAlie) {
          float pv = 0.f;
          for (int i = g; i < na; i += G) {
            const float dv = TR::val(tile[i * S + c]) - mean;
            pv += dv * dv;
          }
          red[tid] = pv;
          __syncthreads();
          for (int gg = 0; gg < G; ++gg) var += red[gg * C + c];
          __syncthreads();
        } else if (a.forge == kForgeAdaptive) {
          for (int i = g; i < na; i += G) {
            const float v = TR::val(tile[i * S + c]);
            mx = nmax(mx, v);
            mn = nmin(mn, v);
          }
          red[tid] = mx;
          red[kThreads + tid] = mn;
          __syncthreads();
          mx = -INFINITY;
          mn = INFINITY;
          for (int gg = 0; gg < G; ++gg) {
            mx = nmax(mx, red[gg * C + c]);
            mn = nmin(mn, red[kThreads + gg * C + c]);
          }
          __syncthreads();
          r = (c < w && a.noise != nullptr) ? a.noise[c0 + c] : 0.f;
        }
        forged = forge_value(a.forge, mean, var, nb, mx, mn, r, a.fc);
        forged = TR::round_store(forged);
        fkey = TR::key_f(forged);
        if (want_sq && !a.compact) {
          if (g == 0) fcol[c] = c < w ? forged * forged : 0.f;
          __syncthreads();
          if (tid == 0)
            for (int cc = 0; cc < C; ++cc) fsq_acc += fcol[cc];
        }
      }

      float out;
      if (a.agg == kAggMean) {
        out = (colsum + (float)mult * forged) / (float)n_true;
      } else {
        const int kA = a.agg == kAggMedian ? (n_true - 1) / 2 : a.k_cut;
        const int kB = a.agg == kAggMedian ? n_true / 2 : n_true - 1 - a.k_cut;
        uint32_t resA = 0, resB = 0;
        for (int bit = TR::kBits - 1; bit >= 0; --bit) {
          const uint32_t candA = resA | (1u << bit), candB = resB | (1u << bit);
          int ca = 0, cb = 0;
          for (int i = g; i < na; i += G) {
            const uint32_t k = tile[i * S + c];
            ca += k < candA;
            cb += k < candB;
          }
          int* buf = cnt + (bit & 1) * 2 * kThreads;
          buf[tid] = ca;
          buf[kThreads + tid] = cb;
          __syncthreads();
          int ta = mult * (fkey < candA), tb = mult * (fkey < candB);
          for (int gg = 0; gg < G; ++gg) {
            ta += buf[gg * C + c];
            tb += buf[kThreads + gg * C + c];
          }
          if (ta <= kA) resA = candA;
          if (tb <= kB) resB = candB;
        }
        if (a.agg == kAggMedian) {
          out = kA == kB ? TR::val(resA) : (TR::val(resA) + TR::val(resB)) * 0.5f;
        } else {
          const uint32_t vlo = resA, vhi = resB;
          const float flo = TR::val(vlo), fhi = TR::val(vhi);
          float sm = 0.f;
          int lt_lo = 0, eq_lo = 0, lt_hi = 0, eq_hi = 0;
          for (int i = g; i < na; i += G) {
            const uint32_t k = tile[i * S + c];
            if (k > vlo && k < vhi) sm += TR::val(k);
            lt_lo += k < vlo;
            eq_lo += k == vlo;
            lt_hi += k < vhi;
            eq_hi += k == vhi;
          }
          __syncthreads();  // the last select step may still read cnt
          red[tid] = sm;
          cnt[tid] = lt_lo;
          cnt[kThreads + tid] = eq_lo;
          cnt[2 * kThreads + tid] = lt_hi;
          cnt[3 * kThreads + tid] = eq_hi;
          __syncthreads();
          sm = 0.f;
          lt_lo = mult * (fkey < vlo);
          eq_lo = mult * (fkey == vlo);
          lt_hi = mult * (fkey < vhi);
          eq_hi = mult * (fkey == vhi);
          for (int gg = 0; gg < G; ++gg) {
            const int o = gg * C + c;
            sm += red[o];
            lt_lo += cnt[o];
            eq_lo += cnt[kThreads + o];
            lt_hi += cnt[2 * kThreads + o];
            eq_hi += cnt[3 * kThreads + o];
          }
          out = trimmed_value(sm, mult, forged, fkey > vlo && fkey < vhi, a.compact, lt_lo,
                              eq_lo, lt_hi, eq_hi, n_true, a.k_cut, flo, fhi, vlo == vhi);
        }
      }
      if (g == 0 && c < w) {
        a.agg_out[c0 + c] = out;
        if (a.forged_out != nullptr) a.forged_out[c0 + c] = forged;
      }
      __syncthreads();  // the next sub-slab overwrites the tile
    }
  }

  const size_t b = blockIdx.x;
  if (want_sq) {
    for (int i = tid; i < na; i += kThreads) a.sq_part[b * (rows + 1) + act[i]] = sqs[i];
    if (tid == 0) a.sq_part[b * (rows + 1) + rows] = fsq_acc;
  }
  for (int r = tid; r < rows; r += kThreads) a.bad_part[b * rows + r] = badacc[r];
}

// ---- The radix route: bf16 rows that are 16-byte aligned -----------------
//
// Replaces finish_kernel for bf16 storage whenever d % 8 == 0, the base
// is 16-byte aligned (the streamed round pads its buffer to 512-column
// stripes, as the JAX package does, so its rows always are) and a two-slab
// ring of the rows fits one CTA's shared memory (up to 1,317 rows).  It computes
// exactly what finish_kernel computes; what differs is how:
//
//  - Slabs of 32 columns x all active rows stream into a ring of two or
//    three shared-memory buffers with 16-byte cp.async, one or two slabs
//    ahead of the one being worked on, so loads overlap the select.  The
//    tile keeps the raw bf16 bits.
//  - Lane = column, warp = row group: a warp reads 32 neighbouring columns
//    of one row (64 bytes, conflict-free), four rows a step.  One pass over
//    the tile takes the column sums (and Adaptive's max/min) and a
//    histogram of each value's raw top byte, which is the key's top byte
//    relabelled (raw_of) for every value but -NaN; a NaN column sum sends
//    the slab through a fix-up that moves -NaNs to the top bucket.  The row
//    norms come from a second thread map that reads 16-byte row pieces.
//  - The select is two 8-bit digit passes instead of 16 bit steps.  The
//    top-byte histogram (hist[bin][column]: lane l only ever touches bank
//    l, so the atomics never conflict inside a warp) gives, per column, the
//    buckets holding both ranks a median or trimmed mean needs, from one
//    walk of the cumulative counts split over the 16 warps.  A second
//    histogram of the low byte over only the values in those buckets, the
//    two ranks packed in one 32-bit counter (low and high 16 bits),
//    finishes both.  The virtual forged row adds `mult` to its key's bin in
//    each walk.  The walks also give the counts below and at each cut that
//    the trimmed mean's tie correction needs.
//  - Every reduction over row groups runs in a fixed order; the row norms
//    and flags are written as per-CTA partials reduced by finalize_kernel.
//
// Bound on the H100: one read of the (active rows, d) bf16 matrix at 3.35
// TB/s.  Two things keep the kernel above it (measured on an H100 SXM):
// 64-byte row pieces, as 32 bf16 columns of 750 rows are, stream at about
// 1.9 TB/s (128-byte pieces reach about 2.9, but 64-column slabs of 750
// rows do not fit twice in shared memory beside the histogram); and the
// shared-memory traffic of the select, about five operations per element
// (the tile read by each pass, one histogram update per element in each
// digit pass), which takes most of the time.

constexpr int kRThreads = 512;
constexpr int kRWarps = kRThreads / 32;
constexpr int kRCols = 32;                   // columns per slab, one per lane
constexpr int kSlabsPerStripe = kStripe / kRCols;
constexpr int kBins = 256;                   // one 8-bit digit
constexpr int kPartBins = kBins / kRWarps;   // bins one warp walks per column
constexpr int kRSmemCap = 226 * 1024;

// Per-column select state in shared memory, one int per column each.
enum ColField { cBinA, cBinB, cBelowA, cBelowB, cResA, cResB, cLtA, cEqA, cLtB, cEqB,
                kColFields };

struct RSmem {
  size_t tile, hist, act, sqs, list, red, psum, negc, col, flag, badacc, total;
  __host__ __device__ RSmem(int rows, int stages) {
    size_t o = 0;
    tile = o;
    o += (size_t)stages * rows * kRCols * 2;  // 64-byte rows: 16-byte aligned
    hist = o;
    o += (size_t)kBins * kRCols * 4;
    act = o;
    o += (size_t)rows * 4;
    sqs = o;
    o += (size_t)rows * 4;
    list = o;
    o += (size_t)rows * 4;
    red = o;
    o += 3 * kRWarps * kRCols * 4;
    psum = o;
    o += kRWarps * kRCols * 4;
    negc = o;
    o += kRWarps * kRCols * 4;
    col = o;
    o += kColFields * kRCols * 4;
    flag = o;
    o += rows;
    badacc = o;
    o += rows;
    total = (o + 15) / 16 * 16;
  }
};

// The raw bf16 byte holding key byte `kb` in the same position: the top
// byte maps this way for every value but -NaN (raw 0xFF.., key 0xFFFF),
// and inside one top-byte bucket the low byte maps the same way.
__device__ __forceinline__ int raw_of(int kb) { return kb >= 0x80 ? kb - 0x80 : 0xFF - kb; }
__device__ __forceinline__ bool neg_nan(uint32_t v) {
  return (v & 0x8000u) && (v & 0x7FFFu) > 0x7F80u;
}
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ bool finite2(uint32_t w) {  // two bf16 in a word
  return (w & 0x7F80u) != 0x7F80u && (w & 0x7F800000u) != 0x7F800000u;
}
__device__ __forceinline__ float sq8(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(w[j] << 16), hi = __uint_as_float(w[j] & 0xFFFF0000u);
    s += lo * lo;
    s += hi * hi;
  }
  return s;
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int kStages>
__global__ void __launch_bounds__(kRThreads, 1) radix_kernel(Args a) {
  using TR = Tr<uint16_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = a.rows;
  const RSmem L(rows, kStages);
  uint16_t* tiles = reinterpret_cast<uint16_t*>(smem + L.tile);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* act = reinterpret_cast<int*>(smem + L.act);
  float* sqs = reinterpret_cast<float*>(smem + L.sqs);
  int* list = reinterpret_cast<int*>(smem + L.list);
  float* rsum = reinterpret_cast<float*>(smem + L.red);
  float* rmx = rsum + kRWarps * kRCols;  // Adaptive's max, or ALIE's variance
  float* rmn = rmx + kRWarps * kRCols;
  unsigned* psum = reinterpret_cast<unsigned*>(smem + L.psum);
  int* negc = reinterpret_cast<int*>(smem + L.negc);
  int* col = reinterpret_cast<int*>(smem + L.col);
  uint8_t* flag = smem + L.flag;
  uint8_t* badacc = smem + L.badacc;
  __shared__ int na_sh, nflag_sh;

  const uint16_t* X = static_cast<const uint16_t*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d = a.d;

  // The active rows in row order, built with ballots by warp 0.
  if (warp == 0) {
    int n = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const bool on = r < rows && (a.active == nullptr || a.active[r]);
      const unsigned m = __ballot_sync(0xFFFFFFFFu, on);
      if (on) act[n + __popc(m & ((1u << lane) - 1u))] = r;
      n += __popc(m);
    }
    if (lane == 0) {
      na_sh = n;
      nflag_sh = 0;
    }
  }
  for (int r = tid; r < rows; r += kRThreads) {
    sqs[r] = 0.f;
    flag[r] = 0;
    badacc[r] = 0;
  }
  for (int e = tid; e < kBins * kRCols; e += kRThreads) hist[e] = 0;
  __syncthreads();
  const int na = na_sh;
  const int mult = a.active != nullptr ? rows - na : a.mult;
  const int n_true = na + mult;
  const float nb = (float)max(na, 1);
  const int kA = a.agg == kAggMedian ? (n_true - 1) / 2 : a.k_cut;
  const int kB = a.agg == kAggMedian ? n_true / 2 : n_true - 1 - a.k_cut;
  const bool select = a.agg != kAggMean;
  const bool want_sq = a.sq_part != nullptr;
  const bool adaptive = a.forge == kForgeAdaptive;
  float fsq_acc = 0.f;  // thread 0 only

  const long long nstripes = (d + kStripe - 1) / kStripe;
  const long long mine =
      nstripes > (long long)blockIdx.x ? (nstripes - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long nslabs = mine * kSlabsPerStripe;
  auto slab_c0 = [&](long long t) -> long long {
    return ((long long)blockIdx.x + (t / kSlabsPerStripe) * gridDim.x) * kStripe +
           (t % kSlabsPerStripe) * kRCols;
  };
  auto slab_tile = [&](long long t) { return tiles + (size_t)(t % kStages) * rows * kRCols; };
  // Slab t into its ring buffer: 16-byte pieces of the active rows; the
  // pieces past d (a ragged last slab) are zero.  One commit group a slab,
  // empty past the end, so wait_group counts stay uniform.
  auto load = [&](long long t) {
    if (t < nslabs) {
      const long long c0 = slab_c0(t);
      if (c0 < d) {
        uint16_t* B = slab_tile(t);
        const long long w = d - c0;
        for (int u = tid; u < na * 4; u += kRThreads) {
          const int i = u >> 2, q = (u & 3) * 8;
          uint16_t* dst = B + i * kRCols + q;
          if (q < w)
            cp_async16(dst, X + (size_t)act[i] * d + c0 + q);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };

  for (int t = 0; t < kStages - 1; ++t) load(t);
  for (long long t = 0; t < nslabs; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab t landed; every thread is done with slab t - 1
    load(t + kStages - 1);
    const long long c0 = slab_c0(t);
    if (c0 >= d) continue;  // past the ragged last stripe (uniform)
    const int w = (int)min((long long)kRCols, d - c0);
    uint16_t* B = slab_tile(t);

    if (a.sanitize && t % kSlabsPerStripe == 0) {
      // Flag every row holding a non-finite value in this stripe, then list
      // the active ones: their tile rows read as +0 for the whole stripe.
      const int sw = (int)min((long long)kStripe, d - c0);
      for (int r = warp; r < rows; r += kRWarps) {
        const uint16_t* row = X + (size_t)r * d + c0;
        bool bad = false;
        for (int j = lane * 8; j < sw; j += 32 * 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + j);
          bad |= !(finite2(v.x) && finite2(v.y) && finite2(v.z) && finite2(v.w));
        }
        bad = __any_sync(0xFFFFFFFFu, bad);
        if (lane == 0) {
          flag[r] = bad;
          if (bad) badacc[r] = 1;
        }
      }
      __syncthreads();
      if (warp == 0) {
        int n = 0;
        for (int i0 = 0; i0 < na; i0 += 32) {
          const int i = i0 + lane;
          const bool on = i < na && flag[act[i]];
          const unsigned m = __ballot_sync(0xFFFFFFFFu, on);
          if (on) list[n + __popc(m & ((1u << lane) - 1u))] = i;
          n += __popc(m);
        }
        if (lane == 0) nflag_sh = n;
      }
      __syncthreads();
    }
    const int nflag = a.sanitize ? nflag_sh : 0;
    if (nflag) {
      for (int e = tid; e < nflag * kRCols; e += kRThreads) B[list[e >> 5] * kRCols + (e & 31)] = 0;
      __syncthreads();
    }

    // Pass A: column sums, Adaptive's max/min, and the histogram of the
    // raw top byte, which is the key's top byte relabelled (raw_of) for
    // every value but -NaN; a column sum that is NaN triggers the fix-up.
    {
      float cs = 0.f, mx = -INFINITY, mn = INFINITY;
      int* hl = hist + lane;
      if (select && !adaptive) {
        // Four rows a step, their loads issued before any atomic, and
        // four partial sums, so the dependent chains overlap.
        float c4[4] = {0.f, 0.f, 0.f, 0.f};
        int i = warp;
        for (; i + 3 * kRWarps < na; i += 4 * kRWarps) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = B[(i + j * kRWarps) * kRCols + lane];
#pragma unroll
          for (int j = 0; j < 4; ++j) c4[j] += bf16_bits_to_f32(v[j]);
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(hl + (v[j] >> 8) * kRCols, 1);
        }
        for (; i < na; i += kRWarps) {
          const uint32_t v = B[i * kRCols + lane];
          c4[0] += bf16_bits_to_f32(v);
          atomicAdd(hl + (v >> 8) * kRCols, 1);
        }
        cs = (c4[0] + c4[1]) + (c4[2] + c4[3]);
      } else {
        for (int i = warp; i < na; i += kRWarps) {
          const uint32_t v = B[i * kRCols + lane];
          const float f = bf16_bits_to_f32(v);
          cs += f;
          if (adaptive) {
            mx = nmax(mx, f);
            mn = nmin(mn, f);
          }
          if (select) atomicAdd(hl + (v >> 8) * kRCols, 1);
        }
      }
      rsum[warp * kRCols + lane] = cs;
      if (adaptive) {
        rmx[warp * kRCols + lane] = mx;
        rmn[warp * kRCols + lane] = mn;
      }
    }
    // Row norms: four threads a row, eight columns each, a fixed tree.
    if (want_sq) {
      const int q = tid & 3;
      for (int i0 = 0; i0 < na; i0 += kRThreads / 4) {
        const int i = i0 + (tid >> 2);
        float s = i < na ? sq8(*reinterpret_cast<const uint4*>(B + i * kRCols + q * 8)) : 0.f;
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
        s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
        if (q == 0 && i < na) sqs[i] += s;
      }
    }
    __syncthreads();

    float colsum = 0.f;
    for (int gg = 0; gg < kRWarps; ++gg) colsum += rsum[gg * kRCols + lane];
    const float mean = colsum / nb;
    if (a.forge == kForgeAlie) {
      float p4[4] = {0.f, 0.f, 0.f, 0.f};
      int i = warp;
      for (; i + 3 * kRWarps < na; i += 4 * kRWarps) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dv = bf16_bits_to_f32(B[(i + j * kRWarps) * kRCols + lane]) - mean;
          p4[j] += dv * dv;
        }
      }
      for (; i < na; i += kRWarps) {
        const float dv = bf16_bits_to_f32(B[i * kRCols + lane]) - mean;
        p4[0] += dv * dv;
      }
      rmx[warp * kRCols + lane] = (p4[0] + p4[1]) + (p4[2] + p4[3]);
    }
    if (select) {  // each warp's share of the cumulative counts, in key order
      unsigned s = 0;
      for (int b = warp * kPartBins; b < (warp + 1) * kPartBins; ++b)
        s += hist[raw_of(b) * kRCols + lane];
      psum[warp * kRCols + lane] = s;
    }
    if (__syncthreads_or(select && isnan(colsum))) {
      // Some column holds a NaN: a -NaN was counted in raw bucket 0xFF (key
      // bucket 0x00) but its key 0xFFFF belongs to key bucket 0xFF.
      int m = 0;
      for (int i = warp; i < na; i += kRWarps) m += neg_nan(B[i * kRCols + lane]);
      negc[warp * kRCols + lane] = m;
      __syncthreads();
      if (warp == 0) {
        m = 0;
        for (int gg = 0; gg < kRWarps; ++gg) m += negc[gg * kRCols + lane];
        hist[raw_of(0x00) * kRCols + lane] -= m;
        hist[raw_of(0xFF) * kRCols + lane] += m;
        psum[lane] -= (unsigned)m;
        psum[(kRWarps - 1) * kRCols + lane] += (unsigned)m;
      }
      __syncthreads();
    }

    float forged = 0.f;
    uint32_t fkey = 0;
    if (a.forge != kForgeNone) {
      float var = 0.f, mx = -INFINITY, mn = INFINITY;
      if (a.forge == kForgeAlie) {
        for (int gg = 0; gg < kRWarps; ++gg) var += rmx[gg * kRCols + lane];
      } else if (adaptive) {
        for (int gg = 0; gg < kRWarps; ++gg) {
          mx = nmax(mx, rmx[gg * kRCols + lane]);
          mn = nmin(mn, rmn[gg * kRCols + lane]);
        }
      }
      const float r = (adaptive && lane < w && a.noise != nullptr) ? a.noise[c0 + lane] : 0.f;
      forged = forge_value(a.forge, mean, var, nb, mx, mn, r, a.fc);
      forged = TR::round_store(forged);
      fkey = TR::key_f(forged);
    }

    float out = 0.f;
    if (!select) {
      out = (colsum + (float)mult * forged) / (float)n_true;
    } else {
      int* cf = col + lane;
      // Walk 1: the top-byte buckets of ranks kA and kB.  The thread owns
      // key bins [b0, b0 + 16) of its column and zeroes them for pass 2.
      {
        const int b0 = warp * kPartBins;
        const int fb = (int)(fkey >> 8);
        int below = fb < b0 ? mult : 0;
        for (int pp = 0; pp < warp; ++pp) below += (int)psum[pp * kRCols + lane];
        for (int j = 0; j < kPartBins; ++j) {
          const int b = b0 + j;
          const int h = hist[raw_of(b) * kRCols + lane] + (fb == b ? mult : 0);
          hist[raw_of(b) * kRCols + lane] = 0;
          if (below <= kA && kA < below + h) {
            cf[cBinA * kRCols] = b;
            cf[cBelowA * kRCols] = below;
          }
          if (below <= kB && kB < below + h) {
            cf[cBinB * kRCols] = b;
            cf[cBelowB * kRCols] = below;
          }
          below += h;
        }
      }
      __syncthreads();
      // Pass 2: low-byte histogram of the values in either bucket, rank A
      // in the low 16 bits of a counter and rank B in the high 16.  Raw
      // bytes again (the low byte of a negative bucket runs backwards),
      // except in a column whose bucket is 0x00 or 0xFF, the two that
      // -NaN or +NaN share with finite values: there the keys themselves.
      const uint32_t bA = cf[cBinA * kRCols], bB = cf[cBinB * kRCols];
      const bool exact = bA == 0u || bA == 0xFFu || bB == 0u || bB == 0xFFu;
      {
        int* hl = hist + lane;
        const uint32_t rA = raw_of((int)bA), rB = raw_of((int)bB);
        auto count = [&](uint32_t v) {
          uint32_t hi = v >> 8, lo = v & 0xFFu;
          if (exact) {
            const uint32_t k = TR::key_bits(v);
            hi = k >> 8;
            lo = k & 0xFFu;
          }
          const int inc = (int)(hi == (exact ? bA : rA)) | ((int)(hi == (exact ? bB : rB)) << 16);
          if (inc) atomicAdd(hl + lo * kRCols, inc);
        };
        int i = warp;
        for (; i + 3 * kRWarps < na; i += 4 * kRWarps) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = B[(i + j * kRWarps) * kRCols + lane];
#pragma unroll
          for (int j = 0; j < 4; ++j) count(v[j]);
        }
        for (; i < na; i += kRWarps) count(B[i * kRCols + lane]);
      }
      __syncthreads();
      // Key-order low byte b of rank A sits at counter b ^ flipA.
      const int flipA = !exact && bA < 0x80u ? 0xFF : 0;
      const int flipB = !exact && bB < 0x80u ? 0xFF : 0;
      {
        unsigned sa = 0, sb = 0;
        for (int b = warp * kPartBins; b < (warp + 1) * kPartBins; ++b) {
          sa += (unsigned)hist[(b ^ flipA) * kRCols + lane] & 0xFFFFu;
          sb += (unsigned)hist[(b ^ flipB) * kRCols + lane] >> 16;
        }
        psum[warp * kRCols + lane] = sa | (sb << 16);
      }
      __syncthreads();
      // Walk 2: the keys of ranks kA and kB, with the counts strictly below
      // and equal to each.
      {
        const int b0 = warp * kPartBins;
        const uint32_t flo = fkey & 0xFFu;
        const int fA = (fkey >> 8) == bA ? mult : 0, fB = (fkey >> 8) == bB ? mult : 0;
        int belA = cf[cBelowA * kRCols] + ((int)flo < b0 ? fA : 0);
        int belB = cf[cBelowB * kRCols] + ((int)flo < b0 ? fB : 0);
        for (int pp = 0; pp < warp; ++pp) {
          const unsigned v = psum[pp * kRCols + lane];
          belA += (int)(v & 0xFFFFu);
          belB += (int)(v >> 16);
        }
        for (int j = 0; j < kPartBins; ++j) {
          const int b = b0 + j;
          const int hA = (int)((unsigned)hist[(b ^ flipA) * kRCols + lane] & 0xFFFFu) +
                         ((int)flo == b ? fA : 0);
          const int hB = (int)((unsigned)hist[(b ^ flipB) * kRCols + lane] >> 16) +
                         ((int)flo == b ? fB : 0);
          if (belA <= kA && kA < belA + hA) {
            cf[cResA * kRCols] = (int)((bA << 8) | (uint32_t)b);
            cf[cLtA * kRCols] = belA;
            cf[cEqA * kRCols] = hA;
          }
          if (belB <= kB && kB < belB + hB) {
            cf[cResB * kRCols] = (int)((bB << 8) | (uint32_t)b);
            cf[cLtB * kRCols] = belB;
            cf[cEqB * kRCols] = hB;
          }
          belA += hA;
          belB += hB;
        }
      }
      __syncthreads();
      // Every counter read; zero them for the next slab's pass A.
      for (int b = warp * kPartBins; b < (warp + 1) * kPartBins; ++b) hist[b * kRCols + lane] = 0;
      const uint32_t vlo = (uint32_t)cf[cResA * kRCols], vhi = (uint32_t)cf[cResB * kRCols];
      if (a.agg == kAggMedian) {
        out = kA == kB ? TR::val(vlo) : (TR::val(vlo) + TR::val(vhi)) * 0.5f;
      } else {
        float sm = 0.f;
        for (int i = warp; i < na; i += kRWarps) {
          const uint32_t v = B[i * kRCols + lane];
          const uint32_t k = TR::key_bits(v);
          if (k > vlo && k < vhi) sm += bf16_bits_to_f32(v);
        }
        rsum[warp * kRCols + lane] = sm;
        __syncthreads();
        if (warp == 0) {
          sm = 0.f;
          for (int gg = 0; gg < kRWarps; ++gg) sm += rsum[gg * kRCols + lane];
          out = trimmed_value(sm, mult, forged, fkey > vlo && fkey < vhi, a.compact,
                              cf[cLtA * kRCols], cf[cEqA * kRCols], cf[cLtB * kRCols],
                              cf[cEqB * kRCols], n_true, a.k_cut, TR::val(vlo), TR::val(vhi),
                              vlo == vhi);
        }
      }
    }
    if (warp == 0) {
      if (lane < w) {
        a.agg_out[c0 + lane] = out;
        if (a.forged_out != nullptr) a.forged_out[c0 + lane] = forged;
      }
      if (want_sq && !a.compact && a.forge != kForgeNone) {
        float f2 = lane < w ? forged * forged : 0.f;
        for (int o = 16; o > 0; o >>= 1) f2 += __shfl_xor_sync(0xFFFFFFFFu, f2, o);
        fsq_acc += f2;
      }
    }
  }
  cp_async_wait<0>();

  const size_t b = blockIdx.x;
  if (want_sq) {
    for (int i = tid; i < na; i += kRThreads) a.sq_part[b * (rows + 1) + act[i]] = sqs[i];
    if (tid == 0) a.sq_part[b * (rows + 1) + rows] = fsq_acc;
  }
  for (int r = tid; r < rows; r += kRThreads) a.bad_part[b * rows + r] = badacc[r];
}

// ---- The ring route: rows that are 16-byte aligned, any row count --------
//
// Replaces finish_kernel wherever the rows are 16-byte aligned (f32 with
// d % 4 == 0, bf16 with d % 8 == 0, a 16-byte-aligned base) and the radix
// route does not take them: f32 storage, and bf16 above radix_kernel's
// 1,317 rows.  The streamed round's padded buffer always is aligned.  It
// computes exactly what finish_kernel computes; what differs is how:
//
//  - A CTA (512 threads) owns whole 512-column stripes (the sanitize
//    granularity) and walks their 32-column slabs: lane = column, warp =
//    row, so a warp reads one 64-byte (bf16) or 128-byte (f32) row piece.
//  - A slab's active rows arrive in groups of 8 KB (128 bf16 or 64 f32
//    rows) through a ring of shared-memory stages by 16-byte cp.async,
//    `ahead` groups in flight.  Resident plan: the ring holds every group
//    of a slab beside the next slab's first `ahead` groups, so the later
//    passes read shared memory while the next slab loads.  Streaming plan
//    (more rows than fit so): every pass streams the slab's groups again.
//    Only the per-row arrays (10 bytes a row) bound the rows, at about
//    17,400; ops/_cuda.py::ring_finish_plan mirrors the plan.
//  - Pass A takes the column sums (and Adaptive's max/min), a histogram
//    of each key's top byte (hist[bin][column]: lane l only touches bank
//    l, so the atomics never conflict inside a warp) and, by a second
//    thread map of 16-byte row pieces, the row norms.  ALIE's deviations
//    pass follows; then the forged row.
//  - The select runs in 8-bit digit passes (two for bf16 keys, four for
//    f32 keys), both ranks in one counter (rank A's count in the low 16
//    bits, B's in the high 16).  After each pass a walk finds, per column,
//    the bins holding ranks kA and kB (select_kernel's walk of
//    csrc/column_select.cu); the virtual forged row adds `mult` to its
//    key's bin whenever its key shares the rank's prefix.  The walks leave
//    the counts below and equal to each rank's key, which the trimmed
//    mean's tie correction needs; its sum takes one more pass.
//  - Every reduction over rows runs in a fixed order (each thread's rows
//    in order, warps in order, no float atomics); row norms and flags go
//    to per-CTA partials that finalize_kernel reduces in CTA order.
//
// Bound on the H100: one read of the (active rows, d) matrix at 3.35 TB/s.

constexpr int kGThreads = 512;
constexpr int kGWarps = kGThreads / 32;
constexpr int kGCols = 32;          // columns per slab, one per lane
constexpr int kGroupBytes = 8192;   // one ring stage
constexpr int kGMaxAhead = 8;       // groups in flight
constexpr int kGMinAhead = 4;       // the fewest a resident slab may leave
constexpr int kGSmemCap = 226 * 1024;  // under 227 KB a block, beside static shared
constexpr int kGMaxRows = 65535;    // counts packed two to a word
constexpr int kGBinsPerWarp = kBins / kGWarps;

// Per-column select state in shared memory, one int per column each.
enum GField { gPrefA, gPrefB, gBelowA, gBelowB, gEqA, gEqB, kGFields = 8 };

// Shared-memory layout of the ring route, shared by host and device: the
// ring of `stages` 8 KB groups, the histogram, two int arrays a row (the
// active rows, the row norms), the per-warp column buffers (sums, then
// ALIE's deviations or Adaptive's max and min, then the walk's totals),
// the per-column fields, and two byte arrays a row (flags).
struct GSmem {
  size_t ring, hist, act, sqs, red, ps, col, flag, badacc, total;
  __host__ __device__ GSmem(int rows, int stages) {
    size_t o = 0;
    ring = o;
    o += (size_t)stages * kGroupBytes;
    hist = o;
    o += (size_t)kBins * kGCols * 4;
    act = o;
    o += (size_t)rows * 4;
    sqs = o;
    o += (size_t)rows * 4;
    red = o;
    o += 3 * kGWarps * kGCols * 4;
    ps = o;
    o += kGWarps * kGCols * 4;
    col = o;
    o += kGFields * kGCols * 4;
    flag = o;
    o += rows;
    badacc = o;
    o += rows;
    total = (o + 15) / 16 * 16;
  }
};

// A 16-byte row piece: all finite, and its sum of squares in a fixed order.
template <typename T>
__device__ __forceinline__ bool piece_finite(uint4 u);
template <>
__device__ __forceinline__ bool piece_finite<uint16_t>(uint4 u) {
  return finite2(u.x) && finite2(u.y) && finite2(u.z) && finite2(u.w);
}
template <>
__device__ __forceinline__ bool piece_finite<uint32_t>(uint4 u) {
  return (u.x & 0x7F800000u) != 0x7F800000u && (u.y & 0x7F800000u) != 0x7F800000u &&
         (u.z & 0x7F800000u) != 0x7F800000u && (u.w & 0x7F800000u) != 0x7F800000u;
}
template <typename T>
__device__ __forceinline__ float piece_sq(uint4 u);
template <>
__device__ __forceinline__ float piece_sq<uint16_t>(uint4 u) {
  return sq8(u);
}
template <>
__device__ __forceinline__ float piece_sq<uint32_t>(uint4 u) {
  const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                      __uint_as_float(u.w)};
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) s += v[j] * v[j];
  return s;
}

// Wait until at most n commit groups are pending (n < kGMaxAhead).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
#define BT_WAIT_CASE(N) \
  case N:               \
    asm volatile("cp.async.wait_group " #N ";\n" ::); \
    break;
  switch (n) {
    BT_WAIT_CASE(0) BT_WAIT_CASE(1) BT_WAIT_CASE(2) BT_WAIT_CASE(3)
    BT_WAIT_CASE(4) BT_WAIT_CASE(5) BT_WAIT_CASE(6)
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
#undef BT_WAIT_CASE
}

// The walk after a digit pass at shift `ds`: warp w owns bins [16w, 16w +
// 16) of column `lane`.  Each thread reads and zeroes its 16 packed
// counters once, publishes their total, and takes the count below its
// bins from the totals of the warps before it and the counts below the
// ranks' prefixes; fbA / fbB is the forged row's bin when its key shares
// rank A's / B's prefix (else -1), and adds `mult` there.  The thread whose
// bins hold rank kA (kB) writes the rank's key prefix, the count below it
// and its bin's count to the column's fields.
__device__ __forceinline__ void ring_walk(int* hl, unsigned* ps, int* cf, int warp, int lane,
                                          int kA, int kB, uint32_t prefA, uint32_t prefB,
                                          int belowA, int belowB, int ds, int fbA, int fbB,
                                          int mult) {
  const int b0 = warp * kGBinsPerWarp;
  unsigned v[kGBinsPerWarp];
  unsigned t = 0;
#pragma unroll
  for (int j = 0; j < kGBinsPerWarp; ++j) {
    v[j] = (unsigned)hl[(b0 + j) * kGCols];
    hl[(b0 + j) * kGCols] = 0;
    t += v[j];
  }
  ps[warp * kGCols + lane] = t;
  __syncthreads();
  unsigned bel = 0;
  for (int w = 0; w < warp; ++w) bel += ps[w * kGCols + lane];
  const bool inA = fbA >= b0 && fbA < b0 + kGBinsPerWarp;
  const bool inB = fbB >= b0 && fbB < b0 + kGBinsPerWarp;
  int belA = belowA + (int)(bel & 0xFFFFu) + (fbA >= 0 && fbA < b0 ? mult : 0);
  int belB = belowB + (int)(bel >> 16) + (fbB >= 0 && fbB < b0 ? mult : 0);
  const int ta = (int)(t & 0xFFFFu) + (inA ? mult : 0);
  const int tb = (int)(t >> 16) + (inB ? mult : 0);
  if (belA <= kA && kA < belA + ta) {
    bool found = false;
#pragma unroll
    for (int j = 0; j < kGBinsPerWarp; ++j) {
      const int c = (int)(v[j] & 0xFFFFu) + (fbA == b0 + j ? mult : 0);
      if (!found && kA < belA + c) {
        found = true;
        cf[gPrefA * kGCols] = (int)(prefA | ((uint32_t)(b0 + j) << ds));
        cf[gBelowA * kGCols] = belA;
        cf[gEqA * kGCols] = c;
      }
      belA += c;
    }
  }
  if (belB <= kB && kB < belB + tb) {
    bool found = false;
#pragma unroll
    for (int j = 0; j < kGBinsPerWarp; ++j) {
      const int c = (int)(v[j] >> 16) + (fbB == b0 + j ? mult : 0);
      if (!found && kB < belB + c) {
        found = true;
        cf[gPrefB * kGCols] = (int)(prefB | ((uint32_t)(b0 + j) << ds));
        cf[gBelowB * kGCols] = belB;
        cf[gEqB * kGCols] = c;
      }
      belB += c;
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kGThreads, 1) ring_kernel(Args a) {
  using TR = Tr<T>;
  constexpr int E = 16 / (int)sizeof(T);                          // elements a piece
  constexpr int P = kGCols / E;                                   // pieces a slab row
  constexpr int GH = kGroupBytes / (kGCols * (int)sizeof(T));     // rows a group
  constexpr int kDigits = TR::kBits / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = a.rows, S = a.stages, ahead = a.ahead;
  const bool resident = a.resident != 0;
  const GSmem L(rows, S);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* act = reinterpret_cast<int*>(smem + L.act);
  float* sqs = reinterpret_cast<float*>(smem + L.sqs);
  float* rsum = reinterpret_cast<float*>(smem + L.red);
  float* rmx = rsum + kGWarps * kGCols;  // ALIE's deviations, or Adaptive's max
  float* rmn = rmx + kGWarps * kGCols;
  unsigned* ps = reinterpret_cast<unsigned*>(smem + L.ps);
  int* col = reinterpret_cast<int*>(smem + L.col);
  uint8_t* flag = smem + L.flag;
  uint8_t* badacc = smem + L.badacc;
  __shared__ int na_sh;

  const T* X = static_cast<const T*>(a.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d = a.d;

  // The active rows in row order, built with ballots by warp 0.
  if (warp == 0) {
    int n = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const int r = r0 + lane;
      const bool on = r < rows && (a.active == nullptr || a.active[r]);
      const unsigned m = __ballot_sync(0xFFFFFFFFu, on);
      if (on) act[n + __popc(m & ((1u << lane) - 1u))] = r;
      n += __popc(m);
    }
    if (lane == 0) na_sh = n;
  }
  for (int r = tid; r < rows; r += kGThreads) {
    sqs[r] = 0.f;
    flag[r] = 0;
    badacc[r] = 0;
  }
  for (int e = tid; e < kBins * kGCols; e += kGThreads) hist[e] = 0;
  __syncthreads();
  const int na = na_sh;
  const int mult = a.active != nullptr ? rows - na : a.mult;
  const int n_true = na + mult;
  const float nb = (float)max(na, 1);
  const int kA = a.agg == kAggMedian ? (n_true - 1) / 2 : a.k_cut;
  const int kB = a.agg == kAggMedian ? n_true / 2 : n_true - 1 - a.k_cut;
  const bool select = a.agg != kAggMean;
  const bool trimmed = a.agg == kAggTrimmed;
  const bool want_sq = a.sq_part != nullptr;
  const bool alie = a.forge == kForgeAlie;
  const bool adaptive = a.forge == kForgeAdaptive;
  const int ng = max((na + GH - 1) / GH, 1);  // groups a slab
  // Streamed passes a slab: pass A; streaming, also ALIE's deviations, the
  // digit passes after the first and the trimmed sum.
  const int npass =
      resident ? 1 : 1 + (alie ? 1 : 0) + (select ? kDigits - 1 : 0) + (trimmed ? 1 : 0);
  const long long nstripes = (d + kStripe - 1) / kStripe;
  auto slabs_in = [&](long long s) -> int {  // the last stripe may be ragged
    return (int)min((long long)kSlabsPerStripe, (d - s * kStripe + kGCols - 1) / kGCols);
  };
  int* hl = hist + lane;
  int* cf = col + lane;
  float fsq_acc = 0.f;  // thread 0 only

  // The load cursor: stripe ls, its slab lj, group lg, pass repeat lrep,
  // and the ring stage.  One commit group a call (empty past the end, so
  // wait counts stay uniform); pieces past d read as +0.
  long long ls = blockIdx.x;
  int lj = 0, lg = 0, lrep = 0, lstage = 0;
  auto load_next = [&]() {
    if (ls < nstripes) {
      const int r0 = lg * GH, nv = min(GH, na - r0);
      T* dst = ring + (size_t)lstage * GH * kGCols;
      const long long c0 = ls * kStripe + (long long)lj * kGCols;
      for (int u = tid; u < nv * P; u += kGThreads) {
        const int i = u / P, q = (u % P) * E;
        if (c0 + q < d)
          cp_async16(dst + i * kGCols + q, X + (size_t)act[r0 + i] * d + c0 + q);
        else
          *reinterpret_cast<uint4*>(dst + i * kGCols + q) = make_uint4(0u, 0u, 0u, 0u);
      }
      if (++lg == ng) {
        lg = 0;
        if (++lrep == npass) {
          lrep = 0;
          if (++lj == slabs_in(ls)) {
            lj = 0;
            ls += gridDim.x;
          }
        }
      }
    }
    cp_async_commit();
    if (++lstage == S) lstage = 0;
  };
  for (int i = 0; i < ahead; ++i) load_next();

  int cstage = 0;     // ring stage of the next group to arrive
  bool nflag = false;  // an active row of this stripe is flagged
  // Every group of the slab arrives and, for each, `fn(B, nv, g)` runs on
  // its stage: the slab's active rows [g * GH, g * GH + nv).  Flagged rows
  // read as +0 for the whole stripe.
  auto stream_pass = [&](auto&& fn) {
    for (int g = 0; g < ng; ++g) {
      cp_async_wait_dyn(ahead - 1);
      __syncthreads();  // group landed; every thread is done with the stage reloaded next
      load_next();
      T* B = ring + (size_t)cstage * GH * kGCols;
      if (++cstage == S) cstage = 0;
      const int nv = max(0, min(GH, na - g * GH));
      if (nflag) {
        for (int u = tid; u < nv * P; u += kGThreads)
          if (flag[act[g * GH + u / P]])
            *reinterpret_cast<uint4*>(B + (u / P) * kGCols + (u % P) * E) =
                make_uint4(0u, 0u, 0u, 0u);
        __syncthreads();
      }
      fn(B, nv, g);
    }
  };
  // A pass after pass A: over the slab's resident groups from stage st0,
  // or streamed again.
  auto later_pass = [&](int st0, auto&& fn) {
    if (!resident) {
      stream_pass(fn);
      return;
    }
    for (int g = 0; g < ng; ++g) {
      int st = st0 + g;
      if (st >= S) st -= S;
      fn(ring + (size_t)st * GH * kGCols, max(0, min(GH, na - g * GH)), g);
    }
  };

  for (long long s = blockIdx.x; s < nstripes; s += gridDim.x) {
    const long long s0 = s * kStripe;
    if (a.sanitize) {
      // Flag every row holding a non-finite value in this stripe.
      __syncthreads();  // the last stripe's passes are done with flag[]
      const int sw = (int)min((long long)kStripe, d - s0);
      bool mine = false;
      for (int r = warp; r < rows; r += kGWarps) {
        const T* row = X + (size_t)r * d + s0;
        bool bad = false;
        for (int j = lane * E; j < sw; j += 32 * E)
          bad |= !piece_finite<T>(*reinterpret_cast<const uint4*>(row + j));
        bad = __any_sync(0xFFFFFFFFu, bad);
        if (lane == 0) {
          flag[r] = bad;
          if (bad) badacc[r] = 1;
        }
        mine |= bad && (a.active == nullptr || a.active[r]);
      }
      nflag = __syncthreads_or(mine) != 0;
    }
    const int nsl = slabs_in(s);
    for (int j = 0; j < nsl; ++j) {
      const long long c0 = s0 + (long long)j * kGCols;
      const int w = (int)min((long long)kGCols, d - c0);
      const int st0 = cstage;

      // Pass A: column sums (four partials a thread), Adaptive's max/min,
      // the top-byte histogram, and the row norms.
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
      float mx = -INFINITY, mn = INFINITY;
      stream_pass([&](T* B, int nv, int g) {
        if (adaptive) {
          for (int i = warp; i < nv; i += kGWarps) {
            const uint32_t v = B[i * kGCols + lane];
            const float f = TR::fval(v);
            c4[0] += f;
            mx = nmax(mx, f);
            mn = nmin(mn, f);
            if (select) atomicAdd(hl + (TR::key_bits(v) >> (TR::kBits - 8)) * kGCols, 0x10001);
          }
        } else {
          int i = warp;
          for (; i + 3 * kGWarps < nv; i += 4 * kGWarps) {
            uint32_t v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = B[(i + q * kGWarps) * kGCols + lane];
#pragma unroll
            for (int q = 0; q < 4; ++q) c4[q] += TR::fval(v[q]);
            if (select) {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                atomicAdd(hl + (TR::key_bits(v[q]) >> (TR::kBits - 8)) * kGCols, 0x10001);
            }
          }
          for (; i < nv; i += kGWarps) {
            const uint32_t v = B[i * kGCols + lane];
            c4[0] += TR::fval(v);
            if (select) atomicAdd(hl + (TR::key_bits(v) >> (TR::kBits - 8)) * kGCols, 0x10001);
          }
        }
        if (want_sq) {
          // P threads a row, one 16-byte piece each, a fixed xor tree.
          const int q = tid % P;
          for (int i0 = 0; i0 < nv; i0 += kGThreads / P) {
            const int i = i0 + tid / P;
            float sq = i < nv ? piece_sq<T>(*reinterpret_cast<const uint4*>(B + i * kGCols + q * E))
                              : 0.f;
#pragma unroll
            for (int o = 1; o < P; o <<= 1) sq += __shfl_xor_sync(0xFFFFFFFFu, sq, o);
            if (q == 0 && i < nv) sqs[g * GH + i] += sq;
          }
        }
      });
      rsum[warp * kGCols + lane] = (c4[0] + c4[1]) + (c4[2] + c4[3]);
      if (adaptive) {
        rmx[warp * kGCols + lane] = mx;
        rmn[warp * kGCols + lane] = mn;
      }
      __syncthreads();
      float colsum = 0.f;
      for (int gg = 0; gg < kGWarps; ++gg) colsum += rsum[gg * kGCols + lane];
      const float mean = colsum / nb;

      float forged = 0.f;
      uint32_t fkey = 0;
      if (a.forge != kForgeNone) {
        float var = 0.f, fmx = -INFINITY, fmn = INFINITY;
        if (alie) {
          float p4[4] = {0.f, 0.f, 0.f, 0.f};
          later_pass(st0, [&](T* B, int nv, int) {
            int i = warp;
            for (; i + 3 * kGWarps < nv; i += 4 * kGWarps) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float dv = TR::fval(B[(i + q * kGWarps) * kGCols + lane]) - mean;
                p4[q] += dv * dv;
              }
            }
            for (; i < nv; i += kGWarps) {
              const float dv = TR::fval(B[i * kGCols + lane]) - mean;
              p4[0] += dv * dv;
            }
          });
          rmx[warp * kGCols + lane] = (p4[0] + p4[1]) + (p4[2] + p4[3]);
          __syncthreads();
          for (int gg = 0; gg < kGWarps; ++gg) var += rmx[gg * kGCols + lane];
        } else if (adaptive) {
          for (int gg = 0; gg < kGWarps; ++gg) {
            fmx = nmax(fmx, rmx[gg * kGCols + lane]);
            fmn = nmin(fmn, rmn[gg * kGCols + lane]);
          }
        }
        const float r = (adaptive && lane < w && a.noise != nullptr) ? a.noise[c0 + lane] : 0.f;
        forged = forge_value(a.forge, mean, var, nb, fmx, fmn, r, a.fc);
        forged = TR::round_store(forged);
        fkey = TR::key_f(forged);
      }

      float out = 0.f;
      if (!select) {
        out = (colsum + (float)mult * forged) / (float)n_true;
      } else {
        uint32_t prefA = 0, prefB = 0;
        int belowA = 0, belowB = 0, eqA = 0, eqB = 0;
        for (int p = 0; p < kDigits; ++p) {
          const int ds = TR::kBits - 8 * (p + 1), hs = ds + 8;
          if (p > 0) {
            // Digit p of the keys that share rank A's or B's prefix.
            const uint32_t qa = prefA >> hs, qb = prefB >> hs;
            auto count = [&](uint32_t v) {
              const uint32_t k = TR::key_bits(v);
              const int inc = ((k >> hs) == qa ? 1 : 0) + ((k >> hs) == qb ? 0x10000 : 0);
              if (inc) atomicAdd(hl + ((k >> ds) & 0xFFu) * kGCols, inc);
            };
            later_pass(st0, [&](T* B, int nv, int) {
              int i = warp;
              for (; i + 3 * kGWarps < nv; i += 4 * kGWarps) {
                uint32_t v[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) v[q] = B[(i + q * kGWarps) * kGCols + lane];
#pragma unroll
                for (int q = 0; q < 4; ++q) count(v[q]);
              }
              for (; i < nv; i += kGWarps) count(B[i * kGCols + lane]);
            });
          }
          __syncthreads();  // every count of the pass is in
          int fbA = -1, fbB = -1;
          if (mult > 0) {
            const int fb = (int)((fkey >> ds) & 0xFFu);
            if (p == 0 || (fkey >> hs) == (prefA >> hs)) fbA = fb;
            if (p == 0 || (fkey >> hs) == (prefB >> hs)) fbB = fb;
          }
          ring_walk(hl, ps, cf, warp, lane, kA, kB, prefA, prefB, belowA, belowB, ds, fbA, fbB,
                    mult);
          prefA = (uint32_t)cf[gPrefA * kGCols];
          prefB = (uint32_t)cf[gPrefB * kGCols];
          belowA = cf[gBelowA * kGCols];
          belowB = cf[gBelowB * kGCols];
          eqA = cf[gEqA * kGCols];
          eqB = cf[gEqB * kGCols];
        }
        const uint32_t vlo = prefA, vhi = prefB;
        if (!trimmed) {
          out = kA == kB ? TR::val(vlo) : (TR::val(vlo) + TR::val(vhi)) * 0.5f;
        } else {
          // The stored values strictly between the two cut keys.
          float t4[4] = {0.f, 0.f, 0.f, 0.f};
          auto add = [&](float& acc, uint32_t v) {
            const uint32_t k = TR::key_bits(v);
            if (k > vlo && k < vhi) acc += TR::fval(v);
          };
          later_pass(st0, [&](T* B, int nv, int) {
            int i = warp;
            for (; i + 3 * kGWarps < nv; i += 4 * kGWarps) {
              uint32_t v[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) v[q] = B[(i + q * kGWarps) * kGCols + lane];
#pragma unroll
              for (int q = 0; q < 4; ++q) add(t4[q], v[q]);
            }
            for (; i < nv; i += kGWarps) add(t4[0], B[i * kGCols + lane]);
          });
          rsum[warp * kGCols + lane] = (t4[0] + t4[1]) + (t4[2] + t4[3]);
          __syncthreads();
          float sm = 0.f;
          for (int gg = 0; gg < kGWarps; ++gg) sm += rsum[gg * kGCols + lane];
          out = trimmed_value(sm, mult, forged, fkey > vlo && fkey < vhi, a.compact, belowA, eqA,
                              belowB, eqB, n_true, a.k_cut, TR::val(vlo), TR::val(vhi),
                              vlo == vhi);
        }
      }
      if (warp == 0) {
        if (lane < w) {
          a.agg_out[c0 + lane] = out;
          if (a.forged_out != nullptr) a.forged_out[c0 + lane] = forged;
        }
        if (want_sq && !a.compact && a.forge != kForgeNone) {
          float f2 = lane < w ? forged * forged : 0.f;
          for (int o = 16; o > 0; o >>= 1) f2 += __shfl_xor_sync(0xFFFFFFFFu, f2, o);
          fsq_acc += f2;
        }
      }
    }
  }
  cp_async_wait_dyn(0);

  const size_t b = blockIdx.x;
  if (want_sq) {
    for (int i = tid; i < na; i += kGThreads) a.sq_part[b * (rows + 1) + act[i]] = sqs[i];
    if (tid == 0) a.sq_part[b * (rows + 1) + rows] = fsq_acc;
  }
  for (int r = tid; r < rows; r += kGThreads) a.bad_part[b * rows + r] = badacc[r];
}

// Reduce the per-CTA row partials in CTA order (deterministic).
__global__ void finalize_kernel(const float* sq_part, const uint8_t* bad_part,
                                const uint8_t* active, int rows, int nblk,
                                float* sq_out, uint8_t* bad_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  if (sq_out != nullptr) {
    const int col = (active == nullptr || active[r]) ? r : rows;
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += sq_part[(size_t)b * (rows + 1) + col];
    sq_out[r] = s;
  }
  uint8_t bad = 0;
  for (int b = 0; b < nblk; ++b) bad |= bad_part[(size_t)b * rows + r];
  bad_out[r] = bad;
}

template <typename T, int C>
cudaError_t plan_one(int rows, int* smem, int* blocks_per_sm) {
  const Smem L(rows, C, (int)sizeof(T));
  *smem = (int)L.total;
  cudaError_t e = cudaFuncSetAttribute(finish_kernel<T, C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, finish_kernel<T, C>,
                                                       kThreads, L.total);
}

// Widest column slab whose shared-memory footprint leaves room for two CTAs
// per SM, else the narrowest slab that fits one CTA.
template <typename T>
int pick_cols(int rows) {
  const int opts[4] = {64, 32, 16, 8};
  for (int i = 0; i < 4; ++i)
    if (Smem(rows, opts[i], (int)sizeof(T)).total <= 110 * 1024) return opts[i];
  if (Smem(rows, 8, (int)sizeof(T)).total <= 226 * 1024) return 8;
  return 0;
}

template <typename T>
cudaError_t plan_t(int rows, int* cols, int* smem, int* blocks_per_sm) {
  *cols = pick_cols<T>(rows);
  switch (*cols) {
    case 64: return plan_one<T, 64>(rows, smem, blocks_per_sm);
    case 32: return plan_one<T, 32>(rows, smem, blocks_per_sm);
    case 16: return plan_one<T, 16>(rows, smem, blocks_per_sm);
    case 8: return plan_one<T, 8>(rows, smem, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
void launch_t(int cols, int grid, int smem, const Args& a, cudaStream_t st) {
  switch (cols) {
    case 64: finish_kernel<T, 64><<<grid, kThreads, smem, st>>>(a); break;
    case 32: finish_kernel<T, 32><<<grid, kThreads, smem, st>>>(a); break;
    case 16: finish_kernel<T, 16><<<grid, kThreads, smem, st>>>(a); break;
    case 8: finish_kernel<T, 8><<<grid, kThreads, smem, st>>>(a); break;
  }
}

template <int S>
cudaError_t rplan_one(int rows, int* smem, int* blocks_per_sm) {
  const RSmem L(rows, S);
  *smem = (int)L.total;
  cudaError_t e = cudaFuncSetAttribute(radix_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.total);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, radix_kernel<S>,
                                                       kRThreads, L.total);
}

// The radix route's ring depth: three slabs in flight where they fit one
// CTA's shared memory, else two; 0 when not even two fit.
cudaError_t rplan(int rows, int* stages, int* smem, int* blocks_per_sm) {
  *stages = RSmem(rows, 3).total <= kRSmemCap ? 3 : RSmem(rows, 2).total <= kRSmemCap ? 2 : 0;
  switch (*stages) {
    case 3: return rplan_one<3>(rows, smem, blocks_per_sm);
    case 2: return rplan_one<2>(rows, smem, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// The ring route's plan for `rows` rows of T (ops/_cuda.py::ring_finish_plan
// mirrors it): resident when a slab's groups and at least kGMinAhead more
// fit the ring, `ahead` up to kGMaxAhead; else streaming, a ring of ahead +
// 1 groups.  geom packs stages | ahead << 8 | resident << 16.
template <typename T>
cudaError_t gplan(int rows, int* geom, int* smem, int* blocks_per_sm) {
  constexpr int gh = kGroupBytes / (kGCols * (int)sizeof(T));
  if (rows < 1 || rows > kGMaxRows) return cudaErrorInvalidValue;
  const long long fixed = (long long)GSmem(rows, 0).total;
  if (fixed + 2LL * kGroupBytes > kGSmemCap) return cudaErrorInvalidValue;
  const int smax = (int)((kGSmemCap - fixed) / kGroupBytes);
  const int ng = (rows + gh - 1) / gh;
  int stages, ahead, resident;
  if (ng + kGMinAhead <= smax) {
    resident = 1;
    ahead = min(kGMaxAhead, smax - ng);
    stages = ng + ahead;
  } else {
    resident = 0;
    ahead = min(kGMaxAhead, smax - 1);
    stages = ahead + 1;
  }
  *geom = stages | (ahead << 8) | (resident << 16);
  *smem = (int)GSmem(rows, stages).total;
  cudaError_t e = cudaFuncSetAttribute(ring_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ring_kernel<T>, kGThreads,
                                                       *smem);
}

}  // namespace

extern "C" {

// Launch geometry for (dtype, route, rows): writes `geom` (the bit-serial
// route's slab width in columns, the radix route's ring depth in slabs, or
// the ring route's packed plan, see gplan), the dynamic shared memory and
// the CTA count to use for `d` columns.  dtype 0 = f32, 1 = bf16; route 0 =
// bit-serial (finish_kernel), 1 = radix (radix_kernel, bf16 only), 2 = ring
// (ring_kernel).  Returns a cudaError_t (cudaErrorInvalidValue when the
// rows do not fit one CTA's shared memory).
int bt_finish_plan(int dtype, int route, int rows, long long d, int* geom, int* smem,
                   int* grid) {
  int per_sm = 0;
  cudaError_t e;
  if (route == 2)
    e = dtype == 1 ? gplan<uint16_t>(rows, geom, smem, &per_sm)
                   : gplan<uint32_t>(rows, geom, smem, &per_sm);
  else if (route == 1)
    e = dtype == 1 ? rplan(rows, geom, smem, &per_sm) : cudaErrorInvalidValue;
  else
    e = dtype == 1 ? plan_t<uint16_t>(rows, geom, smem, &per_sm)
                   : plan_t<uint32_t>(rows, geom, smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nstripes = (d + kStripe - 1) / kStripe;
  long long g = (long long)per_sm * sms;
  if (g > nstripes) g = nstripes;
  *grid = (int)(g < 1 ? 1 : g);
  return 0;
}

// The finish: main kernel, then the row-partial reduction.  sq_part and
// sq_out may be null (no row norms); forged_out may be null.  With an
// `active` mask the forged row's multiplicity is the inactive row count,
// formed on the device with the ranks; without one it is `mult`.  The
// radix route refuses (cudaErrorInvalidValue) rows that are not bf16 and
// 16-byte aligned, the ring route rows that are not 16-byte aligned.
int bt_finish(const void* x, int dtype, int route, int rows, long long d,
              const uint8_t* active, const float* noise, float* agg_out, float* forged_out,
              float* sq_out, uint8_t* bad_out, float* sq_part, uint8_t* bad_part, int geom,
              int grid, int smem, int mult, int forge, int agg, int k_cut, int sanitize,
              int compact, const float* fc, void* stream) {
  Args a;
  a.x = x;
  a.rows = rows;
  a.d = d;
  a.active = active;
  a.noise = noise;
  a.agg_out = agg_out;
  a.forged_out = forged_out;
  a.sq_part = sq_part;
  a.bad_part = bad_part;
  a.mult = mult;
  a.forge = forge;
  a.agg = agg;
  a.k_cut = k_cut;
  a.sanitize = sanitize;
  a.compact = compact;
  for (int i = 0; i < 6; ++i) a.fc[i] = fc[i];
  a.aligned = dtype == 0 || (d % 2 == 0 && ((uintptr_t)x % 4) == 0);
  a.stages = geom & 0xFF;
  a.ahead = (geom >> 8) & 0xFF;
  a.resident = (geom >> 16) & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    const long long esize = dtype == 1 ? 2 : 4;
    if ((d * esize) % 16 != 0 || ((uintptr_t)x % 16) != 0 || rows > kGMaxRows ||
        a.ahead < 1 || a.ahead > kGMaxAhead || a.stages < a.ahead + 1)
      return (int)cudaErrorInvalidValue;
    if (dtype == 1)
      ring_kernel<uint16_t><<<grid, kGThreads, smem, st>>>(a);
    else
      ring_kernel<uint32_t><<<grid, kGThreads, smem, st>>>(a);
  } else if (route == 1) {
    if (dtype != 1 || d % 8 != 0 || ((uintptr_t)x % 16) != 0) return (int)cudaErrorInvalidValue;
    if (geom == 3)
      radix_kernel<3><<<grid, kRThreads, smem, st>>>(a);
    else if (geom == 2)
      radix_kernel<2><<<grid, kRThreads, smem, st>>>(a);
    else
      return (int)cudaErrorInvalidValue;
  } else if (dtype == 1) {
    launch_t<uint16_t>(geom, grid, smem, a, st);
  } else {
    launch_t<uint32_t>(geom, grid, smem, a, st);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finalize_kernel<<<(rows + 255) / 256, 256, 0, st>>>(sq_part, bad_part, active, rows, grid,
                                                      sq_out, bad_out);
  return (int)cudaGetLastError();
}

const char* bt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
