// Fused streamed-round finish and exact column order statistics for Hopper.
//
// One kernel source serves four wrappers (blades_tpu_torch/ops/):
//
//   fused_finish_compact  replaces blades_tpu/ops/pallas_round.py
//                         _fused_finish_compact_jit / _compact_kernel
//   fused_finish          replaces pallas_round.py fused_finish / _fused_kernel
//   column_median         replaces blades_tpu/ops/pallas_select.py
//                         column_median / _median_kernel
//   column_trimmed_mean   replaces pallas_select.py column_trimmed_mean /
//                         _trimmed_mean_kernel
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
// Bound on the H100: the bytes of one read of the matrix (bf16: 2 B per
// element) against 3.35 TB/s, unless the radix select's compare-and-count
// work (16 steps over bf16 keys, 32 over f32 keys, each touching every
// element once) outruns it, which a plain implementation does.
//
// Design:
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
  int mult;               // multiplicity of the virtual forged row
  int n_true;             // active rows + mult
  int forge;
  int agg;
  int k_cut;
  int sanitize;
  int compact;            // arithmetic of the compact kernel for the trimmed sum
  int aligned;            // rows start on 4-byte boundaries: cp.async path
  float nb;               // max(#active, 1) as the forge statistics use it
  float fc[6];            // forge constants, see forge_constants() in the wrapper
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
        const float mean = colsum / a.nb;
        if (a.forge == kForgeAlie) {
          float pv = 0.f;
          for (int i = g; i < na; i += G) {
            const float dv = TR::val(tile[i * S + c]) - mean;
            pv += dv * dv;
          }
          red[tid] = pv;
          __syncthreads();
          float var = 0.f;
          for (int gg = 0; gg < G; ++gg) var += red[gg * C + c];
          __syncthreads();
          const float sd = sqrtf(var / fmaxf(a.nb - 1.f, 1.f));
          forged = mean + a.fc[0] * sd;
        } else if (a.forge == kForgeIpm) {
          forged = a.fc[0] * mean;
        } else {  // Adaptive (Fang): the four sign cases
          float mx = -INFINITY, mn = INFINITY;
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
          const float r = (c < w && a.noise != nullptr) ? a.noise[c0 + c] : 0.f;
          const float neg_pos = r * (a.fc[0] * mx) + mx;
          const float neg_neg = r * (a.fc[1] * mx) + mx;
          const float pos_pos = r * (a.fc[2] * mn) + mn / a.fc[4];
          const float pos_neg = r * (a.fc[3] * mn) + mn * a.fc[5];
          if (mean < 0.f)
            forged = mx > 0.f ? neg_pos : neg_neg;
          else if (mean > 0.f)
            forged = mn > 0.f ? pos_pos : pos_neg;
          else
            forged = mean;
        }
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
      const int mult = a.mult;
      if (a.agg == kAggMean) {
        out = (colsum + (float)mult * forged) / (float)a.n_true;
      } else {
        const int kA = a.agg == kAggMedian ? (a.n_true - 1) / 2 : a.k_cut;
        const int kB = a.agg == kAggMedian ? a.n_true / 2 : a.n_true - 1 - a.k_cut;
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
          if (mult) {
            const bool fb = fkey > vlo && fkey < vhi;
            if (a.compact)
              sm += ((float)mult * forged) * (fb ? 1.f : 0.f);
            else if (fb)
              sm += (float)mult * forged;
          }
          const int n = a.n_true, k = a.k_cut;
          const int lo_keep = max(min(lt_lo + eq_lo, n - k) - max(lt_lo, k), 0);
          const int hi_keep = max(min(lt_hi + eq_hi, n - k) - max(lt_hi, k), 0);
          const int kept = n - 2 * k;
          float total = sm + (float)lo_keep * flo + (float)hi_keep * fhi;
          if (vlo == vhi) total = flo * (float)kept;
          out = total * (1.0f / (float)kept);  // as XLA lowers x / const
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

}  // namespace

extern "C" {

// Launch geometry for (dtype, rows): writes the slab width, the dynamic
// shared memory and the CTA count to use for `d` columns.  dtype 0 = f32,
// 1 = bf16.  Returns a cudaError_t (cudaErrorInvalidValue when the rows do
// not fit one CTA's shared memory).
int bt_finish_plan(int dtype, int rows, long long d, int* cols, int* smem, int* grid) {
  int per_sm = 0;
  cudaError_t e = dtype == 1 ? plan_t<uint16_t>(rows, cols, smem, &per_sm)
                             : plan_t<uint32_t>(rows, cols, smem, &per_sm);
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
// sq_out may be null (no row norms); forged_out may be null.
int bt_finish(const void* x, int dtype, int rows, long long d, const uint8_t* active,
              const float* noise, float* agg_out, float* forged_out, float* sq_out,
              uint8_t* bad_out, float* sq_part, uint8_t* bad_part, int cols, int grid,
              int smem, int mult, int n_true, int forge, int agg, int k_cut, int sanitize,
              int compact, float nb, const float* fc, void* stream) {
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
  a.n_true = n_true;
  a.forge = forge;
  a.agg = agg;
  a.k_cut = k_cut;
  a.sanitize = sanitize;
  a.compact = compact;
  a.nb = nb;
  for (int i = 0; i < 6; ++i) a.fc[i] = fc[i];
  a.aligned = dtype == 0 || (d % 2 == 0 && ((uintptr_t)x % 4) == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch_t<uint16_t>(cols, grid, smem, a, st);
  else
    launch_t<uint32_t>(cols, grid, smem, a, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  finalize_kernel<<<(rows + 255) / 256, 256, 0, st>>>(sq_part, bad_part, active, rows, grid,
                                                      sq_out, bad_out);
  return (int)cudaGetLastError();
}

const char* bt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
