// Exact column order statistics of an f32 matrix for Hopper: the radix
// select behind the dense Median and Trimmedmean aggregators.
//
//   column_median        replaces blades_tpu/ops/pallas_select.py
//                        column_median / _median_kernel
//   column_trimmed_mean  replaces pallas_select.py column_trimmed_mean /
//                        _trimmed_mean_kernel
//
// What it computes, per column of a row-major (rows, d) f32 matrix: the
// keys of pallas_select._keys_of (negatives bit-flipped, positives offset
// past them, every NaN of either sign the largest key), the keys of ranks
// kA and kB, and from them the median (midpoint of ranks (n-1)/2 and n/2)
// or the trimmed mean (ranks k and n-1-k: the sum of the values strictly
// between the two cut keys, plus the exact tie correction at both cuts).
// A selected NaN comes back as the value of the largest key, a NaN.
//
// Bound on the H100: one read of the (rows, d) matrix at 3.35 TB/s.  What
// holds the kernel above it is instruction issue in shared memory (a key,
// a histogram atomic and the per-digit walks per element and slab), and
// at 1,000 rows that the next slab's loads can only overlap the current
// slab's passes by the few groups the ring has room for.
//
// Design (select_kernel):
//  - A CTA (512 threads) walks 32-column slabs persistently (slab
//    blockIdx.x, + gridDim.x, ...): lane = column, so a warp reads one
//    128-byte row piece of the slab.
//  - The slab's rows stream in groups of gh rows through a ring of
//    `stages` shared-memory buffers, `ahead` groups in flight, by cp.async
//    of 16 bytes (rows 16-byte aligned: d % 4 == 0 and a 16-byte base), 8
//    (d even: the dense ResNet-10 trial's d % 4 == 2) or 4: no copy of the
//    matrix is padded.  The ring's position lives in counters; nothing
//    divides a 64-bit index per group.
//  - Digits, not bits: pass 0 histograms the top 8 bits of every key
//    (hist[bin][column]: lane l only touches bank l, so the shared-memory
//    atomics never conflict inside a warp), both ranks in one counter (A
//    low 16 bits, B high 16) below 65,536 rows.  A walk finds per column
//    the bins holding ranks kA and kB: each of the 16 warps owns 16 bins,
//    each thread reads and zeroes its 16 counters once and takes the
//    count below them from the other warps' totals; only the thread
//    whose bins hold a rank searches them.
//  - Resident plan (up to 1,152 rows at the default geometry): every group
//    of the slab stays in the ring, keys in place of the values, while the
//    next slab's first `ahead` groups load.  Pass 1 histograms the second
//    digit of the keys in the two ranks' top-digit buckets, each warp
//    owning 32-row blocks and marking those rows in a mask word per
//    column (mask1).  After its walk, most columns have a few keys left
//    under each rank's 16-bit prefix: they go to two short lists per
//    column (16 keys each), and when every list of the slab fits, each
//    rank's key is the listed key whose run of equal keys covers it,
//    found by counting.  Else (ties, one-bucket columns such as ALIE's
//    identical rows or all-equal columns) digit passes 2 and 3 walk only
//    the marked rows.  Either way each rank ends with its key, the count
//    below it and the count equal to it, which is what the trimmed
//    mean's tie correction needs.
//  - Up to 64 rows in one group: no digits.  Each thread counts, for its
//    rows, the keys below; the rank-k key is the largest key whose count
//    is at most k (a max over the threads).
//  - Streaming plan (more rows, any count): every digit pass streams the
//    slab's groups again (one rank a pass above 65,536 rows); the repeat
//    reads come from L2.  The plan is ops/_cuda.py::select_plan's;
//    bt_select_plan checks it.
//  - The trimmed sum runs in a fixed order: each thread sums its rows in
//    a fixed order, warps are summed in order, and nothing is a float
//    atomic, so two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                  // columns per slab, one per lane
constexpr int kBins = 256;                 // one 8-bit digit
constexpr int kPartBins = kBins / kWarps;  // bins one warp walks per column
constexpr int kSmemCap = 232448;           // 227 KB a block
constexpr int kMaxAhead = 16;
constexpr int kPackedRows = 65536;          // fewer rows: both ranks in one counter
constexpr int kList = 16;                   // keys a short list holds per column
constexpr int kFewPer = 4;                  // rows a thread owns when counting
constexpr int kFewRows = kFewPer * kWarps;  // rows up to which ranks come from counting

enum Agg { kMedian = 1, kTrimmed = 2 };
// Per-column select state in shared memory, one int per column each.
enum Field { fPrefA, fPrefB, fBelowA, fBelowB, fEqA, fEqB, kFields = 8 };
// Which ranks a digit pass counts: both (packed), or one of them.
enum Ranks { kBoth, kOnlyA, kOnlyB };

struct Args {
  const float* x;
  int rows;
  long long d;
  float* out;
  int agg;
  int k_cut;
  int gh;        // rows per group
  int stages;    // groups the ring holds
  int ahead;     // groups in flight
  int resident;  // the whole slab stays in the ring
  int probe;     // 1: loads alone, 2: passes alone (measurements only)
};

// Shared-memory layout, shared by host and device: the ring of `stages`
// groups of gh rows x 32 columns, the histogram, the per-warp column
// totals and sums, the per-column fields, and (resident) two candidate
// masks of nb 32-row blocks x 32 columns and two short key lists of
// kList keys x 32 columns with their lengths.
struct Layout {
  size_t ring, hist, ps, red, col, mask1, mask2, list, lcnt, total;
  __host__ __device__ Layout(int stages, int gh, int nb) {
    size_t o = 0;
    ring = o;
    o += (size_t)stages * gh * kCols * 4;
    hist = o;
    o += (size_t)kBins * kCols * 4;
    ps = o;
    o += (size_t)kWarps * kCols * 4;
    red = o;
    o += (size_t)kWarps * kCols * 4;
    col = o;
    o += (size_t)kFields * kCols * 4;
    mask1 = o;
    o += (size_t)nb * kCols * 4;
    mask2 = o;
    o += (size_t)nb * kCols * 4;
    list = o;
    o += nb ? (size_t)2 * kList * kCols * 4 : 0;
    lcnt = o;
    o += nb ? (size_t)2 * kCols * 4 : 0;
    total = o;
  }
};

__device__ __forceinline__ uint32_t key_of(uint32_t b) {
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) return 0xFFFFFFFFu;  // NaN, either sign
  return (b >> 31) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float val_of(uint32_t k) {
  return __uint_as_float((k >> 31) ? (k & 0x7FFFFFFFu) : ~k);
}

template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (VB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else if (VB == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
template <int VB>
__device__ __forceinline__ void zero_fill(float* dst) {
  if (VB == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else if (VB == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else
    *dst = 0.f;
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most n commit groups are pending (n < kMaxAhead).
__device__ __forceinline__ void cp_async_wait(int n) {
#define BT_WAIT_CASE(N) \
  case N:               \
    asm volatile("cp.async.wait_group " #N ";\n" ::); \
    break;
  switch (n) {
    BT_WAIT_CASE(0) BT_WAIT_CASE(1) BT_WAIT_CASE(2) BT_WAIT_CASE(3)
    BT_WAIT_CASE(4) BT_WAIT_CASE(5) BT_WAIT_CASE(6) BT_WAIT_CASE(7)
    BT_WAIT_CASE(8) BT_WAIT_CASE(9) BT_WAIT_CASE(10) BT_WAIT_CASE(11)
    BT_WAIT_CASE(12) BT_WAIT_CASE(13) BT_WAIT_CASE(14)
    default: asm volatile("cp.async.wait_group 15;\n" ::); break;
  }
#undef BT_WAIT_CASE
}

// The trimmed mean of one column of n values cut k from each end, from the
// cut keys' values flo/fhi, the counts strictly below and equal to each,
// and `sm`, the sum of the values strictly between them.
__device__ __forceinline__ float trimmed_value(float sm, int lt_lo, int eq_lo, int lt_hi,
                                               int eq_hi, int n, int k, float flo, float fhi,
                                               bool same_cut) {
  const int lo_keep = max(min(lt_lo + eq_lo, n - k) - max(lt_lo, k), 0);
  const int hi_keep = max(min(lt_hi + eq_hi, n - k) - max(lt_hi, k), 0);
  const int kept = n - 2 * k;
  float total = sm + (float)lo_keep * flo + (float)hi_keep * fhi;
  if (same_cut) total = flo * (float)kept;
  return total * (1.0f / (float)kept);  // as XLA lowers x / const
}

// The load cursor: the slab, group and pass repeat of the next group to
// load, and its ring stage.
struct Cursor {
  long long slab;  // this CTA's slab counter
  long long c0;    // the slab's first column
  int g, rep, stage;
};

// The walk after a digit pass over digit shift `ds`: warp w owns bins
// [16w, 16w + 16) of column `lane`.  Each thread reads and zeroes its 16
// counters once, publishes their total, and takes the count below its bins
// from the totals of the warps before it; only the thread whose bins hold
// rank kA (kB) searches them, and it writes the rank's key prefix, the
// count below it and its bin's count to the column's fields.  `packed`:
// counters hold rank A's count in the low 16 bits and B's in the high 16;
// else both ranks read the whole counter (a pass that counts one rank
// searches only that one).
__device__ __forceinline__ void walk(int* hl, unsigned* ps, int* cf, int warp, int lane,
                                     bool packed, bool doA, bool doB, int kA, int kB,
                                     uint32_t prefA, uint32_t prefB, int belowA, int belowB,
                                     int ds) {
  const int b0 = warp * kPartBins;
  unsigned v[kPartBins];
  unsigned t = 0;
#pragma unroll
  for (int j = 0; j < kPartBins; ++j) {
    v[j] = (unsigned)hl[(b0 + j) * kCols];
    hl[(b0 + j) * kCols] = 0;
    t += v[j];
  }
  ps[warp * kCols + lane] = t;
  __syncthreads();
  unsigned bel = 0;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w)
    if (w < warp) bel += ps[w * kCols + lane];
  const int belA = belowA + (int)(packed ? bel & 0xFFFFu : bel);
  const int belB = belowB + (int)(packed ? bel >> 16 : bel);
  const int ta = (int)(packed ? t & 0xFFFFu : t), tb = (int)(packed ? t >> 16 : t);
  if (doA && belA <= kA && kA < belA + ta) {
    int below = belA;
    bool found = false;
#pragma unroll
    for (int j = 0; j < kPartBins; ++j) {
      const int c = (int)(packed ? v[j] & 0xFFFFu : v[j]);
      if (!found && kA < below + c) {
        found = true;
        cf[fPrefA * kCols] = (int)(prefA | ((uint32_t)(b0 + j) << ds));
        cf[fBelowA * kCols] = below;
        cf[fEqA * kCols] = c;
      }
      below += c;
    }
  }
  if (doB && belB <= kB && kB < belB + tb) {
    int below = belB;
    bool found = false;
#pragma unroll
    for (int j = 0; j < kPartBins; ++j) {
      const int c = (int)(packed ? v[j] >> 16 : v[j]);
      if (!found && kB < below + c) {
        found = true;
        cf[fPrefB * kCols] = (int)(prefB | ((uint32_t)(b0 + j) << ds));
        cf[fBelowB * kCols] = below;
        cf[fEqB * kCols] = c;
      }
      below += c;
    }
  }
  __syncthreads();
}

template <int VB>
__global__ void __launch_bounds__(kThreads, 2) select_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.rows, gh = a.gh, S = a.stages, ahead = a.ahead;
  const bool resident = a.resident != 0;
  // Up to 64 rows in one group take their ranks from counting.
  const bool few = resident && n <= kFewRows && n <= gh;
  const int nb = resident && !few ? (n + 31) / 32 : 0;  // 32-row mask blocks
  const Layout L(S, gh, nb);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  uint32_t* kring = reinterpret_cast<uint32_t*>(ring);  // keys, resident
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  unsigned* ps = reinterpret_cast<unsigned*>(smem + L.ps);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* col = reinterpret_cast<int*>(smem + L.col);
  unsigned* mask1 = reinterpret_cast<unsigned*>(smem + L.mask1);
  unsigned* mask2 = reinterpret_cast<unsigned*>(smem + L.mask2);
  uint32_t* list = reinterpret_cast<uint32_t*>(smem + L.list);
  int* lcnt = reinterpret_cast<int*>(smem + L.lcnt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long d = a.d;
  const int ng = (n + gh - 1) / gh;
  const int lg = 31 - __clz(gh);  // gh is a power of two
  const long long nslab = (d + kCols - 1) / kCols;
  const long long mine =
      nslab > (long long)blockIdx.x ? (nslab - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const bool trimmed = a.agg == kTrimmed;
  const bool packed = n < kPackedRows;
  // Streaming: digit pass 0, then 1-3 for both ranks or each, then the sum.
  const int nsel = packed ? 4 : 7;
  const int npass = nsel + (trimmed ? 1 : 0);
  const int reps = resident ? 1 : npass;  // loads of each group per slab
  const int kA = trimmed ? a.k_cut : (n - 1) / 2;
  const int kB = trimmed ? n - 1 - a.k_cut : n / 2;
  const bool load_on = a.probe != 2, work_on = a.probe != 1;
  const long long cstride = (long long)gridDim.x * kCols;
  int* hl = hist + lane;
  int* cf = col + lane;

  for (int e = tid; e < kBins * kCols; e += kThreads) hist[e] = 0;

  constexpr int kPer = VB / 4;         // floats per copy
  constexpr int kCpr = kCols / kPer;   // copies per slab row
  Cursor cur{0, (long long)blockIdx.x * kCols, 0, 0, 0};
  // Group cur.g of slab cur.slab into stage cur.stage, one commit group
  // per call (empty past the end, so wait counts stay uniform); columns
  // past d read as +0.
  auto load_next = [&]() {
    if (load_on && cur.slab < mine) {
      const int r0 = cur.g * gh, nv = min(gh, n - r0);
      float* dst = ring + (size_t)cur.stage * gh * kCols;
      const float* src = a.x + (size_t)r0 * d + cur.c0;
      for (int u = tid; u < nv * kCpr; u += kThreads) {
        const int r = u / kCpr, c = (u % kCpr) * kPer;
        if (cur.c0 + c < d)
          cp_async<VB>(dst + r * kCols + c, src + (size_t)r * d + c);
        else
          zero_fill<VB>(dst + r * kCols + c);
      }
    }
    cp_async_commit();
    if (++cur.g == ng) {
      cur.g = 0;
      if (++cur.rep == reps) {
        cur.rep = 0;
        ++cur.slab;
        cur.c0 += cstride;
      }
    }
    if (++cur.stage == S) cur.stage = 0;
  };
  for (int i = 0; i < ahead; ++i) load_next();
  __syncthreads();  // hist zeroed

  int cstage = 0;  // ring stage of the next group to arrive
  // Every group of the slab arrives (fresh) and, for each, `fn(B, nv, g)`
  // runs on its stage: rows [g * gh, g * gh + nv) of the slab.
  auto stream_pass = [&](auto&& fn) {
    for (int g = 0; g < ng; ++g) {
      cp_async_wait(ahead - 1);
      __syncthreads();  // group landed; every thread is done with the stage reloaded next
      load_next();
      float* B = ring + (size_t)cstage * gh * kCols;
      if (++cstage == S) cstage = 0;
      if (work_on) fn(B, min(gh, n - g * gh), g);
    }
  };
  // Resident: the key of slab row R, from the slab's first stage st0.
  auto key_at = [&](int st0, int R) -> uint32_t {
    int st = st0 + (R >> lg);
    if (st >= S) st -= S;
    return kring[((size_t)st << lg) * kCols + (R & (gh - 1)) * kCols + lane];
  };

  long long c0 = (long long)blockIdx.x * kCols;
  for (long long ts = 0; ts < mine; ++ts, c0 += cstride) {
    const int slab_stage = cstage;
    uint32_t prefA = 0, prefB = 0;
    int belowA = 0, belowB = 0, eqA = 0, eqB = 0;
    float acc = 0.f;  // this thread's share of the trimmed sum, in a fixed order
    // After the walk of digit shift ds: the fields into registers.
    auto after_walk = [&](bool doA, bool doB) {
      if (doA) {
        prefA = (uint32_t)cf[fPrefA * kCols];
        belowA = cf[fBelowA * kCols];
        eqA = cf[fEqA * kCols];
      }
      if (doB) {
        prefB = (uint32_t)cf[fPrefB * kCols];
        belowB = cf[fBelowB * kCols];
        eqB = cf[fEqB * kCols];
      }
    };
    auto do_walk = [&](bool doA, bool doB, int ds) {
      if (!work_on) return;
      __syncthreads();  // every count of the pass is in
      walk(hl, ps, cf, warp, lane, packed, doA, doB, kA, kB, prefA, prefB, belowA, belowB, ds);
      after_walk(doA, doB);
    };

    // Pass 0: the top digit of every key, as the groups arrive; a resident
    // slab keeps the keys in place of the values.  A slab of at most 64
    // rows keeps only the keys: its ranks come from counting.
    const int inc0 = packed ? 0x10001 : 1;
    stream_pass([&](float* B, int nv, int) {
      uint32_t* K = reinterpret_cast<uint32_t*>(B);
      if (few) {
        for (int r = warp; r < nv; r += kWarps) K[r * kCols + lane] = key_of(K[r * kCols + lane]);
        return;
      }
      int r = warp;
      for (; r + 3 * kWarps < nv; r += 4 * kWarps) {
        uint32_t k[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) k[j] = key_of(K[(r + j * kWarps) * kCols + lane]);
        if (resident) {
#pragma unroll
          for (int j = 0; j < 4; ++j) K[(r + j * kWarps) * kCols + lane] = k[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(hl + (k[j] >> 24) * kCols, inc0);
      }
      for (; r < nv; r += kWarps) {
        const uint32_t k = key_of(K[r * kCols + lane]);
        if (resident) K[r * kCols + lane] = k;
        atomicAdd(hl + (k >> 24) * kCols, inc0);
      }
    });
    if (few) {
      // Rank by counting: each thread takes its rows r = warp + 16 m and
      // counts the column's keys below each.  A row's count is at most kA
      // exactly when its key is at most the rank-kA key, so that key is
      // the largest such (a max over the threads), and its run of equal
      // keys gives the counts below and equal.  The trimmed sum takes the
      // thread's own keys strictly between the cut keys.
      if (work_on) {
        if (warp == 0) {
          cf[fPrefA * kCols] = cf[fPrefB * kCols] = 0;  // below every key
          cf[fEqA * kCols] = cf[fEqB * kCols] = 0;
        }
        __syncthreads();  // every key in place
        const uint32_t* K = kring + (size_t)slab_stage * gh * kCols + lane;
        uint32_t own[kFewPer];
        int lt[kFewPer];
#pragma unroll
        for (int m = 0; m < kFewPer; ++m) {
          const int r = warp + m * kWarps;
          own[m] = r < n ? K[r * kCols] : 0u;
          lt[m] = 0;
        }
        int j = 0;
        for (; j + 3 < n; j += 4) {
          uint32_t kj[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) kj[t] = K[(j + t) * kCols];
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int m = 0; m < kFewPer; ++m) lt[m] += kj[t] < own[m];
        }
        for (; j < n; ++j) {
          const uint32_t kj = K[j * kCols];
#pragma unroll
          for (int m = 0; m < kFewPer; ++m) lt[m] += kj < own[m];
        }
        uint32_t mA = 0, mB = 0;  // no key is 0
#pragma unroll
        for (int m = 0; m < kFewPer; ++m) {
          if (warp + m * kWarps >= n) continue;
          if (lt[m] <= kA) mA = max(mA, own[m]);
          if (lt[m] <= kB) mB = max(mB, own[m]);
        }
        if (mA) atomicMax(reinterpret_cast<unsigned*>(cf + fPrefA * kCols), mA);
        if (mB) atomicMax(reinterpret_cast<unsigned*>(cf + fPrefB * kCols), mB);
        __syncthreads();
        const uint32_t vA = (uint32_t)cf[fPrefA * kCols], vB = (uint32_t)cf[fPrefB * kCols];
        int eA = 0, eB = 0;
#pragma unroll
        for (int m = 0; m < kFewPer; ++m) {
          if (warp + m * kWarps >= n) continue;
          if (own[m] == vA) {
            ++eA;
            cf[fBelowA * kCols] = lt[m];
          }
          if (own[m] == vB) {
            ++eB;
            cf[fBelowB * kCols] = lt[m];
          }
        }
        if (eA) atomicAdd(cf + fEqA * kCols, eA);
        if (eB) atomicAdd(cf + fEqB * kCols, eB);
        __syncthreads();
        after_walk(true, true);
        if (trimmed) {
#pragma unroll
          for (int m = 0; m < kFewPer; ++m)
            if (warp + m * kWarps < n && own[m] > prefA && own[m] < prefB) acc += val_of(own[m]);
        }
      }
    } else if (resident) {
      if (tid < 2 * kCols) lcnt[tid] = 0;  // the short lists start empty
      do_walk(true, true, 24);
      // Pass 1: digit 1 of the keys in rank A's or B's top-digit bucket.
      // Warp w owns 32-row blocks w, w + 16, ...: each thread marks its
      // column's such rows in a mask word (bit i for row 32 blk + i) of
      // mask1.  The trimmed sum takes every key whose top digit lies
      // strictly between the two buckets.
      const uint32_t pa = prefA >> 24, pb = prefB >> 24;
      if (work_on) {
        for (int blk = warp; blk < nb; blk += kWarps) {
          const int m = min(32, n - blk * 32);
          unsigned word = 0;
          int i = 0;
          auto mark1 = [&](uint32_t k, int bit) {
            const uint32_t hi = k >> 24;
            const int inc = (hi == pa ? 1 : 0) + (hi == pb ? 0x10000 : 0);
            if (inc) {
              atomicAdd(hl + ((k >> 16) & 0xFFu) * kCols, inc);
              word |= 1u << bit;
            }
            if (trimmed && hi > pa && hi < pb) acc += val_of(k);
          };
          for (; i + 3 < m; i += 4) {
            uint32_t k[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) k[j] = key_at(slab_stage, blk * 32 + i + j);
#pragma unroll
            for (int j = 0; j < 4; ++j) mark1(k[j], i + j);
          }
          for (; i < m; ++i) mark1(key_at(slab_stage, blk * 32 + i), i);
          mask1[blk * kCols + lane] = word;
        }
      }
      do_walk(true, true, 16);
      // Most columns have only a few keys left under each rank's 16-bit
      // prefix: list them (list A, then list B, kList keys each), and when
      // every list of the slab fits, each rank's key is the listed key
      // whose run of equal keys covers the rank, found by counting.
      bool listed = false;
      if (work_on) {
        const uint32_t qa = prefA >> 16, qb = prefB >> 16;
        for (int blk = warp; blk < nb; blk += kWarps) {
          unsigned word = mask1[blk * kCols + lane];
          while (word) {
            const int i = __ffs(word) - 1;
            word &= word - 1;
            const uint32_t k = key_at(slab_stage, blk * 32 + i);
            if ((k >> 16) == qa) {
              const int at = atomicAdd(lcnt + lane, 1);
              if (at < kList) list[at * kCols + lane] = k;
            }
            if ((k >> 16) == qb) {
              const int at = atomicAdd(lcnt + kCols + lane, 1);
              if (at < kList) list[(kList + at) * kCols + lane] = k;
            }
          }
        }
        __syncthreads();
        const int na = lcnt[lane], nbk = lcnt[kCols + lane];
        listed = !__syncthreads_or(na > kList || nbk > kList);
        if (listed) {
          if (warp < kList) {
            auto pick = [&](const uint32_t* lst, int len, int rank, int below, int fp, int fb,
                            int fe) {
              if (warp >= len) return;
              const uint32_t key = lst[warp * kCols];
              int lt = 0, eq = 0;
              for (int j = 0; j < len; ++j) {
                const uint32_t kj = lst[j * kCols];
                lt += kj < key;
                eq += kj == key;
              }
              if (lt <= rank - below && rank - below < lt + eq) {
                cf[fp * kCols] = (int)key;
                cf[fb * kCols] = below + lt;
                cf[fe * kCols] = eq;
              }
            };
            pick(list + lane, na, kA, belowA, fPrefA, fBelowA, fEqA);
            pick(list + kList * kCols + lane, nbk, kB, belowB, fPrefB, fBelowB, fEqB);
          }
          __syncthreads();
          after_walk(true, true);
        }
      }
      // Else passes 2 and 3 walk only the marked rows: warp w owns blocks
      // w, w + 16, ..., and marks in mask2 the rows that still match.
      for (int p = 2; p <= 3 && !listed; ++p) {
        const int hs = 32 - 8 * p, ds = 24 - 8 * p;
        const uint32_t qa = prefA >> hs, qb = prefB >> hs;
        const unsigned* m_in = p == 2 ? mask1 : mask2;
        if (work_on) {
          for (int blk = warp; blk < nb; blk += kWarps) {
            unsigned word = m_in[blk * kCols + lane], out = 0;
            while (word) {
              const int i = __ffs(word) - 1;
              word &= word - 1;
              const uint32_t k = key_at(slab_stage, blk * 32 + i);
              const int inc = ((k >> hs) == qa ? 1 : 0) + ((k >> hs) == qb ? 0x10000 : 0);
              if (inc) {
                atomicAdd(hl + ((k >> ds) & 0xFFu) * kCols, inc);
                out |= 1u << i;
              }
            }
            if (p == 2) mask2[blk * kCols + lane] = out;
          }
        }
        do_walk(true, true, ds);
      }
      // The trimmed sum's marked rows: keys of the two cut buckets strictly
      // between the cut keys.
      if (trimmed && work_on) {
        for (int blk = warp; blk < nb; blk += kWarps) {
          unsigned word = mask1[blk * kCols + lane];
          while (word) {
            const int i = __ffs(word) - 1;
            word &= word - 1;
            const uint32_t k = key_at(slab_stage, blk * 32 + i);
            if (k > prefA && k < prefB) acc += val_of(k);
          }
        }
      }
    } else {
      // Streaming: every pass takes every row again.
      do_walk(true, true, 24);
      for (int q = 1; q < npass; ++q) {
        if (q == nsel) {
          stream_pass([&](float* B, int nv, int) {
            for (int r = warp; r < nv; r += kWarps) {
              const float v = B[r * kCols + lane];
              const uint32_t k = key_of(__float_as_uint(v));
              if (k > prefA && k < prefB) acc += v;
            }
          });
          break;
        }
        const int p = packed ? q : (q + 1) / 2;
        const int ranks = packed ? kBoth : (q & 1) ? kOnlyA : kOnlyB;
        const int hs = 32 - 8 * p, ds = 24 - 8 * p;
        const uint32_t qa = prefA >> hs, qb = prefB >> hs;
        const int incA = ranks == kOnlyB ? 0 : 1;
        const int incB = ranks == kOnlyA ? 0 : packed ? 0x10000 : 1;
        auto count = [&](uint32_t k) {
          const int inc = ((k >> hs) == qa ? incA : 0) + ((k >> hs) == qb ? incB : 0);
          if (inc) atomicAdd(hl + ((k >> ds) & 0xFFu) * kCols, inc);
        };
        stream_pass([&](float* B, int nv, int) {
          int r = warp;
          for (; r + 3 * kWarps < nv; r += 4 * kWarps) {
            uint32_t k[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              k[j] = key_of(__float_as_uint(B[(r + j * kWarps) * kCols + lane]));
#pragma unroll
            for (int j = 0; j < 4; ++j) count(k[j]);
          }
          for (; r < nv; r += kWarps) count(key_of(__float_as_uint(B[r * kCols + lane])));
        });
        do_walk(ranks != kOnlyB, ranks != kOnlyA, ds);
      }
    }

    if (!work_on) continue;
    if (trimmed) {
      __syncthreads();  // the sum passes are done with the ring
      red[warp * kCols + lane] = acc;
      __syncthreads();
      if (warp == 0) {
        float sm = 0.f;
        for (int w = 0; w < kWarps; ++w) sm += red[w * kCols + lane];
        if (c0 + lane < d)
          a.out[c0 + lane] = trimmed_value(sm, belowA, eqA, belowB, eqB, n, a.k_cut,
                                           val_of(prefA), val_of(prefB), prefA == prefB);
      }
    } else if (warp == 0 && c0 + lane < d) {
      a.out[c0 + lane] = kA == kB ? val_of(prefA) : (val_of(prefA) + val_of(prefB)) * 0.5f;
    }
  }
  cp_async_wait(0);
}

template <int VB>
cudaError_t occupancy(int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(select_kernel<VB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, select_kernel<VB>, kThreads,
                                                       smem);
}

}  // namespace

extern "C" {

// Check a column-select plan (ops/_cuda.py::select_plan) for (rows, d):
// `vec` bytes a copy (16, 8 or 4), gh rows a group (a power of two), a
// ring of `stages` groups with `ahead` in flight, `resident` when every
// group of a slab stays in the ring (fewer than 65,536 rows).  Writes the dynamic shared memory and the CTA count.
// Returns a cudaError_t (cudaErrorInvalidValue for a plan the kernel does
// not take).
int bt_select_plan(int rows, long long d, int vec, int gh, int stages, int ahead,
                   int resident, int* smem, int* grid) {
  if (rows < 1 || d < 1 || gh < 1 || (gh & (gh - 1)) != 0 || ahead < 1 || ahead > kMaxAhead ||
      stages < ahead + 1)
    return (int)cudaErrorInvalidValue;
  if (vec != 4 && vec != 8 && vec != 16) return (int)cudaErrorInvalidValue;
  const int ng = (rows + gh - 1) / gh;
  if (resident && (ng + ahead > stages || rows >= kPackedRows)) return (int)cudaErrorInvalidValue;
  const bool few = resident && rows <= kFewRows && rows <= gh;
  const Layout L(stages, gh, resident && !few ? (rows + 31) / 32 : 0);
  if (L.total > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  *smem = (int)L.total;
  int per_sm = 0;
  cudaError_t e = vec == 16 ? occupancy<16>(*smem, &per_sm)
                  : vec == 8 ? occupancy<8>(*smem, &per_sm)
                             : occupancy<4>(*smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nslab = (d + kCols - 1) / kCols;
  long long g = (long long)per_sm * sms;
  if (g > nslab) g = nslab;
  *grid = (int)g;
  return 0;
}

// The median (agg 1) or the trimmed mean cut k_cut from each end (agg 2)
// of every column of the (rows, d) f32 matrix x into out (d,), on the plan
// bt_select_plan accepted.  Refuses (cudaErrorInvalidValue) rows the copy
// width does not fit: 16 bytes need d % 4 == 0 and a 16-byte base, 8 bytes
// an even d and an 8-byte base.
int bt_select(const float* x, int rows, long long d, int vec, int gh, int stages, int ahead,
              int resident, int agg, int k_cut, int probe, int smem, int grid, float* out,
              void* stream) {
  const uintptr_t base = (uintptr_t)x;
  if ((vec == 16 && (d % 4 != 0 || base % 16 != 0)) ||
      (vec == 8 && (d % 2 != 0 || base % 8 != 0)) || (vec != 4 && vec != 8 && vec != 16))
    return (int)cudaErrorInvalidValue;
  if ((agg != kMedian && agg != kTrimmed) || k_cut < 0 ||
      (agg == kTrimmed && rows <= 2 * k_cut))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.rows = rows;
  a.d = d;
  a.out = out;
  a.agg = agg;
  a.k_cut = agg == kTrimmed ? k_cut : 0;
  a.gh = gh;
  a.stages = stages;
  a.ahead = ahead;
  a.resident = resident;
  a.probe = probe;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 16)
    select_kernel<16><<<grid, kThreads, smem, st>>>(a);
  else if (vec == 8)
    select_kernel<8><<<grid, kThreads, smem, st>>>(a);
  else
    select_kernel<4><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
