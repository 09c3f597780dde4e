// Row statistics and the Gram matrix of an update matrix, for Hopper.
//
// Replaces blades_tpu/ops/pallas_rowstats.py row_stats_bundle /
// _rowstats_kernel: one call computes any subset of, over a row-major
// (rows, d) matrix X of f32, bf16 or int8 values,
//
//   sq        (rows,)     row squared norms
//   gram      (rows, rows) X X^T
//   signs     (rows, 2)   positive / negative counts per row
//   dots      (rows, R)   X v_k for R vectors v_k of width d
//   wsum      (W, d)      w_k^T X for W row-weight vectors w_k
//   gram_dot  (rows, G)   (X X^T) g_k for G row-weight vectors g_k
//
// int8 input: the self-contractions (sq, gram) are exact integer sums,
// rounded to f32 once; everything else casts the values to f32.
//
// Bound on the H100 at the streamed round's shape (1000, 4,903,424) bf16:
// one read of the matrix, 9.81 GB over 3.35 TB/s = 2.9 ms, for every
// bundle but the Gram.  The Gram's operations, counting its symmetric half,
// are n(n+1)/2 * d * 2 = 4.9e12, at 989 TFLOP/s bf16 = 5.0 ms: the Gram
// bundle is bound by operations.
//
// Design:
//  - Row statistics of rows that are 16-byte aligned, at any row count
//    (rowstats_ring_kernel, below): the slab's rows stream through a ring
//    of row groups that overlaps the HBM read with the passes.
//  - Row statistics of other rows (rowstats_kernel, 512 threads): each CTA
//    walks column slabs of `rowb` bytes per row (16-128, as wide as lets
//    every row of the slab sit in shared memory).  The slab is
//    loaded once with cp.async; a column pass (threads over 16-byte quads,
//    shuffles then warps summed in a fixed order) forms the weighted row sums
//    w^T X_slab -- written out for `wsum`, kept in shared memory as
//    t = g^T X_slab for `gram_dot` -- and a row pass (one thread per row,
//    16 bytes at a time) accumulates sq, the sign counts, X_slab v and
//    X_slab t into per-CTA row partials.  A second kernel reduces the
//    partials in CTA order: deterministic, no float atomics; sign counts
//    and int8 norms are integers throughout.
//  - Gram of rows that are not 16-byte aligned (gram_mma_kernel for int8
//    and bf16, gram_f32_kernel for f32 at any alignment): a tiled product
//    over the (i <= j) tiles of the upper
//    triangle, the d-reduction split across CTAs in whole waves.  bf16 uses mma.sync
//    m16n8k16 with f32 accumulation (a bf16 x bf16 product is exact in
//    f32, so this is the same function up to the order of the sums); int8
//    uses m16n8k32 with int32 accumulation over spans of at most 65536
//    columns, exact; f32 is plain FMA (TF32 would round the inputs).
//    Fragments come from shared memory by ldmatrix.  The tensor cores' f32
//    accumulation does not round to nearest (a CTA that chained ~44k mma
//    sums into one accumulator came out 0.4% low at d = 4.9M), so the bf16
//    path restarts its mma accumulators every kFlush stages and adds them
//    into a separate f32 sum with ordinary rounding.  Tiles are fed by a
//    3-stage cp.async ring.  gram_finalize sums the split partials in
//    split order (int64 for int8) and mirrors the upper triangle, so the
//    result is exactly symmetric.  This reads the matrix once per tile
//    row it meets (the L2 cache serves most of it, since the CTAs of one
//    split walk the same columns together).
//  - Gram of bf16 or int8 rows that are 16-byte aligned
//    (gram_wgmma_kernel, below): TMA loads into a shared-memory ring and
//    wgmma on the tensor cores, f32 sums for bf16, exact int32 spans for
//    int8.  The streamed round's row-geometry buffer is (n, d_alloc),
//    d_alloc the model width rounded up to 512 columns as the JAX package
//    allocates it, and the wire domain's int8 payload is (n,
//    wire_width(d)), a multiple of 16 columns, so the rows of both are;
//    ops/_cuda.py::gram_route picks it.
//  - Otherwise (rowstats_kernel, the mma and f32 Grams) rows need not be
//    aligned to anything: a 4-byte cp.async
//    serves rows whose length in bytes is a multiple of 4 (every f32
//    matrix, bf16 with even d, int8 with d % 4 == 0); other widths load
//    element by element.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;    // Gram kernels
constexpr int kRsThreads = 512;  // row-statistics kernel
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kInt8Span = 65536;  // int32-exact span: 65536 * 128^2 = 2^30 < 2^31

// Element j of a 4-byte word holding 4 / sizeof(T) values, as f32 (all in
// registers: j is a constant after unrolling).
__device__ __forceinline__ float elem_f(uint32_t w, int, float*) { return __uint_as_float(w); }
__device__ __forceinline__ float elem_f(uint32_t w, int j, uint16_t*) {
  return __uint_as_float(j ? (w & 0xFFFF0000u) : (w << 16));
}
__device__ __forceinline__ float elem_f(uint32_t w, int j, int8_t*) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}
template <typename T>
__device__ __forceinline__ float unpack(uint32_t w, int j) {
  return elem_f(w, j, static_cast<T*>(nullptr));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Load rows [row0, row0 + nrows) x 2^wpr_shift 4-byte words of columns
// from col0 into dst (row stride `stride` bytes), zero-filling rows >=
// rows_total and columns >= col_end.  Each thread keeps one word position
// and steps its source and destination pointers down the rows.  Aligned
// rows go through cp.async (the caller commits and waits); others are
// loaded element by element and stored directly.
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* dst, int stride, const T* x,
                                          long long d, int row0, int nrows, int rows_total,
                                          long long col0, long long col_end, int wpr_shift,
                                          bool aligned) {
  constexpr int epw = 4 / sizeof(T);
  const int step = blockDim.x >> wpr_shift;  // rows per sweep of the block
  const int w = threadIdx.x & ((1 << wpr_shift) - 1);
  int r = threadIdx.x >> wpr_shift;
  const long long c = col0 + static_cast<long long>(w) * epw;
  const T* src = x + static_cast<long long>(row0 + r) * d + c;
  const long long src_step = static_cast<long long>(step) * d;
  unsigned char* dp = dst + r * stride + w * 4;
  const int dst_step = step * stride;
  const int rows_here = rows_total - row0 < nrows ? rows_total - row0 : nrows;
  if (aligned) {
    const bool col_ok = c < col_end;
    for (; r < nrows; r += step, src += src_step, dp += dst_step) {
      const bool ok = col_ok && r < rows_here;
      cp_async4(dp, ok ? static_cast<const void*>(src) : static_cast<const void*>(x), ok);
    }
    return;
  }
  for (; r < nrows; r += step, src += src_step, dp += dst_step) {
    T vals[epw];
#pragma unroll
    for (int e = 0; e < epw; ++e) vals[e] = (r < rows_here && c + e < col_end) ? src[e] : T(0);
    uint32_t word;
    memcpy(&word, vals, 4);
    *reinterpret_cast<uint32_t*>(dp) = word;
  }
}

// --------------------------------------------------------------------------
// Row statistics
// --------------------------------------------------------------------------

struct RsArgs {
  const void* x;
  int rows;
  long long d;
  int sq_mode;     // 0 none, 1 f32 partial (fpart[0]), 2 int partial (ipart[0])
  int want_signs;
  const float* v;  // (R, d)
  int R;
  const float* w;  // (W + G, rows): the wsum weights, then the gram_dot weights
  int W, G;
  float* wsum;     // (W, d)
  float* fpart;    // (grid, rows, KF): [sq], dots R, gram_dot G
  int* ipart;      // (grid, rows, 3): int8 sq, pos, neg
  int KF;
  int rowb_shift;  // log2 of the slab bytes per row
  int aligned;
};

// A slab row (rowb bytes) dotted with a slab-wide f32 vector in shared
// memory, 16 bytes of the row and their 16 / sizeof(T) vector entries at a
// time.
template <typename T>
__device__ __forceinline__ float slab_dot(const unsigned char* row, int rowb,
                                          const float* vec) {
  constexpr int epw = 4 / sizeof(T), per = 4 * epw;
  float acc = 0.f;
  for (int b = 0; b < rowb; b += 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + b);
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    const float4* vb = reinterpret_cast<const float4*>(vec + b / static_cast<int>(sizeof(T)));
#pragma unroll
    for (int j4 = 0; j4 < per / 4; ++j4) {
      const float4 v = vb[j4];
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * j4 + u;
        acc = fmaf(unpack<T>(words[j / epw], j % epw), vv[u], acc);
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kRsThreads) rowstats_kernel(RsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int epw = 4 / sizeof(T), per = 4 * epw;  // columns per word, per quad
  constexpr int kWarps = kRsThreads / 32;
  const T* x = static_cast<const T*>(a.x);
  const int rows = a.rows;
  const long long d = a.d;
  const int rowb = 1 << a.rowb_shift;
  const int qpr = rowb / 16;  // 16-byte quads per slab row (1-8)
  const int C = qpr * per;    // columns per slab
  const int stride = rowb + 16;  // an odd multiple of 16 bytes for rowb >= 32
  const int R = a.R, W = a.W, G = a.G, WG = a.W + a.G, KF = a.KF;
  float* vs = reinterpret_cast<float*>(smem + static_cast<size_t>(rows) * stride);  // (R, C)
  float* ts = vs + R * C;                        // (G, C)
  float* red = ts + G * C;                       // (WG, kWarps, C)
  float* fp = red + WG * kWarps * C;             // (rows, KF)
  int* ip = reinterpret_cast<int*>(fp + rows * KF);  // (rows, 3)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < rows * KF; i += kRsThreads) fp[i] = 0.f;
  for (int i = tid; i < rows * 3; i += kRsThreads) ip[i] = 0;

  const long long nslab = (d + C - 1) / C;
  const int qq = tid % qpr, grp = tid / qpr;  // column pass: quad, row group
  const int ng = kRsThreads / qpr;
  const int doff = a.sq_mode == 1 ? 1 : 0, goff = doff + R;
  for (long long s = blockIdx.x; s < nslab; s += gridDim.x) {
    const long long col0 = s * C;
    load_rows<T>(smem, stride, x, d, 0, rows, rows, col0, d, a.rowb_shift - 2, a.aligned);
    cp_async_commit();
    const int ncols = static_cast<int>(d - col0 < C ? d - col0 : C);
    for (int i = tid; i < R * C; i += kRsThreads) {
      const int k = i / C, c = i - k * C;
      vs[i] = c < ncols ? a.v[k * d + col0 + c] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    if (WG) {
      // Column pass: thread (qq, grp) sums quad qq of rows grp, grp + ng,
      // ..., two weight vectors per sweep; lanes holding the same quad then
      // reduce by shuffles, and the warps in order.
      const unsigned char* col = smem + qq * 16;
      for (int k0 = 0; k0 < WG; k0 += 2) {
        const float* w0 = a.w + static_cast<long long>(k0) * rows;
        const float* w1 = k0 + 1 < WG ? w0 + rows : w0;
        float acc0[per], acc1[per];
#pragma unroll
        for (int j = 0; j < per; ++j) acc0[j] = acc1[j] = 0.f;
#pragma unroll 2
        for (int r = grp; r < rows; r += ng) {
          const uint4 q = *reinterpret_cast<const uint4*>(col + r * stride);
          const uint32_t words[4] = {q.x, q.y, q.z, q.w};
          const float a0 = __ldg(w0 + r), a1 = __ldg(w1 + r);
#pragma unroll
          for (int j = 0; j < per; ++j) {
            const float f = unpack<T>(words[j / epw], j % epw);
            acc0[j] = fmaf(a0, f, acc0[j]);
            acc1[j] = fmaf(a1, f, acc1[j]);
          }
        }
        for (int off = qpr; off < 32; off <<= 1) {
#pragma unroll
          for (int j = 0; j < per; ++j) {
            acc0[j] += __shfl_xor_sync(0xffffffffu, acc0[j], off);
            acc1[j] += __shfl_xor_sync(0xffffffffu, acc1[j], off);
          }
        }
        if (lane < qpr) {
#pragma unroll
          for (int j = 0; j < per; ++j) {
            red[(k0 * kWarps + warp) * C + qq * per + j] = acc0[j];
            if (k0 + 1 < WG) red[((k0 + 1) * kWarps + warp) * C + qq * per + j] = acc1[j];
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < WG * C; i += kRsThreads) {
        const int k = i / C, c = i - k * C;
        float tot = 0.f;
        for (int g = 0; g < kWarps; ++g) tot += red[(k * kWarps + g) * C + c];
        if (k < W) {
          if (c < ncols) a.wsum[static_cast<long long>(k) * d + col0 + c] = tot;
        } else {
          ts[(k - W) * C + c] = tot;
        }
      }
      __syncthreads();
    }

    // Row pass: one thread per row over its slab row (zero past d).
    for (int r = tid; r < rows; r += kRsThreads) {
      const unsigned char* row = smem + r * stride;
      if (a.sq_mode || a.want_signs) {
        float fsq = 0.f;
        int isq = 0, pos = 0, neg = 0;
        for (int b = 0; b < rowb; b += 16) {
          const uint4 q = *reinterpret_cast<const uint4*>(row + b);
          const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int j = 0; j < per; ++j) {
            const float f = unpack<T>(words[j / epw], j % epw);
            if constexpr (std::is_same<T, int8_t>::value) {
              const int v = static_cast<int>(f);
              isq += v * v;
            } else {
              fsq = fmaf(f, f, fsq);
            }
            pos += f > 0.f;
            neg += f < 0.f;
          }
        }
        if (a.sq_mode == 1) fp[r * KF] += fsq;
        if (a.sq_mode == 2) ip[r * 3] += isq;
        ip[r * 3 + 1] += pos;
        ip[r * 3 + 2] += neg;
      }
      for (int k = 0; k < R; ++k) fp[r * KF + doff + k] += slab_dot<T>(row, rowb, vs + k * C);
      for (int k = 0; k < G; ++k) fp[r * KF + goff + k] += slab_dot<T>(row, rowb, ts + k * C);
    }
    __syncthreads();
  }
  // Per-CTA row partials out.
  float* fo = a.fpart + static_cast<size_t>(blockIdx.x) * rows * KF;
  int* io = a.ipart + static_cast<size_t>(blockIdx.x) * rows * 3;
  for (int i = tid; i < rows * KF; i += kRsThreads) fo[i] = fp[i];
  for (int i = tid; i < rows * 3; i += kRsThreads) io[i] = ip[i];
}

__global__ void rowstats_finalize(const float* fpart, const int* ipart, int grid, int rows,
                                  int KF, int sq_mode, int want_signs, int R, int G,
                                  long long d_true, float* sq_out, float* signs_out,
                                  float* dots_out, float* gd_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int doff = sq_mode == 1 ? 1 : 0, goff = doff + R;
  float fsq = 0.f;
  long long isq = 0, pos = 0, neg = 0;
  for (int b = 0; b < grid; ++b) {
    const size_t base = static_cast<size_t>(b) * rows + r;
    if (sq_mode == 1) fsq += fpart[base * KF];
    isq += ipart[base * 3];
    pos += ipart[base * 3 + 1];
    neg += ipart[base * 3 + 2];
  }
  if (sq_mode == 1) sq_out[r] = fsq;
  if (sq_mode == 2) sq_out[r] = static_cast<float>(isq);
  if (want_signs) {
    signs_out[r * 3] = static_cast<float>(pos);
    signs_out[r * 3 + 1] = static_cast<float>(neg);
    signs_out[r * 3 + 2] = static_cast<float>(d_true - pos - neg);
  }
  for (int k = 0; k < R; ++k) {
    float s = 0.f;
    for (int b = 0; b < grid; ++b) s += fpart[(static_cast<size_t>(b) * rows + r) * KF + doff + k];
    dots_out[r * R + k] = s;
  }
  for (int k = 0; k < G; ++k) {
    float s = 0.f;
    for (int b = 0; b < grid; ++b) s += fpart[(static_cast<size_t>(b) * rows + r) * KF + goff + k];
    gd_out[r * G + k] = s;
  }
}

// --------------------------------------------------------------------------
// Gram
// --------------------------------------------------------------------------

constexpr int kRowB = 64;            // bytes of a tile row per stage
constexpr int kTStride = kRowB + 16;  // 80 B: conflict-free ldmatrix rows
constexpr int kTWords = kTStride / 4;
constexpr int kMmaTile = 128;
constexpr int kMmaStages = 3;
constexpr int kFlush = 8;  // stages (256 bf16 columns) per mma accumulation
constexpr int kF32Tile = 64;
constexpr int kF32Stages = 2;

struct GramArgs {
  const void* x;
  int rows;
  long long d;
  int nt;          // tiles per side
  int npairs;      // nt (nt + 1) / 2 upper-triangle tiles
  long long span;  // columns per split (a multiple of the stage depth)
  void* part;      // (splits, npairs, tile, tile) f32 or int32
  int aligned;
};

__device__ __forceinline__ void pair_tiles(int p, int nt, int* ti, int* tj) {
  int i = 0;
  while (p >= nt - i) {
    p -= nt - i;
    ++i;
  }
  *ti = i;
  *tj = i + p;
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 matrices of 16-bit pairs from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, per matrix, the
// 4-byte word (l / 4, l % 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const unsigned char* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// bf16 (Acc = float) or int8 (Acc = int).  Eight warps as 2 x 4, each
// computing a 64 x 32 block of the 128 x 128 tile as 4 x 4 mma tiles.  In
// bytes the two fragment layouts coincide: per 32-byte k-step, A takes
// words (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of its 16-row tile
// and B words (g, t), (g, t + 4) of its 8-row tile (g = lane / 4,
// t = lane % 4), where B's rows are X's rows j; ldmatrix.x4 loads one A
// fragment, or the B fragments of two 8-row tiles, at once.
template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads, 1) gram_mma_kernel(GramArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* x = static_cast<const T*>(a.x);
  constexpr int bke = kRowB / sizeof(T);  // columns per stage
  constexpr int tile_bytes = kMmaTile * kTStride;
  constexpr bool kFloat = std::is_same<Acc, float>::value;
  const int p = blockIdx.x % a.npairs;
  const long long split = blockIdx.x / a.npairs;
  int ti, tj;
  pair_tiles(p, a.nt, &ti, &tj);
  const bool diag = ti == tj;
  const int ra = ti * kMmaTile, rb = tj * kMmaTile;
  const long long k0 = split * a.span;
  const long long k1 = k0 + a.span < a.d ? k0 + a.span : a.d;
  const int nk = static_cast<int>((k1 - k0 + bke - 1) / bke);

  auto load_stage = [&](int st, long long kb) {
    unsigned char* base = smem + st * 2 * tile_bytes;
    load_rows<T>(base, kTStride, x, a.d, ra, kMmaTile, a.rows, kb, k1, 4, a.aligned);
    if (!diag)
      load_rows<T>(base + tile_bytes, kTStride, x, a.d, rb, kMmaTile, a.rows, kb, k1, 4,
                   a.aligned);
  };

  Acc acc[4][4][4];
  float tot[4][4][4];  // bf16: the rounded-to-nearest sum of the flushes
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[i][j][k] = Acc(0);
        tot[i][j][k] = 0.f;
      }

  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < nk) load_stage(st, k0 + static_cast<long long>(st) * bke);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  // This lane's ldmatrix row and byte offsets (see ldmatrix_x4).
  const int a_row = wm + (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 16 * (lane >> 4);
  const int b_row = wn + (lane & 7) + 8 * (lane >> 4), b_col = 16 * ((lane >> 3) & 1);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int nxt = kt + kMmaStages - 1;
    if (nxt < nk) load_stage(nxt % kMmaStages, k0 + static_cast<long long>(nxt) * bke);
    cp_async_commit();
    const unsigned char* As = smem + (kt % kMmaStages) * 2 * tile_bytes;
    const unsigned char* Bs = diag ? As : As + tile_bytes;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], As + (a_row + mi * 16) * kTStride + kk * 32 + a_col);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Bs + (b_row + np * 16) * kTStride + kk * 32 + b_col);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], af[mi], bf[ni]);
    }
    if constexpr (kFloat) {
      if ((kt + 1) % kFlush == 0 || kt + 1 == nk) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              tot[i][j][k] += acc[i][j][k];
              acc[i][j][k] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (kFloat) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = tot[i][j][k];
  }

  const int g = lane >> 2, t = lane & 3;
  Acc* out = static_cast<Acc*>(a.part) +
             (static_cast<size_t>(split) * a.npairs + p) * kMmaTile * kMmaTile;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t;
      out[r * kMmaTile + c] = acc[mi][ni][0];
      out[r * kMmaTile + c + 1] = acc[mi][ni][1];
      out[(r + 8) * kMmaTile + c] = acc[mi][ni][2];
      out[(r + 8) * kMmaTile + c + 1] = acc[mi][ni][3];
    }
}

// f32: 64 x 64 tiles, 16 columns per stage, each thread a 4 x 4 block of
// rows ty + 16 i and columns tx + 16 j, plain FMA.
__global__ void __launch_bounds__(kThreads) gram_f32_kernel(GramArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* x = static_cast<const float*>(a.x);
  constexpr int bke = kRowB / 4;
  constexpr int tile_bytes = kF32Tile * kTStride;
  const int p = blockIdx.x % a.npairs;
  const long long split = blockIdx.x / a.npairs;
  int ti, tj;
  pair_tiles(p, a.nt, &ti, &tj);
  const bool diag = ti == tj;
  const int ra = ti * kF32Tile, rb = tj * kF32Tile;
  const long long k0 = split * a.span;
  const long long k1 = k0 + a.span < a.d ? k0 + a.span : a.d;
  const int nk = static_cast<int>((k1 - k0 + bke - 1) / bke);
  auto load_stage = [&](int st, long long kb) {
    unsigned char* base = smem + st * 2 * tile_bytes;
    load_rows<float>(base, kTStride, x, a.d, ra, kF32Tile, a.rows, kb, k1, 4, a.aligned);
    if (!diag)
      load_rows<float>(base + tile_bytes, kTStride, x, a.d, rb, kF32Tile, a.rows, kb, k1, 4,
                       a.aligned);
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_stage(0, k0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < nk) load_stage((kt + 1) % kF32Stages, k0 + static_cast<long long>(kt + 1) * bke);
    cp_async_commit();
    const float* As = reinterpret_cast<const float*>(smem + (kt % kF32Stages) * 2 * tile_bytes);
    const float* Bs = diag ? As : As + tile_bytes / 4;
#pragma unroll
    for (int k = 0; k < bke; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(ty + 16 * i) * kTWords + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * kTWords + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.part) +
               (static_cast<size_t>(split) * a.npairs + p) * kF32Tile * kF32Tile;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(ty + 16 * i) * kF32Tile + tx + 16 * j] = acc[i][j];
}

// --------------------------------------------------------------------------
// Gram on Hopper: TMA + wgmma (bf16 and int8 rows 16-byte aligned)
// --------------------------------------------------------------------------
//
// Replaces the Gram of blades_tpu/ops/pallas_rowstats.py:98
// (_rowstats_kernel, want_gram, and its int8 branch) for bf16 and int8
// matrices whose rows are 16-byte aligned: the streamed round's (1000,
// d_alloc) bf16 buffer, padded as the JAX package pads it (d_alloc a
// multiple of 512), and the wire round's (1000, 4,903,248) int8 payload.
// Bounds on the H100, counting the symmetric half, n (n + 1) / 2 * d * 2
// operations: bf16 at (1000, 4,903,424) 4.9e12 over 989 TFLOP/s = 4.96 ms;
// int8 at (1000, 4,903,248) 4.9e12 over 1,979 TOP/s = 2.48 ms (its bytes,
// 4.9 GB over 3.35 TB/s, 1.47 ms).  The 36 whole upper-triangle tiles do
// 5.78e12: 5.85 / 2.92 ms.
//
// Design: the same 128 x 128 upper-triangle tiles, d-splits and (splits,
// npairs, 128, 128) partials (f32 for bf16, int32 for int8) as
// gram_mma_kernel, so gram_finalize and the split search are shared.  One
// 2-D TMA descriptor over the (rows, d) matrix loads 128-row x 128-byte
// boxes (64 bf16 or 128 int8 columns: one 128-byte swizzle row) into a
// kWgStages-deep ring of 32 KB stages (a diagonal tile loads one box and
// reads it as both operands); the rows >= rows and columns >= d come in as
// zeros from TMA's out-of-bounds fill, so nothing is masked here.
// Warpgroup 2 is the producer (one thread issues the loads); warpgroups 0
// and 1 each own a 64-row half of the tile and run wgmma m64n128k16 (bf16)
// or m64n128k32 (s8) on K-major A and B straight from shared memory, with
// full / empty mbarriers per stage.
//
// Sums.  bf16: the tensor cores' f32 accumulation truncates (see the Gram
// note above), so every kWgFlush stages (256 columns) a consumer waits for
// its wgmma groups, adds the accumulator into a separate f32 sum with
// ordinary rounding, and restarts it.  int8: integer sums are exact, so the
// s32 accumulator runs over the CTA's whole span.  The plan caps a span at
// kWgMaxStages stages of 128 columns = kInt8Span, where a partial is at
// most 65,536 * 128^2 = 2^30 < 2^31 in magnitude and cannot wrap, and
// gram_finalize adds the partials in split order in int64 and rounds to
// f32 once: the result is bit-identical to gram_mma_kernel's and to the
// exact Gram.  No .satfinite: saturation would hide a wrong span cap.
//
// Limit: every CTA streams its two 128-row tiles through shared memory,
// so a Gram moves 64 tile-loads x 128 rows x the row's bytes from L2 into
// shared memory (80 GB for the bf16 buffer, 40 GB for the int8 payload).
// Measured on the H100 (PERF.md §6): the int8 payload takes 9.9 ms, 4.0x
// its bound (4.0 TB/s into shared memory, 0.58 POP/s), where
// gram_mma_kernel takes 24.6 ms; the same tiles at 1 << 20 columns run at
// 7.6 TB/s, so neither the tensor cores nor L2 -> shared memory stop the
// full width, and the rate falls as the matrix widens (L2 reuse across
// waves or address translation; not yet measured by counters).
// Resident CTA groups walking every split, and shorter spans, ran slower.
// A 2-CTA cluster multicasting the shared tile (or a 128 x 256 tile)
// would halve the loads.

constexpr int kWgTile = 128;      // tile side (rows of X per operand)
constexpr int kWgRowB = 128;      // bytes of a tile row per stage: one swizzle row
constexpr int kWgStages = 5;
constexpr int kWgFlush = 4;       // bf16 stages (256 columns) per wgmma accumulation
// Stages one CTA walks at most (32,768 bf16 or 65,536 int8 columns, which
// is kInt8Span).  The CTAs that share a tile row drift apart over a long
// span (a diagonal tile loads half as much a stage), and the L2 cache then
// serves fewer of one CTA's rows to the others: at the round's shape the
// wave-filling 11 splits give each CTA 6,966 bf16 stages, and on the H100
// a cap of 512 (154 splits, still whole waves) ran faster than 256, 1024,
// 2048 or none (PERF.md §6).
constexpr long long kWgMaxStages = 512;
static_assert(kWgMaxStages * kWgRowB <= kInt8Span, "int8 spans must stay int32-exact");
constexpr int kWgBox = kWgTile * kWgRowB;   // bytes of one operand box
constexpr int kWgConsumers = 256;           // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // + the producer warpgroup
constexpr int kWgSmem = kWgStages * 2 * kWgBox + 1024 + 2 * kWgStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Wait for the phase of parity `parity` of the mbarrier `bar` to complete.
// The spin stays inside the asm: a loop the compiler sees would put the
// wgmma that follows on a divergent path, and ptxas then serializes every
// wgmma (its warning C7518).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// One box of `tmap` at (column c, row r) into shared memory at dst,
// completing on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tmap, uint32_t bar,
                                            int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}
// The wgmma descriptor of a K-major operand under 128-byte swizzle at
// shared address `addr`: 8-row groups 1024 bytes apart (SBO), LBO unused
// (1), layout 1 = 128-byte swizzle.  A 32-byte k-step (k16 bf16, k32 s8)
// within the 128-byte swizzle row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulator across the
// asynchronous wgmma's fence, commit and wait.
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, f32, 64 registers a thread) (+)= A (64 x 16) B^T, A and B
// K-major bf16 tiles in shared memory under 128-byte swizzle; `accumulate`
// 0 overwrites D.
__device__ __forceinline__ void wgmma_step(float* d, uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// The same for s8: D (64 x 128, s32) (+)= A (64 x 32) B^T.  The integer
// form has no scale or transpose operands (8-bit operands are K-major
// only).
__device__ __forceinline__ void wgmma_step(int* d, uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// T = uint16_t: bf16 rows, f32 partials; T = int8_t: s8 rows, int32
// partials.  CTA b computes tile pair b % npairs over split b / npairs.
template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    gram_wgmma_kernel(const __grid_constant__ CUtensorMap tmap, GramArgs a) {
  constexpr bool kInt = std::is_same<T, int8_t>::value;
  using Acc = typename std::conditional<kInt, int, float>::type;
  constexpr int kK = kWgRowB / sizeof(T);  // columns per stage
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle wants 1024-byte aligned boxes.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + kWgStages * 2 * kWgBox;  // kWgStages mbarriers
  const uint32_t empty = full + kWgStages * 8;          // kWgStages mbarriers

  const int p = blockIdx.x % a.npairs;
  const long long split = blockIdx.x / a.npairs;
  int ti, tj;
  pair_tiles(p, a.nt, &ti, &tj);
  const bool diag = ti == tj;
  const long long k0 = split * a.span;
  const long long k1 = k0 + a.span < a.d ? k0 + a.span : a.d;
  const int nk = static_cast<int>((k1 - k0 + kK - 1) / kK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup, known to the compiler as uniform across each warp.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == 2) {
    // Producer: one thread keeps the ring full.  The span is a multiple of
    // kK, so no box reaches past this split's columns but at d.
    if (threadIdx.x == kWgConsumers) {
      const uint32_t bytes = diag ? kWgBox : 2 * kWgBox;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kWgStages;
        mbar_wait(empty + 8 * s, ((kt / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        const int col = static_cast<int>(k0 + static_cast<long long>(kt) * kK);
        const uint32_t dst = base + s * 2 * kWgBox;
        tma_load_2d(dst, &tmap, full + 8 * s, col, ti * kWgTile);
        if (!diag) tma_load_2d(dst + kWgBox, &tmap, full + 8 * s, col, tj * kWgTile);
      }
    }
  } else {
    // Consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of the tile
    // against all 128 of the other operand.
    Acc acc[64];
    float tot[kInt ? 1 : 64];  // bf16: the rounded-to-nearest sum of the flushes
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = Acc(0);
#pragma unroll
    for (int i = 0; i < (kInt ? 1 : 64); ++i) tot[i] = 0.f;
    int held = -1;  // the stage an unfinished wgmma group still reads
    int fresh = 1;  // the next wgmma starts a new accumulation
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kWgStages;
      mbar_wait(full + 8 * s, (kt / kWgStages) & 1);
      const uint32_t a_tile = base + s * 2 * kWgBox;
      const uint32_t b_tile = diag ? a_tile : a_tile + kWgBox;
      const uint64_t da = wg_desc(a_tile + wg * 64 * kWgRowB), db = wg_desc(b_tile);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kWgRowB / 32; ++k)  // 32 bytes = 2 descriptor units a step
        wgmma_step(acc, da + 2 * k, db + 2 * k, k > 0 || !fresh);
      wgmma_commit();
      // bf16 restarts its accumulator every kWgFlush stages; int8 sums run
      // over the whole span and wait once, after the loop (a wait inside it
      // that the compiler cannot place makes ptxas serialize the wgmmas).
      if (!kInt && ((kt + 1) % kWgFlush == 0 || kt + 1 == nk)) {
        wgmma_wait<0>();
        fence_regs(acc);
        if (held >= 0) mbar_arrive(empty + 8 * (held % kWgStages));
        mbar_arrive(empty + 8 * s);
        held = -1;
#pragma unroll
        for (int i = 0; i < (kInt ? 1 : 64); ++i) tot[i] += acc[i];
        fresh = 1;
      } else {
        wgmma_wait<1>();  // every group but this stage's has finished
        if (held >= 0) mbar_arrive(empty + 8 * (held % kWgStages));
        held = kt;
        fresh = 0;
      }
    }
    // Accumulator layout of m64nNk16 / m64nNk32: register 4j + e of thread
    // (warp w, lane l) holds row 16 w + l / 4 + 8 (e / 2), column 8 j + 2
    // (l % 4) + e % 2.
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    Acc* out = static_cast<Acc*>(a.part) +
               (static_cast<size_t>(split) * a.npairs + p) * kWgTile * kWgTile;
    const int r = wg * 64 + 16 * w + l / 4;
    if constexpr (kInt) {
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * (l % 4);
        *reinterpret_cast<int2*>(out + r * kWgTile + c) = make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(out + (r + 8) * kWgTile + c) =
            make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * (l % 4);
        *reinterpret_cast<float2*>(out + r * kWgTile + c) = make_float2(tot[4 * j], tot[4 * j + 1]);
        *reinterpret_cast<float2*>(out + (r + 8) * kWgTile + c) =
            make_float2(tot[4 * j + 2], tot[4 * j + 3]);
      }
    }
  }
}

// out[i, j] = sum over splits, in split order, of the upper-triangle entry
// (min(i, j), max(i, j)).
template <typename Acc, typename Sum>
__global__ void gram_finalize(const Acc* part, int rows, int tile, int nt, int npairs,
                              int splits, float* out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * rows) return;
  const int i = static_cast<int>(idx / rows), j = static_cast<int>(idx % rows);
  const int u = i < j ? i : j, v = i < j ? j : i;
  const int ti = u / tile, tj = v / tile;
  const int p = ti * nt - ti * (ti - 1) / 2 + (tj - ti);
  const size_t e = static_cast<size_t>(u % tile) * tile + (v % tile);
  const size_t tsz = static_cast<size_t>(tile) * tile;
  Sum s = Sum(0);
  for (int k = 0; k < splits; ++k) s += part[(static_cast<size_t>(k) * npairs + p) * tsz + e];
  out[idx] = static_cast<float>(s);
}

// --------------------------------------------------------------------------
// Row statistics on Hopper: a ring of row groups (rows 16-byte aligned)
// --------------------------------------------------------------------------
//
// Replaces the row statistics of blades_tpu/ops/pallas_rowstats.py:98
// (_rowstats_kernel: sq, signs, dots, wsum, gram_dot) for matrices whose
// rows are 16-byte aligned -- d * sizeof(T) % 16 == 0 and a 16-byte-aligned
// base: f32 with d % 4 == 0, bf16 with d % 8 == 0, int8 with d % 16 == 0 --
// at any row count.  The streamed round's (n, d_alloc) buffer is such a
// matrix (ops/_cuda.py::rowstats_route).  Bound on the H100: one read of
// the matrix, 9.81 GB at (1000, 4,903,424) bf16 over 3.35 TB/s = 2.93 ms.
//
// Design.  Each CTA (512 threads, one per SM) walks column slabs of `rowb`
// bytes per row.  A slab's rows stream through a shared-memory ring of
// `ahead` + 1 row groups (`gh` rows each) filled by 16-byte cp.async.cg,
// `ahead` groups in flight while one is computed: the HBM read overlaps
// the passes, and the ring runs on from one slab into the next.  The ring's
// position is kept in counters, not divided out of a load index (a 64-bit
// division per group in every thread cost more than the passes).  Thread
// (quad qq, row lane rl) owns quad qq of rows rl, rl + 512 / qpr, ... of
// every group, so a warp reads 512 contiguous bytes of the ring, and works
// on kRgIlp of its rows side by side.
//  - Column pass (w^T X_slab for each column-pass vector, kRgVecs a sweep):
//    register accumulators across every group of the slab, then one
//    reduction across the slab -- lanes of a quad by shuffles, warps in a
//    fixed order -- written out as `wsum` and kept in shared memory as
//    t = g^T X_slab for `gram_dot`.  A gram_dot vector that is the same
//    tensor as a wsum vector (gsrc) takes no pass of its own: its t is that
//    wsum, bit for bit.
//  - Row pass (sq, sign counts, dots): on each group as it arrives, the
//    quads of a row summed by shuffles, one lane adding into the row's
//    per-CTA partial.
//  - gram_dot needs t over all rows before X_slab t: a further sweep over
//    the slab's groups, loaded again through the ring from L2 (132 slabs of
//    1000 rows x 256 B are 34 MB of the 50 MB L2), so HBM reads the matrix
//    once.
//  - Per-row partials live in shared memory when they fit, else in the
//    per-CTA global partials (no row cap); rowstats_finalize sums them in
//    CTA order.  Deterministic, no float atomics; sign counts and int8
//    norms are integers (int8: at most kInt8Span columns per CTA).
// The geometry (ops/_cuda.py: RING_ROWB, RING_GH, RING_AHEAD) was chosen by
// timing the round's bundles on the H100 (chip_smoke.py's ringsweep and
// kernels phases; PERF.md section 6).  Measured there and dropped: keeping
// the slab resident in shared memory for the gram_dot sweep (it fits only
// narrower slabs with fewer groups in flight), a TMA producer warp with
// mbarriers in place of the block's cp.async (its loads read slower), two
// CTAs an SM (register spills), and the gram_dot sweep reading the slab
// from L2 into registers (exposed latency).  GeoMed's bundle is bound by
// the passes' instruction issue at one CTA of 16 warps an SM, not by HBM.

constexpr int kRgThreads = 512;
constexpr int kRgWarps = kRgThreads / 32;
constexpr int kRgVecs = 2;   // column-pass vectors per sweep
constexpr int kRgMaxG = 16;  // gram_dot vectors per launch
constexpr int kRgIlp = 8;    // rows a thread computes side by side

struct RingArgs {
  const unsigned char* x;
  int rows;
  long long d;
  int sq_mode;     // 0 none, 1 f32 partial (fp[0]), 2 int partial (ip[0])
  int want_signs;
  const float* v;  // (R, d)
  int R;
  const float* u;  // (U, rows): the column-pass vectors, the W wsum ones first
  int U, W, G;
  int gsrc[kRgMaxG];  // gram_dot k takes t from column-pass vector gsrc[k]
  float* wsum;        // (W, d)
  float* fpart;       // (grid, rows, KF): [sq], dots R, gram_dot G
  int* ipart;         // (grid, rows, 3): int8 sq, pos, neg
  int KF;
  int qpr_shift;   // log2 of the 16-byte quads per slab row
  int gh;          // rows per group, a multiple of kRgIlp * (kRgThreads >> qpr_shift)
  int ahead;       // groups in flight; the ring holds ahead + 1
  int part_smem;
  int probe;       // kernels' phase timing: 1 the loads alone, 2 the passes alone
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// Wait until at most n committed groups are pending (n above 7 waits for
// 7: longer than asked, never shorter).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// Each of kRgIlp sums over the lanes of its row (the qpr lanes next to
// each other), the shuffles of the rows interleaved.
template <typename V>
__device__ __forceinline__ void row_sums(V (&x)[kRgIlp], int qpr) {
  for (int off = 1; off < qpr; off <<= 1)
#pragma unroll
    for (int i = 0; i < kRgIlp; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], off);
}

// The column pass over kRgIlp rows: acc[v][j] += wv[i][v] * x[i][j] for
// the first NV vectors (NV a constant, so the unrolled loop has no branch).
template <int NV, typename T>
__device__ __forceinline__ void col_accum(float (&acc)[kRgVecs][16 / sizeof(T)],
                                          const uint32_t (&wd)[kRgIlp][4],
                                          const float (&wv)[kRgIlp][kRgVecs]) {
  constexpr int epw = 4 / sizeof(T), per = 4 * epw;
#pragma unroll
  for (int i = 0; i < kRgIlp; ++i)
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const float f = unpack<T>(wd[i][j / epw], j % epw);
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v][j] = fmaf(wv[i][v], f, acc[v][j]);
    }
}

// kRgIlp 16-byte quads (one per row) dotted with the same per = 16 /
// sizeof(T) entries of a slab-wide f32 vector in shared memory (16-byte
// aligned).
template <typename T>
__device__ __forceinline__ void quad_dots(const uint32_t (&wd)[kRgIlp][4], const float* vec,
                                          float (&out)[kRgIlp]) {
  constexpr int epw = 4 / sizeof(T), per = 4 * epw;
  float vv[per];
#pragma unroll
  for (int j4 = 0; j4 < per / 4; ++j4) {
    const float4 f = reinterpret_cast<const float4*>(vec)[j4];
    vv[4 * j4] = f.x;
    vv[4 * j4 + 1] = f.y;
    vv[4 * j4 + 2] = f.z;
    vv[4 * j4 + 3] = f.w;
  }
#pragma unroll
  for (int i = 0; i < kRgIlp; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < per; ++j) acc = fmaf(unpack<T>(wd[i][j / epw], j % epw), vv[j], acc);
    out[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRgThreads, 1) rowstats_ring_kernel(const __grid_constant__ RingArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int epw = 4 / sizeof(T), per = 4 * epw;  // columns per word, per quad
  const int qpr = 1 << a.qpr_shift, rowb = qpr * 16, C = qpr * per;
  const int rps = kRgThreads >> a.qpr_shift;  // rows per sweep of the block
  const int gh = a.gh, rpt = gh / rps;        // rows per group, per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qq = tid & (qpr - 1), rl = tid >> a.qpr_shift;
  const int rows = a.rows, R = a.R, U = a.U, W = a.W, G = a.G, KF = a.KF;
  const int P = a.ahead, S = P + 1;
  const long long rowbytes = a.d * static_cast<long long>(sizeof(T));
  const long long nslab = (a.d + C - 1) / C;
  const int ng = (rows + gh - 1) / gh;
  const int ncs = (U + kRgVecs - 1) / kRgVecs;
  const int nsw = (ncs > 1 ? ncs : 1) + (G > 0 ? 1 : 0);
  const int lps = nsw * ng;  // loads per slab
  const int stage_bytes = gh * rowb;
  const bool want_ip = a.sq_mode == 2 || a.want_signs;
  const bool row_pass = a.sq_mode || a.want_signs || R;
  const int doff = a.sq_mode == 1 ? 1 : 0, goff = doff + R;
  const int wrow = (warp * 32) >> a.qpr_shift;  // the warp's first row lane

  unsigned char* ring = smem;
  float* vs = reinterpret_cast<float*>(smem + static_cast<size_t>(S) * stage_bytes);  // (R, C)
  float* ts = vs + R * C;                                        // (G, C)
  float* red = ts + G * C;                                       // (kRgVecs, kRgWarps, C)
  float* fp;
  int* ip;
  if (a.part_smem) {
    fp = red + (U ? kRgVecs * kRgWarps * C : 0);  // (rows, KF)
    ip = reinterpret_cast<int*>(fp + static_cast<size_t>(rows) * KF);  // (rows, 3)
  } else {
    fp = a.fpart + static_cast<size_t>(blockIdx.x) * rows * KF;
    ip = a.ipart + static_cast<size_t>(blockIdx.x) * rows * 3;
  }
  for (int i = tid; i < rows * KF; i += kRgThreads) fp[i] = 0.f;
  if (want_ip)
    for (int i = tid; i < rows * 3; i += kRgThreads) ip[i] = 0;

  const long long my_slabs =
      blockIdx.x < nslab ? (nslab - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // The loads, in order: for each of this CTA's slabs, lps groups (group
  // j % ng), each into the next stage of the ring; rows >= rows and quads
  // past d are zero-filled.  The position is kept as counters: a 64-bit
  // division per step, in every thread, cost more than the passes.
  long long is_sl = 0;   // slab of the next load to issue
  int is_j = 0, is_g = 0, is_st = 0;  // its load within the slab, group, stage
  const long long row_step = rps * rowbytes;
  auto issue = [&]() {  // always commits: every step has one group to wait for
    if (is_sl < my_slabs) {
      const long long cb =
          (blockIdx.x + is_sl * gridDim.x) * static_cast<long long>(rowb) + qq * 16;
      const bool col_ok = cb < rowbytes;
      unsigned char* dst = ring + static_cast<size_t>(is_st) * stage_bytes + rl * rowb + qq * 16;
      int r = is_g * gh + rl;
      const unsigned char* src = a.x + static_cast<long long>(r) * rowbytes + cb;
      for (int i = 0; i < rpt && a.probe != 2; ++i, r += rps, src += row_step, dst += rps * rowb) {
        const bool ok = col_ok && r < rows;
        cp_async16(dst, ok ? static_cast<const void*>(src) : static_cast<const void*>(a.x), ok);
      }
      if (++is_st == S) is_st = 0;
      if (++is_g == ng) is_g = 0;
      if (++is_j == lps) {
        is_j = 0;
        ++is_sl;
      }
    }
    cp_async_commit();
  };

  for (int p = 0; p < P; ++p) issue();
  int cs = 0;  // the stage of the next load to consume
  for (long long sl = 0; sl < my_slabs; ++sl) {
    const long long col0 = (blockIdx.x + sl * gridDim.x) * static_cast<long long>(C);
    const int ncols = static_cast<int>(a.d - col0 < C ? a.d - col0 : C);
    if (R) {
      __syncthreads();  // the previous slab's row pass is done with vs
      for (int i = tid; i < R * C; i += kRgThreads) {
        const int k = i / C, c = i - k * C;
        vs[i] = c < ncols ? a.v[k * a.d + col0 + c] : 0.f;
      }  // visible after the first group's __syncthreads
    }
    for (int sw = 0; sw < nsw; ++sw) {
      const int ub = sw * kRgVecs;  // this sweep's column-pass vectors
      const int nv = sw < ncs ? (U - ub < kRgVecs ? U - ub : kRgVecs) : 0;
      const bool first = sw == 0, gd = G > 0 && sw == nsw - 1;
      float acc[kRgVecs][per];
#pragma unroll
      for (int v = 0; v < kRgVecs; ++v)
#pragma unroll
        for (int j = 0; j < per; ++j) acc[v][j] = 0.f;
      for (int g = 0; g < ng; ++g) {
        cp_async_wait_dyn(P - 1);  // this load has landed (this thread's part)
        __syncthreads();           // ... every thread's; the stage P ahead is free
        issue();
        const int st = cs;
        if (++cs == S) cs = 0;
        if (a.probe == 1) continue;
        // kRgIlp rows at a time, their sums and shuffles side by side; a
        // warp stops at the first block of rows past the last row.
        const unsigned char* base = ring + static_cast<size_t>(st) * stage_bytes + rl * rowb + qq * 16;
        for (int i0 = 0; i0 < rpt && wrow + g * gh + i0 * rps < rows; i0 += kRgIlp) {
          uint32_t wd[kRgIlp][4];
          int rr[kRgIlp];
          bool own[kRgIlp];
#pragma unroll
          for (int i = 0; i < kRgIlp; ++i) {
            const uint4 q = *reinterpret_cast<const uint4*>(base + (i0 + i) * rps * rowb);
            wd[i][0] = q.x;
            wd[i][1] = q.y;
            wd[i][2] = q.z;
            wd[i][3] = q.w;
            rr[i] = g * gh + rl + (i0 + i) * rps;  // rows past the end read zeros
            own[i] = rr[i] < rows && qq == 0;
          }
          if (nv) {
            float wv[kRgIlp][kRgVecs];
#pragma unroll
            for (int i = 0; i < kRgIlp; ++i)
#pragma unroll
              for (int v = 0; v < kRgVecs; ++v)
                wv[i][v] = v < nv && rr[i] < rows
                               ? __ldg(a.u + static_cast<long long>(ub + v) * rows + rr[i])
                               : 0.f;
            if (nv == 1)
              col_accum<1, T>(acc, wd, wv);
            else
              col_accum<kRgVecs, T>(acc, wd, wv);
          }
          if (first && row_pass) {
            if (a.sq_mode || a.want_signs) {
              float fsq[kRgIlp];
              int isq[kRgIlp], pn[kRgIlp];  // pos + (neg << 16)
#pragma unroll
              for (int i = 0; i < kRgIlp; ++i) {
                fsq[i] = 0.f;
                isq[i] = pn[i] = 0;
#pragma unroll
                for (int j = 0; j < per; ++j) {
                  const float f = unpack<T>(wd[i][j / epw], j % epw);
                  if constexpr (std::is_same<T, int8_t>::value) {
                    const int iv = static_cast<int>(f);
                    isq[i] += iv * iv;
                  } else {
                    fsq[i] = fmaf(f, f, fsq[i]);
                  }
                  pn[i] += (f > 0.f ? 1 : 0) + (f < 0.f ? 1 << 16 : 0);
                }
              }
              if (a.sq_mode == 1) {
                row_sums(fsq, qpr);
#pragma unroll
                for (int i = 0; i < kRgIlp; ++i)
                  if (own[i]) fp[rr[i] * KF] += fsq[i];
              }
              if (a.sq_mode == 2) {
                row_sums(isq, qpr);
#pragma unroll
                for (int i = 0; i < kRgIlp; ++i)
                  if (own[i]) ip[rr[i] * 3] += isq[i];
              }
              if (a.want_signs) {
                row_sums(pn, qpr);
#pragma unroll
                for (int i = 0; i < kRgIlp; ++i)
                  if (own[i]) {
                    ip[rr[i] * 3 + 1] += pn[i] & 0xFFFF;
                    ip[rr[i] * 3 + 2] += pn[i] >> 16;
                  }
              }
            }
            for (int k = 0; k < R; ++k) {
              float dsum[kRgIlp];
              quad_dots<T>(wd, vs + k * C + qq * per, dsum);
              row_sums(dsum, qpr);
#pragma unroll
              for (int i = 0; i < kRgIlp; ++i)
                if (own[i]) fp[rr[i] * KF + doff + k] += dsum[i];
            }
          }
          if (gd) {
            for (int k = 0; k < G; ++k) {
              float dsum[kRgIlp];
              quad_dots<T>(wd, ts + k * C + qq * per, dsum);
              row_sums(dsum, qpr);
#pragma unroll
              for (int i = 0; i < kRgIlp; ++i)
                if (own[i]) fp[rr[i] * KF + goff + k] += dsum[i];
            }
          }
        }
      }
      if (nv && a.probe != 1) {
        // The column sums across the slab: lanes of a quad, then warps in
        // order; written as wsum and kept as t for the gram_dot vectors
        // that take this one.
        for (int off = qpr; off < 32; off <<= 1)
#pragma unroll
          for (int v = 0; v < kRgVecs; ++v)
#pragma unroll
            for (int j = 0; j < per; ++j) acc[v][j] += __shfl_xor_sync(0xffffffffu, acc[v][j], off);
        if (lane < qpr) {
#pragma unroll
          for (int v = 0; v < kRgVecs; ++v)
            if (v < nv)
#pragma unroll
              for (int j = 0; j < per; ++j) red[(v * kRgWarps + warp) * C + qq * per + j] = acc[v][j];
        }
        __syncthreads();
        for (int i = tid; i < nv * C; i += kRgThreads) {
          const int v = i / C, c = i - v * C, u = ub + v;
          float tot = 0.f;
          for (int w8 = 0; w8 < kRgWarps; ++w8) tot += red[(v * kRgWarps + w8) * C + c];
          if (u < W && c < ncols) a.wsum[static_cast<long long>(u) * a.d + col0 + c] = tot;
          for (int k = 0; k < G; ++k)
            if (a.gsrc[k] == u) ts[k * C + c] = tot;
        }
        __syncthreads();  // t is complete; red is free again
      }
    }
  }
  cp_async_wait<0>();
  if (a.part_smem) {
    __syncthreads();
    float* fo = a.fpart + static_cast<size_t>(blockIdx.x) * rows * KF;
    for (int i = tid; i < rows * KF; i += kRgThreads) fo[i] = fp[i];
    if (want_ip) {
      int* io = a.ipart + static_cast<size_t>(blockIdx.x) * rows * 3;
      for (int i = tid; i < rows * 3; i += kRgThreads) io[i] = ip[i];
    }
  }
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

int elem_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 1; }

int log2i(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

size_t rowstats_smem(int rows, int esize, int rowb, int R, int W, int G, int KF) {
  const int C = rowb / esize;
  return static_cast<size_t>(rows) * (rowb + 16) + static_cast<size_t>(R + G) * C * 4 +
         static_cast<size_t>(W + G) * (kRsThreads / 32) * C * 4 +
         static_cast<size_t>(rows) * (KF + 3) * 4;
}

template <typename T>
cudaError_t rowstats_occupancy(int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(rowstats_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rowstats_kernel<T>, kRsThreads,
                                                       smem);
}

// Dynamic shared memory of rowstats_ring_kernel: the ring of ahead + 1
// groups, the dots and gram_dot vectors of a slab, the column reduction
// buffer, and (part_smem) the per-row partials.  ops/_cuda.py::ring_smem
// mirrors it.
size_t ring_smem(int rows, int esize, int rowb, int gh, int ahead, int R, int U, int G, int KF,
                 int want_ip, int part_smem) {
  const size_t C = static_cast<size_t>(rowb / esize);
  size_t s = static_cast<size_t>(ahead + 1) * gh * rowb + static_cast<size_t>(R + G) * C * 4 +
             (U ? static_cast<size_t>(kRgVecs) * kRgWarps * C * 4 : 0);
  if (part_smem) s += static_cast<size_t>(rows) * (KF + (want_ip ? 3 : 0)) * 4;
  return s;
}

template <typename T>
cudaError_t ring_occupancy(int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(rowstats_ring_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rowstats_ring_kernel<T>,
                                                       kRgThreads, smem);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

bool rows_aligned(const void* x, int dtype, long long d) {
  return (d * elem_size(dtype)) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing new
// is linked.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The TMA descriptor of a row-major (rows, d) bf16 or int8 matrix in
// 128-row x 128-byte boxes (64 bf16 or 128 int8 columns), 128-byte
// swizzle, zero fill out of bounds; int8 is copied as its bytes (UINT8).
// Needs rows of a whole number of 16 bytes (d % 8 == 0 bf16, d % 16 == 0
// int8) and a 16-byte-aligned base: TMA's row stride is a multiple of 16
// bytes.
cudaError_t gram_tmap(const void* x, int dtype, int rows, long long d, CUtensorMap* map) {
  const int es = elem_size(dtype);
  if (dtype == 0 || (d * es) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  EncodeTiledFn fn;
  cudaError_t e = encode_tiled(&fn);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWgRowB / es), kWgTile};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                        2, const_cast<void*>(x), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t gram_wgmma_setup(int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(gram_wgmma_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gram_wgmma_kernel<T>, kWgThreads,
                                                       kWgSmem);
}

template <typename T, typename Acc>
cudaError_t gram_mma_setup(int* per_sm) {
  const int smem = kMmaStages * 2 * kMmaTile * kTStride;
  cudaError_t e = cudaFuncSetAttribute(gram_mma_kernel<T, Acc>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gram_mma_kernel<T, Acc>, kThreads,
                                                       smem);
}

// The partial reduction of either row-statistics kernel, when any row
// statistic is asked for.
cudaError_t rowstats_finish(const float* fpart, const int* ipart, int grid, int rows, int KF,
                            int sq_mode, int want_signs, int R, int G, long long d_true,
                            float* sq_out, float* signs_out, float* dots_out, float* gd_out,
                            cudaStream_t st) {
  if (!(sq_mode || want_signs || R || G)) return cudaSuccess;
  rowstats_finalize<<<(rows + 255) / 256, 256, 0, st>>>(fpart, ipart, grid, rows, KF, sq_mode,
                                                        want_signs, R, G, d_true, sq_out,
                                                        signs_out, dots_out, gd_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch geometry of the slab kernel (rowstats_kernel: rows that are not
// 16-byte aligned) for (dtype, rows, d) with R dots vectors, W + G weight
// vectors and KF float partials per row: the slab bytes per row (the
// widest slab that fits: on the H100 at the round's shape a wider slab beat
// narrower ones with more CTAs per SM, and with its 4-byte loads
// double-buffering inside a CTA did not pay), the dynamic shared memory
// and the CTA count.  dtype 0 = f32, 1 = bf16, 2 = int8.  Returns a
// cudaError_t (cudaErrorInvalidValue when the rows do not fit: the kernel
// holds every row of a slab in one CTA's shared memory).
int bt_rowstats_plan(int dtype, int rows, long long d, int R, int W, int G, int KF, int* rowb,
                     int* smem, int* grid) {
  const int es = elem_size(dtype);
  *rowb = 0;
  for (int rb = 128; rb >= 16 && !*rowb; rb /= 2) {
    const size_t need = rowstats_smem(rows, es, rb, R, W, G, KF);
    if (need <= static_cast<size_t>(kSmemMax)) {
      *rowb = rb;
      *smem = static_cast<int>(need);
    }
  }
  if (*rowb == 0) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  cudaError_t e = dtype == 0   ? rowstats_occupancy<float>(*smem, &per_sm)
                  : dtype == 1 ? rowstats_occupancy<uint16_t>(*smem, &per_sm)
                               : rowstats_occupancy<int8_t>(*smem, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int C = *rowb / es;
  const long long nslab = (d + C - 1) / C;
  long long g = static_cast<long long>(per_sm) * sm_count();
  if (dtype == 2) {  // int32 row partials: at most kInt8Span columns per CTA
    const long long need = (d + kInt8Span - 1) / kInt8Span;
    if (g < need) g = need;
  }
  if (g > nslab) g = nslab;
  *grid = static_cast<int>(g < 1 ? 1 : g);
  return 0;
}

// Launch geometry of rowstats_ring_kernel for (dtype, rows, d) with R
// dots vectors, U column-pass vectors, G gram_dot vectors and KF float
// partials per row (want_ip: integer partials too); `geom` is (rowb, gh,
// ahead, part_smem), as ops/_cuda.py::ring_plan chooses it.  Checks the geometry and returns the dynamic shared memory and the
// CTA count (a cudaError_t: cudaErrorInvalidValue for a geometry or a
// matrix the kernel does not take).
int bt_rowstats_ring_plan(int dtype, int rows, long long d, int R, int U, int G, int KF,
                          int want_ip, const int* geom, int* smem, int* grid) {
  const int es = elem_size(dtype);
  const int rowb = geom[0], gh = geom[1], ahead = geom[2], part_smem = geom[3];
  if (rowb < 16 || rowb > 512 || (rowb & (rowb - 1)) || (d * es) % 16 || rows < 1 ||
      G > kRgMaxG || ahead < 1 || ahead > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rps = kRgThreads / (rowb / 16);
  if (gh < kRgIlp * rps || gh % (kRgIlp * rps)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = ring_smem(rows, es, rowb, gh, ahead, R, U, G, KF, want_ip, part_smem);
  if (need > static_cast<size_t>(kSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  *smem = static_cast<int>(need);
  int per_sm = 0;
  cudaError_t e = dtype == 0   ? ring_occupancy<float>(*smem, &per_sm)
                  : dtype == 1 ? ring_occupancy<uint16_t>(*smem, &per_sm)
                               : ring_occupancy<int8_t>(*smem, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long nslab = (d + rowb / es - 1) / (rowb / es);
  long long g = static_cast<long long>(per_sm) * sm_count();
  if (dtype == 2) {  // int32 row partials: at most kInt8Span columns per CTA
    const long long need8 = (d + kInt8Span - 1) / kInt8Span;
    if (g < need8) g = need8;
  }
  if (g > nslab) g = nslab;
  *grid = static_cast<int>(g < 1 ? 1 : g);
  return 0;
}

// The row statistics of 16-byte-aligned rows: rowstats_ring_kernel with
// the geometry of bt_rowstats_ring_plan (geom[4]: the probe flag), then the
// partial reduction.  u is (U, rows), its first W rows the wsum weights;
// gram_dot k takes t from row gsrc[k] of u.  Null outputs are not asked
// for.
int bt_rowstats_ring(const void* x, int dtype, int rows, long long d, long long d_true,
                     int want_sq, int want_signs, const float* v, int R, const float* u, int U,
                     int W, int G, const int* gsrc, float* wsum, float* fpart, int* ipart, int KF,
                     const int* geom, int smem, int grid, float* sq_out, float* signs_out,
                     float* dots_out, float* gd_out, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 || G > kRgMaxG || W > U)
    return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a;
  a.x = static_cast<const unsigned char*>(x);
  a.rows = rows;
  a.d = d;
  a.sq_mode = want_sq ? (dtype == 2 ? 2 : 1) : 0;
  a.want_signs = want_signs;
  a.v = v;
  a.R = R;
  a.u = u;
  a.U = U;
  a.W = W;
  a.G = G;
  for (int k = 0; k < kRgMaxG; ++k) {
    a.gsrc[k] = k < G ? gsrc[k] : -1;
    if (k < G && (gsrc[k] < 0 || gsrc[k] >= U)) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.wsum = wsum;
  a.fpart = fpart;
  a.ipart = ipart;
  a.KF = KF;
  a.qpr_shift = log2i(geom[0] / 16);
  a.gh = geom[1];
  a.ahead = geom[2];
  a.part_smem = geom[3];
  a.probe = geom[4];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rowstats_ring_kernel<float><<<grid, kRgThreads, smem, st>>>(a);
  else if (dtype == 1)
    rowstats_ring_kernel<uint16_t><<<grid, kRgThreads, smem, st>>>(a);
  else
    rowstats_ring_kernel<int8_t><<<grid, kRgThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(rowstats_finish(fpart, ipart, grid, rows, KF, a.sq_mode, want_signs,
                                          R, G, d_true, sq_out, signs_out, dots_out, gd_out, st));
}

// The row statistics of any other rows: the slab kernel, then the partial
// reduction.  Null outputs are not asked for.
int bt_rowstats(const void* x, int dtype, int rows, long long d, long long d_true, int want_sq,
                int want_signs, const float* v, int R, const float* w, int W, int G,
                float* wsum, float* fpart, int* ipart, int KF, int rowb, int smem, int grid,
                float* sq_out, float* signs_out, float* dots_out, float* gd_out, void* stream) {
  RsArgs a;
  a.x = x;
  a.rows = rows;
  a.d = d;
  a.sq_mode = want_sq ? (dtype == 2 ? 2 : 1) : 0;
  a.want_signs = want_signs;
  a.v = v;
  a.R = R;
  a.w = w;
  a.W = W;
  a.G = G;
  a.wsum = wsum;
  a.fpart = fpart;
  a.ipart = ipart;
  a.KF = KF;
  a.rowb_shift = log2i(rowb);
  a.aligned = rows_aligned(x, dtype, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rowstats_kernel<float><<<grid, kRsThreads, smem, st>>>(a);
  else if (dtype == 1)
    rowstats_kernel<uint16_t><<<grid, kRsThreads, smem, st>>>(a);
  else
    rowstats_kernel<int8_t><<<grid, kRsThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(rowstats_finish(fpart, ipart, grid, rows, KF, a.sq_mode, want_signs,
                                          R, G, d_true, sq_out, signs_out, dots_out, gd_out, st));
}

// Gram geometry for (dtype, route, rows, d): the tile side, the
// upper-triangle tile count, the d-splits (whole waves of CTAs where d
// allows; on route 1 also at most kWgMaxStages stages a CTA, in a whole
// multiple of the wave-filling count) and the columns per split, a
// multiple of the kernel's stage depth.  int8 spans are at most
// kInt8Span columns, so its int32 partials stay exact.  route 1 is
// gram_wgmma_kernel (bf16 or int8), 0 the kernel of the dtype.
// ops/_cuda.py::gram_plan mirrors this.
int bt_gram_plan(int dtype, int route, int rows, long long d, int* tile, int* npairs,
                 int* splits, long long* span) {
  int per_sm = 0;
  cudaError_t e;
  int bke = kRowB / elem_size(dtype);
  if (route == 1) {
    if (dtype == 0) return static_cast<int>(cudaErrorInvalidValue);
    *tile = kWgTile;
    bke = kWgRowB / elem_size(dtype);
    e = dtype == 1 ? gram_wgmma_setup<uint16_t>(&per_sm) : gram_wgmma_setup<int8_t>(&per_sm);
  } else if (dtype == 0) {
    *tile = kF32Tile;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_f32_kernel, kThreads,
                                                      kF32Stages * 2 * kF32Tile * kTStride);
  } else {
    *tile = kMmaTile;
    e = dtype == 1 ? gram_mma_setup<uint16_t, float>(&per_sm)
                   : gram_mma_setup<int8_t, int>(&per_sm);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nt = (rows + *tile - 1) / *tile;
  *npairs = nt * (nt + 1) / 2;
  const long long nkb = (d + bke - 1) / bke;
  // Splits that fill whole waves of resident CTAs best (ties: fewer).
  const long long resident = static_cast<long long>(per_sm) * sm_count();
  long long s = 1;
  double best = 0.0;
  for (long long c = 1; c <= 4 * resident / *npairs + 1 && c <= nkb; ++c) {
    const long long ctas = c * *npairs;
    const double eff = static_cast<double>(ctas) /
                       (static_cast<double>((ctas + resident - 1) / resident) * resident);
    if (eff > best + 1e-9) {
      best = eff;
      s = c;
    }
  }
  if (route == 1) {  // a whole multiple of the wave-filling split count
    const long long per = (nkb + s - 1) / s;
    if (per > kWgMaxStages) s *= (per + kWgMaxStages - 1) / kWgMaxStages;
  }
  if (dtype == 2) {  // route 1 meets this already: kWgMaxStages * 128 <= kInt8Span
    const long long need = (d + kInt8Span - 1) / kInt8Span;
    if (s < need) s = need;
  }
  *span = (nkb + s - 1) / s * bke;
  *splits = static_cast<int>((d + *span - 1) / *span);
  return 0;
}

// The Gram: the tile kernel of `route` (as in bt_gram_plan) into `part`,
// then the split reduction into the (rows, rows) f32 output.
int bt_gram(const void* x, int dtype, int route, int rows, long long d, int tile, int npairs,
            int splits, long long span, void* part, float* out, void* stream) {
  GramArgs a;
  a.x = x;
  a.rows = rows;
  a.d = d;
  a.nt = (rows + tile - 1) / tile;
  a.npairs = npairs;
  a.span = span;
  a.part = part;
  a.aligned = rows_aligned(x, dtype, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = npairs * splits;
  if (route == 1) {
    if (dtype == 0 || tile != kWgTile || span % (kWgRowB / elem_size(dtype)) != 0 ||
        (dtype == 2 && span > kInt8Span))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap map;
    cudaError_t me = gram_tmap(x, dtype, rows, d, &map);
    if (me != cudaSuccess) return static_cast<int>(me);
    if (dtype == 1)
      gram_wgmma_kernel<uint16_t><<<grid, kWgThreads, kWgSmem, st>>>(map, a);
    else
      gram_wgmma_kernel<int8_t><<<grid, kWgThreads, kWgSmem, st>>>(map, a);
  } else if (dtype == 0) {
    gram_f32_kernel<<<grid, kThreads, kF32Stages * 2 * kF32Tile * kTStride, st>>>(a);
  } else if (dtype == 1) {
    gram_mma_kernel<uint16_t, float>
        <<<grid, kThreads, kMmaStages * 2 * kMmaTile * kTStride, st>>>(a);
  } else {
    gram_mma_kernel<int8_t, int><<<grid, kThreads, kMmaStages * 2 * kMmaTile * kTStride, st>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(rows) * rows;
  const int blocks = static_cast<int>((total + 255) / 256);
  if (dtype == 2)
    gram_finalize<int, long long><<<blocks, 256, 0, st>>>(static_cast<const int*>(part), rows,
                                                          tile, a.nt, npairs, splits, out);
  else
    gram_finalize<float, float><<<blocks, 256, 0, st>>>(static_cast<const float*>(part), rows,
                                                        tile, a.nt, npairs, splits, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
