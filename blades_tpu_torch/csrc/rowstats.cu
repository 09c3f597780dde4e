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
// Bound on the H100 at the streamed round's shape (1000, 4,903,242) bf16:
// one read of the matrix, 9.81 GB over 3.35 TB/s = 2.9 ms, for every
// bundle but the Gram.  The Gram's operations, counting its symmetric half,
// are n(n+1)/2 * d * 2 = 4.9e12, at 989 TFLOP/s bf16 = 5.0 ms: the Gram
// bundle is bound by operations.
//
// Design:
//  - Row statistics (rowstats_kernel, 512 threads): each CTA walks column
//    slabs of `rowb` bytes per row (16-128, as wide as lets every row of
//    the slab sit in shared memory).  The slab is
//    loaded once with cp.async; a column pass (threads over 16-byte quads,
//    shuffles then warps summed in a fixed order) forms the weighted row sums
//    w^T X_slab -- written out for `wsum`, kept in shared memory as
//    t = g^T X_slab for `gram_dot` -- and a row pass (one thread per row,
//    16 bytes at a time) accumulates sq, the sign counts, X_slab v and
//    X_slab t into per-CTA row partials.  A second kernel reduces the
//    partials in CTA order: deterministic, no float atomics; sign counts
//    and int8 norms are integers throughout.
//  - Gram (gram_mma_kernel for bf16 and int8, gram_f32_kernel for f32): a
//    tiled product over the (i <= j) tiles of the upper triangle, the
//    d-reduction split across CTAs in whole waves.  bf16 uses mma.sync
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
//  - Rows need not be aligned to anything: a 4-byte cp.async serves rows
//    whose length in bytes is a multiple of 4 (every f32 matrix, bf16 with
//    even d, int8 with d % 4 == 0); other widths load element by element.
//    The round's rows (9,806,484 bytes) are 4- but not 16-byte aligned,
//    which also rules out TMA (its row strides are multiples of 16 bytes).
//    wgmma, and 16-byte loads of realigned rows, are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;    // Gram kernels
constexpr int kRsThreads = 512;  // row-statistics kernel
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kInt8Span = 65536;  // int32-exact span: 65536 * 127^2 < 2^31

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

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

bool rows_aligned(const void* x, int dtype, long long d) {
  return (d * elem_size(dtype)) % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
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

}  // namespace

extern "C" {

// Launch geometry of the row statistics for (dtype, rows, d) with R dots
// vectors, W + G weight vectors and KF float partials per row: the slab
// bytes per row (the widest slab that fits: on the H100 at the round's
// shape a wider slab beat narrower ones with more CTAs per SM, and
// double-buffering inside a CTA did not pay), the dynamic shared memory
// and the CTA count.  dtype 0 = f32, 1 = bf16, 2 = int8.  Returns a
// cudaError_t (cudaErrorInvalidValue when the rows do not fit).
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

// The row statistics: the slab kernel, then (when any row statistic is
// asked for) the partial reduction.  Null outputs are not asked for.
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
  if (a.sq_mode || want_signs || R || G) {
    rowstats_finalize<<<(rows + 255) / 256, 256, 0, st>>>(fpart, ipart, grid, rows, KF,
                                                          a.sq_mode, want_signs, R, G, d_true,
                                                          sq_out, signs_out, dots_out, gd_out);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

// Gram geometry for (dtype, rows, d): the tile side, the upper-triangle
// tile count, the d-splits (one wave of CTAs where d allows) and the
// columns per split.
int bt_gram_plan(int dtype, int rows, long long d, int* tile, int* npairs, int* splits,
                 long long* span) {
  int per_sm = 0;
  cudaError_t e;
  if (dtype == 0) {
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
  const int bke = kRowB / elem_size(dtype);
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
  if (dtype == 2) {
    const long long need = (d + kInt8Span - 1) / kInt8Span;
    if (s < need) s = need;
  }
  *span = (nkb + s - 1) / s * bke;
  *splits = static_cast<int>((d + *span - 1) / *span);
  return 0;
}

// The Gram: the tile kernel into `part`, then the split reduction into the
// (rows, rows) f32 output.
int bt_gram(const void* x, int dtype, int rows, long long d, int tile, int npairs, int splits,
            long long span, void* part, float* out, void* stream) {
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
  if (dtype == 0)
    gram_f32_kernel<<<grid, kThreads, kF32Stages * 2 * kF32Tile * kTStride, st>>>(a);
  else if (dtype == 1)
    gram_mma_kernel<uint16_t, float>
        <<<grid, kThreads, kMmaStages * 2 * kMmaTile * kTStride, st>>>(a);
  else
    gram_mma_kernel<int8_t, int><<<grid, kThreads, kMmaStages * 2 * kMmaTile * kTStride, st>>>(a);
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
