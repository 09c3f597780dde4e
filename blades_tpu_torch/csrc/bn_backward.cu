// Per-client BatchNorm backward for Hopper: the two passes of the
// hand-written VJP of every BatchStatsNorm in a vmapped client block.
//
// Replaces the two Pallas bodies of artifacts/perf_r4/time_bn_pallas.py:
//
//   reduce kernels  <- _bn_reduce_kernel (the dscale / dbias pass)
//   dx kernels      <- _bn_dx_kernel (the dx pass)
//
// Wrappers (blades_tpu_torch/ops/bn_backward.py): bn_bwd_reduce and
// bn_bwd_dx launch one kernel each; bn_bwd, the whole backward of one BN
// layer, launches both from one host call (bt_bn_bwd).
//
// What they compute is the backward the JAX package's training runs,
// blades_tpu/models/layers.py _bn_apply_bwd, over a logical
// (G clients, N rows, C channels, S spatial) view given by strides, with
// the per-(client, channel) mean, r = rsqrt(var + eps) and scale, (G, C)
// vectors of the compute dtype T (bf16 or f32), also read through strides:
//
//   xhat  = (x - mean) * r                     rounded to T after each op
//   reduce: dbias = sum dy, dscale = sum T(dy * xhat), sdx = sum T(dy * scale)
//           as f32 sums, then in the same launch
//           dscale_T = T(dscale), dbias_T = T(dbias),
//           md  = T(T(sdx) * inv_n), mdx = T(T(dscale_T * scale) * inv_n)
//   dx    = r * ((T(dy * scale) - md) - xhat * mdx)   rounded after each op
//
// inv_n is the f32 reciprocal 1.0f / n: on the card PyTorch divides a
// tensor by a Python scalar as a multiply by that reciprocal (ATen's
// div_true_kernel_cuda), and the coefficients must equal what the plain
// PyTorch ops compute there.  Rounding after every operation is what
// PyTorch's bf16 elementwise ops do (compute in f32, round), so dx agrees
// bit for bit with the plain version fed the same md and mdx; the build's
// -fmad=false keeps every f32 product and sum separate.
//
// Bound on the H100: bytes.  The reduction reads x and dy once, the dx
// pass reads them again and writes dx: at bf16, G = 50, B = 32 over
// ResNet-10's four stage layers 0.235 ms and 0.352 ms at 3.35 TB/s.
//
// The first version (channels-last map: one channel per lane, 32-channel
// tiles, 512-position splits, a separate finish kernel, the coefficients
// formed by ~5 PyTorch launches) took 3.4-4.2x those bounds.  What held it
// back, and what this version does about each:
//  - 2-byte loads (64 B per warp per load, 16 B in flight per thread):
//    the vector map loads 16 B per thread, 8 bf16 (or 4 f32) channels of
//    one position, and unrolls by 4, so a thread has 8 loads of x and dy
//    (128 B) in flight.  A position's C channels are C/8 consecutive lanes;
//    at C = 64 a warp reads 4 whole 128-B position rows per instruction,
//    where 32-channel tiles split each row between two CTAs.
//  - A multiply-high divide and 64-bit stride multiplies per element: in
//    both channels-last layouts of a client block the n stride is S times
//    the s stride, so (n, s) is one flat position with one stride; the
//    vector map walks it with a pointer step.  It applies only then.
//  - Fixed 512-position splits (at C = 512, 4x4 a grid of 800 CTAs whose
//    warps each walked 64 positions in series): the split count is a pure
//    function of the shape (ops/_cuda.py bn_plan), picked so the grid is
//    about 1000 CTAs, four waves at two resident CTAs per SM.
//  - A second kernel summing split partials, then ~5 elementwise launches
//    for dscale / dbias and the coefficients: the last CTA of each (client,
//    channel group) takes a ticket (__threadfence + atomicAdd on a counter
//    that it resets to 0), sums the group's partials in split order with
//    coherent loads (__ldcg) -- the same result whichever CTA arrives last
//    -- and writes the f32 sums, dscale_T, dbias_T, md and mdx.
//  - bf16 rounding: pairs of values round in one cvt (bf16x2), back to f32
//    by a shift.
//  - Reduction across threads: lanes that hold the same channels sum by a
//    fixed __shfl_xor tree, the eight warps in order through shared memory.
//    No float atomics, so results are deterministic.
//
// Three thread maps, picked on the host from strides, dtype and alignment
// (bn_plan) and checked again here:
//  - vector (channel stride 1, C a multiple of the vector width, flat
//    positions, 16-B aligned pointers and strides): the main path's bf16
//    channels-last activations.  One CTA per (client, group of tc channel
//    vectors, split), tc a power of two <= 32; lanes tc apart share
//    channels.
//  - scalar channel-inner (channel stride 1 otherwise: ragged C, offset
//    views, non-flat strides): one CTA per (client, 32-channel tile,
//    split), lanes over channels, warps over positions.
//  - spatial-inner (the NCHW layouts, e.g. the f32 dense trial): one CTA
//    per (client, channel, split), threads over the split's elements.
//  The scalar maps index (n, s) through a multiply-high division.
//
// The ticket counters are one buffer per device, held by the wrapper; the
// port launches on one stream.  Concurrent launches on two streams would
// need a buffer each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileC = 32;  // scalar channel-inner map: channels per CTA
constexpr int kUnroll = 4;  // vector map: positions in flight per thread

enum Map { kSpatial = 0, kScalar = 1, kVector = 2 };

// n / d for n < 2^31 by a multiply-high (Granlund-Montgomery).
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, (uint32_t)m, s};
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& f) {
  return (uint32_t)(((uint64_t)__umulhi(n, f.m) + n) >> f.s);
}

// A (G, C) per-(client, channel) vector of T, read through its strides
// (an unbatched scale arrives with a zero client stride).
template <typename T>
struct Vec {
  const T* p;
  long long sg, sc;
};

// mean, r, scale, and for the dx pass md and mdx.
template <typename T>
struct Vecs {
  Vec<T> v[5];
};

// The launch plan bn_plan picks: the map, the vector width (elements of
// 16 B), tc (vector map: lanes per position), channel groups per client,
// splits per group and positions (elements, spatial map) per split.
struct Plan {
  int map, vec, tc, groups, splits;
  long long chunk;
};

// Channels per group: the partials' row width.
int width_of(const Plan& pl) {
  return pl.map == kVector ? pl.tc * pl.vec : pl.map == kScalar ? kTileC : 1;
}

struct Geo {
  int G, C;
  uint32_t L;    // N * S positions per (client, channel)
  FastDiv S;     // divides a flat index into (n, s) (scalar maps)
  long long xs[4], ds[4], os[4];  // (g, n, c, s) strides of x, dy, dx
  long long xp, dp, op;           // flat position strides (vector map)
  Plan plan;
  int width;
};

// Where the finish writes.  sums: dbias, dscale and sdx, each (G, C) f32.
// The T outputs are null for the bare reduction: dscale_T and dbias_T
// (G, C), coef (2, G, C): md, mdx.
template <typename T>
struct Fin {
  float* sums[3];
  T* dscale;
  T* dbias;
  T* coef;
  unsigned* counter;
  float inv_n;
};

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round an f32 result to the compute dtype (and back to f32).
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The same for a pair: one bf16x2 conversion, back by shifts.
template <typename T> __device__ __forceinline__ void rnd2(float& a, float& b);
template <> __device__ __forceinline__ void rnd2<float>(float&, float&) {}
template <> __device__ __forceinline__ void rnd2<__nv_bfloat16>(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

template <typename T>
__device__ __forceinline__ float vget(const Vec<T>& v, int g, int c) {
  return ld(v.p + g * v.sg + c * v.sc);
}

template <typename T> __device__ __forceinline__ void st(T* p, float v);
template <> __device__ __forceinline__ void st<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T as f32 values, and back (rounded to T).
template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One element's three reduction terms.
template <typename T>
__device__ __forceinline__ void terms(float xv, float dv, float m, float rr,
                                      float sc, float& sb, float& ss,
                                      float& sd) {
  const float xh = rnd<T>(rnd<T>(xv - m) * rr);
  sb += dv;
  ss += rnd<T>(dv * xh);
  sd += rnd<T>(dv * sc);
}

// One element's dx.
template <typename T>
__device__ __forceinline__ float dx_of(float xv, float dv, float m, float rr,
                                       float sc, float a, float b) {
  const float xh = rnd<T>(rnd<T>(xv - m) * rr);
  const float dxh = rnd<T>(dv * sc);
  return rr * rnd<T>(rnd<T>(dxh - a) - rnd<T>(xh * b));
}

// ---- the finish, taken by the last CTA of each group ---------------------

// Every CTA of group grp calls this after writing its partials (wrote:
// this thread wrote one, so it fences); true in the CTA that arrived last,
// which has reset the group's counter to 0.
__device__ __forceinline__ bool last_of_group(unsigned* counter, int grp,
                                              int splits, int tid,
                                              bool wrote) {
  __shared__ bool last;
  if (splits == 1) {
    __syncthreads();
    return true;
  }
  if (wrote) __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned t = atomicAdd(counter + grp, 1u);
    last = t == (unsigned)(splits - 1);
    if (last) counter[grp] = 0;
  }
  __syncthreads();
  return last;
}

// The group's partials part[((grp * splits + sp) * 3 + k) * width + j],
// summed in split order, and what the finish writes from them.
template <typename T>
__device__ void finish_group(const float* part, int grp, int g, int c0,
                             const Geo& geo, const Vec<T>& scale,
                             const Fin<T>& fin, int tid) {
  const int width = geo.width, splits = geo.plan.splits;
  for (int j = tid; j < width; j += kThreads) {
    const int c = c0 + j;
    if (c >= geo.C) break;
    const float* q = part + (size_t)grp * splits * 3 * width + j;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int i = 0; i < splits; ++i, q += 3 * width) {
      a0 += __ldcg(q);
      a1 += __ldcg(q + width);
      a2 += __ldcg(q + 2 * width);
    }
    const size_t p = (size_t)g * geo.C + c;
    fin.sums[0][p] = a0;
    fin.sums[1][p] = a1;
    fin.sums[2][p] = a2;
    if (fin.coef != nullptr) {
      const float dscale = rnd<T>(a1);
      st(fin.dbias + p, a0);
      st(fin.dscale + p, dscale);
      st(fin.coef + p, rnd<T>(a2) * fin.inv_n);
      st(fin.coef + (size_t)geo.G * geo.C + p,
         rnd<T>(dscale * vget(scale, g, c)) * fin.inv_n);
    }
  }
}

// ---- spatial-inner map ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy, Geo geo,
                 Vecs<T> vec, float* __restrict__ part, Fin<T> fin) {
  __shared__ float red[3][kWarps];
  const int blk = blockIdx.x;
  const int splits = geo.plan.splits;
  const int p = blk / splits;  // (client, channel): the group
  const int sp = blk - p * splits;
  const int g = p / geo.C;
  const int c = p - g * geo.C;
  const T* xp = x + g * geo.xs[0] + c * geo.xs[2];
  const T* dp = dy + g * geo.ds[0] + c * geo.ds[2];
  const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
              sc = vget(vec.v[2], g, c);
  const uint32_t e0 = (uint32_t)(sp * geo.plan.chunk);
  const uint32_t e1 = min(geo.L, (uint32_t)(e0 + geo.plan.chunk));
  float sb = 0.f, ss = 0.f, sd = 0.f;
#pragma unroll 4
  for (uint32_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const uint32_t n = fdiv(e, geo.S);
    const uint32_t s = e - n * geo.S.d;
    terms<T>(ld(xp + n * geo.xs[1] + s * geo.xs[3]),
             ld(dp + n * geo.ds[1] + s * geo.ds[3]), m, rr, sc, sb, ss, sd);
  }
  sb = warp_sum(sb);
  ss = warp_sum(ss);
  sd = warp_sum(sd);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][w] = sb;
    red[1][w] = ss;
    red[2][w] = sd;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float a = 0.f;
    for (int i = 0; i < kWarps; ++i) a += red[threadIdx.x][i];
    part[(size_t)blk * 3 + threadIdx.x] = a;
  }
  if (last_of_group(fin.counter, p, splits, threadIdx.x, threadIdx.x < 3))
    finish_group(part, p, g, c, geo, vec.v[2], fin, threadIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             T* __restrict__ dx, Geo geo, Vecs<T> vec) {
  const int blk = blockIdx.x;
  const int splits = geo.plan.splits;
  const int p = blk / splits;
  const int sp = blk - p * splits;
  const int g = p / geo.C;
  const int c = p - g * geo.C;
  const T* xp = x + g * geo.xs[0] + c * geo.xs[2];
  const T* dp = dy + g * geo.ds[0] + c * geo.ds[2];
  T* op = dx + g * geo.os[0] + c * geo.os[2];
  const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
              sc = vget(vec.v[2], g, c), a = vget(vec.v[3], g, c),
              b = vget(vec.v[4], g, c);
  const uint32_t e0 = (uint32_t)(sp * geo.plan.chunk);
  const uint32_t e1 = min(geo.L, (uint32_t)(e0 + geo.plan.chunk));
#pragma unroll 4
  for (uint32_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const uint32_t n = fdiv(e, geo.S);
    const uint32_t s = e - n * geo.S.d;
    st(op + n * geo.os[1] + s * geo.os[3],
       dx_of<T>(ld(xp + n * geo.xs[1] + s * geo.xs[3]),
                ld(dp + n * geo.ds[1] + s * geo.ds[3]), m, rr, sc, a, b));
  }
}

// ---- scalar channel-inner map ----------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_reduce_cl_kernel(const T* __restrict__ x, const T* __restrict__ dy, Geo geo,
                    Vecs<T> vec, float* __restrict__ part, Fin<T> fin) {
  __shared__ float red[3][kWarps][kTileC];
  const int blk = blockIdx.x;
  const int splits = geo.plan.splits;
  const int q = blk / splits;  // (client, tile): the group
  const int sp = blk - q * splits;
  const int g = q / geo.plan.groups;
  const int c0 = (q - g * geo.plan.groups) * kTileC;
  const int c = c0 + (int)threadIdx.x;
  const int w = threadIdx.y;
  const int tid = w * kTileC + threadIdx.x;
  float sb = 0.f, ss = 0.f, sd = 0.f;
  if (c < geo.C) {
    const T* xp = x + g * geo.xs[0] + c * geo.xs[2];
    const T* dp = dy + g * geo.ds[0] + c * geo.ds[2];
    const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
                sc = vget(vec.v[2], g, c);
    const uint32_t e0 = (uint32_t)(sp * geo.plan.chunk);
    const uint32_t e1 = min(geo.L, (uint32_t)(e0 + geo.plan.chunk));
#pragma unroll 4
    for (uint32_t e = e0 + w; e < e1; e += kWarps) {
      const uint32_t n = fdiv(e, geo.S);
      const uint32_t s = e - n * geo.S.d;
      terms<T>(ld(xp + n * geo.xs[1] + s * geo.xs[3]),
               ld(dp + n * geo.ds[1] + s * geo.ds[3]), m, rr, sc, sb, ss, sd);
    }
  }
  red[0][w][threadIdx.x] = sb;
  red[1][w][threadIdx.x] = ss;
  red[2][w][threadIdx.x] = sd;
  __syncthreads();
  if (w < 3) {
    float a = 0.f;
    for (int i = 0; i < kWarps; ++i) a += red[w][i][threadIdx.x];
    part[(((size_t)q * splits + sp) * 3 + w) * kTileC + threadIdx.x] = a;
  }
  if (last_of_group(fin.counter, q, splits, tid, w < 3))
    finish_group(part, q, g, c0, geo, vec.v[2], fin, tid);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_dx_cl_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ dx, Geo geo, Vecs<T> vec) {
  const int blk = blockIdx.x;
  const int splits = geo.plan.splits;
  const int q = blk / splits;
  const int sp = blk - q * splits;
  const int g = q / geo.plan.groups;
  const int c = (q - g * geo.plan.groups) * kTileC + (int)threadIdx.x;
  if (c >= geo.C) return;
  const T* xp = x + g * geo.xs[0] + c * geo.xs[2];
  const T* dp = dy + g * geo.ds[0] + c * geo.ds[2];
  T* op = dx + g * geo.os[0] + c * geo.os[2];
  const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
              sc = vget(vec.v[2], g, c), a = vget(vec.v[3], g, c),
              b = vget(vec.v[4], g, c);
  const uint32_t e0 = (uint32_t)(sp * geo.plan.chunk);
  const uint32_t e1 = min(geo.L, (uint32_t)(e0 + geo.plan.chunk));
#pragma unroll 4
  for (uint32_t e = e0 + threadIdx.y; e < e1; e += kWarps) {
    const uint32_t n = fdiv(e, geo.S);
    const uint32_t s = e - n * geo.S.d;
    st(op + n * geo.os[1] + s * geo.os[3],
       dx_of<T>(ld(xp + n * geo.xs[1] + s * geo.xs[3]),
                ld(dp + n * geo.ds[1] + s * geo.ds[3]), m, rr, sc, a, b));
  }
}

// ---- vector channel-inner map ----------------------------------------------

// The thread's place in the vector map: its client, channel group, first
// channel, first position, the split's end, and the position step of the
// CTA (kWarps * 32 / tc positions).
struct VecSlot {
  int grp, sp, g, cg, c0, p0, pend, step;
  bool live;
};

template <int V>
__device__ __forceinline__ VecSlot vec_slot(const Geo& geo) {
  const Plan& pl = geo.plan;
  VecSlot v;
  const int blk = blockIdx.x;
  v.grp = blk / pl.splits;
  v.sp = blk - v.grp * pl.splits;
  v.g = v.grp / pl.groups;
  v.cg = v.grp - v.g * pl.groups;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = lane & (pl.tc - 1);  // channel vector within the group
  v.c0 = (v.cg * pl.tc + j) * V;
  v.live = v.c0 < geo.C;
  const int ppw = 32 / pl.tc;  // positions per warp
  v.step = kWarps * ppw;
  const long long first = (long long)v.sp * pl.chunk;
  v.p0 = (int)(first + w * ppw + lane / pl.tc);
  v.pend = (int)min((long long)geo.L, first + pl.chunk);
  return v;
}

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_reduce_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     Geo geo, Vecs<T> vec, float* __restrict__ part,
                     Fin<T> fin) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kWarps][3][kThreads];
  const VecSlot v = vec_slot<V>(geo);
  const int tc = geo.plan.tc;
  float sb[V], ss[V], sd[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sb[e] = ss[e] = sd[e] = 0.f;
  if (v.live) {
    float m[V], rr[V], sc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      m[e] = vget(vec.v[0], v.g, v.c0 + e);
      rr[e] = vget(vec.v[1], v.g, v.c0 + e);
      sc[e] = vget(vec.v[2], v.g, v.c0 + e);
    }
    const long long xstep = v.step * geo.xp, dstep = v.step * geo.dp;
    const T* xq = x + v.g * geo.xs[0] + v.c0 + v.p0 * geo.xp;
    const T* dq = dy + v.g * geo.ds[0] + v.c0 + v.p0 * geo.dp;
    for (int p = v.p0; p < v.pend; p += kUnroll * v.step,
             xq += kUnroll * xstep, dq += kUnroll * dstep) {
      uint4 xa[kUnroll], da[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * v.step < v.pend) {
          xa[u] = ld16(xq + u * xstep);
          da[u] = ld16(dq + u * dstep);
        } else {
          xa[u] = da[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * v.step >= v.pend) break;
        float xf[V], df[V];
        unpack<T>(xa[u], xf);
        unpack<T>(da[u], df);
#pragma unroll
        for (int e = 0; e < V; e += 2) {
          float a0 = xf[e] - m[e], a1 = xf[e + 1] - m[e + 1];
          rnd2<T>(a0, a1);
          a0 = a0 * rr[e];
          a1 = a1 * rr[e + 1];
          rnd2<T>(a0, a1);  // xhat
          float p0 = df[e] * a0, p1 = df[e + 1] * a1;
          rnd2<T>(p0, p1);
          float q0 = df[e] * sc[e], q1 = df[e + 1] * sc[e + 1];
          rnd2<T>(q0, q1);
          sb[e] += df[e];
          sb[e + 1] += df[e + 1];
          ss[e] += p0;
          ss[e + 1] += p1;
          sd[e] += q0;
          sd[e + 1] += q1;
        }
      }
    }
  }
  // Lanes tc apart hold the same channels: a fixed xor tree, then the
  // warps in order.
  for (int o = 16; o >= tc; o >>= 1) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sb[e] += __shfl_xor_sync(0xffffffffu, sb[e], o);
      ss[e] += __shfl_xor_sync(0xffffffffu, ss[e], o);
      sd[e] += __shfl_xor_sync(0xffffffffu, sd[e], o);
    }
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane < tc) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[w][0][lane * V + e] = sb[e];
      red[w][1][lane * V + e] = ss[e];
      red[w][2][lane * V + e] = sd[e];
    }
  }
  __syncthreads();
  const int width = geo.width, t = threadIdx.x;
  if (t < width) {
    float* out = part + ((size_t)v.grp * geo.plan.splits + v.sp) * 3 * width + t;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float a = 0.f;
      for (int i = 0; i < kWarps; ++i) a += red[i][k][t];
      out[k * width] = a;
    }
  }
  if (last_of_group(fin.counter, v.grp, geo.plan.splits, t, t < width))
    finish_group(part, v.grp, v.g, v.cg * width, geo, vec.v[2], fin, t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_dx_vec_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 T* __restrict__ dx, Geo geo, Vecs<T> vec) {
  constexpr int V = 16 / sizeof(T);
  const VecSlot v = vec_slot<V>(geo);
  if (!v.live) return;
  float m[V], rr[V], sc[V], a[V], b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    m[e] = vget(vec.v[0], v.g, v.c0 + e);
    rr[e] = vget(vec.v[1], v.g, v.c0 + e);
    sc[e] = vget(vec.v[2], v.g, v.c0 + e);
    a[e] = vget(vec.v[3], v.g, v.c0 + e);
    b[e] = vget(vec.v[4], v.g, v.c0 + e);
  }
  const long long xstep = v.step * geo.xp, dstep = v.step * geo.dp,
                  ostep = v.step * geo.op;
  const T* xq = x + v.g * geo.xs[0] + v.c0 + v.p0 * geo.xp;
  const T* dq = dy + v.g * geo.ds[0] + v.c0 + v.p0 * geo.dp;
  T* oq = dx + v.g * geo.os[0] + v.c0 + v.p0 * geo.op;
  for (int p = v.p0; p < v.pend; p += kUnroll * v.step,
           xq += kUnroll * xstep, dq += kUnroll * dstep,
           oq += kUnroll * ostep) {
    uint4 xa[kUnroll], da[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * v.step < v.pend) {
        xa[u] = ld16(xq + u * xstep);
        da[u] = ld16(dq + u * dstep);
      } else {
        xa[u] = da[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p + u * v.step >= v.pend) break;
      float xf[V], df[V], o[V];
      unpack<T>(xa[u], xf);
      unpack<T>(da[u], df);
#pragma unroll
      for (int e = 0; e < V; e += 2) {
        float x0 = xf[e] - m[e], x1 = xf[e + 1] - m[e + 1];
        rnd2<T>(x0, x1);
        x0 = x0 * rr[e];
        x1 = x1 * rr[e + 1];
        rnd2<T>(x0, x1);  // xhat
        float h0 = df[e] * sc[e], h1 = df[e + 1] * sc[e + 1];
        rnd2<T>(h0, h1);  // dxhat
        h0 = h0 - a[e];
        h1 = h1 - a[e + 1];
        rnd2<T>(h0, h1);
        x0 = x0 * b[e];
        x1 = x1 * b[e + 1];
        rnd2<T>(x0, x1);
        h0 = h0 - x0;
        h1 = h1 - x1;
        rnd2<T>(h0, h1);
        o[e] = rr[e] * h0;  // rounded to T by pack
        o[e + 1] = rr[e + 1] * h1;
      }
      *reinterpret_cast<uint4*>(oq + u * ostep) = pack<T>(o);
    }
  }
}

// ---- host side ---------------------------------------------------------------

// The packed integer arguments of the entry points (element strides of
// the logical (G, N, C, S) views; plans as bn_plan returns them).
enum Arg {
  kDtype = 0, kG, kN, kC, kS,
  kXs = 5, kDs = 9, kOs = 13,  // four strides each
  kVs = 17,                    // mean, r, scale, md, mdx: (g, c) strides
  kRedPlan = 27, kDxPlan = 33,  // map, vec, tc, groups, splits, chunk
  kArgs = 39
};

// The pointer arguments.
enum Ptr {
  pX = 0, pDy, pDx, pMean, pR, pScale, pMd, pMdx,
  pPart, pCounter, pSums, pDscale = pSums + 3, pDbias, pCoef, kPtrs
};

Plan plan_at(const long long* a, int at) {
  return Plan{(int)a[at], (int)a[at + 1], (int)a[at + 2], (int)a[at + 3],
              (int)a[at + 4], a[at + 5]};
}

bool flat(const long long* s, long long N, long long S) {
  return N == 1 || S == 1 || s[1] == S * s[3];
}

long long pos_stride(const long long* s, long long S) {
  return S > 1 ? s[3] : s[1];
}

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The plan against the operands it will be launched on: every map's grid
// must cover the shape; the vector map also needs its layout.  A plan
// that fails is refused (cudaErrorInvalidValue), never run.
bool plan_ok(const Plan& pl, const long long* a, const long long* const* strides,
             const void* const* ptrs, int k, int esize) {
  const long long G = a[kG], N = a[kN], C = a[kC], S = a[kS], L = N * S;
  if (pl.splits < 1 || pl.chunk < 1 || pl.splits * pl.chunk < L ||
      (pl.splits - 1) * pl.chunk >= L || pl.groups < 1)
    return false;
  if (G * pl.groups * pl.splits >= (1ll << 31)) return false;
  if (pl.map == kSpatial) return pl.groups == C;
  for (int i = 0; i < k; ++i)
    if (strides[i][2] != 1 && C > 1) return false;
  if (pl.map == kScalar) return pl.groups == (C + kTileC - 1) / kTileC;
  if (pl.map != kVector || pl.vec * esize != 16 || C % pl.vec != 0) return false;
  if (pl.tc < 1 || pl.tc > 32 || (pl.tc & (pl.tc - 1)) != 0) return false;
  if ((long long)pl.groups * pl.tc * pl.vec < C ||
      (long long)(pl.groups - 1) * pl.tc * pl.vec >= C)
    return false;
  for (int i = 0; i < k; ++i) {
    const long long* s = strides[i];
    if (!aligned(ptrs[i]) || !flat(s, N, S)) return false;
    if ((G > 1 && s[0] % pl.vec) || (L > 1 && pos_stride(s, S) % pl.vec))
      return false;
  }
  return true;
}

Geo make_geo(const long long* a, const Plan& pl) {
  Geo geo;
  geo.G = (int)a[kG];
  geo.C = (int)a[kC];
  const long long N = a[kN], S = a[kS];
  geo.L = (uint32_t)(N * S);
  geo.S = make_fastdiv((uint32_t)S);
  for (int i = 0; i < 4; ++i) {
    geo.xs[i] = a[kXs + i];
    geo.ds[i] = a[kDs + i];
    geo.os[i] = a[kOs + i];
  }
  geo.xp = pos_stride(geo.xs, S);
  geo.dp = pos_stride(geo.ds, S);
  geo.op = pos_stride(geo.os, S);
  geo.plan = pl;
  geo.width = width_of(pl);
  return geo;
}

bool bad_shape(const long long* a) {
  const long long G = a[kG], N = a[kN], C = a[kC], S = a[kS];
  if (a[kDtype] != 0 && a[kDtype] != 1) return true;
  if (G < 1 || N < 1 || C < 1 || S < 1) return true;
  return N * S >= (1ll << 31) || G * C >= (1ll << 31);
}

template <typename T>
Vecs<T> make_vecs(const void* const* p, const long long* a) {
  Vecs<T> vec = {};
  for (int i = 0; i < 5; ++i)
    vec.v[i] = Vec<T>{(const T*)p[pMean + i], a[kVs + 2 * i], a[kVs + 2 * i + 1]};
  return vec;
}

template <typename T>
cudaError_t launch_reduce(const long long* a, const void* const* p,
                          const Plan& pl, bool coefs, cudaStream_t st) {
  const Geo geo = make_geo(a, pl);
  const Vecs<T> vec = make_vecs<T>(p, a);
  Fin<T> fin;
  for (int k = 0; k < 3; ++k) fin.sums[k] = (float*)p[pSums + k];
  fin.dscale = coefs ? (T*)p[pDscale] : nullptr;
  fin.dbias = coefs ? (T*)p[pDbias] : nullptr;
  fin.coef = coefs ? (T*)p[pCoef] : nullptr;
  fin.counter = (unsigned*)p[pCounter];
  fin.inv_n = 1.0f / (float)(a[kN] * a[kS]);
  const unsigned grid = (unsigned)(a[kG] * pl.groups * pl.splits);
  const T* x = (const T*)p[pX];
  const T* dy = (const T*)p[pDy];
  float* part = (float*)p[pPart];
  if (pl.map == kVector)
    bn_reduce_vec_kernel<T><<<grid, kThreads, 0, st>>>(x, dy, geo, vec, part, fin);
  else if (pl.map == kScalar)
    bn_reduce_cl_kernel<T><<<grid, dim3(kTileC, kWarps), 0, st>>>(
        x, dy, geo, vec, part, fin);
  else
    bn_reduce_kernel<T><<<grid, kThreads, 0, st>>>(x, dy, geo, vec, part, fin);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const long long* a, const void* const* p, const Plan& pl,
                      const Vecs<T>& vec, cudaStream_t st) {
  const Geo geo = make_geo(a, pl);
  const unsigned grid = (unsigned)(a[kG] * pl.groups * pl.splits);
  const T* x = (const T*)p[pX];
  const T* dy = (const T*)p[pDy];
  T* dx = (T*)p[pDx];
  if (pl.map == kVector)
    bn_dx_vec_kernel<T><<<grid, kThreads, 0, st>>>(x, dy, dx, geo, vec);
  else if (pl.map == kScalar)
    bn_dx_cl_kernel<T><<<grid, dim3(kTileC, kWarps), 0, st>>>(x, dy, dx, geo, vec);
  else
    bn_dx_kernel<T><<<grid, kThreads, 0, st>>>(x, dy, dx, geo, vec);
  return cudaGetLastError();
}

bool reduce_ok(const long long* a, const void* const* p, const Plan& pl) {
  const long long* s[2] = {a + kXs, a + kDs};
  return plan_ok(pl, a, s, p, 2, a[kDtype] == 1 ? 2 : 4);
}

bool dx_ok(const long long* a, const void* const* p, const Plan& pl) {
  const long long* s[3] = {a + kXs, a + kDs, a + kOs};
  const void* q[3] = {p[pX], p[pDy], p[pDx]};
  return plan_ok(pl, a, s, q, 3, a[kDtype] == 1 ? 2 : 4);
}

template <typename T>
cudaError_t bwd(const long long* a, const void* const* p, cudaStream_t st) {
  const Plan rp = plan_at(a, kRedPlan);
  cudaError_t e = launch_reduce<T>(a, p, rp, true, st);
  if (e != cudaSuccess) return e;
  // The dx pass reads md and mdx where the finish wrote them: (2, G, C).
  Vecs<T> vec = make_vecs<T>(p, a);
  const long long gc = a[kG] * a[kC];
  vec.v[3] = Vec<T>{(const T*)p[pCoef], a[kC], 1};
  vec.v[4] = Vec<T>{(const T*)p[pCoef] + gc, a[kC], 1};
  return launch_dx<T>(a, p, plan_at(a, kDxPlan), vec, st);
}

}  // namespace

extern "C" {

// a: the kArgs packed integers (dtype 0 = f32, 1 = bf16); p: the kPtrs
// pointers (unused ones may be null).  Each returns a cudaError_t.

// The reduction: writes the sums dbias, dscale, sdx, each (G, C) f32; part
// holds G * groups * splits * 3 * width floats, counter G * groups zeros.
int bt_bn_reduce(const long long* a, const void* const* p, void* stream) {
  const Plan pl = plan_at(a, kRedPlan);
  if (bad_shape(a) || !reduce_ok(a, p, pl)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(a[kDtype] == 1
                   ? launch_reduce<__nv_bfloat16>(a, p, pl, false, st)
                   : launch_reduce<float>(a, p, pl, false, st));
}

// The dx pass with md and mdx from p[pMd], p[pMdx] (strides in a[kVs..]).
int bt_bn_dx(const long long* a, const void* const* p, void* stream) {
  const Plan pl = plan_at(a, kDxPlan);
  if (bad_shape(a) || !dx_ok(a, p, pl)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(a[kDtype] == 1
                   ? launch_dx<__nv_bfloat16>(a, p, pl, make_vecs<__nv_bfloat16>(p, a), st)
                   : launch_dx<float>(a, p, pl, make_vecs<float>(p, a), st));
}

// The whole backward of one layer: the reduction with its finish (sums,
// dscale_T, dbias_T, coef (2, G, C) of T), then the dx pass, on one stream.
int bt_bn_bwd(const long long* a, const void* const* p, void* stream) {
  if (bad_shape(a) || !reduce_ok(a, p, plan_at(a, kRedPlan)) ||
      !dx_ok(a, p, plan_at(a, kDxPlan)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(a[kDtype] == 1 ? bwd<__nv_bfloat16>(a, p, st)
                              : bwd<float>(a, p, st));
}

}  // extern "C"
