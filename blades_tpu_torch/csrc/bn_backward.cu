// Per-client BatchNorm backward for Hopper: the two passes of the
// hand-written VJP of every BatchStatsNorm in a vmapped client block.
//
// Two wrappers (blades_tpu_torch/ops/bn_backward.py):
//
//   bn_bwd_reduce  replaces artifacts/perf_r4/time_bn_pallas.py
//                  _bn_reduce_kernel (the dscale / dbias pass)
//   bn_bwd_dx      replaces time_bn_pallas.py _bn_dx_kernel (the dx pass)
//
// What they compute is the backward the JAX package's training runs,
// blades_tpu/models/layers.py _bn_apply_bwd, over a logical
// (G clients, N rows, C channels, S spatial) view given by strides, with
// the per-(client, channel) mean, r = rsqrt(var + eps) and scale, (G, C)
// vectors of the compute dtype T (bf16 or f32), also read through strides:
//
//   xhat  = (x - mean) * r                     rounded to T after each op
//   reduce: dbias = sum dy, dscale = sum T(dy * xhat), sdx = sum T(dy * scale)
//           as f32 sums (the caller rounds them to T)
//   dx    = r * ((T(dy * scale) - md) - xhat * mdx)   rounded after each op
//
// with md = T(sdx) / n and mdx = T(dscale) * scale / n computed by the
// caller in T.  Rounding after every operation is what PyTorch's bf16
// elementwise ops do (compute in f32, round), so dx agrees bit for bit with
// the plain PyTorch version fed the same md and mdx; the build's -fmad=false
// keeps every f32 product and sum separate.
//
// Bound on the H100: bytes.  The reduction reads x and dy once; the dx pass
// reads them again and writes dx (at bf16 and G = 50 that is 0.125 + 0.188
// ms for ResNet-10's first stage against 3.35 TB/s).
//
// Design:
//  - Strides, not copies: under torch.func.vmap the activations arrive as
//    (G*B, C, H, W) (unbatched parameters: functorch folds the clients into
//    the convolution's batch) or (B, G*C, H, W) (batched parameters: a
//    grouped convolution), and cuDNN hands bf16 activations over
//    channels-last.  Both kernels take the four element strides of the
//    (G, N, C, S) view and index with them.
//  - Two thread maps, picked by the strides so that a warp's loads are
//    contiguous.  Spatial-inner (S stride 1, the NCHW layouts): one CTA per
//    (client, channel, split), threads over a split's kChunk elements of the
//    pair's N*S, the flat index split into (n, s) by a multiply-high
//    division.  Channel-inner (C stride 1, channels-last): one CTA per
//    (client, 32-channel tile, split), lanes over the tile's channels, the
//    eight warps over a split's kRowsCL (n, s) positions.
//  - Long reductions (32,768 elements at the first stage) spread over
//    several splits, short ones (512 at the last) take one.
//  - Determinism: each thread sums its elements in order; the
//    spatial-inner map reduces a CTA by a fixed shuffle tree and the warps
//    in order, the channel-inner map its eight warps in order; the
//    per-split partials are summed in split order by a second kernel.  No
//    float atomics.
//  - The client axis is the outer axis of the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kChunk = kThreads * 16;  // spatial-inner: elements per CTA
constexpr int kTileC = 32;                  // channel-inner: channels per CTA
constexpr uint32_t kRowsCL = kWarps * 64;   // channel-inner: positions per CTA

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

// mean, r, scale, and for the dx pass mean(dxhat) and dscale * scale / n.
template <typename T>
struct Vecs {
  Vec<T> v[5];
};

struct Geo {
  int C;
  int tiles;     // channel-inner: channel tiles per client
  uint32_t L;    // N * S elements per (client, channel) pair
  FastDiv S;     // divides a flat index into (n, s)
  int splits;
  long long xg, xn, xc, xs;  // strides of x
  long long dg, dn, dc, ds;  // strides of dy
  long long og, on, oc, os;  // strides of dx
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

template <typename T>
__device__ __forceinline__ float vget(const Vec<T>& v, int g, int c) {
  return ld(v.p + g * v.sg + c * v.sc);
}

template <typename T> __device__ __forceinline__ void st(T* p, float v);
template <> __device__ __forceinline__ void st<float>(float* p, float v) { *p = v; }
template <> __device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// ---- spatial-inner map ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy, Geo geo,
                 Vecs<T> vec, float* __restrict__ part) {
  __shared__ float red[3][kWarps];
  const int blk = blockIdx.x;
  const int p = blk / geo.splits;
  const int sp = blk - p * geo.splits;
  const int g = p / geo.C;
  const int c = p - g * geo.C;
  const T* xp = x + g * geo.xg + c * geo.xc;
  const T* dp = dy + g * geo.dg + c * geo.dc;
  const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
              sc = vget(vec.v[2], g, c);
  const uint32_t e0 = (uint32_t)sp * kChunk;
  const uint32_t e1 = min(geo.L, e0 + kChunk);
  float sb = 0.f, ss = 0.f, sd = 0.f;
#pragma unroll 4
  for (uint32_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const uint32_t n = fdiv(e, geo.S);
    const uint32_t s = e - n * geo.S.d;
    terms<T>(ld(xp + n * geo.xn + s * geo.xs), ld(dp + n * geo.dn + s * geo.ds),
             m, rr, sc, sb, ss, sd);
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
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             T* __restrict__ dx, Geo geo, Vecs<T> vec) {
  const int blk = blockIdx.x;
  const int p = blk / geo.splits;
  const int sp = blk - p * geo.splits;
  const int g = p / geo.C;
  const int c = p - g * geo.C;
  const T* xp = x + g * geo.xg + c * geo.xc;
  const T* dp = dy + g * geo.dg + c * geo.dc;
  T* op = dx + g * geo.og + c * geo.oc;
  const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
              sc = vget(vec.v[2], g, c), a = vget(vec.v[3], g, c),
              b = vget(vec.v[4], g, c);
  const uint32_t e0 = (uint32_t)sp * kChunk;
  const uint32_t e1 = min(geo.L, e0 + kChunk);
#pragma unroll 4
  for (uint32_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const uint32_t n = fdiv(e, geo.S);
    const uint32_t s = e - n * geo.S.d;
    st(op + n * geo.on + s * geo.os,
       dx_of<T>(ld(xp + n * geo.xn + s * geo.xs),
                ld(dp + n * geo.dn + s * geo.ds), m, rr, sc, a, b));
  }
}

// ---- channel-inner map ---------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_reduce_cl_kernel(const T* __restrict__ x, const T* __restrict__ dy, Geo geo,
                    Vecs<T> vec, float* __restrict__ part) {
  __shared__ float red[3][kWarps][kTileC];
  const int blk = blockIdx.x;
  const int q = blk / geo.splits;  // (client, tile)
  const int sp = blk - q * geo.splits;
  const int g = q / geo.tiles;
  const int c = (q - g * geo.tiles) * kTileC + (int)threadIdx.x;
  const int w = threadIdx.y;
  const bool live = c < geo.C;
  const int p = g * geo.C + c;
  float sb = 0.f, ss = 0.f, sd = 0.f;
  if (live) {
    const T* xp = x + g * geo.xg + c * geo.xc;
    const T* dp = dy + g * geo.dg + c * geo.dc;
    const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
              sc = vget(vec.v[2], g, c);
    const uint32_t e0 = (uint32_t)sp * kRowsCL;
    const uint32_t e1 = min(geo.L, e0 + kRowsCL);
#pragma unroll 4
    for (uint32_t e = e0 + w; e < e1; e += kWarps) {
      const uint32_t n = fdiv(e, geo.S);
      const uint32_t s = e - n * geo.S.d;
      terms<T>(ld(xp + n * geo.xn + s * geo.xs),
               ld(dp + n * geo.dn + s * geo.ds), m, rr, sc, sb, ss, sd);
    }
  }
  red[0][w][threadIdx.x] = sb;
  red[1][w][threadIdx.x] = ss;
  red[2][w][threadIdx.x] = sd;
  __syncthreads();
  if (w < 3 && live) {
    float a = 0.f;
    for (int i = 0; i < kWarps; ++i) a += red[w][i][threadIdx.x];
    part[((size_t)p * geo.splits + sp) * 3 + w] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_dx_cl_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                T* __restrict__ dx, Geo geo, Vecs<T> vec) {
  const int blk = blockIdx.x;
  const int q = blk / geo.splits;
  const int sp = blk - q * geo.splits;
  const int g = q / geo.tiles;
  const int c = (q - g * geo.tiles) * kTileC + (int)threadIdx.x;
  if (c >= geo.C) return;
  const T* xp = x + g * geo.xg + c * geo.xc;
  const T* dp = dy + g * geo.dg + c * geo.dc;
  T* op = dx + g * geo.og + c * geo.oc;
  const float m = vget(vec.v[0], g, c), rr = vget(vec.v[1], g, c),
              sc = vget(vec.v[2], g, c), a = vget(vec.v[3], g, c),
              b = vget(vec.v[4], g, c);
  const uint32_t e0 = (uint32_t)sp * kRowsCL;
  const uint32_t e1 = min(geo.L, e0 + kRowsCL);
#pragma unroll 4
  for (uint32_t e = e0 + threadIdx.y; e < e1; e += kWarps) {
    const uint32_t n = fdiv(e, geo.S);
    const uint32_t s = e - n * geo.S.d;
    st(op + n * geo.on + s * geo.os,
       dx_of<T>(ld(xp + n * geo.xn + s * geo.xs),
                ld(dp + n * geo.dn + s * geo.ds), m, rr, sc, a, b));
  }
}

// Sum each pair's split partials in split order.
__global__ void bn_reduce_finish(const float* __restrict__ part, int pairs,
                                 int splits, float* __restrict__ dbias,
                                 float* __restrict__ dscale,
                                 float* __restrict__ dxhat) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const float* q = part + (size_t)p * splits * 3;
  for (int i = 0; i < splits; ++i) {
    a0 += q[3 * i];
    a1 += q[3 * i + 1];
    a2 += q[3 * i + 2];
  }
  dbias[p] = a0;
  dscale[p] = a1;
  dxhat[p] = a2;
}

// The channel-inner map serves operands whose channels are contiguous.
bool channel_inner(long long xc, long long dc, const long long* os) {
  return xc == 1 && dc == 1 && (os == nullptr || os[2] == 1);
}

int splits_of(long long L, bool cl) {
  const long long per = cl ? kRowsCL : kChunk;
  return (int)((L + per - 1) / per);
}

Geo make_geo(int N, int C, int S, const long long* xs, const long long* ds,
             const long long* os, bool cl) {
  Geo geo;
  geo.C = C;
  geo.tiles = (C + kTileC - 1) / kTileC;
  geo.L = (uint32_t)((long long)N * S);
  geo.S = make_fastdiv((uint32_t)S);
  geo.splits = splits_of(geo.L, cl);
  geo.xg = xs[0]; geo.xn = xs[1]; geo.xc = xs[2]; geo.xs = xs[3];
  geo.dg = ds[0]; geo.dn = ds[1]; geo.dc = ds[2]; geo.ds = ds[3];
  if (os) {
    geo.og = os[0]; geo.on = os[1]; geo.oc = os[2]; geo.os = os[3];
  } else {
    geo.og = geo.on = geo.oc = geo.os = 0;
  }
  return geo;
}

// The launch grid: (client, channel) pairs or (client, tile)s, times splits.
long long grid_of(const Geo& geo, int G, bool cl) {
  return (long long)G * (cl ? geo.tiles : geo.C) * geo.splits;
}

bool bad_shape(int G, int N, int C, int S) {
  if (G < 1 || N < 1 || C < 1 || S < 1) return true;
  const long long L = (long long)N * S;
  return L >= (1ll << 31) || (long long)G * C * splits_of(L, false) >= (1ll << 31);
}

template <typename T>
Vecs<T> make_vecs(const void* const* ptrs, const long long* strides, int k) {
  Vecs<T> vec = {};
  for (int i = 0; i < k; ++i)
    vec.v[i] = Vec<T>{(const T*)ptrs[i], strides[2 * i], strides[2 * i + 1]};
  return vec;
}

template <typename T>
cudaError_t launch_reduce(const void* x, const void* dy, const Geo& geo, int G,
                          bool cl, const void* const* vptr,
                          const long long* vstr, float* part,
                          cudaStream_t st) {
  const unsigned grid = (unsigned)grid_of(geo, G, cl);
  const Vecs<T> vec = make_vecs<T>(vptr, vstr, 3);
  if (cl)
    bn_reduce_cl_kernel<T><<<grid, dim3(kTileC, kWarps), 0, st>>>(
        (const T*)x, (const T*)dy, geo, vec, part);
  else
    bn_reduce_kernel<T><<<grid, kThreads, 0, st>>>((const T*)x, (const T*)dy,
                                                   geo, vec, part);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* x, const void* dy, void* dx, const Geo& geo,
                      int G, bool cl, const void* const* vptr,
                      const long long* vstr, cudaStream_t st) {
  const unsigned grid = (unsigned)grid_of(geo, G, cl);
  const Vecs<T> vec = make_vecs<T>(vptr, vstr, 5);
  if (cl)
    bn_dx_cl_kernel<T><<<grid, dim3(kTileC, kWarps), 0, st>>>(
        (const T*)x, (const T*)dy, (T*)dx, geo, vec);
  else
    bn_dx_kernel<T><<<grid, kThreads, 0, st>>>((const T*)x, (const T*)dy,
                                               (T*)dx, geo, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Splits of one (client, channel) pair's N * S elements under the map the
// strides pick (xc, dc: the channel strides of x and dy): the partials
// buffer of bt_bn_reduce holds G * C * splits * 3 floats.
int bt_bn_splits(long long L, long long xc, long long dc) {
  return splits_of(L, channel_inner(xc, dc, nullptr));
}

// dtype 0 = f32, 1 = bf16.  Strides are element strides of the logical
// (G, N, C, S) views.  vptr: mean, r, scale, (G, C) vectors of the dtype;
// vstr: their (client, channel) strides, two each.  Writes dbias, dscale
// and the dxhat sum, each (G, C) f32.
int bt_bn_reduce(const void* x, const void* dy, int dtype, int G, int N, int C,
                 int S, const long long* xstr, const long long* dstr,
                 const void* const* vptr, const long long* vstr, float* part,
                 float* dbias, float* dscale, float* dxhat, void* stream) {
  if (bad_shape(G, N, C, S) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool cl = channel_inner(xstr[2], dstr[2], nullptr);
  const Geo geo = make_geo(N, C, S, xstr, dstr, nullptr, cl);
  const cudaError_t e =
      dtype == 1 ? launch_reduce<__nv_bfloat16>(x, dy, geo, G, cl, vptr, vstr,
                                                part, st)
                 : launch_reduce<float>(x, dy, geo, G, cl, vptr, vstr, part, st);
  if (e != cudaSuccess) return (int)e;
  const int pairs = G * C;
  bn_reduce_finish<<<(pairs + 255) / 256, 256, 0, st>>>(part, pairs, geo.splits,
                                                        dbias, dscale, dxhat);
  return (int)cudaGetLastError();
}

// vptr / vstr: mean, r, scale, mean(dxhat) and dscale * scale / n, (G, C)
// vectors of the dtype, and their strides.  Writes dx through its own
// strides.
int bt_bn_dx(const void* x, const void* dy, void* dx, int dtype, int G, int N,
             int C, int S, const long long* xstr, const long long* dstr,
             const long long* ostr, const void* const* vptr,
             const long long* vstr, void* stream) {
  if (bad_shape(G, N, C, S) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool cl = channel_inner(xstr[2], dstr[2], ostr);
  const Geo geo = make_geo(N, C, S, xstr, dstr, ostr, cl);
  const cudaError_t e =
      dtype == 1 ? launch_dx<__nv_bfloat16>(x, dy, dx, geo, G, cl, vptr, vstr, st)
                 : launch_dx<float>(x, dy, dx, geo, G, cl, vptr, vstr, st);
  return (int)e;
}

}  // extern "C"
