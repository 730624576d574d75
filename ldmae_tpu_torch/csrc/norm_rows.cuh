// The streaming row engine of the two adaLN kernels, #3 fused_norm_modulate
// (csrc/fused_norm_modulate.cu) and #9 fused_norm_modulate_quant
// (csrc/fused_quant.cu), for Hopper (sm_90a).
//
// Both compute, per token row of x (B, N, D), a norm over the row (rms or
// layer) with fp32 sums, then an elementwise epilogue that reads the RMSNorm
// weight w (D,) and the row's batch element's shift[b] and scale[b]; they
// differ only in that epilogue (the struct `Epi`: #3 rounds to x's dtype and
// writes x's dtype, #9 stays in fp32 and writes per-row int8 and a scale).
//
// What bounds them: a handful of operations per element against 3-4 bytes
// moved (x read once, the output written once), so device memory bandwidth.
// What the design does about it:
//  * a persistent grid: as many blocks as fit on the SMs at once (from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor), each taking one
//    contiguous range of rows (the ranges differ by at most one row), so no
//    ragged last wave and each block meets few batch elements;
//  * the parameters once per batch element a block meets: its threads stage
//    w, 1 + scale[b] and shift[b] (16-byte loads, converted once to the
//    form the epilogue uses) in shared memory, and every row reads them from
//    there (16-byte shared loads), never from global memory;
//  * rows stream ahead of the math, one warp per row: each warp issues the
//    16-byte loads of its next row before it reduces the current one (two
//    rows in flight a warp); a bulk-copy ring of rows in shared memory was
//    slower at every measured shape (PERF.md section 6);
//  * a row lives in registers between the reduction and the epilogue (D <=
//    2048: up to 8 16-byte vectors a lane in bf16, 16 in fp32), so x is read
//    once; the epilogue writes 16-byte vectors (#9 with fp32 x: 4 bytes a
//    lane).
#pragma once

#include <algorithm>

#include "attention_common.cuh"

namespace rows {

using attn::to_float;

// Four warps a block, two rows in flight a warp: against 2, 8 and 16 warps,
// three or four rows in flight, and registers capped for more blocks an SM,
// the fastest or level for both epilogues on the H100 (PERF.md section 6).
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 2048;

// One launch's operands. x: contiguous (B, N, D) of Epi::T; w: (D,) fp32 or
// null (a weight of ones); shift, scale: rows of Epi::T with unit column
// stride, row b at shift + b * shift_stride; out and scales as the epilogue
// writes them.
struct Args {
  const void* x;
  const float* w;
  const void* shift;
  const void* scale;
  long long shift_stride, scale_stride;
  void* out;
  float* scales;
  long long rows;
  int n, d, layer;
  float eps;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int j) {
  return to_float(reinterpret_cast<const T*>(&u)[j]);
}

// Stages the parameters of batch element b in shared memory, all threads of
// the block taking 16-byte chunks (kE elements of x's type): Epi::stage
// turns one chunk of w, scale[b] and shift[b] (as fp32) into its form.
template <class Epi>
__device__ __forceinline__ void stage_params(typename Epi::P* par, const Args& a, long long b, bool vec) {
  using T = typename Epi::T;
  constexpr int kE = 16 / sizeof(T);
  const T* sh = static_cast<const T*>(a.shift) + b * a.shift_stride;
  const T* sc = static_cast<const T*>(a.scale) + b * a.scale_stride;
  const float* w = a.layer ? nullptr : a.w;  // LayerNorm takes no weight
  for (int c = threadIdx.x * kE; c < a.d; c += kThreads * kE) {
    float wv[kE], shv[kE], scv[kE];
    if (vec) {
      const uint4 us = *reinterpret_cast<const uint4*>(sh + c);
      const uint4 uc = *reinterpret_cast<const uint4*>(sc + c);
#pragma unroll
      for (int j = 0; j < kE; ++j) shv[j] = elem<T>(us, j), scv[j] = elem<T>(uc, j);
      if (w != nullptr) {
#pragma unroll
        for (int q = 0; q < kE / 4; ++q) {
          const float4 f = *reinterpret_cast<const float4*>(w + c + 4 * q);
          wv[4 * q] = f.x, wv[4 * q + 1] = f.y, wv[4 * q + 2] = f.z, wv[4 * q + 3] = f.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        shv[j] = to_float(sh[c + j]), scv[j] = to_float(sc[c + j]);
        if (w != nullptr) wv[j] = w[c + j];
      }
    }
    if (w == nullptr) {
#pragma unroll
      for (int j = 0; j < kE; ++j) wv[j] = 1.f;
    }
    Epi::stage(par, a.d, c, wv, scv, shv);
  }
}

// One row, its kVec 16-byte vectors a lane in u (lane l holds vectors l,
// l + 32, ...): the fp32 norm, then the epilogue.
template <class Epi, int kVec>
__device__ __forceinline__ void finish_row(const uint4 (&u)[kVec], long long row, const typename Epi::P* par,
                                           const Args& a, int lane) {
  using T = typename Epi::T;
  constexpr int kE = 16 / sizeof(T);
  const int nvec = a.d / kE;
  float v[kVec][kE];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      v[i][j] = elem<T>(u[i], j);
      if (lane + i * 32 < nvec) sum += a.layer ? v[i][j] : v[i][j] * v[i][j];
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)a.d);
  float var = mean;
  if (a.layer) {
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        v[i][j] = __fsub_rn(v[i][j], mean);
        if (lane + i * 32 < nvec) sq += v[i][j] * v[i][j];
      }
    }
    var = __fdiv_rn(warp_sum(sq), (float)a.d);
  }
  const float rs = Epi::kExactRsqrt ? 1.f / sqrtf(var + a.eps) : rsqrtf(var + a.eps);
  Epi::template finish<kVec>(v, rs, par, a, row, lane, nvec);
}

template <typename T, int kVec>
__device__ __forceinline__ void load_row(uint4 (&u)[kVec], const T* src, int lane, int nvec) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = lane + i * 32;
    u[i] = vi < nvec ? reinterpret_cast<const uint4*>(src)[vi] : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <class Epi, int kVec>
__global__ void __launch_bounds__(kThreads) norm_rows_kernel(const Args a) {
  using T = typename Epi::T;
  using P = typename Epi::P;
  constexpr int kE = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  P* par = reinterpret_cast<P*>(smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nvec = a.d / kE;
  const T* x = static_cast<const T*>(a.x);
  const long long r0 = a.rows * blockIdx.x / gridDim.x, r1 = a.rows * (blockIdx.x + 1) / gridDim.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(a.shift) | reinterpret_cast<uintptr_t>(a.scale) |
                     reinterpret_cast<uintptr_t>(a.w)) % 16 == 0) &&
                   (a.shift_stride * sizeof(T)) % 16 == 0 && (a.scale_stride * sizeof(T)) % 16 == 0;

  // warp w takes rows s0 + w, s0 + w + kWarps, ... of each run of rows of
  // one batch element, loading the next before finishing one
  for (long long s0 = r0; s0 < r1;) {
    const long long s1 = min(r1, (s0 / a.n + 1) * a.n);
    long long r = s0 + warp;
    uint4 buf[2][kVec];
    if (r < s1) load_row<T, kVec>(buf[0], x + r * a.d, lane, nvec);
    __syncthreads();  // every warp is done with the previous parameters
    stage_params<Epi>(par, a, s0 / a.n, vec);
    __syncthreads();
    for (; r < s1; r += 2 * kWarps) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long long rk = r + k * kWarps, next = rk + kWarps;
        if (rk >= s1) break;
        if (next < s1) load_row<T, kVec>(buf[k ^ 1], x + next * a.d, lane, nvec);
        finish_row<Epi, kVec>(buf[k], rk, par, a, lane);
      }
    }
    s0 = s1;
  }
}

template <class Epi, int kVec>
cudaError_t launch_vec(const Args& a, cudaStream_t s) {
  auto kernel = norm_rows_kernel<Epi, kVec>;
  // shared memory of one block: the parameters, three arrays of D
  const size_t smem = (3 * (size_t)a.d * sizeof(typename Epi::P) + 127) / 128 * 128;
  // blocks that fit on the card at once, for this device and shared memory
  // (cached: the query costs host time on every launch otherwise)
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_blocks = sms * per_sm, cached_smem = smem, cached_dev = dev;
  }
  const long long grid = std::min<long long>(cached_blocks, (a.rows + kWarps - 1) / kWarps);
  kernel<<<(unsigned)grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Launches the engine for Epi on a's rows: kVec, the 16-byte vectors of a
// row a lane holds, is chosen from D.
template <class Epi>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int kE = 16 / sizeof(typename Epi::T);
  if (a.d <= 0 || a.d % kE != 0 || a.d > kMaxD || a.n <= 0 || a.rows < 0) return cudaErrorInvalidValue;
  if (a.rows == 0) return cudaSuccess;
  switch ((a.d / kE + 31) / 32) {
#define LDMAE_CASE(V)                                                                   \
  case V:                                                                               \
    if constexpr (V * kE * 32 <= kMaxD) return launch_vec<Epi, V>(a, s);                \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4) LDMAE_CASE(5) LDMAE_CASE(6)
    LDMAE_CASE(7) LDMAE_CASE(8) LDMAE_CASE(9) LDMAE_CASE(10) LDMAE_CASE(11) LDMAE_CASE(12)
    LDMAE_CASE(13) LDMAE_CASE(14) LDMAE_CASE(15) LDMAE_CASE(16)
#undef LDMAE_CASE
  }
  return cudaErrorInvalidValue;
}

// -- #3's backward ----------------------------------------------------------
//
// The gradients of #3 for an output gradient g (B, N, D) of x's type, all in
// fp32, exactly the JAX package's custom VJP (_fnm_custom_vjp):
//   rms:   r = rsqrt(mean(x^2) + eps), u = x r, dxh = g (1 + scale[b]),
//          du = dxh w, dx = r (u (-mean(du u)) + du),
//          dw = sum over (b, n) of dxh u, dscale[b] = sum over n of g u w;
//   layer: xc = x - mean(x), r = rsqrt(mean(xc^2) + eps), xhat = xc r,
//          dx = r ((dxh - mean(dxh)) - xhat mean(dxh xhat)),
//          dscale[b] = sum over n of g xhat (no dw: the norm takes no weight);
//   both:  dshift[b] = sum over n of g.
// What bounds it: x and g read and dx written once, 6 bytes an element in
// bf16, against about 16 fp32 operations an element (25 with the row
// recomputed in each pass), so device memory.
// The design keeps the forward engine's shape:
//  * the same persistent grid and contiguous row ranges, one warp a row,
//    x and g in 16-byte loads, the next row's loads issued before the
//    current row's math, r recomputed from x (the forward saves nothing);
//  * w and 1 + scale[b] staged in fp32 in shared memory once per batch
//    element a block meets;
//  * the row reductions (mean(du u); for layer mean(dxh) and
//    mean(dxh xhat)) by warp shuffles; dx in x's type in 16-byte stores;
//  * the column sums without float atomics: each warp adds its rows'
//    terms to its own fp32 columns in shared memory; at the end of each
//    run of rows of one batch element the block adds its four warps'
//    columns in warp order and writes them, one partial per (block, batch
//    element) it meets, to a workspace; two small kernels add the partials
//    in a fixed order (norm_rows_bwd_sum_kernel dshift and dscale,
//    norm_rows_bwd_dw_kernel dw). Every sum runs in an order fixed by
//    the shape and the grid, so two runs give the same bits.
// The partial of block i for batch element b sits at slot i + b: a block's
// row range starts in the batch element where the previous one ended, so
// the slots of (i, b) pairs grow with i and then b, at most grid + B of them.

// One backward launch's operands. x, g, dx: contiguous (B, N, D) of T; w:
// (D,) fp32 or null; scale: rows of T with unit column stride, row b at
// scale + b * scale_stride; ws: the partials, (grid + B) slots of three
// fp32 rows of D [dw | dshift | dscale].
struct BwdArgs {
  const void* x;
  const void* g;
  const float* w;
  const void* scale;
  long long scale_stride;
  void* dx;
  float* ws;
  long long rows;
  int n, d, layer;
  float eps;
};

// shared memory of one backward block: w and 1 + scale[b], then three
// columns of D a warp
inline size_t bwd_smem(int d) { return (size_t)(2 + 3 * kWarps) * d * sizeof(float); }

template <typename T>
__device__ __forceinline__ uint4 pack_vec(const float* v);

template <>
__device__ __forceinline__ uint4 pack_vec<bf16>(const float* v) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <>
__device__ __forceinline__ uint4 pack_vec<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// Shared fp32 columns are laid out [q][vector] in float4s (q < kE / 4), so
// that the lanes of a warp, which hold consecutive vectors, read and write
// consecutive 16-byte words: no bank conflicts.
__device__ __forceinline__ int col4(int vi, int q, int nvec) { return q * nvec + vi; }

// One row of the backward: x and g as loaded (kVec 16-byte vectors a lane),
// the staged w and 1 + scale[b] (float4 columns), this warp's three fp32
// column sums (float4 columns).
template <typename T, int kVec>
__device__ __forceinline__ void bwd_row(const uint4 (&xu)[kVec], const uint4 (&gu)[kVec], long long row,
                                        const float4* wp, const float4* op, float4* acc, const BwdArgs& a,
                                        bool has_w, int lane) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kQ = kE / 4;
  const int nvec = a.d / kE;
  const float inv_d = 1.f / (float)a.d;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (lane + i * 32 >= nvec) continue;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const float v = elem<T>(xu[i], j);
      sum += a.layer ? v : v * v;
    }
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)a.d);
  float var = mean, mu = 0.f;
  if (a.layer) {
    mu = mean;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lane + i * 32 >= nvec) continue;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const float c = __fsub_rn(elem<T>(xu[i], j), mu);
        sq += c * c;
      }
    }
    var = __fdiv_rn(warp_sum(sq), (float)a.d);
  }
  const float r = rsqrtf(var + a.eps);
  // the row reductions: rms sum(du u); layer sum(dxh) and sum(dxh xhat)
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = lane + i * 32;
    if (vi >= nvec) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 w4 = wp[col4(vi, q, nvec)], o4 = op[col4(vi, q, nvec)];
      const float* wf = &w4.x;
      const float* of = &o4.x;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * q + t;
        const float dxh = elem<T>(gu[i], j) * of[t];
        if (a.layer) {
          const float xhat = (elem<T>(xu[i], j) - mu) * r;
          s1 += dxh;
          s2 += dxh * xhat;
        } else {
          const float u = elem<T>(xu[i], j) * r;
          s1 += dxh * wf[t] * u;
        }
      }
    }
  }
  s1 = warp_sum(s1) * inv_d;
  if (a.layer) s2 = warp_sum(s2) * inv_d;
  T* dx = static_cast<T*>(a.dx) + row * a.d;
  float4* adw = acc;
  float4* ash = acc + a.d / 4;
  float4* asc = acc + a.d / 2;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = lane + i * 32;
    if (vi >= nvec) continue;
    float out[kE];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int c4 = col4(vi, q, nvec);
      const float4 w4 = wp[c4], o4 = op[c4];
      const float* wf = &w4.x;
      const float* of = &o4.x;
      float4 sh = ash[c4], sc = asc[c4], dw4 = has_w ? adw[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
      float* shf = &sh.x;
      float* scf = &sc.x;
      float* dwf = &dw4.x;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * q + t;
        const float g = elem<T>(gu[i], j);
        const float dxh = g * of[t];
        float xhat;
        if (a.layer) {
          xhat = (elem<T>(xu[i], j) - mu) * r;
          out[j] = r * ((dxh - s1) - xhat * s2);
        } else {
          const float u = elem<T>(xu[i], j) * r;
          const float du = dxh * wf[t];
          xhat = u * wf[t];
          out[j] = r * (u * -s1 + du);
          dwf[t] += dxh * u;
        }
        shf[t] += g;
        scf[t] += g * xhat;
      }
      ash[c4] = sh;
      asc[c4] = sc;
      if (has_w) adw[c4] = dw4;
    }
    reinterpret_cast<uint4*>(dx)[vi] = pack_vec<T>(out);
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) norm_rows_bwd_kernel(const BwdArgs a) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kQ = kE / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* wp = reinterpret_cast<float4*>(smem);
  float4* op = wp + a.d / 4;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float4* acc = op + a.d / 4 + warp * (3 * a.d / 4);
  const int nvec = a.d / kE;
  const int d4 = a.d / 4;
  const bool has_w = !a.layer && a.w != nullptr;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  const long long r0 = a.rows * blockIdx.x / gridDim.x, r1 = a.rows * (blockIdx.x + 1) / gridDim.x;
  const bool vec = reinterpret_cast<uintptr_t>(a.scale) % 16 == 0 && (a.scale_stride * sizeof(T)) % 16 == 0;

  for (int c = threadIdx.x; c < kWarps * 3 * d4; c += kThreads)  // every warp's columns from 0
    (op + d4)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long s0 = r0; s0 < r1;) {
    const long long b = s0 / a.n, s1 = min(r1, (b + 1) * a.n);
    long long r = s0 + warp;
    uint4 xb[2][kVec], gb[2][kVec];
    if (r < s1) {
      load_row<T, kVec>(xb[0], x + r * a.d, lane, nvec);
      load_row<T, kVec>(gb[0], g + r * a.d, lane, nvec);
    }
    // stage w and 1 + scale[b] as fp32 float4 columns: vector v's quarter q at q * nvec + v
    const T* sc = static_cast<const T*>(a.scale) + b * a.scale_stride;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      float scv[kE];
      if (vec) {
        const uint4 u = *reinterpret_cast<const uint4*>(sc + v * kE);
#pragma unroll
        for (int j = 0; j < kE; ++j) scv[j] = elem<T>(u, j);
      } else {
#pragma unroll
        for (int j = 0; j < kE; ++j) scv[j] = to_float(sc[v * kE + j]);
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float* wq = a.w + v * kE + 4 * q;
        wp[col4(v, q, nvec)] = has_w ? make_float4(wq[0], wq[1], wq[2], wq[3]) : make_float4(1.f, 1.f, 1.f, 1.f);
        op[col4(v, q, nvec)] = make_float4(__fadd_rn(1.f, scv[4 * q]), __fadd_rn(1.f, scv[4 * q + 1]),
                                               __fadd_rn(1.f, scv[4 * q + 2]), __fadd_rn(1.f, scv[4 * q + 3]));
      }
    }
    __syncthreads();
    for (; r < s1; r += 2 * kWarps) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long long rk = r + k * kWarps, next = rk + kWarps;
        if (rk >= s1) break;
        if (next < s1) {
          load_row<T, kVec>(xb[k ^ 1], x + next * a.d, lane, nvec);
          load_row<T, kVec>(gb[k ^ 1], g + next * a.d, lane, nvec);
        }
        bwd_row<T, kVec>(xb[k], gb[k], rk, wp, op, acc, a, has_w, lane);
      }
    }
    __syncthreads();
    // this (block, b)'s partial: the four warps' columns added in warp
    // order, written in element order to slot blockIdx.x + b; the columns
    // are zeroed for the next batch element
    float* slot = a.ws + (size_t)(blockIdx.x + b) * 3 * a.d;
    const float4* all = op + d4;
    for (int c = threadIdx.x; c < 3 * d4; c += kThreads) {
      const int arr = c / d4, f = c % d4;  // column f: vector f % nvec, quarter f / nvec
      float4 s = all[c];
      float4* w0 = const_cast<float4*>(all) + c;
      *w0 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 1; k < kWarps; ++k) {
        float4* wk = w0 + k * 3 * d4;
        const float4 t = *wk;
        s.x += t.x, s.y += t.y, s.z += t.z, s.w += t.w;
        *wk = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (arr == 0 && !has_w) continue;
      const int e = (f % nvec) * kE + (f / nvec) * 4;
      *reinterpret_cast<float4*>(slot + arr * a.d + e) = s;
    }
    s0 = s1;
  }
  // a block that ends on a batch boundary (not the last block) leaves the
  // slot after its last one to no pair: zeros there, for dw's sum over
  // every slot
  if (has_w && blockIdx.x + 1 < gridDim.x && r1 % a.n == 0) {
    float* gap = a.ws + (size_t)(blockIdx.x + r1 / a.n) * 3 * a.d;
    for (int c = threadIdx.x; c < a.d; c += kThreads) gap[c] = 0.f;
  }
}

// The first and last block of grid whose row range meets batch element b.
__device__ __forceinline__ void blocks_of(long long b, long long n, long long rows, long long grid, long long& lo,
                                          long long& hi) {
  // block i covers [rows i / grid, rows (i + 1) / grid): it meets b's rows
  // [b n, (b + 1) n) when rows (i + 1) / grid > b n and rows i / grid < (b + 1) n
  lo = ((b * n + 1) * grid + rows - 1) / rows - 1;
  hi = ((b + 1) * n * grid + rows - 1) / rows - 1;
  lo = max(lo, 0LL);
  hi = min(hi, grid - 1);
}

struct Kahan {
  float s = 0.f, k = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - k, t = s + y;
    k = (t - s) - y, s = t;
  }
  __device__ __forceinline__ float sum() const { return s - k; }
};

// dshift[b] and dscale[b] from the partials of the blocks that meet b, a
// thread a column, in block order (a compensated sum), written in S (fp32,
// or bf16: one rounding of the fp32 sum).
template <typename S>
__global__ void __launch_bounds__(128)
    norm_rows_bwd_sum_kernel(const float* __restrict__ ws, S* __restrict__ dshift, S* __restrict__ dscale, int n,
                             int d, long long rows, int grid) {
  const int c = blockIdx.x * 128 + threadIdx.x, b = blockIdx.y;
  if (c >= d) return;
  long long lo, hi;
  blocks_of(b, n, rows, grid, lo, hi);
  Kahan s1, s2;
#pragma unroll 4
  for (long long i = lo; i <= hi; ++i) {
    const float* slot = ws + (size_t)(i + b) * 3 * d;
    s1.add(slot[d + c]);
    s2.add(slot[2 * d + c]);
  }
  dshift[(size_t)b * d + c] = attn::from_float<S>(s1.sum());
  dscale[(size_t)b * d + c] = attn::from_float<S>(s2.sum());
}

// dw from the partials of every slot (a slot that no (block, b) pair takes
// holds zeros), the longest sum: thread (c, y) adds, for column c, the slots
// y, y + kDwGroups, ... (a compensated sum), then the block adds the
// kDwGroups sums in y order. fp32.
constexpr int kDwCols = 32, kDwGroups = 32;

__global__ void __launch_bounds__(kDwCols * kDwGroups)
    norm_rows_bwd_dw_kernel(const float* __restrict__ ws, float* __restrict__ dw, int d, int slots) {
  __shared__ float part[kDwGroups][kDwCols];
  const int c = blockIdx.x * kDwCols + threadIdx.x, y = threadIdx.y;
  Kahan s;
  if (c < d) {
#pragma unroll 4
    for (int i = y; i < slots; i += kDwGroups) s.add(ws[(size_t)i * 3 * d + c]);
  }
  part[y][threadIdx.x] = s.sum();
  __syncthreads();
  if (y != 0 || c >= d) return;
  float t = part[0][threadIdx.x];
#pragma unroll
  for (int g = 1; g < kDwGroups; ++g) t += part[g][threadIdx.x];
  dw[c] = t;
}

// Blocks of the backward's grid for a's shape (at least 1), from the
// occupancy of its kernel on this device; 0 with e set on an error.
template <typename T, int kVec>
long long bwd_grid_vec(const BwdArgs& a, cudaError_t& e) {
  auto kernel = norm_rows_bwd_kernel<T, kVec>;
  const size_t smem = bwd_smem(a.d);
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  int dev;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return 0;
    if (smem > 48 * 1024 &&
        (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
      return 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess) return 0;
    if (per_sm < 1) {
      e = cudaErrorInvalidConfiguration;
      return 0;
    }
    cached_blocks = sms * per_sm, cached_smem = smem, cached_dev = dev;
  }
  return std::max<long long>(1, std::min<long long>(cached_blocks, (a.rows + kWarps - 1) / kWarps));
}

// The backward for a's rows: the partials, then their sums into dw (fp32;
// null without a weight), dshift and dscale (bf16 with sums_bf16, else
// fp32). With launch false it only returns the grid (so the caller can size
// ws: (grid + B) * 3 * D floats); ws_slots is the workspace's size in slots.
template <typename T, int kVec>
cudaError_t bwd_vec(const BwdArgs& a, int bsz, long long ws_slots, float* dw, void* dshift, void* dscale,
                    bool sums_bf16, bool launch, long long* grid_out, cudaStream_t s) {
  cudaError_t e = cudaSuccess;
  const long long grid = bwd_grid_vec<T, kVec>(a, e);
  if (e != cudaSuccess) return e;
  *grid_out = grid;
  if (!launch) return cudaSuccess;
  if (grid + bsz > ws_slots) return cudaErrorInvalidValue;
  norm_rows_bwd_kernel<T, kVec><<<(unsigned)grid, kThreads, bwd_smem(a.d), s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 sum_grid((a.d + 127) / 128, bsz);
  if (sums_bf16)
    norm_rows_bwd_sum_kernel<bf16><<<sum_grid, 128, 0, s>>>(a.ws, static_cast<bf16*>(dshift),
                                                            static_cast<bf16*>(dscale), a.n, a.d, a.rows, (int)grid);
  else
    norm_rows_bwd_sum_kernel<float><<<sum_grid, 128, 0, s>>>(a.ws, static_cast<float*>(dshift),
                                                             static_cast<float*>(dscale), a.n, a.d, a.rows, (int)grid);
  if ((e = cudaGetLastError()) != cudaSuccess || a.layer || a.w == nullptr) return e;
  norm_rows_bwd_dw_kernel<<<(a.d + kDwCols - 1) / kDwCols, dim3(kDwCols, kDwGroups), 0, s>>>(
      a.ws, dw, a.d, (int)(grid + bsz - 1));
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const BwdArgs& a, int bsz, long long ws_slots, float* dw, void* dshift, void* dscale, bool sums_bf16,
                bool launch, long long* grid_out, cudaStream_t s) {
  constexpr int kE = 16 / sizeof(T);
  if (a.d <= 0 || a.d % kE != 0 || a.d > kMaxD || a.n <= 0 || bsz <= 0 || a.rows != (long long)bsz * a.n)
    return cudaErrorInvalidValue;
  switch ((a.d / kE + 31) / 32) {
#define LDMAE_CASE(V)                                                                         \
  case V:                                                                                     \
    if constexpr (V * kE * 32 <= kMaxD)                                                       \
      return bwd_vec<T, V>(a, bsz, ws_slots, dw, dshift, dscale, sums_bf16, launch, grid_out, s); \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4) LDMAE_CASE(5) LDMAE_CASE(6)
    LDMAE_CASE(7) LDMAE_CASE(8) LDMAE_CASE(9) LDMAE_CASE(10) LDMAE_CASE(11) LDMAE_CASE(12)
    LDMAE_CASE(13) LDMAE_CASE(14) LDMAE_CASE(15) LDMAE_CASE(16)
#undef LDMAE_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace rows
