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

}  // namespace rows
