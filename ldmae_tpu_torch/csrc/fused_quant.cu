// The two quantizing kernels of the w8a8 sampling leg, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of ldmae_tpu/ops/fused_adaln.py:
//   * fused_norm_modulate_quant (_kernel_quant): per token row of x (B, N, D)
//     bf16, entirely in fp32 (nothing is rounded to bf16 on the way)
//       rms:   y = x * (1 / sqrt(mean(x^2) + eps)) * w
//       layer: y = (x - mu) * (1 / sqrt(mean((x - mu)^2) + eps))
//       o     = y * (1 + scale[b]) + shift[b]
//     then per-row int8: qs = max(absmax(o) / 127, 1e-8), q = round(o / qs);
//   * fused_silu_mul_quant (_kernel_silu_mul_quant): o = (x1 * sigmoid(x1)) * x2
//     in fp32 over the packed SwiGLU pre-activation x12 = [x1 | x2] (rows of
//     2H bf16), then the same per-row int8.
// Both write int8 rows and one fp32 scale per row, the operands of the int8
// matmuls that follow (ops/quant.qdense_pre).
//
// Rounding as the TPU kernels (XLA on the CPU) compute it: the divisions are
// true divisions and no elementwise product is fused into a multiply-add
// (the __f*_rn intrinsics), 1/sqrt instead of the approximate rsqrt, expf
// instead of __expf, and q rounds half to even (rintf, as jnp.round). Only
// the fp32 row sums differ: another order, and the compiler may fuse each
// square into its add (keeping them apart cost the norm kernel a fifth of
// its time), which can move q by one step in rare elements.
//
// What bounds them: a handful of flops per element against 3 bytes moved
// (bf16 in, int8 out) for the norm and 5 bytes per output for the gate, so
// device memory bandwidth. The absmax needs the whole row before the first
// int8 value is written, so each row stays in registers between the two
// passes: one warp per row for the norm (as csrc/fused_norm_modulate.cu, the
// weight and that batch element's shift and scale held in registers across
// four rows), one block of 128 threads per row for the gate (2H = 4,096
// values at B/1, 8 KB).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxVec = 8;       // norm: 16-byte vectors per lane, D <= 8 * 8 * 32 = 2048
constexpr int kGateThreads = 128;
constexpr int kMaxGateVec = 8;   // gate: 8-output vectors per thread, H <= 8 * 8 * 128 = 8192

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

// Eight values o / qs rounded half to even, as int8 in one 8-byte word.
__device__ __forceinline__ uint2 quantize8(const float* o, float qs) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = static_cast<int>(rintf(__fdiv_rn(o[j], qs)));
    w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q))) << (8 * (j % 4));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(__fdiv_rn(absmax, 127.f), 1e-8f);
}

// kVec: 16-byte vectors of the row per lane (D = kVec * 256 at most).
template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    norm_modulate_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                               const bf16* __restrict__ shift, const bf16* __restrict__ scale,
                               long long shift_stride, long long scale_stride,
                               int8_t* __restrict__ out, float* __restrict__ scales, int rows,
                               int n, int d, int layer, float eps) {
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kRowsPerWarp;
  const int nvec = d / 8;
  const bool affine = !layer && w != nullptr;
  float wv[kVec][8];
  bf16 shv[kVec][8], scv[kVec][8];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int c0 = (lane + i * 32) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) wv[i][j] = (affine && c0 < d) ? w[c0 + j] : 1.f;
  }
  int b_loaded = -1;

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= rows) return;
    const int b = row / n;
    if (b != b_loaded) {
      const bf16* sh = shift + b * shift_stride;
      const bf16* sc = scale + b * scale_stride;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int c0 = (lane + i * 32) * 8;
        if (c0 >= d) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          shv[i][j] = sh[c0 + j];
          scv[i][j] = sc[c0 + j];
        }
      }
      b_loaded = b;
    }

    const bf16* xr = x + (size_t)row * d;
    float xv[kVec][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + vi * 8);
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xv[i][j] = __bfloat162float(e[j]);
          sum += layer ? xv[i][j] : xv[i][j] * xv[i][j];
        }
      }
    }
    const float mean = __fdiv_rn(warp_sum(sum), (float)d);
    float rs;
    if (layer) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (lane + i * 32 < nvec) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            xv[i][j] = __fsub_rn(xv[i][j], mean);
            sq += xv[i][j] * xv[i][j];
          }
        }
      }
      rs = 1.f / sqrtf(__fdiv_rn(warp_sum(sq), (float)d) + eps);
    } else {
      rs = 1.f / sqrtf(mean + eps);
    }

    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (lane + i * 32 >= nvec) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float y = __fmul_rn(xv[i][j], rs);
        if (affine) y = __fmul_rn(y, wv[i][j]);
        const float onep = __fadd_rn(1.f, __bfloat162float(scv[i][j]));
        const float o = __fadd_rn(__fmul_rn(y, onep), __bfloat162float(shv[i][j]));
        xv[i][j] = o;
        amax = fmaxf(amax, fabsf(o));
      }
    }
    const float qs = row_scale(warp_max(amax));
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) *reinterpret_cast<uint2*>(out + (size_t)row * d + vi * 8) = quantize8(xv[i], qs);
    }
    if (lane == 0) scales[row] = qs;
  }
}

// One block per row of x12 (2H bf16); kVec: 8-output vectors per thread.
template <int kVec>
__global__ void __launch_bounds__(kGateThreads)
    silu_mul_quant_kernel(const bf16* __restrict__ x12, int8_t* __restrict__ out,
                          float* __restrict__ scales, int h) {
  __shared__ float part[kGateThreads / 32];
  const long long row = blockIdx.x;
  const bf16* x1 = x12 + row * 2 * h;
  const bf16* x2 = x1 + h;
  const int nvec = h / 8;
  float o[kVec][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = threadIdx.x + i * kGateThreads;
    if (vi >= nvec) continue;
    const uint4 u1 = *reinterpret_cast<const uint4*>(x1 + vi * 8);
    const uint4 u2 = *reinterpret_cast<const uint4*>(x2 + vi * 8);
    const bf16* e1 = reinterpret_cast<const bf16*>(&u1);
    const bf16* e2 = reinterpret_cast<const bf16*>(&u2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = __bfloat162float(e1[j]);
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
      o[i][j] = __fmul_rn(__fmul_rn(a, sig), __bfloat162float(e2[j]));
      amax = fmaxf(amax, fabsf(o[i][j]));
    }
  }
  amax = warp_max(amax);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kGateThreads / 32; ++i) amax = fmaxf(amax, part[i]);
  const float qs = row_scale(amax);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = threadIdx.x + i * kGateThreads;
    if (vi < nvec) *reinterpret_cast<uint2*>(out + row * h + vi * 8) = quantize8(o[i], qs);
  }
  if (threadIdx.x == 0) scales[row] = qs;
}

}  // namespace

// x: contiguous (b, n, d) bf16 with d % 8 == 0 and d <= 2048; w: (d,) fp32,
// or null for no weight (always unused when layer != 0); shift, scale: (b, d)
// bf16 with unit column stride, row i at shift + i * shift_stride (in
// elements). Writes out: (b, n, d) int8 and scales: (b, n) fp32. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_norm_modulate_quant(const void* x, const float* w, const void* shift,
                                               const void* scale, long long shift_stride,
                                               long long scale_stride, void* out, float* scales,
                                               int b, int n, int d, int layer, float eps,
                                               void* stream) {
  if (d % 8 != 0 || d > kMaxVec * 8 * 32) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = b * n;
  const int per_block = kWarps * kRowsPerWarp;
  const dim3 grid((rows + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* shb = static_cast<const bf16*>(shift);
  const bf16* scb = static_cast<const bf16*>(scale);
  int8_t* ob = static_cast<int8_t*>(out);
  switch ((d / 8 + 31) / 32) {
#define LDMAE_CASE(V)                                                                          \
  case V:                                                                                      \
    norm_modulate_quant_kernel<V><<<grid, kWarps * 32, 0, s>>>(                                \
        xb, w, shb, scb, shift_stride, scale_stride, ob, scales, rows, n, d, layer, eps);      \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4)
    LDMAE_CASE(5) LDMAE_CASE(6) LDMAE_CASE(7) LDMAE_CASE(8)
#undef LDMAE_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

// x12: contiguous (rows, 2h) bf16 with h % 8 == 0 and h <= 8192. Writes out:
// (rows, h) int8 and scales: (rows,) fp32. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ldmae_fused_silu_mul_quant(const void* x12, void* out, float* scales,
                                          long long rows, int h, void* stream) {
  if (h % 8 != 0 || h > kMaxGateVec * 8 * kGateThreads || rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x12);
  int8_t* ob = static_cast<int8_t*>(out);
  const dim3 grid(static_cast<unsigned>(rows));
  switch ((h / 8 + kGateThreads - 1) / kGateThreads) {
#define LDMAE_CASE(V)                                                                   \
  case V:                                                                               \
    silu_mul_quant_kernel<V><<<grid, kGateThreads, 0, s>>>(xb, ob, scales, h);          \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4)
    LDMAE_CASE(5) LDMAE_CASE(6) LDMAE_CASE(7) LDMAE_CASE(8)
#undef LDMAE_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
