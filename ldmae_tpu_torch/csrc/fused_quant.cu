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
// fp32 input (the configs' other compute dtype) runs the same kernels with
// the element type a template parameter (their arithmetic is fp32 already);
// the norm kernel then reads the weight, shift and scale from L1 for each
// row instead of holding them in registers.
#include <type_traits>

#include "attention_common.cuh"

namespace {

using attn::to_float;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxElems = 64;    // norm: elements of a row per lane, D <= 64 * 32 = 2048
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

// Four values o / qs, as int8 in one 4-byte word.
__device__ __forceinline__ uint32_t quantize4(const float* o, float qs) {
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = static_cast<int>(rintf(__fdiv_rn(o[j], qs)));
    w |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q))) << (8 * j);
  }
  return w;
}

__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(__fdiv_rn(absmax, 127.f), 1e-8f);
}

// Eight consecutive elements as loaded (16 bytes of bf16, 32 of fp32;
// aligned), each converted to fp32 only where it is used: converting all
// of them up front cost #10 three registers a thread, two fewer blocks an
// SM and 3-4 % of its time (PERF.md).
template <typename T>
struct Vec8 {
  static constexpr int kLoads = sizeof(T) / 2;  // 16-byte loads
  uint4 u[kLoads];
  __device__ __forceinline__ explicit Vec8(const T* p) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) u[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ float operator[](int j) const { return to_float(reinterpret_cast<const T*>(u)[j]); }
};

// kVec: 16-byte vectors of the row per lane (kE elements each: 8 bf16, 4 fp32).
template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    norm_modulate_quant_kernel(const T* __restrict__ x, const float* __restrict__ w,
                               const T* __restrict__ shift, const T* __restrict__ scale,
                               long long shift_stride, long long scale_stride,
                               int8_t* __restrict__ out, float* __restrict__ scales, int rows,
                               int n, int d, int layer, float eps) {
  constexpr int kE = 16 / sizeof(T);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kHeld = kBf16 ? kVec : 1;  // fp32 reads the weight, shift and scale from L1
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kRowsPerWarp;
  const int nvec = d / kE;
  const bool affine = !layer && w != nullptr;
  float wv[kHeld][kE];
  T shv[kHeld][kE], scv[kHeld][kE];
  if (kBf16) {
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int c0 = (lane + i * 32) * kE;
#pragma unroll
      for (int j = 0; j < kE; ++j) wv[i][j] = (affine && c0 < d) ? w[c0 + j] : 1.f;
    }
  }
  int b_loaded = -1;

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= rows) return;
    const int b = row / n;
    const T* sh = shift + b * shift_stride;
    const T* sc = scale + b * scale_stride;
    if (kBf16 && b != b_loaded) {
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        const int c0 = (lane + i * 32) * kE;
        if (c0 >= d) continue;
#pragma unroll
        for (int j = 0; j < kE; ++j) {
          shv[i][j] = sh[c0 + j];
          scv[i][j] = sc[c0 + j];
        }
      }
      b_loaded = b;
    }

    const T* xr = x + (size_t)row * d;
    float xv[kVec][kE];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi < nvec) {
        const uint4 u = *reinterpret_cast<const uint4*>(xr + vi * kE);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < kE; ++j) {
          xv[i][j] = to_float(e[j]);
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
          for (int j = 0; j < kE; ++j) {
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
      for (int j = 0; j < kE; ++j) {
        const int c = (lane + i * 32) * kE + j;
        float y = __fmul_rn(xv[i][j], rs);
        const float wj = kBf16 ? wv[kBf16 ? i : 0][j] : (affine ? w[c] : 1.f);
        if (affine) y = __fmul_rn(y, wj);
        const float scj = to_float(kBf16 ? scv[kBf16 ? i : 0][j] : sc[c]);
        const float shj = to_float(kBf16 ? shv[kBf16 ? i : 0][j] : sh[c]);
        const float onep = __fadd_rn(1.f, scj);
        const float o = __fadd_rn(__fmul_rn(y, onep), shj);
        xv[i][j] = o;
        amax = fmaxf(amax, fabsf(o));
      }
    }
    const float qs = row_scale(warp_max(amax));
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi >= nvec) continue;
      if (kE == 8) *reinterpret_cast<uint2*>(out + (size_t)row * d + vi * kE) = quantize8(xv[i], qs);
      else *reinterpret_cast<uint32_t*>(out + (size_t)row * d + vi * kE) = quantize4(xv[i], qs);
    }
    if (lane == 0) scales[row] = qs;
  }
}

// One block per row of x12 (2H elements); kVec: 8-output vectors per thread.
template <typename T, int kVec>
__global__ void __launch_bounds__(kGateThreads)
    silu_mul_quant_kernel(const T* __restrict__ x12, int8_t* __restrict__ out,
                          float* __restrict__ scales, int h) {
  __shared__ float part[kGateThreads / 32];
  const long long row = blockIdx.x;
  const T* x1 = x12 + row * 2 * h;
  const T* x2 = x1 + h;
  const int nvec = h / 8;
  float o[kVec][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = threadIdx.x + i * kGateThreads;
    if (vi >= nvec) continue;
    const Vec8<T> e1(x1 + vi * 8), e2(x2 + vi * 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = e1[j];
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
      o[i][j] = __fmul_rn(__fmul_rn(a, sig), e2[j]);
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

template <typename T>
cudaError_t norm_quant_launch(const void* x, const float* w, const void* shift, const void* scale,
                              long long shift_stride, long long scale_stride, void* out, float* scales, int b,
                              int n, int d, int layer, float eps, cudaStream_t s) {
  constexpr int kE = 16 / sizeof(T);
  if (d % kE != 0 || d > kMaxElems * 32) return cudaErrorInvalidValue;
  const int rows = b * n;
  const int per_block = kWarps * kRowsPerWarp;
  const dim3 grid((rows + per_block - 1) / per_block);
  const T* xb = static_cast<const T*>(x);
  const T* shb = static_cast<const T*>(shift);
  const T* scb = static_cast<const T*>(scale);
  int8_t* ob = static_cast<int8_t*>(out);
  switch ((d / kE + 31) / 32) {
#define LDMAE_CASE(V)                                                                                  \
  case V:                                                                                              \
    if (V * kE <= kMaxElems)                                                                           \
      norm_modulate_quant_kernel<T, (V * kE <= kMaxElems ? V : 1)><<<grid, kWarps * 32, 0, s>>>(        \
          xb, w, shb, scb, shift_stride, scale_stride, ob, scales, rows, n, d, layer, eps);            \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4) LDMAE_CASE(5) LDMAE_CASE(6)
    LDMAE_CASE(7) LDMAE_CASE(8) LDMAE_CASE(9) LDMAE_CASE(10) LDMAE_CASE(11) LDMAE_CASE(12)
    LDMAE_CASE(13) LDMAE_CASE(14) LDMAE_CASE(15) LDMAE_CASE(16)
#undef LDMAE_CASE
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t gate_launch(const void* x12, void* out, float* scales, long long rows, int h, cudaStream_t s) {
  if (h % 8 != 0 || h > kMaxGateVec * 8 * kGateThreads || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xb = static_cast<const T*>(x12);
  int8_t* ob = static_cast<int8_t*>(out);
  const dim3 grid(static_cast<unsigned>(rows));
  switch ((h / 8 + kGateThreads - 1) / kGateThreads) {
#define LDMAE_CASE(V)                                                                   \
  case V:                                                                               \
    silu_mul_quant_kernel<T, V><<<grid, kGateThreads, 0, s>>>(xb, ob, scales, h);       \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4)
    LDMAE_CASE(5) LDMAE_CASE(6) LDMAE_CASE(7) LDMAE_CASE(8)
#undef LDMAE_CASE
  }
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (b, n, d), bf16 (fp32 != 0: fp32), d a multiple of 8 (fp32:
// 4) and <= 2048; w: (d,) fp32, or null for no weight (always unused when
// layer != 0); shift, scale: (b, d) in x's dtype with unit column stride,
// row i at shift + i * shift_stride (in elements). Writes out: (b, n, d)
// int8 and scales: (b, n) fp32. Returns the CUDA error of the launch (0 on
// success).
extern "C" int ldmae_fused_norm_modulate_quant(const void* x, const float* w, const void* shift,
                                               const void* scale, long long shift_stride,
                                               long long scale_stride, void* out, float* scales,
                                               int b, int n, int d, int layer, float eps, int fp32,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      fp32 ? norm_quant_launch<float>(x, w, shift, scale, shift_stride, scale_stride, out, scales, b, n, d, layer, eps, s)
           : norm_quant_launch<bf16>(x, w, shift, scale, shift_stride, scale_stride, out, scales, b, n, d, layer, eps, s));
}

// x12: contiguous (rows, 2h), bf16 (fp32 != 0: fp32), with h % 8 == 0 and h
// <= 8192, 16-byte aligned. Writes out: (rows, h) int8 and scales: (rows,)
// fp32. Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_silu_mul_quant(const void* x12, void* out, float* scales,
                                          long long rows, int h, int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fp32 ? gate_launch<float>(x12, out, scales, rows, h, s)
                               : gate_launch<bf16>(x12, out, scales, rows, h, s));
}
