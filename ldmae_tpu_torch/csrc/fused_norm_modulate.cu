// Fused adaLN epilogue for Hopper (sm_90a): norm + modulate in one pass.
//
// Replaces the Pallas TPU kernel fused_norm_modulate (_kernel in
// ldmae_tpu/ops/fused_adaln.py). Per token row of x (B, N, D), bf16:
//   rms:   y = bf16(x * rsqrt(mean(x^2) + eps)) * bf16(w)
//   layer: y = bf16((x - mu) * rsqrt(mean((x - mu)^2) + eps))
//   out   = y * (1 + bf16(scale[b])) + bf16(shift[b])
// with the reductions in fp32 and every step after the normalisation rounded
// to bf16, as the TPU kernel computes in x's dtype.
//
// What bounds it: a few flops per element against 4 bytes moved per element
// (read x, write out), so device memory bandwidth. One warp owns four rows
// of one batch element in turn and keeps each row in registers (16-byte
// loads, up to 8 vectors per lane: D <= 2048), so x is read once and the
// output written once. shift and scale are read as bf16 straight from the
// adaLN projection's output (a row stride apart), as the TPU kernel casts
// them to x's dtype anyway. The weight and that batch element's shift and
// scale are read once per warp and held in registers as bf16; a first
// version that re-read fp32 copies (12 bytes per element, three times x's
// bytes) from L1 for every row ran at a third of the bandwidth bound.
// fp32 x (the configs' other compute dtype) runs the same kernel with the
// element type a template parameter: the roundings to x's dtype vanish, the
// weight, shift and scale are fp32, and they are read from L1 for each row
// rather than held in registers (a row of up to 2,048 fp32 values already
// takes 64 registers a lane).
#include <type_traits>

#include "attention_common.cuh"

namespace {

using attn::from_float;
using attn::round_to;
using attn::to_float;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxElems = 64;  // elements of a row per lane: D <= 64 * 32 = 2048

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kVec: 16-byte vectors of the row per lane (kE elements each: 8 bf16, 4 fp32).
template <typename T, int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    norm_modulate_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         const T* __restrict__ shift, const T* __restrict__ scale,
                         long long shift_stride, long long scale_stride, T* __restrict__ out,
                         int rows, int n, int d, int layer, float eps) {
  constexpr int kE = 16 / sizeof(T);
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kRowsPerWarp;
  const int nvec = d / kE;
  // bf16: bf16(w), bf16(1 + scale[b]) and shift[b] for this lane's columns,
  // kept as bf16 (half the registers)
  bf16 wv[kBf16 ? kVec : 1][kE], onep[kBf16 ? kVec : 1][kE], shv[kBf16 ? kVec : 1][kE];
  int b_loaded = -1;

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= rows) return;
    const int b = row / n;
    const T* sh = shift + b * shift_stride;
    const T* sc = scale + b * scale_stride;
    if (kBf16 && b != b_loaded) {
#pragma unroll
      for (int i = 0; i < (kBf16 ? kVec : 1); ++i) {
        const int c0 = (lane + i * 32) * kE;
        if (c0 >= d) continue;
#pragma unroll
        for (int j = 0; j < kE; ++j) {
          wv[i][j] = __float2bfloat16_rn(layer ? 1.f : w[c0 + j]);
          onep[i][j] = __float2bfloat16_rn(1.f + to_float(sc[c0 + j]));
          shv[i][j] = __float2bfloat16_rn(to_float(sh[c0 + j]));
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
    const float mean = warp_sum(sum) / (float)d;
    float rs;
    if (layer) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (lane + i * 32 < nvec) {
#pragma unroll
          for (int j = 0; j < kE; ++j) {
            xv[i][j] -= mean;
            sq += xv[i][j] * xv[i][j];
          }
        }
      }
      rs = rsqrtf(warp_sum(sq) / (float)d + eps);
    } else {
      rs = rsqrtf(mean + eps);
    }

#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi >= nvec) continue;
      alignas(16) T y[kE];
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int c = vi * kE + j;
        float v = round_to<T>(xv[i][j] * rs);
        if (kBf16) {
          if (!layer) v = round_bf16(v * __bfloat162float(wv[i][j]));
          y[j] = __float2bfloat16_rn(round_bf16(v * __bfloat162float(onep[i][j])) +
                                     __bfloat162float(shv[i][j]));
        } else {
          if (!layer) v = __fmul_rn(v, w[c]);
          y[j] = from_float<T>(__fadd_rn(__fmul_rn(v, __fadd_rn(1.f, to_float(sc[c]))), to_float(sh[c])));
        }
      }
      *reinterpret_cast<uint4*>(out + (size_t)row * d + vi * kE) = *reinterpret_cast<const uint4*>(y);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const void* shift, const void* scale, long long shift_stride,
                   long long scale_stride, void* out, int b, int n, int d, int layer, float eps,
                   cudaStream_t s) {
  constexpr int kE = 16 / sizeof(T);
  if (d % kE != 0 || d > kMaxElems * 32) return cudaErrorInvalidValue;
  const int rows = b * n;
  const int per_block = kWarps * kRowsPerWarp;
  const dim3 grid((rows + per_block - 1) / per_block);
  const T* xb = static_cast<const T*>(x);
  T* ob = static_cast<T*>(out);
  const T* shb = static_cast<const T*>(shift);
  const T* scb = static_cast<const T*>(scale);
  switch ((d / kE + 31) / 32) {
#define LDMAE_CASE(V)                                                                             \
  case V:                                                                                         \
    if (V * kE <= kMaxElems)                                                                      \
      norm_modulate_kernel<T, (V * kE <= kMaxElems ? V : 1)><<<grid, kWarps * 32, 0, s>>>(         \
          xb, w, shb, scb, shift_stride, scale_stride, ob, rows, n, d, layer, eps);               \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4) LDMAE_CASE(5) LDMAE_CASE(6)
    LDMAE_CASE(7) LDMAE_CASE(8) LDMAE_CASE(9) LDMAE_CASE(10) LDMAE_CASE(11) LDMAE_CASE(12)
    LDMAE_CASE(13) LDMAE_CASE(14) LDMAE_CASE(15) LDMAE_CASE(16)
#undef LDMAE_CASE
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous (b, n, d), bf16 (fp32 != 0: fp32), with d a multiple of
// 8 (fp32: 4) and d <= 2048; w: (d,) fp32 (unused, may be null, when layer
// != 0); shift, scale: (b, d) in x's dtype with unit column stride, row i at
// shift + i * shift_stride (in elements). Returns the CUDA error of the
// launch (0 on success).
extern "C" int ldmae_fused_norm_modulate(const void* x, const float* w, const void* shift,
                                         const void* scale, long long shift_stride,
                                         long long scale_stride, void* out, int b, int n, int d,
                                         int layer, float eps, int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      fp32 ? launch<float>(x, w, shift, scale, shift_stride, scale_stride, out, b, n, d, layer, eps, s)
           : launch<bf16>(x, w, shift, scale, shift_stride, scale_stride, out, b, n, d, layer, eps, s);
  return static_cast<int>(e);
}
