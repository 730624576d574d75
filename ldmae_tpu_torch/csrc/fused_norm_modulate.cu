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
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kMaxVec = 8;  // 16-byte vectors per lane: D <= 8 * 8 * 32 = 2048

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kVec: 16-byte vectors of the row per lane (D = kVec * 256 at most).
template <int kVec>
__global__ void __launch_bounds__(kWarps * 32)
    norm_modulate_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                         const bf16* __restrict__ shift, const bf16* __restrict__ scale,
                         long long shift_stride, long long scale_stride, bf16* __restrict__ out,
                         int rows, int n, int d, int layer, float eps) {
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kRowsPerWarp;
  const int nvec = d / 8;
  // bf16(w), bf16(1 + scale[b]) and shift[b] for this lane's columns, kept
  // as bf16 (half the registers)
  bf16 wv[kVec][8], onep[kVec][8], shv[kVec][8];
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
          wv[i][j] = __float2bfloat16_rn(layer ? 1.f : w[c0 + j]);
          onep[i][j] = __float2bfloat16_rn(1.f + __bfloat162float(sc[c0 + j]));
          shv[i][j] = sh[c0 + j];
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
    const float mean = warp_sum(sum) / (float)d;
    float rs;
    if (layer) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (lane + i * 32 < nvec) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
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
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        float y[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = round_bf16(xv[i][j + h] * rs);
          if (!layer) v = round_bf16(v * __bfloat162float(wv[i][j + h]));
          y[h] = round_bf16(v * __bfloat162float(onep[i][j + h])) +
                 __bfloat162float(shv[i][j + h]);
        }
        packed[j / 2] = pack_bf16(y[0], y[1]);
      }
      *reinterpret_cast<uint4*>(out + (size_t)row * d + vi * 8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
}

}  // namespace

// x, out: contiguous (b, n, d) bf16 with d % 8 == 0 and d <= 2048; w: (d,)
// fp32 (unused, may be null, when layer != 0); shift, scale: (b, d) bf16
// with unit column stride, row i at shift + i * shift_stride (in elements).
// Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_norm_modulate(const void* x, const float* w, const void* shift,
                                         const void* scale, long long shift_stride,
                                         long long scale_stride, void* out, int b, int n, int d,
                                         int layer, float eps, void* stream) {
  if (d % 8 != 0 || d > kMaxVec * 8 * 32) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = b * n;
  const int per_block = kWarps * kRowsPerWarp;
  const dim3 grid((rows + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  const bf16* shb = static_cast<const bf16*>(shift);
  const bf16* scb = static_cast<const bf16*>(scale);
  switch ((d / 8 + 31) / 32) {
#define LDMAE_CASE(V)                                                                       \
  case V:                                                                                   \
    norm_modulate_kernel<V><<<grid, kWarps * 32, 0, s>>>(xb, w, shb, scb, shift_stride,     \
                                                         scale_stride, ob, rows, n, d, layer, \
                                                         eps);                               \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4)
    LDMAE_CASE(5) LDMAE_CASE(6) LDMAE_CASE(7) LDMAE_CASE(8)
#undef LDMAE_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
