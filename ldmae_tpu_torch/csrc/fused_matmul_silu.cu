// SwiGLU first stage for Hopper (sm_90a): x @ w12^T + b12, then silu(x1) * x2.
//
// Replaces the Pallas TPU kernel fused_matmul_silu (_kernel_matmul_silu in
// ldmae_tpu/ops/fused_adaln.py): (M, D) @ (D, 2H) + bias with fp32
// accumulation, silu(x1) * x2 in fp32, one rounding to bf16; the (M, 2H)
// pre-activation never reaches device memory.
//
// What bounds it: at the sampling shape (M = 73,728, D = 768, 2H = 4,096) it
// does 2 M D 2H flops against (M D + 2H D + M H) * 2 bytes, far above the
// card's ridge, so the tensor cores bound it. Design: a tiled bf16 GEMM on
// mma.sync m16n8k16 (fp32 accumulators in registers). Each 128 x 64 output
// tile needs the same 64 columns of both halves of w12 (rows j and H + j of
// the (2H, D) weight), so a block multiplies its A tile against a 128-row B
// tile holding both, and the gate runs in the epilogue on two accumulators
// of the same output element. Tiles of 64 along D are double-buffered with
// cp.async in dynamic shared memory (74 KB a block), so the next tile loads
// while this one is multiplied. At 126 registers a thread two blocks fit on
// an SM; a three-stage ring took 130 registers and left one block per SM,
// and 32-deep tiles synchronise twice as often; both ran slower on the H100.
// No wgmma or TMA yet.
//
// Shape gate as in the TPU kernel (checked by the wrapper): M % 128 == 0,
// D % 128 == 0, 2H % 256 == 0.
#include "common.cuh"

namespace {

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 64;        // output columns (of H) per block
constexpr int kBK = 64;        // depth per shared-memory stage
constexpr int kStages = 2;     // cp.async ring depth (double buffering)
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N, 32 x 32 each
constexpr int kLd = kBK + 8;   // smem row stride in bf16 (144 bytes)
constexpr int kStageElems = (kBM + 2 * kBN) * kLd;  // A tile, then both B halves
constexpr int kSmemBytes = kStages * kStageElems * 2;

__global__ void __launch_bounds__(kThreads)
    matmul_silu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ out, int d, int h) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // per stage: A rows [0, 128), then B rows
                                               // [128, 192) = x1 half, [192, 256) = x2 half

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp % 4, warp_n = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int nk = d / kBK;

  auto load_stage = [&](int kt) {
    bf16* st = ring + (kt % kStages) * kStageElems;
    const int k0 = kt * kBK;
    for (int i = tid; i < (kBM + 2 * kBN) * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bf16* src = r < kBM ? x + (size_t)(m0 + r) * d
                      : r < kBM + kBN ? w + (size_t)(n0 + r - kBM) * d
                                      : w + (size_t)(h + n0 + r - kBM - kBN) * d;
      cp_async16(st + r * kLd + c, src + k0 + c);
    }
  };

  float acc[2][2][4][4];  // [half][m tile of 16][n block of 8][fragment]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c][0] = acc[a][b][c][1] = acc[a][b][c][2] = acc[a][b][c][3] = 0.f;

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {  // one commit group per stage, even if empty
    if (kt < nk) load_stage(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (for this thread's copies)
    __syncthreads();               // ... and for everyone's; stage kt-1 is free again
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
    cp_async_commit();
    const bf16* a_s = ring + (kt % kStages) * kStageElems;
    const bf16* b_s = a_s + kBM * kLd;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                smem_addr(a_s + (warp_m * 32 + mt * 16 + (lane & 15)) * kLd + ks * 16 +
                          (lane >> 4) * 8));
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(b0, b1, b2, b3,
                  smem_addr(b_s +
                            (half * kBN + warp_n * 32 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                kLd +
                            ks * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc[half][mt][2 * p], af[mt], b0, b1);
            mma_bf16_16816(acc[half][mt][2 * p + 1], af[mt], b2, b3);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = n0 + warp_n * 32 + nb * 8 + 2 * t;
      const float b1x = bias[col], b1y = bias[col + 1];
      const float b2x = bias[h + col], b2y = bias[h + col + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + warp_m * 32 + mt * 16 + g + hr * 8;
        const float x1a = acc[0][mt][nb][2 * hr] + b1x, x1b = acc[0][mt][nb][2 * hr + 1] + b1y;
        const float x2a = acc[1][mt][nb][2 * hr] + b2x, x2b = acc[1][mt][nb][2 * hr + 1] + b2y;
        const float ya = x1a * (1.f / (1.f + __expf(-x1a))) * x2a;
        const float yb = x1b * (1.f / (1.f + __expf(-x1b))) * x2b;
        *reinterpret_cast<uint32_t*>(out + (size_t)row * h + col) = pack_bf16(ya, yb);
      }
    }
  }
}

}  // namespace

// x: contiguous (m, d) bf16; w12: contiguous (2h, d) bf16 (nn.Linear layout,
// rows [0, h) give x1 and [h, 2h) give x2); b12: (2h,) fp32; out: (m, h)
// bf16. Requires m % 128 == 0, d % 64 == 0, h % 64 == 0. Returns the CUDA
// error of the launch (0 on success).
extern "C" int ldmae_fused_matmul_silu(const void* x, const void* w12, const float* b12, void* out,
                                       int m, int d, int h, void* stream) {
  if (m % kBM != 0 || d % kBK != 0 || h % kBN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Dynamic shared memory above 48 KB needs an opt-in, which CUDA keeps per
  // device: set it at every launch (cheap) so any card the caller picks has it.
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_silu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(h / kBN, m / kBM);
  matmul_silu_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w12), b12, static_cast<bf16*>(out),
      d, h);
  return static_cast<int>(cudaGetLastError());
}
