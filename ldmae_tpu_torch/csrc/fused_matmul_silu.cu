// SwiGLU first stage for Hopper (sm_90a): x @ w12^T + b12, then silu(x1) * x2.
//
// Replaces the Pallas TPU kernel fused_matmul_silu (_kernel_matmul_silu in
// ldmae_tpu/ops/fused_adaln.py, pallas_call at :199): (M, D) @ (D, 2H) +
// bias with fp32 accumulation, silu(x1) * x2 in fp32, one rounding to bf16;
// the (M, 2H) pre-activation never reaches device memory.
//
// What bounds it: at the sampling shape (M = 16,384, D = 768, 2H = 4,096) it
// does 2 M D 2H = 1.03e11 flops (0.104 ms at 989 TFLOP/s) against
// (M D + 2H D + M H) * 2 bytes (0.031 ms at 3.35 TB/s): the tensor cores
// bound it, and only wgmma reaches their full rate. Feeding them takes loads
// that never stall the products, and each block tile must be wide enough
// that its operands come from L2 few times.
//
// Design: the wgmma GEMM engine of csrc/gemm.cuh in its Wide configuration
// (a persistent, warp-specialised GEMM, two consumer warpgroups in
// ping-pong, clusters of four CTAs, a five-stage ring of 40 KB). A tile is
// 64 rows by 128 columns of H; the unit's w12 block is rows j..j+127 of x1
// and the same rows of x2, from H + j (the engine's paired layout), each CTA
// of a cluster loading one quarter and multicasting it, so the four read it
// from L2 once: a CTA loads 16 KB a stage for 2 x 64 x 256 x 64 flops.
// (Without clusters the 64-row tiles ran at the L2's rate, not the tensor
// cores'; clusters of two, 24 KB a stage, left #4 10 % slower than
// torch.addmm, PERF.md.) The accumulator holds x1 and x2 side by side
// (wgmma m64n256k16, 128 fp32 registers a thread), so the thread holding
// column c of x1 holds column c of x2 too (registers i and i + 64) and the
// gate pairs them in registers: bias, silu by __expf and __fdividef, bf16,
// 4-byte stores. With both warpgroups on one 128-row tile, the epilogue,
// which then stalls the tensor cores, took as long as the products: in
// ping-pong one warpgroup's mainloop has the tensor cores while the other's
// epilogue runs.
//
// Shape gate as in the TPU kernel (checked by the wrapper): M % 128 == 0,
// D % 128 == 0, 2H % 256 == 0 (the rows of a unit past M arrive as zeros
// from TMA and are not stored).
#include "gemm.cuh"

namespace {

// The gate epilogue: out (m, h) = bf16(silu(x1) x2), x1 and x2 the fp32
// products plus b12's fp32 bias, stored from the accumulator's fragment.
struct GateEpi {
  static constexpr bool kPaired = true;
  using Out = bf16;
  const float* bias;
  bf16* out;

  template <class Cfg>
  __device__ __forceinline__ void store(const float (&acc)[Cfg::kAcc], const gemm::Tile& tl) const {
    const int row = tl.m0 + tl.warp * 16 + tl.g, h = tl.n;
#pragma unroll
    for (int jb = 0; jb < Cfg::kBN / 16; ++jb) {
      const int col = tl.n0 + jb * 8 + 2 * tl.t;
      // read-only loads (ld.global.nc): the compiler may hoist them above
      // the stores of earlier columns, which it must not do for plain loads
      // from a pointer it cannot prove apart from `out`
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias + col));
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + h + col));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float x1a = acc[4 * jb + 2 * hr] + b1.x, x1b = acc[4 * jb + 2 * hr + 1] + b1.y;
        const float x2a = acc[Cfg::kAcc / 2 + 4 * jb + 2 * hr] + b2.x;
        const float x2b = acc[Cfg::kAcc / 2 + 4 * jb + 2 * hr + 1] + b2.y;
        // silu(x1) x2 = x1 x2 / (1 + e^-x1); 1 + e^-x1 = inf gives 0
        const float ya = __fdividef(x1a, 1.f + __expf(-x1a)) * x2a;
        const float yb = __fdividef(x1b, 1.f + __expf(-x1b)) * x2b;
        if (row + 8 * hr < tl.m) *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8 * hr) * h + col) = pack_bf16(ya, yb);
      }
    }
  }
};

using GateConfig = gemm::Config<bf16, 256, 4, 5>;

// ---------------------------------------------------------------------------
// fp32 (the configs' other compute dtype): the same function with fp32
// operands, products and output, for the configs' float32 compute dtype
// (the TPU kernel's astype(x.dtype) of w12 and output are then no-ops). The
// tensor cores take no fp32 (TF32 keeps 10 mantissa bits, far from the plain
// fp32 product), so this is a plain tiled SIMT GEMM on the FMA pipes (67
// TFLOP/s: 1.5 ms at the B/1 shape), right first: a block of 256 threads
// computes a 64-row tile of x1 and the same columns of x2 (64 + 64 of 2H)
// over depth steps of 16 staged in shared memory (x and both w12 blocks
// transposed, so each thread reads its 4 rows and 4 + 4 columns as float4),
// 4 x 4 outputs of each a thread; the epilogue adds the bias and forms
// silu(x1) x2 = x1 x2 / (1 + e^-x1) in fp32 (expf and a true division, as the
// plain version's sigmoid). Shape gate as above.
constexpr int kSBM = 64, kSBN = 64, kSBK = 16, kSLd = 64 + 4;

__global__ void __launch_bounds__(256)
    matmul_silu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w12,
                           const float* __restrict__ bias, float* __restrict__ out, int m, int d, int h) {
  __shared__ __align__(16) float sa[kSBK][kSLd], sb1[kSBK][kSLd], sb2[kSBK][kSLd];
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc1[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kSBK) {
    // 64 rows x 16 deep of x, and of the x1 and x2 rows of w12, transposed
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + 256 * i, r = idx / kSBK, c = idx % kSBK;
      sa[c][r] = x[(size_t)(m0 + r) * d + k0 + c];
      sb1[c][r] = w12[(size_t)(n0 + r) * d + k0 + c];
      sb2[c][r] = w12[(size_t)(h + n0 + r) * d + k0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[kk][4 * ty]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb1[kk][4 * tx]);
      const float4 b2 = *reinterpret_cast<const float4*>(&sb2[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, b1v[4] = {b1.x, b1.y, b1.z, b1.w},
                  b2v[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(av[i], b1v[j], acc1[i][j]);
          acc2[i][j] = fmaf(av[i], b2v[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      const float x1 = acc1[i][j] + bias[col], x2 = acc2[i][j] + bias[h + col];
      y[j] = __fdiv_rn(x1, __fadd_rn(1.f, expf(-x1))) * x2;
    }
    *reinterpret_cast<float4*>(out + (size_t)(m0 + 4 * ty + i) * h + n0 + 4 * tx) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

}  // namespace

// x: contiguous (m, d) bf16; w12: contiguous (2h, d) bf16 (nn.Linear layout,
// rows [0, h) give x1 and [h, 2h) give x2); b12: (2h,) fp32; out: (m, h)
// bf16; x and w12 16-byte aligned. Requires m % 128 == 0, d % 64 == 0,
// h % 128 == 0. Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_matmul_silu(const void* x, const void* w12, const float* b12, void* out,
                                       int m, int d, int h, void* stream) {
  if (m % 128 != 0 || d % GateConfig::kBK != 0 || h % (GateConfig::kBN / 2) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(gemm::launch<GateConfig>(x, w12, 2 * h, GateEpi{b12, static_cast<bf16*>(out)}, m, d, h,
                                                   static_cast<cudaStream_t>(stream)));
}

// The fp32 function: x (m, d), w12 (2h, d), b12 (2h,), out (m, h), all fp32
// and contiguous; m % 64 == 0, d % 16 == 0, h % 64 == 0 (the wrapper's shape
// gate is stricter). Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_matmul_silu_f32(const float* x, const float* w12, const float* b12, float* out,
                                           int m, int d, int h, void* stream) {
  if (m % kSBM != 0 || d % kSBK != 0 || h % kSBN != 0 || m / kSBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  matmul_silu_f32_kernel<<<dim3(h / kSBN, m / kSBM), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w12, b12, out, m, d, h);
  return static_cast<int>(cudaGetLastError());
}
