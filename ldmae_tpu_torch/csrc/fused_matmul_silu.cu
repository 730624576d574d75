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
// from TMA and are not stored). bf16 and fp32 (the section "fp32" below).
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
// fp32 (the configs' other compute dtype: parallel.compute_dtype float32):
// the same function with fp32 operands, products and output (the TPU
// kernel's astype(x.dtype) of w12 and output are then no-ops); on the CPU
// JAX computes this dot in full fp32.
//
// What bounds it: at the B/1 sampling shape the 2 M D 2H = 1.03e11
// operations take 1.54 ms on the FMA pipes (67 TFLOP/s), where the SIMT GEMM
// this replaces ran at 0.52 of that (2.94 ms, 1.41x torch.addmm's 2.09 ms).
// One TF32 product keeps 10 mantissa bits, far from fp32; three of them
// (3xTF32, tf32.cuh) keep about 22, as the fp32 attention's tensor-core
// kernels do, and take 3 x 1.03e11 / 495e12 = 0.625 ms: the
// tensor cores bound it, and only wgmma reaches their rate. The bytes (x,
// w12 and the (M, H) output once each) take 0.059 ms.
//
// Design: the GEMM engine's fp32 configuration (gemm.cuh, "fp32 operands")
// with #4's paired tiles (64 columns of x1 and of x2: the partial sums
// against the tensor cores' truncation take a second accumulator) and
// clusters of four, as in bf16: a pass splits w12 once a call into its TF32
// hi and lo parts (split_tf32_kernel: 2H D values, 25 MB written at B/1),
// every stage of the ring holds x's tile and both parts of the w12 block,
// and x is split in registers as the register A operand of the three
// products. The epilogue (GateEpiF32) is
// the plain version's: the fp32 bias, then silu(x1) x2 = x1 x2 / (1 +
// e^-x1) with expf and a true division, fp32 out. Shape gate as above.

using GateConfigF32 = gemm::Config<float, 128, 4, 5>;

// out (m, h) fp32 = silu(x1) x2 from the accumulator's fragment, as GateEpi
// in fp32: 8-byte stores of two columns.
struct GateEpiF32 {
  static constexpr bool kPaired = true;
  using Out = float;
  const float* bias;
  float* out;

  template <class Cfg>
  __device__ __forceinline__ void store(const float (&acc)[Cfg::kAcc], const gemm::Tile& tl) const {
    const int row = tl.m0 + tl.warp * 16 + tl.g, h = tl.n;
#pragma unroll
    for (int jb = 0; jb < Cfg::kBN / 16; ++jb) {
      const int col = tl.n0 + jb * 8 + 2 * tl.t;
      const float2 b1 = __ldg(reinterpret_cast<const float2*>(bias + col));
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + h + col));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float x1a = acc[4 * jb + 2 * hr] + b1.x, x1b = acc[4 * jb + 2 * hr + 1] + b1.y;
        const float x2a = acc[Cfg::kAcc / 2 + 4 * jb + 2 * hr] + b2.x;
        const float x2b = acc[Cfg::kAcc / 2 + 4 * jb + 2 * hr + 1] + b2.y;
        const float ya = __fdiv_rn(x1a, __fadd_rn(1.f, expf(-x1a))) * x2a;
        const float yb = __fdiv_rn(x1b, __fadd_rn(1.f, expf(-x1b))) * x2b;
        if (row + 8 * hr < tl.m) *reinterpret_cast<float2*>(out + (size_t)(row + 8 * hr) * h + col) = make_float2(ya, yb);
      }
    }
  }
};

// w (count fp32 values) into its TF32 parts: hi at hi[i], lo at hi[count + i].
__global__ void __launch_bounds__(256)
    split_tf32_kernel(const float* __restrict__ w, float* __restrict__ hi, long long count) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < count; i += (long long)gridDim.x * 256) {
    uint32_t h, l;
    split_tf32(w[i], h, l);
    hi[i] = __uint_as_float(h);
    hi[count + i] = __uint_as_float(l);
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
// and contiguous, x 16-byte aligned; w_split (4h, d) fp32 scratch that
// receives w12's hi and lo parts. Requires m % 128 == 0, d % 32 == 0, h %
// 128 == 0 (the wrapper's gate: d % 128). Returns the CUDA error of the
// first failed launch (0 on success).
extern "C" int ldmae_fused_matmul_silu_f32(const float* x, const float* w12, const float* b12, float* out,
                                           float* w_split, int m, int d, int h, void* stream) {
  if (m % 128 != 0 || d % GateConfigF32::kBK != 0 || h % (GateConfigF32::kBN / 2) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long count = 2LL * h * d;
  const long long blocks = (count + 255) / 256;
  split_tf32_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0, s>>>(w12, w_split, count);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(gemm::launch<GateConfigF32>(x, w_split, 4 * h, GateEpiF32{b12, out}, m, d, h, s));
}
