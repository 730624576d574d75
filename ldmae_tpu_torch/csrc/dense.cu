// The port's two linear-layer GEMMs for Hopper (sm_90a), on the wgmma/TMA
// engine of csrc/gemm.cuh. Neither replaces a Pallas kernel: each replaces an
// XLA op of the JAX package that cuBLAS cannot compute as JAX does.
//
// dense (ldmae_tpu/ops/linear.py:20, `dense`): out (m, n) bf16 =
// bf16(x (m, k) @ w (n, k)^T in fp32 + bias (n,) fp32), the fp32 bias added
// in fp32 and one rounding. cuBLASLt's bias epilogue takes the bias only in
// the output's dtype, and a bf16 bias rounds it first.
//
// int8_dense (ldmae_tpu/ops/quant.py:97, `qdense_pre`; `qdense` at :71):
// out (m, n) = ((f32(x_q (m, k) @ w_q (n, k)^T) * x_scale[m]) * w_scale[n]) +
// bias[n], each fp32 operation rounded on its own (__fmul_rn and __fadd_rn:
// nvcc would contract a*b+c into one FMA), then one rounding to bf16 (or
// fp32 out). The int32 sum is exact and cvt.rn.f32.s32 rounds it as
// `acc.float()` does, so the output equals the plain PyTorch version
// (torch._int_mm, then the fp32 dequant passes) bit for bit; the int32
// product never reaches device memory. x_q and w_q are both K-major, the
// layout int8 wgmma reads.
//
// Tensor parallelism (ldmae_tpu/parallel/mesh.py, the tp rules: proj and
// w3 sharded on their input dim) adds two more epilogues on the same
// mainloops. A row-parallel layer's partial product goes to an all-reduce
// before the bias and the dequant, as the JAX package's psum does:
//  * dense_f32_out: out (m, n) fp32 = x (m, k) @ w (n, k)^T in fp32, no
//    bias, no rounding (ldmae_tpu/ops/linear.py:21's fp32 sum under the
//    psum); bf16(out + bias) equals ldmae_dense_bias_f32 on the same x, w
//    and bias bit for bit (the same configuration and sums);
//  * int8_dense_i32: out (m, n) int32 = x_q @ w_q^T, the exact sum
//    (ldmae_tpu/ops/quant.py:107's int32 dot under the psum), equal to
//    torch._int_mm.
//
// What bounds them on the path (B/1 under CFG at batch 8): at m = 16,384
// the tensor cores (int8 qkv 0.029 ms at 1,979 TOP/s; bf16 proj 0.020 ms at
// 989 TFLOP/s); at m = 16 (the adaLN linear) the bytes of w (7.1 MB of bf16,
// 3.5 MB of int8); at n = 16 (the final layer) the bytes of x (25 MB). The
// C entries pick the engine's configuration by shape: Narrow (16- or
// 32-column units, no cluster, four stages of 256 elements of depth) when
// m <= 128 or n <= 64, so every SM streams its slice of the operand that
// bounds the call; Wide (64 x 256 tiles in clusters of four, five stages,
// the staged epilogue in place of the two 32 KB output tiles that cost PR
// 6's dense one stage) otherwise.
#include "gemm.cuh"

namespace {

// Wide: #4's tiles. Narrow: 16 (or, for m <= 128 and n >= 4,096, 32)
// columns a unit and stages of 256 elements of depth (four bf16 swizzle
// rows, two int8), no cluster (csrc/gemm.cuh).
template <typename T>
using Wide = gemm::Config<T, 256, 4, 5>;
template <typename T, int BN>
using Narrow = gemm::Config<T, BN, 1, 4, static_cast<int>(2 * sizeof(T))>;

template <typename T, class Epi>
cudaError_t dispatch(const void* x, const void* w, const Epi& epi, int m, int k, int n, cudaStream_t stream) {
  if (m <= 128 && n >= 4096) return gemm::launch<Narrow<T, 32>>(x, w, n, epi, m, k, n, stream);
  if (m <= 128 || n <= 64) return gemm::launch<Narrow<T, 16>>(x, w, n, epi, m, k, n, stream);
  return gemm::launch<Wide<T>>(x, w, n, epi, m, k, n, stream);
}

// bf16(acc + bias[col]) in fp32
struct BiasEpi {
  static constexpr bool kPaired = false;
  using Out = bf16;
  const float* bias;
  bf16* out;
  __device__ __forceinline__ float row(int, int) const { return 0.f; }
  __device__ __forceinline__ float2 col(int c, int n) const {
    return make_float2(c < n ? __ldg(bias + c) : 0.f, 0.f);
  }
  __device__ __forceinline__ float apply(float acc, float, float2 b) const { return acc + b.x; }
};

// ((f32(acc) * x_scale[row]) * w_scale[col]) + bias[col], each rounded
template <typename OutT>
struct DequantEpi {
  static constexpr bool kPaired = false;
  using Out = OutT;
  const float* x_scale;
  const float* w_scale;
  const float* bias;  // or null: no addition
  OutT* out;
  __device__ __forceinline__ float row(int r, int m) const { return r < m ? __ldg(x_scale + r) : 0.f; }
  __device__ __forceinline__ float2 col(int c, int n) const {  // (w_scale, bias)
    return c < n ? make_float2(__ldg(w_scale + c), bias ? __ldg(bias + c) : 0.f) : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ float apply(int acc, float xs, float2 c) const {
    const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), c.x);
    return bias ? __fadd_rn(v, c.y) : v;
  }
};

// fp32(acc) as it is: a row-parallel layer's partial sum
struct F32Epi {
  static constexpr bool kPaired = false;
  using Out = float;
  float* out;
  __device__ __forceinline__ float row(int, int) const { return 0.f; }
  __device__ __forceinline__ float2 col(int, int) const { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ float apply(float acc, float, float2) const { return acc; }
};

// the exact int32 sum as it is: a row-parallel int8 layer's partial sum
struct I32Epi {
  static constexpr bool kPaired = false;
  using Out = int;
  int* out;
  __device__ __forceinline__ float row(int, int) const { return 0.f; }
  __device__ __forceinline__ float2 col(int, int) const { return make_float2(0.f, 0.f); }
  __device__ __forceinline__ int apply(int acc, float, float2) const { return acc; }
};

}  // namespace

// The linear layer of `dense` in bf16 with an fp32 bias, one rounding: out
// (m, n) bf16 = bf16(x (m, d) @ w (n, d)^T in fp32 + bias (n,) fp32), all
// contiguous, x and w 16-byte aligned, d a multiple of 8 (rows of 16-byte
// multiples, as TMA needs), any m and n. Returns the CUDA error of the launch
// (0 on success).
extern "C" int ldmae_dense_bias_f32(const void* x, const void* w, const float* bias, void* out, int m, int d,
                                    int n, void* stream) {
  if (m < 1 || n < 1 || d < 1 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch<bf16>(x, w, BiasEpi{bias, static_cast<bf16*>(out)}, m, d, n, static_cast<cudaStream_t>(stream)));
}

// The w8a8 linear layer: out (m, n) = dequant(x_q (m, k) @ w_q (n, k)^T) as
// above, x_q and w_q int8, contiguous, 16-byte aligned, k a multiple of 16;
// x_scale (m,), w_scale (n,) and bias (n,) fp32 (bias may be null); out bf16,
// or fp32 when out_fp32 != 0; any m and n. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ldmae_int8_dense(const void* x_q, const void* w_q, const float* x_scale, const float* w_scale,
                                const float* bias, void* out, int m, int k, int n, int out_fp32, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_fp32)
    return static_cast<int>(
        dispatch<int8_t>(x_q, w_q, DequantEpi<float>{x_scale, w_scale, bias, static_cast<float*>(out)}, m, k, n, s));
  return static_cast<int>(
      dispatch<int8_t>(x_q, w_q, DequantEpi<bf16>{x_scale, w_scale, bias, static_cast<bf16*>(out)}, m, k, n, s));
}

// A row-parallel layer's partial product: out (m, n) fp32 = x (m, d) @ w (n,
// d)^T with fp32 sums, bf16 operands as ldmae_dense_bias_f32 takes them, no
// bias and no rounding. Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_dense_f32_out(const void* x, const void* w, float* out, int m, int d, int n, void* stream) {
  if (m < 1 || n < 1 || d < 1 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<bf16>(x, w, F32Epi{out}, m, d, n, static_cast<cudaStream_t>(stream)));
}

// A row-parallel int8 layer's partial product: out (m, n) int32 = x_q (m, k)
// @ w_q (n, k)^T, exact, operands as ldmae_int8_dense takes them. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ldmae_int8_dense_i32(const void* x_q, const void* w_q, int* out, int m, int k, int n, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<int8_t>(x_q, w_q, I32Epi{out}, m, k, n, static_cast<cudaStream_t>(stream)));
}
