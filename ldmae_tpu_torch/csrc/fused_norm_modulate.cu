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
// What bounds it: a few operations per element against 4 bytes moved per
// element (read x, write out), so device memory bandwidth. It runs on the
// streaming row engine (csrc/norm_rows.cuh: persistent grid, parameters
// staged once per batch element, rows loaded ahead of the math); this file
// is its epilogue. The parameters are staged as bf16(w), bf16(1 + scale[b])
// and bf16(shift[b]), and the three roundings after bf16(x * rs) are
// bf16x2 instructions (mul.rn / add.rn, two elements each): the product or
// sum of two bf16 values rounded once to bf16, which is what fp32
// arithmetic rounded to bf16 gives (exact in fp32: the product of two 8-bit
// significands fits 24 bits; a sum is exact when the exponents differ by at
// most 16, and otherwise the smaller term is below a quarter ulp of the
// larger and both roundings return the larger), except for results below
// 2^-126, where fp32's subnormals can round twice.
// fp32 x (the configs' other compute dtype) runs the same engine with an
// fp32 epilogue: the roundings to x's dtype vanish and the parameters are
// staged as fp32 w, 1 + scale[b] and shift[b].
//
// The backward (the JAX package's custom VJP of the kernel, hand-written
// XLA math there: ldmae_tpu/ops/fused_adaln.py, _fnm_custom_vjp) runs on
// the same engine's row walk: rows::bwd in csrc/norm_rows.cuh, whose
// comment gives its math and design.
#include "norm_rows.cuh"

namespace {

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& u, int p) { return reinterpret_cast<const uint32_t*>(&u)[p]; }

template <typename T>
struct Modulate;

// bf16: the staged parameters are [bf16(w) | bf16(1 + scale[b]) | bf16(shift[b])].
template <>
struct Modulate<bf16> {
  using T = bf16;
  using P = bf16;
  static constexpr bool kExactRsqrt = false;

  static __device__ __forceinline__ void stage(P* par, int d, int c, const float* w, const float* sc,
                                               const float* sh) {
    uint32_t pw[4], po[4], ps[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      pw[p] = pack_bf16(w[2 * p], w[2 * p + 1]);
      po[p] = pack_bf16(__fadd_rn(1.f, sc[2 * p]), __fadd_rn(1.f, sc[2 * p + 1]));
      ps[p] = pack_bf16(sh[2 * p], sh[2 * p + 1]);
    }
    *reinterpret_cast<uint4*>(par + c) = make_uint4(pw[0], pw[1], pw[2], pw[3]);
    *reinterpret_cast<uint4*>(par + d + c) = make_uint4(po[0], po[1], po[2], po[3]);
    *reinterpret_cast<uint4*>(par + 2 * d + c) = make_uint4(ps[0], ps[1], ps[2], ps[3]);
  }

  template <int kVec>
  static __device__ __forceinline__ void finish(float (&v)[kVec][8], float rs, const P* par, const rows::Args& a,
                                                long long row, int lane, int nvec) {
    const uint4* pw = reinterpret_cast<const uint4*>(par);
    const uint4* po = reinterpret_cast<const uint4*>(par + a.d);
    const uint4* ps = reinterpret_cast<const uint4*>(par + 2 * a.d);
    uint4* out = reinterpret_cast<uint4*>(static_cast<bf16*>(a.out) + row * a.d);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi >= nvec) continue;
      const uint4 w4 = pw[vi], o4 = po[vi], s4 = ps[vi];
      uint32_t y[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t t = pack_bf16(__fmul_rn(v[i][2 * p], rs), __fmul_rn(v[i][2 * p + 1], rs));
        y[p] = add_bf16x2(mul_bf16x2(mul_bf16x2(t, word(w4, p)), word(o4, p)), word(s4, p));
      }
      out[vi] = make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
};

// fp32: the staged parameters are [w | 1 + scale[b] | shift[b]], fp32.
template <>
struct Modulate<float> {
  using T = float;
  using P = float;
  static constexpr bool kExactRsqrt = false;

  static __device__ __forceinline__ void stage(P* par, int d, int c, const float* w, const float* sc,
                                               const float* sh) {
    *reinterpret_cast<float4*>(par + c) = make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(par + d + c) = make_float4(__fadd_rn(1.f, sc[0]), __fadd_rn(1.f, sc[1]),
                                                          __fadd_rn(1.f, sc[2]), __fadd_rn(1.f, sc[3]));
    *reinterpret_cast<float4*>(par + 2 * d + c) = make_float4(sh[0], sh[1], sh[2], sh[3]);
  }

  template <int kVec>
  static __device__ __forceinline__ void finish(float (&v)[kVec][4], float rs, const P* par, const rows::Args& a,
                                                long long row, int lane, int nvec) {
    const float4* pw = reinterpret_cast<const float4*>(par);
    const float4* po = reinterpret_cast<const float4*>(par + a.d);
    const float4* ps = reinterpret_cast<const float4*>(par + 2 * a.d);
    float4* out = reinterpret_cast<float4*>(static_cast<float*>(a.out) + row * a.d);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi >= nvec) continue;
      const float4 w4 = pw[vi], o4 = po[vi], s4 = ps[vi];
      const float* wf = &w4.x;
      const float* of = &o4.x;
      const float* sf = &s4.x;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(v[i][j], rs), wf[j]), of[j]), sf[j]);
      out[vi] = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
};

}  // namespace

// x, out: contiguous (b, n, d), bf16 (fp32 != 0: fp32), 16-byte aligned,
// with d a multiple of 8 (fp32: 4) and d <= 2048; w: (d,) fp32, or null for
// no weight (always unused when layer != 0); shift, scale: (b, d) in x's
// dtype with unit column stride, row i at shift + i * shift_stride (in
// elements). Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_norm_modulate(const void* x, const float* w, const void* shift,
                                         const void* scale, long long shift_stride,
                                         long long scale_stride, void* out, int b, int n, int d,
                                         int layer, float eps, int fp32, void* stream) {
  const rows::Args a{x, w, shift, scale, shift_stride, scale_stride, out, nullptr, (long long)b * n, n, d, layer, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fp32 ? rows::launch<Modulate<float>>(a, s) : rows::launch<Modulate<bf16>>(a, s));
}

// The backward's grid for this shape on the current device (>= 1), or the
// negated CUDA error: ldmae_fused_norm_modulate_bwd takes a workspace of
// (grid + b) * 3 * d floats. stream is unused (the entries share one
// calling convention).
extern "C" int ldmae_fused_norm_modulate_bwd_grid(int b, int n, int d, int fp32, void* stream) {
  (void)stream;
  const rows::BwdArgs a{nullptr, nullptr, nullptr, nullptr, 0, nullptr, nullptr, (long long)b * n, n, d, 0, 0.f};
  long long grid = 0;
  const cudaError_t e = fp32 ? rows::bwd<float>(a, b, 0, nullptr, nullptr, nullptr, false, false, &grid, nullptr)
                             : rows::bwd<bf16>(a, b, 0, nullptr, nullptr, nullptr, false, false, &grid, nullptr);
  return e == cudaSuccess ? static_cast<int>(grid) : -static_cast<int>(e);
}

// #3's backward. x, g, dx: contiguous (b, n, d), bf16 (fp32 != 0: fp32),
// 16-byte aligned, d as the forward takes it; w: (d,) fp32 or null (unused
// when layer != 0); scale: (b, d) in x's dtype with unit column stride, row i
// at scale + i * scale_stride (in elements); ws: ws_slots * 3 * d floats,
// ws_slots >= the grid of ldmae_fused_norm_modulate_bwd_grid + b. Writes dx
// (x's dtype), dw (d,) fp32 (only with a weight and layer == 0), and dshift
// and dscale (b, d), bf16 when sums_bf16 != 0, else fp32. Returns the CUDA
// error of the launches (0 on success).
extern "C" int ldmae_fused_norm_modulate_bwd(const void* x, const void* g, const float* w, const void* scale,
                                             long long scale_stride, void* dx, float* dw, void* dshift,
                                             void* dscale, float* ws, long long ws_slots, int b, int n, int d,
                                             int layer, float eps, int fp32, int sums_bf16, void* stream) {
  const rows::BwdArgs a{x, g, w, scale, scale_stride, dx, ws, (long long)b * n, n, d, layer, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long grid = 0;
  return static_cast<int>(fp32 ? rows::bwd<float>(a, b, ws_slots, dw, dshift, dscale, sums_bf16, true, &grid, s)
                               : rows::bwd<bf16>(a, b, ws_slots, dw, dshift, dscale, sums_bf16, true, &grid, s));
}
