// The fp32 products of the port's kernels on the tensor cores as 3xTF32
// (flash_attention_fp32.cu's tensor-core kernels on mma.sync, #4's fp32
// GEMM on wgmma in gemm.cuh): each fp32 operand x is split into x = hi + lo
// + e, hi the TF32 rounding of x (cvt.rna.tf32.f32's: to nearest, ties away
// from zero), lo that of x - hi (exact in fp32), |e| <= 2^-22 |x|; a product
// a b is accumulated in fp32 as a_lo b_hi + a_hi b_lo + a_hi b_hi, the small
// terms first (CUTLASS's OpMultiplyAddFastF32, what SDPA's fp32 path runs).
// The a_lo b_lo term left out is below 2^-22 of the product.
#pragma once

#include "common.cuh"

// cvt.rna.tf32.f32 by integer operations: + 2^12 on the magnitude bits, the
// 13 low bits cleared (the sign bit stands apart). ptxas lowers the cvt to
// about five instructions with its NaN checks; this is two, the same bits
// for every finite x.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}
