// Pieces shared by the bf16 attention kernels (flash_attention.cu) and the
// fp32 ones (flash_attention_fp32.cu): the strided operand the attention cores
// read, the conversions between the element type and fp32, and the RoPE /
// qk-norm pre-pass with the half-split RoPE algebra at any head dim.
//
// Half-split RoPE at head dim d, half = d / 2, h1 = d - half (h1 = half for
// even d; the TPU kernels' rot = [-x[half:] | x[:half]] for any d):
//   forward   y[c] = x[c] cos[c] + r[c] sin[c],  r[c] = c < h1 ? -x[c + half] : x[c - h1]
//   transpose (J^T y)[c] = y[c] cos[c] + (c < half ? y[c + h1] sin[c + h1] : -y[c - half] sin[c - half])
// both in fp32 without fused multiply-add, in the TPU kernels' op order.
#pragma once

#include "common.cuh"

namespace attn {

// One operand of an attention core: element (b, h, row, c) lives at
// p + b * sb + h * sh + row * sr + c.
template <typename T>
struct Operand {
  const T* p;
  long long sb, sh;
  int sr;
};

// A contiguous (bh, n, d) tensor: one "head" per batch index.
template <typename T>
inline Operand<T> contiguous(const void* p, int n, int d) {
  return Operand<T>{static_cast<const T*>(p), (long long)n * d, 0, d};
}

// A contiguous (b, h, n, d) tensor as an operand of h heads.
template <typename T>
inline Operand<T> bhnd(const void* p, int h, int n, int d) {
  return Operand<T>{static_cast<const T*>(p), (long long)h * n * d, (long long)n * d, d};
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// x rounded to T and back (a no-op for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The transposed RoPE Jacobian of column c of a row y (fp32, any d), given
// the row's tables: y cos + the partner's sin term.
__device__ __forceinline__ float rope_transpose(const float* y, int c, int d, const float* cs,
                                                const float* sn) {
  const int half = d / 2, h1 = d - half;
  const float rt = c < half ? __fmul_rn(y[c + h1], sn[c + h1]) : -__fmul_rn(y[c - half], sn[c - half]);
  return __fadd_rn(__fmul_rn(y[c], cs[c]), rt);
}

template <typename T>
struct NormRopeArgs {
  Operand<T> x[2];       // q, k in
  Operand<T> y[2];       // rotated q, k out (p written)
  const float* w[2];     // per-head RMS norm weights (d,) fp32 of q and k; unused without kNorm
  const float* cos;      // (n, d) fp32 half-split tables
  const float* sin;
  long long rows;        // batch * heads * n
  int heads, n, d;
  float eps;
};

// Four consecutive fp32 values of a 16-byte aligned table.
__device__ __forceinline__ void load4(float* v, const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// Four consecutive elements (8 bytes of bf16, 16 of fp32) as fp32, and back.
__device__ __forceinline__ void load4(float* v, const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// RoPE pre-pass of flash_attention_rope, flash_attention_fused_rope and (with
// kNorm) flash_attention_qknorm_rope, for d % 8 == 0 and rows whose four-
// element groups are aligned: kLanes lanes per row (one token of one head)
// of q (blockIdx.y == 0) or k (blockIdx.y == 1); lane j of a row owns
// columns 4j..4j+3 of each half, read and written four elements at a time
// (d/2 <= 4 * kLanes). With kNorm, the TPU kernel's cast order: the row
// normalised in fp32 (the sum of squares by shuffles within the row's lanes,
// 1/sqrt without the approximate rsqrt), rounded to T and back, times the
// fp32 weight; then, as without it, x*cos + [-x2 | x1]*sin in fp32 without
// fused multiply-add and one rounding to T. A first version, one warp per
// row with 2-byte accesses, took the pre-pass to half the time of the
// attention after it. Without kNorm (no shuffles) kLanes may be d / 8 when
// that is no power of two: 9 at DiT XL's d = 72, where 16 lanes left 7 of a
// row's idle (the last 256 % 9 threads of a block take no row).
template <typename T, bool kNorm, int kLanes>
__global__ void __launch_bounds__(256) norm_rope_kernel(const NormRopeArgs<T> a) {
  static_assert(!kNorm || (kLanes & (kLanes - 1)) == 0, "the qk-norm's shuffles take power-of-two lanes");
  const long long row = (long long)blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int which = blockIdx.y;
  const int half = a.d / 2, c = 4 * (threadIdx.x % kLanes);
  // inactive lanes stay to the shuffles with zeros
  bool active = row < a.rows && c < half;
  if constexpr (256 % kLanes != 0) active = active && threadIdx.x < 256 / kLanes * kLanes;
  const int pos = active ? (int)(row % a.n) : 0;
  const Operand<T> xo = a.x[which], yo = a.y[which];
  float x1[4] = {0.f, 0.f, 0.f, 0.f}, x2[4] = {0.f, 0.f, 0.f, 0.f};
  T* y = nullptr;
  if (active) {
    const long long bh = row / a.n, b = bh / a.heads, h = bh % a.heads;
    const T* x = xo.p + b * xo.sb + h * xo.sh + (long long)pos * xo.sr;
    y = const_cast<T*>(yo.p) + b * yo.sb + h * yo.sh + (long long)pos * yo.sr;
    load4(x1, x + c);
    load4(x2, x + c + half);
  }
  if (kNorm) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ss += __fadd_rn(__fmul_rn(x1[j], x1[j]), __fmul_rn(x2[j], x2[j]));
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o, kLanes);
    const float rs = 1.f / sqrtf(__fdiv_rn(ss, (float)a.d) + a.eps);
    if (active) {
      float w1[4], w2[4];
      load4(w1, a.w[which] + c);
      load4(w2, a.w[which] + c + half);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x1[j] = __fmul_rn(round_to<T>(__fmul_rn(x1[j], rs)), w1[j]);
        x2[j] = __fmul_rn(round_to<T>(__fmul_rn(x2[j], rs)), w2[j]);
      }
    }
  }
  if (!active) return;
  float c1[4], c2[4], s1[4], s2[4];
  load4(c1, a.cos + (size_t)pos * a.d + c);
  load4(c2, a.cos + (size_t)pos * a.d + c + half);
  load4(s1, a.sin + (size_t)pos * a.d + c);
  load4(s2, a.sin + (size_t)pos * a.d + c + half);
  float o1[4], o2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o1[j] = __fadd_rn(__fmul_rn(x1[j], c1[j]), __fmul_rn(-x2[j], s1[j]));
    o2[j] = __fadd_rn(__fmul_rn(x2[j], c2[j]), __fmul_rn(x1[j], s2[j]));
  }
  store4(y + c, o1);
  store4(y + c + half, o2);
}

// The same pre-pass for any d <= 128 and any alignment: one warp per row,
// lane j owning columns j, j + 32, ..; the row (normalised, with kNorm) goes
// through shared memory, since a column's RoPE partner lies in another lane.
template <typename T, bool kNorm>
__global__ void __launch_bounds__(256) norm_rope_any_kernel(const NormRopeArgs<T> a) {
  __shared__ float rows_s[8][128];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, which = blockIdx.y;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= a.rows) return;  // warp-uniform
  const int d = a.d, half = d / 2, h1 = d - half;
  const int pos = (int)(row % a.n);
  const long long bh = row / a.n, b = bh / a.heads, h = bh % a.heads;
  const Operand<T> xo = a.x[which], yo = a.y[which];
  const T* x = xo.p + b * xo.sb + h * xo.sh + (long long)pos * xo.sr;
  T* y = const_cast<T*>(yo.p) + b * yo.sb + h * yo.sh + (long long)pos * yo.sr;
  float* r = rows_s[warp];
  float xv[4];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    xv[i] = c < d ? to_float(x[c]) : 0.f;
    ss = __fadd_rn(ss, __fmul_rn(xv[i], xv[i]));
  }
  if (kNorm) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float rs = 1.f / sqrtf(__fdiv_rn(ss, (float)d) + a.eps);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      if (c < d) xv[i] = __fmul_rn(round_to<T>(__fmul_rn(xv[i], rs)), a.w[which][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane + 32 * i < d) r[lane + 32 * i] = xv[i];
  __syncwarp();
  const float* cs = a.cos + (size_t)pos * d;
  const float* sn = a.sin + (size_t)pos * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    if (c >= d) continue;
    const float rot = c < h1 ? -r[c + half] : r[c - h1];
    y[c] = from_float<T>(__fadd_rn(__fmul_rn(xv[i], cs[c]), __fmul_rn(rot, sn[c])));
  }
}

template <typename T, int kLanes>
void norm_rope_launch(const NormRopeArgs<T>& a, bool norm, cudaStream_t s) {
  const dim3 grid((unsigned)((a.rows + 256 / kLanes - 1) / (256 / kLanes)), 2);
  if (norm) norm_rope_kernel<T, true, kLanes><<<grid, 256, 0, s>>>(a);
  else norm_rope_kernel<T, false, kLanes><<<grid, 256, 0, s>>>(a);
}

// The pre-pass on q and k. vec: the elements every row start, stride and
// pointer is aligned to (a power of two); the vectorised kernel needs d % 8
// == 0 and groups of four aligned, the other kernel takes any d <= 128.
template <typename T>
cudaError_t norm_rope(const NormRopeArgs<T>& a, bool norm, int vec, cudaStream_t s) {
  if (a.d < 1 || a.d > 128) return cudaErrorInvalidValue;
  if (a.d % 8 == 0 && vec >= 4) {
    if (a.d <= 64) norm_rope_launch<T, 8>(a, norm, s);
    else if (a.d == 72 && !norm) norm_rope_kernel<T, false, 9><<<dim3((unsigned)((a.rows + 27) / 28), 2), 256, 0, s>>>(a);
    else norm_rope_launch<T, 16>(a, norm, s);
  } else {
    const dim3 grid((unsigned)((a.rows + 7) / 8), 2);
    if (norm) norm_rope_any_kernel<T, true><<<grid, 256, 0, s>>>(a);
    else norm_rope_any_kernel<T, false><<<grid, 256, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace attn
