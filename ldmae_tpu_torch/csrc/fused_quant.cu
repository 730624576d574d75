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
// instead of __expf, and q rounds half to even (as jnp.round). Only the fp32
// row sums differ: another order, and the compiler may fuse each square
// into its add, which can move q by one step in rare elements.
//
// What bounds them: a handful of operations per element against 3 bytes
// moved (bf16 in, int8 out) for the norm and 5 bytes per output for the
// gate, so device memory bandwidth; at that rate the norm's fp32 epilogue
// also needs a good part of the SMs' issue slots. The norm kernel runs on
// the streaming row engine (csrc/norm_rows.cuh; the row stays in registers
// between the absmax and the int8 pass) and this file holds its epilogue:
// the parameters are staged as fp32 w, 1 + scale[b] and shift[b], and q
// comes from a reciprocal, equal bit for bit to the true quotient's
// rounding (the rule at kMagic below, applied in ModulateQuant::finish). The gate runs one block of 128 threads per row
// (2H = 4,096 values at B/1, 8 KB), in 16-byte loads and 8-byte stores where
// H is a multiple of 8 and the bases are aligned. Any other H (the SwiGLU
// widths int(2/3 * 4D) of L and 1p6B, 2,730 and 4,778, and their halves
// under tensor parallelism, 1,365 and 2,389; a bf16 row of 2H = 5,460 values
// starts every 10,920 bytes, 8 mod 16, and at an odd H x2 starts 2 mod 4
// bytes past x1) runs silu_mul_quant_any_kernel, which moves 16-byte units
// too: each thread makes one aligned 16-byte word of the int8 row, its 16
// inputs of x1 and of x2 read as the aligned 16-byte words that enclose them
// and realigned in registers (funnel shifts); the words wholly inside the
// row are written as one 16-byte store, the ragged first and last word of
// a row (which share their 16 bytes with the neighbouring rows, written by
// other blocks) in aligned stores of 8, 4, 2 and 1 bytes that cover the
// row's bytes alone. Its element-by-element predecessor read at 0.18-0.22
// of the bytes bound on an H100, issue-bound on one load per element.
// fp32 input (the configs' other compute dtype) runs the same kernels with
// the element type a template parameter (their arithmetic is fp32 already).
#include "norm_rows.cuh"

namespace {

using attn::to_float;
using rows::warp_max;

constexpr int kGateThreads = 128;
constexpr int kMaxGateVec = 8;   // gate: 8 outputs a thread kMaxGateVec times, H <= 8 * 8 * 128 = 8192

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

__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(__fdiv_rn(absmax, 127.f), 1e-8f);
}

// The block's largest of its threads' values (part: a float a warp, at
// most kMaxWarps warps).
constexpr int kMaxWarps = 8;
__device__ __forceinline__ float block_max(float v, float* part) {
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  for (int i = 0; i < (int)blockDim.x / 32; ++i) v = fmaxf(v, part[i]);
  return v;
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

// q = rint(o / qs) from the reciprocal r = 1 / qs (rounded), equal bit for
// bit to the true quotient's rounding:
//  * t = o * r is within 3 ulps of the true quotient Q = o / qs (r and the
//    product each round once), and |t| < 128 (|o| <= absmax, qs >=
//    absmax / 127), so t differs from the rounded quotient fl(Q) by less
//    than 3 * 2^-24 * 128 < 2^-14;
//  * y = t + 1.5 * 2^23 rounds t half to even to an integer (the ulp there
//    is 1): y - 1.5 * 2^23 = rint(t), and y's low byte is rint(t) as int8;
//  * f = t - rint(t) (exact) gives t's distance to the nearest half-integer,
//    0.5 - |f|. When it exceeds 2^-14, no half-integer lies between t and
//    fl(Q), so rint(t) = rint(fl(Q)). A lane with an element within 2^-14
//    of a half-integer (|f| >= kNearHalf, or f NaN), and every lane of a row
//    whose qs or r is not a normal number, redoes its elements with the true
//    quotient (__fdiv_rn, converted as rintf then a cast would).
// tests/test_torch_port_rowquant.py holds a numpy model of this rule to
// numpy's true division.
constexpr float kMagic = 12582912.f;
constexpr float kNearHalf = 0.5f - 0x1p-14f;

// Four int8 from the low bytes of four words.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The norm's epilogue: o in fp32 from the staged [w | 1 + scale[b] |
// shift[b]] (fp32), the row's absmax and scale, then int8 stores: with bf16
// x (8 elements a vector) two neighbouring lanes swap halves so that one of
// them writes 16 bytes (when d % 16 == 0, else each writes its 8); with
// fp32 x each lane writes its 4.
template <typename T_>
struct ModulateQuant {
  using T = T_;
  using P = float;
  static constexpr bool kExactRsqrt = true;
  static constexpr int kE = 16 / sizeof(T);

  static __device__ __forceinline__ void stage(P* par, int d, int c, const float* w, const float* sc,
                                               const float* sh) {
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      const int j = 4 * q;
      *reinterpret_cast<float4*>(par + c + j) = make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]);
      *reinterpret_cast<float4*>(par + d + c + j) = make_float4(__fadd_rn(1.f, sc[j]), __fadd_rn(1.f, sc[j + 1]),
                                                                __fadd_rn(1.f, sc[j + 2]), __fadd_rn(1.f, sc[j + 3]));
      *reinterpret_cast<float4*>(par + 2 * d + c + j) = make_float4(sh[j], sh[j + 1], sh[j + 2], sh[j + 3]);
    }
  }

  template <int kVec>
  static __device__ __forceinline__ void finish(float (&v)[kVec][kE], float rs, const P* par, const rows::Args& a,
                                                long long row, int lane, int nvec) {
    const float4* pw = reinterpret_cast<const float4*>(par);
    const float4* po = reinterpret_cast<const float4*>(par + a.d);
    const float4* ps = reinterpret_cast<const float4*>(par + 2 * a.d);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if (vi >= nvec) {  // no element: o = 0 keeps the int8 pass on its fast path
#pragma unroll
        for (int j = 0; j < kE; ++j) v[i][j] = 0.f;
        continue;
      }
#pragma unroll
      for (int q = 0; q < kE / 4; ++q) {
        const float4 w4 = pw[vi * (kE / 4) + q], o4 = po[vi * (kE / 4) + q], s4 = ps[vi * (kE / 4) + q];
        const float* wf = &w4.x;
        const float* of = &o4.x;
        const float* sf = &s4.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& e = v[i][4 * q + j];
          e = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(e, rs), wf[j]), of[j]), sf[j]);
          amax = fmaxf(amax, fabsf(e));
        }
      }
    }
    const float qs = fmaxf(__fdiv_rn(warp_max(amax), 127.f), 1e-8f);
    const float r = __frcp_rn(qs);
    bool redo = !(qs >= 0x1p-126f && r >= 0x1p-126f && r < 0x1p127f);
    uint32_t pk[kVec][kE / 4];  // int8, four a word
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
#pragma unroll
      for (int q = 0; q < kE / 4; ++q) {
        uint32_t y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float t = __fmul_rn(v[i][4 * q + j], r);
          const float yf = __fadd_rn(t, kMagic);
          redo |= !(fabsf(__fsub_rn(t, __fsub_rn(yf, kMagic))) < kNearHalf);
          y[j] = __float_as_uint(yf);
        }
        pk[i][q] = pack_low_bytes(y[0], y[1], y[2], y[3]);
      }
    }
    if (redo) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
#pragma unroll
        for (int q = 0; q < kE / 4; ++q) {
          uint32_t y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) y[j] = static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v[i][4 * q + j], qs)));
          pk[i][q] = pack_low_bytes(y[0], y[1], y[2], y[3]);
        }
      }
    }
    int8_t* out = static_cast<int8_t*>(a.out) + row * a.d;
    const bool wide = a.d % 16 == 0;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int vi = lane + i * 32;
      if constexpr (kE == 8) {
        const uint2 mine = make_uint2(pk[i][0], pk[i][1]);
        if (wide) {
          // lanes 2k, 2k + 1 hold the 16 bytes at vector 2k: the even lane
          // writes them for even i, the odd lane for odd i
          const uint2 other = make_uint2(__shfl_xor_sync(0xffffffffu, mine.x, 1),
                                         __shfl_xor_sync(0xffffffffu, mine.y, 1));
          const int base = (lane & ~1) + i * 32;
          if ((lane & 1) == (i & 1) && base < nvec) {
            const uint4 pair = (lane & 1) ? make_uint4(other.x, other.y, mine.x, mine.y)
                                          : make_uint4(mine.x, mine.y, other.x, other.y);
            *reinterpret_cast<uint4*>(out + base * 8) = pair;
          }
        } else if (vi < nvec) {
          *reinterpret_cast<uint2*>(out + vi * 8) = mine;
        }
      } else if (vi < nvec) {
        *reinterpret_cast<uint32_t*>(out + vi * 4) = pk[i][0];
      }
    }
    if (lane == 0) a.scales[row] = qs;
  }
};

// What the gate kernel writes: #10 whole (int8 rows and their scales), or
// one of its two halves for a hidden dim split over tensor-parallel ranks:
// the row's absmax alone (kGateAmax), then, once the ranks' absmaxes are
// reduced with max, the int8 rows and scales from that absmax (kGateScaled).
// The two halves on each rank's slice equal #10 on the whole row bit for
// bit: max is exact in any order, and each element's quotient is the same.
enum GateMode { kGateFull, kGateAmax, kGateScaled };

// One block per row of x12 (2H elements); kVec: 8 outputs a thread, kVec
// times, 8 neighbouring outputs a thread in 16-byte loads and 8-byte stores
// (H % 8 == 0, aligned bases). amax: written (kGateAmax) or read
// (kGateScaled), one fp32 a row.
template <typename T, int kVec, GateMode kMode>
__global__ void __launch_bounds__(kGateThreads)
    silu_mul_quant_kernel(const T* __restrict__ x12, int8_t* __restrict__ out,
                          float* __restrict__ scales, float* __restrict__ amax_row, int h) {
  __shared__ float part[kMaxWarps];
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
  if constexpr (kMode == kGateScaled) {
    amax = amax_row[row];
  } else {
    amax = block_max(amax, part);
    if constexpr (kMode == kGateAmax) {
      if (threadIdx.x == 0) amax_row[row] = amax;
      return;
    }
  }
  const float qs = row_scale(amax);
  int8_t* orow = out + row * h;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = threadIdx.x + i * kGateThreads;
    if (vi < nvec) *reinterpret_cast<uint2*>(orow + vi * 8) = quantize8(o[i], qs);
  }
  if (threadIdx.x == 0) scales[row] = qs;
}

// The 32-bit words r[0, kR) of the bytes that start `shift` (0..15) bytes
// into w (little endian: the lower address in the lower bits), w holding
// kR + 4 words. shift is the same for a whole row, so the switch does not
// diverge.
template <int kR>
__device__ __forceinline__ void realign(const uint32_t (&w)[kR + 4], int shift, uint32_t (&r)[kR]) {
  const unsigned bits = 8u * (shift & 3);
  switch (shift >> 2) {
#define LDMAE_CASE(S)                                                          \
  case S:                                                                      \
    _Pragma("unroll") for (int q = 0; q < kR; ++q) r[q] = __funnelshift_r(w[q + S], w[q + S + 1], bits); \
    break;
    LDMAE_CASE(0) LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3)
#undef LDMAE_CASE
  }
}

// Elements e0 .. e0 + 15 of p's row [p, p + h) as fp32 (0 outside it): the
// aligned 16-byte words that enclose them are loaded, except words that hold
// no byte of the row (so nothing outside the tensor is read), and realigned.
// kEdge false: all 16 lie in the row (no element is masked).
template <typename T, bool kEdge>
__device__ __forceinline__ void load16(const T* p, int e0, int h, float (&v)[16]) {
  constexpr int kR = 16 * sizeof(T) / 4;  // 32-bit words of 16 elements
  constexpr int kIn = kR / 4 + 1;         // 16-byte words that enclose them
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p), hi = lo + (uintptr_t)h * sizeof(T);
  const uintptr_t start = lo + (intptr_t)e0 * (intptr_t)sizeof(T);
  const uintptr_t base = start & ~(uintptr_t)15;
  const int shift = static_cast<int>(start - base);
  uint32_t w[kR + 4];
#pragma unroll
  for (int k = 0; k < kIn; ++k) {
    const uintptr_t a = base + 16 * k;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if ((k < kIn - 1 || shift != 0) && (!kEdge || (a < hi && a + 16 > lo))) u = *reinterpret_cast<const uint4*>(a);
    w[4 * k] = u.x, w[4 * k + 1] = u.y, w[4 * k + 2] = u.z, w[4 * k + 3] = u.w;
  }
  uint32_t r[kR];
  realign<kR>(w, shift, r);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float x;
    if constexpr (sizeof(T) == 2) {
      x = __uint_as_float(j % 2 ? r[j / 2] & 0xffff0000u : r[j / 2] << 16);
    } else {
      x = __uint_as_float(r[j]);
    }
    v[j] = !kEdge || (e0 + j >= 0 && e0 + j < h) ? x : 0.f;
  }
}

// Bytes [lo, hi) of the 16-byte word q (16 int8, four a word) to dst, a
// 16-byte aligned address: one 16-byte store for the whole word, else
// aligned stores of 8, 4, 2 and 1 bytes that write those bytes alone.
__device__ __forceinline__ void store_bytes(int8_t* dst, const uint32_t (&q)[4], int lo, int hi) {
  if (lo == 0 && hi == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    return;
  }
  // q indexed by constants only (a runtime index would put it in local memory)
  const auto at = [&](int i) { return i == 0 ? q[0] : i == 1 ? q[1] : i == 2 ? q[2] : q[3]; };
  for (int p = lo; p < hi;) {
    const uint32_t word = at(p / 4);
    if (p % 8 == 0 && p + 8 <= hi) {
      *reinterpret_cast<uint2*>(dst + p) = make_uint2(word, at(p / 4 + 1));
      p += 8;
    } else if (p % 4 == 0 && p + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(dst + p) = word;
      p += 4;
    } else if (p % 2 == 0 && p + 2 <= hi) {
      *reinterpret_cast<uint16_t*>(dst + p) = static_cast<uint16_t>(word >> (8 * (p % 4)));
      p += 2;
    } else {
      dst[p] = static_cast<int8_t>(word >> (8 * (p % 4)));
      p += 1;
    }
  }
}

// #10 at any 1 <= H <= 8192 and any element-aligned bases. One block per
// row; thread t makes the aligned 16-byte words t, t + blockDim.x, ...
// (kWords of them) of the row's int8 output: word k holds outputs e0 = 16 k
// - a0 .. e0 + 15, a0 the output row's offset from the 16-byte boundary
// before it (0 in kGateAmax, which writes no row). The block has as many
// warps as keep its threads busy at this H (gate_launch_any). Each output
// and its int8 come from the vector kernel's operations, so the two agree
// bit for bit.
template <typename T, int kWords, GateMode kMode>
__global__ void __launch_bounds__(kMaxWarps * 32)
    silu_mul_quant_any_kernel(const T* __restrict__ x12, int8_t* __restrict__ out,
                              float* __restrict__ scales, float* __restrict__ amax_row, int h) {
  __shared__ float part[kMaxWarps];
  const long long row = blockIdx.x;
  const T* x1 = x12 + row * 2 * h;
  const T* x2 = x1 + h;
  int8_t* orow = kMode == kGateAmax ? nullptr : out + row * h;
  const int a0 = static_cast<int>(reinterpret_cast<uintptr_t>(orow) % 16);
  const int nw = (a0 + h + 15) / 16;
  float o[kWords][16];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int k = threadIdx.x + i * blockDim.x;
    if (k >= nw) continue;
    const int e0 = 16 * k - a0;
    float v1[16], v2[16];
    if (e0 >= 0 && e0 + 16 <= h) {  // a word inside the row: every thread but the first and last word's
      load16<T, false>(x1, e0, h, v1);
      load16<T, false>(x2, e0, h, v2);
    } else {
      load16<T, true>(x1, e0, h, v1);
      load16<T, true>(x2, e0, h, v2);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float a = v1[j];
      const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-a)));
      o[i][j] = __fmul_rn(__fmul_rn(a, sig), v2[j]);  // 0 outside the row
      amax = fmaxf(amax, fabsf(o[i][j]));
    }
  }
  if constexpr (kMode == kGateScaled) {
    amax = amax_row[row];
  } else {
    amax = block_max(amax, part);
    if constexpr (kMode == kGateAmax) {
      if (threadIdx.x == 0) amax_row[row] = amax;
      return;
    }
  }
  const float qs = row_scale(amax);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int k = threadIdx.x + i * blockDim.x;
    if (k >= nw) continue;
    const int e0 = 16 * k - a0;
    uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int v = static_cast<int>(rintf(__fdiv_rn(o[i][j], qs)));
      q[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(v))) << (8 * (j % 4));
    }
    store_bytes(orow + e0, q, max(0, -e0), min(16, h - e0));
  }
  if (threadIdx.x == 0) scales[row] = qs;
}

template <typename T, GateMode kMode>
cudaError_t gate_launch_vec(const T* x12, int8_t* out, float* scales, long long rows, int h, cudaStream_t s,
                            float* amax) {
  const dim3 grid(static_cast<unsigned>(rows));
  switch ((h + 8 * kGateThreads - 1) / (8 * kGateThreads)) {
#define LDMAE_CASE(V)                                                                              \
  case V:                                                                                          \
    silu_mul_quant_kernel<T, V, kMode><<<grid, kGateThreads, 0, s>>>(x12, out, scales, amax, h);   \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3) LDMAE_CASE(4)
    LDMAE_CASE(5) LDMAE_CASE(6) LDMAE_CASE(7) LDMAE_CASE(8)
#undef LDMAE_CASE
  }
  return cudaGetLastError();
}

// kWords words a thread and as many warps (at most kMaxWarps) as the row's
// words (at most (15 + h + 15) / 16 with the output's offset) need.
template <typename T, GateMode kMode>
cudaError_t gate_launch_any(const T* x12, int8_t* out, float* scales, long long rows, int h, cudaStream_t s,
                            float* amax) {
  const dim3 grid(static_cast<unsigned>(rows));
  const int words = (h + 30) / 16, per = (words + kMaxWarps * 32 - 1) / (kMaxWarps * 32);
  const int threads = ((words + per - 1) / per + 31) / 32 * 32;
  switch (per) {
#define LDMAE_CASE(W)                                                                            \
  case W:                                                                                        \
    silu_mul_quant_any_kernel<T, W, kMode><<<grid, threads, 0, s>>>(x12, out, scales, amax, h);  \
    break;
    LDMAE_CASE(1) LDMAE_CASE(2) LDMAE_CASE(3)
#undef LDMAE_CASE
  }
  return cudaGetLastError();
}

// Any 1 <= h <= 8192; the vector kernel where h % 8 == 0, x12 is 16-byte and
// out 8-byte aligned, else silu_mul_quant_any_kernel.
template <typename T, GateMode kMode = kGateFull>
cudaError_t gate_launch(const void* x12, void* out, float* scales, long long rows, int h, cudaStream_t s,
                        float* amax = nullptr) {
  if (h < 1 || h > kMaxGateVec * 8 * kGateThreads || rows < 1 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xb = static_cast<const T*>(x12);
  int8_t* ob = static_cast<int8_t*>(out);
  const bool vec =
      h % 8 == 0 && reinterpret_cast<uintptr_t>(x12) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return vec ? gate_launch_vec<T, kMode>(xb, ob, scales, rows, h, s, amax)
             : gate_launch_any<T, kMode>(xb, ob, scales, rows, h, s, amax);
}

}  // namespace

// x: contiguous (b, n, d), bf16 (fp32 != 0: fp32), 16-byte aligned, d a
// multiple of 8 (fp32: 4) and <= 2048; w: (d,) fp32, or null for no weight
// (always unused when layer != 0); shift, scale: (b, d) in x's dtype with
// unit column stride, row i at shift + i * shift_stride (in elements).
// Writes out: (b, n, d) int8 and scales: (b, n) fp32. Returns the CUDA error
// of the launch (0 on success).
extern "C" int ldmae_fused_norm_modulate_quant(const void* x, const float* w, const void* shift,
                                               const void* scale, long long shift_stride,
                                               long long scale_stride, void* out, float* scales,
                                               int b, int n, int d, int layer, float eps, int fp32,
                                               void* stream) {
  const rows::Args a{x, w, shift, scale, shift_stride, scale_stride, out, scales, (long long)b * n, n, d, layer, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fp32 ? rows::launch<ModulateQuant<float>>(a, s) : rows::launch<ModulateQuant<bf16>>(a, s));
}

// x12: contiguous (rows, 2h), bf16 (fp32 != 0: fp32), 1 <= h <= 8192, rows
// >= 1. Writes out: (rows, h) int8 and scales: (rows,) fp32. Returns the
// CUDA error of the launch (0 on success; cudaErrorInvalidValue for a shape
// outside those bounds).
extern "C" int ldmae_fused_silu_mul_quant(const void* x12, void* out, float* scales,
                                          long long rows, int h, int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fp32 ? gate_launch<float>(x12, out, scales, rows, h, s)
                               : gate_launch<bf16>(x12, out, scales, rows, h, s));
}

// #10's first half on a rank's slice of the hidden dim: x12 as above (the
// slice [x1_r | x2_r], h its width); writes amax: (rows,) fp32, the absmax of
// each row of silu(x1) * x2. Returns the CUDA error of the launch.
extern "C" int ldmae_silu_mul_amax(const void* x12, float* amax, long long rows, int h, int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fp32 ? gate_launch<float, kGateAmax>(x12, nullptr, nullptr, rows, h, s, amax)
                               : gate_launch<bf16, kGateAmax>(x12, nullptr, nullptr, rows, h, s, amax));
}

// #10's second half: given amax (rows,) fp32, the absmax of each whole row
// (the ranks' values reduced with max), writes out (rows, h) int8 and scales
// (rows,) fp32 as #10 does for the whole row. Returns the CUDA error of the
// launch.
extern "C" int ldmae_silu_mul_quant_scaled(const void* x12, const float* amax, void* out, float* scales,
                                           long long rows, int h, int fp32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = const_cast<float*>(amax);  // read only in this mode
  return static_cast<int>(fp32 ? gate_launch<float, kGateScaled>(x12, out, scales, rows, h, s, a)
                               : gate_launch<bf16, kGateScaled>(x12, out, scales, rows, h, s, a));
}
