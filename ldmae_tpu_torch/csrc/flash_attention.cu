// Flash attention forward for Hopper (sm_90a), bf16 in and out, non-causal.
//
// Replaces two Pallas TPU kernels of ldmae_tpu/ops/flash_attention.py:
//   * flash_attention_rope (_flash_rope_bhnd_kernel): half-split RoPE on q and
//     k in fp32, cast back to bf16, then attention (DiT sampling, d = 64);
//   * flash_attention forward (_flash_fwd_kernel): the same without RoPE, any
//     sequence length (VMAE decoder, d = 16).
// Both compute softmax(q k^T d^-1/2) v with fp32 logits, the probabilities
// cast to bf16 before P.V, and P.V accumulated in fp32.
//
// What bounds it: at the sampling shapes (N = 1024, d = 64) the two products
// are 4 N^2 d flops per head against 8 N d bytes, far above the card's ridge,
// so the tensor cores and the softmax's exponentials bound it. The TPU kernel
// kept all of K and V for a head in VMEM and did one exact softmax per q
// block; K and V for one head (256 KB) exceed a block's shared memory here.
// So each block (4 warps, 64 query rows) streams 64-row K/V tiles through
// shared memory, double-buffered with cp.async so the next tile loads while
// this one is multiplied, with an online softmax; its q fragments and output
// accumulator stay in registers and both products run on the tensor cores
// (mma.sync m16n8k16). The (N, N) logits never leave registers.
//
// RoPE: rotating K inside the attention kernel would redo it for every
// 64-row q block (16 times per head at N = 1024), and a first version that
// rotated each shared-memory tile stalled on its table loads (PERF.md has
// its times). So a small elementwise pass rotates q and k once into scratch
// (0.45 GB moved at B = 72), and the attention kernel reads the rotated
// copies. The rounding is the TPU kernel's: fp32
// x*cos + rot(x)*sin without fused multiply-add, one bf16 rounding.
//
// Rounding that differs from the TPU kernel: p is rounded to bf16 before it
// is normalised (the row sum stays fp32 and divides at the end), and exp runs
// as exp2 on pre-scaled logits.
//
// Head dims 16 (VMAE), 64 (DiT B/1 to 1p6B) and 72 (XL) are instantiated; d
// is padded to the mma depth (a multiple of 16) with zeros in shared memory. A ragged last tile
// (N not a multiple of 64) is zero-filled and its keys masked to -inf.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;  // query rows per block (16 per warp) = key/value rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Shape {
  static constexpr int kDK = (D + 15) / 16 * 16;  // head dim padded to the mma depth
  static constexpr int kLd = kDK + 8;             // smem row stride in bf16: 16-byte rows,
                                                  // consecutive rows on other banks
  // q tile + two K and two V tiles
  static constexpr int kSmemBytes = 5 * kBlock * kLd * 2;
};

// Asynchronous copy of a 64 x D tile (row stride D in global) into shared
// memory (row stride kLd); rows >= valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int valid) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kBlock * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const int rr = r < valid ? r : 0;  // a valid address; nothing is read when r >= valid
    cp_async16_zfill(s + r * Shape<D>::kLd + c, g + (size_t)rr * D + c, r < valid ? 16 : 0);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// grid: (ceil(n / 64), batch * heads); q, k, v, out: (batch * heads, n, D).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int n,
                     float scale_log2) {
  constexpr int kDK = Shape<D>::kDK;
  constexpr int kLd = Shape<D>::kLd;
  constexpr int kKSteps = kDK / 16;  // mma steps over the head dim
  constexpr int kOBlocks = kDK / 8;  // 8-wide output column blocks
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kBlock * kLd;      // two buffers
  bf16* sv = sk + 2 * kBlock * kLd;  // two buffers

  const int q0 = blockIdx.x * kBlock;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ntiles = (n + kBlock - 1) / kBlock;

  if (kDK > D) {  // the copies write columns < D only; the padding stays zero
    for (int i = threadIdx.x; i < 5 * kBlock * (kDK - D); i += kThreads)
      sq[(i / (kDK - D)) * kLd + D + i % (kDK - D)] = __float2bfloat16_rn(0.f);
  }
  load_tile_async<D>(sq, q + head + (size_t)q0 * D, n - q0);
  cp_async_commit();
  load_tile_async<D>(sk, k + head, n);
  load_tile_async<D>(sv, v + head, n);
  cp_async_commit();
  cp_async_wait<1>();  // the q tile
  __syncthreads();

  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    ldsm_x4(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
            smem_addr(sq + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8));

  float o[kOBlocks][4];
#pragma unroll
  for (int i = 0; i < kOBlocks; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g+8 (log2 units)
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the row sums

  for (int it = 0; it < ntiles; ++it) {
    const int kv0 = it * kBlock;
    const bf16* kt = sk + (it & 1) * kBlock * kLd;
    const bf16* vt = sv + (it & 1) * kBlock * kLd;
    if (it + 1 < ntiles) {  // prefetch the next tile into the other buffers
      const size_t next = head + (size_t)(kv0 + kBlock) * D;
      load_tile_async<D>(sk + ((it + 1) & 1) * kBlock * kLd, k + next, n - kv0 - kBlock);
      load_tile_async<D>(sv + ((it + 1) & 1) * kBlock * kLd, v + next, n - kv0 - kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 blocks of 8 keys.
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                smem_addr(kt + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
                          ((lane >> 3) & 1) * 8));
        mma_bf16_16816(s[2 * p], qf[kk], b0, b1);
        mma_bf16_16816(s[2 * p + 1], qf[kk], b2, b3);
      }
    }

    // Online softmax in log2 units; keys past n are masked.
    const int valid = n - kv0;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + 2 * t + (e & 1);
        const float x = col < valid ? s[i][e] * scale_log2 : -INFINITY;
        s[i][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < kOBlocks; ++i) {
      o[i][0] *= a0;
      o[i][1] *= a0;
      o[i][2] *= a1;
      o[i][3] *= a1;
    }

    // P in bf16 as the A operand: score blocks 2j and 2j+1 form k-step j.
    uint32_t pf[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p0 = exp2f(s[i][0] - m0), p1 = exp2f(s[i][1] - m0);
      const float p2 = exp2f(s[i][2] - m1), p3 = exp2f(s[i][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pf[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
      pf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V, V read transposed from its row-major tile.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int p = 0; p < kOBlocks / 2; ++p) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(b0, b1, b2, b3,
                      smem_addr(vt + (j * 16 + (lane & 15)) * kLd + p * 16 + (lane >> 4) * 8));
        mma_bf16_16816(o[2 * p], pf[j], b0, b1);
        mma_bf16_16816(o[2 * p + 1], pf[j], b2, b3);
      }
    }
    __syncthreads();  // this tile's buffers are consumed before they are refilled
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < kOBlocks; ++i) {
    const int col = i * 8 + 2 * t;
    if (col >= D) continue;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + head + (size_t)r0 * D + col) =
          pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + head + (size_t)r1 * D + col) =
          pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
  }
}

// Half-split RoPE of q and k into qr and kr: for each row (position pos) and
// column c < d/2, x*cos + [-x2 | x1]*sin in fp32 (no fused multiply-add), one
// bf16 rounding. One thread per 4 columns of each half; d/2 % 4 == 0.
__global__ void rope_half_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const float* __restrict__ cos, const float* __restrict__ sin,
                                 bf16* __restrict__ qr, bf16* __restrict__ kr, long long rows,
                                 int n, int d) {
  const int half = d / 2, chunks = half / 4;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = rows * chunks;
  if (i >= 2 * per) return;
  const bool is_k = i >= per;
  if (is_k) i -= per;
  const long long row = i / chunks;
  const int c = (int)(i % chunks) * 4;
  const int pos = (int)(row % n);
  const bf16* x = (is_k ? k : q) + row * d;
  bf16* y = (is_k ? kr : qr) + row * d;
  const uint2 u1 = *reinterpret_cast<const uint2*>(x + c);
  const uint2 u2 = *reinterpret_cast<const uint2*>(x + c + half);
  const float4 c1 = *reinterpret_cast<const float4*>(cos + (size_t)pos * d + c);
  const float4 c2 = *reinterpret_cast<const float4*>(cos + (size_t)pos * d + c + half);
  const float4 s1 = *reinterpret_cast<const float4*>(sin + (size_t)pos * d + c);
  const float4 s2 = *reinterpret_cast<const float4*>(sin + (size_t)pos * d + c + half);
  const bf16* e1 = reinterpret_cast<const bf16*>(&u1);
  const bf16* e2 = reinterpret_cast<const bf16*>(&u2);
  const float cc1[4] = {c1.x, c1.y, c1.z, c1.w}, cc2[4] = {c2.x, c2.y, c2.z, c2.w};
  const float ss1[4] = {s1.x, s1.y, s1.z, s1.w}, ss2[4] = {s2.x, s2.y, s2.z, s2.w};
  float o1[4], o2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x1 = __bfloat162float(e1[j]), x2 = __bfloat162float(e2[j]);
    o1[j] = __fadd_rn(__fmul_rn(x1, cc1[j]), __fmul_rn(-x2, ss1[j]));
    o2[j] = __fadd_rn(__fmul_rn(x2, cc2[j]), __fmul_rn(x1, ss2[j]));
  }
  *reinterpret_cast<uint2*>(y + c) = make_uint2(pack_bf16(o1[0], o1[1]), pack_bf16(o1[2], o1[3]));
  *reinterpret_cast<uint2*>(y + c + half) =
      make_uint2(pack_bf16(o2[0], o2[1]), pack_bf16(o2[2], o2[3]));
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int bh, int n,
                   cudaStream_t stream) {
  constexpr int kSmem = Shape<D>::kSmemBytes;
  // Dynamic shared memory above 48 KB needs an opt-in, which CUDA keeps per
  // device: set it at every launch (cheap) so any card the caller picks has it.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kBlock - 1) / kBlock, bh);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(q, k, v, out, n, scale_log2);
  return cudaGetLastError();
}

cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int bh, int n,
                     int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16>(q, k, v, out, bh, n, s);
    case 64: return launch<64>(q, k, v, out, bh, n, s);
    case 72: return launch<72>(q, k, v, out, bh, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: contiguous (bh, n, d) bf16. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ldmae_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         int bh, int n, int d, void* stream) {
  return static_cast<int>(dispatch(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                   static_cast<const bf16*>(v), static_cast<bf16*>(out), bh, n,
                                   d, static_cast<cudaStream_t>(stream)));
}

// As above with half-split RoPE: cos, sin are contiguous (n, d) fp32 tables;
// qr, kr are (bh, n, d) bf16 scratch that receive the rotated q and k.
extern "C" int ldmae_flash_attention_rope_fwd(const void* q, const void* k, const void* v,
                                              const float* cos, const float* sin, void* qr,
                                              void* kr, void* out, int bh, int n, int d,
                                              void* stream) {
  if ((d / 2) % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)bh * n;
  const long long work = 2 * rows * (d / 2 / 4);
  const int threads = 256;
  rope_half_kernel<<<(unsigned)((work + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), cos, sin, static_cast<bf16*>(qr),
      static_cast<bf16*>(kr), rows, n, d);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(dispatch(static_cast<const bf16*>(qr), static_cast<const bf16*>(kr),
                                   static_cast<const bf16*>(v), static_cast<bf16*>(out), bh, n,
                                   d, s));
}
