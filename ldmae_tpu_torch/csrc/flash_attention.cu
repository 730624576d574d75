// Flash attention for Hopper (sm_90a), bf16 in and out, non-causal: four
// forward kernels here, the two backward kernels in the section "Backward"
// below (its own note says what bounds them and where they round).
//
// The forward replaces four Pallas TPU kernels of ldmae_tpu/ops/flash_attention.py:
//   * flash_attention_rope (_flash_rope_bhnd_kernel): half-split RoPE on q and
//     k in fp32, cast back to bf16, then attention (DiT sampling, d = 64);
//   * flash_attention forward (_flash_fwd_kernel): the same without RoPE, any
//     sequence length (VMAE decoder, d = 16);
//   * flash_attention_qknorm_rope (_flash_qknorm_rope_kernel): per-head RMS
//     qk-norm with its fp32 weight, then RoPE, then attention (opt-in
//     impl "flash_qkr");
//   * flash_attention_fused_rope (_flash_rope_kernel): RoPE + attention on q,
//     k, v in the (B, N, H*hd) layout of the qkv projection, the output
//     written in that layout (opt-in impl "flash_fused").
// All compute softmax(q k^T d^-1/2) v with fp32 logits, the probabilities
// cast to bf16 before P.V, and P.V accumulated in fp32.
//
// Layouts: the attention core reads q, k, v and writes the output through
// per-operand element strides of batch, head and row (a row is one token of
// one head, its d elements contiguous), so the (B, H, N, d) tensors of the
// first three kernels and the (B, N, H*hd) rows of the fourth, v read as a
// strided view of the packed qkv, go through the same code with nothing
// transposed or copied.
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
// copies. One pre-pass (norm_rope_kernel) serves all three RoPE kernels, the
// per-head qk-norm of flash_attention_qknorm_rope a template switch of it. The
// rounding is the TPU kernel's: fp32 x*cos + rot(x)*sin without fused
// multiply-add, one bf16 rounding.
//
// Rounding that differs from the TPU kernel: p is rounded to bf16 before it
// is normalised (the row sum stays fp32 and divides at the end), and exp runs
// as exp2 on pre-scaled logits.
//
// Head dims 16 (VMAE), 64 (DiT B/1 to 1p6B) and 72 (XL) are instantiated; d
// is padded to the mma depth (a multiple of 16) with zeros in shared memory. A ragged last tile
// (N not a multiple of 64) is zero-filled and its keys masked to -inf.
//
// flash_attention_rope and flash_attention at d = 64 run a second core,
// flash_fwd_wgmma_kernel (wgmma, TMA, warp-specialised; its own note below),
// which can also write the softmax's lse for the backward; at d = 16 and 72
// they run this one. The other two forward kernels, and the backward's
// statistics pass at d = 16 and 72, run this one at every head dim.
#include "hopper.cuh"

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
  // Blocks per SM the register budget must allow: four fit the shared memory
  // (46 KB each at d = 64) if a thread keeps to 128 registers; without the
  // bound the strided indexing took d = 64 to 132 registers and three blocks.
  static constexpr int kMinBlocks = D <= 64 ? 4 : 3;
};

// One operand of the attention core: element (b, h, row, c) lives at
// p + b * sb + h * sh + row * sr + c. Every stride and p are 16-byte aligned.
struct Operand {
  const bf16* p;
  long long sb, sh;
  int sr;
};

struct AttnArgs {
  Operand q, k, v, o;  // o.p is written
  int heads, n;
  float scale_log2;
  // The backward's statistics pass (flash_fwd_kernel<D, true>) writes, in
  // place of o, per query row r of program bh: lse[bh * npad + r] = log2 of
  // the softmax denominator in the kernel's log2 units (running max
  // included) and delta[bh * npad + r] = rowsum(g * o) with o the fp32
  // normalised output; rows n <= r < npad get 0.
  Operand g;
  float* lse;
  float* delta;
  int npad;
};

// Asynchronous copy of a 64 x D tile (row stride ld elements in global) into
// shared memory (row stride kLd); rows >= valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int ld, int valid) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kBlock * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const int rr = r < valid ? r : 0;  // a valid address; nothing is read when r >= valid
    cp_async16_zfill(s + r * Shape<D>::kLd + c, g + rr * ld + c, r < valid ? 16 : 0);
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

// grid: (ceil(n / 64), batch * heads). With kStats, the backward's
// statistics pass: the same forward, whose epilogue writes lse and delta
// (AttnArgs) instead of the output.
template <int D, bool kStats>
__global__ void __launch_bounds__(kThreads, Shape<D>::kMinBlocks) flash_fwd_kernel(const AttnArgs a) {
  constexpr int kDK = Shape<D>::kDK;
  constexpr int kLd = Shape<D>::kLd;
  constexpr int kKSteps = kDK / 16;  // mma steps over the head dim
  constexpr int kOBlocks = kDK / 8;  // 8-wide output column blocks
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kBlock * kLd;      // two buffers
  bf16* sv = sk + 2 * kBlock * kLd;  // two buffers

  const int n = a.n;
  const float scale_log2 = a.scale_log2;
  const int bi = blockIdx.y / a.heads, hi = blockIdx.y % a.heads;
  const bf16* __restrict__ q = a.q.p + bi * a.q.sb + hi * a.q.sh;
  const bf16* __restrict__ k = a.k.p + bi * a.k.sb + hi * a.k.sh;
  const bf16* __restrict__ v = a.v.p + bi * a.v.sb + hi * a.v.sh;
  bf16* __restrict__ out = const_cast<bf16*>(a.o.p) + bi * a.o.sb + hi * a.o.sh;
  const int q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ntiles = (n + kBlock - 1) / kBlock;

  if (kDK > D) {  // the copies write columns < D only; the padding stays zero
    for (int i = threadIdx.x; i < 5 * kBlock * (kDK - D); i += kThreads)
      sq[(i / (kDK - D)) * kLd + D + i % (kDK - D)] = __float2bfloat16_rn(0.f);
  }
  load_tile_async<D>(sq, q + (long long)q0 * a.q.sr, a.q.sr, n - q0);
  cp_async_commit();
  load_tile_async<D>(sk, k, a.k.sr, n);
  load_tile_async<D>(sv, v, a.v.sr, n);
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
      const long long next = kv0 + kBlock;
      load_tile_async<D>(sk + ((it + 1) & 1) * kBlock * kLd, k + next * a.k.sr, a.k.sr,
                         n - kv0 - kBlock);
      load_tile_async<D>(sv + ((it + 1) & 1) * kBlock * kLd, v + next * a.v.sr, a.v.sr,
                         n - kv0 - kBlock);
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

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  if constexpr (kStats) {
    const bf16* gp = a.g.p + bi * a.g.sb + hi * a.g.sh;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int i = 0; i < kOBlocks; ++i) {
      const int col = i * 8 + 2 * t;
      if (col >= D) continue;
      if (r0 < n) {
        const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(gp + (long long)r0 * a.g.sr + col);
        d0 += __low2float(gv) * (o[i][0] * inv0) + __high2float(gv) * (o[i][1] * inv0);
      }
      if (r1 < n) {
        const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(gp + (long long)r1 * a.g.sr + col);
        d1 += __low2float(gv) * (o[i][2] * inv1) + __high2float(gv) * (o[i][3] * inv1);
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (t == 0) {  // rows < npad: the grid covers ceil(n / 64) tiles of 64
      const long long base = (long long)blockIdx.y * a.npad;
      a.lse[base + r0] = r0 < n ? m0 + log2f(sum0) : 0.f;
      a.delta[base + r0] = r0 < n ? d0 : 0.f;
      a.lse[base + r1] = r1 < n ? m1 + log2f(sum1) : 0.f;
      a.delta[base + r1] = r1 < n ? d1 : 0.f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kOBlocks; ++i) {
    const int col = i * 8 + 2 * t;
    if (col >= D) continue;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + (long long)r0 * a.o.sr + col) =
          pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + (long long)r1 * a.o.sr + col) =
          pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
  }
}

struct NormRopeArgs {
  Operand x[2];          // q, k in
  Operand y[2];          // rotated q, k out (p written)
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

// RoPE pre-pass of flash_attention_rope, flash_attention_fused_rope and (with
// kNorm) flash_attention_qknorm_rope: kLanes lanes per row (one token of one head) of q (blockIdx.y == 0) or k
// (blockIdx.y == 1); lane j of a row owns columns 4j..4j+3 of each half, read
// and written 8 bytes at a time (d/2 <= 4 * kLanes). With kNorm, the TPU
// kernel's cast order: the row normalised in fp32 (the sum of squares by
// shuffles within the row's lanes, 1/sqrt without the approximate rsqrt),
// rounded to bf16 and back, times the fp32 weight; then, as without it,
// x*cos + [-x2 | x1]*sin in fp32 without fused multiply-add and one bf16
// rounding. A first version, one warp per row with 2-byte accesses, took the
// pre-pass to half the time of the attention after it.
template <bool kNorm, int kLanes>
__global__ void __launch_bounds__(256) norm_rope_kernel(const NormRopeArgs a) {
  const long long row = (long long)blockIdx.x * (256 / kLanes) + threadIdx.x / kLanes;
  const int which = blockIdx.y;
  const int half = a.d / 2, c = 4 * (threadIdx.x % kLanes);
  // inactive lanes stay to the shuffles with zeros
  const bool active = row < a.rows && c < half;
  const int pos = active ? (int)(row % a.n) : 0;
  const Operand xo = a.x[which], yo = a.y[which];
  float x1[4] = {0.f, 0.f, 0.f, 0.f}, x2[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* x = nullptr;
  bf16* y = nullptr;
  if (active) {
    const long long bh = row / a.n, b = bh / a.heads, h = bh % a.heads;
    x = xo.p + b * xo.sb + h * xo.sh + (long long)pos * xo.sr;
    y = const_cast<bf16*>(yo.p) + b * yo.sb + h * yo.sh + (long long)pos * yo.sr;
    const uint2 u1 = *reinterpret_cast<const uint2*>(x + c);
    const uint2 u2 = *reinterpret_cast<const uint2*>(x + c + half);
    const bf16* e1 = reinterpret_cast<const bf16*>(&u1);
    const bf16* e2 = reinterpret_cast<const bf16*>(&u2);
#pragma unroll
    for (int j = 0; j < 4; ++j) x1[j] = __bfloat162float(e1[j]), x2[j] = __bfloat162float(e2[j]);
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
        x1[j] = __fmul_rn(round_bf16(__fmul_rn(x1[j], rs)), w1[j]);
        x2[j] = __fmul_rn(round_bf16(__fmul_rn(x2[j], rs)), w2[j]);
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
  *reinterpret_cast<uint2*>(y + c) = make_uint2(pack_bf16(o1[0], o1[1]), pack_bf16(o1[2], o1[3]));
  *reinterpret_cast<uint2*>(y + c + half) =
      make_uint2(pack_bf16(o2[0], o2[1]), pack_bf16(o2[2], o2[3]));
}

// ---------------------------------------------------------------------------
// flash_attention_rope and flash_attention at d = 64 on wgmma and TMA: the
// main path's attention (DiT sampling, and the training forward). With the
// RoPE pre-pass above it replaces _flash_rope_bhnd_kernel
// (ldmae_tpu/ops/flash_attention.py, pallas_call at :323), without it
// _flash_fwd_kernel (:77) at this head dim; it computes what
// flash_fwd_kernel<64, false> does,
// with the same roundings (p to bf16 before it is normalised), the logits
// scaled inside the exponent's FMA, exp2 by the SFU's ex2.approx.
//
// What bounds it: at (16, 12, 1024, 64) the two products are 4 b h N^2 d =
// 5.2e10 flops, 0.052 ms at 989 TFLOP/s, and the softmax's b h N^2 = 2.0e8
// exponentials take as long on the SFUs (16 a clock per SM, 0.054 ms); the
// 8 b h N d bytes (0.015 ms) do not bound it. So the design must keep the
// tensor cores busy while the exponentials run; the mma.sync core neither
// reached their full rate nor overlapped the two.
//
// Design (FlashAttention-3's for this head dim): persistent blocks, one per
// SM, walk work tiles of 192 query rows of one (b, h), the tiles of a head
// in a row so that its K and V stay in L2. Warpgroup 0 is the producer: one
// thread loads each work tile's Q once and its 128-key K and V tiles into a
// ring of kFaStages stages by TMA (128-byte swizzle; 3D tensor maps over
// (bh, n, d), so keys and rows past n arrive as zeros), under full and empty
// mbarriers; Q has its own, released after the tile's last Q K^T, so the
// next tile's Q and first K and V load while this one finishes. Warpgroups
// 1 to 3 own 64 query rows each (setmaxnreg: 160 registers, the producer
// 24). S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
// memory; the online softmax runs in registers in exp2 units (ex2.approx);
// P, rounded to bf16, stays in registers as the A operand of O += P V, wgmma
// m64n64k16 with V read MN-major from its (key, d) tile. Each iteration
// issues Q K^T of this tile and P V of the previous one back to back, and the
// three warpgroups take turns at issuing through named barriers, so two
// softmaxes run while the third warpgroup's products do (with two
// warpgroups of 128-row tiles the softmax showed through; FA3's overlap
// inside a warpgroup, the next Q K^T issued before this softmax, ran
// slower at this head dim). Keys past n are
// masked to -inf in the last tile; rows past n are computed on zeros and not
// stored (at n = 1024, 128 of the last tile's 192: 1/9 of the work).

// 2^x on the SFU (relative error about 2^-22; results below 2^-126 flush to
// zero, far under the bf16 rounding of p)
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kFaWG = 3;               // consumer warpgroups, 64 query rows each
constexpr int kFaRows = 64 * kFaWG;    // query rows per work tile
constexpr int kFaKeys = 128;           // keys per K/V tile
constexpr int kFaStages = 3;           // K/V ring depth
constexpr int kFaTile = kFaKeys * 64 * 2;  // bytes of a K or V tile (128 rows of 64 bf16)
constexpr int kFaQTile = kFaRows * 64 * 2;  // bytes of a Q tile
constexpr int kFaThreads = 128 * (kFaWG + 1);
constexpr int kFaSmem = kFaQTile + 2 * kFaStages * kFaTile + 1024;  // + slack to align to 1 KB

// grid: one block per SM (at most one per work tile); work tile w is query
// rows kFaRows (w % qtiles).. of (b, h) = w / qtiles. With kLse (training),
// the epilogue also writes lse[bh * n + r] = m + log2(l) for rows r < n: the
// softmax's log2 denominator, max included, in the exp2 units of the
// logits scaled by scale_log2, which the backward subtracts before its exp2.
// A template switch, so the sampling path (no lse) runs the same code as
// before.
template <bool kLse>
__global__ void __launch_bounds__(kFaThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v, bf16* __restrict__ out,
                           float* __restrict__ lse, int bh_count, int n, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sk = sq + kFaQTile;               // kFaStages tiles
  unsigned char* sv = sk + kFaStages * kFaTile;    // kFaStages tiles
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[kFaStages], v_full[kFaStages],
      kv_empty[kFaStages];

  const int ntiles = (n + kFaKeys - 1) / kFaKeys, qtiles = (n + kFaRows - 1) / kFaRows;
  const int nwork = qtiles * bh_count;
  // broadcast, so that ptxas sees the role branches as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    hopper::mbar_init(&q_empty, 4 * kFaWG);  // one arrival per consumer warp
    for (int s = 0; s < kFaStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&kv_empty[s], 4 * kFaWG);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int w = blockIdx.x; w < nwork; w += gridDim.x, q_phase ^= 1) {
        const int bh = w / qtiles, q0 = w % qtiles * kFaRows;
        // the previous work tile's last Q K^T is done with the Q buffer
        hopper::mbar_wait(&q_empty, q_phase ^ 1);
        hopper::mbar_expect_tx(&q_full, kFaQTile);
        hopper::tma_load_3d(sq, &tmap_q, &q_full, 0, q0, bh);
        for (int it = 0; it < ntiles; ++it) {
          hopper::mbar_wait(&kv_empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&k_full[stage], kFaTile);
          hopper::tma_load_3d(sk + stage * kFaTile, &tmap_k, &k_full[stage], 0, it * kFaKeys, bh);
          hopper::mbar_expect_tx(&v_full[stage], kFaTile);
          hopper::tma_load_3d(sv + stage * kFaTile, &tmap_v, &v_full[stage], 0, it * kFaKeys, bh);
          if (++stage == kFaStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    hopper::reg_alloc<160>();  // 3 x 128 x 160 + 128 x 24 <= 65,536
    const int c = wg - 1;  // query rows q0 + 64c ..
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const uint64_t dq = hopper::desc_sw128(sq + c * (kFaQTile / kFaWG), 16, 1024);
    // Accumulator layouts (column block j of 8): s[4j], s[4j+1] at row
    // 16 warp + g, columns 8j + 2t, +1; s[4j+2], s[4j+3] at row + 8; o alike.
    float s[64], o[32];
    uint32_t p[8][4];  // P in bf16, the A fragments of the 8 key steps of 16
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;

    // Turns: consumer warpgroup c issues its products after bar_sync(1 + c)
    // and then lets the next one issue (bar_arrive on its barrier); c = 0
    // goes first. The arrivals match the syncs: the last warpgroup skips its
    // very last one.
    if (c == kFaWG - 1) hopper::bar_arrive(1, 256);
    auto turn_end = [&](bool very_last) {
      if (c < kFaWG - 1 || !very_last) hopper::bar_arrive(1 + (c + 1) % kFaWG, 256);
    };
    float m0, m1, l0, l1;  // running max of rows g and g+8 (log2 units), this thread's row sums
    // The softmax of the S tile in s, up to P: masks keys past n (valid of
    // the tile's 128), updates m and l, leaves exp2(s scale - m) in s and
    // returns the factors (a0, a1) by which o must be rescaled.
    auto softmax = [&](int valid, float& a0, float& a1) {
      if (valid < kFaKeys) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * 8 + 2 * t + (e & 1) >= valid) s[4 * j + e] = -INFINITY;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      const float n1 = fmaxf(m1, quad_max(mx1) * scale_log2);
      a0 = fa_exp2(m0 - n0);
      a1 = fa_exp2(m1 - n1);
      m0 = n0;
      m1 = n1;
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = fa_exp2(fmaf(s[4 * j], scale_log2, -m0));
        s[4 * j + 1] = fa_exp2(fmaf(s[4 * j + 1], scale_log2, -m0));
        s[4 * j + 2] = fa_exp2(fmaf(s[4 * j + 2], scale_log2, -m1));
        s[4 * j + 3] = fa_exp2(fmaf(s[4 * j + 3], scale_log2, -m1));
        r0 += s[4 * j] + s[4 * j + 1];
        r1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + r0;
      l1 = l1 * a1 + r1;
    };
    // o rescaled, and P = s in bf16 as the A fragments: blocks 2kk and 2kk+1
    // form key step kk, a0 = (g, 2t), a1 = (g+8, 2t), a2 = (g, 8+2t), a3 = (g+8, 8+2t)
    auto to_p = [&](float a0, float a1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        p[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
        p[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
    };
    auto fence_all = [&]() {
      hopper::fence_regs(s);
      hopper::fence_regs(o);
#pragma unroll
      for (int i = 0; i < 8; ++i) hopper::fence_regs(p[i]);  // read by P V until its wait
    };

    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, q_phase ^= 1) {
      const int bh = w / qtiles, q0 = w % qtiles * kFaRows;
      const bool last_work = w + (int)gridDim.x >= nwork;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
      hopper::mbar_wait(&q_full, q_phase);
      int prev = 0;
      uint32_t prev_phase = 0;
      for (int it = 0; it < ntiles; ++it) {
        // S = Q K^T of this tile and O += P V of the previous one, issued
        // in this warpgroup's turn; then the softmax of S. (A warpgroup whose
        // rows all lie past n computes on zeros: skipping its work behind a
        // branch made ptxas serialise the wgmma pipeline, which cost more.)
        hopper::mbar_wait(&k_full[stage], phase);
        if (it > 0) hopper::mbar_wait(&v_full[prev], prev_phase);
        hopper::bar_sync(1 + c, 256);
        hopper::wgmma_fence();
        const uint64_t dk = hopper::desc_sw128(sk + stage * kFaTile, 16, 1024);
#pragma unroll
        for (int k = 0; k < 4; ++k) hopper::wgmma_m64n128k16_ss(s, dq + 2 * k, dk + 2 * k, k > 0);
        if (it > 0) {
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)  // V MN-major: 16 keys = 2 KB
            hopper::wgmma_m64n64k16_rs(
                o, p[kk], hopper::desc_sw128(sv + prev * kFaTile + kk * 2048, kFaTile, 1024), 1);
        }
        hopper::wgmma_commit();
        turn_end(last_work && it + 1 == ntiles);
        hopper::wgmma_wait<0>();
        fence_all();
        if (lane == 0) {
          if (it > 0) hopper::mbar_arrive(&kv_empty[prev]);
          if (it + 1 == ntiles) hopper::mbar_arrive(&q_empty);  // the next Q may load
        }
        float a0, a1;
        softmax(n - it * kFaKeys, a0, a1);
        to_p(a0, a1);
        prev = stage;
        prev_phase = phase;
        if (++stage == kFaStages) stage = 0, phase ^= 1;
      }
      hopper::mbar_wait(&v_full[prev], prev_phase);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_m64n64k16_rs(
            o, p[kk], hopper::desc_sw128(sv + prev * kFaTile + kk * 2048, kFaTile, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_all();
      if (lane == 0) hopper::mbar_arrive(&kv_empty[prev]);

      const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
      const int r0 = q0 + c * 64 + warp * 16 + g, r1 = r0 + 8;
      if (kLse && t == 0) {
        float* lb = lse + (long long)bh * n;
        if (r0 < n) lb[r0] = m0 + log2f(sum0);
        if (r1 < n) lb[r1] = m1 + log2f(sum1);
      }
      bf16* ob = out + (long long)bh * n * 64;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = i * 8 + 2 * t;
        if (r0 < n)
          *reinterpret_cast<uint32_t*>(ob + (long long)r0 * 64 + col) =
              pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        if (r1 < n)
          *reinterpret_cast<uint32_t*>(ob + (long long)r1 * 64 + col) =
              pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
    }
  }
}

// Tensor map of a contiguous (bh, n, 64) bf16 tensor, copied in boxes of
// `rows` rows of one (b, h).
cudaError_t tmap_rows64(CUtensorMap* map, const void* p, int bh, int n, int rows) {
  const cuuint64_t dims[3] = {64, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {64 * 2, (cuuint64_t)n * 64 * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return hopper::make_tmap_bf16(map, p, 3, dims, strides, box);
}

// The wgmma forward on contiguous (bh, n, 64) q, k, v and out; with lse
// (not null) also the (bh, n) fp32 log2 denominators.
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                         int n, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = tmap_rows64(&maps[i], ptrs[i], bh, n, i ? kFaKeys : kFaRows);
    if (e != cudaSuccess) return e;
  }
  auto kernel = lse ? flash_fwd_wgmma_kernel<true> : flash_fwd_wgmma_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFaSmem);
  if (e != cudaSuccess) return e;
  const long long work = (long long)(n + kFaRows - 1) / kFaRows * bh;
  const int sms = hopper::sm_count();
  const int grid = work < sms ? (int)work : sms;
  kernel<<<grid, kFaThreads, kFaSmem, stream>>>(maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse,
                                                bh, n, 1.4426950408889634f / 8.f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const AttnArgs& a, int bh, cudaStream_t stream) {
  constexpr int kSmem = Shape<D>::kSmemBytes;
  // Dynamic shared memory above 48 KB needs an opt-in, which CUDA keeps per
  // device: set it at every launch (cheap) so any card the caller picks has it.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + kBlock - 1) / kBlock, bh);
  flash_fwd_kernel<D, false><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const AttnArgs& a, int bh, int d, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16>(a, bh, s);
    case 64: return launch<64>(a, bh, s);
    case 72: return launch<72>(a, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

// Contiguous (bh, n, d) operands: one "head" per batch index.
Operand contiguous(const void* p, int n, int d) {
  return Operand{static_cast<const bf16*>(p), (long long)n * d, 0, d};
}

AttnArgs contiguous_args(const void* q, const void* k, const void* v, void* out, int n, int d) {
  return AttnArgs{contiguous(q, n, d), contiguous(k, n, d), contiguous(v, n, d),
                  contiguous(out, n, d), 1, n, 1.4426950408889634f / sqrtf((float)d)};
}

template <int kLanes>
void norm_rope_launch(const NormRopeArgs& a, bool norm, cudaStream_t s) {
  const dim3 grid((unsigned)((a.rows + 256 / kLanes - 1) / (256 / kLanes)), 2);
  if (norm) norm_rope_kernel<true, kLanes><<<grid, 256, 0, s>>>(a);
  else norm_rope_kernel<false, kLanes><<<grid, 256, 0, s>>>(a);
}

cudaError_t norm_rope(const NormRopeArgs& a, bool norm, cudaStream_t s) {
  const int lanes = a.d / 8;  // lanes a row needs: 4 columns of each half per lane
  if (a.d % 8 != 0 || lanes > 16) return cudaErrorInvalidValue;
  if (lanes <= 8) norm_rope_launch<8>(a, norm, s);  // d <= 64
  else norm_rope_launch<16>(a, norm, s);            // d = 72
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: replaces the two Pallas backward kernels of
// ldmae_tpu/ops/flash_attention.py, the custom VJPs of flash_attention
// (_flash_bwd_kernel, pallas_call at :151) and of
// flash_attention_rope_trainable (_flash_rope_bwd_kernel, pallas_call at :429).
//
// The TPU kernel holds a whole (N, d) head in VMEM per program and forms p,
// dv = p^T g, dp = g v^T, ds = p (dp - rowsum(dp p)), dq = ds k d^-1/2 and
// dk = ds^T q d^-1/2 at once, in fp32. K and V of a head do not fit in a
// block's shared memory here, so the work is split over key tiles, and no
// (N, N) tensor is written. Two designs, chosen by head dim:
//
// d = 64 (DiT B to 1p6B: the training path), single pass on wgmma and TMA
// (FlashAttention-3's decomposition), in the section "Backward at d = 64"
// below: the forward saves lse (flash_fwd_wgmma_kernel<true>) and its bf16
// output; a preprocess kernel forms delta = rowsum(g * o) from them and
// zeroes an fp32 dq accumulator; flash_bwd_wgmma_kernel does the 10 b h N^2
// d operations once, dq summed across key-tile blocks by atomic adds; a
// postprocess kernel scales dq (and applies the RoPE Jacobian) into bf16.
//
// d = 16 (VMAE) and 72 (DiT XL), three passes on mma.sync (this section),
// deterministic (no atomics):
//   1. statistics: the forward kernel (flash_fwd_kernel<D, true>) recomputes
//      the softmax row maximum and denominator as lse, and delta = rowsum(g *
//      o) = rowsum(dp * p), with o the fp32 output normalised by the fp32 row
//      sum; o itself is not written;
//   2. dK/dV: one block per (64-key tile, b*h), 16 keys per warp, its K and V
//      fragments in registers; it streams the 64-row q and g tiles
//      (double-buffered cp.async) and forms p^T = exp2(k q^T - lse), dp^T =
//      v g^T, dv += p^T g and dk += ds^T q;
//   3. dQ: one block per (64-query tile, b*h), its q and g fragments in
//      registers; it streams the K and V tiles and forms p, dp = g v^T and
//      dq += ds k.
// It does 18 b h N^2 d operations (the statistics pass repeats the
// forward's two products, and passes 2 and 3 both recompute q k^T and g
// v^T); at these head dims it runs in the VMAE's and XL's training only,
// which the port does not drive yet.
//
// Rounding (both designs): p and ds are rounded to bf16 as the A operand of
// the dv, dk and dq products; the TPU kernel keeps p, dp and ds in fp32. dq,
// dk, dv are fp32 until one rounding to bf16 at the end. delta comes from the
// forward's bf16 output at d = 64 and from its fp32 output here.
//
// RoPE (flash_attention_rope_trainable): q and k are rotated once by the
// forward's pre-pass (norm_rope_kernel, no norm) into bf16 scratch, as the
// TPU kernel rounds them; the kernels run on the rotated copies, and what
// writes dq and dk applies the transposed RoPE Jacobian J^T y = y cos +
// [(y sin)_2 | -(y sin)_1] in fp32 in the TPU kernel's op order (here
// through a shared-memory staging tile: column c pairs with c +- d/2, which
// another thread holds).

struct BwdArgs {
  const bf16 *q, *k, *v, *g;  // (bh, n, d) contiguous; q, k rotated with RoPE
  const float *lse, *delta;   // (bh, npad) from the statistics pass
  bf16 *dq, *dk, *dv;         // (bh, n, d) contiguous, written
  const float *cos, *sin;     // (n, d) fp32 half-split tables (kRope only)
  int n, npad;
  float scale_log2, scale;
};

template <int D>
struct BwdShape {
  static constexpr int kT = kBlock * Shape<D>::kLd;  // elements of one bf16 tile
  static constexpr int kSt = Shape<D>::kDK + 4;       // fp32 staging row stride
  // six bf16 tiles + lse and delta, two buffers of 64 each
  static constexpr int kSmemBytes = 6 * kT * 2 + 4 * kBlock * 4;
  static_assert(kBlock * kSt * 4 <= 4 * kT * 2, "the staging tile fits in four streamed tiles");
};

// The 64 x kDK fp32 accumulator of a block (warp w holds rows 16w..16w+15 in
// the mma C layout) times `mul`, written as bf16 to rows row0.. (< n) of out
// (row stride D) through the staging tile st, which may alias tiles the
// block has finished reading. With kRope, the transposed RoPE Jacobian at
// each row's position, in the TPU kernel's fp32 op order. Every thread of
// the block calls it.
template <int D, bool kRope>
__device__ __forceinline__ void store_rows(const float (&acc)[Shape<D>::kDK / 8][4], float mul,
                                           float* st, bf16* out, int row0, int n,
                                           const float* cos, const float* sin) {
  constexpr int kSt = BwdShape<D>::kSt, half = D / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  __syncthreads();  // every warp is done with the tiles st aliases
#pragma unroll
  for (int i = 0; i < Shape<D>::kDK / 8; ++i) {
    float* s0 = st + (warp * 16 + g) * kSt + i * 8 + 2 * t;
    s0[0] = acc[i][0] * mul;
    s0[1] = acc[i][1] * mul;
    s0[8 * kSt] = acc[i][2] * mul;
    s0[8 * kSt + 1] = acc[i][3] * mul;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    if (row >= n) continue;
    const float* sr = st + r * kSt;
    float y = sr[c];
    if (kRope) {
      const float* cs = cos + (size_t)row * D;
      const float* sn = sin + (size_t)row * D;
      const float rt = c < half ? __fmul_rn(sr[c + half], sn[c + half])
                                : -__fmul_rn(sr[c - half], sn[c - half]);
      y = __fadd_rn(__fmul_rn(y, cs[c]), rt);
    }
    out[(size_t)row * D + c] = __float2bfloat16_rn(y);
  }
}

// A fragments (16 rows x kDK) of this warp's rows of a row-major tile.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[Shape<D>::kDK / 16][4], const bf16* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < Shape<D>::kDK / 16; ++kk)
    ldsm_x4(f[kk][0], f[kk][1], f[kk][2], f[kk][3],
            smem_addr(tile + (warp * 16 + (lane & 15)) * Shape<D>::kLd + kk * 16 + (lane >> 4) * 8));
}

// c[8][4] += A (16 x kDK fragments) times the transpose of a 64-row tile:
// the B operand is the tile's rows (n index) over its columns (k index).
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[Shape<D>::kDK / 16][4],
                                        const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < Shape<D>::kDK / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              smem_addr(tile + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * Shape<D>::kLd + kk * 16 +
                        ((lane >> 3) & 1) * 8));
      mma_bf16_16816(c[2 * p], a[kk], b0, b1);
      mma_bf16_16816(c[2 * p + 1], a[kk], b2, b3);
    }
  }
}

// c[kDK/8][4] += A (16 x 64, four k-steps of packed bf16) times a 64-row
// tile read as the B operand (its rows are the k index), transposed on the
// way by ldmatrix.
template <int D>
__device__ __forceinline__ void mma_ab(float (&c)[Shape<D>::kDK / 8][4], const uint32_t (&a)[4][4],
                                       const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int p = 0; p < Shape<D>::kDK / 16; ++p) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(b0, b1, b2, b3,
                    smem_addr(tile + (j * 16 + (lane & 15)) * Shape<D>::kLd + p * 16 + (lane >> 4) * 8));
      mma_bf16_16816(c[2 * p], a[j], b0, b1);
      mma_bf16_16816(c[2 * p + 1], a[j], b2, b3);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_padding(bf16* tiles, int ntiles) {
  constexpr int kDK = Shape<D>::kDK, kLd = Shape<D>::kLd;
  if (kDK > D) {  // the copies write columns < D only; the padding stays zero
    for (int i = threadIdx.x; i < ntiles * kBlock * (kDK - D); i += kThreads)
      tiles[(i / (kDK - D)) * kLd + D + i % (kDK - D)] = __float2bfloat16_rn(0.f);
  }
}

// grid: (ceil(n / 64) key tiles, bh).
template <int D, bool kRope>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int kOBlocks = Shape<D>::kDK / 8, kT = BwdShape<D>::kT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kT;
  bf16* sq = sv + kT;      // two buffers
  bf16* sg = sq + 2 * kT;  // two buffers
  float* sl = reinterpret_cast<float*>(sg + 2 * kT);  // lse, two buffers of 64
  float* sd = sl + 2 * kBlock;                         // delta, two buffers of 64

  const int n = a.n;
  const long long off = (long long)blockIdx.y * n * D;
  const bf16* q = a.q + off;
  const bf16* go = a.g + off;
  const float* lse = a.lse + (long long)blockIdx.y * a.npad;
  const float* delta = a.delta + (long long)blockIdx.y * a.npad;
  const int k0 = blockIdx.x * kBlock;
  const int t = threadIdx.x % 4;
  const int ntiles = (n + kBlock - 1) / kBlock;

  zero_padding<D>(sk, 6);
  load_tile_async<D>(sk, a.k + off + (long long)k0 * D, D, n - k0);
  load_tile_async<D>(sv, a.v + off + (long long)k0 * D, D, n - k0);
  cp_async_commit();
  // q, g, lse and delta of query tile `it` into buffer `buf` (lse and delta
  // rows < npad are all written by the statistics pass)
  auto load_query_tile = [&](int it, int buf) {
    const int q0 = it * kBlock;
    load_tile_async<D>(sq + buf * kT, q + (long long)q0 * D, D, n - q0);
    load_tile_async<D>(sg + buf * kT, go + (long long)q0 * D, D, n - q0);
    for (int i = threadIdx.x; i < 2 * (kBlock / 4); i += kThreads) {
      const int which = i / (kBlock / 4), c = (i % (kBlock / 4)) * 4;
      cp_async16((which ? sd : sl) + buf * kBlock + c, (which ? delta : lse) + q0 + c);
    }
    cp_async_commit();
  };
  load_query_tile(0, 0);
  cp_async_wait<1>();  // the K and V tiles
  __syncthreads();

  uint32_t kf[Shape<D>::kDK / 16][4], vf[Shape<D>::kDK / 16][4];
  load_a_frags<D>(kf, sk);
  load_a_frags<D>(vf, sv);
  float dk[kOBlocks][4], dv[kOBlocks][4];
#pragma unroll
  for (int i = 0; i < kOBlocks; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const bf16* qt = sq + buf * kT;
    const bf16* gt = sg + buf * kT;
    const float* lt = sl + buf * kBlock;
    const float* dt = sd + buf * kBlock;
    if (it + 1 < ntiles) {
      load_query_tile(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory for every warp

    // S^T = K Q^T and dP^T = V G^T: this warp's 16 keys x 64 queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    mma_abt<D>(s, kf, qt);
    mma_abt<D>(dp, vf, gt);

    // P^T = exp2(S^T scale - lse) and dS^T = P^T (dP^T - delta), as bf16 A
    // operands; queries past n contribute nothing
    const int valid = n - it * kBlock;
    uint32_t pf[4][4], df[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + 2 * t + (e & 1);
        p[e] = col < valid ? exp2f(s[i][e] * a.scale_log2 - lt[col]) : 0.f;
        ds[e] = p[e] * (dp[i][e] - dt[col]);
      }
      pf[i / 2][(i % 2) * 2] = pack_bf16(p[0], p[1]);
      pf[i / 2][(i % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
      df[i / 2][(i % 2) * 2] = pack_bf16(ds[0], ds[1]);
      df[i / 2][(i % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_ab<D>(dv, pf, gt);  // dV += P^T G
    mma_ab<D>(dk, df, qt);  // dK += dS^T Q
    __syncthreads();  // this tile's buffers are consumed before they are refilled
  }
  float* st = reinterpret_cast<float*>(sq);
  store_rows<D, kRope>(dk, a.scale, st, a.dk + off, k0, n, a.cos, a.sin);
  store_rows<D, false>(dv, 1.f, st, a.dv + off, k0, n, nullptr, nullptr);
}

// grid: (ceil(n / 64) query tiles, bh).
template <int D, bool kRope>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int kOBlocks = Shape<D>::kDK / 8, kT = BwdShape<D>::kT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sg = sq + kT;
  bf16* sk = sg + kT;      // two buffers
  bf16* sv = sk + 2 * kT;  // two buffers

  const int n = a.n;
  const long long off = (long long)blockIdx.y * n * D;
  const bf16* k = a.k + off;
  const bf16* v = a.v + off;
  const int q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ntiles = (n + kBlock - 1) / kBlock;

  zero_padding<D>(sq, 6);
  load_tile_async<D>(sq, a.q + off + (long long)q0 * D, D, n - q0);
  load_tile_async<D>(sg, a.g + off + (long long)q0 * D, D, n - q0);
  cp_async_commit();
  load_tile_async<D>(sk, k, D, n);
  load_tile_async<D>(sv, v, D, n);
  cp_async_commit();
  cp_async_wait<1>();  // the q and g tiles
  __syncthreads();

  uint32_t qf[Shape<D>::kDK / 16][4], gf[Shape<D>::kDK / 16][4];
  load_a_frags<D>(qf, sq);
  load_a_frags<D>(gf, sg);
  const long long srow = (long long)blockIdx.y * a.npad + q0 + warp * 16 + g;  // rows < npad
  const float lse0 = a.lse[srow], lse1 = a.lse[srow + 8];
  const float del0 = a.delta[srow], del1 = a.delta[srow + 8];
  float dq[kOBlocks][4];
#pragma unroll
  for (int i = 0; i < kOBlocks; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int kv0 = it * kBlock;
    const bf16* kt = sk + (it & 1) * kT;
    const bf16* vt = sv + (it & 1) * kT;
    if (it + 1 < ntiles) {
      const long long next = kv0 + kBlock;
      load_tile_async<D>(sk + ((it + 1) & 1) * kT, k + next * D, D, n - kv0 - kBlock);
      load_tile_async<D>(sv + ((it + 1) & 1) * kT, v + next * D, D, n - kv0 - kBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = G V^T: this warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    mma_abt<D>(s, qf, kt);
    mma_abt<D>(dp, gf, vt);

    // dS = P (dP - delta), keys past n masked
    const int valid = n - kv0;
    uint32_t df[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + 2 * t + (e & 1);
        const float p = col < valid ? exp2f(s[i][e] * a.scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        ds[e] = p * (dp[i][e] - (e < 2 ? del0 : del1));
      }
      df[i / 2][(i % 2) * 2] = pack_bf16(ds[0], ds[1]);
      df[i / 2][(i % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_ab<D>(dq, df, kt);  // dQ += dS K
    __syncthreads();
  }
  store_rows<D, kRope>(dq, a.scale, reinterpret_cast<float*>(sk), a.dq + off, q0, n, a.cos, a.sin);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, bool kRope>
cudaError_t bwd_launch(const AttnArgs& stats, const BwdArgs& b, int bh, cudaStream_t s) {
  const dim3 grid((b.n + kBlock - 1) / kBlock, bh);
  constexpr int kFwd = Shape<D>::kSmemBytes, kBwd = BwdShape<D>::kSmemBytes;
  cudaError_t e = set_smem(flash_fwd_kernel<D, true>, kFwd);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<D, true><<<grid, kThreads, kFwd, s>>>(stats);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(flash_bwd_dkdv_kernel<D, kRope>, kBwd)) != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<D, kRope><<<grid, kThreads, kBwd, s>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(flash_bwd_dq_kernel<D, kRope>, kBwd)) != cudaSuccess) return e;
  flash_bwd_dq_kernel<D, kRope><<<grid, kThreads, kBwd, s>>>(b);
  return cudaGetLastError();
}

// d = 64 runs the single pass (backward64 below) instead
template <bool kRope>
cudaError_t bwd_dispatch(const AttnArgs& stats, const BwdArgs& b, int bh, int d, cudaStream_t s) {
  switch (d) {
    case 16: return bwd_launch<16, kRope>(stats, b, bh, s);
    case 72: return bwd_launch<72, kRope>(stats, b, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

// The three passes on contiguous (bh, n, d) q, k (rotated for RoPE), v, g.
template <bool kRope>
cudaError_t backward3(const void* q, const void* k, const void* v, const void* g, const float* cos,
                      const float* sin, void* dq, void* dk, void* dv, float* lse, float* delta,
                      int bh, int n, int d, cudaStream_t s) {
  const int npad = (n + kBlock - 1) / kBlock * kBlock;
  AttnArgs stats = contiguous_args(q, k, v, nullptr, n, d);
  stats.g = contiguous(g, n, d);
  stats.lse = lse;
  stats.delta = delta;
  stats.npad = npad;
  const BwdArgs b{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  cos, sin, n, npad, stats.scale_log2, 1.f / sqrtf((float)d)};
  return bwd_dispatch<kRope>(stats, b, bh, d, s);
}

// ---------------------------------------------------------------------------
// Backward at d = 64: flash_attention_bwd and flash_attention_rope_bwd on the
// DiT training path, FlashAttention-3's single pass on wgmma and TMA.
//
// What bounds it, at the DiT B/1 training shapes (b h N d = 32 12 1024 64):
// the five products are 10 b h N^2 d = 2.58e11 flops, 0.261 ms at 989
// TFLOP/s; q, k, v, g, o and lse in and dq, dk, dv out are 404 MB, 0.121 ms
// at 3.35 TB/s; the b h N^2 = 4.0e8 exponentials take 0.14 ms on the SFUs (16 a clock
// per SM). Operations bound it. The three-pass design above does 18 b h N^2
// d on mma.sync, which neither reaches the tensor cores' rate nor keeps them
// busy while the exponentials run, and the forward had to be run again
// because it saved no lse.
//
// Design:
//   * the forward (flash_fwd_wgmma_kernel<true>) writes lse, and the
//     autograd Functions save it and the bf16 output;
//   * flash_bwd_preprocess_kernel: delta = rowsum(g * o) in fp32 from the
//     bf16 o; lse copied into a row-padded (bh, npad) array with +inf past
//     n; the fp32 dq accumulator (bh, npad, 64) zeroed. One pass over g and
//     o, 8 lanes a row, 16-byte loads;
//   * flash_bwd_wgmma_kernel<kRope>: one block per (128-key tile, b h), the
//     key tiles of a head adjacent in the grid, so that all of them read the
//     head's q and g tiles from L2. Warpgroup 0 is the producer (setmaxnreg
//     24): one thread loads the block's K and V tiles once, then streams
//     64-query tiles of q and g (TMA, 128-byte swizzle, 3D tensor maps over
//     (bh, n, 64): rows past n arrive as zeros) with their lse and delta rows
//     (bulk copies) through a ring of kBwStages stages under full and empty
//     mbarriers. Warpgroups 1 and 2 own 64 keys each (setmaxnreg 240). Per
//     query tile a consumer issues S^T = K Q^T and dP^T = V G^T (m64n64k16,
//     both operands K-major in shared memory); forms P^T = exp2(S^T scale -
//     lse) (ex2.approx) while dP^T runs; issues dV += P^T G with P^T, in bf16,
//     as the register A operand and G read MN-major; forms dS^T = P^T (dP^T -
//     delta) while dV runs; issues dK += dS^T Q alike; stores dS^T in bf16
//     into a swizzled staging tile. After a named barrier between the two
//     consumers (each having fenced its generic stores for the async proxy),
//     each computes 32 of the 64 columns of dQ = dS K over the block's 128
//     keys (m64n32k16 with dS and K both read MN-major: the descriptors
//     transpose them), stages that part in shared memory and adds it into
//     the accumulator with one TMA bulk reduction (cp.reduce.async.bulk
//     .add.f32, FlashAttention-3's way), the accumulator laid out in such
//     8 KB parts (dq_part). The staging tiles are double-buffered, so one
//     barrier per tile also orders their reuse. Queries past n have lse =
//     +inf, so p = 0 and they add nothing; keys past n arrive as zeros, add
//     0 to dq, and their dk and dv rows are not stored: no branch surrounds
//     a product (in the forward, any branch there made ptxas serialise the
//     wgmma pipeline). The epilogue scales dK (and applies the RoPE
//     Jacobian, in registers: columns c and c + 32 lie in one thread) and
//     writes dK and dV in bf16 from registers;
//     What was tried on an H100 (PERF.md): without the dq adds the
//     backward ran about a quarter faster; per-thread vector atomics
//     (red.global.add.v2/.v4.f32) cost more than the bulk reduction;
//     staggering the blocks' query order gained nothing, and summing the
//     parts of pairs of key tiles in 2-CTA clusters (through distributed
//     shared memory, the merge even deferred by a tile) before one
//     reduction ran slower, though it halved the reduced bytes; issuing the
//     next tile's S^T and dP^T before waiting for dV and dK gained nothing;
//   * flash_bwd_postprocess_kernel<kRope>: dq = bf16(J^T(dq_acc d^-1/2)).
// The eight key-tile blocks of a head add into dq in an order that changes
// from run to run, so dq is not bitwise reproducible (dk and dv are).

constexpr int kBwKeys = 128;                   // keys per block, 64 per consumer warpgroup
constexpr int kBwQ = 64;                       // queries per streamed tile
constexpr int kBwStages = 3;                   // q/g ring depth
constexpr int kBwKTile = kBwKeys * 128;        // bytes of a K or V tile (rows of 64 bf16)
constexpr int kBwQTile = kBwQ * 128;           // bytes of a q or g tile
constexpr int kBwDsTile = kBwKeys * kBwQ * 2;  // bytes of a dS^T staging tile
constexpr int kBwDqPart = kBwQ * 32;           // fp32 values of a warpgroup's dQ part (64 x 32)
constexpr int kBwThreads = 384;
constexpr int kBwSmem = 2 * kBwKTile + 2 * kBwStages * kBwQTile + 2 * kBwDsTile + 4 * kBwDqPart * 4 +
                        2 * kBwStages * kBwQ * 4 + 1024;

// Offset in the dq accumulator of the dQ part (query tile qt, columns 32 c..)
// of (b, h) bh: the parts lie in the order (bh, query tile, c), each 64 rows
// of 32 values, row r's 8-value block j stored at block j ^ (r % 4) (so that
// the consumers' stores to its staging copy in shared memory hit every bank).
__host__ __device__ __forceinline__ long long dq_part(long long bh, int nq, int qt, int c) {
  return ((bh * nq + qt) * 2 + c) * kBwDqPart;
}

struct Bwd64Args {
  float* dq_acc;             // bh npad 64 fp32 as dQ parts (dq_part), zeroed; dq summed here
  bf16 *dk, *dv;             // (bh, n, 64), written
  const float *lse, *delta;  // (bh, npad): lse +inf and delta 0 past n
  const float *cos, *sin;    // (n, 64) fp32 half-split tables (kRope only)
  int n, npad;
  float scale_log2, scale;
};

// grid: (rows / 32, 256 threads), eight lanes a row; rows = bh * npad.
__global__ void __launch_bounds__(256)
    flash_bwd_preprocess_kernel(const bf16* __restrict__ go, const bf16* __restrict__ o,
                                const float* __restrict__ lse_fwd, float* __restrict__ lse,
                                float* __restrict__ delta, float* __restrict__ dq_acc, long long rows,
                                int n, int npad) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int j = threadIdx.x % 8;
  const long long bh = row / npad;
  const int r = (int)(row % npad);
  float acc = 0.f;
  if (row < rows && r < n) {
    const long long off = (bh * n + r) * 64 + 8 * j;
    const uint4 gu = *reinterpret_cast<const uint4*>(go + off);
    const uint4 ou = *reinterpret_cast<const uint4*>(o + off);
    const bf16* ge = reinterpret_cast<const bf16*>(&gu);
    const bf16* oe = reinterpret_cast<const bf16*>(&ou);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += __bfloat162float(ge[e]) * __bfloat162float(oe[e]);
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m, 8);
  if (row >= rows) return;
  float4* z = reinterpret_cast<float4*>(dq_acc + row * 64 + 8 * j);
  z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j == 0) {
    delta[row] = acc;
    lse[row] = r < n ? lse_fwd[bh * n + r] : INFINITY;
  }
}

// grid: (ceil(n / 128), bh); see the note above.
template <bool kRope>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __grid_constant__ CUtensorMap tmap_g, const Bwd64Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sv = sk + kBwKTile;
  unsigned char* sq = sv + kBwKTile;                 // kBwStages tiles
  unsigned char* sg = sq + kBwStages * kBwQTile;     // kBwStages tiles
  unsigned char* sds = sg + kBwStages * kBwQTile;    // two dS^T staging tiles
  float* sdq = reinterpret_cast<float*>(sds + 2 * kBwDsTile);  // dQ parts, two per consumer
  float* sl = sdq + 4 * kBwDqPart;                             // lse rows, kBwStages x kBwQ
  float* sd = sl + kBwStages * kBwQ;                           // delta rows, likewise
  __shared__ __align__(8) uint64_t kv_full, full[kBwStages], empty[kBwStages];

  const int n = a.n, bh = blockIdx.y, k0 = blockIdx.x * kBwKeys;
  const int nq = a.npad / kBwQ;
  // broadcast, so that ptxas sees the role branches as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int s = 0; s < kBwStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(&kv_full, 2 * kBwKTile);
      hopper::tma_load_3d(sk, &tmap_k, &kv_full, 0, k0, bh);
      hopper::tma_load_3d(sv, &tmap_v, &kv_full, 0, k0, bh);
      const long long row0 = (long long)bh * a.npad;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < nq; ++it) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_expect_tx(&full[stage], 2 * kBwQTile + 2 * kBwQ * 4);
        const int q0 = it * kBwQ;
        hopper::tma_load_3d(sq + stage * kBwQTile, &tmap_q, &full[stage], 0, q0, bh);
        hopper::tma_load_3d(sg + stage * kBwQTile, &tmap_g, &full[stage], 0, q0, bh);
        hopper::bulk_load(sl + stage * kBwQ, a.lse + row0 + q0, kBwQ * 4, &full[stage]);
        hopper::bulk_load(sd + stage * kBwQ, a.delta + row0 + q0, kBwQ * 4, &full[stage]);
        if (++stage == kBwStages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  hopper::reg_alloc<240>();  // 2 x 128 x 240 + 128 x 24 <= 65,536
  const int c = wg - 1;      // keys k0 + 64c ..
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint64_t kdesc = hopper::desc_sw128(sk + c * (kBwKTile / 2), 16, 1024);
  const uint64_t vdesc = hopper::desc_sw128(sv + c * (kBwKTile / 2), 16, 1024);
  const float scale_log2 = a.scale_log2;
  // Accumulator layouts (column block j of 8): x[4j], x[4j+1] at row 16 warp
  // + g, columns 8j + 2t, +1; x[4j+2], x[4j+3] at row + 8. Rows of s, dp, dk,
  // dv are this warpgroup's keys; columns of s, dp are the tile's queries,
  // of dk, dv the head dim. Rows of dq are the tile's queries, its columns
  // 32c + 8j + 2t.
  float dk[32], dv[32], s[32], dp[32], dq[16];
  uint32_t pf[4][4], df[4][4];  // P^T and dS^T in bf16: the A fragments of 4 query steps of 16
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dq[i] = 0.f;
  // the staging row of this thread's first key (16-byte chunk j of row r is
  // stored at chunk j ^ (r % 8), TMA's and wgmma's 128-byte swizzle)
  const int srow = c * 64 + warp * 16 + g;
  auto fence_all = [&]() {
    hopper::fence_regs(dq);
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // read by dV and dK until their wait
      hopper::fence_regs(pf[i]);
      hopper::fence_regs(df[i]);
    }
  };

  hopper::mbar_wait(&kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < nq; ++it) {
    hopper::mbar_wait(&full[stage], phase);
    const unsigned char* qt = sq + stage * kBwQTile;
    const unsigned char* gt = sg + stage * kBwQTile;
    const float* lt = sl + stage * kBwQ;
    const float* dt = sd + stage * kBwQ;
    unsigned char* st = sds + (it & 1) * kBwDsTile;
    const uint64_t qdesc = hopper::desc_sw128(qt, 16, 1024);
    const uint64_t gdesc = hopper::desc_sw128(gt, 16, 1024);

    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_ss(s, kdesc + 2 * k, qdesc + 2 * k, k > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_ss(dp, vdesc + 2 * k, gdesc + 2 * k, k > 0);
    hopper::wgmma_commit();

    // P^T = exp2(S^T scale - lse) while dP^T runs
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
      s[4 * j] = fa_exp2(fmaf(s[4 * j], scale_log2, -l.x));
      s[4 * j + 1] = fa_exp2(fmaf(s[4 * j + 1], scale_log2, -l.y));
      s[4 * j + 2] = fa_exp2(fmaf(s[4 * j + 2], scale_log2, -l.x));
      s[4 * j + 3] = fa_exp2(fmaf(s[4 * j + 3], scale_log2, -l.y));
      pf[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    // dV += P^T G, G MN-major: 16 queries = 2 KB
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_rs(dv, pf[kk], hopper::desc_sw128(gt + kk * 2048, kBwQTile, 1024), 1);
    hopper::wgmma_commit();

    // dS^T = P^T (dP^T - delta) while dV runs; into df and the staging tile
    hopper::wgmma_wait<1>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(dt + 8 * j + 2 * t);
      const uint32_t lo = pack_bf16(s[4 * j] * (dp[4 * j] - dl.x), s[4 * j + 1] * (dp[4 * j + 1] - dl.y));
      const uint32_t hi =
          pack_bf16(s[4 * j + 2] * (dp[4 * j + 2] - dl.x), s[4 * j + 3] * (dp[4 * j + 3] - dl.y));
      df[j / 2][(j % 2) * 2] = lo;
      df[j / 2][(j % 2) * 2 + 1] = hi;
      *reinterpret_cast<uint32_t*>(st + srow * 128 + ((j ^ (srow & 7)) << 4) + 4 * t) = lo;
      *reinterpret_cast<uint32_t*>(st + (srow + 8) * 128 + ((j ^ ((srow + 8) & 7)) << 4) + 4 * t) = hi;
    }
    // dK += dS^T Q, Q MN-major
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_rs(dk, df[kk], hopper::desc_sw128(qt + kk * 2048, kBwQTile, 1024), 1);
    hopper::wgmma_commit();

    // dQ[:, 32c..] = dS K over the block's 128 keys, once both consumers'
    // dS^T rows are in the staging tile: dS^T and K both MN-major, 16 keys
    // = 2 KB, this warpgroup's 32 columns 64 bytes into K's rows
    hopper::fence_proxy_async();
    hopper::bar_sync(1, 256);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      hopper::wgmma_m64n32k16_ss_tt(dq, hopper::desc_sw128(st + kk * 2048, kBwDsTile, 1024),
                                    hopper::desc_sw128(sk + kk * 2048 + c * 64, kBwKTile, 1024), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_all();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);  // q, g, lse, delta of this stage are read

    // The dQ part into the accumulator: staged in shared memory (two
    // buffers a warpgroup), then one bulk reduction. The leader's wait before
    // the barrier makes sure the previous tile's reduction has read the
    // other buffer, which the next tile writes.
    float* part = sdq + (c * 2 + (it & 1)) * kBwDqPart;
    const int row = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int blk = 8 * (j ^ (row & 3)) + 2 * t;  // rows row and row + 8 swizzle alike
      *reinterpret_cast<float2*>(part + row * 32 + blk) = make_float2(dq[4 * j], dq[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (row + 8) * 32 + blk) = make_float2(dq[4 * j + 2], dq[4 * j + 3]);
    }
    hopper::fence_proxy_async();
    const bool leader = threadIdx.x % 128 == 0;
    if (leader) hopper::bulk_wait_read<0>();
    hopper::bar_sync(2 + c, 128);
    if (leader) {
      hopper::bulk_reduce_add_f32(a.dq_acc + dq_part(bh, nq, it, c), part, kBwDqPart * 4);
      hopper::bulk_commit();
    }
    if (++stage == kBwStages) stage = 0, phase ^= 1;
  }
  if (threadIdx.x % 128 == 0) hopper::bulk_wait<0>();  // the reductions are done with shared memory

  // dV, and dK d^-1/2 (with kRope J^T of it), in bf16 for keys < n
  const int r0 = k0 + srow, r1 = r0 + 8;
  bf16* dvb = a.dv + (long long)bh * n * 64;
  bf16* dkb = a.dk + (long long)bh * n * 64;
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] *= a.scale;
  if (kRope) {
    // columns c < 32 pair with c + 32 (block j with j + 4), in this thread:
    // out_lo = y_lo cos_lo + y_hi sin_hi, out_hi = y_hi cos_hi - y_lo sin_lo
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? r1 : r0;
      if (row >= n) continue;
      const float* cs = a.cos + (size_t)row * 64;
      const float* sn = a.sin + (size_t)row * 64;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 c1 = *reinterpret_cast<const float2*>(cs + col);
        const float2 c2 = *reinterpret_cast<const float2*>(cs + col + 32);
        const float2 s1 = *reinterpret_cast<const float2*>(sn + col);
        const float2 s2 = *reinterpret_cast<const float2*>(sn + col + 32);
        float& y1a = dk[4 * j + 2 * h];
        float& y1b = dk[4 * j + 2 * h + 1];
        float& y2a = dk[4 * (j + 4) + 2 * h];
        float& y2b = dk[4 * (j + 4) + 2 * h + 1];
        const float o1a = __fadd_rn(__fmul_rn(y1a, c1.x), __fmul_rn(y2a, s2.x));
        const float o1b = __fadd_rn(__fmul_rn(y1b, c1.y), __fmul_rn(y2b, s2.y));
        const float o2a = __fadd_rn(__fmul_rn(y2a, c2.x), -__fmul_rn(y1a, s1.x));
        const float o2b = __fadd_rn(__fmul_rn(y2b, c2.y), -__fmul_rn(y1b, s1.y));
        y1a = o1a, y1b = o1b, y2a = o2a, y2b = o2b;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(dvb + (long long)r0 * 64 + col) = pack_bf16(dv[4 * j], dv[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dkb + (long long)r0 * 64 + col) = pack_bf16(dk[4 * j], dk[4 * j + 1]);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(dvb + (long long)r1 * 64 + col) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(dkb + (long long)r1 * 64 + col) =
          pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
    }
  }
}

// grid: (ceil(rows / 32), 256 threads); rows = bh * n. Eight lanes a row,
// lane j owning columns 4j..4j+3 and their RoPE partners 4j+32..4j+35.
template <bool kRope>
__global__ void __launch_bounds__(256)
    flash_bwd_postprocess_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                                 const float* __restrict__ cos, const float* __restrict__ sin,
                                 long long rows, int n, int npad, float scale) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  if (row >= rows) return;
  const int c = 4 * (threadIdx.x % 8), r = (int)(row % n), rr = r % kBwQ;
  // columns c.. of the part of columns 0..31, and of the part of 32..63
  const float* src = dq_acc + dq_part(row / n, npad / kBwQ, r / kBwQ, 0) + rr * 32 + 8 * ((c / 8) ^ (rr & 3)) + c % 8;
  float y1[4], y2[4];
  load4(y1, src);
  load4(y2, src + kBwDqPart);
#pragma unroll
  for (int e = 0; e < 4; ++e) y1[e] *= scale, y2[e] *= scale;
  if (kRope) {
    float c1[4], c2[4], s1[4], s2[4];
    load4(c1, cos + (size_t)r * 64 + c);
    load4(c2, cos + (size_t)r * 64 + c + 32);
    load4(s1, sin + (size_t)r * 64 + c);
    load4(s2, sin + (size_t)r * 64 + c + 32);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float o1 = __fadd_rn(__fmul_rn(y1[e], c1[e]), __fmul_rn(y2[e], s2[e]));
      const float o2 = __fadd_rn(__fmul_rn(y2[e], c2[e]), -__fmul_rn(y1[e], s1[e]));
      y1[e] = o1, y2[e] = o2;
    }
  }
  bf16* out = dq + row * 64;
  *reinterpret_cast<uint2*>(out + c) = make_uint2(pack_bf16(y1[0], y1[1]), pack_bf16(y1[2], y1[3]));
  *reinterpret_cast<uint2*>(out + c + 32) = make_uint2(pack_bf16(y2[0], y2[1]), pack_bf16(y2[2], y2[3]));
}

// The single pass at d = 64 on contiguous (bh, n, 64) q, k (rotated for
// RoPE), v, g, o; lse_fwd (bh, n) from the forward; lse, delta (bh, npad)
// and dq_acc (bh, npad, 64) fp32 scratch.
template <bool kRope>
cudaError_t backward64(const void* q, const void* k, const void* v, const void* g, const void* o,
                       const float* lse_fwd, const float* cos, const float* sin, void* dq, void* dk,
                       void* dv, float* lse, float* delta, float* dq_acc, int bh, int n,
                       cudaStream_t s) {
  if (o == nullptr || lse_fwd == nullptr || dq_acc == nullptr) return cudaErrorInvalidValue;
  const int npad = (n + kBwQ - 1) / kBwQ * kBwQ;
  const long long prow = (long long)bh * npad;
  flash_bwd_preprocess_kernel<<<(unsigned)((prow + 31) / 32), 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), lse_fwd, lse, delta, dq_acc, prow, n,
      npad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if ((e = tmap_rows64(&maps[i], ptrs[i], bh, n, i == 1 || i == 2 ? kBwKeys : kBwQ)) != cudaSuccess)
      return e;
  if ((e = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<kRope>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kBwSmem)) != cudaSuccess)
    return e;
  const Bwd64Args a{dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, delta, cos, sin, n,
                    npad, 1.4426950408889634f / 8.f, 0.125f};
  const dim3 grid((n + kBwKeys - 1) / kBwKeys, bh);
  flash_bwd_wgmma_kernel<kRope><<<grid, kBwThreads, kBwSmem, s>>>(maps[0], maps[1], maps[2], maps[3], a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long rows = (long long)bh * n;
  flash_bwd_postprocess_kernel<kRope><<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(
      dq_acc, static_cast<bf16*>(dq), cos, sin, rows, n, npad, 0.125f);
  return cudaGetLastError();
}

// The backward on contiguous (bh, n, d) operands: the single pass at d = 64,
// the three passes at the other head dims (o, lse_fwd, dq_acc unused there).
template <bool kRope>
cudaError_t backward(const void* q, const void* k, const void* v, const void* g, const void* o,
                     const float* lse_fwd, const float* cos, const float* sin, void* dq, void* dk,
                     void* dv, float* lse, float* delta, float* dq_acc, int bh, int n, int d,
                     cudaStream_t s) {
  if (d == 64)
    return backward64<kRope>(q, k, v, g, o, lse_fwd, cos, sin, dq, dk, dv, lse, delta, dq_acc, bh, n, s);
  return backward3<kRope>(q, k, v, g, cos, sin, dq, dk, dv, lse, delta, bh, n, d, s);
}

}  // namespace

// q, k, v, out: contiguous (bh, n, d) bf16; lse: null, or at d = 64 the
// (bh, n) fp32 log2 softmax denominators the backward takes (written). d =
// 64 (DiT B, 1p0B, 1p6B) runs the wgmma kernel; the other head dims the
// mma.sync core (d = 16, VMAE; d = 72, DiT XL: a 144-byte row is no 128-byte
// swizzle row, and Q K^T would need d padded to 80). Returns the CUDA error
// of the launch (0 on success).
extern "C" int ldmae_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int bh, int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return static_cast<int>(launch_wgmma(q, k, v, out, lse, bh, n, s));
  if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(contiguous_args(q, k, v, out, n, d), bh, d, s));
}

// As above with half-split RoPE: cos, sin are contiguous (n, d) fp32 tables;
// qr, kr are (bh, n, d) bf16 scratch that receive the rotated q and k.
extern "C" int ldmae_flash_attention_rope_fwd(const void* q, const void* k, const void* v,
                                              const float* cos, const float* sin, void* qr,
                                              void* kr, void* out, float* lse, int bh, int n, int d,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  NormRopeArgs a{{contiguous(q, n, d), contiguous(k, n, d)},
                 {contiguous(qr, n, d), contiguous(kr, n, d)},
                 {nullptr, nullptr}, cos, sin, (long long)bh * n, 1, n, d, 0.f};
  const cudaError_t e = norm_rope(a, false, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return ldmae_flash_attention_fwd(qr, kr, v, out, lse, bh, n, d, stream);
}

// As flash_attention_rope with the per-head RMS qk-norm first: qw, kw are
// the (d,) fp32 norm weights of q and k, eps the norm's epsilon.
extern "C" int ldmae_flash_attention_qknorm_rope_fwd(const void* q, const void* k, const void* v,
                                                     const float* qw, const float* kw,
                                                     const float* cos, const float* sin, void* qr,
                                                     void* kr, void* out, int bh, int n, int d,
                                                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  NormRopeArgs a{{contiguous(q, n, d), contiguous(k, n, d)},
                 {contiguous(qr, n, d), contiguous(kr, n, d)},
                 {qw, kw}, cos, sin, (long long)bh * n, 1, n, d, eps};
  const cudaError_t e = norm_rope(a, true, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(dispatch(contiguous_args(qr, kr, v, out, n, d), bh, d, s));
}

// RoPE + attention in the (b, n, h * d) layout: q, k, v rows of token t are
// at q + (bi * n + t) * q_rs (element row strides; v typically a view of the
// packed qkv), head hi at + hi * d. qr, kr (scratch) and out are contiguous
// (b, n, h * d). cos, sin: contiguous (n, d) fp32.
extern "C" int ldmae_flash_attention_fused_rope_fwd(
    const void* q, const void* k, const void* v, const float* cos, const float* sin, void* qr,
    void* kr, void* out, int b, int h, int n, int d, long long q_rs, long long k_rs,
    long long v_rs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hd = (long long)h * d;
  auto rows = [&](const void* p, long long rs) {
    return Operand{static_cast<const bf16*>(p), n * rs, d, static_cast<int>(rs)};
  };
  NormRopeArgs a{{rows(q, q_rs), rows(k, k_rs)},
                 {rows(qr, hd), rows(kr, hd)},
                 {nullptr, nullptr}, cos, sin, (long long)b * h * n, h, n, d, 0.f};
  const cudaError_t e = norm_rope(a, false, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const AttnArgs args{rows(qr, hd), rows(kr, hd), rows(v, v_rs), rows(out, hd), h, n,
                      1.4426950408889634f / sqrtf((float)d)};
  return static_cast<int>(dispatch(args, b * h, d, s));
}

// Backward of ldmae_flash_attention_fwd: q, k, v, g (the output's gradient)
// contiguous (bh, n, d) bf16; dq, dk, dv written likewise; lse, delta are
// (bh, npad) fp32 scratch with npad = n rounded up to a multiple of 64. At d
// = 64, o is the forward's output, lse_fwd its (bh, n) lse, and dq_acc
// (bh, npad, 64) fp32 scratch; the other head dims ignore the three.
extern "C" int ldmae_flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                         const void* o, const float* lse_fwd, void* dq, void* dk,
                                         void* dv, float* lse, float* delta, float* dq_acc, int bh,
                                         int n, int d, void* stream) {
  return static_cast<int>(backward<false>(q, k, v, g, o, lse_fwd, nullptr, nullptr, dq, dk, dv, lse,
                                          delta, dq_acc, bh, n, d, static_cast<cudaStream_t>(stream)));
}

// Backward of ldmae_flash_attention_rope_fwd: as above with the (n, d) fp32
// half-split tables cos, sin, and qr, kr (bh, n, d) bf16 scratch that
// receive the rotated q and k; dq and dk are the gradients of the unrotated
// q and k.
extern "C" int ldmae_flash_attention_rope_bwd(const void* q, const void* k, const void* v,
                                              const void* g, const void* o, const float* lse_fwd,
                                              const float* cos, const float* sin, void* qr, void* kr,
                                              void* dq, void* dk, void* dv, float* lse, float* delta,
                                              float* dq_acc, int bh, int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  NormRopeArgs a{{contiguous(q, n, d), contiguous(k, n, d)},
                 {contiguous(qr, n, d), contiguous(kr, n, d)},
                 {nullptr, nullptr}, cos, sin, (long long)bh * n, 1, n, d, 0.f};
  const cudaError_t e = norm_rope(a, false, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(backward<true>(qr, kr, v, g, o, lse_fwd, cos, sin, dq, dk, dv, lse, delta,
                                         dq_acc, bh, n, d, s));
}
