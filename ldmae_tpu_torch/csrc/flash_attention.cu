// Flash attention for Hopper (sm_90a), bf16 in and out, non-causal: four
// forward kernels here, the two backward kernels in the section "Backward"
// below (its own note says what bounds them and where they round).
//
// The forward replaces four Pallas TPU kernels of ldmae_tpu/ops/flash_attention.py:
//   * flash_attention_rope (_flash_rope_bhnd_kernel): half-split RoPE on q and
//     k in fp32, cast back to bf16, then attention (DiT sampling, d = 64);
//   * flash_attention forward (_flash_fwd_kernel): the same without RoPE, any
//     sequence length (VMAE decoder, d = 16; VMAE archs from d = 8 to 80);
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
// Any head dim 1 <= d <= 128: the core is instantiated for the classes DK =
// 16, 32, .., 128 (d rounded up to the mma depth, padded with zeros in
// shared memory), d itself a run-time value; rows are copied 16, 8 or 4
// bytes at a time by cp.async, or 2 by plain loads for an odd d, whatever
// their alignment allows (the wrapper passes it as `vec`). A ragged last
// tile (N not a multiple of 64) is zero-filled and its keys masked to -inf.
// The fp32 kernels are in flash_attention_fp32.cu.
//
// Which kernel runs is chosen by shape (forward()): all four forward
// kernels at d = 64 and 72 (DiT B to 1p6B, and XL) with 16-byte aligned rows
// and strides run a second core,
// flash_fwd_wgmma_kernel (wgmma, TMA, warp-specialised; its own note
// below), which reads every operand through a 4D tensor map of its own
// strides: flash_attention and flash_attention_rope on contiguous (B, H, N,
// d), writing the softmax's lse for the backward when asked;
// flash_attention_qknorm_rope on its pre-pass's contiguous scratch, v read
// in place (contiguous, or the permuted view of the packed qkv);
// flash_attention_fused_rope on its pre-pass's scratch, v read in place as
// the strided view of the packed qkv, the output written as (B, N, H*d)
// rows. flash_attention without lse at d = 8 or 16 and N <= 3,072, and
// with lse at d = 16 (under autograd, for the single-pass backward), runs
// flash_fwd_resident_kernel (wgmma, K and V of a head resident in shared
// memory; its own note below). Every other shape (other head dims,
// misaligned rows) runs this one, as does the backward's statistics pass.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using attn::quad_max;
using attn::quad_sum;
using attn::load4;
using Operand = attn::Operand<bf16>;
using NormRopeArgs = attn::NormRopeArgs<bf16>;

constexpr int kBlock = 64;  // query rows per block (16 per warp) = key/value rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// The mma.sync core is instantiated for head-dim classes DK = 16, 32, .., 128
// (the head dim d rounded up to the mma depth); d itself is a run-time value.
template <int DK>
struct Shape {
  static constexpr int kDK = DK;
  static constexpr int kLd = DK + 8;  // smem row stride in bf16: 16-byte rows,
                                      // consecutive rows on other banks
  // q tile + two K and two V tiles
  static constexpr int kSmemBytes = 5 * kBlock * kLd * 2;
  // Blocks per SM the register budget must allow: four fit the shared memory
  // (46 KB each at d = 64) if a thread keeps to 128 registers; without the
  // bound the strided indexing took d = 64 to 132 registers and three blocks.
  static constexpr int kMinBlocks = DK <= 64 ? 4 : (DK <= 80 ? 3 : 2);
};

// The head-dim class of d (1 <= d <= 128).
inline int head_class(int d) { return (d + 15) / 16 * 16; }

struct AttnArgs {
  Operand q, k, v, o;  // o.p is written
  int heads, n;
  float scale_log2;
  int d;    // head dim (<= the class DK)
  int vec;  // elements (8, 4, 2 or 1) every row start and stride is aligned to
  // The backward's statistics pass (flash_fwd_kernel<DK, true>) writes, in
  // place of o, per query row r of program bh: lse[bh * npad + r] = log2 of
  // the softmax denominator in the kernel's log2 units (running max
  // included) and delta[bh * npad + r] = rowsum(g * o) with o the fp32
  // normalised output; rows n <= r < npad get 0.
  Operand g;
  float* lse;
  float* delta;
  int npad;
};

// Asynchronous copy of a 64-row tile of d columns (row stride ld elements in
// global) into shared memory (row stride kLd); rows >= valid are zero-
// filled. vec elements per copy: 16-, 8- or 4-byte cp.async, or plain 2-byte
// loads and stores for rows of an odd head dim. A full class (d == DK) with
// 16-byte copies takes the loop with compile-time bounds, as before the
// classes.
template <int DK>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int ld, int valid, int d, int vec) {
  constexpr int kLd = Shape<DK>::kLd;
  if (vec == 8 && d == DK) {
    constexpr int kVecs = DK / 8;
    for (int i = threadIdx.x; i < kBlock * kVecs; i += kThreads) {
      const int r = i / kVecs, c = (i % kVecs) * 8;
      const int rr = r < valid ? r : 0;  // a valid address; nothing is read when r >= valid
      cp_async16_zfill(s + r * kLd + c, g + (long long)rr * ld + c, r < valid ? 16 : 0);
    }
  } else if (vec >= 2) {
    const int nv = d / vec;
    for (int i = threadIdx.x; i < kBlock * nv; i += kThreads) {
      const int r = i / nv, c = (i % nv) * vec;
      const int rr = r < valid ? r : 0;
      const bf16* src = g + (long long)rr * ld + c;
      const int bytes = r < valid ? 2 * vec : 0;
      if (vec == 8) cp_async16_zfill(s + r * kLd + c, src, bytes);
      else if (vec == 4) cp_async8_zfill(s + r * kLd + c, src, bytes);
      else cp_async4_zfill(s + r * kLd + c, src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < kBlock * d; i += kThreads) {
      const int r = i / d, c = i % d;
      s[r * kLd + c] = r < valid ? g[(long long)r * ld + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// Zeroes columns d..DK-1 of `tiles` consecutive tiles: the copies write
// columns < d only, so the padding the products read stays zero.
template <int DK>
__device__ __forceinline__ void zero_padding(bf16* tiles, int ntiles, int d) {
  constexpr int kLd = Shape<DK>::kLd;
  const int pad = DK - d;
  if (pad > 0) {
    for (int i = threadIdx.x; i < ntiles * kBlock * pad; i += kThreads)
      tiles[(i / pad) * kLd + d + i % pad] = __float2bfloat16_rn(0.f);
  }
}

// Two values of columns col, col + 1 of a row at p (col even): one 4-byte
// store when d is even (col < d implies col + 1 < d, and the row is 4-byte
// aligned), else element by element.
__device__ __forceinline__ void store_pair(bf16* p, int col, int d, float x0, float x1) {
  if ((d & 1) == 0) {
    if (col < d) *reinterpret_cast<uint32_t*>(p + col) = pack_bf16(x0, x1);
  } else {
    if (col < d) p[col] = __float2bfloat16_rn(x0);
    if (col + 1 < d) p[col + 1] = __float2bfloat16_rn(x1);
  }
}

__device__ __forceinline__ float2 load_pair(const bf16* p, int col, int d) {
  if ((d & 1) == 0) {
    if (col >= d) return make_float2(0.f, 0.f);
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p + col);
    return make_float2(__low2float(v), __high2float(v));
  }
  return make_float2(col < d ? __bfloat162float(p[col]) : 0.f, col + 1 < d ? __bfloat162float(p[col + 1]) : 0.f);
}

// grid: (ceil(n / 64), batch * heads). With kStats, the backward's
// statistics pass: the same forward, whose epilogue writes lse and delta
// (AttnArgs) instead of the output.
template <int DK, bool kStats>
__global__ void __launch_bounds__(kThreads, Shape<DK>::kMinBlocks) flash_fwd_kernel(const AttnArgs a) {
  constexpr int kDK = Shape<DK>::kDK;
  constexpr int kLd = Shape<DK>::kLd;
  constexpr int kKSteps = kDK / 16;  // mma steps over the head dim
  constexpr int kOBlocks = kDK / 8;  // 8-wide output column blocks
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kBlock * kLd;      // two buffers
  bf16* sv = sk + 2 * kBlock * kLd;  // two buffers

  const int n = a.n, d = a.d, vec = a.vec;
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

  zero_padding<DK>(sq, 5, d);
  load_tile_async<DK>(sq, q + (long long)q0 * a.q.sr, a.q.sr, n - q0, d, vec);
  cp_async_commit();
  load_tile_async<DK>(sk, k, a.k.sr, n, d, vec);
  load_tile_async<DK>(sv, v, a.v.sr, n, d, vec);
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
      load_tile_async<DK>(sk + ((it + 1) & 1) * kBlock * kLd, k + next * a.k.sr, a.k.sr,
                          n - kv0 - kBlock, d, vec);
      load_tile_async<DK>(sv + ((it + 1) & 1) * kBlock * kLd, v + next * a.v.sr, a.v.sr,
                          n - kv0 - kBlock, d, vec);
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
      if (col >= d) continue;
      if (r0 < n) {
        const float2 gv = load_pair(gp + (long long)r0 * a.g.sr, col, d);
        d0 += gv.x * (o[i][0] * inv0) + gv.y * (o[i][1] * inv0);
      }
      if (r1 < n) {
        const float2 gv = load_pair(gp + (long long)r1 * a.g.sr, col, d);
        d1 += gv.x * (o[i][2] * inv1) + gv.y * (o[i][3] * inv1);
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
    if (r0 < n) store_pair(out + (long long)r0 * a.o.sr, col, d, o[i][0] * inv0, o[i][1] * inv0);
    if (r1 < n) store_pair(out + (long long)r1 * a.o.sr, col, d, o[i][2] * inv1, o[i][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// The forward at d = 64 and d = 72 on wgmma and TMA: the main path's
// attention (DiT sampling, and the training forward; d = 72 is DiT XL's
// head dim) and the two opt-in kernels. With the RoPE pre-pass above it
// replaces _flash_rope_bhnd_kernel (ldmae_tpu/ops/flash_attention.py,
// pallas_call at :323), without it _flash_fwd_kernel (:77) at these head
// dims, with the qk-norm pre-pass _flash_qknorm_rope_kernel (:282), and on
// (B, N, H*d) rows _flash_rope_kernel (:550); it computes what
// flash_fwd_kernel<DK, false> does, with the same roundings (p to bf16
// before it is normalised), the logits scaled inside the exponent's FMA,
// exp2 by the SFU's ex2.approx. Shapes: (16 or 72, 12, 1024, 64) for all
// four in sampling at batch 8 or 36, (32, 12, 1024, 64) with lse in
// training; XL (16, 16, 1024, 72) and (32, 16, 1024, 72).
//
// What bounds it: at (16, 12, 1024, 64) the two products are 4 b h N^2 d =
// 5.2e10 flops, 0.052 ms at 989 TFLOP/s, and the softmax's b h N^2 = 2.0e8
// exponentials take as long on the SFUs (16 a clock per SM, 0.054 ms); the
// 8 b h N d bytes (0.015 ms) do not bound it. So the design must keep the
// tensor cores busy while the exponentials run; the mma.sync core neither
// reached their full rate nor overlapped the two. At (16, 16, 1024, 72) the
// products are 7.7e10 flops (0.078 ms) against 2.7e8 exponentials (0.065
// ms at the measured rate): the products bound it.
//
// Design (FlashAttention-3's for this head dim): persistent blocks, one per
// SM, walk work tiles of 192 query rows of one (b, h), the tiles of a head
// in a row so that its K and V stay in L2. Warpgroup 0 is the producer: one
// thread loads each work tile's Q once and its 128-key K and V tiles into a
// ring of kFaStages stages by TMA (128-byte swizzle; a 4D tensor map per
// operand over (d, n, h, b) with that operand's row, head and batch strides,
// so contiguous (B, H, N, d) and the (B, N, H*d) rows of #8 alike, and keys
// and rows past n arrive as zeros), under full and empty
// mbarriers; Q has its own, released after the tile's last Q K^T, so the
// next tile's Q and first K and V load while this one finishes. Warpgroups
// 1 to 3 own 64 query rows each (setmaxnreg: 160 registers, the producer
// 24; at d = 72 warpgroups 1 and 2, 240 registers). S = Q K^T is wgmma
// m64n128k16 with both operands K-major in shared memory; the online
// softmax runs in registers in exp2 units (ex2.approx); P, rounded to
// bf16, stays in registers as the A operand of O += P V, wgmma
// m64n64k16 with V read MN-major from its (key, d) tile. Each iteration
// issues Q K^T of this tile and P V of the previous one back to back, and the
// three warpgroups take turns at issuing through named barriers, so two
// softmaxes run while the third warpgroup's products do (with two
// warpgroups of 128-row tiles the softmax showed through; FA3's overlap
// inside a warpgroup, the next Q K^T issued before this softmax, ran
// slower at this head dim). Keys past n are
// masked to -inf in the last tile; rows past n are computed on zeros and not
// stored (at n = 1024, 128 of the last tile's 192: 1/9 of the work). The
// epilogue stores O through the output's own row, head and batch strides.
//
// d = 72 (kD, a template switch; the d = 64 code is unchanged): a 144-byte
// row is no 128-byte swizzle row, and 72 is no multiple of wgmma's depth of
// 16. Each tile is loaded as two boxes of two tensor maps over the same
// (72, n, h, b) tensor: columns 0-63 under the 128-byte swizzle, as at d =
// 64, and columns 64-79 as a 16-column box under the 32-byte swizzle (its
// rows are 32 bytes), stored after the first part; the map's inner extent of
// 72 makes TMA fill columns 72-79 with zeros. So the d = 64 products run
// unchanged on the first part, and the second adds one more wgmma of each
// kind on descriptors of the 32-byte layout (the resident kernel's, below):
// a fifth k-step of Q K^T (m64n128k16 on the 16 columns, 8 of them zero) and
// O[:, 64..80) += P V[:, 64..80) (m64n16k16, V MN-major), whose columns
// 72-79 stay zero and are not stored. The zero columns cost 80/72 of the
// d = 72 work in the tensor cores; one n = 72 product would need V's 72
// columns in one swizzle layout, which no box of 144-byte rows gives. A
// consumer holds 8 more accumulator registers (o, 40): at 160 registers
// three consumer warpgroups spilled them inside the loop (32 bytes; 0.33 ms
// of attention at (16, 16, 1024, 72), 0.20 ms with the tail product left
// out), so d = 72 runs two (128-row work tiles, 240 registers, no spills:
// 0.23 ms, PERF.md). K and V tiles grow from 16 to 20 KB, a 128-row Q tile
// is 20 KB: 140 KB of ring and Q.

// 2^x on the SFU (relative error about 2^-22; results below 2^-126 flush to
// zero, far under the bf16 rounding of p)
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kFaKeys = 128;           // keys per K/V tile
constexpr int kFaStages = 3;           // K/V ring depth

// Geometry by head dim: consumer warpgroups (64 query rows each) and their
// registers (kWG x 128 x kRegs + 128 x 24 <= 65,536); tile bytes, the
// 128-byte-swizzled part (columns 0-63) and, at d = 72, the 32-byte-swizzled
// part (columns 64-79) after it.
template <int kD>
struct Fa {
  static_assert(kD == 64 || kD == 72, "the wgmma forward takes d = 64 or 72");
  static constexpr bool kTail = kD > 64;
  static constexpr int kWG = kTail ? 2 : 3;
  static constexpr int kRows = 64 * kWG;  // query rows per work tile
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kRegs = kWG == 3 ? 160 : 240;
  static constexpr int kTileMain = kFaKeys * 64 * 2;               // a K or V tile's first part
  static constexpr int kTile = kTileMain + (kTail ? kFaKeys * 32 : 0);
  static constexpr int kQMain = kRows * 64 * 2;                    // a Q tile's first part
  static constexpr int kQTile = kQMain + (kTail ? kRows * 32 : 0);
  static constexpr int kSmem = kQTile + 2 * kFaStages * kTile + 1024;  // + slack to align to 1 KB
};

// The maps of columns 64-79 (d = 72); unused at d = 64.
struct FaTailMaps {
  CUtensorMap q, k, v;
};

// grid: one block per SM (at most one per work tile); work tile w is query
// rows kRows (w % qtiles).. of head bh = w / qtiles, (b, h) = (bh / heads,
// bh % heads) in the maps and in out (element (b, h, row, c) at out.p + b
// out.sb + h out.sh + row out.sr + c). With kLse (training),
// the epilogue also writes lse[bh * n + r] = m + log2(l) for rows r < n: the
// softmax's log2 denominator, max included, in the exp2 units of the
// logits scaled by scale_log2, which the backward subtracts before its exp2.
// A template switch, so the sampling path (no lse) runs the same code as
// before.
template <int kD, bool kLse>
__global__ void __launch_bounds__(Fa<kD>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v, const Operand out,
                           float* __restrict__ lse, int bh_count, int heads, int n, float scale_log2,
                           const __grid_constant__ FaTailMaps tail) {
  using F = Fa<kD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sk = sq + F::kQTile;               // kFaStages tiles
  unsigned char* sv = sk + kFaStages * F::kTile;    // kFaStages tiles
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[kFaStages], v_full[kFaStages],
      kv_empty[kFaStages];

  constexpr int kWG = F::kWG, kRows = F::kRows;
  const int ntiles = (n + kFaKeys - 1) / kFaKeys, qtiles = (n + kRows - 1) / kRows;
  const int nwork = qtiles * bh_count;
  // broadcast, so that ptxas sees the role branches as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    hopper::mbar_init(&q_empty, 4 * kWG);  // one arrival per consumer warp
    for (int s = 0; s < kFaStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&kv_empty[s], 4 * kWG);
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
        const int bh = w / qtiles, q0 = w % qtiles * kRows;
        const int bi = bh / heads, hi = bh % heads;
        // the previous work tile's last Q K^T is done with the Q buffer
        hopper::mbar_wait(&q_empty, q_phase ^ 1);
        hopper::mbar_expect_tx(&q_full, F::kQTile);
        hopper::tma_load_4d(sq, &tmap_q, &q_full, 0, q0, hi, bi);
        if constexpr (F::kTail) hopper::tma_load_4d(sq + F::kQMain, &tail.q, &q_full, 64, q0, hi, bi);
        for (int it = 0; it < ntiles; ++it) {
          unsigned char* kt = sk + stage * F::kTile;
          unsigned char* vt = sv + stage * F::kTile;
          hopper::mbar_wait(&kv_empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&k_full[stage], F::kTile);
          hopper::tma_load_4d(kt, &tmap_k, &k_full[stage], 0, it * kFaKeys, hi, bi);
          if constexpr (F::kTail)
            hopper::tma_load_4d(kt + F::kTileMain, &tail.k, &k_full[stage], 64, it * kFaKeys, hi, bi);
          hopper::mbar_expect_tx(&v_full[stage], F::kTile);
          hopper::tma_load_4d(vt, &tmap_v, &v_full[stage], 0, it * kFaKeys, hi, bi);
          if constexpr (F::kTail)
            hopper::tma_load_4d(vt + F::kTileMain, &tail.v, &v_full[stage], 64, it * kFaKeys, hi, bi);
          if (++stage == kFaStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    hopper::reg_alloc<F::kRegs>();
    const int c = wg - 1;  // query rows q0 + 64c ..
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const uint64_t dq = hopper::desc_sw128(sq + c * (F::kQMain / kWG), 16, 1024);
    // Accumulator layouts (column block j of 8): s[4j], s[4j+1] at row
    // 16 warp + g, columns 8j + 2t, +1; s[4j+2], s[4j+3] at row + 8; o alike.
    float s[64], o[32];
    uint32_t p[8][4];  // P in bf16, the A fragments of the 8 key steps of 16
    // d = 72: O's columns 64 + 8j + 2t.. (j = 1: the zero columns 72-79) and Q's
    // second part, 64 rows of 32 bytes a consumer
    float ot[F::kTail ? 8 : 1];
    uint64_t dq_tail = 0;
    if constexpr (F::kTail) dq_tail = hopper::desc_sw32(sq + F::kQMain + c * 64 * 32, 16, 256);
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0u;

    // Turns: consumer warpgroup c issues its products after bar_sync(1 + c)
    // and then lets the next one issue (bar_arrive on its barrier); c = 0
    // goes first. The arrivals match the syncs: the last warpgroup skips its
    // very last one.
    if (c == kWG - 1) hopper::bar_arrive(1, 256);
    auto turn_end = [&](bool very_last) {
      if (c < kWG - 1 || !very_last) hopper::bar_arrive(1 + (c + 1) % kWG, 256);
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
      if constexpr (F::kTail) {  // ot[4..7], the zero columns, stay zero
        ot[0] *= a0;
        ot[1] *= a0;
        ot[2] *= a1;
        ot[3] *= a1;
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
      if constexpr (F::kTail) hopper::fence_regs(ot);
#pragma unroll
      for (int i = 0; i < 8; ++i) hopper::fence_regs(p[i]);  // read by P V until its wait
    };
    // O += P V of the tile in stage st: V MN-major, 16 keys = 2 KB of the
    // first part (512 bytes of the second)
    auto pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        hopper::wgmma_m64n64k16_rs(
            o, p[kk], hopper::desc_sw128(sv + st * F::kTile + kk * 2048, F::kTileMain, 1024), 1);
      if constexpr (F::kTail) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hopper::wgmma_m64n16k16_rs(
              ot, p[kk], hopper::desc_sw32(sv + st * F::kTile + F::kTileMain + kk * 512, kFaKeys * 32, 256), 1);
      }
    };

    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int w = blockIdx.x; w < nwork; w += gridDim.x, q_phase ^= 1) {
      const int bh = w / qtiles, q0 = w % qtiles * kRows;
      const bool last_work = w + (int)gridDim.x >= nwork;
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      if constexpr (F::kTail) {
#pragma unroll
        for (int i = 0; i < 8; ++i) ot[i] = 0.f;
      }
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
        const uint64_t dk = hopper::desc_sw128(sk + stage * F::kTile, 16, 1024);
#pragma unroll
        for (int k = 0; k < 4; ++k) hopper::wgmma_m64n128k16_ss(s, dq + 2 * k, dk + 2 * k, k > 0);
        if constexpr (F::kTail)  // the fifth k-step: columns 64-79 (72-79 zero)
          hopper::wgmma_m64n128k16_ss(s, dq_tail,
                                      hopper::desc_sw32(sk + stage * F::kTile + F::kTileMain, 16, 256), 1);
        if (it > 0) pv(prev);
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
      pv(prev);
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
      bf16* ob = const_cast<bf16*>(out.p) + (bh / heads) * out.sb + (bh % heads) * out.sh;
      bf16* o0 = ob + (long long)r0 * out.sr;
      bf16* o1 = ob + (long long)r1 * out.sr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = i * 8 + 2 * t;
        if (r0 < n) *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        if (r1 < n) *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
      if constexpr (F::kTail) {  // columns 64 + 2t, +1
        if (r0 < n) *reinterpret_cast<uint32_t*>(o0 + 64 + 2 * t) = pack_bf16(ot[0] * inv0, ot[1] * inv0);
        if (r1 < n) *reinterpret_cast<uint32_t*>(o1 + 64 + 2 * t) = pack_bf16(ot[2] * inv1, ot[3] * inv1);
      }
    }
  }
}

// Tensor map of a contiguous (bh, n, d) bf16 tensor, copied in boxes of
// `rows` rows of one (b, h) and `cols` columns (64 under the 128-byte
// swizzle, or 16 under the 32-byte one: d = 72's columns 64-79): the
// single-pass backward's operands.
cudaError_t tmap_rows(CUtensorMap* map, const void* p, int d, int bh, int n, int rows, int cols = 64,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  return hopper::make_tmap_bf16(map, p, 3, dims, strides, box, swizzle);
}

// Tensor map of one operand of the wgmma forward, element (b, h, row, c) at
// x.p + b x.sb + h x.sh + row x.sr + c (c < d): a 4D map over (d, n,
// heads, batch) with the operand's own byte strides, copied in boxes of
// `rows` rows of one (b, h) and `cols` columns (as tmap_rows). TMA takes
// the strides in any order (#8's head stride, 128 bytes, is below its row
// stride) if each is a multiple of 16 bytes; a single head takes the batch
// stride (attn::contiguous gives it 0). The map's n dimension ends each (b,
// h), so rows past n arrive as zeros, as with the backward's 3D maps; its
// d dimension ends each row, so at d = 72 columns 72-79 arrive as zeros.
cudaError_t tmap_heads(CUtensorMap* map, const Operand& x, int d, int batch, int heads, int n, int rows,
                       int cols = 64, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)x.sr * 2, (cuuint64_t)(heads > 1 ? x.sh : x.sb) * 2,
                                 (cuuint64_t)x.sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  return hopper::make_tmap_bf16(map, x.p, 4, dims, strides, box, swizzle);
}

// The wgmma forward (a.d = kD, a.vec = 8: every base and stride a multiple
// of 16 bytes) over bh = batch * a.heads heads; with lse (not null) also the
// (bh, n) fp32 log2 denominators.
template <int kD>
cudaError_t launch_wgmma(const AttnArgs& a, float* lse, int bh, cudaStream_t stream) {
  using F = Fa<kD>;
  const int batch = bh / a.heads;
  CUtensorMap maps[3];
  FaTailMaps tail{};
  CUtensorMap* tails[3] = {&tail.q, &tail.k, &tail.v};
  const Operand* ops[3] = {&a.q, &a.k, &a.v};
  for (int i = 0; i < 3; ++i) {
    const int rows = i ? kFaKeys : F::kRows;
    cudaError_t e = tmap_heads(&maps[i], *ops[i], kD, batch, a.heads, a.n, rows);
    if (e == cudaSuccess && F::kTail)
      e = tmap_heads(tails[i], *ops[i], kD, batch, a.heads, a.n, rows, 16, CU_TENSOR_MAP_SWIZZLE_32B);
    if (e != cudaSuccess) return e;
  }
  auto kernel = lse ? flash_fwd_wgmma_kernel<kD, true> : flash_fwd_wgmma_kernel<kD, false>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (e != cudaSuccess) return e;
  const long long work = (long long)(a.n + F::kRows - 1) / F::kRows * bh;
  const int sms = hopper::sm_count();
  const int grid = work < sms ? (int)work : sms;
  kernel<<<grid, F::kThreads, F::kSmem, stream>>>(maps[0], maps[1], maps[2], a.o, lse, bh, a.heads, a.n,
                                                 a.scale_log2, tail);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// flash_attention forward at d = 16 (the VMAE decoder's, and encoder's,
// head dim; d = 8 shares it, padded with zeros by TMA) with K and V of a
// head resident in shared memory: replaces _flash_fwd_kernel
// (ldmae_tpu/ops/flash_attention.py, pallas_call at :77) at these head dims,
// N <= kRsMaxChunks * 128: on the no-grad path, and at d = 16 under autograd.
//
// What bounds it: at (8, 12, 1024, 16) the two products are 4 b h N^2 d =
// 6.4e9 flops (0.0065 ms at 989 TFLOP/s), the 8 b h N d bytes 0.0038 ms,
// but the b h N^2 = 1.0e8 exponentials take 0.024 ms at the SFUs' 16 a clock
// per SM (1.98 GHz, 132 SMs): at d = 16 each exponential carries 16
// multiply-adds per product where the tensor cores do about 120 of them in
// the time the SFU does one. So the design keeps the SFUs busy and takes
// part of their work away.
//
// Design: the TPU kernel's, which fits here at this head dim: K and V of one
// head (2 x 32 KB at N = 1024) are loaded once per block into shared memory
// by TMA (3D tensor maps over (bh, n, d) with the 32-byte swizzle of 32-byte
// rows, chunks of 128 keys, one mbarrier each, so the first products start
// when the first chunk lands; keys past n arrive as zeros), and each
// consumer warpgroup owns 64 query rows. The softmax is exact, in two passes
// over the resident K: pass 1 forms S = Q K^T chunk by chunk (wgmma
// m64n128k16, both operands K-major from shared memory) and keeps only the
// row maxima; pass 2 forms S again, p = exp2(S d^-1/2 log2 e - m), the row
// sums, P rounded to bf16 in registers (cvt.rn.bf16x2.f32) and O += P V by
// wgmma m64n16k16 with P as the register A operand and V read MN-major.
// There is no online rescaling, and O is 8 fp32 registers a thread. Keys
// past n, in the last chunk only, are masked to -inf after the product (no
// branch around a product); rows past n are computed on zeros and not
// stored.
//
// Exponentials: all on the SFU (ex2.approx.ftz). FlashAttention-4 moves a
// share of them to the FMA pipes as a range-reduced cubic; on an H100 every
// share tried (2, 3 and 4 of 8) was slower than none (PERF.md): without
// Blackwell's paired FMA the cubic takes about as many issue slots of a warp
// (8) as the SFU takes clocks for a warp's ex2 (32 lanes at 4 a clock), and
// the softmax's other work needs those slots.
//
// Rounding as the other forward kernels: p rounded to bf16 before it is
// normalised, the row sum in fp32, one division at the end.
//
// Under autograd at d = 16 (the VMAE's training with attn_impl "flash") it
// also writes lse = m + log2(l), the backward's row statistics (as the wgmma
// forward's, in the exp2 units of the logits scaled by scale_log2), from
// the two passes' row maximum m and sum l, for the single-pass backward.

constexpr int kRsWG = 2;                    // consumer warpgroups, 64 query rows each
constexpr int kRsRows = 64 * kRsWG;         // query rows per block
constexpr int kRsKeys = 128;                // keys per chunk: one S = Q K^T product
constexpr int kRsMaxChunks = 24;            // at most 3,072 keys resident (192 KB of K and V)
constexpr int kRsChunk = kRsKeys * 32;      // bytes of a K or V chunk: 128 rows of 16 bf16
constexpr int kRsQTile = kRsRows * 32;      // bytes of a block's Q tile
constexpr int kRsThreads = 128 * kRsWG;

inline int rs_smem(int chunks) { return 1024 + kRsQTile + 2 * chunks * kRsChunk; }

// Keys valid.. of a 128-key S tile in registers (the accumulator layout
// below) to -inf. Called for the last chunk only, behind a uniform branch:
// a compare and a select per element in every chunk kept the ALU pipe,
// not the SFU, the limit.
__device__ __forceinline__ void mask_keys(float (&s)[64], int valid, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (8 * j + 2 * t + (i & 1) >= valid) s[4 * j + i] = -INFINITY;
}

// grid: (ceil(n / kRsRows), bh); dynamic shared memory rs_smem(ceil(n / 128));
// lse (bh, n) fp32, or null.
__global__ void __launch_bounds__(kRsThreads, 2)
    flash_fwd_resident_kernel(const __grid_constant__ CUtensorMap tmap_q,
                              const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v, bf16* __restrict__ out,
                              float* __restrict__ lse, int n, int d, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nchunks = (n + kRsKeys - 1) / kRsKeys;
  unsigned char* sk = sq + kRsQTile;          // nchunks chunks
  unsigned char* sv = sk + nchunks * kRsChunk;  // nchunks chunks
  __shared__ __align__(8) uint64_t q_full, k_full[kRsMaxChunks], v_full[kRsMaxChunks];
  const int bh = blockIdx.y, q0 = blockIdx.x * kRsRows;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int c = 0; c < nchunks; ++c) hopper::mbar_init(&k_full[c], 1), hopper::mbar_init(&v_full[c], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // every load at once: K first, which pass 1 reads
    hopper::mbar_expect_tx(&q_full, kRsQTile);
    hopper::tma_load_3d(sq, &tmap_q, &q_full, 0, q0, bh);
    for (int c = 0; c < nchunks; ++c) {
      hopper::mbar_expect_tx(&k_full[c], kRsChunk);
      hopper::tma_load_3d(sk + c * kRsChunk, &tmap_k, &k_full[c], 0, c * kRsKeys, bh);
    }
    for (int c = 0; c < nchunks; ++c) {
      hopper::mbar_expect_tx(&v_full[c], kRsChunk);
      hopper::tma_load_3d(sv + c * kRsChunk, &tmap_v, &v_full[c], 0, c * kRsKeys, bh);
    }
  }
  // broadcast, so that ptxas sees the warpgroup index as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint64_t dq = hopper::desc_sw32(sq + wg * (kRsQTile / kRsWG), 16, 256);
  // Accumulator layout (column block j of 8): s[4j], s[4j+1] at row 16 warp
  // + g, columns 8j + 2t, +1; s[4j+2], s[4j+3] at row + 8; o alike.
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  hopper::mbar_wait(&q_full, 0);

  // pass 1: the row maxima of S over every key
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int c = 0; c < nchunks; ++c) {
    hopper::mbar_wait(&k_full[c], 0);
    hopper::wgmma_fence();
    hopper::wgmma_m64n128k16_ss(s, dq, hopper::desc_sw32(sk + c * kRsChunk, 16, 256), 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    const int valid = n - c * kRsKeys;
    if (valid < kRsKeys) mask_keys(s, valid, t);  // the last, ragged chunk only
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
  const float m0 = quad_max(mx0) * scale_log2, m1 = quad_max(mx1) * scale_log2;

  // pass 2: p, the row sums and O += P V
  float o[8], l0 = 0.f, l1 = 0.f;
  uint32_t p[8][4];  // P in bf16, the A fragments of the chunk's 8 key steps of 16
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    hopper::mbar_wait(&v_full[c], 0);
    hopper::wgmma_fence();
    hopper::wgmma_m64n128k16_ss(s, dq, hopper::desc_sw32(sk + c * kRsChunk, 16, 256), 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    const int valid = n - c * kRsKeys;
    if (valid < kRsKeys) mask_keys(s, valid, t);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = fa_exp2(fmaf(s[4 * j + i], scale_log2, i < 2 ? -m0 : -m1));
      l0 += e[0] + e[1];
      l1 += e[2] + e[3];
      p[j / 2][(j % 2) * 2] = pack_bf16(e[0], e[1]);
      p[j / 2][(j % 2) * 2 + 1] = pack_bf16(e[2], e[3]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)  // V MN-major: 16 keys = 512 bytes
      hopper::wgmma_m64n16k16_rs(o, p[kk], hopper::desc_sw32(sv + c * kRsChunk + kk * 512, kRsChunk, 256), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
#pragma unroll
    for (int i = 0; i < 8; ++i) hopper::fence_regs(p[i]);
  }

  const float s0 = quad_sum(l0), s1 = quad_sum(l1);
  const float inv0 = 1.f / s0, inv1 = 1.f / s1;
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  bf16* ob = out + (long long)bh * n * d;
  if (lse != nullptr && t == 0) {
    if (r0 < n) lse[(long long)bh * n + r0] = m0 + log2f(s0);
    if (r1 < n) lse[(long long)bh * n + r1] = m1 + log2f(s1);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = 8 * i + 2 * t;
    if (col < d) {
      if (r0 < n) *reinterpret_cast<uint32_t*>(ob + (long long)r0 * d + col) = pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
      if (r1 < n) *reinterpret_cast<uint32_t*>(ob + (long long)r1 * d + col) = pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    }
  }
}

// The resident kernel on contiguous (bh, n, d) q, k, v, out, d in {8, 16},
// 16-byte aligned, n <= kRsMaxChunks * 128; with lse (not null: d = 16) also
// the (bh, n) fp32 log2 denominators.
cudaError_t launch_resident(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int n,
                            int d, cudaStream_t stream) {
  const int chunks = (n + kRsKeys - 1) / kRsKeys;
  if ((d != 8 && d != 16) || chunks > kRsMaxChunks || (lse != nullptr && d != 16)) return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  // 16-element boxes of 32-byte rows: at d = 8 the columns past d arrive as zeros
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  for (int i = 0; i < 3; ++i) {
    const cuuint32_t box[3] = {16, (cuuint32_t)(i ? kRsKeys : kRsRows), 1};
    const cudaError_t e = hopper::make_tmap_bf16(&maps[i], ptrs[i], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_resident_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, rs_smem(kRsMaxChunks));
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kRsRows - 1) / kRsRows, bh);
  flash_fwd_resident_kernel<<<grid, kRsThreads, rs_smem(chunks), stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse, n, d, 1.4426950408889634f / sqrtf((float)d));
  return cudaGetLastError();
}

// Throughput probes for the bound of the kernels above: each thread runs
// `iters` rounds of 8 independent chains of one operation, so the unit that
// executes it is the limit. kOp 0: ex2.approx.ftz.f32 (SFU); kOp 1: the bf16
// packing cvt.rn.bf16x2.f32 (F2FP), each beside one fp32 add and one integer
// operation.
template <int kOp>
__global__ void __launch_bounds__(256) rate_kernel(float* out, int iters) {
  float x[8];
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = -1e-3f * (threadIdx.x + j);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kOp == 0) {
        x[j] = fa_exp2(-x[j]);
      } else {
        acc += pack_bf16(x[j], x[(j + 1) % 8]);
        x[j] = __fadd_rn(x[j], 1.f);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += x[j];
  out[blockIdx.x * 256 + threadIdx.x] = sum + (float)acc;
}

template <int DK>
cudaError_t launch(const AttnArgs& a, int bh, cudaStream_t stream) {
  constexpr int kSmem = Shape<DK>::kSmemBytes;
  // Dynamic shared memory above 48 KB needs an opt-in, which CUDA keeps per
  // device: set it at every launch (cheap) so any card the caller picks has it.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DK, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + kBlock - 1) / kBlock, bh);
  flash_fwd_kernel<DK, false><<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

#define LDMAE_HEAD_CLASSES(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

// The mma.sync core at the class of a.d.
cudaError_t dispatch(const AttnArgs& a, int bh, cudaStream_t s) {
  switch (head_class(a.d)) {
#define LDMAE_CASE(DK) \
  case DK: return launch<DK>(a, bh, s);
    LDMAE_HEAD_CLASSES(LDMAE_CASE)
#undef LDMAE_CASE
    default: return cudaErrorInvalidValue;
  }
}

AttnArgs make_args(Operand q, Operand k, Operand v, Operand o, int heads, int n, int d, int vec) {
  AttnArgs a{};
  a.q = q, a.k = k, a.v = v, a.o = o;
  a.heads = heads, a.n = n, a.d = d, a.vec = vec;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  return a;
}

AttnArgs contiguous_args(const void* q, const void* k, const void* v, void* out, int n, int d, int vec) {
  using attn::contiguous;
  return make_args(contiguous<bf16>(q, n, d), contiguous<bf16>(k, n, d), contiguous<bf16>(v, n, d),
                   contiguous<bf16>(out, n, d), 1, n, d, vec);
}

// The forward of bh heads by shape: the wgmma kernel at d = 64 or 72 with
// 16-byte aligned rows and strides (any layout of the operands), the
// mma.sync core otherwise, which writes no lse.
cudaError_t forward(const AttnArgs& a, float* lse, int bh, cudaStream_t s) {
  if (a.d == 64 && a.vec == 8) return launch_wgmma<64>(a, lse, bh, s);
  if (a.d == 72 && a.vec == 8) return launch_wgmma<72>(a, lse, bh, s);
  if (lse != nullptr) return cudaErrorInvalidValue;
  return dispatch(a, bh, s);
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
// d = 64 and 72 (DiT B to 1p6B, and XL: the training path), and d = 16
// without RoPE for N <= 3,072 (the VMAE's training under attn_impl
// "flash"), single pass on wgmma and TMA (FlashAttention-3's
// decomposition), in the section "Backward at d = 64, 72 and 16" below: the
// forward saves lse (flash_fwd_wgmma_kernel<kD, true>; at d = 16
// flash_fwd_resident_kernel) and its bf16
// output; a preprocess kernel forms delta = rowsum(g * o) from them and
// zeroes an fp32 dq accumulator; flash_bwd_wgmma_kernel does the 10 b h N^2
// d operations once, dq summed across key-tile blocks by bulk reductions in
// key-tile order; a postprocess kernel scales dq (and applies the RoPE
// Jacobian) into bf16.
//
// Every other head dim (1 <= d <= 128, in the classes of the forward core:
// VMAE d = 8 to 80; d = 16 with RoPE or past 3,072 keys), three passes on
// mma.sync (this section), deterministic (no atomics):
//   1. statistics: the forward kernel (flash_fwd_kernel<DK, true>) recomputes
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
// v^T) and forms every exponential three times; no shipped path runs it.
//
// Rounding (both designs): p and ds are rounded to bf16 as the A operand of
// the dv, dk and dq products; the TPU kernel keeps p, dp and ds in fp32. dq,
// dk, dv are fp32 until one rounding to bf16 at the end. delta comes from the
// forward's bf16 output in the single pass (at d = 16 since it took that
// pass: before, the statistics pass formed it from the fp32 output) and
// from the fp32 output in the three passes.
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
  int n, npad, d, vec;
  float scale_log2, scale;
};

template <int DK>
struct BwdShape {
  static constexpr int kT = kBlock * Shape<DK>::kLd;  // elements of one bf16 tile
  static constexpr int kSt = DK + 4;                   // fp32 staging row stride
  // six bf16 tiles + lse and delta, two buffers of 64 each
  static constexpr int kSmemBytes = 6 * kT * 2 + 4 * kBlock * 4;
  static_assert(kBlock * kSt * 4 <= 4 * kT * 2, "the staging tile fits in four streamed tiles");
};

// The 64 x DK fp32 accumulator of a block (warp w holds rows 16w..16w+15 in
// the mma C layout) times `mul`, written as bf16 to rows row0.. (< n) of out
// (row stride d) through the staging tile st, which may alias tiles the
// block has finished reading. With kRope, the transposed RoPE Jacobian at
// each row's position, in the TPU kernel's fp32 op order. Every thread of
// the block calls it.
template <int DK, bool kRope>
__device__ __forceinline__ void store_rows(const float (&acc)[DK / 8][4], float mul, float* st, bf16* out,
                                           int row0, int n, int d, const float* cos, const float* sin) {
  constexpr int kSt = BwdShape<DK>::kSt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  __syncthreads();  // every warp is done with the tiles st aliases
#pragma unroll
  for (int i = 0; i < DK / 8; ++i) {
    float* s0 = st + (warp * 16 + g) * kSt + i * 8 + 2 * t;
    s0[0] = acc[i][0] * mul;
    s0[1] = acc[i][1] * mul;
    s0[8 * kSt] = acc[i][2] * mul;
    s0[8 * kSt + 1] = acc[i][3] * mul;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBlock * d; idx += kThreads) {
    const int r = idx / d, c = idx % d, row = row0 + r;
    if (row >= n) continue;
    const float* sr = st + r * kSt;
    const float y = kRope ? attn::rope_transpose(sr, c, d, cos + (size_t)row * d, sin + (size_t)row * d) : sr[c];
    out[(size_t)row * d + c] = __float2bfloat16_rn(y);
  }
}

// A fragments (16 rows x DK) of this warp's rows of a row-major tile.
template <int DK>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DK / 16][4], const bf16* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
    ldsm_x4(f[kk][0], f[kk][1], f[kk][2], f[kk][3],
            smem_addr(tile + (warp * 16 + (lane & 15)) * Shape<DK>::kLd + kk * 16 + (lane >> 4) * 8));
}

// c[8][4] += A (16 x DK fragments) times the transpose of a 64-row tile:
// the B operand is the tile's rows (n index) over its columns (k index).
template <int DK>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[DK / 16][4], const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4(b0, b1, b2, b3,
              smem_addr(tile + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * Shape<DK>::kLd + kk * 16 +
                        ((lane >> 3) & 1) * 8));
      mma_bf16_16816(c[2 * p], a[kk], b0, b1);
      mma_bf16_16816(c[2 * p + 1], a[kk], b2, b3);
    }
  }
}

// c[DK/8][4] += A (16 x 64, four k-steps of packed bf16) times a 64-row
// tile read as the B operand (its rows are the k index), transposed on the
// way by ldmatrix.
template <int DK>
__device__ __forceinline__ void mma_ab(float (&c)[DK / 8][4], const uint32_t (&a)[4][4], const bf16* tile) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int p = 0; p < DK / 16; ++p) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(b0, b1, b2, b3,
                    smem_addr(tile + (j * 16 + (lane & 15)) * Shape<DK>::kLd + p * 16 + (lane >> 4) * 8));
      mma_bf16_16816(c[2 * p], a[j], b0, b1);
      mma_bf16_16816(c[2 * p + 1], a[j], b2, b3);
    }
  }
}

// grid: (ceil(n / 64) key tiles, bh).
template <int DK, bool kRope>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int kOBlocks = DK / 8, kT = BwdShape<DK>::kT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kT;
  bf16* sq = sv + kT;      // two buffers
  bf16* sg = sq + 2 * kT;  // two buffers
  float* sl = reinterpret_cast<float*>(sg + 2 * kT);  // lse, two buffers of 64
  float* sd = sl + 2 * kBlock;                         // delta, two buffers of 64

  const int n = a.n, d = a.d, vec = a.vec;
  const long long off = (long long)blockIdx.y * n * d;
  const bf16* q = a.q + off;
  const bf16* go = a.g + off;
  const float* lse = a.lse + (long long)blockIdx.y * a.npad;
  const float* delta = a.delta + (long long)blockIdx.y * a.npad;
  const int k0 = blockIdx.x * kBlock;
  const int t = threadIdx.x % 4;
  const int ntiles = (n + kBlock - 1) / kBlock;

  zero_padding<DK>(sk, 6, d);
  load_tile_async<DK>(sk, a.k + off + (long long)k0 * d, d, n - k0, d, vec);
  load_tile_async<DK>(sv, a.v + off + (long long)k0 * d, d, n - k0, d, vec);
  cp_async_commit();
  // q, g, lse and delta of query tile `it` into buffer `buf` (lse and delta
  // rows < npad are all written by the statistics pass)
  auto load_query_tile = [&](int it, int buf) {
    const int q0 = it * kBlock;
    load_tile_async<DK>(sq + buf * kT, q + (long long)q0 * d, d, n - q0, d, vec);
    load_tile_async<DK>(sg + buf * kT, go + (long long)q0 * d, d, n - q0, d, vec);
    for (int i = threadIdx.x; i < 2 * (kBlock / 4); i += kThreads) {
      const int which = i / (kBlock / 4), c = (i % (kBlock / 4)) * 4;
      cp_async16((which ? sd : sl) + buf * kBlock + c, (which ? delta : lse) + q0 + c);
    }
    cp_async_commit();
  };
  load_query_tile(0, 0);
  cp_async_wait<1>();  // the K and V tiles
  __syncthreads();

  uint32_t kf[DK / 16][4], vf[DK / 16][4];
  load_a_frags<DK>(kf, sk);
  load_a_frags<DK>(vf, sv);
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
    mma_abt<DK>(s, kf, qt);
    mma_abt<DK>(dp, vf, gt);

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
    mma_ab<DK>(dv, pf, gt);  // dV += P^T G
    mma_ab<DK>(dk, df, qt);  // dK += dS^T Q
    __syncthreads();  // this tile's buffers are consumed before they are refilled
  }
  float* st = reinterpret_cast<float*>(sq);
  store_rows<DK, kRope>(dk, a.scale, st, a.dk + off, k0, n, d, a.cos, a.sin);
  store_rows<DK, false>(dv, 1.f, st, a.dv + off, k0, n, d, nullptr, nullptr);
}

// grid: (ceil(n / 64) query tiles, bh).
template <int DK, bool kRope>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int kOBlocks = DK / 8, kT = BwdShape<DK>::kT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sg = sq + kT;
  bf16* sk = sg + kT;      // two buffers
  bf16* sv = sk + 2 * kT;  // two buffers

  const int n = a.n, d = a.d, vec = a.vec;
  const long long off = (long long)blockIdx.y * n * d;
  const bf16* k = a.k + off;
  const bf16* v = a.v + off;
  const int q0 = blockIdx.x * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ntiles = (n + kBlock - 1) / kBlock;

  zero_padding<DK>(sq, 6, d);
  load_tile_async<DK>(sq, a.q + off + (long long)q0 * d, d, n - q0, d, vec);
  load_tile_async<DK>(sg, a.g + off + (long long)q0 * d, d, n - q0, d, vec);
  cp_async_commit();
  load_tile_async<DK>(sk, k, d, n, d, vec);
  load_tile_async<DK>(sv, v, d, n, d, vec);
  cp_async_commit();
  cp_async_wait<1>();  // the q and g tiles
  __syncthreads();

  uint32_t qf[DK / 16][4], gf[DK / 16][4];
  load_a_frags<DK>(qf, sq);
  load_a_frags<DK>(gf, sg);
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
      load_tile_async<DK>(sk + ((it + 1) & 1) * kT, k + next * d, d, n - kv0 - kBlock, d, vec);
      load_tile_async<DK>(sv + ((it + 1) & 1) * kT, v + next * d, d, n - kv0 - kBlock, d, vec);
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
    mma_abt<DK>(s, qf, kt);
    mma_abt<DK>(dp, gf, vt);

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
    mma_ab<DK>(dq, df, kt);  // dQ += dS K
    __syncthreads();
  }
  store_rows<DK, kRope>(dq, a.scale, reinterpret_cast<float*>(sk), a.dq + off, q0, n, d, a.cos, a.sin);
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DK, bool kRope>
cudaError_t bwd_launch(const AttnArgs& stats, const BwdArgs& b, int bh, cudaStream_t s) {
  const dim3 grid((b.n + kBlock - 1) / kBlock, bh);
  constexpr int kFwd = Shape<DK>::kSmemBytes, kBwd = BwdShape<DK>::kSmemBytes;
  cudaError_t e = set_smem(flash_fwd_kernel<DK, true>, kFwd);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<DK, true><<<grid, kThreads, kFwd, s>>>(stats);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(flash_bwd_dkdv_kernel<DK, kRope>, kBwd)) != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<DK, kRope><<<grid, kThreads, kBwd, s>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(flash_bwd_dq_kernel<DK, kRope>, kBwd)) != cudaSuccess) return e;
  flash_bwd_dq_kernel<DK, kRope><<<grid, kThreads, kBwd, s>>>(b);
  return cudaGetLastError();
}

template <bool kRope>
cudaError_t bwd_dispatch(const AttnArgs& stats, const BwdArgs& b, int bh, cudaStream_t s) {
  switch (head_class(b.d)) {
#define LDMAE_CASE(DK) \
  case DK: return bwd_launch<DK, kRope>(stats, b, bh, s);
    LDMAE_HEAD_CLASSES(LDMAE_CASE)
#undef LDMAE_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The three passes on contiguous (bh, n, d) q, k (rotated for RoPE), v, g.
template <bool kRope>
cudaError_t backward3(const void* q, const void* k, const void* v, const void* g, const float* cos,
                      const float* sin, void* dq, void* dk, void* dv, float* lse, float* delta,
                      int bh, int n, int d, int vec, cudaStream_t s) {
  const int npad = (n + kBlock - 1) / kBlock * kBlock;
  AttnArgs stats = contiguous_args(q, k, v, nullptr, n, d, vec);
  stats.g = attn::contiguous<bf16>(g, n, d);
  stats.lse = lse;
  stats.delta = delta;
  stats.npad = npad;
  const BwdArgs b{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  cos, sin, n, npad, d, vec, stats.scale_log2, 1.f / sqrtf((float)d)};
  return bwd_dispatch<kRope>(stats, b, bh, s);
}

// ---------------------------------------------------------------------------
// Backward at d = 64, 72 and 16: flash_attention_bwd and
// flash_attention_rope_bwd on the DiT training path, and flash_attention_bwd
// on the VMAE's, FlashAttention-3's single pass on wgmma and TMA.
//
// What bounds it, at the DiT B/1 training shapes (b h N d = 32 12 1024 64):
// the five products are 10 b h N^2 d = 2.58e11 flops, 0.261 ms at 989
// TFLOP/s; q, k, v, g, o and lse in and dq, dk, dv out are 404 MB, 0.121 ms
// at 3.35 TB/s; the b h N^2 = 4.0e8 exponentials take 0.14 ms on the SFUs (16 a clock
// per SM). Operations bound it. The three-pass design above does 18 b h N^2
// d on mma.sync, which neither reaches the tensor cores' rate nor keeps them
// busy while the exponentials run, and the forward had to be run again
// because it saved no lse. At XL's (32, 16, 1024, 72): 3.87e11 flops, 0.391
// ms; 5.4e8 exponentials, 0.13 ms; 604 MB, 0.18 ms: operations again.
//
// Design:
//   * the forward (flash_fwd_wgmma_kernel<kD, true>) writes lse, and the
//     autograd Functions save it and the bf16 output;
//   * flash_bwd_preprocess_kernel: delta = rowsum(g * o) in fp32 from the
//     bf16 o; lse copied into a row-padded (bh, npad) array with +inf past
//     n; the fp32 dq accumulator (bh, npad, d) zeroed. One pass over g and
//     o, 8 lanes a row, 16-byte loads;
//   * flash_bwd_wgmma_kernel<kD, kRope>: one block per (128-key tile, b h), the
//     key tiles of a head adjacent in the grid, so that all of them read the
//     head's q and g tiles from L2. Warpgroup 0 is the producer (setmaxnreg
//     24): one thread loads the block's K and V tiles once, then streams
//     64-query tiles of q and g (TMA, 128-byte swizzle, 3D tensor maps over
//     (bh, n, d): rows past n arrive as zeros) with their lse and delta rows
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
//   * flash_bwd_postprocess_kernel<kD, kRope>: dq = bf16(J^T(dq_acc d^-1/2)).
// The key-tile blocks of a head add into dq in key-tile order: a warp of the
// producer warpgroup (the reducer) takes both consumers' staged parts of a
// query tile (mbarriers dq_full, dq_empty), waits until that tile's counter
// (dq_sem, zeroed by the preprocess) reads its key tile, issues the bulk
// reductions, waits for them to complete and bumps the counter. So dq is
// the same bits from run to run, as dk and dv are; the consumers go on with
// the next tiles meanwhile (two staging buffers). A block waits only on
// blocks of smaller key tiles of its head, which sit before it in the grid.
//
// d = 72 (kD; the d = 64 code is unchanged): every tile of K, V, q and g is
// loaded as the forward's two boxes, columns 0-63 (128-byte swizzle) and
// 64-79 (32-byte swizzle, 72-79 zero-filled by TMA) after them. S^T and
// dP^T take a fifth k-step on the second parts; dV and dK a second product,
// m64n16k16 into 8 more registers each (columns 64-79; 72-79 stay zero and
// are not stored); dQ's columns 64-79 are one more m64n16k16 (dS and K's
// second part both MN-major), split by keys, not columns: each consumer sums
// its own 64 keys (4 k-steps) into a 64 x 8 part, so both consumers issue
// the same products (no branch on the warpgroup around a product); the
// reducer warp adds consumer 1's part to consumer 0's, then adds that into
// the accumulator with a second bulk reduction. The accumulator of a (b h,
// 64-query tile) holds 64 x 72 values as the two 64 x 32 parts and the 64 x
// 8 part (2 KB, 32-byte rows) after them. The RoPE pairs c with c + 36, in
// another thread: dK d^-1/2 is staged in fp32 in shared memory (64 x 72 a
// consumer) for the Jacobian, and the postprocess pairs c with c + 36
// across the parts. Registers: dK and dV 40 each, dQ 24.
//
// d = 16 (the VMAE's head dim; replaces _flash_bwd_kernel, pallas_call at
// :151, at that head dim; no RoPE): d = 72's second part alone, all 16 of
// its columns stored (Bw<16>: no main part), on persistent blocks. What bounds it at the VMAE's
// (16, 12, 1024, 16): the b h N^2 = 2.0e8 exponentials, 0.048 ms on the
// SFUs, against 10 b h N^2 d = 3.2e10 flops (0.033 ms) and 8 b h N d bf16
// values (0.015 ms); the three passes formed each exponential three times. So
// every exponential is formed once, one S^T and one dP^T wgmma a query
// tile (m64n64k16), four m64n16k16 each of dV, dK and dQ. A tile's products
// are short, so the next tile's S^T and dP^T are issued before this
// tile's dV, dK and dQ are waited for, and a consumer's dQ, over its own 64
// keys, waits for its own warpgroup's dS^T rows only, not for the other
// consumer's. The parts of four query tiles (16 KB, contiguous in the
// accumulator at d = 16) are staged and reduced at once, under one counter
// (kGroup): one or eight a reduction ran slower. The blocks are
// persistent (kPersistent: one an SM walks (key tile, b h) units, K and V
// double-buffered), so a unit's loads, start and last ordered reductions
// overlap the next unit's tiles: 1.5x faster at the VMAE's N = 192 and
// 256, whose units are 3 and 4 query tiles, 3 % at 1,024. What is left, at
// 0.15 of the bound, is about 1.6 us a query tile and unit (3,200 clocks)
// at every N, which on an H100 (PERF.md) no one part sets: without the
// exponentials it ran 12 % faster, without the ordered reductions 18 %,
// without dV and dK 6 %; the ring's depth (3 to 10 stages), four dQ
// staging buffers, a tile retired after the next S^T, and the consumers'
// exponentials in turns gained nothing, and three consumers a block (192
// keys) ran slower at N = 1,024 and 256.

constexpr int kBwKeys = 128;                   // keys per block, 64 per consumer warpgroup
constexpr int kBwQ = 64;                       // queries per streamed tile
constexpr int kBwStages = 3;                   // q/g ring depth
constexpr int kBwDsTile = kBwKeys * kBwQ * 2;  // bytes of a dS^T staging tile
constexpr int kBwDqPart = kBwQ * 32;           // fp32 values of a warpgroup's dQ part (64 x 32)
constexpr int kBwThreads = 384;

// The parts of a tile by head dim: the main part, columns 0-63 under the
// 128-byte swizzle (d = 64, 72), and the tail, 16 columns under the 32-byte
// swizzle (d = 72: columns 64-79, 72-79 zero-filled and not stored; d = 16:
// the whole row). Shared-memory bytes: at d = 72 and 16 the dQ parts of the
// tail's columns, and at d = 72 the dK staging, follow.
template <int kD>
struct Bw {
  static_assert(kD == 16 || kD == 64 || kD == 72, "the single-pass backward takes d = 16, 64 or 72");
  static constexpr bool kMain = kD >= 64;
  static constexpr bool kTail = kD != 64;
  static constexpr int kTailCol0 = kMain ? 64 : 0;                  // the tail's first column
  static constexpr int kTailCols = kD - kTailCol0;                  // its stored columns: 8 or 16
  static constexpr int kMainParts = kMain ? 2 : 0;                  // 64 x 32 dQ parts of the main columns
  // query tiles of one ordered dq reduction: at d = 16 four (16 KB), since
  // a tile's 4 KB part takes less time to form than its turn in the order
  static constexpr int kGroup = kD == 16 ? 4 : 1;
  // d = 16: persistent blocks that walk (key tile, b h) units, K and V
  // double-buffered, so a unit's loads and the last reductions of the one
  // before overlap (a unit is short: 16 query tiles at N = 1,024)
  static constexpr bool kPersistent = kD == 16;
  static constexpr int kKvBufs = kPersistent ? 2 : 1;
  static constexpr int kKMain = kMain ? kBwKeys * 128 : 0;          // a K or V tile's main part
  static constexpr int kKTile = kKMain + (kTail ? kBwKeys * 32 : 0);
  static constexpr int kQMain = kMain ? kBwQ * 128 : 0;             // a q or g tile's main part
  static constexpr int kQTile = kQMain + (kTail ? kBwQ * 32 : 0);
  static constexpr int kDqTail = kTail ? kBwQ * kTailCols : 0;      // fp32 values of a dQ part of the tail
  static constexpr int kStRow = 76;                                 // fp32 row stride of the dK staging
  static constexpr int kDkStage = kD == 72 ? 64 * kStRow : 0;       // fp32 values of a consumer's dK staging
  // setmaxnreg's split of the launch's 384 x 168 registers: 128 x kProducerRegs
  // + 256 x kConsumerRegs = 64,512; at d = 16 the reducer's loop over a
  // group spilled at 24, and the consumers need far fewer than 232
  static constexpr int kProducerRegs = kD == 16 ? 40 : 24, kConsumerRegs = kD == 16 ? 232 : 240;
  static constexpr int kSmem = 2 * kKvBufs * kKTile + 2 * kBwStages * kQTile + 2 * kBwDsTile +
                               2 * kMainParts * kBwDqPart * 4 + 2 * kBwStages * kBwQ * 4 +
                               4 * kGroup * kDqTail * 4 + 2 * kDkStage * 4 + 1024;
};

// Offset in the dq accumulator of the dQ part (query tile qt; c < kMainParts:
// columns 32 c..; c = kMainParts: the tail's columns, 64-71 at d = 72, 0-15
// at d = 16) of (b, h) bh: the parts of a query tile lie together in the
// order (bh, query tile), 64 x kD values, each 64 x 32 part's row r's
// 8-value block j stored at block j ^ (r % 4) (so that the consumers'
// stores to its staging copy in shared memory hit every bank), the tail's
// part in plain rows (at d = 16 the parts of consecutive query tiles, each
// 64 x 16, are contiguous: a group's reduction is one bulk copy).
template <int kD>
__host__ __device__ __forceinline__ long long dq_part(long long bh, int nq, int qt, int c) {
  return (bh * nq + qt) * (kBwQ * kD) + c * kBwDqPart;
}

struct BwdWgmmaArgs {
  float* dq_acc;             // bh npad d fp32 as dQ parts (dq_part), zeroed; dq summed here
  int* dq_sem;               // a (b h, group of kGroup query tiles)'s key tiles that have added, zeroed
  bf16 *dk, *dv;             // (bh, n, d), written
  const float *lse, *delta;  // (bh, npad): lse +inf and delta 0 past n
  const float *cos, *sin;    // (n, d) fp32 half-split tables (kRope only)
  int n, npad, nbh;
  float scale_log2, scale;
};

// The maps of the tail (d = 72: columns 64-79; d = 16: 0-15); unused at d = 64.
struct BwTailMaps {
  CUtensorMap q, k, v, g;
};

// grid: (rows / 32, 256 threads), eight lanes a row; rows = bh * npad.
template <int kD>
__global__ void __launch_bounds__(256)
    flash_bwd_preprocess_kernel(const bf16* __restrict__ go, const bf16* __restrict__ o,
                                const float* __restrict__ lse_fwd, float* __restrict__ lse,
                                float* __restrict__ delta, float* __restrict__ dq_acc,
                                int* __restrict__ dq_sem, long long rows, int n, int npad) {
  constexpr int kGroupRows = kBwQ * Bw<kD>::kGroup;
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int j = threadIdx.x % 8;
  const long long bh = row / npad;
  const int r = (int)(row % npad);
  float acc = 0.f;
  // the 8-value chunk ch of the row: lane j's is j (at d = 72 lane 0 also adds the ninth; at d = 16
  // lanes 0 and 1 hold the row)
  auto chunk = [&](int ch) {
    const long long off = (bh * n + r) * kD + 8 * ch;
    const uint4 gu = *reinterpret_cast<const uint4*>(go + off);
    const uint4 ou = *reinterpret_cast<const uint4*>(o + off);
    const bf16* ge = reinterpret_cast<const bf16*>(&gu);
    const bf16* oe = reinterpret_cast<const bf16*>(&ou);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += __bfloat162float(ge[e]) * __bfloat162float(oe[e]);
  };
  if (row < rows && r < n) {
    if (j < kD / 8) chunk(j);
    if constexpr (kD == 72) {
      if (j == 0) chunk(8);
    }
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m, 8);
  if (row >= rows) return;
  if constexpr (kD == 64) {
    float4* z = reinterpret_cast<float4*>(dq_acc + row * 64 + 8 * j);
    z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {  // the row's kD values of the accumulator, as a flat range (the parts tile it)
    float4* z = reinterpret_cast<float4*>(dq_acc + row * kD);
    for (int f = j; f < kD / 4; f += 8) z[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (j == 0) {
    delta[row] = acc;
    lse[row] = r < n ? lse_fwd[bh * n + r] : INFINITY;
    if (r % kGroupRows == 0) dq_sem[bh * ((npad + kGroupRows - 1) / kGroupRows) + r / kGroupRows] = 0;
  }
}

// grid: (ceil(n / 128), bh), or at d = 16 (kPersistent) one block an SM at
// most, walking the (key tile, b h) units u = blockIdx.x, + gridDim.x, ..
// (key tile u % ceil(n / 128), b h u / ceil(n / 128)); see the note above.
template <int kD, bool kRope>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __grid_constant__ CUtensorMap tmap_g, const BwdWgmmaArgs a,
                           const __grid_constant__ BwTailMaps tail) {
  using B = Bw<kD>;
  constexpr int kGroup = B::kGroup;
  static_assert(!B::kMain || kGroup == 1, "the main dQ parts are reduced a query tile at a time");
  static_assert(!kRope || kD != 16, "RoPE at d = 16 runs the three passes");
  extern __shared__ unsigned char smem_raw[];
  // K and V: kKvBufs pairs of tiles
  unsigned char* skv = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* sq = skv + 2 * B::kKvBufs * B::kKTile;  // kBwStages tiles
  unsigned char* sg = sq + kBwStages * B::kQTile;    // kBwStages tiles
  unsigned char* sds = sg + kBwStages * B::kQTile;   // two dS^T staging tiles
  float* sdq = reinterpret_cast<float*>(sds + 2 * kBwDsTile);  // main dQ parts, two per consumer
  float* sl = sdq + 2 * B::kMainParts * kBwDqPart;             // lse rows, kBwStages x kBwQ
  float* sd = sl + kBwStages * kBwQ;                           // delta rows, likewise
  // the tail's dQ parts: [consumer][buffer][query tile of the group]
  float* sdqt = sd + kBwStages * kBwQ;
  float* sdk = sdqt + 4 * kGroup * B::kDqTail;  // d = 72 with RoPE: dK d^-1/2 staged, one per consumer
  __shared__ __align__(8) uint64_t kv_full[B::kKvBufs], kv_empty[B::kKvBufs], full[kBwStages], empty[kBwStages];
  // the dQ staging buffers (two, each holding both consumers' parts of a
  // group of query tiles) between the consumers and the reducer warp
  __shared__ __align__(8) uint64_t dq_full[2], dq_empty[2];

  const int n = a.n, nq = a.npad / kBwQ, ngroups = (nq + kGroup - 1) / kGroup;
  const int nkt = (n + kBwKeys - 1) / kBwKeys;
  const int nunits = B::kPersistent ? nkt * a.nbh : 1;
  const int ufirst = B::kPersistent ? blockIdx.x : 0, ustep = B::kPersistent ? gridDim.x : 1;
  auto unit_kt = [&](int u) { return B::kPersistent ? u % nkt : static_cast<int>(blockIdx.x); };
  auto unit_bh = [&](int u) { return B::kPersistent ? u / nkt : static_cast<int>(blockIdx.y); };
  // broadcast, so that ptxas sees the role branches as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int b = 0; b < B::kKvBufs; ++b) {
      hopper::mbar_init(&kv_full[b], 1);
      hopper::mbar_init(&kv_empty[b], 2);  // each consumer's leader
    }
    for (int s = 0; s < kBwStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(&dq_full[b], 2);  // each consumer's leader
      hopper::mbar_init(&dq_empty[b], 1);  // the reducer
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::reg_dealloc<B::kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = ufirst, ui = 0; u < nunits; u += ustep, ++ui) {
        const int bh = unit_bh(u), k0 = unit_kt(u) * kBwKeys, ub = ui % B::kKvBufs;
        if (ui >= B::kKvBufs) hopper::mbar_wait(&kv_empty[ub], (ui / B::kKvBufs - 1) & 1);
        unsigned char* sk = skv + ub * 2 * B::kKTile;
        unsigned char* sv = sk + B::kKTile;
        hopper::mbar_expect_tx(&kv_full[ub], 2 * B::kKTile);
        if constexpr (B::kMain) {
          hopper::tma_load_3d(sk, &tmap_k, &kv_full[ub], 0, k0, bh);
          hopper::tma_load_3d(sv, &tmap_v, &kv_full[ub], 0, k0, bh);
        }
        if constexpr (B::kTail) {
          hopper::tma_load_3d(sk + B::kKMain, &tail.k, &kv_full[ub], B::kTailCol0, k0, bh);
          hopper::tma_load_3d(sv + B::kKMain, &tail.v, &kv_full[ub], B::kTailCol0, k0, bh);
        }
        const long long row0 = (long long)bh * a.npad;
        for (int it = 0; it < nq; ++it) {
          unsigned char* qt = sq + stage * B::kQTile;
          unsigned char* gt = sg + stage * B::kQTile;
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&full[stage], 2 * B::kQTile + 2 * kBwQ * 4);
          const int q0 = it * kBwQ;
          if constexpr (B::kMain) {
            hopper::tma_load_3d(qt, &tmap_q, &full[stage], 0, q0, bh);
            hopper::tma_load_3d(gt, &tmap_g, &full[stage], 0, q0, bh);
          }
          if constexpr (B::kTail) {
            hopper::tma_load_3d(qt + B::kQMain, &tail.q, &full[stage], B::kTailCol0, q0, bh);
            hopper::tma_load_3d(gt + B::kQMain, &tail.g, &full[stage], B::kTailCol0, q0, bh);
          }
          hopper::bulk_load(sl + stage * kBwQ, a.lse + row0 + q0, kBwQ * 4, &full[stage]);
          hopper::bulk_load(sd + stage * kBwQ, a.delta + row0 + q0, kBwQ * 4, &full[stage]);
          if (++stage == kBwStages) stage = 0, phase ^= 1;
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      // The reducer warp: each group's dQ parts of both consumers into the
      // accumulator, in key-tile order: the block of key tile j waits until
      // the counter of (b h, group) reads j, adds its parts (one bulk
      // reduction each), waits for them to complete and bumps the counter,
      // so every run sums dq in the same order.
      const int lane = threadIdx.x % 32;
      int seq = 0;  // groups this block has reduced: the staging buffers' sequence
      for (int u = ufirst; u < nunits; u += ustep) {
        const int bh = unit_bh(u), kt = unit_kt(u);
        int* sem = a.dq_sem + (long long)bh * ngroups;
        for (int grp = 0; grp < ngroups; ++grp, ++seq) {
          const int buf = seq & 1, it0 = grp * kGroup;
          const int tiles = kGroup == 1 || nq - it0 >= kGroup ? kGroup : nq - it0;
          hopper::mbar_wait(&dq_full[buf], (seq >> 1) & 1);
          float* t0 = sdqt + buf * kGroup * B::kDqTail;
          if constexpr (B::kTail) {  // the tail's parts: consumer 1's added to consumer 0's, in that order
            const float* t1 = sdqt + (2 + buf) * kGroup * B::kDqTail;
            for (int i = lane; i < tiles * B::kDqTail; i += 32) t0[i] += t1[i];
            hopper::fence_proxy_async();
          }
          __syncwarp();
          if (lane == 0) {
            hopper::wait_eq_acquire(sem + grp, kt);
            hopper::fence_proxy_async_global();
            if constexpr (B::kMain) {
              hopper::bulk_reduce_add_f32(a.dq_acc + dq_part<kD>(bh, nq, it0, 0), sdq + buf * kBwDqPart,
                                          kBwDqPart * 4);
              hopper::bulk_reduce_add_f32(a.dq_acc + dq_part<kD>(bh, nq, it0, 1), sdq + (2 + buf) * kBwDqPart,
                                          kBwDqPart * 4);
            }
            if constexpr (B::kTail)
              hopper::bulk_reduce_add_f32(a.dq_acc + dq_part<kD>(bh, nq, it0, B::kMainParts), t0,
                                          tiles * B::kDqTail * 4);
            hopper::bulk_commit();
            hopper::bulk_wait<0>();
            hopper::fence_proxy_async_global();
            hopper::red_add_release(sem + grp, 1);
            hopper::mbar_arrive(&dq_empty[buf]);
          }
          __syncwarp();
        }
      }
    }
    return;
  }

  hopper::reg_alloc<B::kConsumerRegs>();
  const int c = wg - 1;  // keys k0 + 64c ..
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* sk = skv;  // the unit's K tile (V's follows), and their descriptors
  uint64_t kdesc = 0, vdesc = 0;
  const float scale_log2 = a.scale_log2;
  // Accumulator layouts (column block j of 8): x[4j], x[4j+1] at row 16 warp
  // + g, columns 8j + 2t, +1; x[4j+2], x[4j+3] at row + 8. Rows of s, dp, dk,
  // dv are this warpgroup's keys; columns of s, dp are the tile's queries,
  // of dk, dv the head dim. Rows of dq are the tile's queries, its columns
  // 32c + 8j + 2t.
  float dk[32], dv[32], s[32], dp[32], dq[16];
  uint32_t pf[4][4], df[4][4];  // P^T and dS^T in bf16: the A fragments of 4 query steps of 16
  // the tail: columns kTailCol0 + 8j + 2t of dK, dV and dQ (d = 72: j = 1
  // the zero columns 72-79), and the tail parts of K and V, 64 rows of 32
  // bytes a consumer
  constexpr int kT = B::kTail ? 8 : 1;
  float dkt[kT], dvt[kT], dqt[kT];
  uint64_t kdesc_tail = 0, vdesc_tail = 0;
#pragma unroll
  for (int i = 0; i < kT; ++i) dqt[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dq[i] = 0.f;
  // the staging row of this thread's first key (16-byte chunk j of row r is
  // stored at chunk j ^ (r % 8), TMA's and wgmma's 128-byte swizzle)
  const int srow = c * 64 + warp * 16 + g;
  auto fence_all = [&]() {
    if constexpr (B::kMain) {
      hopper::fence_regs(dq);
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
    }
    if constexpr (B::kTail) {
      hopper::fence_regs(dqt);
      hopper::fence_regs(dkt);
      hopper::fence_regs(dvt);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // read by dV and dK until their wait
      hopper::fence_regs(pf[i]);
      hopper::fence_regs(df[i]);
    }
  };

  // S^T = K Q^T and dP^T = V G^T of the query tile in stage stg: two commit groups
  auto issue_s_dp = [&](int stg) {
    const unsigned char* qt = sq + stg * B::kQTile;
    const unsigned char* gt = sg + stg * B::kQTile;
    const uint64_t qdesc = hopper::desc_sw128(qt, 16, 1024);
    const uint64_t gdesc = hopper::desc_sw128(gt, 16, 1024);
    hopper::wgmma_fence();
    if constexpr (B::kMain) {
#pragma unroll
      for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_ss(s, kdesc + 2 * k, qdesc + 2 * k, k > 0);
    }
    if constexpr (B::kTail)  // the tail's k step (d = 72: the fifth, columns 64-79, 72-79 zero)
      hopper::wgmma_m64n64k16_ss(s, kdesc_tail, hopper::desc_sw32(qt + B::kQMain, 16, 256), B::kMain);
    hopper::wgmma_commit();
    if constexpr (B::kMain) {
#pragma unroll
      for (int k = 0; k < 4; ++k) hopper::wgmma_m64n64k16_ss(dp, vdesc + 2 * k, gdesc + 2 * k, k > 0);
    }
    if constexpr (B::kTail)
      hopper::wgmma_m64n64k16_ss(dp, vdesc_tail, hopper::desc_sw32(gt + B::kQMain, 16, 256), B::kMain);
    hopper::wgmma_commit();
  };
  // Retires query tile i (in stage stg) once its dV, dK and dQ are done:
  // the stage goes back to the producer, and the tile's dQ part is staged
  // in shared memory (two buffers of a group a warpgroup) for the reducer
  // warp, once it is done with the buffer's previous group.
  int gbase = 0;  // groups of the block's earlier units: the staging buffers' sequence
  auto retire = [&](int i, int stg) {
    fence_all();
    if (lane == 0) hopper::mbar_arrive(&empty[stg]);  // q, g, lse, delta of this stage are read
    const int gi = i % kGroup, seq = gbase + i / kGroup, buf = seq & 1;
    if (gi == 0 && seq >= 2) hopper::mbar_wait(&dq_empty[buf], ((seq >> 1) - 1) & 1);
    const int row = warp * 16 + g;
    if constexpr (B::kMain) {
      float* part = sdq + (c * 2 + buf) * kBwDqPart;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int blk = 8 * (j ^ (row & 3)) + 2 * t;  // rows row and row + 8 swizzle alike
        *reinterpret_cast<float2*>(part + row * 32 + blk) = make_float2(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<float2*>(part + (row + 8) * 32 + blk) = make_float2(dq[4 * j + 2], dq[4 * j + 3]);
      }
    }
    if constexpr (B::kTail) {  // the tail's stored columns: rows of kTailCols values
      float* part_t = sdqt + ((c * 2 + buf) * kGroup + gi) * B::kDqTail;
#pragma unroll
      for (int j = 0; j < B::kTailCols / 8; ++j) {
        *reinterpret_cast<float2*>(part_t + row * B::kTailCols + 8 * j + 2 * t) =
            make_float2(dqt[4 * j], dqt[4 * j + 1]);
        *reinterpret_cast<float2*>(part_t + (row + 8) * B::kTailCols + 8 * j + 2 * t) =
            make_float2(dqt[4 * j + 2], dqt[4 * j + 3]);
      }
    }
    if (gi == kGroup - 1 || i == nq - 1) {  // the group is staged
      hopper::fence_proxy_async();
      hopper::bar_sync(2 + c, 128);
      if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&dq_full[buf]);
    }
  };
  // d = 16 (no main part): a tile's products are short, so the next tile's
  // S^T and dP^T are issued before this tile's dV, dK and dQ are waited
  // for, and each consumer's dQ, over its own 64 keys, waits only for its
  // own warpgroup's dS^T rows.
  constexpr bool kAhead = !B::kMain;

  int stage = 0;
  uint32_t phase = 0;
  for (int u = ufirst, ui = 0; u < nunits; u += ustep, ++ui, gbase += ngroups) {
    const int bh = unit_bh(u), k0 = unit_kt(u) * kBwKeys, ub = ui % B::kKvBufs;
    sk = skv + ub * 2 * B::kKTile;
    unsigned char* sv = sk + B::kKTile;
    kdesc = hopper::desc_sw128(sk + c * (B::kKMain / 2), 16, 1024);
    vdesc = hopper::desc_sw128(sv + c * (B::kKMain / 2), 16, 1024);
    if constexpr (B::kTail) {
      kdesc_tail = hopper::desc_sw32(sk + B::kKMain + c * 64 * 32, 16, 256);
      vdesc_tail = hopper::desc_sw32(sv + B::kKMain + c * 64 * 32, 16, 256);
#pragma unroll
      for (int i = 0; i < 8; ++i) dkt[i] = dvt[i] = 0.f;
    }
    if constexpr (B::kMain) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    }
    hopper::mbar_wait(&kv_full[ub], (ui / B::kKvBufs) & 1);
    if constexpr (kAhead) {
      hopper::mbar_wait(&full[stage], phase);
      issue_s_dp(stage);
    }
    for (int it = 0; it < nq; ++it) {
      if constexpr (!kAhead) {
        hopper::mbar_wait(&full[stage], phase);
        issue_s_dp(stage);
      }
      const unsigned char* qt = sq + stage * B::kQTile;
      const unsigned char* gt = sg + stage * B::kQTile;
      const float* lt = sl + stage * kBwQ;
      const float* dt = sd + stage * kBwQ;
      unsigned char* st = sds + (it & 1) * kBwDsTile;

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
      // dV += P^T G, G MN-major: 16 queries = 2 KB of the main part (512 bytes of the tail)
      hopper::wgmma_fence();
      if constexpr (B::kMain) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n64k16_rs(dv, pf[kk], hopper::desc_sw128(gt + kk * 2048, B::kQMain, 1024), 1);
      }
      if constexpr (B::kTail) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n16k16_rs(dvt, pf[kk], hopper::desc_sw32(gt + B::kQMain + kk * 512, kBwQ * 32, 256), 1);
      }
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
      if constexpr (B::kMain) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n64k16_rs(dk, df[kk], hopper::desc_sw128(qt + kk * 2048, B::kQMain, 1024), 1);
      }
      if constexpr (B::kTail) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n16k16_rs(dkt, df[kk], hopper::desc_sw32(qt + B::kQMain + kk * 512, kBwQ * 32, 256), 1);
      }
      hopper::wgmma_commit();

      // dQ[:, 32c..] = dS K over the block's 128 keys, once both consumers'
      // dS^T rows are in the staging tile: dS^T and K both MN-major, 16 keys
      // = 2 KB, this warpgroup's 32 columns 64 bytes into K's rows; the tail's
      // columns dQ[:, kTailCol0..] over this warpgroup's 64 keys (16 keys =
      // 512 bytes of K's tail)
      hopper::fence_proxy_async();
      if constexpr (kAhead)
        hopper::bar_sync(2 + c, 128);
      else
        hopper::bar_sync(1, 256);
      hopper::wgmma_fence();
      if constexpr (B::kMain) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          hopper::wgmma_m64n32k16_ss_tt(dq, hopper::desc_sw128(st + kk * 2048, kBwDsTile, 1024),
                                        hopper::desc_sw128(sk + kk * 2048 + c * 64, B::kKMain, 1024), kk > 0);
      }
      if constexpr (B::kTail) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ks = 4 * c + kk;  // this warpgroup's key steps
          hopper::wgmma_m64n16k16_ss_tt(dqt, hopper::desc_sw128(st + ks * 2048, kBwDsTile, 1024),
                                        hopper::desc_sw32(sk + B::kKMain + ks * 512, kBwKeys * 32, 256), kk > 0);
        }
      }
      hopper::wgmma_commit();
      if (kAhead && it + 1 < nq) {
        const int next = stage + 1 == kBwStages ? 0 : stage + 1;
        hopper::mbar_wait(&full[next], next == 0 ? phase ^ 1 : phase);
        issue_s_dp(next);         // into s and dp, which dS^T has read
        hopper::wgmma_wait<2>();  // this tile's dV, dK and dQ; the next tile's S^T and dP^T run on
      } else {
        hopper::wgmma_wait<0>();
      }
      retire(it, stage);
      if (++stage == kBwStages) stage = 0, phase ^= 1;
    }
    // the unit's K and V are read (its products waited for): the buffer back to the producer
    if (B::kPersistent && threadIdx.x % 128 == 0) hopper::mbar_arrive(&kv_empty[ub]);

    // dV, and dK d^-1/2 (with kRope J^T of it), in bf16 for keys < n
    const int r0 = k0 + srow, r1 = r0 + 8;
    bf16* dvb = a.dv + (long long)bh * n * kD;
    bf16* dkb = a.dk + (long long)bh * n * kD;
    if constexpr (B::kMain) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] *= a.scale;
    }
    if constexpr (B::kTail) {
#pragma unroll
      for (int i = 0; i < B::kTailCols / 2; ++i) dkt[i] *= a.scale;
    }
    if (kD == 64 && kRope) {
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
    if constexpr (B::kMain) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (r0 < n) {
          *reinterpret_cast<uint32_t*>(dvb + (long long)r0 * kD + col) = pack_bf16(dv[4 * j], dv[4 * j + 1]);
          if (kD == 64 || !kRope)
            *reinterpret_cast<uint32_t*>(dkb + (long long)r0 * kD + col) = pack_bf16(dk[4 * j], dk[4 * j + 1]);
        }
        if (r1 < n) {
          *reinterpret_cast<uint32_t*>(dvb + (long long)r1 * kD + col) =
              pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
          if (kD == 64 || !kRope)
            *reinterpret_cast<uint32_t*>(dkb + (long long)r1 * kD + col) =
                pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
        }
      }
    }
    if constexpr (B::kTail) {  // columns kTailCol0 + 8j + 2t, +1
#pragma unroll
      for (int j = 0; j < B::kTailCols / 8; ++j) {
        const int col = B::kTailCol0 + 8 * j + 2 * t;
        if (r0 < n)
          *reinterpret_cast<uint32_t*>(dvb + (long long)r0 * kD + col) = pack_bf16(dvt[4 * j], dvt[4 * j + 1]);
        if (r1 < n)
          *reinterpret_cast<uint32_t*>(dvb + (long long)r1 * kD + col) = pack_bf16(dvt[4 * j + 2], dvt[4 * j + 3]);
        if constexpr (!kRope) {
          if (r0 < n)
            *reinterpret_cast<uint32_t*>(dkb + (long long)r0 * kD + col) = pack_bf16(dkt[4 * j], dkt[4 * j + 1]);
          if (r1 < n)
            *reinterpret_cast<uint32_t*>(dkb + (long long)r1 * kD + col) = pack_bf16(dkt[4 * j + 2], dkt[4 * j + 3]);
        }
      }
      if constexpr (kRope && kD == 72) {
        // c pairs with c + 36, in another thread: this warpgroup's 64 x 72
        // rows of dK d^-1/2 through shared memory, then J^T element by element
        float* stg = sdk + c * B::kDkStage;
        const int lr = warp * 16 + g;  // this thread's rows lr and lr + 8 of the warpgroup's 64 keys
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(stg + lr * B::kStRow + 8 * j + 2 * t) = make_float2(dk[4 * j], dk[4 * j + 1]);
          *reinterpret_cast<float2*>(stg + (lr + 8) * B::kStRow + 8 * j + 2 * t) =
              make_float2(dk[4 * j + 2], dk[4 * j + 3]);
        }
        *reinterpret_cast<float2*>(stg + lr * B::kStRow + 64 + 2 * t) = make_float2(dkt[0], dkt[1]);
        *reinterpret_cast<float2*>(stg + (lr + 8) * B::kStRow + 64 + 2 * t) = make_float2(dkt[2], dkt[3]);
        hopper::bar_sync(2 + c, 128);
        const int key0 = k0 + c * 64;
        for (int idx = threadIdx.x % 128; idx < 64 * kD; idx += 128) {
          const int r = idx / kD, col = idx % kD, key = key0 + r;
          if (key >= n) continue;
          const float y = attn::rope_transpose(stg + r * B::kStRow, col, kD, a.cos + (size_t)key * kD,
                                               a.sin + (size_t)key * kD);
          dkb[(long long)key * kD + col] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

// grid: (ceil(rows / 32), 256 threads) at d = 64, rows = bh * n: eight lanes
// a row, lane j owning columns 4j..4j+3 and their RoPE partners
// 4j+32..4j+35. At d = 72 (16): ceil(rows * 36 (8) / 256) blocks, a thread a
// pair of columns (c, c + d / 2) of a row, at d = 72 in different parts.
template <int kD, bool kRope>
__global__ void __launch_bounds__(256)
    flash_bwd_postprocess_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
                                 const float* __restrict__ cos, const float* __restrict__ sin,
                                 long long rows, int n, int npad, float scale) {
  if constexpr (kD == 64) {
    const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
    if (row >= rows) return;
    const int c = 4 * (threadIdx.x % 8), r = (int)(row % n), rr = r % kBwQ;
    // columns c.. of the part of columns 0..31, and of the part of 32..63
    const float* src = dq_acc + dq_part<64>(row / n, npad / kBwQ, r / kBwQ, 0) + rr * 32 + 8 * ((c / 8) ^ (rr & 3)) + c % 8;
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
  } else {
    constexpr int kHalf = kD / 2;
    const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
    if (idx >= rows * kHalf) return;
    const long long row = idx / kHalf;
    const int c = (int)(idx % kHalf), r = (int)(row % n), rr = r % kBwQ;
    const float* blk = dq_acc + dq_part<kD>(row / n, npad / kBwQ, r / kBwQ, 0);
    using B = Bw<kD>;
    auto at = [&](int col) {  // element (rr, col) of the query tile's parts
      if (B::kMain && col < 64) {
        const int cc = col % 32;
        return blk[(col / 32) * kBwDqPart + rr * 32 + 8 * ((cc / 8) ^ (rr & 3)) + cc % 8];
      }
      return blk[B::kMainParts * kBwDqPart + rr * B::kTailCols + col - B::kTailCol0];
    };
    float y1 = at(c) * scale, y2 = at(c + kHalf) * scale;
    if (kRope) {  // J^T: (c, c + half), in the TPU kernel's op order
      const float* cs = cos + (size_t)r * kD;
      const float* sn = sin + (size_t)r * kD;
      const float o1 = __fadd_rn(__fmul_rn(y1, cs[c]), __fmul_rn(y2, sn[c + kHalf]));
      const float o2 = __fadd_rn(__fmul_rn(y2, cs[c + kHalf]), -__fmul_rn(y1, sn[c]));
      y1 = o1, y2 = o2;
    }
    bf16* out = dq + row * kD;
    out[c] = __float2bfloat16_rn(y1);
    out[c + kHalf] = __float2bfloat16_rn(y2);
  }
}

// The single pass at d = kD (16, 64 or 72) on contiguous (bh, n, kD) q, k
// (rotated for RoPE), v, g, o; lse_fwd (bh, n) from the forward; lse, delta
// (bh, npad) and dq_acc (bh, npad, kD) fp32 scratch, followed by bh npad /
// 64 ints (the reduction order's counters, one a group of query tiles).
template <int kD, bool kRope>
cudaError_t backward_wgmma(const void* q, const void* k, const void* v, const void* g, const void* o,
                           const float* lse_fwd, const float* cos, const float* sin, void* dq, void* dk,
                           void* dv, float* lse, float* delta, float* dq_acc, int bh, int n,
                           cudaStream_t s) {
  using B = Bw<kD>;
  if (o == nullptr || lse_fwd == nullptr || dq_acc == nullptr) return cudaErrorInvalidValue;
  const int npad = (n + kBwQ - 1) / kBwQ * kBwQ;
  const long long prow = (long long)bh * npad;
  int* dq_sem = reinterpret_cast<int*>(dq_acc + prow * kD);  // after the accumulator, prow / kBwQ of them
  flash_bwd_preprocess_kernel<kD><<<(unsigned)((prow + 31) / 32), 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), lse_fwd, lse, delta, dq_acc, dq_sem, prow, n,
      npad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap maps[4] = {};
  BwTailMaps tail{};
  CUtensorMap* tails[4] = {&tail.q, &tail.k, &tail.v, &tail.g};
  const void* ptrs[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i) {
    const int rows = i == 1 || i == 2 ? kBwKeys : kBwQ;
    if (B::kMain && (e = tmap_rows(&maps[i], ptrs[i], kD, bh, n, rows)) != cudaSuccess) return e;
    if (B::kTail && (e = tmap_rows(tails[i], ptrs[i], kD, bh, n, rows, 16, CU_TENSOR_MAP_SWIZZLE_32B)) != cudaSuccess)
      return e;
  }
  if ((e = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<kD, kRope>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmem)) != cudaSuccess)
    return e;
  // d = 64: the scales exactly as before (8 = sqrt(64)); d = 72 and 16: the
  // forwards' scale_log2 (make_args, launch_resident), which their lse is in
  const float scale_log2 = kD == 64 ? 1.4426950408889634f / 8.f : 1.4426950408889634f / sqrtf((float)kD);
  const float scale = kD == 64 ? 0.125f : 1.f / sqrtf((float)kD);
  const BwdWgmmaArgs a{dq_acc, dq_sem, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, delta, cos, sin, n,
                       npad, bh, scale_log2, scale};
  const int nkt = (n + kBwKeys - 1) / kBwKeys;
  const long long units = (long long)nkt * bh;
  const int sms = hopper::sm_count();
  const dim3 grid = B::kPersistent ? dim3(units < sms ? (unsigned)units : (unsigned)sms) : dim3(nkt, bh);
  flash_bwd_wgmma_kernel<kD, kRope><<<grid, kBwThreads, B::kSmem, s>>>(maps[0], maps[1], maps[2], maps[3], a,
                                                                        tail);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long rows = (long long)bh * n;
  const long long threads = kD == 64 ? rows * 8 : rows * (kD / 2);
  flash_bwd_postprocess_kernel<kD, kRope><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      dq_acc, static_cast<bf16*>(dq), cos, sin, rows, n, npad, scale);
  return cudaGetLastError();
}

// The backward on contiguous (bh, n, d) operands: the single pass at d = 64
// and 72 with 16-byte aligned rows, and without RoPE at d = 16 with them and
// n <= kRsMaxChunks * 128 (where the resident forward wrote lse); the three
// passes otherwise (o, lse_fwd, dq_acc unused there).
template <bool kRope>
cudaError_t backward(const void* q, const void* k, const void* v, const void* g, const void* o,
                     const float* lse_fwd, const float* cos, const float* sin, void* dq, void* dk,
                     void* dv, float* lse, float* delta, float* dq_acc, int bh, int n, int d, int vec,
                     cudaStream_t s) {
  if (d == 64 && vec == 8)
    return backward_wgmma<64, kRope>(q, k, v, g, o, lse_fwd, cos, sin, dq, dk, dv, lse, delta, dq_acc, bh, n, s);
  if (d == 72 && vec == 8)
    return backward_wgmma<72, kRope>(q, k, v, g, o, lse_fwd, cos, sin, dq, dk, dv, lse, delta, dq_acc, bh, n, s);
  if constexpr (!kRope) {
    if (d == 16 && vec == 8 && n <= kRsMaxChunks * kRsKeys)
      return backward_wgmma<16, false>(q, k, v, g, o, lse_fwd, cos, sin, dq, dk, dv, lse, delta, dq_acc, bh, n, s);
  }
  return backward3<kRope>(q, k, v, g, cos, sin, dq, dk, dv, lse, delta, bh, n, d, vec, s);
}

// The RoPE pre-pass's arguments for contiguous (bh, n, d) q, k and scratch qr, kr.
NormRopeArgs rope_args(const void* q, const void* k, const float* cos, const float* sin, void* qr, void* kr,
                       int bh, int n, int d) {
  using attn::contiguous;
  return NormRopeArgs{{contiguous<bf16>(q, n, d), contiguous<bf16>(k, n, d)},
                      {contiguous<bf16>(qr, n, d), contiguous<bf16>(kr, n, d)},
                      {nullptr, nullptr}, cos, sin, (long long)bh * n, 1, n, d, 0.f};
}

}  // namespace

// q, k, v, out: contiguous (bh, n, d) bf16, 1 <= d <= 128; vec: the
// elements (8, 4, 2 or 1) every pointer and row is aligned to; lse: null,
// or at d = 64 or 72 with vec = 8 the (bh, n) fp32 log2 softmax denominators
// the backward takes (written). By shape: d = 64 or 72, vec = 8 runs the
// wgmma kernel (DiT B, 1p0B, 1p6B; XL), every other shape the mma.sync core.
// Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int bh, int n, int d, int vec, void* stream) {
  if (d < 1 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(forward(contiguous_args(q, k, v, out, n, d, vec), lse, bh, static_cast<cudaStream_t>(stream)));
}

// The resident kernel: q, k, v, out contiguous (bh, n, d) bf16, d = 8 or
// 16, 16-byte aligned, n <= 3,072; lse null, or at d = 16 the (bh, n) fp32
// log2 softmax denominators the single-pass backward takes (written).
// flash_attention picks it for those shapes when no gradient is recorded,
// and with lse at d = 16 when one is (ops/flash_attention.py). Returns the
// CUDA error of the launch (0 on success).
extern "C" int ldmae_flash_attention_resident_fwd(const void* q, const void* k, const void* v, void* out,
                                                  float* lse, int bh, int n, int d, void* stream) {
  return static_cast<int>(launch_resident(q, k, v, out, lse, bh, n, d, static_cast<cudaStream_t>(stream)));
}

// As above with half-split RoPE: cos, sin are contiguous (n, d) fp32 tables;
// qr, kr are (bh, n, d) bf16 scratch that receive the rotated q and k.
extern "C" int ldmae_flash_attention_rope_fwd(const void* q, const void* k, const void* v,
                                              const float* cos, const float* sin, void* qr,
                                              void* kr, void* out, float* lse, int bh, int n, int d,
                                              int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = attn::norm_rope(rope_args(q, k, cos, sin, qr, kr, bh, n, d), false, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return ldmae_flash_attention_fwd(qr, kr, v, out, lse, bh, n, d, vec, stream);
}

// As flash_attention_rope with the per-head RMS qk-norm first: qw, kw are
// the (d,) fp32 norm weights of q and k, eps the norm's epsilon. q, k, v are
// (b, h, n, d) in one layout, element (bi, hi, t, c) at p + bi sb + hi sh +
// t sr + c (contiguous, or views of the packed qkv); qr, kr (scratch, the
// normed and rotated q and k) and out are contiguous (b, h, n, d). The
// attention reads v in place and is chosen as for flash_attention_rope
// (without lse).
extern "C" int ldmae_flash_attention_qknorm_rope_fwd(const void* q, const void* k, const void* v,
                                                     const float* qw, const float* kw,
                                                     const float* cos, const float* sin, void* qr,
                                                     void* kr, void* out, int b, int h, int n, int d,
                                                     long long sb, long long sh, long long sr, int vec,
                                                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto strided = [&](const void* p) { return Operand{static_cast<const bf16*>(p), sb, sh, static_cast<int>(sr)}; };
  auto dense = [&](const void* p) { return attn::bhnd<bf16>(p, h, n, d); };
  const NormRopeArgs a{{strided(q), strided(k)}, {dense(qr), dense(kr)}, {qw, kw}, cos, sin,
                       (long long)b * h * n, h, n, d, eps};
  const cudaError_t e = attn::norm_rope(a, true, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      forward(make_args(dense(qr), dense(kr), strided(v), dense(out), h, n, d, vec), nullptr, b * h, s));
}

// RoPE + attention in the (b, n, h * d) layout: q, k, v rows of token t are
// at q + (bi * n + t) * q_rs (element row strides; v typically a view of the
// packed qkv), head hi at + hi * d. qr, kr (scratch) and out are contiguous
// (b, n, h * d). cos, sin: contiguous (n, d) fp32. vec: as for the others,
// over every pointer and row stride. The attention reads v in place and
// writes out directly: at d = 64 or 72 with vec = 8 the wgmma kernel (4D tensor
// maps over the strided rows), otherwise the mma.sync core. (The scratch
// laid out (b, h, n, d) instead timed the same.)
extern "C" int ldmae_flash_attention_fused_rope_fwd(
    const void* q, const void* k, const void* v, const float* cos, const float* sin, void* qr,
    void* kr, void* out, int b, int h, int n, int d, long long q_rs, long long k_rs,
    long long v_rs, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hd = (long long)h * d;
  auto rows = [&](const void* p, long long rs) {
    return Operand{static_cast<const bf16*>(p), n * rs, d, static_cast<int>(rs)};
  };
  const NormRopeArgs a{{rows(q, q_rs), rows(k, k_rs)},
                       {rows(qr, hd), rows(kr, hd)},
                       {nullptr, nullptr}, cos, sin, (long long)b * h * n, h, n, d, 0.f};
  const cudaError_t e = attn::norm_rope(a, false, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      forward(make_args(rows(qr, hd), rows(kr, hd), rows(v, v_rs), rows(out, hd), h, n, d, vec), nullptr, b * h, s));
}

// Backward of ldmae_flash_attention_fwd: q, k, v, g (the output's gradient)
// contiguous (bh, n, d) bf16; dq, dk, dv written likewise; lse, delta are
// (bh, npad) fp32 scratch with npad = n rounded up to a multiple of 64. At d
// = 64 or 72 with vec = 8, and at d = 16 with vec = 8 and n <= 3,072, o is
// the forward's output, lse_fwd its (bh, n) lse, and dq_acc (bh, npad, d)
// fp32 scratch followed by bh npad / 64 ints; the other shapes ignore the
// three.
extern "C" int ldmae_flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                         const void* o, const float* lse_fwd, void* dq, void* dk,
                                         void* dv, float* lse, float* delta, float* dq_acc, int bh,
                                         int n, int d, int vec, void* stream) {
  return static_cast<int>(backward<false>(q, k, v, g, o, lse_fwd, nullptr, nullptr, dq, dk, dv, lse,
                                          delta, dq_acc, bh, n, d, vec, static_cast<cudaStream_t>(stream)));
}

// Backward of ldmae_flash_attention_rope_fwd: as above with the (n, d) fp32
// half-split tables cos, sin, and qr, kr (bh, n, d) bf16 scratch that
// receive the rotated q and k; dq and dk are the gradients of the unrotated
// q and k. At d = 16 it runs the three passes at any n.
extern "C" int ldmae_flash_attention_rope_bwd(const void* q, const void* k, const void* v,
                                              const void* g, const void* o, const float* lse_fwd,
                                              const float* cos, const float* sin, void* qr, void* kr,
                                              void* dq, void* dk, void* dv, float* lse, float* delta,
                                              float* dq_acc, int bh, int n, int d, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = attn::norm_rope(rope_args(q, k, cos, sin, qr, kr, bh, n, d), false, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(backward<true>(qr, kr, v, g, o, lse_fwd, cos, sin, dq, dk, dv, lse, delta,
                                         dq_acc, bh, n, d, vec, s));
}

// Throughput of the SFU's ex2 (which = 0) or of the bf16 packing F2FP
// (which = 1): `blocks` blocks of 256 threads, each `iters` rounds of 8
// operations; out (blocks * 256 floats) is written.
extern "C" int ldmae_rate_probe(float* out, int which, int blocks, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) rate_kernel<0><<<blocks, 256, 0, s>>>(out, iters);
  else rate_kernel<1><<<blocks, 256, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
