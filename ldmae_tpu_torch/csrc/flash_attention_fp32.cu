// Flash attention in fp32 for Hopper (sm_90a), non-causal: the fp32
// counterparts of the bf16 kernels in flash_attention.cu, with the same C
// entry points (so the wrappers pick a library by dtype), for the configs'
// other compute dtype (parallel.compute_dtype: float32, and the VMAE's fp32
// decode). They replace the same Pallas TPU kernels of
// ldmae_tpu/ops/flash_attention.py in fp32: flash_attention (_flash_fwd_kernel,
// pallas_call at :77; backward _flash_bwd_kernel, :151), flash_attention_rope
// (_flash_rope_bhnd_kernel, :323; backward of flash_attention_rope_trainable,
// _flash_rope_bwd_kernel, :429), flash_attention_qknorm_rope (:282) and
// flash_attention_fused_rope (:550), at any head dim 1 <= d <= 128.
//
// Arithmetic: the TPU kernels' in fp32: logits q k^T d^-1/2 in fp32, exact
// softmax (here online, in exp2 units), p NOT rounded before P.V (the
// kernels' astype(v.dtype) is a no-op in fp32), P.V in fp32; the backward
// recomputes p from the forward's lse and forms dv = p^T g, ds = p (g v^T -
// rowsum(g o)), dq = ds k d^-1/2, dk = ds^T q d^-1/2 in fp32, no product
// rounded to one TF32 or bf16 value. RoPE and the qk-norm run the shared
// pre-pass (attention_common.cuh) instantiated for fp32, where its
// roundings to the element type vanish.
//
// Two routes, chosen by shape in the C dispatches (fwd_dispatch(),
// backward()):
//
// * At d = 64 and 72 with 16-byte aligned rows (every DiT registry arch;
//   what fp32 sampling and training launch) every product runs on the
//   tensor cores as 3xTF32: the forward (tf32x3_fwd_kernel, for all four
//   entries: fwd_dispatch checks every operand's base and strides, so #7's
//   and #8's strided views of qkv qualify) and the backward
//   (tf32x3_bwd_dkdv_kernel, tf32x3_bwd_dq_kernel), the section below. One
//   TF32 product keeps 10 mantissa bits, far from fp32; the sum of three
//   (a_lo b_hi + a_hi b_lo + a_hi b_hi) keeps about 22, as SDPA's fp32 path
//   does: on an H100 the forward reads 9.7e-7 relative L2 from an fp64
//   forward at (4, 12, 1024, 64), the backward 1.7e-6, against the plain
//   fp32 versions' 6.4e-7 and 6.6e-7 (PERF.md). What bounds them at (32,
//   12, 1024, 64): the products, 4 b h N^2 d = 1.03e11 operations forward
//   and 10 b h N^2 d = 2.58e11 backward, are three TF32 products each,
//   0.62 and 1.56 ms at the tensor cores' 495 TFLOP/s (1.54 and 3.85 ms on
//   the FMA pipes); mma.sync reaches about half that TF32 rate (wgmma takes
//   TF32 only with both shared-memory operands K-major, which dV = P^T G,
//   dK = dS^T Q and dQ = dS K's are not), the backward's two kernels do 14
//   b h N^2 d, S and dP in both; the forward reads each B operand (K and V
//   split, 1 KB a key a warp at d = 64) from shared memory for 16 rows.
//   Design: a block of 8 warps keeps 128 rows of one side (K, V for dK/dV
//   and q, g for dQ in shared memory; the forward's q as split fragments in
//   registers), each warp 16 of them, and streams 64-row tiles of the other
//   side by cp.async, the next tile's fp32 copy in flight while the block
//   works on the current one, which it has split once into a hi and a lo
//   tile (every warp reads the same tile: splitting it per warp was 45 % of
//   the instructions). Fragments come by ldmatrix (the first products'
//   operands) and 32-bit loads, rows padded to d + 4 floats so that neither
//   meets a bank conflict; P and dS pass from the first products'
//   accumulators to the second products as A operands in registers. The
//   second products are summed over a tile from zero and added to the
//   running sums in fp32: the tensor cores truncate each sum into the
//   accumulator, and over all N / 8 steps that bias read 8e-6. Nothing is
//   summed across blocks, so every output and lse are the same bits from
//   run to run.
//
// * Other head dims (the VMAE's d = 16 decode, d = 128) and unaligned views
//   run on the CUDA cores' fp32 FMA pipes (67 TFLOP/s). The design is the
//   plain tiled one, right first: a block of 256 threads owns 64 query
//   rows (forward, dQ) or 64 keys (dK/dV) and streams 64-row tiles of the
//   other side through shared memory (rows padded to an odd stride, so a
//   column of rows hits 32 banks); thread (ty, tx) of 16 x 16 owns rows ty
//   + 16 i and columns tx + 16 j (i, j < 4) of each 64 x 64 score tile, and
//   columns tx + 16 c of each output row; the probabilities go through a
//   shared 64 x 64 tile into the second product. Shared-memory loads, two
//   per FMA in the score products, bound it before the FMA pipes do.
#include "attention_common.cuh"

namespace {

using Operand = attn::Operand<float>;
using NormRopeArgs = attn::NormRopeArgs<float>;

constexpr int kRows = 64;       // query rows per block = keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPs = kRows + 1;  // row stride of the 64 x 64 probability tiles

// kC: output columns per thread, d <= 16 kC
template <int kC>
struct F32Shape {
  static constexpr int kW = 16 * kC;         // columns kept of a row (d padded with zeros)
  static constexpr int kLd = kW + 1;         // odd row stride
  static constexpr int kTile = kRows * kLd;  // floats of a q, k, v or g tile
};

__device__ __forceinline__ float half_max(float x) {  // over the 16 lanes of a half-warp
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows 0..63 of an operand at g (row stride sr) into a (64, kLd) tile;
// rows >= valid and columns >= d are zeros.
template <int kC>
__device__ __forceinline__ void load_tile(float* s, const float* g, long long sr, int valid, int d) {
  constexpr int kW = F32Shape<kC>::kW, kLd = F32Shape<kC>::kLd;
  for (int i = threadIdx.x; i < kRows * kW; i += kThreads) {
    const int r = i / kW, c = i % kW;
    s[r * kLd + c] = (r < valid && c < d) ? g[r * sr + c] : 0.f;
  }
}

struct Fwd32Args {
  Operand q, k, v, o;  // o.p is written
  float* lse;          // (bh, n) log2 denominators, written when not null
  int heads, n, d;
  float scale_log2;
};

// grid: (ceil(n / 64), batch * heads).
template <int kC>
__global__ void __launch_bounds__(kThreads) flash32_fwd_kernel(const Fwd32Args a) {
  constexpr int kLd = F32Shape<kC>::kLd, kT = F32Shape<kC>::kTile;
  extern __shared__ float smem32[];
  float* sq = smem32;
  float* sk = sq + kT;
  float* sv = sk + kT;
  float* sp = sv + kT;  // p, 64 x kPs

  const int n = a.n, d = a.d;
  const float scale_log2 = a.scale_log2;
  const int bi = blockIdx.y / a.heads, hi = blockIdx.y % a.heads;
  const float* q = a.q.p + bi * a.q.sb + hi * a.q.sh;
  const float* k = a.k.p + bi * a.k.sb + hi * a.k.sh;
  const float* v = a.v.p + bi * a.v.sb + hi * a.v.sh;
  float* out = const_cast<float*>(a.o.p) + bi * a.o.sb + hi * a.o.sh;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<kC>(sq, q + (long long)q0 * a.q.sr, a.q.sr, n - q0, d);
  float o[4][kC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY, l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[i][c] = 0.f;
  }
  for (int kv0 = 0; kv0 < n; kv0 += kRows) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile<kC>(sk, k + (long long)kv0 * a.k.sr, a.k.sr, n - kv0, d);
    load_tile<kC>(sv, v + (long long)kv0 * a.v.sr, a.v.sr, n - kv0, d);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(ty + 16 * i) * kLd + c], kb[i] = sk[(tx + 16 * i) * kLd + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
    // online softmax in log2 units; keys past n masked
    const int valid = n - kv0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = tx + 16 * j < valid ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float r = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mn);
        sp[(ty + 16 * i) * kPs + tx + 16 * j] = p;
        r += p;
      }
      l[i] = l[i] * alpha + half_sum(r);
#pragma unroll
      for (int c = 0; c < kC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();
    // O += P V
    for (int kk = 0; kk < kRows; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty + 16 * i) * kPs + kk];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float vb = sv[kk * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pa[i], vb, o[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (tx + 16 * c < d) out[(long long)row * a.o.sr + tx + 16 * c] = o[i][c] * inv;
    if (a.lse != nullptr && tx == 0) a.lse[(long long)blockIdx.y * n + row] = m[i] + log2f(l[i]);
  }
}

struct Bwd32Args {
  const float *q, *k, *v, *g;  // (bh, n, d) contiguous; q, k rotated with RoPE
  const float *lse, *delta;    // (bh, npad): lse +inf and delta 0 for rows >= n
  float *dq, *dk, *dv;         // (bh, n, d) contiguous, written
  const float *cos, *sin;      // (n, d) fp32 half-split tables (kRope only)
  int n, npad, d;
  float scale_log2, scale;
};

// delta = rowsum(g * o) and lse padded with +inf (rows n..npad of each bh):
// one warp per row of (bh, npad); grid ceil(rows / 8), 256 threads.
__global__ void __launch_bounds__(256)
    flash32_bwd_preprocess_kernel(const float* __restrict__ g, const float* __restrict__ o,
                                  const float* __restrict__ lse_fwd, float* __restrict__ lse,
                                  float* __restrict__ delta, long long rows, int n, int npad, int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / npad;
  const int r = (int)(row % npad);
  float acc = 0.f;
  if (r < n) {
    const long long off = (bh * n + r) * d;
    for (int c = lane; c < d; c += 32) acc += g[off + c] * o[off + c];
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    delta[row] = acc;
    lse[row] = r < n ? lse_fwd[bh * n + r] : INFINITY;
  }
}

// acc (this thread's rows ty + 16 i, columns tx + 16 c of a 64-row block)
// times mul into rows row0.. (< n) of out (row stride d); with kRope through
// the staging tile st (64 x kLd, free to overwrite) and the transposed RoPE
// Jacobian. Every thread of the block calls it.
template <int kC, bool kRope>
__device__ __forceinline__ void store_rows32(const float (&acc)[4][kC], float mul, float* st, float* out,
                                             int row0, int n, int d, const float* cos, const float* sin) {
  constexpr int kLd = F32Shape<kC>::kLd;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  if (!kRope) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (tx + 16 * c < d) out[(long long)row * d + tx + 16 * c] = acc[i][c] * mul;
    }
    return;
  }
  __syncthreads();  // every thread is done with the tile st overwrites
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) st[(ty + 16 * i) * kLd + tx + 16 * c] = acc[i][c] * mul;
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * d; idx += kThreads) {
    const int r = idx / d, c = idx % d, row = row0 + r;
    if (row < n)
      out[(long long)row * d + c] =
          attn::rope_transpose(st + r * kLd, c, d, cos + (size_t)row * d, sin + (size_t)row * d);
  }
}

// grid: (ceil(n / 64) key tiles, bh).
template <int kC, bool kRope>
__global__ void __launch_bounds__(kThreads) flash32_bwd_dkdv_kernel(const Bwd32Args a) {
  constexpr int kLd = F32Shape<kC>::kLd, kT = F32Shape<kC>::kTile;
  extern __shared__ float smem32[];
  float* sk = smem32;
  float* sv = sk + kT;
  float* sq = sv + kT;
  float* sg = sq + kT;
  float* sp = sg + kT;           // p^T, [key][query], 64 x kPs
  float* sds = sp + kRows * kPs;  // ds^T likewise
  float* sl = sds + kRows * kPs;  // lse of the query tile
  float* sd = sl + kRows;         // delta of the query tile

  const int n = a.n, d = a.d;
  const long long off = (long long)blockIdx.y * n * d;
  const float* lse = a.lse + (long long)blockIdx.y * a.npad;
  const float* delta = a.delta + (long long)blockIdx.y * a.npad;
  const int k0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<kC>(sk, a.k + off + (long long)k0 * d, d, n - k0, d);
  load_tile<kC>(sv, a.v + off + (long long)k0 * d, d, n - k0, d);
  float dk[4][kC], dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kRows) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<kC>(sq, a.q + off + (long long)q0 * d, d, n - q0, d);
    load_tile<kC>(sg, a.g + off + (long long)q0 * d, d, n - q0, d);
    if (threadIdx.x < kRows) sl[threadIdx.x] = lse[q0 + threadIdx.x], sd[threadIdx.x] = delta[q0 + threadIdx.x];
    __syncthreads();
    // S^T = K Q^T and dP^T = V G^T: keys ty + 16 i, queries tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float ka[4], va[4], qb[4], gb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = sk[(ty + 16 * i) * kLd + c], va[i] = sv[(ty + 16 * i) * kLd + c];
        qb[i] = sq[(tx + 16 * i) * kLd + c], gb[i] = sg[(tx + 16 * i) * kLd + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
          dp[i][j] = fmaf(va[i], gb[j], dp[i][j]);
        }
    }
    // P^T = exp2(S^T scale - lse), dS^T = P^T (dP^T - delta); queries past n
    // have lse = +inf, so p = 0
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const float p = exp2f(s[i][j] * a.scale_log2 - sl[qi]);
        sp[(ty + 16 * i) * kPs + qi] = p;
        sds[(ty + 16 * i) * kPs + qi] = p * (dp[i][j] - sd[qi]);
      }
    __syncthreads();
    // dV += P^T G, dK += dS^T Q
    for (int qq = 0; qq < kRows; ++qq) {
      float pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty + 16 * i) * kPs + qq], da[i] = sds[(ty + 16 * i) * kPs + qq];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float gb = sg[qq * kLd + tx + 16 * c], qb = sq[qq * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][c] = fmaf(pa[i], gb, dv[i][c]);
          dk[i][c] = fmaf(da[i], qb, dk[i][c]);
        }
      }
    }
  }
  store_rows32<kC, false>(dv, 1.f, nullptr, a.dv + off, k0, n, d, nullptr, nullptr);
  store_rows32<kC, kRope>(dk, a.scale, sq, a.dk + off, k0, n, d, a.cos, a.sin);
}

// grid: (ceil(n / 64) query tiles, bh).
template <int kC, bool kRope>
__global__ void __launch_bounds__(kThreads) flash32_bwd_dq_kernel(const Bwd32Args a) {
  constexpr int kLd = F32Shape<kC>::kLd, kT = F32Shape<kC>::kTile;
  extern __shared__ float smem32[];
  float* sq = smem32;
  float* sg = sq + kT;
  float* sk = sg + kT;
  float* sv = sk + kT;
  float* sds = sv + kT;  // ds, [query][key], 64 x kPs

  const int n = a.n, d = a.d;
  const long long off = (long long)blockIdx.y * n * d;
  const int q0 = blockIdx.x * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<kC>(sq, a.q + off + (long long)q0 * d, d, n - q0, d);
  load_tile<kC>(sg, a.g + off + (long long)q0 * d, d, n - q0, d);
  float lq[4], dl[4], dq[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long srow = (long long)blockIdx.y * a.npad + q0 + ty + 16 * i;  // rows < npad
    lq[i] = a.lse[srow], dl[i] = a.delta[srow];
#pragma unroll
    for (int c = 0; c < kC; ++c) dq[i][c] = 0.f;
  }
  for (int kv0 = 0; kv0 < n; kv0 += kRows) {
    __syncthreads();  // the previous key tile and ds are consumed
    load_tile<kC>(sk, a.k + off + (long long)kv0 * d, d, n - kv0, d);
    load_tile<kC>(sv, a.v + off + (long long)kv0 * d, d, n - kv0, d);
    __syncthreads();
    // S = Q K^T and dP = G V^T: queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sq[(ty + 16 * i) * kLd + c], ga[i] = sg[(ty + 16 * i) * kLd + c];
        kb[i] = sk[(tx + 16 * i) * kLd + c], vb[i] = sv[(tx + 16 * i) * kLd + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
        }
    }
    const int valid = n - kv0;  // keys past n masked
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = tx + 16 * j < valid ? exp2f(s[i][j] * a.scale_log2 - lq[i]) : 0.f;
        sds[(ty + 16 * i) * kPs + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    // dQ += dS K
    for (int kk = 0; kk < kRows; ++kk) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sds[(ty + 16 * i) * kPs + kk];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kb = sk[kk * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(da[i], kb, dq[i][c]);
      }
    }
  }
  store_rows32<kC, kRope>(dq, a.scale, sk, a.dq + off, q0, n, d, a.cos, a.sin);
}

// ---- The products on the tensor cores as 3xTF32 (d = 64 and 72) -----------
//
// Each fp32 operand x is split into x = hi + lo + e, hi the TF32 rounding of
// x (cvt.rna.tf32.f32's: to nearest, ties away from zero), lo that of x - hi
// (exact in fp32), |e| <= 2^-22 |x|; a product a b is accumulated in fp32
// as a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first (CUTLASS's
// OpMultiplyAddFastF32, what SDPA's fp32 path runs), each by mma.sync
// m16n8k8 tf32. The a_lo b_lo term left out is below 2^-22 of the product.
// p and ds are split alike: neither is rounded to one TF32 value.
//
// m16n8k8 tf32 fragments (g = lane / 4, t = lane % 4):
//   A (16x8, row): a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4)
//   B (8x8, col):  b0 = (k = t, n = g), b1 = (k = t+4, n = g)
//   C (16x8):      c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1)
// The second products (O = P V, dV = P^T G, dK = dS^T Q, dQ = dS K) take P
// and dS from the first products' accumulators as A without a shuffle: their k
// index (keys or queries) is summed, so k = t stands for column 2t of the
// accumulator and k = t+4 for 2t+1, and B reads rows 2t and 2t+1 to match.

// cvt.rna.tf32.f32 by integer operations: + 2^12 on the magnitude bits, the
// 13 low bits cleared (the sign bit stands apart). ptxas lowers the cvt to
// about five instructions with its NaN checks; this is two, the same bits
// for every finite x.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b as 3xTF32
__device__ __forceinline__ void mma3(float* c, const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

constexpr int kTcThreads = 256;  // 8 warps, 16 resident rows each
constexpr int kTcRows = 128;     // resident rows of a block (keys for dK/dV, queries for dQ)
constexpr int kTcTile = 64;      // rows of a streamed tile

// Tiles in shared memory have row stride kD + 4 (= 4 mod 8): a warp's
// 32-bit fragment loads, rows g (8) by columns t (4) or rows 2t and 2t + 1
// by columns g, touch 32 different banks, and ldmatrix's 8 rows of 16 bytes
// fall in 8 different 16-byte bank groups; rows stay 16-byte aligned for
// cp.async. The resident tiles (A operands, 128 rows) are fp32 and split as
// a warp loads them; each streamed tile (B operands, 64 rows) arrives in fp32
// by cp.async while the block works on the one before, and is split once for
// the block into a hi and a lo tile, which every warp then reads as they are.
template <int kD>
struct TcShape {
  static constexpr int kLd = kD + 4;
  static constexpr int kRes = kTcRows * kLd;   // floats of a resident tile
  static constexpr int kTile = kTcTile * kLd;  // floats of a streamed tile
  // two resident tiles, two streamed ones in fp32 (the next tile's) and split
  // (hi, lo: the current tile's); dK/dV adds two stages of the query tiles'
  // lse and delta
  static constexpr int kSmemDq = (2 * kRes + 6 * kTile) * 4;
  static constexpr int kSmemDkdv = kSmemDq + 4 * kTcTile * 4;
  // the forward: the next K and V tiles in fp32, the current ones split
  // (K hi, K lo, V hi, V lo); Q is staged in the split tiles before the
  // first split
  static constexpr int kSmemFwd = 6 * kTile * 4;
  // the first products' k loop unrolled whole at d = 64; at d = 72 by 3,
  // where whole it spilled (the dQ kernel 256-436 bytes) at no gain
  static constexpr int kUnrollK = kD / 8 > 8 ? 3 : kD / 8;
};

// rows 0..rows-1 of an operand at g (row stride sr, rows 16-byte aligned)
// into a tile of row stride kD + 4 by 16-byte cp.async; rows >= valid are zeros
template <int kD>
__device__ __forceinline__ void tile_async(float* s, const float* g, long long sr, int rows, int valid) {
  constexpr int kC = kD / 4, kLd = TcShape<kD>::kLd;
  for (int i = threadIdx.x; i < rows * kC; i += kTcThreads) {
    const int r = i / kC, c = 4 * (i % kC);
    const bool in = r < valid;
    cp_async16_zfill(s + r * kLd + c, in ? g + r * sr + c : g, in ? 16 : 0);
  }
}

// a streamed fp32 tile into its hi tile and the lo tile kTile floats after it
template <int kD>
__device__ __forceinline__ void split_tile(float* hi, const float* raw) {
  constexpr int kC = kD / 4, kLd = TcShape<kD>::kLd, kTile = TcShape<kD>::kTile;
  for (int i = threadIdx.x; i < kTcTile * kC; i += kTcThreads) {
    const int at = i / kC * kLd + 4 * (i % kC);
    const float4 x = *reinterpret_cast<const float4*>(raw + at);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(hi + kTile + at) = l;
  }
}

// ldmatrix's lane offsets: an 8 x 8 b16 matrix is an 8 x 4 fp32 one, lane l
// receiving element (l / 4, l % 4). A: rows 0-15 by columns 0-7 of a
// resident tile as matrices (rows 0-7 | 8-15) x (columns 0-3 | 4-7); B: two
// n tiles (rows 0-15) by columns 0-7 of a streamed tile as matrices
// (columns 0-3 | 4-7) x (rows 0-7 | 8-15).
template <int kLd>
__device__ __forceinline__ int a_lane() {
  const int l = threadIdx.x % 32;
  return ((l & 7) + (l & 8)) * kLd + (l >> 4) * 4;
}
template <int kLd>
__device__ __forceinline__ int b_lane() {
  const int l = threadIdx.x % 32;
  return ((l & 7) + (l >> 4) * 8) * kLd + (l & 8) / 2;
}

// A of a resident fp32 tile (ldmatrix, then the split); addr: this lane's row
__device__ __forceinline__ void ldsm_a(FragA& f, const float* addr) {
  uint32_t r[4];
  ldsm_x4(r[0], r[1], r[2], r[3], smem_addr(addr));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), f.hi[i], f.lo[i]);
}

// B of two n tiles of a split streamed tile (hi at addr, lo kTile floats on)
template <int kTile>
__device__ __forceinline__ void ldsm_b2(FragB& f0, FragB& f1, const float* addr) {
  ldsm_x4(f0.hi[0], f0.hi[1], f1.hi[0], f1.hi[1], smem_addr(addr));
  ldsm_x4(f0.lo[0], f0.lo[1], f1.lo[0], f1.lo[1], smem_addr(addr + kTile));
}

// B (k x n) of a split streamed tile read k-major with k permuted as above;
// s points at the hi tile's (k + 2t, n + g)
template <int kLd, int kTile>
__device__ __forceinline__ void load_b_kn(FragB& f, const float* s) {
  f.hi[0] = __float_as_uint(s[0]);
  f.hi[1] = __float_as_uint(s[kLd]);
  f.lo[0] = __float_as_uint(s[kTile]);
  f.lo[1] = __float_as_uint(s[kTile + kLd]);
}

// A from one 16 x 8 accumulator tile (k permuted as above)
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split_tf32(c[0], f.hi[0], f.lo[0]);
  split_tf32(c[2], f.hi[1], f.lo[1]);
  split_tf32(c[1], f.hi[2], f.lo[2]);
  split_tf32(c[3], f.hi[3], f.lo[3]);
}

// S = A B^T and dP = A' B'^T for this warp's 16 resident rows (A, A' at
// ra, ra', their rows 16 w..) and the 64 rows of the split streamed tiles
// sb, sb': 16 x 64 fp32 accumulators, summed from zero over the d / 8 k
// steps
template <int kD>
__device__ __forceinline__ void first_products(float (&s)[8][4], float (&dp)[8][4], const float* ra,
                                               const float* ra2, const float* sb, const float* sb2) {
  using S = TcShape<kD>;
  constexpr int kLd = S::kLd;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
  const int ao = (threadIdx.x / 32) * 16 * kLd + a_lane<kLd>(), bo = b_lane<kLd>();
#pragma unroll(S::kUnrollK)
  for (int ks = 0; ks < kD / 8; ++ks) {
    FragA a, a2;
    ldsm_a(a, ra + ao + 8 * ks);
    ldsm_a(a2, ra2 + ao + 8 * ks);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      FragB b0, b1;
      ldsm_b2<S::kTile>(b0, b1, sb + 8 * nt * kLd + bo + 8 * ks);
      mma3(s[nt], a, b0);
      mma3(s[nt + 1], a, b1);
      ldsm_b2<S::kTile>(b0, b1, sb2 + 8 * nt * kLd + bo + 8 * ks);
      mma3(dp[nt], a2, b0);
      mma3(dp[nt + 1], a2, b1);
    }
  }
}

// out += a b for this warp's 16 x 64 accumulator tile a (k permuted as
// above) and the split streamed tile b (64 x kD, hi at sb): the product
// summed from zero over the tile's 8 k steps, then added to out in fp32,
// rounded to nearest. The tensor cores truncate each sum into the
// accumulator; carried over all N / 8 steps of a row, that bias read 8e-6
// of dq, dk, dv at N = 1,024 (relative L2), where a tile's 8 steps keep
// them within 2e-6 of fp64.
template <int kD>
__device__ __forceinline__ void tile_product(float (&out)[kD / 8][4], const float (&a)[8][4], const float* sb) {
  using S = TcShape<kD>;
  const int lane = threadIdx.x % 32;
  const float* b = sb + 2 * (lane % 4) * S::kLd + lane / 4;
  float acc[kD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nd][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    FragA fa;
    acc_to_a(fa, a[kk]);
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      FragB fb;
      load_b_kn<S::kLd, S::kTile>(fb, b + 8 * kk * S::kLd + 8 * nd);
      mma3(acc[nd], fa, fb);
    }
  }
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[nd][j] += acc[nd][j];
}

// this warp's accumulator rows (16 x kD, C layout) times mul into its rows
// of the staging tile st
template <int kD>
__device__ __forceinline__ void stage_acc(float* st, const float (&acc)[kD / 8][4], float mul) {
  constexpr int kLd = TcShape<kD>::kLd;
  const int lane = threadIdx.x % 32;
  float* row = st + (threadIdx.x / 32 * 16 + lane / 4) * kLd + 2 * (lane % 4);
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    *reinterpret_cast<float2*>(row + 8 * nd) = make_float2(acc[nd][0] * mul, acc[nd][1] * mul);
    *reinterpret_cast<float2*>(row + 8 * kLd + 8 * nd) = make_float2(acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

// the 128 staged rows into rows row0.. (< n) of out (row stride kD); with
// kRope through the transposed RoPE Jacobian
template <int kD, bool kRope>
__device__ __forceinline__ void store_staged(const float* st, float* out, int row0, int n, const float* cos,
                                             const float* sin) {
  constexpr int kLd = TcShape<kD>::kLd;
  if constexpr (!kRope) {
    for (int i = threadIdx.x; i < kTcRows * kD / 4; i += kTcThreads) {
      const int r = i / (kD / 4), c = 4 * (i % (kD / 4));
      if (row0 + r < n)
        *reinterpret_cast<float4*>(out + (long long)(row0 + r) * kD + c) =
            *reinterpret_cast<const float4*>(st + r * kLd + c);
    }
  } else {
    for (int i = threadIdx.x; i < kTcRows * kD; i += kTcThreads) {
      const int r = i / kD, c = i % kD, row = row0 + r;
      if (row < n)
        out[(long long)row * kD + c] =
            attn::rope_transpose(st + r * kLd, c, kD, cos + (size_t)row * kD, sin + (size_t)row * kD);
    }
  }
}

// dK and dV of 128 keys: for each 64-query tile, S^T = K Q^T and dP^T =
// V G^T, P^T = exp2(S^T scale - lse), dS^T = P^T (dP^T - delta), dV += P^T
// G, dK += dS^T Q; warp w owns keys 16w..16w+15. grid: (ceil(n / 128), bh).
template <int kD, bool kRope>
__global__ void __launch_bounds__(kTcThreads, 1) tf32x3_bwd_dkdv_kernel(const Bwd32Args a) {
  using S = TcShape<kD>;
  constexpr int kN = kD / 8;
  extern __shared__ __align__(16) float smem_tc[];
  float* sk = smem_tc;             // resident, fp32
  float* sv = sk + S::kRes;
  float* rq = sv + S::kRes;        // the next query tile's q, g in fp32
  float* rg = rq + S::kTile;
  float* sq = rg + S::kTile;       // the current one's, split: hi, lo
  float* sg = sq + 2 * S::kTile;
  float* sl = sg + 2 * S::kTile;   // lse of the query tiles, two stages
  float* sd = sl + 2 * kTcTile;    // delta

  const int n = a.n;
  const long long off = (long long)blockIdx.y * n * kD;
  const float* lse = a.lse + (long long)blockIdx.y * a.npad;
  const float* delta = a.delta + (long long)blockIdx.y * a.npad;
  const int k0 = blockIdx.x * kTcRows;
  const int lane = threadIdx.x % 32, t = lane % 4;

  // rows q0.. of q and g into the fp32 tiles, lse and delta (padded to npad) into stage buf
  auto fetch = [&](int q0, int buf) {
    tile_async<kD>(rq, a.q + off + (long long)q0 * kD, kD, kTcTile, n - q0);
    tile_async<kD>(rg, a.g + off + (long long)q0 * kD, kD, kTcTile, n - q0);
    const int i = threadIdx.x % (kTcTile / 4);
    if (threadIdx.x < kTcTile / 4) cp_async16(sl + buf * kTcTile + 4 * i, lse + q0 + 4 * i);
    else if (threadIdx.x < kTcTile / 2) cp_async16(sd + buf * kTcTile + 4 * i, delta + q0 + 4 * i);
    cp_async_commit();
  };
  tile_async<kD>(sk, a.k + off + (long long)k0 * kD, kD, kTcRows, n - k0);
  tile_async<kD>(sv, a.v + off + (long long)k0 * kD, kD, kTcRows, n - k0);
  fetch(0, 0);

  float dk[kN][4], dv[kN][4];
#pragma unroll
  for (int nd = 0; nd < kN; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nd][j] = dv[nd][j] = 0.f;
  const int tiles = (n + kTcTile - 1) / kTcTile;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it has arrived, and every warp is done with tile it - 1's split tiles
    split_tile<kD>(sq, rq);
    split_tile<kD>(sg, rg);
    __syncthreads();
    if (it + 1 < tiles) fetch((it + 1) * kTcTile, (it + 1) & 1);  // into the fp32 tiles, now read
    const float* l = sl + (it & 1) * kTcTile;
    const float* dl = sd + (it & 1) * kTcTile;
    // S^T and dP^T: this warp's 16 keys by the tile's 64 queries
    float s[8][4], dp[8][4];
    first_products<kD>(s, dp, sk, sv, sq, sg);
    // P^T and dS^T in place; queries past n have lse = +inf, so p = 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = 8 * nt + 2 * t + (j & 1);
        const float p = exp2f(s[nt][j] * a.scale_log2 - l[qi]);
        s[nt][j] = p;
        dp[nt][j] = p * (dp[nt][j] - dl[qi]);
      }
    tile_product<kD>(dv, s, sg);  // dV += P^T G
    tile_product<kD>(dk, dp, sq);  // dK += dS^T Q
  }
  __syncthreads();  // every warp is past its last read: sv and sk stage the results
  stage_acc<kD>(sv, dv, 1.f);
  stage_acc<kD>(sk, dk, a.scale);
  __syncthreads();
  store_staged<kD, false>(sv, a.dv + off, k0, n, nullptr, nullptr);
  store_staged<kD, kRope>(sk, a.dk + off, k0, n, a.cos, a.sin);
}

// dQ of 128 queries: for each 64-key tile, S = Q K^T and dP = G V^T, P =
// exp2(S scale - lse) (keys past n masked), dS = P (dP - delta), dQ += dS K;
// warp w owns queries 16w..16w+15. grid: (ceil(n / 128), bh).
template <int kD, bool kRope>
__global__ void __launch_bounds__(kTcThreads, 1) tf32x3_bwd_dq_kernel(const Bwd32Args a) {
  using S = TcShape<kD>;
  constexpr int kN = kD / 8;
  extern __shared__ __align__(16) float smem_tc[];
  float* sq = smem_tc;             // resident, fp32
  float* sg = sq + S::kRes;
  float* rk = sg + S::kRes;        // the next key tile's k, v in fp32
  float* rv = rk + S::kTile;
  float* sk = rv + S::kTile;       // the current one's, split: hi, lo
  float* sv = sk + 2 * S::kTile;

  const int n = a.n;
  const long long off = (long long)blockIdx.y * n * kD;
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  auto fetch = [&](int kv0) {
    tile_async<kD>(rk, a.k + off + (long long)kv0 * kD, kD, kTcTile, n - kv0);
    tile_async<kD>(rv, a.v + off + (long long)kv0 * kD, kD, kTcTile, n - kv0);
    cp_async_commit();
  };
  tile_async<kD>(sq, a.q + off + (long long)q0 * kD, kD, kTcRows, n - q0);
  tile_async<kD>(sg, a.g + off + (long long)q0 * kD, kD, kTcRows, n - q0);
  fetch(0);

  // the lse and delta of this thread's rows g and g + 8 (rows past n: p = 0)
  float lq[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const long long srow = (long long)blockIdx.y * a.npad + row;
    lq[i] = row < n ? a.lse[srow] : INFINITY;
    dl[i] = row < n ? a.delta[srow] : 0.f;
  }
  float dq[kN][4];
#pragma unroll
  for (int nd = 0; nd < kN; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[nd][j] = 0.f;
  const int tiles = (n + kTcTile - 1) / kTcTile;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it has arrived, and every warp is done with tile it - 1's split tiles
    split_tile<kD>(sk, rk);
    split_tile<kD>(sv, rv);
    __syncthreads();
    if (it + 1 < tiles) fetch((it + 1) * kTcTile);
    // S and dP: this warp's 16 queries by the tile's 64 keys
    float s[8][4], dp[8][4];
    first_products<kD>(s, dp, sq, sg, sk, sv);
    // dS in place of dP; keys past n masked
    const int valid = n - it * kTcTile;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = 8 * nt + 2 * t + (j & 1) < valid ? exp2f(s[nt][j] * a.scale_log2 - lq[j / 2]) : 0.f;
        dp[nt][j] = p * (dp[nt][j] - dl[j / 2]);
      }
    tile_product<kD>(dq, dp, sk);  // dQ += dS K
  }
  __syncthreads();
  stage_acc<kD>(sq, dq, a.scale);
  __syncthreads();
  store_staged<kD, kRope>(sq, a.dq + off, q0, n, a.cos, a.sin);
}

// ---- The forward on the tensor cores as 3xTF32 (d = 64 and 72) ------------
//
// A block of 8 warps owns 128 query rows, warp w rows 16w..16w+15, whose Q
// fragments it loads and splits once and keeps in registers, and streams
// the head's keys and values in 64-row tiles as the backward's dQ kernel
// streams them (the next tile's fp32 copy in flight, the current one split
// once for the block). Per tile: S = Q K^T as 3xTF32, summed from zero over
// the d / 8 k steps; the online softmax in exp2 units in the C layout, a
// row's statistics across the quad of lanes that holds it; O <- O alpha +
// P V, P passed from S's accumulators as the A operand (split like any
// operand) and the tile's P V summed from zero before it is added in fp32
// (tile_product). On an H100, Q resident in shared memory and split at
// every k step took fewer registers and ran a little slower, and two
// stages of K and V (the block splitting tile it + 1 beside tile it's
// products, one barrier a tile) ran no faster (PERF.md).
// grid: (ceil(n / 128), batch * heads).
template <int kD>
__global__ void __launch_bounds__(kTcThreads, 1) tf32x3_fwd_kernel(const Fwd32Args a) {
  using S = TcShape<kD>;
  constexpr int kN = kD / 8, kLd = S::kLd;
  extern __shared__ __align__(16) float smem_tc[];
  float* rk = smem_tc;            // the next key tile's k, v in fp32
  float* rv = rk + S::kTile;
  float* sk = rv + S::kTile;      // the current one's, split: hi, lo
  float* sv = sk + 2 * S::kTile;
  float* sq = sk;                 // Q in fp32 (128 rows), read before the first split

  const int n = a.n;
  const int bi = blockIdx.y / a.heads, hi = blockIdx.y % a.heads;
  const float* q = a.q.p + bi * a.q.sb + hi * a.q.sh;
  const float* k = a.k.p + bi * a.k.sb + hi * a.k.sh;
  const float* v = a.v.p + bi * a.v.sb + hi * a.v.sh;
  float* out = const_cast<float*>(a.o.p) + bi * a.o.sb + hi * a.o.sh;
  const int q0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  auto fetch = [&](int kv0) {
    tile_async<kD>(rk, k + (long long)kv0 * a.k.sr, a.k.sr, kTcTile, n - kv0);
    tile_async<kD>(rv, v + (long long)kv0 * a.v.sr, a.v.sr, kTcTile, n - kv0);
    cp_async_commit();
  };
  tile_async<kD>(sq, q + (long long)q0 * a.q.sr, a.q.sr, kTcRows, n - q0);
  fetch(0);  // Q lands with the first tile
  cp_async_wait<0>();
  __syncthreads();
  FragA qf[kN];  // this warp's 16 rows of Q, split
#pragma unroll
  for (int ks = 0; ks < kN; ++ks) ldsm_a(qf[ks], sq + warp * 16 * kLd + a_lane<kLd>() + 8 * ks);

  float o[kN][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < kN; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nd][j] = 0.f;
  const int tiles = (n + kTcTile - 1) / kTcTile;
  const int bo = b_lane<kLd>();
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it has arrived, and every warp is done with tile it - 1's split tiles (and Q)
    split_tile<kD>(sk, rk);
    split_tile<kD>(sv, rv);
    __syncthreads();
    if (it + 1 < tiles) fetch((it + 1) * kTcTile);
    // S = Q K^T: this warp's 16 queries by the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kN; ++ks)
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        FragB b0, b1;
        ldsm_b2<S::kTile>(b0, b1, sk + 8 * nt * kLd + bo + 8 * ks);
        mma3(s[nt], qf[ks], b0);
        mma3(s[nt + 1], qf[ks], b1);
      }
    // the online softmax in exp2 units; keys past n masked
    const int valid = n - it * kTcTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = 8 * nt + 2 * t + (j & 1) < valid ? s[nt][j] * a.scale_log2 : -INFINITY;
        s[nt][j] = x;
        mx[j / 2] = fmaxf(mx[j / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], attn::quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[nt][j] - m[j / 2]);
        s[nt][j] = p;
        l[j / 2] += p;  // this lane's part of the row's sum
      }
#pragma unroll
    for (int nd = 0; nd < kN; ++nd)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[nd][j] *= alpha[j / 2];
    tile_product<kD>(o, s, sv);  // O += P V
  }
  // O / l through o's strides, lse = m + log2 l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = attn::quad_sum(l[i]);
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= n) continue;
    const float inv = 1.f / sum;
    float* dst = out + (long long)row * a.o.sr + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kN; ++nd)
      *reinterpret_cast<float2*>(dst + 8 * nd) = make_float2(o[nd][2 * i] * inv, o[nd][2 * i + 1] * inv);
    if (a.lse != nullptr && t == 0) a.lse[(long long)blockIdx.y * n + row] = m[i] + log2f(sum);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int kC>
cudaError_t fwd_launch(const Fwd32Args& a, int bh, cudaStream_t s) {
  constexpr int kSmem = (3 * F32Shape<kC>::kTile + kRows * kPs) * 4;
  const cudaError_t e = set_smem(flash32_fwd_kernel<kC>, kSmem);
  if (e != cudaSuccess) return e;
  flash32_fwd_kernel<kC><<<dim3((a.n + kRows - 1) / kRows, bh), kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

#define LDMAE_COLUMN_CLASSES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

template <int kD>
cudaError_t tc_fwd_launch(const Fwd32Args& a, int bh, cudaStream_t s) {
  constexpr int kSmem = TcShape<kD>::kSmemFwd;
  const cudaError_t e = set_smem(tf32x3_fwd_kernel<kD>, kSmem);
  if (e != cudaSuccess) return e;
  tf32x3_fwd_kernel<kD><<<dim3((a.n + kTcRows - 1) / kTcRows, bh), kTcThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

// rows 16-byte aligned wherever (b, h, row) puts them
bool aligned16(const Operand& x) {
  return reinterpret_cast<uintptr_t>(x.p) % 16 == 0 && x.sb % 4 == 0 && x.sh % 4 == 0 && x.sr % 4 == 0;
}

// The forward: on the tensor cores as 3xTF32 at d = 64 and 72 when every
// operand's rows are 16-byte aligned, flash32_fwd_kernel otherwise.
cudaError_t fwd_dispatch(const Fwd32Args& a, int bh, cudaStream_t s) {
  if (a.d < 1 || a.d > 128) return cudaErrorInvalidValue;
  if ((a.d == 64 || a.d == 72) && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.o))
    return a.d == 64 ? tc_fwd_launch<64>(a, bh, s) : tc_fwd_launch<72>(a, bh, s);
  switch ((a.d + 15) / 16) {
#define LDMAE_CASE(C) \
  case C: return fwd_launch<C>(a, bh, s);
    LDMAE_COLUMN_CLASSES(LDMAE_CASE)
#undef LDMAE_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <int kC, bool kRope>
cudaError_t bwd_launch(const Bwd32Args& b, int bh, cudaStream_t s) {
  constexpr int kT = F32Shape<kC>::kTile;
  constexpr int kDkdv = (4 * kT + 2 * kRows * kPs + 2 * kRows) * 4, kDq = (4 * kT + kRows * kPs) * 4;
  const dim3 grid((b.n + kRows - 1) / kRows, bh);
  cudaError_t e = set_smem(flash32_bwd_dkdv_kernel<kC, kRope>, kDkdv);
  if (e != cudaSuccess) return e;
  flash32_bwd_dkdv_kernel<kC, kRope><<<grid, kThreads, kDkdv, s>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(flash32_bwd_dq_kernel<kC, kRope>, kDq)) != cudaSuccess) return e;
  flash32_bwd_dq_kernel<kC, kRope><<<grid, kThreads, kDq, s>>>(b);
  return cudaGetLastError();
}

template <int kD, bool kRope>
cudaError_t tc_launch(const Bwd32Args& b, int bh, cudaStream_t s) {
  using S = TcShape<kD>;
  const dim3 grid((b.n + kTcRows - 1) / kTcRows, bh);
  cudaError_t e = set_smem(tf32x3_bwd_dkdv_kernel<kD, kRope>, S::kSmemDkdv);
  if (e != cudaSuccess) return e;
  tf32x3_bwd_dkdv_kernel<kD, kRope><<<grid, kTcThreads, S::kSmemDkdv, s>>>(b);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(tf32x3_bwd_dq_kernel<kD, kRope>, S::kSmemDq)) != cudaSuccess) return e;
  tf32x3_bwd_dq_kernel<kD, kRope><<<grid, kTcThreads, S::kSmemDq, s>>>(b);
  return cudaGetLastError();
}

// The backward on contiguous (bh, n, d) q, k (rotated for RoPE), v, g and
// the forward's output o and lse_fwd (bh, n): the preprocess, then the dK/dV
// and dQ kernels, on the tensor cores as 3xTF32 at d = 64 and 72 with
// 16-byte aligned rows (vec == 4), the SIMT kernels otherwise; lse, delta
// (bh, npad) fp32 scratch.
template <bool kRope>
cudaError_t backward(const float* q, const float* k, const float* v, const float* g, const float* o,
                     const float* lse_fwd, const float* cos, const float* sin, float* dq, float* dk,
                     float* dv, float* lse, float* delta, int bh, int n, int d, int vec, cudaStream_t s) {
  if (o == nullptr || lse_fwd == nullptr || d < 1 || d > 128) return cudaErrorInvalidValue;
  const int npad = (n + kRows - 1) / kRows * kRows;
  const long long rows = (long long)bh * npad;
  flash32_bwd_preprocess_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(g, o, lse_fwd, lse, delta, rows, n,
                                                                           npad, d);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Bwd32Args b{q, k, v, g, lse, delta, dq, dk, dv, cos, sin, n, npad, d,
                    1.4426950408889634f / sqrtf((float)d), 1.f / sqrtf((float)d)};
  if (vec == 4 && d == 64) return tc_launch<64, kRope>(b, bh, s);
  if (vec == 4 && d == 72) return tc_launch<72, kRope>(b, bh, s);
  switch ((d + 15) / 16) {
#define LDMAE_CASE(C) \
  case C: return bwd_launch<C, kRope>(b, bh, s);
    LDMAE_COLUMN_CLASSES(LDMAE_CASE)
#undef LDMAE_CASE
    default: return cudaErrorInvalidValue;
  }
}

Fwd32Args fwd_args(Operand q, Operand k, Operand v, Operand o, float* lse, int heads, int n, int d) {
  return Fwd32Args{q, k, v, o, lse, heads, n, d, 1.4426950408889634f / sqrtf((float)d)};
}

Fwd32Args contiguous_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int n, int d) {
  using attn::contiguous;
  return fwd_args(contiguous<float>(q, n, d), contiguous<float>(k, n, d), contiguous<float>(v, n, d),
                  contiguous<float>(out, n, d), lse, 1, n, d);
}

// The RoPE pre-pass's arguments for contiguous (bh, n, d) q, k and scratch qr, kr.
NormRopeArgs rope_args(const void* q, const void* k, const float* cos, const float* sin, void* qr, void* kr,
                       int bh, int n, int d) {
  using attn::contiguous;
  return NormRopeArgs{{contiguous<float>(q, n, d), contiguous<float>(k, n, d)},
                      {contiguous<float>(qr, n, d), contiguous<float>(kr, n, d)},
                      {nullptr, nullptr}, cos, sin, (long long)bh * n, 1, n, d, 0.f};
}

}  // namespace

// The entry points of flash_attention.cu with fp32 tensors in place of bf16
// (same arguments, so the wrappers pick the library by dtype). lse, when
// not null, receives the (bh, n) log2 denominators at every head dim; vec
// is used by the RoPE pre-pass only (fwd_dispatch reads the operands'
// alignment itself).
extern "C" int ldmae_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         float* lse, int bh, int n, int d, int vec, void* stream) {
  return static_cast<int>(fwd_dispatch(contiguous_fwd(q, k, v, out, lse, n, d), bh, static_cast<cudaStream_t>(stream)));
}

extern "C" int ldmae_flash_attention_rope_fwd(const void* q, const void* k, const void* v,
                                              const float* cos, const float* sin, void* qr,
                                              void* kr, void* out, float* lse, int bh, int n, int d,
                                              int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = attn::norm_rope(rope_args(q, k, cos, sin, qr, kr, bh, n, d), false, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(fwd_dispatch(contiguous_fwd(qr, kr, v, out, lse, n, d), bh, s));
}

extern "C" int ldmae_flash_attention_qknorm_rope_fwd(const void* q, const void* k, const void* v,
                                                     const float* qw, const float* kw,
                                                     const float* cos, const float* sin, void* qr,
                                                     void* kr, void* out, int b, int h, int n, int d,
                                                     long long sb, long long sh, long long sr, int vec,
                                                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto strided = [&](const void* p) { return Operand{static_cast<const float*>(p), sb, sh, static_cast<int>(sr)}; };
  auto dense = [&](const void* p) { return attn::bhnd<float>(p, h, n, d); };
  const NormRopeArgs a{{strided(q), strided(k)}, {dense(qr), dense(kr)}, {qw, kw}, cos, sin,
                       (long long)b * h * n, h, n, d, eps};
  const cudaError_t e = attn::norm_rope(a, true, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      fwd_dispatch(fwd_args(dense(qr), dense(kr), strided(v), dense(out), nullptr, h, n, d), b * h, s));
}

extern "C" int ldmae_flash_attention_fused_rope_fwd(
    const void* q, const void* k, const void* v, const float* cos, const float* sin, void* qr,
    void* kr, void* out, int b, int h, int n, int d, long long q_rs, long long k_rs,
    long long v_rs, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hd = (long long)h * d;
  auto rows = [&](const void* p, long long rs) {
    return Operand{static_cast<const float*>(p), n * rs, d, static_cast<int>(rs)};
  };
  const NormRopeArgs a{{rows(q, q_rs), rows(k, k_rs)},
                       {rows(qr, hd), rows(kr, hd)},
                       {nullptr, nullptr}, cos, sin, (long long)b * h * n, h, n, d, 0.f};
  const cudaError_t e = attn::norm_rope(a, false, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      fwd_dispatch(fwd_args(rows(qr, hd), rows(kr, hd), rows(v, v_rs), rows(out, hd), nullptr, h, n, d), b * h, s));
}

// o and lse_fwd (the forward's output and lse) are required; dq_acc is unused.
extern "C" int ldmae_flash_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                         const void* o, const float* lse_fwd, void* dq, void* dk,
                                         void* dv, float* lse, float* delta, float* dq_acc, int bh,
                                         int n, int d, int vec, void* stream) {
  return static_cast<int>(backward<false>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(o), lse_fwd, nullptr, nullptr,
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), lse, delta, bh, n, d,
      vec, static_cast<cudaStream_t>(stream)));
}

extern "C" int ldmae_flash_attention_rope_bwd(const void* q, const void* k, const void* v,
                                              const void* g, const void* o, const float* lse_fwd,
                                              const float* cos, const float* sin, void* qr, void* kr,
                                              void* dq, void* dk, void* dv, float* lse, float* delta,
                                              float* dq_acc, int bh, int n, int d, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = attn::norm_rope(rope_args(q, k, cos, sin, qr, kr, bh, n, d), false, vec, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(backward<true>(
      static_cast<const float*>(qr), static_cast<const float*>(kr), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(o), lse_fwd, cos, sin, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), lse, delta, bh, n, d, vec, s));
}
