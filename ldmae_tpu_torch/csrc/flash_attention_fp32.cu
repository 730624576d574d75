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
// rounded. RoPE and the qk-norm run the shared pre-pass (attention_common.cuh)
// instantiated for fp32, where its roundings to the element type vanish.
//
// What bounds them: every product runs on the CUDA cores' fp32 FMA (67
// TFLOP/s; the tensor cores take bf16 or TF32, and TF32 keeps 10 mantissa
// bits, far from the plain fp32 version). At (32, 12, 1024, 64) the forward
// does 4 b h N^2 d = 1.03e11 flops, 1.5 ms at that rate. The design is the
// plain tiled one, right first: a block of 256 threads owns 64 query rows
// (forward, dQ) or 64 keys (dK/dV) and streams 64-row tiles of the other
// side through shared memory (rows padded to an odd stride, so a column of
// rows hits 32 banks); thread (ty, tx) of 16 x 16 owns rows ty + 16 i and
// columns tx + 16 j (i, j < 4) of each 64 x 64 score tile, and columns tx +
// 16 c of each output row; the probabilities go through a shared 64 x 64
// tile into the second product. Shared-memory loads, two per FMA in the
// score products, bound it before the FMA pipes do: speed at fp32 is later
// work.
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

cudaError_t fwd_dispatch(const Fwd32Args& a, int bh, cudaStream_t s) {
  if (a.d < 1 || a.d > 128) return cudaErrorInvalidValue;
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

// The backward on contiguous (bh, n, d) q, k (rotated for RoPE), v, g and
// the forward's output o and lse_fwd (bh, n): the preprocess, then the dK/dV
// and dQ kernels; lse, delta (bh, npad) fp32 scratch.
template <bool kRope>
cudaError_t backward(const float* q, const float* k, const float* v, const float* g, const float* o,
                     const float* lse_fwd, const float* cos, const float* sin, float* dq, float* dk,
                     float* dv, float* lse, float* delta, int bh, int n, int d, cudaStream_t s) {
  if (o == nullptr || lse_fwd == nullptr || d < 1 || d > 128) return cudaErrorInvalidValue;
  const int npad = (n + kRows - 1) / kRows * kRows;
  const long long rows = (long long)bh * npad;
  flash32_bwd_preprocess_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(g, o, lse_fwd, lse, delta, rows, n,
                                                                           npad, d);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Bwd32Args b{q, k, v, g, lse, delta, dq, dk, dv, cos, sin, n, npad, d,
                    1.4426950408889634f / sqrtf((float)d), 1.f / sqrtf((float)d)};
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
// is used by the RoPE pre-pass only.
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
      static_cast<cudaStream_t>(stream)));
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
      static_cast<float*>(dk), static_cast<float*>(dv), lse, delta, bh, n, d, s));
}
