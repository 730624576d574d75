// SwiGLU first stage for Hopper (sm_90a): x @ w12^T + b12, then silu(x1) * x2.
//
// Replaces the Pallas TPU kernel fused_matmul_silu (_kernel_matmul_silu in
// ldmae_tpu/ops/fused_adaln.py, pallas_call at :199): (M, D) @ (D, 2H) +
// bias with fp32 accumulation, silu(x1) * x2 in fp32, one rounding to bf16;
// the (M, 2H) pre-activation never reaches device memory.
//
// What bounds it: at the sampling shape (M = 16,384, D = 768, 2H = 4,096) it
// does 2 M D 2H = 1.03e11 flops (0.104 ms at 989 TFLOP/s) against
// (M D + 2H D + M H) * 2 bytes (0.031 ms at 3.35 TB/s): the tensor cores
// bound it, and only wgmma reaches their full rate. Feeding them takes loads
// that never stall the products, and each block tile must be wide enough
// that its operands come from L2 few times.
//
// Design: a persistent, warp-specialised wgmma GEMM with two consumer
// warpgroups in ping-pong, in clusters of four CTAs. A tile is 64 rows by 128
// columns of H; a unit is the same columns in 4 x 64 consecutive rows, one
// tile per CTA of a cluster. Each cluster walks the units, H fastest, so the
// clusters in flight share their rows of x in L2 (w12 fits L2 whole).
// Warpgroup 0 of each CTA is the producer: one thread loads, by TMA with
// 128-byte swizzle, the CTA's 64 x 64 block of x and one quarter of the
// 256 x 64 block of w12 (rows j..j+63 and j+64..j+127 of x1 in CTAs 0 and
// 1, the same rows of x2, from H + j, in CTAs 2 and 3), multicast into every
// CTA of the cluster, so the four read their w12 block from L2 once: a CTA
// loads 16 KB a stage for 2 x 64 x 256 x 64 flops. (Without clusters the
// 64-row tiles ran at the L2's rate, not the tensor cores'; clusters of two,
// 24 KB a stage, left #4 10 % slower than torch.addmm, PERF.md.) Five 40 KB
// stages each have a full mbarrier (the stage's bytes) and an empty one,
// released by the consuming warps of every CTA of the cluster, since every
// producer writes into all of them. Warpgroups 1 and 2 consume
// alternate tiles: wgmma m64n256k16 with x1 and x2 side by side as one
// accumulator (128 fp32 registers a thread), so the thread holding column c
// of x1 holds column c of x2 too (registers i and i + 64) and the gate pairs
// them in registers. They take turns through two named barriers, so one
// warpgroup's mainloop has the tensor cores while the other runs its
// epilogue (bias, silu by __expf and __fdividef, bf16, 4-byte stores): with
// both warpgroups on one 128-row tile, the epilogue, which then stalls the
// tensor cores, took as long as the products. setmaxnreg moves registers
// from the producer (40) to the consumers (232).
//
// Shape gate as in the TPU kernel (checked by the wrapper): M % 128 == 0,
// D % 128 == 0, 2H % 256 == 0 (the rows of a unit past M arrive as zeros
// from TMA and are not stored).
//
// The same kernel without the gate (kGate false) is `dense`'s linear layer
// in bf16 with an fp32 bias (ops/linear.py): the JAX package adds the fp32
// bias to the fp32 product and rounds once, and cuBLASLt's bias epilogue
// takes the bias only in the output's dtype (a bf16 bias would round it
// first). It takes any m and n, d a multiple of 8 (TMA zero-fills past the
// tensor; the epilogue stores rows < m, columns < n). Its epilogue stages
// each 64 x 256 output tile in shared memory and writes whole rows (one ring
// stage fewer makes room for the two tiles).
#include "hopper.cuh"

namespace {

constexpr int kBM = 64;         // output rows per tile: one consumer warpgroup's
constexpr int kBN = 128;        // output columns (of H) per tile: 256 accumulator columns
constexpr int kBK = 64;         // depth per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 5;      // TMA ring depth
constexpr int kCluster = 4;     // CTAs sharing each w12 block, along M (one part each)
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kATile = kBM * kBK * 2;      // 8 KB of x
constexpr int kBTile = 2 * kBN * kBK * 2;  // 32 KB of w12: the x1 rows, then the x2 rows
constexpr int kWRows = 2 * kBN / kCluster;  // rows of that block each CTA of a cluster loads
constexpr int kStageBytes = kATile + kBTile;
constexpr int kOutTile = kBM * 2 * kBN * 2;  // a consumer's 64 x 256 bf16 output tile (dense's staging)
// The ring (dense: one stage fewer, for the two output staging tiles), +
// slack to align the ring to 1 KB.
template <bool kGate>
struct Smem {
  static constexpr int kRing = kGate ? kStages : kStages - 1;
  static constexpr int kBytes = kRing * kStageBytes + (kGate ? 0 : 2 * kOutTile) + 1024;
};

// kGate: the SwiGLU stage (out (m, h) = silu(x1) x2, the w12 block of a
// unit its x1 rows j.. and x2 rows h + j..); without it, the plain linear
// layer of `dense` (out (m, h) = x w^T + bias, h the output columns, the w
// block of a unit 256 consecutive rows, so each thread's 128 accumulators
// are 32 column blocks of 8 of one output tile).
template <bool kGate>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    matmul_silu_kernel(const __grid_constant__ CUtensorMap tmap_x,
                       const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ bias,
                       bf16* __restrict__ out, int m, int d, int h) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int kRing = Smem<kGate>::kRing;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const uint32_t rank = hopper::cluster_rank();
  const int cluster = blockIdx.x / kCluster, nclusters = gridDim.x / kCluster;
  // dense takes any m and ragged n and d: TMA fills rows and depth past the
  // tensor with zeros, and the epilogue stores only rows < m, columns < h
  const int tiles_n = kGate ? h / kBN : (h + 2 * kBN - 1) / (2 * kBN), nk = (d + kBK - 1) / kBK;
  const int nunits = (m + kBM * kCluster - 1) / (kBM * kCluster) * tiles_n;
  // broadcast, so that ptxas sees the role branches as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      hopper::mbar_init(&full[s], 1);  // the producer's arrival with the stage's bytes
      hopper::mbar_init(&empty[s], 4 * kCluster);  // each warp of the consuming warpgroups
    }
    hopper::fence_mbar_init();
  }
  hopper::cluster_sync();  // every CTA's barriers exist before any signals another's

  if (wg == 0) {
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int unit = cluster; unit < nunits; unit += nclusters) {
        const int m0 = (unit / tiles_n * kCluster + rank) * kBM, n0 = unit % tiles_n * kBN * (kGate ? 1 : 2);
        for (int kb = 0; kb < nk; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * kStageBytes;
          hopper::mbar_expect_tx(&full[stage], kStageBytes);
          hopper::tma_load_2d(st, &tmap_x, &full[stage], kb * kBK, m0);
          // this CTA's part of the stacked (x1 | x2) block (kGate) or of the
          // 256-row w block, into every CTA of the cluster
          const int sub = rank * kWRows;
          const int wrow = !kGate ? n0 + sub : sub < kBN ? n0 + sub : h + n0 + sub - kBN;
          hopper::tma_load_2d_multicast(st + kATile + rank * (kBTile / kCluster), &tmap_w, &full[stage],
                                        kb * kBK, wrow, (1u << kCluster) - 1);
          if (++stage == kRing) stage = 0, phase ^= 1;
        }
      }
      // Before this CTA may exit, the other CTA's consumers must be done with
      // the last stages: they arrive on this CTA's empty barriers.
      for (int i = 0; i < kRing; ++i) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == kRing) stage = 0, phase ^= 1;
      }
    }
  } else {
    hopper::reg_alloc<232>();
    const int c = wg - 1;  // units j = c, c + 2, ... of this CTA's sequence
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    // a stage is free once the consuming warps of every CTA are done with it
    auto release = [&](int s) {
      if (lane == 0)
        for (int cta = 0; cta < kCluster; ++cta) hopper::mbar_arrive_cluster(&empty[s], cta);
    };
    // column block j of 8 (0..31): acc[4j], acc[4j+1] at row 16 warp + g,
    // columns 8j + 2t, +1; acc[4j+2], acc[4j+3] at row + 8. Blocks 0..15 are
    // x1, 16..31 the same columns of x2.
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    // The two warpgroups take turns: unit j's mainloop starts after unit
    // j - 1's has waited on all its stages (named barrier 1 + c, arrived at
    // by the other warpgroup), so a warpgroup never waits on a stage more
    // than one phase ahead (the parity of a wait names no more than that),
    // and each mainloop has the tensor cores while the other's epilogue runs.
    if (c == 1) hopper::bar_arrive(1, 256);
    for (int j = c;; j += 2) {
      const int unit = cluster + j * nclusters;
      if (unit >= nunits) break;
      hopper::bar_sync(1 + c, 256);
      const int m0 = (unit / tiles_n * kCluster + rank) * kBM, n0 = unit % tiles_n * kBN * (kGate ? 1 : 2);
      int pos = j * nk, prev = 0;  // place of this unit's first stage in the ring's sequence
      for (int kb = 0; kb < nk; ++kb, ++pos) {
        const int stage = pos % kRing;
        hopper::mbar_wait(&full[stage], (pos / kRing) & 1);
        const unsigned char* st = ring + stage * kStageBytes;
        const uint64_t da = hopper::desc_sw128(st, 16, 1024);
        const uint64_t db = hopper::desc_sw128(st + kATile, 16, 1024);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)  // 16 deep = 32 bytes along the swizzled row
          hopper::wgmma_m64n256k16_ss(acc, da + 2 * k, db + 2 * k, kb > 0 || k > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kb > 0) release(prev);
        prev = stage;
      }
      if (unit + nclusters < nunits) hopper::bar_arrive(2 - c, 256);  // unit j + 1 exists
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(prev);

      const int row = m0 + warp * 16 + g;
      if (!kGate) {
        // acc + bias in fp32, one rounding to bf16, staged in this
        // warpgroup's 64 x 256 tile (rows of 512 bytes, the 16-byte chunk j
        // of row r at chunk j ^ (r % 8), so a warp's stores hit every bank),
        // then written as full 512-byte rows, 16 bytes a thread: the 4-byte
        // stores of the accumulator layout straight to memory, 8 rows a
        // warp, left the epilogue longer than the other warpgroup's mainloop.
        unsigned char* stile = ring + kRing * kStageBytes + c * kOutTile;
        hopper::bar_sync(3 + c, 128);  // this warpgroup has read the last unit's tile
#pragma unroll
        for (int jb = 0; jb < 32; ++jb) {
          const int col = n0 + jb * 8 + 2 * t;
          const float b0 = col < h ? bias[col] : 0.f, b1 = col + 1 < h ? bias[col + 1] : 0.f;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = warp * 16 + g + 8 * hr;
            *reinterpret_cast<uint32_t*>(stile + r * 512 + ((jb ^ (r & 7)) << 4) + 4 * t) =
                pack_bf16(acc[4 * jb + 2 * hr] + b0, acc[4 * jb + 2 * hr + 1] + b1);
          }
        }
        hopper::bar_sync(3 + c, 128);
        const int lt = threadIdx.x % 128;
        // rows of 16-byte multiples take 16-byte stores; a ragged h (a patch
        // of 14 x 14 x 3 = 588 columns) stores the valid columns one by one
        const bool whole = h % 8 == 0;
#pragma unroll 4
        for (int i = lt; i < kBM * 32; i += 128) {
          const int r = i / 32, j = i % 32, col = n0 + 8 * j;
          if (m0 + r >= m || col >= h) continue;
          const unsigned char* src = stile + r * 512 + ((j ^ (r & 7)) << 4);
          bf16* dst = out + (size_t)(m0 + r) * h + col;
          if (whole) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < 8 && col + e < h; ++e) dst[e] = reinterpret_cast<const bf16*>(src)[e];
          }
        }
        continue;
      }
#pragma unroll
      for (int jb = 0; jb < 16; ++jb) {
        const int col = n0 + jb * 8 + 2 * t;
        const float2 b1 = *reinterpret_cast<const float2*>(bias + col);
        const float2 b2 = *reinterpret_cast<const float2*>(bias + h + col);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float x1a = acc[4 * jb + 2 * hr] + b1.x, x1b = acc[4 * jb + 2 * hr + 1] + b1.y;
          const float x2a = acc[64 + 4 * jb + 2 * hr] + b2.x;
          const float x2b = acc[64 + 4 * jb + 2 * hr + 1] + b2.y;
          // silu(x1) x2 = x1 x2 / (1 + e^-x1); 1 + e^-x1 = inf gives 0
          const float ya = __fdividef(x1a, 1.f + __expf(-x1a)) * x2a;
          const float yb = __fdividef(x1b, 1.f + __expf(-x1b)) * x2b;
          if (row + 8 * hr < m) *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8 * hr) * h + col) = pack_bf16(ya, yb);
        }
      }
    }
  }
}

// Clusters of this kernel the current device can hold at once (some SMs
// may not pair up inside their GPC), looked up once per device, after its
// shared-memory opt-in is set (the query fails without it).
template <bool kGate>
int max_clusters() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem<kGate>::kBytes;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, matmul_silu_kernel<kGate>, &cfg) != cudaSuccess) return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

// The wgmma kernel on x (m, d) and w (rows, d), out (m, h); units of
// 2 x 64 rows and `unit_cols` output columns.
template <bool kGate>
cudaError_t launch(const void* x, const void* w, int w_rows, const float* bias, void* out, int m, int d, int h,
                   int unit_cols, cudaStream_t stream) {
  CUtensorMap tmap_x, tmap_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t w_dims[2] = {(cuuint64_t)d, (cuuint64_t)w_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t x_box[2] = {kBK, kBM}, w_box[2] = {kBK, kWRows};
  cudaError_t e = hopper::make_tmap_bf16(&tmap_x, x, 2, x_dims, strides, x_box);
  if (e == cudaSuccess) e = hopper::make_tmap_bf16(&tmap_w, w, 2, w_dims, strides, w_box);
  // Dynamic shared memory above 48 KB needs an opt-in, which CUDA keeps per
  // device: set it at every launch (cheap) so any card the caller picks has it.
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(matmul_silu_kernel<kGate>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<kGate>::kBytes);
  if (e != cudaSuccess) return e;
  const int nunits = (m + kBM * kCluster - 1) / (kBM * kCluster) * ((h + unit_cols - 1) / unit_cols);
  const int clusters = max_clusters<kGate>();
  if (clusters <= 0) return cudaErrorLaunchOutOfResources;
  const int grid = kCluster * (nunits < clusters ? nunits : clusters);
  matmul_silu_kernel<kGate><<<grid, kThreads, Smem<kGate>::kBytes, stream>>>(tmap_x, tmap_w, bias, static_cast<bf16*>(out),
                                                                    m, d, h);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 (the configs' other compute dtype): the same function with fp32
// operands, products and output, for the configs' float32 compute dtype
// (the TPU kernel's astype(x.dtype) of w12 and output are then no-ops). The
// tensor cores take no fp32 (TF32 keeps 10 mantissa bits, far from the plain
// fp32 product), so this is a plain tiled SIMT GEMM on the FMA pipes (67
// TFLOP/s: 1.5 ms at the B/1 shape), right first: a block of 256 threads
// computes a 64-row tile of x1 and the same columns of x2 (64 + 64 of 2H)
// over depth steps of 16 staged in shared memory (x and both w12 blocks
// transposed, so each thread reads its 4 rows and 4 + 4 columns as float4),
// 4 x 4 outputs of each a thread; the epilogue adds the bias and forms
// silu(x1) x2 = x1 x2 / (1 + e^-x1) in fp32 (expf and a true division, as the
// plain version's sigmoid). Shape gate as above.
constexpr int kSBM = 64, kSBN = 64, kSBK = 16, kSLd = 64 + 4;

__global__ void __launch_bounds__(256)
    matmul_silu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w12,
                           const float* __restrict__ bias, float* __restrict__ out, int m, int d, int h) {
  __shared__ __align__(16) float sa[kSBK][kSLd], sb1[kSBK][kSLd], sb2[kSBK][kSLd];
  const int m0 = blockIdx.y * kSBM, n0 = blockIdx.x * kSBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc1[4][4], acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kSBK) {
    // 64 rows x 16 deep of x, and of the x1 and x2 rows of w12, transposed
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x + 256 * i, r = idx / kSBK, c = idx % kSBK;
      sa[c][r] = x[(size_t)(m0 + r) * d + k0 + c];
      sb1[c][r] = w12[(size_t)(n0 + r) * d + k0 + c];
      sb2[c][r] = w12[(size_t)(h + n0 + r) * d + k0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[kk][4 * ty]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb1[kk][4 * tx]);
      const float4 b2 = *reinterpret_cast<const float4*>(&sb2[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, b1v[4] = {b1.x, b1.y, b1.z, b1.w},
                  b2v[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[i][j] = fmaf(av[i], b1v[j], acc1[i][j]);
          acc2[i][j] = fmaf(av[i], b2v[j], acc2[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      const float x1 = acc1[i][j] + bias[col], x2 = acc2[i][j] + bias[h + col];
      y[j] = __fdiv_rn(x1, __fadd_rn(1.f, expf(-x1))) * x2;
    }
    *reinterpret_cast<float4*>(out + (size_t)(m0 + 4 * ty + i) * h + n0 + 4 * tx) = make_float4(y[0], y[1], y[2], y[3]);
  }
}

}  // namespace

// x: contiguous (m, d) bf16; w12: contiguous (2h, d) bf16 (nn.Linear layout,
// rows [0, h) give x1 and [h, 2h) give x2); b12: (2h,) fp32; out: (m, h)
// bf16; x and w12 16-byte aligned. Requires m % 128 == 0, d % 64 == 0,
// h % 128 == 0. Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_matmul_silu(const void* x, const void* w12, const float* b12, void* out,
                                       int m, int d, int h, void* stream) {
  if (m % (2 * kBM) != 0 || d % kBK != 0 || h % kBN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<true>(x, w12, 2 * h, b12, out, m, d, h, kBN, static_cast<cudaStream_t>(stream)));
}

// The linear layer of `dense` in bf16 with an fp32 bias, one rounding: out
// (m, n) bf16 = bf16(x (m, d) @ w (n, d)^T in fp32 + bias (n,) fp32), all
// contiguous, x and w 16-byte aligned, d a multiple of 8 (rows of 16-byte
// multiples, as TMA needs), any m and n. Returns the CUDA error of the launch
// (0 on success).
extern "C" int ldmae_dense_bias_f32(const void* x, const void* w, const float* bias, void* out, int m, int d,
                                    int n, void* stream) {
  if (m < 1 || n < 1 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false>(x, w, n, bias, out, m, d, n, 2 * kBN, static_cast<cudaStream_t>(stream)));
}

// The fp32 function: x (m, d), w12 (2h, d), b12 (2h,), out (m, h), all fp32
// and contiguous; m % 64 == 0, d % 16 == 0, h % 64 == 0 (the wrapper's shape
// gate is stricter). Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_matmul_silu_f32(const float* x, const float* w12, const float* b12, float* out,
                                           int m, int d, int h, void* stream) {
  if (m % kSBM != 0 || d % kSBK != 0 || h % kSBN != 0 || m / kSBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  matmul_silu_f32_kernel<<<dim3(h / kSBN, m / kSBM), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w12, b12, out, m, d, h);
  return static_cast<int>(cudaGetLastError());
}
