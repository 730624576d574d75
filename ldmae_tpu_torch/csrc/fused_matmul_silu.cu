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
// warpgroups in ping-pong, in clusters of two CTAs. A tile is 64 rows by 128
// columns of H; a unit is the same columns in 2 x 64 consecutive rows, one
// tile per CTA of a cluster. Each cluster walks the units, H fastest, so the
// clusters in flight share their rows of x in L2 (w12 fits L2 whole).
// Warpgroup 0 of each CTA is the producer: one thread loads, by TMA with
// 128-byte swizzle, the CTA's 64 x 64 block of x and one half of the
// 256 x 64 block of w12, rows j..j+127 (x1) in CTA 0 and H+j..H+j+127 (x2)
// in CTA 1, multicast into both CTAs, so a pair reads its w12 block from L2
// once (without the cluster the 64-row tiles ran at the L2's rate, not the
// tensor cores'). Five 40 KB stages each have a full mbarrier (the stage's
// bytes) and an empty one, released by the consuming warps of both CTAs,
// since either producer writes into both. Warpgroups 1 and 2 consume
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
// D % 128 == 0, 2H % 256 == 0.
#include "hopper.cuh"

namespace {

constexpr int kBM = 64;         // output rows per tile: one consumer warpgroup's
constexpr int kBN = 128;        // output columns (of H) per tile: 256 accumulator columns
constexpr int kBK = 64;         // depth per stage: one 128-byte swizzle row of bf16
constexpr int kStages = 5;      // TMA ring depth
constexpr int kCluster = 2;     // CTAs sharing each w12 block, along M (one half each)
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kATile = kBM * kBK * 2;      // 8 KB of x
constexpr int kBTile = 2 * kBN * kBK * 2;  // 32 KB of w12: the x1 rows, then the x2 rows
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + slack to align the ring to 1 KB

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    matmul_silu_kernel(const __grid_constant__ CUtensorMap tmap_x,
                       const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ bias,
                       bf16* __restrict__ out, int m, int d, int h) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const uint32_t rank = hopper::cluster_rank();
  const int cluster = blockIdx.x / kCluster, nclusters = gridDim.x / kCluster;
  const int tiles_n = h / kBN, nk = d / kBK;
  const int nunits = m / (kBM * kCluster) * tiles_n;
  // broadcast, so that ptxas sees the role branches as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
        const int m0 = (unit / tiles_n * kCluster + rank) * kBM, n0 = unit % tiles_n * kBN;
        for (int kb = 0; kb < nk; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * kStageBytes;
          hopper::mbar_expect_tx(&full[stage], kStageBytes);
          hopper::tma_load_2d(st, &tmap_x, &full[stage], kb * kBK, m0);
          // this CTA's half of the stacked (x1 | x2) block, into both CTAs
          hopper::tma_load_2d_multicast(st + kATile + rank * (kBTile / 2), &tmap_w, &full[stage],
                                        kb * kBK, rank * h + n0, 0b11);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
      // Before this CTA may exit, the other CTA's consumers must be done with
      // the last stages: they arrive on this CTA's empty barriers.
      for (int i = 0; i < kStages; ++i) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == kStages) stage = 0, phase ^= 1;
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
      const int m0 = (unit / tiles_n * kCluster + rank) * kBM, n0 = unit % tiles_n * kBN;
      int pos = j * nk, prev = 0;  // place of this unit's first stage in the ring's sequence
      for (int kb = 0; kb < nk; ++kb, ++pos) {
        const int stage = pos % kStages;
        hopper::mbar_wait(&full[stage], (pos / kStages) & 1);
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
          *reinterpret_cast<uint32_t*>(out + (size_t)(row + 8 * hr) * h + col) = pack_bf16(ya, yb);
        }
      }
    }
  }
}

// Clusters of this kernel the current device can hold at once (some SMs
// may not pair up inside their GPC), looked up once per device.
int max_clusters() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, matmul_silu_kernel, &cfg) != cudaSuccess) return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

}  // namespace

// x: contiguous (m, d) bf16; w12: contiguous (2h, d) bf16 (nn.Linear layout,
// rows [0, h) give x1 and [h, 2h) give x2); b12: (2h,) fp32; out: (m, h)
// bf16; x and w12 16-byte aligned. Requires m % 128 == 0, d % 64 == 0,
// h % 128 == 0. Returns the CUDA error of the launch (0 on success).
extern "C" int ldmae_fused_matmul_silu(const void* x, const void* w12, const float* b12, void* out,
                                       int m, int d, int h, void* stream) {
  if (m % (kBM * kCluster) != 0 || d % kBK != 0 || h % kBN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tmap_x, tmap_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)d, (cuuint64_t)m};
  const cuuint64_t w_dims[2] = {(cuuint64_t)d, 2 * (cuuint64_t)h};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t x_box[2] = {kBK, kBM}, w_box[2] = {kBK, kBN};
  cudaError_t e = hopper::make_tmap_bf16(&tmap_x, x, 2, x_dims, strides, x_box);
  if (e == cudaSuccess) e = hopper::make_tmap_bf16(&tmap_w, w12, 2, w_dims, strides, w_box);
  // Dynamic shared memory above 48 KB needs an opt-in, which CUDA keeps per
  // device: set it at every launch (cheap) so any card the caller picks has it.
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(matmul_silu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nunits = m / (kBM * kCluster) * (h / kBN);
  const int clusters = max_clusters();
  if (clusters <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int grid = kCluster * (nunits < clusters ? nunits : clusters);
  matmul_silu_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tmap_x, tmap_w, b12, static_cast<bf16*>(out), m, d, h);
  return static_cast<int>(cudaGetLastError());
}
