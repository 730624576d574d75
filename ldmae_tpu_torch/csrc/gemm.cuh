// The port's GEMM engine for Hopper (sm_90a): a persistent, warp-specialised
// wgmma/TMA product out (m, n) = epilogue(x (m, k) @ w (rows, k)^T), both
// operands K-major (nn.Linear's layout: nothing is transposed), with fp32
// (bf16 operands; fp32 operands as 3xTF32) or exact int32 (int8 operands)
// sums. Three kernels instantiate it:
//  * #4 fused_matmul_silu (csrc/fused_matmul_silu.cu): the SwiGLU w12 GEMM
//    with the silu gate in its epilogue, in bf16 and in fp32 (3xTF32: the
//    section "fp32 operands" below);
//  * dense (csrc/dense.cu): the bf16 linear layer with an fp32 bias added in
//    fp32 and one rounding;
//  * int8_dense (csrc/dense.cu): the w8a8 linear layer, int8 x int8 with the
//    per-row and per-column dequant and the fp32 bias in its epilogue;
//  * the row-parallel partials of tensor parallelism (csrc/dense.cu): the
//    bf16 product's fp32 sums and the int8 product's int32 sums, stored as
//    they are for the all-reduce that follows.
//
// What bounds them: at the DiT's token shapes (m = 16,384) the tensor
// cores; at m <= 128 rows (the adaLN and timestep linears) and at n <= 64
// columns (the final layer) the bytes of w or of x. The design per part:
//  * operands: TMA with 128-byte swizzle in rows of 128 bytes of depth (64
//    bf16 or 128 int8: four wgmma k-steps of 32 bytes, m64nNk16 bf16 or
//    m64nNk32 s8, so a row holds the same bytes for both types); a stage is
//    kSub such rows;
//  * warpgroup 0 produces: one thread keeps the ring of kStages stages full
//    (a full and an empty mbarrier each); setmaxnreg gives its registers to
//    the consumers (40 / 232);
//  * warpgroups 1 and 2 consume alternate units in ping-pong through two
//    named barriers, so one's mainloop has the tensor cores while the
//    other's epilogue runs, and a warpgroup never waits on a stage more than
//    one phase ahead;
//  * a unit is kCluster x 64 rows by kBN accumulator columns; the kCluster
//    CTAs of a cluster each load one part of the unit's w block and
//    multicast it into all of them, so the cluster reads it from L2 once;
//    units run column tiles fastest, so the clusters in flight share their
//    rows of x in L2;
//  * the grid is persistent: as many CTAs (clusters) as the device holds at
//    once walk the units;
//  * epilogues (the struct Epi): the plain and int8 linears first stage the
//    tile's column values (bias; w_scale and bias) in shared memory, then
//    write each 64-row tile a chunk of 128 bytes of columns at a time to a
//    small padded buffer and store whole 16-byte vectors (any m and n: rows
//    past m and columns past n are not stored, a ragged n element by
//    element), so the ring keeps its depth; #4 pairs x1 and x2 in registers
//    and stores from there. An epilogue loads from global memory only
//    through ld.global.nc (__ldg) and never between its stores: the
//    compiler cannot tell a plain load from `bias` apart from the stores to
//    `out` (struct members carry no __restrict__), keeps each such load
//    behind the stores before it, and that chain of L2 round trips made the
//    epilogue outlast the other warpgroup's mainloop at k = 768.
//
// Configurations (the template parameter Config; csrc/dense.cu picks one by
// shape):
//  * Wide: kBN = 256, clusters of four, five stages of one row (#4's
//    design): 16 KB of L2 reads a CTA per 64 x 256 x 128 bytes of products;
//  * Narrow: kBN = 16 or 32, no cluster, four stages of 256 elements of
//    depth. At m <= 128 a unit is 16 or 32 columns, so every SM streams a
//    slice of w (the adaLN linear: 144 units); at n <= 64 a unit is 64 rows
//    of x by 16 columns, x streamed at memory rate (the final layer: 256
//    units) instead of through 256-wide products of which 240 columns were
//    discarded. A unit's time here is the chain of its stages (wait,
//    products, release), not their bytes, so a unit has few, deep stages
//    (deeper and fewer were faster at every such shape tried; wider units
//    at small m only past n = 4,096). At m < 64 the TMA box holds only
//    the rows that exist (the accumulator rows past them read stale shared
//    memory and are never stored).
//
// fp32 operands (#4's fp32 instantiation, Config<float, ...>): each product
// runs as 3xTF32 (tf32.cuh), x_lo w_hi + x_hi w_lo + x_hi w_hi per k step of
// 8, the small terms first. wgmma takes TF32 only K-major, which x (m, k)
// and w (rows, k) are. w comes split: its hi and lo parts as rows [0, rows)
// and [rows, 2 rows) of one (2 rows, k) array (split_tf32_kernel, once a
// call), each stage holding x's tile and both parts of the unit's w block
// (8 + 16 + 16 KB at kBN = 128: five stages). x is split as the consumer
// reads it: the register A operand of wgmma m64nNk8 (rows 16 warp + g, + 8;
// columns t, t + 4 of each k step: four conflict-free 32-bit loads from the
// 128-byte-swizzled tile, two integer operations a value), double-buffered
// by k step, so the next k step's split runs while the tensor cores do this
// one's three products. The products of kFlush stages (128 of depth) are
// summed from zero in a second accumulator, then added to the tile's in
// fp32: the tensor cores truncate each sum into their accumulator, and
// three products a k step into one accumulator over k = 1,152 read 1.6e-5
// relative L2 from fp64 (an H100, PERF.md), where the plain fp32 product
// reads about 1e-7. Two 64 x 128 accumulators take 128 registers a thread,
// so kBN = 128, not the bf16 configuration's 256.
#pragma once

#include "hopper.cuh"
#include "tf32.cuh"

namespace gemm {

// ---- wgmma, A and B K-major in shared memory (128-byte swizzle) ------------
// Overloads by accumulator: float[N / 2] is bf16 m64nNk16 with fp32 sums,
// int[N / 2] is s8 m64nNk32 with int32 sums; accumulate != 0 adds to d. The
// fragment: column block j of 8 in d[4j], d[4j+1] (row 16 warp + g, columns
// 8j + 2t, +1) and d[4j+2], d[4j+3] (row + 8), the same for both types.

__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(int (&d)[8], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(int (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A * B, m64n128k8 tf32 (fp32 bit patterns whose 13 low bits are
// zero): A (64 x 8) from registers, a[0..3] = (row 16 warp + g, column t),
// (row + 8, t), (row, t + 4), (row + 8, t + 4); B K-major in shared memory
// (128-byte swizzle); fp32 accumulator of 64 registers a thread.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <typename T>
struct Operand;
template <>
struct Operand<bf16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Operand<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // TMA copies the bits
};
template <>
struct Operand<float> {  // 3xTF32: w as its hi and lo parts
  using Acc = float;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// A tile configuration: operand type T, kBN accumulator columns a tile (the
// wgmma's N), kCluster CTAs along m sharing each w block, a ring of kStages
// stages of kSub swizzle rows of depth each (128 bytes of depth a row: a
// TMA box and four wgmma k-steps).
template <typename T, int BN, int Cluster, int Stages, int Sub = 1>
struct Config {
  using Elem = T;
  using Acc = typename Operand<T>::Acc;
  static constexpr int kBM = 64;  // rows of a tile: one consumer warpgroup's
  static constexpr int kBN = BN, kCluster = Cluster, kStages = Stages, kSub = Sub;
  static constexpr int kRowK = 128 / static_cast<int>(sizeof(T));  // depth of a swizzle row
  static constexpr int kBK = kRowK * kSub;                         // depth a stage
  static constexpr bool kTf32x3 = sizeof(T) == 4;                  // fp32: w's hi and lo parts a stage
  static constexpr int kARow = kBM * 128, kBRow = kBN * 128;       // bytes of one swizzle row of depth
  static constexpr int kATile = kARow * kSub, kBTile = kBRow * kSub;
  static constexpr int kStageBytes = kATile + (kTf32x3 ? 2 : 1) * kBTile;
  static constexpr int kWRows = kBN / kCluster;  // rows of a unit's w block each CTA loads
  static constexpr int kAcc = kBN / 2;           // accumulator registers a thread
  static constexpr int kThreads = 384;           // producer warpgroup + two consumer warpgroups
};

// Where a consumer warpgroup's tile lies and what its threads are.
struct Tile {
  int m0, n0, m, n;   // first row and output column; the output's extent
  int warp, g, t, c;  // warp of the warpgroup, lane / 4, lane % 4, consumer index
  unsigned char* stage;  // this warpgroup's staging buffer (staged epilogues)
};

// The staging buffer of a staged epilogue: 64 rows of one chunk of columns
// (128 bytes of the output type), rows padded by 8 elements so that the
// fragment's stores (8 rows x 4 threads a warp) and the 16-byte reads hit
// distinct banks; then the tile's column values (kBN float2).
template <class Cfg, class Epi>
struct Staging {
  using Out = typename Epi::Out;
  static constexpr int kCols = Cfg::kBN < 128 / static_cast<int>(sizeof(Out)) ? Cfg::kBN : 128 / sizeof(Out);
  static constexpr int kRowBytes = kCols * sizeof(Out);
  static constexpr int kPitch = kRowBytes + 8 * sizeof(Out);
  static constexpr int kTile = Cfg::kBM * kPitch;
  static constexpr int kBytes = Epi::kPaired ? 0 : kTile + Cfg::kBN * 8;
};

template <class Cfg, class Epi>
constexpr int smem_bytes() {
  return Cfg::kStages * Cfg::kStageBytes + 2 * Staging<Cfg, Epi>::kBytes + 1024;  // + slack to align the ring
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// The staged store: the warpgroup stages the tile's column values
// epi.col(c, n) (a float2 a column, zeros past n) once, then per chunk of
// columns each thread writes its fragment's values epi.apply(acc,
// epi.row(r, m), column value) to the staging buffer and the warpgroup
// stores the chunk's rows < m and columns < n, 16 bytes a thread where rows
// are whole 16-byte vectors. No global load is left between the stores.
template <class Cfg, class Epi>
__device__ __forceinline__ void store_staged(const Epi& epi, const typename Cfg::Acc (&acc)[Cfg::kAcc],
                                             const Tile& tl) {
  using S = Staging<Cfg, Epi>;
  using Out = typename Epi::Out;
  constexpr int kVec = 16 / sizeof(Out), kChunks = S::kRowBytes / 16;
  const int lt = threadIdx.x % 128, r0 = tl.warp * 16 + tl.g;
  // the last tile's column values were read before its last barrier
  float2* colv = reinterpret_cast<float2*>(tl.stage + S::kTile);
  for (int i = lt; i < Cfg::kBN; i += 128) colv[i] = epi.col(tl.n0 + i, tl.n);
  const float rows[2] = {epi.row(tl.m0 + r0, tl.m), epi.row(tl.m0 + r0 + 8, tl.m)};
  const bool whole = tl.n % kVec == 0;
#pragma unroll
  for (int c0 = 0; c0 < Cfg::kBN; c0 += S::kCols) {
    hopper::bar_sync(3 + tl.c, 128);  // this warpgroup has read the last chunk (and staged colv)
#pragma unroll
    for (int jb = 0; jb < S::kCols / 8; ++jb) {
      const int j = c0 / 8 + jb, lc = jb * 8 + 2 * tl.t;
      const float4 cv = *reinterpret_cast<const float4*>(colv + c0 + lc);  // columns lc and lc + 1
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        store_pair(reinterpret_cast<Out*>(tl.stage + (r0 + 8 * hr) * S::kPitch) + lc,
                   epi.apply(acc[4 * j + 2 * hr], rows[hr], make_float2(cv.x, cv.y)),
                   epi.apply(acc[4 * j + 2 * hr + 1], rows[hr], make_float2(cv.z, cv.w)));
    }
    hopper::bar_sync(3 + tl.c, 128);
#pragma unroll 4
    for (int i = lt; i < Cfg::kBM * kChunks; i += 128) {
      const int r = i / kChunks, q = i % kChunks, row = tl.m0 + r, col = tl.n0 + c0 + q * kVec;
      if (row >= tl.m || col >= tl.n) continue;
      const unsigned char* src = tl.stage + r * S::kPitch + q * 16;
      Out* dst = epi.out + static_cast<size_t>(row) * tl.n + col;
      if (whole) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < kVec && col + e < tl.n; ++e) dst[e] = reinterpret_cast<const Out*>(src)[e];
      }
    }
  }
}

// The engine. Epi: the epilogue, with `kPaired` (#4: the unit's w block is
// rows j.. of x1 and n + j.. of x2, kBN / 2 output columns, and Epi stores
// the tile itself, `store<Cfg>(acc, tile)`) or else the staged store's
// `Out`, `out`, `float row(r, m)`, `float2 col(c, n)` and
// `apply(acc, row value, column value)`, which returns a float (an int for
// an int32 output).
// a_bytes: the bytes of x a swizzle row of depth loads (the TMA box's rows x
// 128).
template <class Cfg, class Epi>
__global__ void __launch_bounds__(Cfg::kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
                const Epi epi, int m, int k, int n, int a_bytes) {
  constexpr int kBM = Cfg::kBM, kBN = Cfg::kBN, kBK = Cfg::kBK, kCluster = Cfg::kCluster;
  constexpr int kStages = Cfg::kStages, kUnitCols = Epi::kPaired ? kBN / 2 : kBN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  uint32_t rank = 0;
  if constexpr (kCluster > 1) rank = hopper::cluster_rank();
  const int cluster = blockIdx.x / kCluster, nclusters = gridDim.x / kCluster;
  const int tiles_n = (n + kUnitCols - 1) / kUnitCols, nk = (k + kBK - 1) / kBK;
  const int nunits = (m + kBM * kCluster - 1) / (kBM * kCluster) * tiles_n;
  // broadcast, so that ptxas sees the role branches as warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);              // the producer's arrival with the stage's bytes
      hopper::mbar_init(&empty[s], 4 * kCluster);  // each warp of the consuming warpgroups
    }
    hopper::fence_mbar_init();
  }
  // every CTA's barriers exist before any signals another's
  if constexpr (kCluster > 1) hopper::cluster_sync();
  else __syncthreads();

  if (wg == 0) {
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      const int sub = rank * Cfg::kWRows;  // this CTA's part of each w block
      for (int unit = cluster; unit < nunits; unit += nclusters) {
        const int m0 = (unit / tiles_n * kCluster + rank) * kBM, n0 = unit % tiles_n * kUnitCols;
        const int wrow = Epi::kPaired && sub >= kBN / 2 ? n + n0 + sub - kBN / 2 : n0 + sub;
        for (int kb = 0; kb < nk; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * Cfg::kStageBytes;
          hopper::mbar_expect_tx(&full[stage], (a_bytes + (Cfg::kTf32x3 ? 2 : 1) * Cfg::kBRow) * Cfg::kSub);
#pragma unroll
          for (int s = 0; s < Cfg::kSub; ++s) {
            const int k0 = kb * kBK + s * Cfg::kRowK;
            hopper::tma_load_2d(st + s * Cfg::kARow, &tmap_x, &full[stage], k0, m0);
            // fp32: w's hi part, then its lo part (rows w_rows.., 2 n of them paired) a tile later
#pragma unroll
            for (int part = 0; part < (Cfg::kTf32x3 ? 2 : 1); ++part) {
              unsigned char* wdst = st + Cfg::kATile + part * Cfg::kBTile + s * Cfg::kBRow + sub * 128;
              const int row = wrow + part * (Epi::kPaired ? 2 * n : n);
              if constexpr (kCluster > 1)
                hopper::tma_load_2d_multicast(wdst, &tmap_w, &full[stage], k0, row, (1u << kCluster) - 1);
              else
                hopper::tma_load_2d(wdst, &tmap_w, &full[stage], k0, row);
            }
          }
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
      // Before this CTA may exit, the other CTAs' consumers must be done
      // with the last stages: they arrive on this CTA's empty barriers.
      if constexpr (kCluster > 1) {
        for (int i = 0; i < kStages; ++i) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    hopper::reg_alloc<232>();
    const int c = wg - 1;  // units j = c, c + 2, ... of this CTA's sequence
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    // a stage is free once the consuming warps of every CTA are done with it
    auto release = [&](int s) {
      if (lane == 0) {
        if constexpr (kCluster > 1) {
          for (int cta = 0; cta < kCluster; ++cta) hopper::mbar_arrive_cluster(&empty[s], cta);
        } else {
          hopper::mbar_arrive(&empty[s]);
        }
      }
    };
    typename Cfg::Acc acc[Cfg::kAcc];
#pragma unroll
    for (int i = 0; i < Cfg::kAcc; ++i) acc[i] = 0;
    unsigned char* staging = ring + kStages * Cfg::kStageBytes + c * Staging<Cfg, Epi>::kBytes;
    // The two warpgroups take turns: unit j's mainloop starts after unit
    // j - 1's has waited on all its stages (named barrier 1 + c, arrived at
    // by the other warpgroup).
    if (c == 1) hopper::bar_arrive(1, 256);
    for (int j = c;; j += 2) {
      const int unit = cluster + j * nclusters;
      if (unit >= nunits) break;
      hopper::bar_sync(1 + c, 256);
      const int m0 = (unit / tiles_n * kCluster + rank) * kBM, n0 = unit % tiles_n * kUnitCols;
      int pos = j * nk, prev = 0;  // place of this unit's first stage in the ring's sequence
      uint32_t xh[2][4], xl[2][4];  // fp32: x's hi and lo A fragments of the k steps in flight (k step % 2)
      if constexpr (Cfg::kTf32x3) {
        constexpr int kFlush = 4;  // stages summed from zero in part before they are added to acc
        float part[Cfg::kAcc];
        const int g = lane / 4, t = lane % 4, r0 = warp * 16 + g;  // rows r0, r0 + 8 (r0 % 8 = g)
#pragma unroll
        for (int i = 0; i < Cfg::kAcc; ++i) acc[i] = 0.f;
        for (int kb = 0; kb < nk; ++kb, ++pos) {
          const int stage = pos % kStages;
          hopper::mbar_wait(&full[stage], (pos / kStages) & 1);
          const unsigned char* st = ring + stage * Cfg::kStageBytes;
          const uint64_t dh = hopper::desc_sw128(st + Cfg::kATile, 16, 1024);
          const uint64_t dl = hopper::desc_sw128(st + Cfg::kATile + Cfg::kBTile, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // 8 values (32 bytes) of depth a step
            const int b = kk & 1;
            // columns 8 kk + t and + 4: 16-byte chunks 2 kk and 2 kk + 1 of the row, at chunk ^ (row % 8)
            const unsigned char* c0 = st + r0 * 128 + (((2 * kk) ^ g) << 4) + 4 * t;
            const unsigned char* c1 = st + r0 * 128 + (((2 * kk + 1) ^ g) << 4) + 4 * t;
            const float v[4] = {*reinterpret_cast<const float*>(c0), *reinterpret_cast<const float*>(c0 + 8 * 128),
                                *reinterpret_cast<const float*>(c1), *reinterpret_cast<const float*>(c1 + 8 * 128)};
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(v[i], xh[b][i], xl[b][i]);
            hopper::wgmma_fence();
            wgmma_tf32_rs(part, xl[b], dh + 2 * kk, kb % kFlush > 0 || kk > 0);
            wgmma_tf32_rs(part, xh[b], dl + 2 * kk, 1);
            wgmma_tf32_rs(part, xh[b], dh + 2 * kk, 1);
            hopper::wgmma_commit();
            // the previous k step's products are done: its fragments may be
            // overwritten, and at this stage's first step the previous stage
            // is read
            hopper::wgmma_wait<1>();
            hopper::fence_regs(xh[b ^ 1]);
            hopper::fence_regs(xl[b ^ 1]);
            if (kk == 0 && kb > 0) release(prev);
          }
          prev = stage;
          if (kb % kFlush == kFlush - 1 || kb == nk - 1) {  // part into acc, in fp32
            hopper::wgmma_wait<0>();
            hopper::fence_regs(part);
            hopper::fence_regs(xh[1]);
            hopper::fence_regs(xl[1]);
#pragma unroll
            for (int i = 0; i < Cfg::kAcc; ++i) acc[i] += part[i];
          }
        }
      } else {
        for (int kb = 0; kb < nk; ++kb, ++pos) {
          const int stage = pos % kStages;
          hopper::mbar_wait(&full[stage], (pos / kStages) & 1);
          const unsigned char* st = ring + stage * Cfg::kStageBytes;
          hopper::wgmma_fence();
#pragma unroll
          for (int s = 0; s < Cfg::kSub; ++s) {
            const uint64_t da = hopper::desc_sw128(st + s * Cfg::kARow, 16, 1024);
            const uint64_t db = hopper::desc_sw128(st + Cfg::kATile + s * Cfg::kBRow, 16, 1024);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)  // 32 bytes of depth a step along the swizzled row
              wgmma_ss(acc, da + 2 * kk, db + 2 * kk, kb > 0 || s > 0 || kk > 0);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // the previous stage's products are done: release it
          if (kb > 0) release(prev);
          prev = stage;
        }
      }
      if (unit + nclusters < nunits) hopper::bar_arrive(2 - c, 256);  // unit j + 1 exists
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(prev);
      const Tile tile{m0, n0, m, n, warp, lane / 4, lane % 4, c, staging};
      if constexpr (Epi::kPaired) epi.template store<Cfg>(acc, tile);
      else store_staged<Cfg>(epi, acc, tile);
    }
  }
}

// CTAs (kCluster 1) or clusters of the kernel the current device holds at
// once, looked up once per device after its shared-memory opt-in is set
// (the query fails without it).
template <class Cfg, class Epi>
int resident() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  if constexpr (Cfg::kCluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = Cfg::kCluster, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(Cfg::kCluster * 64);
    cfg.blockDim = dim3(Cfg::kThreads);
    cfg.dynamicSmemBytes = smem_bytes<Cfg, Epi>();
    cfg.attrs = &attr, cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&n, gemm_kernel<Cfg, Epi>, &cfg) != cudaSuccess) return 0;
  } else {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_kernel<Cfg, Epi>, Cfg::kThreads,
                                                      smem_bytes<Cfg, Epi>()) != cudaSuccess)
      return 0;
    n = per_sm * hopper::sm_count();
  }
  if (dev < 64) cached[dev] = n;
  return n;
}

// Launches the engine on x (m, k) and w (w_rows, k), both contiguous, 16-byte
// aligned, rows of a multiple of 16 bytes; out (m, n) as Epi writes it.
template <class Cfg, class Epi>
cudaError_t launch(const void* x, const void* w, int w_rows, const Epi& epi, int m, int k, int n,
                   cudaStream_t stream) {
  using T = typename Cfg::Elem;
  constexpr int kSmem = smem_bytes<Cfg, Epi>(), kUnitCols = Epi::kPaired ? Cfg::kBN / 2 : Cfg::kBN;
  // a tile of m <= 64 rows loads only the rows that exist (in whole 8-row groups)
  const int a_rows = m < Cfg::kBM ? (m + 7) / 8 * 8 : Cfg::kBM;
  CUtensorMap tmap_x, tmap_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)m}, w_dims[2] = {(cuuint64_t)k, (cuuint64_t)w_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * sizeof(T)};
  const cuuint32_t x_box[2] = {Cfg::kRowK, (cuuint32_t)a_rows}, w_box[2] = {Cfg::kRowK, Cfg::kWRows};
  cudaError_t e = hopper::make_tmap(&tmap_x, Operand<T>::kTma, x, 2, x_dims, strides, x_box);
  if (e == cudaSuccess) e = hopper::make_tmap(&tmap_w, Operand<T>::kTma, w, 2, w_dims, strides, w_box);
  // Dynamic shared memory above 48 KB needs an opt-in, which CUDA keeps per
  // device: set it at every launch (cheap) so any card the caller picks has it.
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_kernel<Cfg, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int slots = resident<Cfg, Epi>();
  if (slots <= 0) return cudaErrorLaunchOutOfResources;
  const int units = (m + Cfg::kBM * Cfg::kCluster - 1) / (Cfg::kBM * Cfg::kCluster) * ((n + kUnitCols - 1) / kUnitCols);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Cfg::kCluster, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(Cfg::kCluster * (units < slots ? units : slots));
  cfg.blockDim = dim3(Cfg::kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = &attr, cfg.numAttrs = Cfg::kCluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, gemm_kernel<Cfg, Epi>, tmap_x, tmap_w, epi, m, k, n, a_rows * 128);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace gemm
