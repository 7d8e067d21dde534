// Fused set-abstraction tail: neighbour selection + gather + BN-folded
// 2-layer MLP + max over the K neighbours, in one kernel.
//
//   out[b,s] = max_k relu(rnd(rnd(h1[k] @ w2) + b2)),
//   h1[k]    = relu(rnd(rnd(h0[k] @ w1) + b1)),
//   h0[k]    = relu(rnd(pre[b, idx[b,s,k]] + cbias[b,s]))
//
// rnd() rounds to the compute dtype (bf16 or f32), at the places the TPU
// kernels round (_fused_sa_kernel and _fused_sa_idx_kernel,
// mm3d_tpu/ops/pallas_kernels.py): products accumulate in f32, and each
// product output is cast to the dtype before its bias add, which is taken in
// f32 and rounded again.
//
// Two forms share the kernel; a compile-time switch picks the selection:
//
// * ball query (mm3d_fused_sa): idx is the ball query of ball_query.cuh, one
//   warp per centroid. Replaces fused_sa_pallas (its versions
//   _fused_sa_kernel, _v4, _v6 and _v7 are TPU layout variants of one
//   function).
// * given indices (mm3d_fused_sa_idx): idx [B,S,K] int32 comes from the
//   caller (the kNN selection of the pointnet2_cls_knn model), K valid
//   indices per row, repeats allowed. Replaces fused_sa_idx_pallas.
//
// The TPU kernels gather neighbour rows with one-hot MXU matmuls (with a
// 3-term bf16 split for f32) because a TPU core has no fast row gather: a
// layout trick of that core, not carried over. Here rows are gathered
// straight from device memory into shared memory.
//
// What bounds it on the H100: the two products, 2*K*(C1*C2 + C2*C3)
// operations per centroid (51.5 and 103 GFLOP at SA1 and SA2, B=128: 0.052
// and 0.104 ms on the bf16 tensor cores, 0.77 and 1.54 ms on the f32 CUDA
// cores), against ~34 MB of input and output. The weights (24-96 KB in bf16
// on the serving paths) are reused by every row.
//
// bf16, sa_ws_kernel: persistent blocks, one a multiprocessor, each walking
// a contiguous range of the (cloud, centroid tile) pairs. A tile is `rows`
// (128, or 64; past K = 128, one centroid's K rounded up to 128, walked in
// blocks of 128) gathered rows: St centroids of KR = K rounded up to 16
// rows each (rows k >= K repeat row 0 of their centroid, which leaves the
// max unchanged). Each block copies w1, b1, w2 and b2 into shared memory once,
// zero padded to the wgmma shapes; where they do not fit beside the tile
// buffers (the 256- and 384-wide sa4 blocks of the segmentation models), a
// producer streams them a 64-column panel at a time through two slots,
// once for each block of 128 rows.
// Every wgmma operand (A stages, H, weights) is K-major in 128-byte swizzle
// atoms (WsLayout). Warp roles:
// * producer warpgroups (the last 128, 256 or 384 threads), taking turns
//   with an A stage each: the neighbours of a tile (the ball query, one warp a centroid, over the
//   cloud's points kept in shared memory; or a copy of the given indices),
//   then the gather with 16-byte loads of pre and cbias, + , round, relu,
//   stored into the stage in the swizzled layout; then the weight panels if
//   streamed. Several producers keep several tiles' latency-bound
//   selections and gathers in flight;
// * two consumer warpgroups (one for 64-row tiles), each owning 64 rows of
//   the tile: layer 1 as m64n64k16 wgmma chains (A and B in shared memory),
//   round, + b1, round, relu in registers, H stored to shared memory (their
//   own rows: a warpgroup barrier, no block barrier); layer 2 the same way in
//   64- or 128-column chunks; the max over K taken on the f32 sums (rounding
//   and the bias add never decrease, so max commutes with them): in the
//   thread, then over a warp's 16-row slab (one centroid's) by shuffles,
//   the slabs of a centroid combined through a small shared array, and the
//   row rounded, biased and written as bf16 with 16-byte stores.
// mbarriers hand the A stages and weight panels between the roles. The tile
// plan (rows, resident weights, points in shared memory, producers,
// shared-memory bytes) comes from cuda_kernels.sa_plan; the launcher
// recomputes the layout and refuses a mismatch.
//
// f32, sa_f32_kernel: the same function on the CUDA cores, f32 FMAs, no
// TF32 (the f32 form serves strict fp32). Persistent blocks walk the same
// (cloud, centroid tile) ranges. A block is 256 consumer threads and two
// producer warpgroups:
// * the selecting warpgroup takes a tile's neighbours (the ball query, one
//   warp a centroid, over the cloud's points in shared memory where they
//   fit; or a copy of the given indices) and its centroids' cbias rows;
//   the gathering warpgroup then gathers relu(pre + cbias) with 16-byte
//   loads into an A stage, transposed (channel-major), one or two stages in
//   a ring handed over by mbarriers: the next tile's selection runs while
//   this one's rows are gathered, both while the consumers multiply (with
//   one producer warpgroup doing both in turn, SA1's ball-query form ran
//   12 % slower than with no selection at all; the second warpgroup took
//   8 % off: utils/sa_plans.py --src, PERF.md);
// * the consumers hold a grid of thread tiles over `rows` (128 or 64) rows
//   and a chunk of 32, 64 or 128 output columns: 16 x 16 tiles of 8 (or 4)
//   rows x 8, 4 or 2 columns, or, for a chunk narrower than 128 over 128
//   rows, 32 x 8 tiles of 4 rows x 8 or 4 columns (one A load a k-step in
//   place of two: 7 % off SA1's given-index form, utils/sa_plans.py --src,
//   PERF.md), f32 sums in registers (176 a thread, given by the producers
//   with setmaxnreg); A and weight values read as float4 / float2 from
//   shared memory at compile-time offsets, where lanes that share a row or
//   a column read one address (16 FMAs a shared load at 8 x 8). Layer 1: + b1, relu, stored channel-major
//   into H; layer 2: the max over the thread's rows, then over the 4 lanes
//   of a 16-row slab by shuffles, the slabs of a centroid combined in a
//   small shared array, + b2, relu, written: no [rows, C3] staging tile.
// Weights stay resident where they fit (w1 + w2: 48 KB at SA1); else the
// consumers stream 32-row panels through two slots with cp.async, one
// panel ahead of the FMAs. Past `rows` rows a centroid (K > 128, or K > 64
// at 64-row blocks) is walked in blocks whose maxima are merged in a
// running row. The plan (rows, St, resident, points in shared memory, A
// stages, bytes) comes from cuda_kernels.sa_plan; the launcher recomputes
// F32Layout and refuses a mismatch.
//
// sa_loop_kernel, bf16 at widths whose tiles the warp-specialised kernel
// cannot hold in shared memory (a C2 of 512 and more, or K past 128 at wide
// layers; on no model's path): the first design's layout, a block per St
// centroids, selection, gather, then each product in 64-column chunks of
// CUDA-core FMAs (f32 sums) through an f32 staging tile, with block barriers
// between the phases. sa_plan picks it (producers = 0).
#include <stdint.h>

#include "ball_query.cuh"

// Built with -DSA_PHASE_CLOCKS, lane 0 of every warp of the warp-specialised
// kernel adds the clock64() cycles of each phase of its timeline to
// g_sa_phase: SA_MARK(i) charges the cycles since the previous mark to slot
// i, SA_SET(i, v) adds v. Slot 31 counts the warps that reported.
// mm3d_fused_sa_phase_names() names the slots.
#ifdef SA_PHASE_CLOCKS
__device__ unsigned long long g_sa_phase[32];
#define SA_START                        \
  unsigned long long sa_ph[16] = {};    \
  long long sa_t = clock64()
#define SA_MARK(i)                      \
  do {                                  \
    const long long sa_n = clock64();   \
    sa_ph[i] += sa_n - sa_t;            \
    sa_t = sa_n;                        \
  } while (0)
#define SA_SET(i, v) sa_ph[i] += (v)
#define SA_FLUSH                                                         \
  do {                                                                   \
    if ((threadIdx.x & 31) == 0) {                                       \
      for (int i = 0; i < 16; ++i) atomicAdd(&g_sa_phase[i], sa_ph[i]); \
      atomicAdd(&g_sa_phase[31], 1ull);                                  \
    }                                                                    \
  } while (0)
#else
#define SA_START
#define SA_MARK(i)
#define SA_SET(i, v)
#define SA_FLUSH
#endif

namespace {

typedef __nv_bfloat16 bf16;

struct SaArgs {
  const float* xyz;      // [B,N,3], ball-query form
  const float* new_xyz;  // [B,S,3], ball-query form
  const int* idx;        // [B,S,K], given-index form
  const void* pre;       // [B,N,C1]
  const void* cbias;     // [B,S,C1]
  const void* w1;        // [C1,C2]
  const void* b1;        // [C2]
  const void* w2;        // [C2,C3]
  const void* b2;        // [C3]
  void* out;             // [B,S,C3]
  int B, N, S, K, C1, C2, C3;
  int St;  // centroids a tile (a block, loop kernel)
  // producers 0: the loop kernel. stages: the A stages, the plan's (bf16:
  // the producer count). The stage ring reads it, not `producers` or the
  // kernel's template argument: with those, ptxas spilled 36-44 bytes in
  // the two-producer kernels and the given-index form ran 3-7 % slower at
  // SA1 and SA2 (utils/sa_plans.py --src, PERF.md). rows: f32, the rows of
  // a block (an A stage).
  int rows, stages, resident, xyz_smem, producers;
  float r2;
};

// bf16 kernel: output columns a product chunk (the wgmma N): layer 1 and
// streamed panels take kNC; layer 2 takes kNC2 with two producer warpgroups
// (the consumers then have the registers), one m64n128 chain of k-steps in
// place of two m64n64 ones
constexpr int kNC = 64, kNC2 = 128;

// points a lane a round of the ball-query selection (ball_query.cuh): the
// producers of the warp-specialised and f32 kernels walk 4 (no slower than
// 1 or 2 at SA1 and SA2 in bf16, the two-producer kernels' spill at 8
// bytes), the loop kernel 1 (4 read 16 % slower at SA2 when it also ran
// f32; utils/sample_phases.py --src, PERF.md)
constexpr int kSelectU = 4, kLoopSelectU = 1;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// layer 2's chunk width of a plan
__host__ __device__ inline int nc2(const SaArgs& a) {  // see sa_ws_kernel
  return a.producers == 2 ? kNC2 : kNC;
}
__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}
__host__ __device__ inline size_t align1024(size_t x) {
  return (x + 1023) & ~static_cast<size_t>(1023);
}

// ============================================ bf16: warp-specialised kernel

// Shared-memory layout of sa_ws_kernel, in bytes from a 1024-byte aligned
// base (cuda_kernels._ws_smem computes the same total, the alignment slack
// included): weights (resident w1 then w2, or two streamed panel slots) | A
// stages (one a producer) | H | b1, b2 in f32 | neighbour indices (two
// tiles a producer) | f32 slab maxima (two chunks) | the cloud's points
// (ball-query form, where they fit; one copy a producer) | mbarriers.
// Every wgmma operand (A stages, H, weights) is K-major in 128-byte swizzle
// atoms of 8 rows x 64 bf16: element (r, k) at (k/64)*R*64 + r*64 +
// (((k%64)/8) ^ (r%8))*8 + k%8 for R rows, so its K extent is padded to a
// multiple of 64.
struct WsLayout {
  int C1p, K2p, N1p, N2p, KR, slot;  // slot: elements of a streamed panel
  size_t offW2, offA, stageA, offH, offB1, offB2, offIdx, offPart, offXyz,
      xyzBytes, offBar, total;
  __host__ __device__ explicit WsLayout(const SaArgs& a) {
    C1p = round_up(a.C1, 64);
    K2p = round_up(a.C2, 64);
    N1p = round_up(a.C2, kNC);
    N2p = round_up(a.C3, nc2(a));
    KR = round_up(a.K, 16);
    slot = (C1p > K2p ? C1p : K2p) * kNC;
    size_t o;
    if (a.resident) {
      offW2 = align1024(static_cast<size_t>(C1p) * N1p * 2);
      o = offW2 + align1024(static_cast<size_t>(K2p) * N2p * 2);
    } else {
      offW2 = align1024(static_cast<size_t>(slot) * 2);  // the second slot
      o = 2 * offW2;
    }
    offA = o;
    stageA = align1024(static_cast<size_t>(a.rows) * C1p * 2);
    o += a.stages * stageA;
    offH = o;  // at most 128 rows: a larger tile is walked in blocks
    o += align1024(static_cast<size_t>(a.rows < 128 ? a.rows : 128) * N1p * 2);
    offB1 = o;
    o += align128(static_cast<size_t>(N1p) * 4);
    offB2 = o;
    o += align128(static_cast<size_t>(N2p) * 4);
    offIdx = o;
    o += align128(static_cast<size_t>(2) * a.producers * a.rows * 4);
    offPart = o;  // two chunks' buffers; every chunk's past 128 rows
    const int n2 = N2p / nc2(a), pbufs = a.rows > 128 && n2 > 2 ? n2 : 2;
    o += align128(static_cast<size_t>(pbufs) * (a.rows / 16) * nc2(a) * 4);
    offXyz = o;
    xyzBytes = a.xyz_smem ? align128(static_cast<size_t>(a.N) * 12) : 0;
    o += a.producers * xyzBytes;
    offBar = o;
    total = o + 128 + 1024;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a hand-off that went wrong) traps, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int n = 0; !mbar_try(bar, parity); ++n)
    if (n == (1 << 24)) __trap();
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a K-major operand in 128-byte swizzle atoms
// (8 rows x 128 bytes, 1024-byte aligned): SBO 1024 bytes from one 8-row
// group to the next, LBO unused (1), layout type 1 (128-byte swizzle). A
// k-step of 16 moves the start address 32 bytes on inside the atom.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 64] @ B[64 x 64] for one 128-byte swizzle atom of K:
// four wgmma k-steps in one asm statement, the start addresses 32 bytes
// apart; the first overwrites d unless acc. With one statement a step (or a
// PTX loop) ptxas put a fence and a wait around every HGMMA (seen in the
// SASS); within a statement, and across consecutive statements with no other
// instruction on d, the k-steps issue back to back. Thread t of the
// warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and columns 8j + 2*(t%4)
// (+1) in d[4j..4j+3].
template <int N>
__device__ __forceinline__ void gmma_block(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int acc);

template <>
__device__ __forceinline__ void gmma_block<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "setp.eq.b32 q, %34, %34;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "add.s64 da, %32, 2;\n"
      "add.s64 db, %33, 2;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, q, 1, 1, 0, 0;\n"
      "add.s64 da, %32, 4;\n"
      "add.s64 db, %33, 4;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, q, 1, 1, 0, 0;\n"
      "add.s64 da, %32, 6;\n"
      "add.s64 db, %33, 6;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, q, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void gmma_block<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "setp.eq.b32 q, %66, %66;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "add.s64 da, %64, 2;\n"
      "add.s64 db, %65, 2;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, q, 1, 1, 0, 0;\n"
      "add.s64 da, %64, 4;\n"
      "add.s64 db, %65, 4;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, q, 1, 1, 0, 0;\n"
      "add.s64 da, %64, 6;\n"
      "add.s64 db, %65, 6;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, q, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d = A @ B over `kblocks` atoms of K; the descriptors move by astride and
// bstride (16-byte units) from one atom to the next. Unrolled for K up to
// 512, so that no loop back edge sits between the products' wgmmas.
template <int N>
__device__ __forceinline__ void gmma_run(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int kblocks,
                                         uint32_t astride, uint32_t bstride) {
#pragma unroll
  for (int kb = 0; kb < 8; ++kb)
    if (kb < kblocks)
      gmma_block<N>(d, da + kb * astride, db + kb * bstride, kb);
  for (int kb = 8; kb < kblocks; ++kb)
    gmma_block<N>(d, da + kb * astride, db + kb * bstride, kb);
}

// two bf16 (low half: the first) <-> floats
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// relu(rnd(rnd(x) + b)) of two neighbouring columns, the layer epilogue
__device__ __forceinline__ uint32_t bias_relu(float x0, float x1, float2 b) {
  const float2 r = unpack_bf16(pack_bf16(x0, x1));
  return max_bf16x2(pack_bf16(r.x + b.x, r.y + b.y), 0u);
}
// relu(rnd(p + c)) of two neighbouring channels, the gather's
__device__ __forceinline__ uint32_t add_relu(uint32_t p, uint32_t c) {
  const float2 x = unpack_bf16(p), y = unpack_bf16(c);
  return max_bf16x2(pack_bf16(x.x + y.x, x.y + y.y), 0u);
}

// Columns [n0, n0+ncols) of W [Kin][Nout] (device memory, bf16) into dst as
// the K-major swizzled operand of ncols rows (WsLayout): element (k, n) at
// (k/64)*ncols*64 + n*64 + (((k%64)/8) ^ (n%8))*8 + k%8, zero for k >= Kin
// or n0+n >= Nout. One item is 8 k of one column, a 16-byte store;
// neighbouring threads take neighbouring columns, so that the 2-byte loads
// coalesce (rows of an unpadded W need not be 16-byte aligned).
__device__ void copy_panel(bf16* dst, const bf16* W, int Kin, int Nout,
                           int Kp, int n0, int ncols, int tid, int nth) {
  const unsigned short* w = reinterpret_cast<const unsigned short*>(W);
  const int items = ncols * (Kp / 8);
  for (int e = tid; e < items; e += nth) {
    const int n = e % ncols, kc = e / ncols, ng = n0 + n;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kc * 8 + 2 * i;
      const uint32_t lo =
          (k < Kin && ng < Nout) ? __ldg(w + static_cast<size_t>(k) * Nout + ng) : 0u;
      const uint32_t hi = (k + 1 < Kin && ng < Nout)
                              ? __ldg(w + static_cast<size_t>(k + 1) * Nout + ng)
                              : 0u;
      v[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(kc >> 3) * ncols * 64 +
                              n * 64 + (((kc & 7) ^ (n & 7)) * 8)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// A block's tiles: a contiguous range of the B * ceil(S/St) (cloud,
// centroid tile) pairs, so that a block seldom changes cloud.
__device__ __forceinline__ int tile_begin(const SaArgs& a) {
  const long T = static_cast<long>(a.B) * ((a.S + a.St - 1) / a.St);
  return static_cast<int>(T * blockIdx.x / gridDim.x);
}
__device__ __forceinline__ int tile_end(const SaArgs& a) {
  const long T = static_cast<long>(a.B) * ((a.S + a.St - 1) / a.St);
  return static_cast<int>(T * (blockIdx.x + 1) / gridDim.x);
}

// Where gather item e (row r, 8-channel chunk ch; see produce) lands in an
// A stage of `rows` rows and C1c chunks a row: the swizzled K-major layout.
__device__ __forceinline__ size_t a_offset(int e, int C1c, int rows) {
  const int rest = e >> 3, ch = rest % C1c, r8 = e & 7;
  const int r = (rest / C1c) * 8 + r8;
  return static_cast<size_t>(ch >> 3) * rows * 64 + r * 64 +
         (((ch & 7) ^ r8) * 8);
}

// A producer warpgroup: neighbours, gather, streamed weights. Producer p of
// P (P > 1 with resident weights only) takes the block's tiles it with
// it % P == p, always into its own A stage p: P tiles' selections and
// gathers, latency-bound both, are in flight at once. It gathers kBatch
// items a thread at once, so that their loads are in flight together.
template <int NPW, int kBatch, bool kGivenIdx>
__device__ void produce(const SaArgs& a, unsigned char* smem, int ncw) {
  const WsLayout L(a);  // rebuilt from the parameters: nothing of the
                        // prologue stays live across the role split
  const int p = threadIdx.x / 128 - ncw;
  const int t = threadIdx.x & 127, pw = t >> 5, lane = t & 31;
  const int bar_id = 4 + p;
  const int St = a.St, KR = L.KR, C1c = L.C1p / 8;
  const int tpc = (a.S + St - 1) / St;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.offBar);
  uint64_t *full = bar, *empty = bar + 3, *wfull = bar + 6, *wempty = bar + 8;
  float* sxyz = reinterpret_cast<float*>(smem + L.offXyz + p * L.xyzBytes);
  const bf16* pre_all = static_cast<const bf16*>(a.pre);
  const bf16* cb_all = static_cast<const bf16*>(a.cbias);
  const bool vec = a.C1 % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.pre) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.cbias) & 15) == 0;
  int panels = 0;  // streamed weight panels loaded (two slots, in turn)
  int cloud = -1;
  SA_START;
  SA_SET(14, 1);
  for (int tile = tile_begin(a), it = 0; tile < tile_end(a); ++tile, ++it) {
    if (it % NPW != p) continue;
    const int b = tile / tpc, s0 = (tile % tpc) * St;
    const int stage = it % a.stages, use = it / a.stages;  // stage == p
    int* idx = reinterpret_cast<int*>(smem + L.offIdx) +
               (2 * p + (use & 1)) * a.rows;
    // 1. neighbours: idx[s*KR + k], rows k >= K repeat k = 0; centroids
    // past S select point 0
    if constexpr (kGivenIdx) {
      for (int r = t; r < St * KR; r += 128) {
        const int s = r / KR, k = r % KR, sg = s0 + s;
        idx[r] = sg < a.S ? __ldg(a.idx + (static_cast<size_t>(b) * a.S + sg) * a.K +
                                  (k < a.K ? k : 0))
                          : 0;
      }
    } else {
      // the cloud's points in shared memory, where they fit: the scan's
      // loads then wait ~30 cycles, not an L1/L2 round trip
      const float* xyz = a.xyz + static_cast<size_t>(b) * a.N * 3;
      if (a.xyz_smem) {
        if (b != cloud) {
#pragma unroll 8
          for (int i = t; i < 3 * a.N; i += 128) sxyz[i] = __ldg(xyz + i);
          named_bar(bar_id, 128);
          cloud = b;
        }
        xyz = sxyz;
      }
      for (int s = pw; s < St; s += 4) {
        const int sg = s0 + s;
        int* row = idx + s * KR;
        if (sg < a.S) {
          const float* c = a.new_xyz + (static_cast<size_t>(b) * a.S + sg) * 3;
          mm3d_ball_query_warp<kSelectU>(BqCloud3{xyz}, a.N, c[0], c[1],
                                         c[2], a.r2, a.K, row);
          const int first = row[0];
          for (int k = a.K + lane; k < KR; k += 32) row[k] = first;
        } else {
          for (int k = lane; k < KR; k += 32) row[k] = 0;
        }
      }
    }
    SA_MARK(0);
    named_bar(bar_id, 128);
    SA_MARK(1);
    // 2. gather into the next free A stage: item e is 8 channels of one
    // row, at e*8 in the stage's core-matrix layout
    mbar_wait(empty + stage, (use & 1) ^ 1);
    SA_MARK(2);
    bf16* A = reinterpret_cast<bf16*>(smem + L.offA + stage * L.stageA);
    const bf16* pre = pre_all + static_cast<size_t>(b) * a.N * a.C1;
    const bf16* cb = cb_all + static_cast<size_t>(b) * a.S * a.C1;
    // item e: 8 channels (chunk ch) of row r; the 8 lanes of a row group
    // take its 8 rows, so their 16-byte stores hit 8 different banks
    const int items = St * KR * C1c;
    if (vec) {
      for (int e0 = t; e0 < items; e0 += 128 * kBatch) {
        uint4 p[kBatch], q[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + 128 * u;
          const int rest = e >> 3, ch = rest % C1c;
          const int c0 = ch * 8, r = (rest / C1c) * 8 + (e & 7);
          p[u] = q[u] = make_uint4(0u, 0u, 0u, 0u);
          if (e < items && c0 < a.C1) {
            const int sg = min(s0 + r / KR, a.S - 1);
            p[u] = __ldg(reinterpret_cast<const uint4*>(
                pre + static_cast<size_t>(idx[r]) * a.C1 + c0));
            q[u] = __ldg(reinterpret_cast<const uint4*>(
                cb + static_cast<size_t>(sg) * a.C1 + c0));
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + 128 * u;
          if (e < items)
            *reinterpret_cast<uint4*>(A + a_offset(e, C1c, a.rows)) =
                make_uint4(add_relu(p[u].x, q[u].x), add_relu(p[u].y, q[u].y),
                           add_relu(p[u].z, q[u].z), add_relu(p[u].w, q[u].w));
        }
      }
    } else {
      for (int e = t; e < items; e += 128) {
        const int rest = e >> 3, ch = rest % C1c;
        const int r = (rest / C1c) * 8 + (e & 7);
        const int sg = min(s0 + r / KR, a.S - 1);
        const int c0 = ch * 8;
        const bf16* src = pre + static_cast<size_t>(idx[r]) * a.C1 + c0;
        const bf16* cbr = cb + static_cast<size_t>(sg) * a.C1 + c0;
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = c0 + 2 * i + h;
            x[h] = c < a.C1
                       ? fmaxf(rnd<bf16>(to_f(src[2 * i + h]) + to_f(cbr[2 * i + h])), 0.f)
                       : 0.f;
          }
          w[i] = pack_bf16(x[0], x[1]);
        }
        *reinterpret_cast<uint4*>(A + a_offset(e, C1c, a.rows)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    fence_async_smem();
    mbar_arrive(full + stage);
    SA_MARK(3);
    // 3. streamed weights: the tile's w1 panels, then its w2 panels, once
    // for each block of 128 rows that the consumers walk (see consume)
    if (!a.resident) {
      bf16* ring = reinterpret_cast<bf16*>(smem);
      const int n1 = L.N1p / kNC, n2 = L.N2p / kNC;
      const int blocks = a.rows > 128 ? a.rows / 128 : 1;
      for (int c = 0; c < blocks * (n1 + n2); ++c) {
        const int slot = panels & 1, cp = c % (n1 + n2);
        mbar_wait(wempty + slot, ((panels >> 1) & 1) ^ 1);
        bf16* dst = ring + slot * (L.offW2 / 2);
        if (cp < n1)
          copy_panel(dst, static_cast<const bf16*>(a.w1), a.C1, a.C2, L.C1p,
                     cp * kNC, kNC, t, 128);
        else
          copy_panel(dst, static_cast<const bf16*>(a.w2), a.C2, a.C3, L.K2p,
                     (cp - n1) * kNC, kNC, t, 128);
        fence_async_smem();
        mbar_arrive(wfull + slot);
        ++panels;
      }
      SA_MARK(4);
    }
  }
  SA_FLUSH;
}

// Runs n product chunks one after another: issue(acc, c) starts chunk c
// (wgmma.fence, the k-steps, commit), waited(c) follows the wait for it,
// finish(acc, c) is its epilogue. (A two-deep version, chunk c+1's wgmmas
// running under chunk c's epilogue, measured slower at SA1 and SA2: PERF.md.)
template <int N, class Issue, class Waited, class Finish>
__device__ __forceinline__ void chunks(int n, Issue issue, Waited waited,
                                       Finish finish) {
  float acc[N / 2];
  for (int c = 0; c < n; ++c) {
    issue(acc, c);
    gmma_wait<0>();
    fence_regs(acc);
    waited(c);
    finish(acc, c);
  }
}

// A consumer warpgroup: its 64 rows of each tile through both layers and the
// max over K, kNC output columns a chunk in layer 1 and NC2 in layer 2.
// kBlocks: tiles of more than 128 rows can occur (compiled out of the
// two-producer kernel, whose consumers have no registers to spare).
template <int NC2, bool kBlocks>
__device__ void consume(const SaArgs& a, unsigned char* smem, int ncw) {
  const WsLayout L(a);
  constexpr int NC = kNC;
  // the warpgroup index through a shuffle, which ptxas knows to be uniform:
  // the wgmma descriptors built from it then live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, q = lane & 3, rq = lane >> 2;
  const int St = a.St, KR = L.KR;
  const int tpc = (a.S + St - 1) / St;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.offBar);
  uint64_t *full = bar, *empty = bar + 3, *wfull = bar + 6, *wempty = bar + 8;
  const bf16* W1 = reinterpret_cast<const bf16*>(smem);
  const bf16* W2 = reinterpret_cast<const bf16*>(smem + L.offW2);
  const float* sb1 = reinterpret_cast<const float*>(smem + L.offB1);
  const float* sb2 = reinterpret_cast<const float*>(smem + L.offB2);
  bf16* H = reinterpret_cast<bf16*>(smem + L.offH);
  float* part = reinterpret_cast<float*>(smem + L.offPart);
  bf16* out_all = static_cast<bf16*>(a.out);
  const bool vec_out = a.C3 % 8 == 0 &&
                       (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
  // where every centroid's rows lie in one warpgroup, its own threads
  // combine and write them; else all consumers do, after a common barrier
  const bool local = 64 % KR == 0;
  const int gid = local ? 1 + wg : 3, gthreads = local ? 128 : 128 * ncw;
  const int gt = local ? t : threadIdx.x;
  const int s_lo = local ? 64 * wg / KR : 0;
  const int s_hi = local ? min(St, (64 * wg + 64) / KR) : St;
  const int slabs = a.rows / 16;
  // A tile of more than 128 rows (K > 128: one centroid a tile) is walked in
  // blocks of 128, each warpgroup 64 rows of a block at a time through H;
  // the slab maxima of every block and chunk are kept, and combined once.
  const int hrows = kBlocks ? min(a.rows, 128) : a.rows;
  const int blocks = kBlocks ? a.rows / hrows : 1;
  // this thread's rows of H (64wg + 16warp + rq, and 8 on), columns 2q and
  // 2q+1 of each 8, in the swizzled layout: row r of atom column kb at
  // kb*hrows*64 + r*64, its chunk cw at (cw ^ r%8)*8, and r%8 = rq
  bf16* h_mine = H + static_cast<size_t>(64 * wg + 16 * warp + rq) * 64 + 2 * q;
  const bf16* h_wg = H + static_cast<size_t>(64 * wg) * 64;
  // atom-column strides (16-byte units) of the A stages and H, of the
  // weights as resident (all their columns) or streamed (NC columns)
  const uint32_t rows_stride = a.rows * 8, h_stride = hrows * 8;
  const uint32_t w1_stride = (a.resident ? L.N1p : NC) * 8;
  const uint32_t w2_stride = (a.resident ? L.N2p : NC2) * 8;
  const int n1 = L.N1p / NC, n2 = L.N2p / NC2;
  int panels_in = 0, panels_out = 0;  // streamed weight panels taken, freed
  int buf = 0;
  SA_START;
  SA_SET(15, 1);
  // a chunk's weight panel: resident, or the next streamed one
  auto panel = [&](const bf16* resident_base) -> const bf16* {
    if (a.resident) return resident_base;
    const int slot = panels_in & 1;
    mbar_wait(wfull + slot, (panels_in >> 1) & 1);
    ++panels_in;
    return reinterpret_cast<const bf16*>(smem + slot * L.offW2);
  };
  auto free_panel = [&]() {
    if (a.resident) return;
    if (lane == 0) mbar_arrive(wempty + (panels_out & 1));
    ++panels_out;
  };
  // each centroid's slabs of slab-maxima buffer pslot combined, then round,
  // + b2, round, relu, and written for layer-2 chunk c; one 8-column group
  // an item
  auto write_out = [&](int b, int s0, int c, int pslot) {
    const float4* pb = reinterpret_cast<const float4*>(part) +
                       static_cast<size_t>(pslot) * slabs * (NC2 / 4);
    const int groups = NC2 / 8, nitems = (s_hi - s_lo) * groups;
    for (int e = gt; e < nitems; e += gthreads) {
      const int s = s_lo + e / groups, g = e % groups;
      const int sg = s0 + s, col0 = c * NC2 + 8 * g;
      if (sg >= a.S || col0 >= a.C3) continue;
      const int sl0 = s * KR / 16, sl1 = sl0 + KR / 16;
      float4 lo = pb[sl0 * (NC2 / 4) + 2 * g], hi = pb[sl0 * (NC2 / 4) + 2 * g + 1];
      for (int sl = sl0 + 1; sl < sl1; ++sl) {
        const float4 l = pb[sl * (NC2 / 4) + 2 * g], h = pb[sl * (NC2 / 4) + 2 * g + 1];
        lo = make_float4(fmaxf(lo.x, l.x), fmaxf(lo.y, l.y), fmaxf(lo.z, l.z), fmaxf(lo.w, l.w));
        hi = make_float4(fmaxf(hi.x, h.x), fmaxf(hi.y, h.y), fmaxf(hi.z, h.z), fmaxf(hi.w, h.w));
      }
      const float* bc = sb2 + col0;
      const uint4 m = make_uint4(
          bias_relu(lo.x, lo.y, make_float2(bc[0], bc[1])),
          bias_relu(lo.z, lo.w, make_float2(bc[2], bc[3])),
          bias_relu(hi.x, hi.y, make_float2(bc[4], bc[5])),
          bias_relu(hi.z, hi.w, make_float2(bc[6], bc[7])));
      bf16* o = out_all + (static_cast<size_t>(b) * a.S + sg) * a.C3 + col0;
      if (vec_out && col0 + 8 <= a.C3) {
        *reinterpret_cast<uint4*>(o) = m;
      } else {
        const bf16* mv = reinterpret_cast<const bf16*>(&m);
        for (int i = 0; i < 8 && col0 + i < a.C3; ++i) o[i] = mv[i];
      }
    }
  };
  for (int tile = tile_begin(a), it = 0; tile < tile_end(a); ++tile, ++it) {
    const int b = tile / tpc, s0 = (tile % tpc) * St;
    const int stage = it % a.stages;
    mbar_wait(full + stage, (it / a.stages) & 1);
    SA_MARK(5);
    for (int blk = 0; blk < blocks; ++blk) {
      const int row0 = blk * 128 + 64 * wg;  // this warpgroup's first row
      const bf16* A = reinterpret_cast<const bf16*>(smem + L.offA + stage * L.stageA) +
                      static_cast<size_t>(row0) * 64;
      if (blk > 0) named_bar(1 + wg, 128);  // the last block's H is read
      // layer 1: H = relu(rnd(rnd(A @ w1) + b1)), this warpgroup's rows
      chunks<NC>(
          n1,
          [&](float (&d)[NC / 2], int c) {
            const bf16* Wp = panel(W1 + static_cast<size_t>(c) * NC * 64);
            fence_regs(d);
            gmma_fence();
            gmma_run<NC>(d, gmma_desc(A), gmma_desc(Wp), L.C1p / 64,
                         rows_stride, w1_stride);
            gmma_commit();
          },
          [&](int) { SA_MARK(6); },
          [&](float (&d)[NC / 2], int c) {
            free_panel();
            if (c == n1 - 1 && blk == blocks - 1 && lane == 0)
              mbar_arrive(empty + stage);  // every wgmma on A is done
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) {
              const float2 bb =
                  *reinterpret_cast<const float2*>(sb1 + c * NC + 8 * j + 2 * q);
              uint32_t* hp = reinterpret_cast<uint32_t*>(
                  h_mine + static_cast<size_t>(c) * hrows * 64 + ((j ^ rq) * 8));
              hp[0] = bias_relu(d[4 * j], d[4 * j + 1], bb);
              hp[8 * 64 / 2] = bias_relu(d[4 * j + 2], d[4 * j + 3], bb);
            }
            SA_MARK(7);
          });
      fence_async_smem();
      named_bar(1 + wg, 128);  // H of this warpgroup's rows is complete
      SA_MARK(8);
      // layer 2 and the max over K
      chunks<NC2>(
          n2,
          [&](float (&d)[NC2 / 2], int c) {
            const bf16* Wp = panel(W2 + static_cast<size_t>(c) * NC2 * 64);
            fence_regs(d);
            gmma_fence();
            gmma_run<NC2>(d, gmma_desc(h_wg), gmma_desc(Wp), L.K2p / 64,
                          h_stride, w2_stride);
            gmma_commit();
          },
          [&](int) { SA_MARK(9); },
          [&](float (&d)[NC2 / 2], int c) {
            free_panel();
            // The max over K is taken on the f32 sums: x -> relu(rnd(rnd(x)
            // + b)) never decreases, so the max of the rounded outputs is the
            // output of the largest sum, and the epilogue runs once a
            // centroid and column. The warp's 16 rows are one centroid's:
            // max over rows r and r+8 in the thread, then over the 8 row
            // quads by shuffles.
            const int pslot = blocks > 1 ? c : buf;
            float* pw = part + (static_cast<size_t>(pslot) * slabs +
                                8 * blk + 4 * wg + warp) * NC2;
#pragma unroll
            for (int j = 0; j < NC2 / 8; ++j) {
              float m0 = fmaxf(d[4 * j], d[4 * j + 2]);
              float m1 = fmaxf(d[4 * j + 1], d[4 * j + 3]);
#pragma unroll
              for (int x = 4; x < 32; x <<= 1) {
                m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, x));
                m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, x));
              }
              if (rq == 0)
                *reinterpret_cast<float2*>(pw + 8 * j + 2 * q) = make_float2(m0, m1);
            }
            SA_MARK(10);
            if (blocks == 1) {
              named_bar(gid, gthreads);
              SA_MARK(11);
              write_out(b, s0, c, buf);
              buf ^= 1;
              SA_MARK(12);
            }
          });
    }
    if (blocks > 1) {  // every block's slabs are in: combine them
      named_bar(gid, gthreads);
      for (int c = 0; c < n2; ++c) write_out(b, s0, c, c);
      named_bar(gid, gthreads);  // read before the next tile writes
    }
  }
  SA_FLUSH;
}

// NPW producer warpgroups, each with its own A stage (two: layer 2 in
// kNC2-wide chunks, the producers giving registers to the consumers; three,
// for the ball query's selection: 96 registers a thread, kNC-wide chunks)
template <int NPW, bool kGivenIdx>
__global__ void __launch_bounds__(128 * (2 + NPW), 1) sa_ws_kernel(SaArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms want a 1024-byte aligned base (the plan has the slack)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WsLayout L(a);
  const int ncw = blockDim.x / 128 - NPW;  // consumer warpgroups
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.offBar);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) {
      mbar_init(bar + i, 128);          // A stage full: a producer's threads
      mbar_init(bar + 3 + i, 4 * ncw);  // empty: one lane a consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + 6 + i, 128);      // weight panel full
      mbar_init(bar + 8 + i, 4 * ncw);  // weight panel empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // once a block: resident weights, biases in f32, zeroed A stages
  const int tid = threadIdx.x, nth = blockDim.x;
  if (a.resident) {
    copy_panel(reinterpret_cast<bf16*>(smem), static_cast<const bf16*>(a.w1),
               a.C1, a.C2, L.C1p, 0, L.N1p, tid, nth);
    copy_panel(reinterpret_cast<bf16*>(smem + L.offW2),
               static_cast<const bf16*>(a.w2), a.C2, a.C3, L.K2p, 0, L.N2p,
               tid, nth);
  }
  float* sb1 = reinterpret_cast<float*>(smem + L.offB1);
  float* sb2 = reinterpret_cast<float*>(smem + L.offB2);
  for (int n = tid; n < L.N1p; n += nth)
    sb1[n] = n < a.C2 ? to_f(static_cast<const bf16*>(a.b1)[n]) : 0.f;
  for (int n = tid; n < L.N2p; n += nth)
    sb2[n] = n < a.C3 ? to_f(static_cast<const bf16*>(a.b2)[n]) : 0.f;
  uint4* A = reinterpret_cast<uint4*>(smem + L.offA);
  for (size_t i = tid; i < a.stages * L.stageA / 16; i += nth)
    A[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  __syncthreads();
  // with two producers (512 threads, 128 registers each at launch) the
  // producers give registers to the consumers' accumulators: 104 and 152
  if (threadIdx.x >= 128 * ncw) {
    if constexpr (NPW == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    produce<NPW, NPW == 3 ? 2 : 4, kGivenIdx>(a, smem, ncw);
  } else {
    if constexpr (NPW == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
    consume<NPW == 2 ? kNC2 : kNC, NPW != 2>(a, smem, ncw);
  }
}

// ============================================== f32: CUDA-core FMA kernel

constexpr int kF32Consumers = 256;  // a 16 x 16 grid of thread tiles
constexpr int kF32Threads = kF32Consumers + 256;  // + two producer warpgroups
constexpr int kF32MaxStages = 2;  // A stages
// k rows a step of the products (a k-loop's unroll; C1 and C2 are padded to
// it), and a streamed weight panel: two steps (twice as many rows a block
// barrier: 5 % faster at SA2 than one, utils/sa_plans.py --src, PERF.md)
constexpr int kF32BK = 16, kF32Panel = 2 * kF32BK;

// output columns a product chunk: the least of 32, 64 and 128 that holds C
// (a thread then owns 2, 4 or 8 of them)
__host__ __device__ inline int f32_nc(int C) {
  return C <= 32 ? 32 : C <= 64 ? 64 : 128;
}

// Shared-memory layout of sa_f32_kernel, in bytes (cuda_kernels._f32_smem
// computes the same total): weights (resident w1 then w2, chunk-major: a
// chunk's [C1p][NC1] (or [K2p][NC2]) after the other, or two streamed
// panel slots of kF32Panel rows) | A stages (channel-major, [C1p][ldA]) | H
// ([K2p][ldA]) | b1, b2 | neighbour indices (two tiles) | the tile's cbias
// rows (two tiles) | slab maxima (two chunks) | the running maxima of a
// centroid walked in blocks | the cloud's points (ball-query form, where
// they fit) | mbarriers. Every leading dimension is a compile-time constant
// of the kernel (an operand's address is a register plus an immediate):
// the A stages' and H's the block's rows + 4, so that the producer's
// transposing stores and layer 1's H stores spread over the banks; the
// weights' the chunk width.
struct F32Layout {
  int C1p, K2p, NC1, NC2, N1p, N2p, KR, KRt, ldA, blocks, tileRows;
  size_t offW2, offA, stageA, offH, offB1, offB2, offIdx, offCb, offPart,
      offRun, offXyz, offBar, total;
  __host__ __device__ explicit F32Layout(const SaArgs& a) {
    C1p = round_up(a.C1, kF32BK);
    K2p = round_up(a.C2, kF32BK);
    NC1 = f32_nc(a.C2);
    NC2 = f32_nc(a.C3);
    N1p = round_up(a.C2, NC1);
    N2p = round_up(a.C3, NC2);
    KR = round_up(a.K, 16);
    ldA = a.rows + 4;
    // a centroid past a block's rows is walked in blocks (St = 1)
    blocks = KR <= a.rows ? 1 : (KR + a.rows - 1) / a.rows;
    tileRows = blocks * a.rows;
    KRt = blocks > 1 ? tileRows : KR;  // rows a centroid in the tile
    size_t o;
    if (a.resident) {
      offW2 = align128(static_cast<size_t>(C1p) * N1p * 4);
      o = offW2 + align128(static_cast<size_t>(K2p) * N2p * 4);
    } else {
      offW2 = align128(static_cast<size_t>(kF32Panel) *
                       (NC1 > NC2 ? NC1 : NC2) * 4);
      o = 2 * offW2;
    }
    offA = o;
    stageA = align128(static_cast<size_t>(C1p) * ldA * 4);
    o += a.stages * stageA;
    offH = o;
    o += align128(static_cast<size_t>(K2p) * ldA * 4);
    offB1 = o;
    o += align128(static_cast<size_t>(N1p) * 4);
    offB2 = o;
    o += align128(static_cast<size_t>(N2p) * 4);
    offIdx = o;
    o += align128(static_cast<size_t>(2) * tileRows * 4);
    offCb = o;
    o += align128(static_cast<size_t>(2) * a.St * C1p * 4);
    offPart = o;
    o += align128(static_cast<size_t>(2) * (a.rows / 16) * NC2 * 4);
    offRun = o;
    o += blocks > 1 ? align128(static_cast<size_t>(N2p) * 4) : 0;
    offXyz = o;
    // (x, y, z, |p|^2) a point, padded to whole rounds of the selection
    o += a.xyz_smem
             ? align128(static_cast<size_t>(round_up(a.N, 32 * kSelectU)) * 16)
             : 0;
    offBar = o;
    total = o + 128;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// W [Kin][N] (device memory) into dst as Np / NC chunks of [Kp][NC], one
// after the other, zero past Kin and N
__device__ void f32_copy_weights(float* dst, const float* W, int Kin, int N,
                                 int Kp, int Np, int NC, int tid, int nth) {
  for (int e = tid; e < Kp * Np; e += nth) {
    const int k = e / Np, n = e % Np;
    dst[((n / NC) * Kp + k) * NC + n % NC] =
        k < Kin && n < N ? __ldg(W + static_cast<size_t>(k) * N + n) : 0.f;
  }
}

// The producers, two warpgroups with a role each, handing a tile's
// neighbours over through two buffers (sel_full / sel_empty mbarriers):
// * the selecting warpgroup: each tile's neighbours (the ball query, one
//   warp a centroid, over the cloud's points in shared memory where they
//   fit; or a copy of the given indices) and its centroids' cbias rows,
//   into the buffer of the tile's parity;
// * the gathering warpgroup: each block of rows of a tile into the A
//   stages, A[c][r] = relu(pre[idx[r]][c] + cbias[s][c]), zero for
//   C1 <= c < C1p; the buffer handed back after the tile's last block.
// So the next tile's selection runs while this one's rows are gathered.
template <bool kGivenIdx>
__device__ void f32_select(const SaArgs& a, unsigned char* smem) {
  const F32Layout L(a);
  const int t = threadIdx.x - kF32Consumers, pw = t >> 5, lane = t & 31;
  constexpr int kBar = 2;  // named barrier of the selecting warpgroup
  const int tpc = (a.S + a.St - 1) / a.St;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.offBar);
  uint64_t *sel_full = bar + 2 * kF32MaxStages, *sel_empty = sel_full + 2;
  float4* spts = reinterpret_cast<float4*>(smem + L.offXyz);
  int cloud = -1;
  for (int tile = tile_begin(a), it = 0; tile < tile_end(a); ++tile, ++it) {
    const int b = tile / tpc, s0 = (tile % tpc) * a.St, slot = it & 1;
    mbar_wait(sel_empty + slot, ((it >> 1) & 1) ^ 1);
    int* idx = reinterpret_cast<int*>(smem + L.offIdx) + slot * L.tileRows;
    float* scb = reinterpret_cast<float*>(smem + L.offCb) +
                 slot * a.St * L.C1p;
    // neighbours: idx[s*KRt + k], rows k >= K repeat k = 0; centroids
    // past S, and the rows past St*KRt, select point 0
    if constexpr (kGivenIdx) {
      for (int r = t; r < L.tileRows; r += 128) {
        const int s = r / L.KRt, k = r % L.KRt, sg = s0 + s;
        idx[r] = s < a.St && sg < a.S
                     ? __ldg(a.idx + (static_cast<size_t>(b) * a.S + sg) * a.K +
                             (k < a.K ? k : 0))
                     : 0;
      }
    } else {
      // the cloud's points in shared memory, where they fit, each with its
      // |p|^2 (one 16-byte load a visit; NaN points pad the last round),
      // once every warp is past the last cloud's walks
      const float* xyz = a.xyz + static_cast<size_t>(b) * a.N * 3;
      if (a.xyz_smem && b != cloud) {
        named_bar(kBar, 128);
        for (int i = t; i < round_up(a.N, 32 * kSelectU); i += 128) {
          float4 v = mm3d_bq_nan_point();
          if (i < a.N) {
            const float px = __ldg(xyz + 3 * i), py = __ldg(xyz + 3 * i + 1),
                        pz = __ldg(xyz + 3 * i + 2);
            v = make_float4(px, py, pz, mm3d_dot3(px, py, pz, px, py, pz));
          }
          spts[i] = v;
        }
        named_bar(kBar, 128);
        cloud = b;
      }
      for (int s = pw; s < a.St; s += 4) {
        const int sg = s0 + s;
        int* row = idx + s * L.KRt;
        if (sg < a.S) {
          const float* c = a.new_xyz + (static_cast<size_t>(b) * a.S + sg) * 3;
          if (a.xyz_smem)
            mm3d_ball_query_warp<kSelectU>(BqCloud4{spts}, a.N, c[0], c[1],
                                           c[2], a.r2, a.K, row);
          else
            mm3d_ball_query_warp<kSelectU>(BqCloud3{xyz}, a.N, c[0], c[1],
                                           c[2], a.r2, a.K, row);
          const int first = row[0];
          for (int k = a.K + lane; k < L.KRt; k += 32) row[k] = first;
        } else {
          for (int k = lane; k < L.KRt; k += 32) row[k] = 0;
        }
      }
      for (int r = a.St * L.KRt + t; r < L.tileRows; r += 128) idx[r] = 0;
    }
    // the tile's cbias rows, centroids past S clamped to S - 1
    for (int s = pw; s < a.St; s += 4) {
      const float* cb = static_cast<const float*>(a.cbias) +
                        (static_cast<size_t>(b) * a.S + min(s0 + s, a.S - 1)) *
                            a.C1;
      for (int c = lane; c < L.C1p; c += 32)
        scb[s * L.C1p + c] = c < a.C1 ? __ldg(cb + c) : 0.f;
    }
    mbar_arrive(sel_full + slot);
  }
}

template <bool kGivenIdx>
__device__ void f32_gather(const SaArgs& a, unsigned char* smem) {
  const F32Layout L(a);
  const int t = threadIdx.x - kF32Consumers - 128, pw = t >> 5;
  constexpr int kB = 4;  // pre loads a thread keeps in flight
  const int tpc = (a.S + a.St - 1) / a.St, Qh = L.C1p / 8;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.offBar);
  uint64_t *full = bar, *empty = bar + kF32MaxStages;
  uint64_t *sel_full = bar + 2 * kF32MaxStages, *sel_empty = sel_full + 2;
  const bool vec = a.C1 % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.pre) & 15) == 0;
  // this thread's rows of a block: row r16 of row groups pw and pw + 4 (of
  // 8 at 128 rows, 4 at 64); its channel quads 2*qp + qq, qp < Qh: a warp's
  // loads fill whole 32-byte sectors and its transposing stores hit 32
  // different banks
  const int r16 = t & 15, qq = (t >> 4) & 1;
  const int nrow = a.rows == 128 ? 2 : 1, items = nrow * Qh;
  int use = 0;
  for (int tile = tile_begin(a), it = 0; tile < tile_end(a); ++tile, ++it) {
    const int b = tile / tpc, slot = it & 1;
    mbar_wait(sel_full + slot, (it >> 1) & 1);
    const int* idx =
        reinterpret_cast<const int*>(smem + L.offIdx) + slot * L.tileRows;
    const float* scb = reinterpret_cast<const float*>(smem + L.offCb) +
                       slot * a.St * L.C1p;
    const float* pre = static_cast<const float*>(a.pre) +
                       static_cast<size_t>(b) * a.N * a.C1;
    for (int blk = 0; blk < L.blocks; ++blk, ++use) {
      const int stage = use % a.stages;
      mbar_wait(empty + stage, ((use / a.stages) & 1) ^ 1);
      float* A = reinterpret_cast<float*>(smem + L.offA + stage * L.stageA);
      int rr[2];
      const float *src[2], *cbr[2];
      for (int i = 0; i < 2; ++i) {  // this thread's rows, their cbias rows
        rr[i] = (pw + 4 * (i < nrow ? i : 0)) * 16 + r16;
        const int tr = blk * a.rows + rr[i];
        src[i] = pre + static_cast<size_t>(idx[tr]) * a.C1;
        cbr[i] = scb + (L.blocks > 1 ? 0 : min(tr / L.KR, a.St - 1)) * L.C1p;
      }
      for (int m0 = 0; m0 < items; m0 += kB) {
        float4 p[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const int m = m0 + u, i = m >= Qh, c0 = 4 * (2 * (m - i * Qh) + qq);
          p[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (m < items && c0 < a.C1) {
            if (vec) {
              p[u] = __ldg(reinterpret_cast<const float4*>(src[i] + c0));
            } else {
              float* pv = &p[u].x;
              for (int j = 0; j < 4 && c0 + j < a.C1; ++j)
                pv[j] = __ldg(src[i] + c0 + j);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const int m = m0 + u, i = m >= Qh, c0 = 4 * (2 * (m - i * Qh) + qq);
          if (m < items) {
            const float4 q = c0 < a.C1
                                 ? *reinterpret_cast<const float4*>(cbr[i] + c0)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            float* dst = A + static_cast<size_t>(c0) * L.ldA + rr[i];
            dst[0] = fmaxf(p[u].x + q.x, 0.f);
            dst[L.ldA] = fmaxf(p[u].y + q.y, 0.f);
            dst[2 * L.ldA] = fmaxf(p[u].z + q.z, 0.f);
            dst[3 * L.ldA] = fmaxf(p[u].w + q.w, 0.f);
          }
        }
      }
      mbar_arrive(full + stage);
    }
    mbar_arrive(sel_empty + slot);
  }
}

// V consecutive floats of shared memory into registers (one 16-, 8- or
// 4-byte load)
template <int V>
__device__ __forceinline__ void f32_ld(float* v, const float* p) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// acc += A[0:kF32BK] x W[0:kF32BK] for the thread's rows (A points at its
// first, ra: ra..ra+3, and ra + 64.. at TM = 8) and columns (W points at
// its first, ca: TN/2 from there and TN/2 from NC/2 on): A channel-major
// with leading dimension LD, W [k][NC] (a chunk of NC columns)
template <int TM, int TN, int LD, int NC>
__device__ __forceinline__ void f32_panel(float (&acc)[TM][TN],
                                          const float* __restrict__ A,
                                          const float* __restrict__ W) {
  constexpr int ldA = LD;
#pragma unroll
  for (int k = 0; k < kF32BK; ++k) {
    float x[TM], w[TN];
    f32_ld<4>(x, A + k * ldA);
    if constexpr (TM == 8) f32_ld<4>(x + 4, A + k * ldA + 64);
    f32_ld<TN / 2>(w, W + k * NC);
    f32_ld<TN / 2>(w + TN / 2, W + k * NC + NC / 2);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
  }
}

// The consumers' state: the layout, the thread's place in the 16 x 16 grid
// (chunk() maps it onto the 32 x 8 grid of narrow chunks)
// and the streamed weights' panel ring (panel g of the block's sequence:
// layer 1's chunks, then layer 2's, each kF32Panel rows at a time, the same
// sequence for every block of rows).
struct F32Consumer {
  const SaArgs& a;
  F32Layout L;
  unsigned char* smem;
  int ct, lane, wr, rgl, ra, cgi;  // cgi: the column group 0..15
  int ks1, ks2, P, g;
  __device__ F32Consumer(const SaArgs& args, unsigned char* s)
      : a(args), L(args), smem(s) {
    ct = threadIdx.x;
    lane = ct & 31;
    const int warp = ct >> 5;
    wr = warp & 3;
    rgl = lane & 3;
    ra = (wr * 4 + rgl) * 4;
    cgi = (warp >> 2) * 8 + (lane >> 2);
    ks1 = (L.C1p + kF32Panel - 1) / kF32Panel;
    ks2 = (L.K2p + kF32Panel - 1) / kF32Panel;
    P = (L.N1p / L.NC1) * ks1 + (L.N2p / L.NC2) * ks2;
    g = 0;
  }
  __device__ float* ring(int slot) const {
    return reinterpret_cast<float*>(smem + slot * L.offW2);
  }
  // copies panel `seq` of the sequence into its slot (seq & 1)
  __device__ void fetch(int seq) {
    int p = seq % P;
    const int n1p = (L.N1p / L.NC1) * ks1;
    const bool l2 = p >= n1p;
    if (l2) p -= n1p;
    const int ks = l2 ? ks2 : ks1, NC = l2 ? L.NC2 : L.NC1;
    const int Kin = l2 ? a.C2 : a.C1, N = l2 ? a.C3 : a.C2;
    const float* W = static_cast<const float*>(l2 ? a.w2 : a.w1);
    const int c0 = (p / ks) * NC, k0 = (p % ks) * kF32Panel;
    float* dst = ring(seq & 1);
    if (N % 4 == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0) {
      const int n4 = NC / 4;
      for (int e = ct; e < kF32Panel * n4; e += kF32Consumers) {
        const int k = k0 + e / n4, n = c0 + (e % n4) * 4;
        const bool ok = k < Kin && n < N;
        cp_async16(dst + 4 * e, ok ? W + static_cast<size_t>(k) * N + n : W,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = ct; e < kF32Panel * NC; e += kF32Consumers) {
        const int k = k0 + e / NC, n = c0 + e % NC;
        const bool ok = k < Kin && n < N;
        cp_async4(dst + e, ok ? W + static_cast<size_t>(k) * N + n : W,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  }
  // the next streamed panel: its copies done and seen by every consumer,
  // every consumer past the panel before it (whose slot the next one takes)
  __device__ const float* next() {
    cp_async_wait_all();
    named_bar(1, kF32Consumers);
    fetch(g + 1);
    return ring(g++ & 1);
  }
  __device__ void bar() { named_bar(1, kF32Consumers); }

  // One chunk of NC = 16*TN0 output columns (chunk c) over `rows` = 16*TM0
  // rows: X channel-major [Kin rows][ldA] times the layer's weights, then
  // the layer's epilogue. Layer 1: + b1, relu, stored into H; layer 2: the
  // slab maxima into part buffer pbuf. A chunk narrower than 128 columns
  // over a block of 128 rows takes thread tiles of 4 rows x 2*TN0 columns
  // on a 32 x 8 grid (each warp 16 rows, a slab, of every column): one A
  // load a k-step in place of two.
  template <int TM0, int TN0, bool kL2>
  __device__ __forceinline__ void chunk(const float* X, int c, int pbuf) {
    constexpr bool kWide = TM0 == 8 && TN0 < 8;
    constexpr int TM = kWide ? 4 : TM0, TN = kWide ? 2 * TN0 : TN0;
    constexpr int NC = 16 * TN0, ld = 16 * TM0 + 4;
    const int warp = ct >> 5;
    const int ra = kWide ? (warp * 4 + rgl) * 4 : this->ra;
    const int ca = (kWide ? lane >> 2 : cgi) * (TN / 2), cb = ca + NC / 2;
    const int Kin = kL2 ? L.K2p : L.C1p;
    // the chunk's resident weights, [Kin][NC]
    const float* Wres = reinterpret_cast<const float*>(
                            smem + (kL2 ? L.offW2 : 0)) +
                        static_cast<size_t>(c) * Kin * NC;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    if (a.resident) {
      for (int k0 = 0; k0 < Kin; k0 += kF32BK)
        f32_panel<TM, TN, ld, NC>(acc, X + k0 * ld + ra,
                                  Wres + k0 * NC + ca);
    } else {
      for (int k0 = 0; k0 < Kin; k0 += kF32Panel) {
        const float* W = next() + ca;
        f32_panel<TM, TN, ld, NC>(acc, X + k0 * ld + ra, W);
        // the panel's second step, where Kin has it
        if (kF32Panel > kF32BK && k0 + kF32BK < Kin)
          f32_panel<TM, TN, ld, NC>(acc, X + (k0 + kF32BK) * ld + ra,
                                    W + kF32BK * NC);
      }
    }
    if constexpr (!kL2) {
      const float* sb1 = reinterpret_cast<const float*>(smem + L.offB1);
      float* H = reinterpret_cast<float*>(smem + L.offH);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c * NC + (j < TN / 2 ? ca + j : cb + j - TN / 2);
        if (col < L.K2p) {  // H keeps the rows layer 2 reads
          const float bb = sb1[col];
#pragma unroll
          for (int h = 0; h < TM / 4; ++h)
            *reinterpret_cast<float4*>(H + static_cast<size_t>(col) * ld +
                                       ra + 64 * h) =
                make_float4(fmaxf(acc[4 * h][j] + bb, 0.f),
                            fmaxf(acc[4 * h + 1][j] + bb, 0.f),
                            fmaxf(acc[4 * h + 2][j] + bb, 0.f),
                            fmaxf(acc[4 * h + 3][j] + bb, 0.f));
        }
      }
    } else {
      // The max over K on the sums: x -> relu(x + b2) never decreases, so
      // it commutes with the max. A thread's 4 rows of a half, then the 4
      // lanes (rgl) of its 16-row slab, which lies in one centroid: the
      // warp's (wide tiles), or the warp-row's of each half.
      float* part = reinterpret_cast<float*>(smem + L.offPart) +
                    static_cast<size_t>(pbuf) * (a.rows / 16) * L.NC2;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = j < TN / 2 ? ca + j : cb + j - TN / 2;
#pragma unroll
        for (int h = 0; h < TM / 4; ++h) {
          float m = fmaxf(fmaxf(acc[4 * h][j], acc[4 * h + 1][j]),
                          fmaxf(acc[4 * h + 2][j], acc[4 * h + 3][j]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (rgl == 0)
            part[(kWide ? warp : h * (a.rows / 32) + wr) * L.NC2 + col] = m;
        }
      }
    }
  }

  template <int TM, bool kL2>
  __device__ __forceinline__ void chunk_any(const float* X, int c, int pbuf) {
    const int NC = kL2 ? L.NC2 : L.NC1;
    if (NC == 128)
      chunk<TM, 8, kL2>(X, c, pbuf);
    else if (NC == 64)
      chunk<TM, 4, kL2>(X, c, pbuf);
    else
      chunk<TM, 2, kL2>(X, c, pbuf);
  }

  // each centroid's slab maxima of layer-2 chunk c (buffer pbuf): + b2,
  // relu, written; a centroid walked in blocks merges them into its
  // running row first
  __device__ void combine(int b, int s0, int blk, int c, int pbuf) {
    const int NC2 = L.NC2, nslab = a.rows / 16;
    const float* part = reinterpret_cast<const float*>(smem + L.offPart) +
                        static_cast<size_t>(pbuf) * nslab * NC2;
    const float* sb2 = reinterpret_cast<const float*>(smem + L.offB2);
    float* out = static_cast<float*>(a.out);
    if (L.blocks == 1) {
      const int spc = L.KR / 16;
      for (int e = ct; e < a.St * NC2; e += kF32Consumers) {
        const int s = e / NC2, cl = e % NC2, col = c * NC2 + cl;
        const int sg = s0 + s;
        if (sg >= a.S || col >= a.C3) continue;
        const float* pp = part + s * spc * NC2 + cl;
        float m = pp[0];
        for (int sl = 1; sl < spc; ++sl) m = fmaxf(m, pp[sl * NC2]);
        out[(static_cast<size_t>(b) * a.S + sg) * a.C3 + col] =
            fmaxf(m + sb2[col], 0.f);
      }
    } else {
      float* run = reinterpret_cast<float*>(smem + L.offRun);
      for (int cl = ct; cl < NC2; cl += kF32Consumers) {
        const int col = c * NC2 + cl;
        if (col >= a.C3) continue;
        float m = part[cl];
        for (int sl = 1; sl < nslab; ++sl) m = fmaxf(m, part[sl * NC2 + cl]);
        if (blk > 0) m = fmaxf(m, run[col]);
        if (blk == L.blocks - 1)
          out[(static_cast<size_t>(b) * a.S + s0) * a.C3 + col] =
              fmaxf(m + sb2[col], 0.f);
        else
          run[col] = m;
      }
    }
  }
};

// The consumers: for each block of rows, layer 1 chunk by chunk into H, the
// A stage handed back, then layer 2 chunk by chunk with the max over K.
template <int TM>
__device__ void f32_consume(const SaArgs& a, unsigned char* smem) {
  F32Consumer C(a, smem);
  const F32Layout& L = C.L;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.offBar);
  uint64_t *full = bar, *empty = bar + kF32MaxStages;
  const float* H = reinterpret_cast<const float*>(smem + L.offH);
  const int tpc = (a.S + a.St - 1) / a.St;
  const int n1 = L.N1p / L.NC1, n2 = L.N2p / L.NC2;
  if (!a.resident) C.fetch(0);
  int use = 0, pbuf = 0;
  for (int tile = tile_begin(a); tile < tile_end(a); ++tile) {
    const int b = tile / tpc, s0 = (tile % tpc) * a.St;
    for (int blk = 0; blk < L.blocks; ++blk, ++use) {
      const int stage = use % a.stages;
      mbar_wait(full + stage, (use / a.stages) & 1);
      const float* A =
          reinterpret_cast<const float*>(smem + L.offA + stage * L.stageA);
      for (int c = 0; c < n1; ++c) C.chunk_any<TM, false>(A, c, 0);
      __syncwarp();
      if (C.lane == 0) mbar_arrive(empty + stage);  // A is read
      C.bar();  // H is complete
      for (int c = 0; c < n2; ++c) {
        C.chunk_any<TM, true>(H, c, pbuf);
        C.bar();  // the slab maxima are in; every thread is past H's reads
        C.combine(b, s0, blk, c, pbuf);
        pbuf ^= 1;
      }
    }
  }
  cp_async_wait_all();  // the panel prefetched past the last block
}

// The f32 kernel; TM = 8 for blocks of 128 rows, 4 for 64.
template <int TM, bool kGivenIdx>
__global__ void __launch_bounds__(kF32Threads, 1) sa_f32_kernel(SaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L(a);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.offBar);
  const int tid = threadIdx.x;
  if (tid == 0) {
    // an A stage full: the gathering warpgroup's threads; empty: a lane a
    // consumer warp; a tile's neighbours selected: the selecting
    // warpgroup's threads; gathered: the gathering warpgroup's
    for (int i = 0; i < kF32MaxStages; ++i) {
      mbar_init(bar + i, 128);
      mbar_init(bar + kF32MaxStages + i, kF32Consumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + 2 * kF32MaxStages + i, 128);
      mbar_init(bar + 2 * kF32MaxStages + 2 + i, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // once a block: resident weights, biases, zero padded
  if (a.resident) {
    f32_copy_weights(reinterpret_cast<float*>(smem),
                     static_cast<const float*>(a.w1), a.C1, a.C2, L.C1p,
                     L.N1p, L.NC1, tid, kF32Threads);
    f32_copy_weights(reinterpret_cast<float*>(smem + L.offW2),
                     static_cast<const float*>(a.w2), a.C2, a.C3, L.K2p,
                     L.N2p, L.NC2, tid, kF32Threads);
  }
  f32_copy_weights(reinterpret_cast<float*>(smem + L.offB1),
                   static_cast<const float*>(a.b1), 1, a.C2, 1, L.N1p, L.N1p,
                   tid, kF32Threads);
  f32_copy_weights(reinterpret_cast<float*>(smem + L.offB2),
                   static_cast<const float*>(a.b2), 1, a.C3, 1, L.N2p, L.N2p,
                   tid, kF32Threads);
  __syncthreads();
  // launched with 128 registers a thread: the producers give 48 each to
  // the consumers' sums and prefetched operands
  if (tid >= kF32Consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    if (tid < kF32Consumers + 128)
      f32_select<kGivenIdx>(a, smem);
    else
      f32_gather<kGivenIdx>(a, smem);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n" ::: "memory");
    f32_consume<TM>(a, smem);
  }
}

// ============================================== loop kernel (wide bf16)

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // output columns per product pass

// Shared-memory layout, in bytes: idx[R] | A[Rp][ldA] | H[Rp][ldH] | Sc[Rp][ldS]
// (cuda_kernels._loop_smem computes the same total), A and H in bf16
struct Layout {
  int R, Rp, C1p, C2p, ldA, ldH, ldS;
  size_t offA, offH, offS, total;
  __host__ __device__ Layout(int St, int K, int C1, int C2) {
    constexpr int esize = sizeof(bf16);
    R = St * K;
    Rp = (R + 15) & ~15;
    C1p = round_up(C1, 16);
    C2p = round_up(C2, 16);
    ldA = C1p + 16 / esize;  // a 16-byte skew spreads the rows over the banks
    ldH = C2p + 16 / esize;
    ldS = kChunk + 4;
    offA = ((static_cast<size_t>(R) * 4 + 127) / 128) * 128;
    offH = offA + static_cast<size_t>(Rp) * ldA * esize;
    offS = offH + static_cast<size_t>(Rp) * ldH * esize;
    total = offS + static_cast<size_t>(Rp) * ldS * sizeof(float);
  }
};

__device__ __forceinline__ float ldg_f(const bf16* p) {
  return __uint_as_float(
      static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}

// Sc[Rp][ncols] = X[Rp][0:Kin] @ W[0:Kin][c0:c0+ncols] in f32, W [Kin][Nout]
// in device memory, columns past Nout 0; CUDA-core FMAs, each thread four
// rows of one column.
__device__ void product_chunk(const bf16* X, int ldx, int Kin, const bf16* W,
                              int Nout, int c0, int ncols, float* Sc, int ldS,
                              int Rp) {
  const int nq = (Rp / 4) * ncols;
  for (int e = threadIdx.x; e < nq; e += kThreads) {
    const int r = (e / ncols) * 4, c = e % ncols;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (c0 + c < Nout) {
      const bf16* w = W + c0 + c;
      const bf16* x = X + r * ldx;
      for (int k = 0; k < Kin; ++k) {
        const float wk = ldg_f(w + static_cast<size_t>(k) * Nout);
        a0 = fmaf(to_f(x[k]), wk, a0);
        a1 = fmaf(to_f(x[ldx + k]), wk, a1);
        a2 = fmaf(to_f(x[2 * ldx + k]), wk, a2);
        a3 = fmaf(to_f(x[3 * ldx + k]), wk, a3);
      }
    }
    Sc[r * ldS + c] = a0;
    Sc[(r + 1) * ldS + c] = a1;
    Sc[(r + 2) * ldS + c] = a2;
    Sc[(r + 3) * ldS + c] = a3;
  }
}

template <bool kGivenIdx>
__global__ void __launch_bounds__(kThreads) sa_loop_kernel(SaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.St, a.K, a.C1, a.C2);
  int* idx = reinterpret_cast<int*>(smem);
  bf16* A = reinterpret_cast<bf16*>(smem + L.offA);
  bf16* H = reinterpret_cast<bf16*>(smem + L.offH);
  float* Sc = reinterpret_cast<float*>(smem + L.offS);

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * a.St;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* pre = static_cast<const bf16*>(a.pre) + static_cast<size_t>(b) * a.N * a.C1;
  const bf16* cb = static_cast<const bf16*>(a.cbias) + static_cast<size_t>(b) * a.S * a.C1;
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* b1 = static_cast<const bf16*>(a.b1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* b2 = static_cast<const bf16*>(a.b2);
  bf16* out = static_cast<bf16*>(a.out);

  // 1. neighbours, idx[s*K + k] for the tile's centroids; rows past S
  // select point 0
  if constexpr (kGivenIdx) {
    // the caller's indices: the tile's St*K of them are contiguous
    const int* gi = a.idx + (static_cast<size_t>(b) * a.S + s0) * a.K;
    const int valid = min(a.St, a.S - s0) * a.K;
    for (int r = threadIdx.x; r < L.R; r += kThreads)
      idx[r] = r < valid ? __ldg(gi + r) : 0;
  } else {
    // the ball query: one warp per centroid of the tile
    for (int s = warp; s < a.St; s += kWarps) {
      const int sg = s0 + s;
      if (sg < a.S) {
        const float* c = a.new_xyz + (static_cast<size_t>(b) * a.S + sg) * 3;
        mm3d_ball_query_warp<kLoopSelectU>(
            BqCloud3{a.xyz + static_cast<size_t>(b) * a.N * 3}, a.N, c[0],
            c[1], c[2], a.r2, a.K, idx + s * a.K);
      } else {
        for (int k = lane; k < a.K; k += 32) idx[s * a.K + k] = 0;
      }
    }
  }
  __syncthreads();

  // 2. gather: A[r] = relu(rnd(pre[idx[r]] + cbias[s])), zero padding
  for (int r = warp; r < L.Rp; r += kWarps) {
    bf16* row = A + r * L.ldA;
    if (r < L.R) {
      const int sg = min(s0 + r / a.K, a.S - 1);
      const bf16* src = pre + static_cast<size_t>(idx[r]) * a.C1;
      const bf16* cbr = cb + static_cast<size_t>(sg) * a.C1;
      for (int c = lane; c < L.C1p; c += 32) {
        float v = 0.f;
        if (c < a.C1) v = fmaxf(rnd<bf16>(to_f(src[c]) + to_f(cbr[c])), 0.f);
        row[c] = from_f<bf16>(v);
      }
    } else {
      for (int c = lane; c < L.C1p; c += 32) row[c] = from_f<bf16>(0.f);
    }
  }
  __syncthreads();

  // 3. layer 1: H = relu(rnd(rnd(A @ w1) + b1)), zero past C2
  for (int c0 = 0; c0 < L.C2p; c0 += kChunk) {
    const int ncols = min(kChunk, L.C2p - c0);
    product_chunk(A, L.ldA, a.C1, w1, a.C2, c0, ncols, Sc, L.ldS, L.Rp);
    __syncthreads();
    for (int e = threadIdx.x; e < L.Rp * ncols; e += kThreads) {
      const int r = e / ncols, c = e % ncols;
      const float v = rnd<bf16>(Sc[r * L.ldS + c]);
      const float bias = c0 + c < a.C2 ? to_f(b1[c0 + c]) : 0.f;
      H[r * L.ldH + c0 + c] = from_f<bf16>(fmaxf(rnd<bf16>(v + bias), 0.f));
    }
    __syncthreads();
  }

  // 4. layer 2 and the max over K: relu outputs are >= 0, so 0 starts the max
  for (int c0 = 0; c0 < a.C3; c0 += kChunk) {
    const int ncols = min(kChunk, round_up(a.C3, 16) - c0);
    product_chunk(H, L.ldH, a.C2, w2, a.C3, c0, ncols, Sc, L.ldS, L.Rp);
    __syncthreads();
    for (int e = threadIdx.x; e < a.St * ncols; e += kThreads) {
      const int s = e / ncols, c = e % ncols;
      const int sg = s0 + s, cg = c0 + c;
      if (sg >= a.S || cg >= a.C3) continue;
      const float bias = to_f(b2[cg]);
      float m = 0.f;
      for (int k = 0; k < a.K; ++k) {
        const float v = rnd<bf16>(Sc[(s * a.K + k) * L.ldS + c]);
        m = fmaxf(m, fmaxf(rnd<bf16>(v + bias), 0.f));
      }
      out[(static_cast<size_t>(b) * a.S + sg) * a.C3 + cg] = from_f<bf16>(m);
    }
    __syncthreads();
  }
}

// ================================================================ launchers

template <bool kGivenIdx>
int launch_loop(const SaArgs& a, size_t smem, cudaStream_t stream) {
  const Layout L(a.St, a.K, a.C1, a.C2);
  if (L.total != smem) return static_cast<int>(cudaErrorInvalidValue);
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sa_loop_kernel<kGivenIdx>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.S + a.St - 1) / a.St, a.B);
  sa_loop_kernel<kGivenIdx><<<grid, kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Persistent blocks of `kernel`, as many as the card holds (at most one a
// tile). Its multiprocessors and blocks a multiprocessor are asked again
// only when the device, the shared memory or the block size changes: the
// cache is the caller's, one a kernel instantiation.
struct LaunchCache {
  int dev = -1, threads = 0, sms = 0, per_sm = 0;
  size_t smem = 0;
};

template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, LaunchCache& c, const SaArgs& a,
                            int threads, size_t smem, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != c.dev || smem != c.smem || threads != c.threads) {
    if ((e = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &c.per_sm, kernel, threads, smem)) != cudaSuccess)
      return e;
    c.dev = dev;
    c.smem = smem;
    c.threads = threads;
  }
  if (c.per_sm < 1) return cudaErrorInvalidConfiguration;
  const long tiles = static_cast<long>(a.B) * ((a.S + a.St - 1) / a.St);
  *grid = static_cast<int>(tiles < c.sms * c.per_sm ? tiles : c.sms * c.per_sm);
  return cudaSuccess;
}

template <int NPW, bool kGivenIdx>
int launch_ws(const SaArgs& a, size_t smem, cudaStream_t stream) {
  const WsLayout L(a);
  if (L.total != smem || a.rows % 64 || (a.rows > 128 && a.rows % 128) ||
      a.St * L.KR > a.rows || a.stages != NPW ||
      (NPW > 1 && !a.resident) ||
      (NPW == 2 && a.rows > 128))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sa_ws_kernel<NPW, kGivenIdx>;
  const int threads = 128 * ((a.rows < 128 ? a.rows : 128) / 64 + NPW);
  static LaunchCache cache;
  const bool fresh = cache.dev < 0;
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, cache, a, threads, smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fresh && NPW == 2) {
    // two producers move registers to the consumers with setmaxnreg,
    // which waits for the 2 x 128 x (152 - R) it asks to be freed by the
    // 2 x 128 x (R - 104) given back: launch with R >= 128 or not at all
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
      return static_cast<int>(e);
    if (attr.numRegs < 128) {
      cache.dev = -1;
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernel: blocks of 128 rows (TM 8) or 64 (TM 4), two producer
// warpgroups, one or two A stages.
template <int TM, bool kGivenIdx>
int launch_f32(const SaArgs& a, size_t smem, cudaStream_t stream) {
  const F32Layout L(a);
  if (L.total != smem || a.producers != 2 ||
      a.stages < 1 || a.stages > kF32MaxStages || a.St < 1 ||
      (L.blocks == 1 ? a.St * L.KR > a.rows : a.St != 1) ||
      (kGivenIdx && a.xyz_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sa_f32_kernel<TM, kGivenIdx>;
  static LaunchCache cache;
  const bool fresh = cache.dev < 0;
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, cache, a, kF32Threads, smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fresh) {
    // setmaxnreg waits for the 256 x (176 - R) registers it asks to be
    // freed by the 256 x (R - 80) given back: launch with R = 128 or not
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
      return static_cast<int>(e);
    if (attr.numRegs != 128) {
      cache.dev = -1;
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
  }
  kernel<<<grid, kF32Threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGivenIdx>
int launch(int is_bf16, const SaArgs& a, int smem, cudaStream_t stream) {
  if (!is_bf16) {
    if (a.rows == 128) return launch_f32<8, kGivenIdx>(a, smem, stream);
    if (a.rows == 64) return launch_f32<4, kGivenIdx>(a, smem, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.producers == 0) return launch_loop<kGivenIdx>(a, smem, stream);
  if (a.producers == 1) return launch_ws<1, kGivenIdx>(a, smem, stream);
  if (a.producers == 2) return launch_ws<2, kGivenIdx>(a, smem, stream);
  if constexpr (!kGivenIdx)  // three producers: the ball query's plans only
    if (a.producers == 3) return launch_ws<3, false>(a, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

SaArgs tail_args(const void* pre, const void* cbias, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* out,
                 int B, int N, int S, int K, int C1, int C2, int C3, int St,
                 int rows, int resident, int xyz_smem,
                 int producers, int stages) {
  SaArgs a{};
  a.pre = pre;
  a.cbias = cbias;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.out = out;
  a.B = B;
  a.N = N;
  a.S = S;
  a.K = K;
  a.C1 = C1;
  a.C2 = C2;
  a.C3 = C3;
  a.St = St;
  a.rows = rows;
  a.resident = resident;
  a.xyz_smem = xyz_smem;
  a.producers = producers;
  a.stages = stages;
  return a;
}

}  // namespace

// The plan (St centroids a tile or block; rows, a tile's (bf16) or a
// block's (f32); resident, xyz_smem; producers, 0 for the bf16 loop kernel;
// stages, the A stages; the shared-memory bytes) is cuda_kernels.sa_plan's;
// a plan whose bytes disagree with the kernel's layout is refused with
// cudaErrorInvalidValue. Weights and biases unpadded, in pre's dtype.
extern "C" int mm3d_fused_sa(int is_bf16, const void* xyz, const void* new_xyz,
                             const void* pre, const void* cbias, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* out, int B, int N, int S, int K, int C1,
                             int C2, int C3, int St, int rows,
                             int resident, int xyz_smem, int producers,
                             int stages, int smem, float r2, void* stream) {
  SaArgs a = tail_args(pre, cbias, w1, b1, w2, b2, out, B, N, S, K, C1, C2,
                       C3, St, rows, resident, xyz_smem, producers, stages);
  a.xyz = static_cast<const float*>(xyz);
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.r2 = r2;
  return launch<false>(is_bf16, a, smem, static_cast<cudaStream_t>(stream));
}

// The given-index form: idx [B,S,K] int32, each in [0, N). Plan as for
// mm3d_fused_sa (no points in shared memory).
extern "C" int mm3d_fused_sa_idx(int is_bf16, const void* idx,
                                 const void* pre, const void* cbias,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* out,
                                 int B, int N, int S, int K, int C1, int C2,
                                 int C3, int St, int rows,
                                 int resident, int producers, int stages,
                                 int smem, void* stream) {
  SaArgs a = tail_args(pre, cbias, w1, b1, w2, b2, out, B, N, S, K, C1, C2,
                       C3, St, rows, resident, 0, producers, stages);
  a.idx = static_cast<const int*>(idx);
  return launch<true>(is_bf16, a, smem, static_cast<cudaStream_t>(stream));
}

#ifdef SA_PHASE_CLOCKS
// The slots' names, "role:phase", in slot order, of the warp-specialised
// kernel (the loop kernel reports none): the producers' slots 0-4 and 14,
// the consumers' 5-12 and 15; a role's "warps" slot counts its warps.
extern "C" const char* mm3d_fused_sa_phase_names() {
  return "producer:selection,producer:selection_barrier,"
         "producer:wait_empty_stage,producer:gather,producer:weight_panels,"
         "consumer:wait_full_stage,consumer:l1_product,consumer:l1_epilogue,"
         "consumer:h_barrier,consumer:l2_product,consumer:l2_epilogue_max,"
         "consumer:combine_barrier,consumer:write,-:-,producer:warps,"
         "consumer:warps";
}

// Copies the 32 phase slots to host memory, then zeroes them if reset.
extern "C" int mm3d_fused_sa_phases(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_sa_phase, sizeof(g_sa_phase));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zeros[32] = {};
    e = cudaMemcpyToSymbol(g_sa_phase, zeros, sizeof(g_sa_phase));
  }
  return static_cast<int>(e);
}
#endif
