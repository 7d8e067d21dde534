// 3-nearest-neighbour selection of one dense point among M sparse points.
//
// Shared by the fused FP kernel (fused_fp.cu) and the standalone three_nn
// kernel (three_nn.cu), the way ball_query.cuh serves two kernels. The
// contract is geometry.three_nn_torch's (the plain twin of
// geometry._three_nn_jax): d2 = (|x1|^2 - 2 x1.x2) + |x2|^2 with the
// three-term dots of mm3d_dot3 and no FMA contraction, so every distance is
// bit-identical to the twin's; the three smallest in ascending order, ties to
// the lower index (lax.top_k's order); d2 is not clamped at 0.
//
// The selection is bound by instruction issue. A candidate costs the 8
// operations of its exact distance (the contract keeps them out of FMAs)
// and its offer to the running top-3; an insert is rare in a lane (about
// 3 (ln(M/G) - 1) times in M/G candidates) but, across 32 lanes, about
// every other step of a warp has one at M = 256, so a branch on it diverges
// at most steps. The design:
// - G lanes scan a dense point (the launcher's cuda_kernels.nn_lanes: the
//   fewest that give the grid a block a multiprocessor), each over its
//   share in ascending index, so there are few merge rounds;
// - a lane's first candidates go through the full (d, index) order until its
//   three slots hold real entries; from then on every candidate has a higher
//   index than every entry, so (d, j) is before (d_k, i_k) exactly when
//   d < d_k, and the steady state offers each candidate with three float
//   compares and predicated shifts of the list: no index compares and no
//   branch (about 22 instructions a candidate in all; the loop computes
//   eight distances before it offers the first);
// - where every coordinate of the block (its dense points and the cloud) is
//   0 or of magnitude in [2^-63, 2^62), the distance takes 7 operations:
//   with xn = -2 x stored once a point, dot3(xn, s) = -2 dot3(x, s)
//   exactly (no product subnormal, nothing overflows), so the doubling
//   goes; elsewhere the 8 of the twin's order;
// - the G partial lists merge by butterfly shuffles under the full order,
//   branch-free.
// The races that chose this (a branch on the insert, per lane or warp-
// uniform, on each candidate or a batch of four; a min/max network; two or
// four independent lists a lane; more warps) are in PERF.md.
#pragma once

#include <limits.h>

#include "common.cuh"

// candidates whose distances a lane computes before it offers the first
// (the offers then run in index order)
constexpr int kNnUnroll = 8;

struct Mm3dTop3 {
  float d0, d1, d2;
  int i0, i1, i2;
};

__device__ __forceinline__ void mm3d_top3_init(Mm3dTop3& t) {
  t.d0 = t.d1 = t.d2 = __int_as_float(0x7f800000);  // +inf
  t.i0 = t.i1 = t.i2 = INT_MAX;                     // empty slots sort last
}

// (da, ia) before (db, ib): smaller distance, or equal distance and lower
// index. A total order on distinct indices, so merging partial top-3 lists
// gives the top-3 of their union whatever the order of the merge.
__device__ __forceinline__ bool mm3d_nn_before(float da, int ia, float db,
                                               int ib) {
  return da < db || (da == db && ia < ib);
}

// Put (d, j) in front of the entries it goes before: c_k says it goes
// before entry k, and c0 implies c1 implies c2 (the list is sorted).
// Predicated shifts of the list, no branch: no lane of a warp waits for
// another's insert.
__device__ __forceinline__ void mm3d_top3_shift_in(Mm3dTop3& t, float d,
                                                   int j, bool c0, bool c1,
                                                   bool c2) {
  if (c2) {
    t.d2 = d;
    t.i2 = j;
  }
  if (c1) {
    t.d2 = t.d1;
    t.i2 = t.i1;
    t.d1 = d;
    t.i1 = j;
  }
  if (c0) {
    t.d1 = t.d0;
    t.i1 = t.i0;
    t.d0 = d;
    t.i0 = j;
  }
}

// Offer candidate (d, j) to the running top-3, under the full order.
__device__ __forceinline__ void mm3d_top3_push(Mm3dTop3& t, float d, int j) {
  mm3d_top3_shift_in(t, d, j, mm3d_nn_before(d, j, t.d0, t.i0),
                     mm3d_nn_before(d, j, t.d1, t.i1),
                     mm3d_nn_before(d, j, t.d2, t.i2));
}

// Offer (d, j) to a top-3 whose indices are all below j: the order is then
// d's alone (none of the tests passes when d >= d2 or d is NaN).
__device__ __forceinline__ void mm3d_top3_offer_later(Mm3dTop3& t, float d,
                                                      int j) {
  mm3d_top3_shift_in(t, d, j, d < t.d0, d < t.d1, d < t.d2);
}

// Squared distance of dense point (x, y, z), with x2 = |x|^2 precomputed by
// mm3d_dot3, to sparse point s = (sx, sy, sz, |s|^2): the rounding of
// square_distance(xyz1, xyz2) in geometry.py.
__device__ __forceinline__ float mm3d_nn_dist(float x, float y, float z,
                                              float x2, float4 s) {
  const float cross = mm3d_dot3(x, y, z, s.x, s.y, s.z);
  return __fadd_rn(__fsub_rn(x2, __fmul_rn(2.0f, cross)), s.w);
}

// The same distance in 7 operations, with xn = -2 x: dot3(xn, s) is
// -2 dot3(x, s) exactly when no product is subnormal and nothing overflows,
// so (x2 + dot3(xn, s)) rounds as (x2 - 2 cross) does. mm3d_nn_in_range
// says when that holds.
__device__ __forceinline__ float mm3d_nn_dist_neg2(float xn, float yn,
                                                   float zn, float x2,
                                                   float4 s) {
  return __fadd_rn(__fadd_rn(x2, mm3d_dot3(xn, yn, zn, s.x, s.y, s.z)), s.w);
}

// 0 or of magnitude in [2^-63, 2^62) (biased exponent 64 to 188): every
// product of two such is 0 or normal, and sums of three doubled products
// stay finite (inf and NaN are not in range).
__device__ __forceinline__ bool mm3d_nn_in_range(float v) {
  const unsigned u = __float_as_uint(v) & 0x7fffffffu;
  return u == 0u || u - 0x20000000u < 0x3e800000u;
}

// Stage cloud xb [M,3] into sparse[M] as (x, y, z, |s|^2): the nthreads
// threads of the block read the 3M floats in one coalesced pass, then
// |s|^2 is computed once a point. Returns, to every thread, whether every
// staged coordinate and every thread's dense point (x, y, z) are
// mm3d_nn_in_range. Two barriers of the whole block.
__device__ __forceinline__ bool mm3d_nn_stage(float4* __restrict__ sparse,
                                              const float* __restrict__ xb,
                                              int M, int nthreads, float x,
                                              float y, float z) {
  float* f = reinterpret_cast<float*>(sparse);
  bool ok = mm3d_nn_in_range(x) && mm3d_nn_in_range(y) && mm3d_nn_in_range(z);
  for (int w = threadIdx.x; w < 3 * M; w += nthreads) {
    const int j = w / 3;
    const float v = __ldg(xb + w);
    ok = ok && mm3d_nn_in_range(v);
    f[4 * j + (w - 3 * j)] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < M; j += nthreads) {
    const float4 s = sparse[j];
    f[4 * j + 3] = mm3d_dot3(s.x, s.y, s.z, s.x, s.y, s.z);
  }
  return __syncthreads_and(ok);
}

// Lane g of a group of G (g = lane & (G - 1)) scans sparse points g, g+G,
// ... of sparse[M] for dense point (x, y, z) and returns its partial top-3;
// kNeg2: the distances by mm3d_nn_dist_neg2. With SAMPLE_PHASE_CLOCKS,
// `steps` counts the candidates the lane visits and `ins` those at which
// some lane of the warp inserts.
template <int G, bool kNeg2>
__device__ __forceinline__ Mm3dTop3 mm3d_three_nn_scan_as(
    const float4* __restrict__ sparse, int M, float x, float y, float z,
    unsigned long long& steps, unsigned long long& ins) {
  const float x2 = mm3d_dot3(x, y, z, x, y, z);
  const float xn = __fmul_rn(-2.0f, x), yn = __fmul_rn(-2.0f, y),
              zn = __fmul_rn(-2.0f, z);
  auto dist = [&](float4 s) {
    return kNeg2 ? mm3d_nn_dist_neg2(xn, yn, zn, x2, s)
                 : mm3d_nn_dist(x, y, z, x2, s);
  };
  Mm3dTop3 t;
  mm3d_top3_init(t);
  int j = threadIdx.x & (G - 1);
  // the full order until the three slots are real (NaN distances never
  // enter, so this runs past the third candidate only with NaN points)
  for (; j < M && t.i2 == INT_MAX; j += G) {
    mm3d_top3_push(t, dist(sparse[j]), j);
#ifdef SAMPLE_PHASE_CLOCKS
    steps += 1;
    ins += 1;
#endif
  }
  // steady state: every later candidate has a higher index than the three
  // entries, so strict d < d_k is the full order's test
  for (; j + (kNnUnroll - 1) * G < M; j += kNnUnroll * G) {
    float d[kNnUnroll];
#pragma unroll
    for (int q = 0; q < kNnUnroll; ++q) d[q] = dist(sparse[j + q * G]);
#pragma unroll
    for (int q = 0; q < kNnUnroll; ++q) {
#ifdef SAMPLE_PHASE_CLOCKS
      steps += 1;
      ins += __any_sync(__activemask(), d[q] < t.d2);
#endif
      mm3d_top3_offer_later(t, d[q], j + q * G);
    }
  }
  for (; j < M; j += G) {
    const float d = dist(sparse[j]);
#ifdef SAMPLE_PHASE_CLOCKS
    steps += 1;
    ins += __any_sync(__activemask(), d < t.d2);
#endif
    mm3d_top3_offer_later(t, d, j);
  }
  return t;
}

// The scan with the 7-operation distance where the block's coordinates are
// in range (`in_range`, the same in every thread), else with the 8.
template <int G>
__device__ __forceinline__ Mm3dTop3 mm3d_three_nn_scan(
    const float4* __restrict__ sparse, int M, float x, float y, float z,
    bool in_range, unsigned long long& steps, unsigned long long& ins) {
  return in_range
             ? mm3d_three_nn_scan_as<G, true>(sparse, M, x, y, z, steps, ins)
             : mm3d_three_nn_scan_as<G, false>(sparse, M, x, y, z, steps,
                                               ins);
}

// The G partial lists of a group merge by butterfly shuffles under the full
// order; every lane of the group returns the same result. All 32 lanes of
// the warp must call it.
template <int G>
__device__ __forceinline__ Mm3dTop3 mm3d_three_nn_merge(Mm3dTop3 t) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float od0 = __shfl_xor_sync(0xffffffffu, t.d0, off);
    const float od1 = __shfl_xor_sync(0xffffffffu, t.d1, off);
    const float od2 = __shfl_xor_sync(0xffffffffu, t.d2, off);
    const int oi0 = __shfl_xor_sync(0xffffffffu, t.i0, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
    const int oi2 = __shfl_xor_sync(0xffffffffu, t.i2, off);
    mm3d_top3_push(t, od0, oi0);
    mm3d_top3_push(t, od1, oi1);
    mm3d_top3_push(t, od2, oi2);
  }
  return t;
}

// Launch a kernel template instance by the lanes a point, G in {1,2,4,8,16}:
// K<G>::launch(args...) of a functor template; -1 for another G.
template <template <int> class K, typename... A>
int mm3d_nn_by_lanes(int G, A... a) {
  switch (G) {
    case 1: return K<1>::launch(a...);
    case 2: return K<2>::launch(a...);
    case 4: return K<4>::launch(a...);
    case 8: return K<8>::launch(a...);
    case 16: return K<16>::launch(a...);
    default: return -1;
  }
}
