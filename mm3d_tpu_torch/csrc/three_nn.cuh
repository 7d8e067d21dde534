// 3-nearest-neighbour selection of one dense point among M sparse points.
//
// Shared by the fused FP kernel (fused_fp.cu) and the standalone three_nn
// kernel (three_nn.cu), the way ball_query.cuh serves two kernels. The
// contract is geometry.three_nn_torch's (the plain twin of
// geometry._three_nn_jax): d2 = (|x1|^2 - 2 x1.x2) + |x2|^2 with the
// three-term dots of mm3d_dot3 and no FMA contraction, so every distance is
// bit-identical to the twin's; the three smallest in ascending order, ties to
// the lower index (lax.top_k's order); d2 is not clamped at 0.
#pragma once

#include <limits.h>

#include "common.cuh"

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

// Offer candidate (d, j) to the running top-3.
__device__ __forceinline__ void mm3d_top3_push(Mm3dTop3& t, float d, int j) {
  if (!mm3d_nn_before(d, j, t.d2, t.i2)) return;
  if (mm3d_nn_before(d, j, t.d1, t.i1)) {
    t.d2 = t.d1;
    t.i2 = t.i1;
    if (mm3d_nn_before(d, j, t.d0, t.i0)) {
      t.d1 = t.d0;
      t.i1 = t.i0;
      t.d0 = d;
      t.i0 = j;
    } else {
      t.d1 = d;
      t.i1 = j;
    }
  } else {
    t.d2 = d;
    t.i2 = j;
  }
}

// Squared distance of dense point (x, y, z), with x2 = |x|^2 precomputed by
// mm3d_dot3, to sparse point s = (sx, sy, sz, |s|^2): the rounding of
// square_distance(xyz1, xyz2) in geometry.py.
__device__ __forceinline__ float mm3d_nn_dist(float x, float y, float z,
                                              float x2, float4 s) {
  const float cross = mm3d_dot3(x, y, z, s.x, s.y, s.z);
  return __fadd_rn(__fsub_rn(x2, __fmul_rn(2.0f, cross)), s.w);
}

// Top-3 of one dense point, scanned by G consecutive lanes of a warp (G a
// power of two up to 32): lane g of the group walks sparse points g, g+G, ...
// of sparse[M] (x, y, z, |s|^2), then the G partial lists merge by
// butterfly shuffles. Every lane of the group returns the same result. All 32
// lanes of the warp must call it, with the same M.
template <int G>
__device__ __forceinline__ Mm3dTop3 mm3d_three_nn_group(
    const float4* __restrict__ sparse, int M, float x, float y, float z) {
  const int g = threadIdx.x & (G - 1);
  const float x2 = mm3d_dot3(x, y, z, x, y, z);
  Mm3dTop3 t;
  mm3d_top3_init(t);
  for (int j = g; j < M; j += G) {
    mm3d_top3_push(t, mm3d_nn_dist(x, y, z, x2, sparse[j]), j);
  }
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
