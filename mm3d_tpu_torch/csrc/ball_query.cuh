// Ball-query selection for one centroid, run by one warp.
//
// Shared by the standalone ball-query kernel (ball_query.cu) and the fused SA
// kernel (fused_sa.cu), so the standalone kernel's bit-exact check against
// ball_query_torch also vouches for the fused kernel's neighbour selection.
#pragma once

#include "common.cuh"

// The cloud as the selection reads it: point j's coordinates and |p|^2.
// BqCloud3: xyz[N][3], |p|^2 computed on every visit (mm3d_dot3).
struct BqCloud3 {
  static constexpr bool kPadded = false;
  const float* __restrict__ xyz;
  __device__ __forceinline__ float4 operator()(int j) const {
    const float x = xyz[3 * j], y = xyz[3 * j + 1], z = xyz[3 * j + 2];
    return make_float4(x, y, z, mm3d_dot3(x, y, z, x, y, z));
  }
};
// BqCloud4: (x, y, z, |p|^2) a point, |p|^2 computed once by the caller with
// mm3d_dot3; one 16-byte load a visit. kPadded: the caller pads the cloud to
// a whole round (32*U points) with NaN points, so the walk reads past N
// without a bounds test.
struct BqCloud4 {
  static constexpr bool kPadded = true;
  const float4* __restrict__ pts;
  __device__ __forceinline__ float4 operator()(int j) const { return pts[j]; }
};

// A point that no centroid hits: its distances are NaN, and NaN <= r2 is
// false.
__device__ __forceinline__ float4 mm3d_bq_nan_point() {
  return make_float4(__int_as_float(0x7fc00000), 0.f, 0.f, 0.f);
}

// The walk of one warp for centroid (cx, cy, cz) over the N points of the
// cloud: out[0..cnt) gets the first cnt = min(hits, K) point indices with
// d2 <= r2, in ascending index order; slots past cnt are left as they are.
// d2 = (|c|^2 - 2 c.p) + |p|^2 with the three-term dots of mm3d_dot3,
// exactly as ball_query_torch rounds. Returns cnt.
//
// The warp walks the points 32*U at a time, U a lane: the U loads and
// distance chains are in flight together, __ballot_sync + __popc rank a
// group's hits in index order (a group with no hit skips the ranking), and
// the walk stops after the round that brings the K-th hit (the test runs
// once a round). Must be called by all 32 lanes.
template <int U, typename Cloud>
__device__ __forceinline__ int mm3d_ball_query_walk(Cloud cloud, int N,
                                                    float cx, float cy,
                                                    float cz, float r2, int K,
                                                    int* out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float c2 = mm3d_dot3(cx, cy, cz, cx, cy, cz);
  int cnt = 0;
  for (int base = 0; base < N && cnt < K; base += 32 * U) {
    bool hit[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + 32 * u + lane;
      const float4 p =
          Cloud::kPadded || j < N ? cloud(j) : mm3d_bq_nan_point();
      const float cross = mm3d_dot3(cx, cy, cz, p.x, p.y, p.z);
      hit[u] = __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, cross)), p.w) <= r2;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned m = __ballot_sync(0xffffffffu, hit[u]);
      if (m) {
        const int rank = cnt + __popc(m & below);
        if (hit[u] && rank < K) out[rank] = base + 32 * u + lane;
        cnt += __popc(m);
      }
    }
  }
  return min(cnt, K);
}

// Writes out[0..K) for centroid (cx, cy, cz): the walk's row with the empty
// slots repeating the first hit, and all zeros for a centroid with no hit
// (the contract of geometry._query_ball_jax). Returns min(hits, K). Must be
// called by all 32 lanes.
template <int U, typename Cloud>
__device__ __forceinline__ int mm3d_ball_query_warp(Cloud cloud, int N,
                                                    float cx, float cy,
                                                    float cz, float r2, int K,
                                                    int* out) {
  const int cnt = mm3d_ball_query_walk<U>(cloud, N, cx, cy, cz, r2, K, out);
  __syncwarp();
  const int first = cnt > 0 ? out[0] : 0;
  for (int k = cnt + (threadIdx.x & 31); k < K; k += 32) out[k] = first;
  __syncwarp();
  return cnt;
}
