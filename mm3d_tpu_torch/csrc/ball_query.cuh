// Ball-query selection for one centroid, run by one warp.
//
// Shared by the standalone ball-query kernel (ball_query.cu) and the fused SA
// kernel (fused_sa.cu), so the standalone kernel's bit-exact check against
// ball_query_torch also vouches for the fused kernel's neighbour selection.
#pragma once

#include "common.cuh"

// Writes out[0..K) for centroid (cx, cy, cz) over the N points xyz[N][3]:
// the first K point indices with d2 <= r2 in ascending index order, empty
// slots repeat the first hit, and a centroid with no hit gets all zeros
// (the contract of geometry._query_ball_jax). d2 = (|c|^2 - 2 c.p) + |p|^2
// with the three-term dots of mm3d_dot3, exactly as ball_query_torch rounds.
//
// The warp walks the points 32 at a time; __ballot_sync + __popc rank the
// hits of a chunk, and the walk stops once K hits are found. Returns the
// number of live hits, min(hits, K). Must be called by all 32 lanes.
__device__ __forceinline__ int mm3d_ball_query_warp(
    const float* __restrict__ xyz, int N, float cx, float cy, float cz,
    float r2, int K, int* out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float c2 = mm3d_dot3(cx, cy, cz, cx, cy, cz);
  int cnt = 0;
  for (int base = 0; base < N && cnt < K; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < N) {
      const float px = xyz[3 * j], py = xyz[3 * j + 1], pz = xyz[3 * j + 2];
      const float cross = mm3d_dot3(cx, cy, cz, px, py, pz);
      const float p2 = mm3d_dot3(px, py, pz, px, py, pz);
      const float d2 = __fadd_rn(__fsub_rn(c2, __fmul_rn(2.0f, cross)), p2);
      hit = d2 <= r2;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    const int rank = cnt + __popc(m & below);
    if (hit && rank < K) out[rank] = j;
    cnt += __popc(m);
  }
  cnt = min(cnt, K);
  __syncwarp();
  const int first = cnt > 0 ? out[0] : 0;
  for (int k = cnt + lane; k < K; k += 32) out[k] = first;
  __syncwarp();
  return cnt;
}
