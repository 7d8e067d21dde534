// Ball query: (radius, K, xyz [B,N,3] f32, new_xyz [B,S,3] f32) -> [B,S,K] int32.
//
// Replaces the TPU kernel ball_query_v2_pallas / _ball_query_v2_kernel in
// mm3d_tpu/ops/pallas_kernels.py (and ball_query_pallas, which has the same
// contract). The TPU kernel computes all S x N distances with one MXU matmul
// and ranks hits with a triangular matmul, because the TPU has no cheap
// per-lane compaction. On the H100 a warp ballot ranks 32 candidates in one
// instruction, so each warp walks its centroid's points in index order and
// stops as soon as it holds K hits.
//
// What bounds it on the H100: neither bytes (the points are read from L1/L2,
// the output is B*S*K*4 bytes) nor arithmetic, but the dependent chain of
// chunk steps a warp walks before it has K hits (all N/32 of them for a
// centroid with fewer than K hits). Eight centroids per block keep enough
// warps resident to hide the load latency of each step.
#include "ball_query.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int* __restrict__ out,
                  int B, int N, int S, int K, float r2) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(B) * S) return;  // whole warp leaves
  const long long b = w / S;
  const float* c = new_xyz + w * 3;
  mm3d_ball_query_warp(xyz + b * N * 3, N, c[0], c[1], c[2], r2, K,
                       out + w * K);
}

}  // namespace

extern "C" int mm3d_ball_query(const void* xyz, const void* new_xyz, void* out,
                               int B, int N, int S, int K, float r2,
                               void* stream) {
  const long long warps = static_cast<long long>(B) * S;
  const int blocks =
      static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  ball_query_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(new_xyz),
      static_cast<int*>(out), B, N, S, K, r2);
  return static_cast<int>(cudaGetLastError());
}
