// Standalone 3-nearest-neighbour search: xyz1 [B,N,3] dense, xyz2 [B,M,3]
// sparse, f32, 3 <= M -> d2 [B,N,3] f32 ascending, idx [B,N,3] int32.
//
// The contract of geometry.three_nn_torch (the plain twin of
// geometry._three_nn_jax), bit for bit: d2 = (|x1|^2 - 2 x1.x2) + |x2|^2 with
// the three-term dots of mm3d_dot3 and no FMA contraction; the three smallest
// in ascending order, ties to the lower index (lax.top_k's order); d2 not
// clamped at 0. The selection is three_nn.cuh's, which the fused FP kernel
// (fused_fp.cu) runs too.
//
// Replaces the TPU kernel three_nn_pallas / _three_nn_kernel in
// mm3d_tpu/ops/pallas_kernels.py. That kernel computes a [nt, M] distance
// tile with one MXU product and extracts the minimum three times over the
// lanes. Here a dense point is scanned by four lanes of a warp, each keeping
// a running top-3 in registers over an interleaved quarter of the sparse
// points, and the four lists merge by butterfly shuffles.
//
// What bounds it on the H100: neither bytes nor operations, at the training
// shapes (B=24: FP1 N=2048 <- M=256, FP2 N=256 <- M=64). FP1 moves about
// 1.8 MB (0.5 us at 3.35 TB/s) and computes 12.6 M distances of ~8 f32
// operations (1.5 us of the CUDA cores' 67 TFLOP/s); each lane's scan is a
// dependent chain of M/4 compare-and-insert steps, and the launch itself is a
// few us. A block takes 64 dense points of one cloud and stages the cloud's
// sparse xyz and |s|^2 in shared memory (16 bytes per point), so the scan
// reads shared memory only.
#include "three_nn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;                  // lanes per dense point
constexpr int kTile = kThreads / kGroup;   // dense points per block
constexpr int kMaxSparse = 2048;           // 32 KB of float4 in shared memory

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                float* __restrict__ dist, int* __restrict__ idx, int N,
                int M) {
  extern __shared__ float4 sparse[];  // [M]: x, y, z, |s|^2
  const int b = blockIdx.y;
  const float* xb = xyz2 + static_cast<size_t>(b) * M * 3;
  for (int j = threadIdx.x; j < M; j += kThreads) {
    const float sx = xb[3 * j], sy = xb[3 * j + 1], sz = xb[3 * j + 2];
    sparse[j] = make_float4(sx, sy, sz, mm3d_dot3(sx, sy, sz, sx, sy, sz));
  }
  __syncthreads();

  // every lane takes part in the group's shuffles; the lanes of a point past
  // the end of the cloud select for its last point and drop the result
  const int n = blockIdx.x * kTile + threadIdx.x / kGroup;
  const float* x1 = xyz1 + (static_cast<size_t>(b) * N + min(n, N - 1)) * 3;
  const Mm3dTop3 t =
      mm3d_three_nn_group<kGroup>(sparse, M, x1[0], x1[1], x1[2]);
  if ((threadIdx.x & (kGroup - 1)) == 0 && n < N) {
    const size_t o = (static_cast<size_t>(b) * N + n) * 3;
    dist[o] = t.d0;
    dist[o + 1] = t.d1;
    dist[o + 2] = t.d2;
    idx[o] = t.i0;
    idx[o + 1] = t.i1;
    idx[o + 2] = t.i2;
  }
}

}  // namespace

extern "C" int mm3d_three_nn_max_sparse() { return kMaxSparse; }

extern "C" int mm3d_three_nn(const void* xyz1, const void* xyz2, void* dist,
                             void* idx, int B, int N, int M, void* stream) {
  const dim3 grid((N + kTile - 1) / kTile, B);
  const size_t smem = static_cast<size_t>(M) * sizeof(float4);
  three_nn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<float*>(dist), static_cast<int*>(idx), N, M);
  return static_cast<int>(cudaGetLastError());
}
