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
// lanes. Here G lanes of a warp scan a dense point (G = 1 at the training
// shapes' FP1), each keeping a running top-3 in registers over its share of
// the sparse points, and the G lists merge by butterfly shuffles.
//
// What bounds it on the H100: instruction issue. At the training shapes
// (B=24: FP1 N=2048 <- M=256, FP2 N=256 <- M=64) FP1 moves about 1.8 MB
// (0.5 us at 3.35 TB/s) and offers 12.6 M candidates; counted as 8 f32
// operations a candidate (7 for the distance, 1 compare), that is 1.5 us of
// the CUDA cores' published 67 TFLOP/s, a rate that counts an FMA as two
// operations. The bit-exact contract leaves no FMA to fuse, so the issue
// floor is about twice that bound (3.0 us) before the offer to the top-3:
// about 22 instructions a candidate in all, 8.3 us of the card's issue at
// FP1. Measured on an H100 80GB HBM3 at 700 W: 0.0134-0.0139 ms at FP1,
// 0.0028 at FP2. The design (three_nn.cuh):
// one lane a point where the grid still has a block a multiprocessor
// (cuda_kernels.nn_lanes: G = 1 at FP1, 4 at FP2), a branch-free offer, the
// 7-operation distance where the coordinates allow it, eight distances
// computed ahead; the block stages its cloud's sparse points in shared
// memory with coalesced loads (16 bytes a point: x, y, z, |s|^2), so the
// scan reads shared memory only. A block of 128 threads takes 128 / G
// dense points.
#include "sample_phases.cuh"
#include "three_nn.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSparse = 2048;  // 32 KB of float4 in shared memory

template <int G>
__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                float* __restrict__ dist, int* __restrict__ idx, int N,
                int M) {
  extern __shared__ __align__(16) float4 sparse[];  // [M]: x, y, z, |s|^2
  const int b = blockIdx.y;
  PH_START;
  PH_ADD(6, 1);
  // the lanes of a point past the end of the cloud select for its last
  // point and drop the result (every lane takes part in the shuffles)
  const int n = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const float* x1 = xyz1 + (static_cast<size_t>(b) * N + min(n, N - 1)) * 3;
  const float x = __ldg(x1), y = __ldg(x1 + 1), z = __ldg(x1 + 2);
  const bool in_range = mm3d_nn_stage(
      sparse, xyz2 + static_cast<size_t>(b) * M * 3, M, kThreads, x, y, z);
  PH_WAITF(x);
  PH_MARK(0);
  unsigned long long steps = 0, ins = 0;
  Mm3dTop3 t =
      mm3d_three_nn_scan<G>(sparse, M, x, y, z, in_range, steps, ins);
  PH_WAITF(t.d2);
  PH_MARK(1);
  t = mm3d_three_nn_merge<G>(t);
  PH_WAITF(t.d2);
  PH_MARK(2);
  PH_ADD(4, steps);
  PH_ADD(5, ins);
  if ((threadIdx.x & (G - 1)) == 0 && n < N) {
    const size_t o = (static_cast<size_t>(b) * N + n) * 3;
    dist[o] = t.d0;
    dist[o + 1] = t.d1;
    dist[o + 2] = t.d2;
    idx[o] = t.i0;
    idx[o + 1] = t.i1;
    idx[o + 2] = t.i2;
  }
  PH_MARK(3);
  PH_END;
}

template <int G>
struct Launch {
  static int launch(const void* xyz1, const void* xyz2, void* dist, void* idx,
                    int B, int N, int M, cudaStream_t stream) {
    const dim3 grid((N + kThreads / G - 1) / (kThreads / G), B);
    const size_t smem = static_cast<size_t>(M) * sizeof(float4);
    three_nn_kernel<G><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
        static_cast<float*>(dist), static_cast<int*>(idx), N, M);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int mm3d_three_nn_max_sparse() { return kMaxSparse; }

extern "C" int mm3d_three_nn_threads() { return kThreads; }

// lanes: lanes a dense point (1, 2, 4, 8 or 16), cuda_kernels.nn_lanes.
extern "C" int mm3d_three_nn(const void* xyz1, const void* xyz2, void* dist,
                             void* idx, int B, int N, int M, int lanes,
                             void* stream) {
  const int err = mm3d_nn_by_lanes<Launch>(
      lanes, xyz1, xyz2, dist, idx, B, N, M,
      static_cast<cudaStream_t>(stream));
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}
