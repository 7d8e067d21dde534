// Fused feature-propagation tail (eval): 3-NN selection, inverse-distance
// weights, interpolation of the sparse rows, the dense-side term and relu, in
// one kernel.
//
//   out[b,n] = relu(rnd(sum_k w_k * pre[b, idx_k]) + skip[b,n]),
//   idx      = the three nearest sparse points of xyz1[b,n] (three_nn.cuh),
//   r_k      = 1 / (d2_k + 1e-8),   w_k = rnd(r_k * (1 / (r_0 + r_1 + r_2)))
//
// where rnd() rounds to the feature dtype: in bf16 the weights are rounded to
// bf16, the three products (exact in f32) are summed in f32 and the sum is
// rounded to bf16 before the bf16 skip add; in f32 rnd() is the identity.
// These are the rounding points of the TPU kernel, and of the plain twin
// cuda_kernels.fused_fp_torch, which this kernel matches bit for bit: every
// product and sum is an explicitly rounded __fmul_rn / __fadd_rn in the
// twin's order, so nvcc contracts nothing into an FMA.
//
// Replaces the TPU kernel fused_fp_pallas / _fused_fp_kernel in
// mm3d_tpu/ops/pallas_kernels.py. That kernel builds one-hot [nt, M] weight
// rows with an extract-min on the VPU and multiplies them into pre on the
// MXU, because a TPU core has no fast row gather. Here a dense point's
// interpolation is three row gathers and three multiply-adds per channel.
//
// What bounds it on the H100: bytes. At the fusion_sem_seg serving shapes
// (B=16: FP1 N=2048, M=256, C=128; FP2 N=256, M=64, C=256) the skip read and
// the output write dominate (FP1 moves about 36 MB in f32, 18 MB in bf16:
// 10.8 / 5.5 us at 3.35 TB/s); the distance arithmetic is about 1 us of f32
// CUDA-core time. A block takes 64 dense points of one cloud: the cloud's
// sparse xyz (and |s|^2) go to shared memory, four lanes select each point's
// three neighbours, and then all 256 threads walk the 64 output rows with
// 16-byte loads, neighbouring threads on neighbouring channels, so the pre
// rows (read from L2) and the skip and output rows move in coalesced
// transactions. At these sizes the launch and the selection's dependent
// chain (M/4 steps per lane) are expected to dominate; tuning is later work.
#include "three_nn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;                  // lanes per dense point (selection)
constexpr int kTile = kThreads / kGroup;   // dense points per block
constexpr int kMaxSparse = 2048;           // 32 KB of float4 in shared memory

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
fused_fp_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                const T* __restrict__ pre, const T* __restrict__ skip,
                T* __restrict__ out, int N, int M, int C) {
  extern __shared__ float4 sparse[];  // [M]: x, y, z, |s|^2
  __shared__ int s_idx[kTile][3];
  __shared__ float s_w[kTile][3];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kTile;

  const float* xb = xyz2 + static_cast<size_t>(b) * M * 3;
  for (int j = threadIdx.x; j < M; j += kThreads) {
    const float sx = xb[3 * j], sy = xb[3 * j + 1], sz = xb[3 * j + 2];
    sparse[j] = make_float4(sx, sy, sz, mm3d_dot3(sx, sy, sz, sx, sy, sz));
  }
  __syncthreads();

  // selection: every lane takes part in the group's shuffles; the lanes of a
  // point past the end of the cloud select for its last point and drop it
  const int p = threadIdx.x / kGroup;
  const int n = n0 + p;
  const float* x1 = xyz1 + (static_cast<size_t>(b) * N + min(n, N - 1)) * 3;
  const Mm3dTop3 t =
      mm3d_three_nn_group<kGroup>(sparse, M, x1[0], x1[1], x1[2]);
  if ((threadIdx.x & (kGroup - 1)) == 0 && n < N) {
    const float r0 = __fdiv_rn(1.0f, __fadd_rn(t.d0, 1e-8f));
    const float r1 = __fdiv_rn(1.0f, __fadd_rn(t.d1, 1e-8f));
    const float r2 = __fdiv_rn(1.0f, __fadd_rn(t.d2, 1e-8f));
    const float inv = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(r0, r1), r2));
    s_idx[p][0] = t.i0;
    s_idx[p][1] = t.i1;
    s_idx[p][2] = t.i2;
    s_w[p][0] = rnd<T>(__fmul_rn(r0, inv));
    s_w[p][1] = rnd<T>(__fmul_rn(r1, inv));
    s_w[p][2] = rnd<T>(__fmul_rn(r2, inv));
  }
  __syncthreads();

  // interpolation + skip + relu over the tile's rows, V channels per thread
  const int rows = min(kTile, N - n0);
  const int CV = C / V;
  const T* pb = pre + static_cast<size_t>(b) * M * C;
  for (int e = threadIdx.x; e < rows * CV; e += kThreads) {
    const int q = e / CV;
    const int c = (e - q * CV) * V;
    const size_t row = static_cast<size_t>(b) * N + n0 + q;
    using P = Pack<T, V>;
    const P a0 = *reinterpret_cast<const P*>(pb + static_cast<size_t>(s_idx[q][0]) * C + c);
    const P a1 = *reinterpret_cast<const P*>(pb + static_cast<size_t>(s_idx[q][1]) * C + c);
    const P a2 = *reinterpret_cast<const P*>(pb + static_cast<size_t>(s_idx[q][2]) * C + c);
    const P sk = *reinterpret_cast<const P*>(skip + row * C + c);
    const float w0 = s_w[q][0], w1 = s_w[q][1], w2 = s_w[q][2];
    P o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float acc = __fadd_rn(
          __fadd_rn(__fmul_rn(w0, to_f(a0.v[v])), __fmul_rn(w1, to_f(a1.v[v]))),
          __fmul_rn(w2, to_f(a2.v[v])));
      const float y = __fadd_rn(rnd<T>(acc), to_f(sk.v[v]));
      const T yt = from_f<T>(y);
      o.v[v] = to_f(yt) < 0.0f ? from_f<T>(0.0f) : yt;  // relu, NaN kept
    }
    *reinterpret_cast<P*>(out + row * C + c) = o;
  }
}

template <typename T, int V>
int launch(const void* xyz1, const void* xyz2, const void* pre,
           const void* skip, void* out, int B, int N, int M, int C,
           cudaStream_t stream) {
  const dim3 grid((N + kTile - 1) / kTile, B);
  const size_t smem = static_cast<size_t>(M) * sizeof(float4);
  fused_fp_kernel<T, V><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
      static_cast<const T*>(pre), static_cast<const T*>(skip),
      static_cast<T*>(out), N, M, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mm3d_fused_fp_max_sparse() { return kMaxSparse; }

// vec: 1 when C is a multiple of 16 bytes' worth of channels and every
// feature pointer is 16-byte aligned (16-byte moves), else 0 (scalar moves).
extern "C" int mm3d_fused_fp(int is_bf16, int vec, const void* xyz1,
                             const void* xyz2, const void* pre,
                             const void* skip, void* out, int B, int N, int M,
                             int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, 8>(xyz1, xyz2, pre, skip, out, B, N, M,
                                          C, st)
               : launch<__nv_bfloat16, 1>(xyz1, xyz2, pre, skip, out, B, N, M,
                                          C, st);
  }
  return vec ? launch<float, 4>(xyz1, xyz2, pre, skip, out, B, N, M, C, st)
             : launch<float, 1>(xyz1, xyz2, pre, skip, out, B, N, M, C, st);
}
