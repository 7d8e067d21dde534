// Inverse-distance interpolation of sparse features at dense points:
// points [B,M,C] (f32 or bf16), idx [B,N,3] int32, w [B,N,3] f32 ->
// out [B,N,C] in points' dtype,
//
//   out[b,n,c] = rnd((w0 * p0 + w1 * p1) + w2 * p2),   p_k = points[b, idx_k, c]
//
// where the weights arrive already rounded to the points' dtype (the wrapper
// rounds them) and rnd() rounds the f32 sum to the points' dtype: in bf16 the
// products of bf16 weights and bf16 rows are exact in f32, summed in f32 and
// rounded once (the TPU kernel's rounding); in f32 rnd() is the identity.
// Every product and sum is an explicitly rounded __fmul_rn / __fadd_rn in
// this order, so nvcc contracts nothing into an FMA and the result matches the
// plain twin geometry.three_interpolate_torch bit for bit.
//
// Replaces the TPU kernel three_interpolate_pallas_raw / _three_interp_kernel
// in mm3d_tpu/ops/pallas_kernels.py. That kernel writes each dense point's
// three weights into a one-hot [nt, M] row and multiplies the rows into the
// sparse features on the MXU (in f32 with a 3-term bf16 split of both
// operands), because a TPU core has no fast row gather; both are TPU layout
// tricks. Here a dense point is three row gathers and three multiply-adds per
// channel. Its backward is not a kernel of its own: d_points is the
// gather-backward kernel (gather_bwd.cu), see geometry._ThreeInterpolate.
//
// What bounds it on the H100: bytes. At fusion_sem_seg's FP1 training shape
// (B=24, N=2048, M=256, C=128, f32) it writes 25.2 MB and reads 3.1 MB of
// sparse rows and 1.2 MB of indices and weights: 8.8 us at 3.35 TB/s. One
// thread handles 16 bytes of one point's channels, so neighbouring threads
// read neighbouring channels of the same three sparse rows (which stay in
// L2) and write neighbouring output bytes; the output write is the stream
// that counts.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
three_interp_kernel(const T* __restrict__ points, const int* __restrict__ idx,
                    const float* __restrict__ w, T* __restrict__ out, int N,
                    int M, int C, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int CV = C / V;
  const long long pt = e / CV;  // b * N + n
  const int c = static_cast<int>(e - pt * CV) * V;
  const long long b = pt / N;
  const T* pb = points + b * M * static_cast<long long>(C) + c;
  using P = Pack<T, V>;
  const P a0 = *reinterpret_cast<const P*>(pb + static_cast<long long>(idx[3 * pt]) * C);
  const P a1 = *reinterpret_cast<const P*>(pb + static_cast<long long>(idx[3 * pt + 1]) * C);
  const P a2 = *reinterpret_cast<const P*>(pb + static_cast<long long>(idx[3 * pt + 2]) * C);
  const float w0 = w[3 * pt], w1 = w[3 * pt + 1], w2 = w[3 * pt + 2];
  P o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float acc = __fadd_rn(
        __fadd_rn(__fmul_rn(w0, to_f(a0.v[v])), __fmul_rn(w1, to_f(a1.v[v]))),
        __fmul_rn(w2, to_f(a2.v[v])));
    o.v[v] = from_f<T>(acc);
  }
  *reinterpret_cast<P*>(out + pt * C + c) = o;
}

template <typename T, int V>
int launch(const void* points, const void* idx, const void* w, void* out,
           int B, int N, int M, int C, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * N * (C / V);
  const long long blocks = (total + kThreads - 1) / kThreads;
  three_interp_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
      static_cast<const T*>(points), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), N, M, C, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when C is a multiple of 16 bytes' worth of channels and both feature
// pointers are 16-byte aligned (16-byte moves), else 0 (scalar moves).
extern "C" int mm3d_three_interp(int is_bf16, int vec, const void* points,
                                 const void* idx, const void* w, void* out,
                                 int B, int N, int M, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, 8>(points, idx, w, out, B, N, M, C, st)
               : launch<__nv_bfloat16, 1>(points, idx, w, out, B, N, M, C, st);
  }
  return vec ? launch<float, 4>(points, idx, w, out, B, N, M, C, st)
             : launch<float, 1>(points, idx, w, out, B, N, M, C, st);
}
