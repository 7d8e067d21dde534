// Inverse-distance interpolation of sparse features at dense points:
// points [B,M,C] (f32 or bf16), idx [B,N,3] int32, w [B,N,3] (f32 or bf16)
// -> out [B,N,C] in points' dtype,
//
//   out[b,n,c] = rnd((w0 * p0 + w1 * p1) + w2 * p2),   p_k = points[b, idx_k, c]
//
// where w_k is the weight rounded to the points' dtype (rounded here, in
// registers: the wrapper passes the weights as the caller gave them) and
// rnd() rounds the f32 sum to the points' dtype: in bf16 the products of
// bf16 weights and bf16 rows are exact in f32, summed in f32 and rounded
// once (the TPU kernel's rounding); in f32 rnd() is the identity. Every
// product and sum is an explicitly rounded __fmul_rn / __fadd_rn in this
// order, so nvcc contracts nothing into an FMA and the result matches the
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
// What bounds it on the H100. At fusion_sem_seg's FP1 training shape
// (B=24, N=2048, M=256, C=128) it writes 25.2 MB (f32; 12.6 MB bf16) and
// reads 3.1 MB of sparse rows (1.6 MB) and 1.2 MB of indices and weights
// (0.9 MB with bf16 weights): 8.8 us at 3.35 TB/s (4.5 us bf16). The first
// design, one thread a 16-byte pack, did not reach that: it issued 212 SASS
// instructions a thread in bf16 (152 in f32) for 16 bytes, about 48 of them
// two 64-bit divisions to find its point, the point's index, weight and
// address work repeated on every lane; and its wrapper rounded the weights
// in a second launch, 2.3 us of device time a bf16 call. Here the grid is
// 2-D (tiles of points in x, the cloud in y): every offset inside a cloud
// is 32-bit and a thread finds its point and lane by shift and mask (a
// point takes a power of two of lanes); a lane writes kPacks 16-byte packs
// of its point (channels lane*V + q*C/kPacks, so a store of the point's
// lanes stays contiguous), which spreads the point's loads over kPacks
// packs; and the weights are read at the caller's dtype and rounded in
// registers, one launch a call. That is 131 instructions for 16 bytes in
// bf16 and 45 in f32. The kernel holds at most 64 registers a thread
// (kMinBlocks): left free, nvcc took up to 70 and the card held three
// blocks a multiprocessor, too few loads in flight. At FP1 it then runs at
// about 1.1x its byte bound in f32 and 1.35x in bf16, where a kernel that
// only stores the output already takes 0.8x and 0.9x. A grid of only the
// blocks the card holds at once, each walking tiles; 1024-thread blocks;
// the tile's indices and weights staged in shared memory; and FMAs on
// exact bf16 products were raced and lost (PERF.md).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// 16-byte packs of one point a thread writes: f32 4, bf16 2, the faster of
// 1, 2 and 4 at the path shapes
template <typename T>
constexpr int kPacks = std::is_same_v<T, float> ? 4 : 2;
constexpr int kMinBlocks = 4;  // tile kernel: blocks of kThreads a
                               // multiprocessor holds (<= 64 registers)
constexpr int kMaxBatch = 65535;  // clouds on the grid's y axis

// The weight as the twin uses it: rounded to the points' dtype, in f32.
template <typename T, typename WT>
__device__ __forceinline__ float weight_of(WT w) {
  if constexpr (std::is_same_v<T, float> || std::is_same_v<WT, T>) {
    return to_f(w);
  } else {
    return rnd<T>(to_f(w));
  }
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> interp(const Pack<T, V> (&a)[3],
                                             const float (&w)[3]) {
  Pack<T, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float acc = __fadd_rn(
        __fadd_rn(__fmul_rn(w[0], to_f(a[0].v[v])),
                  __fmul_rn(w[1], to_f(a[1].v[v]))),
        __fmul_rn(w[2], to_f(a[2].v[v])));
    o.v[v] = from_f<T>(acc);
  }
  return o;
}

// 16-byte packs, 2^lanes_log2 lanes a point, kPacks packs a lane: block
// (x, b) takes points x * (kThreads >> lanes_log2) ... of cloud b.
template <typename T, typename WT, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
three_interp_kernel(const T* __restrict__ points, const int* __restrict__ idx,
                    const WT* __restrict__ w, T* __restrict__ out, int N,
                    int M, int C, int lanes_log2) {
  using P = Pack<T, V>;
  const int n = blockIdx.x * (kThreads >> lanes_log2) +
                (threadIdx.x >> lanes_log2);
  if (n >= N) return;
  const int lane = threadIdx.x & ((1 << lanes_log2) - 1);
  const int step = V << lanes_log2;  // channels from one pack to the next
  const long long pt = static_cast<long long>(blockIdx.y) * N + n;
  const T* pb =
      points + static_cast<long long>(blockIdx.y) * M * C + lane * V;
  int row[3];
  float wt[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    row[k] = idx[3 * pt + k] * C;
    wt[k] = weight_of<T>(w[3 * pt + k]);
  }
  P a[kPacks<T>][3];
#pragma unroll
  for (int q = 0; q < kPacks<T>; ++q) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[q][k] = *reinterpret_cast<const P*>(pb + row[k] + q * step);
    }
  }
  T* o = out + pt * C + lane * V;
#pragma unroll
  for (int q = 0; q < kPacks<T>; ++q) {
    *reinterpret_cast<P*>(o + q * step) = interp<T, V>(a[q], wt);
  }
}

// Any C: V channels a thread (V = 1, the scalar moves, or a 16-byte pack
// when the packs of a point are not kPacks times a power of two), the pack
// found by a 32-bit division inside the cloud.
template <typename T, typename WT, int V>
__global__ void __launch_bounds__(kThreads)
three_interp_any(const T* __restrict__ points, const int* __restrict__ idx,
                 const WT* __restrict__ w, T* __restrict__ out, int N, int M,
                 int C) {
  using P = Pack<T, V>;
  const int b = blockIdx.y;
  const int Q = C / V;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= N * Q) return;
  const int n = e / Q;
  const int c = (e - n * Q) * V;
  const long long pt = static_cast<long long>(b) * N + n;
  const T* pb = points + static_cast<long long>(b) * M * C + c;
  P a[3];
  float wt[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = *reinterpret_cast<const P*>(pb + idx[3 * pt + k] * C);
    wt[k] = weight_of<T>(w[3 * pt + k]);
  }
  *reinterpret_cast<P*>(out + pt * C + c) = interp<T, V>(a, wt);
}

template <typename T, typename WT>
int launch(int vec, const void* points_, const void* idx_, const void* w_,
           void* out_, int B, int N, int M, int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* points = static_cast<const T*>(points_);
  const int* idx = static_cast<const int*>(idx_);
  const WT* w = static_cast<const WT*>(w_);
  T* out = static_cast<T*>(out_);
  const int lanes = vec ? C / V / kPacks<T> : 0;
  if (vec && C / V % kPacks<T> == 0 && lanes > 0 && lanes <= kThreads &&
      (lanes & (lanes - 1)) == 0) {
    int lg = 0;
    while ((1 << lg) < lanes) ++lg;
    const int rows = kThreads >> lg;
    const dim3 grid((N + rows - 1) / rows, B);
    three_interp_kernel<T, WT, V><<<grid, kThreads, 0, stream>>>(
        points, idx, w, out, N, M, C, lg);
  } else if (vec) {
    const dim3 grid((N * (C / V) + kThreads - 1) / kThreads, B);
    three_interp_any<T, WT, V><<<grid, kThreads, 0, stream>>>(
        points, idx, w, out, N, M, C);
  } else {
    const dim3 grid((N * C + kThreads - 1) / kThreads, B);
    three_interp_any<T, WT, 1><<<grid, kThreads, 0, stream>>>(
        points, idx, w, out, N, M, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16: the points' (and output's) dtype; w_bf16: the weights'. vec: 1
// when C is a multiple of 16 bytes' worth of channels and both feature
// pointers are 16-byte aligned (16-byte moves), else 0 (scalar moves). The
// caller keeps B <= mm3d_three_interp_max_batch(), M*C and N*C below 2^31.
extern "C" int mm3d_three_interp(int is_bf16, int w_bf16, int vec,
                                 const void* points, const void* idx,
                                 const void* w, void* out, int B, int N,
                                 int M, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                        vec, points, idx, w, out, B, N, M, C, st)
                  : launch<__nv_bfloat16, float>(vec, points, idx, w, out, B,
                                                 N, M, C, st);
  }
  return w_bf16 ? launch<float, __nv_bfloat16>(vec, points, idx, w, out, B,
                                               N, M, C, st)
                : launch<float, float>(vec, points, idx, w, out, B, N, M, C,
                                       st);
}

extern "C" int mm3d_three_interp_max_batch() { return kMaxBatch; }
