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
// What bounds it on the H100: bytes by the count (at the fusion_sem_seg
// serving shapes, B=16: FP1 N=2048, M=256, C=128 moves about 36 MB in f32,
// 18 MB in bf16, 10.8 / 5.5 us at 3.35 TB/s; FP2 N=256, M=64, C=256), but
// the selection's issue (three_nn.cuh: 8.4 M candidates at FP1, about 22
// instructions each, 5.5 us of the card's issue) is of the same size, and
// a block that selects and then streams leaves the memory idle while it
// selects. A block of 256 threads takes a tile of 256 / G dense points of
// one cloud (G lanes a point, the launcher's cuda_kernels.fp_plan: the
// fewest that give the grid a block a multiprocessor, G = 2 at FP1, 16 at
// FP2) and:
// - stages the cloud's sparse points with coalesced loads, then starts
//   copies of the tile's skip rows (contiguous in skip) and, where they fit
//   beside it (bf16 FP1, both FP2s), of the cloud's pre rows into shared
//   memory by cp.async, 16 bytes a thread, which run while it selects;
// - selects each point's three neighbours (three_nn.cuh), lane 0 of a group
//   writing the indices and weights to shared memory;
// - then walks the tile's rows with 16-byte moves, neighbouring threads on
//   neighbouring channels, two (bf16) or four (f32) steps a thread in
//   flight: the skip from shared memory, the pre rows from shared memory or
//   L2, the output to device memory; a thread's (row, channel) steps by
//   additions, no divide an element; bf16 rounds two channels a conversion.
// Measured on an H100 80GB HBM3 at 700 W: FP1 0.0146 ms bf16, 0.0161 f32,
// FP2 0.0050 / 0.0054; the selection is 59-65 % of a warp's cycles at FP1.
// Where C is not a multiple of 16 bytes' worth of channels or a pointer is
// not 16-byte aligned, the scalar path reads skip and pre from device
// memory element by element in the same order.
#include "sample_phases.cuh"
#include "three_nn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSparse = 2048;  // 32 KB of float4 in shared memory

struct alignas(16) FpNeighbours {
  int4 idx;   // i0, i1, i2, -
  float4 w;   // w0, w1, w2, -
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A copy into shared memory that completes while the block selects: 16
// bytes a thread.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// o = relu(rnd(rnd(acc) + skip)), NaN kept, channel by channel; in bf16 with
// an even V two channels a conversion (cvt.rn.bf16x2.f32, the same
// rounding as two cvt.rn.bf16.f32).
template <typename T, int V>
__device__ __forceinline__ void fp_epilogue(const float (&acc)[V],
                                            const Pack<T, V>& sk,
                                            Pack<T, V>& o) {
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      const float2 r = __bfloat1622float2(
          __float22bfloat162_rn(make_float2(acc[v], acc[v + 1])));
      const __nv_bfloat162 y = __float22bfloat162_rn(
          make_float2(__fadd_rn(r.x, to_f(sk.v[v])),
                      __fadd_rn(r.y, to_f(sk.v[v + 1]))));
      const float2 yf = __bfloat1622float2(y);
      o.v[v] = yf.x < 0.0f ? from_f<T>(0.0f) : y.x;
      o.v[v + 1] = yf.y < 0.0f ? from_f<T>(0.0f) : y.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const T yt = from_f<T>(__fadd_rn(rnd<T>(acc[v]), to_f(sk.v[v])));
      o.v[v] = to_f(yt) < 0.0f ? from_f<T>(0.0f) : yt;
    }
  }
}

// V channels a thread-step (16 bytes when V > 1, the skip tile staged in
// shared memory); G lanes a dense point; kPre: the cloud's pre rows staged
// in shared memory too.
template <typename T, int V, int G, bool kPre>
__global__ void __launch_bounds__(kThreads)
fused_fp_kernel(const float* __restrict__ xyz1, const float* __restrict__ xyz2,
                const T* __restrict__ pre, const T* __restrict__ skip,
                T* __restrict__ out, int N, int M, int C) {
  constexpr int kRows = kThreads / G;  // dense points a tile
  constexpr bool kStage = V > 1;
  // stream steps a thread has in flight (the bf16 steps take more registers)
  constexpr int kU = sizeof(T) == 2 ? 2 : 4;
  // [M] sparse float4, then (kStage) the skip tile [kRows, C], then (kPre)
  // the cloud's pre [M, C]
  extern __shared__ __align__(16) float4 sparse[];
  __shared__ FpNeighbours s_nn[kRows];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - n0);
  const size_t row0 = static_cast<size_t>(b) * N + n0;
  T* s_skip = reinterpret_cast<T*>(sparse + M);
  T* s_pre = s_skip + kRows * C;
  PH_START;
  PH_ADD(6, 1);

  // selection: every lane takes part in the group's shuffles; the lanes of a
  // point past the end of the cloud select for its last point and drop it
  const int p = threadIdx.x / G;
  const float* x1 = xyz1 + (row0 + min(p, rows - 1)) * 3;
  const float x = __ldg(x1), y = __ldg(x1 + 1), z = __ldg(x1 + 2);
  const bool in_range = mm3d_nn_stage(
      sparse, xyz2 + static_cast<size_t>(b) * M * 3, M, kThreads, x, y, z);
  // the copies of the skip tile (and of pre) run during the selection
  // (started after the staging, whose loads they would otherwise delay)
  if (kStage) {
    const unsigned bytes = rows * C * static_cast<unsigned>(sizeof(T));
    const unsigned pbytes = kPre ? M * C * static_cast<unsigned>(sizeof(T))
                                 : 0u;
    const char* src = reinterpret_cast<const char*>(skip + row0 * C);
    char* dst = reinterpret_cast<char*>(s_skip);
    for (unsigned o = 16 * threadIdx.x; o < bytes; o += 16 * kThreads)
      cp_async16(dst + o, src + o);
    src = reinterpret_cast<const char*>(pre + static_cast<size_t>(b) * M * C);
    dst = reinterpret_cast<char*>(s_pre);
    for (unsigned o = 16 * threadIdx.x; o < pbytes; o += 16 * kThreads)
      cp_async16(dst + o, src + o);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  PH_WAITF(x);
  PH_MARK(0);
  unsigned long long steps = 0, ins = 0;
  Mm3dTop3 t =
      mm3d_three_nn_scan<G>(sparse, M, x, y, z, in_range, steps, ins);
  t = mm3d_three_nn_merge<G>(t);
  PH_WAITF(t.d2);
  PH_MARK(1);
  PH_ADD(4, steps);
  PH_ADD(5, ins);
  if ((threadIdx.x & (G - 1)) == 0 && p < rows) {
    const float r0 = __fdiv_rn(1.0f, __fadd_rn(t.d0, 1e-8f));
    const float r1 = __fdiv_rn(1.0f, __fadd_rn(t.d1, 1e-8f));
    const float r2 = __fdiv_rn(1.0f, __fadd_rn(t.d2, 1e-8f));
    const float inv = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(r0, r1), r2));
    s_nn[p].idx = make_int4(t.i0, t.i1, t.i2, 0);
    s_nn[p].w = make_float4(rnd<T>(__fmul_rn(r0, inv)),
                            rnd<T>(__fmul_rn(r1, inv)),
                            rnd<T>(__fmul_rn(r2, inv)), 0.0f);
  }
  if (kStage) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  PH_MARK(2);

  // interpolation + skip + relu over the tile's rows, V channels a step;
  // thread i takes steps i, i + kThreads, ... of the rows x CV grid, kU at a
  // time: their loads all issue before the first is used
  const int CV = C / V;
  const int dq = kThreads / CV, dc = kThreads % CV;
  int q = threadIdx.x / CV, c = threadIdx.x % CV;
  const T* pb = kPre ? s_pre : pre + static_cast<size_t>(b) * M * C;
  using P = Pack<T, V>;
  while (q < rows) {
    int qs[kU], chs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      qs[u] = q;
      chs[u] = c * V;
      q += dq;
      c += dc;
      if (c >= CV) {
        c -= CV;
        ++q;
      }
    }
    P a0[kU], a1[kU], a2[kU], sk[kU];
    float4 w[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (qs[u] >= rows) break;
      const int4 id = s_nn[qs[u]].idx;
      w[u] = s_nn[qs[u]].w;
      const T* col = pb + chs[u];
      a0[u] = *reinterpret_cast<const P*>(col + static_cast<size_t>(id.x) * C);
      a1[u] = *reinterpret_cast<const P*>(col + static_cast<size_t>(id.y) * C);
      a2[u] = *reinterpret_cast<const P*>(col + static_cast<size_t>(id.z) * C);
      sk[u] = kStage
          ? *reinterpret_cast<const P*>(s_skip + qs[u] * C + chs[u])
          : *reinterpret_cast<const P*>(skip + (row0 + qs[u]) * C + chs[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (qs[u] >= rows) break;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] = __fadd_rn(
            __fadd_rn(__fmul_rn(w[u].x, to_f(a0[u].v[v])),
                      __fmul_rn(w[u].y, to_f(a1[u].v[v]))),
            __fmul_rn(w[u].z, to_f(a2[u].v[v])));
      P o;
      fp_epilogue<T, V>(acc, sk[u], o);
      *reinterpret_cast<P*>(out + (row0 + qs[u]) * C + chs[u]) = o;
    }
  }
  PH_MARK(3);
  PH_END;
}

// the dynamic shared memory of a block (the layout in fused_fp_kernel)
template <typename T, int V, bool kPre>
size_t smem_bytes(int G, int M, int C) {
  size_t smem = static_cast<size_t>(M) * sizeof(float4);
  if (V > 1) smem += static_cast<size_t>(kThreads / G) * C * sizeof(T);
  if (kPre) smem += static_cast<size_t>(M) * C * sizeof(T);
  return smem;
}

template <typename T, int V, bool kPre>
struct ByLanes {
  template <int G>
  struct Launch {
    static int launch(const void* xyz1, const void* xyz2, const void* pre,
                      const void* skip, void* out, int B, int N, int M, int C,
                      size_t smem, cudaStream_t stream) {
      constexpr int kRows = kThreads / G;
      auto kernel = fused_fp_kernel<T, V, G, kPre>;
      // the default limit (48 KB) counts the static s_nn too: ask for
      // every size past the largest asked for before on this device
      static size_t granted = 0;
      static int granted_dev = -1;
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev != granted_dev || smem > granted) {
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        granted = smem;
        granted_dev = dev;
      }
      const dim3 grid((N + kRows - 1) / kRows, B);
      kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const float*>(xyz1), static_cast<const float*>(xyz2),
          static_cast<const T*>(pre), static_cast<const T*>(skip),
          static_cast<T*>(out), N, M, C);
      return static_cast<int>(cudaGetLastError());
    }
  };
};

// smem: the bytes the caller's plan (cuda_kernels.fp_plan) counted; a
// launch whose layout differs is refused
template <typename T, int V, bool kPre = false>
int launch(int lanes, const void* xyz1, const void* xyz2, const void* pre,
           const void* skip, void* out, int B, int N, int M, int C,
           size_t smem, cudaStream_t stream) {
  if (lanes < 1 || kThreads % lanes != 0 ||
      smem != smem_bytes<T, V, kPre>(lanes, M, C))
    return static_cast<int>(cudaErrorInvalidValue);
  using L = ByLanes<T, V, kPre>;
  const int err = mm3d_nn_by_lanes<L::template Launch>(
      lanes, xyz1, xyz2, pre, skip, out, B, N, M, C, smem, stream);
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

template <typename T, int V>
int launch_mode(int mode, int lanes, const void* xyz1, const void* xyz2,
                const void* pre, const void* skip, void* out, int B, int N,
                int M, int C, size_t smem, cudaStream_t stream) {
  const auto args = [&](auto f) {
    return f(lanes, xyz1, xyz2, pre, skip, out, B, N, M, C, smem, stream);
  };
  switch (mode) {
    case 0: return args(launch<T, 1>);
    case 1: return args(launch<T, V>);
    case 2: return args(launch<T, V, true>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mm3d_fused_fp_max_sparse() { return kMaxSparse; }

extern "C" int mm3d_fused_fp_threads() { return kThreads; }

// mode: 0, scalar moves; 1, 16-byte moves with the skip tile staged in
// shared memory (C a multiple of 16 bytes' worth of channels, every feature
// pointer 16-byte aligned); 2, as 1 with the cloud's pre rows staged too.
// lanes: lanes a dense point (1, 2, 4, 8 or 16); smem: the block's dynamic
// shared-memory bytes. All three from cuda_kernels.fp_plan.
extern "C" int mm3d_fused_fp(int is_bf16, int mode, const void* xyz1,
                             const void* xyz2, const void* pre,
                             const void* skip, void* out, int B, int N, int M,
                             int C, int lanes, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(smem);
  return is_bf16 ? launch_mode<__nv_bfloat16, 8>(mode, lanes, xyz1, xyz2, pre,
                                                 skip, out, B, N, M, C, bytes,
                                                 st)
                 : launch_mode<float, 4>(mode, lanes, xyz1, xyz2, pre, skip,
                                         out, B, N, M, C, bytes, st);
}
