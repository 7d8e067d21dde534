// Backward of the grouping gather (index_points):
// g [B,F,C] (f32 or bf16), idx [B,F] int32 -> d [B,n,C] in g's dtype, with
// d[b, idx[b,f]] += g[b,f] summed in f32. Duplicate indices accumulate; an
// index outside [0, n) contributes nothing (as a -1 pad does in the TPU
// kernel's one-hot).
//
// Replaces the TPU kernel gather_bwd_pallas / _gather_bwd_kernel in
// mm3d_tpu/ops/pallas_kernels.py. The TPU kernel writes the scatter-add as a
// one-hot-transpose MXU matmul (with a three-way bf16 split of f32 g),
// because XLA's scatter serialises on the TPU. None of that carries over: on
// the H100 the scatter is a sort of the indices followed by a gather-sum.
//
// Determinism. Ball-query padding repeats a centroid's first hit, so one
// output row can receive up to K contributions from one centroid. A float
// atomicAdd per element would sum them in a different order on every launch.
// Instead the work is split in two kernels that give identical bits on
// every launch:
//   1. csr_kernel, one block per batch: a counting sort of idx into CSR
//      form (row_start [B,n+1], perm [B,F]). The histogram and the scan are
//      integer and so order-free; the scatter of f into its row's slots is
//      done by one warp walking f in order (warp match + popcount rank), so
//      each row lists its contributors in ascending f.
//   2. sum_kernel, one warp per output row: sums the row's contributors in
//      that ascending order, lanes across channels, and writes the row once.
//
// What bounds it on the H100: bytes. g is read once and d written once
// (SA1 at B=24: 100.7 MB of f32 g, 0.032 ms at 3.35 TB/s). The first
// kernel's one-warp scatter is a dependent walk over F/32 chunks per batch,
// which this simple version leaves on the critical path; making it parallel
// is later work.
#include "common.cuh"

namespace {

constexpr int kCsrThreads = 1024;
constexpr int kTile = 4096;  // idx elements staged in shared memory per pass
constexpr int kMaxRows = 50000;  // n ints + the tile fit in 227 KB
constexpr int kSumWarps = 8;
constexpr int kUnroll = 4;

// Exclusive block scan of one int per thread; returns the thread's prefix.
__device__ int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int t = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    if (lane < nw) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  return (warp > 0 ? warp_tot[warp - 1] : 0) + inc - v;
}

// smem: cursor[n] ints, then tile[kTile] ints.
__global__ void __launch_bounds__(kCsrThreads)
csr_kernel(const int* __restrict__ idx, int* __restrict__ row_start,
           int* __restrict__ perm, int F, int n) {
  extern __shared__ int smem[];
  int* cursor = smem;
  int* tile = smem + n;
  __shared__ int warp_tot[32];
  const int b = blockIdx.x;
  const int* ib = idx + static_cast<long long>(b) * F;
  int* rs = row_start + static_cast<long long>(b) * (n + 1);
  int* pb = perm + static_cast<long long>(b) * F;

  // 1. histogram
  for (int i = threadIdx.x; i < n; i += blockDim.x) cursor[i] = 0;
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int k = ib[f];
    if (k >= 0 && k < n) atomicAdd(&cursor[k], 1);
  }
  __syncthreads();

  // 2. exclusive scan: each thread owns a contiguous run of rows
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += cursor[i];
  int run = block_exclusive_scan(s, warp_tot);
  for (int i = lo; i < hi; ++i) {
    const int c = cursor[i];
    rs[i] = run;
    cursor[i] = run;
    run += c;
  }
  if (threadIdx.x == blockDim.x - 1) rs[n] = run;  // number of valid f
  __syncthreads();

  // 3. stable scatter of f into its row's slots: warp 0 walks f in order
  const int lane = threadIdx.x & 31;
  for (int f0 = 0; f0 < F; f0 += kTile) {
    const int len = min(kTile, F - f0);
    for (int j = threadIdx.x; j < len; j += blockDim.x) tile[j] = ib[f0 + j];
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int j0 = 0; j0 < len; j0 += 32) {
        const int j = j0 + lane;
        int k = j < len ? tile[j] : -1;
        const bool valid = k >= 0 && k < n;
        if (!valid) k = -1;
        const unsigned peers = __match_any_sync(0xffffffffu, k);
        if (valid) {
          const int rank = __popc(peers & ((1u << lane) - 1u));
          pb[cursor[k] + rank] = f0 + j;
        }
        __syncwarp();
        if (valid && lane == 31 - __clz(peers)) cursor[k] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// One warp per output row (b, r): d[b,r,:] = sum over the row's contributors,
// in ascending f, of g[b,f,:]. Lanes cover 128 channels per pass.
template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
sum_kernel(const T* __restrict__ g, const int* __restrict__ row_start,
           const int* __restrict__ perm, T* __restrict__ out, int B, int F,
           int n, int C) {
  const long long w =
      static_cast<long long>(blockIdx.x) * kSumWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(B) * n) return;  // whole warp leaves
  const int lane = threadIdx.x & 31;
  const long long b = w / n;
  const int r = static_cast<int>(w - b * n);
  const int* rs = row_start + b * (n + 1);
  const int beg = rs[r], end = rs[r + 1];
  const int* pb = perm + b * F;
  const T* gb = g + b * F * static_cast<long long>(C);
  T* o = out + w * C;
  for (int c0 = 0; c0 < C; c0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = beg; j < end; j += kUnroll) {
      float v[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = j + u < end;
        const T* row = gb + (in ? static_cast<long long>(pb[j + u]) * C : 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + lane + 32 * q;
          v[u][q] = (in && c < C) ? to_f(row[c]) : 0.f;
        }
      }
      // add in ascending f: the same order on every launch
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (j + u < end) acc[q] += v[u][q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < C) o[c] = from_f<T>(acc[q]);
    }
  }
}

template <typename T>
int launch(const void* g, const void* idx, void* row_start, void* perm,
           void* out, int B, int F, int n, int C, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n + kTile) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  csr_kernel<<<B, kCsrThreads, smem, stream>>>(
      static_cast<const int*>(idx), static_cast<int*>(row_start),
      static_cast<int*>(perm), F, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long warps = static_cast<long long>(B) * n;
  const int blocks = static_cast<int>((warps + kSumWarps - 1) / kSumWarps);
  sum_kernel<T><<<blocks, kSumWarps * 32, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int*>(row_start),
      static_cast<const int*>(perm), static_cast<T*>(out), B, F, n, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mm3d_gather_bwd_max_rows() { return kMaxRows; }

// row_start: [B, n+1] int32 scratch, perm: [B, F] int32 scratch, both
// allocated by the caller; out: [B, n, C] in g's dtype.
extern "C" int mm3d_gather_bwd(int is_bf16, const void* g, const void* idx,
                               void* row_start, void* perm, void* out, int B,
                               int F, int n, int C, void* stream) {
  if (n > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch<__nv_bfloat16>(g, idx, row_start, perm, out, B, F, n, C,
                                     s)
             : launch<float>(g, idx, row_start, perm, out, B, F, n, C, s);
}
