// Farthest point sampling: xyz [B,N,3] f32, start [B] int32 -> [B,npoint] int32.
//
// Replaces the TPU kernel fps_pallas / _fps_kernel in
// mm3d_tpu/ops/pallas_kernels.py (and fps_pallas_v2, which has the same
// contract). Bit-exact with geometry.fps_torch and geometry._fps_jax: the
// running min-distance starts at 1e10, d = (dx*dx + dy*dy) + dz*dz rounded
// without FMA contraction, and the argmax takes the first index on ties.
//
// What bounds it on the H100: the npoint steps depend on each other, and each
// step ends in a block-wide (max value, min index) reduction. The bytes (one
// read of the cloud, one write of the indices) and the arithmetic are tiny,
// so the time is npoint times the latency of one step. The design keeps a
// step short: one block per cloud, each thread holds its points and their
// running min-distance in registers, the cloud sits in shared memory for the
// centroid lookup, and the reduction is one 64-bit key (distance bits, then
// the inverted index) reduced by warp shuffles and once across warps.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// smem: the cloud (3N floats, rounded up to an even count) then 33 keys.
inline size_t fps_smem_bytes(int N) {
  return static_cast<size_t>((3 * N + 1) & ~1) * sizeof(float) +
         33 * sizeof(unsigned long long);
}

template <int PPT>
__global__ void fps_kernel(const float* __restrict__ xyz,
                           const int* __restrict__ start,
                           int* __restrict__ out, int N, int npoint) {
  extern __shared__ __align__(16) float cloud[];
  unsigned long long* red =
      reinterpret_cast<unsigned long long*>(cloud + ((3 * N + 1) & ~1));
  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) cloud[i] = p[i];
  __syncthreads();

  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int t = 0; t < PPT; ++t) {
    const int j = threadIdx.x + t * blockDim.x;
    px[t] = py[t] = pz[t] = 0.f;
    if (j < N) {
      px[t] = cloud[3 * j];
      py[t] = cloud[3 * j + 1];
      pz[t] = cloud[3 * j + 2];
    }
    mind[t] = 1e10f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  int* o = out + static_cast<size_t>(b) * npoint;
  int far = start[b];
  for (int i = 0; i < npoint; ++i) {
    if (threadIdx.x == 0) o[i] = far;
    if (i + 1 == npoint) break;
    const float cx = cloud[3 * far], cy = cloud[3 * far + 1],
                cz = cloud[3 * far + 2];
    unsigned long long best = 0ull;  // loses to every live point
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      const int j = threadIdx.x + t * blockDim.x;
      if (j < N) {
        const float dx = __fsub_rn(px[t], cx);
        const float dy = __fsub_rn(py[t], cy);
        const float dz = __fsub_rn(pz[t], cz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        mind[t] = fminf(mind[t], d);
        // distances are >= 0, so their bit patterns order like the floats;
        // ~j in the low word makes the lower index win a tie
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(mind[t])) << 32) |
            static_cast<unsigned>(~j);
        best = key > best ? key : best;
      }
    }
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < nwarp ? red[lane] : 0ull;
      v = warp_max(v);
      if (lane == 0) red[32] = v;
    }
    __syncthreads();
    far = static_cast<int>(~static_cast<unsigned>(red[32] & 0xffffffffull));
  }
}

template <int PPT>
int launch(const float* xyz, const int* start, int* out, int B, int N,
           int npoint, int threads, cudaStream_t stream) {
  const size_t smem = fps_smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fps_kernel<PPT><<<B, threads, smem, stream>>>(xyz, start, out, N, npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest N the launcher takes: 512 threads x 32 points each.
extern "C" int mm3d_fps_max_points() { return 512 * 32; }

extern "C" int mm3d_fps(const void* xyz, const void* start, void* out, int B,
                        int N, int npoint, void* stream) {
  const int threads = N >= 512 ? 512 : ((N + 31) / 32) * 32;
  const int ppt = (N + threads - 1) / threads;
  const float* x = static_cast<const float*>(xyz);
  const int* s = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ppt <= 1) return launch<1>(x, s, o, B, N, npoint, threads, st);
  if (ppt <= 2) return launch<2>(x, s, o, B, N, npoint, threads, st);
  if (ppt <= 4) return launch<4>(x, s, o, B, N, npoint, threads, st);
  if (ppt <= 8) return launch<8>(x, s, o, B, N, npoint, threads, st);
  if (ppt <= 16) return launch<16>(x, s, o, B, N, npoint, threads, st);
  if (ppt <= 32) return launch<32>(x, s, o, B, N, npoint, threads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
