// Ball query: (radius, K, xyz [B,N,3] f32, new_xyz [B,S,3] f32) -> [B,S,K] int32.
//
// Replaces the TPU kernel ball_query_v2_pallas / _ball_query_v2_kernel in
// mm3d_tpu/ops/pallas_kernels.py (and ball_query_pallas, which has the same
// contract). The TPU kernel computes all S x N distances with one MXU matmul
// and ranks hits with a triangular matmul, because the TPU has no cheap
// per-lane compaction. On the H100 a warp ballot ranks 32 candidates in one
// instruction, so each warp walks its centroid's points in index order and
// stops once it holds K hits.
//
// What bounds it on the H100: neither bytes (the cloud is read once a block,
// the output is B*S*K*4 bytes) nor arithmetic, but the instructions and the
// shared-memory reads of the walk (most SA1 centroids have fewer than K hits
// and walk the whole cloud), and the latency of each round. The design:
// - one block per (cloud, slice of centroids): the cloud is staged in shared
//   memory once as (x, y, z, |p|^2), padded to a whole round with NaN points
//   that never hit, so a visit is 9 operations with no bounds test; |p|^2 is
//   computed once a point with mm3d_dot3, as ball_query_torch rounds it. A
//   cloud too large for shared memory is read from global memory in the
//   same order, |p|^2 computed on each visit;
// - the selection (ball_query.cuh) walks kU points a lane a round, so kU
//   load-and-distance chains are in flight a warp (a warp walking several
//   centroids over each point it reads measured slower: more registers,
//   fewer warps, and the shared-memory reads were not the limit);
// - the block's centroids are staged beside the cloud, so no walk starts on
//   a global load;
// - a warp collects its row in shared memory and stores it, the empty slots
//   filled on the way, in coalesced 16-byte stores;
// - the kernel asks for the largest shared-memory carve-out, so the
//   multiprocessor holds as many blocks as its threads and registers allow,
//   and the launcher gives each warp fewer centroids where the grid would
//   not fill the card (at least four blocks a multiprocessor).
#include "ball_query.cuh"
#include "sample_phases.cuh"

namespace {

constexpr int kWarps = 8;    // a block
constexpr int kU = 8;        // points a lane a round
constexpr int kMaxCpw = 8;   // centroids a warp
constexpr int kRowBytes = 32 * 1024;     // most bytes of row buffers
constexpr int kSmemBytes = 220 * 1024;   // most shared memory a block asks

// smem: the padded cloud (cloud_pts float4, 0 if it is read from global
// memory), the block's centroids (kWarps * cpw float4), then (kRowSmem) a
// row of K ints a warp. Warp w walks the block's centroids w, w + kWarps, ...
template <bool kRowSmem>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int* __restrict__ out,
                  int N, int S, int K, float r2, int cpw, int cloud_pts) {
  extern __shared__ __align__(16) float4 spts[];
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* x = xyz + static_cast<size_t>(b) * N * 3;
  const int s0 = blockIdx.x * cpw * kWarps;
  float4* scen = spts + cloud_pts;
  PH_START;
  PH_ADD(5, 1);
  for (int i = threadIdx.x; i < cloud_pts; i += kWarps * 32) {
    float4 v = mm3d_bq_nan_point();
    if (i < N) {
      const float px = __ldg(x + 3 * i), py = __ldg(x + 3 * i + 1),
                  pz = __ldg(x + 3 * i + 2);
      v = make_float4(px, py, pz, mm3d_dot3(px, py, pz, px, py, pz));
    }
    spts[i] = v;
  }
  for (int i = threadIdx.x; i < kWarps * cpw && s0 + i < S;
       i += kWarps * 32) {
    const float* cp = new_xyz + (static_cast<size_t>(b) * S + s0 + i) * 3;
    scen[i] = make_float4(__ldg(cp), __ldg(cp + 1), __ldg(cp + 2), 0.f);
  }
  __syncthreads();
  PH_MARK(0);
  int* srow = reinterpret_cast<int*>(scen + kWarps * cpw) + warp * K;
  for (int c = 0; c < cpw; ++c) {
    const int i = c * kWarps + warp;
    if (s0 + i >= S) break;  // the whole warp
    const float4 cen = scen[i];
    int* dst = out + (static_cast<size_t>(b) * S + s0 + i) * K;
    int* row = kRowSmem ? srow : dst;
    const int cnt =
        cloud_pts ? mm3d_ball_query_walk<kU>(BqCloud4{spts}, N, cen.x, cen.y,
                                             cen.z, r2, K, row)
                  : mm3d_ball_query_walk<kU>(BqCloud3{x}, N, cen.x, cen.y,
                                             cen.z, r2, K, row);
    __syncwarp();
    PH_MARK(1);
    PH_ADD(3, cnt == K ? min((row[K - 1] / (32 * kU) + 1) * kU, (N + 31) / 32)
                       : (N + 31) / 32);
    PH_ADD(4, 1);
    // the row out, the empty slots repeating the first hit (0 if none)
    const int first = cnt > 0 ? row[0] : 0;
    if (kRowSmem && (K & 3) == 0) {
      for (int k = 4 * lane; k < K; k += 128) {
        int4 v = *reinterpret_cast<const int4*>(row + k);
        v.x = k < cnt ? v.x : first;
        v.y = k + 1 < cnt ? v.y : first;
        v.z = k + 2 < cnt ? v.z : first;
        v.w = k + 3 < cnt ? v.w : first;
        *reinterpret_cast<int4*>(dst + k) = v;
      }
    } else {
      for (int k = lane; k < K; k += 32)
        if (kRowSmem || k >= cnt) dst[k] = k < cnt ? row[k] : first;
    }
    __syncwarp();  // the row is out before the next centroid's hits
    PH_MARK(2);
  }
  PH_END;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <bool kRowSmem>
int launch(const float* xyz, const float* new_xyz, int* out, int B, int N,
           int S, int K, float r2, int cpw, cudaStream_t stream) {
  static bool carveout = false;
  if (!carveout) {
    const cudaError_t e = cudaFuncSetAttribute(
        ball_query_kernel<kRowSmem>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    carveout = true;
  }
  const size_t fixed = kWarps * cpw * sizeof(float4) +
                       (kRowSmem ? kWarps * K * sizeof(int) : 0);
  const int padded = (N + 32 * kU - 1) / (32 * kU) * (32 * kU);
  const int cloud_pts =
      fixed + static_cast<size_t>(padded) * sizeof(float4) <= kSmemBytes
          ? padded
          : 0;
  const size_t smem = fixed + static_cast<size_t>(cloud_pts) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ball_query_kernel<kRowSmem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + kWarps * cpw - 1) / (kWarps * cpw), B);
  ball_query_kernel<kRowSmem><<<grid, kWarps * 32, smem, stream>>>(
      xyz, new_xyz, out, N, S, K, r2, cpw, cloud_pts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mm3d_ball_query(const void* xyz, const void* new_xyz, void* out,
                               int B, int N, int S, int K, float r2,
                               void* stream) {
  int cpw = kMaxCpw;
  while (cpw > 1 && static_cast<long long>(B) *
                            ((S + kWarps * cpw - 1) / (kWarps * cpw)) <
                        4LL * sm_count())
    cpw /= 2;
  const float* x = static_cast<const float*>(xyz);
  const float* c = static_cast<const float*>(new_xyz);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (static_cast<size_t>(kWarps) * K * sizeof(int) <= kRowBytes)
    return launch<true>(x, c, o, B, N, S, K, r2, cpw, st);
  return launch<false>(x, c, o, B, N, S, K, r2, cpw, st);
}
