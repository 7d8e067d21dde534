// Farthest point sampling: xyz [B,N,3] f32, start [B] int32 -> [B,npoint] int32.
//
// Replaces the TPU kernel fps_pallas / _fps_kernel in
// mm3d_tpu/ops/pallas_kernels.py (and fps_pallas_v2, which has the same
// contract). Bit-exact with geometry.fps_torch and geometry._fps_jax: the
// running min-distance starts at 1e10, d = (dx*dx + dy*dy) + dz*dz rounded
// without FMA contraction, and the argmax takes the first index on ties.
//
// What bounds it on the H100: the npoint steps depend on each other, and each
// step ends in a block-wide (max distance, min index) reduction. The bytes
// (one read of the cloud, one write of the indices) and the arithmetic are
// tiny, so the time is npoint times the latency of one step; one block per
// cloud already fills the card at B=128. The design keeps the step short:
// - few warps (128 threads up to 1,024 points, at most kRegThreads up to
//   kRegThreads * 16), thread t holding the points [t*PPT, (t+1)*PPT) (up
//   to 16), their running min-distance and their coordinates in registers,
//   so lanes and warps are in index order;
// - a thread's best (distance, point) by a tree of strict > merges, the
//   lower indices on the left;
// - one barrier a step. Up to 4 warps every thread writes its best
//   (distance bits, index) to a double-buffered slot; after the barrier
//   lane l of every warp merges the slots of lane l of all warps (in index
//   order), and two redux.sync (the max of the distance bits, which order
//   like the floats since d >= 0, then the min of the index among the lanes
//   holding it) give every thread the block's winner. With more warps each
//   warp first reduces its best the same way to one slot, and lane w reads
//   slot w after the barrier. The form is a template argument, so the step
//   has no branch on the block's size. No warp waits for a serial stage.
//   (On the H100 a chained redux.sync measured 47 cycles, ballot + ffs 63,
//   a shuffle 30; the one-level exchange saves a warp's two redux.sync up
//   to 4 warps, and loses to them at 8, where a lane merges 8 slots:
//   utils/sample_phases.py, PERF.md.)
// - the winner's coordinates are one 16-byte shared-memory read: the
//   register form also keeps the cloud there as (x, y, z, 0) a point;
// - the indices collect in shared memory, a chunk of kIdxChunk at a time,
//   and leave in coalesced stores between the chunks' steps.
// Past kRegThreads * 16 points the distance loop reads the coordinates from
// shared memory too (16 points a thread, up to 1,024 threads, x, y and z in
// separate arrays so the reads do not conflict); the running minima stay in
// registers.
#include "common.cuh"
#include "sample_phases.cuh"

namespace {

constexpr int kFewThreads = 128;  // threads up to 1,024 points
constexpr int kRegThreads = 256;  // most threads of the register form
constexpr int kPPT = 16;          // most points a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kIdxChunk = 2048;   // indices held before a store

// smem: the slots of (distance bits, index) (2 x 32 a warp's, then 2 x
// kFewThreads a thread's), the index chunk, then the cloud: in the register
// form (x, y, z, 0) a point in index order, the winner's coordinates one
// 16-byte read; in the shared form x[T*PPT], y[...], z[...], point k of
// thread t at k*T + t
inline size_t fps_smem_bytes(int threads, int ppt, bool smem_form) {
  return 2 * (32 + kFewThreads) * sizeof(uint2) + kIdxChunk * sizeof(int) +
         static_cast<size_t>(threads) * ppt *
             (smem_form ? 3 * sizeof(float) : sizeof(float4));
}

template <int PPT, bool kSmem, bool kOneLevel>
__global__ void __launch_bounds__(kSmem ? kMaxThreads : kRegThreads)
fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
           int* __restrict__ out, int N, int npoint) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* slot = reinterpret_cast<uint2*>(smem);
  int* sidx = reinterpret_cast<int*>(slot + 2 * (32 + kFewThreads));
  float* sx = reinterpret_cast<float*>(sidx + kIdxChunk);
  float4* s4 = reinterpret_cast<float4*>(sidx + kIdxChunk);
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, nwarp = T >> 5;
  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float* sy = sx + T * PPT;
  float* sz = sy + T * PPT;

  // point k of this thread: j = t*PPT + k; past N it holds d = 0 and
  // coordinates 0 for ever, and loses every tie to a live point, whose
  // index is lower
  float px[kSmem ? 1 : PPT], py[kSmem ? 1 : PPT], pz[kSmem ? 1 : PPT];
  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int j = t * PPT + k;
    float x = 0.f, y = 0.f, z = 0.f;
    if (j < N) {
      x = __ldg(p + 3 * j);
      y = __ldg(p + 3 * j + 1);
      z = __ldg(p + 3 * j + 2);
    }
    if constexpr (kSmem) {
      sx[k * T + t] = x;
      sy[k * T + t] = y;
      sz[k * T + t] = z;
    } else {
      s4[j] = make_float4(x, y, z, 0.f);
      px[k] = x;
      py[k] = y;
      pz[k] = z;
    }
    mind[k] = j < N ? 1e10f : 0.f;
  }
  __syncthreads();  // the cloud is in shared memory for the lookups

  int* o = out + static_cast<size_t>(b) * npoint;
  int far = start[b];
  float cx, cy, cz;
  // the coordinates of point j
  auto lookup = [&](int j) {
    if constexpr (kSmem) {
      const unsigned at = (static_cast<unsigned>(j) % PPT) * T +
                          static_cast<unsigned>(j) / PPT;
      cx = sx[at];
      cy = sy[at];
      cz = sz[at];
    } else {
      const float4 c = s4[j];
      cx = c.x;
      cy = c.y;
      cz = c.z;
    }
  };
  lookup(far);
  if (t == 0) sidx[0] = far;
  PH_START;
  PH_ADD(7, 1);
  // step i picks index i; the indices of [base, end) collect in sidx and
  // leave together
  int i = 1;
  for (int base = 0;; base += kIdxChunk) {
    const int end = min(base + kIdxChunk, npoint);
    for (; i < end; ++i) {
      PH_ADD(6, 1);
      float d[PPT];
      int kb[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float x = kSmem ? sx[k * T + t] : px[k];
        const float y = kSmem ? sy[k * T + t] : py[k];
        const float z = kSmem ? sz[k * T + t] : pz[k];
        const float dx = __fsub_rn(x, cx);
        const float dy = __fsub_rn(y, cy);
        const float dz = __fsub_rn(z, cz);
        mind[k] = fminf(mind[k], __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                      __fmul_rn(dy, dy)),
                                            __fmul_rn(dz, dz)));
        d[k] = mind[k];
        kb[k] = k;
      }
      // the thread's best: a later point (higher index) wins only if
      // strictly farther. A tree of merges in the register form; in order
      // where the coordinates are in shared memory (fewer live registers at
      // 1,024 threads)
      auto merge = [&](int l, int r) {
        const bool take = d[r] > d[l];
        d[l] = take ? d[r] : d[l];
        kb[l] = take ? kb[r] : kb[l];
      };
      if constexpr (kSmem) {
#pragma unroll
        for (int k = 1; k < PPT; ++k) merge(0, k);
      } else {
#pragma unroll
        for (int step = 1; step < PPT; step *= 2) {
#pragma unroll
          for (int k = 0; k + step < PPT; k += 2 * step) merge(k, k + step);
        }
      }
      PH_WAITF(d[0]);
      PH_MARK(0);
      uint2 v = make_uint2(__float_as_uint(d[0]),
                           static_cast<unsigned>(t * PPT + kb[0]));
      if constexpr (!kOneLevel) {
        // more than 4 warps: the warp's best (the max distance bits, then
        // the lowest index holding them) to its slot; lane w reads slot w
        const unsigned m = __reduce_max_sync(0xffffffffu, v.x);
        const unsigned jm =
            __reduce_min_sync(0xffffffffu, v.x == m ? v.y : 0xffffffffu);
        if (lane == 0) slot[(i & 1) * 32 + warp] = make_uint2(m, jm);
        PH_MARK(1);
        __syncthreads();
        PH_MARK(2);
        v = lane < nwarp ? slot[(i & 1) * 32 + lane] : make_uint2(0u, ~0u);
      } else {
        // up to 4 warps: every thread's best to its slot; lane l merges
        // lane l's slots of every warp, which are in index order
        uint2* sl = slot + 64 + (i & 1) * kFewThreads;
        sl[t] = v;
        PH_MARK(1);
        __syncthreads();
        PH_MARK(2);
        uint2 w[kFewThreads / 32];
#pragma unroll
        for (int k = 0; k < kFewThreads / 32; ++k)
          w[k] = k < nwarp ? sl[k * 32 + lane] : make_uint2(0u, ~0u);
#pragma unroll
        for (int step = 1; step < kFewThreads / 32; step *= 2) {
#pragma unroll
          for (int k = 0; k + step < kFewThreads / 32; k += 2 * step)
            if (w[k + step].x > w[k].x) w[k] = w[k + step];
        }
        v = w[0];
      }
      // the block's winner: the max distance bits, then the lowest index
      const unsigned gm = __reduce_max_sync(0xffffffffu, v.x);
      far = static_cast<int>(
          __reduce_min_sync(0xffffffffu, v.x == gm ? v.y : 0xffffffffu));
      PH_WAIT(far);
      PH_MARK(3);
      lookup(far);
      PH_WAITF(cx + cy + cz);
      PH_MARK(4);
      if (t == 0) sidx[i - base] = far;
      PH_MARK(5);
    }
    __syncthreads();
    for (int k = t; k < end - base; k += T) o[base + k] = sidx[k];
    if (end == npoint) break;
    __syncthreads();  // the chunk is out before thread 0 reuses it
  }
  PH_END;
}

template <int PPT, bool kSmem, bool kOneLevel = false>
int launch(const float* xyz, const int* start, int* out, int B, int N,
           int npoint, int threads, cudaStream_t stream) {
  const size_t smem = fps_smem_bytes(threads, PPT, kSmem);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PPT, kSmem, kOneLevel>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fps_kernel<PPT, kSmem, kOneLevel><<<B, threads, smem, stream>>>(
      xyz, start, out, N, npoint);
  return static_cast<int>(cudaGetLastError());
}

// Points a thread holds for a cloud of N: the fewest (1, 2, 4, 8) that keep
// the block within kFewThreads, then 8 up to kRegThreads threads, then 16
// (measured: 128 threads of 8 points beat 256 of 4 at N = 1,024, 128 of 4
// beat 64 of 8 at 512, 256 of 8 beat 128 of 16 at 2,048;
// utils/sample_phases.py --src, PERF.md).
int points_per_thread(int N) {
  int ppt = 1;
  while (ppt < 8 && ppt * kFewThreads < N) ppt *= 2;
  return N <= 8 * kRegThreads ? ppt : kPPT;
}

#ifdef SAMPLE_PHASE_CLOCKS
// The least step of a block of the register form (at most kRegThreads
// threads): the exchange of fps_kernel's step in the same form (the slot
// writes, barrier, slot reads and merge, two or four redux.sync) and the
// coordinate read, with no distance work; each step's input depends on the
// last step's result. Thread 0 of block 0 writes the cycles and the
// nanoseconds (%globaltimer) of the whole loop to out.
template <bool kOneLevel>
__global__ void __launch_bounds__(kRegThreads)
fps_floor_kernel(int steps, unsigned long long* out) {
  __shared__ uint2 slot[2][kFewThreads];
  __shared__ float4 cloud[kRegThreads];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarp = blockDim.x >> 5;
  cloud[t] = make_float4(static_cast<float>(t), 0.f, 0.f, 0.f);
  uint2 v = make_uint2((t + 1) * 2654435761u, t);
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const unsigned long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    uint2* sl = slot[i & 1];
    if constexpr (!kOneLevel) {
      const unsigned m = __reduce_max_sync(0xffffffffu, v.x);
      const unsigned jm =
          __reduce_min_sync(0xffffffffu, v.x == m ? v.y : 0xffffffffu);
      if (lane == 0) sl[warp] = make_uint2(m, jm);
      __syncthreads();
      v = lane < nwarp ? sl[lane] : make_uint2(0u, ~0u);
    } else {
      sl[t] = v;
      __syncthreads();
      uint2 w[kFewThreads / 32];
#pragma unroll
      for (int k = 0; k < kFewThreads / 32; ++k)
        w[k] = k < nwarp ? sl[k * 32 + lane] : make_uint2(0u, ~0u);
#pragma unroll
      for (int step = 1; step < kFewThreads / 32; step *= 2) {
#pragma unroll
        for (int k = 0; k + step < kFewThreads / 32; k += 2 * step)
          if (w[k + step].x > w[k].x) w[k] = w[k + step];
      }
      v = w[0];
    }
    const unsigned gm = __reduce_max_sync(0xffffffffu, v.x);
    const unsigned far =
        __reduce_min_sync(0xffffffffu, v.x == gm ? v.y : 0xffffffffu);
    v = make_uint2(v.x * 1664525u +
                       __float_as_uint(cloud[far & (kRegThreads - 1)].x),
                   t);
  }
  const unsigned long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (t == 0 && blockIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = g1 - g0;
    out[2] = v.x;
  }
}
#endif

}  // namespace

#ifdef SAMPLE_PHASE_CLOCKS
// Runs the least-step loop on `blocks` blocks of `threads` (at most
// kRegThreads) threads and writes its cycles and nanoseconds (block 0) to
// the device array out[3].
extern "C" int mm3d_fps_floor(int blocks, int threads, int steps, void* out,
                              void* stream) {
  if (threads > kRegThreads) return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads > kFewThreads)
    fps_floor_kernel<false><<<blocks, threads, 0, st>>>(steps, o);
  else
    fps_floor_kernel<true><<<blocks, threads, 0, st>>>(steps, o);
  return static_cast<int>(cudaGetLastError());
}
#endif

// Largest N the launcher takes: 1,024 threads x 16 points.
extern "C" int mm3d_fps_max_points() { return kMaxThreads * kPPT; }

// Threads a block of the launcher runs for a cloud of N points.
extern "C" int mm3d_fps_threads(int N) {
  const int ppt = points_per_thread(N);
  return ((N + 32 * ppt - 1) / (32 * ppt)) * 32;
}

extern "C" int mm3d_fps(const void* xyz, const void* start, void* out, int B,
                        int N, int npoint, void* stream) {
  if (N < 1 || N > mm3d_fps_max_points())
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = mm3d_fps_threads(N);
  const int ppt = points_per_thread(N);
  const float* x = static_cast<const float*>(xyz);
  const int* s = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads > kRegThreads)
    return launch<kPPT, true>(x, s, o, B, N, npoint, threads, st);
  if (threads > kFewThreads) {
    return ppt == 8 ? launch<8, false>(x, s, o, B, N, npoint, threads, st)
                    : launch<16, false>(x, s, o, B, N, npoint, threads, st);
  }
  switch (ppt) {
    case 1: return launch<1, false, true>(x, s, o, B, N, npoint, threads, st);
    case 2: return launch<2, false, true>(x, s, o, B, N, npoint, threads, st);
    case 4: return launch<4, false, true>(x, s, o, B, N, npoint, threads, st);
    default: return launch<8, false, true>(x, s, o, B, N, npoint, threads, st);
  }
}
