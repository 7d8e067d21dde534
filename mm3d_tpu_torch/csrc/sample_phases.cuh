// Phase clocks of the sampling kernels (fps.cu, ball_query.cu).
//
// Built in only with -DSAMPLE_PHASE_CLOCKS (utils/sample_phases.py builds a
// second copy of each library so): every thread reads clock64() at each
// phase mark and adds the cycles since the last mark to its phase's
// register accumulator; at the end of the kernel lane 0 of every warp adds
// its accumulators to a block sum, and one thread adds that to a device
// array, which mm3d_sample_phases copies out (and zeroes). PH_WAIT(x) makes
// the phase wait for a loaded value, so a load's latency lands in the phase
// that issued it. Without the switch every macro is empty.
#pragma once

#include "common.cuh"

constexpr int kPhaseSlots = 16;

#ifdef SAMPLE_PHASE_CLOCKS
__device__ unsigned long long mm3d_phase_clk[kPhaseSlots];

extern "C" int mm3d_sample_phases(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, mm3d_phase_clk,
                                       sizeof(mm3d_phase_clk));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[kPhaseSlots] = {};
    e = cudaMemcpyToSymbol(mm3d_phase_clk, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}

// Called by every thread of the block once, at its end.
__device__ __forceinline__ void ph_flush(const unsigned long long* acc) {
  __shared__ unsigned long long sum[kPhaseSlots];
  if (threadIdx.x < kPhaseSlots) sum[threadIdx.x] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kPhaseSlots; ++k)
      if (acc[k]) atomicAdd(&sum[k], acc[k]);
  }
  __syncthreads();
  if (threadIdx.x < kPhaseSlots && sum[threadIdx.x])
    atomicAdd(&mm3d_phase_clk[threadIdx.x], sum[threadIdx.x]);
}

#define PH_START                                      \
  unsigned long long ph_acc[kPhaseSlots] = {};        \
  unsigned ph_sink = 0;                               \
  unsigned long long ph_t = clock64()
#define PH_MARK(k)                                    \
  do {                                                \
    const unsigned long long ph_n = clock64();        \
    ph_acc[k] += ph_n - ph_t;                         \
    ph_t = ph_n;                                      \
  } while (0)
#define PH_ADD(k, v) (ph_acc[k] += static_cast<unsigned long long>(v))
#define PH_WAIT(x) (ph_sink += static_cast<unsigned>(x))
#define PH_WAITF(x) (ph_sink += __float_as_uint(x))
#define PH_END                                        \
  do {                                                \
    ph_acc[kPhaseSlots - 1] += ph_sink & 1u;          \
    ph_flush(ph_acc);                                 \
  } while (0)
#else
#define PH_START
#define PH_MARK(k)
#define PH_ADD(k, v)
#define PH_WAIT(x)
#define PH_WAITF(x)
#define PH_END
#endif
