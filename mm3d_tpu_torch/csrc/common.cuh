// Shared helpers of the mm3d_tpu_torch kernels.
//
// Every kernel source is built into its own shared library with a plain C
// interface (see ops/_build.py) and loaded with ctypes. Each library carries
// this error-string helper so that a wrapper can report the code its launch
// function returned.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

extern "C" const char* mm3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// (a0*b0 + a1*b1) + a2*b2 in round-to-nearest with no FMA contraction: the
// order and rounding of the plain PyTorch twins, so index outputs are
// bit-exact with them.
__device__ __forceinline__ float mm3d_dot3(float a0, float a1, float a2,
                                           float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}
