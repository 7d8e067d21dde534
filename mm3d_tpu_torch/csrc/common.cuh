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

// Storage type (f32 or bf16) <-> f32, and rnd<T>(): round to T and back.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// V consecutive channels, loaded and stored as one move (16 bytes when
// sizeof(T) * V == 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};
