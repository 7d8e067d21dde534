// Bilinear sampling of a feature map at fractional pixel coordinates, zero
// outside the frame: feat [B,H,W,C] (f32 or bf16), uv [B,N,2] f32 ->
// out [B,N,C] in feat's dtype.
//
//   x0 = floor(u), y0 = floor(v), du = u - x0, dv = v - y0; corner (x, y) is
//   feat[b, y, x] if 0 <= x < W and 0 <= y < H, else 0.
//   f32:  top = c00 (1-du) + c10 du,  bot = c01 (1-du) + c11 du,
//         out = top (1-dv) + bot dv       (projection._bilinear_sample_jax)
//   bf16: w_xy = rnd((1-du)(1-dv)), rnd(du (1-dv)), rnd((1-du) dv), rnd(du dv)
//         (0 outside the frame), out = rnd(sum of w_xy * c_xy in f32)
//         (the TPU kernel's rounding: its weight rows are cast to bf16)
//
// Each form matches the plain twin projection.bilinear_sample_torch bit for
// bit: every product and sum is an explicitly rounded __fmul_rn / __fadd_rn
// in the twin's order (in bf16 the products are exact in f32), and, as in the
// twin, an outside corner reads the clamped in-frame pixel and is zeroed by
// its mask or weight.
//
// Replaces the TPU kernel bilinear_sample_pallas_raw / _bilinear_kernel in
// mm3d_tpu/ops/pallas_kernels.py (the forward; the VJP is
// cuda_kernels._BilinearSample, which scatters the corner cotangents through
// gather_bwd.cu). That kernel builds each point's four weights as a one-hot
// [nt, H*W] row and multiplies it into the map on the MXU, because a TPU core
// has no fast gather. Here a point is four row gathers and a lerp per
// channel.
//
// What bounds it on the H100: bytes. At the fusion_sem_seg serving shape (a
// [16,16,16,128] map sampled at 16 x 2048 points) it reads the 2.1 MB map
// (f32) and the uv and writes 16.8 MB: about 19.1 MB, 5.7 us at 3.35 TB/s
// (9.7 MB, 2.9 us in bf16). One thread handles 16 bytes of one point's
// channels, so neighbouring threads read neighbouring channels of the same
// corner rows, which stay in L2; the output write is the stream that counts.
// At this size the launch is expected to dominate.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bilinear_kernel(const T* __restrict__ feat, const float* __restrict__ uv,
                T* __restrict__ out, int H, int W, int N, int C,
                long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int CV = C / V;
  const long long pt = e / CV;  // b * N + n
  const int c = static_cast<int>(e - pt * CV) * V;
  const long long b = pt / N;
  const float u = uv[2 * pt], v = uv[2 * pt + 1];
  const float x0 = floorf(u), y0 = floorf(v);
  const float du = __fsub_rn(u, x0), dv = __fsub_rn(v, y0);
  const float omdu = __fsub_rn(1.0f, du), omdv = __fsub_rn(1.0f, dv);

  using P = Pack<T, V>;
  P corner[4];
  bool inside[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = x0 + static_cast<float>(k & 1);
    const float y = y0 + static_cast<float>(k >> 1);
    inside[k] = x >= 0.0f && x < static_cast<float>(W) && y >= 0.0f &&
                y < static_cast<float>(H);
    const int xi = static_cast<int>(fminf(fmaxf(x, 0.0f), static_cast<float>(W - 1)));
    const int yi = static_cast<int>(fminf(fmaxf(y, 0.0f), static_cast<float>(H - 1)));
    corner[k] = *reinterpret_cast<const P*>(
        feat + ((b * H + yi) * W + xi) * static_cast<long long>(C) + c);
  }

  P o;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const float w[4] = {inside[0] ? rnd<T>(__fmul_rn(omdu, omdv)) : 0.0f,
                        inside[1] ? rnd<T>(__fmul_rn(du, omdv)) : 0.0f,
                        inside[2] ? rnd<T>(__fmul_rn(omdu, dv)) : 0.0f,
                        inside[3] ? rnd<T>(__fmul_rn(du, dv)) : 0.0f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float acc = __fmul_rn(w[0], to_f(corner[0].v[j]));
      acc = __fadd_rn(acc, __fmul_rn(w[1], to_f(corner[1].v[j])));
      acc = __fadd_rn(acc, __fmul_rn(w[2], to_f(corner[2].v[j])));
      acc = __fadd_rn(acc, __fmul_rn(w[3], to_f(corner[3].v[j])));
      o.v[j] = from_f<T>(acc);
    }
  } else {
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = inside[k] ? 1.0f : 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float c00 = __fmul_rn(to_f(corner[0].v[j]), m[0]);
      const float c10 = __fmul_rn(to_f(corner[1].v[j]), m[1]);
      const float c01 = __fmul_rn(to_f(corner[2].v[j]), m[2]);
      const float c11 = __fmul_rn(to_f(corner[3].v[j]), m[3]);
      const float top = __fadd_rn(__fmul_rn(c00, omdu), __fmul_rn(c10, du));
      const float bot = __fadd_rn(__fmul_rn(c01, omdu), __fmul_rn(c11, du));
      o.v[j] = from_f<T>(__fadd_rn(__fmul_rn(top, omdv), __fmul_rn(bot, dv)));
    }
  }
  *reinterpret_cast<P*>(out + pt * C + c) = o;
}

template <typename T, int V>
int launch(const void* feat, const void* uv, void* out, int B, int H, int W,
           int N, int C, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * N * (C / V);
  const long long blocks = (total + kThreads - 1) / kThreads;
  bilinear_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(feat), static_cast<const float*>(uv),
      static_cast<T*>(out), H, W, N, C, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when C is a multiple of 16 bytes' worth of channels and both feature
// pointers are 16-byte aligned (16-byte moves), else 0 (scalar moves).
extern "C" int mm3d_bilinear(int is_bf16, int vec, const void* feat,
                             const void* uv, void* out, int B, int H, int W,
                             int N, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return vec ? launch<__nv_bfloat16, 8>(feat, uv, out, B, H, W, N, C, st)
               : launch<__nv_bfloat16, 1>(feat, uv, out, B, H, W, N, C, st);
  }
  return vec ? launch<float, 4>(feat, uv, out, B, H, W, N, C, st)
             : launch<float, 1>(feat, uv, out, B, H, W, N, C, st);
}
