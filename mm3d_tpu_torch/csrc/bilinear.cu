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
// its mask or weight. In f32 the twin's masked corner times its lerp weight,
// (c m) (1-du), is taken as c (m (1-du)), once a point: with m 0 or 1 and
// 1-du, du in [0, 1] (or NaN) the two are the same float, signed zeros and
// NaNs included, and a channel costs 9 operations instead of 13.
//
// Replaces the TPU kernel bilinear_sample_pallas_raw / _bilinear_kernel in
// mm3d_tpu/ops/pallas_kernels.py (the forward; the VJP is
// cuda_kernels._BilinearSample, which scatters the corner cotangents through
// gather_bwd.cu). That kernel builds each point's four weights as a one-hot
// [nt, H*W] row and multiplies it into the map on the MXU, because a TPU core
// has no fast gather. Here a point is four row gathers and a lerp per
// channel.
//
// What bounds it on the H100. At the fusion_sem_seg serving shape (a
// [16,16,16,128] map sampled at 16 x 2048 points) it reads the 2.1 MB map
// (f32) and the uv and writes 16.8 MB: about 19.1 MB, 5.7 us at 3.35 TB/s
// (9.7 MB, 2.9 us in bf16). The first design, one thread a 16-byte pack,
// did not reach that: it issued 319 SASS instructions a thread in bf16 (252
// in f32) for 16 bytes, about 48 of them two 64-bit divisions to find its
// point, and repeated the point's corners, masks and weights on every lane.
// Here the grid is 2-D (tiles of points in x, the image in y): every offset
// inside a map is 32-bit, a thread finds its point and lane by shift and
// mask, a lane writes kPacks 16-byte packs of its point (channels lane*V +
// q*C/kPacks: a store of the point's lanes stays contiguous), so the
// point's work is spread over kPacks packs, and f32 takes 9 operations a
// channel. That is 150 instructions for 16 bytes in bf16 and 115 in f32
// (4 and 2 packs a lane). The kernel holds at most 64 registers a
// thread (kMinBlocks), so the card holds four blocks a multiprocessor. At
// the serving shape it then runs at about 1.2x its byte bound in f32 and
// 1.7x in bf16, where a kernel that only stores the output already takes
// 0.9x and 1.05x: each 16 bytes written gathers four corner rows of 16
// bytes from the map, which the bf16 form pays most for. A grid of only
// the blocks the card holds at once, each walking tiles; 1024-thread
// blocks; the corners staged in shared memory once a point; and FMAs on
// exact bf16 products were raced and lost (PERF.md).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// 16-byte packs of one point a thread writes: f32 2, bf16 4, the faster of
// 1, 2 and 4 at the path shapes
template <typename T>
constexpr int kPacks = std::is_same_v<T, float> ? 2 : 4;
constexpr int kMinBlocks = 4;  // tile kernel: blocks of kThreads a
                               // multiprocessor holds (<= 64 registers)
constexpr int kMaxBatch = 65535;  // images on the grid's y axis

// One point's corners (x0,y0), (x1,y0), (x0,y1), (x1,y1): their offsets in
// the map (clamped in-frame pixels) and weights. bf16: the four rounded
// weights, 0 outside. f32: m00 (1-du), m10 du, m01 (1-du), m11 du, then
// (1-dv) and dv.
struct Corners {
  int off[4];
  float w[4];
  float omdv, dv;
};

template <typename T>
__device__ __forceinline__ Corners corners(float u, float v, int H, int W,
                                           int C) {
  Corners k;
  const float x0 = floorf(u), y0 = floorf(v);
  const float du = __fsub_rn(u, x0), dv = __fsub_rn(v, y0);
  const float omdu = __fsub_rn(1.0f, du), omdv = __fsub_rn(1.0f, dv);
  const float x1 = __fadd_rn(x0, 1.0f), y1 = __fadd_rn(y0, 1.0f);
  const float fw = static_cast<float>(W), fh = static_cast<float>(H);
  const bool inx0 = x0 >= 0.0f && x0 < fw, inx1 = x1 >= 0.0f && x1 < fw;
  const bool iny0 = y0 >= 0.0f && y0 < fh, iny1 = y1 >= 0.0f && y1 < fh;
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  const int xi0 = static_cast<int>(fminf(fmaxf(x0, 0.0f), xmax));
  const int xi1 = static_cast<int>(fminf(fmaxf(x1, 0.0f), xmax));
  const int r0 = static_cast<int>(fminf(fmaxf(y0, 0.0f), ymax)) * W;
  const int r1 = static_cast<int>(fminf(fmaxf(y1, 0.0f), ymax)) * W;
  k.off[0] = (r0 + xi0) * C;
  k.off[1] = (r0 + xi1) * C;
  k.off[2] = (r1 + xi0) * C;
  k.off[3] = (r1 + xi1) * C;
  const bool in[4] = {inx0 && iny0, inx1 && iny0, inx0 && iny1,
                      inx1 && iny1};
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    k.w[0] = in[0] ? rnd<T>(__fmul_rn(omdu, omdv)) : 0.0f;
    k.w[1] = in[1] ? rnd<T>(__fmul_rn(du, omdv)) : 0.0f;
    k.w[2] = in[2] ? rnd<T>(__fmul_rn(omdu, dv)) : 0.0f;
    k.w[3] = in[3] ? rnd<T>(__fmul_rn(du, dv)) : 0.0f;
  } else {
    k.w[0] = __fmul_rn(in[0] ? 1.0f : 0.0f, omdu);
    k.w[1] = __fmul_rn(in[1] ? 1.0f : 0.0f, du);
    k.w[2] = __fmul_rn(in[2] ? 1.0f : 0.0f, omdu);
    k.w[3] = __fmul_rn(in[3] ? 1.0f : 0.0f, du);
  }
  k.omdv = omdv;
  k.dv = dv;
  return k;
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> lerp(const Pack<T, V> (&c)[4],
                                           const Corners& k) {
  Pack<T, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      float acc = __fmul_rn(k.w[0], to_f(c[0].v[j]));
      acc = __fadd_rn(acc, __fmul_rn(k.w[1], to_f(c[1].v[j])));
      acc = __fadd_rn(acc, __fmul_rn(k.w[2], to_f(c[2].v[j])));
      acc = __fadd_rn(acc, __fmul_rn(k.w[3], to_f(c[3].v[j])));
      o.v[j] = from_f<T>(acc);
    } else {
      const float top = __fadd_rn(__fmul_rn(to_f(c[0].v[j]), k.w[0]),
                                  __fmul_rn(to_f(c[1].v[j]), k.w[1]));
      const float bot = __fadd_rn(__fmul_rn(to_f(c[2].v[j]), k.w[2]),
                                  __fmul_rn(to_f(c[3].v[j]), k.w[3]));
      o.v[j] = from_f<T>(
          __fadd_rn(__fmul_rn(top, k.omdv), __fmul_rn(bot, k.dv)));
    }
  }
  return o;
}

// 16-byte packs, 2^lanes_log2 lanes a point, kPacks packs a lane: block
// (x, b) takes points x * (kThreads >> lanes_log2) ... of image b.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bilinear_kernel(const T* __restrict__ feat, const float* __restrict__ uv,
                T* __restrict__ out, int H, int W, int N, int C,
                int lanes_log2) {
  using P = Pack<T, V>;
  const int n = blockIdx.x * (kThreads >> lanes_log2) +
                (threadIdx.x >> lanes_log2);
  if (n >= N) return;
  const int lane = threadIdx.x & ((1 << lanes_log2) - 1);
  const int step = V << lanes_log2;  // channels from one pack to the next
  const long long pt = static_cast<long long>(blockIdx.y) * N + n;
  const T* fb =
      feat + static_cast<long long>(blockIdx.y) * H * W * C + lane * V;
  const Corners k = corners<T>(uv[2 * pt], uv[2 * pt + 1], H, W, C);
  P c[kPacks<T>][4];
#pragma unroll
  for (int q = 0; q < kPacks<T>; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[q][i] = *reinterpret_cast<const P*>(fb + k.off[i] + q * step);
    }
  }
  T* o = out + pt * C + lane * V;
#pragma unroll
  for (int q = 0; q < kPacks<T>; ++q) {
    *reinterpret_cast<P*>(o + q * step) = lerp<T, V>(c[q], k);
  }
}

// Any C: V channels a thread (V = 1, the scalar moves, or a 16-byte pack
// when the packs of a point are not kPacks times a power of two), the pack
// found by a 32-bit division inside the image.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bilinear_any(const T* __restrict__ feat, const float* __restrict__ uv,
             T* __restrict__ out, int H, int W, int N, int C) {
  using P = Pack<T, V>;
  const int b = blockIdx.y;
  const int Q = C / V;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= N * Q) return;
  const int n = e / Q;
  const int ch = (e - n * Q) * V;
  const long long pt = static_cast<long long>(b) * N + n;
  const T* fb = feat + static_cast<long long>(b) * H * W * C + ch;
  const Corners k = corners<T>(uv[2 * pt], uv[2 * pt + 1], H, W, C);
  P c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = *reinterpret_cast<const P*>(fb + k.off[i]);
  }
  *reinterpret_cast<P*>(out + pt * C + ch) = lerp<T, V>(c, k);
}

template <typename T>
int launch(int vec, const void* feat_, const void* uv_, void* out_, int B,
           int H, int W, int N, int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* feat = static_cast<const T*>(feat_);
  const float* uv = static_cast<const float*>(uv_);
  T* out = static_cast<T*>(out_);
  const int lanes = vec ? C / V / kPacks<T> : 0;
  if (vec && C / V % kPacks<T> == 0 && lanes > 0 && lanes <= kThreads &&
      (lanes & (lanes - 1)) == 0) {
    int lg = 0;
    while ((1 << lg) < lanes) ++lg;
    const int rows = kThreads >> lg;
    const dim3 grid((N + rows - 1) / rows, B);
    bilinear_kernel<T, V><<<grid, kThreads, 0, stream>>>(feat, uv, out, H, W,
                                                         N, C, lg);
  } else if (vec) {
    const dim3 grid((N * (C / V) + kThreads - 1) / kThreads, B);
    bilinear_any<T, V><<<grid, kThreads, 0, stream>>>(feat, uv, out, H, W, N,
                                                      C);
  } else {
    const dim3 grid((N * C + kThreads - 1) / kThreads, B);
    bilinear_any<T, 1><<<grid, kThreads, 0, stream>>>(feat, uv, out, H, W, N,
                                                      C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 1 when C is a multiple of 16 bytes' worth of channels and both feature
// pointers are 16-byte aligned (16-byte moves), else 0 (scalar moves). The
// caller keeps B <= mm3d_bilinear_max_batch(), H*W*C and N*C below 2^31.
extern "C" int mm3d_bilinear(int is_bf16, int vec, const void* feat,
                             const void* uv, void* out, int B, int H, int W,
                             int N, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch<__nv_bfloat16>(vec, feat, uv, out, B, H, W, N, C, st)
             : launch<float>(vec, feat, uv, out, B, H, W, N, C, st);
}

extern "C" int mm3d_bilinear_max_batch() { return kMaxBatch; }
