// Fused set-abstraction tail: ball query + gather + BN-folded 2-layer MLP +
// max over the K neighbours, in one kernel.
//
//   out[b,s] = max_k relu(rnd(rnd(h1[k] @ w2) + b2)),
//   h1[k]    = relu(rnd(rnd(h0[k] @ w1) + b1)),
//   h0[k]    = relu(rnd(pre[b, idx[b,s,k]] + cbias[b,s]))
//
// where idx is the ball query of ball_query.cuh and rnd() rounds to the
// compute dtype (bf16 or f32), at the places the TPU kernel rounds
// (_fused_sa_kernel, mm3d_tpu/ops/pallas_kernels.py): products accumulate in
// f32, and each product output is cast to the dtype before its bias add.
//
// Replaces the TPU kernel fused_sa_pallas (its versions _fused_sa_kernel,
// _v4, _v6 and _v7 are TPU layout variants of one function) in
// mm3d_tpu/ops/pallas_kernels.py. The TPU kernel gathers neighbour rows with
// one-hot MXU matmuls because a TPU core has no fast row gather; here each
// warp copies a neighbour's row straight from device memory into shared
// memory.
//
// What bounds it on the H100: the two products (2*K*(C1*C2 + C2*C3) operations
// per centroid, about 155 GFLOP for SA1 and SA2 together at B=128) against
// ~34 MB of input and output, so it is bound by tensor-core operations. The
// grouped [B,S,K,C] tensor never touches device memory: a block takes St
// centroids (St*K ~ 128 rows), selects their neighbours into shared memory,
// gathers the rows, runs both products from shared memory with bf16 wmma
// tiles and f32 accumulators (f32 inputs take CUDA-core FMAs), and reduces
// max over K in the epilogue. Weights are read through L1/L2 by every block;
// keeping them resident and using wgmma is later work.
#include <mma.h>

#include "ball_query.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // output columns per product pass

struct SaArgs {
  const float* xyz;      // [B,N,3]
  const float* new_xyz;  // [B,S,3]
  const void* pre;       // [B,N,C1]
  const void* cbias;     // [B,S,C1]
  const void* w1;        // [C1p,C2p], zero padded
  const void* b1;        // [C2p]
  const void* w2;        // [C2p,C3p]
  const void* b2;        // [C3p]
  void* out;             // [B,S,C3]
  int B, N, S, K, C1, C3, C1p, C2p, C3p, St;
  float r2;
};

// Shared-memory layout, in bytes: idx[R] | A[Rp][ldA] | H[Rp][ldH] | Sc[Rp][ldS]
struct Layout {
  int R, Rp, ldA, ldH, ldS;
  size_t offA, offH, offS, total;
  __host__ __device__ Layout(int St, int K, int C1p, int C2p, int esize) {
    R = St * K;
    Rp = (R + 15) & ~15;
    ldA = C1p + 16 / esize;  // a 16-byte skew keeps wmma loads off one bank
    ldH = C2p + 16 / esize;
    ldS = kChunk + 4;
    offA = ((static_cast<size_t>(R) * 4 + 127) / 128) * 128;
    offH = offA + static_cast<size_t>(Rp) * ldA * esize;
    offS = offH + static_cast<size_t>(Rp) * ldH * esize;
    total = offS + static_cast<size_t>(Rp) * ldS * sizeof(float);
  }
};

// Sc[Rp][ncols] = X[Rp][Kd] @ W[Kd][c0:c0+ncols], X in shared memory, W in
// device memory (row stride ldw). bf16: one warp per 16x16 output tile.
__device__ void product_chunk(const __nv_bfloat16* X, int ldx, int Kd,
                              const __nv_bfloat16* W, int ldw, int c0,
                              int ncols, float* Sc, int ldS, int Rp) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int tn_count = ncols / 16;
  const int tiles = (Rp / 16) * tn_count;
  for (int t = warp; t < tiles; t += kWarps) {
    const int tm = t / tn_count, tn = t % tn_count;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < Kd; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, X + tm * 16 * ldx + k, ldx);
      wmma::load_matrix_sync(fb, W + static_cast<size_t>(k) * ldw + c0 + tn * 16,
                             ldw);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(Sc + tm * 16 * ldS + tn * 16, acc, ldS,
                            wmma::mem_row_major);
  }
}

// f32: CUDA-core FMAs, each thread four rows of one column.
__device__ void product_chunk(const float* X, int ldx, int Kd, const float* W,
                              int ldw, int c0, int ncols, float* Sc, int ldS,
                              int Rp) {
  const int nq = (Rp / 4) * ncols;
  for (int e = threadIdx.x; e < nq; e += kThreads) {
    const int r = (e / ncols) * 4, c = e % ncols;
    const float* w = W + c0 + c;
    const float* x = X + r * ldx;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int k = 0; k < Kd; ++k) {
      const float wk = __ldg(w + static_cast<size_t>(k) * ldw);
      a0 = fmaf(x[k], wk, a0);
      a1 = fmaf(x[ldx + k], wk, a1);
      a2 = fmaf(x[2 * ldx + k], wk, a2);
      a3 = fmaf(x[3 * ldx + k], wk, a3);
    }
    Sc[r * ldS + c] = a0;
    Sc[(r + 1) * ldS + c] = a1;
    Sc[(r + 2) * ldS + c] = a2;
    Sc[(r + 3) * ldS + c] = a3;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_sa_kernel(SaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.St, a.K, a.C1p, a.C2p, sizeof(T));
  int* idx = reinterpret_cast<int*>(smem);
  T* A = reinterpret_cast<T*>(smem + L.offA);
  T* H = reinterpret_cast<T*>(smem + L.offH);
  float* Sc = reinterpret_cast<float*>(smem + L.offS);

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * a.St;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* pre = static_cast<const T*>(a.pre) + static_cast<size_t>(b) * a.N * a.C1;
  const T* cb = static_cast<const T*>(a.cbias) + static_cast<size_t>(b) * a.S * a.C1;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* w2 = static_cast<const T*>(a.w2);
  const T* b2 = static_cast<const T*>(a.b2);
  T* out = static_cast<T*>(a.out);

  // 1. neighbours: one warp per centroid of the tile
  for (int s = warp; s < a.St; s += kWarps) {
    const int sg = s0 + s;
    if (sg < a.S) {
      const float* c = a.new_xyz + (static_cast<size_t>(b) * a.S + sg) * 3;
      mm3d_ball_query_warp(a.xyz + static_cast<size_t>(b) * a.N * 3, a.N, c[0],
                           c[1], c[2], a.r2, a.K, idx + s * a.K);
    } else {
      for (int k = lane; k < a.K; k += 32) idx[s * a.K + k] = 0;
    }
  }
  __syncthreads();

  // 2. gather: A[r] = relu(rnd(pre[idx[r]] + cbias[s])), zero padding
  for (int r = warp; r < L.Rp; r += kWarps) {
    T* row = A + r * L.ldA;
    if (r < L.R) {
      const int sg = min(s0 + r / a.K, a.S - 1);
      const T* src = pre + static_cast<size_t>(idx[r]) * a.C1;
      const T* cbr = cb + static_cast<size_t>(sg) * a.C1;
      for (int c = lane; c < a.C1p; c += 32) {
        float v = 0.f;
        if (c < a.C1) v = fmaxf(rnd<T>(to_f(src[c]) + to_f(cbr[c])), 0.f);
        row[c] = from_f<T>(v);
      }
    } else {
      for (int c = lane; c < a.C1p; c += 32) row[c] = from_f<T>(0.f);
    }
  }
  __syncthreads();

  // 3. layer 1: H = relu(rnd(rnd(A @ w1) + b1))
  for (int c0 = 0; c0 < a.C2p; c0 += kChunk) {
    const int ncols = min(kChunk, a.C2p - c0);
    product_chunk(A, L.ldA, a.C1p, w1, a.C2p, c0, ncols, Sc, L.ldS, L.Rp);
    __syncthreads();
    for (int e = threadIdx.x; e < L.Rp * ncols; e += kThreads) {
      const int r = e / ncols, c = e % ncols;
      const float v = rnd<T>(Sc[r * L.ldS + c]);
      H[r * L.ldH + c0 + c] = from_f<T>(fmaxf(rnd<T>(v + to_f(b1[c0 + c])), 0.f));
    }
    __syncthreads();
  }

  // 4. layer 2 and the max over K: relu outputs are >= 0, so 0 starts the max
  for (int c0 = 0; c0 < a.C3p; c0 += kChunk) {
    const int ncols = min(kChunk, a.C3p - c0);
    product_chunk(H, L.ldH, a.C2p, w2, a.C3p, c0, ncols, Sc, L.ldS, L.Rp);
    __syncthreads();
    for (int e = threadIdx.x; e < a.St * ncols; e += kThreads) {
      const int s = e / ncols, c = e % ncols;
      const int sg = s0 + s, cg = c0 + c;
      if (sg >= a.S || cg >= a.C3) continue;
      const float bias = to_f(b2[cg]);
      float m = 0.f;
      for (int k = 0; k < a.K; ++k) {
        const float v = rnd<T>(Sc[(s * a.K + k) * L.ldS + c]);
        m = fmaxf(m, fmaxf(rnd<T>(v + bias), 0.f));
      }
      out[(static_cast<size_t>(b) * a.S + sg) * a.C3 + cg] = from_f<T>(m);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const SaArgs& a, cudaStream_t stream) {
  const Layout L(a.St, a.K, a.C1p, a.C2p, sizeof(T));
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_sa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((a.S + a.St - 1) / a.St, a.B);
  fused_sa_kernel<T><<<grid, kThreads, L.total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C1p, C2p and C3p are multiples of 16; w1, b1, w2 and b2 are zero padded to
// them. St centroids per block.
extern "C" int mm3d_fused_sa(int is_bf16, const void* xyz, const void* new_xyz,
                             const void* pre, const void* cbias, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* out, int B, int N, int S, int K, int C1,
                             int C3, int C1p, int C2p, int C3p, int St,
                             float r2, void* stream) {
  SaArgs a;
  a.xyz = static_cast<const float*>(xyz);
  a.new_xyz = static_cast<const float*>(new_xyz);
  a.pre = pre;
  a.cbias = cbias;
  a.w1 = w1;
  a.b1 = b1;
  a.w2 = w2;
  a.b2 = b2;
  a.out = out;
  a.B = B;
  a.N = N;
  a.S = S;
  a.K = K;
  a.C1 = C1;
  a.C3 = C3;
  a.C1p = C1p;
  a.C2p = C2p;
  a.C3p = C3p;
  a.St = St;
  a.r2 = r2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
