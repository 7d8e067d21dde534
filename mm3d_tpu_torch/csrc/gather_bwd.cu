// Scatter-add backward of the gathers, with an optional weight per
// contribution. Two forms, one entry point:
//
//   unweighted: g [B,F,C], idx [B,F] int32 -> d [B,n,C] in g's dtype,
//               d[b, idx[b,f]] += g[b,f]             (index_points' backward)
//   weighted:   g [B,R,C], idx [B,R,k], w [B,R,k] in g's dtype ->
//               d[b, idx[b,r,j]] += rnd(g[b,r] * w[b,r,j])
//
// The contribution f = r*k + j is the product taken in f32 (__fmul_rn) and
// rounded to g's dtype (rnd), as the elementwise product g * w of the plain
// PyTorch version is; the unweighted form is k = 1 with no product. Every
// output element is the f32 sum of its contributions in ascending f, begun
// from +0, then rounded to g's dtype. An index outside [0, n) contributes
// nothing. That order is the one CPU index_add_ takes, so the result matches
// cuda_kernels.gather_backward_torch run on the host bit for bit, and two
// calls give identical bits. The weighted form serves the backwards of
// three_interpolate (k = 3) and of the bilinear sampling (k = 4, f32) without
// a [B,R,k,C] stack of products in device memory.
//
// Replaces the TPU kernel gather_bwd_pallas / _gather_bwd_kernel in
// mm3d_tpu/ops/pallas_kernels.py. The TPU kernel writes the scatter-add as a
// one-hot-transpose MXU matmul (with a three-way bf16 split of f32 g),
// because XLA's scatter serialises on the TPU. None of that carries over.
//
// What bounds it on the H100: bytes in principle (each contribution's row of
// g read once, each output row written once: SA1 at B=24 is 100.7 MB of f32
// g, 0.030 ms at 3.35 TB/s). In practice the latency of the chain of phases
// a block runs per batch (loads, sort, sums, barriers) comes first; more
// resident warps measured faster, hence 512 threads and two blocks a
// multiprocessor (PERF.md has the times and the phase split). Three
// kernels, one call:
//   1. count_kernel, a block per (cloud, tile of 1024 contributions): how
//      many contributions of the tile land in each bucket, a bucket being a
//      range of rows_per_block output rows (integer shared-memory atomics,
//      order-free).
//   2. bucket_kernel, the same grid: a stable counting sort of the tile by
//      bucket (warp match ranks equal buckets, counts per warp and bucket, a
//      scan), written to the bucket's place in a per-cloud list: each
//      bucket's contributions contiguous, in ascending f, packed as
//      f << 7 | row within the bucket. Every tile sorts in parallel; no
//      single-warp walk, and each index is read twice in all.
//   3. gather_bwd_kernel, a block per (cloud, bucket, 32-channel slice): 256
//      contributions at a time form a batch. The block loads the batch's
//      32-channel segments of g with 16-byte moves (32 KB in flight) while it
//      sorts the batch by row (warp match, counts per 32 entries and row, a
//      scan) and sums the batch before it; the loaded values, weighted and
//      rounded, go to shared memory in row order. Warp w sums rows
//      r = w mod 16, each row's segment of the sorted batch in order, lanes
//      across the 32 channels, into f32 sums that live in shared memory
//      until the block writes its rows once at the end.
//   A heavy output row (ball-query padding, projected points crowding one
//   pixel) is split across channel slices and its loads across all the
//   block's threads; its sum order is never split. No float atomics.
#include <type_traits>

#include "common.cuh"

// Built with -DGB_PHASE_CLOCKS (utils/gather_phases.py), thread 0 of each
// block of gather_bwd_kernel adds the clock64() cycles of each phase to
// g_phase: 0 reading the batch's entries, 1 issuing its loads, 2 the sort,
// 3 warp 0's sums, 4 the barrier after them, 5 staging plus the barrier,
// 6 batches. Off, the macros are empty.
#ifdef GB_PHASE_CLOCKS
__device__ unsigned long long g_phase[8];
#define GB_CLOCK(t) const long long t = clock64()
#define GB_ADD(i, v) ph[i] += (v)
#else
#define GB_CLOCK(t)
#define GB_ADD(i, v)
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;  // resident a multiprocessor: <= 64 registers
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 32;             // channels a block owns, one per lane
constexpr int kBatch = 256;            // contributions staged per pass
constexpr int kGroups = kBatch / 32;   // the batch's 32-entry groups
constexpr int kRowBits = 7;
constexpr int kMaxRowsPerBlock = 1 << kRowBits;  // rows of a bucket
constexpr int kMaxRows = 50000;
constexpr int kMaxF = 1 << (31 - kRowBits);  // contributions a cloud
constexpr int kTile = 1024;            // contributions a tile, one a thread
constexpr int kTileWarps = kTile / 32;
constexpr int kMaxBuckets = 512;

static_assert(kMaxRowsPerBlock <= kThreads, "one thread per row in the sort");
static_assert(kBatch <= kThreads, "one thread per entry in the sort");
static_assert(kMaxBuckets <= kTile, "one thread per bucket in the scan");
static_assert(kTileWarps == 32, "one warp total a lane");

// ------------------------------------------------ 1. counts per tile

// cnt [B, T, NB]: contributions of tile t that land in bucket q.
__global__ void __launch_bounds__(kTile)
count_kernel(const int* __restrict__ idx, int* __restrict__ cnt, int F,
             int n, int rpb, int NB, int T) {
  extern __shared__ int hist[];
  const int t = blockIdx.x, b = blockIdx.y;
  for (int q = threadIdx.x; q < NB; q += kTile) hist[q] = 0;
  __syncthreads();
  const int f = t * kTile + threadIdx.x;
  if (f < F) {
    const int v = __ldg(idx + static_cast<long long>(b) * F + f);
    if (v >= 0 && v < n) atomicAdd(&hist[v / rpb], 1);
  }
  __syncthreads();
  int* cb = cnt + (static_cast<long long>(b) * T + t) * NB;
  for (int q = threadIdx.x; q < NB; q += kTile) cb[q] = hist[q];
}

// ------------------------------------------- 2. stable bucket sort

// list [B, F]: each cloud's contributions grouped by bucket, ascending f in
// a bucket, packed f << kRowBits | row in the bucket; bstart [B, NB + 1]:
// where each bucket starts (written by tile 0's block).
__global__ void __launch_bounds__(kTile)
bucket_kernel(const int* __restrict__ idx, const int* __restrict__ cnt,
              int* __restrict__ list, int* __restrict__ bstart, int F, int n,
              int rpb, int NB, int T) {
  extern __shared__ int sm[];
  int* wc = sm;                          // [kTileWarps][NB]
  int* warp_tot = sm + kTileWarps * NB;  // [kTileWarps]
  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kTileWarps * NB; i += kTile) wc[i] = 0;
  const int f = t * kTile + tid;
  int q = -1, loc = 0;
  if (f < F) {
    const int v = __ldg(idx + static_cast<long long>(b) * F + f);
    if (v >= 0 && v < n) {
      q = v / rpb;
      loc = v - q * rpb;
    }
  }
  const unsigned peers = __match_any_sync(0xffffffffu, q);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  __syncthreads();
  if (q >= 0 && rank == 0) wc[warp * NB + q] = __popc(peers);

  // bucket qq's first slot for this tile: the totals of the buckets before
  // it, plus its counts in the tiles before this one; thread qq's bucket
  const int* cb = cnt + static_cast<long long>(b) * T * NB;
  int total = 0, before = 0;
  if (tid < NB) {
    for (int tt = 0; tt < T; ++tt) {
      const int c = cb[static_cast<long long>(tt) * NB + tid];
      total += c;
      before += tt < t ? c : 0;
    }
  }
  int inc = total;  // block exclusive scan of the totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int start = inc - total;
  for (int w = 0; w < warp; ++w) start += warp_tot[w];
  if (t == 0 && tid <= NB)
    bstart[static_cast<long long>(b) * (NB + 1) + tid] = start;
  if (tid < NB) {
    int run = start + before;
    for (int w = 0; w < kTileWarps; ++w) {
      const int c = wc[w * NB + tid];
      wc[w * NB + tid] = run;
      run += c;
    }
  }
  __syncthreads();
  if (q >= 0)
    list[static_cast<long long>(b) * F + wc[warp * NB + q] + rank] =
        static_cast<int>((static_cast<unsigned>(f) << kRowBits) |
                         static_cast<unsigned>(loc));
}

// ------------------------------------------------------ 3. the sums

struct Smem {
  float stage[kBatch * kSlice];          // 32 KB: a batch, sorted by row
  float acc[kMaxRowsPerBlock * kSlice];  // 16 KB: the block's sums
  int ent[kBatch];                       // the batch's packed entries
  int cnt[kGroups * kMaxRowsPerBlock];   // a batch's counts per group, row
  int seg[2][kMaxRowsPerBlock + 1];      // a batch's row segments in stage
  int pos[kBatch];                       // a batch entry's slot in stage
  int tot[kWarps];
};

template <typename T, bool kWeighted, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_bwd_kernel(const T* __restrict__ g, const int* __restrict__ list,
                  const int* __restrict__ bstart, const T* __restrict__ weight,
                  T* __restrict__ out, int R, int k, int n, int C,
                  int rows_per_block, int slices, int NB) {
  constexpr int kVE = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kPPE = kSlice / kVE;                 // moves per entry
  constexpr int kPPT = kBatch * kPPE / kThreads;     // moves per thread
  constexpr int kM = kMaxRowsPerBlock;
  using Vec = Pack<T, kVE>;
  // a 16-byte move is one uint4 (a struct of 8 bf16 would copy as 8 loads)
  using Word = std::conditional_t<kVec, uint4, T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x % slices) * kSlice;
  const int bucket = blockIdx.x / slices;
  const int r0 = bucket * rows_per_block;
  const int rows = min(rows_per_block, n - r0);
  const int F = R * k;  // contributions per cloud
  const int* bs = bstart + static_cast<long long>(b) * (NB + 1);
  const int* lb = list + static_cast<long long>(b) * F + bs[bucket];
  const int total = bs[bucket + 1] - bs[bucket];  // this block's entries
  const T* wb = kWeighted ? weight + static_cast<long long>(b) * F : nullptr;
  const T* gb = g + static_cast<long long>(b) * R * C;
#ifdef GB_PHASE_CLOCKS
  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#endif

  for (int i = tid; i < rows * kSlice; i += kThreads) s.acc[i] = 0.f;
  for (int i = tid; i < kGroups * kM; i += kThreads) s.cnt[i] = 0;
  for (int i = tid; i < 2 * (kM + 1); i += kThreads) (&s.seg[0][0])[i] = 0;

  // A stable counting sort of the batch s.ent[0, m) by row: entry e goes to
  // slot pos[e] of the stage, row r's entries fill seg[r] up to seg[r + 1]
  // in ascending f. Thread e holds entry e; warp ranks by match.
  auto sort_batch = [&](int m, int* seg) {
    const int r = tid < m ? s.ent[tid] & (kM - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    const int rank = __popc(peers & lt);
    if (r >= 0 && rank == 0) s.cnt[warp * kM + r] = __popc(peers);
    __syncthreads();
    int run = 0;
    if (tid < rows) {
#pragma unroll
      for (int w = 0; w < kGroups; ++w) {
        const int c = s.cnt[w * kM + tid];
        s.cnt[w * kM + tid] = run;
        run += c;
      }
    }
    int inc = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    if (lane == 31) s.tot[warp] = inc;
    __syncthreads();
    int start = inc - run;
    for (int w = 0; w < warp; ++w) start += s.tot[w];
    if (tid < rows) {
      seg[tid] = start;
#pragma unroll
      for (int w = 0; w < kGroups; ++w) s.cnt[w * kM + tid] += start;
    }
    if (tid == 0) seg[rows] = m;
    __syncthreads();
    if (r >= 0) s.pos[tid] = s.cnt[warp * kM + r] + rank;
    __syncthreads();
    if (tid < rows) {
#pragma unroll
      for (int w = 0; w < kGroups; ++w) s.cnt[w * kM + tid] = 0;
    }
  };

  int head = 0;  // the first entry not yet staged
  int cur = 0;   // s.seg[cur]: the staged batch's segments (empty at first)
  // this thread's entry of the next batch, loaded a batch ahead
  int nxt = tid < min(kBatch, total) ? __ldg(lb + tid) : 0;
  Word reg[kPPT];
  T wreg[kPPT];
  while (true) {
    // 0. the batch's entries to shared memory; the next batch's loaded ahead
    GB_CLOCK(t0);
    const int m = min(kBatch, total - head);
    if (tid < m) s.ent[tid] = nxt;
    if (tid < min(kBatch, total - head - m)) nxt = __ldg(lb + head + m + tid);
    __syncthreads();
    // 1. issue the loads of the batch; they land while 2-3 run
    GB_CLOCK(t1);
#pragma unroll
    for (int i = 0; i < kPPT; ++i) {
      const int p = tid + i * kThreads;
      const int e = p / kPPE, c = c0 + (p % kPPE) * kVE;
      if (e < m && c < C) {
        const int f = static_cast<int>(static_cast<unsigned>(s.ent[e]) >>
                                       kRowBits);
        const int src = kWeighted ? f / k : f;
        reg[i] = *reinterpret_cast<const Word*>(
            gb + static_cast<long long>(src) * C + c);
        if (kWeighted) wreg[i] = wb[f];
      }
    }
    // 2. sort it by row
    GB_CLOCK(t2);
    sort_batch(m, s.seg[cur ^ 1]);
    // 3. sum the staged batch: warp w the rows r = w mod 16, each row's
    // segment in ascending f
    GB_CLOCK(t3);
    const int* seg = s.seg[cur];
    for (int r = warp; r < rows; r += kWarps) {
      const int a = seg[r], z = seg[r + 1];
      if (a == z) continue;
      float acc = s.acc[r * kSlice + lane];
      int e = a;
      for (; e + 4 <= z; e += 4) {
        const float v0 = s.stage[e * kSlice + lane];
        const float v1 = s.stage[(e + 1) * kSlice + lane];
        const float v2 = s.stage[(e + 2) * kSlice + lane];
        const float v3 = s.stage[(e + 3) * kSlice + lane];
        acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v0), v1), v2),
                        v3);
      }
      for (; e < z; ++e) acc = __fadd_rn(acc, s.stage[e * kSlice + lane]);
      s.acc[r * kSlice + lane] = acc;
    }
    GB_CLOCK(t4);
    __syncthreads();
    GB_CLOCK(t5);
    GB_ADD(0, t1 - t0);
    GB_ADD(1, t2 - t1);
    GB_ADD(2, t3 - t2);
    GB_ADD(3, t4 - t3);
    GB_ADD(4, t5 - t4);
    if (m == 0) break;

    // 4. stage the batch in row order: f32 values, the weight applied
#pragma unroll
    for (int i = 0; i < kPPT; ++i) {
      const int p = tid + i * kThreads;
      const int e = p / kPPE, q = (p % kPPE) * kVE;
      if (e >= m) continue;
      const bool in = c0 + q < C;
      const float w = kWeighted && in ? to_f(wreg[i]) : 1.f;
      float x[kVE];
#pragma unroll
      for (int v = 0; v < kVE; ++v) {
        x[v] = in ? to_f(reinterpret_cast<const Vec&>(reg[i]).v[v]) : 0.f;
        if (kWeighted) x[v] = rnd<T>(__fmul_rn(x[v], w));
      }
      float* dst = &s.stage[s.pos[e] * kSlice + q];
      if constexpr (kVE % 4 == 0) {
#pragma unroll
        for (int v = 0; v < kVE; v += 4)
          *reinterpret_cast<float4*>(dst + v) =
              make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
      } else {
#pragma unroll
        for (int v = 0; v < kVE; ++v) dst[v] = x[v];
      }
    }
    head += m;
    cur ^= 1;
    __syncthreads();
    GB_ADD(5, clock64() - t5);
    GB_ADD(6, 1);
  }
#ifdef GB_PHASE_CLOCKS
  if (tid == 0)
    for (int i = 0; i < 8; ++i) atomicAdd(&g_phase[i], ph[i]);
#endif

  // 5. write the block's rows once
  T* ob = out + (static_cast<long long>(b) * n + r0) * C + c0;
  for (int i = tid; i < rows * kSlice; i += kThreads) {
    const int r = i / kSlice, c = i % kSlice;
    if (c0 + c < C) ob[static_cast<long long>(r) * C + c] = from_f<T>(s.acc[i]);
  }
}

template <typename T, bool kWeighted, bool kVec>
int launch_sums(const void* g, const int* list, const int* bstart,
                const void* weight, void* out, int B, int R, int k, int n,
                int C, int rows_per_block, int NB, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  const cudaError_t e = cudaFuncSetAttribute(
      gather_bwd_kernel<T, kWeighted, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int slices = (C + kSlice - 1) / kSlice;
  const dim3 grid(static_cast<unsigned>(NB * slices),
                  static_cast<unsigned>(B));
  gather_bwd_kernel<T, kWeighted, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), list, bstart, static_cast<const T*>(weight),
      static_cast<T*>(out), R, k, n, C, rows_per_block, slices, NB);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int vec, const void* g, const int* list, const int* bstart,
             const void* weight, void* out, int B, int R, int k, int n, int C,
             int rpb, int NB, cudaStream_t s) {
  if (weight != nullptr) {
    return vec ? launch_sums<T, true, true>(g, list, bstart, weight, out, B, R,
                                            k, n, C, rpb, NB, s)
               : launch_sums<T, true, false>(g, list, bstart, weight, out, B,
                                             R, k, n, C, rpb, NB, s);
  }
  return vec ? launch_sums<T, false, true>(g, list, bstart, weight, out, B, R,
                                           k, n, C, rpb, NB, s)
             : launch_sums<T, false, false>(g, list, bstart, weight, out, B, R,
                                            k, n, C, rpb, NB, s);
}

}  // namespace

extern "C" int mm3d_gather_bwd_max_rows() { return kMaxRows; }
extern "C" int mm3d_gather_bwd_max_rows_per_block() { return kMaxRowsPerBlock; }
extern "C" int mm3d_gather_bwd_max_contributions() { return kMaxF; }
extern "C" int mm3d_gather_bwd_max_buckets() { return kMaxBuckets; }
extern "C" int mm3d_gather_bwd_tile() { return kTile; }

#ifdef GB_PHASE_CLOCKS
// Copies the 8 phase sums to host memory, then zeroes them if reset.
extern "C" int mm3d_gather_bwd_phases(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#endif

// g: [B,R,C] in the dtype is_bf16 names; idx: [B,R,k] int32; weight: [B,R,k]
// in g's dtype, or null for the unweighted form (k = 1); out: [B,n,C] in g's
// dtype, every element written. Scratch, allocated by the caller: cnt
// [B, T, NB], list [B, R*k] and bstart [B, NB + 1] int32, T = ceil(R*k /
// tile), NB = ceil(n / rows_per_block). vec: 1 when C is a multiple of 16
// bytes' worth of channels and g is 16-byte aligned (16-byte moves), else 0.
// rows_per_block: output rows a bucket (and a block) owns, 1..128, with
// NB <= max_buckets (the wrapper picks it so that the launch fills the card).
extern "C" int mm3d_gather_bwd(int is_bf16, int vec, const void* g,
                               const void* idx, const void* weight, void* out,
                               void* cnt, void* list, void* bstart, int B,
                               int R, int k, int n, int C, int rows_per_block,
                               void* stream) {
  const long long F = static_cast<long long>(R) * k;
  if (n > kMaxRows || rows_per_block < 1 ||
      rows_per_block > kMaxRowsPerBlock || (weight == nullptr && k != 1) ||
      F > kMaxF)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NB = (n + rows_per_block - 1) / rows_per_block;
  if (NB > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  const int T = static_cast<int>((F + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cntp = static_cast<int*>(cnt);
  int* listp = static_cast<int*>(list);
  int* bsp = static_cast<int*>(bstart);
  cudaError_t e;
  if (T == 0) {
    e = cudaMemsetAsync(bsp, 0, sizeof(int) * B * (NB + 1), s);
  } else {
    const int smem1 = NB * static_cast<int>(sizeof(int));
    const int smem2 = (kTileWarps * NB + kTileWarps) *
                      static_cast<int>(sizeof(int));
    e = cudaFuncSetAttribute(count_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bucket_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem2);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(B));
    count_kernel<<<grid, kTile, smem1, s>>>(static_cast<const int*>(idx),
                                             cntp, static_cast<int>(F), n,
                                             rows_per_block, NB, T);
    bucket_kernel<<<grid, kTile, smem2, s>>>(static_cast<const int*>(idx),
                                              cntp, listp, bsp,
                                              static_cast<int>(F), n,
                                              rows_per_block, NB, T);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return is_bf16
             ? dispatch<__nv_bfloat16>(vec, g, listp, bsp, weight, out, B, R,
                                       k, n, C, rows_per_block, NB, s)
             : dispatch<float>(vec, g, listp, bsp, weight, out, B, R, k, n, C,
                               rows_per_block, NB, s);
}
