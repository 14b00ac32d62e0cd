// Blocked squared-L2 distances between N records and C representatives with
// a running top-k per record: (N, k) ascending distances and rep ids.  The
// (N, C) matrix is never written.
//
// Replaces: distance_topk_pallas in src/repro/kernels/distance_topk/kernel.py
// (its _kernel and _k_smallest).  Same arithmetic: d2 = |x|^2 + |r|^2 - 2 x.r
// accumulated in float32 from f32/f16/bf16 inputs, clamped at 0.
//
// Bound on an H100: operations.  2*N*C*D multiply-adds (1.79 TFLOP at
// N = 1M, C = 7,000, D = 128, ~27 ms at 67 TFLOP/s of float32 FMA) against
// ~0.58 GB of traffic (~0.17 ms at 3.35 TB/s).  The design is a SIMT float32
// GEMM tile (64 records x 64 reps per block, 4 x 4 outputs per thread, the
// depth staged through shared memory 32 at a time) whose finished distance
// tile goes to shared memory, where 4 threads per record scan 16 candidates
// each into a sorted k-list held in registers.  The lists are merged through
// warp shuffles once per block, so top-k upkeep costs ~1/100 of the FMAs.
// The TPU kernel's k rounds of (min, argmin, mask) existed because the TPU
// has no dynamic gather; they are not carried over.
//
// Ties: candidates are ordered by (distance, rep id), so on equal distances
// the lower id wins, as in lax.top_k and _k_smallest's argmin.  Reps beyond C
// in the last tile get +inf and sort after every real rep; as k <= C they
// never reach the output (no padded rep values, so float16 inputs give
// finite outputs).  Exact float32 throughout; tensor
// cores (TF32/wgmma) are left for a later change with its own tolerance.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int BM = 64;                 // records per block
constexpr int BN = 64;                 // reps per tile
constexpr int BK = 32;                 // dimensions per shared-memory chunk
constexpr int THREADS = 256;
constexpr int PARTS = THREADS / BM;    // threads sharing one record's top-k
constexpr int SEG = BN / PARTS;        // candidates per thread per tile

template <typename T>
__global__ void row_sqnorm_kernel(const T* __restrict__ a, int n, int d,
                                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < n; row += warps) {
    const T* p = a + row * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = to_f32(p[j]);
      s = fmaf(v, v, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[row] = s;
  }
}

__device__ __forceinline__ bool before(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

// Insert (v, id) into the sorted list; the caller checked it beats the tail.
template <int KMAX>
__device__ __forceinline__ void insert(float v, int id, float (&bd)[KMAX],
                                       int (&bi)[KMAX]) {
  bd[KMAX - 1] = v;
  bi[KMAX - 1] = id;
#pragma unroll
  for (int j = KMAX - 1; j > 0; --j) {
    if (before(bd[j], bi[j], bd[j - 1], bi[j - 1])) {
      const float td = bd[j];
      bd[j] = bd[j - 1];
      bd[j - 1] = td;
      const int ti = bi[j];
      bi[j] = bi[j - 1];
      bi[j - 1] = ti;
    }
  }
}

template <typename T, int KMAX>
__global__ void __launch_bounds__(THREADS)
distance_topk_kernel(const T* __restrict__ x, const T* __restrict__ r,
                     const float* __restrict__ xsq,
                     const float* __restrict__ rsq, int n, int c, int d,
                     int k, float* __restrict__ out_d,
                     int* __restrict__ out_i) {
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float rs[BK][BN + 4];
  __shared__ float ds[BM][BN + 1];

  const int tid = threadIdx.x;
  const int ty = tid / 16;             // outputs: records ty*4 .. ty*4+3
  const int tx = tid % 16;             //          reps    tx*4 .. tx*4+3
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int my_row = tid / PARTS;      // top-k phase: record and segment
  const int part = tid % PARTS;

  float x2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t rr = row0 + ty * 4 + i;
    x2[i] = rr < n ? xsq[rr] : 0.f;
  }
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = INFINITY;
    bi[j] = INT_MAX;
  }

  for (int c0 = 0; c0 < c; c0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      // coalesced along the depth, stored depth-major for float4 reads
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int i = e / BK, j = e % BK;
        const int64_t rr = row0 + i;
        const int dd = k0 + j;
        xs[j][i] = (rr < n && dd < d) ? to_f32(x[rr * d + dd]) : 0.f;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int i = e / BK, j = e % BK;
        const int cc = c0 + i;
        const int dd = k0 + j;
        rs[j][i] = (cc < c && dd < d) ? to_f32(r[(int64_t)cc * d + dd]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int t = 0; t < BK; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[t][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&rs[t][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c0 + tx * 4 + j;
      const float r2 = cc < c ? rsq[cc] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = fmaxf((x2[i] + r2) - 2.f * acc[i][j], 0.f);
        ds[ty * 4 + i][tx * 4 + j] = cc < c ? v : INFINITY;
      }
    }
    __syncthreads();
    // ascending rep ids within each thread's segment
#pragma unroll 4
    for (int s = 0; s < SEG; ++s) {
      const int col = part * SEG + s;
      const float v = ds[my_row][col];
      if (before(v, c0 + col, bd[KMAX - 1], bi[KMAX - 1]))
        insert<KMAX>(v, c0 + col, bd, bi);
    }
    __syncthreads();
  }

  // merge the PARTS lists of each record (adjacent lanes) into part 0's
#pragma unroll
  for (int p = 1; p < PARTS; ++p) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const float v = __shfl_down_sync(0xffffffffu, bd[j], p);
      const int id = __shfl_down_sync(0xffffffffu, bi[j], p);
      if (part == 0 && before(v, id, bd[KMAX - 1], bi[KMAX - 1]))
        insert<KMAX>(v, id, bd, bi);
    }
  }
  const int64_t row = row0 + my_row;
  if (part == 0 && row < n) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        out_d[row * k + j] = bd[j];
        out_i[row * k + j] = bi[j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* r, float* xsq, float* rsq, int n, int c,
           int d, int k, float* out_d, int* out_i, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const int norm_blocks = repro_sm_count() * 8;
  row_sqnorm_kernel<T><<<norm_blocks, 256, 0, s>>>(xt, n, d, xsq);
  row_sqnorm_kernel<T><<<norm_blocks, 256, 0, s>>>(rt, c, d, rsq);
  const unsigned grid = (unsigned)((n + BM - 1) / BM);
#define REPRO_TOPK(KM)                                                      \
  distance_topk_kernel<T, KM><<<grid, THREADS, 0, s>>>(xt, rt, xsq, rsq, n, \
                                                       c, d, k, out_d, out_i)
  // two list lengths only: each instantiation costs build time, and a
  // longer list than k changes nothing but the upkeep of its tail
  if (k <= 8) REPRO_TOPK(8);
  else if (k <= 32) REPRO_TOPK(32);
  else return (int)cudaErrorInvalidValue;
#undef REPRO_TOPK
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d) and r (c, d) row-major in `dtype`; xsq (n,) and rsq (c,) float32
// scratch; out_d (n, k) float32 and out_i (n, k) int32.  Needs 1 <= k <= 32,
// k <= c, n >= 1.
REPRO_EXPORT int distance_topk_launch(const void* x, const void* r, void* xsq,
                                      void* rsq, int n, int c, int d, int k,
                                      int dtype, void* out_d, void* out_i,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(xsq);
  float* rs = static_cast<float*>(rsq);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  switch (dtype) {
    case REPRO_F32: return launch<float>(x, r, xs, rs, n, c, d, k, od, oi, s);
    case REPRO_F16: return launch<__half>(x, r, xs, rs, n, c, d, k, od, oi, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(x, r, xs, rs, n, c, d, k, od, oi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
