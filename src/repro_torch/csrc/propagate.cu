// Fused score propagation over the resident top-k rep structures: the (C,)
// rep scores become (N,) proxy scores through inverse-distance weights
// 1 / (sqrt(d2) + eps), with any column at or above pad_dist weighted 0.
//   numeric     - weighted mean, optionally clipped to [0, 1]
//   top1        - nearest rep's score minus prescale * its distance
//   categorical - weighted vote over n_classes, argmax (first class on ties),
//                 the class id returned as float32
//
// Replaces: propagate_pallas in src/repro/kernels/propagate/kernel.py (its
// _numeric_kernel, _top1_kernel and _categorical_kernel).  The top-1
// prescale is a global reduction over real rows: tie_break_prescale of
// kernels/propagate/ref.py, min(1e-6, 0.5 * smallest positive gap between
// rep scores) / (1 + max_row sqrt(max(d2[row, 0], 0))).  Min, max and that
// formula are exact, so the card reproduces it bit for bit: top1_stats
// writes each block's max and its smallest positive |s_i - s_j| over a
// share of the pairs of scores (the smallest such difference is the
// smallest gap between neighbours in sorted order, and the rounded
// difference of neighbours is what torch.diff computes), and every block
// of the propagation kernel reduces those partials itself.  So top1 is two
// launches and the host never waits; numeric and categorical are one.
//
// Bound on an H100: bytes.  It reads topk_ids and topk_d2 (64 MB at
// N = 1M, k = 8) and writes 4 MB, ~20 us at 3.35 TB/s; the arithmetic is a
// few operations per byte.  Design: one thread per record over a grid sized
// to the SMs; with k a multiple of 4 a row arrives as 16-byte vectors (two
// int4 and two float4 at k = 8), and at k = 8 the row's classes and
// weights are gathered into registers once and the vote runs there.  Rep
// scores are gathered by id through the read-only cache (28 KB at
// C = 7,000 stays in L1): faster than staging them per block in shared
// memory (PERF.md, PR 14).  The TPU kernel's one-hot gathers over a
// (rows, C) grid existed because the TPU has no dynamic gather; Hopper
// does.
#include "common.cuh"

namespace {

enum { MODE_NUMERIC = 0, MODE_TOP1 = 1, MODE_CATEGORICAL = 2 };

constexpr int THREADS = 256;

__device__ __forceinline__ float column_weight(float d2, float eps,
                                               float pad_dist) {
  return d2 >= pad_dist ? 0.f : 1.f / (sqrtf(fmaxf(d2, 0.f)) + eps);
}

template <typename Op>
__device__ __forceinline__ float block_reduce(float v, Op op, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                     // red may still be read by a caller
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = op(v, red[w]);
  return v;
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Block b of G: stats[b] = max over its rows of sqrt(max(d2[row, 0], 0));
// stats[G + b] = the smallest positive |s_i - s_j| over its share of the
// ordered pairs (+inf if none).  Pair work (i, strip): i = u % c and reps
// j in the strip u / c of c split into `strips`, so the lanes of a warp
// read the same s_j.
__global__ void __launch_bounds__(THREADS)
top1_stats_kernel(const float* __restrict__ scores, int c, int strips,
                  const float* __restrict__ d2, int n, int k,
                  float* __restrict__ stats) {
  __shared__ float red[THREADS / 32];
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  float mx = 0.f;
  for (int64_t row = gid; row < n; row += nthreads)
    mx = fmaxf(mx, sqrtf(fmaxf(__ldg(d2 + row * k), 0.f)));
  mx = block_reduce(mx, MaxOp(), red);
  float gap = INFINITY;
  const int len = (c + strips - 1) / strips;
  for (int64_t u = gid; u < (int64_t)c * strips; u += nthreads) {
    const int i = (int)(u % c), j0 = (int)(u / c) * len;
    const float si = __ldg(scores + i);
    const int j1 = min(c, j0 + len);
    for (int j = j0; j < j1; ++j) {
      const float diff = fabsf(__ldg(scores + j) - si);
      if (diff > 0.f) gap = fminf(gap, diff);
    }
  }
  gap = block_reduce(gap, MinOp(), red);
  if (threadIdx.x == 0) {
    stats[blockIdx.x] = mx;
    stats[gridDim.x + blockIdx.x] = gap;
  }
}

// The prescale from top1_stats' partials, as tie_break_prescale computes
// it (float32 throughout; no positive gap, or C < 2, leaves eps at 1e-6).
__device__ float prescale_from(const float* __restrict__ stats, int g,
                               float* red) {
  float mx = 0.f, gap = INFINITY;
  for (int b = threadIdx.x; b < g; b += blockDim.x) {
    mx = fmaxf(mx, stats[b]);
    gap = fminf(gap, stats[g + b]);
  }
  mx = block_reduce(mx, MaxOp(), red);
  gap = block_reduce(gap, MinOp(), red);
  return fminf(1e-6f, 0.5f * gap) / (1.f + mx);
}

// KC > 0: k == KC at compile time (a multiple of 4; the row in 16-byte
// vectors, the vote in registers).  KC == 0: any k, read as 16-byte vectors
// in numeric mode where k % 4 == 0, else scalar; the vote gathers a class
// per pair of columns.
template <int KC>
__global__ void __launch_bounds__(THREADS)
propagate_kernel(const float* __restrict__ scores, int c,
                 const int* __restrict__ ids, const float* __restrict__ d2,
                 int n, int k, int mode, int n_classes, int clip01, float eps,
                 float pad_dist, const float* __restrict__ prescale,
                 const float* __restrict__ stats, int n_stats,
                 float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  auto score = [&](int id) {
    return (unsigned)id < (unsigned)c ? __ldg(scores + id) : 0.f;
  };
  float pre = 0.f;
  if (mode == MODE_TOP1)
    pre = prescale ? *prescale : prescale_from(stats, n_stats, red);
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (int64_t)gridDim.x * blockDim.x) {
    const int* ri = ids + row * k;
    const float* rd = d2 + row * k;
    float o;
    if (mode == MODE_TOP1) {
      o = score(__ldg(ri)) - pre * sqrtf(fmaxf(__ldg(rd), 0.f));
    } else if constexpr (KC > 0) {
      int id[KC];
      float w[KC];
#pragma unroll
      for (int v = 0; v < KC / 4; ++v) {
        const int4 iv = __ldg(reinterpret_cast<const int4*>(ri) + v);
        const float4 dv = __ldg(reinterpret_cast<const float4*>(rd) + v);
        id[4 * v] = iv.x, id[4 * v + 1] = iv.y;
        id[4 * v + 2] = iv.z, id[4 * v + 3] = iv.w;
        w[4 * v] = column_weight(dv.x, eps, pad_dist);
        w[4 * v + 1] = column_weight(dv.y, eps, pad_dist);
        w[4 * v + 2] = column_weight(dv.z, eps, pad_dist);
        w[4 * v + 3] = column_weight(dv.w, eps, pad_dist);
      }
      if (mode == MODE_NUMERIC) {
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          num += w[j] * score(id[j]);
          den += w[j];
        }
        o = num / den;
      } else {
        int cls[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) cls[j] = (int)score(id[j]);
        float best_v = 0.f;
        int best_c = 0;  // all-zero votes -> class 0, like argmax
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int cj = cls[j];
          float v = 0.f;
#pragma unroll
          for (int j2 = 0; j2 < KC; ++j2)
            if (cls[j2] == cj) v += w[j2];
          if (cj >= 0 && cj < n_classes &&
              (v > best_v || (v == best_v && cj < best_c))) {
            best_v = v;
            best_c = cj;
          }
        }
        o = (float)best_c;
      }
    } else if (mode == MODE_NUMERIC) {
      float num = 0.f, den = 0.f;
      if (k % 4 == 0) {
        for (int v = 0; v < k / 4; ++v) {
          const int4 iv = __ldg(reinterpret_cast<const int4*>(ri) + v);
          const float4 dv = __ldg(reinterpret_cast<const float4*>(rd) + v);
          const int ii[4] = {iv.x, iv.y, iv.z, iv.w};
          const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float w = column_weight(dd[e], eps, pad_dist);
            num += w * score(ii[e]);
            den += w;
          }
        }
      } else {
        for (int j = 0; j < k; ++j) {
          const float w = column_weight(rd[j], eps, pad_dist);
          num += w * score(ri[j]);
          den += w;
        }
      }
      o = num / den;
    } else {
      float best_v = 0.f;
      int best_c = 0;  // all-zero votes -> class 0, like argmax
      for (int j = 0; j < k; ++j) {
        const int cj = (int)score(ri[j]);
        if (cj < 0 || cj >= n_classes) continue;
        float v = 0.f;
        for (int j2 = 0; j2 < k; ++j2)
          if ((int)score(ri[j2]) == cj)
            v += column_weight(rd[j2], eps, pad_dist);
        if (v > best_v || (v == best_v && cj < best_c)) {
          best_v = v;
          best_c = cj;
        }
      }
      o = (float)best_c;
    }
    if (clip01) o = fminf(fmaxf(o, 0.f), 1.f);
    out[row] = o;
  }
}

template <int KC>
int launch(const float* sc, int c, const int* ids, const float* d2, int n,
           int k, int mode, int n_classes, int clip01, float eps,
           float pad_dist, const float* pre, const float* stats, int n_stats,
           float* o, cudaStream_t s) {
  int64_t blocks = ((int64_t)n + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)repro_sm_count() * 4;
  if (blocks > cap) blocks = cap;
  propagate_kernel<KC><<<(unsigned)blocks, THREADS, 0, s>>>(
      sc, c, ids, d2, n, k, mode, n_classes, clip01, eps, pad_dist, pre,
      stats, n_stats, o);
  return (int)cudaGetLastError();
}

}  // namespace

// rep_scores (c,) float32; topk_ids (n, k) int32; topk_d2 (n, k) float32,
// both at 16-byte aligned addresses; out (n,) float32.  In mode 1 (top1)
// the prescale is *prescale where prescale is not null, else computed on
// the card: top1_stats_kernel over n_stats blocks into stats (2 * n_stats
// float32 scratch) first, `strips` splitting its pairs of scores.  Needs
// n >= 1, k >= 1.
REPRO_EXPORT int propagate_launch(const void* rep_scores, int c,
                                  const void* topk_ids, const void* topk_d2,
                                  int n, int k, int mode, int n_classes,
                                  int clip01, float eps, float pad_dist,
                                  const void* prescale, void* stats,
                                  int n_stats, int strips, void* out,
                                  void* stream) {
  if (mode < MODE_NUMERIC || mode > MODE_CATEGORICAL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(rep_scores);
  const int* ids = static_cast<const int*>(topk_ids);
  const float* d2 = static_cast<const float*>(topk_d2);
  const float* pre = static_cast<const float*>(prescale);
  float* st = static_cast<float*>(stats);
  float* o = static_cast<float*>(out);
  if (mode == MODE_TOP1 && pre == nullptr) {
    if (st == nullptr || n_stats < 1 || strips < 1)
      return (int)cudaErrorInvalidValue;
    top1_stats_kernel<<<n_stats, THREADS, 0, s>>>(sc, c, strips, d2, n, k,
                                                  st);
  }
  // the main path's k in registers; any other k in the generic loop
  if (k == 8)
    return launch<8>(sc, c, ids, d2, n, k, mode, n_classes, clip01, eps,
                     pad_dist, pre, st, n_stats, o, s);
  return launch<0>(sc, c, ids, d2, n, k, mode, n_classes, clip01, eps,
                   pad_dist, pre, st, n_stats, o, s);
}
