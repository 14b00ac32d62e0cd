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
// prescale is a global reduction over real rows, computed by the wrapper
// around the kernel as in the reference.
//
// Bound on an H100: bytes.  It reads topk_ids and topk_d2 (64 MB at
// N = 1M, k = 8) and writes 4 MB, ~20 us at 3.35 TB/s; the arithmetic is a
// few operations per byte.  Design: one thread per record over a grid sized
// to the SMs, rep scores staged once per block in shared memory (28 KB at
// C = 7,000), gathered directly by id.  The TPU kernel's one-hot gathers over
// a (rows, C) grid existed because the TPU has no dynamic gather; Hopper
// does.  The categorical vote needs no per-class array: a class's vote is
// the sum of the weights of the columns holding it, O(k^2) per record.
#include "common.cuh"

namespace {

enum { MODE_NUMERIC = 0, MODE_TOP1 = 1, MODE_CATEGORICAL = 2 };

constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 200 * 1024;

__device__ __forceinline__ float column_weight(float d2, float eps,
                                               float pad_dist) {
  return d2 >= pad_dist ? 0.f : 1.f / (sqrtf(fmaxf(d2, 0.f)) + eps);
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
propagate_kernel(const float* __restrict__ scores, int c,
                 const int* __restrict__ ids, const float* __restrict__ d2,
                 int n, int k, int mode, int n_classes, int clip01, float eps,
                 float pad_dist, const float* __restrict__ prescale,
                 float* __restrict__ out) {
  extern __shared__ float s_scores[];
  if (SMEM) {
    for (int j = threadIdx.x; j < c; j += blockDim.x) s_scores[j] = scores[j];
    __syncthreads();
  }
  const float* sc = SMEM ? s_scores : scores;
  const float pre = mode == MODE_TOP1 ? *prescale : 0.f;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < n;
       row += (int64_t)gridDim.x * blockDim.x) {
    const int* ri = ids + row * k;
    const float* rd = d2 + row * k;
    float o;
    if (mode == MODE_NUMERIC) {
      float num = 0.f, den = 0.f;
      for (int j = 0; j < k; ++j) {
        const float w = column_weight(rd[j], eps, pad_dist);
        const int id = ri[j];
        const float s = (unsigned)id < (unsigned)c ? sc[id] : 0.f;
        num += w * s;
        den += w;
      }
      o = num / den;
    } else if (mode == MODE_TOP1) {
      const int id = ri[0];
      const float base = (unsigned)id < (unsigned)c ? sc[id] : 0.f;
      o = base - pre * sqrtf(fmaxf(rd[0], 0.f));
    } else {
      float best_v = 0.f;
      int best_c = 0;  // all-zero votes -> class 0, like argmax
      for (int j = 0; j < k; ++j) {
        const int idj = ri[j];
        const int cj = (unsigned)idj < (unsigned)c ? (int)sc[idj] : 0;
        if (cj < 0 || cj >= n_classes) continue;
        float v = 0.f;
        for (int j2 = 0; j2 < k; ++j2) {
          const int id2 = ri[j2];
          const int c2 = (unsigned)id2 < (unsigned)c ? (int)sc[id2] : 0;
          if (c2 == cj) v += column_weight(rd[j2], eps, pad_dist);
        }
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

}  // namespace

// rep_scores (c,) float32; topk_ids (n, k) int32; topk_d2 (n, k) float32;
// prescale (1,) float32, read in mode 1 (top1) only; out (n,) float32.
// Needs n >= 1, k >= 1.
REPRO_EXPORT int propagate_launch(const void* rep_scores, int c,
                                  const void* topk_ids, const void* topk_d2,
                                  int n, int k, int mode, int n_classes,
                                  int clip01, float eps, float pad_dist,
                                  const void* prescale, void* out,
                                  void* stream) {
  if (mode < MODE_NUMERIC || mode > MODE_CATEGORICAL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(rep_scores);
  const int* ids = static_cast<const int*>(topk_ids);
  const float* d2 = static_cast<const float*>(topk_d2);
  const float* pre = static_cast<const float*>(prescale);
  float* o = static_cast<float*>(out);
  int64_t blocks = ((int64_t)n + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)repro_sm_count() * 4;
  if (blocks > cap) blocks = cap;
  const size_t smem = (size_t)c * sizeof(float);
  if (smem <= MAX_SMEM) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          propagate_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    propagate_kernel<true><<<(unsigned)blocks, THREADS, smem, s>>>(
        sc, c, ids, d2, n, k, mode, n_classes, clip01, eps, pad_dist, pre, o);
  } else {
    propagate_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        sc, c, ids, d2, n, k, mode, n_classes, clip01, eps, pad_dist, pre, o);
  }
  return (int)cudaGetLastError();
}
