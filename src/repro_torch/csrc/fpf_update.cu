// One furthest-point-first step: the squared distance from every record to
// the newest representative, its min with the running min_d2 (written as
// new_min), and the global (max, argmax) of new_min, lowest index on ties.
//
// Replaces: fpf_update_pallas in src/repro/kernels/fpf_update/kernel.py (its
// _kernel, plus the argmax over block partials done by XLA around it).  The
// distance keeps the reference's (x - rep)^2 form (fpf_update/ref.py:14).
//
// Bound on an H100: bytes.  Each step reads the (N, D) embeddings and min_d2
// and writes new_min: 512 MB + 8 MB at N = 1M, D = 128 float32, ~0.155 ms
// at 3.35 TB/s; the embeddings exceed the 50 MB L2, so every step streams
// them from device memory.  The design makes that single pass and nothing
// else: one warp per record (coalesced 128-byte loads, a shuffle sum), the
// rep in shared memory, and the argmax folded into the same pass as a 64-bit
// key (order-preserving value bits << 32 | ~index) reduced per block and
// combined with one atomicMax per block.  A one-thread kernel unpacks the key
// into (idx, val) on the device, so the FPF loop never waits on the host.
#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned int order_bits(float v) {
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

template <typename T>
__global__ void __launch_bounds__(256)
fpf_update_kernel(const T* __restrict__ x, const T* __restrict__ rep,
                  const float* __restrict__ min_d2, int n, int d,
                  float* __restrict__ new_min,
                  unsigned long long* __restrict__ best) {
  extern __shared__ float srep[];
  __shared__ unsigned long long warp_best[32];
  for (int j = threadIdx.x; j < d; j += blockDim.x) srep[j] = to_f32(rep[j]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_block = blockDim.x >> 5;
  unsigned long long mine = 0ull;
  for (int64_t row = (int64_t)blockIdx.x * warps_per_block + warp; row < n;
       row += (int64_t)gridDim.x * warps_per_block) {
    const T* p = x + row * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float diff = to_f32(p[j]) - srep[j];
      s = fmaf(diff, diff, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float m = fminf(min_d2[row], s);
    if (lane == 0) new_min[row] = m;
    const unsigned long long key =
        ((unsigned long long)order_bits(m) << 32) |
        (unsigned long long)(0xffffffffu - (unsigned int)row);
    mine = key > mine ? key : mine;
  }
  if (lane == 0) warp_best[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long b = warp_best[0];
    for (int w = 1; w < warps_per_block; ++w)
      b = warp_best[w] > b ? warp_best[w] : b;
    atomicMax(best, b);
  }
}

__global__ void fpf_finalize_kernel(const unsigned long long* __restrict__ best,
                                    int* __restrict__ idx,
                                    float* __restrict__ val) {
  const unsigned long long key = *best;
  *idx = (int)(0xffffffffu - (unsigned int)(key & 0xffffffffull));
  *val = from_order_bits((unsigned int)(key >> 32));
}

template <typename T>
int launch(const void* x, const void* rep, const float* min_d2, int n, int d,
           float* new_min, unsigned long long* best, int* idx, float* val,
           cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(best, 0, sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  constexpr int threads = 256;
  const int rows_per_block = threads / 32;
  int64_t blocks = ((int64_t)n + rows_per_block - 1) / rows_per_block;
  const int64_t cap = (int64_t)repro_sm_count() * 8;
  if (blocks > cap) blocks = cap;
  fpf_update_kernel<T><<<(unsigned)blocks, threads, d * sizeof(float), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(rep), min_d2, n, d,
      new_min, best);
  fpf_finalize_kernel<<<1, 1, 0, s>>>(best, idx, val);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d) row-major and rep (d,) in `dtype`; min_d2 and new_min (n,)
// float32; best one uint64 of scratch; idx (1,) int32 and val (1,) float32.
// Needs n >= 1 and d <= 12288 (rep in 48 KB of shared memory).
REPRO_EXPORT int fpf_update_launch(const void* x, const void* rep,
                                   const void* min_d2, int n, int d,
                                   int dtype, void* new_min, void* best,
                                   void* idx, void* val, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(min_d2);
  float* nm = static_cast<float*>(new_min);
  unsigned long long* b = static_cast<unsigned long long*>(best);
  int* i = static_cast<int*>(idx);
  float* v = static_cast<float*>(val);
  switch (dtype) {
    case REPRO_F32: return launch<float>(x, rep, m, n, d, nm, b, i, v, s);
    case REPRO_F16: return launch<__half>(x, rep, m, n, d, nm, b, i, v, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(x, rep, m, n, d, nm, b, i, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
