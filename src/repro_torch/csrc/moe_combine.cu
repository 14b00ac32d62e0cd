// The dropless MoE's combine: out[t] = sum_j weights[t, j] * y[pos[t, j]]
// over a token's k choices, in float32 in choice order j = 0 .. k-1, each
// product rounded to float32 before it is added, rounded once to y's type.
// y holds the experts' output rows in expert order (the sort of the T k
// (token, choice) pairs by expert), pos[t, j] the row of y that holds
// (t, j): the inverse of the sort's order, made here by one small scatter.
//
// Replaces: no Pallas kernel.  The JAX package combines by an einsum over
// its capacity buffers, which XLA fuses.  The port ran five eager passes
// (the weights gathered into expert order, the rows times their weights
// written in float32, a zeroed float32 sum, a scatter-add by atomics, a
// cast back), which at OLMoE-1B-7B-0924's prefill of 32,768 tokens x 8
// choices x 2,048 move ~6 GB a layer where one read of the 1.07 GB of bf16
// rows and one write of the 134 MB of outputs are the work.
//
// Bound on an H100: bytes (two operations an element against 2 k + 2 bytes
// moved in bf16).  The design makes the one read and the one write and
// nothing else: each thread owns 16-byte chunks of a token's output row,
// issues the k 16-byte loads of its chunk (k at a time, up to eight) before
// it sums any of them, keeps the sum in registers and writes the chunk once.
// A block's tokens read their k positions and weights into shared memory
// once.  Threads a token (a power of two: enough for one chunk each, at
// most a block) and tokens a block follow from the row's width and type
// alone (and k, which bounds the shared memory); no atomics, so the result
// is the same every run.
#include "common.cuh"

namespace {

constexpr int BLOCK_THREADS = 256;
// rows of y a thread loads before it sums them
constexpr int BATCH = 8;
// the largest k
constexpr int MAX_K = 32;
// (position, weight) pairs a block stages at most: 32 KiB
constexpr int MAX_STAGED = 4096;

__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f,
                                       __nv_bfloat16) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, __half) {
  const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
  }
}

__device__ __forceinline__ unsigned int pair(unsigned short lo,
                                             unsigned short hi) {
  return (unsigned int)lo | ((unsigned int)hi << 16);
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pair(__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])),
                __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])));
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 pack(const float* f, __half) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pair(__half_as_ushort(__float2half_rn(f[2 * i])),
                __half_as_ushort(__float2half_rn(f[2 * i + 1])));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// pos[order[i]] = i: where each (token, choice) pair lies in expert order.
__global__ void moe_combine_positions_kernel(const int64_t* __restrict__ order,
                                             int* __restrict__ pos,
                                             int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) pos[order[i]] = (int)i;
}

// y (tokens k, d) and out (tokens, d) contiguous, pos and weights
// (tokens, k); `tpr` threads a token, blockDim.x / tpr tokens a block.
template <typename T>
__global__ void __launch_bounds__(BLOCK_THREADS)
moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ pos,
                   const float* __restrict__ weights, T* __restrict__ out,
                   int64_t tokens, int k, int d, int tpr) {
  constexpr int VT = 16 / sizeof(T);       // elements of a chunk
  extern __shared__ unsigned char staged[];
  const int per_block = blockDim.x / tpr;
  int* s_pos = reinterpret_cast<int*>(staged);
  float* s_w = reinterpret_cast<float*>(s_pos + per_block * k);
  const int64_t first = (int64_t)blockIdx.x * per_block;
  const int here =
      (tokens - first < per_block ? (int)(tokens - first) : per_block) * k;
  for (int i = threadIdx.x; i < here; i += blockDim.x) {
    s_pos[i] = pos[first * k + i];
    s_w[i] = weights[first * k + i];
  }
  __syncthreads();
  const int local = threadIdx.x / tpr;
  const int64_t t = first + local;
  if (t >= tokens) return;
  const int chunks = d / VT;
  const int* tp = s_pos + local * k;
  const float* tw = s_w + local * k;
  const uint4* rows = reinterpret_cast<const uint4*>(y);
  uint4* dst = reinterpret_cast<uint4*>(out) + t * chunks;
  for (int c = threadIdx.x % tpr; c < chunks; c += tpr) {
    float acc[VT];
#pragma unroll
    for (int e = 0; e < VT; ++e) acc[e] = 0.f;
    for (int j0 = 0; j0 < k; j0 += BATCH) {
      uint4 v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
        if (j0 + i < k) v[i] = __ldcs(rows + (int64_t)tp[j0 + i] * chunks + c);
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        if (j0 + i < k) {
          float f[VT];
          unpack(v[i], f, T());
          const float w = tw[j0 + i];
#pragma unroll
          for (int e = 0; e < VT; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(f[e], w));
        }
      }
    }
    dst[c] = pack(acc, T());
  }
}

template <typename T>
int launch(const void* y, const int64_t* order, const float* weights,
           int* pos, void* out, int64_t tokens, int k, int d,
           cudaStream_t s) {
  constexpr int VT = 16 / sizeof(T);
  if (tokens <= 0 || k < 1 || k > MAX_K || d <= 0 || d % VT ||
      tokens * k >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t n = tokens * k;
  moe_combine_positions_kernel<<<(unsigned)((n + BLOCK_THREADS - 1) /
                                            BLOCK_THREADS),
                                 BLOCK_THREADS, 0, s>>>(order, pos, n);
  const int chunks = d / VT;
  int tpr = 1;
  while (tpr < BLOCK_THREADS && tpr < chunks) tpr <<= 1;
  int per_block = BLOCK_THREADS / tpr;
  while (per_block > 1 && per_block * k > MAX_STAGED) per_block >>= 1;
  // few tokens: fewer a block, whole warps still
  const int per_warp = tpr >= 32 ? 1 : 32 / tpr;
  const int64_t needed = (tokens + per_warp - 1) / per_warp * per_warp;
  if (per_block > needed) per_block = (int)needed;
  const int64_t blocks = (tokens + per_block - 1) / per_block;
  if (blocks >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)per_block * k * (sizeof(int) + sizeof(float));
  moe_combine_kernel<T><<<(unsigned)blocks, (unsigned)(per_block * tpr), smem,
                          s>>>(static_cast<const T*>(y), pos, weights,
                               static_cast<T*>(out), tokens, k, d, tpr);
  return (int)cudaGetLastError();
}

}  // namespace

// y (tokens k, d) in `dtype`, contiguous at a 16-byte aligned address;
// order (tokens k,) int64, a permutation of 0 .. tokens k - 1 (the sort's:
// row i of y is pair order[i]); weights (tokens, k) float32; pos
// (tokens k,) int32 scratch, written with the inverse of order; out
// (tokens, d) contiguous in `dtype`.  Needs d * itemsize a multiple of 16,
// 1 <= k <= 32 and tokens k < 2^31.
REPRO_EXPORT int moe_combine_launch(const void* y, const void* order,
                                    const void* weights, void* pos, void* out,
                                    long long tokens, int k, int d, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* o = static_cast<const int64_t*>(order);
  const float* w = static_cast<const float*>(weights);
  int* p = static_cast<int*>(pos);
  switch (dtype) {
    case REPRO_F32: return launch<float>(y, o, w, p, out, tokens, k, d, s);
    case REPRO_F16: return launch<__half>(y, o, w, p, out, tokens, k, d, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(y, o, w, p, out, tokens, k, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
