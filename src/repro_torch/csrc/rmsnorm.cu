// RMSNorm over the last dim, one pass: y = x * rsqrt(sum(x^2) / d + eps)
// * scale, in float32, rounded once to x's type.
//
// Replaces: no Pallas kernel.  The JAX package leaves its norm
// (src/repro/models/common.py rmsnorm) to XLA, which fuses it into one
// pass.  The port ran it eagerly (a cast up, a square, a mean, an add, an
// rsqrt, two products and a cast down, each a kernel of its own), which
// moves ~10x the bytes the function needs: at phi3-medium-14b's prefill,
// rows of 5,120 bf16 over 32,768 tokens, ~6.7 GB a norm where one read of x
// and one write of y are 0.67 GB.
//
// Bound on an H100: bytes (four float32 operations an element against two
// to eight bytes moved).  The design makes the one read and the one write
// and nothing else: each thread holds its 16-byte chunks of the row in
// registers from the load to the store, the sum of squares is reduced in
// float32 by warp shuffles and, where a row spans several warps, through
// shared memory, and the row is written as 16-byte vectors.  Threads a row
// (a power of two: enough for about four chunks each, so a narrow row
// takes part of a warp and every lane loads) and rows a block follow from
// the row's width and type alone, so a row's sum is taken in the same order
// whatever the number of rows; only a launch of few rows takes fewer rows a
// block.
// The arithmetic is the plain version's (kernels/rmsnorm/ops.py) in its
// order: each square rounded, the sum divided by d, eps added, rsqrtf, the
// product with the inverse, then with the scale; only the order of the sum
// differs.
#include <type_traits>

#include "common.cuh"

namespace {

// 16-byte chunks of a row a thread holds at most
constexpr int MAX_CHUNKS = 8;
// chunks a thread aims at
constexpr int TARGET_CHUNKS = 4;
constexpr int MAX_THREADS = 1024;
// threads a block aims at when rows are narrow
constexpr int BLOCK_THREADS = 256;
constexpr int WARP = 32;

__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The elements of a 16-byte chunk of T as floats (exact).
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
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
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

// A 16-byte chunk of T from floats, each rounded to nearest even.
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned int pair(unsigned short lo,
                                             unsigned short hi) {
  return (unsigned int)lo | ((unsigned int)hi << 16);
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

// x (rows, d) with row stride `stride` elements, scale (d,), y (rows, d)
// contiguous; `tpr` threads a row, blockDim.x / tpr rows a block.
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, int64_t rows, int d, int64_t stride,
               int tpr, float eps) {
  constexpr int VT = 16 / sizeof(T);       // elements of a chunk
  __shared__ float partial[MAX_THREADS / WARP];
  const int chunks = d / VT;
  const int lane = threadIdx.x & (tpr - 1);
  const int local_row = threadIdx.x / tpr;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / tpr) + local_row;
  const bool valid = row < rows;           // no early exit: all shuffle
  const uint4* src =
      reinterpret_cast<const uint4*>(x + (valid ? row : 0) * stride);

  uint4 v[MAX_CHUNKS];
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int j = lane + i * tpr;
    if (valid && j < chunks) v[i] = src[j];
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int j = lane + i * tpr;
    if (valid && j < chunks) {
      float f[VT];
      unpack(v[i], f, T());
#pragma unroll
      for (int k = 0; k < VT; ++k) ss = __fadd_rn(ss, __fmul_rn(f[k], f[k]));
    }
  }
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1)   // within the row's lanes
    if (o < tpr) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > WARP) {                        // uniform over the block
    const int warps = tpr / WARP;
    if ((threadIdx.x & (WARP - 1)) == 0) partial[threadIdx.x / WARP] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < warps; ++w) ss += partial[local_row * warps + w];
  }
  if (!valid) return;
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)d), eps));

  uint4* dst = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int j = lane + i * tpr;
    if (j < chunks) {
      float f[VT], s[VT];
      unpack(v[i], f, T());
      if constexpr (std::is_same<S, T>::value) {
        unpack(reinterpret_cast<const uint4*>(scale)[j], s, T());
      } else {
#pragma unroll
        for (int k = 0; k < VT; ++k) s[k] = to_f32(scale[j * VT + k]);
      }
#pragma unroll
      for (int k = 0; k < VT; ++k) f[k] = __fmul_rn(__fmul_rn(f[k], r), s[k]);
      dst[j] = pack(f, T());
    }
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int64_t rows, int d,
           int64_t stride, float eps, cudaStream_t s) {
  constexpr int VT = 16 / sizeof(T);
  if (rows <= 0 || d <= 0 || d % VT || stride % VT)
    return (int)cudaErrorInvalidValue;
  const int chunks = d / VT;
  int tpr = 1;
  while (tpr < MAX_THREADS && tpr * TARGET_CHUNKS < chunks) tpr <<= 1;
  if (tpr * MAX_CHUNKS < chunks) return (int)cudaErrorInvalidValue;
  int64_t rows_per_block = tpr >= BLOCK_THREADS ? 1 : BLOCK_THREADS / tpr;
  // few rows: fewer rows a block, whole warps still
  const int64_t per_warp = tpr >= WARP ? 1 : WARP / tpr;
  const int64_t needed = (rows + per_warp - 1) / per_warp * per_warp;
  if (rows_per_block > needed) rows_per_block = needed;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T, S><<<(unsigned)blocks, (unsigned)(rows_per_block * tpr),
                         0, s>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rows, d, stride, tpr, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scale(const void* x, const void* scale, void* y, int64_t rows,
                 int d, int64_t stride, int scale_dtype, float eps,
                 cudaStream_t s) {
  switch (scale_dtype) {
    case REPRO_F32: return launch<T, float>(x, scale, y, rows, d, stride, eps, s);
    case REPRO_F16: return launch<T, __half>(x, scale, y, rows, d, stride, eps, s);
    case REPRO_BF16:
      return launch<T, __nv_bfloat16>(x, scale, y, rows, d, stride, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (rows, d) in `dtype` with row stride `stride` elements (the last dim
// contiguous; x and each row at a 16-byte aligned address), scale (d,) in
// `scale_dtype` (16-byte aligned), y (rows, d) contiguous in `dtype`.
// Needs d * itemsize a multiple of 16 and at most 1,024 threads of eight
// 16-byte chunks a row (128 KiB).
REPRO_EXPORT int rmsnorm_launch(const void* x, const void* scale, void* y,
                                long long rows, int d, long long stride,
                                int dtype, int scale_dtype, float eps,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch_scale<float>(x, scale, y, rows, d, stride, scale_dtype,
                                 eps, s);
    case REPRO_F16:
      return launch_scale<__half>(x, scale, y, rows, d, stride, scale_dtype,
                                  eps, s);
    case REPRO_BF16:
      return launch_scale<__nv_bfloat16>(x, scale, y, rows, d, stride,
                                         scale_dtype, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
