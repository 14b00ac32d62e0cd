// Forward attention with an online softmax: grouped-query heads, a causal
// mask, a sliding window and a logical key count, the output in q's dtype
// with float32 softmax and accumulation.
//
// Replaces: flash_attention_pallas in
// src/repro/kernels/flash_attention/kernel.py (its _kernel, together with the
// layout change, head-dim padding and scale correction of the wrapper in
// kernels/flash_attention/ops.py).  It computes flash_attention_ref
// (flash_attention/ref.py) at the logical head dim: scale 1/sqrt(hd), query
// head h on kv head h / (H / Hk), a key kept where kpos < skv, qpos >= kpos
// (causal) and qpos - kpos < window (window > 0), positions from 0 on both
// sides, masked scores at the reference's finite NEG_INF so that a row with
// no key left averages every value, as the reference does.
//
// Bound on an H100: operations.  A (query, key) pair costs 4 * hd flops; at
// the h2o-danube-3-4b prefill (S = 32,768, window 4,096, 32 heads, hd 120)
// one launch needs ~1.9e12 flops against ~0.6 GB of q, k, v and out, so it is
// compute-bound by three orders of magnitude.  This first version runs on
// the CUDA cores in float32 (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16 via wgmma): that is later work.  What the design does:
// - scores and probabilities never leave the SM: a 64 x 64 score tile lives
//   in registers (4 x 4 per thread), the probabilities pass through shared
//   memory once for the P.V product;
// - it visits only the key tiles that meet the causal/window band of its
//   query tile (the Pallas grid visits every kv block and masks), about 1/8
//   of the work at S = 32,768 with window 4,096; a tile that holds a row
//   with no key left visits every key, so that row averages them all;
// - the TPU grid's sequential kv axis, which carried m/l/acc in VMEM
//   scratch, is a loop inside the block; the accumulators stay in registers;
// - q, k, v and out are read in place in the (B, S, H, hd) layout: no
//   transposes, no padding of hd or of the sequence; any hd <= 128 (120
//   included) is a loop bound, and the tiles are 64 or 128 columns wide.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: thread (tr, tc) owns rows 4tr..4tr+3
                              // and keys 4tc..4tc+3 of a score tile
constexpr int LDT = BQ + 4;   // leading dim of transposed tiles (float4-aligned)
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // ref.py's mask value
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int HDP>
__host__ __device__ constexpr int kt_rows() { return HDP > BK ? HDP : BK; }

template <int HDP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (HDP * LDT + kt_rows<HDP>() * LDT + BK * HDP);
}

// One block per (batch * head, query tile).  HDP is the head dim rounded up
// to 64 or 128: the width of the V tile and of each thread's output row.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s, int skv,
                 int h, int hk, int hd, int causal, int window,
                 float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                   // [hd][LDT]  Q tile, transposed, scaled
  float* k_t = q_t + HDP * LDT;        // [hd][LDT]  K tile, transposed; then
  float* p_t = k_t;                    // [BK][LDT]  P tile, transposed
  float* v_s = k_t + kt_rows<HDP>() * LDT;  // [BK][HDP] V tile, 0 past hd

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int kvh = hi / (h / hk);
  const int q0 = blockIdx.y * BQ;
  const int q_rows = min(BQ, s - q0);
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int64_t q_step = (int64_t)h * hd;      // between positions
  const int64_t kv_step = (int64_t)hk * hd;
  const T* qb = q + ((int64_t)bi * s * h + hi) * hd;
  T* ob = o + ((int64_t)bi * s * h + hi) * hd;
  const T* kb = k + ((int64_t)bi * skv * hk + kvh) * hd;
  const T* vb = v + ((int64_t)bi * skv * hk + kvh) * hd;

  // scores come out in the log2 domain: q * (log2 e / sqrt(hd))
  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    q_t[d * LDT + r] =
        r < q_rows ? to_f32(qb[(q0 + r) * q_step + d]) * scale_log2 : 0.f;
  }

  // the key range this query tile needs
  const int q_last = q0 + q_rows - 1;
  int kv_lo = 0, kv_hi = causal ? min(skv, q_last + 1) : skv;
  if (window > 0) {
    if ((int64_t)q_last >= (int64_t)skv + window - 1) {
      kv_hi = skv;                     // a row with no key left: visit all
    } else {
      kv_lo = max(0, q0 - window + 1);
    }
  }

  float m_i[4], l_i[4], acc[4][HDP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) acc[i][j] = 0.f;
  }
  const bool live = tr * 4 < q_rows;   // uniform over each half warp

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    const int kn = min(BK, skv - k0);
    __syncthreads();                   // the last tile's P and V are read
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int c = i / hd, d = i - c * hd;
      k_t[d * LDT + c] =
          c < kn ? to_f32(kb[(int64_t)(k0 + c) * kv_step + d]) : 0.f;
    }
    for (int i = tid; i < BK * HDP; i += THREADS) {
      const int c = i / HDP, d = i % HDP;
      v_s[i] = (c < kn && d < hd)
                   ? to_f32(vb[(int64_t)(k0 + c) * kv_step + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    if (live) {
#pragma unroll 4
      for (int d = 0; d < hd; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(q_t + d * LDT + tr * 4);
        const float4 b = *reinterpret_cast<const float4*>(k_t + d * LDT + tc * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
      }
    }

    // mask, then the online softmax of each row; a row's 64 keys sit on
    // the 16 threads of one half warp, reduced by xor shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc * 4 + j, kp = k0 + c;
        float x = sc[i][j];
        if (c >= kn) {
          x = __uint_as_float(0xff800000u);  // -inf past the last key: weight 0
        } else if ((causal && qp < kp) || (window > 0 && qp - kp >= window)) {
          x = NEG_INF;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = exp2f(sc[i][j] - m_new);
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();                   // every read of the K tile is done
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (tc * 4 + j) * LDT + tr * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

    if (live) {
      for (int c = 0; c < kn; ++c) {
        const float4 p = *reinterpret_cast<const float4*>(p_t + c * LDT + tr * 4);
        const float* vr = v_s + c * HDP + tc;
#pragma unroll
        for (int j = 0; j < HDP / 16; ++j) {
          const float x = vr[16 * j];
          acc[0][j] = fmaf(p.x, x, acc[0][j]);
          acc[1][j] = fmaf(p.y, x, acc[1][j]);
          acc[2][j] = fmaf(p.z, x, acc[2][j]);
          acc[3][j] = fmaf(p.w, x, acc[3][j]);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= q_rows) break;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    T* orow = ob + (q0 + r) * q_step;
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      const int d = tc + 16 * j;
      if (d < hd) orow[d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int skv, int h, int hk, int hd, int causal, int window,
           cudaStream_t st) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(b * h), (unsigned)((s + BQ - 1) / BQ));
  const float scale_log2 = LOG2E / sqrtf((float)hd);
  flash_fwd_kernel<T, HDP><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, skv, h, hk, hd, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int b,
              int s, int skv, int h, int hk, int hd, int causal, int window,
              cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, b, s, skv, h, hk, hd, causal, window, st);
  return launch<T, 128>(q, k, v, o, b, s, skv, h, hk, hd, causal, window, st);
}

}  // namespace

// q and o (b, s, h, hd), k and v (b, skv, hk, hd), contiguous, in `dtype`
// (float32 or bfloat16, the TPU kernel's two input types).
// Needs 1 <= hd <= 128, h a multiple of hk, s, skv >= 1 and
// ceil(s / 64) <= 65535.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int b, int s,
                                        int skv, int h, int hk, int hd,
                                        int causal, int window, int dtype,
                                        void* stream) {
  if (hd < 1 || hd > 128 || hk < 1 || h % hk || s < 1 || skv < 1 || b < 1 ||
      (s + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case REPRO_F32:
      return launch_hd<float>(q, k, v, o, b, s, skv, h, hk, hd, causal,
                              window, st);
    case REPRO_BF16:
      return launch_hd<__nv_bfloat16>(q, k, v, o, b, s, skv, h, hk, hd, causal,
                                      window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
