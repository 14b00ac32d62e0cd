// Forward attention with an online softmax: grouped-query heads, a causal
// mask, a sliding window and a logical key count, the output in q's dtype
// with float32 softmax statistics.
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
// Three paths, chosen by the wrapper from shape and dtype alone
// (ops.flash_route), all reading q, k, v and writing out in the (B, S, H, hd)
// layout in place:
//
// - tc (bf16, hd % 8 == 0, hd <= 128, longer than the short path takes):
//   bound by operations (4 * hd flops per kept (query, key) pair; the
//   h2o-danube-3-4b prefill needs ~1.9e12 per launch against ~0.6 GB).  Both
//   products run on the tensor cores with wgmma: S = Q K^T from shared
//   memory, O += P V with P in registers as bf16 (the JAX package's XLA
//   attention also rounds P to v's dtype).  A block owns 128 query rows of
//   one (batch, head), two consumer warpgroups of 64 rows each, each
//   running QK, softmax, PV per key tile, so that one's softmax overlaps
//   the other's products; one producer warp (of a third warpgroup that
//   hands its registers to the consumers) keeps a ring of K/V tiles in
//   flight with TMA and mbarriers.  4-D tensor maps over (hd, heads, S, B)
//   put the GQA head and the batch in TMA coordinates, zero-fill hd up to
//   the tile's 64 or 128 columns (hd 120 needs no copy) and keys past S (no
//   read of the next batch's rows).
// - short (S and Skv <= 32, the transformer embedder's S = 8): bound by
//   bytes.  A block stages whole batch elements (q, k, v rows are contiguous
//   there) into shared memory with 16-byte copies, one warp computes one
//   (batch, head) problem in registers, and the block writes the output back
//   with 16-byte stores.
// - simt (everything else, float32 included, which stays exact float32):
//   64 x 64 tiles on the CUDA cores, scores and probabilities in registers
//   and shared memory.
//
// The tc and simt paths visit only the key tiles that meet the causal/window
// band of their query tile (the Pallas grid visits every kv block and
// masks); a tile that holds a row with no key left visits every key, so that
// row averages them all.  The TPU grid's sequential kv axis, which carried
// m/l/acc in VMEM scratch, is a loop inside the block.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // ref.py's mask value
constexpr float LOG2E = 1.4426950408889634f;

enum { ROUTE_SIMT = 0, ROUTE_TC = 1, ROUTE_SHORT = 2 };

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 2^x by the special-function unit (2 ulp; -inf and underflow give 0):
// the tc path's softmax, whose probabilities are rounded to bf16 anyway.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The keys [lo, hi) that query rows q_first..q_last need: the causal/window
// band, or every key when a row has none left in it.
__device__ __forceinline__ void key_range(int q_first, int q_last, int skv,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = 0;
  hi = causal ? min(skv, q_last + 1) : skv;
  if (window > 0) {
    if ((int64_t)q_last >= (int64_t)skv + window - 1) {
      hi = skv;                        // a row with no key left: visit all
    } else {
      lo = max(0, q_first - window + 1);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// simt: float32 arithmetic on the CUDA cores, any input type
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16: thread (tr, tc) owns rows 4tr..4tr+3
                              // and keys 4tc..4tc+3 of a score tile
constexpr int LDT = BQ + 4;   // leading dim of transposed tiles (float4-aligned)
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

  int kv_lo, kv_hi;
  key_range(q0, q0 + q_rows - 1, skv, causal, window, kv_lo, kv_hi);

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

}  // namespace simt

// ---------------------------------------------------------------------------
// tc: bf16 on the tensor cores (wgmma, TMA)
// ---------------------------------------------------------------------------
namespace tc {

using hopper::smem_u32;

constexpr int BM = 128;               // query rows per block
constexpr int BN = 128;               // keys per tile
constexpr int STAGES = 2;             // K/V tiles in flight
constexpr int CONSUMER_WARPS = 8;     // two warpgroups of 64 query rows each
// + a producer warpgroup, of which one warp issues the loads: registers are
// handed out by warpgroup, 168 a thread at launch (65,536 / 384), and
// setmaxnreg moves them from the producer (40) to the consumers (232)
constexpr int THREADS = 32 * (CONSUMER_WARPS + 4);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BOX = 128 * 128;        // one TMA box: 128 rows x 64 bf16 columns

// Shared memory (bytes from a 1,024-aligned base): Q, then per stage K and V.
// Each tile is HDP / 64 boxes of 128 rows x 128 bytes, swizzled by TMA.
template <int HDP>
struct Layout {
  static constexpr int TILE = HDP / 64 * BOX;
  static constexpr int Q = 0;
  __host__ __device__ static constexpr int k(int st) {
    return TILE * (1 + 2 * st);
  }
  __host__ __device__ static constexpr int v(int st) {
    return TILE * (2 + 2 * st);
  }
  static constexpr int BYTES = TILE * (1 + 2 * STAGES) + 1024;  // + alignment
};

// Masks a score tile held in the wgmma accumulator layout: keys from skv on
// get -inf (weight 0), keys outside the causal/window band the reference's
// NEG_INF.  c0 is the key of this thread's first column, qa its first row
// (the second is qa + 8).  Bounds become offsets from c0, so each score
// compares its compile-time column with a few registers.
template <int N>
__device__ __forceinline__ void mask_tile(float (&sc)[N], int c0, int qa,
                                          int skv, int causal, int window) {
  const int end = skv - c0;
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qa + 8 * r;
    hi[r] = causal ? qp + 1 - c0 : INT_MAX;              // kp <= qp
    lo[r] = window > 0 ? qp - window + 1 - c0 : INT_MIN;  // qp - kp < window
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int c = 8 * (x / 4) + (x & 1), r = (x >> 1) & 1;
    if (c >= end) {
      sc[x] = __uint_as_float(0xff800000u);
    } else if (c >= hi[r] || c < lo[r]) {
      sc[x] = NEG_INF;
    }
  }
}

// The block's query tile, its key range and its shared memory: the ring of
// K/V stages with a full barrier per tensor and an empty barrier per stage.
struct Ring {
  uint32_t base;                     // 1,024-aligned start of the tiles
  uint32_t q_full, full_k, full_v, empty;   // mbarriers, + 8 * stage
  int q0, kv_lo, n_tiles;
};

// One thread of the producer warpgroup: Q once, then K and V tiles into the
// ring, a stage at a time once the consumers have released it.
template <int HDP>
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int hi,
                                        int kvh, int bi) {
  using L = Layout<HDP>;
  constexpr int BOXES = HDP / 64;
  hopper::mbar_arrive_expect_tx(ring.q_full, L::TILE);
  for (int x = 0; x < BOXES; ++x)
    hopper::tma_load_4d(ring.base + L::Q + x * BOX, tm_q, 64 * x, hi,
                        ring.q0, bi, ring.q_full);
  for (int i = 0; i < ring.n_tiles; ++i) {
    const int st = i % STAGES, k0 = ring.kv_lo + i * BN;
    if (i >= STAGES)
      hopper::mbar_wait(ring.empty + 8 * st, ((i / STAGES) + 1) & 1);
    hopper::mbar_arrive_expect_tx(ring.full_k + 8 * st, L::TILE);
    for (int x = 0; x < BOXES; ++x)
      hopper::tma_load_4d(ring.base + L::k(st) + x * BOX, tm_k, 64 * x, kvh,
                          k0, bi, ring.full_k + 8 * st);
    hopper::mbar_arrive_expect_tx(ring.full_v + 8 * st, L::TILE);
    for (int x = 0; x < BOXES; ++x)
      hopper::tma_load_4d(ring.base + L::v(st) + x * BOX, tm_v, 64 * x, kvh,
                          k0, bi, ring.full_v + 8 * st);
  }
}

// A consumer warpgroup: block rows 64 wg .. 64 wg + 63.  In the wgmma
// accumulator layout this thread holds rows ra and ra + 8, columns
// 8 j + 2 (lane % 4) + {0, 1} for j = 0 .. N / 8 - 1.
template <int HDP>
__device__ __forceinline__ void consume(const Ring& ring, int wg, int tid,
                                        __nv_bfloat16* __restrict__ o, int s,
                                        int skv, int h, int hi, int bi, int hd,
                                        int causal, int window,
                                        float scale_log2) {
  using L = Layout<HDP>;
  const uint32_t base = ring.base, full_k = ring.full_k;
  const uint32_t full_v = ring.full_v, empty = ring.empty;
  const int q0 = ring.q0, kv_lo = ring.kv_lo, n_tiles = ring.n_tiles;
  const int lane = tid % 32;
  const int ra = 64 * wg + 16 * (tid / 32 % 4) + lane / 4;
  const int qa = q0 + ra, qb = qa + 8;
  const int col0 = 2 * (lane % 4);
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  const uint32_t q_smem = base + L::Q + 64 * wg * 128;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HDP / 2];
#pragma unroll
  for (int x = 0; x < HDP / 2; ++x) acc[x] = 0.f;
  float sc[BN / 2];
#pragma unroll
  for (int x = 0; x < BN / 2; ++x) sc[x] = 0.f;

  hopper::mbar_wait(ring.q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES, k0 = kv_lo + i * BN;
    const uint32_t parity = (i / STAGES) & 1;

    // S = Q K^T: hd / 16 k-steps of 16 columns; a step moves 32 bytes
    // inside a 128-byte swizzled row, four steps fill a box
    hopper::mbar_wait(full_k + 8 * st, parity);
    hopper::fence_operands(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      hopper::wgmma_ss_m64n128(
          sc, hopper::make_desc_sw128(q_smem + off, 16, 1024),
          hopper::make_desc_sw128(base + L::k(st) + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operands(sc);

    // scores in the log2 domain; mask only tiles that cross the causal
    // diagonal, the window's far edge or the last key
    const bool edge = k0 + BN > skv || (causal && k0 + BN - 1 > wg_first) ||
                      (window > 0 && wg_last - k0 >= window);
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) sc[x] *= scale_log2;
    if (edge) mask_tile(sc, k0 + col0, qa, skv, causal, window);

    // online softmax: a row's 128 scores sit on the 4 threads of a quad
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < BN / 2; ++x)
      mn[(x >> 1) & 1] = fmaxf(mn[(x >> 1) & 1], sc[x]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = fast_exp2(m[r] - mn[r]);
      m[r] = mn[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) {
      sc[x] = fast_exp2(sc[x] - m[(x >> 1) & 1]);
      l[(x >> 1) & 1] += sc[x];
    }
#pragma unroll
    for (int x = 0; x < HDP / 2; ++x) acc[x] *= alpha[(x >> 1) & 1];

    // P as the A operand of the next product: the accumulator's pairs of
    // columns are the A fragment's pairs of k, 16 keys per k-step
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        __nv_bfloat162 two =
            __floats2bfloat162_rn(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        pa[kk][r] = *reinterpret_cast<uint32_t*>(&two);
      }
    }

    // O += P V: V (keys x hd) is MN-major, so the transpose bit is set; the
    // step between the two 64-column boxes is the descriptor's LBO
    hopper::mbar_wait(full_v + 8 * st, parity);
    hopper::fence_operands(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t dv =
          hopper::make_desc_sw128(base + L::v(st) + kk * 16 * 128, BOX, 1024);
      if constexpr (HDP == 128) {
        hopper::wgmma_rs_m64n128(acc, pa[kk], dv);
      } else {
        hopper::wgmma_rs_m64n64(acc, pa[kk], dv);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operands(acc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + 8 * st);
  }

  // normalise and store the columns below hd of the rows below s
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const int64_t row_step = (int64_t)h * hd;
  __nv_bfloat16* oa = o + ((int64_t)bi * s + qa) * row_step + (int64_t)hi * hd;
  __nv_bfloat16* ob = oa + 8 * row_step;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + col0;
    if (col < hd) {
      if (qa < s)
        *reinterpret_cast<__nv_bfloat162*>(oa + col) = __floats2bfloat162_rn(
            acc[4 * j] * l[0], acc[4 * j + 1] * l[0]);
      if (qb < s)
        *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
            acc[4 * j + 2] * l[1], acc[4 * j + 3] * l[1]);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int s, int skv, int h, int hk,
                int hd, int causal, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  Ring ring;
  ring.base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  ring.q_full = smem_u32(&bars[0]);
  ring.full_k = smem_u32(&bars[1]);
  ring.full_v = smem_u32(&bars[1 + STAGES]);
  ring.empty = smem_u32(&bars[1 + 2 * STAGES]);

  // grid.x walks query tiles (last first: the longest causal rows start
  // early), then heads, then the batch
  const int nq = (s + BM - 1) / BM;
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int bh = (int)(blockIdx.x / nq);
  const int hi = bh % h, bi = bh / h;
  ring.q0 = qt * BM;
  int kv_hi;
  key_range(ring.q0, min(ring.q0 + BM, s) - 1, skv, causal, window,
            ring.kv_lo, kv_hi);
  ring.n_tiles = (kv_hi - ring.kv_lo + BN - 1) / BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(ring.q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(ring.full_k + 8 * st, 1);
      hopper::mbar_init(ring.full_v + 8 * st, 1);
      hopper::mbar_init(ring.empty + 8 * st, CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup index, made warp-uniform for the compiler by the
  // shuffle: each side of the branch then keeps its own register budget
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == CONSUMER_WARPS / 4) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == CONSUMER_WARPS * 32)
      produce<HDP>(ring, &tm_q, &tm_k, &tm_v, hi, hi / (h / hk), bi);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    consume<HDP>(ring, wg, tid, o, s, skv, h, hi, bi, hd, causal, window,
                 scale_log2);
  }
}

// (hd, heads, seq, batch) bf16, innermost first; boxes of 64 columns x 1
// head x 128 rows x 1 batch with the 128-byte swizzle; zeros out of bounds.
static bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads,
                     int seq, int batch) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, BN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return hopper::encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int skv, int h, int hk, int hd, int causal, int window,
           cudaStream_t st) {
  if (hopper::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, hd, h, s, b) || !make_map(&mk, k, hd, hk, skv, b) ||
      !make_map(&mv, v, hd, hk, skv, b))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<HDP>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (int64_t)((s + BM - 1) / BM) * h * b;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_tc_kernel<HDP><<<(unsigned)blocks, THREADS, smem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s, skv, h, hk, hd, causal,
      window, LOG2E / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// short: S, Skv <= 32, whole batch elements per block
// ---------------------------------------------------------------------------
namespace shortseq {

// MAX_LEN, BLOCK_BYTES, pitch and batch_bytes are restated in
// kernels/flash_attention/ops.py (SHORT_MAX_LEN, SHORT_BATCH_BYTES,
// _short_batch_bytes), whose flash_route sends an input here by the same
// rule: change both sides together.
constexpr int MAX_LEN = 32;            // longest S and Skv this path takes
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_BYTES = 64 * 1024;  // shared memory aimed at per block

// Shared-memory pitch of one row of hd elements: an odd number of 16-byte
// chunks, so that 8 lanes reading the same chunk of 8 consecutive rows hit 8
// different banks.
__host__ __device__ inline int pitch(int hd, int elem) {
  return ((hd * elem / 16) | 1) * 16;
}

__host__ __device__ inline int64_t batch_bytes(int s, int skv, int h, int hk,
                                               int hd, int elem) {
  return (int64_t)(s * h + 2 * skv * hk) * pitch(hd, elem);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}

// 16 bytes of T as floats
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 two =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = two.x;
    f[2 * i + 1] = two.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* f, float scale);
template <>
__device__ __forceinline__ uint4 pack16<float>(const float* f, float scale) {
  return make_uint4(__float_as_uint(f[0] * scale),
                    __float_as_uint(f[1] * scale),
                    __float_as_uint(f[2] * scale),
                    __float_as_uint(f[3] * scale));
}
template <>
__device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* f,
                                                       float scale) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 two =
        __floats2bfloat162_rn(f[2 * i] * scale, f[2 * i + 1] * scale);
    w[i] = *reinterpret_cast<uint32_t*>(&two);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Global rows of `nb` batch elements, ordered (batch, pos, head), to or from
// shared-memory rows ordered (batch, head, pos): a head's rows sit together.
__device__ __forceinline__ int smem_row(int row, int len, int heads) {
  const int per = len * heads;
  const int j = row / per, rem = row - j * per;
  const int pos = rem / heads, hh = rem - pos * heads;
  return (j * heads + hh) * len + pos;
}

template <typename T>
__device__ __forceinline__ void stage(const T* src, uint32_t dst, int rows,
                                      int len, int heads, int cpr, int rp) {
  const uint8_t* g = reinterpret_cast<const uint8_t*>(src);
  for (int f = threadIdx.x; f < rows * cpr; f += THREADS) {
    const int row = f / cpr, c = f - row * cpr;
    cp_async16(dst + smem_row(row, len, heads) * rp + 16 * c,
               g + 16 * (int64_t)f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int b, int s,
                   int skv, int h, int hk, int hd, int causal, int window,
                   float scale_log2, int nb) {
  constexpr int EPC = 16 / sizeof(T);          // elements per 16-byte chunk
  constexpr int CHUNKS = 16 / EPC;             // most chunks a lane owns
  extern __shared__ __align__(16) uint8_t sm[];
  const int cpr = hd / EPC, rp = pitch(hd, sizeof(T));
  const int b0 = blockIdx.x * nb, nbh = min(nb, b - b0);
  const int q_rows = s * h, kv_rows = skv * hk;
  uint8_t* sq = sm;
  uint8_t* sk = sq + nb * q_rows * rp;
  uint8_t* sv = sk + nb * kv_rows * rp;

  stage(q + (int64_t)b0 * q_rows * hd, hopper::smem_u32(sq), nbh * q_rows, s,
        h, cpr, rp);
  stage(k + (int64_t)b0 * kv_rows * hd, hopper::smem_u32(sk), nbh * kv_rows,
        skv, hk, cpr, rp);
  stage(v + (int64_t)b0 * kv_rows * hd, hopper::smem_u32(sv), nbh * kv_rows,
        skv, hk, cpr, rp);
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // a warp per (batch, head) problem: lane (qi, c) scores query i0 + qi
  // against key c, KP lanes per query; for P.V the same lane owns the
  // 16-byte chunks c, c + KP, ... of the query's output row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = skv <= 8 ? 8 : (skv <= 16 ? 16 : 32);
  const int ql = 32 / kp, qi = lane / kp, c = lane % kp;
  for (int p = warp; p < nbh * h; p += WARPS) {
    const int j = p / h, hh = p - j * h, kvh = hh / (h / hk);
    uint8_t* qr = sq + (j * h + hh) * s * rp;
    const uint8_t* kr = sk + (j * hk + kvh) * skv * rp;
    const uint8_t* vr = sv + (j * hk + kvh) * skv * rp;
    for (int i0 = 0; i0 < s; i0 += ql) {
      const int i = i0 + qi;
      float x = 0.f;
      if (i < s && c < skv) {
        for (int ch = 0; ch < cpr; ++ch) {
          float a[EPC], bk[EPC];
          unpack16<T>(*reinterpret_cast<const uint4*>(qr + i * rp + 16 * ch),
                      a);
          unpack16<T>(*reinterpret_cast<const uint4*>(kr + c * rp + 16 * ch),
                      bk);
#pragma unroll
          for (int e = 0; e < EPC; ++e) x = fmaf(a[e], bk[e], x);
        }
      }
      x *= scale_log2;
      if (c >= skv) {
        x = __uint_as_float(0xff800000u);        // -inf: weight 0
      } else if ((causal && i < c) || (window > 0 && i - c >= window)) {
        x = NEG_INF;
      }
      float mx = x;
      for (int off = kp / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float pe = exp2f(x - mx);
      float sum = pe;
      for (int off = kp / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);

      float acc[CHUNKS * EPC];
#pragma unroll
      for (int e = 0; e < CHUNKS * EPC; ++e) acc[e] = 0.f;
      for (int cc = 0; cc < skv; ++cc) {
        const float pc = __shfl_sync(0xffffffffu, pe, qi * kp + cc);
#pragma unroll
        for (int t = 0; t < CHUNKS; ++t) {
          const int ch = c + t * kp;
          if (ch < cpr) {
            float vv[EPC];
            unpack16<T>(
                *reinterpret_cast<const uint4*>(vr + cc * rp + 16 * ch), vv);
#pragma unroll
            for (int e = 0; e < EPC; ++e)
              acc[t * EPC + e] = fmaf(pc, vv[e], acc[t * EPC + e]);
          }
        }
      }
      __syncwarp();          // every lane has read its q row: overwrite it
      if (i < s) {
        const float inv = 1.f / sum;
#pragma unroll
        for (int t = 0; t < CHUNKS; ++t) {
          const int ch = c + t * kp;
          if (ch < cpr)
            *reinterpret_cast<uint4*>(qr + i * rp + 16 * ch) =
                pack16<T>(acc + t * EPC, inv);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // the output rows, now where q's were, back in (batch, pos, head) order
  uint8_t* g = reinterpret_cast<uint8_t*>(o + (int64_t)b0 * q_rows * hd);
  for (int f = threadIdx.x; f < nbh * q_rows * cpr; f += THREADS) {
    const int row = f / cpr, cch = f - row * cpr;
    *reinterpret_cast<uint4*>(g + 16 * (int64_t)f) =
        *reinterpret_cast<const uint4*>(sq + smem_row(row, s, h) * rp +
                                        16 * cch);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s,
           int skv, int h, int hk, int hd, int causal, int window,
           cudaStream_t st) {
  const int64_t per = batch_bytes(s, skv, h, hk, hd, sizeof(T));
  const int64_t fit = BLOCK_BYTES / per;
  const int nb = fit < 1 ? 1 : (fit > b ? b : (int)fit);
  const int smem = (int)(nb * per);
  cudaError_t e = cudaFuncSetAttribute(
      flash_short_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((b + nb - 1) / nb);
  flash_short_kernel<T><<<blocks, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), b, s, skv, h, hk, hd,
      causal, window, LOG2E / sqrtf((float)hd), nb);
  return (int)cudaGetLastError();
}

}  // namespace shortseq

// q and o (b, s, h, hd), k and v (b, skv, hk, hd), contiguous, in `dtype`
// (float32 or bfloat16, the TPU kernel's two input types), through `route`
// (ROUTE_*: the wrapper's ops.flash_route).  Every path needs 1 <= hd <= 128,
// h a multiple of hk and s, skv, b >= 1; tc needs bf16, hd % 8 == 0 and
// 16-byte aligned pointers; short needs s, skv <= 32, rows of a multiple of
// 16 bytes, 16-byte aligned pointers and one batch element's q, k, v within
// 64 KB of shared memory; simt needs ceil(s / 64) <= 65535.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int b, int s,
                                        int skv, int h, int hk, int hd,
                                        int causal, int window, int dtype,
                                        int route, void* stream) {
  if (hd < 1 || hd > 128 || hk < 1 || h % hk || s < 1 || skv < 1 || b < 1 ||
      (dtype != REPRO_F32 && dtype != REPRO_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elem = dtype == REPRO_F32 ? 4 : 2;
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)o) % 16 == 0;
  switch (route) {
    case ROUTE_TC:
      if (dtype != REPRO_BF16 || hd % 8 || !aligned)
        return (int)cudaErrorInvalidValue;
      if (hd <= 64)
        return tc::launch<64>(q, k, v, o, b, s, skv, h, hk, hd, causal, window,
                              st);
      return tc::launch<128>(q, k, v, o, b, s, skv, h, hk, hd, causal, window,
                             st);
    case ROUTE_SHORT:
      if (s > shortseq::MAX_LEN || skv > shortseq::MAX_LEN ||
          hd * elem % 16 || !aligned ||
          shortseq::batch_bytes(s, skv, h, hk, hd, elem) >
              shortseq::BLOCK_BYTES)
        return (int)cudaErrorInvalidValue;
      if (dtype == REPRO_F32)
        return shortseq::launch<float>(q, k, v, o, b, s, skv, h, hk, hd,
                                       causal, window, st);
      return shortseq::launch<__nv_bfloat16>(q, k, v, o, b, s, skv, h, hk, hd,
                                             causal, window, st);
    case ROUTE_SIMT:
      if ((s + simt::BQ - 1) / simt::BQ > 65535 || (int64_t)b * h > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
      if (dtype == REPRO_F32)
        return simt::launch_hd<float>(q, k, v, o, b, s, skv, h, hk, hd, causal,
                                      window, st);
      return simt::launch_hd<__nv_bfloat16>(q, k, v, o, b, s, skv, h, hk, hd,
                                            causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
