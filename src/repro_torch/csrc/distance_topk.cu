// Blocked squared-L2 distances between N records and C representatives with
// a running top-k per record: (N, k) ascending distances and rep ids.  The
// (N, C) matrix is never written.
//
// Replaces: distance_topk_pallas in src/repro/kernels/distance_topk/kernel.py
// (its _kernel and _k_smallest).  Same arithmetic: d2 = |x|^2 + |r|^2 - 2 x.r
// accumulated in float32 from f32/f16/bf16 inputs, clamped at 0, as
// fmaxf((x2 + r2) - 2 * acc, 0) with the norms in float32 (row_sqnorm_kernel).
//
// Bound on an H100: operations.  2*N*C*D multiply-adds (1.79 TFLOP at
// N = 1M, C = 7,000, D = 128) against ~0.58 GB of traffic (~0.17 ms at
// 3.35 TB/s).  Two routes, picked by the wrapper from dtype and shape
// (ops.distance_topk_route):
//
// - tc (D <= 128, rows of 16 bytes, k <= 8; the main path's embeddings):
//   the products on the tensor cores with wgmma, fed by TMA.  float32
//   inputs take 3xTF32: hi = rna(a), lo = rna(a - hi), and x.r as
//   (x_hi.r_lo + x_lo.r_hi) + x_hi.r_hi in one float32 accumulator, the
//   small terms over the whole depth first, so that their bits are not cut
//   at the large sum's rounding (the tensor cores truncate each addition
//   to the accumulator's precision).  Single-pass TF32 would lose the
//   distance itself where records sit near a rep (|x|^2 ~ 1,000 against
//   d2 ~ 0.01: TASTI's near-duplicate frames).  Bound 3 x 1.79e12 /
//   494.7 TFLOP/s = 10.9 ms at 1M rows.  bf16 and f16 inputs take one pass
//   (their products are exact in float32; 1.8 ms).  A block owns 128
//   records, two consumer warpgroups of 64 rows, and one producer warp of
//   a third warpgroup keeps a ring of rep tiles (64 reps and their norms)
//   in flight with TMA and mbarriers; setmaxnreg hands the producer's
//   registers to the consumers.  Shared memory holds the records (as x_lo
//   for float32, written back by the consumers after the split) and the
//   ring; x_hi stays in registers as the A operand of two of the three
//   products, which leaves room in the 227 KB for two 64 KB stages of
//   r_hi + r_lo.  r is split once per launch (row_sqnorm_kernel<float,
//   true>, with its norms) into a (2, C, D) scratch.  Each thread's
//   accumulator fragment is 2 records x 16 reps; it folds them into a sorted
//   k-list per record in registers, and the 4 threads (a quad) that share a
//   record merge their lists through shuffles once, at the end.  The fold,
//   not the products, sets the time (bf16, a sixth of the products, takes
//   two thirds of float32's), so it is kept short: a candidate is dropped
//   above the smallest tail of the quad's lists, and an insertion moves
//   every list position at once.
// - simt (everything else, the exact float32 SIMT tile of the first port):
//   64 records x 64 reps per block, 4 x 4 outputs per thread, the depth
//   staged through shared memory 32 at a time; the finished distance tile
//   goes to shared memory, where 4 threads per record scan 16 candidates
//   each into a sorted k-list held in registers, merged through warp
//   shuffles once per block.
//
// The TPU kernel's k rounds of (min, argmin, mask) existed because the TPU
// has no dynamic gather; they are not carried over.
//
// Ties: candidates are ordered by (distance, rep id), so on equal distances
// the lower id wins, as in lax.top_k and _k_smallest's argmin.  Reps beyond C
// in the last tile get +inf and sort after every real rep (the tc route's
// TMA fills their rows with zeros, which never become a distance); as k <= C
// they never reach the output (no padded rep values, so float16 inputs give
// finite outputs).
#include "common.cuh"
#include "hopper.cuh"

#include <limits.h>
#include <type_traits>

namespace {

constexpr int BM = 64;                 // records per block
constexpr int BN = 64;                 // reps per tile
constexpr int BK = 32;                 // dimensions per shared-memory chunk
constexpr int THREADS = 256;
constexpr int PARTS = THREADS / BM;    // threads sharing one record's top-k
constexpr int SEG = BN / PARTS;        // candidates per thread per tile

// |a_row|^2 in float32, a warp per row.  With SPLIT (float32 rows), each
// element also goes to hi = rna_tf32(a) and lo = rna_tf32(a - hi), row-major
// like a: the tc route's 3xTF32 operands.
template <typename T, bool SPLIT = false>
__global__ void row_sqnorm_kernel(const T* __restrict__ a, int n, int d,
                                  float* __restrict__ out,
                                  float* __restrict__ hi = nullptr,
                                  float* __restrict__ lo = nullptr) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       row < n; row += warps) {
    const T* p = a + row * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = to_f32(p[j]);
      s = fmaf(v, v, s);
      if constexpr (SPLIT) {
        const float h = __uint_as_float(hopper::to_tf32(v));
        hi[row * d + j] = h;
        lo[row * d + j] = __uint_as_float(hopper::to_tf32(v - h));
      }
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

// ---------------------------------------------------------------------------
// tc: the products on the tensor cores (wgmma), rep tiles fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

using hopper::smem_u32;

constexpr int ROWS = 64;               // records per consumer warpgroup
constexpr int BM = 2 * ROWS;           // records per block
constexpr int BN = 64;                 // reps per tile
constexpr int DMAX = 128;              // depth the tiles hold
constexpr int KMAX = 8;                // list length (k <= 8)
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
// + a producer warpgroup, of which one thread starts the loads: 170
// registers a thread at launch (65,536 / 384), and setmaxnreg moves them
// from the producer (40) to the consumers (232)
constexpr int THREADS = 32 * (CONSUMER_WARPS + 4);
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BOX = 64 * 128;          // one TMA box: 64 rows x 128 bytes

// Shared memory (bytes from a 1,024-aligned base): the block's records, one
// warpgroup's 64 rows after the other's, then the ring of rep tiles, each
// stage r_hi then (float32) r_lo, then each stage's 64 rep norms.  A tile
// of 64 rows x DMAX columns is DMAX * sizeof(T) / 128 boxes of 64 rows x
// 128 bytes, swizzled by TMA.  float32: 64 KB of records + 2 stages of
// 64 KB; 16-bit: 32 + 4 x 16 KB.
template <typename T>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int COLS = 128 / (int)sizeof(T);     // columns per box
  static constexpr int BOXES = DMAX / COLS;
  static constexpr int TILE = BOXES * BOX;
  static constexpr int STAGES = F32 ? 2 : 4;
  static constexpr int STAGE = (F32 ? 2 : 1) * TILE;
  static constexpr int KSTEPS = DMAX * (int)sizeof(T) / 32;   // 32 B each
  static constexpr int R2 = 2 * TILE + STAGES * STAGE;
  __host__ __device__ static constexpr int x(int wg) { return wg * TILE; }
  __host__ __device__ static constexpr int r(int st) {
    return 2 * TILE + st * STAGE;
  }
  __host__ __device__ static constexpr int r2(int st) {
    return R2 + st * BN * 4;
  }
  static constexpr int BYTES = R2 + STAGES * BN * 4 + 1024;
};

// The block's records and its ring: a full and an empty barrier per stage.
struct Ring {
  uint32_t base;                       // 1,024-aligned start of the tiles
  uint32_t x_full, full, empty;        // mbarriers, full/empty + 8 * stage
  int row0, n_tiles;
};

// One thread of the producer warpgroup: the records once, then rep tiles
// and their norms into the ring, a stage at a time once the consumers have
// released it.  Reps past C and records past N arrive as zeros (TMA's
// out-of-bounds fill), columns past D too; rsq is padded to whole tiles.
template <typename T>
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* tm_x,
                                        const CUtensorMap* tm_rh,
                                        const CUtensorMap* tm_rl,
                                        const float* rsq) {
  using L = Layout<T>;
  hopper::mbar_arrive_expect_tx(ring.x_full, 2 * L::TILE);
  for (int wg = 0; wg < 2; ++wg)
    for (int b = 0; b < L::BOXES; ++b)
      hopper::tma_load_2d(ring.base + L::x(wg) + b * BOX, tm_x, b * L::COLS,
                          ring.row0 + ROWS * wg, ring.x_full);
  for (int i = 0; i < ring.n_tiles; ++i) {
    const int st = i % L::STAGES;
    if (i >= L::STAGES)
      hopper::mbar_wait(ring.empty + 8 * st, ((i / L::STAGES) + 1) & 1);
    const uint32_t bar = ring.full + 8 * st;
    hopper::mbar_arrive_expect_tx(bar, L::STAGE + BN * 4);
    for (int b = 0; b < L::BOXES; ++b) {
      hopper::tma_load_2d(ring.base + L::r(st) + b * BOX, tm_rh, b * L::COLS,
                          i * BN, bar);
      if constexpr (L::F32)
        hopper::tma_load_2d(ring.base + L::r(st) + L::TILE + b * BOX, tm_rl,
                            b * L::COLS, i * BN, bar);
    }
    hopper::bulk_load(ring.base + L::r2(st), rsq + i * BN, BN * 4, bar);
  }
}

// Starts tile i's products into acc as one wgmma group once its stage has
// arrived: float32 x_hi.r_lo and x_lo.r_hi over the whole depth, then
// x_hi.r_hi (the small terms first: the tensor cores truncate each sum to
// the accumulator's precision, which must not cut them at the large sum's
// scale); 16-bit inputs x.r in one pass.  A k-step moves 32 bytes inside a
// 128-byte swizzled row, four steps fill a box.
template <typename T, int XK>
__device__ __forceinline__ void products(float (&acc)[32],
                                         const uint32_t (&xh)[XK][4],
                                         const Ring& ring, uint32_t xs,
                                         int i) {
  using L = Layout<T>;
  const int st = i % L::STAGES;
  const uint32_t rs = ring.base + L::r(st);
  hopper::mbar_wait(ring.full + 8 * st, (i / L::STAGES) & 1);
  hopper::fence_operands(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::KSTEPS; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    const uint64_t dr = hopper::make_desc_sw128(rs + off, 16, 1024);
    const uint64_t dx = hopper::make_desc_sw128(xs + off, 16, 1024);
    if constexpr (L::F32) {
      hopper::wgmma_rs_m64n64k8_tf32(
          acc, xh[kk], hopper::make_desc_sw128(rs + L::TILE + off, 16, 1024),
          kk > 0);
      hopper::wgmma_ss_m64n64k8_tf32(acc, dx, dr, 1);
    } else if constexpr (std::is_same<T, __half>::value) {
      hopper::wgmma_ss_m64n64k16_f16(acc, dx, dr, kk > 0);
    } else {
      hopper::wgmma_ss_m64n64k16_bf16(acc, dx, dr, kk > 0);
    }
  }
  if constexpr (L::F32) {
#pragma unroll
    for (int kk = 0; kk < L::KSTEPS; ++kk)
      hopper::wgmma_rs_m64n64k8_tf32(
          acc, xh[kk],
          hopper::make_desc_sw128(rs + (kk / 4) * BOX + (kk % 4) * 32, 16,
                                  1024),
          1);
  }
  hopper::wgmma_commit();
}

// Inserts (v, id) into a sorted list whose ids are all below id (the
// caller checked v < the tail): after the entries of equal distance, as
// (distance, id) order puts it.  Every position is computed from the old
// list at once, a depth of three instead of a chain of KMAX swaps.
template <int K>
__device__ __forceinline__ void insert_last_id(float v, int id,
                                               float (&bd)[K], int (&bi)[K]) {
  bool lt[K];
#pragma unroll
  for (int j = 0; j < K; ++j) lt[j] = v < bd[j];
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    bd[j] = lt[j - 1] ? bd[j - 1] : (lt[j] ? v : bd[j]);
    bi[j] = lt[j - 1] ? bi[j - 1] : (lt[j] ? id : bi[j]);
  }
  if (lt[0]) {
    bd[0] = v;
    bi[0] = id;
  }
}

// Tile i's products have arrived in acc: takes the tile's rep norms,
// releases its stage to the producer and folds the distances into the
// rows' k-lists.  In the wgmma accumulator layout acc[4 j + 2 rr + e] is
// (row ra + 8 rr, rep 8 j + 2 t + e of the tile), t = lane % 4.  A thread
// meets its reps in ascending id order, so a candidate beats its list's
// tail only by a smaller distance (on a tie the tail's id is the lower).
// A candidate above the smallest tail of the quad's four lists of its row
// is beaten by that list's KMAX entries and is dropped unseen.  Reps from
// C on get +inf.
template <typename T>
__device__ __forceinline__ void retire(float (&acc)[32], const Ring& ring,
                                       const uint8_t* smem, int i, int c,
                                       int lane, const float (&x2)[2],
                                       float (&bd)[2][KMAX],
                                       int (&bi)[2][KMAX]) {
  using L = Layout<T>;
  const int st = i % L::STAGES, t = lane % 4;
  const float* r2s = reinterpret_cast<const float*>(
      smem + (ring.base + L::r2(st) - smem_u32(smem))) + 2 * t;
  float2 r2[BN / 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
    r2[j] = *reinterpret_cast<const float2*>(r2s + 8 * j);
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(ring.empty + 8 * st);

  float thr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    thr[rr] = bd[rr][KMAX - 1];
    thr[rr] = fminf(thr[rr], __shfl_xor_sync(0xffffffffu, thr[rr], 1));
    thr[rr] = fminf(thr[rr], __shfl_xor_sync(0xffffffffu, thr[rr], 2));
  }
  const int c0 = i * BN;
  const int lim = c - c0 - 2 * t;      // this thread's columns below C
  const bool tail = c0 + BN > c;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float v = fmaxf((x2[rr] + (e ? r2[j].y : r2[j].x)) -
                            2.f * acc[4 * j + 2 * rr + e],
                        0.f);
        if (tail && 8 * j + e >= lim) v = INFINITY;
        if (v < bd[rr][KMAX - 1] && v <= thr[rr])
          insert_last_id<KMAX>(v, c0 + 8 * j + 2 * t + e, bd[rr], bi[rr]);
      }
    }
  }
}

// A consumer warpgroup: block rows 64 wg .. 64 wg + 63; this thread holds
// rows ra and ra + 8 of them (ra = 16 warp + lane / 4).  A tile's products,
// then its fold: the other warpgroup's products fill the tensor cores
// meanwhile.
template <typename T>
__device__ __forceinline__ void consume(const Ring& ring, uint8_t* smem,
                                        int wg, int tid,
                                        const float* __restrict__ xsq, int n,
                                        int c, int k, float* __restrict__ out_d,
                                        int* __restrict__ out_i) {
  using L = Layout<T>;
  constexpr int KS = L::KSTEPS;
  const int lane = tid % 32, t = lane % 4;
  const int ra = 16 * (tid / 32 % 4) + lane / 4;
  const int64_t row_a = (int64_t)ring.row0 + ROWS * wg + ra;
  float x2[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    x2[rr] = row_a + 8 * rr < n ? xsq[row_a + 8 * rr] : 0.f;
  const uint32_t xs = ring.base + L::x(wg);
  hopper::mbar_wait(ring.x_full, 0);

  // float32: split the records.  hi stays in registers as the A fragment
  // of x_hi.r_hi and x_hi.r_lo (m16n8k8 layout: a0 (g, t), a1 (g + 8, t),
  // a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows), lo goes back
  // in place, as the shared-memory A operand of x_lo.r_hi.  The 128-byte
  // swizzle puts 16-byte chunk q of row y at chunk q ^ (y % 8).
  uint32_t xh[L::F32 ? KS : 1][4];
  if constexpr (L::F32) {
    uint8_t* xg = smem + (xs - smem_u32(smem));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int y = ra + 8 * (e & 1);
        const int col = 8 * kk + t + 4 * (e >> 1);
        const int cb = col % 32;
        float* p = reinterpret_cast<float*>(
            xg + (col / 32) * BOX + y * 128 + ((cb / 4) ^ (y % 8)) * 16 +
            (cb % 4) * 4);
        const float v = *p;
        xh[kk][e] = hopper::to_tf32(v);
        *p = __uint_as_float(hopper::to_tf32(v - __uint_as_float(xh[kk][e])));
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
  }

  float bd[2][KMAX];
  int bi[2][KMAX];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      bd[rr][j] = INFINITY;
      bi[rr][j] = INT_MAX;
    }
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  for (int i = 0; i < ring.n_tiles; ++i) {
    products<T>(acc, xh, ring, xs, i);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    retire<T>(acc, ring, smem, i, c, lane, x2, bd, bi);
  }

  // merge the 4 lists of each row (the lanes of a quad) into lane t = 0's
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int p = 1; p < 4; ++p) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        const float v = __shfl_down_sync(0xffffffffu, bd[rr][j], p);
        const int id = __shfl_down_sync(0xffffffffu, bi[rr][j], p);
        if (t == 0 && before(v, id, bd[rr][KMAX - 1], bi[rr][KMAX - 1]))
          insert<KMAX>(v, id, bd[rr], bi[rr]);
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int64_t row = row_a + 8 * rr;
      if (row < n) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) {
            out_d[row * k + j] = bd[rr][j];
            out_i[row * k + j] = bi[rr][j];
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
distance_topk_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_rh,
                        const __grid_constant__ CUtensorMap tm_rl,
                        const float* __restrict__ xsq,
                        const float* __restrict__ rsq, int n, int c, int k,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  using L = Layout<T>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * L::STAGES];
  Ring ring;
  ring.base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  ring.x_full = smem_u32(&bars[0]);
  ring.full = smem_u32(&bars[1]);
  ring.empty = smem_u32(&bars[1 + L::STAGES]);
  ring.row0 = (int)blockIdx.x * BM;
  ring.n_tiles = (c + BN - 1) / BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(ring.x_full, 1);
    for (int st = 0; st < L::STAGES; ++st) {
      hopper::mbar_init(ring.full + 8 * st, 1);
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
      produce<T>(ring, &tm_x, &tm_rh, &tm_rl, rsq);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    consume<T>(ring, smem_raw, wg, tid, xsq, n, c, k, out_d, out_i);
  }
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// (cols, rows) row-major; boxes of 128 bytes x 64 rows with the 128-byte
// swizzle; zeros out of bounds.
template <typename T>
static bool make_map(CUtensorMap* map, const void* ptr, int cols, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Layout<T>::COLS, 64};
  const cuuint32_t unit[2] = {1, 1};
  return hopper::encode_tiled()(map, map_type<T>(), 2,
                                const_cast<void*>(ptr), dims, strides, box,
                                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T>
int launch(const void* x, const void* r, float* xsq, float* rsq,
           float* rsplit, int n, int c, int d, int k, float* out_d,
           int* out_i, cudaStream_t s) {
  using L = Layout<T>;
  if (hopper::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  if (d > DMAX || d * sizeof(T) % 16 != 0 || k > KMAX ||
      (L::F32 && rsplit == nullptr))
    return (int)cudaErrorInvalidValue;
  const int norm_blocks = repro_sm_count() * 8;
  row_sqnorm_kernel<T><<<norm_blocks, 256, 0, s>>>(static_cast<const T*>(x),
                                                   n, d, xsq);
  const void* rh = r;
  const void* rl = r;
  if constexpr (L::F32) {
    float* lo = rsplit + (int64_t)c * d;
    row_sqnorm_kernel<float, true><<<norm_blocks, 256, 0, s>>>(
        static_cast<const float*>(r), c, d, rsq, rsplit, lo);
    rh = rsplit;
    rl = lo;
  } else {
    row_sqnorm_kernel<T><<<norm_blocks, 256, 0, s>>>(
        static_cast<const T*>(r), c, d, rsq);
  }
  CUtensorMap mx, mh, ml;
  if (!make_map<T>(&mx, x, d, n) || !make_map<T>(&mh, rh, d, c) ||
      !make_map<T>(&ml, rl, d, c))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      distance_topk_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((n + BM - 1) / BM);
  distance_topk_tc_kernel<T><<<grid, THREADS, L::BYTES, s>>>(
      mx, mh, ml, xsq, rsq, n, c, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

enum { ROUTE_SIMT = 0, ROUTE_TC = 1 };

// x (n, d) and r (c, d) row-major in `dtype`; xsq (n,) and rsq (c rounded
// up to a multiple of 64,) float32 scratch; rsplit (2, c, d) float32
// scratch for route tc with float32 inputs (else unused, may be null);
// out_d (n, k) float32 and out_i (n, k) int32.  Needs 1 <= k <= c, n >= 1;
// route simt k <= 32, route tc k <= 8, d <= 128, d * itemsize % 16 == 0 and
// x, r at 16-byte aligned addresses.
REPRO_EXPORT int distance_topk_launch(const void* x, const void* r, void* xsq,
                                      void* rsq, void* rsplit, int n, int c,
                                      int d, int k, int dtype, int route,
                                      void* out_d, void* out_i,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(xsq);
  float* rs = static_cast<float*>(rsq);
  float* sp = static_cast<float*>(rsplit);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  if (route == ROUTE_TC) {
    switch (dtype) {
      case REPRO_F32:
        return tc::launch<float>(x, r, xs, rs, sp, n, c, d, k, od, oi, s);
      case REPRO_F16:
        return tc::launch<__half>(x, r, xs, rs, sp, n, c, d, k, od, oi, s);
      case REPRO_BF16:
        return tc::launch<__nv_bfloat16>(x, r, xs, rs, sp, n, c, d, k, od,
                                         oi, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != ROUTE_SIMT) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case REPRO_F32: return launch<float>(x, r, xs, rs, n, c, d, k, od, oi, s);
    case REPRO_F16: return launch<__half>(x, r, xs, rs, n, c, d, k, od, oi, s);
    case REPRO_BF16:
      return launch<__nv_bfloat16>(x, r, xs, rs, n, c, d, k, od, oi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
