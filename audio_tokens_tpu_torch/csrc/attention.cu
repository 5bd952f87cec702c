// Kernel B5: non-causal flash attention with segment ids, forward and the
// two backward kernels (dk/dv and dq).
//
// Replaces the library kernels the JAX package calls from
// audio_tokens_tpu/models/transformer.py::FlashSelfAttention
// (jax.experimental.pallas.ops.tpu.flash_attention):
// _flash_attention_kernel (forward), _flash_attention_dkv_kernel and
// _flash_attention_dq_kernel (backward).
//
// q, k, v, o, do (B, nh, T, 64) in float32 or bfloat16, seg (B, T) int32,
// lse and di (B, nh, T) float32.  The numerics are the library's: scores
// q.k^T accumulated in f32, times sm_scale, plus the finite mask value
// -0.7 * FLT_MAX where the query's and key's segments differ; an online
// softmax with running max m and sum l; P rounded to v's dtype before P.v,
// accumulation in f32, the output cast to the input dtype.  The backward
// recomputes P = exp(s - lse) from the saved row logsumexp, with
// dP = dO.V^T, dS = (dP - di) * P * sm_scale and di = rowsum(O * dO)
// (computed by the wrapper, as the library computes it outside its kernels);
// P and dS are rounded to the input dtype before the products that consume
// them.  Keys past T do not exist: the kernels mask their own ragged edge
// instead of padding T to a tile multiple.
//
// What bounds it on the H100: at the serving shape (B 64, nh 12, T 1728,
// dh 64) the forward is 587 GFLOP against 680 MB of q, k, v, o in bf16, so
// it is bound by arithmetic, and past the mma by the elementwise pass (the
// online softmax takes about as many instruction slots as the mma at head
// dim 64).  Every kernel keeps the (T, T) scores on chip: one block per
// (batch x head, tile of 16 x warps own rows), 64-row tiles of the other
// side staged through shared memory.  In bf16 all three kernels run on the
// tensor cores with mma.sync from bf16 tiles (flash_fwd_mma_kernel,
// flash_dkv_mma_kernel, flash_dq_mma_kernel) on one design: P and dS stay in
// registers, the accumulator of one product being the A fragment of the
// next; the streamed tiles come through a cp.async ring that overlaps the
// next tile's loads with this tile's mma; tiles that share no segment with
// the block's rows are left out and tiles of one segment skip the mask
// tests; the exponential is the bare ex2 instruction.  In f32 all three
// kernels (flash_fwd_tf32_kernel, flash_dkv_tf32_kernel,
// flash_dq_tf32_kernel) run the same design on the tensor cores in 3xTF32,
// each operand split into two tf32 parts and three products taken for one,
// which keeps f32 accuracy at 165 TFLOP/s (495 / 3) where f32 FMA has 67;
// the block's own rows stay in shared memory (see the notes above the pair
// and above the forward).  wgmma, TMA and warp specialisation are later
// work.
#include <cuda_bf16.h>

#include <climits>
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kD = 64;          // head dim the kernels take
constexpr int kTile = 64;       // rows (queries or keys) of a tile

// The bf16 kernels run on the tensor cores: mma.sync m16n8k16 (bf16
// operands, f32 accumulation).
constexpr int kLdh = kD + 8;  // bf16 row of a staged tile: 144 bytes, no bank conflicts

// mma_bf16 and pack_bf16 live in common.cuh (B1 and B2 use them too).
using atk::mma_bf16;
using atk::pack_bf16;

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane i gives the
// address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The three bf16 kernels share one shape: a warp owns 16 rows, keeps their
// operands as mma A fragments in registers for the whole loop, and walks the
// other side in 64-row tiles.
//
//   forward: a warp owns 16 query rows (Q fragments resident) and streams K
//     and V.  Per key tile it forms S = Q.K^T in the accumulator layout, runs
//     the online softmax on it (a row's 16 values per thread reduced over the
//     4 lanes of a quad; base 2, scores times sm_scale * log2(e)), and reuses
//     the accumulators of two neighbouring 8-key column tiles, P rounded to
//     bf16 against the running max as it is packed, as the A fragment of
//     O += P.V.
//   dk/dv: a warp owns 16 key rows (K and V fragments resident) and streams
//     Q and dO.  It forms the transposed scores S^T = K.Q^T and dP^T = V.dO^T
//     with the keys as the M dimension, so the accumulators of two
//     neighbouring 8-query column tiles are, once P^T and dS^T are rounded
//     to bf16 and packed, the A fragments of dV += P^T.dO and dK += dS^T.Q.
//   dq: a warp owns 16 query rows (Q and dO fragments resident) and streams
//     K and V: S = Q.K^T, dP = dO.V^T, and dS from the accumulator is the A
//     fragment of dQ += dS.K.
//
// P and dS never touch shared memory.  The B fragments of the score products
// come from the streamed tiles' row-major rows by ldmatrix, those of the
// output products (contracted over the streamed rows) by ldmatrix.trans.
// In the backward P = exp2(s * sm_scale * log2(e) - lse * log2(e)) where the
// pair is valid (same segment, streamed row below T), else exactly 0 (as the
// plain version's exp(MASK_VALUE - lse) is).  The forward sets an invalid
// pair's score to -inf before the row max, so that it neither raises the
// running max nor adds to l and O (exp2(-inf) = 0); the plain version's
// exp(MASK_VALUE - m) is 0 there too, since every query row below T has a
// key of its own segment (itself).  An owned row past T is not tested: a row
// of P or dS reaches only its own row of the output, which is not stored.
// exp2 is the bare ex2.approx.ftz instruction: what exp2f compiles to
// without its rescue of results below 2^-126, which become 0 here; the
// elementwise pass between the products takes as many instruction slots as
// the mma, so every instruction in it shows in the kernel's time.
//
// The streamed tiles come through a ring of kStages stages filled by
// cp.async (16 bytes a thread; rows past T are zero-filled by the src-size
// form), so the loads of the next tiles overlap the mma of this one, with
// one block barrier a tile.  A streamed tile whose segment ids cannot meet
// the block's own (disjoint [min, max] ranges; any int32 ids) holds only
// pairs with P = 0 and is left out of the walk; a full tile whose rows and
// the block's all carry one id needs no mask and takes a path without the
// tests.  Both are exact: in the forward a left-out tile would leave m, l and
// O as they are (all its P are 0), or, walked first, be wiped by the first
// tile with a valid key (alpha = 0).  The walk is in ascending tile order and
// nothing is accumulated across blocks: bit-identical from launch to launch,
// and with the skip and the untested path on or off.
//
// Tuning knobs: the defaults are the measured best on an H100 (PERF.md);
// tools/kernel_ab.py builds the alternatives with -D and times them.
#ifndef ATK_FWD_WARPS
#define ATK_FWD_WARPS 4  // warps of a forward block, 16 query rows each
#endif
#ifndef ATK_FWD_BLOCKS
#define ATK_FWD_BLOCKS 4  // forward blocks an SM that the register count must allow
#endif
#ifndef ATK_DKV_WARPS
#define ATK_DKV_WARPS 4  // warps of a dk/dv block, 16 key rows each
#endif
#ifndef ATK_DKV_BLOCKS
#define ATK_DKV_BLOCKS 3  // dk/dv blocks an SM that the register count must allow
#endif
#ifndef ATK_DQ_WARPS
#define ATK_DQ_WARPS 8  // warps of a dq block, 16 query rows each
#endif
#ifndef ATK_DQ_BLOCKS
#define ATK_DQ_BLOCKS 2  // dq blocks an SM that the register count must allow
#endif
#ifndef ATK_STAGES
#define ATK_STAGES 2  // stages of the cp.async ring
#endif
#ifndef ATK_BWD_UNROLL
#define ATK_BWD_UNROLL 1  // unrolling of a tile's four 16-row steps (4 spills registers)
#endif
#ifndef ATK_TILE_SKIP
#define ATK_TILE_SKIP 1  // leave out the tiles whose pairs all have P = 0
#endif
#ifndef ATK_PLAIN_TILES
#define ATK_PLAIN_TILES 1  // no mask tests on the tiles that need none
#endif
constexpr int kFwdWarps = ATK_FWD_WARPS;
constexpr int kFwdBlocks = ATK_FWD_BLOCKS;
constexpr int kDkvWarps = ATK_DKV_WARPS;
constexpr int kDkvBlocks = ATK_DKV_BLOCKS;
constexpr int kDqWarps = ATK_DQ_WARPS;
constexpr int kDqBlocks = ATK_DQ_BLOCKS;
constexpr int kStages = ATK_STAGES;
constexpr int kBwdUnroll = ATK_BWD_UNROLL;
constexpr bool kTileSkip = ATK_TILE_SKIP != 0;
constexpr bool kPlainTiles = ATK_PLAIN_TILES != 0;
constexpr float kLog2e = 1.44269504088896341f;

// One stage of the ring: a 64-row tile of each streamed operand (rows LD
// elements apart) and the rows' segment ids, logsumexp and di (the last two
// only for dk/dv).
template <typename Elem, int LD>
struct StageOf {
  using T = Elem;
  static constexpr int kLd = LD;
  Elem a[kTile * LD];  // K (forward, dq) or Q (dk/dv)
  Elem b[kTile * LD];  // V (forward, dq) or dO (dk/dv)
  int seg[kTile];
  float lse[kTile];
  float di[kTile];
};
using Stage = StageOf<__nv_bfloat16, kLdh>;
static_assert(sizeof(Stage) % 16 == 0, "stages stay 16-byte aligned");

using atk::cp_async16;
using atk::cp_async4;
using atk::cp_async_commit;
using atk::cp_async_wait;

// Start the copy of rows [r0, r0 + 64) of the head a and, if kB, of the
// head b, of the batch row's segment ids sg and, unless null, of the head's
// lse and di rows into a stage.  The caller commits the group.
template <int THREADS, bool kB = true, typename St>
__device__ __forceinline__ void stream_tile(St& st, const typename St::T* __restrict__ a,
                                            const typename St::T* __restrict__ b,
                                            const int* __restrict__ sg,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ di, int r0, int t) {
  constexpr int kPiece = 16 / sizeof(typename St::T);  // elements of a 16-byte piece
  constexpr int kChunks = kD / kPiece;                 // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kTile * kChunks; e += THREADS) {
    const int r = e / kChunks, c = kPiece * (e % kChunks);
    const bool ok = r0 + r < t;
    const size_t off = (size_t)(ok ? r0 + r : 0) * kD + c;
    cp_async16(st.a + r * St::kLd + c, a + off, ok);
    if (kB) cp_async16(st.b + r * St::kLd + c, b + off, ok);
  }
  const int i = threadIdx.x;
  if (i < kTile) {
    const bool ok = r0 + i < t;
    const int r = ok ? r0 + i : 0;
    cp_async4(st.seg + i, sg + r, ok);
    if (lse != nullptr) {
      cp_async4(st.lse + i, lse + r, ok);
      cp_async4(st.di + i, di + r, ok);
    }
  }
}

// ldmatrix_x4 lives in common.cuh.  Read as 32-bit words, a matrix is 8
// rows of 4 f32 values and a lane receives the word at row lane / 4, column
// lane % 4: a tf32 mma fragment.
using atk::ldmatrix_x4;

// The A fragments (16 rows x 64 columns, four k steps) of the 16 staged rows
// that start at `rows`.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kD / 16][4],
                                             const __nv_bfloat16* rows, int g, int tg) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const __nv_bfloat16* lo = rows + g * kLdh + kk * 16 + 2 * tg;
    const __nv_bfloat16* hi = lo + 8 * kLdh;
    a[kk][0] = lds32(lo);
    a[kk][1] = lds32(hi);
    a[kk][2] = lds32(lo + 8);
    a[kk][3] = lds32(hi + 8);
  }
}

// acc (16 x 8) += A (16 x 64, fragments a) . X^T for the 8 staged rows of X
// that start at `rows`: the B fragments of all four k steps by two ldmatrix.
__device__ __forceinline__ void mma_rows(float (&acc)[4], const uint32_t (&a)[kD / 16][4],
                                         const __nv_bfloat16* rows, int lane) {
  uint32_t b[2][4];
  const __nv_bfloat16* p = rows + (lane & 7) * kLdh + 8 * (lane >> 3);
  ldmatrix_x4(b[0], p);
  ldmatrix_x4(b[1], p + 32);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    mma_bf16(acc, a[kk], b[kk / 2][2 * (kk % 2)], b[kk / 2][2 * (kk % 2) + 1]);
}

// acc (16 x 64) += A (16 x 16, fragment a) . X for the 16 staged rows of X
// that start at `rows` (X contracted over its rows: ldmatrix.trans).
__device__ __forceinline__ void mma_cols(float (&acc)[kD / 8][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* rows, int lane) {
#pragma unroll
  for (int jp = 0; jp < kD / 16; ++jp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, rows + (lane & 15) * kLdh + 16 * jp + 8 * (lane >> 4));
    mma_bf16(acc[2 * jp], a, b[0], b[1]);
    mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
  }
}

// The accumulators of two neighbouring 8-column tiles, rounded to bf16, as
// the A fragment of the 16 columns they cover.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void warp_range(int& lo, int& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// The 64-row tiles of the batch row's T positions that the block must walk,
// ascending, into `tiles`; returns their number.  A tile is walked unless
// the [min, max] of its segment ids is disjoint from that of the block's own
// rows [r0, r0 + 16 WARPS): then every pair of the two has P = 0.  An entry
// is 2 * tile + 1 where the tile needs its mask, 2 * tile where it is full
// and it and the block's rows carry one and the same id.
template <int WARPS>
__device__ __forceinline__ int tiles_to_walk(int* tiles, const int* __restrict__ sg, int r0,
                                             int t) {
  __shared__ int count;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = r0 + lane; r < min(r0 + 16 * WARPS, t); r += 32) {
    lo = min(lo, sg[r]);
    hi = max(hi, sg[r]);
  }
  warp_range(lo, hi);
  const int ntiles = (t + kTile - 1) / kTile;
  for (int tile = warp; tile < ntiles; tile += WARPS) {
    int tlo = INT_MAX, thi = INT_MIN;
    for (int r = tile * kTile + lane; r < min((tile + 1) * kTile, t); r += 32) {
      tlo = min(tlo, sg[r]);
      thi = max(thi, sg[r]);
    }
    warp_range(tlo, thi);
    const bool walk = !kTileSkip || (tlo <= hi && thi >= lo);
    const bool plain = kPlainTiles && (tile + 1) * kTile <= t && tlo == thi && lo == hi &&
                       tlo == lo;
    if (lane == 0) tiles[tile] = walk ? (plain ? 2 : 1) : 0;  // 0: not walked
  }
  __syncthreads();
  if (warp == 0) {  // compact the flags into the list, in place
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int tile = base + lane;
      const int flag = tile < ntiles ? tiles[tile] : 0;
      const unsigned m = __ballot_sync(0xffffffffu, flag != 0);
      if (flag != 0) tiles[n + __popc(m & ((1u << lane) - 1u))] = 2 * tile + (flag & 1);
      n += __popc(m);
    }
    if (lane == 0) count = n;
  }
  __syncthreads();
  return count;
}

// The block's own 16 WARPS rows of head a and, if kB, of head b staged
// through the ring's first stages and read into this warp's A fragments,
// while `tiles` is filled; returns the number of tiles to walk.  The ring is
// free on return.
template <int WARPS, bool kB = true>
__device__ __forceinline__ int load_resident(Stage* stages, int* tiles,
                                             uint32_t (&fa)[kD / 16][4],
                                             uint32_t (&fb)[kD / 16][4],
                                             const __nv_bfloat16* __restrict__ a,
                                             const __nv_bfloat16* __restrict__ b,
                                             const int* __restrict__ sg, int r0, int t) {
  constexpr int kOwnTiles = (16 * WARPS + kTile - 1) / kTile;
  static_assert(kOwnTiles <= kStages, "the block's own rows fit the ring");
#pragma unroll
  for (int i = 0; i < kOwnTiles; ++i)
    stream_tile<32 * WARPS, kB>(stages[i], a, b, sg, nullptr, nullptr, r0 + i * kTile, t);
  cp_async_commit();
  const int n = tiles_to_walk<WARPS>(tiles, sg, r0, t);
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Stage& own = stages[16 * warp / kTile];
  const int row = 16 * warp % kTile;
  load_a_frags(fa, own.a + row * kLdh, lane >> 2, lane & 3);
  if (kB) load_a_frags(fb, own.b + row * kLdh, lane >> 2, lane & 3);
  __syncthreads();
  return n;
}

// One (16 x 64) accumulator to rows `row` and `row + 8` of a bf16 head.
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[kD / 8][4], int row, int t,
                                           int tg) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= t) continue;
    __nv_bfloat16* orow = out + (size_t)(row + 8 * h) * kD + 2 * tg;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// One staged tile of 64 queries into a warp's dk and dv accumulators.
// `left` is the number of the tile's queries that exist; kMasked = false
// leaves out the validity tests (every pair of the tile is valid).
template <bool kMasked>
__device__ __forceinline__ void dkv_tile(float (&dka)[kD / 8][4], float (&dva)[kD / 8][4],
                                         const uint32_t (&ka)[kD / 16][4],
                                         const uint32_t (&va)[kD / 16][4], const Stage& st,
                                         const int (&segk)[2], int left, float scale,
                                         float scale_log2, int lane) {
  const int tg = lane & 3;
#pragma unroll kBwdUnroll
  for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 queries a step
    // S^T and dP^T: element e of column tile jj is key row g + 8 (e >> 1),
    // query 16 kk + 8 jj + 2 tg + (e & 1)
    float s[2][4], dp[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
      mma_rows(s[jj], ka, st.a + (16 * kk + 8 * jj) * kLdh, lane);
      mma_rows(dp[jj], va, st.b + (16 * kk + 8 * jj) * kLdh, lane);
      const int c = 16 * kk + 8 * jj + 2 * tg;  // even: the two columns as one load
      const float2 lse2 = *reinterpret_cast<const float2*>(st.lse + c);
      const float2 di2 = *reinterpret_cast<const float2*>(st.di + c);
      const int2 seg2 = *reinterpret_cast<const int2*>(st.seg + c);
      const float nlse[2] = {-kLog2e * lse2.x, -kLog2e * lse2.y};
      const float dic[2] = {di2.x, di2.y};
      const int segq[2] = {seg2.x, seg2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = e & 1, h = e >> 1;
        float p = ex2(fmaf(s[jj][e], scale_log2, nlse[o]));
        if (kMasked && !(c + o < left && segk[h] == segq[o])) p = 0.f;
        s[jj][e] = p;
        dp[jj][e] = (dp[jj][e] - dic[o]) * p * scale;
      }
    }
    uint32_t pa[4], dsa[4];
    pack_a(pa, s);
    pack_a(dsa, dp);
    mma_cols(dva, pa, st.b + 16 * kk * kLdh, lane);   // dV += P^T dO
    mma_cols(dka, dsa, st.a + 16 * kk * kLdh, lane);  // dK += dS^T Q
  }
}

__global__ void __launch_bounds__(32 * kDkvWarps, kDkvBlocks)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                     const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ di, int heads, int t, float scale,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stages = reinterpret_cast<Stage*>(smem_raw);
  int* tiles = reinterpret_cast<int*>(stages + kStages);
  constexpr int kThr = 32 * kDkvWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const int k0 = blockIdx.x * 16 * kDkvWarps;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  const float* lse_h = lse + (size_t)bh * t;
  const float* di_h = di + (size_t)bh * t;
  const float scale_log2 = scale * kLog2e;
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  const int n = load_resident<kDkvWarps>(stages, tiles, ka, va, k + head, v + head, sg, k0, t);
  int segk[2];  // of this thread's two key rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + 16 * warp + g + 8 * h;
    segk[h] = row < t ? sg[row] : 0;
  }
  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stream_tile<kThr>(stages[s], q + head, dout + head, sg, lse_h, di_h,
                        (tiles[s] >> 1) * kTile, t);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile i has landed
    __syncthreads();  // so has everyone's, and tile i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n)
      stream_tile<kThr>(stages[nx % kStages], q + head, dout + head, sg, lse_h, di_h,
                        (tiles[nx] >> 1) * kTile, t);
    cp_async_commit();
    const Stage& st = stages[i % kStages];
    const int left = t - (tiles[i] >> 1) * kTile;  // queries of this tile that exist
    if (tiles[i] & 1)
      dkv_tile<true>(dka, dva, ka, va, st, segk, left, scale, scale_log2, lane);
    else
      dkv_tile<false>(dka, dva, ka, va, st, segk, left, scale, scale_log2, lane);
  }
  store_rows(dk + head, dka, k0 + 16 * warp + g, t, tg);
  store_rows(dv + head, dva, k0 + 16 * warp + g, t, tg);
}

// One staged tile of 64 keys into a warp's dq accumulator; `left` and
// kMasked as in dkv_tile.  nlse is -lse log2(e) of the thread's two rows.
template <bool kMasked>
__device__ __forceinline__ void dq_tile(float (&acc)[kD / 8][4],
                                        const uint32_t (&qa)[kD / 16][4],
                                        const uint32_t (&doa)[kD / 16][4], const Stage& st,
                                        const int (&segq)[2], const float (&nlse)[2],
                                        const float (&dir)[2], int left, float scale,
                                        float scale_log2, int lane) {
  const int tg = lane & 3;
#pragma unroll kBwdUnroll
  for (int kk = 0; kk < kTile / 16; ++kk) {  // 16 keys a step
    // S and dP: element e of column tile jj is query row g + 8 (e >> 1),
    // key 16 kk + 8 jj + 2 tg + (e & 1)
    float s[2][4], dp[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
      mma_rows(s[jj], qa, st.a + (16 * kk + 8 * jj) * kLdh, lane);
      mma_rows(dp[jj], doa, st.b + (16 * kk + 8 * jj) * kLdh, lane);
      const int c = 16 * kk + 8 * jj + 2 * tg;  // even: the two columns as one load
      const int2 seg2 = *reinterpret_cast<const int2*>(st.seg + c);
      const int segk[2] = {seg2.x, seg2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = e & 1, h = e >> 1;
        float p = ex2(fmaf(s[jj][e], scale_log2, nlse[h]));
        if (kMasked && !(c + o < left && segq[h] == segk[o])) p = 0.f;
        dp[jj][e] = (dp[jj][e] - dir[h]) * p * scale;
      }
    }
    uint32_t dsa[4];
    pack_a(dsa, dp);
    mma_cols(acc, dsa, st.a + 16 * kk * kLdh, lane);  // dQ += dS K
  }
}

__global__ void __launch_bounds__(32 * kDqWarps, kDqBlocks)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ di, int heads, int t, float scale,
                    __nv_bfloat16* __restrict__ dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stages = reinterpret_cast<Stage*>(smem_raw);
  int* tiles = reinterpret_cast<int*>(stages + kStages);
  constexpr int kThr = 32 * kDqWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * 16 * kDqWarps;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  const float scale_log2 = scale * kLog2e;
  uint32_t qa[kD / 16][4], doa[kD / 16][4];
  const int n = load_resident<kDqWarps>(stages, tiles, qa, doa, q + head, dout + head, sg, q0, t);
  int segq[2];            // of this thread's two query rows,
  float nlse[2], dir[2];  // their -lse log2(e) and their di
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    const bool ok = row < t;
    segq[h] = ok ? sg[row] : 0;
    nlse[h] = ok ? -kLog2e * lse[(size_t)bh * t + row] : 0.f;
    dir[h] = ok ? di[(size_t)bh * t + row] : 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stream_tile<kThr>(stages[s], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[s] >> 1) * kTile, t);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile i has landed
    __syncthreads();  // so has everyone's, and tile i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n)
      stream_tile<kThr>(stages[nx % kStages], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[nx] >> 1) * kTile, t);
    cp_async_commit();
    const Stage& st = stages[i % kStages];
    const int left = t - (tiles[i] >> 1) * kTile;  // keys of this tile that exist
    if (tiles[i] & 1)
      dq_tile<true>(acc, qa, doa, st, segq, nlse, dir, left, scale, scale_log2, lane);
    else
      dq_tile<false>(acc, qa, doa, st, segq, nlse, dir, left, scale, scale_log2, lane);
  }
  store_rows(dq + head, acc, q0 + 16 * warp + g, t, tg);
}

// One staged tile of 64 keys into a warp's output accumulator and its two
// rows' running max m (base 2, of the scaled scores) and sum l.  `left` is
// the number of the tile's keys that exist; kMasked = false leaves out the
// validity tests (every pair of the tile is valid).
template <bool kMasked>
__device__ __forceinline__ void fwd_tile(float (&acc)[kD / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qa)[kD / 16][4], const Stage& st,
                                         const int (&segq)[2], int left, float scale_log2,
                                         int lane) {
  const int tg = lane & 3;
  // S = Q K^T: element e of column tile j is row g + 8 (e >> 1), key
  // 8 j + 2 tg + (e & 1); an invalid pair's score becomes -inf
  float s[kTile / 8][4];
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mma_rows(s[j], qa, st.a + 8 * j * kLdh, lane);
    const int c = 8 * j + 2 * tg;  // even: the two columns' ids as one load
    const int2 seg2 = *reinterpret_cast<const int2*>(st.seg + c);
    const int segk[2] = {seg2.x, seg2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = e & 1, h = e >> 1;
      if (kMasked && !(c + o < left && segq[h] == segk[o])) s[j][e] = -CUDART_INF_F;
      mx[h] = fmaxf(mx[h], s[j][e]);
    }
  }
  float alpha[2], nm[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    // -inf while the row has met no valid key: then l and O stay 0
    const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[h] = ex2(m[h] - base);
    nm[h] = -base;
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], scale_log2, nm[e >> 1]));  // P, unrounded for the row sum
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = alpha[h] * l[h] + sum[h];
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
  // O += P V: the accumulators of key tiles 2 kk and 2 kk + 1 are the A
  // fragment of keys 16 kk .. 16 kk + 15
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    mma_cols(acc, pa, st.b + 16 * kk * kLdh, lane);
  }
}

__global__ void __launch_bounds__(32 * kFwdWarps, kFwdBlocks)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg, int heads,
                     int t, float scale, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stages = reinterpret_cast<Stage*>(smem_raw);
  int* tiles = reinterpret_cast<int*>(stages + kStages);
  constexpr int kThr = 32 * kFwdWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * 16 * kFwdWarps;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  const float scale_log2 = scale * kLog2e;
  uint32_t qa[kD / 16][4], unused[kD / 16][4];
  const int n =
      load_resident<kFwdWarps, false>(stages, tiles, qa, unused, q + head, nullptr, sg, q0, t);
  int segq[2];  // of this thread's two query rows,
  float m[2], l[2];  // their running max and sum
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    segq[h] = row < t ? sg[row] : 0;
    m[h] = -CUDART_INF_F;
    l[h] = 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stream_tile<kThr>(stages[s], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[s] >> 1) * kTile, t);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile i has landed
    __syncthreads();  // so has everyone's, and tile i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n)
      stream_tile<kThr>(stages[nx % kStages], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[nx] >> 1) * kTile, t);
    cp_async_commit();
    const Stage& st = stages[i % kStages];
    const int left = t - (tiles[i] >> 1) * kTile;  // keys of this tile that exist
    if (tiles[i] & 1)
      fwd_tile<true>(acc, m, l, qa, st, segq, left, scale_log2, lane);
    else
      fwd_tile<false>(acc, m, l, qa, st, segq, left, scale_log2, lane);
  }
  const int row = q0 + 16 * warp + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / l[h];  // l > 0 below T: a row meets its own key
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      acc[j][2 * h] *= inv;
      acc[j][2 * h + 1] *= inv;
    }
    if (lse != nullptr && tg == 0 && row + 8 * h < t)
      lse[(size_t)bh * t + row + 8 * h] = (m[h] + log2f(l[h])) * 0.693147180559945309f;
  }
  store_rows(o + head, acc, row, t, tg);
}

// The f32 kernels run on the tensor cores too, in 3xTF32 (the forward has
// a note of its own below the pair):
// mma.sync m16n8k8 with tf32 operands and f32 accumulation.  Each operand x
// is split into hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties
// away), and a product is lo.hi + hi.lo, then hi.hi, into one f32
// accumulator (CUTLASS's OpMultiplyAddFastF32, which PyTorch's f32
// attention backward uses too): the lo.lo term left out is below 2^-22 of the
// product, so the pair keeps f32 accuracy at 165 TFLOP/s (495 / 3) where
// plain f32 FMA has 67.  P and dS are not rounded (f32 in, f32 out).
//
// The shape is the bf16 pair's: a block of 4 warps owns 64 rows (a warp 16
// key rows for dk/dv, 16 query rows for dq), walks the other side's tiles
// from tiles_to_walk in ascending order through the cp.async ring, one
// barrier a tile, masked and untested tiles as there, no atomics.  What
// differs:
//
// - Registers.  Split into hi and lo, a warp's 16 x 64 resident operand
//   would take 64 registers a thread, two of them 128 before the
//   accumulators.  So the block's own rows stay in shared memory (a stage
//   of their own, beside the ring: 3 x 35.6 KB a block, 2 blocks an SM)
//   and are split as their fragments are loaded.  With S and dP of a whole
//   64-row tile in registers the kernels take ~240 registers without a
//   spill; walking a tile 32 rows at a time took ~200 but was 8% slower,
//   as it loads and splits the own rows twice a tile.
// - The splits, not the mma, set the time: every fragment is split where it
//   is loaded (a warp splits all of the streamed tile, four warps the same
//   values).  cvt.rna.tf32.f32 is a compare-and-select sequence in SASS;
//   two integer operations give the same bits (split_tf32), and took the
//   pair from 4.48 to 3.56 ms at (8, 12, 1728, 64) on an H100.
// - One body of code: the mask is a runtime flag, not a template as in
//   bf16, and the d loop of the score products is unrolled twice, not 8
//   times (7% faster).  With two instances of the unrolled tile the
//   untested path was slower than masking every tile (5.24 vs 4.91 ms),
//   which points at the instruction cache.
// - Accumulation.  An mma aligns its products to the accumulator and drops
//   the bits below, toward zero; 648 mma straight into dk's accumulator at
//   T 1728 lost 2.4e-5 of its largest entry.  Each tile's products are
//   summed from zero apart and added to the accumulator by an FADD, which
//   rounds (mma_step).
// - Fragments.  A tf32 fragment is 32-bit words: ldmatrix (b16) reads an
//   8 x 8 b16 matrix as 8 rows of 4 words and hands lane i the word at row
//   i / 4, column i % 4, which is what the A fragment and the B fragment of
//   a score product (row-major rows, contracted over d) take.  The output
//   products contract over the streamed rows, and ldmatrix.trans moves
//   16-bit values, so their B fragments are plain 8-byte loads.
// - P^T and dS^T (dk/dv) and dS (dq) stay in registers: the accumulator
//   gives a thread columns 2t and 2t + 1 of an 8-column tile, the A
//   fragment wants k-slots t and t + 4, so the contraction index is
//   permuted instead of shuffled: column 2t is k-slot t, 2t + 1 is k-slot
//   t + 4, and the B fragment reads streamed rows 2t and 2t + 1.  Its n
//   index is permuted too: column g of n-tile 2m + h is d = 16m + 2g + h,
//   so one 8-byte load gives the fragments of n-tiles 2m and 2m + 1 and the
//   thread's outputs of a row are d 16m + 4t .. + 3, one 16-byte store.
// - Banks.  Staged rows are kLdf = 68 floats apart (272 bytes, 16-byte
//   aligned for cp.async and ldmatrix): the 8 rows of an ldmatrix matrix
//   start 4 words apart, and the 8-byte loads of rows 2t and 2t + 1 at
//   column 2g fall on 16 distinct bank pairs in each half warp.
// - ex2.approx.ftz as in bf16 (relative error about 2^-22): a P below
//   2^-126 becomes 0.
constexpr int kF32Warps = 4;   // 64 own rows: one stage
constexpr int kF32Blocks = 2;  // blocks an SM: 2 x 106 KB (the pair), 224-241 registers
constexpr int kLdf = kD + 4;  // f32 row of a staged tile: 272 bytes
using StageF = StageOf<float, kLdf>;
static_assert(sizeof(StageF) % 16 == 0, "stages stay 16-byte aligned");

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

#ifndef ATK_F32_SPLIT
#define ATK_F32_SPLIT 1  // 0: split by cvt.rna.tf32.f32 (the same bits, slower)
#endif

// x = hi + lo, each a tf32 value rounded to nearest, ties away from zero.
// cvt.rna.tf32.f32 compiles to a compare-and-select sequence that guards
// NaN and infinity; adding half a tf32 ulp to the bits and clearing the 13
// low ones gives the same value for every finite x in two integer
// operations.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return ATK_F32_SPLIT ? (__float_as_uint(x) + 0x1000u) & 0xffffe000u : to_tf32(x);
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));  // x - hi is exact
}

// A fragment (or a pair of B fragments) in hi and lo.
struct Frag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ Frag split_frag(float x0, float x1, float x2, float x3) {
  Frag f;
  split_tf32(x0, f.hi[0], f.lo[0]);
  split_tf32(x1, f.hi[1], f.lo[1]);
  split_tf32(x2, f.hi[2], f.lo[2]);
  split_tf32(x3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ Frag split_words(const uint32_t (&w)[4]) {
  return split_frag(__uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]),
                    __uint_as_float(w[3]));
}

// c += A.B in 3xTF32, B's fragment words j0 and j0 + 1 of b: the small
// terms first, then hi.hi.
__device__ __forceinline__ void mma3(float (&c)[4], const Frag& a, const Frag& b, int j0) {
  mma_tf32(c, a.lo, b.hi[j0], b.hi[j0 + 1]);
  mma_tf32(c, a.hi, b.lo[j0], b.lo[j0 + 1]);
  mma_tf32(c, a.hi, b.hi[j0], b.hi[j0 + 1]);
}

// The A fragment of k step kk (d 8 kk .. 8 kk + 7) of the 16 staged rows at
// `rows`, split.
__device__ __forceinline__ Frag own_frag(const float* rows, int kk, int lane) {
  uint32_t w[4];
  ldmatrix_x4(w, rows + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdf + 8 * kk + 4 * (lane >> 4));
  return split_words(w);
}

// The B fragments of k step kk for the two 8-row n-tiles of the 16 staged
// rows at `rows` (contracted over d): words 0, 1 of the first, 2, 3 of the
// second, split.
__device__ __forceinline__ Frag row_frags(const float* rows, int kk, int lane) {
  uint32_t w[4];
  ldmatrix_x4(w, rows + ((lane & 7) + 8 * (lane >> 4)) * kLdf + 8 * kk + 4 * ((lane >> 3) & 1));
  return split_words(w);
}

// acc (16 x 64, the permuted columns) += A (16 x 8, fragment a) . X for the
// 8 staged rows of X at `rows` (k-slot t is row 2t, t + 4 row 2t + 1).
__device__ __forceinline__ void mma_cols_f32(float (&acc)[kD / 8][4], const Frag& a,
                                             const float* rows, int lane) {
  const float* r0 = rows + 2 * (lane & 3) * kLdf + 2 * (lane >> 2);
#pragma unroll
  for (int m = 0; m < kD / 16; ++m) {
    const float2 x0 = *reinterpret_cast<const float2*>(r0 + 16 * m);
    const float2 x1 = *reinterpret_cast<const float2*>(r0 + kLdf + 16 * m);
    const Frag b = split_frag(x0.x, x1.x, x0.y, x1.y);
    mma3(acc[2 * m], a, b, 0);
    mma3(acc[2 * m + 1], a, b, 2);
  }
}

// S (16 x 64) = A . X^T and S2 = A2 . X2^T over d, for the resident 16
// rows `own`, `own2` and the 64 staged rows at `x`, `x2`.
__device__ __forceinline__ void score_pair(float (&s)[kTile / 8][4], float (&s2)[kTile / 8][4],
                                           const float* own, const float* own2, const float* x,
                                           const float* x2, int lane) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll 2  // of 8: see "One body of code" above
  for (int kk = 0; kk < kD / 8; ++kk) {
    const Frag a = own_frag(own, kk, lane);
    const Frag a2 = own_frag(own2, kk, lane);
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      const Frag b = row_frags(x + 16 * np * kLdf, kk, lane);
      mma3(s[2 * np], a, b, 0);
      mma3(s[2 * np + 1], a, b, 2);
      const Frag b2 = row_frags(x2 + 16 * np * kLdf, kk, lane);
      mma3(s2[2 * np], a2, b2, 0);
      mma3(s2[2 * np + 1], a2, b2, 2);
    }
  }
}

// The A fragment of an accumulator tile's 8 columns in the permuted order.
__device__ __forceinline__ Frag acc_frag(const float (&c)[4]) {
  return split_frag(c[0], c[2], c[1], c[3]);
}

// acc (16 x 64) += A . X over the 64 staged rows at `rows`, A the
// accumulator tiles a (16 x 64): summed from zero first, then added to acc
// by FADD (see "Accumulation" above).
__device__ __forceinline__ void mma_step(float (&acc)[kD / 8][4], const float (&a)[kTile / 8][4],
                                         const float* rows, int lane) {
  float part[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) mma_cols_f32(part, acc_frag(a[j]), rows + 8 * j * kLdf, lane);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// One staged tile of 64 queries into a warp's dk and dv accumulators, from
// its 16 key rows `ks`, `vs`; `left` as in dkv_tile, `masked` false where
// every pair of the tile is valid.  The mask is a runtime flag, not two
// instances as in bf16: one body of code keeps the loop in the instruction
// cache.
__device__ __forceinline__ void dkv_tile_f32(float (&dka)[kD / 8][4], float (&dva)[kD / 8][4],
                                             const float* ks, const float* vs, const StageF& st,
                                             const int (&segk)[2], int left, bool masked,
                                             float scale, float scale_log2, int lane) {
  const int tg = lane & 3;
  // S^T and dP^T: element e of column tile j is key row g + 8 (e >> 1),
  // query 8 j + 2 tg + (e & 1)
  float s[kTile / 8][4], dp[kTile / 8][4];
  score_pair(s, dp, ks, vs, st.a, st.b, lane);
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int c = 8 * j + 2 * tg;  // even: the two columns as one load
    const float2 lse2 = *reinterpret_cast<const float2*>(st.lse + c);
    const float2 di2 = *reinterpret_cast<const float2*>(st.di + c);
    const int2 seg2 = *reinterpret_cast<const int2*>(st.seg + c);
    const float nlse[2] = {-kLog2e * lse2.x, -kLog2e * lse2.y};
    const float dic[2] = {di2.x, di2.y};
    const int segq[2] = {seg2.x, seg2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = e & 1, h = e >> 1;
      float p = ex2(fmaf(s[j][e], scale_log2, nlse[o]));
      if (masked && !(c + o < left && segk[h] == segq[o])) p = 0.f;
      s[j][e] = p;
      dp[j][e] = (dp[j][e] - dic[o]) * p * scale;
    }
  }
  mma_step(dva, s, st.b, lane);   // dV += P^T dO
  mma_step(dka, dp, st.a, lane);  // dK += dS^T Q
}

// One (16 x 64, permuted columns) accumulator to rows `row` and `row + 8`
// of an f32 head.
__device__ __forceinline__ void store_rows_f32(float* __restrict__ out,
                                               const float (&acc)[kD / 8][4], int row, int t,
                                               int tg) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= t) continue;
    float* orow = out + (size_t)(row + 8 * h) * kD + 4 * tg;
#pragma unroll
    for (int m = 0; m < kD / 16; ++m)
      *reinterpret_cast<float4*>(orow + 16 * m) =
          make_float4(acc[2 * m][2 * h], acc[2 * m + 1][2 * h], acc[2 * m][2 * h + 1],
                      acc[2 * m + 1][2 * h + 1]);
  }
}

// The block's own 64 rows of head a and, if kB, of head b into `own` while
// `tiles` is filled; returns the number of tiles to walk.
template <bool kB = true>
__device__ __forceinline__ int load_own(StageF& own, int* tiles, const float* __restrict__ a,
                                        const float* __restrict__ b, const int* __restrict__ sg,
                                        int r0, int t) {
  static_assert(16 * kF32Warps == kTile, "the block's own rows are one stage");
  stream_tile<32 * kF32Warps, kB>(own, a, b, sg, nullptr, nullptr, r0, t);
  cp_async_commit();
  const int n = tiles_to_walk<kF32Warps>(tiles, sg, r0, t);
  cp_async_wait<0>();
  __syncthreads();
  return n;
}

__global__ void __launch_bounds__(32 * kF32Warps, kF32Blocks)
flash_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ seg,
                      const float* __restrict__ lse, const float* __restrict__ dout,
                      const float* __restrict__ di, int heads, int t, float scale,
                      float* __restrict__ dk, float* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageF* stages = reinterpret_cast<StageF*>(smem_raw);
  StageF& own = stages[kStages];
  int* tiles = reinterpret_cast<int*>(stages + kStages + 1);
  constexpr int kThr = 32 * kF32Warps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const int k0 = blockIdx.x * kTile;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  const float* lse_h = lse + (size_t)bh * t;
  const float* di_h = di + (size_t)bh * t;
  const float scale_log2 = scale * kLog2e;
  const int n = load_own(own, tiles, k + head, v + head, sg, k0, t);
  const float* ks = own.a + 16 * warp * kLdf;
  const float* vs = own.b + 16 * warp * kLdf;
  int segk[2];  // of this thread's two key rows
#pragma unroll
  for (int h = 0; h < 2; ++h) segk[h] = own.seg[16 * warp + g + 8 * h];
  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stream_tile<kThr>(stages[s], q + head, dout + head, sg, lse_h, di_h,
                        (tiles[s] >> 1) * kTile, t);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile i has landed
    __syncthreads();  // so has everyone's, and tile i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n)
      stream_tile<kThr>(stages[nx % kStages], q + head, dout + head, sg, lse_h, di_h,
                        (tiles[nx] >> 1) * kTile, t);
    cp_async_commit();
    const StageF& st = stages[i % kStages];
    const int left = t - (tiles[i] >> 1) * kTile;  // queries of this tile that exist
    dkv_tile_f32(dka, dva, ks, vs, st, segk, left, tiles[i] & 1, scale, scale_log2, lane);
  }
  store_rows_f32(dk + head, dka, k0 + 16 * warp + g, t, tg);
  store_rows_f32(dv + head, dva, k0 + 16 * warp + g, t, tg);
}

// One staged tile of 64 keys into a warp's dq accumulator, from its 16
// query rows `qs`, `dos`; nlse is -lse log2(e) of the thread's two rows;
// `left` and `masked` as in dkv_tile_f32.
__device__ __forceinline__ void dq_tile_f32(float (&acc)[kD / 8][4], const float* qs,
                                            const float* dos, const StageF& st,
                                            const int (&segq)[2], const float (&nlse)[2],
                                            const float (&dir)[2], int left, bool masked,
                                            float scale, float scale_log2, int lane) {
  const int tg = lane & 3;
  // S and dP: element e of column tile j is query row g + 8 (e >> 1), key
  // 8 j + 2 tg + (e & 1)
  float s[kTile / 8][4], dp[kTile / 8][4];
  score_pair(s, dp, qs, dos, st.a, st.b, lane);
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int c = 8 * j + 2 * tg;  // even: the two columns as one load
    const int2 seg2 = *reinterpret_cast<const int2*>(st.seg + c);
    const int segk[2] = {seg2.x, seg2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = e & 1, h = e >> 1;
      float p = ex2(fmaf(s[j][e], scale_log2, nlse[h]));
      if (masked && !(c + o < left && segq[h] == segk[o])) p = 0.f;
      dp[j][e] = (dp[j][e] - dir[h]) * p * scale;
    }
  }
  mma_step(acc, dp, st.a, lane);  // dQ += dS K
}

__global__ void __launch_bounds__(32 * kF32Warps, kF32Blocks)
flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     const float* __restrict__ lse, const float* __restrict__ dout,
                     const float* __restrict__ di, int heads, int t, float scale,
                     float* __restrict__ dq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageF* stages = reinterpret_cast<StageF*>(smem_raw);
  StageF& own = stages[kStages];
  int* tiles = reinterpret_cast<int*>(stages + kStages + 1);
  constexpr int kThr = 32 * kF32Warps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  const float scale_log2 = scale * kLog2e;
  const int n = load_own(own, tiles, q + head, dout + head, sg, q0, t);
  const float* qs = own.a + 16 * warp * kLdf;
  const float* dos = own.b + 16 * warp * kLdf;
  int segq[2];            // of this thread's two query rows,
  float nlse[2], dir[2];  // their -lse log2(e) and their di
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    const bool ok = row < t;
    segq[h] = own.seg[16 * warp + g + 8 * h];
    nlse[h] = ok ? -kLog2e * lse[(size_t)bh * t + row] : 0.f;
    dir[h] = ok ? di[(size_t)bh * t + row] : 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stream_tile<kThr>(stages[s], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[s] >> 1) * kTile, t);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile i has landed
    __syncthreads();  // so has everyone's, and tile i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n)
      stream_tile<kThr>(stages[nx % kStages], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[nx] >> 1) * kTile, t);
    cp_async_commit();
    const StageF& st = stages[i % kStages];
    const int left = t - (tiles[i] >> 1) * kTile;  // keys of this tile that exist
    dq_tile_f32(acc, qs, dos, st, segq, nlse, dir, left, tiles[i] & 1, scale, scale_log2, lane);
  }
  store_rows_f32(dq + head, acc, q0 + 16 * warp + g, t, tg);
}

// The f32 forward in 3xTF32 (flash_fwd_tf32_kernel) is the dq kernel with
// one score product instead of two and the bf16 forward's online softmax
// (fwd_tile) in place of the dS formula: a block of 4 warps owns 64 query
// rows (a warp 16), streams K and V through the ring from tiles_to_walk in
// ascending order, one barrier a tile, masked and untested tiles by the
// runtime flag in one body of code, no atomics.  Per 64-key tile a warp
// takes 192 tf32 mma for S = Q.K^T (mma3 on row_frags) and 192 for
// O += P.V, where dq takes 576; P stays in registers as the A fragments of
// P.V (acc_frag, V's rows 2t and 2t + 1 as the B fragments) and is not
// rounded (f32 in, f32 out).  What the forward adds:
//
// - The online softmax in base 2: scores times sm_scale * log2(e), ex2, a
//   quad shuffle for the row max and the row sum.  An invalid pair (another
//   segment, or a key past T) gets -inf before the row max, and a row that
//   has met no valid key keeps base 0, so alpha = ex2(m - base) is
//   ex2(-inf) = 0, never NaN, on its first valid tile.  A row meets tiles
//   without a valid key even with the tile skip: a tile is walked when it
//   shares a segment with any of the block's rows.  The plain version adds
//   the finite MASK_VALUE instead, and exp(MASK_VALUE - m) is exactly 0 in
//   f32 for every row below T, since every such row meets its own key: the
//   two agree.  The logsumexp is (m + log2 l) ln 2, as in bf16.
// - Accumulation.  acc is rescaled by alpha first, then the tile's P.V,
//   summed from zero apart, is added by FADD (mma_step): 27 tiles straight
//   into the mma accumulator would truncate, as dk's 648 mma did.
// - Q, the one resident operand, passes through the ring's first stage and
//   is split once into registers (8 k steps x 4 words x (hi, lo), 64
//   registers; the score loop over d is unrolled fully to keep them
//   there), so the forward needs no own stage: 71 KB of shared memory a
//   block, 224 registers, 2 blocks an SM.  Q kept in an own stage and
//   split as it is read, as in the pair, took 192 registers and was 2.7%
//   slower at (64, 12, 1728, 64) on an H100 (7.88 vs 7.67 ms); at 3 blocks
//   an SM the 168-register cap spills (7.72 ms).

// S (16 x 64) += k step kk (d 8 kk .. 8 kk + 7) of A . X^T, for A's split
// fragment a and the 64 staged rows at `x`: score_pair's inner loop for one
// product (score_pair built on it took dk/dv from 239 to 255 registers).
__device__ __forceinline__ void score_step(float (&s)[kTile / 8][4], const Frag& a,
                                           const float* x, int kk, int lane) {
#pragma unroll
  for (int np = 0; np < kTile / 16; ++np) {
    const Frag b = row_frags(x + 16 * np * kLdf, kk, lane);
    mma3(s[2 * np], a, b, 0);
    mma3(s[2 * np + 1], a, b, 2);
  }
}

// One staged tile of 64 keys into a warp's output accumulator and its two
// rows' running max m (base 2, of the scaled scores) and sum l, from Q's
// split fragments qf; `left` and `masked` as in dkv_tile_f32.
__device__ __forceinline__ void fwd_tile_f32(float (&acc)[kD / 8][4], float (&m)[2],
                                             float (&l)[2], const Frag (&qf)[kD / 8],
                                             const StageF& st, const int (&segq)[2], int left,
                                             bool masked, float scale_log2, int lane) {
  const int tg = lane & 3;
  // S = Q K^T: element e of column tile j is query row g + 8 (e >> 1), key
  // 8 j + 2 tg + (e & 1)
  float s[kTile / 8][4];
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) score_step(s, qf[kk], st.a, kk, lane);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
    const int c = 8 * j + 2 * tg;  // even: the two columns' ids as one load
    const int2 seg2 = *reinterpret_cast<const int2*>(st.seg + c);
    const int segk[2] = {seg2.x, seg2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = e & 1, h = e >> 1;
      if (masked && !(c + o < left && segq[h] == segk[o])) s[j][e] = -CUDART_INF_F;
      mx[h] = fmaxf(mx[h], s[j][e]);
    }
  }
  float alpha[2], nm[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    // -inf while the row has met no valid key: then l and O stay 0
    const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[h] = ex2(m[h] - base);
    nm[h] = -base;
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], scale_log2, nm[e >> 1]));  // P
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = alpha[h] * l[h] + sum[h];
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
  mma_step(acc, s, st.b, lane);  // O += P V
}

__global__ void __launch_bounds__(32 * kF32Warps, kF32Blocks)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ seg, int heads, int t,
                      float scale, float* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StageF* stages = reinterpret_cast<StageF*>(smem_raw);
  int* tiles = reinterpret_cast<int*>(stages + kStages);
  constexpr int kThr = 32 * kF32Warps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  const float scale_log2 = scale * kLog2e;
  const int n = load_own<false>(stages[0], tiles, q + head, nullptr, sg, q0, t);
  int segq[2];       // of this thread's two query rows,
  float m[2], l[2];  // their running max and sum
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    segq[h] = stages[0].seg[16 * warp + g + 8 * h];
    m[h] = -CUDART_INF_F;
    l[h] = 0.f;
  }
  Frag qf[kD / 8];  // this warp's 16 rows of Q, split
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk)
    qf[kk] = own_frag(stages[0].a + 16 * warp * kLdf, kk, lane);
  __syncthreads();  // the ring's first stage is free
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n)
      stream_tile<kThr>(stages[s], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[s] >> 1) * kTile, t);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile i has landed
    __syncthreads();  // so has everyone's, and tile i - 1 is consumed
    const int nx = i + kStages - 1;
    if (nx < n)
      stream_tile<kThr>(stages[nx % kStages], k + head, v + head, sg, nullptr, nullptr,
                        (tiles[nx] >> 1) * kTile, t);
    cp_async_commit();
    const StageF& st = stages[i % kStages];
    const int left = t - (tiles[i] >> 1) * kTile;  // keys of this tile that exist
    fwd_tile_f32(acc, m, l, qf, st, segq, left, tiles[i] & 1, scale_log2, lane);
  }
  const int row = q0 + 16 * warp + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / l[h];  // l > 0 below T: a row meets its own key
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      acc[j][2 * h] *= inv;
      acc[j][2 * h + 1] *= inv;
    }
    if (lse != nullptr && tg == 0 && row + 8 * h < t)
      lse[(size_t)bh * t + row + 8 * h] = (m[h] + log2f(l[h])) * 0.693147180559945309f;
  }
  store_rows_f32(o + head, acc, row, t, tg);
}

template <typename K, typename... Args>
int launch(K kernel, int tiles, int batch, int heads, int threads, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = atk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, batch * heads), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// Launch one of the tensor-core kernels on T elements (bf16, or f32 for
// the 3xTF32 kernels): `warps` x 16 owned rows a block; `stages` bytes of
// ring (and own rows) and the list of tiles to walk in dynamic shared
// memory.  cp.async copies 16 bytes at a time, so the heads (q, k, v and,
// unless null, dout) must be 16-byte aligned: a misaligned one is refused.
template <typename T, typename K, typename... Args>
int launch_rows(K kernel, int warps, size_t stages, int batch, int heads, int t, void* stream,
                const void* q, const void* k, const void* v, const void* dout, Args... args) {
  for (const void* p : {q, k, v, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = stages + sizeof(int) * ((t + kTile - 1) / kTile);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kernel, (t + 16 * warps - 1) / (16 * warps), batch, heads, 32 * warps, smem,
                stream, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), args...);
}

template <typename K, typename... Args>
int launch_mma(K kernel, int warps, Args... args) {
  return launch_rows<__nv_bfloat16>(kernel, warps, kStages * sizeof(Stage), args...);
}

// The 3xTF32 kernels: the ring and `own` stages of the block's own rows.
template <typename K, typename... Args>
int launch_tf32(K kernel, int own, Args... args) {
  return launch_rows<float>(kernel, kF32Warps, (kStages + own) * sizeof(StageF), args...);
}

bool bad_shape(int batch, int heads, int t, int dh) {
  return batch <= 0 || heads <= 0 || t <= 0 || dh != kD || batch * heads > 65535;
}

}  // namespace

// B5 forward.  lse is null (no residual) or the (B, nh, T) row logsumexp.
ATK_EXPORT int atk_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                             int batch, int heads, int t, int dh, float scale, int bf16,
                             void* o, float* lse, void* stream) {
  if (bad_shape(batch, heads, t, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return launch_mma(flash_fwd_mma_kernel, kFwdWarps, batch, heads, t, stream, q, k, v, nullptr,
                      seg, heads, t, scale, static_cast<__nv_bfloat16*>(o), lse);
  return launch_tf32(flash_fwd_tf32_kernel, 0, batch, heads, t, stream, q, k, v, nullptr, seg,
                     heads, t, scale, static_cast<float*>(o), lse);
}

// B5 backward, dk and dv.
ATK_EXPORT int atk_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* seg,
                                 const float* lse, const void* dout, const float* di,
                                 int batch, int heads, int t, int dh, float scale, int bf16,
                                 void* dk, void* dv, void* stream) {
  if (bad_shape(batch, heads, t, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_mma(flash_dkv_mma_kernel, kDkvWarps, batch, heads, t, stream, q, k, v, dout,
                      seg, lse, static_cast<const T*>(dout), di, heads, t, scale,
                      static_cast<T*>(dk), static_cast<T*>(dv));
  }
  using T = float;
  return launch_tf32(flash_dkv_tf32_kernel, 1, batch, heads, t, stream, q, k, v, dout, seg, lse,
                     static_cast<const T*>(dout), di, heads, t, scale, static_cast<T*>(dk),
                     static_cast<T*>(dv));
}

// B5 backward, dq.
ATK_EXPORT int atk_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg,
                                const float* lse, const void* dout, const float* di,
                                int batch, int heads, int t, int dh, float scale, int bf16,
                                void* dq, void* stream) {
  if (bad_shape(batch, heads, t, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_mma(flash_dq_mma_kernel, kDqWarps, batch, heads, t, stream, q, k, v, dout,
                      seg, lse, static_cast<const T*>(dout), di, heads, t, scale,
                      static_cast<T*>(dq));
  }
  using T = float;
  return launch_tf32(flash_dq_tf32_kernel, 1, batch, heads, t, stream, q, k, v, dout, seg, lse,
                     static_cast<const T*>(dout), di, heads, t, scale, static_cast<T*>(dq));
}
