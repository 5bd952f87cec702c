// Shared pieces of the port's kernels: the C export macro, the error-string
// export, the cp.async copies, the (score, index) order of the nearest-
// centroid argmin (B1 and B2), the normalize + scoring + argmin that
// kernel B1 (tokenizer.cu) ends with (B2, vq.cu, has its own), the bf16
// tensor-core pieces (mma.sync, ldmatrix, the hi/lo split) and the tiered
// centroid-distance product that B1 and B2 share at the bf16x3 and default
// tiers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#define ATK_EXPORT extern "C" __attribute__((visibility("default")))

ATK_EXPORT const char* atk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace atk {

constexpr float kEps = 1e-10f;       // l2 normalize: x / (||x|| + eps)
constexpr int kThreads = 256;        // threads of every argmin block
constexpr int kColThreads = 16;      // lanes that split a chunk's centroids
constexpr int kRowThreads = kThreads / kColThreads;  // 16 row groups
constexpr int kChunk = 64;           // centroids staged in shared memory at once
constexpr int kColsPerThread = kChunk / kColThreads;  // 4

// Lexicographic (score, index) order: the lower score wins and, among equal
// scores, the lower index, whichever lane found it.  This keeps the lowest-
// index tie-break of a flat argmin (jnp.argmin, FAISS) through a parallel
// merge.
__device__ __forceinline__ bool better(float s, int i, float best, int bi) {
  return s < best || (s == best && i < bi);
}

// Row-wise x / (sqrt(sum x^2) + eps) in place, the formula of
// ops/vq.l2_normalize (no max(), +eps).  One thread per row.
__device__ inline void normalize_rows(float* f, int ldf, int d, int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* row = f + r * ldf;
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
    const float den = sqrtf(s) + kEps;
    for (int j = 0; j < d; ++j) row[j] = row[j] / den;
  }
}

// 16 or 4 bytes global -> shared, asynchronously; zeros instead when !valid
// (src must still be an address inside the tensor).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Nearest centroid for each of the (THREADS / 16) * RPT feature rows held in shared
// memory (row r at feat[r * ldf], d features), written to out[r] for
// r < rows_valid.  Score = ||c||^2 - 2 f.c (the ||f||^2 term is constant
// per row and dropped, as in ops/vq.py).
//
// Centroids stream from global memory (L2) in chunks of kChunk through the
// shared buffer cs (kChunk * (d + 1) floats; the +1 keeps the 16 lanes that
// read one feature index of 16 different centroids on 16 different banks)
// and c2s (kChunk floats).  Thread (tx, ty) scores rows ty + (THREADS / 16) r against
// centroids tx + 16 c of each chunk, so it visits its centroids in
// ascending order and keeps a strict-< running (min, index); the 16 lanes
// of a row group are then merged with `better`.  The loop stops at exactly
// k: no padded centroid is ever scored.  Requires blockDim.x == THREADS.
template <int RPT, int THREADS = kThreads>
__device__ void block_argmin(const float* feat, int ldf, int d,
                             const float* __restrict__ cent,
                             const float* __restrict__ c2, int k,
                             float* cs, float* c2s, int* out, int rows_valid) {
  constexpr int kGroups = THREADS / kColThreads;  // row groups
  const int t = threadIdx.x;
  const int tx = t % kColThreads;
  const int ty = t / kColThreads;
  const int ldc = d + 1;
  float best[RPT];
  int bidx[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    best[r] = CUDART_INF_F;
    bidx[r] = 0;
  }
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    __syncthreads();  // the previous chunk (or the caller's buffer) is done
    for (int e = t; e < kChunk * d; e += THREADS) {
      const int c = e / d, j = e - c * d;
      cs[c * ldc + j] = (c0 + c < k) ? cent[(size_t)(c0 + c) * d + j] : 0.f;
    }
    for (int c = t; c < kChunk; c += THREADS)
      c2s[c] = (c0 + c < k) ? c2[c0 + c] : CUDART_INF_F;
    __syncthreads();
    float acc[RPT][kColsPerThread];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < d; ++j) {
      float f[RPT], cv[kColsPerThread];
#pragma unroll
      for (int r = 0; r < RPT; ++r) f[r] = feat[(ty + kGroups * r) * ldf + j];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        cv[c] = cs[(tx + kColThreads * c) * ldc + j];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          acc[r][c] = fmaf(f[r], cv[c], acc[r][c]);
    }
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int cl = tx + kColThreads * c;
      if (c0 + cl >= k) break;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float s = c2s[cl] - 2.0f * acc[r][c];
        if (s < best[r]) {
          best[r] = s;
          bidx[r] = c0 + cl;
        }
      }
    }
  }
  // the 16 lanes of a row group are 16 consecutive lanes of one warp
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
#pragma unroll
    for (int off = kColThreads / 2; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], off);
      if (better(os, oi, best[r], bidx[r])) {
        best[r] = os;
        bidx[r] = oi;
      }
    }
    const int row = ty + kGroups * r;
    if (tx == 0 && row < rows_valid) out[row] = bidx[r];
  }
}

// ---- bf16 on the tensor cores -----------------------------------------------

// c += a.b on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulation.  Fragments (g = lane / 4, t = lane % 4): a[0] row g, columns
// 2t and 2t + 1; a[1] row g + 8, the same columns; a[2] and a[3] the same
// rows at columns 2t + 8 and 2t + 9.  b0 holds B's rows 2t, 2t + 1 of column
// g, b1 rows 2t + 8, 2t + 9.  c[0], c[1] row g, columns 2t, 2t + 1; c[2],
// c[3] row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16x3 split of two values, packed as pack_bf16 packs them:
// hi = bf16(x), lo = bf16(x - hi) (ops/tiers.split_bf16; the JAX package's
// _dot_tier).  hi + lo carries about 16 significant bits of x.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Four 8 x 8 bf16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8 (16-byte aligned); a lane receives of each
// matrix the two values at row lane / 4, columns 2 (lane % 4) and + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- the tiered centroid-distance product (B1 and B2) ------------------------
//
// At the bf16x3 and default tiers the products f.c of the nearest-centroid
// search run on the tensor cores: a warp owns 16 feature rows, held as bf16
// A fragments in registers (split once a frame tile, as the JAX kernel
// splits the features once a tile into bf16 scratch), and walks the
// centroids in groups of NT 8-centroid n-tiles whose bf16 rows (split once
// by the wrapper, as the JAX kernel's host-side split) lie in shared
// memory; ldmatrix.x4 loads the B fragments of two n-tiles at once, and the
// NT tiles' products are independent accumulator chains, so their mma
// latencies overlap.  bf16x3 takes three passes, hi.hi, hi.lo and lo.hi,
// each accumulated in f32 and summed as the JAX kernel sums them, (hh + hl)
// + lh; default one pass of the rounded operands.  c2 = ||c||^2 stays f32
// from the f32 centroids.  The score is c2 - 2 f.c, as at the highest tier.
//
// Tie-break: a thread scores columns 2t and 2t + 1 of each n-tile, n-tiles
// in ascending order, so it visits its centroids in ascending index order
// with a strict-< running (min, index); the quad's 4 lanes (and, where
// warps split the n-tiles, the warps) merge with `better`: the lowest index
// wins among equal scores, whatever the fragment layout.

enum Tier { kHighest = 0, kBf16x3 = 1, kDefault = 2 };

constexpr int kMaxKs = 8;        // k-steps of 16 features a warp's rows keep: d <= 128
constexpr int kTierChunk = 64;   // centroids a streamed chunk holds (8 n-tiles)

// Pitch (bf16) of a centroid row of 16 ks features in shared memory: 8 more,
// so that the 8 rows an ldmatrix reads fall on 8 bank groups.
__host__ __device__ inline int tier_pitch(int ks) { return 16 * ks + 8; }

// A warp's 16 feature rows as bf16 A fragments, hi and (bf16x3) lo, for at
// most KS k-steps.
template <int KS>
struct RowFrags {
  uint32_t hi[KS][4];
  uint32_t lo[KS][4];
};

// Rows f[0 .. 16) (f32, row r at f + r * ldf; zeros from d up to 16 ks) ->
// fragments: default rounds, bf16x3 splits.
template <int KS>
__device__ __forceinline__ void load_row_frags(RowFrags<KS>& a, const float* f, int ldf, int ks,
                                               bool x3) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s < ks) {
      const float* r0 = f + g * ldf + 16 * s + 2 * t;
      const float* r1 = r0 + 8 * ldf;
      const float v[4][2] = {{r0[0], r0[1]}, {r1[0], r1[1]}, {r0[8], r0[9]}, {r1[8], r1[9]}};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (x3) {
          split_bf16(v[q][0], v[q][1], a.hi[s][q], a.lo[s][q]);
        } else {
          a.hi[s][q] = pack_bf16(v[q][0], v[q][1]);
        }
      }
    }
  }
}

// Scores of the warp's 16 rows against the NT n-tiles (8 NT centroids) whose
// bf16 rows start at ch (and cl, bf16x3), pitch ldc, centroid indices from
// n0; c2s their squared norms.  The running (min, index) of rows g (slot 0)
// and g + 8 (slot 1) is kept over the centroids below k in two chains, by
// the parity of the n-tile (two shorter dependency chains of
// compare-selects; each still visits its centroids in ascending order).
template <int KS, int NT>
__device__ __forceinline__ void score_tiles(const RowFrags<KS>& a, int ks, bool x3,
                                            const __nv_bfloat16* ch, const __nv_bfloat16* cl,
                                            int ldc, const float* c2s, int n0, int k,
                                            float (&best)[2][2], int (&bidx)[2][2]) {
  static_assert(NT % 2 == 0, "n-tiles come in ldmatrix pairs");
  const int lane = threadIdx.x % 32, t = lane % 4;
  float hh[NT][4], hl[NT][4], lh[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hh[j][e] = hl[j][e] = lh[j][e] = 0.f;
  // this lane's ldmatrix row: a centroid of the pair, 8 features of the k-step
  const int boff = ((lane & 7) + 8 * (lane >> 4)) * ldc + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s < ks) {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t bh[4];
        ldmatrix_x4(bh, ch + 16 * p * ldc + boff + 16 * s);
        mma_bf16(hh[2 * p], a.hi[s], bh[0], bh[1]);
        mma_bf16(hh[2 * p + 1], a.hi[s], bh[2], bh[3]);
        if (x3) {
          uint32_t bl[4];
          ldmatrix_x4(bl, cl + 16 * p * ldc + boff + 16 * s);
          mma_bf16(hl[2 * p], a.hi[s], bl[0], bl[1]);
          mma_bf16(hl[2 * p + 1], a.hi[s], bl[2], bl[3]);
          mma_bf16(lh[2 * p], a.lo[s], bh[0], bh[1]);
          mma_bf16(lh[2 * p + 1], a.lo[s], bh[2], bh[3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ci = n0 + 8 * j + 2 * t + q;
      if (ci < k) {
        const float c2v = c2s[8 * j + 2 * t + q];
        const float f0 = x3 ? (hh[j][q] + hl[j][q]) + lh[j][q] : hh[j][q];
        const float f1 = x3 ? (hh[j][2 + q] + hl[j][2 + q]) + lh[j][2 + q] : hh[j][2 + q];
        const float s0 = c2v - 2.0f * f0, s1 = c2v - 2.0f * f1;
        if (s0 < best[j & 1][0]) {
          best[j & 1][0] = s0;
          bidx[j & 1][0] = ci;
        }
        if (s1 < best[j & 1][1]) {
          best[j & 1][1] = s1;
          bidx[j & 1][1] = ci;
        }
      }
    }
  }
}

__device__ __forceinline__ void reset_best(float (&best)[2][2], int (&bidx)[2][2]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      best[c][r] = CUDART_INF_F;
      bidx[c][r] = 0;
    }
}

// Merge the two parity chains, then the 4 lanes of each quad: afterwards
// every lane of the quad holds in best[0] / bidx[0] the row's (min, lowest
// index).
__device__ __forceinline__ void quad_merge(float (&best)[2][2], int (&bidx)[2][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (better(best[1][r], bidx[1][r], best[0][r], bidx[0][r])) {
      best[0][r] = best[1][r];
      bidx[0][r] = bidx[1][r];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best[0][r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[0][r], off);
      if (better(os, oi, best[0][r], bidx[0][r])) {
        best[0][r] = os;
        bidx[0][r] = oi;
      }
    }
  }
}

// Floats of a chunk stage of block_argmin_tier: the hi and lo planes of
// kTierChunk bf16 rows and their c2.
__host__ __device__ inline int tier_stage_floats(int ks) {
  return kTierChunk * tier_pitch(ks) + kTierChunk;
}

// Floats of block_argmin_tier's shared scratch for `rows` rows: two chunk
// stages and the merge of two column groups.
__host__ __device__ inline int tier_scratch_floats(int ks, int rows) {
  return 2 * tier_stage_floats(ks) + 2 * 2 * rows;
}

// Nearest centroid at the tier for each of the `rows` (16 x the block's row
// tiles) feature rows in shared memory (row r at feat + r * ldf, zeros from d
// to 16 ks, ks <= KS), written to out[r] for r < rows_valid.  The bf16
// centroid rows (chi, clo: (k, 16 ks), zeros past d) stream from global
// memory in chunks of kTierChunk through a 2-stage cp.async ring in
// `scratch` (tier_scratch_floats), the next chunk loading while this one is
// scored; warps split into rows / 16 row tiles x CG column groups, a group
// taking the chunk's 8 / CG n-tiles in turn (NT at a time), merged through
// shared memory.  Requires blockDim.x == THREADS.
template <int THREADS, int KS, int NT>
__device__ void block_argmin_tier(const float* feat, int ldf, int ks, bool x3, int rows,
                                  const __nv_bfloat16* __restrict__ chi,
                                  const __nv_bfloat16* __restrict__ clo,
                                  const float* __restrict__ c2, int k, float* scratch, int* out,
                                  int rows_valid) {
  constexpr int kWarps = THREADS / 32;
  const int rt_count = rows / 16;
  const int groups = kWarps / rt_count;  // 1 or 2
  const int per_group = kTierChunk / 8 / groups;  // n-tiles of a chunk a group scores
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4;
  const int rt = warp % rt_count, cg = warp / rt_count;
  const int ldc = tier_pitch(ks), row_len = 16 * ks;
  const int stage = tier_stage_floats(ks);
  float* mbest = scratch + 2 * stage;
  int* midx = reinterpret_cast<int*>(mbest + 2 * rows);
  const int pieces = row_len / 8;  // 16-byte pieces of a centroid row
  // chunk c0 -> stage buf: rows past k and their c2 zero-filled (never scored)
  auto issue = [&](int c0, int buf) {
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(scratch + buf * stage);
    __nv_bfloat16* l = h + kTierChunk * ldc;
    float* cs2 = scratch + buf * stage + kTierChunk * ldc;
    for (int e = threadIdx.x; e < kTierChunk * pieces; e += THREADS) {
      const int c = e / pieces, q = e - c * pieces;
      const bool ok = c0 + c < k;
      const size_t src = ok ? static_cast<size_t>(c0 + c) * row_len + 8 * q : 0;
      cp_async16(h + c * ldc + 8 * q, chi + src, ok);
      if (x3) cp_async16(l + c * ldc + 8 * q, clo + src, ok);
    }
    for (int c = threadIdx.x; c < kTierChunk; c += THREADS)
      cp_async4(cs2 + c, c2 + (c0 + c < k ? c0 + c : 0), c0 + c < k);
    cp_async_commit();
  };
  RowFrags<KS> a;
  __syncthreads();  // the features are written; the caller's use of scratch is done
  issue(0, 0);
  load_row_frags(a, feat + rt * 16 * ldf, ldf, ks, x3);
  float best[2][2];
  int bidx[2][2];
  reset_best(best, bidx);
  for (int c0 = 0, it = 0; c0 < k; c0 += kTierChunk, ++it) {
    const int buf = it & 1;
    if (c0 + kTierChunk < k) {
      issue(c0 + kTierChunk, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk `it` visible to every thread
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(scratch + buf * stage);
    const float* cs2 = scratch + buf * stage + kTierChunk * ldc;
    for (int j = cg * per_group; j < (cg + 1) * per_group && c0 + 8 * j < k; j += NT)
      score_tiles<KS, NT>(a, ks, x3, h + 8 * j * ldc, h + kTierChunk * ldc + 8 * j * ldc, ldc,
                          cs2 + 8 * j, c0 + 8 * j, k, best, bidx);
    __syncthreads();  // stage buf free for the chunk after next
  }
  quad_merge(best, bidx);
  const int r0 = rt * 16 + g;
  if (groups == 1) {
    if (lane % 4 == 0) {
      if (r0 < rows_valid) out[r0] = bidx[0][0];
      if (r0 + 8 < rows_valid) out[r0 + 8] = bidx[0][1];
    }
    return;
  }
  if (lane % 4 == 0) {
    mbest[cg * rows + r0] = best[0][0];
    midx[cg * rows + r0] = bidx[0][0];
    mbest[cg * rows + r0 + 8] = best[0][1];
    midx[cg * rows + r0 + 8] = bidx[0][1];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows_valid; r += THREADS) {
    float b = mbest[r];
    int bi = midx[r];
    for (int q = 1; q < groups; ++q)
      if (better(mbest[q * rows + r], midx[q * rows + r], b, bi)) {
        b = mbest[q * rows + r];
        bi = midx[q * rows + r];
      }
    out[r] = bi;
  }
}

// block_argmin_tier with the fragments' capacity picked by ks: 4 k-steps
// and 4 n-tiles at once for d <= 64, else 8 and 2 (registers).
template <int THREADS>
__device__ void block_argmin_tier_any(const float* feat, int ldf, int ks, bool x3, int rows,
                                      const __nv_bfloat16* __restrict__ chi,
                                      const __nv_bfloat16* __restrict__ clo,
                                      const float* __restrict__ c2, int k, float* scratch,
                                      int* out, int rows_valid) {
  if (ks <= 4)
    block_argmin_tier<THREADS, 4, 4>(feat, ldf, ks, x3, rows, chi, clo, c2, k, scratch, out,
                                     rows_valid);
  else
    block_argmin_tier<THREADS, kMaxKs, 2>(feat, ldf, ks, x3, rows, chi, clo, c2, k, scratch, out,
                                          rows_valid);
}

// Dynamic shared memory above 48 KB must be granted per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace atk
