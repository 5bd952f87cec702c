// Kernel B2: fused (optional) L2 normalize + nearest-centroid assignment.
//
// Replaces audio_tokens_tpu/ops/pallas_vq.py::_vq_kernel.
//
// frames (n, d) f32, centroids (k, d) f32, c2 = ||c||^2 (k,) f32 computed by
// the wrapper -> out (n,) int32, the lowest index among equal scores.
//
// What bounds it on the H100: at the serving shape (n = 110,272 frames,
// d = 64, k = 500) the distance product is 7.1 GFLOP against 28 MB of
// frames read, so it is bound by float32 FMA issue (0.106 ms), not by bytes;
// at k = 16,384 (a large vocabulary) 231 GFLOP, 3.45 ms.  The design keeps
// every intermediate on chip and feeds the FMAs from registers:
//  - a block of 256 threads takes frame tiles of 128 rows and scores them
//    against centroid chunks of 128; thread (tx, ty) holds an 8 x 8 register
//    tile (rows ty + 16 r, centroids tx + 16 q), so per 4 features it makes
//    16 float4 shared loads for 256 FMAs.  Rows and centroids are both
//    row-major in shared memory with a stride of 4 mod 32 floats: the 8
//    threads of a quarter-warp read 8 centroid rows on 8 disjoint bank
//    quads, and a warp's 2 frame rows are broadcasts;
//  - where all k centroids fit in shared memory beside two frame tiles (k
//    500 at d 64: 206 KB in all), the grid is persistent, one block an SM: each
//    block stages the centroids once and walks frame tiles, loading the
//    next tile by cp.async while it scores this one;
//  - otherwise (k 16,384 at d 64 is 4 MB) the chunks stream through a ring
//    of ATK_VQ_STAGES cp.async stages, one barrier a chunk, the loads of
//    chunk c+2 in flight while chunk c is scored;
//  - rows too wide for that ring (d above 100 at 3 stages) are walked in
//    feature slices of at most kSlice: a ring item is one slice of a chunk
//    and the same slice of the frame tile, and the products are carried
//    over a chunk's slices in feature order, so any d fits;
//  - normalization runs on chip (8 lanes a row, a shuffle sum): the frame
//    tile is divided by its norms in shared memory, or in the sliced ring
//    (whose slices are staged once a chunk) the products are scaled by the
//    inverse norms;
//  - each thread visits its centroids in ascending order with a strict-<
//    running (min, index), then the 16 lanes of a row merge with
//    atk::better (score, then index): the lowest index wins ties, as
//    jnp.argmin does.  The loops stop at k: no padded centroid is scored.
// Any d: where d % 4 != 0 the copies are 4 bytes (zeros past d, so the
// product over d rounded up to 4 adds exact zeros).  Plain f32 FMA, no
// tensor cores: the scores are full float32 like the reference's HIGHEST
// products.
//
// The bf16x3 and default tiers (atk_vq_argmin_tier; the Lloyd assignment at
// kmeans_precision high and default, the TPU's Precision.HIGH and DEFAULT)
// run the distance product on the tensor cores (common.cuh's tiered
// product): at 17.23M rows x 64 x 500 it is 1.10 TFLOP, three bf16 passes
// (3.35 ms at 989 TFLOP/s) for bf16x3, and for default one pass, where the
// 4.4 GB of frames read bound it (1.32 ms).  One instance, the resident
// one: the bf16 centroids (hi and lo) stay in shared memory, the grid is
// persistent with 16 warps an SM, the next 256-row frame tile loads by
// cp.async while this one is scored; each warp splits its 16 rows once a
// tile and walks the centroids four n-tiles (32 centroids) at a time, in two
// running-min chains.  Shapes whose centroids do not fit (K 500 at d 64
// takes 214 KB at bf16x3) are refused; the wrapper names the tier and the
// shape.
#include "common.cuh"

#ifndef ATK_VQ_STAGES
#define ATK_VQ_STAGES 3  // ring stages where the centroids do not fit: 2 to 4
#endif
#ifndef ATK_VQ_RING
#define ATK_VQ_RING 0  // 1: stream the centroids even where they would fit
#endif

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTile = 128;     // frame rows of a tile, centroids of a chunk
constexpr int kPer = 8;        // rows (and centroids) a thread scores
constexpr int kStages = ATK_VQ_STAGES;
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a block may have
// widest feature slice of the sliced ring: 4 stages fit at 32
constexpr int kSlice = kStages <= 3 ? 64 : 32;
static_assert(kStages >= 2 && kStages <= 4, "the centroid ring has 2 to 4 stages");
static_assert((kTile + kStages * (2 * kTile * (kSlice + 4) + kTile)) * sizeof(float) <= kMaxSmem,
              "the sliced ring fits in shared memory at any d");

// Shared-memory row stride for d features: d rounded up to 4, then up to
// 4 mod 32 floats, so float4 reads of 8 consecutive rows at one feature
// fall on 8 disjoint groups of 4 banks.
__host__ __device__ inline int row_stride(int d4) { return d4 + ((36 - d4 % 32) % 32); }

// Floats of a ring slot: a chunk's slice of ld floats a centroid, their
// squared norms, and in the sliced ring the frame tile's slice.
__host__ __device__ inline int ring_slot(int ld, bool sliced) {
  return kTile * ld + kTile + (sliced ? kTile * ld : 0);
}

// features [f0, f0 + w) of rows [r0, r0 + kTile) of src (total x d) -> dst
// (kTile x ld) by cp.async; zeros past `total` rows and past d features.
// w is a multiple of 4 (and, with VEC, f0 + w <= d).
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, long r0,
                                           long total, int d, int f0, int w, int ld) {
  if (VEC) {
    const int q4 = w / 4;
    for (int e = threadIdx.x; e < kTile * q4; e += kThreads) {
      const int r = e / q4, q = e - r * q4;
      const bool ok = r0 + r < total;
      atk::cp_async16(dst + r * ld + 4 * q, ok ? src + (r0 + r) * d + f0 + 4 * q : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * w; e += kThreads) {
      const int r = e / w, j = e - r * w;
      const bool ok = r0 + r < total && f0 + j < d;
      atk::cp_async4(dst + r * ld + j, ok ? src + (r0 + r) * d + f0 + j : src, ok);
    }
  }
}

// c2[c0 .. c0 + kTile) -> dst (zeros past k: those centroids are never scored)
__device__ __forceinline__ void stage_c2(float* dst, const float* __restrict__ c2, int c0, int k) {
  for (int c = threadIdx.x; c < kTile; c += kThreads)
    atk::cp_async4(dst + c, c0 + c < k ? c2 + c0 + c : c2, c0 + c < k);
}

// ||x|| + eps of `row` (d floats), the norm of ops/vq.l2_normalize; the 8
// lanes l of a row sum features l, l + 8, ... and then by shuffles.
__device__ __forceinline__ float row_den(const float* row, int d) {
  const int l = threadIdx.x % 8;
  float s = 0.f;
  for (int j = l; j < d; j += 8) s = fmaf(row[j], row[j], s);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return sqrtf(s) + atk::kEps;
}

// x / (||x|| + eps) for each of the tile's ROWS rows in place (THREADS
// threads).  Zero rows stay zero.
template <int ROWS = kTile, int THREADS = kThreads>
__device__ __forceinline__ void normalize_tile(float* fs, int d, int ld) {
  for (int r = threadIdx.x / 8; r < ROWS; r += THREADS / 8) {
    float* row = fs + r * ld;
    const float den = row_den(row, d);
    for (int j = threadIdx.x % 8; j < d; j += 8) row[j] = row[j] / den;
  }
}

// The sliced ring's normalization: inv[r] = 1 / (||x|| + eps) of rows
// r0 + r of frames (the norm of ops/vq.l2_normalize, summed in row_den's
// order), read whole from global memory (rows past n read row 0; they are
// never written out); a thread's 4 rows at once, so their loads are in
// flight together.  The scores use f.c * inv, which equals the normalized
// row's product up to rounding: the staged slices stay as they are.
__device__ __forceinline__ void tile_inv_norms(float* inv, const float* __restrict__ frames,
                                               long r0, long n, int d) {
  constexpr int kRows = kTile / (kThreads / 8);  // rows of a thread
  const int l = threadIdx.x % 8, r8 = threadIdx.x / 8;
  const float* row[kRows];
  float s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long r = r0 + r8 + (kThreads / 8) * i;
    row[i] = frames + (r < n ? r * d : 0);
    s[i] = 0.f;
  }
#pragma unroll 4
  for (int j = l; j < d; j += 8)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float x = __ldg(row[i] + j);
      s[i] = fmaf(x, x, s[i]);
    }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
    if (l == 0) inv[r8 + (kThreads / 8) * i] = 1.0f / (sqrtf(s[i]) + atk::kEps);
  }
}

__device__ __forceinline__ void zero(float (&acc)[kPer][kPer]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r)
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc[r][q] = 0.f;
}

// acc[r][q] += f.c over w features for this thread's rows ty + 16 r of the
// frame tile fs and its centroids tx + 16 q of the chunk cs (both kTile x ld).
__device__ __forceinline__ void accumulate(const float* fs, const float* cs, int w, int ld,
                                           float (&acc)[kPer][kPer]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4  // 16 features at once: 5% faster than 4 (254 registers, no spill)
  for (int j = 0; j < w; j += 4) {
    float4 f[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      f[r] = *reinterpret_cast<const float4*>(fs + (ty + 16 * r) * ld + j);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const float4 c = *reinterpret_cast<const float4*>(cs + (tx + 16 * q) * ld + j);
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        acc[r][q] = fmaf(f[r].x, c.x, acc[r][q]);
        acc[r][q] = fmaf(f[r].y, c.y, acc[r][q]);
        acc[r][q] = fmaf(f[r].z, c.z, acc[r][q]);
        acc[r][q] = fmaf(f[r].w, c.w, acc[r][q]);
      }
    }
  }
}

// Keep the running (min, index) per row over the chunk's centroids c0 + tx
// + 16 q (c2s their squared norms): score = ||c||^2 - 2 f.c, the ||f||^2
// term constant per row and dropped.
__device__ __forceinline__ void score(const float (&acc)[kPer][kPer], const float* c2s, int c0,
                                      int k, float* best, int* bidx) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int ci = c0 + tx + 16 * q;  // ascending in q
    if (ci >= k) break;
    const float c2v = c2s[tx + 16 * q];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float s = c2v - 2.0f * acc[r][q];
      if (s < best[r]) {
        best[r] = s;
        bidx[r] = ci;
      }
    }
  }
}

__device__ __forceinline__ void reset(float* best, int* bidx) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    best[r] = CUDART_INF_F;
    bidx[r] = 0;
  }
}

// Merge the 16 lanes of each row (16 consecutive lanes of one warp) and
// write the tile's ids for rows below n.
__device__ __forceinline__ void finish_tile(float* best, int* bidx, long row0, long n,
                                            int* __restrict__ out) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], off);
      if (atk::better(os, oi, best[r], bidx[r])) {
        best[r] = os;
        bidx[r] = oi;
      }
    }
    const long row = row0 + ty + 16 * r;
    if (tx == 0 && row < n) out[row] = bidx[r];
  }
}

// All `chunks` x kTile centroids resident in shared memory; two frame tile
// buffers, the next tile loading while this one is scored.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
vq_resident_kernel(const float* __restrict__ frames, int n, int d, const float* __restrict__ cent,
                   const float* __restrict__ c2, int k, int normalize, int chunks,
                   int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int d4 = (d + 3) / 4 * 4, ld = row_stride(d4);
  float* cs = reinterpret_cast<float*>(smem4);  // chunks * kTile x ld
  float* c2s = cs + chunks * kTile * ld;        // chunks * kTile
  float* fbuf = c2s + chunks * kTile;           // 2 x kTile x ld
  const int tiles = (n + kTile - 1) / kTile;
  for (int ch = 0; ch < chunks; ++ch) {
    stage_rows<VEC>(cs + ch * kTile * ld, cent, static_cast<long>(ch) * kTile, k, d, 0, d4, ld);
    stage_c2(c2s + ch * kTile, c2, ch * kTile, k);
  }
  if (blockIdx.x < tiles)
    stage_rows<VEC>(fbuf, frames, static_cast<long>(blockIdx.x) * kTile, n, d, 0, d4, ld);
  atk::cp_async_commit();
  float best[kPer];
  int bidx[kPer];
  float acc[kPer][kPer];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    float* fs = fbuf + (it & 1) * kTile * ld;
    atk::cp_async_wait<0>();  // this tile (and, the first time, the centroids)
    __syncthreads();          // ... for every thread; the other buffer is free
    const int next = tile + gridDim.x;
    if (next < tiles)
      stage_rows<VEC>(fbuf + ((it + 1) & 1) * kTile * ld, frames, static_cast<long>(next) * kTile,
                      n, d, 0, d4, ld);
    atk::cp_async_commit();
    if (normalize) {
      normalize_tile(fs, d, ld);
      __syncthreads();
    }
    reset(best, bidx);
    for (int ch = 0; ch < chunks; ++ch) {
      zero(acc);
      accumulate(fs, cs + ch * kTile * ld, d4, ld, acc);
      score(acc, c2s + ch * kTile, ch * kTile, k, best, bidx);
    }
    finish_tile(best, bidx, static_cast<long>(tile) * kTile, n, out);
  }
  atk::cp_async_wait<0>();
}

// The centroids streamed through a ring of kStages items for every tile.
// An item is features [f0, f0 + ds) of a chunk, ds the slice width.  Where
// the whole row is one slice (!SLICED, ds = d rounded up to 4) the frame
// tile is staged once a tile and an item is a whole chunk; otherwise an
// item also carries the frame tile's same slice, the products are summed
// over a chunk's slices in feature order, and normalization scales them by
// the rows' inverse norms.
template <bool VEC, bool SLICED>
__global__ void __launch_bounds__(kThreads, 1)
vq_ring_kernel(const float* __restrict__ frames, int n, int d, const float* __restrict__ cent,
               const float* __restrict__ c2, int k, int normalize, int chunks, int ds,
               int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int d4 = (d + 3) / 4 * 4, ld = row_stride(ds);
  const int slices = SLICED ? (d4 + ds - 1) / ds : 1;
  const int items = chunks * slices;
  const int slot = ring_slot(ld, SLICED);
  float* fs = reinterpret_cast<float*>(smem4);  // the frame tile, kTile x ld; sliced: its norms
  float* ring = fs + (SLICED ? kTile : kTile * ld);  // kStages slots
  const int tiles = (n + kTile - 1) / kTile;
  auto stage_item = [&](int i, long r0) {
    const int ch = SLICED ? i / slices : i, f0 = SLICED ? (i - ch * slices) * ds : 0;
    const int w = SLICED && d4 - f0 < ds ? d4 - f0 : ds;
    float* s = ring + (i % kStages) * slot;
    stage_rows<VEC>(s, cent, static_cast<long>(ch) * kTile, k, d, f0, w, ld);
    stage_c2(s + kTile * ld, c2, ch * kTile, k);
    if (SLICED) stage_rows<VEC>(s + kTile * ld + kTile, frames, r0, n, d, f0, w, ld);
  };
  float best[kPer];
  int bidx[kPer];
  float acc[kPer][kPer];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long r0 = static_cast<long>(tile) * kTile;
    __syncthreads();  // the last tile's readers of fs and the ring are done
    if (!SLICED) stage_rows<VEC>(fs, frames, r0, n, d, 0, d4, ld);
    atk::cp_async_commit();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < items) stage_item(s, r0);
      atk::cp_async_commit();  // an empty group keeps the count uniform
    }
    if (normalize) {
      if (SLICED) {
        tile_inv_norms(fs, frames, r0, n, d);  // the first item's barrier publishes them
      } else {
        atk::cp_async_wait<kStages - 1>();  // the frame tile, the oldest group
        __syncthreads();
        normalize_tile(fs, d, ld);  // the first item's barrier publishes it
      }
    }
    reset(best, bidx);
    for (int i = 0; i < items; ++i) {
      atk::cp_async_wait<kStages - 2>();  // item i (and the frames) landed
      __syncthreads();                    // ... for every thread; slot i-1 is free
      if (i + kStages - 1 < items) stage_item(i + kStages - 1, r0);
      atk::cp_async_commit();
      const float* s = ring + (i % kStages) * slot;
      const int ch = SLICED ? i / slices : i, sl = SLICED ? i - ch * slices : 0;
      const int w = SLICED && d4 - sl * ds < ds ? d4 - sl * ds : ds;
      const float* f = SLICED ? s + kTile * ld + kTile : fs;
      if (sl == 0) zero(acc);
      accumulate(f, s, w, ld, acc);
      if (sl == slices - 1) {
        if (SLICED && normalize) {
#pragma unroll
          for (int r = 0; r < kPer; ++r) {
            const float inv = fs[threadIdx.x / 16 + 16 * r];
#pragma unroll
            for (int q = 0; q < kPer; ++q) acc[r][q] *= inv;
          }
        }
        score(acc, s + kTile * ld, ch * kTile, k, best, bidx);
      }
    }
    finish_tile(best, bidx, r0, n, out);
  }
  atk::cp_async_wait<0>();
}

// ---- the bf16x3 and default tiers --------------------------------------------

// The tiered instance: 16 warps, each scoring 16 rows of a 256-row frame
// tile, one block an SM (the bf16 centroids fill its shared memory).
constexpr int kTierThreads = 512;
constexpr int kTierRows = kTierThreads / 32 * 16;
constexpr int kTierTiles = 4;  // n-tiles a warp scores at once

// Shared memory of the tiered instance: the bf16 centroid rows (hi, and lo
// at bf16x3) of kp = k rounded up to kTierTiles n-tiles (zero rows past k),
// their c2, and the f32 frame tile of row pitch tier_ld(ks).
__host__ __device__ inline int tier_ld(int ks) { return row_stride(16 * ks); }
__host__ __device__ inline int tier_rows(int k) {
  return (k + 8 * kTierTiles - 1) / (8 * kTierTiles) * (8 * kTierTiles);
}
__host__ __device__ inline size_t tier_smem(int ks, int k, bool x3) {
  const int kp = tier_rows(k);
  return static_cast<size_t>(kp) * atk::tier_pitch(ks) * 2 * (x3 ? 2 : 1) + kp * sizeof(float) +
         static_cast<size_t>(kTierRows) * tier_ld(ks) * sizeof(float);
}

// rows [r0, r0 + kTierRows) of frames (n x d) -> fs (pitch ld) by cp.async,
// zeros past n and past d; d4 = d rounded up to 4.
template <bool VEC>
__device__ __forceinline__ void stage_tier_rows(float* fs, const float* __restrict__ frames,
                                                long r0, long n, int d, int d4, int ld) {
  if (VEC) {
    const int q4 = d4 / 4;
    for (int e = threadIdx.x; e < kTierRows * q4; e += kTierThreads) {
      const int r = e / q4, q = e - r * q4;
      const bool ok = r0 + r < n;
      atk::cp_async16(fs + r * ld + 4 * q, ok ? frames + (r0 + r) * d + 4 * q : frames, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kTierRows * d4; e += kTierThreads) {
      const int r = e / d4, j = e - r * d4;
      const bool ok = r0 + r < n && j < d;
      atk::cp_async4(fs + r * ld + j, ok ? frames + (r0 + r) * d + j : frames, ok);
    }
  }
  atk::cp_async_commit();
}

// KS: the fragments' capacity in k-steps (ks <= KS).  Per frame tile: the
// rows land (the previous tile's scoring overlapped their copy), are
// normalized, and each warp takes its 16 rows as split A fragments; then
// the next tile's copy starts and the warps score their rows against every
// centroid from registers and shared memory.
template <int KS, bool VEC>
__global__ void __launch_bounds__(kTierThreads, 1)
vq_tier_kernel(const float* __restrict__ frames, int n, int d,
               const __nv_bfloat16* __restrict__ chi, const __nv_bfloat16* __restrict__ clo,
               int ks, const float* __restrict__ c2, int k, int normalize, int x3,
               int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int kp = tier_rows(k), ldc = atk::tier_pitch(ks), row_len = 16 * ks;
  const int d4 = (d + 3) / 4 * 4, ld = tier_ld(ks);
  __nv_bfloat16* cs_hi = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* cs_lo = cs_hi + kp * ldc;
  float* c2s = reinterpret_cast<float*>(cs_hi + kp * ldc * (x3 ? 2 : 1));
  float* fs = c2s + kp;  // kTierRows x ld
  const int tiles = (n + kTierRows - 1) / kTierRows;
  const int pieces = row_len / 8;  // 16-byte pieces of a centroid row
  for (int e = threadIdx.x; e < kp * pieces; e += kTierThreads) {
    const int c = e / pieces, q = e - c * pieces;
    const bool ok = c < k;
    const size_t src = ok ? static_cast<size_t>(c) * row_len + 8 * q : 0;
    atk::cp_async16(cs_hi + c * ldc + 8 * q, chi + src, ok);
    if (x3) atk::cp_async16(cs_lo + c * ldc + 8 * q, clo + src, ok);
  }
  for (int c = threadIdx.x; c < kp; c += kTierThreads)
    atk::cp_async4(c2s + c, c2 + (c < k ? c : 0), c < k);
  // the features from d4 up to 16 ks are zeros the copies never write
  for (int e = threadIdx.x; e < kTierRows * (row_len - d4); e += kTierThreads) {
    const int r = e / (row_len - d4);
    fs[r * ld + d4 + (e - r * (row_len - d4))] = 0.f;
  }
  if (blockIdx.x < tiles)
    stage_tier_rows<VEC>(fs, frames, static_cast<long>(blockIdx.x) * kTierRows, n, d, d4, ld);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    atk::cp_async_wait<0>();  // this tile (and, the first time, the centroids)
    __syncthreads();
    if (normalize) {
      normalize_tile<kTierRows, kTierThreads>(fs, d, ld);
      __syncthreads();
    }
    atk::RowFrags<KS> a;
    atk::load_row_frags(a, fs + warp * 16 * ld, ld, ks, x3);
    __syncthreads();  // every warp holds its rows: the tile buffer is free
    const int next = tile + gridDim.x;
    if (next < tiles)
      stage_tier_rows<VEC>(fs, frames, static_cast<long>(next) * kTierRows, n, d, d4, ld);
    float best[2][2];
    int bidx[2][2];
    atk::reset_best(best, bidx);
    for (int n0 = 0; n0 < k; n0 += 8 * kTierTiles)
      atk::score_tiles<KS, kTierTiles>(a, ks, x3, cs_hi + n0 * ldc, cs_lo + n0 * ldc, ldc,
                                       c2s + n0, n0, k, best, bidx);
    atk::quad_merge(best, bidx);
    const long r0 = static_cast<long>(tile) * kTierRows + warp * 16 + lane / 4;
    if (lane % 4 == 0) {
      if (r0 < n) out[r0] = bidx[0][0];
      if (r0 + 8 < n) out[r0 + 8] = bidx[0][1];
    }
  }
  atk::cp_async_wait<0>();
}

template <int THREADS = kThreads, typename K, typename... Args>
cudaError_t launch(K kernel, size_t smem, int grid, cudaStream_t stream, Args... args) {
  cudaError_t err = atk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

ATK_EXPORT int atk_vq_argmin(const float* frames, int n, int d, const float* cent,
                             const float* c2, int k, int normalize, int* out, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d4 = (d + 3) / 4 * 4, ld = row_stride(d4);
  const int chunks = (k + kTile - 1) / kTile;
  const size_t tile = static_cast<size_t>(kTile) * ld;
  const size_t resident = (chunks * (tile + kTile) + 2 * tile) * sizeof(float);
  const size_t ring = (tile + kStages * ring_slot(ld, false)) * sizeof(float);
  const int tiles = (n + kTile - 1) / kTile;
  const int grid = tiles < sms ? tiles : sms;  // persistent: one block an SM
  const bool vec = d % 4 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ATK_VQ_RING && resident <= kMaxSmem) {
    err = launch(vec ? vq_resident_kernel<true> : vq_resident_kernel<false>, resident, grid, st,
                 frames, n, d, cent, c2, k, normalize, chunks, out);
  } else if (ring <= kMaxSmem) {
    err = launch(vec ? vq_ring_kernel<true, false> : vq_ring_kernel<false, false>, ring, grid, st,
                 frames, n, d, cent, c2, k, normalize, chunks, d4, out);
  } else {
    // slices of equal width (a multiple of 4, at most kSlice), as few as fit
    const int slices = (d4 + kSlice - 1) / kSlice;
    const int ds = ((d4 + slices - 1) / slices + 3) / 4 * 4;
    const size_t sliced = (kTile + kStages * ring_slot(row_stride(ds), true)) * sizeof(float);
    err = launch(vec ? vq_ring_kernel<true, true> : vq_ring_kernel<false, true>, sliced, grid, st,
                 frames, n, d, cent, c2, k, normalize, chunks, ds, out);
  }
  return static_cast<int>(err);
}

// Shared memory the tiered instance needs for k centroids of d features at
// bf16x3 (x3 = 1) or default; the wrapper refuses what passes 227 KB.
ATK_EXPORT long atk_vq_tier_smem(int d, int k, int x3) {
  return static_cast<long>(tier_smem((d + 15) / 16, k, x3 != 0));
}

// B2 at the bf16x3 (tier 1) or default (tier 2) tier.  chi, clo: the
// centroids' bf16 split (k, 16 ks) with ks = ceil(d / 16), zeros past d;
// clo is read at bf16x3 only.  c2 = ||c||^2 of the f32 centroids.
ATK_EXPORT int atk_vq_argmin_tier(const float* frames, int n, int d, const void* chi,
                                  const void* clo, const float* c2, int k, int normalize,
                                  int tier, int* out, void* stream) {
  if (n <= 0) return 0;
  const int ks = (d + 15) / 16;
  const bool x3 = tier == atk::kBf16x3;
  if (k < 1 || d < 1 || ks > atk::kMaxKs || (tier != atk::kBf16x3 && tier != atk::kDefault))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tier_smem(ks, k, x3);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kTierRows - 1) / kTierRows;
  const int grid = tiles < sms ? tiles : sms;
  const auto* h = static_cast<const __nv_bfloat16*>(chi);
  const auto* l = static_cast<const __nv_bfloat16*>(clo);
  const bool vec = d % 4 == 0;
  const auto kernel = ks <= 2   ? (vec ? vq_tier_kernel<2, true> : vq_tier_kernel<2, false>)
                      : ks <= 4 ? (vec ? vq_tier_kernel<4, true> : vq_tier_kernel<4, false>)
                                : (vec ? vq_tier_kernel<8, true> : vq_tier_kernel<8, false>);
  err = launch<kTierThreads>(kernel, smem, grid, static_cast<cudaStream_t>(stream), frames, n, d,
                             h, l, ks, c2, k, normalize, static_cast<int>(x3), out);
  return static_cast<int>(err);
}
