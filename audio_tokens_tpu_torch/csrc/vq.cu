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
// run the distance product on wgmma (common.cuh's tiered product): at
// 17.23M rows x 64 x 500 it is 1.10 TFLOP, three bf16 passes (3.35 ms at
// 989 TFLOP/s) for bf16x3, and for default one pass, where the 4.4 GB of
// frames read bound it (1.32 ms).  A persistent block an SM: two consumer
// warpgroups hold a 128-row frame tile's rows as fragments (64 each), one
// producer warp stages the tiles by cp.async into a ring of frame buffers
// and the centroid image items by cp.async.bulk, each buffer completing on
// an mbarrier, released through another: no block-wide barrier a tile.
// tier_plan picks the instance: rows up to 64 features keep 4 k-steps of
// fragments and score 128-centroid chunks, up to 128 features 8 k-steps and
// 64-centroid chunks (registers); the chunks stay resident where they fit
// beside two frame buffers (K 500 at d 64: 130 KB at bf16x3), else they
// stream through a ring of up to 4 stages (K 16,384); rows wider than 128
// features are walked in 128-feature slices, each ring item carrying a
// chunk's slice and the frame tile's same slice, the products summed over a
// chunk's slices in feature order, so any K and d run.  Bound: the
// products' tensor rate at bf16x3; at default the epilogue (~5
// instructions a score) and the frames' bytes.
#include <cuda.h>  // CUtensorMap and its enums (the encoder is looked up at run time)

#include "common.cuh"

#ifndef ATK_VQ_STAGES
#define ATK_VQ_STAGES 3  // ring stages where the centroids do not fit: 2 to 4
#endif
#ifndef ATK_VQ_RING
#define ATK_VQ_RING 0  // 1: stream the centroids even where they would fit
#endif
#ifndef ATK_VQ_TMA
#define ATK_VQ_TMA 1  // tiers: 0 stages the frame rows by cp.async, not the tensor map
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

// The tiered instance: two consumer warpgroups score a 128-row frame tile
// (64 rows each, from registers) and one warp of a third, the producer
// warpgroup, keeps the copies in flight, one block an SM.  The producer
// warpgroup gives its registers to the consumers (setmaxnreg): 3 warps an
// SM sub-partition would otherwise cap every thread at 168, too few for two
// 128-wide accumulator sets (ptxas then serializes the wgmmas).
constexpr int kTierRows = 128;
constexpr int kTierConsumers = 256;
constexpr int kTierThreads = kTierConsumers + 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTierHeader = 256;   // mbarriers: centroid full/empty, frame full/empty
constexpr int kMaxResident = 12;   // chunks that may stay resident (their barriers)
constexpr int kMaxFrameStages = 4;
constexpr int kSmemAlign = 1024;   // the frame tiles' swizzle repeats every 1024 bytes
constexpr int kBox = 32;           // features of a tensor-map box: 128 bytes a row

// The launch plan of the tiered instance; ops/cuda_vq.vq_tier_plan is its
// Python mirror (the wrapper lays the centroid image out by it), and a card
// test holds the two equal through atk_vq_tier_plan.  Shared memory, from
// a 1024-aligned base: the frame tile buffers, the ring, the mbarriers.
struct TierPlan {
  int ks;        // k-steps of 16 features the fragments hold (a slice): 4 or 8
  int nc;        // centroids a chunk (and a wgmma): 128 at 4 k-steps, else 64
  int wide;      // rows wider than 128 features, walked in slices
  int slices;    // feature slices of 16 ks (the image's features)
  int chunks;    // ceil(k / nc)
  int items;     // chunks x slices, an image item each
  int ibytes;    // bytes of an image item
  int istride;   // bytes of a ring stage: (wide: the tile's slice, then) the item
  int tile;      // bytes of a frame tile (a slice where wide): 128 rows x 16 ks f32
  int resident;  // every item stays in shared memory for the whole launch
  int stages;    // ring stages (resident: the items)
  int fstages;   // frame tile buffers (0 where wide)
  int smem;      // bytes of dynamic shared memory, the alignment slack included
};

__host__ __device__ inline TierPlan tier_plan(int d, int k, bool x3) {
  TierPlan p{};
  const int ks = atk::ceil_div(d, 16);
  p.ks = ks <= 4 ? 4 : 8;
  p.nc = ks <= 4 ? 128 : 64;
  p.wide = ks > 8;
  p.slices = p.wide ? atk::ceil_div(ks, 8) : 1;
  p.chunks = atk::ceil_div(k, p.nc);
  p.items = p.chunks * p.slices;
  p.ibytes = atk::tier_item_bytes(p.nc, p.ks, x3, true);
  p.tile = kTierRows * 16 * p.ks * 4;
  p.istride = p.wide ? (p.tile + p.ibytes + kSmemAlign - 1) / kSmemAlign * kSmemAlign
                     : atk::align128(p.ibytes);
  const int avail = atk::kSmemLimit - kSmemAlign - kTierHeader;
  if (!p.wide && p.items <= kMaxResident && p.items * p.istride + 2 * p.tile <= avail) {
    p.resident = 1;
    p.stages = p.items;
    const int fs = (avail - p.items * p.istride) / p.tile;
    p.fstages = fs < kMaxFrameStages ? fs : kMaxFrameStages;
  } else {
    p.fstages = p.wide ? 0 : 2;
    const int st = (avail - p.fstages * p.tile) / p.istride;
    p.stages = st < atk::kMaxStages ? st : atk::kMaxStages;
  }
  p.smem = kSmemAlign + p.fstages * p.tile + p.stages * p.istride + kTierHeader;
  return p;
}

// Float index of (row r, feature c) in a frame tile: boxes of 32 features
// x 128 rows, each row's 16-byte pieces swizzled by the row (the tensor
// map's 128-byte swizzle), so that the 8 rows a fragment load reads fall
// on other banks.
__device__ __forceinline__ int tile_at(int r, int c) {
  return (c / kBox) * (kTierRows * kBox) + r * kBox + ((((c >> 2) & 7) ^ (r & 7)) << 2) + (c & 3);
}

// Rows [r0, r0 + kTierRows) x features [f0, f0 + 16 KS) of frames (n x d)
// -> the tile at dst (tile_at's layout), zeros past n and past d,
// completing on bar, by the producer warp: with a tensor map, lane 0 loads
// the 16 KS / 32 boxes (announcing their bytes and `extra` of the
// caller's); else every lane copies 4 bytes at a time by cp.async and
// arrives on bar as its copies land.
template <int KS>
__device__ __forceinline__ void copy_tile(float* dst, const CUtensorMap* tmap,
                                          const float* __restrict__ frames, long r0, long n, int d,
                                          int f0, uint64_t* bar, int extra) {
  constexpr int kBoxes = 16 * KS / kBox;
  const int lane = threadIdx.x % 32;
  if (tmap) {
    if (lane == 0) {
      atk::mbar_expect(bar, kBoxes * kTierRows * kBox * 4 + extra);
#pragma unroll
      for (int b = 0; b < kBoxes; ++b) {
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(atk::smem_u32(dst + b * kTierRows * kBox)),
            "l"(reinterpret_cast<uint64_t>(tmap)), "r"(f0 + b * kBox),
            "r"(static_cast<int>(r0)), "r"(atk::smem_u32(bar))
            : "memory");
      }
    }
  } else {
    if (lane == 0 && extra) atk::mbar_expect(bar, extra);
    for (int e = lane; e < kTierRows * 16 * KS; e += 32) {
      const int r = e / (16 * KS), j = e % (16 * KS), col = f0 + j;
      const bool ok = r0 + r < n && col < d;
      atk::cp_async4(dst + tile_at(r, j), ok ? frames + (r0 + r) * d + col : frames, ok);
    }
    atk::cp_async_arrive(bar);
  }
}

// x / (||x|| + eps) in place for the warpgroup's 64 rows (from row rb) of
// the tile fs, 8 lanes a row: the formula and the summation order of
// normalize_tile.
__device__ __forceinline__ void normalize_wg_rows(float* fs, int rb, int d) {
  const int t = threadIdx.x % 128, l = t % 8;
  for (int r = rb + t / 8; r < rb + 64; r += 16) {
    float s = 0.f;
    for (int j = l; j < d; j += 8) {
      const float x = fs[tile_at(r, j)];
      s = fmaf(x, x, s);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float den = sqrtf(s) + atk::kEps;
    for (int j = l; j < d; j += 8) fs[tile_at(r, j)] = fs[tile_at(r, j)] / den;
  }
}

// ||x|| + eps of the warp's rows g (den0) and g + 8 (den1) from row0 on,
// read whole from frames (lanes 2r and 2r + 1 sum row r); rows past n get 1.
__device__ __forceinline__ void wide_dens(const float* __restrict__ frames, long row0, long n,
                                          int d, float& den0, float& den1) {
  const int lane = threadIdx.x % 32;
  const long row = row0 + lane / 2;
  float s = 0.f;
  if (row < n)
    for (int j = lane % 2; j < d; j += 2) {
      const float x = __ldg(frames + row * d + j);
      s = fmaf(x, x, s);
    }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  const float den = row < n ? sqrtf(s) + atk::kEps : 1.f;
  den0 = __shfl_sync(0xffffffffu, den, 2 * (lane / 4));
  den1 = __shfl_sync(0xffffffffu, den, 2 * (lane / 4 + 8));
}

// KS: the fragments' k-steps; WIDE: the sliced walk.  The producer warp
// loads the image items once (resident) or streams them through the ring
// for every tile, and stages each frame tile (WIDE: each item's slice of
// it) by the tensor map tmap (null: by cp.async); the consumers take a
// tile's rows as fragments (normalized in place first), release its buffer
// and walk the chunks.
template <int KS, bool X3, bool WIDE>
__global__ void __launch_bounds__(kTierThreads, 1)
vq_tier_kernel(const __grid_constant__ CUtensorMap tmap, int use_tmap,
               const float* __restrict__ frames, long n, int d, const char* __restrict__ img,
               TierPlan p, int normalize, int* __restrict__ out) {
  constexpr int NW = KS == 4 ? 128 : 64;
  extern __shared__ __align__(128) char smem_raw[];
  // offset, not a cast of the address, so the compiler keeps shared loads
  char* smem = smem_raw + ((kSmemAlign - (atk::smem_u32(smem_raw) & (kSmemAlign - 1))) &
                           (kSmemAlign - 1));
  char* fbuf = smem;
  char* ring = fbuf + p.fstages * p.tile;
  uint64_t* cfull = reinterpret_cast<uint64_t*>(ring + p.stages * p.istride);
  uint64_t* cempty = cfull + kMaxResident;
  uint64_t* ffull = cempty + kMaxResident;
  uint64_t* fempty = ffull + kMaxFrameStages;
  const CUtensorMap* tm = use_tmap ? &tmap : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long tiles = (n + kTierRows - 1) / kTierRows;
  const int item_at = WIDE ? p.tile : 0;  // the image's offset in a ring stage
  if (threadIdx.x == 0) {
    // full: lane 0's arrival with the bytes (and, copying by cp.async, each
    // lane's arrival as its copies land)
    for (int s = 0; s < p.stages; ++s) {
      atk::mbar_init(cfull + s, WIDE && !tm ? 33 : 1);
      atk::mbar_init(cempty + s, kTierConsumers / 32);
    }
    for (int s = 0; s < p.fstages; ++s) {
      atk::mbar_init(ffull + s, tm ? 1 : 32);
      atk::mbar_init(fempty + s, kTierConsumers / 32);
    }
    atk::mbar_init_fence();
  }
  __syncthreads();
  if (warp >= kTierConsumers / 32) {  // the producer warpgroup: one warp works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp > kTierConsumers / 32) return;
    if (p.resident && lane == 0)
      for (int i = 0; i < p.items; ++i) {
        atk::mbar_expect(cfull + i, p.ibytes);
        atk::bulk_copy(ring + i * p.istride, img + static_cast<size_t>(i) * p.ibytes, p.ibytes,
                       cfull + i);
      }
    long g = 0;
    int ft = 0;
    for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ft) {
      const long r0 = tile * kTierRows;
      if (!WIDE && !(ATK_TIER_SPLIT & 4)) {
        const int fb = ft % p.fstages;
        atk::mbar_wait(fempty + fb, ((ft / p.fstages) & 1) ^ 1);
        copy_tile<KS>(reinterpret_cast<float*>(fbuf + fb * p.tile), tm, frames, r0, n, d, 0,
                      ffull + fb, 0);
      }
      if (p.resident) continue;
      for (int i = 0; i < p.items; ++i, ++g) {
        const int st = static_cast<int>(g % p.stages);
        atk::mbar_wait(cempty + st, static_cast<int>((g / p.stages) & 1) ^ 1);
        char* dst = ring + st * p.istride;
        if (WIDE)  // the item's bytes announced with the slice's
          copy_tile<KS>(reinterpret_cast<float*>(dst), tm, frames, r0, n, d,
                        (i % p.slices) * 16 * KS, cfull + st, p.ibytes);
        else if (lane == 0)
          atk::mbar_expect(cfull + st, p.ibytes);
        if (lane == 0)
          atk::bulk_copy(dst + item_at, img + static_cast<size_t>(i) * p.ibytes, p.ibytes,
                         cfull + st);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, wq = warp % 4, rw = 64 * wg + 16 * wq;  // the warp's first row
  const int plane_bytes = p.nc * 16 * (KS + 1) * 2;
  float best[atk::kChains][2];
  int bidx[atk::kChains][2];
  long g0 = 0;
  int ft = 0;
  for (long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ft, g0 += p.items) {
    const long r0 = tile * kTierRows;
    auto wait = [&](int i) -> const char* {
      if (p.resident) {  // landed once for the whole launch
        if (ft == 0) atk::mbar_wait(cfull + i, 0);
        return ring + i * p.istride;
      }
      const long gi = g0 + i;
      atk::mbar_wait(cfull + gi % p.stages, static_cast<int>((gi / p.stages) & 1));
      return ring + (gi % p.stages) * p.istride + item_at;
    };
    auto release = [&](int i) {
      if (p.resident) return;
      __syncwarp();
      if (lane == 0) atk::mbar_arrive(cempty + (g0 + i) % p.stages);
    };
    atk::reset_best(best, bidx);
    if (!WIDE) {
      const int fb = ft % p.fstages;
      if (!(ATK_TIER_SPLIT & 4)) atk::mbar_wait(ffull + fb, (ft / p.fstages) & 1);
      float* f = reinterpret_cast<float*>(fbuf + fb * p.tile);
      if (normalize) {
        normalize_wg_rows(f, 64 * wg, d);
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      }
      atk::RowFrags<KS> a;
      atk::load_frags<KS, X3>(a, [&](int r, int c) {
        return *reinterpret_cast<const float2*>(f + tile_at(rw + r, c));
      }, false, 1.f, 1.f);
      if (normalize) atk::fence_proxy_async();  // the rows written here before the next copy
      __syncwarp();
      if (lane == 0) atk::mbar_arrive(fempty + fb);  // the tile buffer is free
      atk::scan_narrow<KS, NW, X3, true>(a, p.items, p.nc, 0, plane_bytes, wait, release, best,
                                   bidx);
    } else {
      float den0 = 1.f, den1 = 1.f;
      if (normalize) wide_dens(frames, r0 + rw, n, d, den0, den1);
      auto load = [&](atk::RowFrags<KS>& a, int, const char* st) {
        const float* f = reinterpret_cast<const float*>(st - item_at);
        atk::load_frags<KS, X3>(a, [&](int r, int c) {
          return *reinterpret_cast<const float2*>(f + tile_at(rw + r, c));
        }, normalize != 0, den0, den1);
      };
      atk::scan_wide<KS, NW, X3, true>(p.chunks, p.slices, p.nc, 0, plane_bytes, wait, release,
                                 load, best, bidx);
    }
    atk::quad_merge(best, bidx);
    const long row = r0 + rw + lane / 4;
    if (lane % 4 == 0) {
      if (row < n) out[row] = bidx[0][0];
      if (row + 8 < n) out[row + 8] = bidx[0][1];
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's
// cudaGetDriverEntryPoint (no link against libcuda); null where missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The frames (n x d f32) as a 2-D tensor map of 32-feature x 128-row boxes,
// 128-byte swizzle, zeros out of bounds; false where TMA cannot read them
// (d % 4 or the base not 16-byte aligned).
bool frames_map(CUtensorMap* map, const float* frames, long n, int d) {
  const EncodeTiled encode = encode_tiled();
  if (ATK_VQ_TMA == 0 || !encode || d % 4 || reinterpret_cast<uintptr_t>(frames) % 16) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kBox, kTierRows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(frames), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// The tiered instance's plan for k centroids of d features at bf16x3 (x3 =
// 1) or default, as 13 ints in TierPlan's order (the wrapper's mirror is
// held to it).
ATK_EXPORT int atk_vq_tier_plan(int d, int k, int x3, int* out) {
  if (k < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const TierPlan p = tier_plan(d, k, x3 != 0);
  const int v[] = {p.ks,      p.nc,   p.wide,     p.slices, p.chunks,  p.items, p.ibytes,
                   p.istride, p.tile, p.resident, p.stages, p.fstages, p.smem};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// B2 at the bf16x3 (tier 1) or default (tier 2) tier.  img: the centroid
// image of tier_plan (img_bytes = items x ibytes): per chunk and feature
// slice, the bf16 planes in wgmma's core-matrix order and the chunk's c2
// (of the f32 centroids, +inf past k).
ATK_EXPORT int atk_vq_argmin_tier(const float* frames, int n, int d, const void* img,
                                  long img_bytes, int k, int normalize, int tier, int* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const bool x3 = tier == atk::kBf16x3;
  if (k < 1 || d < 1 || (tier != atk::kBf16x3 && tier != atk::kDefault))
    return static_cast<int>(cudaErrorInvalidValue);
  const TierPlan p = tier_plan(d, k, x3);
  if (img_bytes != static_cast<long>(p.items) * p.ibytes || (p.stages < 2 && !p.resident) ||
      p.smem > atk::kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = (static_cast<long>(n) + kTierRows - 1) / kTierRows;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  CUtensorMap map{};
  const int use_map = frames_map(&map, frames, n, d);
  const auto* im = static_cast<const char*>(img);
  const auto kernel =
      p.ks == 4 ? (x3 ? vq_tier_kernel<4, true, false> : vq_tier_kernel<4, false, false>)
      : p.wide  ? (x3 ? vq_tier_kernel<8, true, true> : vq_tier_kernel<8, false, true>)
                : (x3 ? vq_tier_kernel<8, true, false> : vq_tier_kernel<8, false, false>);
  err = launch<kTierThreads>(kernel, p.smem, grid, static_cast<cudaStream_t>(stream), map,
                             use_map, frames, static_cast<long>(n), d, im, p, normalize, out);
  return static_cast<int>(err);
}
