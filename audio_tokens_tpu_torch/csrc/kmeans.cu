// The K-means centroid sums at a precision tier: (parts, K, d) f64 sums of
// each cluster's rows as the tier's one-hot product sees them.
//
// Replaces no Pallas kernel: the JAX package forms these sums as a one-hot
// product inside _lloyd_stats (audio_tokens_tpu/ops/kmeans.py:70, :90-91),
// 2 N K d operations, as many as the assignment.  The port sums the rows
// sorted by cluster instead, O(N d) bytes, with no atomics, so that two
// fits of the same points give the same bits.  Before this kernel those
// sums were a torch composition (a gather of the sorted rows, an (N, d) f64
// running-sum buffer, a one-hot product of the runs), 18x its bytes bound
// and the fit's peak memory; this is that composition as one pass.
//
// Parts (ops/tiers.tier_operands, round to nearest even as split_bf16):
// highest x; default bf16(x); bf16x3 hi = bf16(x) and lo = bf16(x - hi),
// kept apart, because the objective (_score) needs both.
//
// Design.  The caller sorts the ids (a stable sort: a cluster's rows keep
// their order) and gives the sorted ids sid, the order and each cluster's
// [bounds[c], bounds[c+1]) of sorted positions.
// - sums_runs_kernel: a warp owns a tile of `tile` sorted positions and 64
//   columns (2 a lane, each a coalesced 128-byte load of the row), reads
//   each row once in place, x[order[p]], in groups of kUnroll rows, splits it
//   into the tier's parts in registers and keeps one f64 running sum a
//   part and column.  A run is a cluster's rows inside the tile.  A run
//   that is its whole cluster goes straight to out; a run whose cluster
//   began before the tile goes to the tile's head slot, one that goes on
//   past the tile to its tail slot (a tile has at most one of each);
// - sums_join_kernel: a warp a cluster and 64 columns; a cluster that spans
//   tiles t0 < t1 is tail[t0] + head[t0+1] + ... + head[t1], added in that
//   order; an empty cluster is 0.
// No atomics and no gathered copy: the order of every addition follows
// from the sorted ids and the tile alone, never from the grid or the
// timing.  Ids outside [0, K) add to nothing, as in the one-hot product.
//
// What bounds it on the H100: bytes, each row read once (4.41 GB at the
// clustering stage's 17.23M x 64) plus the ids and the order, ~1.4 ms at
// 3.35 TB/s.  The rows come in sorted order, so a warp's loads are 256-byte
// rows scattered over the points; a warp loads its next group of kUnroll
// rows while it sums the current one, so loads stay in flight through the
// tier's splitting and the f64 additions.
#include "common.cuh"

namespace {

// The knobs tools/kernel_ab.py --kernel kmeans times: rows a warp loads
// at once (a group); 1: a warp loads its next group while it sums this
// one, 0: load, then sum; blocks an SM must hold (registers a thread
// capped to fit; 0: no cap).  Groups of 2 rows loaded ahead, 4 blocks (32
// warps) an SM, measured fastest over the three tiers.
#ifndef ATK_SUMS_UNROLL
#define ATK_SUMS_UNROLL 2
#endif
#ifndef ATK_SUMS_PIPELINE
#define ATK_SUMS_PIPELINE 1
#endif
#ifndef ATK_SUMS_BLOCKS
#define ATK_SUMS_BLOCKS 4
#endif
#if ATK_SUMS_BLOCKS > 0
#define ATK_SUMS_BOUNDS __launch_bounds__(256, ATK_SUMS_BLOCKS)
#else
#define ATK_SUMS_BOUNDS __launch_bounds__(256)
#endif

constexpr int kSlab = 64;                // columns a warp sums: 2 a lane
constexpr int kUnroll = ATK_SUMS_UNROLL;  // rows a warp has in flight
constexpr int kWarps = 8;                // warps a block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kUnroll <= 16 && 32 % kUnroll == 0, "a group lies in one 32-position round");
static_assert(ATK_SUMS_BLOCKS == 0 || kWarps * 32 == 256, "ATK_SUMS_BOUNDS takes 256 threads");

// v rounded to bf16 (nearest even) as f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v's parts at the tier: highest v, default bf16(v), bf16x3 (hi, lo).
template <int TIER>
__device__ __forceinline__ void tier_parts(float v, float& p0, float& p1) {
  if (TIER == atk::kHighest) {
    p0 = v;
    p1 = 0.f;
  } else {
    const float hi = round_bf16(v);
    p0 = hi;
    p1 = TIER == atk::kBf16x3 ? round_bf16(v - hi) : 0.f;
  }
}

template <int TIER>
__global__ void ATK_SUMS_BOUNDS
sums_runs_kernel(const float* __restrict__ x, long ldx, int d, const int* __restrict__ sid,
                 const long* __restrict__ order, long n, int tile, long tiles, int slabs, int k,
                 double* __restrict__ out, double* __restrict__ head,
                 double* __restrict__ tail) {
  constexpr int P = TIER == atk::kBf16x3 ? 2 : 1;
  const long w = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= tiles * slabs) return;
  const long t = w / slabs;
  const int lane = threadIdx.x % 32;
  const int c0 = static_cast<int>(w % slabs) * kSlab + lane, c1 = c0 + 32;
  const bool v0 = c0 < d, v1 = c1 < d;
  const long begin = t * tile, end = begin + tile < n ? begin + tile : n;
  const int before = begin > 0 ? sid[begin - 1] : -1;  // the cluster left of the tile
  const int after = end < n ? sid[end] : -1;           // and right of it
  double a0[P], a1[P];
#pragma unroll
  for (int q = 0; q < P; ++q) a0[q] = a1[q] = 0.0;
  int cur = sid[begin];
  long start = begin;
  // the run [start, stop) of cluster cur is done: write it where it belongs
  auto flush = [&](long stop) {
    if (cur >= 0 && cur < k) {
      const size_t plane = static_cast<size_t>(k) * d;
      double* dst;
      size_t step;
      if (start == begin && before == cur) {  // its cluster began left of the tile
        dst = head + static_cast<size_t>(t) * P * d;
        step = d;
      } else if (stop == end && after == cur) {  // it goes on right of the tile
        dst = tail + static_cast<size_t>(t) * P * d;
        step = d;
      } else {  // the whole cluster
        dst = out + static_cast<size_t>(cur) * d;
        step = plane;
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (v0) dst[q * step + c0] = a0[q];
        if (v1) dst[q * step + c1] = a1[q];
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) a0[q] = a1[q] = 0.0;
  };
  // the ids and rows of this round of 32 sorted positions and of the next,
  // one position a lane; a group of kUnroll rows is loaded one group ahead
  // of the one being summed
  long q = begin + lane;
  int c_id = q < end ? sid[q] : -1, n_id;
  long c_row = q < end ? order[q] : 0, n_row, c_base = begin;
  q += 32;
  n_id = q < end ? sid[q] : -1;
  n_row = q < end ? order[q] : 0;
  const int groups = static_cast<int>((end - begin + kUnroll - 1) / kUnroll);
  auto load = [&](float (&y0)[kUnroll], float (&y1)[kUnroll], int g) {
    const long p0 = begin + static_cast<long>(g) * kUnroll;
    const long rows = p0 >= c_base + 32 ? n_row : c_row;  // the same in every lane
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long row = __shfl_sync(kFull, rows, static_cast<int>(p0 + u - begin) & 31);
      const float* r = x + row * ldx;
      const bool ok = p0 + u < end;
      y0[u] = ok && v0 ? r[c0] : 0.f;
      y1[u] = ok && v1 ? r[c1] : 0.f;
    }
  };
  auto add = [&](const float (&y0)[kUnroll], const float (&y1)[kUnroll], int g) {
    const long p0 = begin + static_cast<long>(g) * kUnroll;
    if (p0 >= c_base + 32) {  // this group opens the next round
      c_id = n_id;
      c_row = n_row;
      c_base += 32;
      const long nq = c_base + 32 + lane;
      n_id = nq < end ? sid[nq] : -1;
      n_row = nq < end ? order[nq] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long p = p0 + u;
      if (p >= end) break;
      const int id = __shfl_sync(kFull, c_id, static_cast<int>(p - begin) & 31);
      if (id != cur) {  // the same in every lane
        flush(p);
        cur = id;
        start = p;
      }
      float h0, l0, h1, l1;
      tier_parts<TIER>(y0[u], h0, l0);
      tier_parts<TIER>(y1[u], h1, l1);
      a0[0] += h0;
      a1[0] += h1;
      if (P == 2) {
        a0[P - 1] += l0;
        a1[P - 1] += l1;
      }
    }
  };
  float xa0[kUnroll], xa1[kUnroll];
  if (ATK_SUMS_PIPELINE) {
    float xb0[kUnroll], xb1[kUnroll];
    load(xa0, xa1, 0);
    for (int g = 0; g < groups; g += 2) {
      if (g + 1 < groups) load(xb0, xb1, g + 1);
      add(xa0, xa1, g);
      if (g + 2 < groups) load(xa0, xa1, g + 2);
      if (g + 1 < groups) add(xb0, xb1, g + 1);
    }
  } else {
    for (int g = 0; g < groups; ++g) {
      load(xa0, xa1, g);
      add(xa0, xa1, g);
    }
  }
  flush(end);
}

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
sums_join_kernel(const long* __restrict__ bounds, int k, int d, int slabs, int tile,
                 const double* __restrict__ head, const double* __restrict__ tail,
                 double* __restrict__ out) {
  const long w = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (w >= static_cast<long>(k) * slabs) return;
  const int c = static_cast<int>(w / slabs), lane = threadIdx.x % 32;
  const int c0 = static_cast<int>(w % slabs) * kSlab + lane, c1 = c0 + 32;
  const long s = bounds[c], e = bounds[c + 1];
  const long t0 = s / tile, t1 = e > s ? (e - 1) / tile : t0;
  if (e > s && t0 == t1) return;  // inside one tile: the runs kernel wrote it
  const size_t plane = static_cast<size_t>(k) * d;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    double a0 = 0.0, a1 = 0.0;
    if (e > s) {
      const double* tl = tail + (static_cast<size_t>(t0) * P + q) * d;
      if (c0 < d) a0 += tl[c0];
      if (c1 < d) a1 += tl[c1];
#pragma unroll 4
      for (long t = t0 + 1; t <= t1; ++t) {
        const double* hd = head + (static_cast<size_t>(t) * P + q) * d;
        if (c0 < d) a0 += hd[c0];
        if (c1 < d) a1 += hd[c1];
      }
    }
    if (c0 < d) out[q * plane + static_cast<size_t>(c) * d + c0] = a0;
    if (c1 < d) out[q * plane + static_cast<size_t>(c) * d + c1] = a1;
  }
}

template <int TIER>
cudaError_t launch(const float* x, long n, int d, long ldx, const int* sid, const long* order,
                   int tile, const long* bounds, int k, double* head, double* tail, double* out,
                   cudaStream_t stream) {
  constexpr int P = TIER == atk::kBf16x3 ? 2 : 1;
  const int slabs = atk::ceil_div(d, kSlab);
  const long tiles = (n + tile - 1) / tile;
  if (tiles > 0) {
    const long warps = tiles * slabs;
    sums_runs_kernel<TIER><<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kWarps * 32, 0,
                             stream>>>(x, ldx, d, sid, order, n, tile, tiles, slabs, k, out, head,
                                       tail);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long warps = static_cast<long>(k) * slabs;
  sums_join_kernel<P><<<static_cast<unsigned>((warps + kWarps - 1) / kWarps), kWarps * 32, 0,
                        stream>>>(bounds, k, d, slabs, tile, head, tail, out);
  return cudaGetLastError();
}

}  // namespace

// The (parts, k, d) f64 centroid sums of the n rows of x (row stride ldx
// floats) at tier (0 highest, 1 bf16x3, 2 default; parts 2 at bf16x3, else
// 1): sid the ids sorted (int32, stable), order the rows in that order
// (int64), bounds (k + 1, int64) each cluster's first sorted position and
// the end; head and tail scratch of ceil(n / tile) x parts x d f64 each.
ATK_EXPORT int atk_tier_sums64(const float* x, long n, int d, long ldx, const int* sid,
                               const long* order, int tile, const long* bounds, int k, int tier,
                               double* head, double* tail, double* out, void* stream) {
  if (n < 0 || d < 1 || ldx < d || tile < 1 || k < 1 || tier < 0 || tier > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tier == atk::kBf16x3)
    err = launch<atk::kBf16x3>(x, n, d, ldx, sid, order, tile, bounds, k, head, tail, out, st);
  else if (tier == atk::kDefault)
    err = launch<atk::kDefault>(x, n, d, ldx, sid, order, tile, bounds, k, head, tail, out, st);
  else
    err = launch<atk::kHighest>(x, n, d, ldx, sid, order, tile, bounds, k, head, tail, out, st);
  return static_cast<int>(err);
}
