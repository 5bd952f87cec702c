// Shared pieces of the port's kernels: the C export macro, the error-string
// export, the cp.async copies, the (score, index) order of the nearest-
// centroid argmin (B1 and B2), the normalize + scoring + argmin that
// kernel B1 (tokenizer.cu) ends with (B2, vq.cu, has its own), the bf16
// tensor-core pieces (mma.sync, ldmatrix, the hi/lo split), Hopper's
// mbarriers, bulk copies and wgmma, and the tiered centroid-distance search
// that B1 and B2 share at the bf16x3 and default tiers.
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

// ---- the tiered centroid-distance product (B1 and B2) on wgmma ---------------
//
// At the bf16x3 and default tiers the products f.c of the nearest-centroid
// search run on Hopper's warpgroup products (wgmma.mma_async m64nNk16, bf16
// operands, f32 sums).  A warpgroup owns 64 feature rows; each of its warps
// keeps its 16 rows as bf16 A fragments in registers (split once a frame
// tile, as the JAX kernel splits the features once a tile: the register-A
// layout of wgmma is mma.sync's m16n8k16 A layout, warp by warp).  B is a
// chunk of nc centroids in shared memory, laid out by the wrapper as the
// exact image wgmma reads (K-major, no swizzle: 8 centroids x 8 features a
// 128-byte core matrix, a chunk's core matrices in (8-centroid group,
// 8-feature block) order).  c2 = ||c||^2 of the f32 centroids comes in one
// of two ways (tier_item_bytes): B2 folds it into the products as one more
// k-step, -c2 / 2 in three bf16 parts that sum to it exactly against A's
// ones, so that the products are the scores f.c - c2 / 2 (the largest the
// nearest: one instruction a score fewer, the epilogue B2 is bound by);
// B1, bound by reading the chunks from L2, keeps c2 in f32 after the
// planes and subtracts it.  Padded centroids score -inf or -2^127, never
// chosen under strict >: no per-score index test.  One cp.async.bulk moves an
// item (a chunk, or a chunk's feature slice) into a ring stage and
// completes on the stage's mbarrier; the consumers release a stage through
// a second mbarrier, with no block-wide barrier a chunk.  bf16x3 takes
// hi.hi, hi.lo and lo.hi into one f32 accumulator (the JAX kernel sums
// (hh + hl) + lh: another order of the same exact products), default one
// pass of the rounded operands.
//
// Two accumulator sets overlap the epilogue with the products: chunk j+1's
// wgmmas are issued, then chunk j's compare-selects run while they do
// (wgmma.wait_group 1).  What bounds it: the products at the tensor rate
// (bf16x3 three passes), the epilogue's compare-selects (~4 instructions a
// score in B2, ~5 in B1), and at default the rows' bytes (B2) or the
// centroids' L2 reads (B1).
//
// Tie-break: a thread scores columns 2t and 2t + 1 of each 8-centroid
// n-tile, n-tiles in ascending order and chunks in ascending order, so it
// visits its centroids in ascending index order with a strict-> running
// (max, index), in kChains chains by n-tile; the chains, the quad's 4
// lanes (and, in B1, the column groups) merge with `nearer`: the lowest
// index wins among equal scores, whatever the fragment layout.

enum Tier { kHighest = 0, kBf16x3 = 1, kDefault = 2 };

// The A/B tool's split of the tiered product (tools/kernel_ab.py, vq-tier
// and tokenizer-tier): bit 1 drops the compare-select epilogue, bit 2 the
// products (3: copies, barriers and fragment loads only), bit 4 (B2) the
// frame tiles' copies and waits (4: products and epilogue only).  In B1's
// bf16 front end (tokenizer.cu) bit 8 drops the DFT products, 16 the mel
// products, 32 the argmin (ids 0 or 1 from the features' first value), 64
// the waveform window's loads and rounding.  Wrong ids; 0 in every
// real build.
#ifndef ATK_TIER_SPLIT
#define ATK_TIER_SPLIT 0
#endif

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have
constexpr int kRingHeader = 128;    // bytes of mbarriers ahead of a ring
constexpr int kMaxStages = 4;       // ring stages at most

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int align128(int x) { return (x + 127) / 128 * 128; }

// Bytes of one item of a centroid image: the hi (and, bf16x3, lo) bf16
// planes of nc centroids x 16 ks features, and either (c2k) a 16-feature
// c2 k-step more a centroid (-c2 / 2 in three bf16 parts, then zeros; zeros
// in the lo plane) or, after the planes, the nc f32 c2.
__host__ __device__ inline int tier_item_bytes(int nc, int ks, bool x3, bool c2k) {
  return (x3 ? 2 : 1) * nc * 16 * (ks + (c2k ? 1 : 0)) * 2 + (c2k ? 0 : nc * 4);
}

// (score, index) for the tiers' f.c - c2 / 2, the larger the nearer: the
// larger wins and, on equal scores, the lower index.
__device__ __forceinline__ bool nearer(float s, int i, float best, int bi) {
  return s > best || (s == best && i < bi);
}

// -- mbarriers and bulk copies --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive, and expect `bytes` more of asynchronous copies on this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait past
// ~20 G cycles (a copy or an arrival that never comes) traps, so that a
// fault surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}
// This thread's cp.async copies so far arrive on bar when they have landed
// (noinc: the barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared
// by the bulk-copy unit, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Order this thread's generic shared-memory accesses before later
// asynchronous-proxy ones (a bulk copy into a buffer threads used).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma --

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across a wgmma issue
// or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major bf16 tile without swizzle at `tile` (shared
// memory): core matrices 128 bytes apart along K (the leading offset) and
// `sbo` bytes apart along the 8-row groups.
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile, int sbo) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d (the warpgroup's m64 x N f32 accumulators, N / 2 a thread, in mma.sync's
// C layout n-tile by n-tile) += a.b: a the thread's m16n8k16-layout A
// fragment (its warp's 16 rows), b the K-major k16 x N bf16 tile of desc;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                        int scale_d) {
  if constexpr (N == 128) {
    wgmma_n128(d, a, desc, scale_d);
  } else {
    static_assert(N == 64, "wgmma widths: 64 or 128 centroids");
    wgmma_n64(d, a, desc, scale_d);
  }
}

// -- the search --

// A warp's 16 feature rows as bf16 A fragments, hi and (bf16x3) lo, KS
// k-steps of 16 features.
template <int KS>
struct RowFrags {
  uint32_t hi[KS][4];
  uint32_t lo[KS][4];
};

// The warp's 16 feature rows -> fragments, at(r, c) giving the f32 pair
// (row r, features c and c + 1) of 16 KS features (zeros past the real
// ones): default rounds, bf16x3 splits; with `div` each value is divided by
// its row's den first (rows g: den0, g + 8: den1).
template <int KS, bool X3, typename At>
__device__ __forceinline__ void load_frags(RowFrags<KS>& a, At at, bool div, float den0,
                                           float den1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = 16 * s + 2 * t;
    const float2 p[4] = {at(g, c), at(g + 8, c), at(g, c + 8), at(g + 8, c + 8)};
    float v[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q][0] = p[q].x;
      v[q][1] = p[q].y;
      if (div) {
        v[q][0] = v[q][0] / (q & 1 ? den1 : den0);
        v[q][1] = v[q][1] / (q & 1 ? den1 : den0);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (X3) {
        split_bf16(v[q][0], v[q][1], a.hi[s][q], a.lo[s][q]);
      } else {
        a.hi[s][q] = pack_bf16(v[q][0], v[q][1]);
      }
    }
  }
}

// The A fragment of the c2 k-step: ones at features 0, 1, 2 of every row
// (exact in bf16), zeros elsewhere.
__device__ __forceinline__ void ones3_frag(uint32_t (&a)[4]) {
  const int t = threadIdx.x % 4;
  const uint32_t one = 0x3F80u;  // bf16 1.0
  a[0] = a[1] = t == 0 ? (one | one << 16) : t == 1 ? one : 0u;
  a[2] = a[3] = 0u;
}

// Issue the products of the warpgroup's rows (fragments a) with the NW
// centroids of the image plane(s) at b (bf16x3: lo plane plane_bytes after
// hi; KS k-steps of features a centroid, and with C2K the c2 k-step), into
// acc (overwritten unless accumulate), as one wgmma group; with c2 (C2K)
// the c2 k-step too, so that acc = f.c - c2 / 2.
template <int KS, int NW, bool X3, bool C2K>
__device__ __forceinline__ void issue_products(float (&acc)[NW / 2], const RowFrags<KS>& a,
                                               const char* b, int plane_bytes, bool accumulate,
                                               bool c2) {
  constexpr int kSbo = 256 * (KS + (C2K ? 1 : 0));  // bytes an 8-centroid group
  const uint64_t dh = kmajor_desc(b, kSbo);
  const uint64_t dl = kmajor_desc(b + plane_bytes, kSbo);
  uint32_t ones[4];
  ones3_frag(ones);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    // k-step s starts 2 core matrices (256 bytes, 16 descriptor units) on
    wgmma_n<NW>(acc, a.hi[s], dh + 16 * s, s > 0 || accumulate);
    if (X3) {
      wgmma_n<NW>(acc, a.hi[s], dl + 16 * s, 1);
      wgmma_n<NW>(acc, a.lo[s], dh + 16 * s, 1);
    }
  }
  if (C2K && c2) wgmma_n<NW>(acc, ones, dh + 16 * KS, 1);
  wgmma_commit();
  fence_acc(acc);
}

// Running minima a thread keeps a row, each over the n-tiles j of one
// residue j % kChains: independent compare-select chains whose latencies
// overlap (2 and 8 time the same on the card).
constexpr int kChains = 4;

// Running (max, index) of the thread's rows g (slot 0) and g + 8 (slot 1)
// over the NW scores f.c - c2 / 2 of centroids n0 + 8 j + 2 t + q, chain j
// % kChains: the products' own sums where they took the c2 k-step, else
// acc - c2s[.] / 2 (one rounding).
template <int NW, bool C2K>
__device__ __forceinline__ void scan_scores(const float (&acc)[NW / 2], const float* c2s, int n0,
                                            float (&best)[kChains][2], int (&bidx)[kChains][2]) {
  const int t = threadIdx.x % 4;
  if (ATK_TIER_SPLIT & 1) {  // no epilogue: one read keeps the products alive
    if (acc[0] == 1.2345e-30f) bidx[0][0] = n0;
    return;
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    float2 cc = make_float2(0.f, 0.f);
    if (!C2K) cc = *reinterpret_cast<const float2*>(c2s + 8 * j + 2 * t);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int ci = n0 + 8 * j + 2 * t + q;
      float s0 = acc[4 * j + q], s1 = acc[4 * j + 2 + q];
      if (!C2K) {
        const float h = -0.5f * (q ? cc.y : cc.x);  // exact
        s0 += h;
        s1 += h;
      }
      const int ch = j % kChains;
      if (s0 > best[ch][0]) {
        best[ch][0] = s0;
        bidx[ch][0] = ci;
      }
      if (s1 > best[ch][1]) {
        best[ch][1] = s1;
        bidx[ch][1] = ci;
      }
    }
  }
}

__device__ __forceinline__ void reset_best(float (&best)[kChains][2], int (&bidx)[kChains][2]) {
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      best[c][r] = -CUDART_INF_F;
      bidx[c][r] = 0;
    }
}

// Merge the chains, then the 4 lanes of each quad: afterwards every lane of
// the quad holds in best[0] / bidx[0] the row's (min, lowest index).
__device__ __forceinline__ void quad_merge(float (&best)[kChains][2], int (&bidx)[kChains][2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 1; c < kChains; ++c)
      if (nearer(best[c][r], bidx[c][r], best[0][r], bidx[0][r])) {
        best[0][r] = best[c][r];
        bidx[0][r] = bidx[c][r];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best[0][r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[0][r], off);
      if (nearer(os, oi, best[0][r], bidx[0][r])) {
        best[0][r] = os;
        bidx[0][r] = oi;
      }
    }
  }
}

// One chunk's products and scores for the split builds: products off (2)
// stand in the fragments for them.
template <int KS, int NW>
__device__ __forceinline__ void fake_products(float (&acc)[NW / 2], const RowFrags<KS>& a) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = __uint_as_float(a.hi[0][i % 4] ^ (i << 20));
}

// The chunk walk of a warpgroup whose rows' fragments are loaded: items
// [0, items) (item i = chunk i, nc centroids), NW of them from column col0
// of each; wait(i) -> the item's stage once it has landed, release(i) once
// its products and scores are done.  Chunk i+1's products are in flight
// while chunk i's scores are compared.
template <int KS, int NW, bool X3, bool C2K, typename Wait, typename Release>
__device__ __forceinline__ void scan_narrow(const RowFrags<KS>& a, int items, int nc, int col0,
                                            int plane_bytes, Wait wait,
                                            Release release, float (&best)[kChains][2],
                                            int (&bidx)[kChains][2]) {
  float acc0[NW / 2], acc1[NW / 2];
  // bytes to the column's 8-centroid group; the c2 after the planes
  const int bcol = col0 / 8 * 256 * (KS + (C2K ? 1 : 0));
  const int c2_off = (X3 ? 2 : 1) * plane_bytes + 4 * col0;
  auto issue = [&](float (&acc)[NW / 2], const char* st) {
    if (ATK_TIER_SPLIT & 2)
      fake_products<KS, NW>(acc, a);
    else
      issue_products<KS, NW, X3, C2K>(acc, a, st + bcol, plane_bytes, false, true);
  };
  auto scores = [&](float (&acc)[NW / 2], int i, const char* st) {
    fence_acc(acc);
    scan_scores<NW, C2K>(acc, reinterpret_cast<const float*>(st + c2_off), i * nc + col0, best,
                         bidx);
  };
  const char* s0 = wait(0);
  issue(acc0, s0);
  int i = 1;
  for (; i + 1 < items; i += 2) {
    const char* s1 = wait(i);
    issue(acc1, s1);
    wgmma_wait<1>();
    scores(acc0, i - 1, s0);
    release(i - 1);
    s0 = wait(i + 1);
    issue(acc0, s0);
    wgmma_wait<1>();
    scores(acc1, i, s1);
    release(i);
  }
  if (i < items) {
    const char* s1 = wait(i);
    issue(acc1, s1);
    wgmma_wait<1>();
    scores(acc0, i - 1, s0);
    release(i - 1);
    wgmma_wait<0>();
    scores(acc1, i, s1);
    release(i);
  } else {
    wgmma_wait<0>();
    scores(acc0, i - 1, s0);
    release(i - 1);
  }
}

// The same for rows wider than the fragments hold: item i = chunk i /
// slices, feature slice i % slices; load(a, slice, stage) fills the
// fragments of a slice, the products are summed over a chunk's slices in
// feature order and scored after the last.  The fragments are reloaded
// after each item's products have finished: no overlap.
template <int KS, int NW, bool X3, bool C2K, typename Wait, typename Release, typename Load>
__device__ __forceinline__ void scan_wide(int chunks, int slices, int nc, int col0,
                                          int plane_bytes, Wait wait, Release release,
                                          Load load, float (&best)[kChains][2], int (&bidx)[kChains][2]) {
  float acc[NW / 2];
  RowFrags<KS> a;
  const int bcol = col0 / 8 * 256 * (KS + (C2K ? 1 : 0));
  const int c2_off = (X3 ? 2 : 1) * plane_bytes + 4 * col0;
  for (int c = 0, i = 0; c < chunks; ++c) {
    for (int s = 0; s < slices; ++s, ++i) {
      const char* st = wait(i);
      load(a, s, st);
      if (ATK_TIER_SPLIT & 2)
        fake_products<KS, NW>(acc, a);
      else
        issue_products<KS, NW, X3, C2K>(acc, a, st + bcol, plane_bytes, s > 0,
                                        s == slices - 1);
      wgmma_wait<0>();
      fence_acc(acc);
      if (s == slices - 1)
        scan_scores<NW, C2K>(acc, reinterpret_cast<const float*>(st + c2_off), c * nc + col0,
                             best, bidx);
      release(i);
    }
  }
}

// B1's argmin at a bf16 tier: for each of the ROWS (64 x RB) feature rows
// in shared memory (row r at fs + r * ldf, 64 slices features, zeros past
// the real ones) the nearest centroid, written to out[r] for r <
// rows_valid.  THREADS = 128 x RB x G: RB warpgroups of rows times G column
// groups, group gi scoring columns [gi NW, (gi + 1) NW) of every 128-wide
// chunk, merged through shared memory.  The centroid image img (chunks x
// slices items of tier_item_bytes(128, 4, X3), the wrapper's) streams
// through a ring of up to 4 stages in `scratch` (scratch_bytes, the
// window's buffer: b1_scratch_bytes), thread 0 refilling a stage once every
// warp has released it.  WIDE: more than 64 features, the fragments
// reloaded per slice.
constexpr int kB1Chunk = 128;
constexpr int kB1Ks = 4;

__host__ __device__ inline int b1_slices(int m) { return ceil_div(ceil_div(m, 16), kB1Ks); }
__host__ __device__ inline int b1_merge_bytes(int rows, int groups) {
  return groups > 1 ? groups * rows * 8 : 0;
}
// Shared scratch the argmin needs for `stages` ring stages.
__host__ __device__ inline int b1_scratch_bytes(int stages, bool x3, int rows, int groups) {
  return kRingHeader + stages * align128(tier_item_bytes(kB1Chunk, kB1Ks, x3, false)) +
         b1_merge_bytes(rows, groups);
}

template <int THREADS, int ROWS, bool X3, bool WIDE>
__device__ void block_argmin_wg(const float* fs, int ldf, const char* __restrict__ img,
                                int slices, int chunks, char* scratch, int scratch_bytes,
                                int* out, int rows_valid) {
  constexpr int RB = ROWS / 64, G = THREADS / (128 * RB), NW = kB1Chunk / G;
  static_assert(G * 128 * RB == THREADS && (G == 1 || G == 2), "warpgroups x column groups");
  const int ibytes = tier_item_bytes(kB1Chunk, kB1Ks, X3, false), istride = align128(ibytes);
  const int merge = b1_merge_bytes(ROWS, G);
  int stages = (scratch_bytes - kRingHeader - merge) / istride;
  stages = stages < kMaxStages ? stages : kMaxStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch);
  uint64_t* empty = full + kMaxStages;
  char* ring = scratch + kRingHeader;
  float* mbest = reinterpret_cast<float*>(ring + stages * istride);
  int* midx = reinterpret_cast<int*>(mbest + G * ROWS);
  const int items = chunks * slices;
  fence_proxy_async();  // the window's generic accesses before the copies
  __syncthreads();      // the features are written; scratch is free
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, THREADS / 32);
    }
    mbar_init_fence();
    for (int i = 0; i < stages && i < items; ++i) {
      mbar_expect(full + i, ibytes);
      bulk_copy(ring + i * istride, img + static_cast<size_t>(i) * ibytes, ibytes, full + i);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, rb = wg % RB, gi = wg / RB;
  auto wait = [&](int i) -> const char* {
    mbar_wait(full + i % stages, (i / stages) & 1);
    return ring + (i % stages) * istride;
  };
  auto release = [&](int i) {
    const int st = i % stages;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
    if (threadIdx.x == 0 && i + stages < items) {
      mbar_wait(empty + st, (i / stages) & 1);
      mbar_expect(full + st, ibytes);
      bulk_copy(ring + st * istride, img + static_cast<size_t>(i + stages) * ibytes, ibytes,
                full + st);
    }
    __syncwarp();
  };
  const float* f = fs + (64 * rb + 16 * (warp % 4)) * ldf;
  const int plane_bytes = kB1Chunk * 16 * kB1Ks * 2;
  float best[kChains][2];
  int bidx[kChains][2];
  reset_best(best, bidx);
  if (!WIDE) {
    RowFrags<kB1Ks> a;
    load_frags<kB1Ks, X3>(a, [&](int r, int c) { return make_float2(f[r * ldf + c], f[r * ldf + c + 1]); },
                          false, 1.f, 1.f);
    scan_narrow<kB1Ks, NW, X3, false>(a, items, kB1Chunk, gi * NW, plane_bytes, wait, release,
                               best, bidx);
  } else {
    auto load = [&](RowFrags<kB1Ks>& a, int s, const char*) {
      const float* fsl = f + 16 * kB1Ks * s;
      load_frags<kB1Ks, X3>(
          a, [&](int r, int c) { return make_float2(fsl[r * ldf + c], fsl[r * ldf + c + 1]); },
          false, 1.f, 1.f);
    };
    scan_wide<kB1Ks, NW, X3, false>(chunks, slices, kB1Chunk, gi * NW, plane_bytes, wait,
                             release, load, best, bidx);
  }
  quad_merge(best, bidx);
  const int r0 = 64 * rb + 16 * (warp % 4) + lane / 4;
  if (G == 1) {
    if (lane % 4 == 0) {
      if (r0 < rows_valid) out[r0] = bidx[0][0];
      if (r0 + 8 < rows_valid) out[r0 + 8] = bidx[0][1];
    }
    return;
  }
  if (lane % 4 == 0) {
    mbest[gi * ROWS + r0] = best[0][0];
    midx[gi * ROWS + r0] = bidx[0][0];
    mbest[gi * ROWS + r0 + 8] = best[0][1];
    midx[gi * ROWS + r0 + 8] = bidx[0][1];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows_valid; r += THREADS) {
    float b = mbest[r];
    int bi = midx[r];
    for (int q = 1; q < G; ++q)
      if (nearer(mbest[q * ROWS + r], midx[q * ROWS + r], b, bi)) {
        b = mbest[q * ROWS + r];
        bi = midx[q * ROWS + r];
      }
    out[r] = bi;
  }
}

// block_argmin_wg with the tier and the width picked at run time.
template <int THREADS, int ROWS>
__device__ void block_argmin_wg_any(const float* fs, int ldf, const char* img, bool x3,
                                    int slices, int chunks, char* scratch, int scratch_bytes,
                                    int* out, int rows_valid) {
  if (x3) {
    if (slices > 1)
      block_argmin_wg<THREADS, ROWS, true, true>(fs, ldf, img, slices, chunks, scratch,
                                                 scratch_bytes, out, rows_valid);
    else
      block_argmin_wg<THREADS, ROWS, true, false>(fs, ldf, img, slices, chunks, scratch,
                                                  scratch_bytes, out, rows_valid);
  } else {
    if (slices > 1)
      block_argmin_wg<THREADS, ROWS, false, true>(fs, ldf, img, slices, chunks, scratch,
                                                  scratch_bytes, out, rows_valid);
    else
      block_argmin_wg<THREADS, ROWS, false, false>(fs, ldf, img, slices, chunks, scratch,
                                                   scratch_bytes, out, rows_valid);
  }
}

// Dynamic shared memory above 48 KB must be granted per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace atk
