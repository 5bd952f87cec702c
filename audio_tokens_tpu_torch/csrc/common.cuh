// Shared pieces of the port's kernels: the C export macro, the error-string
// export, the cp.async copies, the (score, index) order of the nearest-
// centroid argmin (B1 and B2), and the normalize + scoring + argmin that
// kernel B1 (tokenizer.cu) ends with (B2, vq.cu, has its own).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

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

// Dynamic shared memory above 48 KB must be granted per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace atk
