// Kernel B2: fused (optional) L2 normalize + nearest-centroid assignment.
//
// Replaces audio_tokens_tpu/ops/pallas_vq.py::_vq_kernel.
//
// frames (n, d) f32, centroids (k, d) f32, c2 = ||c||^2 (k,) f32 computed by
// the wrapper -> out (n,) int32, the lowest index among equal scores.
//
// What bounds it on the H100: at the slice's shapes (n = 110,272 frames,
// d = 64, k = 500) the distance product is 7.1 GFLOP against 28 MB of
// frames read, so it is bound by float32 FMA issue, not by bytes.  The
// design keeps every intermediate on chip: a block of 256 threads takes 64
// frame rows into shared memory, normalizes them there, and scores them
// against centroid chunks of 64 staged through shared memory, each thread
// holding a 4 x 4 register tile of scores and a running (min, index) per
// row; only the int32 ids are written.  It uses no tensor cores yet (plain
// f32 FMA, so the scores are full float32 like the reference's HIGHEST
// products); wgmma/TMA tiles are later work.
#include "common.cuh"

namespace {

constexpr int kRpt = 4;                                // rows per thread
constexpr int kTileRows = atk::kRowThreads * kRpt;     // 64 rows per block

__global__ void __launch_bounds__(atk::kThreads)
vq_kernel(const float* __restrict__ frames, int n, int d,
          const float* __restrict__ cent, const float* __restrict__ c2, int k,
          int normalize, int* __restrict__ out) {
  extern __shared__ float smem[];
  const int ldf = d + 1;
  float* fs = smem;                         // kTileRows * ldf
  float* cs = fs + kTileRows * ldf;         // kChunk * ldf
  float* c2s = cs + atk::kChunk * ldf;      // kChunk
  const long row0 = static_cast<long>(blockIdx.x) * kTileRows;
  const long left = n - row0;
  const int rows_valid = left < kTileRows ? static_cast<int>(left) : kTileRows;
  for (int e = threadIdx.x; e < kTileRows * d; e += atk::kThreads) {
    const int r = e / d, j = e - r * d;
    fs[r * ldf + j] = r < rows_valid ? frames[(row0 + r) * d + j] : 0.f;
  }
  __syncthreads();
  if (normalize) atk::normalize_rows(fs, ldf, d, kTileRows);
  // block_argmin synchronizes before it first reads fs
  atk::block_argmin<kRpt>(fs, ldf, d, cent, c2, k, cs, c2s, out + row0,
                          rows_valid);
}

}  // namespace

ATK_EXPORT int atk_vq_argmin(const float* frames, int n, int d,
                             const float* cent, const float* c2, int k,
                             int normalize, int* out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem =
      ((size_t)(kTileRows + atk::kChunk) * (d + 1) + atk::kChunk) * sizeof(float);
  cudaError_t err = atk::allow_smem(vq_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kTileRows - 1) / kTileRows;
  vq_kernel<<<grid, atk::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      frames, n, d, cent, c2, k, normalize, out);
  return static_cast<int>(cudaGetLastError());
}
