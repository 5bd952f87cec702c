// Kernel B1: padded waveform -> token ids in one kernel.
//
// Replaces audio_tokens_tpu/ops/pallas_tokenizer.py::_kernel (launched by
// TokenizerKernel.__call__).
//
// wave (B, stride) f32, rows reflect-padded as ops/mel.prepare_batch lays
// them out; only the first padded_len samples of a row are read, a longer
// row's tail is ignored.  Frame f of a clip is samples [f*hop, f*hop+n_fft).
// Per frame: Hann-windowed real DFT against basis (n_fft, 2*nb) = [re | im]
// of bins 0..nb-1 (nb = n_fft/2: the Nyquist bin is dropped, its filterbank
// row is exactly zero) -> power re^2 + im^2 -> mel product with fb (nb, M)
// -> 10*log10(max(mel, 1e-10)) -> x / (||x|| + 1e-10) -> nearest of the k
// centroids by ||c||^2 - 2 f.c, lowest index among ties -> out (B, n_frames)
// int32.  Only waveform bytes are read and token bytes written: no frame,
// spectrum or mel tensor goes to device memory.
//
// What bounds it on the H100: the DFT product, 2 * n_fft * n_fft flops per
// frame (57.8 GFLOP for a batch of 64 ten-second clips), against 56 MB of
// waveform read, so it is bound by float32 FMA issue.  The design: one
// block of 256 threads per (clip, 32-frame tile).  The tile's overlapping
// waveform window ((32-1)*hop + n_fft samples) sits in shared memory and
// frames are read from it in place, never copied.  The DFT basis (1 MB at
// n_fft 512) does not fit a block's shared memory, so each thread streams
// the re and im columns of two bins from L2 with coalesced loads
// for 8 frames (re, im accumulators in registers), squaring them straight
// into the power tile.  The power tile's shared buffer is then reused for the
// centroid chunks of the argmin, which is B2's (common.cuh).  Plain f32
// FMA, no tensor cores yet: the f32 scores keep the reference's tokens.
#include "common.cuh"

namespace {

constexpr int kTileT = 32;                   // frames per block
constexpr int kRpt = kTileT / atk::kRowThreads;  // argmin rows per thread: 2
// DFT: 64 lanes along bins x 4 frame groups; a thread accumulates re and
// im of 2 bins (lane, lane + 64) for 8 frames (group + 4 i), so each basis
// value loaded from L2 feeds 8 FMAs and each window value 4
constexpr int kBinLanes = 64;
constexpr int kFrameGroups = atk::kThreads / kBinLanes;     // 4
constexpr int kDftFrames = kTileT / kFrameGroups;           // 8
// mel: 32 lanes along mel bands x 8 warps; 4 frames (warp + 8 i) a thread
constexpr int kMelLanes = 32;
constexpr int kMelWarps = atk::kThreads / kMelLanes;        // 8
constexpr int kMelFrames = kTileT / kMelWarps;              // 4

static_assert(kRpt * atk::kRowThreads == kTileT, "tile must match argmin rows");

struct Smem {
  int win_len, p_len, f_len;
  __host__ __device__ Smem(int hop, int n_fft, int nb, int m) {
    win_len = (kTileT - 1) * hop + n_fft;
    const int power = kTileT * (nb + 1);
    const int chunk = atk::kChunk * (m + 1) + atk::kChunk;
    p_len = power > chunk ? power : chunk;
    f_len = kTileT * (m + 1);
  }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(win_len + p_len + f_len) * sizeof(float);
  }
};

__global__ void __launch_bounds__(atk::kThreads)
tokenizer_kernel(const float* __restrict__ wave, long stride, long padded_len,
                 int n_frames, int hop, int n_fft,
                 const float* __restrict__ basis, int nb,
                 const float* __restrict__ fb, int m,
                 const float* __restrict__ cent, const float* __restrict__ c2,
                 int k, int* __restrict__ out) {
  extern __shared__ float smem[];
  const Smem lay(hop, n_fft, nb, m);
  float* win = smem;
  float* pw = win + lay.win_len;   // power tile, later the centroid chunks
  float* fs = pw + lay.p_len;      // unit features
  const int ldp = nb + 1, ldf = m + 1;
  const int t = threadIdx.x;
  const int lane = t % kMelLanes, tw = t / kMelLanes;
  const int t0 = blockIdx.x * kTileT;
  const int clip = blockIdx.y;

  // overlapping waveform window of the tile; zeros past padded_len
  const float* src = wave + clip * stride + static_cast<long>(t0) * hop;
  const long avail = padded_len - static_cast<long>(t0) * hop;
  for (int e = t; e < lay.win_len; e += atk::kThreads)
    win[e] = e < avail ? src[e] : 0.f;
  __syncthreads();

  // windowed real DFT -> power: bins (lane, lane + 64) of each 128-bin pass
  const size_t ldb = 2 * static_cast<size_t>(nb);
  const int bl = t % kBinLanes, fg = t / kBinLanes;
  for (int j0 = 0; j0 < nb; j0 += 2 * kBinLanes) {
    const int ja = j0 + bl, jb = ja + kBinLanes;
    const bool va = ja < nb, vb = jb < nb;
    float ra[kDftFrames], ia[kDftFrames], rb[kDftFrames], ib[kDftFrames];
#pragma unroll
    for (int i = 0; i < kDftFrames; ++i) ra[i] = ia[i] = rb[i] = ib[i] = 0.f;
#pragma unroll 2
    for (int s = 0; s < n_fft; ++s) {
      const float* row = basis + s * ldb;
      const float wra = va ? __ldg(row + ja) : 0.f;
      const float wia = va ? __ldg(row + nb + ja) : 0.f;
      const float wrb = vb ? __ldg(row + jb) : 0.f;
      const float wib = vb ? __ldg(row + nb + jb) : 0.f;
#pragma unroll
      for (int i = 0; i < kDftFrames; ++i) {
        const float x = win[(fg + kFrameGroups * i) * hop + s];
        ra[i] = fmaf(x, wra, ra[i]);
        ia[i] = fmaf(x, wia, ia[i]);
        rb[i] = fmaf(x, wrb, rb[i]);
        ib[i] = fmaf(x, wib, ib[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kDftFrames; ++i) {
      float* prow = pw + (fg + kFrameGroups * i) * ldp;
      if (va) prow[ja] = ra[i] * ra[i] + ia[i] * ia[i];
      if (vb) prow[jb] = rb[i] * rb[i] + ib[i] * ib[i];
    }
  }
  __syncthreads();

  // mel product -> dB, one mel band per lane
  for (int m0 = 0; m0 < m; m0 += kMelLanes) {
    const int mb = m0 + lane;
    const bool valid = mb < m;
    float acc[kMelFrames];
#pragma unroll
    for (int i = 0; i < kMelFrames; ++i) acc[i] = 0.f;
    for (int j = 0; j < nb; ++j) {
      const float w = valid ? __ldg(fb + static_cast<size_t>(j) * m + mb) : 0.f;
#pragma unroll
      for (int i = 0; i < kMelFrames; ++i)
        acc[i] = fmaf(pw[(tw + kMelWarps * i) * ldp + j], w, acc[i]);
    }
    if (valid) {
#pragma unroll
      for (int i = 0; i < kMelFrames; ++i)
        fs[(tw + kMelWarps * i) * ldf + mb] = 10.0f * log10f(fmaxf(acc[i], 1e-10f));
    }
  }
  __syncthreads();
  atk::normalize_rows(fs, ldf, m, kTileT);
  // block_argmin synchronizes before it overwrites pw or reads fs
  const int rows_valid = min(kTileT, n_frames - t0);
  atk::block_argmin<kRpt>(fs, ldf, m, cent, c2, k, pw, pw + atk::kChunk * ldf,
                          out + static_cast<long>(clip) * n_frames + t0,
                          rows_valid);
}

}  // namespace

ATK_EXPORT int atk_tokenize(const float* wave, int batch, long stride,
                            long padded_len, int n_frames, int hop, int n_fft,
                            const float* basis, int nb, const float* fb, int m,
                            const float* cent, const float* c2, int k, int* out,
                            void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  const size_t smem = Smem(hop, n_fft, nb, m).bytes();
  cudaError_t err = atk::allow_smem(tokenizer_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTileT - 1) / kTileT, batch);
  tokenizer_kernel<<<grid, atk::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      wave, stride, padded_len, n_frames, hop, n_fft, basis, nb, fb, m, cent,
      c2, k, out);
  return static_cast<int>(cudaGetLastError());
}
