// Kernel B1: padded waveform -> token ids in one kernel.
//
// Replaces audio_tokens_tpu/ops/pallas_tokenizer.py::_kernel (launched by
// TokenizerKernel.__call__).
//
// wave (B, stride) f32, rows reflect-padded as ops/mel.prepare_batch lays
// them out; only the first padded_len samples of a row are read, a longer
// row's tail is ignored.  Frame f of a clip is samples [f*hop, f*hop+n_fft).
// Per frame: Hann-windowed real DFT against basis (rows, 2*nb) = [re | im]
// of bins 0..nb-1 (the Nyquist bin is dropped, its filterbank row is
// exactly zero) -> power re^2 + im^2 -> mel product with fb (nb, M) ->
// 10*log10(max(mel, 1e-10)) -> x / (||x|| + 1e-10) -> nearest of the k
// centroids by ||c||^2 - 2 f.c, lowest index among ties -> out (B, n_frames)
// int32.  The wrapper (ops/cuda_tokenizer.py) pads the basis with zero rows
// to a multiple of 16 (rows >= n_fft) and with zero bins, and fb with zero
// rows, to a multiple of 128 bins: the zeros add nothing to any sum.  Only
// waveform bytes are read and token bytes written: no frame, spectrum or mel
// tensor goes to device memory.
//
// What bounds it on the H100: the DFT product, 2 * n_fft * n_fft flops per
// frame (57.8 GFLOP for a batch of 64 ten-second clips), against 56 MB of
// waveform read, so it is bound by float32 FMA issue.  The design:
// - a block owns one clip x FT frames (FT = 128, or 64 where 128 frames'
//   shared memory would not fit), FT / 8 warps.  The tile's overlapping
//   waveform window ((FT-1)*hop + rows samples) sits in shared memory and
//   frames are read from it in place, never copied;
// - the basis does not fit shared memory (1 MB at n_fft 512), so it streams
//   through a 2-stage cp.async ring of FT/8 samples x 256 columns (re and im
//   of 128 bins), the next stage loading while this one is used.  Each block
//   reads the basis once, so the card reads it (frame tiles) times from L2:
//   0.9 GB at FT 128, 1.7 GB at FT 64;
// - a thread holds a register tile of 8 frames x re and im of 4 bins (64
//   accumulators) over a pass of 128 bins: lanes run along the bins, so a
//   basis load is one conflict-free float4 per lane that feeds 32 FMAs, and
//   a window load is a float4 (4 samples) broadcast to the warp, since all
//   lanes read the same frame (frames lie hop floats apart, so lanes along
//   frames would all read one bank).  The power is squared in registers;
// - after each pass its 128 bins' power goes to shared memory and the mel
//   product adds those bins into the features, fb streamed through the
//   (then idle) ring in pieces; lanes run along the mel bands;
// - the features' shared buffer then holds the unit features, and the
//   window's buffer the centroid chunks of the argmin, which is B2's
//   (common.cuh).
// Plain f32 FMA, no tensor cores: the f32 scores keep the reference's tokens
// (TF32 flips them).
#include "common.cuh"

namespace {

// Frames a block owns where its shared memory fits (else 64); the A/B tool
// builds 64 with -DATK_TOKENIZER_FRAMES=64.
#ifndef ATK_TOKENIZER_FRAMES
#define ATK_TOKENIZER_FRAMES 128
#endif
static_assert(ATK_TOKENIZER_FRAMES == 64 || ATK_TOKENIZER_FRAMES == 128,
              "ATK_TOKENIZER_FRAMES must be 64 or 128");
constexpr int kDefaultFrames = ATK_TOKENIZER_FRAMES;

constexpr int kBins = 128;             // bins of one pass: 32 lanes x 4
constexpr int kCols = 2 * kBins;       // a ring row: re | im of the pass's bins
constexpr int kWarpFrames = 8;         // frames of a thread's register tile
constexpr int kRowMultiple = 16;       // the basis' rows, padded (the wrapper)
constexpr int kArgminRows = 4;         // argmin rows a thread group scores: FT / (threads / 16)

// Shared memory of a block, in floats: the window (later the argmin's
// centroid chunks), the ring (also the fb pieces), one pass's power, the
// features (FT x (m + 1)).  Each region starts 16-byte aligned.
struct Layout {
  int win, ring, pw, fs;
  __host__ __device__ Layout(int ft, int hop, int rows, int m) {
    const int w = (ft - 1) * hop + rows;
    const int cs = atk::kChunk * (m + 1) + atk::kChunk;
    win = ((w > cs ? w : cs) + 3) / 4 * 4;
    ring = 2 * (ft / 8) * kCols;
    pw = ft * kBins;
    fs = ft * (m + 1);
  }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(win + ring + pw + fs) * sizeof(float);
  }
};

// VEC: hop is a multiple of 4, so a frame's 4 samples load as one float4.
template <int FT, bool VEC>
__global__ void __launch_bounds__(FT / kWarpFrames * 32, FT == 64 ? 2 : 1)
tokenizer_kernel(const float* __restrict__ wave, long stride, long padded_len,
                 int n_frames, int hop, int rows,
                 const float* __restrict__ basis, int nb,
                 const float* __restrict__ fb, int m,
                 const float* __restrict__ cent, const float* __restrict__ c2,
                 int k, int* __restrict__ out) {
  constexpr int kThreads = FT / kWarpFrames * 32;
  constexpr int kStage = FT / 8;             // samples a ring stage holds
  constexpr int kStageFloats = kStage * kCols;
  extern __shared__ float4 smem4[];
  const Layout lay(FT, hop, rows, m);
  float* win = reinterpret_cast<float*>(smem4);
  float* ring = win + lay.win;
  float* pw = ring + lay.ring;
  float* fs = pw + lay.pw;
  const int ldf = m + 1;
  const int t = threadIdx.x, lane = t % 32;
  const int f0 = (t / 32) * kWarpFrames;     // the warp's first frame of the tile
  const int t0 = blockIdx.x * FT;
  const int clip = blockIdx.y;
  const size_t ldb = 2 * static_cast<size_t>(nb);
  const int tiles = rows / kStage;

  // ring stage `buf` <- basis rows [tile * kStage, + kStage) x (re, im) of
  // bins [pass * 128, + 128); the caller waits
  auto issue = [&](int pass, int tile, int buf) {
    float* dst = ring + buf * kStageFloats;
    for (int e = t; e < kStageFloats / 4; e += kThreads) {
      const int r = e / (kCols / 4), c4 = e % (kCols / 4);
      const int col = pass * kBins + (c4 < kBins / 4 ? 4 * c4 : nb + 4 * (c4 - kBins / 4));
      atk::cp_async16(dst + r * kCols + 4 * c4,
                      basis + static_cast<size_t>(tile * kStage + r) * ldb + col, true);
    }
    atk::cp_async_commit();
  };
  issue(0, 0, 0);

  // the tile's waveform window, zeros past padded_len; the mel sums start at 0
  const float* src = wave + clip * stride + static_cast<long>(t0) * hop;
  const long avail = padded_len - static_cast<long>(t0) * hop;
  const int wlen = (FT - 1) * hop + rows;
  for (int e = t; e < wlen; e += kThreads) win[e] = e < avail ? src[e] : 0.f;
  for (int e = t; e < lay.fs; e += kThreads) fs[e] = 0.f;
  const float* wrow = win + f0 * hop;

  const int passes = nb / kBins;
  int piece = lay.ring / m;  // fb rows a ring piece holds: a multiple of 4
  piece = piece < kBins ? piece / 4 * 4 : kBins;
  for (int pass = 0; pass < passes; ++pass) {
    // windowed real DFT of bins [pass * 128, + 128) -> power
    float re[kWarpFrames][4], im[kWarpFrames][4];
#pragma unroll
    for (int i = 0; i < kWarpFrames; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) re[i][c] = im[i][c] = 0.f;
    for (int tile = 0; tile < tiles; ++tile) {
      const int buf = tile & 1;
      if (tile + 1 < tiles) {
        issue(pass, tile + 1, buf ^ 1);
        atk::cp_async_wait<1>();
      } else {
        atk::cp_async_wait<0>();
      }
      __syncthreads();  // stage buf (and, the first time, the window) visible
      const float* st = ring + buf * kStageFloats;
      const int s0 = tile * kStage;
#pragma unroll
      for (int ss = 0; ss < kStage; ss += 4) {
        float x[kWarpFrames][4];
#pragma unroll
        for (int i = 0; i < kWarpFrames; ++i) {
          const float* w = wrow + i * hop + s0 + ss;
          if (VEC) {
            const float4 v = *reinterpret_cast<const float4*>(w);
            x[i][0] = v.x;
            x[i][1] = v.y;
            x[i][2] = v.z;
            x[i][3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) x[i][q] = w[q];
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 br = *reinterpret_cast<const float4*>(st + (ss + q) * kCols + 4 * lane);
          const float4 bi =
              *reinterpret_cast<const float4*>(st + (ss + q) * kCols + kBins + 4 * lane);
#pragma unroll
          for (int i = 0; i < kWarpFrames; ++i) {
            const float xv = x[i][q];
            re[i][0] = fmaf(xv, br.x, re[i][0]);
            re[i][1] = fmaf(xv, br.y, re[i][1]);
            re[i][2] = fmaf(xv, br.z, re[i][2]);
            re[i][3] = fmaf(xv, br.w, re[i][3]);
            im[i][0] = fmaf(xv, bi.x, im[i][0]);
            im[i][1] = fmaf(xv, bi.y, im[i][1]);
            im[i][2] = fmaf(xv, bi.z, im[i][2]);
            im[i][3] = fmaf(xv, bi.w, im[i][3]);
          }
        }
      }
      __syncthreads();  // stage buf free for the tile after next
    }
#pragma unroll
    for (int i = 0; i < kWarpFrames; ++i)
      *reinterpret_cast<float4*>(pw + (f0 + i) * kBins + 4 * lane) = make_float4(
          re[i][0] * re[i][0] + im[i][0] * im[i][0], re[i][1] * re[i][1] + im[i][1] * im[i][1],
          re[i][2] * re[i][2] + im[i][2] * im[i][2], re[i][3] * re[i][3] + im[i][3] * im[i][3]);

    // mel product of this pass's bins, fb through the idle ring in pieces;
    // each feature (frame, band) has one owner thread: no race, fixed order
    for (int j0 = 0; j0 < kBins; j0 += piece) {
      const int prow = min(piece, kBins - j0);
      const float* fsrc = fb + static_cast<size_t>(pass * kBins + j0) * m;
      __syncthreads();  // the power is written; the ring's last readers are done
      for (int e = t; e < prow * m; e += kThreads) ring[e] = fsrc[e];
      __syncthreads();
      for (int mg = 0; mg < m; mg += 64) {
        const int ma = mg + lane, mb = ma + 32;
        float acc[kWarpFrames][2];
#pragma unroll
        for (int i = 0; i < kWarpFrames; ++i) acc[i][0] = acc[i][1] = 0.f;
        for (int j = 0; j < prow; j += 4) {
          float4 pv[kWarpFrames];
#pragma unroll
          for (int i = 0; i < kWarpFrames; ++i)
            pv[i] = *reinterpret_cast<const float4*>(pw + (f0 + i) * kBins + j0 + j);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float wa = ma < m ? ring[(j + q) * m + ma] : 0.f;
            const float wb = mb < m ? ring[(j + q) * m + mb] : 0.f;
#pragma unroll
            for (int i = 0; i < kWarpFrames; ++i) {
              const float p = q == 0 ? pv[i].x : q == 1 ? pv[i].y : q == 2 ? pv[i].z : pv[i].w;
              acc[i][0] = fmaf(p, wa, acc[i][0]);
              acc[i][1] = fmaf(p, wb, acc[i][1]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kWarpFrames; ++i) {
          if (ma < m) fs[(f0 + i) * ldf + ma] += acc[i][0];
          if (mb < m) fs[(f0 + i) * ldf + mb] += acc[i][1];
        }
      }
    }
    __syncthreads();  // the ring and the power are free again
    if (pass + 1 < passes) issue(pass + 1, 0, 0);
  }

  // dB, unit norm, nearest centroid
  for (int e = t; e < FT * m; e += kThreads) {
    float* p = fs + (e / m) * ldf + e % m;
    *p = 10.0f * log10f(fmaxf(*p, 1e-10f));
  }
  __syncthreads();
  atk::normalize_rows(fs, ldf, m, FT);
  // block_argmin synchronizes before it overwrites the window or reads fs
  const int rows_valid = min(FT, n_frames - t0);
  atk::block_argmin<kArgminRows, kThreads>(fs, ldf, m, cent, c2, k, win,
                                           win + atk::kChunk * ldf,
                                           out + static_cast<long>(clip) * n_frames + t0,
                                           rows_valid);
}

template <int FT>
cudaError_t launch(const float* wave, int batch, long stride, long padded_len, int n_frames,
                   int hop, int rows, const float* basis, int nb, const float* fb, int m,
                   const float* cent, const float* c2, int k, int* out, cudaStream_t stream) {
  static_assert(kArgminRows * (FT / kWarpFrames * 32) / atk::kColThreads == FT,
                "argmin rows must cover the tile");
  constexpr int kThreads = FT / kWarpFrames * 32;
  const size_t smem = Layout(FT, hop, rows, m).bytes();
  const dim3 grid((n_frames + FT - 1) / FT, batch);
  cudaError_t err;
  if (hop % 4 == 0) {
    err = atk::allow_smem(tokenizer_kernel<FT, true>, smem);
    if (err != cudaSuccess) return err;
    tokenizer_kernel<FT, true><<<grid, kThreads, smem, stream>>>(
        wave, stride, padded_len, n_frames, hop, rows, basis, nb, fb, m, cent, c2, k, out);
  } else {
    err = atk::allow_smem(tokenizer_kernel<FT, false>, smem);
    if (err != cudaSuccess) return err;
    tokenizer_kernel<FT, false><<<grid, kThreads, smem, stream>>>(
        wave, stride, padded_len, n_frames, hop, rows, basis, nb, fb, m, cent, c2, k, out);
  }
  return cudaGetLastError();
}

}  // namespace

// B1.  basis (rows, 2 nb) with rows a multiple of 16 and nb of 128; fb
// (nb, m).  A 128-frame block whose shared memory would pass 227 KB takes
// 64 frames.
ATK_EXPORT int atk_tokenize(const float* wave, int batch, long stride, long padded_len,
                            int n_frames, int hop, int rows, const float* basis, int nb,
                            const float* fb, int m, const float* cent, const float* c2, int k,
                            int* out, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  constexpr size_t kMaxSmem = 227 * 1024;
  if (rows % kRowMultiple || nb % kBins || hop < 1 || m < 1 || k < 1 ||
      Layout(64, hop, rows, m).ring / m < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  int ft = kDefaultFrames;
  if (ft == 128 && Layout(128, hop, rows, m).bytes() > kMaxSmem) ft = 64;
  if (Layout(ft, hop, rows, m).bytes() > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      ft == 128 ? launch<128>(wave, batch, stride, padded_len, n_frames, hop, rows, basis, nb, fb,
                              m, cent, c2, k, out, st)
                : launch<64>(wave, batch, stride, padded_len, n_frames, hop, rows, basis, nb, fb,
                             m, cent, c2, k, out, st);
  return static_cast<int>(err);
}
