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
//
// The precision tiers (atk_tokenize_tier; the JAX kernel's `tier` and
// `vq_tier`, config tokenizer_precision and tokenizer_vq_precision):
// - vq_tier bf16x3 or default: the argmin's distance product runs on
//   wgmma (common.cuh's block_argmin_wg), after either front end, its
//   centroid chunks streamed by bulk copies through a ring in the window's
//   (with the ring's and the power's, the f32 front end's) idle buffer; any
//   number of mel bands, in 64-band slices past 64;
// - tier bf16x3 or default: the DFT and mel products run on the tensor cores
//   (tokenizer_mma_kernel), bf16 operands with f32 accumulation: bf16x3
//   takes the three passes hi.hi + hi.lo + lo.hi of _dot_tier, default one
//   pass of both operands rounded to bf16 (what the TPU computes for
//   Precision.DEFAULT on f32 operands).  A block owns 128 frames in 8 warps
//   of 16.  The tile's waveform window is rounded to bf16 once (hi, and lo at
//   bf16x3) into shared memory, laid out in hop-sample blocks 8 values apart
//   so that the 8 frames an ldmatrix reads fall on 8 bank groups, and read in
//   place as the A fragments; the Hann window lives in the basis, so raw
//   samples are what gets rounded, as in the JAX kernel.  The basis, split
//   and transposed once by the wrapper (bins x samples, bf16), streams
//   through a 2-stage cp.async ring, 32 samples x 128 columns (re and im of
//   64 bins) a stage; a warp holds the 16 frames x 128 columns in
//   registers, squares them into the power and, the accumulators of two
//   neighbouring n-tiles being an A fragment, feeds the power straight into
//   the mel product (the filterbank split and transposed by the wrapper,
//   one pass's 64 bins at a time through the idle ring) without a shared
//   buffer; the mel sums stay in registers over the passes.  The three
//   passes of bf16x3 add into one f32 accumulator, k-step by k-step, where
//   _dot_tier adds three products: another summation order.  At 64
//   ten-second clips the DFT is 57.8 GFLOP: 0.175 ms at bf16x3 (three
//   passes at 989 TFLOP/s), 0.058 ms at default.
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

// Feature pitch (floats) of the argmin: at a bf16 vq tier whole slices of
// the tiered argmin (zeros past m), plus one so rows fall on other banks.
__host__ __device__ inline int feat_pitch(int m, int vq) {
  return vq ? 16 * atk::kB1Ks * atk::b1_slices(m) + 1 : m + 1;
}

// Ring stages the tiered argmin is given room for (it takes up to 4 where
// the window's buffer is larger).
constexpr int kArgminStages = 4;

// Shared memory of a block, in floats: the window (later, with the ring and
// the power, the argmin's centroid chunks), the ring (also the fb pieces),
// one pass's power, the features (FT x feat_pitch).  Each region starts
// 16-byte aligned.  vq: the argmin's tier (0 highest: f32 chunks in the
// window; else block_argmin_wg's ring).
struct Layout {
  int win, ring, pw, fs;
  __host__ __device__ Layout(int ft, int hop, int rows, int m, int vq = 0) {
    const int w = (ft - 1) * hop + rows;
    ring = 2 * (ft / 8) * kCols;
    pw = ft * kBins;
    const int cs =
        vq ? atk::ceil_div(atk::b1_scratch_bytes(kArgminStages, vq == atk::kBf16x3, ft, 2), 4) -
                 ring - pw
           : atk::kChunk * (m + 1) + atk::kChunk;
    win = ((w > cs ? w : cs) + 3) / 4 * 4;
    fs = ft * feat_pitch(m, vq);
  }
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(win + ring + pw + fs) * sizeof(float);
  }
};

// VEC: hop is a multiple of 4, so a frame's 4 samples load as one float4.
// TVQ: the argmin at a bf16 tier (vq: bf16x3 or default) against the
// centroid image timg (block_argmin_wg's); else the f32 argmin on cent.
template <int FT, bool VEC, bool TVQ>
__global__ void __launch_bounds__(FT / kWarpFrames * 32, FT == 64 ? 2 : 1)
tokenizer_kernel(const float* __restrict__ wave, long stride, long padded_len,
                 int n_frames, int hop, int rows,
                 const float* __restrict__ basis, int nb,
                 const float* __restrict__ fb, int m,
                 const float* __restrict__ cent, const float* __restrict__ c2,
                 int k, const char* __restrict__ timg, int vq,
                 int* __restrict__ out) {
  constexpr int kThreads = FT / kWarpFrames * 32;
  constexpr int kStage = FT / 8;             // samples a ring stage holds
  constexpr int kStageFloats = kStage * kCols;
  extern __shared__ float4 smem4[];
  const Layout lay(FT, hop, rows, m, TVQ ? vq : 0);
  float* win = reinterpret_cast<float*>(smem4);
  float* ring = win + lay.win;
  float* pw = ring + lay.ring;
  float* fs = pw + lay.pw;
  const int ldf = feat_pitch(m, TVQ ? vq : 0);
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
  // the argmin synchronizes before it overwrites the window or reads fs
  const int rows_valid = min(FT, n_frames - t0);
  if (TVQ) {
    atk::block_argmin_wg_any<kThreads, FT>(
        fs, ldf, timg, vq == atk::kBf16x3, atk::b1_slices(m), atk::ceil_div(k, atk::kB1Chunk),
        reinterpret_cast<char*>(win), (lay.win + lay.ring + lay.pw) * 4,
        out + static_cast<long>(clip) * n_frames + t0, rows_valid);
  } else {
    atk::block_argmin<kArgminRows, kThreads>(fs, ldf, m, cent, c2, k, win,
                                             win + atk::kChunk * ldf,
                                             out + static_cast<long>(clip) * n_frames + t0,
                                             rows_valid);
  }
}

// ---- the bf16 tiers of the DFT and mel products -------------------------------

constexpr int kMmaFrames = 128;        // frames a block owns: 8 warps x 16
constexpr int kMmaThreads = 256;
constexpr int kPassBins = 64;          // bins a pass: 8 re + 8 im n-tiles a warp
constexpr int kSlab = 32;              // samples a ring stage holds
constexpr int kSlabPitch = kSlab + 8;  // bf16: 80 bytes, 8 columns on 8 bank groups
constexpr int kFbPitch = kPassBins + 8;
constexpr int kMaxMelTiles = 16;       // mel bands <= 128
constexpr int kStageElems = 2 * kPassBins * kSlabPitch;  // bf16 of one plane of a stage

// Shared memory of tokenizer_mma_kernel, in bytes: the window (planes x
// pitch bf16; later, with the ring, the argmin's scratch), the ring (two
// stages of planes; also one pass's filterbank columns), the features (f32,
// pitch mma_feat_pitch).  vq: the argmin's tier.
__host__ __device__ inline int mma_feat_pitch(int m, int vq) {
  return vq ? feat_pitch(m, vq) : (m + 15) / 16 * 16 + 1;
}
struct MmaLayout {
  size_t win, ring, fs;
  int pitch;  // bf16 of one plane of the window: hop-blocks of hop + 8
  __host__ __device__ MmaLayout(int hop, int rows, int m, bool x3, int vq) {
    const int planes = x3 ? 2 : 1, m16 = (m + 15) / 16 * 16, ldf = mma_feat_pitch(m, vq);
    const int wlen = (kMmaFrames - 1) * hop + rows;
    pitch = ((wlen + hop - 1) / hop * (hop + 8) + 7) / 8 * 8;
    const size_t w = static_cast<size_t>(planes) * pitch * 2;
    const size_t stages = static_cast<size_t>(2) * planes * kStageElems * 2;
    const size_t fbs = static_cast<size_t>(m16) * kFbPitch * planes * 2;
    ring = ((stages > fbs ? stages : fbs) + 15) / 16 * 16;
    const size_t tier = atk::b1_scratch_bytes(kArgminStages, vq == atk::kBf16x3, kMmaFrames, 1);
    const size_t cs = vq ? (tier > ring ? tier - ring : 0)
                         : 4 * static_cast<size_t>(atk::kChunk * ldf + atk::kChunk);
    win = ((w > cs ? w : cs) + 127) / 128 * 128;
    fs = static_cast<size_t>(kMmaFrames) * ldf * 4;
  }
  __host__ __device__ size_t bytes() const { return win + ring + fs; }
};

// B1 at tier bf16x3 (x3) or default: bhi, blo the basis' bf16 split,
// transposed ((2 nbp, rows): re of bins 0..nbp-1, then im; rows a multiple
// of 32, nbp of 64, zeros past n_fft and past the bins); fhi, flo the
// filterbank's ((m16, nbp)); hop a multiple of 16.  TVQ and vq as in
// tokenizer_kernel.
template <bool TVQ>
__global__ void __launch_bounds__(kMmaThreads, 1)
tokenizer_mma_kernel(const float* __restrict__ wave, long stride, long padded_len, int n_frames,
                     int hop, int rows, const __nv_bfloat16* __restrict__ bhi,
                     const __nv_bfloat16* __restrict__ blo, int nbp,
                     const __nv_bfloat16* __restrict__ fhi, const __nv_bfloat16* __restrict__ flo,
                     int m, int x3, const float* __restrict__ cent, const float* __restrict__ c2,
                     int k, const char* __restrict__ timg, int vq, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const bool x3v = x3 != 0;
  const int planes = x3v ? 2 : 1;
  const MmaLayout lay(hop, rows, m, x3v, TVQ ? vq : 0);
  char* base = reinterpret_cast<char*>(smem4);
  __nv_bfloat16* whi = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* wlo = whi + lay.pitch;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(base + lay.win);
  float* fs = reinterpret_cast<float*>(base + lay.win + lay.ring);
  const int m16 = (m + 15) / 16 * 16, ldf = mma_feat_pitch(m, TVQ ? vq : 0), mt = m16 / 8;
  const int t = threadIdx.x, lane = t % 32, tq = lane % 4;
  const int f0 = (t / 32) * 16;  // the warp's first frame of the tile
  const int t0 = blockIdx.x * kMmaFrames, clip = blockIdx.y;
  const int slabs = rows / kSlab, passes = nbp / kPassBins;

  // ring stage `buf` <- samples [slab * 32, + 32) of the 128 basis columns
  // (re, im) of the pass's bins, each plane; the caller waits
  auto issue = [&](int pass, int slab, int buf) {
    constexpr int kPieces = 2 * kPassBins * (kSlab / 8);  // 16-byte pieces a plane
    for (int e = t; e < kPieces * planes; e += kMmaThreads) {
      const int p = e / kPieces, r = e - p * kPieces;
      const int col = r / (kSlab / 8), q = r % (kSlab / 8);
      const int gcol = col < kPassBins ? pass * kPassBins + col
                                       : nbp + pass * kPassBins + col - kPassBins;
      atk::cp_async16(ring + (buf * planes + p) * kStageElems + col * kSlabPitch + 8 * q,
                      (p ? blo : bhi) + static_cast<size_t>(gcol) * rows + slab * kSlab + 8 * q,
                      true);
    }
    atk::cp_async_commit();
  };
  issue(0, 0, 0);

  // the tile's waveform window rounded to bf16 once (hi, and lo at bf16x3),
  // zeros past padded_len; sample p at p + 8 (p / hop)
  const float* src = wave + clip * stride + static_cast<long>(t0) * hop;
  const long avail = padded_len - static_cast<long>(t0) * hop;
  const int wlen = (kMmaFrames - 1) * hop + rows;
  for (int e = t; e < wlen; e += kMmaThreads) {
    const float x = e < avail ? src[e] : 0.f;
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    const int at = e + 8 * (e / hop);
    whi[at] = h;
    if (x3v) wlo[at] = __float2bfloat16_rn(x - __bfloat162float(h));
  }

  float mel[kMaxMelTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxMelTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mel[j][e] = 0.f;
  // this lane's ldmatrix rows: a frame of the warp's 16 (A) and a column of
  // an n-tile pair (B, the ring's and the filterbank's)
  const int a_frame = f0 + (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_k = 8 * ((lane >> 3) & 1);
  for (int pass = 0; pass < passes; ++pass) {
    float acc[16][4];  // re (n-tiles 0..7) and im (8..15) of the pass's 64 bins
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int slab = 0; slab < slabs; ++slab) {
      const int buf = slab & 1;
      if (slab + 1 < slabs) {
        issue(pass, slab + 1, buf ^ 1);
        atk::cp_async_wait<1>();
      } else {
        atk::cp_async_wait<0>();
      }
      __syncthreads();  // stage buf (and, the first time, the window) visible
      const __nv_bfloat16* sh = ring + buf * planes * kStageElems;
      const __nv_bfloat16* sl = sh + kStageElems;
#pragma unroll
      for (int kk = 0; kk < kSlab / 16; ++kk) {
        const int s = slab * kSlab + kk * 16 + a_k;
        const int at = a_frame * (hop + 8) + s + 8 * (s / hop);
        uint32_t ah[4], al[4];
        atk::ldmatrix_x4(ah, whi + at);
        if (x3v) atk::ldmatrix_x4(al, wlo + at);
        const int boff = b_row * kSlabPitch + kk * 16 + b_k;
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          uint32_t bh[4];
          atk::ldmatrix_x4(bh, sh + 16 * jp * kSlabPitch + boff);
          atk::mma_bf16(acc[2 * jp], ah, bh[0], bh[1]);
          atk::mma_bf16(acc[2 * jp + 1], ah, bh[2], bh[3]);
          if (x3v) {
            uint32_t bl[4];
            atk::ldmatrix_x4(bl, sl + 16 * jp * kSlabPitch + boff);
            atk::mma_bf16(acc[2 * jp], ah, bl[0], bl[1]);
            atk::mma_bf16(acc[2 * jp + 1], ah, bl[2], bl[3]);
            atk::mma_bf16(acc[2 * jp], al, bh[0], bh[1]);
            atk::mma_bf16(acc[2 * jp + 1], al, bh[2], bh[3]);
          }
        }
      }
      __syncthreads();  // stage buf free for the slab after next
    }
    // the power of the pass's bins, in acc[0..7]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = acc[j][e] * acc[j][e] + acc[j + 8][e] * acc[j + 8][e];
    // the mel product over the pass's bins: the filterbank's columns of
    // them through the idle ring; two neighbouring power n-tiles are one A
    // fragment
    constexpr int kFbPieces = kPassBins / 8;
    for (int e = t; e < m16 * kFbPieces * planes; e += kMmaThreads) {
      const int p = e / (m16 * kFbPieces), r = e - p * m16 * kFbPieces;
      const int band = r / kFbPieces, q = r % kFbPieces;
      *reinterpret_cast<uint4*>(ring + (p * m16 + band) * kFbPitch + 8 * q) =
          *reinterpret_cast<const uint4*>((p ? flo : fhi) + static_cast<size_t>(band) * nbp +
                                          pass * kPassBins + 8 * q);
    }
    __syncthreads();
    const __nv_bfloat16* fh = ring;
    const __nv_bfloat16* fl = ring + m16 * kFbPitch;
#pragma unroll
    for (int i = 0; i < kPassBins / 16; ++i) {
      uint32_t ph[4], pl[4];
      const float v[4][2] = {{acc[2 * i][0], acc[2 * i][1]},
                             {acc[2 * i][2], acc[2 * i][3]},
                             {acc[2 * i + 1][0], acc[2 * i + 1][1]},
                             {acc[2 * i + 1][2], acc[2 * i + 1][3]}};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (x3v) {
          atk::split_bf16(v[q][0], v[q][1], ph[q], pl[q]);
        } else {
          ph[q] = atk::pack_bf16(v[q][0], v[q][1]);
        }
      }
      const int boff = b_row * kFbPitch + 16 * i + b_k;
#pragma unroll
      for (int jp = 0; jp < kMaxMelTiles / 2; ++jp) {
        if (2 * jp < mt) {
          uint32_t bh[4];
          atk::ldmatrix_x4(bh, fh + 16 * jp * kFbPitch + boff);
          atk::mma_bf16(mel[2 * jp], ph, bh[0], bh[1]);
          atk::mma_bf16(mel[2 * jp + 1], ph, bh[2], bh[3]);
          if (x3v) {
            uint32_t bl[4];
            atk::ldmatrix_x4(bl, fl + 16 * jp * kFbPitch + boff);
            atk::mma_bf16(mel[2 * jp], ph, bl[0], bl[1]);
            atk::mma_bf16(mel[2 * jp + 1], ph, bl[2], bl[3]);
            atk::mma_bf16(mel[2 * jp], pl, bh[0], bh[1]);
            atk::mma_bf16(mel[2 * jp + 1], pl, bh[2], bh[3]);
          }
        }
      }
    }
    __syncthreads();  // the ring is free for the next pass
    if (pass + 1 < passes) issue(pass + 1, 0, 0);
  }

  // dB (bands past m are zero features), unit norm over the quad's lanes,
  // the features to shared memory for the argmin
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kMaxMelTiles; ++j) {
    if (j < mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * tq + (e & 1);
        const float v = col < m ? 10.0f * log10f(fmaxf(mel[j][e], 1e-10f)) : 0.f;
        mel[j][e] = v;
        ss[e >> 1] = fmaf(v, v, ss[e >> 1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 1);
    ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], 2);
  }
  const float den0 = sqrtf(ss[0]) + atk::kEps, den1 = sqrtf(ss[1]) + atk::kEps;
  float* row0 = fs + (f0 + lane / 4) * ldf;
  float* row1 = row0 + 8 * ldf;
#pragma unroll
  for (int j = 0; j < kMaxMelTiles; ++j) {
    if (j < mt) {
      const int col = 8 * j + 2 * tq;
      row0[col] = mel[j][0] / den0;
      row0[col + 1] = mel[j][1] / den0;
      row1[col] = mel[j][2] / den1;
      row1[col + 1] = mel[j][3] / den1;
    }
  }
  for (int col = m16 + tq; col < ldf - 1; col += 4) {  // the tiered argmin's whole slices
    row0[col] = 0.f;
    row1[col] = 0.f;
  }
  // the argmin synchronizes before it overwrites the window or reads fs
  const int rows_valid = min(kMmaFrames, n_frames - t0);
  float* scratch = reinterpret_cast<float*>(base);
  int* o = out + static_cast<long>(clip) * n_frames + t0;
  if (TVQ) {
    atk::block_argmin_wg_any<kMmaThreads, kMmaFrames>(
        fs, ldf, timg, vq == atk::kBf16x3, atk::b1_slices(m), atk::ceil_div(k, atk::kB1Chunk),
        base, static_cast<int>(lay.win + lay.ring), o, rows_valid);
  } else {
    atk::block_argmin<kMmaFrames * atk::kColThreads / kMmaThreads, kMmaThreads>(
        fs, ldf, m, cent, c2, k, scratch, scratch + atk::kChunk * ldf, o, rows_valid);
  }
}

template <int FT, bool TVQ>
cudaError_t launch(const float* wave, int batch, long stride, long padded_len, int n_frames,
                   int hop, int rows, const float* basis, int nb, const float* fb, int m,
                   const float* cent, const float* c2, int k, const char* timg, int vq, int* out,
                   cudaStream_t stream) {
  static_assert(kArgminRows * (FT / kWarpFrames * 32) / atk::kColThreads == FT,
                "argmin rows must cover the tile");
  constexpr int kThreads = FT / kWarpFrames * 32;
  const size_t smem = Layout(FT, hop, rows, m, TVQ ? vq : 0).bytes();
  const dim3 grid((n_frames + FT - 1) / FT, batch);
  cudaError_t err;
  if (hop % 4 == 0) {
    err = atk::allow_smem(tokenizer_kernel<FT, true, TVQ>, smem);
    if (err != cudaSuccess) return err;
    tokenizer_kernel<FT, true, TVQ><<<grid, kThreads, smem, stream>>>(
        wave, stride, padded_len, n_frames, hop, rows, basis, nb, fb, m, cent, c2, k, timg, vq,
        out);
  } else {
    err = atk::allow_smem(tokenizer_kernel<FT, false, TVQ>, smem);
    if (err != cudaSuccess) return err;
    tokenizer_kernel<FT, false, TVQ><<<grid, kThreads, smem, stream>>>(
        wave, stride, padded_len, n_frames, hop, rows, basis, nb, fb, m, cent, c2, k, timg, vq,
        out);
  }
  return cudaGetLastError();
}

}  // namespace

ATK_EXPORT int atk_tokenize_tier(const float* wave, int batch, long stride, long padded_len,
                                 int n_frames, int hop, int rows, const float* basis, int nb,
                                 const float* fb, int m, const void* tbasis, int trows, int tnb,
                                 const void* tfb, const float* cent, const float* c2, int k,
                                 const void* timg, long timg_bytes, int tier, int vq_tier,
                                 int* out, void* stream);

// B1 in f32 (the highest tiers).  basis (rows, 2 nb) with rows a multiple of
// 16 and nb of 128; fb (nb, m).  A 128-frame block whose shared memory would
// pass 227 KB takes 64 frames.
ATK_EXPORT int atk_tokenize(const float* wave, int batch, long stride, long padded_len,
                            int n_frames, int hop, int rows, const float* basis, int nb,
                            const float* fb, int m, const float* cent, const float* c2, int k,
                            int* out, void* stream) {
  return atk_tokenize_tier(wave, batch, stride, padded_len, n_frames, hop, rows, basis, nb, fb, m,
                           nullptr, 0, 0, nullptr, cent, c2, k, nullptr, 0, atk::kHighest,
                           atk::kHighest, out, stream);
}

// B1 at the precision tiers: tier and vq_tier 0 highest, 1 bf16x3, 2 default.
// tier highest runs tokenizer_kernel
// on the f32 basis (rows, 2 nb) and filterbank (nb, m), as atk_tokenize;
// otherwise tokenizer_mma_kernel on tbasis ((planes, 2 tnb, trows) bf16,
// planes 2 at bf16x3: hi then lo) and tfb ((planes, m16, tnb)), hop a
// multiple of 16.  vq_tier highest scores against cent (k, m) f32, else
// against timg, the centroid image of block_argmin_wg (timg_bytes: chunks
// of 128 x b1_slices(m) items of tier_item_bytes(128, 4, bf16x3)), whose c2
// are those of the f32 centroids, as c2 is at every tier.
ATK_EXPORT int atk_tokenize_tier(const float* wave, int batch, long stride, long padded_len,
                                 int n_frames, int hop, int rows, const float* basis, int nb,
                                 const float* fb, int m, const void* tbasis, int trows, int tnb,
                                 const void* tfb, const float* cent, const float* c2, int k,
                                 const void* timg, long timg_bytes, int tier, int vq_tier,
                                 int* out, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  constexpr size_t kMaxSmem = 227 * 1024;
  const int m16 = (m + 15) / 16 * 16;
  const bool tvq = vq_tier != atk::kHighest;
  const int vq = tvq ? vq_tier : 0;
  if (tier < 0 || tier > 2 || vq_tier < 0 || vq_tier > 2 || hop < 1 || m < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tvq && timg_bytes != static_cast<long>(atk::ceil_div(k, atk::kB1Chunk)) *
                               atk::b1_slices(m) *
                               atk::tier_item_bytes(atk::kB1Chunk, atk::kB1Ks, vq == atk::kBf16x3,
                                                    false))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ti = static_cast<const char*>(timg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier == atk::kHighest) {
    if (rows % kRowMultiple || nb % kBins || Layout(64, hop, rows, m).ring / m < 4)
      return static_cast<int>(cudaErrorInvalidValue);
    int ft = kDefaultFrames;
    if (ft == 128 && Layout(128, hop, rows, m, vq).bytes() > kMaxSmem) ft = 64;
    if (Layout(ft, hop, rows, m, vq).bytes() > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    if (tvq)
      err = ft == 128 ? launch<128, true>(wave, batch, stride, padded_len, n_frames, hop, rows,
                                          basis, nb, fb, m, cent, c2, k, ti, vq, out, st)
                      : launch<64, true>(wave, batch, stride, padded_len, n_frames, hop, rows,
                                         basis, nb, fb, m, cent, c2, k, ti, vq, out, st);
    else
      err = ft == 128 ? launch<128, false>(wave, batch, stride, padded_len, n_frames, hop, rows,
                                           basis, nb, fb, m, cent, c2, k, nullptr, 0, out, st)
                      : launch<64, false>(wave, batch, stride, padded_len, n_frames, hop, rows,
                                          basis, nb, fb, m, cent, c2, k, nullptr, 0, out, st);
    return static_cast<int>(err);
  }
  const bool x3 = tier == atk::kBf16x3;
  if (hop % 16 || trows % kSlab || tnb % kPassBins || tnb < 1 || m16 > 8 * kMaxMelTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaLayout lay(hop, trows, m, x3, vq);
  if (lay.bytes() > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto* tb = static_cast<const __nv_bfloat16*>(tbasis);
  const auto* tf = static_cast<const __nv_bfloat16*>(tfb);
  const __nv_bfloat16* blo = tb + static_cast<size_t>(2) * tnb * trows;
  const __nv_bfloat16* flo = tf + static_cast<size_t>(m16) * tnb;
  const dim3 grid((n_frames + kMmaFrames - 1) / kMmaFrames, batch);
  const auto kernel = tvq ? tokenizer_mma_kernel<true> : tokenizer_mma_kernel<false>;
  cudaError_t err = atk::allow_smem(kernel, lay.bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kMmaThreads, lay.bytes(), st>>>(wave, stride, padded_len, n_frames, hop, trows,
                                                 tb, blo, tnb, tf, flo, m, x3 ? 1 : 0, cent, c2,
                                                 k, ti, vq, out);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of atk_tokenize_tier's tensor-core instance (tier bf16x3 or
// default) with the argmin at vq_tier; the wrapper refuses what passes 227 KB.
ATK_EXPORT long atk_tokenize_tier_smem(int hop, int trows, int m, int x3, int vq_tier) {
  return static_cast<long>(MmaLayout(hop, trows, m, x3 != 0, vq_tier).bytes());
}
