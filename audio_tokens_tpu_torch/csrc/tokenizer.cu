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
// - tier bf16x3 or default: the DFT and mel products run on Hopper's
//   warpgroup products (tokenizer_wg_kernel), bf16 operands with f32
//   accumulation: bf16x3 takes the three passes hi.hi + hi.lo + lo.hi of
//   _dot_tier, default one pass of both operands rounded to bf16 (what the
//   TPU computes for Precision.DEFAULT on f32 operands).  A block owns 128
//   frames (64 where shared memory is short) in consumer warpgroups of 64.
//   The tile's waveform window is rounded to bf16 once (hi, and lo at
//   bf16x3) into shared memory, in hop-sample blocks padded so that the 8
//   frames an ldmatrix reads fall on 8 bank groups, and read in place as
//   the register A fragments of wgmma m64n128k16 (overlapping frames, hop
//   apart, cannot be a shared-memory descriptor); where hop % 8 != 0 the
//   fragments are gathered from an unpadded window sample by sample.  The
//   Hann window lives in the basis, so raw samples are what gets rounded,
//   as in the JAX kernel.  The wrapper lays the basis and the filterbank
//   out once as the exact images wgmma reads (K-major core matrices, no
//   swizzle needed): per pass of 64 bins, 64-sample slabs of its 128
//   columns (re, im) and 64-band slices of its filterbank rows, each an
//   item that one bulk copy (the TMA unit) brings into a ring of up to 4
//   stages on mbarriers; one shared-memory descriptor serves the 4 warps
//   of a warpgroup.  Thread 0 refills a stage once every warp has
//   released it, one item behind, with no block barrier in the loop.  The
//   accumulators of a pass (re and im of 64 bins: a thread holds columns c
//   and c + 64, one bin's re and im) are squared into the power in
//   registers and become the A fragments of the mel wgmma (m64n64k16),
//   split hi/lo at bf16x3; each 64-band slice's sums are added into the
//   features in shared memory, so any number of bands runs.  The three
//   passes of bf16x3 add into one f32 accumulator, k-step by k-step, where
//   _dot_tier adds three products: another summation order.  At 64
//   ten-second clips the DFT is 57.8 GFLOP: 0.175 ms at bf16x3 (three
//   passes at 989 TFLOP/s), 0.058 ms at default; every block reads the
//   basis images from L2 (1 MB at bf16x3 and n_fft 512), 0.9 GB in all.
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

// ---- the bf16 tiers of the DFT and mel products, on wgmma -------------------

constexpr int kWgFrames = 64;        // frames a consumer warpgroup owns
constexpr int kPassBins = 64;        // bins a pass: re and im, 128 wgmma columns
constexpr int kSlab = 64;            // samples a basis item holds
constexpr int kSlabSteps = kSlab / 16;  // its k-steps
constexpr int kBandSlice = 64;       // mel bands a filterbank item holds: 4 k-steps
constexpr int kPlaneBytes = 2 * kPassBins * kSlab * 2;  // one bf16 plane of a basis item
constexpr int kFbPlaneBytes = kBandSlice * kPassBins * 2;  // ... of a filterbank item
constexpr int kBasisSbo = 8 * kSlab * 2;  // bytes an 8-column group of a basis item
constexpr int kFbSbo = 1024;         // bytes an 8-band group of a filterbank item
constexpr int kMaxRing = 8;          // ring stages at most (16 mbarriers: the 128-byte header)
constexpr int kArgminMinStages = 2;  // argmin ring stages the window's room must hold
constexpr int kFillUnroll = 16;      // window samples a thread loads at once

// The frames' window in shared memory: sample p of the tile at
// p + pad * (p / hop).  Where hop % 8 == 0 (LDM) the 8 samples an ldmatrix
// row reads never cross a hop block and the pad (8 or 16 bf16) puts 8
// neighbouring frames on 8 bank groups ((hop + pad) / 8 odd); otherwise
// pad 0 and the fragments are gathered sample by sample.
__host__ __device__ inline int wg_pad(int hop) {
  return hop % 8 ? 0 : ((hop / 8) % 2 ? 16 : 8);
}
__host__ __device__ inline int wg_feat_pitch(int m, int vq) {
  return vq ? feat_pitch(m, vq) : m + 1;
}

// Shared memory of tokenizer_wg_kernel, in bytes: the ring (stages items
// of planes x 8 KB), the window (planes x pitch bf16; with the ring, later
// the argmin's scratch), the features (f32, FT x ldf), the mbarriers.
struct WgLayout {
  size_t ring, win, fs, bar, total;
  int pitch;  // bf16 of one plane of the window
  __host__ __device__ WgLayout(int ft, int stages, int hop, int rows, int m, bool x3, int vq) {
    const int planes = x3 ? 2 : 1, pad = wg_pad(hop), ldf = wg_feat_pitch(m, vq);
    const int wlen = (ft - 1) * hop + rows;
    pitch = ((wlen + hop - 1) / hop * (hop + pad) + 7) / 8 * 8;
    ring = static_cast<size_t>(stages) * planes * kPlaneBytes;
    const size_t w = static_cast<size_t>(planes) * pitch * 2;
    const size_t need =
        vq ? atk::b1_scratch_bytes(kArgminMinStages, vq == atk::kBf16x3, ft, 1)
           : 4 * static_cast<size_t>(atk::kChunk * ldf + atk::kChunk);
    const size_t cs = need > ring ? need - ring : 0;
    win = ((w > cs ? w : cs) + 127) / 128 * 128;
    fs = static_cast<size_t>(ft) * ldf * 4;
    bar = ring + win + fs;
    total = bar + 128;
  }
};

// A warp's A fragments of one basis item: its k-steps of 16 samples, hi and
// (bf16x3) lo.
struct SlabFrags {
  uint32_t hi[kSlabSteps][4];
  uint32_t lo[kSlabSteps][4];
};

template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void keep_frags(SlabFrags& a) {
#pragma unroll
  for (int kk = 0; kk < kSlabSteps; ++kk) {
    keep_regs(a.hi[kk]);
    keep_regs(a.lo[kk]);
  }
}

// B1 at tier bf16x3 (x3) or default, RB consumer warpgroups of 64 frames
// each (FT = 64 RB frames a block).  bimg: the basis items, (passes x
// slabs) x planes x 16 KB, item (pass, slab) the 128 columns (re then im of
// the pass's 64 bins) x 64 samples in wgmma's K-major core-matrix order
// (8 columns x 8 samples a 128-byte core matrix, (8-column group, 8-sample
// block) order); fimg: the filterbank items, (passes x mslices) x planes x
// 8 KB, item (pass, slice) 64 bands x the pass's 64 bins in the same
// order.  rows: the basis' samples, a multiple of 64 (zeros past n_fft).
// LDM: hop % 8 == 0.  TVQ, vq as in tokenizer_kernel.
template <int RB, bool LDM, bool TVQ>
__global__ void __launch_bounds__(128 * RB, 1)
tokenizer_wg_kernel(const float* __restrict__ wave, long stride, long padded_len, int n_frames,
                    int hop, int rows, const char* __restrict__ bimg,
                    const char* __restrict__ fimg, int passes, int m, int x3, int stages,
                    const float* __restrict__ cent, const float* __restrict__ c2, int k,
                    const char* __restrict__ timg, int vq, int* __restrict__ out) {
  constexpr int FT = kWgFrames * RB, kThreads = 128 * RB;
  extern __shared__ __align__(128) char smem[];
  const bool x3v = x3 != 0;
  // a ring stage holds a basis item; a filterbank item fills part of one
  const int planes = x3v ? 2 : 1, ibytes = planes * kPlaneBytes, fbytes = planes * kFbPlaneBytes;
  const WgLayout lay(FT, stages, hop, rows, m, x3v, TVQ ? vq : 0);
  char* ring = smem;
  __nv_bfloat16* whi = reinterpret_cast<__nv_bfloat16*>(smem + lay.ring);
  __nv_bfloat16* wlo = whi + lay.pitch;
  float* fs = reinterpret_cast<float*>(smem + lay.ring + lay.win);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
  uint64_t* empty = full + kMaxRing;
  const int ldf = wg_feat_pitch(m, TVQ ? vq : 0), pad = wg_pad(hop);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int f_w = 16 * warp;  // the warp's first frame of the tile (warpgroup wg = warp / 4)
  const int t0 = blockIdx.x * FT, clip = blockIdx.y;
  const int slabs = rows / kSlab, mslices = atk::ceil_div(m, kBandSlice);
  const int per_pass = slabs + mslices, items = passes * per_pass;

  // The items in order: per pass its basis slabs, then its filterbank
  // slices.  Thread 0 copies item `next` (pass np, np_r within it) into a
  // stage; every counter below moves by one, with no division.
  int next = 0, np = 0, np_r = 0;
  auto issue = [&](int st) {
    const bool basis = np_r < slabs;
    const char* src = basis ? bimg + static_cast<size_t>(np * slabs + np_r) * ibytes
                            : fimg + static_cast<size_t>(np * mslices + np_r - slabs) * fbytes;
    const int bytes = basis ? ibytes : fbytes;
    atk::mbar_expect(full + st, bytes);
    atk::bulk_copy(ring + st * ibytes, src, bytes, full + st);
    ++next;
    if (++np_r == per_pass) {
      np_r = 0;
      ++np;
    }
  };
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      atk::mbar_init(full + st, 1);
      atk::mbar_init(empty + st, kThreads / 32);
    }
    atk::mbar_init_fence();
    for (int st = 0; st < stages && next < items; ++st) issue(st);
  }
  // the tile's waveform window rounded to bf16 once (hi, and lo at
  // bf16x3), zeros past padded_len; the mel sums start at 0
  const float* src = wave + clip * stride + static_cast<long>(t0) * hop;
  const long avail = padded_len - static_cast<long>(t0) * hop;
  const int wlen = (FT - 1) * hop + rows;
  // e / hop for the window's e < 2^22: exact in f32 with e + 1/2 (the error
  // stays far below 1/(2 hop) of the nearest integer)
  const float inv_hop = 1.0f / hop;
  auto hop_block = [&](int e) { return static_cast<int>((e + 0.5f) * inv_hop); };
  for (int e0 = tid; e0 < (ATK_TIER_SPLIT & 64 ? 0 : wlen); e0 += kFillUnroll * kThreads) {
    float v[kFillUnroll];  // kFillUnroll loads a thread in flight
#pragma unroll
    for (int u = 0; u < kFillUnroll; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < wlen && e < avail ? src[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kFillUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e < wlen) {
        const __nv_bfloat16 h = __float2bfloat16_rn(v[u]);
        const int at = pad ? e + pad * hop_block(e) : e;
        whi[at] = h;
        if (x3v) wlo[at] = __float2bfloat16_rn(v[u] - __bfloat162float(h));
      }
    }
  }
  for (int e = tid; e < FT * ldf; e += kThreads) fs[e] = 0.f;
  __syncthreads();

  // the items are waited for, and released, in order: the stage and
  // phase of the next to wait for, of the next to release, and of the one
  // released last
  int w_st = 0, w_ph = 0, r_st = 0, r_ph = 0, p_st = -1, p_ph = 0;
  auto wait = [&]() -> const char* {
    atk::mbar_wait(full + w_st, w_ph);
    const char* st = ring + w_st * ibytes;
    if (++w_st == stages) {
      w_st = 0;
      w_ph ^= 1;
    }
    return st;
  };
  // every warp releases the next item; thread 0 refills the stage of the
  // item released before it (which the slower warpgroup let go a step
  // earlier) with the next item to copy
  auto release = [&]() {
    __syncwarp();
    if (lane == 0) atk::mbar_arrive(empty + r_st);
    if (tid == 0 && p_st >= 0 && next < items) {
      atk::mbar_wait(empty + p_st, p_ph);
      issue(p_st);
    }
    p_st = r_st;
    p_ph = r_ph;
    if (++r_st == stages) {
      r_st = 0;
      r_ph ^= 1;
    }
    __syncwarp();
  };
  // the warp's A fragments of samples [32 slab, + 32)
  auto load_frags = [&](SlabFrags& a, int slab) {
#pragma unroll
    for (int kk = 0; kk < kSlabSteps; ++kk) {
      const int sb = slab * kSlab + 16 * kk;
      if (LDM) {
        const int fr = f_w + (lane & 7) + 8 * ((lane >> 3) & 1), s = sb + 8 * (lane >> 4);
        const int at = fr * (hop + pad) + s + pad * hop_block(s);
        atk::ldmatrix_x4(a.hi[kk], whi + at);
        if (x3v) atk::ldmatrix_x4(a.lo[kk], wlo + at);
      } else {
        const unsigned short* wh = reinterpret_cast<const unsigned short*>(whi);
        const unsigned short* wl = reinterpret_cast<const unsigned short*>(wlo);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int at = (f_w + g + 8 * (q & 1)) * hop + sb + 2 * tq + 8 * (q >> 1);
          a.hi[kk][q] = wh[at] | static_cast<uint32_t>(wh[at + 1]) << 16;
          if (x3v) a.lo[kk][q] = wl[at] | static_cast<uint32_t>(wl[at + 1]) << 16;
        }
      }
    }
  };

  for (int pass = 0; pass < passes; ++pass) {
    float acc[64];  // re (columns 0..63) and im (64..127) of the pass's 64 bins
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    SlabFrags fa{}, fb{};
    // one basis item: its products into acc, one wgmma group; the previous
    // item's group finishes meanwhile, then its stage and fragments are
    // released
    auto dft_item = [&](SlabFrags& a, SlabFrags& prev, int slab) {
      load_frags(a, slab);
      const char* st = wait();
      atk::fence_acc(acc);
      atk::wgmma_fence();
      if (ATK_TIER_SPLIT & 8) {  // no DFT products: the fragments stand in
        acc[0] += __uint_as_float(a.hi[0][0] & 0x807fffffu);
        acc[1] += __uint_as_float(a.hi[1][1] & 0x807fffffu);
        if (x3v) acc[2] += __uint_as_float(a.lo[0][2] & 0x807fffffu);
        acc[3] += st[lane];
      } else {
        const uint64_t dh = atk::kmajor_desc(st, kBasisSbo);
        const uint64_t dl = atk::kmajor_desc(st + kPlaneBytes, kBasisSbo);
#pragma unroll
        for (int kk = 0; kk < kSlabSteps; ++kk) {
          atk::wgmma_n128(acc, a.hi[kk], dh + 16 * kk, 1);
          if (x3v) {
            atk::wgmma_n128(acc, a.hi[kk], dl + 16 * kk, 1);
            atk::wgmma_n128(acc, a.lo[kk], dh + 16 * kk, 1);
          }
        }
      }
      atk::wgmma_commit();
      atk::fence_acc(acc);
      atk::wgmma_wait<1>();
      keep_frags(prev);
      if (slab > 0) release();
    };
    for (int slab = 0; slab < slabs; slab += 2) {
      dft_item(fa, fb, slab);
      if (slab + 1 < slabs) dft_item(fb, fa, slab + 1);
    }
    atk::wgmma_wait<0>();
    atk::fence_acc(acc);
    keep_frags(fa);
    keep_frags(fb);
    release();

    // the power of the pass's bins as the mel product's A fragments: a
    // thread holds columns c and c + 64 (re, im of one bin); k-step kk is
    // bins 16 kk .. 16 kk + 15, the n-tiles 2 kk and 2 kk + 1
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = 2 * kk + (q >> 1), e = 2 * (q & 1);
        const float p0 = acc[4 * j + e] * acc[4 * j + e] + acc[4 * j + 32 + e] * acc[4 * j + 32 + e];
        const float p1 = acc[4 * j + e + 1] * acc[4 * j + e + 1] +
                         acc[4 * j + 33 + e] * acc[4 * j + 33 + e];
        if (x3v) {
          atk::split_bf16(p0, p1, ph[kk][q], pl[kk][q]);
        } else {
          ph[kk][q] = atk::pack_bf16(p0, p1);
          pl[kk][q] = 0u;
        }
      }
    // the mel product, one 64-band slice an item, added into the features
    // (each (frame, band) has one owner thread: no race, a fixed order)
    for (int sl = 0; sl < mslices; ++sl) {
      float mel[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) mel[i] = 0.f;
      const char* st = wait();
      atk::fence_acc(mel);
      atk::wgmma_fence();
      if (ATK_TIER_SPLIT & 16) {  // no mel products: the fragments stand in
        mel[0] += __uint_as_float(ph[0][0] & 0x807fffffu);
        mel[1] += __uint_as_float(ph[3][3] & 0x807fffffu);
        if (x3v) mel[2] += __uint_as_float(pl[1][2] & 0x807fffffu);
        mel[3] += st[lane];
      } else {
        const uint64_t dh = atk::kmajor_desc(st, kFbSbo);
        const uint64_t dl = atk::kmajor_desc(st + kFbPlaneBytes, kFbSbo);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          atk::wgmma_n64(mel, ph[kk], dh + 16 * kk, 1);
          if (x3v) {
            atk::wgmma_n64(mel, ph[kk], dl + 16 * kk, 1);
            atk::wgmma_n64(mel, pl[kk], dh + 16 * kk, 1);
          }
        }
      }
      atk::wgmma_commit();
      atk::wgmma_wait<0>();
      atk::fence_acc(mel);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        keep_regs(ph[kk]);
        keep_regs(pl[kk]);
      }
      release();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int band = kBandSlice * sl + 8 * j + 2 * tq + (e & 1);
          if (band < m) fs[(f_w + g + 8 * (e >> 1)) * ldf + band] += mel[4 * j + e];
        }
    }
  }

  // dB, unit norm, nearest centroid
  __syncthreads();
  for (int e = tid; e < FT * m; e += kThreads) {
    float* p = fs + (e / m) * ldf + e % m;
    *p = 10.0f * log10f(fmaxf(*p, 1e-10f));
  }
  __syncthreads();
  atk::normalize_rows(fs, ldf, m, FT);
  // the argmin synchronizes before it overwrites the ring and the window
  const int rows_valid = min(FT, n_frames - t0);
  int* o = out + static_cast<long>(clip) * n_frames + t0;
  if (ATK_TIER_SPLIT & 32) {  // no argmin: the features stand in for the ids
    __syncthreads();
    for (int r = tid; r < rows_valid; r += kThreads) o[r] = fs[r * ldf] == 1.2345e-30f;
  } else if (TVQ) {
    atk::block_argmin_wg_any<kThreads, FT>(
        fs, ldf, timg, vq == atk::kBf16x3, atk::b1_slices(m), atk::ceil_div(k, atk::kB1Chunk),
        smem, static_cast<int>(lay.ring + lay.win), o, rows_valid);
  } else {
    float* scratch = reinterpret_cast<float*>(smem);
    atk::block_argmin<FT * atk::kColThreads / kThreads, kThreads>(
        fs, ldf, m, cent, c2, k, scratch, scratch + atk::kChunk * ldf, o, rows_valid);
  }
}

// The launch plan of tokenizer_wg_kernel: 128 frames with the most ring
// stages (8 down to 3) that fit, else 64 frames so, else 2 stages at 128
// and 64 frames; frames 0 where no plan's shared memory fits.  A deep ring
// keeps the basis items' copies from L2 ahead of the products; 128 frames
// a block read the basis from L2 half as often as 64.
struct WgPlan {
  int ft = 0, stages = 0;
  size_t smem = 0;
  WgPlan(int hop, int rows, int m, bool x3, int vq) {
    auto fits = [&](int f, int s) {
      const size_t bytes = WgLayout(f, s, hop, rows, m, x3, vq).total;
      if (bytes > static_cast<size_t>(atk::kSmemLimit)) return false;
      ft = f;
      stages = s;
      smem = bytes;
      return true;
    };
    for (int f = 128; f >= 64; f /= 2)
      for (int s = kMaxRing; s >= 3; --s)
        if (fits(f, s)) return;
    for (int f = 128; f >= 64; f /= 2)
      if (fits(f, 2)) return;
  }
};

template <int RB, bool LDM, bool TVQ>
cudaError_t launch_wg(const WgPlan& plan, const float* wave, int batch, long stride,
                      long padded_len, int n_frames, int hop, int rows, const char* bimg,
                      const char* fimg, int passes, int m, int x3, const float* cent,
                      const float* c2, int k, const char* timg, int vq, int* out,
                      cudaStream_t stream) {
  const auto kernel = tokenizer_wg_kernel<RB, LDM, TVQ>;
  cudaError_t err = atk::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + plan.ft - 1) / plan.ft, batch);
  kernel<<<grid, 128 * RB, plan.smem, stream>>>(wave, stride, padded_len, n_frames, hop, rows,
                                                 bimg, fimg, passes, m, x3, plan.stages, cent,
                                                 c2, k, timg, vq, out);
  return cudaGetLastError();
}

template <int RB, bool LDM>
cudaError_t launch_wg_vq(bool tvq, const WgPlan& plan, const float* wave, int batch, long stride,
                         long padded_len, int n_frames, int hop, int rows, const char* bimg,
                         const char* fimg, int passes, int m, int x3, const float* cent,
                         const float* c2, int k, const char* timg, int vq, int* out,
                         cudaStream_t stream) {
  return tvq ? launch_wg<RB, LDM, true>(plan, wave, batch, stride, padded_len, n_frames, hop,
                                        rows, bimg, fimg, passes, m, x3, cent, c2, k, timg, vq,
                                        out, stream)
             : launch_wg<RB, LDM, false>(plan, wave, batch, stride, padded_len, n_frames, hop,
                                         rows, bimg, fimg, passes, m, x3, cent, c2, k, nullptr, 0,
                                         out, stream);
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
// otherwise tokenizer_wg_kernel on the front end's items tbasis ((tnb / 64)
// x (trows / 64) items of planes x 16 KB) and tfb ((tnb / 64) x ceil(m /
// 64) items of planes x 8 KB), bf16 (planes 2 at bf16x3: hi then lo; the
// layouts at tokenizer_wg_kernel), trows a multiple of 64, tnb of 64, any hop (the
// wrapper refuses one that does not divide n_fft, as the JAX kernel does)
// and any m whose WgPlan fits.  vq_tier highest scores against cent (k, m) f32, else
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
  if (trows < kSlab || trows % kSlab || tnb < kPassBins || tnb % kPassBins)
    return static_cast<int>(cudaErrorInvalidValue);
  const WgPlan plan(hop, trows, m, x3, vq);
  if (plan.ft == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* bi = static_cast<const char*>(tbasis);
  const auto* fi = static_cast<const char*>(tfb);
  const int passes = tnb / kPassBins, x3i = x3 ? 1 : 0;
  cudaError_t err;
  if (hop % 8 == 0)
    err = plan.ft == 128
              ? launch_wg_vq<2, true>(tvq, plan, wave, batch, stride, padded_len, n_frames, hop,
                                      trows, bi, fi, passes, m, x3i, cent, c2, k, ti, vq, out, st)
              : launch_wg_vq<1, true>(tvq, plan, wave, batch, stride, padded_len, n_frames, hop,
                                      trows, bi, fi, passes, m, x3i, cent, c2, k, ti, vq, out, st);
  else
    err = plan.ft == 128
              ? launch_wg_vq<2, false>(tvq, plan, wave, batch, stride, padded_len, n_frames, hop,
                                       trows, bi, fi, passes, m, x3i, cent, c2, k, ti, vq, out, st)
              : launch_wg_vq<1, false>(tvq, plan, wave, batch, stride, padded_len, n_frames,
                                       hop, trows, bi, fi, passes, m, x3i, cent, c2, k, ti, vq,
                                       out, st);
  return static_cast<int>(err);
}

// The launch plan of atk_tokenize_tier's tensor-core instance (tier bf16x3
// or default) with the argmin at vq_tier: frames a block (128 or 64; 0
// where no plan's shared memory fits 227 KB, which the wrapper refuses),
// ring stages and bytes of shared memory, into plan[3].
ATK_EXPORT void atk_tokenize_tier_plan(int hop, int trows, int m, int x3, int vq_tier,
                                       long* plan) {
  const WgPlan p(hop, trows, m, x3 != 0, vq_tier);
  plan[0] = p.ft;
  plan[1] = p.stages;
  plan[2] = static_cast<long>(p.smem);
}
