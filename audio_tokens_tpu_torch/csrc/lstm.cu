// Kernel B3: one LSTM direction over precomputed input gates (forward only).
//
// Replaces audio_tokens_tpu/ops/pallas_lstm.py::_fwd_kernel (launched by
// _lstm_fwd_call).
//
// xg (T, B, 4H) f32 = x @ w_ih + bias, gate order i, f, g, o (torch's);
// mask (T, B) f32; w_hh (H, 4H) f32 -> hs (T, B, H), h_last (B, H).  Step s
// processes time t = s, or t = T-1-s when reverse, and writes hs[t], so the
// outputs stay in the original time order.  Past a sequence's end (mask 0)
// the state passes through: h = m*new + (1-m)*prev, likewise c.
//
// What bounds it on the H100: the recurrence.  Each step needs all of the
// previous step's h, so the T steps are serial; per step the work is one
// (B, H) x (H, 4H) product (67 MFLOP at B 64, H 512) plus the cell.  The
// TPU kernel keeps h, c and w_hh in one core's VMEM across a sequential
// grid; here w_hh is 4 MB, more than one SM holds, so the recurrence is
// split across blocks.  The design: one persistent cooperative launch of
// H/4 blocks.  Block j owns hidden units 4j..4j+3 and all four gate columns
// of those units, so its (H, 16) slice of w_hh (32 KB at H 512) stays in
// shared memory for all T steps and the cell update needs no exchange
// between blocks: a thread per (batch row b, unit u) keeps c in a register
// and runs the cell.  h is exchanged through a double-buffered global buffer
// hbuf (2, B, H) with a grid-wide barrier after every step.  Blocks read h
// written by other blocks after the barrier, so those reads bypass L1
// (__ldcg) and hbuf carries no const or __restrict__.  The per-step time is
// then bound by reading h (B*H floats) from L2 in every block and by the
// barrier itself, not by flops.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 4;            // hidden units per block
constexpr int kCols = 4 * kUnits;    // w_hh columns per block
constexpr int kRows = 4;             // batch rows of a thread's register tile
constexpr int kMaxSplit = 16;        // at most 16 slices of H per tile
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// One step's gate product for the block's 4 units is a (B, H) x (H, 16)
// product.  Work is cut into tiles of 4 batch rows x 1 unit (its 4 gates)
// and the H axis into ksplit slices: thread (ks, tile) accumulates the
// 4 x 4 register tile of its k slice, so each 16-byte weight load from
// shared memory feeds 16 FMAs and each h load 4.  The ksplit partial tiles
// are summed in shared memory in a fixed order; then thread p = b * 4 + u
// (one per (batch row, unit), which keeps c in a register) runs the cell.
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ mask,
                const float* __restrict__ w_hh, int steps, int batch, int hidden,
                int reverse, int ntiles, int ksplit, float* hbuf,
                float* __restrict__ hs, float* __restrict__ h_last) {
  // ws[k * kUnits + u] = w_hh[k, g*H + u0 + u] for g = 0..3 (x, y, z, w)
  extern __shared__ float4 smem4[];
  float4* ws = smem4;                                  // hidden * kUnits
  float4* part = ws + hidden * kUnits;                 // ksplit * ntiles * kRows
  float4* gates = part + ksplit * ntiles * kRows;      // ntiles * kRows
  cg::grid_group grid = cg::this_grid();
  const int u0 = blockIdx.x * kUnits;
  const size_t g4 = 4 * static_cast<size_t>(hidden);
  float* wsf = reinterpret_cast<float*>(ws);
  for (int e = threadIdx.x; e < hidden * kCols; e += blockDim.x) {
    const int k = e / kCols, ug = e % kCols;
    const int u = ug / 4, g = ug % 4;
    wsf[e] = w_hh[k * g4 + g * hidden + u0 + u];
  }
  // product role
  const int tile = threadIdx.x % ntiles, ks = threadIdx.x / ntiles;
  const int tu = tile % kUnits, row0 = (tile / kUnits) * kRows;
  const int klen = hidden / ksplit, kbeg = ks * klen;
  const bool producer = ks < ksplit;
  // cell role
  const int cb = threadIdx.x / kUnits, cu = threadIdx.x % kUnits;
  const bool owner = cb < batch;
  const int col = u0 + cu;
  float h = 0.f, c = 0.f;
  if (owner) hbuf[cb * hidden + col] = 0.f;  // buffer 0 holds the zero state
  grid.sync();  // w slice loaded, zero state visible to every block

  const size_t plane = static_cast<size_t>(batch) * hidden;
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const float* hp = hbuf + (s & 1) * plane;
    float* hn = hbuf + ((s + 1) & 1) * plane;
    // this step's input gates and mask do not depend on h: load them first
    float xi = 0.f, xf = 0.f, xc = 0.f, xo = 0.f, m = 0.f;
    if (owner) {
      const float* x = xg + (static_cast<size_t>(t) * batch + cb) * g4 + col;
      xi = x[0];
      xf = x[hidden];
      xc = x[2 * hidden];
      xo = x[3 * hidden];
      m = mask[static_cast<size_t>(t) * batch + cb];
    }
    if (producer) {
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
#pragma unroll 2
      for (int k = kbeg; k < kbeg + klen; k += 4) {
        float4 hv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          hv[r] = row0 + r < batch
                      ? __ldcg(reinterpret_cast<const float4*>(
                            hp + static_cast<size_t>(row0 + r) * hidden + k))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = ws[(k + q) * kUnits + tu];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float hk = q == 0 ? hv[r].x : q == 1 ? hv[r].y : q == 2 ? hv[r].z : hv[r].w;
            acc[r][0] = fmaf(hk, w.x, acc[r][0]);
            acc[r][1] = fmaf(hk, w.y, acc[r][1]);
            acc[r][2] = fmaf(hk, w.z, acc[r][2]);
            acc[r][3] = fmaf(hk, w.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        part[(ks * ntiles + tile) * kRows + r] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    // sum the k slices, in ks order
    for (int e = threadIdx.x; e < ntiles * kRows; e += blockDim.x) {
      float4 sum = part[e];
      for (int j = 1; j < ksplit; ++j) {
        const float4 v = part[j * ntiles * kRows + e];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      gates[e] = sum;
    }
    __syncthreads();
    if (owner) {
      const float4 a = gates[((cb / kRows) * kUnits + cu) * kRows + cb % kRows];
      const float gi = sigmoid(xi + a.x);
      const float gf = sigmoid(xf + a.y);
      const float gg = tanhf(xc + a.z);
      const float go = sigmoid(xo + a.w);
      const float c_new = gf * c + gi * gg;
      const float h_new = go * tanhf(c_new);
      h = m * h_new + (1.0f - m) * h;
      c = m * c_new + (1.0f - m) * c;
      hn[static_cast<size_t>(cb) * hidden + col] = h;
      hs[(static_cast<size_t>(t) * batch + cb) * hidden + col] = h;
    }
    grid.sync();  // h of this step visible; part and gates free again
  }
  if (owner) h_last[cb * hidden + col] = h;
}

}  // namespace

// Launch shape for (batch, hidden), shared by the launch and the query:
// H/4 blocks; ntiles = ceil(B/4) * 4 register tiles, each split over
// ksplit slices of H (at most 16) so that ntiles * ksplit fills up to 1024
// threads.
struct LstmShape {
  int blocks, threads, ntiles, ksplit;
  size_t smem;
  LstmShape(int batch, int hidden) {
    ntiles = (batch + kRows - 1) / kRows * kUnits;
    ksplit = kMaxThreads / ntiles < kMaxSplit ? kMaxThreads / ntiles : kMaxSplit;
    while (ksplit > 1 && hidden % (4 * ksplit)) --ksplit;  // whole float4s
    if (ksplit < 1) ksplit = 1;
    blocks = hidden / kUnits;
    const int cells = batch * kUnits;
    threads = ntiles * ksplit > cells ? ntiles * ksplit : cells;
    threads = (threads + 31) / 32 * 32;
    smem = (static_cast<size_t>(hidden) * kUnits +
            static_cast<size_t>(ksplit + 1) * ntiles * kRows) * sizeof(float4);
  }
};

// How many blocks of this kernel can be resident at once on the current
// device (0 if it has no cooperative launch); the launch needs hidden / 4.
ATK_EXPORT int atk_lstm_max_blocks(int batch, int hidden, int* out) {
  const LstmShape sh(batch, hidden);
  int dev, coop, per_sm, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = atk::allow_smem(lstm_fwd_kernel, sh.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_fwd_kernel, sh.threads,
                                                        sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = coop ? per_sm * sms : 0;
  return 0;
}

ATK_EXPORT int atk_lstm_fwd(const float* xg, const float* mask, const float* w_hh,
                            int steps, int batch, int hidden, int reverse, float* hbuf,
                            float* hs, float* h_last, void* stream) {
  LstmShape sh(batch, hidden);
  if (hidden % kUnits || batch * kUnits > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (steps <= 0) return 0;
  cudaError_t err = atk::allow_smem(lstm_fwd_kernel, sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xg,      &mask,     &w_hh,      &steps, &batch, &hidden,
                  &reverse, &sh.ntiles, &sh.ksplit, &hbuf,  &hs,    &h_last};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fwd_kernel), dim3(sh.blocks),
                                    dim3(sh.threads), args, sh.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
