// Kernels B3 and B4: one LSTM direction over precomputed input gates,
// forward (B3) and backward (B4).
//
// B3 replaces audio_tokens_tpu/ops/pallas_lstm.py::_fwd_kernel (launched by
// _lstm_fwd_call), B4 replaces _bwd_kernel (launched by _lstm_bwd_call).
//
// B3: xg (T, B, 4H) f32 = x @ w_ih + bias, gate order i, f, g, o (torch's);
// mask (T, B) f32; w_hh (H, 4H) f32 -> hs (T, B, H), h_last (B, H), and,
// when a gradient is needed, the residuals of B4: the post-activation gates
// (T, B, 4H) and the masked cell carry c (T, B, H).  Step s processes time
// t = s, or t = T-1-s when reverse, and writes hs[t], so the outputs stay in
// the original time order.  Past a sequence's end (mask 0) the state passes
// through: h = m*new + (1-m)*prev, likewise c.
//
// What bounds B3 on the H100: the recurrence.  Each step needs all of the
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
// barrier itself, not by flops.  The residual stores are one uniform branch
// per step; serving (no gradient) passes null residual pointers and skips
// them.
//
// B4 walks the forward processing order backwards, carrying (dh, dc), and
// emits dxg = the pre-activation gate gradients (T, B, 4H) and dw_hh (H, 4H).
// It is two launches:
//  1. lstm_bwd_kernel, the serial part, shaped like B3: one cooperative
//     launch of H/4 blocks, block j owning units 4j..4j+3.  A thread per
//     (b, u) runs the cell backward from the residuals with dh and dc in
//     registers, and writes its unit's 4 gate gradients to dxg and to a
//     double-buffered global plane dgbuf (2, B, 4H).  After a grid barrier,
//     every block needs ALL 4H columns of that plane for dh = dgp . w_hh^T
//     of its own 4 units, so it keeps the ROWS w_hh[4j..4j+3, :] in shared
//     memory (32 KB at H 512), not B3's columns.  The product is tiled 4
//     batch rows x 4 units per thread over a slice of 4H, the slices summed
//     in shared memory in a fixed order by the (b, u) thread that owns the
//     carry, so dh never leaves the block.  Each block reads the whole
//     (B, 4H) plane from L2 per step, 4x B3's h: that and the barrier bound
//     a step.  The step's residual loads (HBM: 0.9 GB of gates at T 1728,
//     B 64, H 512) do not depend on the carry and are issued before the
//     product of the step before.
//  2. lstm_dw_kernel: dw_hh = sum over processing steps p >= 1 of
//     h_prev(p)^T dgp(p).  h_prev is hs one step back in processing order
//     (zero at the first step), so the sum is one product A^T B of two
//     time-shifted contiguous views, hs and dxg, with K = (T-1)*B rows: a
//     plain f32 GEMM over the whole card (64 x 64 output tiles, 4 x 4 per
//     thread), run after the recurrence instead of inside its serial steps.
//     232 GFLOP at T 1728, B 64, H 512: bound by the FMA rate.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 4;            // hidden units per block
constexpr int kCols = 4 * kUnits;    // w_hh columns per block
constexpr int kRows = 4;             // batch rows of a thread's register tile
constexpr int kMaxSplit = 16;        // B3: at most 16 slices of H per tile
constexpr int kMaxSplitBwd = 64;     // B4: at most 64 slices of 4H per tile
constexpr int kMaxThreads = 1024;
constexpr int kGemmTile = 64;        // dw_hh output tile (both sides)
constexpr int kGemmK = 16;           // K rows staged per iteration
constexpr int kGemmThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

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
                float* __restrict__ hs, float* __restrict__ h_last,
                float* __restrict__ gates_res, float* __restrict__ c_res) {
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
            const float hk = lane(hv[r], q);
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
      const size_t row = static_cast<size_t>(t) * batch + cb;
      hn[static_cast<size_t>(cb) * hidden + col] = h;
      hs[row * hidden + col] = h;
      if (gates_res != nullptr) {  // the residuals of B4
        float* gr = gates_res + row * g4 + col;
        gr[0] = gi;
        gr[hidden] = gf;
        gr[2 * hidden] = gg;
        gr[3 * hidden] = go;
        c_res[row * hidden + col] = c;
      }
    }
    grid.sync();  // h of this step visible; part and gates free again
  }
  if (owner) h_last[cb * hidden + col] = h;
}

// One step's residuals for thread (b, unit col) of B4, at forward
// processing position p (time t): the post-activation gates, the masked
// cell carry c[t] and the carry that entered the step (zero at p == 0),
// the upstream gradient dhs[t] and the mask.
struct Residuals {
  float i, f, g, o, c, c_prev, dh_out, m;
};

__device__ __forceinline__ Residuals load_residuals(
    const float* __restrict__ dhs, const float* __restrict__ gates,
    const float* __restrict__ c_res, const float* __restrict__ mask, int p, int steps,
    int batch, int hidden, int reverse, int b, int col) {
  const int t = reverse ? steps - 1 - p : p;
  const size_t row = static_cast<size_t>(t) * batch + b;
  const float* gr = gates + row * 4 * hidden + col;
  Residuals r;
  r.i = gr[0];
  r.f = gr[hidden];
  r.g = gr[2 * hidden];
  r.o = gr[3 * hidden];
  r.c = c_res[row * hidden + col];
  r.dh_out = dhs[row * hidden + col];
  r.m = mask[row];
  r.c_prev = 0.f;
  if (p > 0) {
    const int tp = reverse ? steps - p : p - 1;
    r.c_prev = c_res[(static_cast<size_t>(tp) * batch + b) * hidden + col];
  }
  return r;
}

// B4's recurrence (see the head of the file).  Step s handles forward
// processing position p = T-1-s.  Thread roles as in B3: product thread
// (ks, tile) holds a 4 x 4 tile (batch rows row0..row0+3 x the block's 4
// units) over the k slice [kbeg, kbeg + klen) of 4H; cell thread
// (cb, cu) = (threadIdx / 4, threadIdx % 4) owns the carries of
// (batch row cb, unit u0 + cu).
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ dh_last,
                const float* __restrict__ gates, const float* __restrict__ c_res,
                const float* __restrict__ mask, const float* __restrict__ w_hh,
                int steps, int batch, int hidden, int reverse, int ntiles, int ksplit,
                float* dgbuf, float* __restrict__ dxg) {
  // ws[k] = (w_hh[u0, k], w_hh[u0+1, k], w_hh[u0+2, k], w_hh[u0+3, k])
  extern __shared__ float4 smem4[];
  const int g4 = 4 * hidden;
  float4* ws = smem4;                                      // g4
  float* part = reinterpret_cast<float*>(ws + g4);         // ksplit * ntiles * 16
  cg::grid_group grid = cg::this_grid();
  const int u0 = blockIdx.x * kUnits;
  float* wsf = reinterpret_cast<float*>(ws);
  for (int e = threadIdx.x; e < g4 * kUnits; e += blockDim.x) {
    const int u = e / g4, k = e % g4;
    wsf[k * kUnits + u] = w_hh[static_cast<size_t>(u0 + u) * g4 + k];
  }
  // product role
  const int tile = threadIdx.x % ntiles, ks = threadIdx.x / ntiles;
  const int row0 = tile * kRows;
  const int klen = g4 / ksplit, kbeg = ks * klen;
  const bool producer = ks < ksplit;
  const int tile_stride = ntiles * kRows * kUnits;  // floats per k slice
  // cell role
  const int cb = threadIdx.x / kUnits, cu = threadIdx.x % kUnits;
  const bool owner = cb < batch;
  const int col = u0 + cu;
  float dh = owner ? dh_last[cb * hidden + col] : 0.f;
  float dc = 0.f;
  Residuals res{};
  if (owner)
    res = load_residuals(dhs, gates, c_res, mask, steps - 1, steps, batch, hidden, reverse,
                         cb, col);
  __syncthreads();  // ws loaded

  const size_t plane = static_cast<size_t>(batch) * g4;
  for (int s = 0; s < steps; ++s) {
    const int p = steps - 1 - s;
    const int t = reverse ? steps - 1 - p : p;
    float* dg = dgbuf + (s & 1) * plane;
    float dh_direct = 0.f;
    if (owner) {
      // _bwd_kernel's cell backward, term for term
      const float tanh_c = tanhf(res.c);  // == tanh(c_new) wherever the step was live
      const float dh_total = res.dh_out + dh;
      const float dh_new = res.m * dh_total;
      dh_direct = (1.0f - res.m) * dh_total;
      const float dc_new = res.m * dc;
      const float dc_direct = (1.0f - res.m) * dc;
      const float d_o = dh_new * tanh_c;
      const float dcn = dc_new + dh_new * res.o * (1.0f - tanh_c * tanh_c);
      const float d_i = dcn * res.g;
      const float d_g = dcn * res.i;
      const float d_f = dcn * res.c_prev;
      dc = dcn * res.f + dc_direct;
      const float gi = d_i * res.i * (1.0f - res.i);
      const float gf = d_f * res.f * (1.0f - res.f);
      const float gg = d_g * (1.0f - res.g * res.g);
      const float go = d_o * res.o * (1.0f - res.o);
      float* x = dxg + (static_cast<size_t>(t) * batch + cb) * g4 + col;
      x[0] = gi;
      x[hidden] = gf;
      x[2 * hidden] = gg;
      x[3 * hidden] = go;
      float* d = dg + static_cast<size_t>(cb) * g4 + col;
      d[0] = gi;
      d[hidden] = gf;
      d[2 * hidden] = gg;
      d[3 * hidden] = go;
    }
    if (s + 1 == steps) break;  // the same for every block: no dh after p == 0
    grid.sync();  // this step's dgp plane visible to every block
    // the next step's residuals do not depend on the carries: load them now
    if (owner)
      res = load_residuals(dhs, gates, c_res, mask, p - 1, steps, batch, hidden, reverse,
                           cb, col);
    if (producer) {
      float acc[kRows][kUnits];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int u = 0; u < kUnits; ++u) acc[r][u] = 0.f;
#pragma unroll 2
      for (int k = kbeg; k < kbeg + klen; k += 4) {
        float4 dv[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          dv[r] = row0 + r < batch
                      ? __ldcg(reinterpret_cast<const float4*>(
                            dg + static_cast<size_t>(row0 + r) * g4 + k))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = ws[k + q];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float d = lane(dv[r], q);
            acc[r][0] = fmaf(d, w.x, acc[r][0]);
            acc[r][1] = fmaf(d, w.y, acc[r][1]);
            acc[r][2] = fmaf(d, w.z, acc[r][2]);
            acc[r][3] = fmaf(d, w.w, acc[r][3]);
          }
        }
      }
      // part[ks][row][u]: the owner of (row, u) reads a contiguous column
      float* pp = part + ks * tile_stride + row0 * kUnits;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int u = 0; u < kUnits; ++u) pp[r * kUnits + u] = acc[r][u];
    }
    __syncthreads();
    if (owner) {
      // sum the k slices in ks order: dh = dgp . w_hh^T + dh_prev_direct
      const float* pp = part + cb * kUnits + cu;
      float sum = pp[0];
      for (int j = 1; j < ksplit; ++j) sum += pp[j * tile_stride];
      dh = sum + dh_direct;
    }
    // part is written again only after the next grid.sync
  }
}

// c (m x n) = a^T b for row-major a (k x m) and b (k x n); m and n multiples
// of 4 (whole float4s).  Block (bx, by) owns the 64 x 64 tile of c at rows
// 64*by, columns 64*bx; thread (tx, ty) its 4 x 4 sub-tile at rows
// 4*ty.., columns 4*tx...  K advances 16 rows a step through shared memory;
// the next step's rows are loaded into registers while this step's are
// multiplied.  One accumulator per output, summed in k order.
__global__ void __launch_bounds__(kGemmThreads)
lstm_dw_kernel(const float* __restrict__ a, const float* __restrict__ b, int kdim, int m,
               int n, float* __restrict__ c) {
  __shared__ float4 as[kGemmK][kGemmTile / 4];
  __shared__ float4 bs[kGemmK][kGemmTile / 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kGemmTile, n0 = blockIdx.x * kGemmTile;
  // loader role: thread -> (k row ty, float4 column tx) of both tiles
  const int am = m0 + 4 * tx, bn = n0 + 4 * tx;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int k0, float4& av, float4& bv) {
    const int k = k0 + ty;
    av = k < kdim && am < m
             ? *reinterpret_cast<const float4*>(a + static_cast<size_t>(k) * m + am)
             : zero;
    bv = k < kdim && bn < n
             ? *reinterpret_cast<const float4*>(b + static_cast<size_t>(k) * n + bn)
             : zero;
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float4 ra, rb;
  load(0, ra, rb);
  for (int k0 = 0; k0 < kdim; k0 += kGemmK) {
    as[ty][tx] = ra;
    bs[ty][tx] = rb;
    __syncthreads();
    if (k0 + kGemmK < kdim) load(k0 + kGemmK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < kGemmK; ++kk) {
      const float4 av = as[kk][ty];
      const float4 bv = bs[kk][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = lane(av, i);
        acc[i][0] = fmaf(ai, bv.x, acc[i][0]);
        acc[i][1] = fmaf(ai, bv.y, acc[i][1]);
        acc[i][2] = fmaf(ai, bv.z, acc[i][2]);
        acc[i][3] = fmaf(ai, bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  const int cn = n0 + 4 * tx;
  if (cn >= n) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cm = m0 + 4 * ty + i;
    if (cm < m)
      *reinterpret_cast<float4*>(c + static_cast<size_t>(cm) * n + cn) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace

// Launch shape of B3 for (batch, hidden), shared by the launch and the
// query: H/4 blocks; ntiles = ceil(B/4) * 4 register tiles, each split over
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

// Launch shape of B4's recurrence: H/4 blocks; ntiles = ceil(B/4) tiles of
// 4 rows x 4 units, each split over ksplit slices of 4H (at most 64) so
// that ntiles * ksplit fills up to 1024 threads.
struct LstmBwdShape {
  int blocks, threads, ntiles, ksplit;
  size_t smem;
  LstmBwdShape(int batch, int hidden) {
    const int g4 = 4 * hidden;
    ntiles = (batch + kRows - 1) / kRows;
    ksplit = kMaxThreads / ntiles < kMaxSplitBwd ? kMaxThreads / ntiles : kMaxSplitBwd;
    while (ksplit > 1 && g4 % (4 * ksplit)) --ksplit;  // whole float4s
    if (ksplit < 1) ksplit = 1;
    blocks = hidden / kUnits;
    const int cells = batch * kUnits;
    threads = ntiles * ksplit > cells ? ntiles * ksplit : cells;
    threads = (threads + 31) / 32 * 32;
    smem = static_cast<size_t>(g4) * sizeof(float4) +
           static_cast<size_t>(ksplit) * ntiles * kRows * kUnits * sizeof(float);
  }
};

template <typename Shape, typename K>
static int max_blocks(K kernel, int batch, int hidden, int* out) {
  const Shape sh(batch, hidden);
  int dev, coop, per_sm, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = atk::allow_smem(kernel, sh.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, sh.threads, sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = coop ? per_sm * sms : 0;
  return 0;
}

// How many blocks of B3 (backward == 0) or of B4's recurrence (backward ==
// 1) can be resident at once on the current device (0 if it has no
// cooperative launch); either launch needs hidden / 4.
ATK_EXPORT int atk_lstm_max_blocks(int batch, int hidden, int backward, int* out) {
  return backward ? max_blocks<LstmBwdShape>(lstm_bwd_kernel, batch, hidden, out)
                  : max_blocks<LstmShape>(lstm_fwd_kernel, batch, hidden, out);
}

// B3.  gates_res and c_res are both null (no residuals) or both the
// (T, B, 4H) and (T, B, H) outputs.
ATK_EXPORT int atk_lstm_fwd(const float* xg, const float* mask, const float* w_hh,
                            int steps, int batch, int hidden, int reverse, float* hbuf,
                            float* hs, float* h_last, float* gates_res, float* c_res,
                            void* stream) {
  LstmShape sh(batch, hidden);
  if (hidden % kUnits || batch * kUnits > kMaxThreads || (gates_res == nullptr) != (c_res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (steps <= 0) return 0;
  cudaError_t err = atk::allow_smem(lstm_fwd_kernel, sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xg,      &mask,      &w_hh,      &steps, &batch,  &hidden,    &reverse,
                  &sh.ntiles, &sh.ksplit, &hbuf,  &hs,     &h_last, &gates_res, &c_res};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fwd_kernel), dim3(sh.blocks),
                                    dim3(sh.threads), args, sh.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// B4: the recurrence, then dw_hh.  dgbuf is (2, B, 4H) scratch; dxg
// (T, B, 4H) and dw_hh (H, 4H) are written in full.
ATK_EXPORT int atk_lstm_bwd(const float* dhs, const float* dh_last, const float* gates,
                            const float* c_res, const float* hs, const float* mask,
                            const float* w_hh, int steps, int batch, int hidden, int reverse,
                            float* dgbuf, float* dxg, float* dw_hh, void* stream) {
  LstmBwdShape sh(batch, hidden);
  if (hidden % kUnits || batch * kUnits > kMaxThreads || steps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = atk::allow_smem(lstm_bwd_kernel, sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&dhs,    &dh_last, &gates,   &c_res,     &mask,      &w_hh,  &steps,
                  &batch,  &hidden,  &reverse, &sh.ntiles, &sh.ksplit, &dgbuf, &dxg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_bwd_kernel), dim3(sh.blocks),
                                    dim3(sh.threads), args, sh.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // h_prev of processing position p is hs at the time one step earlier in
  // processing order: pair hs[t-1] with dxg[t] (forward) or hs[t+1] with
  // dxg[t] (reverse), for the T-1 positions p >= 1
  const int g4 = 4 * hidden;
  const int kdim = (steps - 1) * batch;
  const float* a = hs + (reverse ? static_cast<size_t>(batch) * hidden : 0);
  const float* b = dxg + (reverse ? 0 : static_cast<size_t>(batch) * g4);
  const dim3 grid((g4 + kGemmTile - 1) / kGemmTile, (hidden + kGemmTile - 1) / kGemmTile);
  lstm_dw_kernel<<<grid, kGemmThreads, 0, st>>>(a, b, kdim, hidden, g4, dw_hh);
  return static_cast<int>(cudaGetLastError());
}
