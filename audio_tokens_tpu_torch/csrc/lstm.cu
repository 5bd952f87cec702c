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
// split across blocks: one persistent cooperative launch, h exchanged
// through a double-buffered global buffer hbuf (2, B, H) with a barrier
// after every step.  Blocks read h written by other blocks after the
// barrier, so those reads bypass L1 (cp.async.cg) and hbuf carries no const
// or __restrict__.  Each block reads its rows of h in full every step, so
// the card reads (unit groups) x its share of h: blocks of 4 units x all
// rows would read 16 MB a step at B 64, H 512.  So a block
// owns 8 units x 32 batch rows (B4's partition), 128 blocks at B 64, H 512:
// its 64 KB of w_hh columns stay in shared memory, it copies its 64 KB of h
// into shared memory once a step (8 MB in all, every copy in flight at
// once), and its warps hold 8 rows x 16 gate columns in registers, so a
// weight load feeds 32 FMAs and an h load 16, and sum their tiles by
// shuffles: no shared-memory pass.  The barrier waits only for the blocks
// that write the block's rows (lstm_fwd_kernel's comment).  Per step at
// B 64, H 512 that leaves the product (~2.3 us of FMA issue over 128 SMs),
// the copy's L2 round trip and the barrier (~1.1 us).  The sums are in a
// fixed order: launches are bit-identical.  The residual stores are one
// uniform branch per step; serving (no gradient) passes null residual
// pointers and skips them.
//
// B4 walks the forward processing order backwards, carrying (dh, dc), and
// emits dxg = the pre-activation gate gradients (T, B, 4H) and dw_hh (H, 4H).
// It is two launches:
//  1. lstm_bwd_kernel, the serial part: one cooperative launch.  Each step
//     every cell (b, u) turns its residuals and carries into its unit's 4
//     gate gradients, written to dxg and to a double-buffered global plane
//     dgbuf (2, B, 4H); after a grid barrier, dh = dgp . w_hh^T needs ALL 4H
//     columns of that plane for each row.  What bounds a step on the H100 is
//     reading the plane from L2: every block reads its batch rows of it in
//     full, so the card reads (number of unit groups) x the plane a step, and
//     only blocks that own more units read less; the FMA work (134 MFLOP a
//     step at B 64, H 512) and the grid barrier (~1.1 us) come next.  So a
//     block owns U = 8 or 16 units (kBwdUnits) x `rows` batch rows: it keeps
//     the ROWS w_hh[u0 .. u0+U, :] in shared memory (64 KB at U 8, H 512),
//     its cell threads hold dh and dc in registers, and its product threads
//     read only its rows of the plane, each element once (__ldcg: written by
//     other blocks, so not through L1): 32 MB a step at B 64, H 512, U 8,
//     from the 64 MB of the first design's 4-unit blocks.  A product thread
//     holds a 4 rows x U units register tile over every ksplit-th float4
//     column of 4H; a warp's 32 lanes take 32 neighbouring columns of one
//     tile (coalesced plane loads, conflict-free weight loads), sum their
//     tiles over the warp by a reduce-scatter of shuffles, and the warps of a
//     tile are summed in shared memory in a fixed order by the (b, u) thread
//     that owns the carry, so dh never leaves the block and launches are
//     bit-identical.  The step's residual loads (HBM: 0.9 GB of gates at
//     T 1728, B 64, H 512) do not depend on the carry and are issued before
//     the product of the step before.  Its phase counters (ATK_LSTM_TIMERS)
//     put ~70% of a step in the plane loads and the product and ~16% in the
//     grid barrier at B 64, H 512 (PERF.md).
//  2. lstm_dw_kernel: dw_hh = sum over processing steps p >= 1 of
//     h_prev(p)^T dgp(p).  h_prev is hs one step back in processing order
//     (zero at the first step), so the sum is one product A^T B of two
//     time-shifted contiguous views, hs and dxg, with K = (T-1)*B rows, run
//     after the recurrence instead of inside its serial steps: 232 GFLOP a
//     direction against 1.13 GB read at T 1728, B 64, H 512, so bound by
//     the f32 FMA rate (3.46 ms at 67 TFLOP/s).  Both operands are K-major,
//     so a k-row of A is contiguous along m and one of B along n: the
//     product is a sum of outer products and needs no transpose.  A block
//     of 4 warps owns a 128 x 128 output tile, a thread 16 x 8 outputs fed
//     by six float4 shared loads a k-row (128 FMAs per 6 loads; 255
//     registers, 2 blocks an SM); k-rows arrive in stages of 16 through a
//     ring of 4 cp.async stages, one barrier a stage, so the loads of stage
//     s+3 are in flight while stage s is multiplied; the copies walk
//     pointers kept across stages, so little address arithmetic sits
//     between the FMAs.  At H 512 the output has only 64
//     such tiles for 132 SMs, so K is cut into S slices (split-K, S from the
//     grid's size: 2 blocks an SM); each block writes its partial tile to
//     scratch and lstm_dw_sum_kernel adds the S partials in slice order.
//     No float atomics: every sum has a fixed order, so launches are
//     bit-identical.  On an H100 (700 W): 9.2 ms for both directions at
//     T 1728, B 64, H 512, against cuBLAS's 8.8 on the same views (PERF.md).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBatch = 256;       // rows the wrappers accept
constexpr size_t kMaxSmem = 227 * 1024;  // shared memory a block may have
constexpr int kFwdUnits = 8;         // B3: hidden units a block owns
constexpr int kFwdRows = 32;         // B3: batch rows a block owns, unless the grid must shrink
constexpr int kFwdThreads = 256;     // B3: threads of a block (8 warps, up to 255 registers)
constexpr int kFwdTaskRows = 8;      // B3: batch rows of a warp's task (x 4 units)

// dw_hh's GEMM, tuning knobs (tools/kernel_ab.py --kernel lstm-dw builds
// the alternatives with -D and times them)
#ifndef ATK_LSTM_DW_BK
#define ATK_LSTM_DW_BK 16  // k-rows of a ring stage: 8, 16 or 32
#endif
#ifndef ATK_LSTM_DW_STAGES
#define ATK_LSTM_DW_STAGES 4  // cp.async ring stages, at least 3
#endif
#ifndef ATK_LSTM_DW_SLICES
#define ATK_LSTM_DW_SLICES 0  // split-K slices; 0: as many as fill the SMs
#endif
constexpr int kDwTile = 128;    // output tile rows (of H) and columns (of 4H)
constexpr int kDwThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kDwBK = ATK_LSTM_DW_BK;
constexpr int kDwStages = ATK_LSTM_DW_STAGES;
constexpr int kDwBlocksPerSm = 2;  // resident blocks an SM
static_assert(kDwBK == 8 || kDwBK == 16 || kDwBK == 32, "dw_hh stages of 8, 16 or 32 k-rows");
static_assert(kDwStages >= 3, "dw_hh's ring needs 3 stages to overlap loads and product");

// B4's partition, tuning knobs: the defaults are the measured best on an
// H100 (PERF.md); tools/kernel_ab.py builds the alternatives with -D and
// times them.
#ifndef ATK_LSTM_BWD_UNITS
#define ATK_LSTM_BWD_UNITS 8  // hidden units a B4 block owns: 8 or 16
#endif
#ifndef ATK_LSTM_BWD_ROWS
#define ATK_LSTM_BWD_ROWS 32  // batch rows a B4 block owns, unless the grid must shrink to fit
#endif
#ifndef ATK_LSTM_BWD_THREADS
#define ATK_LSTM_BWD_THREADS 512  // threads of a U = 8 block: 512 or 1024 (64 registers: spills)
#endif
#ifndef ATK_LSTM_BWD_UNROLL
#define ATK_LSTM_BWD_UNROLL 2  // unrolling of the product's loop over plane columns
#endif
constexpr int kBwdUnits = ATK_LSTM_BWD_UNITS;
constexpr int kBwdRows = ATK_LSTM_BWD_ROWS;
constexpr int kBwdThreads = ATK_LSTM_BWD_THREADS;
constexpr int kBwdUnroll = ATK_LSTM_BWD_UNROLL;
static_assert(kBwdThreads == 512 || kBwdThreads == 1024, "B4 blocks of 512 or 1024 threads");
static_assert(kBwdUnits == 8 || kBwdUnits == 16, "B4 blocks own 8 or 16 units");
constexpr int kTileRows = 4;  // B4: batch rows of a product thread's register tile

// Per-phase cycle counters (clock64) of B3 and B4, compiled in only with
// -DATK_LSTM_TIMERS=1 (tools/kernel_ab.py reads them): thread 0 of each block
// adds the cycles between marks to its phase, and writes its sums to
// g_timers[kernel][block] at the end.  A mark after loads first consumes
// the loaded value, so the phase ends when the data has arrived.
constexpr int kTimerPhases = 6;
constexpr int kTimerBlocks = 1024;
#ifndef ATK_LSTM_TIMERS
#define ATK_LSTM_TIMERS 0  // 1: compile the phase counters in
#endif
#if ATK_LSTM_TIMERS
__device__ unsigned long long g_timers[2][kTimerBlocks][kTimerPhases];
__device__ __forceinline__ long long cycles() {
  long long now;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(now));
  return now;
}
struct PhaseTimer {
  unsigned long long acc[kTimerPhases] = {};
  long long last;
  __device__ PhaseTimer() : last(cycles()) {}
  __device__ void mark(int phase) {
    const long long now = cycles();
    acc[phase] += now - last;
    last = now;
  }
  __device__ void wait_for(float v) {  // stalls until v is loaded
    asm volatile("add.f32 %0, %0, 0f00000000;" : "+f"(v));
  }
  __device__ void store(int kernel) const {
    if (threadIdx.x == 0 && blockIdx.x < kTimerBlocks)
      for (int p = 0; p < kTimerPhases; ++p) g_timers[kernel][blockIdx.x][p] += acc[p];
  }
};
#else
struct PhaseTimer {
  __device__ void mark(int) {}
  __device__ void wait_for(float) {}
  __device__ void store(int) const {}
};
#endif

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The warp's sum, over its 32 lanes, of each of the N values v[0..N) (N a
// multiple of 32), left scattered: lane i ends with the sums of values
// i * N/32 .. i * N/32 + N/32 - 1 in v[0..N/32).  Each of the five rounds
// halves the values a lane keeps and sends the other half to its partner:
// N - N/32 shuffles where a butterfly would take 5 N.  The order of the
// additions is fixed: bit-identical from launch to launch.  One template
// instance a round, so that every index into v is a constant: a loop over
// rounds whose inner trip count depends on the round leaves the indices
// unknown to the compiler, which then keeps the whole array in local
// memory (a stack frame of the array's size in ptxas' report).
template <int N, int ROUND = 0>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N], int lane) {
  static_assert(N % 32 == 0, "whole warps of values");
  if constexpr (ROUND < 5) {
    constexpr int off = 16 >> ROUND, half = N >> (ROUND + 1);
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float keep = upper ? v[i + half] : v[i];
      const float send = upper ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    warp_reduce_scatter<N, ROUND + 1>(v, lane);
  }
}

// B3 (see the head of the file).  Block x owns the hidden units [u0,
// u0 + 8) (unit group x % ceil(H/8); units past H are masked: zero weights,
// no cell) and the batch rows [b0, b0 + rows) (row group x / ceil(H/8)),
// and keeps the 32 columns of w_hh those units' gates read, all H rows, in
// shared memory: ws[((p * 4 + q) * 4 + v) * (H/4) + j] = the 4 gates (i, f,
// g, o) of unit u0 + 4p + v at k = 4j + q.  Each step the block copies its
// rows of h into shared memory (cp.async, every copy in flight at once: one
// L2 round trip), `chunk` rows at a time where they do not all fit.  A task
// is 8 batch rows x 4 units (p = task % 2); warp w takes tasks w, w +
// warps, ...  A lane forms a register tile of 8 rows x 16 gate columns over
// the float4 columns j = lane, lane + 32, ... of h: a conflict-free float4
// of weights feeds 32 FMAs, one of h 16.  A shuffle reduce-scatter over the
// warp then leaves lane L with the 4 gates of unit L % 4, row L / 4: every
// lane runs one cell, whose c and h live in shared memory (one owner lane
// each); h goes out through hbuf.  A block's rows of h are written only by
// the blocks of its row group, so after a step it waits for those alone (an
// arrival counter a row group, release/acquire), not for the whole grid.
__global__ void __launch_bounds__(kFwdThreads, 1)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ mask,
                const float* __restrict__ w_hh, int steps, int batch, int hidden,
                int reverse, int rows, int chunk, float* hbuf,
                float* __restrict__ hs, float* __restrict__ h_last,
                float* __restrict__ gates_res, float* __restrict__ c_res) {
  extern __shared__ float4 smem4[];
  const int jn = hidden / 4;                              // float4 columns of a row of h
  float4* ws = smem4;                                     // 8 * hidden float4s
  float4* hsm = ws + 8 * static_cast<size_t>(hidden);     // chunk * jn float4s
  float* cst = reinterpret_cast<float*>(hsm + static_cast<size_t>(chunk) * jn);  // rows * 8
  float* hst = cst + rows * kFwdUnits;                    // rows * 8
  cg::grid_group grid = cg::this_grid();
  const int ugroups = (hidden + kFwdUnits - 1) / kFwdUnits;
  const int u0 = (blockIdx.x % ugroups) * kFwdUnits;
  const int b0 = (blockIdx.x / ugroups) * rows;
  const int row_end = min(b0 + rows, batch);
  const size_t g4 = 4 * static_cast<size_t>(hidden);
  float* wsf = reinterpret_cast<float*>(ws);
  for (int e = threadIdx.x; e < 32 * jn; e += blockDim.x) {
    const int j = e % jn, rest = e / jn;  // rest = (p * 4 + q) * 4 + v
    const int v = rest % 4, q = (rest / 4) % 4, p = rest / 16;
    const int k = 4 * j + q, u = u0 + 4 * p + v;
    for (int g = 0; g < 4; ++g)
      wsf[(static_cast<size_t>(rest) * jn + j) * 4 + g] =
          u < hidden ? w_hh[k * g4 + g * hidden + u] : 0.f;
  }
  for (int e = threadIdx.x; e < rows * kFwdUnits; e += blockDim.x) cst[e] = hst[e] = 0.f;
  // the row groups' arrival counters, after hbuf (atk_lstm_fwd_scratch)
  unsigned* arrivals = reinterpret_cast<unsigned*>(hbuf + 2 * static_cast<size_t>(batch) * hidden);
  const int row_group = blockIdx.x / ugroups;
  if (blockIdx.x == 0 && threadIdx.x < gridDim.x / ugroups) arrivals[threadIdx.x] = 0u;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int lr = lane / 4, lv = lane % 4;  // the lane's cell in a task: row, unit
  const int tasks = 2 * ((rows + kFwdTaskRows - 1) / kFwdTaskRows);
  // the cells this thread owns write the zero state into buffer 0
  for (int task = warp; task < tasks; task += warps) {
    const int b = b0 + kFwdTaskRows * (task / 2) + lr, col = u0 + 4 * (task % 2) + lv;
    if (b < row_end && col < hidden) hbuf[b * hidden + col] = 0.f;
  }
  grid.sync();  // w slice loaded, zero state visible to every block

  const size_t plane = static_cast<size_t>(batch) * hidden;
  PhaseTimer timer;  // phases: 0 inputs, 1 h copy, 2 product, 3 sum, 4 cell, 5 barrier
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const float* hp = hbuf + (s & 1) * plane;
    float* hn = hbuf + ((s + 1) & 1) * plane;
    for (int c0 = b0; c0 < row_end; c0 += chunk) {
      const int c1 = min(c0 + chunk, row_end);
      // the chunk's rows of h -> shared memory, every copy in flight at once
      for (int e = threadIdx.x; e < (c1 - c0) * jn; e += blockDim.x)
        atk::cp_async16(hsm + e, hp + static_cast<size_t>(c0) * hidden + 4 * e, true);
      atk::cp_async_commit();
      timer.mark(1);
      atk::cp_async_wait<0>();
      __syncthreads();
      timer.mark(1);
      for (int task = warp; task < tasks; task += warps) {
        const int rb = b0 + kFwdTaskRows * (task / 2);  // the task's first row
        if (rb < c0 || rb >= c1) continue;              // another chunk's task
        const int b = rb + lr, col = u0 + 4 * (task % 2) + lv;
        const bool live = b < row_end && col < hidden;
        // this step's input gates and mask do not depend on h
        float x[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.f;
        if (live) {
          const float* xr = xg + (static_cast<size_t>(t) * batch + b) * g4 + col;
#pragma unroll
          for (int g = 0; g < 4; ++g) x[g] = xr[g * hidden];
          m = mask[static_cast<size_t>(t) * batch + b];
        }
        timer.mark(0);
        float acc[kFwdTaskRows * 16];  // acc[r * 16 + v * 4 + g]
#pragma unroll
        for (int e = 0; e < kFwdTaskRows * 16; ++e) acc[e] = 0.f;
        const float4* wh = ws + static_cast<size_t>((task % 2) * 16) * jn;
        const float4* hr = hsm + static_cast<size_t>(rb - c0) * jn;
        const int nr = min(kFwdTaskRows, c1 - rb);  // rows of the task that exist
        for (int j = lane; j < jn; j += 32) {
          float4 h4[kFwdTaskRows];
#pragma unroll
          for (int r = 0; r < kFwdTaskRows; ++r)
            h4[r] = r < nr ? hr[static_cast<size_t>(r) * jn + j] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float4 w = wh[static_cast<size_t>(q * 4 + v) * jn + j];
#pragma unroll
              for (int r = 0; r < kFwdTaskRows; ++r) {
                const float hk = lane_of(h4[r], q);
                const int a = r * 16 + v * 4;
                acc[a] = fmaf(hk, w.x, acc[a]);
                acc[a + 1] = fmaf(hk, w.y, acc[a + 1]);
                acc[a + 2] = fmaf(hk, w.z, acc[a + 2]);
                acc[a + 3] = fmaf(hk, w.w, acc[a + 3]);
              }
            }
        }
        timer.wait_for(acc[kFwdTaskRows * 16 - 1]);
        timer.mark(2);
        warp_reduce_scatter(acc, lane);  // lane L: the 4 gates of row L / 4, unit L % 4
        timer.wait_for(acc[3]);
        timer.mark(3);
        if (live) {
          const float gi = sigmoid(x[0] + acc[0]);
          const float gf = sigmoid(x[1] + acc[1]);
          const float gg = tanhf(x[2] + acc[2]);
          const float go = sigmoid(x[3] + acc[3]);
          const int cell = (b - b0) * kFwdUnits + (col - u0);
          const float c_prev = cst[cell], h_prev = hst[cell];
          const float c_new = gf * c_prev + gi * gg;
          const float h_new = go * tanhf(c_new);
          const float h = m * h_new + (1.0f - m) * h_prev;
          const float c = m * c_new + (1.0f - m) * c_prev;
          cst[cell] = c;
          hst[cell] = h;
          const size_t row = static_cast<size_t>(t) * batch + b;
          hn[static_cast<size_t>(b) * hidden + col] = h;
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
        timer.mark(4);
      }
      if (c1 < row_end) __syncthreads();  // the next chunk overwrites hsm
    }
    // wait only for the blocks of this row group, which wrote its rows of h
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();  // this block's h before its arrival
      atomicAdd(arrivals + row_group, 1u);
      const unsigned target = static_cast<unsigned>(s + 1) * ugroups;
      unsigned seen;
      do {
        asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(arrivals + row_group));
      } while (seen < target);
    }
    __syncthreads();  // the group's h visible; hsm free again
    timer.mark(5);
  }
  for (int task = warp; task < tasks; task += warps) {
    const int b = b0 + kFwdTaskRows * (task / 2) + lr, col = u0 + 4 * (task % 2) + lv;
    if (b < row_end && col < hidden)
      h_last[b * hidden + col] = hst[(b - b0) * kFwdUnits + (col - u0)];
  }
  timer.store(0);
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
// processing position p = T-1-s.  Block x owns the hidden units
// [u0, u0 + U) (unit group x % ceil(H/U); units past H are masked: zero
// weights, no cell) and the batch rows [b0, b0 + rows) (row group
// x / ceil(H/U)).  Product thread (tile, ks) = (threadIdx / ksplit,
// threadIdx % ksplit) holds a kTileRows x U register tile (batch rows
// b0 + 4 tile .. + 3 x the block's units) over the float4 columns ks,
// ks + ksplit, ... of the plane's 4H; a warp is 32 neighbouring columns of
// one tile, so its plane loads are 512 contiguous bytes a row and its
// weight loads 512 contiguous bytes of shared memory.  Cell thread (cb, cu)
// = (threadIdx / U, threadIdx % U) owns the carries of (batch row b0 + cb,
// unit u0 + cu).
template <int U, int THREADS>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ dh_last,
                const float* __restrict__ gates, const float* __restrict__ c_res,
                const float* __restrict__ mask, const float* __restrict__ w_hh,
                int steps, int batch, int hidden, int reverse, int rows, int ntiles,
                int ksplit, float* dgbuf, float* __restrict__ dxg) {
  constexpr int kQ = U / 4;                   // float4s of one k's U weights
  constexpr int kAcc = kTileRows * U;         // a product thread's outputs
  constexpr int kPer = kAcc / 32;             // of which a lane keeps, summed
  // ws[(q * kQ + qq) * H + j] = w_hh[u0 + 4 qq .. u0 + 4 qq + 3, 4 j + q]
  extern __shared__ float4 smem4[];
  const int g4 = 4 * hidden;
  float4* ws = smem4;                                                  // U * g4 floats
  float* part = reinterpret_cast<float*>(ws + static_cast<size_t>(hidden) * 4 * kQ);
  cg::grid_group grid = cg::this_grid();
  const int ugroups = (hidden + U - 1) / U;
  const int u0 = (blockIdx.x % ugroups) * U;
  const int b0 = (blockIdx.x / ugroups) * rows;
  float* wsf = reinterpret_cast<float*>(ws);
  for (int e = threadIdx.x; e < U * g4; e += blockDim.x) {
    const int u = e / g4, k = e % g4;
    wsf[(static_cast<size_t>((k % 4) * kQ + u / 4) * hidden + k / 4) * 4 + u % 4] =
        u0 + u < hidden ? w_hh[static_cast<size_t>(u0 + u) * g4 + k] : 0.f;
  }
  // product role
  const int ks = threadIdx.x % ksplit, tile = threadIdx.x / ksplit;
  const int lane_id = threadIdx.x % 32;
  const bool producer = tile < ntiles;
  const int row0 = tile * kTileRows;  // within the block's rows
  const int nrows = min(kTileRows, min(rows, batch - b0) - row0);  // of the tile that exist
  const int tile_rows = ntiles * kTileRows;
  // cell role
  const int cb = threadIdx.x / U, cu = threadIdx.x % U;
  const int b = b0 + cb, col = u0 + cu;
  const bool owner = cb < rows && b < batch && col < hidden;
  float dh = owner ? dh_last[b * hidden + col] : 0.f;
  float dc = 0.f;
  Residuals res{};
  if (owner)
    res = load_residuals(dhs, gates, c_res, mask, steps - 1, steps, batch, hidden, reverse, b,
                         col);
  __syncthreads();  // ws loaded

  const size_t plane = static_cast<size_t>(batch) * g4;
  // phases: 0 cell + stores, 1 barrier, 2 residual loads issued, 3 plane
  // loads + product, 4 reduce-scatter + partial stores, 5 block sum of the partials
  PhaseTimer timer;
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
      float* x = dxg + (static_cast<size_t>(t) * batch + b) * g4 + col;
      x[0] = gi;
      x[hidden] = gf;
      x[2 * hidden] = gg;
      x[3 * hidden] = go;
      float* d = dg + static_cast<size_t>(b) * g4 + col;
      d[0] = gi;
      d[hidden] = gf;
      d[2 * hidden] = gg;
      d[3 * hidden] = go;
    }
    timer.mark(0);
    if (s + 1 == steps) break;  // the same for every block: no dh after p == 0
    grid.sync();  // this step's dgp plane visible to every block
    timer.mark(1);
    // the next step's residuals do not depend on the carries: load them now
    if (owner)
      res = load_residuals(dhs, gates, c_res, mask, p - 1, steps, batch, hidden, reverse, b,
                           col);
    timer.mark(2);
    if (producer) {  // whole warps: ksplit is a multiple of 32
      float acc[kAcc];  // acc[r * U + u]: row row0 + r, unit u0 + u
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      const float* dgr = dg + static_cast<size_t>(b0 + row0) * g4;
#pragma unroll kBwdUnroll
      for (int j = ks; j < hidden; j += ksplit) {  // float4 column j: k = 4j .. 4j + 3
        float4 dv[kTileRows];
#pragma unroll
        for (int r = 0; r < kTileRows; ++r)
          dv[r] = r < nrows ? __ldcg(reinterpret_cast<const float4*>(
                                  dgr + static_cast<size_t>(r) * g4) + j)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int qq = 0; qq < kQ; ++qq) {
            const float4 w = ws[static_cast<size_t>(q * kQ + qq) * hidden + j];
#pragma unroll
            for (int r = 0; r < kTileRows; ++r) {
              const float d = lane_of(dv[r], q);
              float* a = acc + r * U + 4 * qq;
              a[0] = fmaf(d, w.x, a[0]);
              a[1] = fmaf(d, w.y, a[1]);
              a[2] = fmaf(d, w.z, a[2]);
              a[3] = fmaf(d, w.w, a[3]);
            }
          }
      }
      timer.mark(3);
      warp_reduce_scatter(acc, lane_id);
      // part[kw][row][u] for the warp kw = ks / 32 of the tile's k slices
      float* pp = part + (static_cast<size_t>(ks / 32) * tile_rows + row0) * U + lane_id * kPer;
#pragma unroll
      for (int i = 0; i < kPer; ++i) pp[i] = acc[i];
      timer.mark(4);
    }
    __syncthreads();
    if (owner) {
      // sum the warps' k slices in order: dh = dgp . w_hh^T + dh_prev_direct
      const float* pp = part + cb * U + cu;
      float sum = pp[0];
      for (int kw = 1; kw < ksplit / 32; ++kw) sum += pp[static_cast<size_t>(kw) * tile_rows * U];
      dh = sum + dh_direct;
      timer.wait_for(dh);
    }
    timer.mark(5);
    // part is written again only after the next grid.sync
  }
  timer.store(1);
}

// c (m x n) = a^T b for row-major a (k x m) and b (k x n), m and n
// multiples of 4 (whole float4s): block (bx, by, bz) sums k-rows
// [bz * kslice, min(kdim, (bz + 1) * kslice)) of the output tile at rows
// kDwTile * by, columns kDwTile * bx, into out + bz * m * n (c itself when
// there is one slice).  Its warps split the tile 2 x 2 into 64 x 64; a
// warp's tile is split 4 x 8 over its lanes, and lane (ly, lx) owns rows
// 16 hm + 4 ly + {0..3} (hm < 4) and columns 32 hn + 4 lx + {0..3} (hn < 2)
// of it: per k-row it reads 4 + 2 float4s, which the warp serves from 4
// and 8 consecutive float4s (one shared-memory wavefront each).  Rows
// past m or n and k-rows past the slice are zeros (cp.async's zero fill),
// so the edge tiles need no other mask until the store.  One accumulator
// per output, summed in k order.
__global__ void __launch_bounds__(kDwThreads, kDwBlocksPerSm)
lstm_dw_kernel(const float* __restrict__ a, const float* __restrict__ b, int kdim, int m, int n,
               int kslice, float* __restrict__ out) {
  constexpr int k4 = kDwTile / 4;             // float4s of a k-row of A's or B's tile
  constexpr int kRows = kDwThreads / k4;      // k-rows one pass of the block copies
  constexpr int kStage = 2 * kDwBK * k4;      // float4s of a ring stage
  constexpr int kHM = 4, kHN = 2;             // float4s of A and of B a lane reads a k-row
  constexpr int kTM = 4 * kHM, kTN = 4 * kHN;  // a lane's outputs
  extern __shared__ float4 ring[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2, ly = lane / 8, lx = lane % 8;
  const int m0 = blockIdx.y * kDwTile, n0 = blockIdx.x * kDwTile;
  const int kbeg = blockIdx.z * kslice;
  const int kend = kdim < kbeg + kslice ? kdim : kbeg + kslice;
  const int iters = kend > kbeg ? (kend - kbeg + kDwBK - 1) / kDwBK : 0;
  // copy role: k-rows r + kRows q of the stage at float4 column ca of A and
  // cb of B; the pointers walk one stage a call
  const int r = threadIdx.x / k4, ca = m0 + 4 * (threadIdx.x % k4);
  const int cb = n0 + 4 * (threadIdx.x % k4);
  const bool a_in = ca < m, b_in = cb < n;
  const float* a_src = a + static_cast<size_t>(kbeg + r) * m + ca;
  const float* b_src = b + static_cast<size_t>(kbeg + r) * n + cb;
  float4* const a_dst = ring + threadIdx.x;
  float4* const b_dst = ring + kDwBK * k4 + threadIdx.x;
  int k_next = kbeg;  // first k-row of the next stage to load
  auto load_next = [&](int slot) {
    const int left = kend - k_next;  // k-rows of the slice from here
#pragma unroll
    for (int q = 0; q < kDwBK / kRows; ++q) {
      const bool ok = a_in && r + kRows * q < left;
      atk::cp_async16(a_dst + slot * kStage + q * kRows * k4,
                      ok ? a_src + static_cast<size_t>(q) * kRows * m : a, ok);
    }
#pragma unroll
    for (int q = 0; q < kDwBK / kRows; ++q) {
      const bool ok = b_in && r + kRows * q < left;
      atk::cp_async16(b_dst + slot * kStage + q * kRows * k4,
                      ok ? b_src + static_cast<size_t>(q) * kRows * n : b, ok);
    }
    a_src += static_cast<size_t>(kDwBK) * m;
    b_src += static_cast<size_t>(kDwBK) * n;
    k_next += kDwBK;
  };
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < iters) load_next(s);
    atk::cp_async_commit();  // an empty group keeps the count uniform
  }
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int a_off = wm * (k4 / 2) + ly, b_off = wn * (k4 / 2) + lx;
  int slot = 0;  // it % kDwStages
  for (int it = 0; it < iters; ++it) {
    atk::cp_async_wait<kDwStages - 2>();  // stage it has landed (this thread's part)
    __syncthreads();  // ... everyone's; and stage it-1's slot is free again
    if (it + kDwStages - 1 < iters) load_next(slot == 0 ? kDwStages - 1 : slot - 1);
    atk::cp_async_commit();
    const float4* as = ring + slot * kStage + a_off;
    const float4* bs = ring + slot * kStage + kDwBK * k4 + b_off;
#pragma unroll
    for (int kk = 0; kk < kDwBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int h = 0; h < kHM; ++h) {
        const float4 v = as[kk * k4 + 4 * h];
        av[4 * h] = v.x;
        av[4 * h + 1] = v.y;
        av[4 * h + 2] = v.z;
        av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < kHN; ++h) {
        const float4 v = bs[kk * k4 + 8 * h];
        bv[4 * h] = v.x;
        bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z;
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    slot = slot == kDwStages - 1 ? 0 : slot + 1;
  }
  atk::cp_async_wait<0>();  // no copy outlives the block (the tail groups are empty)
  float* c = out + static_cast<size_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + wm * (kDwTile / 2) + 16 * (i / 4) + 4 * ly + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < kHN; ++h) {
      const int col = n0 + wn * (kDwTile / 2) + 32 * h + 4 * lx;
      if (col < n)
        *reinterpret_cast<float4*>(c + static_cast<size_t>(row) * n + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// c = the sum of the `slices` partial products part[z] (each count4
// float4s), in slice order.
__global__ void lstm_dw_sum_kernel(const float4* __restrict__ part, int slices, int count4,
                                   float4* __restrict__ c) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count4; i += gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int z = 1; z < slices; ++z) {
      const float4 p = part[static_cast<size_t>(z) * count4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    c[i] = s;
  }
}

}  // namespace

// Launch shape of B3 for (batch, hidden) on a card of `sms` SMs, shared by
// the launch and the residency query: blocks own 8 units x `rows` batch
// rows, ceil(B / 32) row groups, fewer where the grid of ceil(H/8) x row
// groups would exceed one block an SM; the rows of h a block copies at once
// (`chunk`, a multiple of 8) are as many as shared memory holds beside the
// weights.  Threads: a warp a task (8 rows x 4 units), at most 8 warps.
struct LstmShape {
  int rows, chunk, blocks, threads;
  size_t smem;
  LstmShape(int batch, int hidden, int sms) {
    const int ugroups = (hidden + kFwdUnits - 1) / kFwdUnits;
    int rgroups = (batch + kFwdRows - 1) / kFwdRows;
    const int fit = sms / ugroups > 1 ? sms / ugroups : 1;
    if (rgroups > fit) rgroups = fit;
    rows = (batch + rgroups - 1) / rgroups;
    rgroups = (batch + rows - 1) / rows;
    blocks = ugroups * rgroups;
    const int tasks = 2 * ((rows + kFwdTaskRows - 1) / kFwdTaskRows);
    threads = 32 * tasks < kFwdThreads ? 32 * tasks : kFwdThreads;
    const size_t fixed = (static_cast<size_t>(32) * hidden +
                          2 * static_cast<size_t>(rows) * kFwdUnits) * sizeof(float);
    const size_t room = fixed < kMaxSmem ? (kMaxSmem - fixed) / (hidden * sizeof(float)) : 0;
    chunk = (rows + kFwdTaskRows - 1) / kFwdTaskRows * kFwdTaskRows;
    if (static_cast<size_t>(chunk) > room) chunk = static_cast<int>(room) / kFwdTaskRows * kFwdTaskRows;
    if (chunk < kFwdTaskRows) chunk = kFwdTaskRows;  // then the launch is refused for its memory
    smem = fixed + static_cast<size_t>(chunk) * hidden * sizeof(float);
  }
};

// Launch shape of B4's recurrence for (batch, hidden) on a card of `sms`
// SMs, shared by the launch and the residency query.  Blocks own U units x
// `rows` batch rows: ceil(B / kBwdRows) row groups, fewer where the grid of
// ceil(H/U) x row groups would exceed about one block an SM, but at least
// enough that a block's rows x U cells fit its threads.  ntiles =
// ceil(rows / 4) register tiles, each split over ksplit (a multiple of 32,
// at most the plane's H float4 columns) k slices.  The first of these that
// can be resident and whose weights fit shared memory is taken: U =
// kBwdUnits in 512 threads (the 128 registers a thread that U = 16's 64
// accumulators need; U = 8 in kBwdThreads), U = 8 in 512, U = 8 in 1024
// (64 registers a thread: it spills, but holds the 128 rows a block that
// B 256 at H 512 needs).
struct LstmBwdShape {
  int units, max_threads, rows, ntiles, ksplit, blocks, threads;
  size_t smem;
  LstmBwdShape(int batch, int hidden, int sms) {
    const int plans[3][2] = {{kBwdUnits, kBwdUnits == 8 ? kBwdThreads : 512}, {8, 512}, {8, 1024}};
    for (const auto& plan : plans) {
      units = plan[0];
      max_threads = plan[1];
      const int ugroups = (hidden + units - 1) / units;
      int rgroups = (batch + kBwdRows - 1) / kBwdRows;
      const int fit = sms / ugroups > 1 ? sms / ugroups : 1;
      if (rgroups > fit) rgroups = fit;
      const int least = (batch * units + max_threads - 1) / max_threads;  // a thread a cell
      if (rgroups < least) rgroups = least;
      rows = (batch + rgroups - 1) / rgroups;
      rgroups = (batch + rows - 1) / rows;
      blocks = ugroups * rgroups;
      ntiles = (rows + kTileRows - 1) / kTileRows;
      int warps = max_threads / 32 / ntiles;
      const int col_warps = (hidden + 31) / 32;  // the plane row's H float4 columns
      if (warps > col_warps) warps = col_warps;
      ksplit = 32 * warps;
      threads = rows * units > ntiles * ksplit ? rows * units : ntiles * ksplit;
      threads = (threads + 31) / 32 * 32;
      smem = (static_cast<size_t>(units) * 4 * hidden +
              static_cast<size_t>(warps) * ntiles * kTileRows * units) * sizeof(float);
      if (blocks <= sms && smem <= 227 * 1024) break;
    }
  }
  void* kernel() const {
    if (units == 16) return reinterpret_cast<void*>(lstm_bwd_kernel<16, 512>);
    return max_threads == 512 ? reinterpret_cast<void*>(lstm_bwd_kernel<8, 512>)
                              : reinterpret_cast<void*>(lstm_bwd_kernel<8, 1024>);
  }
};

// The current device's SM count and whether it has cooperative launch.
static cudaError_t device_sms(int* sms, int* coop) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// How many blocks of B3 (backward == 0) or of B4's recurrence (backward ==
// 1) can be resident at once on the current device (0 if it has no
// cooperative launch) into *resident, and how many the launch at (batch,
// hidden) needs into *needed.
ATK_EXPORT int atk_lstm_max_blocks(int batch, int hidden, int backward, int* resident,
                                   int* needed) {
  int sms, coop, per_sm = 0;
  cudaError_t err = device_sms(&sms, &coop);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (backward) {
    const LstmBwdShape sh(batch, hidden, sms);
    *needed = sh.blocks;
    err = cudaFuncSetAttribute(sh.kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sh.smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sh.kernel(), sh.threads,
                                                          sh.smem);
  } else {
    const LstmShape sh(batch, hidden, sms);
    *needed = sh.blocks;
    err = atk::allow_smem(lstm_fwd_kernel, sh.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lstm_fwd_kernel, sh.threads,
                                                          sh.smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *resident = coop ? per_sm * sms : 0;
  return 0;
}

// Floats of B3's scratch hbuf at (batch, hidden): h's two planes, then an
// arrival counter for each row group (LstmShape takes at most ceil(B / 32)).
ATK_EXPORT long atk_lstm_fwd_scratch(int batch, int hidden) {
  return 2L * batch * hidden + (batch + kFwdRows - 1) / kFwdRows;
}

// B3.  hbuf is scratch of atk_lstm_fwd_scratch floats; gates_res and
// c_res are both null (no residuals) or both the (T, B, 4H) and (T, B, H)
// outputs.
ATK_EXPORT int atk_lstm_fwd(const float* xg, const float* mask, const float* w_hh,
                            int steps, int batch, int hidden, int reverse, float* hbuf,
                            float* hs, float* h_last, float* gates_res, float* c_res,
                            void* stream) {
  if (hidden % 4 || batch < 1 || batch > kMaxBatch || (gates_res == nullptr) != (c_res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (steps <= 0) return 0;
  int sms, coop;
  cudaError_t err = device_sms(&sms, &coop);
  if (err != cudaSuccess) return static_cast<int>(err);
  LstmShape sh(batch, hidden, sms);
  err = atk::allow_smem(lstm_fwd_kernel, sh.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&xg,      &mask,     &w_hh,    &steps, &batch,  &hidden,    &reverse,
                  &sh.rows, &sh.chunk, &hbuf,    &hs,    &h_last, &gates_res, &c_res};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lstm_fwd_kernel), dim3(sh.blocks),
                                    dim3(sh.threads), args, sh.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch shape of dw_hh's GEMM at (steps, batch, hidden) on a card of
// `sms` SMs, shared by the launch and the scratch query: K = (T-1)*B
// k-rows cut into `slices` slices of `kslice` (a multiple of kDwBK), as
// many as keep about two blocks on each SM (ATK_LSTM_DW_SLICES overrides).
struct DwShape {
  int kdim, tiles_m, tiles_n, slices, kslice;
  DwShape(int steps, int batch, int hidden, int sms) {
    kdim = steps > 1 ? (steps - 1) * batch : 0;
    tiles_m = (hidden + kDwTile - 1) / kDwTile;
    tiles_n = (4 * hidden + kDwTile - 1) / kDwTile;
    int want = ATK_LSTM_DW_SLICES > 0 ? ATK_LSTM_DW_SLICES
                                      : kDwBlocksPerSm * sms / (tiles_m * tiles_n);
    if (want < 1) want = 1;
    const int per = (kdim + want - 1) / want;
    kslice = (per + kDwBK - 1) / kDwBK * kDwBK;
    slices = kslice > 0 ? (kdim + kslice - 1) / kslice : 1;
  }
  size_t smem() const { return static_cast<size_t>(kDwStages) * kDwBK * 2 * kDwTile * sizeof(float); }
};

// Floats of dw_hh's scratch at (steps, batch, hidden): one partial product
// a slice, none when there is one slice; -1 on a CUDA error.
ATK_EXPORT long atk_lstm_dw_scratch(int steps, int batch, int hidden) {
  int sms, coop;
  if (device_sms(&sms, &coop) != cudaSuccess) return -1;
  const DwShape sh(steps, batch, hidden, sms);
  return sh.slices > 1 ? static_cast<long>(sh.slices) * hidden * 4 * hidden : 0;
}

// B4's second kernel alone: dw_hh (H, 4H) = sum over processing positions
// p >= 1 of h_prev(p)^T dgp(p), from hs (T, B, H) and dxg (T, B, 4H);
// scratch holds atk_lstm_dw_scratch floats.
ATK_EXPORT int atk_lstm_dw(const float* hs, const float* dxg, int steps, int batch, int hidden,
                           int reverse, float* scratch, float* dw_hh, void* stream) {
  if (hidden % 4 || hidden < 1 || batch < 1 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms, coop;
  cudaError_t err = device_sms(&sms, &coop);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DwShape sh(steps, batch, hidden, sms);
  // h_prev of processing position p is hs at the time one step earlier in
  // processing order: pair hs[t-1] with dxg[t] (forward) or hs[t+1] with
  // dxg[t] (reverse), for the T-1 positions p >= 1
  const int g4 = 4 * hidden;
  const float* a = hs + (reverse ? static_cast<size_t>(batch) * hidden : 0);
  const float* b = dxg + (reverse ? 0 : static_cast<size_t>(batch) * g4);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = atk::allow_smem(lstm_dw_kernel, sh.smem());
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_dw_kernel<<<dim3(sh.tiles_n, sh.tiles_m, sh.slices), kDwThreads, sh.smem(), st>>>(
      a, b, sh.kdim, hidden, g4, sh.kslice, sh.slices > 1 ? scratch : dw_hh);
  err = cudaGetLastError();
  if (err != cudaSuccess || sh.slices == 1) return static_cast<int>(err);
  const int count4 = hidden * g4 / 4;
  const int blocks = (count4 + 255) / 256 < 4 * sms ? (count4 + 255) / 256 : 4 * sms;
  lstm_dw_sum_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(scratch), sh.slices,
                                             count4, reinterpret_cast<float4*>(dw_hh));
  return static_cast<int>(cudaGetLastError());
}

#if ATK_LSTM_TIMERS
// The phase cycle sums of B3 (kernel 0) or B4's recurrence (kernel 1), per
// block: host (blocks, kTimerPhases) unsigned 64-bit; then zeroed.
ATK_EXPORT int atk_lstm_timers(int kernel, unsigned long long* host, int blocks) {
  if (kernel < 0 || kernel > 1 || blocks > kTimerBlocks) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(unsigned long long) * kTimerPhases;
  const size_t offset = static_cast<size_t>(kernel) * kTimerBlocks * bytes;
  cudaError_t err = cudaMemcpyFromSymbol(host, g_timers, blocks * bytes, offset);
  if (err != cudaSuccess) return static_cast<int>(err);
  static unsigned long long zeros[kTimerBlocks][kTimerPhases];
  return static_cast<int>(cudaMemcpyToSymbol(g_timers, zeros, sizeof(zeros), offset));
}
#endif

// B4: the recurrence, then dw_hh.  dgbuf is (2, B, 4H) scratch, dw_scratch
// atk_lstm_dw_scratch floats; dxg (T, B, 4H) and dw_hh (H, 4H) are written
// in full.
ATK_EXPORT int atk_lstm_bwd(const float* dhs, const float* dh_last, const float* gates,
                            const float* c_res, const float* hs, const float* mask,
                            const float* w_hh, int steps, int batch, int hidden, int reverse,
                            float* dgbuf, float* dw_scratch, float* dxg, float* dw_hh,
                            void* stream) {
  if (hidden % 4 || batch < 1 || batch > kMaxBatch || steps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms, coop;
  cudaError_t err = device_sms(&sms, &coop);
  if (err != cudaSuccess) return static_cast<int>(err);
  LstmBwdShape sh(batch, hidden, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(sh.kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sh.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&dhs,    &dh_last, &gates,   &c_res,   &mask,      &w_hh,
                  &steps,  &batch,   &hidden,  &reverse, &sh.rows,   &sh.ntiles,
                  &sh.ksplit, &dgbuf, &dxg};
  err = cudaLaunchCooperativeKernel(sh.kernel(), dim3(sh.blocks), dim3(sh.threads), args,
                                    sh.smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return atk_lstm_dw(hs, dxg, steps, batch, hidden, reverse, dw_scratch, dw_hh, stream);
}
