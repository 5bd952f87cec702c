// Kernel B5: non-causal flash attention with segment ids, forward and the
// two backward kernels (dk/dv and dq).
//
// Replaces the library kernels the JAX package calls from
// audio_tokens_tpu/models/transformer.py::FlashSelfAttention
// (jax.experimental.pallas.ops.tpu.flash_attention):
// _flash_attention_kernel (forward), _flash_attention_dkv_kernel and
// _flash_attention_dq_kernel (backward).
//
// q, k, v, o, do (B, nh, T, 64) in float32 or bfloat16, seg (B, T) int32,
// lse and di (B, nh, T) float32.  The numerics are the library's: scores
// q.k^T accumulated in f32, times sm_scale, plus the finite mask value
// -0.7 * FLT_MAX where the query's and key's segments differ; an online
// softmax with running max m and sum l; P rounded to v's dtype before P.v,
// accumulation in f32, the output cast to the input dtype.  The backward
// recomputes P = exp(s - lse) from the saved row logsumexp, with
// dP = dO.V^T, dS = (dP - di) * P * sm_scale and di = rowsum(O * dO)
// (computed by the wrapper, as the library computes it outside its kernels);
// P and dS are rounded to the input dtype before the products that consume
// them.  Keys past T do not exist: the kernels mask their own ragged edge
// instead of padding T to a tile multiple.
//
// What bounds it on the H100: at the serving shape (B 64, nh 12, T 1728,
// dh 64) the forward is 587 GFLOP against 680 MB of q, k, v, o in bf16, so
// it is bound by arithmetic.  Every kernel keeps the (T, T) scores on chip:
// one block per (batch x head, 64-row tile), 64-row tiles of the other
// side staged through shared memory.  The bf16 forward (the serving path's)
// runs on the tensor cores with mma.sync (flash_fwd_mma_kernel); the f32
// forward and both backward kernels are plain f32 FMA from f32 tiles, each
// thread a 4 x 4 register tile, so they cannot beat the 67 TFLOP/s f32
// rate.  wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kD = 64;          // head dim the kernels take
constexpr int kTile = 64;       // rows (queries or keys) of a tile
constexpr int kLd = kD + 1;     // padded row of a shared tile: no bank conflicts
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)
constexpr int kR = 4;           // rows of a thread's register tile
constexpr float kMask = -0.7f * 3.40282347e38f;  // library DEFAULT_MASK_VALUE
constexpr size_t kTileBytes = sizeof(float) * kTile * kLd;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// x rounded to the input dtype (round to nearest even, as astype does)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}

// Rows [r0, r0 + 64) of one (T, 64) head into a shared tile as f32, zeros
// past T.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                                          int t) {
  for (int e = threadIdx.x; e < kTile * kD; e += kThreads) {
    const int r = e / kD, d = e % kD;
    dst[r * kLd + d] = r0 + r < t ? ld(src + (size_t)(r0 + r) * kD + d) : 0.f;
  }
}

// acc[i][j] += sum_c a[(4 ty + i), c] * b[c, tx + 16 j] over the 64 columns
// c of the shared tiles a (row-major) and b (row-major).
__device__ __forceinline__ void tile_pv(float (&acc)[kR][kR], const float* a, const float* b,
                                        int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float av[kR], bv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = a[(kR * ty + i) * kLd + c];
#pragma unroll
    for (int j = 0; j < kR; ++j) bv[j] = b[c * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// s[i][j] = sum_d a[(4 ty + i), d] * b[tx + 16 j, d]: rows of a against rows
// of b, both row-major tiles.
__device__ __forceinline__ void tile_qk(float (&s)[kR][kR], const float* a, const float* b,
                                        int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float av[kR], bv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = a[(kR * ty + i) * kLd + d];
#pragma unroll
    for (int j = 0; j < kR; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// The 16 threads of a row group are 16 consecutive lanes of one warp.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Forward, f32: block (query tile, batch x head).  Thread (ty, tx) owns
// query rows 4 ty .. 4 ty + 3 and, of each key tile and of the output, the
// columns tx + 16 j.
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg, int heads, int t,
                 float scale, float* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* ps = vs + kTile * kLd;
  __shared__ int segk[kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  load_tile(qs, q + head, q0, t);
  int segq[kR];
  float m[kR], l[kR], acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + kR * ty + i;
    segq[i] = r < t ? sg[r] : 0;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    load_tile(ks, k + head, k0, t);
    load_tile(vs, v + head, k0, t);
    if (threadIdx.x < kTile) segk[threadIdx.x] = k0 + threadIdx.x < t ? sg[k0 + threadIdx.x] : 0;
    __syncthreads();
    float s[kR][kR];
    tile_qk(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = k0 + c < t ? s[i][j] * scale + (segq[i] == segk[c] ? 0.f : kMask)
                             : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));  // finite: key k0 exists
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(kR * ty + i) * kLd + tx + 16 * j] = p;
        acc[i][j] *= alpha;
      }
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();
    tile_pv(acc, ps, vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + kR * ty + i;
    if (r >= t) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < kR; ++j) st(o + head + (size_t)r * kD + tx + 16 * j, acc[i][j] * inv);
    if (lse != nullptr && tx == 0) lse[(size_t)bh * t + r] = m[i] + logf(l[i]);
  }
}

// dk, dv: block (key tile, batch x head).  Thread (ty, tx) owns key rows
// 4 ty .. 4 ty + 3 and, of each query tile and of dk and dv, the columns
// tx + 16 j.  P^T and dS^T of a query tile go through shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, const float* __restrict__ lse,
                 const T* __restrict__ dout, const float* __restrict__ di, int heads, int t,
                 float scale, T* __restrict__ dk, T* __restrict__ dv) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* pt = dos + kTile * kLd;
  float* dst = pt + kTile * kLd;
  __shared__ int segq[kTile];
  __shared__ float lse_s[kTile], di_s[kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / heads;
  const int k0 = blockIdx.x * kTile;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  load_tile(ks, k + head, k0, t);
  load_tile(vs, v + head, k0, t);
  int segk[kR];
  float dka[kR][kR], dva[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = k0 + kR * ty + i;
    segk[i] = r < t ? sg[r] : 0;
#pragma unroll
    for (int j = 0; j < kR; ++j) dka[i][j] = dva[i][j] = 0.f;
  }
  for (int q0 = 0; q0 < t; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_tile(qs, q + head, q0, t);
    load_tile(dos, dout + head, q0, t);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      segq[threadIdx.x] = r < t ? sg[r] : 0;
      lse_s[threadIdx.x] = r < t ? lse[(size_t)bh * t + r] : 0.f;
      di_s[threadIdx.x] = r < t ? di[(size_t)bh * t + r] : 0.f;
    }
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    tile_qk(s, ks, qs, ty, tx);
    tile_qk(dp, vs, dos, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const bool kvalid = k0 + kR * ty + i < t;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = tx + 16 * j;
        const float logit = s[i][j] * scale + (segk[i] == segq[c] ? 0.f : kMask);
        const float p = kvalid && q0 + c < t ? expf(logit - lse_s[c]) : 0.f;
        const float ds = (dp[i][j] - di_s[c]) * p * scale;
        pt[(kR * ty + i) * kLd + c] = rnd<T>(p);
        dst[(kR * ty + i) * kLd + c] = rnd<T>(ds);
      }
    }
    __syncthreads();
    tile_pv(dva, pt, dos, ty, tx);
    tile_pv(dka, dst, qs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = k0 + kR * ty + i;
    if (r >= t) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      st(dk + head + (size_t)r * kD + tx + 16 * j, dka[i][j]);
      st(dv + head + (size_t)r * kD + tx + 16 * j, dva[i][j]);
    }
  }
}

// dq: block (query tile, batch x head), shaped like the forward; dS of a key
// tile goes through shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ seg, const float* __restrict__ lse,
                const T* __restrict__ dout, const float* __restrict__ di, int heads, int t,
                float scale, T* __restrict__ dq) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* dss = vs + kTile * kLd;
  __shared__ int segk[kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * kTile;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  load_tile(qs, q + head, q0, t);
  load_tile(dos, dout + head, q0, t);
  int segq[kR];
  float lse_r[kR], di_r[kR], acc[kR][kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + kR * ty + i;
    segq[i] = r < t ? sg[r] : 0;
    lse_r[i] = r < t ? lse[(size_t)bh * t + r] : 0.f;
    di_r[i] = r < t ? di[(size_t)bh * t + r] : 0.f;
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_tile(ks, k + head, k0, t);
    load_tile(vs, v + head, k0, t);
    if (threadIdx.x < kTile) segk[threadIdx.x] = k0 + threadIdx.x < t ? sg[k0 + threadIdx.x] : 0;
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    tile_qk(s, qs, ks, ty, tx);
    tile_qk(dp, dos, vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const bool qvalid = q0 + kR * ty + i < t;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int c = tx + 16 * j;
        const float logit = s[i][j] * scale + (segq[i] == segk[c] ? 0.f : kMask);
        const float p = qvalid && k0 + c < t ? expf(logit - lse_r[i]) : 0.f;
        dss[(kR * ty + i) * kLd + c] = rnd<T>((dp[i][j] - di_r[i]) * p * scale);
      }
    }
    __syncthreads();
    tile_pv(acc, dss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + kR * ty + i;
    if (r >= t) continue;
#pragma unroll
    for (int j = 0; j < kR; ++j) st(dq + head + (size_t)r * kD + tx + 16 * j, acc[i][j]);
  }
}

// Forward on the tensor cores, for bf16: mma.sync m16n8k16 (bf16 operands,
// f32 accumulation).  Block (query tile of 128, batch x head), 8 warps of
// 16 query rows each.  A warp keeps its Q fragments in registers for the whole
// key loop; per 64-key tile it forms S (16 x 64) in the mma accumulator
// layout, runs the online softmax on it (a row's 16 values per thread
// reduced over the 4 lanes of a quad), and reuses the accumulator of two
// neighbouring 8-key column tiles directly as the A fragment of P.V, P
// rounded to bf16 as it is packed.  K and V are staged row-major; the B
// fragments of P.V come from V by ldmatrix.trans.  The softmax runs in base
// 2 (scores times sm_scale * log2(e), exp2f: the same P up to an ulp, and
// cheaper than expf, whose instruction count rivals the mma at head dim 64).
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows of a block
constexpr int kLdh = kD + 8;  // bf16 row of a staged tile: 144 bytes, no bank conflicts

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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane i gives the
// address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Rows [r0, r0 + rows) of one (T, 64) bf16 head into a shared tile with
// row stride kLdh, zeros past T; 32-bit copies.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* __restrict__ src, int r0,
                                               int t, int rows) {
  for (int e = threadIdx.x; e < rows * kD / 2; e += kMmaThreads) {
    const int r = e / (kD / 2), w = e % (kD / 2);
    const uint32_t val =
        r0 + r < t ? *reinterpret_cast<const uint32_t*>(src + (size_t)(r0 + r) * kD + 2 * w) : 0u;
    *reinterpret_cast<uint32_t*>(dst + r * kLdh + 2 * w) = val;
  }
}

__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg, int heads,
                     int t, float scale, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse) {
  __shared__ __align__(16) __nv_bfloat16 qs[kMmaRows * kLdh];
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kLdh];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kLdh];
  __shared__ int segk[kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3;  // mma group (row) and thread in group
  const int bh = blockIdx.y, b = bh / heads;
  const int q0 = blockIdx.x * kMmaRows;
  const size_t head = (size_t)bh * t * kD;
  const int* sg = seg + (size_t)b * t;
  const float scale_log2 = scale * 1.44269504088896341f;  // log2(e)
  load_tile_bf16(qs, q + head, q0, t, kMmaRows);
  __syncthreads();
  const int r0 = warp * 16;  // this warp's rows within the tile
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const __nv_bfloat16* row_lo = qs + (r0 + g) * kLdh + kk * 16 + 2 * tg;
    const __nv_bfloat16* row_hi = row_lo + 8 * kLdh;
    qa[kk][0] = lds32(row_lo);
    qa[kk][1] = lds32(row_hi);
    qa[kk][2] = lds32(row_lo + 8);
    qa[kk][3] = lds32(row_hi + 8);
  }
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  int segq[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    segq[h] = rows[h] < t ? sg[rows[h]] : 0;
    m[h] = -CUDART_INF_F;
    l[h] = 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();  // the previous tile's ks and vs are consumed
    load_tile_bf16(ks, k + head, k0, t, kTile);
    load_tile_bf16(vs, v + head, k0, t, kTile);
    if (threadIdx.x < kTile) segk[threadIdx.x] = k0 + threadIdx.x < t ? sg[k0 + threadIdx.x] : 0;
    __syncthreads();
    // S = Q K^T: 8 column tiles of 8 keys; element e of tile j is row
    // g + 8 (e >> 1), key 8 j + 2 tg + (e & 1)
    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* krow = ks + (8 * j + g) * kLdh + 2 * tg;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        mma_bf16(s[j], qa[kk], lds32(krow + kk * 16), lds32(krow + kk * 16 + 8));
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tg + (e & 1);
        const int h = e >> 1;
        s[j][e] = k0 + c < t ? s[j][e] * scale_log2 + (segq[h] == segk[c] ? 0.f : kMask)
                             : -CUDART_INF_F;
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: key k0 exists
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);  // P, unrounded for the row sum
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    // O += P V: the accumulators of key tiles 2 kk and 2 kk + 1 are the A
    // fragment of keys 16 kk .. 16 kk + 15; one ldmatrix.trans gives the B
    // fragments of two 8-wide d tiles (lanes 0-15: keys 16 kk + lane % 16
    // at d 16 jp, lanes 16-31: the same keys at d 16 jp + 8)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < kD / 16; ++jp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 15)) * kLdh + 16 * jp + 8 * (lane >> 4));
        mma_bf16(acc[2 * jp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * jp + 1], pa, vb[2], vb[3]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= t) continue;
    const float inv = 1.f / l[h];
    __nv_bfloat16* orow = o + head + (size_t)rows[h] * kD + 2 * tg;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    if (lse != nullptr && tg == 0)
      lse[(size_t)bh * t + rows[h]] = (m[h] + log2f(l[h])) * 0.693147180559945309f;
  }
}

template <typename K, typename... Args>
int launch(K kernel, int tiles, int batch, int heads, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = atk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, batch * heads), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int heads, int t, int dh) {
  return batch <= 0 || heads <= 0 || t <= 0 || dh != kD || batch * heads > 65535;
}

}  // namespace

// B5 forward.  lse is null (no residual) or the (B, nh, T) row logsumexp.
ATK_EXPORT int atk_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                             int batch, int heads, int t, int dh, float scale, int bf16,
                             void* o, float* lse, void* stream) {
  if (bad_shape(batch, heads, t, dh)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    using T = __nv_bfloat16;
    const int tiles = (t + kMmaRows - 1) / kMmaRows;
    flash_fwd_mma_kernel<<<dim3(tiles, batch * heads), kMmaThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg, heads,
        t, scale, static_cast<T*>(o), lse);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (t + kTile - 1) / kTile;
  return launch(flash_fwd_kernel, tiles, batch, heads, 4 * kTileBytes, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), seg, heads, t, scale, static_cast<float*>(o), lse);
}

// B5 backward, dk and dv.
ATK_EXPORT int atk_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* seg,
                                 const float* lse, const void* dout, const float* di,
                                 int batch, int heads, int t, int dh, float scale, int bf16,
                                 void* dk, void* dv, void* stream) {
  if (bad_shape(batch, heads, t, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (t + kTile - 1) / kTile;
  const size_t smem = 6 * kTileBytes;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(flash_dkv_kernel<T>, tiles, batch, heads, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  seg, lse, static_cast<const T*>(dout), di, heads, t, scale,
                  static_cast<T*>(dk), static_cast<T*>(dv));
  }
  return launch(flash_dkv_kernel<float>, tiles, batch, heads, smem, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), seg, lse, static_cast<const float*>(dout), di,
                heads, t, scale, static_cast<float*>(dk), static_cast<float*>(dv));
}

// B5 backward, dq.
ATK_EXPORT int atk_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg,
                                const float* lse, const void* dout, const float* di,
                                int batch, int heads, int t, int dh, float scale, int bf16,
                                void* dq, void* stream) {
  if (bad_shape(batch, heads, t, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (t + kTile - 1) / kTile;
  const size_t smem = 5 * kTileBytes;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(flash_dq_kernel<T>, tiles, batch, heads, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  seg, lse, static_cast<const T*>(dout), di, heads, t, scale,
                  static_cast<T*>(dq));
  }
  return launch(flash_dq_kernel<float>, tiles, batch, heads, smem, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), seg, lse, static_cast<const float*>(dout), di,
                heads, t, scale, static_cast<float*>(dq));
}
