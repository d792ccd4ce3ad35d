// Blocked (flash) attention on Hopper: a forward and a backward on two
// routes, tensor cores for bf16 and SIMT for f32.
//
//   forward:  O = softmax(scale * Q K^T + mask) V, streamed over key blocks
//             with an f32 running max m, normaliser l and accumulator; also
//             lse = m + log l per row (f32, natural log), which the
//             backward needs.
//   backward: P = exp(scale * Q K^T - lse) on the visible pairs,
//             Delta = rowsum(dO * O), dS = P * (dO V^T - Delta),
//             dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO
//             (FlashAttention-2's split: one kernel for dQ and Delta by
//             query block, one for dK/dV by key block; no atomics).
//
// q (B,H,S,D), k/v (B,K,S,D) with H % K == 0 (q head h reads kv head
// h / (H/K)); any strides in elements, the last axis contiguous, so the
// model's (B,S,H,D) projections are read in place; outputs in the inputs'
// type.  A mask: key j is visible to query i if j < S, and j <= i
// (causal), and i - j < window (window > 0).  Masked scores are -1e30 and
// their probabilities zeroed, so a fully masked row outputs 0 (lse +inf);
// key blocks with no visible pair are skipped.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (line 86; body _flash_kernel at line 27, pallas_call at line 113): the
// attention of every dense self-attention sequence forward (probe, update,
// eval).  The reference has no backward kernel (XLA differentiates
// attend_full); the backward kernels here are the port's own.
//
// What bounds it on the card: at the main path's shape (B 4, S 1024, H 32,
// K 4, D 64, bf16, causal) the forward needs 17.2 GFLOP (the causal half of
// QK^T and PV) against 38 MB of traffic, the backward's five products 42.9
// GFLOP: both are bound by the tensor cores' operations (17 us and 43 us at
// 989 TFLOP/s bf16), never by memory.  So every bf16 product has to run on
// the tensor cores, and what limits a warp-level design is then how fast
// shared memory feeds them and how well the blocks fill the 132 SMs.
//
// The tensor-core route (bf16, D <= 128, D % 8 == 0), FlashAttention-2's
// design on mma.sync (the warpgroup wgmma/TMA design is a later step):
//   * every product is mma.sync m16n8k16 bf16 x bf16 -> f32 (mma_sm90.cuh):
//     S = Q K^T in f32 from exact bf16 products; P (forward, dK/dV) and dS
//     are rounded to bf16 as operands of the next product, as SDPA's
//     kernels do, and accumulate in f32.  A product's C fragments are the
//     next product's A fragment, so S, P and dS never leave registers;
//   * 4 warps a block, 16 rows each; tiles are staged in bf16 shared memory
//     with 16-byte cp.async into a two-stage ring (the next tile's copy
//     overlaps this tile's products), rows padded by 16 bytes so that
//     ldmatrix (plain for K-major operands, .trans for V, dO and Q as the
//     right factor) reads 8 rows on 8 distinct bank groups.  Head dims
//     below 64 / 128 are zero-filled by the copy (exact zeros in the sums);
//   * the softmax works on raw scores with one FFMA into ex2.approx
//     (scale * log2e folded in); lse is written back in natural log.  Tiles
//     a warp sees whole skip the mask; masked ones apply it per score;
//   * forward: a block owns 64 query rows of one (batch, q head) and walks
//     64-key blocks, query blocks heaviest first under a causal mask.  At
//     D 64 it is held to 128 registers, four blocks an SM;
//   * dQ: a block owns 64 query rows, holds Q and dO as A fragments, walks
//     32-key blocks and writes Delta (B,H,S) f32 first (128 registers at
//     D 64);
//   * dK/dV: a block owns 64 keys of one kv head and walks (q head, query
//     block) tiles of its group, 64 queries (32 at D 128), through the
//     ring; the key blocks are dispatched heaviest first.  Under a causal
//     mask the first key block does S/64 times the last one's work, so a
//     grid that only fills the SMs' two resident slots waits on its
//     heaviest blocks: the wrapper splits each group into `parts` until the
//     grid has twice as many blocks as SMs (the seq-128 round has 32
//     blocks unsplit, S 1024 256).  Each part sums its q heads into an f32
//     scratch slice, and a second kernel sums the slices in order.  Every
//     sum has a fixed order and there are no atomics, so two launches
//     agree bit for bit, as the (P1) masks need.
//
// The SIMT route (f32 inputs at any D <= 256, and bf16 above D 128 or at a
// D that is not a multiple of 8), the port's first kernels, exact in f32:
//   * one block owns one (batch, head, query block) and loops over the key
//     blocks, m, l and the accumulator in registers;
//   * tiles of BQ x BK = 64 x 64 for head dims up to 128 and 32 x 32 up to
//     256, staged in f32 shared memory (rows padded by one float).  Head
//     dims below a tile width are zero-padded; 256 threads, each owning a
//     strided 4 x 4 (or 2 x 2) sub-tile of the scores;
//   * row max and row sum by shuffles inside a half warp; expf/logf;
//   * the dK/dV kernel loops over its kv head's group of q heads and the
//     query blocks that see its key block; fixed sum orders.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes
// the split's scratch), returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 16;                 // 16 x 16 threads over a tile
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

template <int DT> struct Tile { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

struct View { long long b, h, s; };    // element strides of a (B,H,S,D) view

struct Args {
  const void* q; const void* k; const void* v; const void* o; const void* dO;
  void* out;                            // forward: O
  float* lse; float* delta;
  void* dq; void* dk; void* dv;
  int H, S, D, group, causal, window;
  float scale;
  View qs, ks, vs, os, dos, dqs, dks, dvs;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Sum and max over the 16 threads of a half warp (one row of a tile).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kT / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kT / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Does the query block at q0 see any key of the key block at k0?  As
// _flash_kernel: k_min <= q_max (causal) and q_min - k_max < window.
__device__ __forceinline__ bool block_needed(const Args& a, int q0, int bq,
                                             int k0, int bk) {
  bool need = true;
  if (a.causal) need = k0 <= q0 + bq - 1;
  if (a.window) need = need && (q0 - (k0 + bk - 1) < a.window);
  return need;
}

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return i < a.S && j < a.S && (!a.causal || j <= i)
         && (!a.window || i - j < a.window);
}

// Stage rows [r0, r0 + R) of one head's (S, D) slice into dst[R][DT + 1] in
// f32; rows past S and columns past D are 0.
template <typename T, int DT>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long s_stride, int r0, int R,
                                      const Args& a) {
  for (int e = threadIdx.x; e < R * DT; e += kThreads) {
    const int r = e / DT, d = e - r * DT;
    const int row = r0 + r;
    dst[r * (DT + 1) + d] =
        (row < a.S && d < a.D) ? to_f32(src[row * s_stride + d]) : 0.f;
  }
}

template <int DT>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((Tile<DT>::BQ + 2 * Tile<DT>::BK) * (DT + 1)
                          + Tile<DT>::BQ * (Tile<DT>::BK + 1));
}
template <int DT>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (Tile<DT>::BQ + Tile<DT>::BK) * (DT + 1)
                          + Tile<DT>::BQ * (Tile<DT>::BK + 1)
                          + 2 * Tile<DT>::BQ);
}
template <int DT>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * (Tile<DT>::BQ + Tile<DT>::BK) * (DT + 1)
                          + 2 * Tile<DT>::BK * (Tile<DT>::BQ + 1)
                          + 2 * Tile<DT>::BQ);
}

// ---------------------------------------------------------------------------
// Forward: one block per (query block, q head, batch)
// ---------------------------------------------------------------------------
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int BQ = Tile<DT>::BQ, BK = Tile<DT>::BK;
  constexpr int R = BQ / kT, C = BK / kT, M = DT / kT;
  constexpr int LD = DT + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                    // [BQ][LD]
  float* sK = sQ + BQ * LD;            // [BK][LD]
  float* sV = sK + BK * LD;            // [BK][LD]
  float* sP = sV + BK * LD;            // [BQ][LP]

  const int qb = gridDim.x - 1 - blockIdx.x;        // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  const int q0 = qb * BQ;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;

  stage<T, DT>(sQ, qg, a.qs.s, q0, BQ, a);

  float m[R], l[R], acc[R][M];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < M; ++c) acc[i][c] = 0.f;
  }

  const int nk = (a.S + BK - 1) / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    if (!block_needed(a, q0, BQ, k0, BK)) continue;   // uniform per block
    __syncthreads();                   // the last block's reads are done
    stage<T, DT>(sK, kg, a.ks.s, k0, BK, a);
    stage<T, DT>(sV, vg, a.vs.s, k0, BK, a);
    __syncthreads();

    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      float qv[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = sQ[(ty + kT * i) * LD + d];
#pragma unroll
      for (int j = 0; j < C; ++j) kv[j] = sK[(tx + kT * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + kT * i;
      bool ok[C];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        ok[j] = visible(a, q0 + r, k0 + tx + kT * j);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[r * LP + tx + kT * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(rs);
#pragma unroll
      for (int c = 0; c < M; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[R], vv[M];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = sP[(ty + kT * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < M; ++c) vv[c] = sV[kk * LD + tx + kT * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < M; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* og = static_cast<T*>(a.out) + b * a.os.b + h * a.os.h;
  float* lse = a.lse + ((long long)b * a.H + h) * a.S;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + kT * i;
    if (qi >= a.S) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const int d = tx + kT * c;
      if (d < a.D) store(og + qi * a.os.s + d, acc[i][c] / den);
    }
    if (tx == 0) lse[qi] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ (and Delta): one block per (query block, q head, batch)
// ---------------------------------------------------------------------------
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Args a) {
  constexpr int BQ = Tile<DT>::BQ, BK = Tile<DT>::BK;
  constexpr int R = BQ / kT, C = BK / kT, M = DT / kT;
  constexpr int LD = DT + 1, LP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                    // [BQ][LD]
  float* sdO = sQ + BQ * LD;           // [BQ][LD]
  float* sK = sdO + BQ * LD;           // [BK][LD]
  float* sV = sK + BK * LD;            // [BK][LD]
  float* sdS = sV + BK * LD;           // [BQ][LP]
  float* s_lse = sdS + BQ * LP;        // [BQ]
  float* s_delta = s_lse + BQ;         // [BQ]

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  const int q0 = qb * BQ;
  const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* og = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h;
  const T* dog = static_cast<const T*>(a.dO) + b * a.dos.b + h * a.dos.h;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;
  const long long row0 = ((long long)b * a.H + h) * a.S;

  stage<T, DT>(sQ, qg, a.qs.s, q0, BQ, a);
  stage<T, DT>(sdO, dog, a.dos.s, q0, BQ, a);
  __syncthreads();

  // Delta = rowsum(dO * O): each half warp sums its row in a fixed order.
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + kT * i, qi = q0 + r;
    float part = 0.f;
    if (qi < a.S) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const int d = tx + kT * c;
        if (d < a.D) part += sdO[r * LD + d] * to_f32(og[qi * a.os.s + d]);
      }
    }
    part = row_sum(part);
    if (tx == 0) {
      s_delta[r] = part;
      s_lse[r] = qi < a.S ? a.lse[row0 + qi] : INFINITY;
      if (qi < a.S) a.delta[row0 + qi] = part;
    }
  }

  float dq[R][M];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < M; ++c) dq[i][c] = 0.f;

  const int nk = (a.S + BK - 1) / BK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    if (!block_needed(a, q0, BQ, k0, BK)) continue;
    __syncthreads();
    stage<T, DT>(sK, kg, a.ks.s, k0, BK, a);
    stage<T, DT>(sV, vg, a.vs.s, k0, BK, a);
    __syncthreads();

    float s[R][C], dp[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DT; ++d) {
      float qv[R], ov[R], kv[C], vv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = sQ[(ty + kT * i) * LD + d];
        ov[i] = sdO[(ty + kT * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        kv[j] = sK[(tx + kT * j) * LD + d];
        vv[j] = sV[(tx + kT * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + kT * i;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = tx + kT * j;
        const float p = visible(a, q0 + r, k0 + c)
                            ? expf(s[i][j] * a.scale - s_lse[r]) : 0.f;
        sdS[r * LP + c] = p * (dp[i][j] - s_delta[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[R], kv[M];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = sdS[(ty + kT * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < M; ++c) kv[c] = sK[kk * LD + tx + kT * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < M; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
    }
  }

  T* dqg = static_cast<T*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + kT * i;
    if (qi >= a.S) continue;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const int d = tx + kT * c;
      if (d < a.D) store(dqg + qi * a.dqs.s + d, dq[i][c] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dK and dV: one block per (key block, kv head, batch), looping
// over the kv head's group of q heads and the query blocks that see it
// ---------------------------------------------------------------------------
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(const Args a) {
  constexpr int BQ = Tile<DT>::BQ, BK = Tile<DT>::BK;
  constexpr int CI = BK / kT, RJ = BQ / kT, M = DT / kT;
  constexpr int LD = DT + 1, LQ = BQ + 1;
  extern __shared__ float smem[];
  float* sK = smem;                    // [BK][LD]
  float* sV = sK + BK * LD;            // [BK][LD]
  float* sQ = sV + BK * LD;            // [BQ][LD]
  float* sdO = sQ + BQ * LD;           // [BQ][LD]
  float* sP = sdO + BQ * LD;           // [BK][LQ]  P^T
  float* sdS = sP + BK * LQ;           // [BK][LQ]  dS^T
  float* s_lse = sdS + BK * LQ;        // [BQ]
  float* s_delta = s_lse + BQ;         // [BQ]

  const int kb = blockIdx.x;           // causal: low key blocks are heaviest
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % kT, ty = threadIdx.x / kT;
  const int k0 = kb * BK;
  const T* kg = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* vg = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;

  stage<T, DT>(sK, kg, a.ks.s, k0, BK, a);
  stage<T, DT>(sV, vg, a.vs.s, k0, BK, a);

  float dk[CI][M], dv[CI][M];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int c = 0; c < M; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (a.S + BQ - 1) / BQ;
  for (int g = 0; g < a.group; ++g) {
    const int h = kh * a.group + g;
    const T* qg = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* dog = static_cast<const T*>(a.dO) + b * a.dos.b + h * a.dos.h;
    const long long row0 = ((long long)b * a.H + h) * a.S;
    for (int qb = 0; qb < nq; ++qb) {
      const int q0 = qb * BQ;
      if (!block_needed(a, q0, BQ, k0, BK)) continue;
      __syncthreads();
      stage<T, DT>(sQ, qg, a.qs.s, q0, BQ, a);
      stage<T, DT>(sdO, dog, a.dos.s, q0, BQ, a);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int qi = q0 + r;
        s_lse[r] = qi < a.S ? a.lse[row0 + qi] : INFINITY;
        s_delta[r] = qi < a.S ? a.delta[row0 + qi] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: thread rows are keys (ty), columns queries (tx)
      float st[CI][RJ], dpt[CI][RJ];
#pragma unroll
      for (int i = 0; i < CI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DT; ++d) {
        float kv[CI], vv[CI], qv[RJ], ov[RJ];
#pragma unroll
        for (int i = 0; i < CI; ++i) {
          kv[i] = sK[(ty + kT * i) * LD + d];
          vv[i] = sV[(ty + kT * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          qv[j] = sQ[(tx + kT * j) * LD + d];
          ov[j] = sdO[(tx + kT * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < CI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < CI; ++i) {
        const int c = ty + kT * i;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int r = tx + kT * j;
          const float p = visible(a, q0 + r, k0 + c)
                              ? expf(st[i][j] * a.scale - s_lse[r]) : 0.f;
          sP[c * LQ + r] = p;
          sdS[c * LQ + r] = p * (dpt[i][j] - s_delta[r]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int rr = 0; rr < BQ; ++rr) {
        float pv[CI], dsv[CI], ov[M], qv[M];
#pragma unroll
        for (int i = 0; i < CI; ++i) {
          pv[i] = sP[(ty + kT * i) * LQ + rr];
          dsv[i] = sdS[(ty + kT * i) * LQ + rr];
        }
#pragma unroll
        for (int c = 0; c < M; ++c) {
          ov[c] = sdO[rr * LD + tx + kT * c];
          qv[c] = sQ[rr * LD + tx + kT * c];
        }
#pragma unroll
        for (int i = 0; i < CI; ++i)
#pragma unroll
          for (int c = 0; c < M; ++c) {
            dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
          }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + b * a.dks.b + kh * a.dks.h;
  T* dvg = static_cast<T*>(a.dv) + b * a.dvs.b + kh * a.dvs.h;
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int kj = k0 + ty + kT * i;
    if (kj >= a.S) continue;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const int d = tx + kT * c;
      if (d < a.D) {
        store(dkg + kj * a.dks.s + d, dk[i][c] * a.scale);
        store(dvg + kj * a.dvs.s + d, dv[i][c]);
      }
    }
  }
}


// ===========================================================================
// The tensor-core route: bf16, D <= 128, D % 8 == 0
// ===========================================================================
template <typename Kernel, typename... Ts>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const Ts&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

namespace tc {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;          // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile shapes: 4 warps a block, each owning 16 rows (queries in the
// forward and dQ, keys in dK/dV) and the whole other side of the tile.
// Chosen on an H100 at the main path's shape (PERF.md): at D 64 the
// forward and dQ kernels are held to 128 registers so that four blocks
// share an SM, which hides more latency than larger tiles in fewer blocks
// did; at D 128 that would spill.
template <int DT> struct FwdTile {
  static constexpr int BQ = 64, BK = 64, MIN_BLOCKS = DT <= 64 ? 4 : 1;
};
template <int DT> struct DqTile {
  static constexpr int BQ = 64, BK = 32, MIN_BLOCKS = DT <= 64 ? 4 : 1;
};
template <int DT> struct DkvTile {
  static constexpr int BK = 64, BQ = DT <= 64 ? 64 : 32;
};

// Copy rows [r0, r0 + R) of one head's (S, D) slice into dst[R][DT + 8]
// with 16-byte cp.async; rows past S and columns past D are zero-filled.
template <int R, int DT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long s_stride, int r0,
                                          const Args& a) {
  constexpr int CH = DT / 8, LD = DT + 8;
  static_assert(R * CH % kThreads == 0, "tile not a multiple of the block");
#pragma unroll
  for (int i = 0; i < R * CH / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / CH, c = e - r * CH, row = r0 + r;
    const int bytes = row < a.S ? max(0, min(16, 2 * (a.D - 8 * c))) : 0;
    const bf16* s = bytes ? src + row * s_stride + 8 * c : src;
    cp_async16(smem_addr(dst + r * LD + 8 * c), s, bytes);
  }
}

// Are all pairs of the tile real and visible (no mask to apply)?
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int bq,
                                          int k0, int bk) {
  return q0 + bq <= a.S && k0 + bk <= a.S
         && (!a.causal || k0 + bk - 1 <= q0)
         && (!a.window || q0 + bq - 1 - k0 < a.window);
}

// The blocks [lo, hi) of `step` rows along one axis that meet a fixed block
// on the other (contiguous: the causal mask and the window each cut one
// end).  keys: the key blocks that the query block (q0, bq) sees; else the
// query blocks that see the key block (q0 = k0, bq = bk).
template <bool keys>
__device__ __forceinline__ void block_range(const Args& a, int r0, int rn,
                                            int step, int& lo, int& hi) {
  auto need = [&](int i) {
    return keys ? block_needed(a, r0, rn, i * step, step)
                : block_needed(a, i * step, step, r0, rn);
  };
  lo = 0;
  hi = (a.S + step - 1) / step;
  while (lo < hi && !need(lo)) ++lo;
  while (hi > lo && !need(hi - 1)) --hi;
}

// Lane l's element offset inside the 16 x 16 block of a [rows][LD] tile
// that one ldmatrix.x4 reads: an A fragment (16 rows x 16 k, row-major),
// the B fragments of two n-tiles from an [n][k] tile (plain), or from a
// [k][n] tile (.trans).  A fragment at (r0, c0) is then at
// base + 2 * (lane offset + r0 * LD + c0) bytes, a constant per fragment.
__device__ __forceinline__ int lane_a(int l, int LD) {
  return (l & 15) * LD + (l >> 4) * 8;
}
__device__ __forceinline__ int lane_bn(int l, int LD) {
  return ((l & 7) + (l >> 4) * 8) * LD + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ int lane_bk(int l, int LD) {
  return ((l & 7) + ((l >> 3) & 1) * 8) * LD + (l >> 4) * 8;
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One key block of the online softmax for one m16 tile of rows: s holds
// the raw scores QK^T on entry and P on exit; m (log2 units), l and o are
// rescaled.  kMasked: bit 4 nt + i of ok says the pair is visible; masked
// scores are -1e30 and their probabilities 0.
template <bool kMasked, int NT, int DN>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2], float (&o)[DN][4],
                                             uint32_t ok, float sl2) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * hr + e;
        if (kMasked && !((ok >> (nt * 4 + i)) & 1)) s[nt][i] = kNegInf;
        mx = fmaxf(mx, s[nt][i]);
      }
    mx = fmaxf(m[hr], quad_max(mx) * sl2);
    const float alpha = exp2_approx(m[hr] - mx);
    m[hr] = mx;
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * hr + e;
        float p = exp2_approx(fmaf(s[nt][i], sl2, -mx));
        if (kMasked && !((ok >> (nt * 4 + i)) & 1)) p = 0.f;
        s[nt][i] = p;
        rs += p;
      }
    l[hr] = l[hr] * alpha + rs;        // this lane's share of the row
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][2 * hr] *= alpha;
      o[dn][2 * hr + 1] *= alpha;
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (query block, q head, batch)
// ---------------------------------------------------------------------------
template <int DT>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (FwdTile<DT>::BQ + 4 * FwdTile<DT>::BK) * (DT + 8);
}

template <int DT>
__global__ void __launch_bounds__(kThreads, FwdTile<DT>::MIN_BLOCKS)
flash_fwd_mma_kernel(const Args a) {
  constexpr int BQ = FwdTile<DT>::BQ, BK = FwdTile<DT>::BK, LD = DT + 8;
  constexpr int KT = DT / 16, NT = BK / 8, DN = DT / 8;
  static_assert(NT * 4 <= 32, "one visibility bit per score of a lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                         // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;                     // [2][BK][LD]

  const int lane = threadIdx.x % 32, w0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, t = lane % 4;
  const int qb = gridDim.x - 1 - blockIdx.x;       // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const int q0 = qb * BQ, r0 = q0 + w0;            // r0: this warp's rows
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + kh * a.vs.h;

  int lo, hi;
  block_range<true>(a, q0, BQ, BK, lo, hi);
  load_tile<BQ, DT>(sQ, qg, a.qs.s, q0, a);
  if (lo < hi) {
    load_tile<BK, DT>(sK, kg, a.ks.s, lo * BK, a);
    load_tile<BK, DT>(sV, vg, a.vs.s, lo * BK, a);
  }
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  // m: running max of the scores in log2 units (scale * log2e * s); l: this
  // lane's share of the running sum; o: the unnormalised output
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[DN][4] = {};
  uint32_t qf[KT][4];
  for (int kb = lo; kb < hi; ++kb) {
    const int st = (kb - lo) & 1, k0 = kb * BK;
    if (kb + 1 < hi) {
      load_tile<BK, DT>(sK + (st ^ 1) * BK * LD, kg, a.ks.s, k0 + BK, a);
      load_tile<BK, DT>(sV + (st ^ 1) * BK * LD, vg, a.vs.s, k0 + BK, a);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kb == lo) {
      const uint32_t sQA = smem_addr(sQ) + 2 * lane_a(lane, LD);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        ldsm_x4(qf[kt], sQA + 2 * (w0 * LD + kt * 16));
    }
    // a warp whose rows see no key of this block only waits for the others
    if (block_needed(a, r0, 16, k0, BK)) {
      const uint32_t cKN = smem_addr(sK + st * BK * LD)
                           + 2 * lane_bn(lane, LD);
      const uint32_t cVT = smem_addr(sV + st * BK * LD)
                           + 2 * lane_bk(lane, LD);
      float s[NT][4] = {};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, cKN + 2 * (np * 16 * LD + kt * 16));
          mma_bf16(s[2 * np], qf[kt], bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], qf[kt], bb[2], bb[3]);
        }

      if (tile_full(a, r0, 16, k0, BK)) {
        softmax_step<false>(s, m, l, o, 0u, sl2);
      } else {
        uint32_t ok = 0;               // bit 4 nt + i: pair visible
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (visible(a, r0 + g + (i >> 1) * 8,
                        k0 + nt * 8 + 2 * t + (i & 1)))
              ok |= 1u << (nt * 4 + i);
        softmax_step<true>(s, m, l, o, ok, sl2);
      }

#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, cVT + 2 * (j * 16 * LD + dp * 16));
          mma_bf16(o[2 * dp], pa, bb[0], bb[1]);
          mma_bf16(o[2 * dp + 1], pa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                   // this stage is free for kb + 2
  }
  cp_async_wait<0>();

  bf16* og = static_cast<bf16*>(a.out) + b * a.os.b + h * a.os.h;
  float* lse = a.lse + ((long long)b * a.H + h) * a.S;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lt = quad_sum(l[hr]);
    const int qi = r0 + g + hr * 8;
    if (qi >= a.S) continue;
    const float den = lt > 0.f ? lt : 1.f;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d < a.D)
        store2(og + qi * a.os.s + d, o[dn][2 * hr] / den,
               o[dn][2 * hr + 1] / den);
    }
    if (t == 0) lse[qi] = lt > 0.f ? m[hr] * kLn2 + logf(lt) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ (and Delta): one block per (query block, q head, batch)
// ---------------------------------------------------------------------------
template <int DT>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (2 * DqTile<DT>::BQ + 4 * DqTile<DT>::BK) * (DT + 8)
         + sizeof(float) * 2 * DqTile<DT>::BQ;
}

template <int DT>
__global__ void __launch_bounds__(kThreads, DqTile<DT>::MIN_BLOCKS)
flash_dq_mma_kernel(const Args a) {
  constexpr int BQ = DqTile<DT>::BQ, BK = DqTile<DT>::BK, LD = DT + 8;
  constexpr int KT = DT / 16, NT = BK / 8, DN = DT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* sdO = sQ + BQ * LD;                        // [BQ][LD]
  bf16* sK = sdO + BQ * LD;                        // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;                     // [2][BK][LD]
  float* s_lse = reinterpret_cast<float*>(sV + 2 * BK * LD);  // [BQ]
  float* s_dlt = s_lse + BQ;                                   // [BQ]

  const int lane = threadIdx.x % 32, w0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, t = lane % 4;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const int q0 = qb * BQ, r0 = q0 + w0;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* og = static_cast<const bf16*>(a.o) + b * a.os.b + h * a.os.h;
  const bf16* dog = static_cast<const bf16*>(a.dO) + b * a.dos.b
                    + h * a.dos.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + kh * a.vs.h;
  const long long row0 = ((long long)b * a.H + h) * a.S;

  int lo, hi;
  block_range<true>(a, q0, BQ, BK, lo, hi);
  load_tile<BQ, DT>(sQ, qg, a.qs.s, q0, a);
  load_tile<BQ, DT>(sdO, dog, a.dos.s, q0, a);
  if (lo < hi) {
    load_tile<BK, DT>(sK, kg, a.ks.s, lo * BK, a);
    load_tile<BK, DT>(sV, vg, a.vs.s, lo * BK, a);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Delta = rowsum(dO * O): two lanes a row, each half the columns in
  // order, then one add (commutative, so both lanes hold the same bits).
  {
    const int r = w0 + lane / 2, qi = q0 + r, c0 = (lane & 1) * (DT / 2);
    float part = 0.f;
    if (qi < a.S) {
#pragma unroll
      for (int c = c0; c < c0 + DT / 2; c += 8) {
        if (c >= a.D) break;
        const uint4 ov = *reinterpret_cast<const uint4*>(og + qi * a.os.s
                                                         + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(sdO + r * LD + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(
            &ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(
            &dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 of = __bfloat1622float2(o2[u]);
          const float2 df = __bfloat1622float2(d2[u]);
          part += df.x * of.x;
          part += df.y * of.y;
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((lane & 1) == 0) {
      s_dlt[r] = part;
      s_lse[r] = qi < a.S ? a.lse[row0 + qi] * kLog2e : INFINITY;
      if (qi < a.S) a.delta[row0 + qi] = part;
    }
  }
  __syncwarp();
  float lse2[2], dlt[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse2[hr] = s_lse[w0 + g + hr * 8];
    dlt[hr] = s_dlt[w0 + g + hr * 8];
  }
  uint32_t qf[KT][4], df[KT][4];
  const uint32_t sQA = smem_addr(sQ) + 2 * lane_a(lane, LD);
  const uint32_t sdOA = smem_addr(sdO) + 2 * lane_a(lane, LD);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    ldsm_x4(qf[kt], sQA + 2 * (w0 * LD + kt * 16));
    ldsm_x4(df[kt], sdOA + 2 * (w0 * LD + kt * 16));
  }

  const float sl2 = a.scale * kLog2e;
  float dq[DN][4] = {};
  for (int kb = lo; kb < hi; ++kb) {
    const int st = (kb - lo) & 1, k0 = kb * BK;
    if (kb + 1 < hi) {
      load_tile<BK, DT>(sK + (st ^ 1) * BK * LD, kg, a.ks.s, k0 + BK, a);
      load_tile<BK, DT>(sV + (st ^ 1) * BK * LD, vg, a.vs.s, k0 + BK, a);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (block_needed(a, r0, 16, k0, BK)) {
      const uint32_t kbase = smem_addr(sK + st * BK * LD);
      const uint32_t cKN = kbase + 2 * lane_bn(lane, LD);
      const uint32_t cKT = kbase + 2 * lane_bk(lane, LD);
      const uint32_t cVN = smem_addr(sV + st * BK * LD)
                           + 2 * lane_bn(lane, LD);
      float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, cKN + 2 * (np * 16 * LD + kt * 16));
          mma_bf16(s[2 * np], qf[kt], bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], qf[kt], bb[2], bb[3]);
          ldsm_x4(bb, cVN + 2 * (np * 16 * LD + kt * 16));
          mma_bf16(dp[2 * np], df[kt], bb[0], bb[1]);
          mma_bf16(dp[2 * np + 1], df[kt], bb[2], bb[3]);
        }
      // dS = P * (dP - Delta), P = 2^(s sl2 - lse log2e) on the visible
      auto ds = [&](auto masked) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int hr = i >> 1;
            float p = exp2_approx(fmaf(s[nt][i], sl2, -lse2[hr]));
            if (decltype(masked)::value
                && !visible(a, r0 + g + hr * 8, k0 + nt * 8 + 2 * t
                                                + (i & 1)))
              p = 0.f;
            s[nt][i] = p * (dp[nt][i] - dlt[hr]);
          }
      };
      if (tile_full(a, r0, 16, k0, BK))
        ds(std::false_type());
      else
        ds(std::true_type());
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        uint32_t da[4];
        c_to_a(da, s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int dn = 0; dn < DN / 2; ++dn) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, cKT + 2 * (j * 16 * LD + dn * 16));
          mma_bf16(dq[2 * dn], da, bb[0], bb[1]);
          mma_bf16(dq[2 * dn + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = r0 + g + hr * 8;
    if (qi >= a.S) continue;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + 2 * t;
      if (d < a.D)
        store2(dqg + qi * a.dqs.s + d, dq[dn][2 * hr] * a.scale,
               dq[dn][2 * hr + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dK and dV: one block per (key block, kv head and part of its
// group, batch), walking (q head, query block) tiles through the ring
// ---------------------------------------------------------------------------
struct Split {
  int parts;                 // q heads of a group split over this many blocks
  int kv;                    // K, the kv heads
  float* dk; float* dv;      // (parts, B, K, S, D) f32 scratch when parts > 1
};

template <int DT>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (2 * DkvTile<DT>::BK + 4 * DkvTile<DT>::BQ) * (DT + 8)
         + sizeof(float) * 4 * DkvTile<DT>::BQ;
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_mma_kernel(const Args a, const Split sp) {
  constexpr int BK = DkvTile<DT>::BK, BQ = DkvTile<DT>::BQ, LD = DT + 8;
  constexpr int KT = DT / 16, NQ = BQ / 8, DN = DT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD]
  bf16* sV = sK + BK * LD;                         // [BK][LD]
  bf16* sQ = sV + BK * LD;                         // [2][BQ][LD]
  bf16* sdO = sQ + 2 * BQ * LD;                    // [2][BQ][LD]
  float* s_lse = reinterpret_cast<float*>(sdO + 2 * BQ * LD);  // [2][BQ]
  float* s_dlt = s_lse + 2 * BQ;                                // [2][BQ]

  const int lane = threadIdx.x % 32, w0 = (threadIdx.x / 32) * 16;
  const int g = lane / 4, t = lane % 4;
  // x runs over (part, kv head, batch), y over the key blocks: under a
  // causal mask the low key blocks are the heaviest, and they go first
  const int kb = blockIdx.y, part = blockIdx.x % sp.parts;
  const int kh = blockIdx.x / sp.parts % sp.kv;
  const int b = blockIdx.x / (sp.parts * sp.kv);
  const int nb = gridDim.x / (sp.parts * sp.kv);
  const int per = a.group / sp.parts, h0 = kh * a.group + part * per;
  const int k0 = kb * BK, c0 = k0 + w0;           // c0: this warp's keys
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + kh * a.vs.h;

  int lo, hi;
  block_range<false>(a, k0, BK, BQ, lo, hi);
  const int nqb = hi - lo, tiles = per * nqb;

  auto stage = [&](int idx, int st) {
    const int h = h0 + idx / nqb, q0 = (lo + idx % nqb) * BQ;
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
    const bf16* dog = static_cast<const bf16*>(a.dO) + b * a.dos.b
                      + h * a.dos.h;
    load_tile<BQ, DT>(sQ + st * BQ * LD, qg, a.qs.s, q0, a);
    load_tile<BQ, DT>(sdO + st * BQ * LD, dog, a.dos.s, q0, a);
    const long long row0 = ((long long)b * a.H + h) * a.S;
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      const int qi = q0 + r, n = qi < a.S ? 4 : 0;
      cp_async4(smem_addr(s_lse + st * BQ + r), n ? a.lse + row0 + qi : a.lse,
                n);
      cp_async4(smem_addr(s_dlt + st * BQ + r),
                n ? a.delta + row0 + qi : a.delta, n);
    }
  };
  load_tile<BK, DT>(sK, kg, a.ks.s, k0, a);
  load_tile<BK, DT>(sV, vg, a.vs.s, k0, a);
  if (tiles > 0) stage(0, 0);
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float dk[DN][4] = {}, dv[DN][4] = {};
  for (int idx = 0; idx < tiles; ++idx) {
    const int st = idx & 1, q0 = (lo + idx % nqb) * BQ;
    if (idx + 1 < tiles) stage(idx + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (block_needed(a, q0, BQ, c0, 16)) {
      const uint32_t qbase = smem_addr(sQ + st * BQ * LD);
      const uint32_t obase = smem_addr(sdO + st * BQ * LD);
      const uint32_t cQN = qbase + 2 * lane_bn(lane, LD);
      const uint32_t cQT = qbase + 2 * lane_bk(lane, LD);
      const uint32_t cdON = obase + 2 * lane_bn(lane, LD);
      const uint32_t cdOT = obase + 2 * lane_bk(lane, LD);
      const uint32_t sKA = smem_addr(sK) + 2 * lane_a(lane, LD);
      const uint32_t sVA = smem_addr(sV) + 2 * lane_a(lane, LD);
      const float* cl = s_lse + st * BQ;
      const float* cd = s_dlt + st * BQ;

      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries
      float s[NQ][4] = {}, dp[NQ][4] = {};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, sKA + 2 * (w0 * LD + kt * 16));
        ldsm_x4(va, sVA + 2 * (w0 * LD + kt * 16));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, cQN + 2 * (np * 16 * LD + kt * 16));
          mma_bf16(s[2 * np], ka, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], ka, bb[2], bb[3]);
          ldsm_x4(bb, cdON + 2 * (np * 16 * LD + kt * 16));
          mma_bf16(dp[2 * np], va, bb[0], bb[1]);
          mma_bf16(dp[2 * np + 1], va, bb[2], bb[3]);
        }
      }
      // P^T = 2^(s sl2 - lse log2e) on the visible, dS^T = P^T (dP^T - Delta)
      auto pds = [&](auto masked) {
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = nt * 8 + 2 * t + (i & 1);
            float p = exp2_approx(fmaf(s[nt][i], sl2, -cl[c] * kLog2e));
            if (decltype(masked)::value
                && !visible(a, q0 + c, c0 + g + (i >> 1) * 8))
              p = 0.f;
            s[nt][i] = p;
            dp[nt][i] = p * (dp[nt][i] - cd[c]);
          }
      };
      if (tile_full(a, q0, BQ, c0, 16))
        pds(std::false_type());
      else
        pds(std::true_type());

      // dV += P^T dO, dK += dS^T Q: k runs over the queries
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * j], s[2 * j + 1]);
        c_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int dn = 0; dn < DN / 2; ++dn) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, cdOT + 2 * (j * 16 * LD + dn * 16));
          mma_bf16(dv[2 * dn], pa, bb[0], bb[1]);
          mma_bf16(dv[2 * dn + 1], pa, bb[2], bb[3]);
          ldsm_x4_trans(bb, cQT + 2 * (j * 16 * LD + dn * 16));
          mma_bf16(dk[2 * dn], da, bb[0], bb[1]);
          mma_bf16(dk[2 * dn + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = c0 + g + hr * 8;
    if (kj >= a.S) continue;
    if (sp.parts == 1) {
      bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dks.b + kh * a.dks.h
                  + kj * a.dks.s;
      bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dvs.b + kh * a.dvs.h
                  + kj * a.dvs.s;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int d = dn * 8 + 2 * t;
        if (d >= a.D) continue;
        store2(dkg + d, dk[dn][2 * hr] * a.scale, dk[dn][2 * hr + 1] * a.scale);
        store2(dvg + d, dv[dn][2 * hr], dv[dn][2 * hr + 1]);
      }
    } else {
      const long long off =
          ((((long long)part * nb + b) * sp.kv + kh) * a.S + kj) * a.D;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int d = dn * 8 + 2 * t;
        if (d >= a.D) continue;
        *reinterpret_cast<float2*>(sp.dk + off + d) =
            make_float2(dk[dn][2 * hr], dk[dn][2 * hr + 1]);
        *reinterpret_cast<float2*>(sp.dv + off + d) =
            make_float2(dv[dn][2 * hr], dv[dn][2 * hr + 1]);
      }
    }
  }
}

// The split's second pass: dK = scale * sum_p dK_p, dV = sum_p dV_p over
// the parts in order; one thread per 4 head-dim elements of a (b, kv head,
// key) row.
__global__ void __launch_bounds__(256)
flash_dkdv_reduce_kernel(const Args a, const Split sp, int B, int K) {
  const int q4 = a.D / 4;
  const long long n = (long long)B * K * a.S * q4;
  const long long slice = (long long)B * K * a.S * a.D;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / q4;                  // (b * K + kh) * S + s
    const int d = (int)(e - row * q4) * 4;
    const int s = (int)(row % a.S);
    const int kh = (int)((row / a.S) % K), b = (int)(row / a.S / K);
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int p = 0; p < sp.parts; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(sp.dk + p * slice
                                                        + row * a.D + d);
      const float4 y = *reinterpret_cast<const float4*>(sp.dv + p * slice
                                                        + row * a.D + d);
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dks.b + kh * a.dks.h
                + s * a.dks.s + d;
    bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dvs.b + kh * a.dvs.h
                + s * a.dvs.s + d;
    store2(dkp, sk.x * a.scale, sk.y * a.scale);
    store2(dkp + 2, sk.z * a.scale, sk.w * a.scale);
    store2(dvp, sv.x, sv.y);
    store2(dvp + 2, sv.z, sv.w);
  }
}

template <int DT>
int forward(const Args& a, int B, cudaStream_t s) {
  const dim3 grid((a.S + FwdTile<DT>::BQ - 1) / FwdTile<DT>::BQ, a.H, B);
  return launch(flash_fwd_mma_kernel<DT>, grid, kThreads, fwd_smem<DT>(), s,
                a);
}

template <int DT>
int backward(const Args& a, int B, int K, const Split& sp, cudaStream_t s) {
  const dim3 gq((a.S + DqTile<DT>::BQ - 1) / DqTile<DT>::BQ, a.H, B);
  int err = launch(flash_dq_mma_kernel<DT>, gq, kThreads, dq_smem<DT>(), s,
                   a);
  if (err) return err;
  const dim3 gk(sp.parts * K * B,
                (a.S + DkvTile<DT>::BK - 1) / DkvTile<DT>::BK);
  err = launch(flash_dkdv_mma_kernel<DT>, gk, kThreads, dkdv_smem<DT>(), s,
               a, sp);
  if (err || sp.parts == 1) return err;
  const long long n = (long long)B * K * a.S * (a.D / 4);
  const int blocks = (int)((n + 255) / 256 < 65535 ? (n + 255) / 256 : 65535);
  return launch(flash_dkdv_reduce_kernel, dim3(blocks), 256, 0, s, a, sp, B,
                K);
}

}  // namespace tc

template <typename T, int DT>
int forward(const Args& a, int B, cudaStream_t s) {
  const dim3 grid((a.S + Tile<DT>::BQ - 1) / Tile<DT>::BQ, a.H, B);
  return launch(flash_fwd_kernel<T, DT>, grid, kThreads, fwd_smem<DT>(), s,
                a);
}

template <typename T, int DT>
int backward(const Args& a, int B, cudaStream_t s) {
  const dim3 gq((a.S + Tile<DT>::BQ - 1) / Tile<DT>::BQ, a.H, B);
  int err = launch(flash_dq_kernel<T, DT>, gq, kThreads, dq_smem<DT>(), s,
                   a);
  if (err) return err;
  const dim3 gk((a.S + Tile<DT>::BK - 1) / Tile<DT>::BK, a.H / a.group, B);
  return launch(flash_dkdv_kernel<T, DT>, gk, kThreads, dkdv_smem<DT>(), s,
                a);
}

// The SIMT route: dispatch on the type and on the tile width that holds D.
template <template <typename, int> class Op>
int dispatch(const Args& a, int B, int is_bf16, cudaStream_t s) {
  if (a.D <= 64)
    return is_bf16 ? Op<__nv_bfloat16, 64>::run(a, B, s)
                   : Op<float, 64>::run(a, B, s);
  if (a.D <= 128)
    return is_bf16 ? Op<__nv_bfloat16, 128>::run(a, B, s)
                   : Op<float, 128>::run(a, B, s);
  return is_bf16 ? Op<__nv_bfloat16, 256>::run(a, B, s)
                 : Op<float, 256>::run(a, B, s);
}
template <typename T, int DT> struct Fwd {
  static int run(const Args& a, int B, cudaStream_t s) {
    return forward<T, DT>(a, B, s);
  }
};
template <typename T, int DT> struct Bwd {
  static int run(const Args& a, int B, cudaStream_t s) {
    return backward<T, DT>(a, B, s);
  }
};

bool shapes_ok(int B, int H, int K, int S, int D, int window) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && K >= 1 && H % K == 0
         && S >= 1 && D >= 1 && D <= kMaxD && window >= 0;
}

// route 0: SIMT (any D <= 256, bf16 or f32); route 1: tensor cores (bf16,
// D <= 128, D % 8 == 0).
bool route_ok(int route, int is_bf16, int D) {
  return route == 0 || (route == 1 && is_bf16 && D <= 128 && D % 8 == 0);
}

View view(const long long* st, int i) {
  return View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

extern "C" {

// strides: (b, h, s) element strides of q, k, v, o, in that order.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int K, int S,
                               int D, int causal, int window, int is_bf16,
                               int route, float scale,
                               const long long* strides, void* stream) {
  if (!shapes_ok(B, H, K, S, D, window) || !route_ok(route, is_bf16, D))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = o;
  a.lse = static_cast<float*>(lse);
  a.H = H; a.S = S; a.D = D; a.group = H / K;
  a.causal = causal; a.window = window; a.scale = scale;
  a.qs = view(strides, 0); a.ks = view(strides, 1);
  a.vs = view(strides, 2); a.os = view(strides, 3);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return D <= 64 ? tc::forward<64>(a, B, s) : tc::forward<128>(a, B, s);
  return dispatch<Fwd>(a, B, is_bf16, s);
}

// strides: (b, h, s) element strides of q, k, v, o, dO, dq, dk, dv.  parts
// splits each kv head's group of q heads over that many dK/dV blocks
// (route 1 only; parts > 1 needs the (parts, B, K, S, D) f32 scratch
// part_dk and part_dv).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, const void* lse,
                               void* delta, void* dq, void* dk, void* dv,
                               void* part_dk, void* part_dv, int B, int H,
                               int K, int S, int D, int causal, int window,
                               int is_bf16, int route, int parts, float scale,
                               const long long* strides, void* stream) {
  if (!shapes_ok(B, H, K, S, D, window) || !route_ok(route, is_bf16, D)
      || parts < 1 || (H / K) % parts || (parts > 1 && route != 1)
      || (parts > 1 && (!part_dk || !part_dv)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dO = dO;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.S = S; a.D = D; a.group = H / K;
  a.causal = causal; a.window = window; a.scale = scale;
  a.qs = view(strides, 0); a.ks = view(strides, 1); a.vs = view(strides, 2);
  a.os = view(strides, 3); a.dos = view(strides, 4); a.dqs = view(strides, 5);
  a.dks = view(strides, 6); a.dvs = view(strides, 7);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const tc::Split sp{parts, K, static_cast<float*>(part_dk),
                       static_cast<float*>(part_dv)};
    return D <= 64 ? tc::backward<64>(a, B, K, sp, s)
                   : tc::backward<128>(a, B, K, sp, s);
  }
  return dispatch<Bwd>(a, B, is_bf16, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
