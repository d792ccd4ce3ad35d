// Blocked (flash) attention on Hopper: one forward and two backward kernels.
//
//   forward:  O = softmax(scale * Q K^T + mask) V, streamed over key blocks
//             with an f32 running max m, normaliser l and accumulator; also
//             lse = m + log l per row (f32), which the backward needs.
//   backward: P = exp(scale * Q K^T - lse) on the visible pairs,
//             Delta = rowsum(dO * O), dS = P * (dO V^T - Delta),
//             dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO
//             (FlashAttention-2's split: one kernel for dQ by query block,
//             one for dK/dV by key block; no atomics).
//
// q (B,H,S,D), k/v (B,K,S,D) with H % K == 0 (q head h reads kv head
// h / (H/K)); any strides in elements, the last axis contiguous, so the
// model's (B,S,H,D) projections are read in place; bf16 or f32, f32 inside,
// outputs in the inputs' type.  A mask: key j is visible to query i if
// j < S, and j <= i (causal), and i - j < window (window > 0).  Masked
// scores are -1e30 and their probabilities zeroed, so a fully masked row
// outputs 0 (lse +inf); key blocks with no visible pair are skipped.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (line 86; body _flash_kernel at line 27, pallas_call at line 113): the
// attention of every dense self-attention sequence forward (probe, update,
// eval).  The reference has no backward kernel (XLA differentiates
// attend_full); the two backward kernels here are the port's own.
//
// What bounds it on the card: at the main path's shape (B 4, S 1024, H 32,
// K 4, D 64, bf16, causal) the forward needs 17.2 GFLOP (the causal half of
// QK^T and PV) and moves 38 MB, so its bound is the operations, 17 us at
// 989 TFLOP/s bf16; the backward's five products are 42.9 GFLOP, 43 us.
// These kernels are plain f32 SIMT kernels (f32 products on CUDA cores, as
// the TPU kernel computes in f32): bound by their own shared-memory loads
// and f32 FMAs, with a floor of 0.26 ms (forward) and 0.64 ms (backward) at
// 67 TFLOP/s.  A simple, right kernel first; mma/wgmma and TMA come later.
//
// Design:
//   * the TPU walks key blocks on a sequential grid axis and carries m, l
//     and the accumulator in VMEM scratch.  Hopper blocks run in no order,
//     so one block owns one (batch, head, query block) and loops over the
//     key blocks itself, m, l and the accumulator in registers;
//   * tiles of BQ x BK = 64 x 64 for head dims up to 128 and 32 x 32 up to
//     256, staged in f32 shared memory (rows padded by one float, so that
//     neither row-broadcast nor column reads conflict on banks).  Head dims
//     below a tile width (64, 128, 256) are zero-padded in the stage, which
//     adds exact zeros; 256 threads, each owning a strided 4 x 4 (or 2 x 2)
//     sub-tile of the scores and rows x D/16 of the output;
//   * row max and row sum by shuffles inside a half warp (the 16 threads
//     that share a row);
//   * the query blocks are launched heaviest first (under a causal mask the
//     last query block sees every key block);
//   * the dQ kernel also writes Delta (B,H,S) f32 for the dK/dV kernel,
//     which loops over its kv head's group of q heads and the query blocks
//     that see its key block, so dK and dV sum the group without atomics:
//     every sum has a fixed order and two launches agree bit for bit;
//   * expf/logf, no fast math.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Args& a,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DT>
int forward(const Args& a, int B, cudaStream_t s) {
  const dim3 grid((a.S + Tile<DT>::BQ - 1) / Tile<DT>::BQ, a.H, B);
  return launch(flash_fwd_kernel<T, DT>, grid, fwd_smem<DT>(), a, s);
}

template <typename T, int DT>
int backward(const Args& a, int B, cudaStream_t s) {
  const dim3 gq((a.S + Tile<DT>::BQ - 1) / Tile<DT>::BQ, a.H, B);
  int err = launch(flash_dq_kernel<T, DT>, gq, dq_smem<DT>(), a, s);
  if (err) return err;
  const dim3 gk((a.S + Tile<DT>::BK - 1) / Tile<DT>::BK, a.H / a.group, B);
  return launch(flash_dkdv_kernel<T, DT>, gk, dkdv_smem<DT>(), a, s);
}

// Dispatch on the type and on the tile width that holds D.
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

View view(const long long* st, int i) {
  return View{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace

extern "C" {

// strides: (b, h, s) element strides of q, k, v, o, in that order.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int K, int S,
                               int D, int causal, int window, int is_bf16,
                               float scale, const long long* strides,
                               void* stream) {
  if (!shapes_ok(B, H, K, S, D, window)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = o;
  a.lse = static_cast<float*>(lse);
  a.H = H; a.S = S; a.D = D; a.group = H / K;
  a.causal = causal; a.window = window; a.scale = scale;
  a.qs = view(strides, 0); a.ks = view(strides, 1);
  a.vs = view(strides, 2); a.os = view(strides, 3);
  return dispatch<Fwd>(a, B, is_bf16, static_cast<cudaStream_t>(stream));
}

// strides: (b, h, s) element strides of q, k, v, o, dO, dq, dk, dv.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dO, const void* lse,
                               void* delta, void* dq, void* dk, void* dv,
                               int B, int H, int K, int S, int D, int causal,
                               int window, int is_bf16, float scale,
                               const long long* strides, void* stream) {
  if (!shapes_ok(B, H, K, S, D, window)) return (int)cudaErrorInvalidValue;
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
  return dispatch<Bwd>(a, B, is_bf16, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
