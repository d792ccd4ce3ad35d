// Mamba2 SSD chunked scan, one (batch, head) per block:
//
//   for each chunk of Q positions, with cs = cumsum(dt * A) inside the chunk,
//   y[i]   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra-chunk)
//          + exp(cs_i) C_i . state                                 (inter-chunk)
//          + D x_i
//   state' = state exp(cs_{Q-1}) + sum_j (x_j dt_j exp(cs_{Q-1} - cs_j)) (x) B_j
//
// f32 sums, y in x's type (bf16 or f32).  x (B,S,H,P), dt (B,S,H) f32,
// A = -exp(A_log) (H,) f32, B/C (B,S,G,N) read per group (head h uses group
// h / (H/G)), D (H,) f32; strides in elements, the last axis contiguous.
// y is written contiguous (B,S,H,P).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (line 72;
// body _ssd_kernel at line 27, pallas_call at line 88): the scan of every
// Mamba2 layer of every sequence forward (probe, update, eval, frozen prefix).
//
// What bounds it on the card: at the main path's shape (b 4, S 512, H 32,
// P 64, N 128, G 1, chunk 128, bf16 x/B/C) the function moves ~18 MB and
// needs ~3.8 GFLOP (the causal half of the Q x Q products), so its bound is
// the bytes, ~5.4 us at 3.35 TB/s.  Two routes (kernels/ssd_scan.py::route):
//
// route 0: SIMT, f32 (and bf16 at a P or N that is not a multiple of 16).
// A plain f32 kernel, exact to ~1e-6: its scalar FMAs from shared memory
// bound it (0.31 ms at the main shape in bf16, 57x the bound), which is why
// bf16 has its own route.  Design:
//   * the TPU runs the chunk axis as a sequential grid axis and keeps the
//     (P, N) state in VMEM scratch.  Hopper blocks run in no order, so one
//     block owns one (batch, head) and loops over the chunks itself, the
//     64 x 128 f32 state in shared memory (32 KB);
//   * per chunk the block stages C, B (Q x N), raw x (Q x P) in f32 and the
//     scores in tiles of 32 columns: 217 KB of dynamic shared memory at the
//     largest shapes (after cudaFuncSetAttribute), one block per SM, 128
//     blocks at full width for 132 SMs.  Rows are padded by one float so
//     that neither the row-broadcast nor the column reads conflict on banks;
//   * dt is folded into the scores (S_ij exp(cs_i - cs_j) dt_j) and into the
//     state weights, so x is staged once, undiscretised, and also serves the
//     D x term;
//   * the upper triangle of L is a select (j <= i ? ... : 0), never a 0/1
//     multiply: exp(cs_i - cs_j) overflows to inf there, and inf * 0 is NaN.
//     Whole 16-row groups above a scores tile are skipped;
//   * expf, no flush of denormals (no fast math): underflow to 0 as in the
//     plain version;
//   * no atomics: every sum has a fixed order, so two launches agree bit
//     for bit.
//
// route 1: tensor cores, bf16 with P % 16 == 0 and N % 16 == 0 (every
// Mamba2 layer).  The same block per (batch, head) looping over the chunks,
// the four chunk products on bf16 mma.sync m16n8k16 with f32 accumulation
// (mma_sm90.cuh), 8 warps of 16 rows.  One launch, no state traffic through
// device memory: the f32 state lives in the registers of the warps that
// update it.  Every product has one operand that is bf16 in memory (C, B or
// x) and one formed in f32; the f32 one goes to the tensor cores as two bf16
// terms, hi = bf16(v) and lo = bf16(v - hi), so each product agrees with
// f32 to ~2^-16 relative for twice the mma count:
//   * scores C B^T: both exact, one pass;
//   * (scores * L * dt_j) @ x: the f32 factor split in registers (the C
//     fragments of the scores are the A fragments of this product), x exact;
//     L = exp(cs_i - cs_j) on the special-function unit (ex2.approx, ~2
//     ulp, far inside the hi/lo split's 2^-16);
//   * C @ state^T: the state split into bf16 hi/lo copies in shared memory;
//   * state' = state exp(cs_last) + x^T @ (B * w_j), w_j = dt_j
//     exp(cs_last - cs_j): the weight folded into B's rows, which are split;
//     x^T comes straight from the staged x by ldmatrix.trans.
// The causal half is skipped by whole 16 x 16 tiles; L's upper triangle is
// a select, as in route 0.  A chunk stages C, B, x by 16-byte cp.async
// (scalar loads where a row is not 16-byte aligned), zero-filling rows
// past Q up to a multiple of 16.  Shared memory: C, B, B*w hi/lo (Q x N),
// x (Q x P), state hi/lo (P x N), bf16 rows padded by 16 bytes so ldmatrix
// does not conflict on banks: 190 KB, one block per SM.  Sums in a fixed
// order, no atomics: the same bits on every launch.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTY = 16, kTX = 16;          // thread grid over output tiles
constexpr int kMaxQ = 128, kMaxP = 64, kMaxN = 128;
constexpr int kJT = 32;                    // scores tile width (columns j)
constexpr int kLdN = kMaxN + 1;            // padded row strides (floats)
constexpr int kLdP = kMaxP + 1;
constexpr int kLdS = kJT + 1;
constexpr int kYR = kMaxQ / kTY;           // 8 rows i of y per thread
constexpr int kYC = kMaxP / kTX;           // 4 columns p of y per thread
constexpr int kSC = kJT / kTX;             // 2 columns j of a scores tile
constexpr int kHR = kMaxP / kTY;           // 4 rows p of the state
constexpr int kHC = kMaxN / kTX;           // 8 columns n of the state

constexpr int kSmemFloats = 2 * kMaxQ * kLdN      // C, B
                            + kMaxQ * kLdP        // x
                            + kMaxP * kLdN        // state
                            + kMaxQ * kLdS        // scores tile
                            + 4 * kMaxQ;          // dt, cs, w, exp(cs)
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* x; const float* dt; const float* A; const void* B;
  const void* C; const float* D; void* y;
  int S, H, P, G, N, Q;
  long long xs_b, xs_s, xs_h;
  long long ds_b, ds_s, ds_h;
  long long bs_b, bs_s, bs_g;
  long long cs_b, cs_s, cs_g;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const Args a) {
  extern __shared__ float smem[];
  float* sC = smem;
  float* sB = sC + kMaxQ * kLdN;
  float* sX = sB + kMaxQ * kLdN;
  float* sH = sX + kMaxQ * kLdP;
  float* sS = sH + kMaxP * kLdN;
  float* s_dt = sS + kMaxQ * kLdS;
  float* s_cs = s_dt + kMaxQ;
  float* s_w = s_cs + kMaxQ;
  float* s_eo = s_w + kMaxQ;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int Q = a.Q, P = a.P, N = a.N;
  const float A = a.A[h], D = a.D[h];

  const T* xg = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const float* dtg = a.dt + b * a.ds_b + h * a.ds_h;
  const T* Bg = static_cast<const T*>(a.B) + b * a.bs_b + g * a.bs_g;
  const T* Cg = static_cast<const T*>(a.C) + b * a.cs_b + g * a.cs_g;
  T* yg = static_cast<T*>(a.y) + ((long long)b * a.S * a.H + h) * P;
  const long long ys_s = (long long)a.H * P;

  // Rows and columns beyond (Q, P, N) stay 0 and the state starts at 0.
  for (int e = tid; e < kSmemFloats; e += kThreads) smem[e] = 0.f;
  __syncthreads();

  for (int s0 = 0; s0 < a.S; s0 += Q) {
    // ---- stage the chunk ---------------------------------------------------
    for (int e = tid; e < Q; e += kThreads) s_dt[e] = dtg[(s0 + e) * a.ds_s];
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      sC[i * kLdN + n] = to_f32(Cg[(s0 + i) * a.cs_s + n]);
      sB[i * kLdN + n] = to_f32(Bg[(s0 + i) * a.bs_s + n]);
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e - i * P;
      sX[i * kLdP + p] = to_f32(xg[(s0 + i) * a.xs_s + p]);
    }
    __syncthreads();
    if (tid == 0) {                        // cumsum in order, as the plain one
      float acc = 0.f;
      for (int i = 0; i < Q; ++i) {
        acc += s_dt[i] * A;
        s_cs[i] = acc;
      }
    }
    __syncthreads();
    const float cl = s_cs[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      s_w[i] = s_dt[i] * expf(cl - s_cs[i]);
      s_eo[i] = expf(s_cs[i]);
    }
    __syncthreads();

    // ---- inter-chunk term: exp(cs_i) * C_i . state_p ------------------------
    float acc[kYR][kYC];
#pragma unroll
    for (int k = 0; k < kYR; ++k)
#pragma unroll
      for (int m = 0; m < kYC; ++m) acc[k][m] = 0.f;
    if (s0 > 0) {
      for (int n = 0; n < N; ++n) {
        float cv[kYR], hv[kYC];
#pragma unroll
        for (int k = 0; k < kYR; ++k) cv[k] = sC[(ty + kTY * k) * kLdN + n];
#pragma unroll
        for (int m = 0; m < kYC; ++m) hv[m] = sH[(tx + kTX * m) * kLdN + n];
#pragma unroll
        for (int k = 0; k < kYR; ++k)
#pragma unroll
          for (int m = 0; m < kYC; ++m) acc[k][m] += cv[k] * hv[m];
      }
#pragma unroll
      for (int k = 0; k < kYR; ++k) {
        const float eo = s_eo[ty + kTY * k];
#pragma unroll
        for (int m = 0; m < kYC; ++m) acc[k][m] *= eo;
      }
    }

    // ---- intra-chunk term, by tiles of kJT columns j ------------------------
    for (int j0 = 0; j0 < Q; j0 += kJT) {
      float sacc[kYR][kSC];
#pragma unroll
      for (int k = 0; k < kYR; ++k)
#pragma unroll
        for (int m = 0; m < kSC; ++m) sacc[k][m] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kYR], bv[kSC];
#pragma unroll
        for (int k = 0; k < kYR; ++k) cv[k] = sC[(ty + kTY * k) * kLdN + n];
#pragma unroll
        for (int m = 0; m < kSC; ++m)
          bv[m] = sB[(j0 + tx + kTX * m) * kLdN + n];
#pragma unroll
        for (int k = 0; k < kYR; ++k) {
          if (kTY * k + kTY - 1 < j0) continue;   // whole group above the tile
#pragma unroll
          for (int m = 0; m < kSC; ++m) sacc[k][m] += cv[k] * bv[m];
        }
      }
#pragma unroll
      for (int k = 0; k < kYR; ++k) {
        const int i = ty + kTY * k;
#pragma unroll
        for (int m = 0; m < kSC; ++m) {
          const int j = j0 + tx + kTX * m;
          sS[i * kLdS + tx + kTX * m] =
              (j <= i && i < Q) ? sacc[k][m] * expf(s_cs[i] - s_cs[j]) * s_dt[j]
                                : 0.f;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < kJT; ++jj) {
        float sv[kYR], xv[kYC];
#pragma unroll
        for (int k = 0; k < kYR; ++k) sv[k] = sS[(ty + kTY * k) * kLdS + jj];
#pragma unroll
        for (int m = 0; m < kYC; ++m) xv[m] = sX[(j0 + jj) * kLdP + tx + kTX * m];
#pragma unroll
        for (int k = 0; k < kYR; ++k) {
          if (kTY * k + kTY - 1 < j0) continue;
#pragma unroll
          for (int m = 0; m < kYC; ++m) acc[k][m] += sv[k] * xv[m];
        }
      }
      __syncthreads();
    }

    // ---- y = intra + inter + D x -------------------------------------------
#pragma unroll
    for (int k = 0; k < kYR; ++k) {
      const int i = ty + kTY * k;
      if (i >= Q) continue;
#pragma unroll
      for (int m = 0; m < kYC; ++m) {
        const int p = tx + kTX * m;
        if (p < P)
          store(yg + (s0 + i) * ys_s + p, acc[k][m] + sX[i * kLdP + p] * D);
      }
    }

    // ---- state update (every thread owns its entries; the old state's last
    // reads were before the tile loop's barriers) ----------------------------
    {
      const float ecl = expf(cl);
      float hacc[kHR][kHC];
#pragma unroll
      for (int k = 0; k < kHR; ++k)
#pragma unroll
        for (int m = 0; m < kHC; ++m)
          hacc[k][m] = sH[(ty + kTY * k) * kLdN + tx + kTX * m] * ecl;
      for (int j = 0; j < Q; ++j) {
        const float w = s_w[j];
        float xv[kHR], bv[kHC];
#pragma unroll
        for (int k = 0; k < kHR; ++k) xv[k] = sX[j * kLdP + ty + kTY * k] * w;
#pragma unroll
        for (int m = 0; m < kHC; ++m) bv[m] = sB[j * kLdN + tx + kTX * m];
#pragma unroll
        for (int k = 0; k < kHR; ++k)
#pragma unroll
          for (int m = 0; m < kHC; ++m) hacc[k][m] += xv[k] * bv[m];
      }
#pragma unroll
      for (int k = 0; k < kHR; ++k)
#pragma unroll
        for (int m = 0; m < kHC; ++m)
          sH[(ty + kTY * k) * kLdN + tx + kTX * m] = hacc[k][m];
    }
    __syncthreads();                       // before the next chunk's staging
  }
}

// ---------------------------------------------------------------------------
// route 1: bf16 on the tensor cores (P % 16 == 0, N % 16 == 0)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using mma_sm90::cp_async16;
using mma_sm90::exp2_approx;
using mma_sm90::cp_async_commit;
using mma_sm90::cp_async_wait;
using mma_sm90::ldsm_x4;
using mma_sm90::ldsm_x4_trans;
using mma_sm90::mma_bf16;
using mma_sm90::pack_bf16;
using mma_sm90::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kLdNb = kMaxN + 8;           // bf16 row strides, +16 bytes
constexpr int kLdPb = kMaxP + 8;
// one chunk's staged inputs: C, B (Q x N), x (Q x P) in bf16, dt in f32
constexpr int kStageElems = 2 * kMaxQ * kLdNb + kMaxQ * kLdPb;
constexpr size_t kStageBytes = sizeof(bf16) * kStageElems
                               + sizeof(float) * kMaxQ;
constexpr size_t kMmaSmemBytes =
    2 * kStageBytes                          // two stages: chunk c and c + 1
    + sizeof(bf16) * 2 * kMaxP * kLdNb       // state hi / lo
    + sizeof(float) * 3 * kMaxQ;             // cs, w, exp(cs)

// Lane l's element offset inside the 16 x 16 block of a [rows][ld] tile that
// one ldmatrix.x4 reads (as in flash_attention.cu): lane_a, an A fragment
// (16 rows x 16 k, row-major); lane_bn, the B fragments of two n-tiles from
// an [n][k] tile (plain), which is also the A fragment of a [k][m] tile
// (.trans); lane_bk, the B fragments of two n-tiles from a [k][n] tile
// (.trans).
__device__ __forceinline__ int lane_a(int l, int ld) {
  return (l & 15) * ld + (l >> 4) * 8;
}
__device__ __forceinline__ int lane_bn(int l, int ld) {
  return ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ int lane_bk(int l, int ld) {
  return ((l & 7) + ((l >> 3) & 1) * 8) * ld + (l >> 4) * 8;
}

// v = hi + lo with hi = bf16(v) and lo = v - hi (lo rounds to bf16 when
// packed): the two bf16 terms of an f32 factor.
__device__ __forceinline__ void split_bf16(float v, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(v));
  lo = v - hi;
}

// Two f32 as packed bf16 hi and lo terms.
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  float hx, lx, hy, ly;
  split_bf16(x, hx, lx);
  split_bf16(y, hy, ly);
  hi = pack_bf16(hx, hy);
  lo = pack_bf16(lx, ly);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Stage rows [0, rows) of `cols` bf16 (cols % 8 == 0) from g (row stride
// gs) into s (row stride ld).  vec: every row starts 16-byte aligned, so
// cp.async (committed by the caller); else plain loads.
__device__ __forceinline__ void stage_rows(bf16* s, int ld, const bf16* g,
                                           long long gs, int rows, int cols,
                                           bool vec) {
  if (vec) {                    // a thread keeps one 16-byte column piece
    const int pieces = cols / 8, rstep = kMmaThreads / pieces;
    const int r0 = threadIdx.x / pieces, c = (threadIdx.x - r0 * pieces) * 8;
    if (r0 >= rstep) return;
    const bf16* src = g + r0 * gs + c;
    uint32_t dst = smem_addr(s + r0 * ld + c);
    for (int r = r0; r < rows; r += rstep) {
      cp_async16(dst, src, 16);
      src += rstep * gs;
      dst += 2 * rstep * ld;
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kMmaThreads) {
      const int r = e / cols, c = e - r * cols;
      s[r * ld + c] = g[r * gs + c];
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

struct Stage {
  bf16 *C, *B, *X;
  float* dt;
};

__device__ __forceinline__ Stage stage_at(unsigned char* base, int i) {
  unsigned char* p = base + i * kStageBytes;
  bf16* C = reinterpret_cast<bf16*>(p);
  bf16* B = C + kMaxQ * kLdNb;
  bf16* X = B + kMaxQ * kLdNb;
  return {C, B, X, reinterpret_cast<float*>(X + kMaxQ * kLdPb)};
}

__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_scan_mma_kernel(const Args a, const bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the state's bf16 hi / lo copies, [P][kLdNb] each
  bf16* sHh = reinterpret_cast<bf16*>(smem_raw + 2 * kStageBytes);
  bf16* sHl = sHh + kMaxP * kLdNb;
  float* s_cs = reinterpret_cast<float*>(sHl + kMaxP * kLdNb);
  float* s_w = s_cs + kMaxQ;
  float* s_eo = s_w + kMaxQ;

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (a.H / a.G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int Q = a.Q, P = a.P, N = a.N, Qp = (Q + 15) & ~15;
  const int KN = N / 16, PT = P / 16;
  const float A = a.A[h], D = a.D[h];

  const bf16* xg = static_cast<const bf16*>(a.x) + b * a.xs_b + h * a.xs_h;
  const float* dtg = a.dt + b * a.ds_b + h * a.ds_h;
  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.bs_b + grp * a.bs_g;
  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.cs_b + grp * a.cs_g;
  bf16* yg = static_cast<bf16*>(a.y) + ((long long)b * a.S * a.H + h) * P;
  const long long ys_s = (long long)a.H * P;
  const int i0 = warp * 16;                        // this warp's rows

  // Rows past Q (up to a multiple of 16) stay 0 in both stages: zero
  // scores, zero x, dt 0.  Staging writes rows < Q only.
  for (int s = 0; s < 2; ++s) {
    const Stage z = stage_at(smem_raw, s);
    for (int e = threadIdx.x; e < (Qp - Q) * kLdNb; e += kMmaThreads) {
      z.C[Q * kLdNb + e] = __float2bfloat16(0.f);
      z.B[Q * kLdNb + e] = __float2bfloat16(0.f);
    }
    for (int e = threadIdx.x; e < (Qp - Q) * kLdPb; e += kMmaThreads)
      z.X[Q * kLdPb + e] = __float2bfloat16(0.f);
    for (int e = Q + threadIdx.x; e < kMaxQ; e += kMmaThreads) z.dt[e] = 0.f;
  }

  auto issue = [&](int s0, const Stage& d) {
    stage_rows(d.C, kLdNb, Cg + s0 * a.cs_s, a.cs_s, Q, N, vec);
    stage_rows(d.B, kLdNb, Bg + s0 * a.bs_s, a.bs_s, Q, N, vec);
    stage_rows(d.X, kLdPb, xg + s0 * a.xs_s, a.xs_s, Q, P, vec);
    for (int e = threadIdx.x; e < Q; e += kMmaThreads)
      mma_sm90::cp_async4(smem_addr(d.dt + e),
                          dtg + (long long)(s0 + e) * a.ds_s, 4);
    cp_async_commit();
  };
  issue(0, stage_at(smem_raw, 0));

  // this warp's 16 columns of the f32 state (n0 = 16 warp, every row
  // group q: rows 16 q), carried across chunks in registers
  float hst[kMaxP / 16][2][4];
#pragma unroll
  for (int q = 0; q < kMaxP / 16; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) hst[q][0][e] = hst[q][1][e] = 0.f;

  for (int c = 0, s0 = 0; s0 < a.S; ++c, s0 += Q) {
    const bool first = s0 == 0, last = s0 + Q >= a.S;
    const Stage cur = stage_at(smem_raw, c & 1);
    // ---- the next chunk's loads go out while this one is computed; its
    // stage was last read by chunk c - 1, which every warp has finished --
    __syncthreads();
    if (!last) {
      issue(s0 + Q, stage_at(smem_raw, (c + 1) & 1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // ---- warp 0: cs = cumsum(dt * A) (lane l holds positions 4l..4l+3,
    // then a scan of the lanes' sums), w_j and exp(cs_i) ----------------
    if (warp == 0) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        run += cur.dt[4 * lane + k] * A;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = incl - run;
      // the chunk's total (positions past Q add 0)
      const float cl = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * lane + k;
        const float cs = excl + v[k];
        s_cs[i] = cs;
        s_w[i] = i < Q ? cur.dt[i] * expf(cl - cs) : 0.f;
        s_eo[i] = expf(cs);
      }
    }

    float y[kMaxP / 8][4];
    float sc[kMaxQ / 8][4];
    if (i0 < Qp) {
      const uint32_t aC = smem_addr(cur.C) + 2 * (lane_a(lane, kLdNb)
                                                  + i0 * kLdNb);
      uint32_t cf[kMaxN / 16][4];
#pragma unroll
      for (int kt = 0; kt < kMaxN / 16; ++kt)
        if (kt < KN) ldsm_x4(cf[kt], aC + 2 * kt * 16);
#pragma unroll
      for (int nt = 0; nt < kMaxP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;

      // inter-chunk: C @ state^T, the state as hi + lo (scaled below)
      if (!first) {
        const uint32_t bh = smem_addr(sHh) + 2 * lane_bn(lane, kLdNb);
        const uint32_t bl = smem_addr(sHl) + 2 * lane_bn(lane, kLdNb);
#pragma unroll
        for (int kt = 0; kt < kMaxN / 16; ++kt) {
          if (kt >= KN) break;
#pragma unroll
          for (int np = 0; np < kMaxP / 16; ++np) {
            if (np >= PT) break;
            const int off = 2 * (np * 16 * kLdNb + kt * 16);
            uint32_t bb[4];
            ldsm_x4(bb, bh + off);
            mma_bf16(y[2 * np], cf[kt], bb[0], bb[1]);
            mma_bf16(y[2 * np + 1], cf[kt], bb[2], bb[3]);
            ldsm_x4(bb, bl + off);
            mma_bf16(y[2 * np], cf[kt], bb[0], bb[1]);
            mma_bf16(y[2 * np + 1], cf[kt], bb[2], bb[3]);
          }
        }
      }

      // scores C B^T on the tiles at or below the diagonal (j < i0 + 16)
#pragma unroll
      for (int nt = 0; nt < kMaxQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      const uint32_t bB = smem_addr(cur.B) + 2 * lane_bn(lane, kLdNb);
#pragma unroll
      for (int kt = 0; kt < kMaxN / 16; ++kt) {
        if (kt >= KN) break;
#pragma unroll
        for (int np = 0; np < kMaxQ / 16; ++np) {
          if (np > warp) break;
          uint32_t bb[4];
          ldsm_x4(bb, bB + 2 * (np * 16 * kLdNb + kt * 16));
          mma_bf16(sc[2 * np], cf[kt], bb[0], bb[1]);
          mma_bf16(sc[2 * np + 1], cf[kt], bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                         // cs, w, exp(cs) are written

    if (i0 < Qp) {
      const int ia = i0 + gq, ib = ia + 8;
      const float csa = s_cs[ia], csb = s_cs[ib];
      if (!first) {
        const float e0 = s_eo[ia], e1 = s_eo[ib];
#pragma unroll
        for (int nt = 0; nt < kMaxP / 8; ++nt) {
          y[nt][0] *= e0;
          y[nt][1] *= e0;
          y[nt][2] *= e1;
          y[nt][3] *= e1;
        }
      }

      // intra-chunk: (scores * L * dt_j) @ x, that factor as hi + lo.  The
      // upper triangle of L is a select: exp(cs_i - cs_j) is inf there.
      const uint32_t bX = smem_addr(cur.X) + 2 * lane_bk(lane, kLdPb);
#pragma unroll
      for (int kk = 0; kk < kMaxQ / 16; ++kk) {
        if (kk > warp) break;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = kk * 16 + hf * 8 + 2 * tq + (e & 1);
            v[e] = j <= i ? sc[2 * kk + hf][e]
                                * exp2_approx(((e < 2 ? csa : csb) - s_cs[j])
                                              * kLog2e)
                                * cur.dt[j]
                          : 0.f;
          }
          split_pack(v[0], v[1], ah[2 * hf], al[2 * hf]);
          split_pack(v[2], v[3], ah[2 * hf + 1], al[2 * hf + 1]);
        }
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (dp >= PT) break;
          uint32_t bb[4];
          ldsm_x4_trans(bb, bX + 2 * (kk * 16 * kLdPb + dp * 16));
          mma_bf16(y[2 * dp], ah, bb[0], bb[1]);
          mma_bf16(y[2 * dp + 1], ah, bb[2], bb[3]);
          mma_bf16(y[2 * dp], al, bb[0], bb[1]);
          mma_bf16(y[2 * dp + 1], al, bb[2], bb[3]);
        }
      }

      // y = intra + inter + D x, rows < Q
#pragma unroll
      for (int nt = 0; nt < kMaxP / 8; ++nt) {
        if (nt >= P / 8) break;
        const int p = nt * 8 + 2 * tq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = i0 + gq + 8 * hr;
          if (i >= Q) continue;
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(cur.X + i * kLdPb + p);
          store2(yg + (s0 + i) * ys_s + p,
                 y[nt][2 * hr] + __low2float(xv) * D,
                 y[nt][2 * hr + 1] + __high2float(xv) * D);
        }
      }
    }
    if (last) break;

    // ---- state' = state exp(cs_last) + x^T @ (B * w): warp w owns the
    // state's columns 16 w .. 16 w + 15; B's fragments for them are weighted
    // by w_j and split into hi + lo once per k-step, then serve every row
    // group ------------------------------------------------------------------
    __syncthreads();                   // every warp is past the state's copies
    if (warp < KN) {
      const float ecl = s_eo[Q - 1];
      const int n0 = warp * 16;
      const uint32_t aXT = smem_addr(cur.X) + 2 * lane_bn(lane, kLdPb);
      const uint32_t bBT = smem_addr(cur.B) + 2 * (lane_bk(lane, kLdNb) + n0);
#pragma unroll
      for (int q = 0; q < kMaxP / 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hst[q][0][e] *= ecl;
          hst[q][1][e] *= ecl;
        }
      for (int kk = 0; kk < Qp / 16; ++kk) {
        uint32_t bb[4], bh[4], bl[4];
        ldsm_x4_trans(bb, bBT + 2 * kk * 16 * kLdNb);
        // bb[0], bb[2]: rows j = 16 kk + 2 tq (+1); bb[1], bb[3]: 8 more
        const int j0 = kk * 16 + 2 * tq;
        const float w0 = s_w[j0], w1 = s_w[j0 + 1];
        const float w8 = s_w[j0 + 8], w9 = s_w[j0 + 9];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float wl = (r & 1) ? w8 : w0, wh = (r & 1) ? w9 : w1;
          split_pack(bf16_lo(bb[r]) * wl, bf16_hi(bb[r]) * wh, bh[r], bl[r]);
        }
#pragma unroll
        for (int q = 0; q < kMaxP / 16; ++q) {
          if (q >= PT) break;
          uint32_t xa[4];
          ldsm_x4_trans(xa, aXT + 2 * (kk * 16 * kLdPb + q * 16));
          mma_bf16(hst[q][0], xa, bh[0], bh[1]);
          mma_bf16(hst[q][1], xa, bh[2], bh[3]);
          mma_bf16(hst[q][0], xa, bl[0], bl[1]);
          mma_bf16(hst[q][1], xa, bl[2], bl[3]);
        }
      }
      // the new state's bf16 hi/lo copies, for the next chunk's C @ state^T
#pragma unroll
      for (int q = 0; q < kMaxP / 16; ++q) {
        if (q >= PT) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int p = q * 16 + gq + 8 * hr, n = n0 + nt * 8 + 2 * tq;
            uint32_t hi, lo;
            split_pack(hst[q][nt][2 * hr], hst[q][nt][2 * hr + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(sHh + p * kLdNb + n) = hi;
            *reinterpret_cast<uint32_t*>(sHl + p * kLdNb + n) = lo;
          }
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.H, (unsigned)batch);
  ssd_scan_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Do x, B and C start every row they are read by on a 16-byte boundary?
bool rows_aligned(const void* p, long long s0, long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0
         && s1 % 8 == 0 && s2 % 8 == 0;
}

int launch_mma(const Args& a, int batch, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMmaSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec = rows_aligned(a.x, a.xs_b, a.xs_s, a.xs_h)
                   && rows_aligned(a.B, a.bs_b, a.bs_s, a.bs_g)
                   && rows_aligned(a.C, a.cs_b, a.cs_s, a.cs_g);
  const dim3 grid((unsigned)a.H, (unsigned)batch);
  ssd_scan_mma_kernel<<<grid, kMmaThreads, kMmaSmemBytes, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest chunk, head dim and state size the kernel takes.
int ssd_scan_max_q() { return kMaxQ; }
int ssd_scan_max_p() { return kMaxP; }
int ssd_scan_max_n() { return kMaxN; }

// route 0: SIMT (bf16 or f32); route 1: tensor cores (bf16, P % 16 == 0,
// N % 16 == 0).
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, const void* D, void* y,
                    int batch, int S, int H, int P, int G, int N, int Q,
                    int is_bf16, long long xs_b, long long xs_s,
                    long long xs_h, long long ds_b, long long ds_s,
                    long long ds_h, long long bs_b, long long bs_s,
                    long long bs_g, long long cs_b, long long cs_s,
                    long long cs_g, int route, void* stream) {
  if (batch < 1 || batch > 65535 || H < 1 || G < 1 || H % G || S < 1
      || Q < 1 || Q > kMaxQ || S % Q || P < 1 || P > kMaxP || N < 1
      || N > kMaxN || route < 0 || route > 1
      || (route == 1 && (!is_bf16 || P % 16 || N % 16)))
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B,
         C, static_cast<const float*>(D), y, S, H, P, G, N, Q,
         xs_b, xs_s, xs_h, ds_b, ds_s, ds_h, bs_b, bs_s, bs_g,
         cs_b, cs_s, cs_g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) return launch_mma(a, batch, s);
  return is_bf16 ? launch<__nv_bfloat16>(a, batch, s)
                 : launch<float>(a, batch, s);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
