// Mamba2 SSD chunked scan, one (batch, head) per block:
//
//   for each chunk of Q positions, with cs = cumsum(dt * A) inside the chunk,
//   y[i]   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra-chunk)
//          + exp(cs_i) C_i . state                                 (inter-chunk)
//          + D x_i
//   state' = state exp(cs_{Q-1}) + sum_j (x_j dt_j exp(cs_{Q-1} - cs_j)) (x) B_j
//
// f32 arithmetic, y in x's type (bf16 or f32).  x (B,S,H,P), dt (B,S,H) f32,
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
// the bytes, ~5.4 us at 3.35 TB/s.  This kernel is a plain f32 SIMT kernel
// (no tensor cores), so it is bound by its own shared-memory loads and f32
// FMAs, far above that: a simple, right kernel first; wgmma/TMA come later.
//
// Design:
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
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// Largest chunk, head dim and state size the kernel takes.
int ssd_scan_max_q() { return kMaxQ; }
int ssd_scan_max_p() { return kMaxP; }
int ssd_scan_max_n() { return kMaxN; }

int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* B, const void* C, const void* D, void* y,
                    int batch, int S, int H, int P, int G, int N, int Q,
                    int is_bf16, long long xs_b, long long xs_s,
                    long long xs_h, long long ds_b, long long ds_s,
                    long long ds_h, long long bs_b, long long bs_s,
                    long long bs_g, long long cs_b, long long cs_s,
                    long long cs_g, void* stream) {
  if (batch < 1 || batch > 65535 || H < 1 || G < 1 || H % G || S < 1
      || Q < 1 || Q > kMaxQ || S % Q || P < 1 || P > kMaxP || N < 1
      || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B,
         C, static_cast<const float*>(D), y, S, H, P, G, N, Q,
         xs_b, xs_s, xs_h, ds_b, ds_s, ds_h, bs_b, bs_s, bs_g,
         cs_b, cs_s, cs_g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, batch, s) : launch<float>(a, batch, s);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
