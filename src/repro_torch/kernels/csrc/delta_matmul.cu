// Fused "base + per-slot delta" projection for personalized-delta serving.
//
//   y[b] = x[b] @ w  +  sum_{e : slots[e] == b}  x[b] @ dw[e]
//
// Replaces the TPU kernel repro/kernels/delta_matmul.py::base_delta_matmul_2d
// (pl.pallas_call at line 126, body at line 120).  x (B, d) and w (d, f) are
// bf16 or f32, dw (C, d, f) is f32 (the overlay's leaves), slots (C,) int32
// with -1 for an empty entry, out (B, f) in x's type.  Sums are f32.
//
// What bounds it on the card: bytes.  At decode batch B the kernel does
// 2*B MACs for every element of w it reads, far below the ~295 operations
// per byte where an H100 stops being memory-bound.  The least traffic is
//     d*f*sizeof(w) + n_active*d*f*4 + B*d*sizeof(x) + B*f*sizeof(out)
// (each input read once, each output written once; n_active = entries with
// slots[e] >= 0), so the design reads every element of w and of each active
// dw[e] exactly once and never touches the slabs of empty entries:
//   * one lane per output column, so a warp reads 32 contiguous elements of
//     a row of w or dw[e] (coalesced);
//   * the 8 warps of a block split the d axis (interleaved rows) and meet in
//     a shared-memory reduction at the end, so every column's sum is made by
//     one block with no atomics (deterministic);
//   * x is staged in f32 through shared memory in chunks of kChunk rows of d,
//     so d is unbounded (it reaches 5632 for TinyLlama's MLP wo);
//   * bf16 w is read as bf16 and widened in registers: no f32 copy of the
//     weights is ever written.
// Known limit: the grid has ceil(f/32) blocks, so a narrow f (256 for
// TinyLlama's wk/wv) fills only a few SMs.  Splitting d across blocks is
// left to a later change.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kCols = 32;                 // output columns per block
constexpr int kWarps = 8;                 // warps per block, split over d
constexpr int kThreads = kCols * kWarps;
constexpr int kChunk = 128;               // rows of d staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, typename TW, int MAXB>
__global__ void __launch_bounds__(kThreads)
base_delta_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                         const float* __restrict__ dw,
                         const int* __restrict__ slots, TX* __restrict__ out,
                         int B, int d, int f, int C) {
  // +1 pads the batch axis so the staging writes do not share a bank
  __shared__ float sx[kChunk][MAXB + 1];
  __shared__ float red[kWarps][MAXB][kCols];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kCols + lane;
  const bool col_ok = j < f;

  float acc[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;

  // base product x @ w, read once for the whole batch
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * MAXB; i += kThreads) {
      const int b = i / kChunk;
      const int kk = i - b * kChunk;
      const int k = k0 + kk;
      sx[kk][b] = (b < B && k < d) ? to_f32(x[(size_t)b * d + k]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int kk = warp; kk < kChunk; kk += kWarps) {
        const int k = k0 + kk;
        if (k < d) {
          const float wv = to_f32(w[(size_t)k * f + j]);
#pragma unroll
          for (int b = 0; b < MAXB; ++b) acc[b] += sx[kk][b] * wv;
        }
      }
    }
  }

  // per-slot corrections in entry order; an empty entry's slab is not read
  for (int e = 0; e < C; ++e) {
    const int s = slots[e];
    if (s < 0 || s >= B) continue;
    const float* __restrict__ dwe = dw + (size_t)e * d * f;
    const TX* __restrict__ xs = x + (size_t)s * d;
    float corr = 0.f;
    if (col_ok) {
#pragma unroll 8
      for (int k = warp; k < d; k += kWarps)
        corr += to_f32(xs[k]) * dwe[(size_t)k * f + j];
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b == s) acc[b] += corr;
  }

  // combine the warps' partial sums over d
#pragma unroll
  for (int b = 0; b < MAXB; ++b) red[warp][b][lane] = acc[b];
  __syncthreads();
  for (int i = threadIdx.x; i < MAXB * kCols; i += kThreads) {
    const int b = i / kCols;
    const int c = i - b * kCols;
    const int jj = blockIdx.x * kCols + c;
    if (b < B && jj < f) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) sum += red[q][b][c];
      out[(size_t)b * f + jj] = from_f32<TX>(sum);
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch_typed(const void* x, const void* w, const void* dw,
                         const void* slots, void* out, int B, int d, int f,
                         int C, cudaStream_t stream) {
  const dim3 grid((f + kCols - 1) / kCols);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const float* dwp = static_cast<const float*>(dw);
  const int* sp = static_cast<const int*>(slots);
  TX* op = static_cast<TX*>(out);
  if (B <= 4) {
    base_delta_matmul_kernel<TX, TW, 4>
        <<<grid, kThreads, 0, stream>>>(xp, wp, dwp, sp, op, B, d, f, C);
  } else if (B <= 8) {
    base_delta_matmul_kernel<TX, TW, 8>
        <<<grid, kThreads, 0, stream>>>(xp, wp, dwp, sp, op, B, d, f, C);
  } else {
    base_delta_matmul_kernel<TX, TW, 16>
        <<<grid, kThreads, 0, stream>>>(xp, wp, dwp, sp, op, B, d, f, C);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B above 16 is refused (MAX_BATCH in kernels/delta_matmul.py).
int base_delta_matmul_launch(const void* x, const void* w, const void* dw,
                             const void* slots, void* out, int B, int d,
                             int f, int C, int x_bf16, int w_bf16,
                             void* stream) {
  if (B < 1 || B > 16 || d < 1 || f < 1 || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && w_bf16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(x, w, dw, slots, out, B,
                                                     d, f, C, s);
  else if (x_bf16)
    err = launch_typed<__nv_bfloat16, float>(x, w, dw, slots, out, B, d, f,
                                             C, s);
  else if (w_bf16)
    err = launch_typed<float, __nv_bfloat16>(x, w, dw, slots, out, B, d, f,
                                             C, s);
  else
    err = launch_typed<float, float>(x, w, dw, slots, out, B, d, f, C, s);
  return static_cast<int>(err);
}

const char* base_delta_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
