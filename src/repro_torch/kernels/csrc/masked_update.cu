// Fused masked-SGD apply on a stacked (L, F) leaf, Eq.(3)/(6):
//
//   out[l, f] = T( float(p[l, f]) - ((lr * mask[l]) * float(g[l, f])) )
//
// Replaces the TPU kernel repro/kernels/masked_update.py::masked_sgd_update_2d
// (pl.pallas_call at line 72, inline body at line 64; _masked_update_kernel
// at line 18 is never called).  p and g are (L, F) in p's type (bf16 or
// f32), mask (L,) f32, lr an f32 scalar; out is a fresh (L, F) in p's type.
// It runs once per stacked leaf per local step per client in the masked
// round's tau loop.
//
// What bounds it on the card: bytes, L*F*(2*sizeof(p) + sizeof(g)) + 4*L
// (p and g read once, out written once, the mask read once); two flops per
// element.  Design:
//   * the expression is written with __fmul_rn / __fsub_rn so nvcc cannot
//     contract it into an FMA: the kernel equals the plain PyTorch version
//     (two rounded ops in the reference's order) bit for bit;
//   * rows with mask 0 are NOT skipped: p - 0*g turns a non-finite g into
//     NaN exactly as the reference does;
//   * out of place: the tau loop's first input is a view of the global
//     params, and Delta = (theta0 - theta_tau) / lr needs theta0 afterwards;
//   * a (ceil(F / kChunk), L) grid, 64-bit offsets, 16-byte loads and stores
//     where F and the three bases allow them, a guarded scalar path
//     otherwise.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 16384;       // elements of a row per block

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
  return __float2bfloat16(v);       // round to nearest even, as torch casts
}

template <typename T>
__device__ __forceinline__ T apply(T p, T g, float s) {
  return from_f32<T>(__fsub_rn(to_f32(p), __fmul_rn(s, to_f32(g))));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
masked_update_kernel(const T* __restrict__ p, const T* __restrict__ g,
                     const float* __restrict__ mask, float lr,
                     T* __restrict__ out, long long F) {
  const int row = blockIdx.y;
  const float s = __fmul_rn(lr, mask[row]);
  const long long begin = (long long)blockIdx.x * kChunk;
  const long long end = begin + kChunk < F ? begin + kChunk : F;
  const long long off = (long long)row * F;
  if (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const uint4* pv = reinterpret_cast<const uint4*>(p + off + begin);
    const uint4* gv = reinterpret_cast<const uint4*>(g + off + begin);
    uint4* ov = reinterpret_cast<uint4*>(out + off + begin);
    const long long nvec = (end - begin) / kPer;
#pragma unroll 4
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 a = __ldg(pv + i);
      const uint4 b = __ldg(gv + i);
      uint4 c;
      const T* ea = reinterpret_cast<const T*>(&a);
      const T* eb = reinterpret_cast<const T*>(&b);
      T* ec = reinterpret_cast<T*>(&c);
#pragma unroll
      for (int k = 0; k < kPer; ++k) ec[k] = apply(ea[k], eb[k], s);
      ov[i] = c;
    }
  } else {
#pragma unroll 4
    for (long long i = begin + threadIdx.x; i < end; i += kThreads)
      out[off + i] = apply(p[off + i], g[off + i], s);
  }
}

template <typename T>
void launch(const void* p, const void* g, const float* mask, float lr,
            void* out, int L, long long F, cudaStream_t stream) {
  const dim3 grid((unsigned)((F + kChunk - 1) / kChunk), (unsigned)L);
  constexpr int kPer = 16 / sizeof(T);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p)
      | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out);
  const T* pt = static_cast<const T*>(p);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (F % kPer == 0 && (bases & 15) == 0)
    masked_update_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        pt, gt, mask, lr, ot, F);
  else
    masked_update_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        pt, gt, mask, lr, ot, F);
}

}  // namespace

extern "C" {

// p, g, out (L, F) bf16 (is_bf16 != 0) or f32, contiguous; mask (L,) f32.
int masked_sgd_update_launch(const void* p, const void* g, const void* mask,
                             float lr, void* out, int L, long long F,
                             int is_bf16, void* stream) {
  if (L < 1 || L > 65535 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (is_bf16)
    launch<__nv_bfloat16>(p, g, m, lr, out, L, F, s);
  else
    launch<float>(p, g, m, lr, out, L, F, s);
  return (int)cudaGetLastError();
}

const char* masked_sgd_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
