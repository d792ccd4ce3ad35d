// Per-row squared norm of a stacked (L, F) gradient leaf:
//
//   out[l] = sum_f  float(g[l, f])^2        (f32 sums, out (L,) f32)
//
// Replaces the TPU kernel repro/kernels/layer_grad_norm.py::layer_sq_norms_2d
// (pl.pallas_call at line 74, body _sqnorm_kernel at line 24): the probe's
// per-layer ||g_l||^2, once per stacked leaf per probe batch per client.
// g is bf16 or f32.
//
// What bounds it on the card: bytes.  One multiply-add per element read,
// far below the ~295 operations per byte where an H100 stops being
// memory-bound.  The least traffic is L*F*sizeof(g) + 4*L bytes (each
// element read once); a bf16 TinyLlama-1.1B gradient tree is ~1.94 GB.
//
// Design:
//   * the TPU walks a row's blocks in order and carries the sum in scratch;
//     here a row is too long for one block (F = 23.07 M at TinyLlama's
//     mlp_wi, with only L = 22 rows for 132 SMs), so pass 1 runs a grid of
//     (ceil(F / kChunk), L) blocks, each summing kChunk elements of one row
//     into an f32 partial in an (L, nb) scratch, and pass 2 (one block per
//     row) folds the partials;
//   * no atomics: every sum is a fixed per-thread stride order followed by
//     a fixed shuffle/shared-memory tree, so the result has the same bits on
//     every run.  The (P1) masks are a discrete function of these floats;
//   * 64-bit offsets: L*F reaches 5.07e8 elements at mlp_wi and passes 2^31
//     for larger models;
//   * rows whose length is a multiple of 16 bytes (and a 16-byte-aligned
//     base) are read with 16-byte loads; any other F (7 or 17, say) takes
//     a scalar path, and every chunk's ragged end is guarded.
//
// Launches on the caller's stream, allocates nothing (the wrapper passes
// the scratch), returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 65536;       // elements of a row per block (pass 1)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum of v over the block, valid in thread 0.  Fixed order: a shuffle tree
// within each warp, then warp 0 reduces the warps' sums the same way.
__device__ __forceinline__ float block_sum(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kThreads / 32 ? smem[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
sqnorm_partial_kernel(const T* __restrict__ g, float* __restrict__ partial,
                      long long F, int nb) {
  __shared__ float smem[kThreads / 32];
  const int row = blockIdx.y;
  const long long begin = (long long)blockIdx.x * kChunk;
  const long long end = begin + kChunk < F ? begin + kChunk : F;
  const T* base = g + (long long)row * F;
  float acc = 0.f;
  if (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    // begin and F are multiples of kPer here, so the chunk is whole vectors
    const uint4* vb = reinterpret_cast<const uint4*>(base + begin);
    const long long nvec = (end - begin) / kPer;
#pragma unroll 4
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 v = __ldg(vb + i);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float x = to_f32(e[k]);
        acc += x * x;
      }
    }
  } else {
#pragma unroll 4
    for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
      const float x = to_f32(base[i]);
      acc += x * x;
    }
  }
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) partial[(long long)row * nb + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
sqnorm_fold_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   int nb) {
  __shared__ float smem[kThreads / 32];
  const float* p = partial + (long long)blockIdx.x * nb;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nb; i += kThreads) acc += p[i];
  const float s = block_sum(acc, smem);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T>
void launch(const void* g, float* partial, float* out, int L, long long F,
            int nb, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  const dim3 grid((unsigned)nb, (unsigned)L);
  constexpr int kPer = 16 / sizeof(T);
  const bool vec = F % kPer == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (vec)
    sqnorm_partial_kernel<T, true><<<grid, kThreads, 0, stream>>>(gt, partial,
                                                                  F, nb);
  else
    sqnorm_partial_kernel<T, false><<<grid, kThreads, 0, stream>>>(gt, partial,
                                                                   F, nb);
  sqnorm_fold_kernel<<<L, kThreads, 0, stream>>>(partial, out, nb);
}

}  // namespace

extern "C" {

// Blocks per row of pass 1, i.e. the scratch's second dimension.
long long layer_sq_norms_blocks(long long F) { return (F + kChunk - 1) / kChunk; }

// g (L, F) bf16 (is_bf16 != 0) or f32, contiguous; partial (L, nb) f32
// scratch with nb = layer_sq_norms_blocks(F); out (L,) f32.
int layer_sq_norms_launch(const void* g, void* partial, void* out, int L,
                          long long F, int nb, int is_bf16, void* stream) {
  if (L < 1 || L > 65535 || F < 1 || nb != layer_sq_norms_blocks(F))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partial);
  float* po = static_cast<float*>(out);
  if (is_bf16)
    launch<__nv_bfloat16>(g, pp, po, L, F, nb, s);
  else
    launch<float>(g, pp, po, L, F, nb, s);
  return (int)cudaGetLastError();
}

const char* layer_sq_norms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
