// Fused "base + per-slot delta" projection for personalized-delta serving.
//
//   y[b] = x[b] @ w  +  sum_{e : slots[e] == b}  x[b] @ dw[e]
//
// Replaces the TPU kernel repro/kernels/delta_matmul.py::base_delta_matmul_2d
// (pl.pallas_call at line 126, body at line 120).  x (B, d) and w (d, f) are
// bf16 or f32, dw (C, d, f) is f32 (the overlay's leaves), slots (C,) int32
// with -1 for an empty entry, out (B, f) in x's type.  Sums are f32.
//
// What bounds it on the card: bytes.  At decode batch B <= 16 the kernel
// does 2*B operations for every element of w it reads, far below the ~295
// operations per byte where an H100 stops being memory-bound.  The least
// traffic is
//     d*f*sizeof(w) + n_live*d*f*4 + B*d*sizeof(x) + B*f*sizeof(out)
// (n_live = entries with slots[e] >= 0), so the kernel reads every element
// of w and of each live dw[e] once, never touches an empty entry's slab, and
// reads slots on the card (no host sync).  Reaching that rate takes many
// bytes in flight on every SM, which a grid of one block per column tile
// does not give at a narrow f (f = 256 filled 8 of 132 SMs, each block
// walking all of d).  So:
//   * the grid is (column tile) x (d-split): the blocks of one column tile
//     take disjoint row ranges of d.  The split is planned on the host from
//     (B, d, f) alone (kernels/delta_matmul.py::plan, >= 264 blocks at every
//     TinyLlama shape), never from the SM count, so the bits are the same on
//     any card;
//   * each lane reads 16 bytes per row: 8 bf16 columns of w (two 16-byte
//     loads for 8 f32 columns of w or dw).  `lpr` lanes cover one row
//     segment of 8*lpr columns (lpr = 32, 16 or 8: 512, 256 or 128 bytes of
//     bf16, whole 32-byte sectors), so a warp reads 32/lpr rows at a time;
//   * 64 bytes of row loads in flight per lane (4 rows of bf16, 2 of f32),
//     the first rows' loads issued before x is staged; registers are held
//     to what lets 3 blocks share an SM at B <= 4 (2 at B <= 8), so that
//     every planned grid at TinyLlama's shapes runs in one wave, with
//     3 x 256 x 64 bytes = 48 KB in flight on every SM;
//   * x is staged once per block in f32 through shared memory (the split
//     caps a block at kMaxRows rows); bf16 is widened in registers, no f32
//     copy of the weights is ever written;
//   * corrections: each live entry e, s = slots[e], is one more pass over
//     the block's rows of dw[e] into its own f32 partial, added to row s of
//     the block's sums; several entries on one slot each add theirs, in
//     entry order;
//   * reduction: the rows a warp read at one time meet by shuffles, the
//     8 warps in shared memory, in a fixed order; each block writes its f32
//     partial sums to scratch (splits, B, f) that the wrapper allocates, and
//     a second small kernel folds the splits in order (fixed 8-lane trees),
//     launched as a programmatic dependent of the first so that its launch
//     overlaps the first's tail.  No atomics: two launches give the same
//     bits.  With one split the first kernel writes y itself.
//
// Launches on the caller's stream, allocates nothing, returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;                   // columns per lane
constexpr int kMaxTile = 32 * kVec;       // columns per block at lpr = 32
constexpr int kMaxRows = 512;             // rows of d per block (plan's cap)
constexpr int kFoldLanes = 8;             // lanes per output in the fold
constexpr int kStagedSlots = 64;          // slots read once into shared memory

// Rows of a (d, f) matrix of T a lane has in flight: 64 bytes.
template <typename T>
__host__ __device__ constexpr int rows_in_flight() {
  return 64 / (kVec * (int)sizeof(T));
}

// Blocks of the kernel an SM should hold at batch bound MAXB (the register
// budget: 80 registers a thread at 3, 128 at 2).
template <int MAXB>
__host__ __device__ constexpr int min_blocks() {
  return MAXB <= 4 ? 3 : MAXB <= 8 ? 2 : 1;
}

// Rows of the batch the block reduction takes at once (its shared buffer
// stays within the 48 KB of static shared memory beside x's).
template <int MAXB>
__host__ __device__ constexpr int red_rows() {
  return MAXB <= 4 ? MAXB : MAXB <= 8 ? 2 : 1;
}

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

// kVec consecutive elements of one row, loaded raw and widened on use.
// n: how many are real (<= 0: none, all read as 0); vec: the 16-byte path
// may be taken (the row segment is 16-byte aligned).
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n,
                                       bool vec) {
    if (vec && n >= kVec) {
      r = __ldg(reinterpret_cast<const uint4*>(p));
      return;
    }
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    uint32_t h[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) h[i] = i < n ? __ldg(q + i) : 0u;
    r = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                   h[6] | h[7] << 16);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const uint32_t v = (i >> 1) == 0 ? r.x : (i >> 1) == 1 ? r.y
                       : (i >> 1) == 2 ? r.z : r.w;
    return __uint_as_float((i & 1) ? (v & 0xffff0000u) : (v << 16));
  }
};

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p, int n, bool vec) {
    if (vec && n >= kVec) {
      a = __ldg(reinterpret_cast<const float4*>(p));
      b = __ldg(reinterpret_cast<const float4*>(p) + 1);
      return;
    }
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = i < n ? __ldg(p + i) : 0.f;
    a = make_float4(v[0], v[1], v[2], v[3]);
    b = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ float operator[](int i) const {
    const float4& h = i < 4 ? a : b;
    const int j = i & 3;
    return j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w;
  }
};

// The U rows of a (d, f) matrix m at block rows kb, kb + step, ... that
// this lane reads (none past nk).
template <typename T, int U>
__device__ __forceinline__ void load_rows(Row8<T> (&v)[U],
                                          const T* __restrict__ m, int kb,
                                          int step, int k0, int nk, int f,
                                          int c0, int ncol, bool vec) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int kk = kb + u * step;
    v[u].load(m + (size_t)(k0 + kk) * f + c0, kk < nk ? ncol : 0, vec);
  }
}

// One pass over the block's rows of a (d, f) matrix m, the first U rows
// already in v: acc[b][i] += sx[k][b] * m[k][c0 + i] for b < NB (NB = 1:
// the row of x given by xcol).  Each step uses the U rows in v, then loads
// the next U.
template <typename T, int U, int NB, int LDX>
__device__ __forceinline__ void row_pass(float (&acc)[NB][kVec],
                                         Row8<T> (&v)[U],
                                         const T* __restrict__ m,
                                         const float (*sx)[LDX], int xcol,
                                         int k0, int nk, int f, int c0,
                                         int ncol, int first, int step,
                                         bool vec) {
  for (int kb = first; kb < nk; kb += U * step) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kb + u * step;
      if (kk >= nk) break;
      float xs[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) xs[b] = sx[kk][NB == 1 ? xcol : b];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float wv = v[u][i];
#pragma unroll
        for (int b = 0; b < NB; ++b) acc[b][i] = fmaf(xs[b], wv, acc[b][i]);
      }
    }
    if (kb + U * step < nk)
      load_rows(v, m, kb + U * step, step, k0, nk, f, c0, ncol, vec);
  }
}

template <typename TX, typename TW, int MAXB>
__global__ void __launch_bounds__(kThreads, min_blocks<MAXB>())
delta_split_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   const float* __restrict__ dw,
                   const int* __restrict__ slots, float* __restrict__ part,
                   TX* __restrict__ out, int B, int d, int f, int C, int lpr,
                   int rows, bool vec_w, bool vec_dw) {
  constexpr int RB = red_rows<MAXB>();
  constexpr int UW = rows_in_flight<TW>(), UD = rows_in_flight<float>();
  // +1 pads the batch axis so the staging writes do not share a bank
  __shared__ float sx[kMaxRows][MAXB + 1];
  __shared__ float red[kWarps][RB][kMaxTile];
  __shared__ int s_slots[kStagedSlots];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / lpr;                   // rows a warp reads at a time
  const int sub = lane / lpr, cl = lane % lpr;
  const int tile = lpr * kVec;
  const int c0 = blockIdx.x * tile + cl * kVec;
  const int ncol = min(kVec, f - c0);         // <= 0 past the ragged edge
  const int k0 = blockIdx.y * rows;
  const int nk = min(rows, d - k0);
  const int step = kWarps * rpw, first = warp * rpw + sub;

  // the first rows of w are in flight while x is staged
  Row8<TW> vw[UW];
  load_rows(vw, w, first, step, k0, nk, f, c0, ncol, vec_w);
  mma_sm90::grid_dependents_launch();

  for (int i = threadIdx.x; i < nk * MAXB; i += kThreads) {
    const int b = i / nk, kk = i - b * nk;
    sx[kk][b] = b < B ? to_f32(x[(size_t)b * d + k0 + kk]) : 0.f;
  }
  for (int e = threadIdx.x; e < min(C, kStagedSlots); e += kThreads)
    s_slots[e] = slots[e];
  __syncthreads();

  float acc[MAXB][kVec];
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[b][i] = 0.f;
  row_pass(acc, vw, w, sx, 0, k0, nk, f, c0, ncol, first, step, vec_w);

  // per-slot corrections in entry order; an empty entry's slab is not read
  for (int e = 0; e < C; ++e) {
    const int s = e < kStagedSlots ? s_slots[e] : slots[e];
    if (s < 0 || s >= B) continue;
    const float* dwe = dw + (size_t)e * d * f;
    float corr[1][kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) corr[0][i] = 0.f;
    Row8<float> vd[UD];
    load_rows(vd, dwe, first, step, k0, nk, f, c0, ncol, vec_dw);
    row_pass(corr, vd, dwe, sx, s, k0, nk, f, c0, ncol, first, step, vec_dw);
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b == s)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[b][i] += corr[0][i];
  }

  // the rows one warp read at a time meet by shuffles (a + b == b + a, so
  // every sub-row lane ends with the same bits)
  for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        acc[b][i] += __shfl_xor_sync(0xffffffffu, acc[b][i], off);

  // then the warps, in order; RB rows of the batch at a time
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int b0 = 0; b0 < MAXB; b0 += RB) {
    if (b0 >= B) break;
    if (sub == 0)
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          red[warp][r][cl * kVec + i] = acc[b0 + r][i];
    __syncthreads();
    for (int t = threadIdx.x; t < RB * tile; t += kThreads) {
      const int r = t / tile, c = t - r * tile, b = b0 + r;
      const int j = blockIdx.x * tile + c;
      if (b < B && j < f) {
        float sum = red[0][r][c];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) sum += red[q][r][c];
        if (direct)
          out[(size_t)b * f + j] = from_f32<TX>(sum);
        else
          part[((size_t)blockIdx.y * B + b) * f + j] = sum;
      }
    }
    __syncthreads();
  }
}

// out[i] = sum over p of part[p][i], i < n = B * f: kFoldLanes lanes per
// output, lane r summing splits r, r + kFoldLanes, ... in order, then a
// fixed xor tree.  Depends on the split count alone.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
delta_fold_kernel(const float* __restrict__ part, TX* __restrict__ out,
                  int splits, int n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / kFoldLanes;
  const int r = (int)(t % kFoldLanes);
  mma_sm90::grid_dependency_wait();        // the partial sums are written
  float s = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int p = r; p < splits; p += kFoldLanes) s += part[(size_t)p * n + i];
  }
#pragma unroll
  for (int off = 1; off < kFoldLanes; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (i < n && r == 0) out[i] = from_f32<TX>(s);
}

template <typename TX, typename TW>
cudaError_t launch_typed(const void* x, const void* w, const void* dw,
                         const void* slots, void* out, void* part, int B,
                         int d, int f, int C, int lpr, int rows,
                         cudaStream_t stream) {
  const int tile = lpr * kVec;
  const int splits = (d + rows - 1) / rows;
  const dim3 grid((f + tile - 1) / tile, splits);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const float* dwp = static_cast<const float*>(dw);
  const int* sp = static_cast<const int*>(slots);
  float* pp = static_cast<float*>(part);
  TX* op = static_cast<TX*>(out);
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0
                     && ((size_t)f * sizeof(TW)) % 16 == 0;
  const bool vec_dw = reinterpret_cast<uintptr_t>(dw) % 16 == 0 && f % 4 == 0;
  if (B <= 4) {
    delta_split_kernel<TX, TW, 4><<<grid, kThreads, 0, stream>>>(
        xp, wp, dwp, sp, pp, op, B, d, f, C, lpr, rows, vec_w, vec_dw);
  } else if (B <= 8) {
    delta_split_kernel<TX, TW, 8><<<grid, kThreads, 0, stream>>>(
        xp, wp, dwp, sp, pp, op, B, d, f, C, lpr, rows, vec_w, vec_dw);
  } else {
    delta_split_kernel<TX, TW, 16><<<grid, kThreads, 0, stream>>>(
        xp, wp, dwp, sp, pp, op, B, d, f, C, lpr, rows, vec_w, vec_dw);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int n = B * f;
  const long long threads = (long long)n * kFoldLanes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((threads + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cpp = pp;
  return cudaLaunchKernelEx(&cfg, delta_fold_kernel<TX>, cpp, op, splits, n);
}

}  // namespace

extern "C" {

// Limits the planner (kernels/delta_matmul.py::plan) must keep to.
int base_delta_matmul_max_rows() { return kMaxRows; }

// B above 16 is refused (MAX_BATCH in kernels/delta_matmul.py).  lpr (lanes
// per row segment: 32, 16 or 8) and rows (rows of d per block, <= kMaxRows)
// are the plan; part is f32 scratch of ceil(d / rows) * B * f elements, or
// null when rows >= d.
int base_delta_matmul_launch(const void* x, const void* w, const void* dw,
                             const void* slots, void* out, void* part, int B,
                             int d, int f, int C, int x_bf16, int w_bf16,
                             int lpr, int rows, void* stream) {
  if (B < 1 || B > 16 || d < 1 || f < 1 || C < 0 || rows < 1
      || rows > kMaxRows || (lpr != 32 && lpr != 16 && lpr != 8)
      || (d + rows - 1) / rows > 65535 || (rows < d && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16 && w_bf16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        x, w, dw, slots, out, part, B, d, f, C, lpr, rows, s);
  else if (x_bf16)
    err = launch_typed<__nv_bfloat16, float>(x, w, dw, slots, out, part, B,
                                             d, f, C, lpr, rows, s);
  else if (w_bf16)
    err = launch_typed<float, __nv_bfloat16>(x, w, dw, slots, out, part, B,
                                             d, f, C, lpr, rows, s);
  else
    err = launch_typed<float, float>(x, w, dw, slots, out, part, B, d, f, C,
                                     lpr, rows, s);
  return static_cast<int>(err);
}

const char* base_delta_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
