// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by the
// port's hand-written kernels: bf16 mma.sync m16n8k16 with f32
// accumulation, ldmatrix (plain and transposed), 16-byte cp.async with
// zero fill, and the two halves of programmatic dependent launch.  Inline
// PTX only; no CUTLASS/CuTe, so a source that includes this compiles in
// seconds.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane l, g = l / 4,
// t = l % 4), each register two bf16 (low half first) or one f32:
//   A (16 x 16): a0 (row g, cols 2t..2t+1), a1 (row g+8, cols 2t..),
//                a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B (16 x 8):  b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g);
//   C (16 x 8):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same).
// So the C fragments of two neighbouring n-tiles, rounded to bf16 and
// packed in pairs, are the A fragment of one k-step of 16: a product's
// result feeds the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives matrix i's fragment (thread l: row l / 4,
// elements 2(l % 4) and 2(l % 4) + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed (thread l: column l / 4, rows 2(l % 4)
// and 2(l % 4) + 1): the B fragment of a [k][n] tile with n contiguous.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on the tensor cores: bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of one k-step from the C fragments of n-tiles 2j and 2j + 1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes global -> shared, bypassing L1; only the first src_bytes (0..16)
// are read and the rest of the 16 are zero-filled.  Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared (src_bytes 0 or 4).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit (flushes subnormal results to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sum and max over the four lanes of a quad (one row of a C fragment).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Programmatic dependent launch: a grid launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// block of the grid before it has called grid_dependents_launch (or ended),
// and grid_dependency_wait blocks until that grid has finished and its
// writes are visible.
__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

}  // namespace mma_sm90
