// Tensor-core helpers of the mma.sync kernels (the bias gradient,
// flash_dbias.cu, and bottleneck.cuh's staged core): the m16n8k16 product
// (bf16 in, fp32 accumulate), bf16 packing and the fragment loaders.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major) a0: (g, 2t..2t+1)  a1: (g+8, 2t..)
//                          a2: (g, 2t+8..)    a3: (g+8, 2t+8..)
//   B (16 x 8, k x n)      b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g)
//   C (16 x 8)             c0,c1: (g, 2t..2t+1)   c2,c3: (g+8, 2t..)
// Each 32-bit register holds two bf16, the lower column in the low half.
// So an operand whose k runs along a shared-memory row is read with
// ldmatrix (non-transposed).
#pragma once

#include "common.cuh"

namespace apex_port {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix.x4: four 8 x 8 bf16 matrices from shared memory, lane l
// naming row l % 8 of matrix l / 8; register i gets, on lane l, the
// word (row l / 4, columns 2 (l % 4) ..+1) of matrix i — one fragment
// register. Rows are 16 bytes and 16-byte aligned.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a
// row-major bf16 tile (row stride ld).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  ldsm_x4(a, m + (r0 + (mi & 1) * 8 + (lane & 7)) * ld + c0 + (mi >> 1) * 8);
}

// B fragments (b0, b1) of two adjacent 8-column blocks n and n + 1 for
// the k-step [c0, c0 + 16), from a tile stored n-major ([n][k], row
// stride ld): b[0], b[1] for block n at rows n0.., b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const bf16* m,
                                        int ld, int n0, int c0) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  ldsm_x4(b, m + (n0 + (mi >> 1) * 8 + (lane & 7)) * ld + c0 + (mi & 1) * 8);
}

}  // namespace apex_port
