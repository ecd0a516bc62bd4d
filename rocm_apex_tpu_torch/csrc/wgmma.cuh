// Hopper's asynchronous pieces, shared by the wgmma kernels: the
// 128-byte swizzle and the shared-memory matrix descriptors wgmma reads,
// wgmma m64nNk16 (bf16 or fp16 in, the operand type T a template
// parameter; fp32 accumulators in registers) with A from
// shared memory or from registers, the fences that order it, and cp.async
// with zero-fill. The bottleneck pipe (bottleneck_pipe.cuh) and the
// flash-forward pipe (flash_fwd_pipe.cuh) are built on them; the layouts
// were settled by a one-tile probe against torch.matmul.
#pragma once

#include "common.cuh"

namespace apex_port {

// 128-byte swizzle: 16-byte chunk c (0..7) of row r of a tile of 128-byte
// rows lies at byte r * 128 + ((c ^ (r % 8)) * 16); a tile starts on a
// 1024-byte boundary
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// the shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x N, fp32, the mma.sync C layout per 8-column block: d[4 j ..
// 4 j + 3] of n-block j) += A (64 x 16) B (16 x N); kTransA / kTransB 0:
// the operand K-major (k contiguous), 1: MN-major
#define APEX_WG_SS128(TY)                                                     \
  asm volatile(                                                               \
      "{\n"                                                                   \
      ".reg .pred p;\n"                                                       \
      "setp.ne.b32 p, %66, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, %64, %65, p, 1, 1, %67, %68;\n"                                     \
      "}\n"                                                                   \
      :                                                                       \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB))
template <typename T, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  if constexpr (kIsF16<T>)
    APEX_WG_SS128("f16");
  else
    APEX_WG_SS128("bf16");
}

#define APEX_WG_SS64(TY)                                                      \
  asm volatile(                                                               \
      "{\n"                                                                   \
      ".reg .pred p;\n"                                                       \
      "setp.ne.b32 p, %34, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                \
      "}, %32, %33, p, 1, 1, %35, %36;\n"                                     \
      "}\n"                                                                   \
      :                                                                       \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB))
template <typename T, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  if constexpr (kIsF16<T>)
    APEX_WG_SS64("f16");
  else
    APEX_WG_SS64("bf16");
}

// D (64 x N, fp32, as above) += A (64 x 16, T from registers: each
// warp its 16 rows in mma.sync's A-fragment layout, a[0..3]) B (16 x N
// from shared memory); kTransB 0: B K-major, 1: MN-major
#define APEX_WG_RS128(TY)                                                     \
  asm volatile(                                                               \
      "{\n"                                                                   \
      ".reg .pred p;\n"                                                       \
      "setp.ne.b32 p, %69, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"                         \
      "}\n"                                                                   \
      :                                                                       \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),          \
        "n"(kTransB))
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  if constexpr (kIsF16<T>)
    APEX_WG_RS128("f16");
  else
    APEX_WG_RS128("bf16");
}

#define APEX_WG_RS64(TY)                                                      \
  asm volatile(                                                               \
      "{\n"                                                                   \
      ".reg .pred p;\n"                                                       \
      "setp.ne.b32 p, %37, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"                         \
      "}\n"                                                                   \
      :                                                                       \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),          \
        "n"(kTransB))
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  if constexpr (kIsF16<T>)
    APEX_WG_RS64("f16");
  else
    APEX_WG_RS64("bf16");
}
// wgmma_m64n128k16_rs into d[kOff, kOff + 64) of a longer accumulator:
// at head_dim 256 the 256 columns of p v are two 128-column products,
// d[0, 64) the first and d[64, 128) the second (the m64nN layout puts
// 8-column block nb at d[4 nb, 4 nb + 4), so the halves keep the indexing
// of one 256-column accumulator)
#define APEX_WG_F8(o)                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),             \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define APEX_WG_RS128_AT(TY)                                                  \
  asm volatile(                                                               \
      "{\n"                                                                   \
      ".reg .pred p;\n"                                                       \
      "setp.ne.b32 p, %69, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"                         \
      "}\n"                                                                   \
      : APEX_WG_F8(kOff), APEX_WG_F8(kOff + 8), APEX_WG_F8(kOff + 16),        \
        APEX_WG_F8(kOff + 24), APEX_WG_F8(kOff + 32), APEX_WG_F8(kOff + 40),  \
        APEX_WG_F8(kOff + 48), APEX_WG_F8(kOff + 56)                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),          \
        "n"(kTransB))
template <typename T, int kTransB, int kOff, int N>
__device__ __forceinline__ void wgmma_m64n128k16_rs_at(
    float (&d)[N], const uint32_t (&a)[4], uint64_t db) {
  static_assert(kOff + 64 <= N, "the accumulator's slice");
  if constexpr (kIsF16<T>)
    APEX_WG_RS128_AT("f16");
  else
    APEX_WG_RS128_AT("bf16");
}
#undef APEX_WG_F8
#undef APEX_WG_SS128
#undef APEX_WG_SS64
#undef APEX_WG_RS128
#undef APEX_WG_RS64
#undef APEX_WG_RS128_AT

// where 16-byte segment (r, c) of an MN-major tile lies: BK rows of k,
// the MN axis in blocks of 64 (c over the MN axis); a K-major tile is
// rows of 64 k, segment (r, c) at sw128(r, c)
__device__ __forceinline__ uint32_t mnmajor_seg(int r, int c) {
  return static_cast<uint32_t>((c >> 3) * 64 * 128) + sw128(r, c & 7);
}

// 16 bytes global -> shared, asynchronously; zero-fill where !valid (the
// source address is then not read, but kept inside the tensor)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace apex_port
