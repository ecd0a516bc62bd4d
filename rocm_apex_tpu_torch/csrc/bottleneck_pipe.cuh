// A multistage cp.async + wgmma product core for Hopper (sm_90a), beside
// the staged mma.sync core of bottleneck.cuh: the bf16 3x3 and 1x1
// backwards (bottleneck_bwd.cu `conv3_bwd_bf16`, `mm_bwd_bf16`) run on
// it, and the forwards may move onto it later.
//
// The difference from `gemm_kernel`: the operands of a product are plain
// bf16 rows in device memory (the 3x3 backward writes the finalized
// cotangent and the activated input once, in a pre-pass, rather than
// recomputing them while staging), so every 16-byte row segment of a
// tile is one `cp.async` straight into shared memory, with src-size 0
// (zero-fill) for a segment outside the problem: a tap whose source
// pixel leaves the image, the ragged edge. A ring of kStages tiles keeps
// the loads of the next chunks in flight while chunk k multiplies, with
// one barrier a chunk. The product: wgmma m64nNk16 (bf16 in, fp32
// accumulators in registers), two warpgroups each taking 64 rows of a
// 128 x BN tile (BN 128 or 64), the operands read from shared memory in
// the 128-byte-swizzled layout wgmma's descriptors name: K-major (k
// contiguous, a dgrad's) or MN-major (the pixels down the tile, as a
// wgrad's two sources lie; wgmma transposes them). 64-deep chunks, 3
// stages of 32 KB (BN 128), two blocks a multiprocessor.
//
// A problem (a struct of the .cu file) says how many chunks its tile
// has, precomputes what a thread's staging needs once (`Thread`, which
// `load` may advance: chunks are loaded once each, in order), issues
// the copies of chunk kc (`load`) and consumes the fp32 accumulators
// (`epilogue`).
#pragma once

#include "bottleneck.cuh"

namespace apex_port {
namespace bneck {

// ---------------------------------------------------------------------------
// wgmma: a warpgroup's asynchronous m64nNk16 product from shared memory
// ---------------------------------------------------------------------------

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
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int BN_, bool kMNMajor_>
struct PCfg {
  static constexpr int BM = 128, BN = BN_, BK = 64;
  static constexpr int kStages = 3, kThreads = 256;
  static constexpr bool kMNMajor = kMNMajor_;
  static constexpr int kTrans = kMNMajor ? 1 : 0;
  static constexpr int kABytes = BM * BK * 2, kBBytes = BN * BK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // descriptor byte offsets: 8 rows of 128 bytes between 8-row groups;
  // MN-major, 64-element MN blocks of BK rows each (unused K-major); the
  // start address a 16-deep k step on; a warpgroup's 64 rows of A (64
  // rows of 128 bytes K-major, one MN block MN-major)
  static constexpr uint32_t kSbo = 1024, kLbo = kMNMajor ? BK * 128 : 16;
  static constexpr uint32_t kKStep = kMNMajor ? 16 * 128 : 32;
  static constexpr uint32_t kWarpgroupA = 64 * 128;
  static constexpr int LDC = BN + 4;
  static constexpr int kPipeBytes = kStages * kStageBytes;
  static constexpr int kCBytes = BM * LDC * 4;
  // + 1024: the tiles start on a 1024-byte boundary
  static constexpr int kSmemBytes =
      (kPipeBytes > kCBytes ? kPipeBytes : kCBytes) + 1024;
  static_assert(BN == 128 || BN == 64, "tile width 128 or 64");
};

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

// The tile's fp32 accumulators: warpgroup g holds rows 64 g .. 64 g +
// 63, warp w of it rows 16 w .., each thread in wgmma's (mma.sync's) C
// layout per 8-column block.
template <int BN>
struct WAcc {
  float d[BN / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  }

  // keeps the compiler from moving the registers across the asynchronous
  // products
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }

  template <int kTrans>
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db) {
    if constexpr (BN == 128)
      wgmma_m64n128k16<kTrans, kTrans>(d, da, db);
    else
      wgmma_m64n64k16<kTrans, kTrans>(d, da, db);
  }

  // fn(r, col, v0, v1): the tile's elements (r, col) and (r, col + 1)
  template <class Fn>
  __device__ __forceinline__ void for_pairs(Fn fn) const {
    const int lane = threadIdx.x & 31;
    const int r = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 +
                  (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      fn(r, col, d[4 * j], d[4 * j + 1]);
      fn(r + 8, col, d[4 * j + 2], d[4 * j + 3]);
    }
  }

  __device__ __forceinline__ void store(float* Cs, int ldc) const {
    for_pairs([&](int r, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(Cs + r * ldc + col) = make_float2(v0, v1);
    });
  }
};

// One block: the ring filled kStages - 1 chunks ahead; each chunk waited
// for (the copies made visible to wgmma's proxy), multiplied (BK / 16
// wgmma a warpgroup) while the slot freed a chunk earlier is refilled,
// the products waited for before the next barrier; then the problem's
// epilogue (shared memory free for its use).
template <class Prob>
__global__ void __launch_bounds__(256, 2) pipe_kernel(Prob p) {
  using C = typename Prob::Cfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  typename Prob::Thread th = p.thread_init();
  const int n = p.chunks();
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n)
      p.load(th, s, smem + s * C::kStageBytes,
             smem + s * C::kStageBytes + C::kABytes);
    cp_async_commit();
  }
  WAcc<C::BN> acc;
  acc.zero();
  const uint32_t a_off = (threadIdx.x >> 7) * C::kWarpgroupA;
  for (int kc = 0; kc < n; ++kc) {
    cp_async_wait<C::kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    // the products of chunk kc first, then, while they run, the copies
    // into the slot chunk kc - 1 freed
    const unsigned char* a = smem + (kc % C::kStages) * C::kStageBytes;
    const unsigned char* b = a + C::kABytes;
    acc.fence();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
      acc.template mma<C::kTrans>(
          gmma_desc(a + a_off + kk * C::kKStep, C::kLbo, C::kSbo),
          gmma_desc(b + kk * C::kKStep, C::kLbo, C::kSbo));
    wgmma_commit();
    const int nx = kc + C::kStages - 1;
    if (nx < n) {
      unsigned char* st = smem + (nx % C::kStages) * C::kStageBytes;
      p.load(th, nx, st, st + C::kABytes);
    }
    cp_async_commit();
    wgmma_wait<0>();
    acc.fence();
  }
  cp_async_wait<0>();
  __syncthreads();
  p.epilogue(acc, reinterpret_cast<float*>(smem));
}

template <class Prob>
cudaError_t launch_pipe(const Prob& p, dim3 grid, cudaStream_t stream) {
  using C = typename Prob::Cfg;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  static bool attr_set = false;  // once per instance and process
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        pipe_kernel<Prob>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  pipe_kernel<Prob><<<grid, C::kThreads, C::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bneck
}  // namespace apex_port
