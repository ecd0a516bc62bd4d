// A multistage cp.async + wgmma product core for Hopper (sm_90a), beside
// the staged mma.sync core of bottleneck.cuh: the bf16 and fp16 (T, a
// template parameter of every piece) 1x1 and 3x3 forwards
// (bottleneck_fwd.cu `mm_fwd_pipe`, `conv3_fwd_pipe`) and 3x3 and 1x1
// backwards (bottleneck_bwd.cu `conv3_bwd_pipe`, `mm_bwd_pipe`) run on it.
//
// The difference from `gemm_kernel`: the operands of a product are plain
// T rows in device memory (the 3x3 forward and backward write the
// activated input, and the backward the finalized cotangent, once, in a
// pre-pass, rather than recomputing them while staging), so every
// 16-byte row segment of a
// tile is one `cp.async` straight into shared memory, with src-size 0
// (zero-fill) for a segment outside the problem: a tap whose source
// pixel leaves the image, the ragged edge. A ring of kStages tiles keeps
// the loads of the next chunks in flight while chunk k multiplies, with
// one barrier a chunk. The product: wgmma m64nNk16 (T in, fp32
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
// (`epilogue`). The wgmma and cp.async pieces are in wgmma.cuh.
#pragma once

#include <algorithm>
#include <numeric>

#include "bottleneck.cuh"
#include "wgmma.cuh"

namespace apex_port {
namespace bneck {

template <typename T_, int BN_, bool kMNMajor_>
struct PCfg {
  using T = T_;  // bf16 or fp16
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

// The tile's fp32 accumulators: warpgroup g holds rows 64 g .. 64 g +
// 63, warp w of it rows 16 w .., each thread in wgmma's (mma.sync's) C
// layout per 8-column block.
template <typename T, int BN>
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
      wgmma_m64n128k16<T, kTrans, kTrans>(d, da, db);
    else
      wgmma_m64n64k16<T, kTrans, kTrans>(d, da, db);
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

// The tile's two column sums from the row groups' partials: thread
// (row group rg, 8-column segment at c) holds s1[j], s2[j] of columns c +
// j over its rows; the groups' sums are combined in group order through
// `red` (2 x groups x BN floats of shared memory: the tile's, once every
// thread has read it) into part[col] and part[width + col] for the
// tile's first `cols` columns. Every thread calls it.
template <int BN, int kRowGroups>
__device__ __forceinline__ void combine_row_groups(const float (&s1)[8],
                                                   const float (&s2)[8],
                                                   int rg, int c, int cols,
                                                   float* red, float* part,
                                                   int width) {
  __syncthreads();  // every thread is done reading the tile from red
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[rg * BN + c + j] = s1[j];
    red[(kRowGroups + rg) * BN + c + j] = s2[j];
  }
  __syncthreads();
  const int col = threadIdx.x;
  if (col < cols) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int gi = 0; gi < kRowGroups; ++gi) {
      t1 += red[gi * BN + col];
      t2 += red[(kRowGroups + gi) * BN + col];
    }
    part[col] = t1;
    part[width + col] = t2;
  }
}

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
  WAcc<typename C::T, C::BN> acc;
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

// Rows [r0, r0 + kRows) of a (rows, depth) 2-byte matrix whose depth is
// contiguous, columns [c0, c0 + 64), into a K-major tile (one 16-byte
// segment a copy, row tid / 8 + 32 i at segment tid % 8 for 256
// threads); rows at or past `rows` and columns at or past `depth`
// zero-filled. The A tile of a product over pixel rows, and the B tile of
// weights stored (N, K).
template <int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_kmajor_rows(unsigned char* tile,
                                                 const T* src,
                                                 int64_t rows, int depth,
                                                 int64_t r0, int c0) {
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v >> 3, cc = v & 7;
    const int c = c0 + cc * 8;
    const bool ok = r0 + r < rows && c < depth;
    cp_async16(tile + sw128(r, cc), ok ? src + (r0 + r) * depth + c : src,
               ok);
  }
}

template <class Prob>
cudaError_t launch_pipe(const Prob& p, dim3 grid, cudaStream_t stream) {
  using C = typename Prob::Cfg;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  // every call: a function-local "once" flag in this header would be one
  // symbol across the libraries that include it (bottleneck_fwd.cu,
  // bottleneck_bwd.cu), each of which registers its own kernels
  const cudaError_t err = cudaFuncSetAttribute(
      pipe_kernel<Prob>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (err != cudaSuccess) return err;
  pipe_kernel<Prob><<<grid, C::kThreads, C::kSmemBytes, stream>>>(p);
  note_launch("pipe_kernel", typeid(Prob).name());
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the pre-passes' shared pieces
// ---------------------------------------------------------------------------

// Blocks of 256 threads for a pre-pass over M rows of c1 and of c2
// channels, 8 a thread, at most 16 a multiprocessor: a multiple of
// `step` blocks, so that 256 step threads divide by c1 / 8 and c2 / 8
// and a thread keeps its channels over its grid-stride steps.
inline int prepass_blocks(int64_t M, int c1, int c2, int sms) {
  const int64_t step =
      std::lcm(std::lcm(int64_t{256}, int64_t{c1 / 8}), int64_t{c2 / 8}) /
      256;
  const int64_t segs = M * std::max(c1, c2) / 8;
  const int64_t want =
      std::min<int64_t>((segs + 255) / 256, static_cast<int64_t>(sms) * 16);
  return segs > 0 ? static_cast<int>((want + step - 1) / step * step) : 0;
}

// u = relu(x a + b) over M rows of C channels, in T with `prologue_dt`'s
// rounding (that of the staged forms), 8 channels a thread from thread
// `tid` on in steps of `stride` threads (a multiple of C / 8: a thread
// keeps its channels)
template <typename T>
__device__ __forceinline__ void prologue_rows(const T* __restrict__ x,
                                              const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              T* __restrict__ u, int64_t M,
                                              int C, int64_t tid,
                                              int64_t stride) {
  const int k = static_cast<int>(tid % (C / 8)) * 8;
  float a8[8], b8[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a8[i] = round_to<T>(a[k + i]);
    b8[i] = round_to<T>(b[k + i]);
  }
  for (int64_t off = tid * 8; off < M * C; off += stride * 8) {
    float xv[8];
    load8<T>(x + off, xv);
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = prologue_dt<T>(xv[i], a8[i], b8[i]);
    store_vec_packed<T, 8>(u + off, xv);
  }
}

// (h, w) of flat pixel p of an (n, H, W) stream (32-bit: the wrappers
// keep the pixel count below 2^31)
__device__ __forceinline__ void pixel_hw(int64_t p, int H, int W, int& h,
                                         int& w) {
  const int rem = static_cast<int>(p) % (H * W);
  h = rem / W;
  w = rem - h * W;
}

// A thread's share of the A tile of an implicit 3x3 product over 128
// pixels (the forward, and the backward's dgrad): rows tid / 8 + 32 i at
// 16-byte segment tid % 8, their pixels' (h, w) (h far outside the image
// past the last pixel, so that no tap is valid there), and the next
// chunk's tap and channel offset: chunks are loaded once each, in order,
// tap-major over C channels in BK-deep runs.
struct TapRows {
  int h[4], w[4];
  int t, c0;

  __device__ __forceinline__ void init(int64_t m0, int64_t M, int H,
                                       int W) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q = m0 + (threadIdx.x >> 3) + 32 * i;
      if (q < M) {
        pixel_hw(q, H, W, h[i], w[i]);
      } else {
        h[i] = -4 * H;
        w[i] = 0;
      }
    }
    t = 0;
    c0 = 0;
  }

  // the chunk's (tap, channel offset), then on to the next chunk
  __device__ __forceinline__ void next(int bk, int C, int& tap, int& ch) {
    tap = t;
    ch = c0;
    c0 += bk;
    if (c0 >= C) {
      c0 = 0;
      ++t;
    }
  }

  // whether row i's pixel shifted by (dy, dx) lies in the image
  __device__ __forceinline__ bool in_image(int i, int dy, int dx, int H,
                                           int W) const {
    const int hs = h[i] + dy, ws = w[i] + dx;
    return hs >= 0 && hs < H && ws >= 0 && ws < W;
  }
};

}  // namespace bneck
}  // namespace apex_port
