// The fused ResNet bottleneck's convolutions for Hopper (sm_90a): one
// tiled product core shared by the kernels of bottleneck_fwd.cu and
// bottleneck_bwd.cu (all but the bf16 3x3 forward and backward and the
// bf16 1x1 backward at widths that are multiples of 64, which run on
// bottleneck_pipe.cuh), the staging helpers that apply a prologue while
// a tile is written to shared memory, and the fixed-order reduction of
// per-block partial sums.
//
// Every product is C (rows x cols) = sum over a reduction axis of
// A[row][k] * B[col][k]. A problem (a struct of the .cu files) says how
// many reduction chunks its tile has and stages chunk kc of A into
// As[BM][LDS] and of B into Bs[BN][LDS], both k-contiguous, computing
// each element on the way (the BN-apply + ReLU prologue, the BN-backward
// finalize, the tap validity of a 3x3): no operand of a product is ever
// written to device memory. The accumulators then go to shared memory
// (Cs[BM][LDC], fp32) and the problem's epilogue walks them a column per
// thread, down the rows in order: the stores of a warp cover consecutive
// channels of one pixel, and the per-channel sums (BN statistics, the
// upstream reductions) are summed in a fixed order, written as one fp32
// partial per block, and reduced over the blocks in a fixed order by
// `reduce_parts`: no atomics, so a run repeats itself bit for bit.
//
// bf16 and fp16: 128 x 64 tiles, 4 warps of 64 x 32, mma.sync m16n8k16
// with fp32 accumulators, fragments by ldmatrix from rows padded to 80 bytes; a
// wgrad, whose reduction axis (the pixels) runs down both sources, stages
// its tiles k-major as they lie and forms the fragments with
// ldmatrix.trans.
// fp32 (the parity runs): 64 x 64 tiles on the CUDA cores, a 4 x 4 block
// of outputs a thread. No cp.async ring, no wgmma: one chunk staged, one
// chunk multiplied, in turn (simple first; PERF.md has its times).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace apex_port {
namespace bneck {

template <typename T>
struct Cfg;

// the 2-byte types (bf16, fp16) share one layout and one mma.sync body
struct CfgHalf {
  static constexpr int BM = 128, BN = 64, BK = 32, kThreads = 128;
  static constexpr int LDS = BK + 8;  // 80-byte rows: 16-byte aligned
  static constexpr int LDC = BN + 4;
  // k-major tiles (the wgrad's): At[BK][LDA_T], Bt[BK][LDB_T]; rows of
  // 272 and 144 bytes, 16-byte aligned, 8 rows on distinct bank groups
  static constexpr int LDA_T = BM + 8, LDB_T = BN + 8;
};
template <>
struct Cfg<__nv_bfloat16> : CfgHalf {};
template <>
struct Cfg<__half> : CfgHalf {};

template <>
struct Cfg<float> {
  static constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;
  static constexpr int LDS = BK + 1;
  static constexpr int LDC = BN + 4;
};

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  using C = Cfg<T>;
  // (the k-major bf16 tiles, 32 x (136 + 72) elements, fit in the same)
  constexpr int ab = (C::BM + C::BN) * C::LDS * static_cast<int>(sizeof(T));
  constexpr int c = C::BM * C::LDC * 4;
  return ab > c ? ab : c;
}

// ---------------------------------------------------------------------------
// element arithmetic, rounded as the plain versions' separate tensor ops
// round it (no fused multiply-add)
// ---------------------------------------------------------------------------

// relu(x * a + b) computed in T: the product and the sum each rounded to T
// (`x * a.astype(dt) + b.astype(dt)` of the forward and of the 3x3
// backward); a_t, b_t already rounded to T
template <typename T>
__device__ __forceinline__ float prologue_dt(float x, float a_t, float b_t) {
  const float s = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x, a_t)), b_t));
  return s > 0.f ? s : 0.f;
}

// s = x * a + b in fp32 (the 1x1 backward's recompute)
__device__ __forceinline__ float prologue_f32(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// dz = k1 * e + k2 * y + k0 in T, each op rounded to T
template <typename T>
__device__ __forceinline__ float finalize_dt(float e, float y, float k1,
                                             float k2, float k0) {
  const float t1 = round_to<T>(__fmul_rn(k1, e));
  const float t2 = round_to<T>(__fmul_rn(k2, y));
  return round_to<T>(__fadd_rn(round_to<T>(__fadd_rn(t1, t2)), k0));
}

template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    load_vec<T, 8>(p, v);
  } else {
    float a[4], b[4];
    load_vec<T, 4>(p, a);
    load_vec<T, 4>(p + 4, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = a[i];
      v[i + 4] = b[i];
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero8(float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = 0.f;
}

// The finalized (and pre-masked) cotangent of 8 channels [n, n + 8) of
// pixel p: e, masked by z > 0 when z is given, then k1 e + k2 y + k0 in T
// when y is given (k* fp32 vectors over the channels).
template <typename T>
__device__ __forceinline__ void dz8(const T* __restrict__ e,
                                    const T* __restrict__ z,
                                    const T* __restrict__ y,
                                    const float* __restrict__ k1,
                                    const float* __restrict__ k2,
                                    const float* __restrict__ k0, int64_t off,
                                    int n, float (&v)[8]) {
  load8<T>(e + off, v);
  if (z != nullptr) {
    float zv[8];
    load8<T>(z + off, zv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = zv[i] > 0.f ? v[i] : 0.f;
  }
  if (y != nullptr) {
    float yv[8];
    load8<T>(y + off, yv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = finalize_dt<T>(v[i], yv[i], round_to<T>(k1[n + i]),
                            round_to<T>(k2[n + i]), round_to<T>(k0[n + i]));
  }
}

// ---------------------------------------------------------------------------
// staging: a source tile of kRows x kCols read 8 contiguous columns at a
// time; fn(r, c, v) fills v with elements (r, c .. c + 7) (zeros outside
// the problem). Straight: dst[r][c], rows kLd apart (columns fastest
// across threads, so a warp reads whole row segments). Transposed:
// dst[c][r] (rows fastest, so the 2-byte shared stores of a warp are
// consecutive; the fp32 wgrad's only).
// ---------------------------------------------------------------------------

template <typename T, int kRows, int kCols, bool kTranspose,
          int kLd = Cfg<T>::LDS, class Fn>
__device__ __forceinline__ void stage(T* __restrict__ dst, Fn fn) {
  using C = Cfg<T>;
  constexpr int kVecs = kRows * kCols / 8;
  for (int v = threadIdx.x; v < kVecs; v += C::kThreads) {
    int r, c;
    if constexpr (kTranspose) {
      r = v % kRows;
      c = (v / kRows) * 8;
    } else {
      r = v / (kCols / 8);
      c = (v % (kCols / 8)) * 8;
    }
    float x[8];
    fn(r, c, x);
    if constexpr (kTranspose) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * C::LDS + r] = from_float<T>(x[i]);
    } else if constexpr (sizeof(T) == 2) {
      store_vec_packed<T, 8>(dst + r * kLd + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[r * kLd + c + i] = x[i];
    }
  }
}

// ---------------------------------------------------------------------------
// the product core
// ---------------------------------------------------------------------------

// ldmatrix.x4.trans: as ldsm_x4, each 8 x 8 matrix transposed on the way
template <typename T>
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const T* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <typename T>
struct Acc;

// the 2-byte types' accumulator: mma.sync m16n8k16 on T operands
template <typename T>
struct AccHalf {
  using C = Cfg<T>;
  static constexpr int MI = 4, NI = 4;  // 16-row and 8-column fragments
  float c[MI][NI][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) c[i][j][k] = 0.f;
  }

  __device__ __forceinline__ void mac(const T* As, const T* Bs) {
    const int warp = threadIdx.x >> 5;
    const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
#pragma unroll
    for (int k0 = 0; k0 < C::BK; k0 += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) load_a(a[i], As, C::LDS, wm + i * 16, k0);
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {
        uint32_t b[4];
        load_b2(b, Bs, C::LDS, wn + jj * 16, k0);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16<T>(c[i][2 * jj], a[i], b[0], b[1]);
          mma16<T>(c[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // the same product from k-major tiles At[BK][LDA_T], Bt[BK][LDB_T]
  // (rows = the reduction axis): ldmatrix.trans turns each 8 x 8 block
  // stored k-major into the row-major A and n-major B fragments
  __device__ __forceinline__ void mac_t(const T* At, const T* Bt) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
    const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < C::BK; k0 += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4_t(a[i], At + (k0 + (mi >> 1) * 8 + r8) * C::LDA_T + wm +
                            i * 16 + (mi & 1) * 8);
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4_t(b, Bt + (k0 + (mi & 1) * 8 + r8) * C::LDB_T + wn +
                         jj * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16<T>(c[i][2 * jj], a[i], b[0], b[1]);
          mma16<T>(c[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* Cs) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int r = wm + i * 16 + g, col = wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(Cs + r * C::LDC + col) =
            make_float2(c[i][j][0], c[i][j][1]);
        *reinterpret_cast<float2*>(Cs + (r + 8) * C::LDC + col) =
            make_float2(c[i][j][2], c[i][j][3]);
      }
  }
};

template <>
struct Acc<__nv_bfloat16> : AccHalf<__nv_bfloat16> {};
template <>
struct Acc<__half> : AccHalf<__half> {};

template <>
struct Acc<float> {
  using C = Cfg<float>;
  float c[4][4];  // rows tm + 16 i, columns tn + 16 j

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void mac(const float* As, const float* Bs) {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
    for (int k = 0; k < C::BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(tm + 16 * i) * C::LDS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tn + 16 * j) * C::LDS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* Cs) const {
    const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(tm + 16 * i) * C::LDC + tn + 16 * j] = c[i][j];
  }
};

// One block: the tile of blockIdx, every reduction chunk staged and
// multiplied in turn, then the epilogue over the fp32 tile in Cs. A
// problem with kKMajor stages k-major tiles (the 2-byte types only).
template <typename T, class Prob>
__global__ void __launch_bounds__(Cfg<T>::kThreads) gemm_kernel(Prob p) {
  using C = Cfg<T>;
  __shared__ __align__(16) unsigned char smem[smem_bytes<T>()];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + C::BM * C::LDS;
  float* Cs = reinterpret_cast<float*>(smem);
  const int nchunks = p.chunks();
  Acc<T> acc;
  acc.zero();
  for (int kc = 0; kc < nchunks; ++kc) {
    p.load_a(kc, As);
    p.load_b(kc, Bs);
    __syncthreads();
    if constexpr (Prob::kKMajor)
      acc.mac_t(As, Bs);
    else
      acc.mac(As, Bs);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();
  p.epilogue(Cs);
}

template <typename T, class Prob>
cudaError_t launch_gemm(const Prob& p, dim3 grid, cudaStream_t stream) {
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return cudaSuccess;
  gemm_kernel<T, Prob><<<grid, Cfg<T>::kThreads, 0, stream>>>(p);
  note_launch("gemm_kernel");
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the column epilogue: a thread a column of the tile, down the rows in
// order; groups of kThreads / BN threads split the rows (thread group j
// takes rows j, j + groups, ...) and their two partial sums are combined
// in group order. fn(r, c, v, s1, s2) handles element (r, c) of value v
// and adds to the column's two sums.
// ---------------------------------------------------------------------------

template <typename T, class Fn>
__device__ __forceinline__ void column_pass(const float* Cs, int rows,
                                            int cols, float* part1,
                                            float* part2, Fn fn) {
  using C = Cfg<T>;
  constexpr int kGroups = C::kThreads / C::BN;
  __shared__ float red[2][kGroups][C::BN];
  const int c = threadIdx.x % C::BN, grp = threadIdx.x / C::BN;
  float s1 = 0.f, s2 = 0.f;
  if (c < cols)
    for (int r = grp; r < rows; r += kGroups)
      fn(r, c, Cs[r * C::LDC + c], s1, s2);
  if (part1 == nullptr) return;
  red[0][grp][c] = s1;
  red[1][grp][c] = s2;
  __syncthreads();
  if (grp == 0 && c < cols) {
    float t1 = red[0][0][c], t2 = red[1][0][c];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) {
      t1 += red[0][j][c];
      t2 += red[1][j][c];
    }
    part1[c] = t1;
    part2[c] = t2;
  }
}

// ---------------------------------------------------------------------------
// out[j][col] = sum over parts i in [j * kRedChunk, (j + 1) * kRedChunk)
// of in[i][col], for `width` columns: 32 columns x 8 part lanes a block,
// each lane its parts in order, the lanes in order.
// ---------------------------------------------------------------------------

constexpr int kRedChunk = 256;

__global__ void __launch_bounds__(256)
    reduce_parts_kernel(const float* __restrict__ in, int parts,
                        int64_t width, float* __restrict__ out) {
  __shared__ float red[8][32];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  const int lo = blockIdx.y * kRedChunk;
  const int hi = min(parts, lo + kRedChunk);
  float s = 0.f;
  if (col < width)
    for (int i = lo + static_cast<int>(threadIdx.y); i < hi; i += 8)
      s += in[static_cast<int64_t>(i) * width + col];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < width) {
    float t = red[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < 8; ++j) t += red[j][threadIdx.x];
    out[static_cast<int64_t>(blockIdx.y) * width + col] = t;
  }
}

// out[col] = sum over `parts` rows of in; scratch holds
// ceil(parts / kRedChunk) rows when parts > kRedChunk (at most
// kRedChunk^2 parts).
inline cudaError_t reduce_parts(const float* in, int parts, int64_t width,
                                float* out, float* scratch,
                                cudaStream_t stream) {
  if (parts <= 0 || width <= 0) return cudaSuccess;
  const unsigned gx = static_cast<unsigned>((width + 31) / 32);
  const dim3 block(32, 8);
  if (parts <= kRedChunk) {
    reduce_parts_kernel<<<dim3(gx, 1), block, 0, stream>>>(in, parts, width,
                                                            out);
    note_launch("reduce_parts_kernel");
    return cudaGetLastError();
  }
  const int mid = (parts + kRedChunk - 1) / kRedChunk;
  if (mid > kRedChunk || scratch == nullptr) return cudaErrorInvalidValue;
  reduce_parts_kernel<<<dim3(gx, mid), block, 0, stream>>>(in, parts, width,
                                                            scratch);
  note_launch("reduce_parts_kernel");
  reduce_parts_kernel<<<dim3(gx, 1), block, 0, stream>>>(scratch, mid, width,
                                                          out);
  note_launch("reduce_parts_kernel");
  return cudaGetLastError();
}

// min(left, cap) as an int: the rows of a tile that lie in the problem
__device__ __forceinline__ int span(int64_t left, int cap) {
  return left < cap ? static_cast<int>(left) : cap;
}

// (h, w) of flat pixel p of an (n, H, W) stream and whether (h + dy, w +
// dx) lies in the image (32-bit arithmetic: the wrappers keep the pixel
// count below 2^31)
__device__ __forceinline__ bool tap_valid(int64_t p, int H, int W, int dy,
                                          int dx) {
  const int rem = static_cast<int>(p) % (H * W);
  const int hh = rem / W;
  const int h = hh + dy, w = rem - hh * W + dx;
  return h >= 0 && h < H && w >= 0 && w < W;
}

}  // namespace bneck
}  // namespace apex_port
