// The fused bottleneck's forward convolutions for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/fused_bottleneck.py:112 `_mm_fwd_kernel`
//   y = relu(x * a + b) @ w over the flattened pixel stream, x (M, K),
//   w (K, N), the prologue optional; Σy and Σy² per output channel from
//   the fp32 accumulator, before y is rounded to x's dtype;
// and :301 `_conv3_fwd_kernel`
//   the 3x3 stride-1 SAME convolution of the same prologue on NHWC x
//   (n, H, W, C), w (3, 3, C, Cout): an implicit product with a
//   reduction of 9 taps x C, a tap outside the image contributing 0 (the
//   zero padding is of the ACTIVATED input), and the same statistics.
// The prologue is computed in x's dtype, the product and the sum each
// rounded (`x * a.astype(dt) + b.astype(dt)`, as the TPU kernels and the
// plain versions round it).
//
// Bound: bytes at stage 1 (a 256-channel bf16 map of the bench batch is
// 205.5 MB, the products 64 to 256 deep), tensor-core operations at
// stages 3 and 4 (K = 1024 .. 9 x 512) and for every 3x3 (29.6 GFLOP at
// each ResNet-50 stride-1 shape against ~2 M C bytes). The staged core
// (bottleneck.cuh) keeps every map in device memory once: x is read raw
// and activated while its tile is staged in shared memory, y is written
// once, and its statistics come from the accumulator in the same pass, so
// no BN pass reads y again. Rows past M of a ragged last tile are zero in
// the staged tile and left out of the sums (relu(b) != 0 there would
// pollute them). The 3x3 tile computes each of its pixels' (h, w) and the
// tap's validity itself; the TPU's halo slivers and tap bits are not
// needed. The per-tile sums are fp32 partials reduced over the tiles in a
// fixed order.
//
// The bf16 forwards at channel counts that are multiples of 64 (every
// ResNet-50 width) run on bottleneck_pipe.cuh instead, as the backwards'
// dgrads do: on the staged core the 3x3 sat at 46-54 TFLOP/s and the 1x1
// at 80-98 where its products are deep (layer3, layer4) and 2.4-4x over
// its bound where it moves bytes (layer1), one chunk staged, then
// multiplied. Here a pre-pass writes u = relu(x a + b) once in bf16 (the
// staged load's rounding, so the product sees the same values), and the
// product reads u's rows (shifted by each tap for the 3x3) through the
// cp.async ring, zero-filled where a tap leaves the image: the padding is
// of u, which an inline prologue would get wrong (relu(b) != 0). The bare
// forms (no prologue: conv1, the downsample) read x itself. The 1x1 is
// the 3x3 with one tap: A holds the pixel rows, B the rows of w^T, both
// K-major. The epilogue writes y and the tile's (Σy, Σy²) partial from
// the fp32 accumulators, reduced as above. The host's `mm_fwd_plan` and
// `conv3_fwd_plan` pick the route and the tile width from the shape.
#include <type_traits>

#include "bottleneck_pipe.cuh"

namespace apex_port {
namespace bneck {

// y = P(x) @ w, x (M, K); wt = w^T (N, K)
template <typename T>
struct MmFwd {
  using C = Cfg<T>;
  static constexpr bool kKMajor = false;
  const T* x;
  const float* a;  // null: no prologue
  const float* b;
  const T* wt;
  T* y;
  float* part;  // (tiles over M, 2, N) or null: no statistics
  int64_t M;
  int K, N;

  __device__ int chunks() const { return (K + C::BK - 1) / C::BK; }

  __device__ void load_a(int kc, T* As) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int k0 = kc * C::BK;
    stage<T, C::BM, C::BK, false>(As, [&](int r, int c, float (&v)[8]) {
      const int64_t p = m0 + r;
      const int k = k0 + c;
      if (p >= M || k >= K) return zero8<T>(v);
      load8<T>(x + p * K + k, v);
      if (a != nullptr)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = prologue_dt<T>(v[i], round_to<T>(a[k + i]),
                                round_to<T>(b[k + i]));
    });
  }

  __device__ void load_b(int kc, T* Bs) const {
    const int n0 = blockIdx.y * C::BN;
    const int k0 = kc * C::BK;
    // Bs[n][k] = wt[n][k]
    stage<T, C::BN, C::BK, false>(Bs, [&](int r, int c, float (&v)[8]) {
      const int n = n0 + r, k = k0 + c;
      if (k >= K || n >= N) return zero8<T>(v);
      load8<T>(wt + static_cast<int64_t>(n) * K + k, v);
    });
  }

  __device__ void epilogue(const float* Cs) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int n0 = blockIdx.y * C::BN;
    const int rows = span(M - m0, C::BM);
    const int cols = min(C::BN, N - n0);
    float* p1 = part ? part + static_cast<int64_t>(blockIdx.x) * 2 * N + n0
                     : nullptr;
    column_pass<T>(Cs, rows, cols, p1, p1 ? p1 + N : nullptr,
                   [&](int r, int c, float v, float& s1, float& s2) {
                     y[(m0 + r) * N + n0 + c] = from_float<T>(v);
                     s1 += v;
                     s2 = fmaf(v, v, s2);
                   });
  }
};

// y = conv3x3(P(x), w), x (n, H, W, Cin) as (M, Cin); wt (9, Cout, Cin),
// each tap's (Cin, Cout) kernel transposed; reduction chunk kc = (tap,
// channel chunk)
template <typename T>
struct Conv3Fwd {
  using C = Cfg<T>;
  static constexpr bool kKMajor = false;
  const T* x;
  const float* a;
  const float* b;
  const T* wt;
  T* y;
  float* part;
  int64_t M;
  int H, W, Cin, Cout;

  __device__ int cchunks() const { return (Cin + C::BK - 1) / C::BK; }
  __device__ int chunks() const { return 9 * cchunks(); }

  __device__ void load_a(int kc, T* As) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int t = kc / cchunks();
    const int c0 = (kc % cchunks()) * C::BK;
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    stage<T, C::BM, C::BK, false>(As, [&](int r, int c, float (&v)[8]) {
      const int64_t p = m0 + r;
      const int ch = c0 + c;
      if (p >= M || ch >= Cin || !tap_valid(p, H, W, dy, dx))
        return zero8<T>(v);
      load8<T>(x + (p + dy * W + dx) * Cin + ch, v);
      if (a != nullptr)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = prologue_dt<T>(v[i], round_to<T>(a[ch + i]),
                                round_to<T>(b[ch + i]));
    });
  }

  __device__ void load_b(int kc, T* Bs) const {
    const int n0 = blockIdx.y * C::BN;
    const int t = kc / cchunks();
    const int c0 = (kc % cchunks()) * C::BK;
    stage<T, C::BN, C::BK, false>(Bs, [&](int r, int c, float (&v)[8]) {
      const int n = n0 + r, ch = c0 + c;
      if (ch >= Cin || n >= Cout) return zero8<T>(v);
      load8<T>(wt + (static_cast<int64_t>(t) * Cout + n) * Cin + ch, v);
    });
  }

  __device__ void epilogue(const float* Cs) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int n0 = blockIdx.y * C::BN;
    const int rows = span(M - m0, C::BM);
    const int cols = min(C::BN, Cout - n0);
    float* p1 = part ? part + static_cast<int64_t>(blockIdx.x) * 2 * Cout + n0
                     : nullptr;
    column_pass<T>(Cs, rows, cols, p1, p1 ? p1 + Cout : nullptr,
                   [&](int r, int c, float v, float& s1, float& s2) {
                     y[(m0 + r) * Cout + n0 + c] = from_float<T>(v);
                     s1 += v;
                     s2 = fmaf(v, v, s2);
                   });
  }
};

// The pipe's pre-pass of the 3x3 and the 1x1 forwards: u = relu(x a + b)
// (M, Cin) in T with `prologue_dt`'s rounding, the grid as
// `prepass_blocks` sizes it
template <typename T>
__global__ void __launch_bounds__(256)
    conv3_fwd_prepass_kernel(const T* __restrict__ x,
                             const float* __restrict__ a,
                             const float* __restrict__ b, T* __restrict__ u,
                             int64_t M, int Cin) {
  prologue_rows<T>(x, a, b, u, M, Cin,
                      static_cast<int64_t>(blockIdx.x) * blockDim.x +
                          threadIdx.x,
                      static_cast<int64_t>(gridDim.x) * blockDim.x);
}

// The forwards' epilogue: y (M, N) and the (Σy, Σy²) partial of the
// tile (part, where not null) from the accumulators. Each thread a
// 16-byte run of 8 channels down every kRowGroups-th row of the tile (one
// vector store of y), its sums in row order; the row groups' sums then
// combined in group order through shared memory (the tile's, free once
// read).
template <typename T, int BN>
__device__ __forceinline__ void fwd_epilogue(const WAcc<T, BN>& acc,
                                             float* Cs, T* __restrict__ y,
                                             float* part, int64_t M, int N) {
  using Cfg = PCfg<T, BN, false>;
  acc.store(Cs, Cfg::LDC);
  __syncthreads();
  constexpr int kSegs = BN / 8;
  constexpr int kRowGroups = Cfg::kThreads / kSegs;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * Cfg::BM;
  const int n0 = blockIdx.y * BN;
  const int rows = span(M - m0, Cfg::BM);
  const int cols = min(BN, N - n0);  // a multiple of 16
  const int seg = threadIdx.x % kSegs, rg = threadIdx.x / kSegs;
  const int c = seg * 8;
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  if (c < cols) {
#pragma unroll
    for (int i = 0; i < Cfg::BM / kRowGroups; ++i) {
      const int r = rg + i * kRowGroups;
      if (r < rows) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = Cs[r * Cfg::LDC + c + j];
          s1[j] += v[j];
          s2[j] = fmaf(v[j], v[j], s2[j]);
        }
        store_vec_packed<T, 8>(y + (m0 + r) * N + n0 + c, v);
      }
    }
  }
  if (part == nullptr) return;  // uniform: no statistics
  combine_row_groups<BN, kRowGroups>(
      s1, s2, rg, c, cols, Cs,
      part + static_cast<int64_t>(blockIdx.x) * 2 * N + n0, N);
}

// y = conv3x3(u, w) with the (Σy, Σy²) partial of each pixel tile. Rows:
// pixels (BM a tile); reduction: (tap, 64-channel chunk of Cin),
// tap-major; A and B K-major (rows of Cin contiguous values: u's pixel
// rows shifted by the tap, wt[t]'s rows, one a column co of the tile).
// The dgrad of the backward (Conv3DgradPipe) with the tap's sign flipped.
template <typename T, int BN>
struct Conv3FwdPipe {
  using Cfg = PCfg<T, BN, false>;
  const T* u;   // (M, Cin): the activated input (x in the bare form)
  const T* wt;  // (9, Cout, Cin)
  T* y;
  float* part;  // (tiles over M, 2, Cout) or null: no statistics
  int64_t M;
  int H, W, Cin, Cout;

  // the A rows a thread stages; chunks over Cin
  using Thread = TapRows;

  __device__ int chunks() const {
    return 9 * ((Cin + Cfg::BK - 1) / Cfg::BK);
  }

  __device__ Thread thread_init() const {
    Thread th;
    th.init(static_cast<int64_t>(blockIdx.x) * Cfg::BM, M, H, W);
    return th;
  }

  __device__ void load(Thread& th, int, unsigned char* As,
                       unsigned char* Bs) const {
    int t, c0;
    th.next(Cfg::BK, Cin, t, c0);
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    const int c = threadIdx.x & 7, ci = c0 + c * 8;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * Cfg::BM;
    // output pixel p reads the source pixel p + off, which must lie in
    // the image
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 3) + 32 * i;
      const bool ok = ci < Cin && th.in_image(i, dy, dx, H, W);
      const T* src = ok ? u + (m0 + r + dy * W + dx) * Cin + ci : u;
      cp_async16(As + sw128(r, c), src, ok);
    }
    load_kmajor_rows<BN, Cfg::kThreads>(
        Bs, wt + static_cast<int64_t>(t) * Cout * Cin, Cout, Cin,
        blockIdx.y * BN, c0);
  }

  __device__ void epilogue(const WAcc<T, BN>& acc, float* Cs) const {
    fwd_epilogue<T, BN>(acc, Cs, y, part, M, Cout);
  }
};

// y = u @ w with the (Σy, Σy²) partial of each pixel tile, u (M, K) the
// pre-pass's rows (x in the bare form), wt = w^T (N, K): rows pixels (BM
// a tile), reduction K in 64-deep chunks; A and B K-major, as they lie.
// Conv3FwdPipe with one tap, or the 1x1 backward's dgrad with x in dz's
// place.
template <typename T, int BN>
struct MmFwdPipe {
  using Cfg = PCfg<T, BN, false>;
  const T* u;
  const T* wt;
  T* y;
  float* part;  // (tiles over M, 2, N) or null: no statistics
  int64_t M;
  int K, N;

  struct Thread {};

  __device__ int chunks() const { return (K + Cfg::BK - 1) / Cfg::BK; }
  __device__ Thread thread_init() const { return Thread{}; }

  __device__ void load(Thread&, int kc, unsigned char* As,
                       unsigned char* Bs) const {
    const int c0 = kc * Cfg::BK;
    load_kmajor_rows<Cfg::BM, Cfg::kThreads>(
        As, u, M, K, static_cast<int64_t>(blockIdx.x) * Cfg::BM, c0);
    load_kmajor_rows<BN, Cfg::kThreads>(Bs, wt, N, K, blockIdx.y * BN, c0);
  }

  __device__ void epilogue(const WAcc<T, BN>& acc, float* Cs) const {
    fwd_epilogue<T, BN>(acc, Cs, y, part, M, N);
  }
};

template <typename T>
int mm_fwd(const void* x, const float* a, const float* b, const void* wt,
           void* y, float* part, float* scratch, float* sums, int64_t M, int K,
           int N, cudaStream_t stream) {
  using C = Cfg<T>;
  MmFwd<T> p{static_cast<const T*>(x), a, b, static_cast<const T*>(wt),
             static_cast<T*>(y), sums ? part : nullptr, M, K, N};
  const int tiles = static_cast<int>((M + C::BM - 1) / C::BM);
  cudaError_t err = launch_gemm<T>(
      p, dim3(tiles, (N + C::BN - 1) / C::BN), stream);
  if (err != cudaSuccess || sums == nullptr) return err;
  return reduce_parts(part, tiles, 2 * static_cast<int64_t>(N), sums, scratch,
                      stream);
}

template <typename T>
int conv3_fwd(const void* x, const float* a, const float* b, const void* wt,
              void* y, float* part, float* scratch, float* sums, int n, int H,
              int W, int Cin, int Cout, cudaStream_t stream) {
  using C = Cfg<T>;
  const int64_t M = static_cast<int64_t>(n) * H * W;
  Conv3Fwd<T> p{static_cast<const T*>(x), a, b, static_cast<const T*>(wt),
                static_cast<T*>(y), sums ? part : nullptr, M, H, W, Cin, Cout};
  const int tiles = static_cast<int>((M + C::BM - 1) / C::BM);
  cudaError_t err = launch_gemm<T>(
      p, dim3(tiles, (Cout + C::BN - 1) / C::BN), stream);
  if (err != cudaSuccess || sums == nullptr) return err;
  return reduce_parts(part, tiles, 2 * static_cast<int64_t>(Cout), sums,
                      scratch, stream);
}

// The bf16 and fp16 forwards on the pipe (channel counts multiples of 64):
// the
// pre-pass where there is a prologue (u = ubuf, (M, K); else the product
// reads x), the product `make(bn, u, part)` builds in tiles of 128 pixels
// x bn channels over a grid of (pixel tiles, N / bn), the sums of its
// tile partials.
template <typename T, class Make>
int fwd_pipe(const T* x, const float* a, const float* b, T* ubuf,
             float* part, float* scratch, float* sums, int64_t M, int K,
             int N, int bn, int sms, cudaStream_t stream, Make make) {
  const int tiles = static_cast<int>((M + 127) / 128);
  if ((a != nullptr) != (ubuf != nullptr) || K % 64 || N % 64 ||
      (bn != 128 && bn != 64) || N % bn)
    return cudaErrorInvalidValue;
  const T* u = x;
  if (a != nullptr) {
    conv3_fwd_prepass_kernel<T><<<prepass_blocks(M, K, K, sms), 256, 0,
                                  stream>>>(x, a, b, ubuf, M, K);
    note_launch("conv3_fwd_prepass_kernel");
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    u = ubuf;
  }
  float* pp = sums ? part : nullptr;
  const dim3 grid(tiles, N / bn);
  const cudaError_t err =
      bn == 128
          ? launch_pipe(make(std::integral_constant<int, 128>{}, u, pp), grid,
                        stream)
          : launch_pipe(make(std::integral_constant<int, 64>{}, u, pp), grid,
                        stream);
  if (err != cudaSuccess || sums == nullptr) return err;
  return reduce_parts(part, tiles, 2 * static_cast<int64_t>(N), sums,
                      scratch, stream);
}

// the 1x1 on the pipe: y (M, N) = P(x) @ w, wt = w^T (N, K)
template <typename T>
int mm_fwd_pipe(const T* x, const float* a, const float* b, const T* wt,
                T* y, float* part, float* scratch, float* sums, T* ubuf,
                int64_t M, int K, int N, int bn, int sms,
                cudaStream_t stream) {
  return fwd_pipe(x, a, b, ubuf, part, scratch, sums, M, K, N, bn, sms,
                  stream, [&](auto bnc, const T* u, float* pp) {
                    return MmFwdPipe<T, decltype(bnc)::value>{u, wt, y, pp,
                                                              M, K, N};
                  });
}

// the 3x3 on the pipe: x (n, H, W, Cin), wt (9, Cout, Cin)
template <typename T>
int conv3_fwd_pipe(const T* x, const float* a, const float* b, const T* wt,
                   T* y, float* part, float* scratch, float* sums, T* ubuf,
                   int n, int H, int W, int Cin, int Cout, int bn, int sms,
                   cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(n) * H * W;
  return fwd_pipe(x, a, b, ubuf, part, scratch, sums, M, Cin, Cout, bn, sms,
                  stream, [&](auto bnc, const T* u, float* pp) {
                    return Conv3FwdPipe<T, decltype(bnc)::value>{
                        u, wt, y, pp, M, H, W, Cin, Cout};
                  });
}

}  // namespace bneck
}  // namespace apex_port

using namespace apex_port;

extern "C" {

// y (M, N) = relu(x * a + b) @ w (no prologue when a is null), wt = w^T
// (N, K); with sums (2, N) not null, sums = (Σy, Σy²) through part (tiles,
// 2, N) and, past 256 tiles, scratch (ceil(tiles / 256), 2, N). bn 128 or
// 64: bf16 on bottleneck_pipe.cuh in tiles of bn channels, with ubuf (M,
// K) the pre-pass's output when a is given (else null); sms sizes the
// pre-pass. bn 0: the staged core (ubuf null).
int bneck_mm_fwd(const void* x, const float* a, const float* b,
                 const void* wt, void* y, float* part, float* scratch,
                 float* sums, void* ubuf, long long M, int K, int N, int bn,
                 int sms, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_half_code(dtype) && bn != 0)
    return with_half(dtype, [&](auto h) {
      using T = decltype(h);
      return bneck::mm_fwd_pipe<T>(
          static_cast<const T*>(x), a, b, static_cast<const T*>(wt),
          static_cast<T*>(y), part, scratch, sums, static_cast<T*>(ubuf), M,
          K, N, bn, sms, s);
    });
  if (ubuf != nullptr) return cudaErrorInvalidValue;
  if (is_half_code(dtype))
    return with_half(dtype, [&](auto h) {
      return bneck::mm_fwd<decltype(h)>(x, a, b, wt, y, part, scratch, sums,
                                        M, K, N, s);
    });
  if (dtype == kFloat32 && bn == 0)
    return bneck::mm_fwd<float>(x, a, b, wt, y, part, scratch, sums, M, K, N,
                                s);
  return cudaErrorInvalidValue;
}

// the 3x3 stride-1 SAME form on x (n, H, W, Cin), wt (9, Cout, Cin).
// bn 128 or 64: bf16 on bottleneck_pipe.cuh in tiles of bn channels, with
// ubuf (M, Cin) the pre-pass's output when a is given (else null); sms
// sizes the pre-pass. bn 0: the staged core (ubuf null).
int bneck_conv3_fwd(const void* x, const float* a, const float* b,
                    const void* wt, void* y, float* part, float* scratch,
                    float* sums, void* ubuf, int n, int H, int W, int Cin,
                    int Cout, int bn, int sms, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_half_code(dtype) && bn != 0)
    return with_half(dtype, [&](auto h) {
      using T = decltype(h);
      return bneck::conv3_fwd_pipe<T>(
          static_cast<const T*>(x), a, b, static_cast<const T*>(wt),
          static_cast<T*>(y), part, scratch, sums, static_cast<T*>(ubuf), n,
          H, W, Cin, Cout, bn, sms, s);
    });
  if (ubuf != nullptr) return cudaErrorInvalidValue;
  if (is_half_code(dtype))
    return with_half(dtype, [&](auto h) {
      return bneck::conv3_fwd<decltype(h)>(x, a, b, wt, y, part, scratch,
                                           sums, n, H, W, Cin, Cout, s);
    });
  if (dtype == kFloat32 && bn == 0)
    return bneck::conv3_fwd<float>(x, a, b, wt, y, part, scratch, sums, n, H,
                                   W, Cin, Cout, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
