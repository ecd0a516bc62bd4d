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
// stages 3 and 4 (K = 1024 .. 9 x 512). The design keeps every map in
// device memory once: x is read raw and activated while its tile is
// staged in shared memory, y is written once, and its statistics come
// from the accumulator in the same pass, so no BN pass reads y again.
// Rows past M of a ragged last tile are zero in the staged tile and left
// out of the sums (relu(b) != 0 there would pollute them). The 3x3 tile
// computes each of its pixels' (h, w) and the tap's validity itself; the
// TPU's halo slivers and tap bits are not needed. The per-tile sums are
// fp32 partials reduced over the tiles in a fixed order.
#include "bottleneck.cuh"

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

}  // namespace bneck
}  // namespace apex_port

using namespace apex_port;

extern "C" {

// y (M, N) = relu(x * a + b) @ w (no prologue when a is null), wt = w^T
// (N, K); with sums (2, N) not null, sums = (Σy, Σy²) through part (tiles,
// 2, N) and, past 256 tiles, scratch (ceil(tiles / 256), 2, N)
int bneck_mm_fwd(const void* x, const float* a, const float* b,
                 const void* wt, void* y, float* part, float* scratch,
                 float* sums, long long M, int K, int N, int dtype,
                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return bneck::mm_fwd<__nv_bfloat16>(x, a, b, wt, y, part, scratch, sums, M,
                                        K, N, s);
  if (dtype == kFloat32)
    return bneck::mm_fwd<float>(x, a, b, wt, y, part, scratch, sums, M, K, N,
                                s);
  return cudaErrorInvalidValue;
}

// the 3x3 stride-1 SAME form on x (n, H, W, Cin), wt (9, Cout, Cin)
int bneck_conv3_fwd(const void* x, const float* a, const float* b,
                    const void* wt, void* y, float* part, float* scratch,
                    float* sums, int n, int H, int W, int Cin, int Cout,
                    int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return bneck::conv3_fwd<__nv_bfloat16>(x, a, b, wt, y, part, scratch, sums,
                                           n, H, W, Cin, Cout, s);
  if (dtype == kFloat32)
    return bneck::conv3_fwd<float>(x, a, b, wt, y, part, scratch, sums, n, H,
                                   W, Cin, Cout, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
