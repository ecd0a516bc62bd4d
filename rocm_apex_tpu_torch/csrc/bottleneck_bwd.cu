// The fused bottleneck's backward convolutions for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/fused_bottleneck.py:445 `_mm_bwd_kernel`,
// the merged backward of a 1x1 conv y = w . u(x): the incoming cotangent
// e pre-masked by z > 0 (the block's output ReLU) and finalized, dz =
// k1 e + k2 y + k0 in e's dtype (the BN backward of this conv's output);
// the dgrad g = dz w^T, masked by s > 0 where s = x a + b is the fp32
// recompute of the upstream prologue, with the upstream BN's reductions
// Σg and Σg x̂ (x̂ = (x - mu) rs) from the fp32 product; the wgrad dw =
// u^T dz in fp32 summed over the pixels, u = relu(s) rounded to e's dtype
// (or x when there is no prologue). And :624 `_conv3_bwd_kernel`, the
// same for the 3x3 stride-1 SAME conv: the finalize (no pre-mask), the
// 9-tap dgrad over flipped taps whose source pixel is the mirrored tap's
// (validity seen from the source), the ReLU mask from u > 0 with u =
// relu(x a + b) computed in e's dtype as the forward computes it, the
// reductions, and the 9-tap wgrad of the shifted, masked u.
//
// Each entry point is one wrapper call and launches a dgrad product, a
// wgrad product and the fixed-order reductions of their partials: the
// TPU kernel accumulates dw and the reductions across its sequential
// grid; the H100's blocks run in parallel, so the dgrad writes one
// (Σg, Σg x̂) partial per tile of pixels and the wgrad splits the pixels
// into `splits` ranges of `split_len` (a multiple of the staged chunk),
// each writing its own fp32 dw, summed over the ranges in order.
//
// Bound: as the forward (bytes at stage 1, tensor-core operations at
// stages 3 and 4; backward does twice the forward's products). The
// design: the finalized cotangent and the activated input are never
// written to device memory; each product recomputes them while staging
// its tiles (dz is computed once by the dgrad and once by the wgrad, a
// few operations an element against a 64- to 4608-deep product).
#include "bottleneck.cuh"

namespace apex_port {
namespace bneck {

// the finalized cotangent's inputs
template <typename T>
struct Cot {
  const T* e;
  const T* z;  // null: no pre-mask
  const T* y;  // null: no finalize (dz = e)
  const float* k1;
  const float* k2;
  const float* k0;
};

// the upstream input, its prologue and its BN's (mu, rs)
template <typename T>
struct Up {
  const T* x;
  const float* a;  // null: no prologue
  const float* b;
  const float* mu;  // null: no reductions
  const float* rs;
};

// g (M, K) = dz (M, N) @ w^T, w (K, N)
template <typename T>
struct MmDgrad {
  using C = Cfg<T>;
  static constexpr bool kKMajor = false;
  Cot<T> d;
  Up<T> u;
  const T* w;
  T* g;
  float* part;  // (tiles over M, 2, K) or null
  int64_t M;
  int K, N;

  __device__ int chunks() const { return (N + C::BK - 1) / C::BK; }

  __device__ void load_a(int kc, T* As) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int c0 = kc * C::BK;
    stage<T, C::BM, C::BK, false>(As, [&](int r, int c, float (&v)[8]) {
      const int64_t p = m0 + r;
      const int n = c0 + c;
      if (p >= M || n >= N) return zero8<T>(v);
      dz8<T>(d.e, d.z, d.y, d.k1, d.k2, d.k0, p * N + n, n, v);
    });
  }

  __device__ void load_b(int kc, T* Bs) const {
    const int k0 = blockIdx.y * C::BN;
    const int c0 = kc * C::BK;
    stage<T, C::BN, C::BK, false>(Bs, [&](int r, int c, float (&v)[8]) {
      const int k = k0 + r, n = c0 + c;
      if (k >= K || n >= N) return zero8<T>(v);
      load8<T>(w + static_cast<int64_t>(k) * N + n, v);
    });
  }

  __device__ void epilogue(const float* Cs) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int k0 = blockIdx.y * C::BN;
    const int rows = span(M - m0, C::BM);
    const int cols = min(C::BN, K - k0);
    float* p1 = part ? part + static_cast<int64_t>(blockIdx.x) * 2 * K + k0
                     : nullptr;
    column_pass<T>(Cs, rows, cols, p1, p1 ? p1 + K : nullptr,
                   [&](int r, int c, float v, float& s1, float& s2) {
                     const int64_t i = (m0 + r) * K + k0 + c;
                     const int k = k0 + c;
                     float xv = 0.f;
                     if (u.a != nullptr || u.mu != nullptr)
                       xv = to_float(u.x[i]);
                     if (u.a != nullptr && !(prologue_f32(xv, u.a[k], u.b[k]) > 0.f))
                       v = 0.f;
                     g[i] = from_float<T>(v);
                     if (u.mu != nullptr) {
                       s1 += v;
                       s2 = fmaf(v, __fmul_rn(__fsub_rn(xv, u.mu[k]), u.rs[k]),
                                 s2);
                     }
                   });
  }
};

// g (M, Cin) = sum over taps t of dz[q - off_t] @ w[t]^T, w (9, Cin, Cout)
template <typename T>
struct Conv3Dgrad {
  using C = Cfg<T>;
  static constexpr bool kKMajor = false;
  Cot<T> d;
  Up<T> u;
  const T* w;
  T* g;
  float* part;  // (tiles over M, 2, Cin)
  int64_t M;
  int H, W, Cin, Cout;

  __device__ int cchunks() const { return (Cout + C::BK - 1) / C::BK; }
  __device__ int chunks() const { return 9 * cchunks(); }

  __device__ void load_a(int kc, T* As) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int t = kc / cchunks();
    const int c0 = (kc % cchunks()) * C::BK;
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    stage<T, C::BM, C::BK, false>(As, [&](int r, int c, float (&v)[8]) {
      const int64_t q = m0 + r;
      const int co = c0 + c;
      // the pair (q - off, q) is the forward's (p, p + off): the source
      // pixel q - off must lie in the image
      if (q >= M || co >= Cout || !tap_valid(q, H, W, -dy, -dx))
        return zero8<T>(v);
      dz8<T>(d.e, nullptr, d.y, d.k1, d.k2, d.k0,
             (q - dy * W - dx) * Cout + co, co, v);
    });
  }

  __device__ void load_b(int kc, T* Bs) const {
    const int ci0 = blockIdx.y * C::BN;
    const int t = kc / cchunks();
    const int c0 = (kc % cchunks()) * C::BK;
    stage<T, C::BN, C::BK, false>(Bs, [&](int r, int c, float (&v)[8]) {
      const int ci = ci0 + r, co = c0 + c;
      if (ci >= Cin || co >= Cout) return zero8<T>(v);
      load8<T>(w + (static_cast<int64_t>(t) * Cin + ci) * Cout + co, v);
    });
  }

  __device__ void epilogue(const float* Cs) const {
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * C::BM;
    const int ci0 = blockIdx.y * C::BN;
    const int rows = span(M - m0, C::BM);
    const int cols = min(C::BN, Cin - ci0);
    float* p1 = part + static_cast<int64_t>(blockIdx.x) * 2 * Cin + ci0;
    column_pass<T>(Cs, rows, cols, p1, p1 + Cin,
                   [&](int r, int c, float v, float& s1, float& s2) {
                     const int64_t i = (m0 + r) * Cin + ci0 + c;
                     const int ci = ci0 + c;
                     const float xv = to_float(u.x[i]);
                     if (!(prologue_dt<T>(xv, round_to<T>(u.a[ci]),
                                          round_to<T>(u.b[ci])) > 0.f))
                       v = 0.f;
                     g[i] = from_float<T>(v);
                     s1 += v;
                     s2 = fmaf(v, __fmul_rn(__fsub_rn(xv, u.mu[ci]), u.rs[ci]),
                               s2);
                   });
  }
};

// ws[z] (K, N) = sum over the pixels p of split s of u[p + off_t]^T dz[p]
// (z = t * splits + s; kTaps 1: the 1x1, off 0, u with the fp32
// prologue; kTaps 9: the 3x3, tap t's shift and validity, u with the
// prologue in T)
template <typename T, int kTaps>
struct Wgrad {
  using C = Cfg<T>;
  // bf16: k-major tiles (pixels are the rows of both sources, so they are
  // copied as they lie and ldmatrix.trans forms the fragments); fp32: the
  // transposed staging
  static constexpr bool kKMajor = sizeof(T) == 2;
  Cot<T> d;
  Up<T> u;
  float* ws;  // (kTaps * splits, K, N)
  int64_t M;
  int H, W, K, N;
  int64_t split_len;
  int splits;

  __device__ int64_t p_begin() const {
    return static_cast<int64_t>(blockIdx.z % splits) * split_len;
  }
  __device__ int64_t p_end() const {
    const int64_t e = p_begin() + split_len;
    return e < M ? e : M;
  }
  __device__ int chunks() const {
    const int64_t n = p_end() - p_begin();
    return n > 0 ? static_cast<int>((n + C::BK - 1) / C::BK) : 0;
  }

  __device__ void load_a(int kc, T* As) const {
    const int64_t p0 = p_begin() + static_cast<int64_t>(kc) * C::BK;
    const int64_t pe = p_end();
    const int k0 = blockIdx.x * C::BM;
    const int t = kTaps == 9 ? static_cast<int>(blockIdx.z) / splits : 4;
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    // source rows: pixels; columns: channels of x
    auto fn = [&](int r, int c, float (&v)[8]) {
      const int64_t p = p0 + r;
      const int k = k0 + c;
      if (p >= pe || k >= K) return zero8<T>(v);
      if (kTaps == 9 && !tap_valid(p, H, W, dy, dx)) return zero8<T>(v);
      load8<T>(u.x + (p + dy * W + dx) * K + k, v);
      if (u.a == nullptr) return;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (kTaps == 9) {
          v[i] = prologue_dt<T>(v[i], round_to<T>(u.a[k + i]),
                                round_to<T>(u.b[k + i]));
        } else {
          const float s = prologue_f32(v[i], u.a[k + i], u.b[k + i]);
          v[i] = round_to<T>(s > 0.f ? s : 0.f);
        }
      }
    };
    if constexpr (kKMajor)
      stage<T, C::BK, C::BM, false, C::LDA_T>(As, fn);  // At[p][k]
    else
      stage<T, C::BK, C::BM, true>(As, fn);  // As[k][p]
  }

  __device__ void load_b(int kc, T* Bs) const {
    const int64_t p0 = p_begin() + static_cast<int64_t>(kc) * C::BK;
    const int64_t pe = p_end();
    const int n0 = blockIdx.y * C::BN;
    auto fn = [&](int r, int c, float (&v)[8]) {
      const int64_t p = p0 + r;
      const int n = n0 + c;
      if (p >= pe || n >= N) return zero8<T>(v);
      dz8<T>(d.e, d.z, d.y, d.k1, d.k2, d.k0, p * N + n, n, v);
    };
    if constexpr (kKMajor)
      stage<T, C::BK, C::BN, false, C::LDB_T>(Bs, fn);  // Bt[p][n]
    else
      stage<T, C::BK, C::BN, true>(Bs, fn);  // Bs[n][p]
  }

  __device__ void epilogue(const float* Cs) const {
    const int k0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
    float* out = ws + static_cast<int64_t>(blockIdx.z) * K * N;
    column_pass<T>(Cs, min(C::BM, K - k0), min(C::BN, N - n0), nullptr,
                   nullptr, [&](int r, int c, float v, float&, float&) {
                     out[static_cast<int64_t>(k0 + r) * N + n0 + c] = v;
                   });
  }
};

template <typename T>
int mm_bwd(Cot<T> d, Up<T> u, const void* w, void* g, float* dw, float* r12,
           float* part, float* wsw, float* scratch, int64_t M, int K, int N,
           int64_t split_len, int splits, cudaStream_t stream) {
  using C = Cfg<T>;
  const int tiles = static_cast<int>((M + C::BM - 1) / C::BM);
  cudaError_t err = cudaSuccess;
  if (g != nullptr) {
    MmDgrad<T> p{d, u, static_cast<const T*>(w), static_cast<T*>(g),
                 u.mu ? part : nullptr, M, K, N};
    err = launch_gemm<T>(p, dim3(tiles, (K + C::BN - 1) / C::BN), stream);
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr) {
    Wgrad<T, 1> p{d, u, wsw, M, 1, 1, K, N, split_len, splits};
    err = launch_gemm<T>(
        p, dim3((K + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, splits),
        stream);
    if (err != cudaSuccess) return err;
    err = reduce_parts(wsw, splits, static_cast<int64_t>(K) * N, dw, nullptr,
                       stream);
    if (err != cudaSuccess) return err;
  }
  if (g != nullptr && u.mu != nullptr)
    err = reduce_parts(part, tiles, 2 * static_cast<int64_t>(K), r12, scratch,
                       stream);
  return err;
}

template <typename T>
int conv3_bwd(Cot<T> d, Up<T> u, const void* w, void* g, float* dw,
              float* r12, float* part, float* wsw, float* scratch, int n,
              int H, int W, int Cin, int Cout, int64_t split_len, int splits,
              cudaStream_t stream) {
  using C = Cfg<T>;
  const int64_t M = static_cast<int64_t>(n) * H * W;
  const int tiles = static_cast<int>((M + C::BM - 1) / C::BM);
  Conv3Dgrad<T> pd{d, u, static_cast<const T*>(w), static_cast<T*>(g), part,
                   M, H, W, Cin, Cout};
  cudaError_t err =
      launch_gemm<T>(pd, dim3(tiles, (Cin + C::BN - 1) / C::BN), stream);
  if (err != cudaSuccess) return err;
  Wgrad<T, 9> pw{d, u, wsw, M, H, W, Cin, Cout, split_len, splits};
  err = launch_gemm<T>(
      pw, dim3((Cin + C::BM - 1) / C::BM, (Cout + C::BN - 1) / C::BN,
               9 * splits),
      stream);
  if (err != cudaSuccess) return err;
  // the 9 taps' partials are (9 * splits, Cin, Cout) in tap-major order:
  // each tap's splits summed in order into dw[t]
  for (int t = 0; t < 9; ++t) {
    const int64_t kn = static_cast<int64_t>(Cin) * Cout;
    err = reduce_parts(wsw + t * splits * kn, splits, kn, dw + t * kn, nullptr,
                       stream);
    if (err != cudaSuccess) return err;
  }
  return reduce_parts(part, tiles, 2 * static_cast<int64_t>(Cin), r12,
                      scratch, stream);
}

}  // namespace bneck
}  // namespace apex_port

using namespace apex_port;

extern "C" {

// The merged 1x1 backward (see above). Null pointers switch parts off: z
// (pre-mask), y (finalize, with k1 k2 k0), a (prologue, with b), mu (the
// reductions r12 (2, K), with rs, through part (tiles, 2, K) and scratch),
// g (dgrad), dw (wgrad (K, N) fp32, through wsw (splits, K, N)).
int bneck_mm_bwd(const void* e, const void* z, const void* y,
                 const float* k1, const float* k2, const float* k0,
                 const void* x, const float* a, const float* b,
                 const float* mu, const float* rs, const void* w, void* g,
                 float* dw, float* r12, float* part, float* wsw,
                 float* scratch, long long M, int K, int N,
                 long long split_len, int splits, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    return bneck::mm_bwd<T>(
        {static_cast<const T*>(e), static_cast<const T*>(z),
         static_cast<const T*>(y), k1, k2, k0},
        {static_cast<const T*>(x), a, b, mu, rs}, w, g, dw, r12, part, wsw,
        scratch, M, K, N, split_len, splits, s);
  }
  if (dtype == kFloat32) {
    using T = float;
    return bneck::mm_bwd<T>(
        {static_cast<const T*>(e), static_cast<const T*>(z),
         static_cast<const T*>(y), k1, k2, k0},
        {static_cast<const T*>(x), a, b, mu, rs}, w, g, dw, r12, part, wsw,
        scratch, M, K, N, split_len, splits, s);
  }
  return cudaErrorInvalidValue;
}

// The merged 3x3 backward on (n, H, W, C) maps, w (9, Cin, Cout); the
// finalize optional (y null), the prologue and the reductions not.
int bneck_conv3_bwd(const void* e, const void* y, const float* k1,
                    const float* k2, const float* k0, const void* x,
                    const float* a, const float* b, const float* mu,
                    const float* rs, const void* w, void* g, float* dw,
                    float* r12, float* part, float* wsw, float* scratch,
                    int n, int H, int W, int Cin, int Cout,
                    long long split_len, int splits, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    return bneck::conv3_bwd<T>(
        {static_cast<const T*>(e), nullptr, static_cast<const T*>(y), k1, k2,
         k0},
        {static_cast<const T*>(x), a, b, mu, rs}, w, g, dw, r12, part, wsw,
        scratch, n, H, W, Cin, Cout, split_len, splits, s);
  }
  if (dtype == kFloat32) {
    using T = float;
    return bneck::conv3_bwd<T>(
        {static_cast<const T*>(e), nullptr, static_cast<const T*>(y), k1, k2,
         k0},
        {static_cast<const T*>(x), a, b, mu, rs}, w, g, dw, r12, part, wsw,
        scratch, n, H, W, Cin, Cout, split_len, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
