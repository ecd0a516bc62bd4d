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
// each writing its own fp32 dw, summed over the ranges in order by ONE
// reduction launch (no atomics: two launches give the same bits).
//
// Bound: tensor-core operations for the 3x3 at every ResNet-50 shape
// (2 x 2 M 9 Cin Cout against ~2 M (Cin + 2 Cout) + 9 Cin Cout elements),
// bytes for most 1x1s. The fp32 forms (the parity runs') stage their
// tiles on bottleneck.cuh's core, recomputing the finalized cotangent and
// the activated input while staging. The bf16 forms, the costliest
// kernels of the fused ResNet-50 step, were that too and sat at 11-33x
// their bounds: serial staged chunks with no load in flight during the
// products, dz and u recomputed by every tile that read them (9 times
// over for the 3x3). They now run on bottleneck_pipe.cuh: a pre-pass
// writes dz = finalize(e, y) and u = relu(x a + b) once each in bf16
// (the same rounding, so the products see the same values), the dgrad
// and the wgrad become (implicit, for the 3x3) GEMMs over those rows,
// fed by a 3-stage cp.async ring (zero-fill for the taps that leave the
// image and the ragged edges) and multiplied by wgmma, and one launch
// sums the wgrad's split partials (for the 3x3: every tap's, its output
// rows being (tap, cin) pairs, full tiles at Cin 64). A 1x1 whose
// channel counts are not multiples of 64 stays on the staged core (the
// host's plan says so): the pipe's chunks and tiles are 64 channels deep
// and wide.
#include "bottleneck_pipe.cuh"

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
// (kTaps 1: the 1x1, z = s, off 0, u with the fp32 prologue; kTaps 9:
// the fp32 3x3, z = s * 9 + t, so that ws is (splits, 9, K, N) and one
// reduction over the splits gives dw (9, K, N); tap t's shift and
// validity, u with the prologue in T)
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

  __device__ int64_t p_begin() const {
    const int s = kTaps == 9 ? static_cast<int>(blockIdx.z) / 9
                             : static_cast<int>(blockIdx.z);
    return static_cast<int64_t>(s) * split_len;
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
    const int t = kTaps == 9 ? static_cast<int>(blockIdx.z) % 9 : 4;
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
    Wgrad<T, 1> p{d, u, wsw, M, 1, 1, K, N, split_len};
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

// ---------------------------------------------------------------------------
// the bf16 and fp16 backwards on bottleneck_pipe.cuh
// ---------------------------------------------------------------------------

// The 1x1 backward's pre-pass: dz = finalize(premask(e, z), y) (M, N)
// where dz is given, with `dz8`'s rounding, and u = relu(s) (M, K) where
// u is given: s = x a + b in fp32, rounded to T once (the staged wgrad's
// rule, not the 3x3's rounding of each op). 8 channels a thread; the
// grid as `prepass_blocks` sizes it.
template <typename T>
__global__ void __launch_bounds__(256)
    mm_prepass_kernel(Cot<T> d, Up<T> up, T* __restrict__ dz,
                      T* __restrict__ u, int64_t M, int K, int N) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (dz != nullptr) {
    const int n = static_cast<int>(tid % (N / 8)) * 8;
    float k1[8], k2[8], k0[8];
    if (d.y != nullptr) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        k1[i] = round_to<T>(d.k1[n + i]);
        k2[i] = round_to<T>(d.k2[n + i]);
        k0[i] = round_to<T>(d.k0[n + i]);
      }
    }
    for (int64_t off = tid * 8; off < M * N; off += stride * 8) {
      float ev[8];
      load8<T>(d.e + off, ev);
      if (d.z != nullptr) {
        float zv[8];
        load8<T>(d.z + off, zv);
#pragma unroll
        for (int i = 0; i < 8; ++i) ev[i] = zv[i] > 0.f ? ev[i] : 0.f;
      }
      if (d.y != nullptr) {
        float yv[8];
        load8<T>(d.y + off, yv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ev[i] = finalize_dt<T>(ev[i], yv[i], k1[i], k2[i], k0[i]);
      }
      store_vec_packed<T, 8>(dz + off, ev);
    }
  }
  if (u != nullptr) {
    const int k = static_cast<int>(tid % (K / 8)) * 8;
    float a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = up.a[k + i];
      b[i] = up.b[k + i];
    }
    for (int64_t off = tid * 8; off < M * K; off += stride * 8) {
      float xv[8];
      load8<T>(up.x + off, xv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sv = prologue_f32(xv[i], a[i], b[i]);
        xv[i] = sv > 0.f ? sv : 0.f;
      }
      store_vec_packed<T, 8>(u + off, xv);
    }
  }
}

// The 3x3 pre-pass: dz = finalize(e, y) (M, Cout) when y is given and u =
// relu(x a + b) (M, Cin), each in T with the rounding of the staged
// forms (`dz8`, `prologue_dt`), 8 channels a thread. The grid's threads
// are a multiple of Cin / 8 and of Cout / 8: a thread keeps its channels
// over its grid-stride steps.
template <typename T>
__global__ void __launch_bounds__(256)
    conv3_prepass_kernel(Cot<T> d, Up<T> up, T* __restrict__ dz,
                         T* __restrict__ u, int64_t M, int Cin, int Cout) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (d.y != nullptr) {
    const int n = static_cast<int>(tid % (Cout / 8)) * 8;
    float k1[8], k2[8], k0[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k1[i] = round_to<T>(d.k1[n + i]);
      k2[i] = round_to<T>(d.k2[n + i]);
      k0[i] = round_to<T>(d.k0[n + i]);
    }
    for (int64_t off = tid * 8; off < M * Cout; off += stride * 8) {
      float ev[8], yv[8];
      load8<T>(d.e + off, ev);
      load8<T>(d.y + off, yv);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ev[i] = finalize_dt<T>(ev[i], yv[i], k1[i], k2[i], k0[i]);
      store_vec_packed<T, 8>(dz + off, ev);
    }
  }
  prologue_rows<T>(up.x, up.a, up.b, u, M, Cin, tid, stride);
}

// out[i] = sum over the parts j in order of in[j][i] (a few parts: the
// pipelined wgrad's splits), 4 columns a thread
__global__ void __launch_bounds__(256)
    sum_parts_kernel(const float* __restrict__ in, int parts, int64_t width,
                     float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * 4;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 4;
       i < width; i += stride) {
    float4 s = *reinterpret_cast<const float4*>(in + i);
    for (int j = 1; j < parts; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(in + j * width + i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + i) = s;
  }
}

inline cudaError_t sum_parts(const float* in, int parts, int64_t width,
                             float* out, int sms, cudaStream_t stream) {
  sum_parts_kernel<<<static_cast<int>(std::min<int64_t>(
                         (width / 4 + 255) / 256,
                         static_cast<int64_t>(sms) * 16)),
                     256, 0, stream>>>(in, parts, width, out);
  note_launch("sum_parts_kernel");
  return cudaGetLastError();
}

// g (M, Cin) = sum over taps t of dz[q - off_t] @ w[t]^T, masked by
// u > 0, with the (Σg, Σg x̂) partial of each pixel tile. Rows: pixels
// (BM a tile); reduction: (tap, 64-channel chunk of Cout), tap-major; A
// and B K-major (rows of Cout contiguous values: dz's pixel rows, w[t]'s
// rows, one a column ci of the tile).
template <typename T, int BN>
struct Conv3DgradPipe {
  using Cfg = PCfg<T, BN, false>;
  const T* dz;  // (M, Cout)
  const T* u;   // (M, Cin): the mask
  const T* x;   // (M, Cin): x̂ of the reductions
  const float* mu;
  const float* rs;
  const T* w;  // (9, Cin, Cout)
  T* g;
  float* part;  // (tiles over M, 2, Cin)
  int64_t M;
  int H, W, Cin, Cout;

  // the A rows a thread stages; chunks over Cout
  using Thread = TapRows;

  __device__ int chunks() const {
    return 9 * ((Cout + Cfg::BK - 1) / Cfg::BK);
  }

  __device__ Thread thread_init() const {
    Thread th;
    th.init(static_cast<int64_t>(blockIdx.x) * Cfg::BM, M, H, W);
    return th;
  }

  __device__ void load(Thread& th, int, unsigned char* As,
                       unsigned char* Bs) const {
    int t, c0;
    th.next(Cfg::BK, Cout, t, c0);
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    const int c = threadIdx.x & 7, co = c0 + c * 8;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * Cfg::BM;
    // the pair (q - off, q) is the forward's (p, p + off): the source
    // pixel q - off must lie in the image
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 3) + 32 * i;
      const bool ok = co < Cout && th.in_image(i, -dy, -dx, H, W);
      const T* src =
          ok ? dz + (m0 + r - dy * W - dx) * Cout + co : dz;
      cp_async16(As + sw128(r, c), src, ok);
    }
    const int ci0 = blockIdx.y * BN;
#pragma unroll
    for (int i = 0; i < BN * 8 / Cfg::kThreads; ++i) {
      const int v = threadIdx.x + i * Cfg::kThreads;
      const int r = v >> 3, cc = v & 7;
      const int ci = ci0 + r, co2 = c0 + cc * 8;
      const bool ok = ci < Cin && co2 < Cout;
      const T* src =
          ok ? w + (static_cast<int64_t>(t) * Cin + ci) * Cout + co2 : w;
      cp_async16(Bs + sw128(r, cc), src, ok);
    }
  }

  // Each thread a 16-byte run of 8 channels down every kRowGroups-th row
  // of the tile (vector loads of u and x, one vector store of g), its
  // sums in row order; the row groups' sums then combined in group
  // order through shared memory (the tile's, free once read).
  __device__ void epilogue(const WAcc<T, BN>& acc, float* Cs) const {
    acc.store(Cs, Cfg::LDC);
    __syncthreads();
    constexpr int kSegs = BN / 8;
    constexpr int kRowGroups = Cfg::kThreads / kSegs;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * Cfg::BM;
    const int ci0 = blockIdx.y * BN;
    const int rows = span(M - m0, Cfg::BM);
    const int cols = min(BN, Cin - ci0);  // a multiple of 16
    const int seg = threadIdx.x % kSegs, rg = threadIdx.x / kSegs;
    const int c = seg * 8;
    float s1[8], s2[8], mu8[8], rs8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] = s2[j] = 0.f;
      mu8[j] = rs8[j] = 0.f;
    }
    if (c < cols) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mu8[j] = mu[ci0 + c + j];
        rs8[j] = rs[ci0 + c + j];
      }
#pragma unroll
      for (int i = 0; i < Cfg::BM / kRowGroups; ++i) {
        const int r = rg + i * kRowGroups;
        if (r < rows) {
          const int64_t off = (m0 + r) * Cin + ci0 + c;
          float uv[8], xv[8], v[8];
          load_vec<T, 8>(u + off, uv);
          load_vec<T, 8>(x + off, xv);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            v[j] = uv[j] > 0.f ? Cs[r * Cfg::LDC + c + j] : 0.f;
            s1[j] += v[j];
            s2[j] = fmaf(v[j], __fmul_rn(__fsub_rn(xv[j], mu8[j]), rs8[j]),
                         s2[j]);
          }
          store_vec_packed<T, 8>(g + off, v);
        }
      }
    }
    combine_row_groups<BN, kRowGroups>(
        s1, s2, rg, c, cols, Cs,
        part + static_cast<int64_t>(blockIdx.x) * 2 * Cin + ci0, Cin);
  }
};

// ws[s] (9 Cin, Cout) = sum over the pixels p of split s of
// u[p + off_t][ci]^T dz[p], row t * Cin + ci: the taps folded into the
// output rows, so that ws[s] has dw's (3, 3, Cin, Cout) layout. Both
// sources MN-major (pixels down the tile), as they lie.
template <typename T, int BN>
struct Conv3WgradPipe {
  using Cfg = PCfg<T, BN, true>;
  const T* u;   // (M, Cin)
  const T* dz;  // (M, Cout)
  float* ws;    // (splits, 9 Cin, Cout)
  int64_t M;
  int H, W, Cin, Cout;
  int64_t split_len;

  // a thread stages the A segment c = tid % 16 (8 channels of one (tap,
  // cin) run) for pixel rows tid / 16 + 16 i; (h, w) of those rows'
  // pixels in the next chunk (chunks are loaded in order, BK pixels
  // apart)
  struct Thread {
    int ci, dy, dx;
    bool row_ok;
    int h[4], w[4];
  };

  __device__ int64_t p_begin() const {
    return static_cast<int64_t>(blockIdx.z) * split_len;
  }
  __device__ int64_t p_end() const {
    const int64_t e = p_begin() + split_len;
    return e < M ? e : M;
  }
  __device__ int chunks() const {
    const int64_t n = p_end() - p_begin();
    return n > 0 ? static_cast<int>((n + Cfg::BK - 1) / Cfg::BK) : 0;
  }

  __device__ Thread thread_init() const {
    Thread th;
    const int row = blockIdx.x * Cfg::BM + (threadIdx.x & 15) * 8;
    const int t = row / Cin;
    th.ci = row - t * Cin;
    th.dy = t / 3 - 1;
    th.dx = t % 3 - 1;
    th.row_ok = row < 9 * Cin;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pixel_hw(p_begin() + (threadIdx.x >> 4) + 16 * i, H, W, th.h[i],
               th.w[i]);
    return th;
  }

  __device__ void load(Thread& th, int kc, unsigned char* At,
                       unsigned char* Bt) const {
    const int64_t p0 = p_begin() + static_cast<int64_t>(kc) * Cfg::BK;
    const int64_t pe = p_end();
    const int c = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 4) + 16 * i;
      const int64_t p = p0 + r;
      const int h = th.h[i] + th.dy, w = th.w[i] + th.dx;
      const bool ok = th.row_ok && p < pe && h >= 0 && h < H && w >= 0 &&
                      w < W;
      const T* src =
          ok ? u + (p + th.dy * W + th.dx) * Cin + th.ci : u;
      cp_async16(At + mnmajor_seg(r, c), src, ok);
      // the same row of the next chunk: BK pixels on
      th.w[i] += Cfg::BK;
      while (th.w[i] >= W) {
        th.w[i] -= W;
        if (++th.h[i] == H) th.h[i] = 0;
      }
    }
    const int n0 = blockIdx.y * BN;
    constexpr int kSegs = BN / 8;  // 16-byte segments a pixel row
#pragma unroll
    for (int i = 0; i < Cfg::BK * kSegs / Cfg::kThreads; ++i) {
      const int v = threadIdx.x + i * Cfg::kThreads;
      const int r = v / kSegs, cc = v % kSegs;
      const int64_t p = p0 + r;
      const int n = n0 + cc * 8;
      const bool ok = p < pe && n < Cout;
      cp_async16(Bt + mnmajor_seg(r, cc), ok ? dz + p * Cout + n : dz, ok);
    }
  }

  __device__ void epilogue(const WAcc<T, BN>& acc, float*) const {
    const int row0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * BN;
    const int rows = 9 * Cin;
    float* out = ws + static_cast<int64_t>(blockIdx.z) * rows * Cout;
    acc.for_pairs([&](int r, int col, float v0, float v1) {
      // Cout is a multiple of 16: a pair is in or out together
      if (row0 + r < rows && n0 + col < Cout)
        *reinterpret_cast<float2*>(
            out + static_cast<int64_t>(row0 + r) * Cout + n0 + col) =
            make_float2(v0, v1);
    });
  }
};

// g (M, K) = dz (M, N) @ w^T, w (K, N): rows pixels (BM a tile), columns
// K (BN a tile), reduction N in 64-deep chunks; A and B K-major (dz's
// pixel rows, w's rows: N contiguous), as they lie. The epilogue masks
// by s = x a + b > 0 with s recomputed in fp32 from x, a and b (the
// prologue's own rule: a positive s below bf16's least subnormal rounds
// to a bf16 u of 0, so u > 0 would drop it), and writes the tile's
// (Σg, Σg x̂) partial where the reductions run.
template <typename T, int BN>
struct MmDgradPipe {
  using Cfg = PCfg<T, BN, false>;
  const T* dz;  // (M, N)
  const T* w;   // (K, N)
  const T* x;   // (M, K); null: no mask and no reductions
  const float* a;   // null: no mask
  const float* b;
  const float* mu;  // null: no reductions
  const float* rs;
  T* g;
  float* part;  // (tiles over M, 2, K) or null
  int64_t M;
  int K, N;

  struct Thread {};

  __device__ int chunks() const { return (N + Cfg::BK - 1) / Cfg::BK; }
  __device__ Thread thread_init() const { return Thread{}; }

  __device__ void load(Thread&, int kc, unsigned char* As,
                       unsigned char* Bs) const {
    const int c0 = kc * Cfg::BK;
    load_kmajor_rows<Cfg::BM, Cfg::kThreads>(
        As, dz, M, N, static_cast<int64_t>(blockIdx.x) * Cfg::BM, c0);
    load_kmajor_rows<BN, Cfg::kThreads>(Bs, w, K, N, blockIdx.y * BN, c0);
  }

  // Each thread a 16-byte run of 8 channels down every kRowGroups-th row
  // of the tile (vector loads of x, one vector store of g), its sums in
  // row order; the row groups' sums then combined in group order through
  // shared memory (the tile's, free once read).
  __device__ void epilogue(const WAcc<T, BN>& acc, float* Cs) const {
    acc.store(Cs, Cfg::LDC);
    __syncthreads();
    constexpr int kSegs = BN / 8;
    constexpr int kRowGroups = Cfg::kThreads / kSegs;
    const int64_t m0 = static_cast<int64_t>(blockIdx.x) * Cfg::BM;
    const int k0 = blockIdx.y * BN;
    const int rows = span(M - m0, Cfg::BM);
    const int cols = min(BN, K - k0);  // a multiple of 64
    const int seg = threadIdx.x % kSegs, rg = threadIdx.x / kSegs;
    const int c = seg * 8;
    float s1[8], s2[8], a8[8], b8[8], mu8[8], rs8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s1[j] = s2[j] = 0.f;
      a8[j] = b8[j] = mu8[j] = rs8[j] = 0.f;
    }
    if (c < cols) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (a != nullptr) {
          a8[j] = a[k0 + c + j];
          b8[j] = b[k0 + c + j];
        }
        if (mu != nullptr) {
          mu8[j] = mu[k0 + c + j];
          rs8[j] = rs[k0 + c + j];
        }
      }
#pragma unroll
      for (int i = 0; i < Cfg::BM / kRowGroups; ++i) {
        const int r = rg + i * kRowGroups;
        if (r < rows) {
          const int64_t off = (m0 + r) * K + k0 + c;
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = Cs[r * Cfg::LDC + c + j];
          if (x != nullptr) {
            float xv[8];
            load_vec<T, 8>(x + off, xv);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (a != nullptr && !(prologue_f32(xv[j], a8[j], b8[j]) > 0.f))
                v[j] = 0.f;
              if (mu != nullptr) {
                s1[j] += v[j];
                s2[j] = fmaf(v[j],
                             __fmul_rn(__fsub_rn(xv[j], mu8[j]), rs8[j]),
                             s2[j]);
              }
            }
          }
          store_vec_packed<T, 8>(g + off, v);
        }
      }
    }
    if (part == nullptr) return;  // uniform: no reductions
    combine_row_groups<BN, kRowGroups>(
        s1, s2, rg, c, cols, Cs,
        part + static_cast<int64_t>(blockIdx.x) * 2 * K + k0, K);
  }
};

// ws[s] (K, N) = sum over the pixels p of split s of u[p]^T dz[p]: rows
// K (BM a tile), columns N (BN a tile), reduction the split's pixels in
// 64-deep chunks; both sources MN-major (pixels down the tile), as they
// lie.
template <typename T, int BN>
struct MmWgradPipe {
  using Cfg = PCfg<T, BN, true>;
  const T* u;   // (M, K)
  const T* dz;  // (M, N)
  float* ws;    // (splits, K, N)
  int64_t M;
  int K, N;
  int64_t split_len;

  struct Thread {};

  __device__ int64_t p_begin() const {
    return static_cast<int64_t>(blockIdx.z) * split_len;
  }
  __device__ int64_t p_end() const {
    const int64_t e = p_begin() + split_len;
    return e < M ? e : M;
  }
  __device__ int chunks() const {
    const int64_t n = p_end() - p_begin();
    return n > 0 ? static_cast<int>((n + Cfg::BK - 1) / Cfg::BK) : 0;
  }
  __device__ Thread thread_init() const { return Thread{}; }

  __device__ void load(Thread&, int kc, unsigned char* At,
                       unsigned char* Bt) const {
    const int64_t p0 = p_begin() + static_cast<int64_t>(kc) * Cfg::BK;
    const int64_t pe = p_end();
    // A: segment c = tid % 16 (8 of the tile's 128 rows of K) of pixel
    // rows tid / 16 + 16 i
    const int c = threadIdx.x & 15;
    const int k = blockIdx.x * Cfg::BM + c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 4) + 16 * i;
      const int64_t p = p0 + r;
      const bool ok = k < K && p < pe;
      cp_async16(At + mnmajor_seg(r, c), ok ? u + p * K + k : u, ok);
    }
    const int n0 = blockIdx.y * BN;
    constexpr int kSegs = BN / 8;  // 16-byte segments a pixel row
#pragma unroll
    for (int i = 0; i < Cfg::BK * kSegs / Cfg::kThreads; ++i) {
      const int v = threadIdx.x + i * Cfg::kThreads;
      const int r = v / kSegs, cc = v % kSegs;
      const int64_t p = p0 + r;
      const int n = n0 + cc * 8;
      const bool ok = p < pe && n < N;
      cp_async16(Bt + mnmajor_seg(r, cc), ok ? dz + p * N + n : dz, ok);
    }
  }

  __device__ void epilogue(const WAcc<T, BN>& acc, float*) const {
    const int row0 = blockIdx.x * Cfg::BM, n0 = blockIdx.y * BN;
    float* out = ws + static_cast<int64_t>(blockIdx.z) * K * N;
    acc.for_pairs([&](int r, int col, float v0, float v1) {
      if (row0 + r < K && n0 + col < N)
        *reinterpret_cast<float2*>(
            out + static_cast<int64_t>(row0 + r) * N + n0 + col) =
            make_float2(v0, v1);
    });
  }
};

// the 3x3 backward on the pipe: pre-pass, dgrad, wgrad, the sums of the
// wgrad's split partials (one launch for every tap) and of the dgrad's
// tile partials. dzbuf is null when y is (dz = e itself).
template <typename T>
int conv3_bwd_pipe(Cot<T> d, Up<T> u, const T* w, T* g, float* dw,
                   float* r12, float* part, float* wsw, float* scratch,
                   T* dzbuf, T* ubuf, int n, int H, int W, int Cin, int Cout,
                   int64_t split_len, int splits, int sms,
                   cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(n) * H * W;
  const int tiles = static_cast<int>((M + 127) / 128);
  const int pre_blocks = prepass_blocks(M, Cin, Cout, sms);
  if (pre_blocks > 0) {
    conv3_prepass_kernel<T><<<pre_blocks, 256, 0, stream>>>(
        d, u, dzbuf, ubuf, M, Cin, Cout);
    note_launch("conv3_prepass_kernel");
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* dz = d.y != nullptr ? dzbuf : d.e;
  if (Cin % 128 == 0) {
    Conv3DgradPipe<T, 128> p{dz, ubuf, u.x, u.mu, u.rs, w, g, part,
                          M, H, W, Cin, Cout};
    err = launch_pipe(p, dim3(tiles, Cin / 128), stream);
  } else {
    Conv3DgradPipe<T, 64> p{dz, ubuf, u.x, u.mu, u.rs, w, g, part,
                         M, H, W, Cin, Cout};
    err = launch_pipe(p, dim3(tiles, (Cin + 63) / 64), stream);
  }
  if (err != cudaSuccess) return err;
  const unsigned row_tiles = static_cast<unsigned>((9 * Cin + 127) / 128);
  if (Cout % 128 == 0) {
    Conv3WgradPipe<T, 128> p{ubuf, dz, wsw, M, H, W, Cin, Cout, split_len};
    err = launch_pipe(p, dim3(row_tiles, Cout / 128, splits), stream);
  } else {
    Conv3WgradPipe<T, 64> p{ubuf, dz, wsw, M, H, W, Cin, Cout, split_len};
    err = launch_pipe(p, dim3(row_tiles, (Cout + 63) / 64, splits), stream);
  }
  if (err != cudaSuccess) return err;
  err = sum_parts(wsw, splits, 9 * static_cast<int64_t>(Cin) * Cout, dw, sms,
                  stream);
  if (err != cudaSuccess) return err;
  return reduce_parts(part, tiles, 2 * static_cast<int64_t>(Cin), r12,
                      scratch, stream);
}

// the 1x1 backward on the pipe (K and N multiples of 64): the
// pre-pass where there is a pre-mask or a finalize (dzbuf; else dz = e)
// and where the wgrad runs under a prologue (ubuf; else u = x), the
// dgrad (g non-null), the wgrad and the sum of its split partials (dw
// non-null), the sums of the dgrad's tile partials (with the
// reductions).
template <typename T>
int mm_bwd_pipe(Cot<T> d, Up<T> u, const T* w, T* g, float* dw, float* r12,
                float* part, float* wsw, float* scratch, T* dzbuf, T* ubuf,
                int64_t M, int K, int N, int64_t split_len, int splits,
                int sms, cudaStream_t stream) {
  const bool need_dz = (d.z != nullptr || d.y != nullptr) &&
                       (g != nullptr || dw != nullptr);
  if (K % 64 != 0 || N % 64 != 0 || need_dz != (dzbuf != nullptr) ||
      (dw != nullptr && u.a != nullptr) != (ubuf != nullptr))
    return cudaErrorInvalidValue;
  const int tiles = static_cast<int>((M + 127) / 128);
  const int pre_blocks =
      dzbuf != nullptr || ubuf != nullptr ? prepass_blocks(M, K, N, sms) : 0;
  if (pre_blocks > 0) {
    mm_prepass_kernel<T><<<pre_blocks, 256, 0, stream>>>(d, u, dzbuf, ubuf,
                                                         M, K, N);
    note_launch("mm_prepass_kernel");
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* dz = dzbuf != nullptr ? dzbuf : d.e;
  if (g != nullptr) {
    const T* x = u.a != nullptr || u.mu != nullptr ? u.x : nullptr;
    float* p = u.mu != nullptr ? part : nullptr;
    if (K % 128 == 0) {
      MmDgradPipe<T, 128> pd{dz, w, x, u.a, u.b, u.mu, u.rs, g, p, M, K, N};
      err = launch_pipe(pd, dim3(tiles, K / 128), stream);
    } else {
      MmDgradPipe<T, 64> pd{dz, w, x, u.a, u.b, u.mu, u.rs, g, p, M, K, N};
      err = launch_pipe(pd, dim3(tiles, K / 64), stream);
    }
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr) {
    const T* src = ubuf != nullptr ? ubuf : u.x;
    const unsigned row_tiles = static_cast<unsigned>((K + 127) / 128);
    if (N % 128 == 0) {
      MmWgradPipe<T, 128> pw{src, dz, wsw, M, K, N, split_len};
      err = launch_pipe(pw, dim3(row_tiles, N / 128, splits), stream);
    } else {
      MmWgradPipe<T, 64> pw{src, dz, wsw, M, K, N, split_len};
      err = launch_pipe(pw, dim3(row_tiles, N / 64, splits), stream);
    }
    if (err != cudaSuccess) return err;
    err = sum_parts(wsw, splits, static_cast<int64_t>(K) * N, dw, sms,
                    stream);
    if (err != cudaSuccess) return err;
  }
  if (g != nullptr && u.mu != nullptr)
    err = reduce_parts(part, tiles, 2 * static_cast<int64_t>(K), r12,
                       scratch, stream);
  return err;
}

// the fp32 3x3 backward (the parity runs'): the staged core, dz and u
// recomputed while staging; the wgrad's partials (splits, 9, Cin, Cout)
// reduced in one launch
inline int conv3_bwd_f32(Cot<float> d, Up<float> u, const float* w,
                         float* g, float* dw, float* r12, float* part,
                         float* wsw, float* scratch, int n, int H, int W,
                         int Cin, int Cout, int64_t split_len, int splits,
                         cudaStream_t stream) {
  using C = Cfg<float>;
  const int64_t M = static_cast<int64_t>(n) * H * W;
  const int tiles = static_cast<int>((M + C::BM - 1) / C::BM);
  Conv3Dgrad<float> pd{d, u, w, g, part, M, H, W, Cin, Cout};
  cudaError_t err =
      launch_gemm<float>(pd, dim3(tiles, (Cin + C::BN - 1) / C::BN), stream);
  if (err != cudaSuccess) return err;
  Wgrad<float, 9> pw{d, u, wsw, M, H, W, Cin, Cout, split_len};
  err = launch_gemm<float>(
      pw, dim3((Cin + C::BM - 1) / C::BM, (Cout + C::BN - 1) / C::BN,
               9 * splits),
      stream);
  if (err != cudaSuccess) return err;
  err = reduce_parts(wsw, splits, 9 * static_cast<int64_t>(Cin) * Cout, dw,
                     nullptr, stream);
  if (err != cudaSuccess) return err;
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
// g (dgrad), dw (wgrad (K, N) fp32, through wsw (splits, K, N)). pipe:
// the bf16 form on bottleneck_pipe.cuh (K and N multiples of 64), with
// the pre-pass's dzbuf (M, N) where z or y is given and ubuf (M, K) where
// dw and a are (else null); sms sizes the pre-pass and the sums. pipe 0:
// the staged core (dzbuf, ubuf null).
int bneck_mm_bwd(const void* e, const void* z, const void* y,
                 const float* k1, const float* k2, const float* k0,
                 const void* x, const float* a, const float* b,
                 const float* mu, const float* rs, const void* w, void* g,
                 float* dw, float* r12, float* part, float* wsw,
                 float* scratch, void* dzbuf, void* ubuf, long long M, int K,
                 int N, long long split_len, int splits, int pipe, int sms,
                 int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (pipe) {
    if (!is_half_code(dtype)) return cudaErrorInvalidValue;
    return with_half(dtype, [&](auto h) {
      using T = decltype(h);
      return bneck::mm_bwd_pipe<T>(
          {static_cast<const T*>(e), static_cast<const T*>(z),
           static_cast<const T*>(y), k1, k2, k0},
          {static_cast<const T*>(x), a, b, mu, rs}, static_cast<const T*>(w),
          static_cast<T*>(g), dw, r12, part, wsw, scratch,
          static_cast<T*>(dzbuf), static_cast<T*>(ubuf), M, K, N, split_len,
          splits, sms, s);
    });
  }
  if (is_half_code(dtype)) {
    return with_half(dtype, [&](auto h) {
      using T = decltype(h);
      return bneck::mm_bwd<T>(
          {static_cast<const T*>(e), static_cast<const T*>(z),
           static_cast<const T*>(y), k1, k2, k0},
          {static_cast<const T*>(x), a, b, mu, rs}, w, g, dw, r12, part, wsw,
          scratch, M, K, N, split_len, splits, s);
    });
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
// finalize optional (y null), the prologue and the reductions not. wsw:
// the wgrad's (splits, 9, Cin, Cout) fp32 partials. bf16 only: dzbuf (M,
// Cout) (unused without y) and ubuf (M, Cin), the pre-pass's outputs; sms
// sizes its grid.
int bneck_conv3_bwd(const void* e, const void* y, const float* k1,
                    const float* k2, const float* k0, const void* x,
                    const float* a, const float* b, const float* mu,
                    const float* rs, const void* w, void* g, float* dw,
                    float* r12, float* part, float* wsw, float* scratch,
                    void* dzbuf, void* ubuf, int n, int H, int W, int Cin,
                    int Cout, long long split_len, int splits, int sms,
                    int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_half_code(dtype)) {
    return with_half(dtype, [&](auto h) {
      using T = decltype(h);
      return bneck::conv3_bwd_pipe<T>(
          {static_cast<const T*>(e), nullptr, static_cast<const T*>(y), k1,
           k2, k0},
          {static_cast<const T*>(x), a, b, mu, rs}, static_cast<const T*>(w),
          static_cast<T*>(g), dw, r12, part, wsw, scratch,
          static_cast<T*>(dzbuf), static_cast<T*>(ubuf), n, H, W, Cin, Cout,
          split_len, splits, sms, s);
    });
  }
  if (dtype == kFloat32) {
    using T = float;
    return bneck::conv3_bwd_f32(
        {static_cast<const T*>(e), nullptr, static_cast<const T*>(y), k1, k2,
         k0},
        {static_cast<const T*>(x), a, b, mu, rs}, static_cast<const T*>(w),
        static_cast<T*>(g), dw, r12, part, wsw, scratch, n, H, W, Cin, Cout,
        split_len, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
