// Row LayerNorm forward (plain, residual, residual with dropout on the
// delta) and its backward, for Hopper (sm_90a).
//
// Forward: replaces rocm_apex_tpu/ops/layer_norm.py:78 `_ln_fwd_kernel`.
// Per row of a (rows, hidden) view: s = x (+ keep * delta / (1 - rate)),
// in fp32; y = (s - mean) * rsqrt(var + eps) (* gamma + beta), with the
// two-pass mean-then-centred-variance statistics of the TPU kernel. The
// residual forms also write s in the stream dtype; the statistics use
// the fp32 sum, not the rounded s, as the TPU kernel does. The keep bit
// of element (row, c) is dropout.cuh's hash of (seed, 0, row, c).
//
// Backward: replaces rocm_apex_tpu/ops/layer_norm.py:204 `_ln_bwd_kernel`.
// With x̂ = (s - mean) * rsigma and g = dy * gamma:
//   dx = rsigma * (g - mean(g) - x̂ * mean(g * x̂))  (+ ds, the stream's
//   cotangent), dd = keep * dx / (1 - rate) with the forward's bits
//   regenerated, dgamma = sum_rows dy * x̂, dbeta = sum_rows dy.
// dgamma/dbeta are reduced in two stages in fp32, as on the TPU: each
// block sums its rows into per-warp shared-memory columns, adds the warps
// in a fixed order and writes one partial row; `ln_bwd_reduce` adds the
// partials in a fixed order. No atomics, so the result is the same run
// to run.
//
// Bound: bytes (a handful of FLOPs per element). The forward's layout is
// the host's plan (ops/layer_norm.py `ln_fwd_plan`), by shape:
// - the register row (`ln_fwd_warp_kernel`: a warp a row, when the rows
//   fill the card; `ln_fwd_block_kernel`: a block of up to 8 warps a row,
//   when they are too few, as the serve's 8-row decode tick): each thread
//   holds its columns in registers, at most kLnMaxValues fp32 values. x
//   and delta are read once with 16-byte loads, each keep bit hashed
//   once, s and y written once with vector stores; the sums are a
//   thread's columns in order, the warp's butterfly, then the row's warps
//   in index order through shared memory;
// - the three-pass row (`ln_fwd_kernel`), for widths off the 16-byte
//   vector grid, past the register cap, or at unaligned addresses: one
//   warp a row, the lanes striding over it three times (sum, centred
//   squares, output), re-reading it from L1 and re-hashing each keep bit.
// The backward is one warp a row, every pass a coalesced warp load.
#include "common.cuh"
#include "dropout.cuh"

namespace apex_port {

struct Dropout {
  int on;
  uint32_t seed;
  uint32_t thr;
  float scale;  // 1 / (1 - rate)
};

template <typename T>
__device__ __forceinline__ float row_value(const T* __restrict__ x,
                                           const T* __restrict__ d, int c,
                                           const Dropout& drop,
                                           uint32_t row_key) {
  float v = to_float(x[c]);
  if (d != nullptr) {
    float dv = to_float(d[c]);
    if (drop.on) dv = keep_bit(row_key, c, drop.thr) ? dv * drop.scale : 0.f;
    v += dv;
  }
  return v;
}

template <typename T, typename W, typename Y>
__global__ void __launch_bounds__(128)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                  const W* __restrict__ gamma, const W* __restrict__ beta,
                  Y* __restrict__ y, T* __restrict__ s,
                  float* __restrict__ mean, float* __restrict__ rsigma,
                  int rows, int hidden, float eps, Dropout drop) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform per warp
  const int64_t off = static_cast<int64_t>(row) * hidden;
  const T* xr = x + off;
  const T* dr = delta != nullptr ? delta + off : nullptr;
  const uint32_t key = dropout_row_key(drop.seed, 0u, row);

  float sum = 0.f;
  for (int c = lane; c < hidden; c += 32) {
    const float v = row_value(xr, dr, c, drop, key);
    if (s != nullptr) s[off + c] = from_float<T>(v);
    sum += v;
  }
  const float mu = warp_sum(sum) / hidden;

  float sq = 0.f;
  for (int c = lane; c < hidden; c += 32) {
    const float t = row_value(xr, dr, c, drop, key) - mu;
    sq = fmaf(t, t, sq);
  }
  const float rs = rsqrtf(warp_sum(sq) / hidden + eps);

  Y* yr = y + off;
  for (int c = lane; c < hidden; c += 32) {
    float o = (row_value(xr, dr, c, drop, key) - mu) * rs;
    if (gamma != nullptr) o = o * to_float(gamma[c]) + to_float(beta[c]);
    yr[c] = from_float<Y>(o);
  }
  if (lane == 0) {
    mean[row] = mu;
    rsigma[row] = rs;
  }
}

// The register row: at most this many fp32 values a thread (ops/
// layer_norm.py _LN_MAX_VALUES), at most kLnMaxRowWarps warps a row.
constexpr int kLnMaxValues = 32;
constexpr int kLnMaxRowWarps = 8;
// a warp a row: four rows a block
constexpr int kLnWarpRowThreads = 128;

// The row's sum on every thread of its row: the warp's butterfly, then
// for a block-wide row the warps in index order through `red`.
template <bool kBlockRow>
__device__ __forceinline__ float ln_row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (kBlockRow) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) v += red[w];
  }
  return v;
}

// N elements of T at p (aligned to min(16, N * sizeof(T)) bytes) as fp32,
// in 16-byte pieces
template <typename T, int N>
__device__ __forceinline__ void load_wide(const T* __restrict__ p,
                                          float (&out)[N]) {
  constexpr int kPiece = 16 / static_cast<int>(sizeof(T));
  if constexpr (N <= kPiece) {
    load_vec<T, N>(p, out);
  } else {
#pragma unroll
    for (int k = 0; k < N / kPiece; ++k) {
      float part[kPiece];
      load_vec<T, kPiece>(p + k * kPiece, part);
#pragma unroll
      for (int i = 0; i < kPiece; ++i) out[k * kPiece + i] = part[i];
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_wide(T* __restrict__ p,
                                           const float (&in)[N]) {
  constexpr int kPiece = 16 / static_cast<int>(sizeof(T));
  if constexpr (N <= kPiece) {
    store_vec_packed<T, N>(p, in);
  } else {
#pragma unroll
    for (int k = 0; k < N / kPiece; ++k) {
      float part[kPiece];
#pragma unroll
      for (int i = 0; i < kPiece; ++i) part[i] = in[k * kPiece + i];
      store_vec_packed<T, kPiece>(p + k * kPiece, part);
    }
  }
}

// One row of the register form. Thread t of a row of R threads holds the
// 16-byte vectors j * R + t, j < NV, that start inside the row.
template <typename T, typename W, typename Y, int NV, bool kBlockRow>
__device__ __forceinline__ void ln_fwd_row(
    const T* __restrict__ x, const T* __restrict__ delta,
    const W* __restrict__ gamma, const W* __restrict__ beta,
    Y* __restrict__ y, T* __restrict__ s, float* __restrict__ mean,
    float* __restrict__ rsigma, int rows, int hidden, float eps,
    const Dropout& drop) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  __shared__ float red[2][kLnMaxRowWarps];
  const int row = static_cast<int>(
      kBlockRow ? blockIdx.x
                : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
  if (!kBlockRow && row >= rows) return;  // uniform per warp
  const int t = kBlockRow ? static_cast<int>(threadIdx.x)
                          : static_cast<int>(threadIdx.x & 31);
  const int row_threads = kBlockRow ? static_cast<int>(blockDim.x) : 32;
  const int64_t off = static_cast<int64_t>(row) * hidden;

  // every load first: x's and delta's 16-byte words
  uint4 xw[NV], dw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * row_threads + t) * VEC;
    if (c < hidden) {
      xw[j] = *reinterpret_cast<const uint4*>(x + off + c);
      if (delta != nullptr)
        dw[j] = *reinterpret_cast<const uint4*>(delta + off + c);
    }
  }
  const uint32_t key = dropout_row_key(drop.seed, 0u, row);
  float v[NV][VEC];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * row_threads + t) * VEC;
    if (c < hidden) {
      const T* xe = reinterpret_cast<const T*>(&xw[j]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][i] = to_float(xe[i]);
      if (delta != nullptr) {
        const T* de = reinterpret_cast<const T*>(&dw[j]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float dv = to_float(de[i]);
          // __fmul_rn: no contraction into the add, as the plain version
          if (drop.on)
            dv = keep_bit(key, c + i, drop.thr) ? __fmul_rn(dv, drop.scale)
                                                : 0.f;
          v[j][i] += dv;
        }
        if (s != nullptr) store_vec_packed<T, VEC>(s + off + c, v[j]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum += v[j][i];
    }
  }
  const float mu = ln_row_sum<kBlockRow>(sum, red[0]) / hidden;

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * row_threads + t) * VEC;
    if (c < hidden) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[j][i] - mu;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rs = rsqrtf(ln_row_sum<kBlockRow>(sq, red[1]) / hidden + eps);

#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * row_threads + t) * VEC;
    if (c < hidden) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = (v[j][i] - mu) * rs;
      if (gamma != nullptr) {
        float g[VEC], b[VEC];
        load_wide<W, VEC>(gamma + c, g);
        load_wide<W, VEC>(beta + c, b);
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = o[i] * g[i] + b[i];
      }
      store_wide<Y, VEC>(y + off + c, o);
    }
  }
  if (t == 0) {
    mean[row] = mu;
    rsigma[row] = rs;
  }
}

#define APEX_LN_FWD_PARAMS                                                 \
  const T *__restrict__ x, const T *__restrict__ delta,                    \
      const W *__restrict__ gamma, const W *__restrict__ beta,             \
      Y *__restrict__ y, T *__restrict__ s, float *__restrict__ mean,      \
      float *__restrict__ rsigma, int rows, int hidden, float eps,         \
      Dropout drop

template <typename T, typename W, typename Y, int NV>
__global__ void __launch_bounds__(kLnWarpRowThreads)
    ln_fwd_warp_kernel(APEX_LN_FWD_PARAMS) {
  ln_fwd_row<T, W, Y, NV, false>(x, delta, gamma, beta, y, s, mean, rsigma,
                                 rows, hidden, eps, drop);
}

template <typename T, typename W, typename Y, int NV>
__global__ void __launch_bounds__(kLnMaxRowWarps * 32)
    ln_fwd_block_kernel(APEX_LN_FWD_PARAMS) {
  ln_fwd_row<T, W, Y, NV, true>(x, delta, gamma, beta, y, s, mean, rsigma,
                                rows, hidden, eps, drop);
}
#undef APEX_LN_FWD_PARAMS

// rows handled by one backward block: 4 warps x 8 rows
constexpr int kBwdWarps = 4;
constexpr int kBwdRowsPerBlock = 32;

template <typename T, typename W, typename Y>
__global__ void __launch_bounds__(kBwdWarps * 32)
    ln_bwd_kernel(const T* __restrict__ x, const Y* __restrict__ dy,
                  const T* __restrict__ ds, const float* __restrict__ mean,
                  const float* __restrict__ rsigma,
                  const W* __restrict__ gamma, T* __restrict__ dx,
                  T* __restrict__ dd, float* __restrict__ part, int rows,
                  int hidden, Dropout drop) {
  extern __shared__ float sm[];  // [warp][dgamma | dbeta][hidden]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sg = sm + warp * 2 * hidden;
  float* sb = sg + hidden;
  for (int c = lane; c < hidden; c += 32) {
    sg[c] = 0.f;
    sb[c] = 0.f;
  }
  const int row0 = blockIdx.x * kBwdRowsPerBlock;
  const int row_end = min(row0 + kBwdRowsPerBlock, rows);
  for (int row = row0 + warp; row < row_end; row += kBwdWarps) {
    const int64_t off = static_cast<int64_t>(row) * hidden;
    const float mu = mean[row];
    const float rs = rsigma[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < hidden; c += 32) {
      const float xh = (to_float(x[off + c]) - mu) * rs;
      const float g = to_float(dy[off + c]);
      const float gg = g * to_float(gamma[c]);
      s1 += gg;
      s2 = fmaf(gg, xh, s2);
      sg[c] = fmaf(g, xh, sg[c]);  // lane-private columns: no race
      sb[c] += g;
    }
    const float c1 = warp_sum(s1) / hidden;
    const float c2 = warp_sum(s2) / hidden;
    const uint32_t key = dropout_row_key(drop.seed, 0u, row);
    for (int c = lane; c < hidden; c += 32) {
      const float xh = (to_float(x[off + c]) - mu) * rs;
      const float gg = to_float(dy[off + c]) * to_float(gamma[c]);
      float v = rs * (gg - c1 - xh * c2);
      if (ds != nullptr) v += to_float(ds[off + c]);
      dx[off + c] = from_float<T>(v);
      if (dd != nullptr)
        dd[off + c] = from_float<T>(
            keep_bit(key, c, drop.thr) ? v * drop.scale : 0.f);
    }
  }
  __syncthreads();
  float* out = part + static_cast<int64_t>(blockIdx.x) * 2 * hidden;
  for (int c = threadIdx.x; c < hidden; c += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) {
      g += sm[w * 2 * hidden + c];
      b += sm[w * 2 * hidden + hidden + c];
    }
    out[c] = g;
    out[hidden + c] = b;
  }
}

// dgamma/dbeta = the column sums of the (blocks, 2, hidden) partials. A
// (32, 8) block: 32 columns, 8 slices of the partial rows, added across
// slices in a fixed order.
template <typename W>
__global__ void __launch_bounds__(256)
    ln_bwd_reduce_kernel(const float* __restrict__ part, int blocks,
                         int hidden, W* __restrict__ dgamma,
                         W* __restrict__ dbeta) {
  __shared__ float red[2][8][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float g = 0.f, b = 0.f;
  if (c < hidden) {
    for (int k = threadIdx.y; k < blocks; k += 8) {
      g += part[static_cast<int64_t>(k) * 2 * hidden + c];
      b += part[static_cast<int64_t>(k) * 2 * hidden + hidden + c];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = g;
  red[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < hidden) {
    g = 0.f;
    b = 0.f;
    for (int k = 0; k < 8; ++k) {
      g += red[0][k][threadIdx.x];
      b += red[1][k][threadIdx.x];
    }
    dgamma[c] = from_float<W>(g);
    dbeta[c] = from_float<W>(b);
  }
}

// Calls F::template run<T, W, Y>() for the three dtype codes.
template <typename F>
static int dispatch3(int t, int w, int y, F&& f) {
#define APEX_LN_Y(TT, WW)                                                  \
  if (y == kFloat32) return f.template run<TT, WW, float>();              \
  if (y == kBFloat16) return f.template run<TT, WW, __nv_bfloat16>();     \
  return static_cast<int>(cudaErrorInvalidValue);
#define APEX_LN_W(TT)                                                      \
  if (w == kFloat32) { APEX_LN_Y(TT, float) }                              \
  if (w == kBFloat16) { APEX_LN_Y(TT, __nv_bfloat16) }                     \
  return static_cast<int>(cudaErrorInvalidValue);
  if (t == kFloat32) { APEX_LN_W(float) }
  if (t == kBFloat16) { APEX_LN_W(__nv_bfloat16) }
  return static_cast<int>(cudaErrorInvalidValue);
#undef APEX_LN_W
#undef APEX_LN_Y
}

struct FwdLaunch {
  const void *x, *delta, *gamma, *beta;
  void *y, *s, *mean, *rsigma;
  int rows, hidden;
  float eps;
  Dropout drop;
  int row_warps, vectors;  // the plan's layout; row_warps 0: three-pass
  cudaStream_t stream;

  template <typename T, typename W, typename Y>
  int run() {
    if (row_warps == 0) {
      const int threads = 128;  // four rows per block
      const int blocks = (rows * 32 + threads - 1) / threads;
      ln_fwd_kernel<T, W, Y><<<blocks, threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(delta),
          static_cast<const W*>(gamma), static_cast<const W*>(beta),
          static_cast<Y*>(y), static_cast<T*>(s), static_cast<float*>(mean),
          static_cast<float*>(rsigma), rows, hidden, eps, drop);
      return 0;
    }
    // the register row takes what its plan checked: 16-byte aligned
    // addresses, whole vectors, every vector of the row held
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    const uintptr_t bits =
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(delta) |
        reinterpret_cast<uintptr_t>(gamma) |
        reinterpret_cast<uintptr_t>(beta) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(s);
    if (bits % 16 != 0 || hidden % kVec != 0 || row_warps < 1 ||
        row_warps > kLnMaxRowWarps ||
        static_cast<int64_t>(vectors) * 32 * row_warps * kVec < hidden)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_register<T, W, Y, 1>();
  }

  // the instance of NV == vectors: 1, 2, 4, ... up to kLnMaxValues values
  template <typename T, typename W, typename Y, int NV>
  int launch_register() {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if constexpr (NV * kVec > kLnMaxValues) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (vectors != NV) return launch_register<T, W, Y, NV * 2>();
      auto args = [&](auto kernel, int blocks, int threads) {
        kernel<<<blocks, threads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(delta),
            static_cast<const W*>(gamma), static_cast<const W*>(beta),
            static_cast<Y*>(y), static_cast<T*>(s),
            static_cast<float*>(mean), static_cast<float*>(rsigma), rows,
            hidden, eps, drop);
      };
      if (row_warps == 1) {
        constexpr int kRows = kLnWarpRowThreads / 32;
        args(ln_fwd_warp_kernel<T, W, Y, NV>, (rows + kRows - 1) / kRows,
             kLnWarpRowThreads);
      } else {
        args(ln_fwd_block_kernel<T, W, Y, NV>, rows, 32 * row_warps);
      }
      return 0;
    }
  }
};

struct BwdLaunch {
  const void *x, *dy, *ds, *mean, *rsigma, *gamma;
  void *dx, *dd, *part, *dgamma, *dbeta;
  int rows, hidden;
  Dropout drop;
  cudaStream_t stream;

  template <typename T, typename W, typename Y>
  int run() {
    const int blocks = (rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
    const size_t smem = sizeof(float) * kBwdWarps * 2 * hidden;
    auto kernel = ln_bwd_kernel<T, W, Y>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<blocks, kBwdWarps * 32, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const Y*>(dy),
        static_cast<const T*>(ds), static_cast<const float*>(mean),
        static_cast<const float*>(rsigma), static_cast<const W*>(gamma),
        static_cast<T*>(dx), static_cast<T*>(dd), static_cast<float*>(part),
        rows, hidden, drop);
    ln_bwd_reduce_kernel<W><<<(hidden + 31) / 32, dim3(32, 8), 0, stream>>>(
        static_cast<const float*>(part), blocks, hidden,
        static_cast<W*>(dgamma), static_cast<W*>(dbeta));
    return 0;
  }
};

}  // namespace apex_port

// x (and delta, s): (rows, hidden) contiguous in x_dtype; gamma/beta:
// (hidden,) in w_dtype or both null (no affine); delta and s both null
// for the plain form; y: (rows, hidden) in y_dtype; mean/rsigma: (rows,)
// fp32. dropout != 0 drops delta with keep bit hash(seed, 0, row, col)
// >= thr and scale 1/(1 - rate). row_warps/vectors: `ln_fwd_plan`'s
// layout (0: the three-pass row; 1: a warp a row; more: a block of that
// many warps a row, `vectors` 16-byte vectors a thread).
extern "C" int ln_fwd(const void* x, const void* delta, const void* gamma,
                      const void* beta, void* y, void* s, void* mean,
                      void* rsigma, int rows, int hidden, float eps,
                      int dropout, unsigned seed, unsigned thr,
                      float keep_scale, int x_dtype, int w_dtype,
                      int y_dtype, int row_warps, int vectors,
                      void* stream) {
  using namespace apex_port;
  FwdLaunch l{x, delta, gamma, beta, y, s, mean, rsigma, rows, hidden, eps,
              Dropout{dropout, seed, thr, keep_scale}, row_warps, vectors,
              static_cast<cudaStream_t>(stream)};
  const int rc = dispatch3(x_dtype, w_dtype, y_dtype, l);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// x: the saved (rows, hidden) LN input (the stream s of the residual
// forms) in x_dtype; dy: (rows, hidden) in y_dtype; ds: the stream's
// cotangent in x_dtype or null; mean/rsigma: the forward's (rows,) fp32;
// gamma: (hidden,) in w_dtype. Writes dx (x_dtype), dd (x_dtype, only
// with dropout; else null), dgamma/dbeta ((hidden,) in w_dtype) through
// `part`, an fp32 scratch of ceil(rows / 32) * 2 * hidden.
extern "C" int ln_bwd(const void* x, const void* dy, const void* ds,
                      const void* mean, const void* rsigma,
                      const void* gamma, void* dx, void* dd, void* part,
                      void* dgamma, void* dbeta, int rows, int hidden,
                      int dropout, unsigned seed, unsigned thr,
                      float keep_scale, int x_dtype, int w_dtype,
                      int y_dtype, void* stream) {
  using namespace apex_port;
  BwdLaunch l{x, dy, ds, mean, rsigma, gamma, dx, dd, part, dgamma, dbeta,
              rows, hidden, Dropout{dropout, seed, thr, keep_scale},
              static_cast<cudaStream_t>(stream)};
  const int rc = dispatch3(x_dtype, w_dtype, y_dtype, l);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
