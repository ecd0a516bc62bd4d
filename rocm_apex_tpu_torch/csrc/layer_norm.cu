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
// block sums its rows into one partial row, adding its warps in a fixed
// order; `ln_bwd_reduce_kernel` adds the partials in a fixed order. No
// atomics, so the result is the same run to run. A null gamma is the
// non-affine form (`_ln_bwd_kernel` with affine=False): g = dy, no
// partials and no reduction launch; each kernel takes it as a template
// flag, so the affine instances are the code they were.
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
// The backward takes the forward's layouts (ops/layer_norm.py
// `ln_bwd_plan`): the register row (`ln_bwd_warp_kernel`, a warp a row at
// the training rows; `ln_bwd_block_kernel`, a block a row at few rows),
// the grid walking the rows with two or three blocks a multiprocessor. x, dy
// and ds are read once with 16-byte loads, the row sums of dy gamma and
// dy gamma x̂ taken from the registers, each keep bit hashed once, dx and
// dd written once with vector stores. A thread owns the same columns in
// every row its warp (block) walks, so dgamma and dbeta accumulate in its
// registers; a block adds its warps' sums once, in warp order, through
// shared memory, and writes one partial row: (grid, 2, hidden) partials.
// Widths off the vector grid, past the register cap or at unaligned
// addresses keep the old form (`ln_bwd_kernel`): a warp a row, x and dy
// read twice, dgamma/dbeta summed in shared memory an element at a time,
// a partial row a 32-row block.
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

template <typename T, typename W, typename Y, bool kAffine>
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
  if constexpr (kAffine) {
    for (int c = lane; c < hidden; c += 32) {
      sg[c] = 0.f;
      sb[c] = 0.f;
    }
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
      const float gg = kAffine ? g * to_float(gamma[c]) : g;
      s1 += gg;
      s2 = fmaf(gg, xh, s2);
      if constexpr (kAffine) {
        sg[c] = fmaf(g, xh, sg[c]);  // lane-private columns: no race
        sb[c] += g;
      }
    }
    const float c1 = warp_sum(s1) / hidden;
    const float c2 = warp_sum(s2) / hidden;
    const uint32_t key = dropout_row_key(drop.seed, 0u, row);
    for (int c = lane; c < hidden; c += 32) {
      const float xh = (to_float(x[off + c]) - mu) * rs;
      const float g = to_float(dy[off + c]);
      const float gg = kAffine ? g * to_float(gamma[c]) : g;
      float v = rs * (gg - c1 - xh * c2);
      if (ds != nullptr) v += to_float(ds[off + c]);
      dx[off + c] = from_float<T>(v);
      if (dd != nullptr)
        dd[off + c] = from_float<T>(
            keep_bit(key, c, drop.thr) ? v * drop.scale : 0.f);
    }
  }
  if constexpr (kAffine) {
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
}

// The register row's backward: the row groups of the grid (a warp, or a
// block of warps) walk rows g, g + groups, ...; thread t of a group of R
// threads holds the 16-byte vectors of x j * R + t, j < NV, that start
// inside the row, and the same columns of dy, ds, dx and dd. dgamma and
// dbeta of those columns accumulate in its registers over the rows it
// walks; at the end the block's warps add theirs in warp order through
// `colsum` (a warp route: every warp holds every column) and the block
// writes part[blockIdx.x] = (dgamma, dbeta) of its rows. Without
// kAffine, g = dy and no column sums are kept or written.
constexpr int kLnBwdWarpHidden = 32 * kLnMaxValues;  // a warp row's widest

// the line holding p into L2, ahead of its load
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename T, typename W, typename Y, int NV, bool kBlockRow,
          bool kAffine>
__device__ __forceinline__ void ln_bwd_row(
    const T* __restrict__ x, const Y* __restrict__ dy,
    const T* __restrict__ ds, const float* __restrict__ mean,
    const float* __restrict__ rsigma, const W* __restrict__ gamma,
    T* __restrict__ dx, T* __restrict__ dd, float* __restrict__ part,
    int rows, int hidden, Dropout drop) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  __shared__ float red[2][kLnMaxRowWarps];
  __shared__ float colsum[kBlockRow || !kAffine ? 1
                                                : 2 * kLnBwdWarpHidden];
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int warps = static_cast<int>(blockDim.x >> 5);
  const int t = kBlockRow ? static_cast<int>(threadIdx.x)
                          : static_cast<int>(threadIdx.x & 31);
  const int row_threads = kBlockRow ? static_cast<int>(blockDim.x) : 32;
  const int groups = kBlockRow ? static_cast<int>(gridDim.x)
                               : static_cast<int>(gridDim.x) * warps;

  float ag[NV][VEC], ab[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) ag[j][i] = ab[j][i] = 0.f;

  for (int row = kBlockRow ? static_cast<int>(blockIdx.x)
                           : static_cast<int>(blockIdx.x) * warps + warp;
       row < rows; row += groups) {  // uniform per row group
    if constexpr (kBlockRow) __syncthreads();  // red's last readers done
    const int64_t off = static_cast<int64_t>(row) * hidden;
    // every load first: the row's statistics, x's and ds's 16-byte words,
    // dy's VEC values
    const float mu = mean[row];
    const float rs = rsigma[row];
    uint4 xw[NV], sw[NV];
    float g[NV][VEC];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * row_threads + t) * VEC;
      if (c < hidden) {
        xw[j] = __ldcs(reinterpret_cast<const uint4*>(x + off + c));
        load_vec_once<Y, VEC>(dy + off + c, g[j]);
        if (ds != nullptr)
          sw[j] = __ldcs(reinterpret_cast<const uint4*>(ds + off + c));
      }
    }
    // the group's next row into L2 while this one is worked on: a row
    // group holds one row's loads in flight, so its next row's wait would
    // otherwise be a full trip to device memory
    if (row + groups < rows) {
      const int64_t nxt = off + static_cast<int64_t>(groups) * hidden;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (j * row_threads + t) * VEC;
        if (c < hidden) {
          prefetch_l2(x + nxt + c);
          prefetch_l2(dy + nxt + c);
          if (ds != nullptr) prefetch_l2(ds + nxt + c);
        }
      }
    }
    // the row sums of dy gamma and dy gamma x̂, and the column sums; x̂
    // and dy gamma are formed again below from the held words (holding
    // them would cost 2 * NV * VEC registers a thread, and the blocks an
    // SM keeps in flight)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * row_threads + t) * VEC;
      if (c < hidden) {
        float w[VEC];
        if constexpr (kAffine) load_wide<W, VEC>(gamma + c, w);
        const T* xe = reinterpret_cast<const T*>(&xw[j]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xh = (to_float(xe[i]) - mu) * rs;
          const float gg = kAffine ? g[j][i] * w[i] : g[j][i];
          if constexpr (kAffine) {
            ag[j][i] = fmaf(g[j][i], xh, ag[j][i]);
            ab[j][i] += g[j][i];
          }
          s1 += gg;
          s2 = fmaf(gg, xh, s2);
        }
      }
    }
    const float c1 = ln_row_sum<kBlockRow>(s1, red[0]) / hidden;
    const float c2 = ln_row_sum<kBlockRow>(s2, red[1]) / hidden;
    const uint32_t key = dropout_row_key(drop.seed, 0u, row);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * row_threads + t) * VEC;
      if (c < hidden) {
        float w[VEC], v[VEC];
        if constexpr (kAffine) load_wide<W, VEC>(gamma + c, w);
        const T* xe = reinterpret_cast<const T*>(&xw[j]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xh = (to_float(xe[i]) - mu) * rs;
          v[i] = rs * ((kAffine ? g[j][i] * w[i] : g[j][i]) - c1 - xh * c2);
        }
        if (ds != nullptr) {
          const T* se = reinterpret_cast<const T*>(&sw[j]);
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] += to_float(se[i]);
        }
        store_vec_once<T, VEC>(dx + off + c, v);
        if (dd != nullptr) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            v[i] = keep_bit(key, c + i, drop.thr) ? v[i] * drop.scale : 0.f;
          store_vec_once<T, VEC>(dd + off + c, v);
        }
      }
    }
  }

  // the block's partial row: a block row's threads own disjoint columns;
  // a warp route's warps each own every column, added in warp order (no
  // partial row without kAffine)
  float* out = part + (kAffine ? static_cast<int64_t>(blockIdx.x) * 2 *
                                     hidden
                               : 0);
  for (int w = 0; w < (!kAffine ? 0 : kBlockRow ? 1 : warps); ++w) {
    if (kBlockRow || warp == w) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (j * row_threads + t) * VEC;
        if (c < hidden) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float gs = ag[j][i], bs = ab[j][i];
            if (!kBlockRow && w > 0) {
              gs = colsum[c + i] + gs;
              bs = colsum[hidden + c + i] + bs;
            }
            if (kBlockRow || w == warps - 1) {
              out[c + i] = gs;
              out[hidden + c + i] = bs;
            } else {
              colsum[c + i] = gs;
              colsum[hidden + c + i] = bs;
            }
          }
        }
      }
    }
    if (!kBlockRow) __syncthreads();
  }
}

#define APEX_LN_BWD_PARAMS                                                 \
  const T *__restrict__ x, const Y *__restrict__ dy,                       \
      const T *__restrict__ ds, const float *__restrict__ mean,            \
      const float *__restrict__ rsigma, const W *__restrict__ gamma,       \
      T *__restrict__ dx, T *__restrict__ dd, float *__restrict__ part,    \
      int rows, int hidden, Dropout drop

// blocks a multiprocessor the warp route keeps in flight (ops/layer_norm.py
// _LN_BWD_BLOCKS_PER_SM), its registers capped to fit them: three for a
// 2-byte x (at most 170 registers a thread), two for fp32, whose row
// words take twice the registers
template <typename T>
constexpr int ln_bwd_blocks_per_sm() {
  return sizeof(T) == 2 ? 3 : 2;
}

template <typename T, typename W, typename Y, int NV, bool kAffine>
__global__ void __launch_bounds__(kLnWarpRowThreads,
                                  ln_bwd_blocks_per_sm<T>())
    ln_bwd_warp_kernel(APEX_LN_BWD_PARAMS) {
  ln_bwd_row<T, W, Y, NV, false, kAffine>(x, dy, ds, mean, rsigma, gamma,
                                          dx, dd, part, rows, hidden, drop);
}

template <typename T, typename W, typename Y, int NV, bool kAffine>
__global__ void __launch_bounds__(kLnMaxRowWarps * 32)
    ln_bwd_block_kernel(APEX_LN_BWD_PARAMS) {
  ln_bwd_row<T, W, Y, NV, true, kAffine>(x, dy, ds, mean, rsigma, gamma,
                                         dx, dd, part, rows, hidden, drop);
}
#undef APEX_LN_BWD_PARAMS

// dgamma/dbeta = the column sums of the (parts, 2, hidden) partials. An
// (8, 128) block: 8 columns, 128 slices of the partial rows (slice y adds
// rows y, y + 128, ... in order, four loads in flight), then the slices
// added in a fixed order, 8 at a time and those 16 sums in turn. Blocks of
// 8 columns put the reduction on hidden / 8 multiprocessors.
constexpr int kReduceCols = 8;
constexpr int kReduceSlices = 128;

template <typename W>
__global__ void __launch_bounds__(kReduceCols * kReduceSlices)
    ln_bwd_reduce_kernel(const float* __restrict__ part, int parts,
                         int hidden, W* __restrict__ dgamma,
                         W* __restrict__ dbeta) {
  __shared__ float red[2][kReduceSlices][kReduceCols + 1];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  const int y = threadIdx.y;
  float g = 0.f, b = 0.f;
  if (c < hidden) {
    const int64_t stride = static_cast<int64_t>(kReduceSlices) * 2 * hidden;
    const float* p = part + static_cast<int64_t>(y) * 2 * hidden + c;
    int k = y;
    for (; k + 3 * kReduceSlices < parts;
         k += 4 * kReduceSlices, p += 4 * stride) {
      float pg[4], pb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        pg[u] = p[u * stride];
        pb[u] = p[u * stride + hidden];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        g += pg[u];
        b += pb[u];
      }
    }
    for (; k < parts; k += kReduceSlices, p += stride) {
      g += p[0];
      b += p[hidden];
    }
  }
  red[0][y][threadIdx.x] = g;
  red[1][y][threadIdx.x] = b;
  __syncthreads();
  constexpr int kGroups = kReduceSlices / 8;
  if (y < kGroups) {
    g = b = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      g += red[0][8 * y + i][threadIdx.x];
      b += red[1][8 * y + i][threadIdx.x];
    }
  }
  __syncthreads();
  if (y < kGroups) {
    red[0][y][threadIdx.x] = g;
    red[1][y][threadIdx.x] = b;
  }
  __syncthreads();
  if (y == 0 && c < hidden) {
    g = b = 0.f;
    for (int i = 0; i < kGroups; ++i) {
      g += red[0][i][threadIdx.x];
      b += red[1][i][threadIdx.x];
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
  int row_warps, vectors, grid;  // the plan's layout; row_warps 0: old form
  cudaStream_t stream;

  // a null gamma: the non-affine form, instantiated for W == T only (the
  // host passes x's dtype code for the absent weight)
  template <typename T, typename W, typename Y>
  int run() {
    if (gamma != nullptr) return run_form<T, W, Y, true>();
    if constexpr (std::is_same<T, W>::value) {
      return run_form<T, W, Y, false>();
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }

  template <typename T, typename W, typename Y, bool kAffine>
  int run_form() {
    int parts = grid;
    if (row_warps == 0) {
      parts = (rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
      if (grid != parts) return static_cast<int>(cudaErrorInvalidValue);
      const size_t smem = kAffine ? sizeof(float) * kBwdWarps * 2 * hidden
                                  : 0;
      auto kernel = ln_bwd_kernel<T, W, Y, kAffine>;
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      kernel<<<parts, kBwdWarps * 32, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const Y*>(dy),
          static_cast<const T*>(ds), static_cast<const float*>(mean),
          static_cast<const float*>(rsigma), static_cast<const W*>(gamma),
          static_cast<T*>(dx), static_cast<T*>(dd),
          static_cast<float*>(part), rows, hidden, drop);
    } else {
      // the register row takes what its plan checked: 16-byte aligned
      // addresses, whole vectors, every vector of the row held
      constexpr int kVec = 16 / static_cast<int>(sizeof(T));
      const uintptr_t bits =
          reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
          reinterpret_cast<uintptr_t>(ds) |
          reinterpret_cast<uintptr_t>(gamma) |
          reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(dd);
      if (bits % 16 != 0 || hidden % kVec != 0 || row_warps < 1 ||
          row_warps > kLnMaxRowWarps || grid < 1 ||
          (row_warps == 1 && hidden > kLnBwdWarpHidden) ||
          static_cast<int64_t>(vectors) * 32 * row_warps * kVec < hidden)
        return static_cast<int>(cudaErrorInvalidValue);
      const int rc = launch_register<T, W, Y, 1, kAffine>();
      if (rc != 0) return rc;
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    if constexpr (kAffine) {
      ln_bwd_reduce_kernel<W>
          <<<(hidden + kReduceCols - 1) / kReduceCols,
             dim3(kReduceCols, kReduceSlices), 0, stream>>>(
              static_cast<const float*>(part), parts, hidden,
              static_cast<W*>(dgamma), static_cast<W*>(dbeta));
    }
    return 0;
  }

  // the instance of NV == vectors: 1, 2, 4, ... up to kLnMaxValues values
  template <typename T, typename W, typename Y, int NV, bool kAffine>
  int launch_register() {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    if constexpr (NV * kVec > kLnMaxValues) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (vectors != NV) return launch_register<T, W, Y, NV * 2, kAffine>();
      auto args = [&](auto kernel, int threads) {
        kernel<<<grid, threads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const Y*>(dy),
            static_cast<const T*>(ds), static_cast<const float*>(mean),
            static_cast<const float*>(rsigma), static_cast<const W*>(gamma),
            static_cast<T*>(dx), static_cast<T*>(dd),
            static_cast<float*>(part), rows, hidden, drop);
      };
      if (row_warps == 1)
        args(ln_bwd_warp_kernel<T, W, Y, NV, kAffine>, kLnWarpRowThreads);
      else
        args(ln_bwd_block_kernel<T, W, Y, NV, kAffine>, 32 * row_warps);
      return 0;
    }
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
// gamma: (hidden,) in w_dtype, or null for the non-affine form (w_dtype
// then x_dtype; part, dgamma and dbeta null). Writes dx (x_dtype), dd
// (x_dtype, only with dropout; else null), dgamma/dbeta ((hidden,) in
// w_dtype) through `part`, an fp32 scratch of grid * 2 * hidden. row_warps/vectors/grid:
// `ln_bwd_plan`'s layout (row_warps 0: the old form, grid ceil(rows /
// 32); 1: a warp a row, four a block; more: a block of that many warps
// a row; `vectors` 16-byte vectors of x a thread, `grid` blocks).
extern "C" int ln_bwd(const void* x, const void* dy, const void* ds,
                      const void* mean, const void* rsigma,
                      const void* gamma, void* dx, void* dd, void* part,
                      void* dgamma, void* dbeta, int rows, int hidden,
                      int dropout, unsigned seed, unsigned thr,
                      float keep_scale, int x_dtype, int w_dtype,
                      int y_dtype, int row_warps, int vectors, int grid,
                      void* stream) {
  using namespace apex_port;
  BwdLaunch l{x,     dy,     ds,
              mean,  rsigma, gamma,
              dx,    dd,     part,
              dgamma, dbeta, rows,
              hidden, Dropout{dropout, seed, thr, keep_scale},
              row_warps, vectors, grid,
              static_cast<cudaStream_t>(stream)};
  const int rc = dispatch3(x_dtype, w_dtype, y_dtype, l);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
