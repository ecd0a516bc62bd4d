// Scaled softmax over the last axis of materialized attention scores, for
// Hopper (sm_90a): the causal and the padding-masked forward, and the
// softmax backward of both.
//
// Replaces rocm_apex_tpu/ops/softmax.py:46 `_causal_fwd_kernel`
//   y = softmax(scale * x), column > row set to -inf (row = the query's
//   index in its (sq, sk) matrix), so those columns are exactly 0;
// :139 `_masked_fwd_kernel`
//   y = softmax(where(mask, -10000, scale * x)), the bool mask (True =
//   masked) broadcast over heads, so a fully masked row is uniform;
// and :62 `_softmax_bwd_kernel`
//   dx = scale * y * (dy - sum_row(y * dy)), from the forward's y.
// All math is fp32 whatever the storage dtype (fp32, bf16 or fp16); each
// output is rounded once to its input's dtype.
//
// Bound: bytes (one exp and a few FLOPs an element). Every reduction runs
// in a fixed order (a thread's columns in order, a butterfly within the
// warp, then the warps in index order): no atomics, so a run reproduces
// bit for bit.
//
// Both forwards' rows of up to kWarpRowMax keys take the register row
// (`softmax_reg_kernel`, the route ops/softmax.py `softmax_fwd_plan`
// names): a warp a row, each lane holding its columns, NV vectors of VEC,
// in registers. x is read once (16-byte evict-first loads where the
// row's bytes are a multiple of 16 at aligned bases, else a scalar a
// column), the mask beside it (VEC bytes a vector where its last stride
// is 1 and its rows are aligned, else a byte a column through its
// strides); then the row's max, one exp an element kept in registers,
// the row's sum, and y = e * (1 / sum), one evict-first store a vector
// (a division a lane, not an element). The causal form (kCausal) loads
// no vector that lies wholly right of the diagonal and stores zeros
// there; the vector that straddles it is masked by element to -inf, so
// its right part is exactly 0. Longer rows take the streaming form: one
// block of 8 warps a row; the row is never held whole: pass 1 keeps a
// running (max, sum exp) per lane and merges them over the row's
// threads; pass 2 reads the row again and writes y. The second read
// comes from L2 (a row is at most 64 KB at 16K fp32 keys, the rows in
// flight a few MB against the 50 MB L2), so device memory sees each
// input byte once and each output byte once. The causal form reads only
// the columns at or left of the diagonal and stores zeros right of it,
// which is what exp(-inf) gives.
// The backward reads y and dy twice the same way (their row sum, then
// dx). Rows whose byte length is a multiple of 16, at 16-byte-aligned
// bases, take 16-byte loads and stores; any other row the scalar form of
// the same code.
#include <math.h>

#include "common.cuh"

namespace apex_port {

constexpr int kSoftmaxThreads = 256;
constexpr int kSoftmaxWarps = kSoftmaxThreads / 32;
// rows up to this many keys take one warp each (at most 64 values a
// lane a pass), longer rows a whole block
constexpr int kWarpRowMax = 2048;
// the padding-masked form's fill, applied after scaling (ops/softmax.py
// MASK_FILL)
constexpr float kMaskFill = -10000.f;

// (m, s) <- the merge of two running softmax states, m the max and s the
// sum of exp(x - m); (-inf, 0) is the empty state. Symmetric in its two
// states, so both lanes of a butterfly step get the same result.
__device__ __forceinline__ void merge_state(float& m, float& s, float m2,
                                            float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// The row's (m, s) on every thread of the row: the warp's butterfly, then
// for a block-wide row the warps in index order through shared memory.
template <int kRowWarps>
__device__ __forceinline__ void row_merge(float& m, float& s,
                                          float (*red)[kSoftmaxWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFullMask, m, o);
    const float s2 = __shfl_xor_sync(kFullMask, s, o);
    merge_state(m, s, m2, s2);
  }
  if constexpr (kRowWarps > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = m;
      red[1][warp] = s;
    }
    __syncthreads();
    m = red[0][0];
    s = red[1][0];
    for (int w = 1; w < kRowWarps; ++w) merge_state(m, s, red[0][w], red[1][w]);
  }
}

// The row's sum on every thread of the row, in the same fixed order.
template <int kRowWarps>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (kRowWarps > 1) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    v = red[0];
    for (int w = 1; w < kRowWarps; ++w) v += red[w];
  }
  return v;
}

// One (sq, sk) row of `rows` a row group of kRowWarps warps. kMasked
// selects the padding-masked form (mask may be null: nothing masked),
// else the causal form.
template <typename T, int VEC, int kRowWarps, bool kMasked>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const uint8_t* __restrict__ mask, int64_t rows,
                       int heads, int sq, int sk, int64_t mask_sb,
                       int64_t mask_sq, int64_t mask_sk, float scale) {
  constexpr int kRowThreads = kRowWarps * 32;
  constexpr int kRowsPerBlock = kSoftmaxWarps / kRowWarps;
  __shared__ float red[2][kSoftmaxWarps];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      threadIdx.x / kRowThreads;
  // a whole row group leaves together (a block-wide row never does: the
  // grid has one block a row)
  if (row >= rows) return;
  const int t = threadIdx.x % kRowThreads;
  const int qi = static_cast<int>(row % sq);
  // the columns that can carry probability: all of them, or those at or
  // left of the diagonal
  const int limit = kMasked ? sk : min(qi + 1, sk);
  const uint8_t* mrow = nullptr;
  if (kMasked && mask != nullptr) {
    mrow = mask + (row / (static_cast<int64_t>(heads) * sq)) * mask_sb +
           qi * mask_sq;
  }
  const T* xr = x + row * sk;
  T* yr = y + row * sk;

  // pass 1: per-lane running (max, sum exp) over the live columns
  float m = -INFINITY, s = 0.f;
  for (int c = t * VEC; c < limit; c += kRowThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + c, v);
    float cm = -INFINITY;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      v[i] *= scale;
      if (mrow != nullptr && mrow[(c + i) * mask_sk]) v[i] = kMaskFill;
      if (c + i < limit) cm = fmaxf(cm, v[i]);
    }
    if (cm > m) {
      s *= expf(m - cm);
      m = cm;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (c + i < limit) s += expf(v[i] - m);
    }
  }
  row_merge<kRowWarps>(m, s, red);

  // pass 2: y = exp(v - max) / sum on the live columns, 0 past them
  for (int c = t * VEC; c < sk; c += kRowThreads * VEC) {
    float v[VEC];
    if (c < limit) {
      load_vec<T, VEC>(xr + c, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float u = v[i] * scale;
        if (mrow != nullptr && mrow[(c + i) * mask_sk]) u = kMaskFill;
        v[i] = c + i < limit ? expf(u - m) / s : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
    store_vec_packed<T, VEC>(yr + c, v);
  }
}

// The register row of both forwards: a warp a row, 8 rows a block. Lane
// l holds the vectors j * 32 + l, j < NV, that start inside the row (the
// causal form: those that start at or left of the diagonal, the others
// stored as zeros). kVecMask reads the mask's VEC bytes beside each
// vector (its last stride 1, its rows VEC-byte aligned); else a byte a
// column through mask_sk. mask may be null (nothing masked); the causal
// form takes none.
template <typename T, int VEC, int NV, bool kVecMask, bool kCausal>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_reg_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const uint8_t* __restrict__ mask, int64_t rows,
                       int heads, int sq, int sk, int64_t mask_sb,
                       int64_t mask_sq, int64_t mask_sk, float scale) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kSoftmaxWarps +
                      (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  const uint8_t* mrow = nullptr;
  int limit = sk;  // the columns that can carry probability
  if (kCausal || mask != nullptr) {
    // the row's batch and query, in 32-bit division where the rows allow
    // (a 64-bit one costs a lane more than its 16 columns' arithmetic)
    int64_t bi;
    int qi;
    if (rows <= 0x7fffffff) {
      const uint32_t bh = static_cast<uint32_t>(row) / sq;
      qi = static_cast<int>(static_cast<uint32_t>(row) - bh * sq);
      bi = kCausal ? 0 : bh / heads;
    } else {
      qi = static_cast<int>(row % sq);
      bi = kCausal ? 0 : row / (static_cast<int64_t>(heads) * sq);
    }
    if constexpr (kCausal)
      limit = min(qi + 1, sk);
    else
      mrow = mask + bi * mask_sb + qi * mask_sq;
  }
  const T* xr = x + row * sk;
  T* yr = y + row * sk;

  // every load first: x, and the mask's bytes beside it (kept as the
  // loaded words, a byte a column)
  using MaskWord = typename std::conditional<
      kVecMask, typename std::conditional<VEC == 8, uint2, uint32_t>::type,
      uint8_t[VEC]>::type;
  float v[NV][VEC];
  MaskWord mw[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * VEC;
    if (c < limit) {
      load_vec_once<T, VEC>(xr + c, v[j]);
      if (mrow != nullptr) {
        if constexpr (kVecMask) {
          mw[j] = *reinterpret_cast<const MaskWord*>(mrow + c);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) mw[j][i] = mrow[(c + i) * mask_sk];
        }
      }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * VEC;
    if (c < limit) {
      const uint8_t* mk = reinterpret_cast<const uint8_t*>(&mw[j]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float u = v[j][i] * scale;
        if (mrow != nullptr && mk[i]) u = kMaskFill;
        // the causal form's straddling vector: -inf right of the diagonal
        if (kCausal && c + i >= limit) u = -INFINITY;
        v[j][i] = u;
        m = fmaxf(m, u);
      }
    }
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((j * 32 + lane) * VEC < limit) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        v[j][i] = expf(v[j][i] - m);
        s += v[j][i];
      }
    }
  }
  // y = e * (1 / sum): one division a lane; a fully masked row's e are
  // all 1, so its y is 1 / sk, as e / sum gives
  const float inv = 1.f / warp_sum(s);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * VEC;
    if (c < sk) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][i] = c < limit ? v[j][i] * inv : 0.f;
      store_vec_once<T, VEC>(yr + c, v[j]);
    }
  }
}

// dx = scale * y * (dy - sum_row(y * dy)), one row a row group.
template <typename T, int VEC, int kRowWarps>
__global__ void __launch_bounds__(kSoftmaxThreads)
    softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                       T* __restrict__ dx, int64_t rows, int sk,
                       float scale) {
  constexpr int kRowThreads = kRowWarps * 32;
  constexpr int kRowsPerBlock = kSoftmaxWarps / kRowWarps;
  __shared__ float red[kSoftmaxWarps];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      threadIdx.x / kRowThreads;
  if (row >= rows) return;
  const int t = threadIdx.x % kRowThreads;
  const int64_t off = row * sk;

  float acc = 0.f;
  for (int c = t * VEC; c < sk; c += kRowThreads * VEC) {
    float a[VEC], b[VEC];
    load_vec<T, VEC>(y + off + c, a);
    load_vec<T, VEC>(dy + off + c, b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc += a[i] * b[i];
  }
  acc = row_sum<kRowWarps>(acc, red);

  for (int c = t * VEC; c < sk; c += kRowThreads * VEC) {
    float a[VEC], b[VEC];
    load_vec<T, VEC>(y + off + c, a);
    load_vec<T, VEC>(dy + off + c, b);
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[i] = scale * a[i] * (b[i] - acc);
    store_vec_packed<T, VEC>(dx + off + c, a);
  }
}

template <typename T>
constexpr int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

// blocks for `rows` rows of sk keys: 8 rows a block, or one
static int64_t grid_of(int64_t rows, int sk) {
  return sk <= kWarpRowMax ? (rows + kSoftmaxWarps - 1) / kSoftmaxWarps
                           : rows;
}

// The streaming forward, a block a row: both forms' rows over
// kWarpRowMax keys.
template <typename T, bool kMasked>
static int launch_fwd(const void* x, const void* mask, void* y, int64_t rows,
                      int heads, int sq, int sk, int64_t mask_sb,
                      int64_t mask_sq, int64_t mask_sk, float scale,
                      cudaStream_t stream) {
  constexpr int kVec = vec_of<T>();
  const bool aligned = sk % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (sk <= kWarpRowMax || rows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = aligned ? softmax_fwd_kernel<T, kVec, kSoftmaxWarps, kMasked>
                        : softmax_fwd_kernel<T, 1, kSoftmaxWarps, kMasked>;
  kernel<<<static_cast<unsigned>(rows), kSoftmaxThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const uint8_t*>(mask), rows, heads, sq, sk, mask_sb,
      mask_sq, mask_sk, scale);
  return 0;
}

struct MaskedArgs {
  const void* x;
  const void* mask;
  void* y;
  int64_t rows;
  int heads, sq, sk;
  int64_t mask_sb, mask_sq, mask_sk;
  float scale;
  cudaStream_t stream;
};

// The register row's instance of NV == vectors: 1, 2, 4, ... up to
// kWarpRowMax / 32 values a lane.
template <typename T, int VEC, bool kVecMask, bool kCausal, int NV = 1>
static int launch_reg(const MaskedArgs& a, int vectors) {
  if constexpr (NV * VEC * 32 > kWarpRowMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (vectors != NV)
      return launch_reg<T, VEC, kVecMask, kCausal, NV * 2>(a, vectors);
    const int64_t blocks = (a.rows + kSoftmaxWarps - 1) / kSoftmaxWarps;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    softmax_reg_kernel<T, VEC, NV, kVecMask, kCausal>
        <<<static_cast<unsigned>(blocks), kSoftmaxThreads, 0, a.stream>>>(
            static_cast<const T*>(a.x), static_cast<T*>(a.y),
            static_cast<const uint8_t*>(a.mask), a.rows, a.heads, a.sq, a.sk,
            a.mask_sb, a.mask_sq, a.mask_sk, a.scale);
    return 0;
  }
}

// Either forward on `softmax_fwd_plan`'s route: vectors 0 streams (rows
// over kWarpRowMax keys), else the register row of `vectors` vectors of
// `vec` a lane, with the mask read as vectors where `vec_mask`. The
// plan's vec, vectors and mask form are checked against the addresses and
// strides here: a plan that does not fit raises.
template <typename T, bool kCausal>
static int launch_planned(const MaskedArgs& a, int vec, int vectors,
                          int vec_mask) {
  constexpr int kVec = vec_of<T>();
  const bool aligned = a.sk % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  if (vec != (aligned ? kVec : 1) || (kCausal && a.mask != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vectors == 0) {
    if (vec_mask) return static_cast<int>(cudaErrorInvalidValue);
    return launch_fwd<T, !kCausal>(a.x, a.mask, a.y, a.rows, a.heads, a.sq,
                                   a.sk, a.mask_sb, a.mask_sq, a.mask_sk,
                                   a.scale, a.stream);
  }
  if (a.sk > kWarpRowMax || static_cast<int64_t>(vectors) * 32 * vec < a.sk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!vec_mask) {
    return vec == 1 ? launch_reg<T, 1, false, kCausal>(a, vectors)
                    : launch_reg<T, kVec, false, kCausal>(a, vectors);
  }
  const int64_t mbits = static_cast<int64_t>(
                            reinterpret_cast<uintptr_t>(a.mask)) |
                        a.mask_sb | a.mask_sq;
  if (kCausal || vec == 1 || a.mask == nullptr || a.mask_sk != 1 ||
      mbits % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_reg<T, kVec, true, false>(a, vectors);
}

template <typename T>
static int launch_bwd(const void* y, const void* dy, void* dx, int64_t rows,
                      int sk, float scale, cudaStream_t stream) {
  constexpr int kVec = vec_of<T>();
  const bool aligned = sk % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int64_t blocks = grid_of(rows, sk);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sk <= kWarpRowMax
                    ? (aligned ? softmax_bwd_kernel<T, kVec, 1>
                               : softmax_bwd_kernel<T, 1, 1>)
                    : (aligned ? softmax_bwd_kernel<T, kVec, kSoftmaxWarps>
                               : softmax_bwd_kernel<T, 1, kSoftmaxWarps>);
  kernel<<<static_cast<unsigned>(blocks), kSoftmaxThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy),
      static_cast<T*>(dx), rows, sk, scale);
  return 0;
}

template <bool kCausal>
static int dispatch_fwd(const MaskedArgs& a, int vec, int vectors,
                        int vec_mask, int dtype) {
  int rc;
  if (dtype == kFloat32) {
    rc = launch_planned<float, kCausal>(a, vec, vectors, vec_mask);
  } else if (dtype == kBFloat16) {
    rc = launch_planned<__nv_bfloat16, kCausal>(a, vec, vectors, vec_mask);
  } else if (dtype == kFloat16) {
    rc = launch_planned<__half, kCausal>(a, vec, vectors, vec_mask);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace apex_port

// x, y: (rows, sk) contiguous in `dtype`, rows = b * sq of a (b, sq, sk)
// input; the query index of a row is row % sq. vec, vectors: the route of
// `softmax_fwd_plan` (vectors 0: streaming).
extern "C" int softmax_causal_fwd(const void* x, void* y, long long rows,
                                  int sq, int sk, float scale, int vec,
                                  int vectors, int dtype, void* stream) {
  using namespace apex_port;
  const MaskedArgs a{x,  nullptr, y, rows,  1,
                     sq, sk,      0, 0,     0,
                     scale, static_cast<cudaStream_t>(stream)};
  return dispatch_fwd<true>(a, vec, vectors, 0, dtype);
}

// x, y: (rows, sk) contiguous in `dtype`, rows = b * heads * sq of a (b,
// heads, sq, sk) input. mask: bytes (nonzero = masked) of a (b, 1, sq, sk)
// view with element strides mask_sb, mask_sq, mask_sk (0 on a broadcast
// axis), or null (nothing masked). vec, vectors, vec_mask: the route of
// `softmax_fwd_plan` (vectors 0: streaming).
extern "C" int softmax_masked_fwd(const void* x, const void* mask, void* y,
                                  long long rows, int heads, int sq, int sk,
                                  long long mask_sb, long long mask_sq,
                                  long long mask_sk, float scale, int vec,
                                  int vectors, int vec_mask, int dtype,
                                  void* stream) {
  using namespace apex_port;
  const MaskedArgs a{x,  mask,    y,       rows,    heads,
                     sq, sk,      mask_sb, mask_sq, mask_sk,
                     scale, static_cast<cudaStream_t>(stream)};
  return dispatch_fwd<false>(a, vec, vectors, vec_mask, dtype);
}

// y, dy, dx: (rows, sk) contiguous in `dtype`.
extern "C" int softmax_bwd(const void* y, const void* dy, void* dx,
                           long long rows, int sk, float scale, int dtype,
                           void* stream) {
  using namespace apex_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kFloat32) {
    rc = launch_bwd<float>(y, dy, dx, rows, sk, scale, s);
  } else if (dtype == kBFloat16) {
    rc = launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, s);
  } else if (dtype == kFloat16) {
    rc = launch_bwd<__half>(y, dy, dx, rows, sk, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}
