// Label-smoothed softmax cross-entropy over materialized logits, for
// Hopper (sm_90a): two forward forms and the two-pass backward.
//
// Replaces rocm_apex_tpu/ops/xentropy.py:155 `_fwd_dg_kernel` (the
// differentiated forward: per-row loss and dg = softmax - target in the
// logits dtype), :53 `_fwd_kernel` (the plain forward: loss and lse) and
// :61 `_bwd_kernel` (the backward of that plain forward, from the logits
// and its lse). Per row of a (rows, vocab) view with label y and
// smoothing eps:
//   lse  = max + log(sum exp(x - max))
//   loss = lse - (1 - eps) * x[y] - (eps / vocab) * sum(x)
//   dg_j = exp(x_j - max) / sum - ((1 - eps) * [j == y] + eps / vocab)
//   dx_j = dl * (exp(x_j - lse) - ((1 - eps) * [j == y] + eps / vocab))
// all in fp32 whatever the storage dtype. A label outside [0, vocab)
// selects no column, as the TPU kernel's `col == label` does. Rows whose
// label equals padding_idx are zeroed by the caller, outside the kernel
// (dl = 0 there for the backward).
//
// Bound: bytes (one exp and a handful of FLOPs per element). One block per
// row. The vocabulary (30592 on the BERT path) does not fit registers, so
// the forward reads the row twice: pass 1 keeps a running (max, sum exp,
// sum x) per thread and merges them across the block; pass 2, only when dg
// is asked, re-reads the row (61 KB in bf16: it is still in L2, so device
// memory sees it once) and writes dg with 16-byte stores. The backward
// needs no reduction: it reads the row once and writes dx once. Every
// reduction runs in a fixed order (thread-strided partials, warp shuffles,
// then the warps in index order): no atomics, so a run reproduces bit for
// bit. Rows whose byte length is a multiple of 16 take 16-byte loads; any
// other vocab takes the scalar form of the same code.
#include "common.cuh"

namespace apex_port {

constexpr int kXentThreads = 256;
constexpr int kXentWarps = kXentThreads / 32;

// (m, s) <- merge of two running softmax states: max m, s = sum exp(x - m)
__device__ __forceinline__ void merge_max_sum(float& m, float& s, float m2,
                                              float s2) {
  const float mn = fmaxf(m, m2);
  s = s * __expf(m - mn) + s2 * __expf(m2 - mn);
  m = mn;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kXentThreads)
    xent_fwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse_out,
                    T* __restrict__ dg, int vocab, float smoothing) {
  __shared__ float red[3][kXentWarps];
  __shared__ float row_stats[2];  // max, sum exp
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* xr = x + static_cast<int64_t>(row) * vocab;

  // pass 1: per-thread running max / sum exp / sum x over strided vectors
  float m = kNegInf, s = 0.f, sx = 0.f;
  for (int c = tid * VEC; c < vocab; c += kXentThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + c, v);
    float cm = v[0];
#pragma unroll
    for (int i = 1; i < VEC; ++i) cm = fmaxf(cm, v[i]);
    if (cm > m) {
      s *= __expf(m - cm);
      m = cm;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s += __expf(v[i] - m);
      sx += v[i];
    }
  }
  // the warp, in a fixed butterfly order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFullMask, m, o);
    const float s2 = __shfl_xor_sync(kFullMask, s, o);
    merge_max_sum(m, s, m2, s2);
    sx += __shfl_xor_sync(kFullMask, sx, o);
  }
  if (lane == 0) {
    red[0][warp] = m;
    red[1][warp] = s;
    red[2][warp] = sx;
  }
  __syncthreads();
  if (tid == 0) {
    float bm = red[0][0], bs = red[1][0], bx = red[2][0];
    for (int w = 1; w < kXentWarps; ++w) {
      merge_max_sum(bm, bs, red[0][w], red[1][w]);
      bx += red[2][w];
    }
    const float lse = bm + logf(bs);
    const int64_t y = labels[row];
    const float xt = (y >= 0 && y < vocab) ? to_float(xr[y]) : 0.f;
    float l = lse - (1.f - smoothing) * xt;
    if (smoothing > 0.f) l -= (smoothing / vocab) * bx;
    loss[row] = l;
    if (lse_out != nullptr) lse_out[row] = lse;
    row_stats[0] = bm;
    row_stats[1] = bs;
  }
  if (dg == nullptr) return;
  __syncthreads();

  // pass 2: dg = exp(x - max) / sum - target, in the logits dtype
  const float bm = row_stats[0];
  const float inv = 1.f / row_stats[1];
  const float base = smoothing / vocab;
  const int64_t y = labels[row];
  T* dr = dg + static_cast<int64_t>(row) * vocab;
  for (int c = tid * VEC; c < vocab; c += kXentThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float target = (c + i == y ? 1.f - smoothing : 0.f) + base;
      v[i] = __expf(v[i] - bm) * inv - target;
    }
    store_vec_packed<T, VEC>(dr + c, v);
  }
}

// dx = dl * (exp(x - lse) - target) for one row a block, in x's dtype.
template <typename T, int VEC>
__global__ void __launch_bounds__(kXentThreads)
    xent_bwd_kernel(const T* __restrict__ x, const int64_t* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ dl, T* __restrict__ dx,
                    int vocab, float smoothing) {
  const int row = blockIdx.x;
  const int64_t off = static_cast<int64_t>(row) * vocab;
  const float l = lse[row];
  const float g = dl[row];
  const float base = smoothing / vocab;
  const int64_t y = labels[row];
  for (int c = threadIdx.x * VEC; c < vocab; c += kXentThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(x + off + c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float target = (c + i == y ? 1.f - smoothing : 0.f) + base;
      v[i] = g * (expf(v[i] - l) - target);
    }
    store_vec_packed<T, VEC>(dx + off + c, v);
  }
}

template <typename T>
static int launch_xent_bwd(const void* x, const void* labels, const void* lse,
                           const void* dl, void* dx, int rows, int vocab,
                           float smoothing, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool aligned = vocab % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  auto kernel = aligned ? xent_bwd_kernel<T, kVec> : xent_bwd_kernel<T, 1>;
  kernel<<<rows, kXentThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(dl),
      static_cast<T*>(dx), vocab, smoothing);
  return 0;
}

template <typename T>
static int launch_xent(const void* x, const void* labels, void* loss,
                       void* lse, void* dg, int rows, int vocab,
                       float smoothing, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const bool aligned =
      vocab % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dg) % 16 == 0;
  auto kernel = aligned ? xent_fwd_kernel<T, kVec> : xent_fwd_kernel<T, 1>;
  kernel<<<rows, kXentThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int64_t*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse),
      static_cast<T*>(dg), vocab, smoothing);
  return 0;
}

}  // namespace apex_port

// x: (rows, vocab) contiguous in x_dtype; labels: (rows,) int64; loss:
// (rows,) fp32. lse: (rows,) fp32 or null; dg: (rows, vocab) in x_dtype or
// null (the plain forward passes lse and no dg, the differentiated one dg
// and no lse).
extern "C" int xent_fwd(const void* x, const void* labels, void* loss,
                        void* lse, void* dg, int rows, int vocab,
                        float smoothing, int x_dtype, void* stream) {
  using namespace apex_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32) {
    launch_xent<float>(x, labels, loss, lse, dg, rows, vocab, smoothing, s);
  } else if (x_dtype == kBFloat16) {
    launch_xent<__nv_bfloat16>(x, labels, loss, lse, dg, rows, vocab,
                               smoothing, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, vocab) contiguous in x_dtype; labels: (rows,) int64; lse: the
// plain forward's (rows,) fp32; dl: (rows,) fp32, the loss cotangent with
// padded rows zeroed; dx: (rows, vocab) in x_dtype.
extern "C" int xent_bwd(const void* x, const void* labels, const void* lse,
                        const void* dl, void* dx, int rows, int vocab,
                        float smoothing, int x_dtype, void* stream) {
  using namespace apex_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kFloat32) {
    launch_xent_bwd<float>(x, labels, lse, dl, dx, rows, vocab, smoothing, s);
  } else if (x_dtype == kBFloat16) {
    launch_xent_bwd<__nv_bfloat16>(x, labels, lse, dl, dx, rows, vocab,
                                   smoothing, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
