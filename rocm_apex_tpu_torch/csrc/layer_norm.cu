// Row LayerNorm forward, plain or with the fused residual add, for
// Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/layer_norm.py:78 `_ln_fwd_kernel` (forward,
// no dropout). Per row of a (rows, hidden) view: s = x (+ delta), in
// fp32; y = (s - mean) * rsqrt(var + eps) (* gamma + beta), with the
// two-pass mean-then-centred-variance statistics of the TPU kernel. The
// residual form also writes s in the stream dtype; the statistics use the
// fp32 sum, not the rounded s, as the TPU kernel does. mean and rsigma
// are written for the backward of the training slice.
//
// Bound: bytes (a handful of FLOPs per element). One warp per row; the
// 32 lanes stride over the row so every pass is a coalesced warp load.
// The second and third passes re-read the row, which at hidden 1024 is
// 2-4 KB and still in L1, so device memory sees each input once.
#include "common.cuh"

namespace apex_port {

template <typename T>
__device__ __forceinline__ float row_value(const T* __restrict__ x,
                                           const T* __restrict__ d, int c) {
  float v = to_float(x[c]);
  if (d != nullptr) v += to_float(d[c]);
  return v;
}

template <typename T, typename W, typename Y>
__global__ void __launch_bounds__(128)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ delta,
                  const W* __restrict__ gamma, const W* __restrict__ beta,
                  Y* __restrict__ y, T* __restrict__ s,
                  float* __restrict__ mean, float* __restrict__ rsigma,
                  int rows, int hidden, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform per warp
  const int64_t off = static_cast<int64_t>(row) * hidden;
  const T* xr = x + off;
  const T* dr = delta != nullptr ? delta + off : nullptr;

  float sum = 0.f;
  for (int c = lane; c < hidden; c += 32) {
    const float v = row_value(xr, dr, c);
    if (s != nullptr) s[off + c] = from_float<T>(v);
    sum += v;
  }
  const float mu = warp_sum(sum) / hidden;

  float sq = 0.f;
  for (int c = lane; c < hidden; c += 32) {
    const float t = row_value(xr, dr, c) - mu;
    sq = fmaf(t, t, sq);
  }
  const float rs = rsqrtf(warp_sum(sq) / hidden + eps);

  Y* yr = y + off;
  for (int c = lane; c < hidden; c += 32) {
    float o = (row_value(xr, dr, c) - mu) * rs;
    if (gamma != nullptr) o = o * to_float(gamma[c]) + to_float(beta[c]);
    yr[c] = from_float<Y>(o);
  }
  if (lane == 0) {
    mean[row] = mu;
    rsigma[row] = rs;
  }
}

template <typename T, typename W, typename Y>
static int launch(const void* x, const void* delta, const void* gamma,
                  const void* beta, void* y, void* s, void* mean,
                  void* rsigma, int rows, int hidden, float eps,
                  cudaStream_t stream) {
  const int threads = 128;  // four rows per block
  const int blocks = (rows * 32 + threads - 1) / threads;
  ln_fwd_kernel<T, W, Y><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta),
      static_cast<const W*>(gamma), static_cast<const W*>(beta),
      static_cast<Y*>(y), static_cast<T*>(s), static_cast<float*>(mean),
      static_cast<float*>(rsigma), rows, hidden, eps);
  return 0;
}

template <typename T, typename W>
static int dispatch_y(int y_dtype, const void* x, const void* delta,
                      const void* gamma, const void* beta, void* y, void* s,
                      void* mean, void* rsigma, int rows, int hidden,
                      float eps, cudaStream_t stream) {
  if (y_dtype == kFloat32)
    return launch<T, W, float>(x, delta, gamma, beta, y, s, mean, rsigma,
                               rows, hidden, eps, stream);
  if (y_dtype == kBFloat16)
    return launch<T, W, __nv_bfloat16>(x, delta, gamma, beta, y, s, mean,
                                       rsigma, rows, hidden, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int dispatch_w(int w_dtype, int y_dtype, const void* x,
                      const void* delta, const void* gamma, const void* beta,
                      void* y, void* s, void* mean, void* rsigma, int rows,
                      int hidden, float eps, cudaStream_t stream) {
  if (w_dtype == kFloat32)
    return dispatch_y<T, float>(y_dtype, x, delta, gamma, beta, y, s, mean,
                                rsigma, rows, hidden, eps, stream);
  if (w_dtype == kBFloat16)
    return dispatch_y<T, __nv_bfloat16>(y_dtype, x, delta, gamma, beta, y, s,
                                        mean, rsigma, rows, hidden, eps,
                                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace apex_port

// x (and delta, s): (rows, hidden) contiguous in x_dtype; gamma/beta:
// (hidden,) in w_dtype or both null (no affine); delta and s both null
// for the plain form; y: (rows, hidden) in y_dtype; mean/rsigma: (rows,)
// fp32.
extern "C" int ln_fwd(const void* x, const void* delta, const void* gamma,
                      const void* beta, void* y, void* s, void* mean,
                      void* rsigma, int rows, int hidden, float eps,
                      int x_dtype, int w_dtype, int y_dtype, void* stream) {
  using namespace apex_port;
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_dtype == kFloat32)
    rc = dispatch_w<float>(w_dtype, y_dtype, x, delta, gamma, beta, y, s,
                           mean, rsigma, rows, hidden, eps, st);
  else if (x_dtype == kBFloat16)
    rc = dispatch_w<__nv_bfloat16>(w_dtype, y_dtype, x, delta, gamma, beta, y,
                                   s, mean, rsigma, rows, hidden, eps, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
