// The multi-tensor passes over a packed (rows, 1024) buffer, for Hopper
// (sm_90a): one read of each input buffer, one warp a row.
//
// Replaces the TPU kernels of rocm_apex_tpu/ops/multi_tensor.py:
//   `mt_scale`        :78  _scale_kernel        out = x * s, nonfinite flag
//   `mt_scale_sumsq`  :144 _scale_sumsq_kernel  the same + fp32 row sums of
//                                               (x * s)^2
//   `mt_axpby`        :215 _axpby_kernel        out = a * x + b * y, flag
//   `mt_row_sumsq`    :290 _rowsum_sq_kernel    fp32 row sums of x^2
// The values are formed in fp32 (x * s, or x * a + y * b, each product and
// the sum rounded once, as the plain version's separate tensor ops round
// them: no fused multiply-add), probed with isfinite BEFORE the output is
// rounded to its dtype, and stored in that dtype.
//
// Bound: bytes. Each 1024-element row is one warp's: 32 lanes x 8 chunks
// of 4 consecutive elements, neighbouring lanes on neighbouring chunks,
// so every load and store instruction of the warp covers 128 contiguous
// elements (an 8-byte access a lane in bf16, 16 in fp32). A packed buffer
// has rows % 64 == 0 and a 16-byte-aligned start, so there is no tail.
// The row sum is each lane's 32 squares in a fixed order, then a fixed
// shuffle tree: the same inputs give the same bits every run.
//
// The flag: the scale and scale_sumsq buffers and the axpby output share
// one device int32 the wrapper zeroes once for all its dtype groups; a
// warp that finds a nonfinite value stores 1 into it (every writer stores
// the same value). The wrapper turns it into a device bool; the host
// never reads it.
#include "common.cuh"

namespace apex_port {

constexpr int kMtWidth = 1024;
constexpr int kMtThreads = 256;  // 8 warps: 8 rows a block
constexpr int kMtChunk = 4;      // elements a lane touches at once
constexpr int kMtChunksPerLane = kMtWidth / (32 * kMtChunk);  // 8

// kMode: 0 scale (out, flag), 1 scale + row sums, 2 axpby (out, flag),
// 3 row sums of x^2 alone
template <int kMode, typename X, typename Y, typename O>
__global__ void __launch_bounds__(kMtThreads)
    mt_row_kernel(const X* __restrict__ x, const Y* __restrict__ y,
                  const float* __restrict__ a_ptr,
                  const float* __restrict__ b_ptr, O* __restrict__ out,
                  int* __restrict__ flag, float* __restrict__ rowsq) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kMtThreads / 32) + (threadIdx.x >> 5);
  const int64_t base = row * kMtWidth;
  const float a = kMode == 3 ? 1.f : *a_ptr;
  const float b = kMode == 2 ? *b_ptr : 0.f;
  // every load of the row first (8 in flight a lane), then the
  // arithmetic and the stores
  float v[kMtChunksPerLane][kMtChunk];
#pragma unroll
  for (int j = 0; j < kMtChunksPerLane; ++j)
    load_vec<X, kMtChunk>(x + base + (j * 32 + lane) * kMtChunk, v[j]);
  if constexpr (kMode == 2) {
    float w[kMtChunksPerLane][kMtChunk];
#pragma unroll
    for (int j = 0; j < kMtChunksPerLane; ++j)
      load_vec<Y, kMtChunk>(y + base + (j * 32 + lane) * kMtChunk, w[j]);
#pragma unroll
    for (int j = 0; j < kMtChunksPerLane; ++j)
#pragma unroll
      for (int k = 0; k < kMtChunk; ++k)
        v[j][k] = __fadd_rn(__fmul_rn(v[j][k], a), __fmul_rn(w[j][k], b));
  } else if constexpr (kMode != 3) {
#pragma unroll
    for (int j = 0; j < kMtChunksPerLane; ++j)
#pragma unroll
      for (int k = 0; k < kMtChunk; ++k) v[j][k] = __fmul_rn(v[j][k], a);
  }
  float sum = 0.f;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kMtChunksPerLane; ++j) {
    if constexpr (kMode == 1 || kMode == 3) {
#pragma unroll
      for (int k = 0; k < kMtChunk; ++k)
        sum = __fadd_rn(sum, __fmul_rn(v[j][k], v[j][k]));
    }
    if constexpr (kMode != 3) {
#pragma unroll
      for (int k = 0; k < kMtChunk; ++k) bad |= !isfinite(v[j][k]);
      store_vec_packed<O, kMtChunk>(out + base + (j * 32 + lane) * kMtChunk,
                                    v[j]);
    }
  }
  if constexpr (kMode != 3) {
    if (__any_sync(kFullMask, bad) && lane == 0) *flag = 1;
  }
  if constexpr (kMode == 1 || kMode == 3) {
    sum = warp_sum(sum);
    if (lane == 0) rowsq[row] = sum;
  }
}

template <int kMode, typename X, typename Y, typename O>
int launch_rows(long long rows, const void* x, const void* y, const float* a,
                const float* b, void* out, int* flag, float* rowsq,
                cudaStream_t stream) {
  if (rows > 0) {
    const unsigned grid =
        static_cast<unsigned>(rows / (kMtThreads / 32));
    mt_row_kernel<kMode, X, Y, O><<<grid, kMtThreads, 0, stream>>>(
        static_cast<const X*>(x), static_cast<const Y*>(y), a, b,
        static_cast<O*>(out), flag, rowsq);
    note_launch("mt_row_kernel");
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace apex_port

using namespace apex_port;

// Dispatch on the dtype codes of up to three buffers: each fp32 or the
// call's one 2-byte type H (bf16 or fp16; half_family refuses a mix).
template <int kMode, typename H>
int dispatch_rows(int xc, int yc, int oc, long long rows, const void* x,
                  const void* y, const float* a, const float* b, void* out,
                  int* flag, float* rowsq, cudaStream_t stream) {
  switch ((xc != kFloat32) * 4 + (yc != kFloat32) * 2 + (oc != kFloat32)) {
#define MT_CASE(C, X, Y, O)                                                  \
  case C:                                                                    \
    return launch_rows<kMode, X, Y, O>(rows, x, y, a, b, out, flag, rowsq,  \
                                       stream);
    MT_CASE(0, float, float, float)
    MT_CASE(1, float, float, H)
    MT_CASE(2, float, H, float)
    MT_CASE(3, float, H, H)
    MT_CASE(4, H, float, float)
    MT_CASE(5, H, float, H)
    MT_CASE(6, H, H, float)
    default:
      return launch_rows<kMode, H, H, H>(rows, x, y, a, b, out, flag, rowsq,
                                         stream);
#undef MT_CASE
  }
}

template <int kMode>
int dispatch_codes(int xc, int yc, int oc, long long rows, const void* x,
                   const void* y, const float* a, const float* b, void* out,
                   int* flag, float* rowsq, void* stream) {
  return with_half(half_family(xc, yc, oc), [&](auto h) {
    return dispatch_rows<kMode, decltype(h)>(
        xc, yc, oc, rows, x, y, a, b, out, flag, rowsq,
        static_cast<cudaStream_t>(stream));
  });
}

extern "C" {

// out = x * s; flag = 1 where a value is not finite (y is unused: its code
// is x's, so no more instances than (x, out))
int mt_scale(long long rows, const void* x, int x_dt, const float* s,
             void* out, int out_dt, int* flag, void* stream) {
  return dispatch_codes<0>(x_dt, x_dt, out_dt, rows, x, nullptr, s, nullptr,
                           out, flag, nullptr, stream);
}

// the same, and rowsq[r] = sum over row r of (x * s)^2
int mt_scale_sumsq(long long rows, const void* x, int x_dt, const float* s,
                   void* out, int out_dt, int* flag, float* rowsq,
                   void* stream) {
  return dispatch_codes<1>(x_dt, x_dt, out_dt, rows, x, nullptr, s, nullptr,
                           out, flag, rowsq, stream);
}

// out = a * x + b * y; flag = 1 where a value is not finite
int mt_axpby(long long rows, const void* x, int x_dt, const void* y, int y_dt,
             const float* a, const float* b, void* out, int out_dt, int* flag,
             void* stream) {
  return dispatch_codes<2>(x_dt, y_dt, out_dt, rows, x, y, a, b, out, flag,
                           nullptr, stream);
}

// rowsq[r] = sum over row r of x^2
int mt_row_sumsq(long long rows, const void* x, int x_dt, float* rowsq,
                 void* stream) {
  return dispatch_codes<3>(x_dt, x_dt, kFloat32, rows, x, nullptr, nullptr,
                           nullptr, nullptr, nullptr, rowsq, stream);
}

}  // extern "C"
