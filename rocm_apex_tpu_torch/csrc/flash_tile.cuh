// Shared pieces of the packed-QKV flash-attention forward (flash_fwd.cu)
// and backward (flash_bwd.cu): tile geometry, the tile loader that reads
// q/k/v straight out of the fused projection, the masking rule, and the
// bias pre-pass both bf16 pipes read the biased projection from.
//
// Layouts (those of rocm_apex_tpu/ops/flash_attention.py's packed path):
//   qkv   (B, S, nh, 3*hd): per head, q | k | v columns; read in place
//   bias  (nh*3*hd,) or null: added to q/k/v as an fp32 tile is loaded,
//         or once by the bf16 pre-pass
//   o, do (B, S, nh*hd)
//   lse   (B*nh, S) fp32, natural log
// Grid row bh = b * nh + h, as on the TPU.
//
// The bf16 pipes take hd 128 and 256 (their widths); the fp32 kernels
// below take hd = kHd = 128, and hd 256 in fp32 runs on the unpacked
// CUDA-core bodies (flash_unpacked_{fwd,bwd}.cuh) through the projection's
// strides, after the fp32 bias pre-pass (`launch_qkv_bias_f32`), with the
// bias partials summed by `qkv_column_sums_kernel`. Tiles are 64 query
// rows x 64 keys. The rest serves the fp32 kernels, which run the products on the CUDA cores:
// tiles are staged in shared memory as fp32; 256 threads form a 16 x 16
// grid (tx = tid % 16, ty = tid / 16); a thread owns rows ty + 16 i and
// columns tx + 16 j of a 64 x 64 score tile, so a row's 64 scores sit in
// one half-warp and its softmax reductions are 4 shuffles. Operand rows
// are padded to 129 floats so the column-strided reads hit distinct
// banks. (The bf16 kernels run on flash_fwd_pipe.cuh and
// flash_bwd_pipe.cuh.)
#pragma once

#include <algorithm>

#include "common.cuh"
#include "dropout.cuh"

namespace apex_port {

constexpr int kHd = 128;     // head_dim the kernels take
constexpr int kTile = 64;    // query rows and keys per tile
constexpr int kLd = kHd + 1; // padded operand row (floats)
constexpr int kLdP = kTile + 1;
constexpr int kThreads = 256;

struct FlashShape {
  int B, S, nh;
  int causal;
  int drop;
  uint32_t seed, thr;
  float keep_scale;  // 1 / (1 - rate)
};

// Load rows [r0, r0 + 64) of one (b, h) fp32 head into dst (64 x ld
// floats): element (r, c) is src[(r0 + r) * row_stride + c] (+ bias[c])
// times `mul`, and 0 for rows at or past S. Each thread reads 16-byte
// vectors: the wrappers pass 16-byte aligned tensors and every row and
// column offset is a multiple of 4 elements.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t row_stride,
                                          const float* __restrict__ bias,
                                          int r0, int S, float mul) {
  constexpr int kVec = 4;
  constexpr int kPerRow = kHd / kVec;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    const int row = r0 + r;
    float v[kVec];
    if (row < S) {
      load_vec<float, kVec>(src + row * row_stride + c, v);
      if (bias != nullptr) {
        float bv[kVec];
        load_vec<float, kVec>(bias + c, bv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[i] += bv[i];
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] *= mul;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * ld + c + i] = v[i];
  }
}

// The one masking rule of every pass: key `col` is attended by query
// `row` iff both are inside the sequence and, when causal, col <= row.
__device__ __forceinline__ bool attends(const FlashShape& sh, int row,
                                        int col) {
  return row < sh.S && col < sh.S && !(sh.causal && col > row);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The projection's q/k/v column block `part` (0, 1, 2) of head h in
// batch b, as a (S, hd) matrix with row stride nh * 3 * hd.
template <typename T>
__device__ __forceinline__ const T* qkv_part(const T* qkv, const FlashShape& sh,
                                             int b, int h, int part) {
  return qkv + (static_cast<int64_t>(b) * sh.S * sh.nh + h) * 3 * kHd +
         part * kHd;
}

template <typename T>
__device__ __forceinline__ const T* bias_part(const T* bias, int h,
                                              int part) {
  return bias == nullptr ? nullptr : bias + (h * 3 + part) * kHd;
}

// ---- the bf16 and fp16 pipes' bias pre-pass -------------------------------

// out = T(qkv + bias) over n8 vectors of 8 T, the bias repeating every
// row8 vectors (one (b, s) row of nh*3*hd)
template <typename T>
__global__ void __launch_bounds__(256)
    qkv_bias_kernel(const uint4* __restrict__ qkv,
                    const uint4* __restrict__ bias, uint4* __restrict__ out,
                    int64_t n8, int row8) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n8; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint4 raw = qkv[i];
    const uint4 braw = bias[i % row8];
    using T2 = typename Pair<T>::type;
    T2* e = reinterpret_cast<T2*>(&raw);
    const T2* be = reinterpret_cast<const T2*>(&braw);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = __hadd2(e[j], be[j]);
    out[i] = raw;
  }
}

// the biased projection T(qkv + bias) of a (B, S, nh, 3*hd) projection in
// T into out, once, for the pipes to read (flash_fwd.cu, flash_bwd.cu)
template <typename T>
inline cudaError_t launch_qkv_bias(const void* qkv, const void* bias,
                                   void* out, const FlashShape& sh, int hd,
                                   cudaStream_t stream) {
  const int row8 = sh.nh * 3 * hd / 8;
  const int64_t n8 = static_cast<int64_t>(sh.B) * sh.S * row8;
  const int64_t blocks = std::min<int64_t>((n8 + 255) / 256, 1 << 20);
  if (blocks == 0) return cudaSuccess;
  qkv_bias_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const uint4*>(qkv), static_cast<const uint4*>(bias),
      static_cast<uint4*>(out), n8, row8);
  note_launch("qkv_bias_kernel");
  return cudaGetLastError();
}

// ---- fp32 at head_dim 256: the bias pre-pass and the bias partials --------

// out = qkv + bias over n4 vectors of 4 fp32, the bias repeating every
// row4 vectors (the add load_tile makes, once)
__global__ void __launch_bounds__(256)
    qkv_bias_f32_kernel(const float4* __restrict__ qkv,
                        const float4* __restrict__ bias,
                        float4* __restrict__ out, int64_t n4, int row4) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 x = qkv[i];
    const float4 b = bias[i % row4];
    out[i] = make_float4(x.x + b.x, x.y + b.y, x.z + b.z, x.w + b.w);
  }
}

inline cudaError_t launch_qkv_bias_f32(const void* qkv, const void* bias,
                                       void* out, const FlashShape& sh,
                                       int hd, cudaStream_t stream) {
  const int row4 = sh.nh * 3 * hd / 4;
  const int64_t n4 = static_cast<int64_t>(sh.B) * sh.S * row4;
  const int64_t blocks = std::min<int64_t>((n4 + 255) / 256, 1 << 20);
  if (blocks == 0) return cudaSuccess;
  qkv_bias_f32_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const float4*>(qkv), static_cast<const float4*>(bias),
      static_cast<float4*>(out), n4, row4);
  note_launch("qkv_bias_f32_kernel");
  return cudaGetLastError();
}

// part[b, tile, c] = the sum of dqkv[b, r, c] over the tile's 64 rows r in
// ascending order (c over the nh*3*hd columns): the fp32 bias partials of
// (B, ceil(S / 64), nh, 3*hd), a thread a column of a (b, tile)
__global__ void __launch_bounds__(256)
    qkv_column_sums_kernel(const float* __restrict__ dqkv,
                           float* __restrict__ part, int S, int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int ntl = (S + kTile - 1) / kTile;
  const int b = blockIdx.y / ntl;
  const int tl = blockIdx.y % ntl;
  if (c >= width) return;
  const float* col = dqkv + (static_cast<int64_t>(b) * S) * width + c;
  float acc = 0.f;
  for (int r = tl * kTile; r < min(S, tl * kTile + kTile); ++r)
    acc += col[static_cast<int64_t>(r) * width];
  part[static_cast<int64_t>(blockIdx.y) * width + c] = acc;
}

inline cudaError_t launch_qkv_column_sums(const void* dqkv, void* part,
                                          const FlashShape& sh, int hd,
                                          cudaStream_t stream) {
  const int width = sh.nh * 3 * hd;
  const int64_t rows = static_cast<int64_t>(sh.B) * ((sh.S + kTile - 1) / kTile);
  if (rows == 0 || width == 0) return cudaSuccess;
  if (rows > 65535) return cudaErrorInvalidValue;
  qkv_column_sums_kernel<<<dim3((width + 255) / 256, static_cast<unsigned>(rows)),
                           256, 0, stream>>>(static_cast<const float*>(dqkv),
                                             static_cast<float*>(part), sh.S,
                                             width);
  note_launch("qkv_column_sums_kernel");
  return cudaGetLastError();
}

}  // namespace apex_port
