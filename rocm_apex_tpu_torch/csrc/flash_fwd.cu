// Packed-QKV flash-attention forward with the projection bias and
// in-kernel dropout, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:1170 `_fwd_single_kernel`
// and the packed use of :170 `_fwd_kernel` (both reached from
// `_fwd_packed`). q/k/v are read straight out of the (B, S, nh, 3*hd)
// projection; an online softmax in base 2 walks key tiles up to the
// causal bound, so S has no ceiling. As on the TPU the normalizer l sums
// the UNdropped probabilities and dropout zeroes entries of the
// normalized matrix (softmax -> dropout -> @ v). Writes o in (B, S,
// nh*hd) and the natural-log lse (B*nh, S). The scores are
// `_masked_scores`': the biased q times q_mul = scale * log2(e) in the
// operand dtype, rounded to it, then the fp32 product with k.
//
// Bound: operations. At the training shape (B 16, S 1024, 8 heads, hd
// 128) the causal forward is 34 GFLOP against 0.13 GB of traffic.
//   bf16: the wgmma pipe of flash_fwd_pipe.cuh, the unpacked forward's,
//         on the projection's per-head column blocks read through their
//         strides (batch S*nh*3*hd, head 3*hd, row nh*3*hd). With a
//         projection bias, a pre-pass first writes the biased projection
//         bf16(qkv + bias) once (the JAX kernels' bf16 add) into a scratch
//         of the projection's shape, which the pipe then reads: the
//         alternative, adding the bias to every staged K/V tile, redoes
//         each tile's add for every query tile that reads it and puts a
//         shared-memory pass and a barrier into every key step.
//   fp32: the products run on the CUDA cores in fp32 (4 x 4 score and
//         4 x 8 output register tiles per thread, operands from shared
//         memory); it is held to the fp32 rate.
// Head dims: the packed path takes hd % 128 == 0 up to 256 (the JAX
// package's rule at the models' widths, models/gpt.py:370): bf16 on the
// pipe's width-128 and width-256 instances; fp32 at 128 on the kernel
// below, at 256 on the unpacked forward's CUDA-core body (width 256)
// through the projection's strides, after an fp32 bias pre-pass.
#include "flash_fwd_pipe.cuh"
#include "flash_tile.cuh"
#include "flash_unpacked_fwd.cuh"

namespace apex_port {

// ---- bf16 and fp16 (T): the bias pre-pass, then the pipe -----------------

template <typename T, int HD>
static int launch_pipe(const void* qkv, const void* bias, void* o, void* lse,
                       const FlashShape& sh, float scale, float q_mul,
                       int splits, int split_tiles, void* scratch, void* ws,
                       cudaStream_t stream) {
  const T* x = static_cast<const T*>(qkv);
  if (bias != nullptr) {
    const cudaError_t e =
        launch_qkv_bias<T>(qkv, bias, scratch, sh, HD, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    x = static_cast<const T*>(scratch);
  }
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * HD;
  const unpacked::Strides in{sh.S * rs, 3 * HD, rs};
  const int64_t ors = static_cast<int64_t>(sh.nh) * HD;
  const unpacked::Strides st[4] = {in, in, in,
                                   unpacked::Strides{sh.S * ors, HD, ors}};
  const unpacked::Problem pb = unpacked::make_problem(
      sh.B, sh.nh, sh.S, sh.S, sh.causal, nullptr, nullptr, 0, sh.drop,
      sh.seed, sh.thr, sh.keep_scale, q_mul, scale, HD);
  return unpacked::launch_pipe_fwd<T, HD>(x, x + HD, x + 2 * HD, o, lse, st,
                                          pb, splits, split_tiles, ws,
                                          stream);
}

// ---- fp32 at head_dim 256: the bias pre-pass, then the unpacked body ------

static int launch_wide(const void* qkv, const void* bias, void* o, void* lse,
                       const FlashShape& sh, int hd, float scale, float q_mul,
                       void* scratch, cudaStream_t stream) {
  const float* x = static_cast<const float*>(qkv);
  if (bias != nullptr) {
    const cudaError_t e =
        launch_qkv_bias_f32(qkv, bias, scratch, sh, hd, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    x = static_cast<const float*>(scratch);
  }
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * hd;
  const int64_t ors = static_cast<int64_t>(sh.nh) * hd;
  const int64_t st[12] = {sh.S * rs,  3 * hd, rs, sh.S * rs,  3 * hd, rs,
                          sh.S * rs,  3 * hd, rs, sh.S * ors, hd,     ors};
  const unpacked::Problem pb = unpacked::make_problem(
      sh.B, sh.nh, sh.S, sh.S, sh.causal, nullptr, nullptr, 0, sh.drop,
      sh.seed, sh.thr, sh.keep_scale, q_mul, scale, hd);
  if (!unpacked::grid_ok(pb)) return static_cast<int>(cudaErrorInvalidValue);
  return unpacked::launch_fwd<false>(x, x + hd, x + 2 * hd, o, lse, st, pb,
                                     kFloat32, stream);
}

// ---- fp32: CUDA cores ------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse,
                     FlashShape sh, float q_mul) {
  extern __shared__ float sm[];
  float* sq = sm;                  // 64 x kLd, q * q_mul
  float* sk = sq + kTile * kLd;    // 64 x kLd
  float* sv = sk + kTile * kLd;    // 64 x kHd
  float* sp = sv + kTile * kHd;    // 64 x kLdP, dropped probabilities
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / sh.nh;
  const int h = bh % sh.nh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * kHd;

  load_tile(sq, kLd, qkv_part(qkv, sh, b, h, 0), rs, bias_part(bias, h, 0),
            q0, sh.S, q_mul);

  float m[4], l[4], acc[4][8];
  uint32_t key[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    key[i] = dropout_row_key(sh.seed, bh, q0 + ty + 16 * i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int ntiles = (sh.S + kTile - 1) / kTile;
  const int nk = sh.causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's readers of sk/sv/sp are done
    load_tile(sk, kLd, qkv_part(qkv, sh, b, h, 1), rs, bias_part(bias, h, 1),
              kt * kTile, sh.S, 1.f);
    load_tile(sv, kHd, qkv_part(qkv, sh, b, h, 2), rs, bias_part(bias, h, 2),
              kt * kTile, sh.S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // padded query rows still see key 0, so every row's max is a
        // real score after the first tile
        const int col = kt * kTile + tx + 16 * j;
        if (!(col < sh.S && !(sh.causal && col > row))) s[i][j] = kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float corr = exp2f(m[i] - m_new);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        const float p = exp2f(s[i][j] - m_new);  // 0 for masked keys
        psum += p;
        float pd = p;
        if (sh.drop)
          pd = keep_bit(key[i], col, sh.thr) ? p * sh.keep_scale : 0.f;
        sp[(ty + 16 * i) * kLdP + tx + 16 * j] = pd;
      }
      l[i] = l[i] * corr + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty + 16 * i) * kLdP + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = sv[k * kHd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sh.S) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    float* orow =
        o + ((static_cast<int64_t>(b) * sh.S + row) * sh.nh + h) * kHd;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      orow[tx + 16 * j] = (acc[i][j] / safe_l);
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * sh.S + row] =
          (m[i] + log2f(safe_l)) * kLn2;
  }
}

static int launch(const void* qkv, const void* bias, void* o, void* lse,
                  const FlashShape& sh, float q_mul, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kTile * kLd + kTile * kHd + kTile * kLdP);
  auto kernel = flash_fwd_kernel;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sh.S + kTile - 1) / kTile, sh.B * sh.nh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), sh, q_mul);
  note_launch("flash_fwd_kernel");
  return 0;
}

}  // namespace apex_port

// qkv: contiguous (B, S, nh, 3*hd); bias: (nh*3*hd,) in the same dtype
// or null; o: contiguous (B, S, nh*hd); lse: contiguous (B*nh, S) fp32.
// hd is 128 or 256. dropout != 0 drops p with keep bit hash(seed, b*nh+h,
// query, key) >= thr and scale 1/(1 - rate). q_mul is scale * log2(e)
// rounded to qkv's dtype. bf16: splits and split_tiles are the plan's key
// split (flash_fwd_plan), ws its fp32 workspace when splits > 1, else
// null; scratch, with a bias, a contiguous (B, S, nh, 3*hd) buffer in
// qkv's dtype for the biased projection (bf16, and fp32 at hd 256), else
// null. fp32 ignores splits, split_tiles and ws.
extern "C" int flash_fwd(const void* qkv, const void* bias, void* o,
                         void* lse, int B, int S, int nh, int hd,
                         float scale, float q_mul, int causal, int dropout,
                         unsigned seed, unsigned thr, float keep_scale,
                         int splits, int split_tiles, void* scratch,
                         void* ws, int dtype, void* stream) {
  using namespace apex_port;
  if (hd != 128 && hd != 256) return static_cast<int>(cudaErrorInvalidValue);
  const FlashShape sh{B, S, nh, causal, dropout, seed, thr, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kFloat32 && hd == kHd)
    rc = launch(qkv, bias, o, lse, sh, q_mul, st);
  else if (dtype == kFloat32 && (bias == nullptr || scratch != nullptr))
    rc = launch_wide(qkv, bias, o, lse, sh, hd, scale, q_mul, scratch, st);
  else if (is_half_code(dtype) && (bias == nullptr || scratch != nullptr))
    rc = with_half(dtype, [&](auto h) {
      using T = decltype(h);
      return hd == 256 ? launch_pipe<T, 256>(qkv, bias, o, lse, sh, scale,
                                             q_mul, splits, split_tiles,
                                             scratch, ws, st)
                       : launch_pipe<T, 128>(qkv, bias, o, lse, sh, scale,
                                             q_mul, splits, split_tiles,
                                             scratch, ws, st);
    });
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
