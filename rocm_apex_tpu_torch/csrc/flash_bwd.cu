// Packed-QKV flash-attention backward with the projection bias and
// in-kernel dropout, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:1324 `_bwd_merged_kernel`
// and the packed use of :316 `_bwd_dkv_kernel` / :384 `_bwd_dq_kernel`
// (`_bwd_packed`). Blocks run in no order on Hopper, so the TPU's merged
// single-grid-step kernel becomes two launches with no atomics:
//
//   dq pass   one block per (b*nh, query tile): delta = rowsum(do * o)
//             of its rows (written for the dk/dv pass), then for each key
//             tile up to the causal bound p = exp2(s - lse log2 e),
//             dp = do v^T, ds = p (keep dp / (1 - rate) - delta), and
//             dq += ds k;
//   dkv pass  one block per (b*nh, key tile): for each query tile from
//             the causal bound on, the same p and ds, then
//             dv += (keep p / (1 - rate))^T do and dk += ds^T q.
//
// The probabilities and keep bits are recomputed from the saved lse and
// dropout.cuh's hash, so no mask or score tile is stored. The scores are
// the forward's: the biased q times q_mul = scale * log2(e) in the
// operand dtype, rounded to it once as the tile is staged (the JAX rule,
// `_masked_scores`), then the fp32 product with k; dq and dk take the
// scale at the end, dk from the unscaled biased q, as JAX's. dq, dk and dv
// are written straight into the (B, S, nh, 3*hd) projection cotangent.
// With a bias, each block also writes the fp32 column sums of its dq (or
// dk and dv) rows — partials of shape (B, tiles of 64, nh, 3*hd) that the
// wrapper sums over batch and tiles in fp32, as `_bwd_merged_kernel`
// sums its per-(batch, head) fp32 partials. Every sum has a fixed order,
// so two runs on the same inputs give the same bits.
//
// Bound: operations (2.5x the forward's products).
//   bf16: the wgmma pipe of flash_bwd_pipe.cuh on the projection's
//         per-head column blocks read through their strides (batch
//         S*nh*3*hd, head 3*hd, row nh*3*hd), dq, dk and dv written the
//         same way into dqkv; with a projection bias, a pre-pass first
//         writes the biased projection once (flash_tile.cuh, the forward's
//         pre-pass), which both passes then read. The dq pass writes (lse
//         log2 e, delta) pairs for the dk/dv pass into `stats`.
//   fp32: CUDA cores, as flash_fwd.cu.
// Head dims as flash_fwd.cu's: bf16 on the pipe's widths 128 and 256 (at
// 256 its dk/dv pass split by columns, flash_bwd_pipe.cuh), fp32 at 256 on
// the unpacked backward's CUDA-core bodies through the projection's
// strides, after the fp32 bias pre-pass, with the bias partials summed
// from dqkv by `qkv_column_sums_kernel` (one 64-row tile each, in row
// order).
#include "flash_bwd_pipe.cuh"
#include "flash_tile.cuh"
#include "flash_unpacked_bwd.cuh"

namespace apex_port {

// ---- bf16 and fp16 (T): the bias pre-pass, then the pipe -----------------

template <typename T, int HD>
static int launch_pipe(const void* qkv, const void* bias, const void* o,
                       const void* lse, const void* dout, void* dqkv,
                       void* stats, void* dbias_part, const FlashShape& sh,
                       float scale, float q_mul, void* scratch,
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
  const unpacked::Strides out{sh.S * ors, HD, ors};
  const int64_t tiles = (sh.S + kTile - 1) / kTile;
  T* g = static_cast<T*>(dqkv);
  const unpacked::BwdArgs<T> a{
      x, x + HD, x + 2 * HD, static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(stats), g, g + HD, g + 2 * HD,
      static_cast<float*>(dbias_part), in, in, in, out, out, in, in, in,
      unpacked::Strides{tiles * rs, 3 * HD, rs}};
  const unpacked::Problem pb = unpacked::make_problem(
      sh.B, sh.nh, sh.S, sh.S, sh.causal, nullptr, nullptr, 0, sh.drop,
      sh.seed, sh.thr, sh.keep_scale, q_mul, scale, HD);
  return unpacked::launch_pipe_bwd<HD>(a, pb, stream);
}

// ---- fp32 at head_dim 256: the bias pre-pass, the unpacked bodies, the
// bias partials ----------------------------------------------------------

static int launch_wide(const void* qkv, const void* bias, const void* o,
                       const void* lse, const void* dout, void* dqkv,
                       void* delta, void* dbias_part, const FlashShape& sh,
                       int hd, float scale, float q_mul, void* scratch,
                       cudaStream_t stream) {
  const float* x = static_cast<const float*>(qkv);
  if (bias != nullptr) {
    const cudaError_t e =
        launch_qkv_bias_f32(qkv, bias, scratch, sh, hd, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    x = static_cast<const float*>(scratch);
  }
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * hd;
  const int64_t ors = static_cast<int64_t>(sh.nh) * hd;
  const int64_t in[3] = {sh.S * rs, 3 * hd, rs};
  const int64_t out[3] = {sh.S * ors, hd, ors};
  int64_t st[24];  // q, k, v, o, do, dq, dk, dv
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j)
      st[3 * i + j] = (i == 3 || i == 4) ? out[j] : in[j];
  float* g = static_cast<float*>(dqkv);
  const void* p[11] = {x, x + hd, x + 2 * hd, o,          lse,  dout,
                       nullptr,   g,          g + hd, g + 2 * hd, delta};
  const unpacked::Problem pb = unpacked::make_problem(
      sh.B, sh.nh, sh.S, sh.S, sh.causal, nullptr, nullptr, 0, sh.drop,
      sh.seed, sh.thr, sh.keep_scale, q_mul, scale, hd);
  if (!unpacked::grid_ok(pb)) return static_cast<int>(cudaErrorInvalidValue);
  int rc = unpacked::launch_bwd<false>(p, st, pb, kFloat32, stream);
  if (rc == 0) rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || dbias_part == nullptr) return rc;
  return static_cast<int>(
      launch_qkv_column_sums(dqkv, dbias_part, sh, hd, stream));
}

// ---- fp32: CUDA cores ------------------------------------------------------

// Column sums of a thread-tiled (64 x 128) accumulator acc[i][j] (rows
// ty + 16 i, columns tx + 16 j), times `mul`, into out[0..128). `red` is
// 16 x 128 floats of shared memory; the caller synchronizes before.
__device__ __forceinline__ void column_sums(const float (&acc)[4][8],
                                            float mul, float* red,
                                            float* __restrict__ out) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float c = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) c += acc[i][j];
    red[ty * kHd + tx + 16 * j] = c * mul;
  }
  __syncthreads();
  if (threadIdx.x < kHd) {
    float c = 0.f;
    for (int r = 0; r < 16; ++r) c += red[r * kHd + threadIdx.x];
    out[threadIdx.x] = c;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float* __restrict__ dqkv,
                        float* __restrict__ delta_out,
                        float* __restrict__ dbias_part, FlashShape sh,
                        float scale, float q_mul) {
  extern __shared__ float sm[];
  float* sq = sm;                  // 64 x kLd, q * q_mul
  float* sdo = sq + kTile * kLd;   // 64 x kLd
  float* sk = sdo + kTile * kLd;   // 64 x kLd
  float* sv = sk + kTile * kLd;    // 64 x kLd
  float* sds = sv + kTile * kLd;   // 64 x kLdP
  float* slse = sds + kTile * kLdP;  // 64, times log2 e
  float* sdelta = slse + kTile;      // 64
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / sh.nh;
  const int h = bh % sh.nh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * kTile;
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * kHd;
  const int64_t os = static_cast<int64_t>(sh.nh) * kHd;
  const int64_t ohead = (static_cast<int64_t>(b) * sh.S * sh.nh + h) * kHd;

  load_tile(sq, kLd, qkv_part(qkv, sh, b, h, 0), rs, bias_part(bias, h, 0),
            q0, sh.S, q_mul);
  load_tile(sdo, kLd, dout + ohead, os, nullptr, q0,
            sh.S, 1.f);
  __syncthreads();
  // delta = rowsum(do * o): 8 warps x 8 rows
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sh.S) {
      for (int c = lane; c < kHd; c += 32)
        acc += sdo[r * kLd + c] * to_float(o[ohead + row * os + c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      sdelta[r] = acc;
      slse[r] = row < sh.S ? lse[static_cast<int64_t>(bh) * sh.S + row] * kLog2e
                           : 0.f;
      if (row < sh.S) delta_out[static_cast<int64_t>(bh) * sh.S + row] = acc;
    }
  }

  float acc[4][8];
  uint32_t key[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = dropout_row_key(sh.seed, bh, q0 + ty + 16 * i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int ntiles = (sh.S + kTile - 1) / kTile;
  const int nk = sh.causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile(sk, kLd, qkv_part(qkv, sh, b, h, 1), rs, bias_part(bias, h, 1),
              kt * kTile, sh.S, 1.f);
    load_tile(sv, kLd, qkv_part(qkv, sh, b, h, 2), rs, bias_part(bias, h, 2),
              kt * kTile, sh.S, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHd; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sq[(ty + 16 * i) * kLd + d];
        dov[i] = sdo[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sk[(tx + 16 * j) * kLd + d];
        vv[j] = sv[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        float ds = 0.f;
        if (attends(sh, row, col)) {
          const float p = exp2f(s[i][j] - slse[r]);
          float dpd = dp[i][j];
          if (sh.drop)
            dpd = keep_bit(key[i], col, sh.thr) ? dpd * sh.keep_scale : 0.f;
          ds = p * (dpd - sdelta[r]);
        }
        sds[r * kLdP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTile; ++k) {
      float dsv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sds[(ty + 16 * i) * kLdP + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sk[k * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sh.S) continue;
    float* out =
        dqkv + (static_cast<int64_t>(b) * sh.S + row) * rs + h * 3 * kHd;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[tx + 16 * j] = (acc[i][j] * scale);
  }
  if (dbias_part != nullptr) {
    __syncthreads();  // sds is reused as the reduction buffer
    const int ntl = (sh.S + kTile - 1) / kTile;
    column_sums(acc, scale, sds,
                dbias_part + ((static_cast<int64_t>(b) * ntl + qt) * sh.nh + h) *
                                 3 * kHd);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ bias,
                         const float* __restrict__ lse,
                         const float* __restrict__ dout,
                         const float* __restrict__ delta,
                         float* __restrict__ dqkv,
                         float* __restrict__ dbias_part,
                         FlashShape sh, float scale, float q_mul) {
  extern __shared__ float sm[];
  float* sk = sm;                  // 64 x kLd (keys of this block)
  float* sv = sk + kTile * kLd;    // 64 x kLd
  float* sq = sv + kTile * kLd;    // 64 x kLd, unscaled q
  float* sdo = sq + kTile * kLd;   // 64 x kLd
  float* sp = sdo + kTile * kLd;   // 64 x kLdP, [key][query] dropped p
  float* sds = sp + kTile * kLdP;  // 64 x kLdP, [key][query] ds
  float* slse = sds + kTile * kLdP;  // 64, times log2 e
  float* sdelta = slse + kTile;      // 64
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / sh.nh;
  const int h = bh % sh.nh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * kHd;
  const int64_t os = static_cast<int64_t>(sh.nh) * kHd;
  const int64_t ohead = (static_cast<int64_t>(b) * sh.S * sh.nh + h) * kHd;

  load_tile(sk, kLd, qkv_part(qkv, sh, b, h, 1), rs, bias_part(bias, h, 1),
            k0, sh.S, 1.f);
  load_tile(sv, kLd, qkv_part(qkv, sh, b, h, 2), rs, bias_part(bias, h, 2),
            k0, sh.S, 1.f);

  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int ntiles = (sh.S + kTile - 1) / kTile;
  for (int qt = sh.causal ? kt : 0; qt < ntiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(sq, kLd, qkv_part(qkv, sh, b, h, 0), rs, bias_part(bias, h, 0),
              q0, sh.S, 1.f);
    load_tile(sdo, kLd, dout + ohead, os, nullptr, q0,
              sh.S, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const int64_t at = static_cast<int64_t>(bh) * sh.S + row;
      slse[threadIdx.x] = row < sh.S ? lse[at] * kLog2e : 0.f;
      sdelta[threadIdx.x] = row < sh.S ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHd; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sk[(ty + 16 * i) * kLd + d];
        vv[i] = sv[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sq[(tx + 16 * j) * kLd + d] * q_mul;  // the scores' q
        dov[j] = sdo[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int row = q0 + c;
      const uint32_t key = dropout_row_key(sh.seed, bh, row);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int col = k0 + r;
        float pd = 0.f, ds = 0.f;
        if (attends(sh, row, col)) {
          const float p = exp2f(s[i][j] - slse[c]);
          float dpd = dp[i][j];
          pd = p;
          if (sh.drop) {
            const bool keep = keep_bit(key, col, sh.thr);
            pd = keep ? p * sh.keep_scale : 0.f;
            dpd = keep ? dpd * sh.keep_scale : 0.f;
          }
          ds = p * (dpd - sdelta[c]);
        }
        sp[r * kLdP + c] = pd;
        sds[r * kLdP + c] = ds;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int q = 0; q < kTile; ++q) {
      float pv[4], dsv[4], dov[8], qv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sp[(ty + 16 * i) * kLdP + q];
        dsv[i] = sds[(ty + 16 * i) * kLdP + q];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dov[j] = sdo[q * kLd + tx + 16 * j];
        qv[j] = sq[q * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sh.S) continue;
    float* out =
        dqkv + (static_cast<int64_t>(b) * sh.S + key) * rs + h * 3 * kHd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      out[kHd + tx + 16 * j] = (dk[i][j] * scale);
      out[2 * kHd + tx + 16 * j] = (dv[i][j]);
    }
  }
  if (dbias_part != nullptr) {
    float* part = dbias_part +
                  ((static_cast<int64_t>(b) * ntiles + kt) * sh.nh + h) * 3 * kHd;
    __syncthreads();  // sp is reused as the reduction buffer
    column_sums(dk, scale, sp, part + kHd);
    __syncthreads();
    column_sums(dv, 1.f, sp, part + 2 * kHd);
  }
}

static int launch(const void* qkv, const void* bias, const void* o,
                  const void* lse, const void* dout, void* dqkv, void* delta,
                  void* dbias_part, const FlashShape& sh, float scale,
                  float q_mul, cudaStream_t stream) {
  const dim3 grid((sh.S + kTile - 1) / kTile, sh.B * sh.nh);
  const size_t smem_dq =
      sizeof(float) * (4 * kTile * kLd + kTile * kLdP + 2 * kTile);
  const size_t smem_dkv =
      sizeof(float) * (4 * kTile * kLd + 2 * kTile * kLdP + 2 * kTile);
  auto dq_kernel = flash_bwd_dq_kernel;
  auto dkv_kernel = flash_bwd_dkv_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dkv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<<<grid, kThreads, smem_dq, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<float*>(dqkv),
      static_cast<float*>(delta), static_cast<float*>(dbias_part), sh, scale,
      q_mul);
  note_launch("flash_bwd_dq_kernel");
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const float*>(delta), static_cast<float*>(dqkv),
      static_cast<float*>(dbias_part), sh, scale, q_mul);
  note_launch("flash_bwd_dkv_kernel");
  return 0;
}

}  // namespace apex_port

// qkv, bias, o, lse as saved by flash_fwd; dout: contiguous (B, S, nh*hd)
// in qkv's dtype; dqkv: contiguous (B, S, nh, 3*hd) output; dbias_part:
// null without a bias, else an fp32 output of (B, ceil(S/64), nh, 3*hd)
// partial column sums. hd is 128 or 256. q_mul is scale * log2(e) rounded
// to qkv's dtype. stats: bf16, an fp32 scratch of (B*nh, 64 ceil(S/64),
// 2) (lse log2 e, delta) pairs; fp32, one of (B*nh, S) (delta). scratch:
// with a bias in bf16, and in fp32 at hd 256, a contiguous (B, S, nh,
// 3*hd) buffer in qkv's dtype for the biased projection, else null (the
// plan, flash_bwd_plan, names both).
extern "C" int flash_bwd(const void* qkv, const void* bias, const void* o,
                         const void* lse, const void* dout, void* dqkv,
                         void* stats, void* dbias_part, void* scratch, int B,
                         int S, int nh, int hd, float scale, float q_mul,
                         int causal, int dropout, unsigned seed, unsigned thr,
                         float keep_scale, int dtype, void* stream) {
  using namespace apex_port;
  if (hd != 128 && hd != 256) return static_cast<int>(cudaErrorInvalidValue);
  const FlashShape sh{B, S, nh, causal, dropout, seed, thr, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kFloat32 && hd == kHd)
    rc = launch(qkv, bias, o, lse, dout, dqkv, stats, dbias_part, sh, scale,
                q_mul, st);
  else if (dtype == kFloat32 && (bias == nullptr) == (scratch == nullptr))
    rc = launch_wide(qkv, bias, o, lse, dout, dqkv, stats, dbias_part, sh,
                     hd, scale, q_mul, scratch, st);
  else if (is_half_code(dtype) && (bias == nullptr) == (scratch == nullptr))
    rc = with_half(dtype, [&](auto h) {
      using T = decltype(h);
      return hd == 256 ? launch_pipe<T, 256>(qkv, bias, o, lse, dout, dqkv,
                                             stats, dbias_part, sh, scale,
                                             q_mul, scratch, st)
                       : launch_pipe<T, 128>(qkv, bias, o, lse, dout, dqkv,
                                             stats, dbias_part, sh, scale,
                                             q_mul, scratch, st);
    });
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
