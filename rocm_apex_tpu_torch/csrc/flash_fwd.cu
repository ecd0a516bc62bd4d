// Packed-QKV flash-attention forward with the projection bias and
// in-kernel dropout, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:1170 `_fwd_single_kernel`
// and the packed use of :170 `_fwd_kernel` (both reached from
// `_fwd_packed`). One block per (query tile of 64 rows, batch * head):
// q/k/v tiles are read straight out of the (B, S, nh, 3*hd) projection,
// the bias added on load; an online softmax in base 2 walks key tiles up
// to the causal bound, so S has no ceiling. As on the TPU the normalizer
// l sums the UNdropped probabilities and dropout zeroes entries of the
// normalized matrix (softmax -> dropout -> @ v). Writes o in
// (B, S, nh*hd) and the natural-log lse (B*nh, S).
//
// Bound: operations. At the training shape (B 16, S 1024, 8 heads, hd
// 128) the causal forward is 34 GFLOP against 0.05 GB of traffic.
//   bf16: the two products run on the tensor cores (mma.sync m16n8k16,
//         fp32 accumulate; mma.cuh): 4 warps, 16 query rows each; the
//         scores stay in registers and become the A operand of p @ v,
//         split hi + lo so p keeps fp32-level precision (1.5x the bf16
//         products of a plain bf16 p).
//   fp32: the products run on the CUDA cores in fp32 (4 x 4 score and
//         4 x 8 output register tiles per thread, operands from shared
//         memory); it is held to the fp32 rate.
// Neither pipelines its loads (one tile in flight, a barrier between
// load and use); cp.async/TMA double buffering and wgmma are next.
#include "flash_tile.cuh"
#include "mma.cuh"

namespace apex_port {

// ---- bf16: tensor cores --------------------------------------------------

constexpr int kMmaWarps = 4;      // 16 query rows each
constexpr int kLdS = kHd + 8;     // bf16 row of a [row][d] tile (136)
constexpr int kLdT = kTile + 8;   // bf16 row of a [d][key] tile (72)

__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_fwd_mma_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ bias, bf16* __restrict__ o,
                         float* __restrict__ lse, FlashShape sh,
                         float s_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [64][kLdS]
  bf16* sk = sq + kTile * kLdS;                   // [64][kLdS]
  bf16* svt = sk + kTile * kLdS;                  // [128][kLdT]: v^T
  constexpr int nthreads = kMmaWarps * 32;
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / sh.nh;
  const int h = bh % sh.nh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kTile;
  const int wr = warp * 16;  // this warp's first row in the tile
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * kHd;

  stage_tile<kTile>(sq, kLdS, nullptr, 0, qkv_part(qkv, sh, b, h, 0), rs,
                    bias_part(bias, h, 0), q0, sh.S, nthreads);
  __syncthreads();
  uint32_t qa[8][4];  // the warp's 16 rows of q, per 16-wide k-step of d
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) load_a(qa[kk], sq, kLdS, wr, kk * 16);
  // the thread's two rows: g and g + 8 of the warp's 16
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const uint32_t rkey[2] = {dropout_row_key(sh.seed, bh, row[0]),
                            dropout_row_key(sh.seed, bh, row[1])};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[16][4];  // o: 16 column blocks of 8 over d
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = (sh.S + kTile - 1) / kTile;
  const int nk = sh.causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // the previous tile's readers of sk/svt are done
    stage_tile<kTile>(sk, kLdS, nullptr, 0, qkv_part(qkv, sh, b, h, 1), rs,
                      bias_part(bias, h, 1), kt * kTile, sh.S, nthreads);
    stage_tile<kTile>(nullptr, 0, svt, kLdT,
                      qkv_part(qkv, sh, b, h, 2), rs, bias_part(bias, h, 2),
                      kt * kTile, sh.S, nthreads);
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys = 8 column blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t kb[4];
        load_b2(kb, sk, kLdS, nb * 8, kk * 16);
        mma_bf16(s[nb], qa[kk], kb[0], kb[1]);
        mma_bf16(s[nb + 1], qa[kk], kb[2], kb[3]);
      }

    // online softmax over the tile; e < 2 is row 0, e >= 2 row 1
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * kTile + nb * 8 + 2 * t + (e & 1);
        const int r = row[e >> 1];
        // padded query rows still see key 0, so every row's max is a
        // real score after the first tile
        float v = s[nb][e] * s_log2;
        if (!(col < sh.S && !(sh.causal && col > r))) v = kNegInf;
        s[nb][e] = v;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], v);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFullMask, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFullMask, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      corr[i] = exp2f(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);  // 0 for masked keys
        psum[e >> 1] += p;
        float pd = p;
        if (sh.drop) {
          const int col = kt * kTile + nb * 8 + 2 * t + (e & 1);
          pd = keep_bit(rkey[e >> 1], col, sh.thr) ? p * sh.keep_scale : 0.f;
        }
        s[nb][e] = pd;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(kFullMask, psum[i], 1);
      psum[i] += __shfl_xor_sync(kFullMask, psum[i], 2);
      l[i] = l[i] * corr[i] + psum[i];
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // o += p v over the 4 k-steps of 16 keys; p split hi + lo
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi[4], lo[4];
      c_to_a(s[2 * j], s[2 * j + 1], hi, lo);
#pragma unroll
      for (int n = 0; n < 16; n += 2) {
        uint32_t vb[4];
        load_b2(vb, svt, kLdT, n * 8, j * 16);
        mma_bf16(acc[n], hi, vb[0], vb[1]);
        mma_bf16(acc[n], lo, vb[0], vb[1]);
        mma_bf16(acc[n + 1], hi, vb[2], vb[3]);
        mma_bf16(acc[n + 1], lo, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= sh.S) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    bf16* orow =
        o + ((static_cast<int64_t>(b) * sh.S + row[i]) * sh.nh + h) * kHd;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = pack_bf16(
          acc[n][2 * i] / safe_l, acc[n][2 * i + 1] / safe_l);
    if (t == 0)
      lse[static_cast<int64_t>(bh) * sh.S + row[i]] =
          (m[i] + log2f(safe_l)) * kLn2;
  }
}

static int launch_mma(const void* qkv, const void* bias, void* o, void* lse,
                      const FlashShape& sh, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kTile * kLdS + kHd * kLdT);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sh.S + kTile - 1) / kTile, sh.B * sh.nh);
  flash_fwd_mma_kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<bf16*>(o), static_cast<float*>(lse), sh, scale * kLog2e);
  return 0;
}

// ---- fp32: CUDA cores ------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse,
                     FlashShape sh, float q_scale) {
  extern __shared__ float sm[];
  float* sq = sm;                  // 64 x kLd, pre-scaled q
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
            q0, sh.S, q_scale);

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
                  const FlashShape& sh, float scale, cudaStream_t stream) {
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
      static_cast<float*>(o), static_cast<float*>(lse), sh, scale * kLog2e);
  return 0;
}

}  // namespace apex_port

// qkv: contiguous (B, S, nh, 3*hd); bias: (nh*3*hd,) in the same dtype
// or null; o: contiguous (B, S, nh*hd); lse: contiguous (B*nh, S) fp32.
// hd must be 128. dropout != 0 drops p with keep bit hash(seed, b*nh+h,
// query, key) >= thr and scale 1/(1 - rate).
extern "C" int flash_fwd(const void* qkv, const void* bias, void* o,
                         void* lse, int B, int S, int nh, int hd,
                         float scale, int causal, int dropout, unsigned seed,
                         unsigned thr, float keep_scale, int dtype,
                         void* stream) {
  using namespace apex_port;
  if (hd != kHd) return static_cast<int>(cudaErrorInvalidValue);
  const FlashShape sh{B, S, nh, causal, dropout, seed, thr, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kFloat32)
    rc = launch(qkv, bias, o, lse, sh, scale, st);
  else if (dtype == kBFloat16)
    rc = launch_mma(qkv, bias, o, lse, sh, scale, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
