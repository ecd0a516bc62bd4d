// Packed-QKV flash-attention backward with the projection bias and
// in-kernel dropout, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:1324 `_bwd_merged_kernel`
// and the packed use of :316 `_bwd_dkv_kernel` / :384 `_bwd_dq_kernel`
// (`_bwd_packed`). Blocks run in no order on Hopper, so the TPU's merged
// single-grid-step kernel becomes two launches with no atomics:
//
//   dq pass   one block per (query tile, b*nh): delta = rowsum(do * o) of
//             its rows (written for the dk/dv pass), then for each key
//             tile up to the causal bound p = exp2(s - lse log2 e),
//             dp = do v^T, ds = p (keep dp / (1 - rate) - delta), and
//             dq += ds k;
//   dkv pass  one block per (key tile, b*nh): for each query tile from
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
//   bf16: tensor cores (mma.sync, mma.cuh), 4 warps of 16 rows (queries
//         in the dq pass, keys in the dk/dv pass; 32-query tiles there
//         to keep the dk and dv accumulators in registers); ds split hi
//         + lo and p hi + mid + lo (dv's sums are unnormalized) as the A
//         operand of the products that consume them; operands read along
//         their columns are staged transposed.
//   fp32: CUDA cores, as flash_fwd.cu.
#include "flash_tile.cuh"
#include "mma.cuh"

namespace apex_port {

// ---- bf16: tensor cores --------------------------------------------------

constexpr int kMmaWarps = 4;          // 16 rows each
constexpr int kLdS = kHd + 8;         // bf16 row of a [row][d] tile (136)
constexpr int kLdKT = kTile + 8;      // bf16 row of a [d][64 keys] tile
constexpr int kQTile = 32;            // query rows per dk/dv step
constexpr int kLdQT = kQTile + 8;     // bf16 row of a [d][32 rows] tile

// Column sums over the 16 x 128 accumulator tiles of the 4 warps (rows g
// and g + 8 of acc[n][0..3]) times `mul`, into out[0..128). `red` is
// 4 x 128 floats of shared memory; the caller synchronizes before.
__device__ __forceinline__ void mma_column_sums(const float (&acc)[16][4],
                                                float mul, float* red,
                                                float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float c0 = acc[n][0] + acc[n][2];
    float c1 = acc[n][1] + acc[n][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {  // over g: lanes with equal t
      c0 += __shfl_xor_sync(kFullMask, c0, o);
      c1 += __shfl_xor_sync(kFullMask, c1, o);
    }
    if (lane < 4) {
      red[warp * kHd + n * 8 + 2 * lane] = c0;
      red[warp * kHd + n * 8 + 2 * lane + 1] = c1;
    }
  }
  __syncthreads();
  if (threadIdx.x < kHd) {
    float c = 0.f;
    for (int w = 0; w < kMmaWarps; ++w) c += red[w * kHd + threadIdx.x];
    out[threadIdx.x] = c * mul;
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ bias,
                            const bf16* __restrict__ o,
                            const float* __restrict__ lse,
                            const bf16* __restrict__ dout,
                            bf16* __restrict__ dqkv,
                            float* __restrict__ delta_out,
                            float* __restrict__ dbias_part, FlashShape sh,
                            float scale, float q_mul) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [64][kLdS], q * q_mul
  bf16* sdo = sq + kTile * kLdS;                  // [64][kLdS]
  bf16* sk = sdo + kTile * kLdS;                  // [64][kLdS]
  bf16* sv = sk + kTile * kLdS;                   // [64][kLdS]
  bf16* skt = sv + kTile * kLdS;                  // [128][kLdKT]: k^T
  float* slse = reinterpret_cast<float*>(skt + kHd * kLdKT);  // 64, x log2e
  float* sdelta = slse + kTile;                               // 64
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
  const int wr = warp * 16;
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * kHd;
  const int64_t os = static_cast<int64_t>(sh.nh) * kHd;
  const int64_t ohead = (static_cast<int64_t>(b) * sh.S * sh.nh + h) * kHd;

  stage_tile<kTile>(sq, kLdS, nullptr, 0, qkv_part(qkv, sh, b, h, 0), rs,
                    bias_part(bias, h, 0), q0, sh.S, nthreads, q_mul);
  stage_tile<kTile>(sdo, kLdS, nullptr, 0, dout + ohead, os,
                    static_cast<const bf16*>(nullptr), q0, sh.S, nthreads);
  __syncthreads();
  // delta = rowsum(do * o): each warp its 16 rows, 4 columns a lane
  for (int r = wr; r < wr + 16; ++r) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < sh.S) {
      const bf16* orow = o + ohead + row * os;
#pragma unroll
      for (int c = lane * 4; c < lane * 4 + 4; ++c)
        acc += __bfloat162float(sdo[r * kLdS + c]) * __bfloat162float(orow[c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const int64_t at = static_cast<int64_t>(bh) * sh.S + row;
      sdelta[r] = acc;
      slse[r] = row < sh.S ? lse[at] * kLog2e : 0.f;
      if (row < sh.S) delta_out[at] = acc;
    }
  }
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const uint32_t rkey[2] = {dropout_row_key(sh.seed, bh, row[0]),
                            dropout_row_key(sh.seed, bh, row[1])};
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = (sh.S + kTile - 1) / kTile;
  const int nk = sh.causal ? qt + 1 : ntiles;
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // delta/lse written; previous tile's readers done
    stage_tile<kTile>(sk, kLdS, skt, kLdKT, qkv_part(qkv, sh, b, h, 1), rs,
                      bias_part(bias, h, 1), kt * kTile, sh.S, nthreads);
    stage_tile<kTile>(sv, kLdS, nullptr, 0, qkv_part(qkv, sh, b, h, 2), rs,
                      bias_part(bias, h, 2), kt * kTile, sh.S, nthreads);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, sq, kLdS, wr, kk * 16);
      load_a(da, sdo, kLdS, wr, kk * 16);
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t kb[4], vb[4];
        load_b2(kb, sk, kLdS, nb * 8, kk * 16);
        load_b2(vb, sv, kLdS, nb * 8, kk * 16);
        mma_bf16(s[nb], qa, kb[0], kb[1]);
        mma_bf16(s[nb + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[nb], da, vb[0], vb[1]);
        mma_bf16(dp[nb + 1], da, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = wr + g + 8 * i;
        const int col = kt * kTile + nb * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (attends(sh, row[i], col)) {
          const float p = exp2f(s[nb][e] - slse[r]);
          float dpd = dp[nb][e];
          if (sh.drop)
            dpd = keep_bit(rkey[i], col, sh.thr) ? dpd * sh.keep_scale : 0.f;
          ds = p * (dpd - sdelta[r]);
        }
        s[nb][e] = ds;
      }
    // dq += ds k over the 4 k-steps of 16 keys; ds split hi + lo
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi[4], lo[4];
      c_to_a(s[2 * j], s[2 * j + 1], hi, lo);
#pragma unroll
      for (int n = 0; n < 16; n += 2) {
        uint32_t kb[4];
        load_b2(kb, skt, kLdKT, n * 8, j * 16);
        mma_bf16(acc[n], hi, kb[0], kb[1]);
        mma_bf16(acc[n], lo, kb[0], kb[1]);
        mma_bf16(acc[n + 1], hi, kb[2], kb[3]);
        mma_bf16(acc[n + 1], lo, kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= sh.S) continue;
    bf16* out = dqkv + (static_cast<int64_t>(b) * sh.S + row[i]) * rs +
                h * 3 * kHd;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) = pack_bf16(
          acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
  if (dbias_part != nullptr) {
    __syncthreads();  // sq is reused as the reduction buffer
    mma_column_sums(
        acc, scale, reinterpret_cast<float*>(sq),
        dbias_part + ((static_cast<int64_t>(b) * ntiles + qt) * sh.nh + h) *
                         3 * kHd);
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ qkv,
                             const bf16* __restrict__ bias,
                             const float* __restrict__ lse,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dqkv,
                             float* __restrict__ dbias_part, FlashShape sh,
                             float scale, float q_mul) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [64][kLdS]
  bf16* sv = sk + kTile * kLdS;                   // [64][kLdS]
  bf16* sq = sv + kTile * kLdS;                   // [32][kLdS], q * q_mul
  bf16* sdo = sq + kQTile * kLdS;                 // [32][kLdS]
  bf16* sqt = sdo + kQTile * kLdS;                // [128][kLdQT]: q^T
  bf16* sdot = sqt + kHd * kLdQT;                 // [128][kLdQT]: do^T
  float* slse = reinterpret_cast<float*>(sdot + kHd * kLdQT);  // x log2e
  float* sdelta = slse + kQTile;
  constexpr int nthreads = kMmaWarps * 32;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / sh.nh;
  const int h = bh % sh.nh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kTile;
  const int wr = warp * 16;
  const int64_t rs = static_cast<int64_t>(sh.nh) * 3 * kHd;
  const int64_t os = static_cast<int64_t>(sh.nh) * kHd;
  const int64_t ohead = (static_cast<int64_t>(b) * sh.S * sh.nh + h) * kHd;

  stage_tile<kTile>(sk, kLdS, nullptr, 0, qkv_part(qkv, sh, b, h, 1), rs,
                    bias_part(bias, h, 1), k0, sh.S, nthreads);
  stage_tile<kTile>(sv, kLdS, nullptr, 0, qkv_part(qkv, sh, b, h, 2), rs,
                    bias_part(bias, h, 2), k0, sh.S, nthreads);
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int nq = (sh.S + kQTile - 1) / kQTile;
  for (int qt = sh.causal ? k0 / kQTile : 0; qt < nq; ++qt) {
    const int q0 = qt * kQTile;
    __syncthreads();  // the previous tile's readers are done
    // sq: q * q_mul for the scores; sqt: the unscaled q for dk
    stage_tile<kQTile>(sq, kLdS, sqt, kLdQT, qkv_part(qkv, sh, b, h, 0), rs,
                       bias_part(bias, h, 0), q0, sh.S, nthreads, q_mul);
    stage_tile<kQTile>(sdo, kLdS, sdot, kLdQT, dout + ohead, os,
                       static_cast<const bf16*>(nullptr), q0, sh.S,
                       nthreads);
    if (threadIdx.x < kQTile) {
      const int row = q0 + threadIdx.x;
      const int64_t at = static_cast<int64_t>(bh) * sh.S + row;
      slse[threadIdx.x] = row < sh.S ? lse[at] * kLog2e : 0.f;
      sdelta[threadIdx.x] = row < sh.S ? delta[at] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T: 16 keys x 32 queries a warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sk, kLdS, wr, kk * 16);
      load_a(va, sv, kLdS, wr, kk * 16);
#pragma unroll
      for (int nb = 0; nb < 4; nb += 2) {
        uint32_t qb[4], db[4];
        load_b2(qb, sq, kLdS, nb * 8, kk * 16);
        load_b2(db, sdo, kLdS, nb * 8, kk * 16);
        mma_bf16(st[nb], ka, qb[0], qb[1]);
        mma_bf16(st[nb + 1], ka, qb[2], qb[3]);
        mma_bf16(dpt[nb], va, db[0], db[1]);
        mma_bf16(dpt[nb + 1], va, db[2], db[3]);
      }
    }
    // st <- dropped p^T, dpt <- ds^T
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int qc = nb * 8 + 2 * t + par;  // query within the tile
        const int q = q0 + qc;
        const uint32_t rk = dropout_row_key(sh.seed, bh, q);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + par;
          float pd = 0.f, ds = 0.f;
          if (attends(sh, q, key[i])) {
            const float p = exp2f(st[nb][e] - slse[qc]);
            float dpd = dpt[nb][e];
            pd = p;
            if (sh.drop) {
              const bool keep = keep_bit(rk, key[i], sh.thr);
              pd = keep ? p * sh.keep_scale : 0.f;
              dpd = keep ? dpd * sh.keep_scale : 0.f;
            }
            ds = p * (dpd - sdelta[qc]);
          }
          st[nb][e] = pd;
          dpt[nb][e] = ds;
        }
      }
    // dv += pd^T do and dk += ds^T q over the 2 k-steps of 16 queries.
    // pd is split in three (hi + mid + lo, ~24 bits): dv sums p over
    // every query that attends the key, unnormalized, so at a key most
    // queries attend (key 0 under causal masking, ~ln S of p mass) the
    // two-term split's 2^-18 of that mass reaches the bf16 output's
    // absolute tolerance; ds keeps two terms
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t phi[4], pmid[4], plo[4], shi[4], slo[4];
      c_to_a3(st[2 * j], st[2 * j + 1], phi, pmid, plo);
      c_to_a(dpt[2 * j], dpt[2 * j + 1], shi, slo);
#pragma unroll
      for (int n = 0; n < 16; n += 2) {
        uint32_t db[4], qb[4];
        load_b2(db, sdot, kLdQT, n * 8, j * 16);
        load_b2(qb, sqt, kLdQT, n * 8, j * 16);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_bf16(dv[n + u], phi, db[2 * u], db[2 * u + 1]);
          mma_bf16(dv[n + u], pmid, db[2 * u], db[2 * u + 1]);
          mma_bf16(dv[n + u], plo, db[2 * u], db[2 * u + 1]);
          mma_bf16(dk[n + u], shi, qb[2 * u], qb[2 * u + 1]);
          mma_bf16(dk[n + u], slo, qb[2 * u], qb[2 * u + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= sh.S) continue;
    bf16* out = dqkv + (static_cast<int64_t>(b) * sh.S + key[i]) * rs +
                h * 3 * kHd;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<uint32_t*>(out + kHd + n * 8 + 2 * t) = pack_bf16(
          dk[n][2 * i] * scale, dk[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(out + 2 * kHd + n * 8 + 2 * t) =
          pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
  if (dbias_part != nullptr) {
    const int ntiles = (sh.S + kTile - 1) / kTile;
    float* part = dbias_part +
                  ((static_cast<int64_t>(b) * ntiles + kt) * sh.nh + h) * 3 *
                      kHd;
    __syncthreads();  // sq is reused as the reduction buffer
    mma_column_sums(dk, scale, reinterpret_cast<float*>(sq), part + kHd);
    __syncthreads();
    mma_column_sums(dv, 1.f, reinterpret_cast<float*>(sq), part + 2 * kHd);
  }
}

static int launch_mma(const void* qkv, const void* bias, const void* o,
                      const void* lse, const void* dout, void* dqkv,
                      void* delta, void* dbias_part, const FlashShape& sh,
                      float scale, float q_mul, cudaStream_t stream) {
  const size_t smem_dq = sizeof(bf16) * (4 * kTile * kLdS + kHd * kLdKT) +
                         sizeof(float) * 2 * kTile;
  const size_t smem_dkv =
      sizeof(bf16) * (2 * kTile * kLdS + 2 * kQTile * kLdS + 2 * kHd * kLdQT) +
      sizeof(float) * 2 * kQTile;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sh.S + kTile - 1) / kTile, sh.B * sh.nh);
  flash_bwd_dq_mma_kernel<<<grid, kMmaWarps * 32, smem_dq, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(o), static_cast<const float*>(lse),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv),
      static_cast<float*>(delta), static_cast<float*>(dbias_part), sh, scale,
      q_mul);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_mma_kernel<<<grid, kMmaWarps * 32, smem_dkv, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<const float*>(delta), static_cast<bf16*>(dqkv),
      static_cast<float*>(dbias_part), sh, scale, q_mul);
  return 0;
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
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<grid, kThreads, smem_dkv, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const float*>(delta), static_cast<float*>(dqkv),
      static_cast<float*>(dbias_part), sh, scale, q_mul);
  return 0;
}

}  // namespace apex_port

// qkv, bias, o, lse as saved by flash_fwd; dout: contiguous (B, S, nh*hd)
// in qkv's dtype; dqkv: contiguous (B, S, nh, 3*hd) output; delta: an
// fp32 scratch of (B*nh, S); dbias_part: null without a bias, else an
// fp32 output of (B, ceil(S/64), nh, 3*hd) partial column sums. hd must
// be 128. q_mul is scale * log2(e) rounded to qkv's dtype.
extern "C" int flash_bwd(const void* qkv, const void* bias, const void* o,
                         const void* lse, const void* dout, void* dqkv,
                         void* delta, void* dbias_part, int B, int S, int nh,
                         int hd, float scale, float q_mul, int causal,
                         int dropout, unsigned seed, unsigned thr,
                         float keep_scale, int dtype, void* stream) {
  using namespace apex_port;
  if (hd != kHd) return static_cast<int>(cudaErrorInvalidValue);
  const FlashShape sh{B, S, nh, causal, dropout, seed, thr, keep_scale};
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kFloat32)
    rc = launch(qkv, bias, o, lse, dout, dqkv, delta, dbias_part, sh, scale,
                q_mul, st);
  else if (dtype == kBFloat16)
    rc = launch_mma(qkv, bias, o, lse, dout, dqkv, delta, dbias_part, sh,
                    scale, q_mul, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
