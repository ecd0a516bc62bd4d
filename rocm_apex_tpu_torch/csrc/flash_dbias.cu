// Gradient of the additive attention bias for Hopper (sm_90a):
// dbias[n] = sum over the hp heads sharing bias row n of
// ds = p (keep dp / (1 - rate) - delta), fp32 (nb, Sq, Sk).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:440 `_bwd_dbias_kernel`
// (`flash_attention(..., compute_dbias=True)`, `flash_attention_with_lse`
// with a learned bias: ALiBi slopes, relative positions). The TPU kernel
// keeps the head-group dimension innermost in its sequential grid, so one
// VMEM tile accumulates across heads; here one block per (bias row n,
// query tile of 64, key tile of 64) loops over the hp heads itself, keeps
// its 64 x 64 sum in registers, and writes it once: no atomics, no
// (B*H, Sq, Sk) intermediate. p and dp are recomputed per head from the
// saved lse and from delta (written by flash_unpacked_bwd's dq pass), with
// the forward's `masked_score` (flash_unpacked.cuh), so a masked key has
// ds = 0.
//
// Bound: operations. Each (head, tile) pair recomputes s = q k^T and
// dp = do v^T (4 D FLOP a score): the work of the dq pass without its
// third product, and slow by design, as the TPU kernel is.
//   bf16: tensor cores (mma.sync), 4 warps of 16 query rows.
//   fp32: CUDA cores (4 x 4 scores a thread).
#include "flash_unpacked.cuh"

namespace apex_port {
namespace unpacked {

// ---- bf16: tensor cores ----------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    dbias_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ lse,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ delta,
                     float* __restrict__ dbias, Strides qs, Strides ks,
                     Strides vs, Strides dos, Problem pb) {
  constexpr int kLdS = HD + 8;
  constexpr int kKs = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [64][kLdS], q * q_mul
  bf16* sdo = sq + kTile * kLdS;                  // [64][kLdS]
  bf16* sk = sdo + kTile * kLdS;                  // [64][kLdS]
  bf16* sv = sk + kTile * kLdS;                   // [64][kLdS]
  float* slse = reinterpret_cast<float*>(sv + kTile * kLdS);  // x log2 e
  float* sdelta = slse + kTile;
  const int kt = blockIdx.x;
  const int qt = blockIdx.y;
  const int n = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kTile;
  const int k0 = kt * kTile;
  const int wr = warp * 16;
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float db[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[nb][e] = 0.f;

  // a key tile wholly past the causal bound of this query tile is 0
  const bool live = !(pb.causal && k0 > min(q0 + kTile, pb.Sq) - 1);
  for (int hh = 0; live && hh < pb.hp; ++hh) {
    const int bh = n * pb.hp + hh;
    __syncthreads();  // the previous head's readers are done
    stage_bf16<HD, kTile>(sq, kLdS, head(q, qs, bh, pb.H), qs.s,
                          q0, pb.Sq, pb.q_mul, kMmaThreads);
    stage_bf16<HD, kTile>(sdo, kLdS, head(dout, dos, bh, pb.H),
                          dos.s, q0, pb.Sq, 1.f, kMmaThreads);
    stage_bf16<HD, kTile>(sk, kLdS, head(k, ks, bh, pb.H), ks.s,
                          k0, pb.Sk, 1.f, kMmaThreads);
    stage_bf16<HD, kTile>(sv, kLdS, head(v, vs, bh, pb.H), vs.s,
                          k0, pb.Sk, 1.f, kMmaThreads);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      const int64_t at = static_cast<int64_t>(bh) * pb.Sq + r;
      slse[threadIdx.x] = r < pb.Sq ? lse[at] * kLog2e : 0.f;
      sdelta[threadIdx.x] = r < pb.Sq ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
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
    const int len = kv_len(pb, bh);
    const float* brow[2] = {bias_row(pb, bh, row[0]),
                            bias_row(pb, bh, row[1])};
    const uint32_t rkey[2] = {dropout_row_key(pb.seed, bh, row[0]),
                              dropout_row_key(pb.seed, bh, row[1])};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = wr + g + 8 * i;
        const int col = k0 + nb * 8 + 2 * t + (e & 1);
        const float sc = masked_score(pb, len, brow[i], s[nb][e], row[i], col);
        const float p = exp2f(sc - slse[r]);
        float dpd = dp[nb][e];
        if (pb.drop)
          dpd = keep_bit(rkey[i], col, pb.thr) ? dpd * pb.keep_scale : 0.f;
        db[nb][e] += p * (dpd - sdelta[r]);
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= pb.Sq) continue;
    float* out = dbias + (static_cast<int64_t>(n) * pb.Sq + row[i]) * pb.Sk;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = k0 + nb * 8 + 2 * t + u;
        if (col < pb.Sk) out[col] = db[nb][2 * i + u];
      }
  }
}

template <int HD>
int launch_mma(const void* const* p, const int64_t* st, const Problem& pb,
               int nb, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * 4 * kTile * (HD + 8) + sizeof(float) * 2 * kTile;
  const cudaError_t e = cudaFuncSetAttribute(
      dbias_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((pb.Sk + kTile - 1) / kTile, (pb.Sq + kTile - 1) / kTile,
                  nb);
  dbias_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const bf16*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<float*>(const_cast<void*>(p[6])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), pb);
  return 0;
}

// ---- fp32: CUDA cores ------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dbias_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout,
                     const float* __restrict__ delta,
                     float* __restrict__ dbias, Strides qs, Strides ks,
                     Strides vs, Strides dos, Problem pb) {
  constexpr int kLd = HD + 1;
  extern __shared__ float sm[];
  float* sq = sm;                  // 64 x kLd, q * q_mul
  float* sdo = sq + kTile * kLd;   // 64 x kLd
  float* sk = sdo + kTile * kLd;   // 64 x kLd
  float* sv = sk + kTile * kLd;    // 64 x kLd
  float* slse = sv + kTile * kLd;  // 64, x log2 e
  float* sdelta = slse + kTile;    // 64
  const int kt = blockIdx.x;
  const int qt = blockIdx.y;
  const int n = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;
  const int k0 = kt * kTile;
  float db[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) db[i][j] = 0.f;

  const bool live = !(pb.causal && k0 > min(q0 + kTile, pb.Sq) - 1);
  for (int hh = 0; live && hh < pb.hp; ++hh) {
    const int bh = n * pb.hp + hh;
    __syncthreads();
    stage_f32<HD>(sq, kLd, head(q, qs, bh, pb.H), qs.s, q0, pb.Sq, pb.q_mul);
    stage_f32<HD>(sdo, kLd, head(dout, dos, bh, pb.H), dos.s, q0, pb.Sq,
                  1.f);
    stage_f32<HD>(sk, kLd, head(k, ks, bh, pb.H), ks.s, k0, pb.Sk, 1.f);
    stage_f32<HD>(sv, kLd, head(v, vs, bh, pb.H), vs.s, k0, pb.Sk, 1.f);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      const int64_t at = static_cast<int64_t>(bh) * pb.Sq + r;
      slse[threadIdx.x] = r < pb.Sq ? lse[at] * kLog2e : 0.f;
      sdelta[threadIdx.x] = r < pb.Sq ? delta[at] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
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
    const int len = kv_len(pb, bh);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      const float* brow = bias_row(pb, bh, row);
      const uint32_t rk = dropout_row_key(pb.seed, bh, row);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float sc = masked_score(pb, len, brow, s[i][j], row, col);
        const float p = exp2f(sc - slse[r]);
        float dpd = dp[i][j];
        if (pb.drop)
          dpd = keep_bit(rk, col, pb.thr) ? dpd * pb.keep_scale : 0.f;
        db[i][j] += p * (dpd - sdelta[r]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= pb.Sq) continue;
    float* out = dbias + (static_cast<int64_t>(n) * pb.Sq + row) * pb.Sk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < pb.Sk) out[col] = db[i][j];
    }
  }
}

template <int HD>
int launch_f32(const void* const* p, const int64_t* st, const Problem& pb,
               int nb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * kTile * (HD + 1) + 2 * kTile);
  const cudaError_t e = cudaFuncSetAttribute(
      dbias_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((pb.Sk + kTile - 1) / kTile, (pb.Sq + kTile - 1) / kTile,
                  nb);
  dbias_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<float*>(const_cast<void*>(p[6])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), pb);
  return 0;
}

}  // namespace unpacked
}  // namespace apex_port

// q, k, v, lse, dout as flash_unpacked_bwd took them; delta: the fp32
// (B*H, Sq) rowsum(do * o) - dlse its dq pass wrote; dbias: the fp32
// contiguous (nb, Sq, Sk) output. st[0..11]: the (batch, head, row)
// element strides of q, k, v, dout. bias (the forward's, needed for p) is
// required. The rest as flash_unpacked_fwd.
extern "C" int flash_dbias(const void* q, const void* k, const void* v,
                           const void* lse, const void* dout,
                           const void* delta, void* dbias, const int64_t* st,
                           const void* bias, int nb, const void* lens, int B,
                           int H, int Sq, int Sk, int hd, int causal,
                           int dropout, unsigned seed, unsigned thr,
                           float keep_scale, float q_mul, int dtype,
                           void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  const Problem pb = make_problem(B, H, Sq, Sk, causal, lens, bias, nb,
                                  dropout, seed, thr, keep_scale, q_mul, 1.f);
  if (bias == nullptr || nb <= 0 || nb > 65535 || (B * H) % nb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* p[7] = {q, k, v, lse, dout, delta, dbias};
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kBFloat16 && hd == 128)
    rc = launch_mma<128>(p, st, pb, nb, s);
  else if (dtype == kBFloat16 && hd == 64)
    rc = launch_mma<64>(p, st, pb, nb, s);
  else if (dtype == kFloat32 && hd == 128)
    rc = launch_f32<128>(p, st, pb, nb, s);
  else if (dtype == kFloat32 && hd == 64)
    rc = launch_f32<64>(p, st, pb, nb, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
