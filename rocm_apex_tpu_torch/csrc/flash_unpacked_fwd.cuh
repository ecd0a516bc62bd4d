// The unpacked flash-attention forward's CUDA-core and mma.sync kernels,
// included by flash_unpacked_fwd.cu (its fp32 form) and, with kSeg,
// flash_segments_fwd.cu (segment attention, bf16 and fp32). The unpacked
// bf16 form runs on the wgmma pipe of flash_fwd_pipe.cuh.
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:170 `_fwd_kernel` as `_fwd`
// (:242) runs it: masked BERT (the -1e30 padding bias), whole-prompt GPT
// prefill (causal), `flash_attention_varlen` and `_with_lse`. One block per
// (query tile of 64 rows, b*h): the q tile is staged once with scale *
// log2(e) folded in, then an online softmax in base 2 walks key tiles up
// to the row block's causal and length bound (so S has no ceiling), with
// the scores masked by flash_unpacked.cuh's `masked_score`. As on the TPU
// the normalizer l sums the UNdropped probabilities and dropout zeroes
// entries of the normalized matrix; the keep bit of (row, key) is
// dropout.cuh's hash with stream b*h, as the packed kernels draw it.
// Writes o through its strides (the model passes a (B, S, H, D) memory
// layout, the output projection's) and the natural-log lse (B*H, Sq).
//
// Bound: operations. At masked BERT-Large (B 8, 8 heads, S 512, D 128)
// one layer's forward is 8.6 GFLOP against 0.05 GB of q/k/v/o and 8 MiB
// of bias.
//   bf16 (segment attention; the unpacked form is the pipe's): both
//         products on the tensor cores (mma.sync m16n8k16, fp32
//         accumulate), 4 warps of 16 query rows; the scores stay in
//         registers and become the A operand of p @ v split hi + lo, so p
//         keeps fp32-level precision.
//   fp32: the products on the CUDA cores (4 x 4 score and 4 x D/16 output
//         register tiles a thread); held to the fp32 rate.
// One tile in flight, a barrier between load and use.
//
// With kSeg (flash_segments_fwd.cu) the same body serves segment attention
// over a packed (H, total, D) stream: a key of another segment is masked as
// well, and a block visits only the key tiles whose segment-id range meets
// its own (`for_tiles`), gathered by a ballot so dead tiles cost no
// barrier.
#pragma once

#include "flash_unpacked.cuh"

namespace apex_port {
namespace unpacked {

// ---- bf16: tensor cores ----------------------------------------------------

template <int HD, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, Strides qs, Strides ks,
                   Strides vs, Strides os, Problem pb) {
  constexpr int kLdS = HD + 8;     // bf16 row of a [row][d] tile
  constexpr int kLdT = kTile + 8;  // bf16 row of a [d][key] tile
  constexpr int kKs = HD / 16;     // k-steps over d
  constexpr int kNo = HD / 8;      // 8-column blocks of o
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [64][kLdS], q * q_mul
  bf16* sk = sq + kTile * kLdS;                   // [64][kLdS]
  bf16* svt = sk + kTile * kLdS;                  // [HD][kLdT]: v^T
  // segment attention: the key tile's ids, the live-tile list and counts
  int* sseg = reinterpret_cast<int*>(svt + HD * kLdT);
  int* slist = sseg + kTile;
  int* scount = slist + kMmaThreads;
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kTile;
  const int wr = warp * 16;
  const bf16* kh = head(k, ks, bh, pb.H);
  const bf16* vh = head(v, vs, bh, pb.H);

  stage_bf16<HD, kTile>(sq, kLdS, nullptr, 0, head(q, qs, bh, pb.H), qs.s,
                        q0, pb.Sq, pb.q_mul, kMmaThreads);
  __syncthreads();
  uint32_t qa[kKs][4];
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk) load_a(qa[kk], sq, kLdS, wr, kk * 16);
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const float* brow[2] = {bias_row(pb, bh, row[0]), bias_row(pb, bh, row[1])};
  const uint32_t rkey[2] = {dropout_row_key(pb.seed, bh, row[0]),
                            dropout_row_key(pb.seed, bh, row[1])};
  const int len = kv_len(pb, bh);
  int rseg[2] = {0, 0};
  int2 qrange = make_int2(0, 0);
  if constexpr (kSeg) {
    rseg[0] = seg_id(pb, row[0]);
    rseg[1] = seg_id(pb, row[1]);
    qrange = tile_range(pb, q0, kTile);
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kend = key_end(pb, bh, min(q0 + kTile, pb.Sq) - 1);
  const int nk = (kend + kTile - 1) / kTile;
  auto live = [&](int kt) {
    return ranges_meet(qrange, tile_range(pb, kt * kTile, kTile));
  };
  auto tile = [&](int kt) {
    __syncthreads();  // the previous tile's readers of sk/svt are done
    stage_bf16<HD, kTile>(sk, kLdS, nullptr, 0, kh, ks.s, kt * kTile, pb.Sk,
                          1.f, kMmaThreads);
    stage_bf16<HD, kTile>(nullptr, 0, svt, kLdT, vh, vs.s, kt * kTile, pb.Sk,
                          1.f, kMmaThreads);
    if constexpr (kSeg) stage_seg(pb, sseg, kt * kTile, kTile);
    __syncthreads();

    // s = (q * q_mul) k^T: 16 rows x 64 keys = 8 column blocks of 8 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk)
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
        const int i = e >> 1;
        const int c = nb * 8 + 2 * t + (e & 1);
        const int col = kt * kTile + c;
        const float sc = masked_score(pb, len, brow[i], s[nb][e], row[i], col,
                                      !kSeg || sseg[c] == rseg[i]);
        s[nb][e] = sc;
        tmax[i] = fmaxf(tmax[i], sc);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFullMask, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFullMask, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m[e >> 1]);  // 0 for masked keys
        psum[e >> 1] += p;
        float pd = p;
        if (pb.drop) {
          const int col = kt * kTile + nb * 8 + 2 * t + (e & 1);
          pd = keep_bit(rkey[e >> 1], col, pb.thr) ? p * pb.keep_scale : 0.f;
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
    for (int n = 0; n < kNo; ++n) {
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
      for (int n = 0; n < kNo; n += 2) {
        uint32_t vb[4];
        load_b2(vb, svt, kLdT, n * 8, j * 16);
        mma_bf16(acc[n], hi, vb[0], vb[1]);
        mma_bf16(acc[n], lo, vb[0], vb[1]);
        mma_bf16(acc[n + 1], hi, vb[2], vb[3]);
        mma_bf16(acc[n + 1], lo, vb[2], vb[3]);
      }
    }
  };
  for_tiles<kSeg, kMmaThreads>(0, nk, slist, scount, live, tile);

  bf16* oh = head(o, os, bh, pb.H);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= pb.Sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    bf16* orow = oh + row[i] * os.s;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i] / safe_l, acc[n][2 * i + 1] / safe_l);
    if (t == 0)
      lse[static_cast<int64_t>(bh) * pb.Sq + row[i]] =
          (m[i] + log2f(safe_l)) * kLn2;
  }
}

template <int HD, bool kSeg>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, const int64_t* st, const Problem& pb,
               cudaStream_t stream) {
  constexpr int kLdS = HD + 8;
  constexpr int kLdT = kTile + 8;
  const size_t smem = sizeof(bf16) * (2 * kTile * kLdS + HD * kLdT) +
                      (kSeg ? sizeof(int) * seg_smem_ints<kMmaThreads>() : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_mma_kernel<HD, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((pb.Sq + kTile - 1) / kTile, pb.B * pb.H);
  fwd_mma_kernel<HD, kSeg><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), pb);
  return 0;
}

// ---- fp32: CUDA cores ------------------------------------------------------

template <int HD, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, Strides qs, Strides ks,
                   Strides vs, Strides os, Problem pb) {
  constexpr int kLd = HD + 1;  // padded operand row: column reads spread
  constexpr int kNj = HD / 16;  // output columns a thread owns
  extern __shared__ float sm[];
  float* sq = sm;                // 64 x kLd, q * q_mul
  float* sk = sq + kTile * kLd;  // 64 x kLd
  float* sv = sk + kTile * kLd;  // 64 x HD
  float* sp = sv + kTile * HD;   // 64 x kLdP, dropped probabilities
  int* sseg = reinterpret_cast<int*>(sp + kTile * kLdP);  // segment ids
  int* slist = sseg + kTile;
  int* scount = slist + kThreads;
  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;
  const float* kh = head(k, ks, bh, pb.H);
  const float* vh = head(v, vs, bh, pb.H);
  const int len = kv_len(pb, bh);

  stage_f32<HD>(sq, kLd, head(q, qs, bh, pb.H), qs.s, q0, pb.Sq, pb.q_mul);

  float m[4], l[4], acc[4][kNj];
  uint32_t key[4];
  const float* brow[4];
  int rseg[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
    key[i] = dropout_row_key(pb.seed, bh, row);
    brow[i] = bias_row(pb, bh, row);
    if constexpr (kSeg) rseg[i] = seg_id(pb, row);
#pragma unroll
    for (int j = 0; j < kNj; ++j) acc[i][j] = 0.f;
  }
  int2 qrange = make_int2(0, 0);
  if constexpr (kSeg) qrange = tile_range(pb, q0, kTile);

  const int kend = key_end(pb, bh, min(q0 + kTile, pb.Sq) - 1);
  const int nk = (kend + kTile - 1) / kTile;
  auto live = [&](int kt) {
    return ranges_meet(qrange, tile_range(pb, kt * kTile, kTile));
  };
  auto tile = [&](int kt) {
    __syncthreads();  // the previous tile's readers of sk/sv/sp are done
    stage_f32<HD>(sk, kLd, kh, ks.s, kt * kTile, pb.Sk, 1.f);
    stage_f32<HD>(sv, HD, vh, vs.s, kt * kTile, pb.Sk, 1.f);
    if constexpr (kSeg) stage_seg(pb, sseg, kt * kTile, kTile);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
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
        const int col = kt * kTile + tx + 16 * j;
        s[i][j] = masked_score(pb, len, brow[i], s[i][j], row, col,
                               !kSeg || sseg[tx + 16 * j] == rseg[i]);
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tmax));
      const float corr = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        const float p = exp2f(s[i][j] - m_new);  // 0 for masked keys
        psum += p;
        float pd = p;
        if (pb.drop)
          pd = keep_bit(key[i], col, pb.thr) ? p * pb.keep_scale : 0.f;
        sp[(ty + 16 * i) * kLdP + tx + 16 * j] = pd;
      }
      l[i] = l[i] * corr + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kNj; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], vv[kNj];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kNj; ++j) vv[j] = sv[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNj; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  };
  for_tiles<kSeg, kThreads>(0, nk, slist, scount, live, tile);

  float* oh = head(o, os, bh, pb.H);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= pb.Sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int j = 0; j < kNj; ++j)
      oh[row * os.s + tx + 16 * j] = acc[i][j] / safe_l;
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * pb.Sq + row] =
          (m[i] + log2f(safe_l)) * kLn2;
  }
}

template <int HD, bool kSeg>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, const int64_t* st, const Problem& pb,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kTile * (HD + 1) + kTile * HD + kTile * kLdP) +
      (kSeg ? sizeof(int) * seg_smem_ints<kThreads>() : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_f32_kernel<HD, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((pb.Sq + kTile - 1) / kTile, pb.B * pb.H);
  fwd_f32_kernel<HD, kSeg><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), pb);
  return 0;
}

// fp32 on the CUDA cores and, for segment attention, bf16 on mma.sync
// (the unpacked bf16 form is the pipe's); head_dim 64 or 128.
template <bool kSeg>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const int64_t* st, const Problem& pb, int hd,
               int dtype, cudaStream_t s) {
  if constexpr (kSeg) {
    if (dtype == kBFloat16 && hd == 128)
      return launch_mma<128, kSeg>(q, k, v, o, lse, st, pb, s);
    if (dtype == kBFloat16 && hd == 64)
      return launch_mma<64, kSeg>(q, k, v, o, lse, st, pb, s);
  }
  if (dtype == kFloat32 && hd == 128)
    return launch_f32<128, kSeg>(q, k, v, o, lse, st, pb, s);
  if (dtype == kFloat32 && hd == 64)
    return launch_f32<64, kSeg>(q, k, v, o, lse, st, pb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace unpacked
}  // namespace apex_port

