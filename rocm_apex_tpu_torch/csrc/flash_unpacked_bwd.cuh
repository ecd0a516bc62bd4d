// The unpacked flash-attention backward's CUDA-core and mma.sync
// kernels: the fp32 form of flash_unpacked_bwd.cu (its bf16 form runs on
// the wgmma pipe of flash_bwd_pipe.cuh) and both forms of segment
// attention (kSeg, flash_segments_bwd.cu).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:316 `_bwd_dkv_kernel` and
// :384 `_bwd_dq_kernel` as `_bwd` (:502) runs them. Blocks run in no order
// on Hopper, so the TPU's sequential grids become two launches with no
// atomics, and results repeat run to run:
//
//   dq pass   one block per (query tile of 64, b*h): delta = rowsum(do * o)
//             - dlse of its rows (the XLA code around `_bwd`'s calls,
//             :513-519; written for the dk/dv pass and the dbias kernel),
//             then for each key tile up to the causal and length bound
//             p = exp2(s - lse log2 e), dp = do v^T,
//             ds = p (keep dp / (1 - rate) - delta), dq += ds k;
//   dkv pass  one block per (key tile of 64, b*h): for each query tile
//             from the causal bound on, the same p and ds, then
//             dv += (keep p / (1 - rate))^T do and dk += ds^T q.
//
// s is flash_unpacked.cuh's `masked_score`, the forward's, recomputed from
// the staged q * q_mul; dk uses the unscaled q; the keep bits are
// regenerated from dropout.cuh's hash (stream b*h). dq and dk take the
// scale once at the end, as the JAX kernels do. All outputs are written
// through their strides.
//
// Bound: operations (2.5x the forward's products: s, dp, dq in one pass,
// s, dp, dv, dk in the other).
//   bf16: tensor cores (mma.sync), 4 warps of 16 rows (queries in the dq
//         pass, keys in the dk/dv pass, which steps over 32-query tiles to
//         keep its dk and dv accumulators in registers); p_drop and ds
//         rounded to bf16 as the A operand of the products that consume
//         them, as the JAX kernels round them;
//         operands read along their columns are staged transposed. Only
//         segment attention takes this form now.
//   fp32: CUDA cores, as flash_unpacked_fwd.cuh.
//
// With kSeg (flash_segments_bwd.cu) the same bodies serve segment
// attention over a packed (H, total, D) stream: a key of another segment is
// masked as well, and each pass visits only the tiles whose segment-id
// ranges meet its own tile's (`for_tiles`).
#pragma once

#include "flash_unpacked.cuh"

namespace apex_port {
namespace unpacked {

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kQTile = 32;  // query rows per step of the bf16 dk/dv pass

template <int HD, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const float* __restrict__ lse,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ dlse, bf16* __restrict__ dq,
                  float* __restrict__ delta_out, Strides qs, Strides ks,
                  Strides vs, Strides os, Strides dos, Strides dqs,
                  Problem pb) {
  constexpr int kLdS = HD + 8;
  constexpr int kLdKT = kTile + 8;
  constexpr int kKs = HD / 16;
  constexpr int kNo = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [64][kLdS], q * q_mul
  bf16* sdo = sq + kTile * kLdS;                  // [64][kLdS]
  bf16* sk = sdo + kTile * kLdS;                  // [64][kLdS]
  bf16* sv = sk + kTile * kLdS;                   // [64][kLdS]
  bf16* skt = sv + kTile * kLdS;                  // [HD][kLdKT]: k^T
  float* slse = reinterpret_cast<float*>(skt + HD * kLdKT);  // x log2 e
  float* sdelta = slse + kTile;
  int* sseg = reinterpret_cast<int*>(sdelta + kTile);  // segment attention
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
  stage_bf16<HD, kTile>(sdo, kLdS, nullptr, 0, head(dout, dos, bh, pb.H),
                        dos.s, q0, pb.Sq, 1.f, kMmaThreads);
  __syncthreads();
  row_delta<HD>(sdo, kLdS, head(o, os, bh, pb.H), os.s, lse, dlse, delta_out,
                sdelta, slse, bh, q0, pb.Sq, kMmaThreads / 32);
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
    __syncthreads();  // delta/lse written; the previous tile's readers done
    stage_bf16<HD, kTile>(sk, kLdS, skt, kLdKT, kh, ks.s, kt * kTile, pb.Sk,
                          1.f, kMmaThreads);
    stage_bf16<HD, kTile>(sv, kLdS, nullptr, 0, vh, vs.s, kt * kTile, pb.Sk,
                          1.f, kMmaThreads);
    if constexpr (kSeg) stage_seg(pb, sseg, kt * kTile, kTile);
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
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = wr + g + 8 * i;
        const int c = nb * 8 + 2 * t + (e & 1);
        const int col = kt * kTile + c;
        const float sc = masked_score(pb, len, brow[i], s[nb][e], row[i], col,
                                      !kSeg || sseg[c] == rseg[i]);
        const float p = exp2f(sc - slse[r]);  // 0 for masked keys
        float dpd = dp[nb][e];
        if (pb.drop)
          dpd = keep_bit(rkey[i], col, pb.thr) ? dpd * pb.keep_scale : 0.f;
        s[nb][e] = p * (dpd - sdelta[r]);
      }
    // dq += ds k over the 4 k-steps of 16 keys, ds rounded to bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t da[4];
      c_to_a(s[2 * j], s[2 * j + 1], da);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        uint32_t kb[4];
        load_b2(kb, skt, kLdKT, n * 8, j * 16);
        mma_bf16(acc[n], da, kb[0], kb[1]);
        mma_bf16(acc[n + 1], da, kb[2], kb[3]);
      }
    }
  };
  for_tiles<kSeg, kMmaThreads>(0, nk, slist, scount, live, tile);

  bf16* dqh = head(dq, dqs, bh, pb.H);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= pb.Sq) continue;
    bf16* out = dqh + row[i] * dqs.s;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) = pack_bf16(
          acc[n][2 * i] * pb.scale, acc[n][2 * i + 1] * pb.scale);
  }
}

template <int HD, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                   Strides dos, Strides dks, Strides dvs, Problem pb) {
  constexpr int kLdS = HD + 8;
  constexpr int kLdQT = kQTile + 8;
  constexpr int kKs = HD / 16;
  constexpr int kNo = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [64][kLdS]
  bf16* sv = sk + kTile * kLdS;                   // [64][kLdS]
  bf16* sq = sv + kTile * kLdS;                   // [32][kLdS], q * q_mul
  bf16* sdo = sq + kQTile * kLdS;                 // [32][kLdS]
  bf16* sqt = sdo + kQTile * kLdS;                // [HD][kLdQT]: q^T
  bf16* sdot = sqt + HD * kLdQT;                  // [HD][kLdQT]: do^T
  float* slse = reinterpret_cast<float*>(sdot + HD * kLdQT);  // x log2 e
  float* sdelta = slse + kQTile;
  int* sseg = reinterpret_cast<int*>(sdelta + kQTile);  // segment attention
  int* slist = sseg + kTile;
  int* scount = slist + kMmaThreads;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kTile;
  const int wr = warp * 16;
  const bf16* qh = head(q, qs, bh, pb.H);
  const bf16* doh = head(dout, dos, bh, pb.H);
  const int len = kv_len(pb, bh);

  stage_bf16<HD, kTile>(sk, kLdS, nullptr, 0, head(k, ks, bh, pb.H), ks.s,
                        k0, pb.Sk, 1.f, kMmaThreads);
  stage_bf16<HD, kTile>(sv, kLdS, nullptr, 0, head(v, vs, bh, pb.H), vs.s,
                        k0, pb.Sk, 1.f, kMmaThreads);
  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
  int kseg[2] = {0, 0};
  int2 krange = make_int2(0, 0);
  if constexpr (kSeg) {
    kseg[0] = seg_id(pb, key[0]);
    kseg[1] = seg_id(pb, key[1]);
    krange = tile_range(pb, k0, kTile);
  }
  float dka[kNo][4], dva[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // query tiles that may attend this key tile: none past the length
  // bound; when causal, none before row k0
  const int nq = k0 < len ? (pb.Sq + kQTile - 1) / kQTile : 0;
  auto live = [&](int qt) {
    return ranges_meet(krange, tile_range(pb, qt * kQTile, kQTile));
  };
  auto tile = [&](int qt) {
    const int q0 = qt * kQTile;
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<HD, kQTile>(sq, kLdS, sqt, kLdQT, qh, qs.s, q0, pb.Sq,
                           pb.q_mul, kMmaThreads);
    stage_bf16<HD, kQTile>(sdo, kLdS, sdot, kLdQT, doh, dos.s, q0, pb.Sq,
                           1.f, kMmaThreads);
    if (threadIdx.x < kQTile) {
      const int row = q0 + threadIdx.x;
      const int64_t at = static_cast<int64_t>(bh) * pb.Sq + row;
      slse[threadIdx.x] = row < pb.Sq ? lse[at] * kLog2e : 0.f;
      sdelta[threadIdx.x] = row < pb.Sq ? delta[at] : 0.f;
      if constexpr (kSeg) sseg[threadIdx.x] = seg_id(pb, row);
    }
    __syncthreads();

    // s^T = k (q * q_mul)^T and dp^T = v do^T: 16 keys x 32 queries a warp
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
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
        const int qrow = q0 + qc;
        const uint32_t rk = dropout_row_key(pb.seed, bh, qrow);
        const float* brow = bias_row(pb, bh, qrow);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 2 * i + par;
          const float sc =
              masked_score(pb, len, brow, st[nb][e], qrow, key[i],
                           !kSeg || sseg[qc] == kseg[i]);
          const float p = exp2f(sc - slse[qc]);  // 0 for masked keys
          float pd = p, dpd = dpt[nb][e];
          if (pb.drop) {
            const bool keep = keep_bit(rk, key[i], pb.thr);
            pd = keep ? p * pb.keep_scale : 0.f;
            dpd = keep ? dpd * pb.keep_scale : 0.f;
          }
          st[nb][e] = pd;
          dpt[nb][e] = p * (dpd - sdelta[qc]);
        }
      }
    // dv += pd^T do and dk += ds^T q over the 2 k-steps of 16 queries,
    // pd and ds rounded to bf16
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t pa[4], da[4];
      c_to_a(st[2 * j], st[2 * j + 1], pa);
      c_to_a(dpt[2 * j], dpt[2 * j + 1], da);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        uint32_t db[4], qb[4];
        load_b2(db, sdot, kLdQT, n * 8, j * 16);
        load_b2(qb, sqt, kLdQT, n * 8, j * 16);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_bf16(dva[n + u], pa, db[2 * u], db[2 * u + 1]);
          mma_bf16(dka[n + u], da, qb[2 * u], qb[2 * u + 1]);
        }
      }
    }
  };
  for_tiles<kSeg, kMmaThreads>(pb.causal ? k0 / kQTile : 0, nq, slist, scount,
                               live, tile);

  bf16* dkh = head(dk, dks, bh, pb.H);
  bf16* dvh = head(dv, dvs, bh, pb.H);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= pb.Sk) continue;
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
      *reinterpret_cast<uint32_t*>(dkh + key[i] * dks.s + n * 8 + 2 * t) =
          pack_bf16(dka[n][2 * i] * pb.scale, dka[n][2 * i + 1] * pb.scale);
      *reinterpret_cast<uint32_t*>(dvh + key[i] * dvs.s + n * 8 + 2 * t) =
          pack_bf16(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

template <int HD, bool kSeg>
int launch_mma(const void* const* p, const int64_t* st, const Problem& pb,
               cudaStream_t stream) {
  constexpr int kLdS = HD + 8;
  constexpr size_t kSegBytes =
      kSeg ? sizeof(int) * seg_smem_ints<kMmaThreads>() : 0;
  const size_t smem_dq = sizeof(bf16) * (4 * kTile * kLdS + HD * (kTile + 8)) +
                         sizeof(float) * 2 * kTile + kSegBytes;
  const size_t smem_dkv =
      sizeof(bf16) *
          (2 * kTile * kLdS + 2 * kQTile * kLdS + 2 * HD * (kQTile + 8)) +
      sizeof(float) * 2 * kQTile + kSegBytes;
  cudaError_t e = cudaFuncSetAttribute(
      dq_mma_kernel<HD, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dkv_mma_kernel<HD, kSeg>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bh = pb.B * pb.H;
  dq_mma_kernel<HD, kSeg><<<dim3((pb.Sq + kTile - 1) / kTile, bh), kMmaThreads,
                      smem_dq, stream>>>(
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const bf16*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const bf16*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<bf16*>(const_cast<void*>(p[7])),
      static_cast<float*>(const_cast<void*>(p[10])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), pb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_mma_kernel<HD, kSeg><<<dim3((pb.Sk + kTile - 1) / kTile, bh), kMmaThreads,
                       smem_dkv, stream>>>(
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const float*>(p[4]),
      static_cast<const bf16*>(p[5]), static_cast<const float*>(p[10]),
      static_cast<bf16*>(const_cast<void*>(p[8])),
      static_cast<bf16*>(const_cast<void*>(p[9])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 4),
      strides_at(st, 6), strides_at(st, 7), pb);
  return 0;
}

// ---- fp32: CUDA cores ------------------------------------------------------

template <int HD, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ lse,
                  const float* __restrict__ dout,
                  const float* __restrict__ dlse, float* __restrict__ dq,
                  float* __restrict__ delta_out, Strides qs, Strides ks,
                  Strides vs, Strides os, Strides dos, Strides dqs,
                  Problem pb) {
  constexpr int kLd = HD + 1;
  constexpr int kNj = HD / 16;
  extern __shared__ float sm[];
  float* sq = sm;                  // 64 x kLd, q * q_mul
  float* sdo = sq + kTile * kLd;   // 64 x kLd
  float* sk = sdo + kTile * kLd;   // 64 x kLd
  float* sv = sk + kTile * kLd;    // 64 x kLd
  float* sds = sv + kTile * kLd;   // 64 x kLdP
  float* slse = sds + kTile * kLdP;  // 64, x log2 e
  float* sdelta = slse + kTile;      // 64
  int* sseg = reinterpret_cast<int*>(sdelta + kTile);  // segment attention
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
  stage_f32<HD>(sdo, kLd, head(dout, dos, bh, pb.H), dos.s, q0, pb.Sq, 1.f);
  __syncthreads();
  row_delta<HD>(sdo, kLd, head(o, os, bh, pb.H), os.s, lse, dlse, delta_out,
                sdelta, slse, bh, q0, pb.Sq, kThreads / 32);

  float acc[4][kNj];
  uint32_t key[4];
  const float* brow[4];
  int rseg[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
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
    __syncthreads();
    stage_f32<HD>(sk, kLd, kh, ks.s, kt * kTile, pb.Sk, 1.f);
    stage_f32<HD>(sv, kLd, vh, vs.s, kt * kTile, pb.Sk, 1.f);
    if constexpr (kSeg) stage_seg(pb, sseg, kt * kTile, kTile);
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        const float sc = masked_score(pb, len, brow[i], s[i][j], row, col,
                                      !kSeg || sseg[tx + 16 * j] == rseg[i]);
        const float p = exp2f(sc - slse[r]);
        float dpd = dp[i][j];
        if (pb.drop)
          dpd = keep_bit(key[i], col, pb.thr) ? dpd * pb.keep_scale : 0.f;
        sds[r * kLdP + tx + 16 * j] = p * (dpd - sdelta[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4], kv[kNj];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sds[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kNj; ++j) kv[j] = sk[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNj; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  };
  for_tiles<kSeg, kThreads>(0, nk, slist, scount, live, tile);

  float* dqh = head(dq, dqs, bh, pb.H);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= pb.Sq) continue;
#pragma unroll
    for (int j = 0; j < kNj; ++j)
      dqh[row * dqs.s + tx + 16 * j] = acc[i][j] * pb.scale;
  }
}

template <int HD, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ lse,
                   const float* __restrict__ dout,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                   Strides dos, Strides dks, Strides dvs, Problem pb) {
  constexpr int kLd = HD + 1;
  constexpr int kNj = HD / 16;
  extern __shared__ float sm[];
  float* sk = sm;                  // 64 x kLd, the block's keys
  float* sv = sk + kTile * kLd;    // 64 x kLd
  float* sq = sv + kTile * kLd;    // 64 x kLd, unscaled q
  float* sdo = sq + kTile * kLd;   // 64 x kLd
  float* sp = sdo + kTile * kLd;   // 64 x kLdP, [key][query] dropped p
  float* sds = sp + kTile * kLdP;  // 64 x kLdP, [key][query] ds
  float* slse = sds + kTile * kLdP;  // 64, x log2 e
  float* sdelta = slse + kTile;      // 64
  int* sseg = reinterpret_cast<int*>(sdelta + kTile);  // segment attention
  int* slist = sseg + kTile;
  int* scount = slist + kThreads;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = kt * kTile;
  const float* qh = head(q, qs, bh, pb.H);
  const float* doh = head(dout, dos, bh, pb.H);
  const int len = kv_len(pb, bh);

  stage_f32<HD>(sk, kLd, head(k, ks, bh, pb.H), ks.s, k0, pb.Sk, 1.f);
  stage_f32<HD>(sv, kLd, head(v, vs, bh, pb.H), vs.s, k0, pb.Sk, 1.f);

  float dka[4][kNj], dva[4][kNj];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNj; ++j) dka[i][j] = dva[i][j] = 0.f;
  int kseg[4] = {0, 0, 0, 0};
  int2 krange = make_int2(0, 0);
  if constexpr (kSeg) {
#pragma unroll
    for (int i = 0; i < 4; ++i) kseg[i] = seg_id(pb, k0 + ty + 16 * i);
    krange = tile_range(pb, k0, kTile);
  }

  const int nq = k0 < len ? (pb.Sq + kTile - 1) / kTile : 0;
  auto live = [&](int qt) {
    return ranges_meet(krange, tile_range(pb, qt * kTile, kTile));
  };
  auto tile = [&](int qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage_f32<HD>(sq, kLd, qh, qs.s, q0, pb.Sq, 1.f);
    stage_f32<HD>(sdo, kLd, doh, dos.s, q0, pb.Sq, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const int64_t at = static_cast<int64_t>(bh) * pb.Sq + row;
      slse[threadIdx.x] = row < pb.Sq ? lse[at] * kLog2e : 0.f;
      sdelta[threadIdx.x] = row < pb.Sq ? delta[at] : 0.f;
      if constexpr (kSeg) sseg[threadIdx.x] = seg_id(pb, row);
    }
    __syncthreads();

    // s^T with q * q_mul formed as it is read (one fp32 rounding, the
    // value the forward staged)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sk[(ty + 16 * i) * kLd + d];
        vv[i] = sv[(ty + 16 * i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = __fmul_rn(sq[(tx + 16 * j) * kLd + d], pb.q_mul);
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
      const uint32_t rk = dropout_row_key(pb.seed, bh, row);
      const float* brow = bias_row(pb, bh, row);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int col = k0 + r;
        const float sc = masked_score(pb, len, brow, s[i][j], row, col,
                                      !kSeg || sseg[c] == kseg[i]);
        const float p = exp2f(sc - slse[c]);
        float pd = p, dpd = dp[i][j];
        if (pb.drop) {
          const bool keep = keep_bit(rk, col, pb.thr);
          pd = keep ? p * pb.keep_scale : 0.f;
          dpd = keep ? dpd * pb.keep_scale : 0.f;
        }
        sp[r * kLdP + c] = pd;
        sds[r * kLdP + c] = p * (dpd - sdelta[c]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      float pv[4], dsv[4], dov[kNj], qv[kNj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sp[(ty + 16 * i) * kLdP + c];
        dsv[i] = sds[(ty + 16 * i) * kLdP + c];
      }
#pragma unroll
      for (int j = 0; j < kNj; ++j) {
        dov[j] = sdo[c * kLd + tx + 16 * j];
        qv[j] = sq[c * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNj; ++j) {
          dva[i][j] = fmaf(pv[i], dov[j], dva[i][j]);
          dka[i][j] = fmaf(dsv[i], qv[j], dka[i][j]);
        }
    }
  };
  for_tiles<kSeg, kThreads>(pb.causal ? kt : 0, nq, slist, scount, live,
                            tile);

  float* dkh = head(dk, dks, bh, pb.H);
  float* dvh = head(dv, dvs, bh, pb.H);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= pb.Sk) continue;
#pragma unroll
    for (int j = 0; j < kNj; ++j) {
      dkh[kr * dks.s + tx + 16 * j] = dka[i][j] * pb.scale;
      dvh[kr * dvs.s + tx + 16 * j] = dva[i][j];
    }
  }
}

template <int HD, bool kSeg>
int launch_f32(const void* const* p, const int64_t* st, const Problem& pb,
               cudaStream_t stream) {
  constexpr int kLd = HD + 1;
  constexpr size_t kSegBytes =
      kSeg ? sizeof(int) * seg_smem_ints<kThreads>() : 0;
  const size_t smem_dq =
      sizeof(float) * (4 * kTile * kLd + kTile * kLdP + 2 * kTile) +
      kSegBytes;
  const size_t smem_dkv =
      sizeof(float) * (4 * kTile * kLd + 2 * kTile * kLdP + 2 * kTile) +
      kSegBytes;
  cudaError_t e = cudaFuncSetAttribute(
      dq_f32_kernel<HD, kSeg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dkv_f32_kernel<HD, kSeg>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_dkv));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bh = pb.B * pb.H;
  dq_f32_kernel<HD, kSeg><<<dim3((pb.Sq + kTile - 1) / kTile, bh), kThreads,
                      smem_dq, stream>>>(
      static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const float*>(p[6]),
      static_cast<float*>(const_cast<void*>(p[7])),
      static_cast<float*>(const_cast<void*>(p[10])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), pb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_f32_kernel<HD, kSeg><<<dim3((pb.Sk + kTile - 1) / kTile, bh), kThreads,
                       smem_dkv, stream>>>(
      static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), static_cast<const float*>(p[10]),
      static_cast<float*>(const_cast<void*>(p[8])),
      static_cast<float*>(const_cast<void*>(p[9])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 4),
      strides_at(st, 6), strides_at(st, 7), pb);
  return 0;
}

// The backward on these bodies (p as the entries order it: q, k, v, o,
// lse, dout, dlse, dq, dk, dv, delta): bf16 on the tensor cores, fp32 on
// the CUDA cores, head_dim 64 or 128. Segment attention takes it whole;
// the unpacked entry takes launch_f32 alone.
template <bool kSeg>
int launch_bwd(const void* const* p, const int64_t* st, const Problem& pb,
               int hd, int dtype, cudaStream_t s) {
  if (dtype == kBFloat16 && hd == 128)
    return launch_mma<128, kSeg>(p, st, pb, s);
  if (dtype == kBFloat16 && hd == 64)
    return launch_mma<64, kSeg>(p, st, pb, s);
  if (dtype == kFloat32 && hd == 128)
    return launch_f32<128, kSeg>(p, st, pb, s);
  if (dtype == kFloat32 && hd == 64)
    return launch_f32<64, kSeg>(p, st, pb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace unpacked
}  // namespace apex_port

