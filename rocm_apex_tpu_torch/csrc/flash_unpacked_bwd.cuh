// The unpacked flash-attention backward's CUDA-core kernels: the fp32
// form of flash_unpacked_bwd.cu and, with kSeg, of flash_segments_bwd.cu
// (segment attention). Both bf16 forms run on the wgmma pipe of
// flash_bwd_pipe.cuh.
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:316 `_bwd_dkv_kernel` and
// :384 `_bwd_dq_kernel` as `_bwd` (:502) runs them, in fp32. Blocks run
// in no order on Hopper, so the TPU's sequential grids become two
// launches with no atomics, and results repeat run to run:
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
// Bound: the fp32 rate of the CUDA cores (2.5x the forward's products:
// s, dp, dq in one pass, s, dp, dv, dk in the other), as
// flash_unpacked_fwd.cuh.
//
// With kSeg the same bodies serve segment attention over a packed (H,
// total, D) stream: a key of another segment is masked as well, and each
// pass visits only the tiles whose segment-id ranges meet its own tile's
// (`for_tiles`).
#pragma once

#include "flash_unpacked.cuh"

namespace apex_port {
namespace unpacked {

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
// lse, dout, dlse, dq, dk, dv, delta): fp32, head_dim 64 or 128.
template <bool kSeg>
int launch_bwd(const void* const* p, const int64_t* st, const Problem& pb,
               int hd, int dtype, cudaStream_t s) {
  if (dtype == kFloat32 && hd == 128)
    return launch_f32<128, kSeg>(p, st, pb, s);
  if (dtype == kFloat32 && hd == 64)
    return launch_f32<64, kSeg>(p, st, pb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace unpacked
}  // namespace apex_port

