// The unpacked flash-attention forward's CUDA-core kernel, the fp32 form
// of flash_unpacked_fwd.cu and, with kSeg, of flash_segments_fwd.cu
// (segment attention). Both bf16 forms run on the wgmma pipe of
// flash_fwd_pipe.cuh.
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:170 `_fwd_kernel` as `_fwd`
// (:242) runs it, in fp32. One block per (query tile of 64 rows, b*h): the
// q tile is staged once with scale * log2(e) folded in, then an online
// softmax in base 2 walks key tiles up to the row block's causal and
// length bound (so S has no ceiling), with the scores masked by
// flash_unpacked.cuh's `masked_score`. As on the TPU the normalizer l sums
// the UNdropped probabilities and dropout zeroes entries of the normalized
// matrix; the keep bit of (row, key) is dropout.cuh's hash with stream
// b*h, as the packed kernels draw it. Writes o through its strides and the
// natural-log lse (B*H, Sq).
//
// Bound: the fp32 rate of the CUDA cores (4 x 4 score and 4 x D/16 output
// register tiles a thread). One tile in flight, a barrier between load and
// use.
//
// With kSeg the same body serves segment attention over a packed (H,
// total, D) stream: a key of another segment is masked as well, and a
// block visits only the key tiles whose segment-id range meets its own
// (`for_tiles`), gathered by a ballot so dead tiles cost no barrier.
//
// Head dims: widths 64, 128 and 256 (`at_width`), the columns past pb.hd
// staged as zeros and not stored. At width 256 the staged q, k, v and p
// take 209 KB of shared memory, and a thread 64 output accumulators.
#pragma once

#include "flash_unpacked.cuh"

namespace apex_port {
namespace unpacked {

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

  stage_f32<HD>(sq, kLd, head(q, qs, bh, pb.H), qs.s, q0, pb.Sq, pb.q_mul,
                pb.hd);

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
    stage_f32<HD>(sk, kLd, kh, ks.s, kt * kTile, pb.Sk, 1.f, pb.hd);
    stage_f32<HD>(sv, HD, vh, vs.s, kt * kTile, pb.Sk, 1.f, pb.hd);
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
      if (tx + 16 * j < pb.hd) oh[row * os.s + tx + 16 * j] = acc[i][j] / safe_l;
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
  note_launch("fwd_f32_kernel");
  return 0;
}

// fp32 on the CUDA cores, at pb.hd's width.
template <bool kSeg>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const int64_t* st, const Problem& pb, int dtype,
               cudaStream_t s) {
  if (dtype != kFloat32) return static_cast<int>(cudaErrorInvalidValue);
  return at_width(pb.hd, [&](auto w) {
    return launch_f32<decltype(w)::value, kSeg>(q, k, v, o, lse, st, pb, s);
  });
}

}  // namespace unpacked
}  // namespace apex_port

