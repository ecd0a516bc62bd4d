// The bf16 and fp16 flash-attention backward on Hopper's asynchronous
// units (the element type T a template parameter of every piece): the
// pipe of the packed backward (flash_bwd.cu, row 11: rocm_apex_tpu/ops/
// flash_attention.py:1324 `_bwd_merged_kernel` and the packed use of :316
// `_bwd_dkv_kernel` / :384 `_bwd_dq_kernel`), of the unpacked one
// (flash_unpacked_bwd.cu, row 9b: the same two kernels as `_bwd` (:502)
// runs them) and, with kSeg, of the training segment backward
// (flash_segments_bwd.cu, row 4: ops/flash_attention_segments.py:173
// `_seg_dq_kernel` and :120 `_seg_dkv_kernel` as `_seg_bwd` runs them),
// built from the forward pipe's pieces (flash_fwd_pipe.cuh).
// q, k, v, o and do are read, and dq, dk and dv written, in place through
// (batch, head, row) strides, so a caller with other layouts passes other
// strides.
//
// Bound: operations. At the GPT train cell (B 16, S 1024, 8 heads, hd
// 128, causal) the backward issues 5 products a (query tile, key
// tile) pair, 86 GFLOP, against ~0.2 GB of operands. What keeps a tile
// loop far from the tensor peak (mma.sync bodies ran at ~90 TFLOP/s
// issued): 16-row warps, one K/V tile in flight with barriers around it,
// and every operand read along its columns (k in the dq pass, q and do in
// the dk/dv pass) staged transposed element by element. Here:
//
// - Two launches, no atomics. The dq pass (a block per (b*H + h, query
//   tile)) first writes, for its 64 rows, (lse log2 e, delta =
//   rowsum(do o) - dlse) into a stats buffer of (B*H, 64 * query tiles, 2)
//   fp32 (and, where `delta` is given, delta alone into a (B*H, Sq) buffer,
//   the bias gradient's input), then walks the key tiles up to the causal
//   bound. The dk/dv pass (a block per (b*H + h, key tile)) walks the query
//   tiles from the causal bound on, reading a tile's 64 (lse, delta) pairs
//   as it lands. Both grids go longest first: query tiles counted down in
//   the dq pass, key tiles up in the dk/dv pass.
// - One warpgroup (128 threads) a block, 64 rows (queries in the dq pass,
//   keys in the dk/dv pass); blocks share a multiprocessor (two at hd
//   128; at hd 64 see the last item), so one's softmax-side arithmetic
//   runs beside another's products.
// - Every operand tile is 64 rows of hd T in the forward's 128-byte
//   swizzle, one cp.async a 16-byte segment (zero-filled past the
//   sequence), into a ring of two stages: K and V in the dq pass, q and do
//   in the dk/dv pass; one barrier a tile (two in the dk/dv pass, whose
//   scaled q copy is written between them).
// - dq pass: S = (q q_mul) k^T and dP = do v^T are wgmma with both
//   operands K-major in shared memory; ds = p (keep dP / (1 - rate) -
//   delta) becomes, in place, the A fragments of dq += ds k, with k read
//   MN-major as the forward reads V.
// - dk/dv pass: S^T = k (q q_mul)^T and dP^T = v do^T the same way; p^T
//   and ds^T become the A fragments of dv += p^T do and dk += ds^T q, q
//   and do read MN-major. q is staged once: the scores' copy, T(q
//   q_mul), is written beside it in shared memory for every query tile.
// - The computed operands are rounded to T once, as the JAX kernels
//   round them: ds (`ds.astype(q.dtype)`) for dq and for dk, p_drop
//   (`p_drop.astype(do.dtype)`) for dv; one product each a 16-row step.
// - The score rule, the masking rule and the keep bits are the forward
//   pipe's: `key_live` (causal, lengths, the ragged edge; a tile no edge
//   crosses skips its tests), dropout.cuh's hash of (seed, b*H + h,
//   query, key). The fp32 score bias of the unpacked forms (`kBias`) is
//   where S (S^T) starts: each thread loads its fragment positions' bias
//   log2 e into the accumulators first thing in a tile (the dk/dv pass's
//   load is 4 queries x 8 consecutive keys a warp, from L2), they land
//   under the tile's wait and the dP product, issued first, and the S
//   product adds to them. The sum's rounding order is not the forward's
//   (score, then bias), a difference at fp32 level; a -1e30 bias still
//   gives p = 0, and a zero bias the bias-free bits. dq and dk take
//   `scale` at the end, dk from the unscaled q. Each pass also writes,
//   where `part` is given, the fp32 column sums of its 64 rows of dq (or
//   dk and dv) in a fixed order: the projection bias's partials.
// - Segment attention (kSeg): each pass walks the tiles of its [lo, hi]
//   as the forward pipe does (the dk/dv pass from the causal bound on),
//   ids staged with each tile (keys in the dq pass, queries in the dk/dv
//   pass) and held in registers for the block's own rows, in the
//   pre-pass's order `pb.order` (the query tiles' order in the dq pass,
//   the key tiles' in the dk/dv pass). At head_dim 64 its dq pass runs
//   four blocks a multiprocessor (128 registers a thread) and its dk/dv
//   pass three (168, a few spilled): a tile's step there is bound by its
//   latency, not by its products, so more blocks in flight is what
//   shortens a pass. The other forms keep two blocks.
// - Head dims: the forward pipe's widths and zero columns (64, 128, 256;
//   copy_rows zero-fills the segments past hd, the S and dP k-steps stop
//   at ceil(hd / 16), only hd columns are stored). At width 256 the dq
//   pass holds 128 fp32 accumulators a thread, as the forward does, in
//   193 KB of shared memory. Its dk/dv pass cannot hold both 256-column
//   accumulators (256 fp32 a thread), so it is split by columns: the grid
//   gets a z of 2, and block z owns columns [128 z, 128 z + 128) of dk and
//   dv, recomputing S^T and dP^T over the whole head dim (1.5x the
//   pass's products). Its shared memory is k, v and the scaled q copy (3 x
//   32 KB) and two q/do stages (2 x 64 KB): 230,400 bytes with the
//   alignment, 230,912 with segment ids, within the 232,448 a block may
//   take.
#pragma once

#include "flash_fwd_pipe.cuh"

namespace apex_port {
namespace unpacked {

template <int HD>
struct BwdCfg {
  static constexpr int kThreads = 128;
  static constexpr int kStages = 2;
  static constexpr int kTileBytes = PipeCfg<HD>::kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;
  // dq pass: the scaled q, do, the ring of K/V stages; dk/dv pass: k, v,
  // the scaled q copy, the ring of q/do stages; + 1024 for the alignment
  static constexpr int kDqSmem = 2 * kTileBytes + kStages * kStageBytes +
                                 1024;
  static constexpr int kDkvSmem = 3 * kTileBytes + kStages * kStageBytes +
                                  1024;
  // the dk/dv columns a block owns (a grid z of HD / kOut blocks a tile)
  static constexpr int kOut = HD > 128 ? 128 : HD;
};

// The operands of one backward: q, o and do of (B, H, Sq, HD), k and v of
// (B, H, Sk, HD), dq, dk and dv likewise, each through its strides; lse
// (B*H, Sq); stats (B*H, 64 * query tiles, 2) fp32, written by the dq
// pass; part, where not null, the fp32 column sums of each 64-row tile of
// dq, dk and dv at part_of(bh, tile) + 0, HD and 2 HD; dlse, where not
// null, the (B*H, Sq) cotangent of lse (folded into delta); delta, where
// not null, a (B*H, Sq) fp32 output of the dq pass's delta.
template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;
  float* stats;
  T* dq;
  T* dk;
  T* dv;
  float* part;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  Strides ps;  // part's (batch, head, tile) strides
  const float* dlse = nullptr;
  float* delta = nullptr;
};

template <typename T>
__device__ __forceinline__ float* part_of(const BwdArgs<T>& a, int bh, int H,
                                          int tile) {
  return a.part + static_cast<int64_t>(bh / H) * a.ps.b +
         static_cast<int64_t>(bh % H) * a.ps.h +
         static_cast<int64_t>(tile) * a.ps.s;
}

// *p through the read-only path, issued where it stands: a volatile load
// keeps the compiler from sinking it to its use, so that it lands under
// what comes between
__device__ __forceinline__ float ldg_pinned(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Row `row` of operand row bh's bias, the row clamped into the bias (with
// the columns clamped as well: a position past Sq or Sk is masked by
// key_live and its score never read)
__device__ __forceinline__ const float* bias_at(const Problem& pb, int bh,
                                                int row) {
  return pb.bias + (static_cast<int64_t>(bh / pb.hp) * pb.Sq +
                    min(row, pb.Sq - 1)) * pb.Sk;
}

// dst <- T(src * mul) over a tile (same layout: the map is elementwise)
template <int HD, typename T>
__device__ __forceinline__ void scaled_copy(unsigned char* dst,
                                            const unsigned char* src,
                                            float mul) {
  for (int i = threadIdx.x; i < BwdCfg<HD>::kTileBytes / 16;
       i += BwdCfg<HD>::kThreads) {
    uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = from_float<T>(to_float(e[j]) * mul);
    reinterpret_cast<uint4*>(dst)[i] = raw;
  }
}

// x (64 rows x HD, the warpgroup's C layout, fp32) times `mul`, rounded
// to T, into rows [r0, r0 + 64) of a (rows, HD) matrix with row
// stride rs; rows at or past `rows` and columns at or past `cols` are left
// out
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           int64_t rs, int r0, int rows,
                                           const float (&x)[HD / 2],
                                           float mul, int cols) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= rows) continue;
    T* row = dst + static_cast<int64_t>(r + 8 * h) * rs;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      if (nb * 8 < cols)
        *reinterpret_cast<uint32_t*>(row + nb * 8 + 2 * t) = pack2<T>(
            x[4 * nb + 2 * h] * mul, x[4 * nb + 2 * h + 1] * mul);
  }
}

// out[c] = mul * the sum of column c of x over the 64 rows, for c < HD:
// each warp's 16 rows by shuffles over the row lanes, then the 4 warps in
// order through `red` (4 HD floats of shared memory, free: the caller
// synchronizes before)
template <int HD>
__device__ __forceinline__ void tile_column_sums(const float (&x)[HD / 2],
                                            float mul, float* red,
                                            float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) {
    float c0 = x[4 * nb] + x[4 * nb + 2];
    float c1 = x[4 * nb + 1] + x[4 * nb + 3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {  // over the rows: lanes of equal t
      c0 += __shfl_xor_sync(kFullMask, c0, o);
      c1 += __shfl_xor_sync(kFullMask, c1, o);
    }
    if (lane < 4) {
      red[warp * HD + nb * 8 + 2 * lane] = c0;
      red[warp * HD + nb * 8 + 2 * lane + 1] = c1;
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < HD; col += 128) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) c += red[w * HD + col];
    out[col] = c * mul;
  }
}

template <typename T, int HD, bool kBias, bool kSeg>
__global__ void __launch_bounds__(128, kSeg && HD == 64 ? 4 : 2)
    bwd_dq_pipe_kernel(BwdArgs<T> a, Problem pb) {
  static_assert(!(kBias && kSeg), "segment attention takes no bias");
  using C = BwdCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* sdo = sq + C::kTileBytes;
  unsigned char* ring = sdo + C::kTileBytes;
  // segment attention: the ids of each stage's keys
  int* sids = reinterpret_cast<int*>(ring + C::kStages * C::kStageBytes);
  const int bh = blockIdx.x;
  const int nqt = (pb.Sq + kTile - 1) / kTile;
  int qt = nqt - 1 - static_cast<int>(blockIdx.y);
  if constexpr (kSeg) qt = __ldg(pb.order + blockIdx.y);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint32_t rkey[2] = {dropout_row_key(pb.seed, bh, row[0]),
                            dropout_row_key(pb.seed, bh, row[1])};
  const float* brow[2] = {kBias ? bias_at(pb, bh, row[0]) : nullptr,
                          kBias ? bias_at(pb, bh, row[1]) : nullptr};
  const int len = kv_len(pb, bh);
  const T* kh = head(a.k, a.ks, bh, pb.H);
  const T* vh = head(a.v, a.vs, bh, pb.H);

  // this block's key tiles: [t0, t0 + n); with segments, those of [lo, hi],
  // the rows' ids in registers
  const int kend = key_end(pb, bh, min(q0 + kTile, pb.Sq) - 1);
  int t0 = 0;
  int n = (kend + kTile - 1) / kTile;
  int2 qr = make_int2(0, 0);
  int rseg[2] = {0, 0};
  if constexpr (kSeg) {
    const int4 span = __ldg(pb.tiles + qt);
    n = max(0, min(n, span.y + 1) - span.x);
    t0 = span.x;
    qr = tile_range(pb, q0, kTile);
    rseg[0] = seg_id(pb, row[0]);
    rseg[1] = seg_id(pb, row[1]);
  }
  auto stage = [&](int i) { return ring + (i % C::kStages) * C::kStageBytes; };
  auto load = [&](int i) {
    unsigned char* st = stage(i);
    copy_rows<HD>(st, kh, a.ks.s, (t0 + i) * kTile, pb.Sk, pb.hd);
    copy_rows<HD>(st + C::kTileBytes, vh, a.vs.s, (t0 + i) * kTile, pb.Sk,
                  pb.hd);
    if constexpr (kSeg) {
      if (threadIdx.x < kTile)
        sids[(i % C::kStages) * kTile + threadIdx.x] =
            seg_id(pb, (t0 + i) * kTile + threadIdx.x);
    }
  };
  copy_rows<HD>(sq, head(a.q, a.qs, bh, pb.H), a.qs.s, q0, pb.Sq, pb.hd);
  copy_rows<HD>(sdo, head(a.dout, a.dos, bh, pb.H), a.dos.s, q0, pb.Sq,
                pb.hd);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < n) load(i);
    cp_async_commit();
  }

  // q and do landed: q <- T(q q_mul) in place; delta = rowsum(do o)
  // of each warp's 16 rows (HD / 32 columns a lane, then the warp), and
  // the rows' (lse log2 e, delta) into the stats for the dk/dv pass
  cp_async_wait<C::kStages - 1>();
  __syncthreads();
  fold_q<HD, T>(sq, pb.q_mul);
  constexpr int kVec = HD / 32;
  const T* oh = head(a.o, a.os, bh, pb.H);
  float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float* stats = a.stats + (static_cast<int64_t>(bh) * nqt + qt) * kTile * 2;
  for (int r = 0; r < 16; ++r) {
    const int rr = warp * 16 + r;
    const int c = lane * kVec;
    float acc = 0.f;
    if (q0 + rr < pb.Sq && c < pb.hd) {  // a lane's kVec columns: all or none
      float dv[kVec], ov[kVec];
      load_vec<T, kVec>(reinterpret_cast<const T*>(
                            sdo + mnmajor_seg(rr, c >> 3)) + (c & 7), dv);
      load_vec<T, kVec>(oh + static_cast<int64_t>(q0 + rr) * a.os.s + c, ov);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc += dv[i] * ov[i];
    }
    acc = warp_sum(acc);
    const float l2 = q0 + rr < pb.Sq
                         ? a.lse[static_cast<int64_t>(bh) * pb.Sq + q0 + rr] *
                               kLog2e
                         : 0.f;
    if (r == g) {
      lse2[0] = l2;
      delta[0] = acc;
    }
    if (r == g + 8) {
      lse2[1] = l2;
      delta[1] = acc;
    }
    if (lane == 0) {
      stats[2 * rr] = l2;
      stats[2 * rr + 1] = acc;
    }
  }
  // the unpacked forms: delta - dlse where the lse has a cotangent (each
  // thread its two rows, the stats rewritten by the warp's lanes of t 0),
  // and delta into `delta` where given
  if (a.dlse != nullptr || a.delta != nullptr) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int rr = warp * 16 + g + 8 * k;
      if (q0 + rr >= pb.Sq) continue;
      const int64_t at = static_cast<int64_t>(bh) * pb.Sq + q0 + rr;
      if (a.dlse != nullptr) delta[k] -= a.dlse[at];
      if (t == 0) {
        stats[2 * rr + 1] = delta[k];
        if (a.delta != nullptr) a.delta[at] = delta[k];
      }
    }
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    // with a bias, S starts from the tile's bias terms (bias log2 e: the
    // product adds to them; key_live decides which count), their loads
    // issued first so that they land under the tile's wait and the dP
    // product
    const int kbase = (t0 + i) * kTile;
    float s[32], dp[32];
    if constexpr (kBias) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = ldg_pinned(
              brow[e >> 1] + min(kbase + j * 8 + 2 * t + (e & 1), pb.Sk - 1));
    }
    cp_async_wait<C::kStages - 2>();
    fence_proxy_async();  // the folded q and tile i, for wgmma's proxy
    __syncthreads();      // tile i landed; every warp is done with i - 1
    if (i + C::kStages - 1 < n) load(i + C::kStages - 1);
    cp_async_commit();
    const unsigned char* skt = stage(i);
    const unsigned char* svt = skt + C::kTileBytes;
    const int* kids = sids + (i % C::kStages) * kTile;

    // S += (q q_mul) k^T and dP = do v^T: 64 rows x 64 keys each; with
    // a bias dP goes first, and S's start values are awaited while it runs
    auto s_product = [&] {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        if (kstep_live(kk, pb.hd))
          wgmma_m64n64k16<T, 0, 0>(s, kmajor_desc(sq, kk),
                                   kmajor_desc(skt, kk));
    };
    auto dp_product = [&] {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        if (kstep_live(kk, pb.hd))
          wgmma_m64n64k16<T, 0, 0>(dp, kmajor_desc(sdo, kk),
                                   kmajor_desc(svt, kk));
    };
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dp[e] = 0.f;
      if constexpr (!kBias) s[e] = 0.f;
    }
    reg_fence(dp);
    if constexpr (kBias) {
      wgmma_fence();
      dp_product();
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = __fmul_rn(s[e], kLog2e);
      reg_fence(s);
      wgmma_fence();
      s_product();
    } else {
      reg_fence(s);
      wgmma_fence();
      s_product();
      dp_product();
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // ds = p (keep dp / (1 - rate) - delta) into s; e < 2 is row 0
    bool edge = kbase + kTile > len || (pb.causal && kbase + kTile - 1 > q0) ||
                q0 + kTile > pb.Sq;
    if constexpr (kSeg)
      edge = edge || !one_segment(qr, tile_range(pb, kbase, kTile));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kbase + j * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (!edge || key_live(pb, len, row[r], col,
                              !kSeg || kids[col - kbase] == rseg[r])) {
          const float p = exp2f(s[4 * j + e] - lse2[r]);
          float dpd = dp[4 * j + e];
          if (pb.drop)
            dpd = keep_bit(rkey[r], col, pb.thr) ? dpd * pb.keep_scale : 0.f;
          ds = p * (dpd - delta[r]);
        }
        s[4 * j + e] = ds;
      }

    // dq += ds k over 4 steps of 16 keys, ds rounded to T
    uint32_t da[4][4];
    c_to_a_tile<T>(s, da);
    reg_fence(da);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pv_mma<HD, T>(acc, da[j], mnmajor_desc(skt, j));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(da);
  }

  cp_async_wait<0>();
  store_rows<HD>(head(a.dq, a.dqs, bh, pb.H), a.dqs.s, q0, pb.Sq, acc,
                 pb.scale, pb.hd);
  if (a.part != nullptr) {
    __syncthreads();  // sq is the reduction buffer
    tile_column_sums<HD>(acc, pb.scale, reinterpret_cast<float*>(sq),
                    part_of(a, bh, pb.H, qt));
  }
}

template <typename T, int HD, bool kBias, bool kSeg>
__global__ void __launch_bounds__(128, kSeg && HD == 64 ? 3 : 2)
    bwd_dkv_pipe_kernel(BwdArgs<T> a, Problem pb) {
  static_assert(!(kBias && kSeg), "segment attention takes no bias");
  using C = BwdCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* sv = sk + C::kTileBytes;
  unsigned char* sqs = sv + C::kTileBytes;  // T(q q_mul) of the tile
  unsigned char* ring = sqs + C::kTileBytes;
  // segment attention: the ids of each stage's queries
  int* sids = reinterpret_cast<int*>(ring + C::kStages * C::kStageBytes);
  constexpr int kOut = C::kOut;
  const int c0 = static_cast<int>(blockIdx.z) * kOut;  // dk/dv columns owned
  const int bh = blockIdx.x;
  const int nqt = (pb.Sq + kTile - 1) / kTile;
  int kt = blockIdx.y;
  if constexpr (kSeg) kt = __ldg(pb.order + nqt + blockIdx.y);
  const int k0 = kt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const int kcol[2] = {min(key[0], pb.Sk - 1), min(key[1], pb.Sk - 1)};
  const int len = kv_len(pb, bh);
  const T* qh = head(a.q, a.qs, bh, pb.H);
  const T* doh = head(a.dout, a.dos, bh, pb.H);
  const float* stats = a.stats + static_cast<int64_t>(bh) * nqt * kTile * 2;

  // this block's query tiles: [qt0, qt0 + n) (none past the last live
  // key); with segments, those of [lo, hi] from the causal bound on, the
  // keys' ids in registers
  int qt0 = pb.causal ? kt : 0;
  int n = k0 < len ? nqt - qt0 : 0;
  int2 kr = make_int2(0, 0);
  int kseg[2] = {0, 0};
  if constexpr (kSeg) {
    const int4 span = __ldg(pb.tiles + kt);
    qt0 = max(qt0, span.x);
    n = max(0, span.y + 1 - qt0);
    kr = tile_range(pb, k0, kTile);
    kseg[0] = seg_id(pb, key[0]);
    kseg[1] = seg_id(pb, key[1]);
  }
  auto stage = [&](int i) { return ring + (i % C::kStages) * C::kStageBytes; };
  auto load = [&](int i) {
    unsigned char* st = stage(i);
    copy_rows<HD>(st, qh, a.qs.s, (qt0 + i) * kTile, pb.Sq, pb.hd);
    copy_rows<HD>(st + C::kTileBytes, doh, a.dos.s, (qt0 + i) * kTile,
                  pb.Sq, pb.hd);
    if constexpr (kSeg) {
      if (threadIdx.x < kTile)
        sids[(i % C::kStages) * kTile + threadIdx.x] =
            seg_id(pb, (qt0 + i) * kTile + threadIdx.x);
    }
  };
  copy_rows<HD>(sk, head(a.k, a.ks, bh, pb.H), a.ks.s, k0, pb.Sk, pb.hd);
  copy_rows<HD>(sv, head(a.v, a.vs, bh, pb.H), a.vs.s, k0, pb.Sk, pb.hd);
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < n) load(i);
    cp_async_commit();
  }

  float dk[kOut / 2], dv[kOut / 2];
#pragma unroll
  for (int i = 0; i < kOut / 2; ++i) dk[i] = dv[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    // S^T starts from the bias terms at its fragment positions (bias[q]
    // [key] log2 e; a warp's load is 4 queries x 8 consecutive keys), their
    // loads issued first so that they land under the tile's wait, the
    // scaled q copy and the dP^T product; key_live decides which count
    const int q0 = (qt0 + i) * kTile;
    float s[32], dp[32];
    if constexpr (kBias) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const float* bq = bias_at(pb, bh, q0 + j * 8 + 2 * t + par);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            s[4 * j + 2 * r + par] = ldg_pinned(bq + kcol[r]);
            dp[4 * j + 2 * r + par] = 0.f;
          }
        }
    }
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with i - 1
    if (i + C::kStages - 1 < n) load(i + C::kStages - 1);
    cp_async_commit();
    const unsigned char* sqt = stage(i);
    const unsigned char* sdot = sqt + C::kTileBytes;
    const int* qids = sids + (i % C::kStages) * kTile;
    scaled_copy<HD, T>(sqs, sqt, pb.q_mul);
    fence_proxy_async();  // tile i and the copy, for wgmma's proxy
    __syncthreads();

    // S^T += k (q q_mul)^T and dP^T = v do^T: 64 keys x 64 queries each;
    // with a bias dP^T goes first, and S^T's start values are awaited
    // while it runs
    auto s_product = [&] {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        if (kstep_live(kk, pb.hd))
          wgmma_m64n64k16<T, 0, 0>(s, kmajor_desc(sk, kk),
                                   kmajor_desc(sqs, kk));
    };
    auto dp_product = [&] {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        if (kstep_live(kk, pb.hd))
          wgmma_m64n64k16<T, 0, 0>(dp, kmajor_desc(sv, kk),
                                   kmajor_desc(sdot, kk));
    };
    if constexpr (!kBias) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    }
    reg_fence(dp);
    if constexpr (kBias) {
      wgmma_fence();
      dp_product();
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = __fmul_rn(s[e], kLog2e);
      reg_fence(s);
      wgmma_fence();
      s_product();
    } else {
      reg_fence(s);
      wgmma_fence();
      s_product();
      dp_product();
    }
    wgmma_commit();
    // the tile's (lse log2 e, delta) of this thread's 16 query columns,
    // loaded under the products (the dq pass padded the rows to the tile).
    // With a bias, whose start values hold 32 more registers through the
    // products, each lane loads the pairs of queries 2 L and 2 L + 1 and
    // hands them by shuffles to the lanes that need them
    float4 qst[kBias ? 1 : 8];
    if constexpr (kBias) {
      qst[0] = *reinterpret_cast<const float4*>(stats + (q0 + 2 * lane) * 2);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qst[j] = *reinterpret_cast<const float4*>(stats +
                                                  (q0 + j * 8 + 2 * t) * 2);
    }
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // s <- the dropped p^T, dp <- ds^T; e < 2 is key row 0, e & 1 the
    // query column's parity
    bool edge = q0 + kTile > pb.Sq || k0 + kTile > len ||
                (pb.causal && k0 + kTile - 1 > q0);
    if constexpr (kSeg)
      edge = edge || !one_segment(kr, tile_range(pb, q0, kTile));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (lse log2 e, delta) of queries j * 8 + 2 t and + 1 (with a bias,
      // lane 4 j + t's)
      float4 st;
      if constexpr (kBias) {
        const int src = 4 * j + t;
        st = make_float4(__shfl_sync(kFullMask, qst[0].x, src),
                         __shfl_sync(kFullMask, qst[0].y, src),
                         __shfl_sync(kFullMask, qst[0].z, src),
                         __shfl_sync(kFullMask, qst[0].w, src));
      } else {
        st = qst[j];
      }
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int q = q0 + j * 8 + 2 * t + par;
        const float l2 = par ? st.z : st.x;
        const float dl = par ? st.w : st.y;
        const uint32_t rk = pb.drop ? dropout_row_key(pb.seed, bh, q) : 0u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r + par;
          float pd = 0.f, ds = 0.f;
          if (!edge || key_live(pb, len, q, key[r],
                                !kSeg || qids[q - q0] == kseg[r])) {
            const float p = exp2f(s[e] - l2);
            float dpd = dp[e];
            pd = p;
            if (pb.drop) {
              const bool keep = keep_bit(rk, key[r], pb.thr);
              pd = keep ? p * pb.keep_scale : 0.f;
              dpd = keep ? dpd * pb.keep_scale : 0.f;
            }
            ds = p * (dpd - dl);
          }
          s[e] = pd;
          dp[e] = ds;
        }
      }
    }

    // dv += p^T do and dk += ds^T q over 4 steps of 16 queries, p^T and
    // ds^T rounded to T, q and do read MN-major (the block's columns
    // [c0, c0 + kOut): c0 / 64 blocks of 64 columns on)
    uint32_t pa[4][4], da[4][4];
    c_to_a_tile<T>(s, pa);
    c_to_a_tile<T>(dp, da);
    reg_fence(pa);
    reg_fence(da);
    reg_fence(dv);
    reg_fence(dk);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pv_mma<kOut, T>(dv, pa[j],
                      mnmajor_desc(sdot + (c0 / 64) * kTile * 128, j));
      pv_mma<kOut, T>(dk, da[j],
                      mnmajor_desc(sqt + (c0 / 64) * kTile * 128, j));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);
    reg_fence(da);
  }

  cp_async_wait<0>();
  store_rows<kOut>(head(a.dk, a.dks, bh, pb.H) + c0, a.dks.s, k0, pb.Sk, dk,
                   pb.scale, pb.hd - c0);
  store_rows<kOut>(head(a.dv, a.dvs, bh, pb.H) + c0, a.dvs.s, k0, pb.Sk, dv,
                   1.f, pb.hd - c0);
  if (a.part != nullptr) {
    __syncthreads();  // sk is the reduction buffer
    float* part = part_of(a, bh, pb.H, kt) + c0;
    tile_column_sums<kOut>(dk, pb.scale, reinterpret_cast<float*>(sk),
                           part + HD);
    __syncthreads();
    tile_column_sums<kOut>(dv, 1.f, reinterpret_cast<float*>(sk),
                           part + 2 * HD);
  }
}

// The two passes over grids of (b*H + h, 64-row tiles): the dq pass
// (query tiles, which writes the stats), then the dk/dv pass (key
// tiles); kBias for a problem with a score bias (the unpacked forms), kSeg
// for segment attention (pb.seg, pb.ranges, pb.tiles and pb.order filled
// by launch_seg_tiles).
template <int HD, bool kBias = false, bool kSeg = false, typename T>
int launch_pipe_bwd(const BwdArgs<T>& a, const Problem& pb,
                    cudaStream_t stream) {
  using C = BwdCfg<HD>;
  constexpr int kSegBytes = kSeg ? C::kStages * kTile * sizeof(int) : 0;
  const int bh = pb.B * pb.H;
  const int nqt = (pb.Sq + kTile - 1) / kTile;
  const int nkt = (pb.Sk + kTile - 1) / kTile;
  if ((pb.bias != nullptr) != kBias || (pb.seg != nullptr) != kSeg ||
      (kSeg && (pb.tiles == nullptr || pb.order == nullptr)) ||
      nqt > 65535 || nkt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || nqt == 0) return 0;
  // every call, as launch_pipe_fwd sets its own
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq_pipe_kernel<T, HD, kBias, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem + kSegBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bwd_dkv_pipe_kernel<T, HD, kBias, kSeg>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kDkvSmem + kSegBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_pipe_kernel<T, HD, kBias, kSeg>
      <<<dim3(bh, nqt), C::kThreads, C::kDqSmem + kSegBytes, stream>>>(a,
                                                                       pb);
  note_launch("bwd_dq_pipe_kernel");
  e = cudaGetLastError();
  if (e != cudaSuccess || nkt == 0) return static_cast<int>(e);
  bwd_dkv_pipe_kernel<T, HD, kBias, kSeg>
      <<<dim3(bh, nkt, HD / C::kOut), C::kThreads, C::kDkvSmem + kSegBytes,
         stream>>>(a, pb);
  note_launch("bwd_dkv_pipe_kernel");
  return static_cast<int>(cudaGetLastError());
}

// launch_pipe_bwd at pb.hd, on its width (`at_width`)
template <bool kBias = false, bool kSeg = false, typename T>
int launch_pipe_bwd_hd(const BwdArgs<T>& a, const Problem& pb,
                       cudaStream_t stream) {
  return at_width(pb.hd, [&](auto w) {
    return launch_pipe_bwd<decltype(w)::value, kBias, kSeg>(a, pb, stream);
  });
}

}  // namespace unpacked
}  // namespace apex_port
