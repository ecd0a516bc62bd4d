// The bf16 and fp16 flash-attention forward on Hopper's asynchronous
// units (the element type T a template parameter of every piece): one
// pipe for the packed forward (flash_fwd.cu, rows 7a and 8: rocm_apex_tpu/
// ops/flash_attention.py:1170 `_fwd_single_kernel` and the packed use of
// :170 `_fwd_kernel`), the unpacked one (flash_unpacked_fwd.cu, row 7b:
// `_fwd_kernel` as `_fwd` runs it) and, with kSeg, the training segment
// forward (flash_segments_fwd.cu, row 3: ops/flash_attention_segments.py:70
// `_seg_fwd_kernel` as `_seg_fwd` runs it). All read q, k and v in place
// through (batch, head, row) strides: the packed form's heads are column
// blocks of the (B, S, nh, 3 hd) projection, so the forms differ only in
// what they pass.
//
// Bound: operations. At the GPT train cell (B 16, S 1024, 8 heads, hd 128,
// causal) a forward is 34 GFLOP of q k^T and p v against 0.13 GB of q, k,
// v and o. What keeps a tile loop far from the tensor peak (a 64 x 64
// mma.sync body ran at 4% of it): one K/V tile in flight with two barriers
// a tile, V transposed element by element while staged, and 16-row
// products fed through ldmatrix. Here:
//
// - One warpgroup (4 warps, 128 threads) takes 64 query rows; a block is
//   one warpgroup, so blocks share a multiprocessor (two at hd 128, 81 KB
//   of shared memory each; four at hd 64) and one's softmax runs beside
//   another's products.
// - Every operand tile is 64 rows of hd T, each 16-byte segment one
//   cp.async (zero-filled past the sequence) into the 128-byte swizzle,
//   hd / 64 blocks of 64 columns. A ring of two K/V stages keeps the next
//   tile's copies in flight while the current one multiplies, one barrier
//   a tile.
// - S = (q q_mul) k^T is wgmma m64n64k16 with both operands K-major in
//   shared memory. O += p v is wgmma m64n{hd}k16 with A from registers:
//   the S accumulators become the A fragments in place, and V is read as
//   it lies, keys down the tile, MN-major (wgmma transposes it). p is
//   rounded to T once, against the running max after each 64-key
//   tile, as `_fwd_kernel` rounds it after each key block (`p.astype(
//   v.dtype)`): one product a 16-key step.
// - The score rule is `_masked_scores`': after the q tile lands, one pass
//   rounds q q_mul to T in place (q_mul = scale log2 e in T); the
//   scores are masked by flash_unpacked.cuh's `masked_score` rule (causal,
//   lengths, the ragged edge, the fp32 score bias, whose values for a tile
//   are loaded before its products so that they arrive under them); a tile
//   that no edge crosses skips the mask's tests. Softmax and dropout: base
//   2, the running max from -1e30, l over the undropped p, dropout.cuh's
//   keep bit of (seed, b*H + h, query, key), o = acc / l with l = 0 giving
//   0, the natural-log lse.
// - A unit is (b*H + h, query tile, key split): the host plan
//   (`flash_fwd_plan`) cuts each tile's key range into `splits` runs of
//   `split_tiles` tiles where the (head, query tile) pairs alone cannot
//   fill the card, from the shape, never from data. A split writes its
//   unnormalized (acc, m, l) partial to a workspace and `fwd_merge_kernel`
//   merges a row's partials in split order: no atomics, two launches give
//   the same bits. Query tiles go longest first (grid.y counts them down),
//   so a causal grid's long blocks do not finish last.
// - Segment attention (kSeg; B = 1, Sq = Sk = the stream's tokens, one
//   split): a unit walks the key tiles of [lo, hi] that the causal
//   triangle keeps, lo and hi the first and the last tile whose id range
//   meets its own (the pre-pass `seg_tiles_kernel`). With sorted ids every
//   tile between them meets it, so the walk visits no dead tile; with ids
//   in any order it may visit dead ones, whose keys the mask drops, and
//   skips no live one. A key's id is staged with its tile (64 ints a
//   stage), a row's held in registers: `key_live` masks another segment's
//   key, and a tile whose query and key tiles hold one and the same id
//   skips the tests as a tile no edge crosses does. The units run in
//   `pb.order` (`seg_order_kernel`: the longest walk first): the longest
//   walks are the last tiles of the longest sequences, wherever they lie
//   in the stream.
// - Head dims: instances at widths 64, 128 and 256 (`at_width`). A head
//   dim below its width (a multiple of 8) runs with zero columns formed in
//   shared memory: cp.async zero-fills the 16-byte segments at or past it,
//   the q k^T k-steps stop at ceil(hd / 16) (the rest would add exact
//   zeros), and only its columns are stored. At width 256 q is 32 KB and a
//   K/V stage 64 KB (161 KB with the alignment), the accumulator 128 fp32
//   a thread, and o += p v is two 128-column products a 16-key step.
#pragma once

#include "flash_unpacked.cuh"
#include "wgmma.cuh"

namespace apex_port {
namespace unpacked {

template <int HD>
struct PipeCfg {
  static constexpr int kThreads = 128;                // one warpgroup
  static constexpr int kStages = 2;                   // K/V tiles in flight
  static constexpr int kTileBytes = kTile * HD * 2;   // 64 rows of hd T
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  // q, the ring, and 1024 to align the tiles to the swizzle's period
  static constexpr int kSmemBytes =
      kTileBytes + kStages * kStageBytes + 1024;
  static constexpr int kChunks = HD / 8;  // 16-byte segments a row
  // fp32 workspace floats of one unit's partial: 64 rows of (acc, m, l)
  static constexpr int kUnitFloats = kTile * (HD + 2);
  static_assert(HD == 64 || HD == 128 || HD == 256, "width 64, 128 or 256");
};

// The descriptor of q or k for the 16-deep step kk over hd: K-major, each
// 64-column block a 64-row tile of 128-byte rows
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile,
                                                int kk) {
  return gmma_desc(tile + (kk >> 2) * (kTile * 128) + (kk & 3) * 32, 16,
                   1024);
}

// The descriptor of v for the keys [16 j, 16 j + 16): MN-major, the next
// 64 columns of hd 64 rows of 128 bytes on
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile,
                                                 int j) {
  return gmma_desc(tile + j * 16 * 128, kTile * 128, 1024);
}

// Rows [r0, r0 + 64) of a (S, hd) matrix of a 2-byte type with row stride
// rs into a swizzled tile of HD columns, asynchronously; rows at or past S
// and the columns [hd, HD) are zero-filled.
template <int HD, typename T>
__device__ __forceinline__ void copy_rows(unsigned char* tile,
                                          const T* __restrict__ src,
                                          int64_t rs, int r0, int S, int hd) {
  constexpr int kChunks = PipeCfg<HD>::kChunks;
  for (int idx = threadIdx.x; idx < kTile * kChunks;
       idx += PipeCfg<HD>::kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = r0 + r < S && c * 8 < hd;
    cp_async16(tile + mnmajor_seg(r, c),
               ok ? src + (r0 + r) * rs + c * 8 : src, ok);
  }
}

// The same copy by kN threads (thread `tid` of them; kN a multiple of
// HD / 8, 128 or 256) with a fixed segment a thread: segment tid % (HD /
// 8) of rows tid / (HD / 8) + j kN / (HD / 8), so the thread's swizzled
// offset moves by whole 1024-byte periods and its source by a fixed
// stride, one predicated cp.async a step
template <int HD, int kN, typename T>
__device__ __forceinline__ void copy_tile(unsigned char* tile,
                                          const T* __restrict__ src,
                                          int64_t rs, int r0, int S,
                                          int tid, int hd) {
  constexpr int kChunks = HD / 8;      // 16-byte segments a row
  constexpr int kRows = kN / kChunks;  // rows a step, a multiple of 8
  static_assert(kRows % 8 == 0 && kTile % kRows == 0, "whole periods");
  const int c = tid % kChunks;
  const int r = tid / kChunks;
  const bool col = c * 8 < hd;  // a segment past hd is zero-filled
  const T* from = src + static_cast<int64_t>(r0 + r) * rs + c * 8;
  unsigned char* to = tile + mnmajor_seg(r, c);
#pragma unroll
  for (int i = 0; i < kTile / kRows; ++i) {
    const bool ok = col && r0 + r + i * kRows < S;
    cp_async16(to + i * kRows * 128, ok ? from + i * kRows * rs : src, ok);
  }
}

// tile <- T(tile * mul) in place, by kN threads (thread `tid`)
template <int HD, int kN, typename T>
__device__ __forceinline__ void fold_tile(unsigned char* tile, float mul,
                                          int tid) {
  for (int i = tid; i < PipeCfg<HD>::kTileBytes / 16; i += kN) {
    uint4* p = reinterpret_cast<uint4*>(tile) + i;
    uint4 raw = *p;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = from_float<T>(to_float(e[j]) * mul);
    *p = raw;
  }
}

// The 1024-byte aligned base of a block's dynamic shared memory, as an
// offset from the array itself (not through an integer), so that the
// compiler keeps its accesses in the shared space
__device__ __forceinline__ unsigned char* smem_base_1024(
    unsigned char* smem) {
  const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return smem + ((1024u - (at & 1023u)) & 1023u);
}

// q <- T(q * q_mul) over the landed q tile, in place
template <int HD, typename T>
__device__ __forceinline__ void fold_q(unsigned char* tile, float q_mul) {
  constexpr int kChunks = PipeCfg<HD>::kChunks;
  for (int idx = threadIdx.x; idx < kTile * kChunks;
       idx += PipeCfg<HD>::kThreads) {
    uint4* p = reinterpret_cast<uint4*>(
        tile + mnmajor_seg(idx / kChunks, idx % kChunks));
    uint4 raw = *p;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = from_float<T>(to_float(e[i]) * q_mul);
    *p = raw;
  }
}

// the C accumulators of a 64 x 64 tile as T A fragments: step j's A is
// blocks 2 j and 2 j + 1, register for register
template <typename T>
__device__ __forceinline__ void c_to_a_tile(const float (&c)[32],
                                            uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[j][i] = pack2<T>(c[8 * j + 2 * i], c[8 * j + 2 * i + 1]);
}

// keeps the compiler from moving registers across the asynchronous
// products that read or write them
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// o (64 x HD) += a (64 x 16) times the MN-major 16 x HD tile at db: at
// HD 256 the columns' second half starts two 64-column blocks on
template <int HD, typename T>
__device__ __forceinline__ void pv_mma(float (&o)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 256) {
    wgmma_m64n128k16_rs_at<T, 1, 0>(o, a, db);
    wgmma_m64n128k16_rs_at<T, 1, 64>(
        o, a, db + ((2 * kTile * 128) >> 4));  // start address, 16 B units
  } else if constexpr (HD == 128) {
    wgmma_m64n128k16_rs<T, 1>(o, a, db);
  } else {
    wgmma_m64n64k16_rs<T, 1>(o, a, db);
  }
}

// the q k^T k-steps a head dim needs: the rest would multiply zero columns
__device__ __forceinline__ bool kstep_live(int kk, int hd) {
  return kk * 16 < hd;
}

// Segment attention at head_dim 64 puts four blocks on a multiprocessor
// (128 registers a thread, a few spilled): a tile's step there is bound by
// its latency, not by its products, so more blocks in flight is what
// shortens the pass. It has no key split, so no plan counts its blocks;
// the other forms keep the occupancy `flash_fwd_plan` sizes its splits by.
template <typename T, int HD, bool kSeg>
__global__ void __launch_bounds__(128, kSeg && HD == 64 ? 4 : 1)
    fwd_pipe_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ lse, Strides qs, Strides ks,
                    Strides vs, Strides os, Problem pb, int splits,
                    int split_tiles, float* __restrict__ ws) {
  using C = PipeCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* ring = sq + C::kTileBytes;
  // segment attention: the ids of each stage's keys
  int* sids = reinterpret_cast<int*>(ring + C::kStages * C::kStageBytes);
  const int bh = blockIdx.x;
  const int nqt = (pb.Sq + kTile - 1) / kTile;
  int qt = nqt - 1 - static_cast<int>(blockIdx.y) / splits;
  if constexpr (kSeg) qt = __ldg(pb.order + blockIdx.y);
  const int split = static_cast<int>(blockIdx.y) % splits;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* brow[2] = {bias_row(pb, bh, row[0]), bias_row(pb, bh, row[1])};
  const uint32_t rkey[2] = {dropout_row_key(pb.seed, bh, row[0]),
                            dropout_row_key(pb.seed, bh, row[1])};
  const int len = kv_len(pb, bh);
  const T* qh = head(q, qs, bh, pb.H);
  const T* kh = head(k, ks, bh, pb.H);
  const T* vh = head(v, vs, bh, pb.H);

  // this unit's key tiles: [t0, t0 + n); with segments, those of [lo, hi]
  // (one split), the rows' ids in registers
  const int kend = key_end(pb, bh, min(q0 + kTile, pb.Sq) - 1);
  int t0 = split * split_tiles;
  int n = max(0, min((kend + kTile - 1) / kTile, t0 + split_tiles) - t0);
  int2 qr = make_int2(0, 0);
  int rseg[2] = {0, 0};
  if constexpr (kSeg) {
    const int4 span = __ldg(pb.tiles + qt);
    n = max(0, min(t0 + n, span.y + 1) - span.x);
    t0 = span.x;
    qr = tile_range(pb, q0, kTile);
    rseg[0] = seg_id(pb, row[0]);
    rseg[1] = seg_id(pb, row[1]);
  }
  auto stage = [&](int i) { return ring + (i % C::kStages) * C::kStageBytes; };
  auto load = [&](int i) {
    unsigned char* st = stage(i);
    copy_rows<HD>(st, kh, ks.s, (t0 + i) * kTile, pb.Sk, pb.hd);
    copy_rows<HD>(st + C::kTileBytes, vh, vs.s, (t0 + i) * kTile, pb.Sk,
                  pb.hd);
    if constexpr (kSeg) {
      if (threadIdx.x < kTile)
        sids[(i % C::kStages) * kTile + threadIdx.x] =
            seg_id(pb, (t0 + i) * kTile + threadIdx.x);
    }
  };
  if (n > 0) {
    copy_rows<HD>(sq, qh, qs.s, q0, pb.Sq, pb.hd);
#pragma unroll
    for (int i = 0; i < C::kStages - 1; ++i) {
      if (i < n) load(i);
      cp_async_commit();
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<C::kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i == 0) {
      fold_q<HD, T>(sq, pb.q_mul);
      fence_proxy_async();
      __syncthreads();
    }
    if (i + C::kStages - 1 < n) load(i + C::kStages - 1);
    cp_async_commit();
    const unsigned char* skt = stage(i);
    const unsigned char* svt = skt + C::kTileBytes;
    const int* kids = sids + (i % C::kStages) * kTile;

    // the tile's bias terms, loaded before the products so that their
    // latency hides under them (masked_score's values: key_live decides)
    const int kbase = (t0 + i) * kTile;
    float bv[32];
    if (pb.bias != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = kbase + j * 8 + 2 * t + (e & 1);
          bv[4 * j + e] = brow[r] != nullptr && col < len
                              ? __ldg(brow[r] + col) : 0.f;
        }
    }

    // s = (q q_mul) k^T: 64 rows x 64 keys, d[4 j + e] of 8-key block j
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      if (kstep_live(kk, pb.hd))
        wgmma_m64n64k16<T, 0, 0>(s, kmajor_desc(sq, kk),
                                 kmajor_desc(skt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // online softmax over the tile; e < 2 is row 0, e >= 2 row 1. Only a
    // tile on the causal diagonal, the last live key, the last row or, with
    // segments, more than one id needs the mask (uniform per block)
    bool edge = kbase + kTile > len || (pb.causal && kbase + kTile - 1 > q0) ||
                q0 + kTile > pb.Sq;
    if constexpr (kSeg)
      edge = edge || !one_segment(qr, tile_range(pb, kbase, kTile));
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = kbase + j * 8 + 2 * t + (e & 1);
        float sc = masked();
        if (!edge || key_live(pb, len, row[r], col,
                              !kSeg || kids[col - kbase] == rseg[r]))
          sc = brow[r] == nullptr
                   ? s[4 * j + e]
                   : s[4 * j + e] + __fmul_rn(bv[4 * j + e], kLog2e);
        s[4 * j + e] = sc;
        tmax[r] = fmaxf(tmax[r], sc);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(s[4 * j + e] - m[r]);  // 0 for masked keys
        psum[r] += p;
        float pd = p;
        if (pb.drop) {
          const int col = kbase + j * 8 + 2 * t + (e & 1);
          pd = keep_bit(rkey[r], col, pb.thr) ? p * pb.keep_scale : 0.f;
        }
        s[4 * j + e] = pd;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(kFullMask, psum[r], 1);
      psum[r] += __shfl_xor_sync(kFullMask, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      acc[4 * nb] *= corr[0];
      acc[4 * nb + 1] *= corr[0];
      acc[4 * nb + 2] *= corr[1];
      acc[4 * nb + 3] *= corr[1];
    }

    // o += p v over 4 steps of 16 keys, p rounded to T as the A fragments
    uint32_t pa[4][4];
    c_to_a_tile<T>(s, pa);
    reg_fence(pa);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pv_mma<HD, T>(acc, pa[j], mnmajor_desc(svt, j));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
  }

  if (splits == 1) {
    T* oh = head(o, os, bh, pb.H);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= pb.Sq) continue;
      const float safe_l = l[r] > 0.f ? l[r] : 1.f;
      T* orow = oh + row[r] * os.s;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
        if (nb * 8 < pb.hd)
          *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * t) = pack2<T>(
              acc[4 * nb + 2 * r] / safe_l, acc[4 * nb + 2 * r + 1] / safe_l);
      if (t == 0)
        lse[static_cast<int64_t>(bh) * pb.Sq + row[r]] =
            (m[r] + log2f(safe_l)) * kLn2;
    }
    return;
  }
  // the unit's partial: unnormalized acc, m and l of each live row
  float* part =
      ws + ((static_cast<int64_t>(bh) * nqt + qt) * splits + split) *
               PipeCfg<HD>::kUnitFloats;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= pb.Sq) continue;
    float* prow = part + static_cast<int64_t>(row[r] - q0) * (HD + 2);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<float2*>(prow + nb * 8 + 2 * t) =
          make_float2(acc[4 * nb + 2 * r], acc[4 * nb + 2 * r + 1]);
    if (t == 0) {
      prow[HD] = m[r];
      prow[HD + 1] = l[r];
    }
  }
}

// One warp a live (b*H + h, row): the row's `splits` partials merged in
// split order through their maxima, o = sum acc_i 2^(m_i - M) / sum l_i
// 2^(m_i - M) (0 where the sum is 0) and lse = (M + log2 l) ln 2, as the
// unsplit pipe writes them.
template <typename T, int HD>
__global__ void __launch_bounds__(128)
    fwd_merge_kernel(const float* __restrict__ ws, T* __restrict__ o,
                     float* __restrict__ lse, Strides os, int BH, int H,
                     int Sq, int splits, int hd) {
  constexpr int VEC = HD / 32;
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<int64_t>(BH) * Sq) return;  // uniform per warp
  const int bh = static_cast<int>(w / Sq);
  const int row = static_cast<int>(w % Sq);
  const int nqt = (Sq + kTile - 1) / kTile;
  const float* part =
      ws + (static_cast<int64_t>(bh) * nqt + row / kTile) * splits *
               PipeCfg<HD>::kUnitFloats +
      static_cast<int64_t>(row % kTile) * (HD + 2);
  float mx = kNegInf;
  for (int i = 0; i < splits; ++i)
    mx = fmaxf(mx, part[i * PipeCfg<HD>::kUnitFloats + HD]);
  float lsum = 0.f, acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float* p = part + i * PipeCfg<HD>::kUnitFloats;
    const float f = exp2f(p[HD] - mx);  // 0 for a split that saw nothing
    lsum = fmaf(p[HD + 1], f, lsum);
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = fmaf(p[lane * VEC + c], f, acc[c]);
  }
  const float safe_l = lsum > 0.f ? lsum : 1.f;
  T* orow = head(o, os, bh, H) + row * os.s + lane * VEC;
#pragma unroll
  for (int c = 0; c < VEC; ++c)
    if (lane * VEC + c < hd) orow[c] = from_float<T>(acc[c] / safe_l);
  if (lane == 0)
    lse[static_cast<int64_t>(bh) * Sq + row] = (mx + log2f(safe_l)) * kLn2;
}

// The pipe on q/k/v/o given by base pointers and strides: the grid of
// (b*H + h, query tiles x splits) units, then, with splits > 1, the merge
// (ws: B*H * ceil(Sq / 64) * splits * 64 * (HD + 2) floats). kSeg: segment
// attention (pb.seg, pb.ranges, pb.tiles and pb.order filled by
// launch_seg_tiles), one split.
template <typename T, int HD, bool kSeg = false>
int launch_pipe_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, const Strides (&st)[4], const Problem& pb,
                    int splits, int split_tiles, void* ws,
                    cudaStream_t stream) {
  using C = PipeCfg<HD>;
  constexpr int kSmem =
      C::kSmemBytes + (kSeg ? C::kStages * kTile * sizeof(int) : 0);
  const int bh = pb.B * pb.H;
  const int nqt = (pb.Sq + kTile - 1) / kTile;
  if (splits < 1 || split_tiles < 1 ||
      static_cast<int64_t>(nqt) * splits > 65535 ||
      (splits > 1 && ws == nullptr) ||
      (kSeg && (splits != 1 || pb.tiles == nullptr || pb.order == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || nqt == 0) return 0;
  // every call: a function-local "once" flag in this header would be one
  // symbol across the libraries that include it (flash_fwd.cu,
  // flash_unpacked_fwd.cu, flash_segments_fwd.cu), each of which registers
  // its own kernel
  const cudaError_t e = cudaFuncSetAttribute(
      fwd_pipe_kernel<T, HD, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_pipe_kernel<T, HD, kSeg><<<dim3(bh, nqt * splits), C::kThreads, kSmem,
                                 stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), st[0], st[1], st[2], st[3], pb, splits,
      split_tiles, static_cast<float*>(ws));
  note_launch("fwd_pipe_kernel");
  if (splits > 1) {
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
    const int64_t warps = static_cast<int64_t>(bh) * pb.Sq;
    fwd_merge_kernel<T, HD><<<static_cast<unsigned>((warps + 3) / 4), 128, 0,
                              stream>>>(
        static_cast<const float*>(ws), static_cast<T*>(o),
        static_cast<float*>(lse), st[3], bh, pb.H, pb.Sq, splits, pb.hd);
    note_launch("fwd_merge_kernel");
  }
  return static_cast<int>(cudaGetLastError());
}

// launch_pipe_fwd at pb.hd, on its width (`at_width`)
template <typename T, bool kSeg = false>
int launch_pipe_fwd_hd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const Strides (&st)[4], const Problem& pb,
                       int splits, int split_tiles, void* ws,
                       cudaStream_t stream) {
  return at_width(pb.hd, [&](auto w) {
    return launch_pipe_fwd<T, decltype(w)::value, kSeg>(
        q, k, v, o, lse, st, pb, splits, split_tiles, ws, stream);
  });
}

}  // namespace unpacked
}  // namespace apex_port
