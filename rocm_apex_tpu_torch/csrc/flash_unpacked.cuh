// Shared pieces of the unpacked flash-attention kernels: the fp32 forward
// (flash_unpacked_fwd.cuh), the fp32 backward's dq and dk/dv passes
// (flash_unpacked_bwd.cuh), the bias gradient (flash_dbias.cu) and the
// bf16 pipes (flash_fwd_pipe.cuh, flash_bwd_pipe.cuh). The fp32 bodies
// and the pipes are templates on `kSeg`: false for the unpacked and
// packed entries, true for the segment attention of the packed token
// stream (flash_segments_{fwd,bwd}.cu), whose tables (the ranges, the
// tiles' walks and the units' order) the pre-passes below write.
//
// Operands (those of rocm_apex_tpu/ops/flash_attention.py `_fwd`/`_bwd`):
//   q, o, do, dq   (B, H, Sq, D), k, v, dk, dv (B, H, Sk, D), read and
//                  written through (batch, head, row) element strides with
//                  a unit stride on D, so the per-head columns of the fused
//                  projection are read in place; bh = b * H + h is the row
//                  of the JAX layout (B*H, S, D)
//   lse, delta     (B*H, Sq) fp32, natural-log lse
//   bias           (nb, Sq, Sk) fp32 or null; operand row bh reads bias
//                  row bh / hp, hp = B*H / nb
//   lens           (B*H,) int32 or null: row bh attends keys [0, lens[bh])
//   seg, ranges    segment attention only (else null): B = 1, Sq = Sk =
//                  total tokens, seg (total,) int32 ids, ranges (ceil(total
//                  / 32),) the (min, max) id of each 32-token tile; on the
//   tiles, order   pipes also tiles (ceil(total / 64),) and order (2
//                  ceil(total / 64),), `seg_workspace`'s
// D is 64 or 128 (the kernels are templates on it).
//
// `masked_score` is the one masking rule of all three kernels, the
// counterpart of `_masked_scores` (:122): a score is in base 2,
// (q * q_mul) . k with q_mul = scale * log2(e) rounded to the operand
// dtype and folded into q as it is staged (rounded in that dtype, as the
// JAX kernels round it), plus bias * log2(e) in fp32; a key at or past Sk
// or lens[bh], or past the query's own index when causal (top-left
// aligned), scores -inf. The running max starts at -1e30 (kNegInf), so a
// masked key adds exactly 0 to every softmax sum, and a row whose every
// live score carries the -1e30 padding bias keeps l = 0: o = 0 and lse =
// -1e30 * ln 2, as the JAX kernel gives without causal masking (under it
// the JAX kernel's masked scores are -1e30, equal to its starting max, and
// such a row averages v over the masked keys of the blocks it visits: a
// value of its tiling, which the port does not follow). In the backward
// such a row has p = exp2(s - lse log2 e) = 0 everywhere.
#pragma once

#include <climits>

#include "common.cuh"
#include "dropout.cuh"
#include "mma.cuh"

namespace apex_port {
namespace unpacked {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kMmaThreads = 128;   // bf16 dbias: 4 warps of 16 rows
constexpr int kThreads = 256;      // fp32: a 16 x 16 thread grid
constexpr int kLdP = kTile + 1;    // fp32 [row][64] tile row (floats)

struct Strides {
  int64_t b, h, s;
};

struct Problem {
  int B, H, Sq, Sk;
  int causal;
  const int* __restrict__ lens;
  const float* __restrict__ bias;
  int hp;  // heads per bias row
  int drop;
  uint32_t seed, thr;
  float keep_scale;  // 1 / (1 - rate)
  float q_mul;       // scale * log2(e) in the operand dtype
  float scale;
  const int* __restrict__ seg;      // segment attention: ids, else null
  const int2* __restrict__ ranges;  // (min, max) id of each 32-token tile
  // segment attention on the pipes: each 64-token tile's (lo, hi, cq, ck)
  // (`seg_tiles_kernel`), and the units' order (`seg_order_kernel`: the
  // query tiles, then the key tiles)
  const int4* __restrict__ tiles;
  const int* __restrict__ order;
};

// -inf, the score of a masked key
__device__ __forceinline__ float masked() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

// The (S, D) matrix of operand row bh.
template <typename P>
__device__ __forceinline__ P head(P base, const Strides& st, int bh, int H) {
  return base + static_cast<int64_t>(bh / H) * st.b +
         static_cast<int64_t>(bh % H) * st.h;
}

// The keys operand row bh may attend at all: [0, kv_len).
__device__ __forceinline__ int kv_len(const Problem& pb, int bh) {
  return pb.lens == nullptr ? pb.Sk : max(0, min(pb.Sk, pb.lens[bh]));
}

// The first key past what query rows up to `last_row` may attend.
__device__ __forceinline__ int key_end(const Problem& pb, int bh,
                                       int last_row) {
  const int e = kv_len(pb, bh);
  return pb.causal ? min(e, last_row + 1) : e;
}

// Row `row` of operand row bh's bias, or null.
__device__ __forceinline__ const float* bias_row(const Problem& pb, int bh,
                                                 int row) {
  if (pb.bias == nullptr || row >= pb.Sq) return nullptr;
  return pb.bias +
         (static_cast<int64_t>(bh / pb.hp) * pb.Sq + row) * pb.Sk;
}

// THE masked base-2 score of (row, col) from its raw product
// (q * q_mul) . k; `len` is kv_len(pb, bh), `brow` bias_row(pb, bh, row),
// `same` whether row and col share a segment (always, but in segment
// attention). The bias term is rounded before the add, as the plain
// version's `s + bias * LOG2E` rounds it. `key_live` is its mask alone.
__device__ __forceinline__ bool key_live(const Problem& pb, int len, int row,
                                         int col, bool same = true) {
  return !(row >= pb.Sq || col >= len || (pb.causal && col > row) || !same);
}

__device__ __forceinline__ float masked_score(const Problem& pb, int len,
                                              const float* brow, float raw,
                                              int row, int col,
                                              bool same = true) {
  if (!key_live(pb, len, row, col, same)) return masked();
  return brow == nullptr ? raw
                         : raw + __fmul_rn(__ldg(brow + col), kLog2e);
}

// ---- staging -----------------------------------------------------------

// Rows [r0, r0 + kRows) of a (S, HD) bf16 matrix (row stride rs) into
// shared memory: dst (row-major, row stride ld) gets bf16(x * mul) (mul 1
// copies); rows at or past S are 0. Lanes walk columns (16-byte loads, a
// row's bytes together).
template <int HD, int kRows>
__device__ __forceinline__ void stage_bf16(bf16* __restrict__ dst, int ld,
                                           const bf16* __restrict__ src,
                                           int64_t rs, int r0, int S,
                                           float mul, int nthreads) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += nthreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const int row = r0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) raw = *reinterpret_cast<const uint4*>(src + row * rs + c);
    if (mul != 1.f) {
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(__bfloat162float(e[i]) * mul);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = raw;
  }
}

// Rows [r0, r0 + 64) of a (S, HD) fp32 matrix into dst (row stride ld)
// times `mul` (one fp32 rounding, as the plain version's q * c), 0 past S.
template <int HD>
__device__ __forceinline__ void stage_f32(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t rs, int r0, int S,
                                          float mul) {
  constexpr int kPerRow = HD / 4;
  for (int idx = threadIdx.x; idx < kTile * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    const int row = r0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < S) load_vec<float, 4>(src + row * rs + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r * ld + c + i] = v[i] * mul;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// delta = rowsum(do * o) - dlse for rows [r0, r0 + 64) of operand row bh,
// do from shared memory (row stride ld, type T), o from device memory; one
// warp per row in turn. Writes sdelta[64] and, for live rows, delta_out;
// slse[64] gets lse * log2(e) (0 past Sq: every score of such a row is
// -inf).
template <int HD, typename T>
__device__ __forceinline__ void row_delta(
    const T* sdo, int ld, const T* __restrict__ oh, int64_t o_rs,
    const float* __restrict__ lse, const float* __restrict__ dlse,
    float* __restrict__ delta_out, float* sdelta, float* slse, int bh, int r0,
    int Sq, int nwarps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += nwarps) {
    const int row = r0 + r;
    float acc = 0.f;
    if (row < Sq) {
      for (int c = lane; c < HD; c += 32)
        acc += to_float(sdo[r * ld + c]) * to_float(oh[row * o_rs + c]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const int64_t at = static_cast<int64_t>(bh) * Sq + row;
      if (row < Sq && dlse != nullptr) acc -= dlse[at];
      sdelta[r] = acc;
      slse[r] = row < Sq ? lse[at] * kLog2e : 0.f;
      if (row < Sq && delta_out != nullptr) delta_out[at] = acc;
    }
  }
}

// ---- segment attention ---------------------------------------------------

constexpr int kRangeRows = 32;  // tokens per entry of `ranges`

// One warp per 32-token tile: ranges[t] = (min, max) of seg over tokens
// [32 t, min(32 t + 32, total)).
__global__ void seg_ranges_kernel(const int* __restrict__ seg, int total,
                                  int2* __restrict__ ranges) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int n = (total + kRangeRows - 1) / kRangeRows;
  if (t >= n) return;
  const int i = t * kRangeRows + lane;
  int lo = i < total ? seg[i] : INT_MAX;
  int hi = i < total ? seg[i] : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFullMask, lo, o));
    hi = max(hi, __shfl_xor_sync(kFullMask, hi, o));
  }
  if (lane == 0) ranges[t] = make_int2(lo, hi);
}

inline int launch_seg_ranges(const void* seg, int total, void* ranges,
                             cudaStream_t stream) {
  const int n = (total + kRangeRows - 1) / kRangeRows;
  if (n == 0) return 0;
  seg_ranges_kernel<<<(n + 7) / 8, 256, 0, stream>>>(
      static_cast<const int*>(seg), total, static_cast<int2*>(ranges));
  return static_cast<int>(cudaGetLastError());
}

// The (min, max) id over tokens [r0, r0 + rows) (rows a multiple of 32),
// from `ranges`; tokens past the stream add nothing.
__device__ __forceinline__ int2 tile_range(const Problem& pb, int r0,
                                           int rows) {
  const int n = (pb.Sq + kRangeRows - 1) / kRangeRows;
  int2 r = make_int2(INT_MAX, INT_MIN);
  for (int t = r0 / kRangeRows; t < min(n, (r0 + rows) / kRangeRows); ++t) {
    const int2 e = __ldg(pb.ranges + t);
    r.x = min(r.x, e.x);
    r.y = max(r.y, e.y);
  }
  return r;
}

// May a tile of ids in `a` meet one in `b`? (`_overlap`: ranges that
// overlap; exact coverage when ids are sorted, and never false for a
// pair that holds a live position, whatever their order.)
__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) {
  return a.x <= b.y && a.y >= b.x;
}

// Whether a tile pair needs no segment test: both tiles hold one id, the
// same (a diagonal or ragged tile still needs the other tests)
__device__ __forceinline__ bool one_segment(int2 a, int2 b) {
  return a.x == a.y && b.x == b.y && a.x == b.x;
}

// One warp a 64-token tile t of the stream: tiles[t] = (lo, hi, cq, ck),
// lo and hi the first and the last tile whose id range meets t's (32
// candidates at a time, one a lane, by a ballot), cq and ck the tiles a
// pipe unit of t walks as a query tile ([lo, t] when causal, else [lo,
// hi]) and as a key tile ([t, hi] when causal, else [lo, hi]). With sorted
// ids every tile of [lo, hi] meets t's.
__global__ void seg_tiles_kernel(Problem pb, int4* __restrict__ tiles) {
  const int nt = (pb.Sq + kTile - 1) / kTile;
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= nt) return;
  const int2 r = tile_range(pb, t * kTile, kTile);
  int lo = nt, hi = -1;
  for (int base = 0; base < nt; base += 32) {
    const int u = base + lane;
    const unsigned bal = __ballot_sync(
        kFullMask,
        u < nt && ranges_meet(r, tile_range(pb, u * kTile, kTile)));
    if (bal != 0u) {
      lo = min(lo, base + __ffs(bal) - 1);
      hi = base + 31 - __clz(bal);
    }
  }
  if (lane == 0)
    tiles[t] = make_int4(lo, hi, (pb.causal ? t : hi) - lo + 1,
                         hi - (pb.causal ? t : lo) + 1);
}

// order[0, nt): the query tiles by the length of their walk, longest
// first (ties: the later tile first, as the index order counts query tiles
// down); order[nt, 2 nt): the key tiles likewise (ties: the earlier tile
// first). One warp a tile t: its lanes count the tiles that rank before
// t, 32 at a time, then the warp sums the counts.
__global__ void seg_order_kernel(const int4* __restrict__ tiles, int nt,
                                 int* __restrict__ order) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= nt) return;
  const int4 me = tiles[t];
  int rq = 0, rk = 0;
  for (int u = lane; u < nt; u += 32) {
    const int4 c = tiles[u];
    rq += c.z > me.z || (c.z == me.z && u > t);
    rk += c.w > me.w || (c.w == me.w && u < t);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    rq += __shfl_xor_sync(kFullMask, rq, o);
    rk += __shfl_xor_sync(kFullMask, rk, o);
  }
  if (lane == 0) {
    order[rq] = t;
    order[nt + rk] = t;
  }
}

// Points pb's segment tables into ws, an int32 workspace of a stream of
// Sq tokens: the tiles' (lo, hi, cq, ck) (4 words a 64-token tile), the
// order (2 a tile) and the ranges (2 a 32-token tile), in that order. The
// fp32 bodies read only the ranges.
inline void seg_workspace(Problem& pb, void* ws) {
  const int nt = (pb.Sq + kTile - 1) / kTile;
  int* w = static_cast<int*>(ws);
  pb.tiles = reinterpret_cast<const int4*>(w);
  pb.order = w + 4 * nt;
  pb.ranges = reinterpret_cast<const int2*>(w + 6 * nt);
}

// The pipes' segment pre-passes into the tables seg_workspace set: the
// ranges, the tiles, then the order.
inline int launch_seg_tiles(const Problem& pb, cudaStream_t stream) {
  int rc = launch_seg_ranges(pb.seg, pb.Sq, const_cast<int2*>(pb.ranges),
                             stream);
  const int nt = (pb.Sq + kTile - 1) / kTile;
  if (rc != 0 || nt == 0) return rc;
  seg_tiles_kernel<<<(nt + 7) / 8, 256, 0, stream>>>(
      pb, const_cast<int4*>(pb.tiles));
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  seg_order_kernel<<<(nt + 7) / 8, 256, 0, stream>>>(
      pb.tiles, nt, const_cast<int*>(pb.order));
  return static_cast<int>(cudaGetLastError());
}

// The segment id of token `i` (-1 past the stream, where every score is
// masked by its index anyway).
__device__ __forceinline__ int seg_id(const Problem& pb, int i) {
  return i < pb.Sq ? __ldg(pb.seg + i) : -1;
}

// The ids of tokens [r0, r0 + rows) into sseg (rows <= the block's
// threads).
__device__ __forceinline__ void stage_seg(const Problem& pb, int* sseg,
                                          int r0, int rows) {
  const int i = static_cast<int>(threadIdx.x);
  if (i < rows) sseg[i] = seg_id(pb, r0 + i);
}

// Calls body(t) for every t in [t0, t1) with live(t), in ascending order,
// on every thread of the block alike (body may hold barriers). The
// candidates are tested kN at a time, one a thread, and the live ones
// gathered into `list` (kN ints of shared memory; `count` kN / 32 ints)
// by a ballot per warp, so a block spends no barrier on a dead tile.
template <int kN, class Live, class Body>
__device__ __forceinline__ void for_live_tiles(int t0, int t1, int* list,
                                               int* count, Live live,
                                               Body body) {
  constexpr int kWarps = kN / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int base = t0; base < t1; base += kN) {
    const int t = base + static_cast<int>(threadIdx.x);
    const bool ok = t < t1 && live(t);
    const unsigned bal = __ballot_sync(kFullMask, ok);
    __syncthreads();  // the previous round's readers of list/count are done
    if (lane == 0) count[warp] = __popc(bal);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? count[w] : 0;
      n += count[w];
    }
    if (ok) list[off + __popc(bal & ((1u << lane) - 1u))] = t;
    __syncthreads();
    for (int i = 0; i < n; ++i) body(list[i]);
  }
}

// Runs body(t) for each tile t in [t0, t1): every one for the unpacked
// kernels, the live ones (`live`) for segment attention.
template <bool kSeg, int kN, class Live, class Body>
__device__ __forceinline__ void for_tiles(int t0, int t1, int* list,
                                          int* count, Live live, Body body) {
  if constexpr (kSeg) {
    for_live_tiles<kN>(t0, t1, list, count, live, body);
  } else {
    for (int t = t0; t < t1; ++t) body(t);
  }
}

// Shared-memory ints segment attention adds to a block of kN threads:
// `list` (kN), `count` (kN / 32) and the ids of one tile's tokens (64).
template <int kN>
constexpr int seg_smem_ints() {
  return kN + kN / 32 + kTile;
}

inline Problem make_problem(int B, int H, int Sq, int Sk, int causal,
                            const void* lens, const void* bias, int nb,
                            int drop, uint32_t seed, uint32_t thr,
                            float keep_scale, float q_mul, float scale) {
  Problem pb;
  pb.B = B;
  pb.H = H;
  pb.Sq = Sq;
  pb.Sk = Sk;
  pb.causal = causal;
  pb.lens = static_cast<const int*>(lens);
  pb.bias = static_cast<const float*>(bias);
  pb.hp = (bias != nullptr && nb > 0) ? (B * H) / nb : 1;
  pb.drop = drop;
  pb.seed = seed;
  pb.thr = thr;
  pb.keep_scale = keep_scale;
  pb.q_mul = q_mul;
  pb.scale = scale;
  pb.seg = nullptr;
  pb.ranges = nullptr;
  pb.tiles = nullptr;
  pb.order = nullptr;
  return pb;
}

inline Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// grid.y carries batch * heads
inline bool grid_ok(const Problem& pb) {
  return pb.B * pb.H <= 65535 && pb.B * pb.H > 0;
}

}  // namespace unpacked
}  // namespace apex_port
