// The split-KV decode read with lse, for Hopper (sm_90a): one kernel for
// the contiguous cache (flash_decode.cu, rocm_apex_tpu/ops/
// flash_attention.py:813 `_decode_kernel`) and the page pools
// (flash_decode_paged.cu, :950 `_decode_paged_kernel`), templated on how a
// lane finds key t's K/V row (`CacheKeys`, `PagedKeys`).
//
// Each query row reads the prefix [0, kv_len[slot]) of ONE slot, bounded
// by the slots' key range `capacity` (the chunked-prefill piece B passes
// a slot id per chunk token; the decode grid reads slot r for row r).
// Rows whose slot is out of range (chunk padding) or whose prefix is
// empty emit zeros and lse = -1e30.
//
// Bound: bytes. A decode row does 4 * head_dim FLOPs per key against
// 2 * head_dim K/V elements, far below the ~295 FLOP/byte where Hopper's
// tensor cores would bind, so the design reads each live key row once
// per (row, head) and never touches a key past the row's bound. What held
// the one-warp walk back was latency, not bytes: the decode grid (8 rows
// x 8 heads) was 64 warps on 132 multiprocessors walking up to 32 tiles
// each, one after the other.
//
// Split-KV: each (row, head)'s key range [0, capacity) is cut into
// `spans` spans of `span_len` keys (a multiple of the 32-key tile; the
// host sizes them from rows, heads, the multiprocessor count and the
// capacity, never from the device's kv_len), a warp a span, so that
// rows x heads x spans warps fill the card; a span at or past its row's
// bound exits at once. A span's (m, l, acc) partial is merged with the
// others of its (row, head) in a fixed order through their maxima: the
// up to 4 spans of a block in shared memory, then (spans > 4) the blocks'
// partials by a second small launch, a warp a (row, head), in block
// order. No atomics: two launches give the same bits. With one span (the
// chunk's piece B: 256 rows already fill the card) a warp walks its whole
// row and writes o and lse itself.
//
// Both cache forms run this one code: the tile's products, the order of
// keys within a span, the order of the spans and the merge. The same keys
// in the same dtype under the same plan therefore give the same bits,
// whichever cache holds them (the paged serve reproduces the contiguous
// serve's greedy tokens).
//
// Within a span, keys go in tiles of 32 as in attention_row.cuh, and
// every lane knows each key's row before the tile's loads (past the
// span's end within its last tile: the last live key's, weighing 0), so
// the 32 loads go out back to back: the contiguous cache's rows are
// computed (the keys are consecutive), a pool's are resolved through the
// table by lane j and shuffled to the warp. A paged tile may span pages
// (page_size 16 puts two in a tile): its next table entry is loaded
// while the current tile is read, and an int8 page's scales are shuffled
// per key beside the dequantization, which no load waits on. (Shuffled
// as a pool's rows are, the contiguous rows ran piece B at 1.4x, with a
// 64-bit multiply a key, and at 2.5x, with 32-bit offsets, the time the
// computed rows take on the H100.)
//
// The scores follow `_masked_scores` (flash_attention.py:122): a lane's
// slice of q is multiplied by q_mul = scale * log2(e) in q's dtype and
// rounded to that dtype once, as the row is loaded; q . k is then fp32.
#pragma once

#include <type_traits>

#include "attention_row.cuh"

namespace apex_port {

// A key source gives a warp, for its (slot, head), a `Walk` (walk(slot,
// h, t): t the lane's first key), and the walk gives each tile of keys
// [t0, t0 + n) a `Tile` (tile(t0, n, t, t_next): t the lane's key in it,
// t_next the lane's key in the next tile or < 0), whose k/v and row(j)
// say where key j's K and V rows lie (keys past the tile's last live key:
// that key's rows), with k_sc/v_sc the lane's key's page scales for int8
// pools.

// The contiguous cache (num_slots, capacity, heads, head_dim), read in
// place through its strides: key t of (slot, h) at slot * slot_stride +
// t * pos_stride + h * head_stride. Every lane computes key j's row
// itself (the tile's keys are consecutive): no shuffle, no table.
template <typename P>
struct CacheKeys {
  const P* k;
  const P* v;
  int64_t slot_stride, pos_stride, head_stride;

  struct Tile {
    const P* k;  // key t0's rows
    const P* v;
    int64_t stride;
    int last;  // the tile's last live key
    float k_sc, v_sc;
    __device__ __forceinline__ int64_t row(int j) const {
      return static_cast<int64_t>(min(j, last)) * stride;
    }
  };

  struct Walk {
    const P* k;
    const P* v;
    int64_t stride;
    __device__ __forceinline__ Tile tile(int t0, int n, int, int) const {
      const int64_t off = static_cast<int64_t>(t0) * stride;
      return Tile{k + off, v + off, stride, n - 1, 1.f, 1.f};
    }
  };

  __device__ __forceinline__ Walk walk(int slot, int h, int) const {
    const int64_t off = static_cast<int64_t>(slot) * slot_stride +
                        static_cast<int64_t>(h) * head_stride;
    return Walk{k + off, v + off, pos_stride};
  }
};

// The page pools (num_pages, heads, page_size, head_dim) through the
// (num_slots, pages_per_slot) table: key t of (slot, h) at pool row
// (page * heads + h) * page_size + t % page_size, page = the slot's
// entry t / page_size, clamped into the pool (a dead row's bound may
// reach unmapped sentinel entries, a live row's never does). P is the
// query's dtype, or int8 with fp32 scales per (page, head), dequantized
// as the TPU kernel does it: (float(x) * scale) rounded to the query's
// dtype.
template <typename P, int D>
struct PagedKeys {
  const P* k;
  const P* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* table;
  int pages_per_slot, page_size, num_pages, heads;
  int hd;  // a pool row's elements (the head dim, at most D)

  // lane j's pool row reaches every lane by shuffles before the tile's
  // loads, so the 32 loads depend on no shuffle and go out back to back
  struct Tile {
    const P* k;
    const P* v;
    int rows[32];
    int hd;
    float k_sc, v_sc;
    __device__ __forceinline__ int64_t row(int j) const {
      return static_cast<int64_t>(rows[j]) * hd;
    }
  };

  struct Walk {
    const P* k;
    const P* v;
    const float* k_scale;
    const float* v_scale;
    const int32_t* pages;
    int page_size, num_pages, heads, h, hd;
    int entry;  // the table entry of this tile's key

    // the next tile's entry is loaded while this one is read
    __device__ __forceinline__ Tile tile(int, int, int t, int t_next) {
      const int nxt = t_next >= 0 ? pages[t_next / page_size] : 0;
      const int page = min(max(entry, 0), num_pages - 1);
      const int ph = page * heads + h;
      const int row = ph * page_size + t % page_size;
      Tile tl;
      tl.k = k;
      tl.v = v;
      tl.hd = hd;
#pragma unroll
      for (int j = 0; j < 32; ++j) tl.rows[j] = __shfl_sync(kFullMask, row, j);
      tl.k_sc = tl.v_sc = 1.f;
      if constexpr (std::is_same<P, int8_t>::value) {
        tl.k_sc = k_scale[ph];
        tl.v_sc = v_scale[ph];
      }
      entry = nxt;
      return tl;
    }
  };

  __device__ __forceinline__ Walk walk(int slot, int h, int t) const {
    const int32_t* pages = table + static_cast<int64_t>(slot) * pages_per_slot;
    return Walk{k,         v,         k_scale, v_scale, pages,
                page_size, num_pages, heads,   h,       hd,
                pages[t / page_size]};
  }
};

// One tile of up to 32 keys (`Tile` as above; lane j's k_sc/v_sc the
// scales of key j's page for int8 pools), k/v the tile's k/v offset to
// this lane's dims. `live` as in attend_tile.
template <typename T, int VEC, typename P, class Tile>
__device__ __forceinline__ void attend_rows_tile(const P* __restrict__ k,
                                                 const P* __restrict__ v,
                                                 const Tile& tl,
                                                 uint32_t live,
                                                 const float (&q)[VEC],
                                                 RowState<VEC>& st,
                                                 int lane, bool dims) {
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  float part[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float kf[VEC] = {};
    if (dims) load_vec<P, VEC>(k + tl.row(j), kf);
    if constexpr (kInt8) {
      const float sj = __shfl_sync(kFullMask, tl.k_sc, j);
#pragma unroll
      for (int c = 0; c < VEC; ++c) kf[c] = round_to<T>(kf[c] * sj);
    }
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) dot = fmaf(q[c], kf[c], dot);
    part[j] = dot;
  }
  const float s_full = transpose_reduce(part, lane);
  const float s = ((live >> lane) & 1u) ? s_full : kNegInf;
  const float m_new = fmaxf(st.m, warp_max(s));
  const float p = exp2f(s - m_new);        // 0 for dead keys
  const float corr = exp2f(st.m - m_new);  // 0 on the first live tile
  st.l = st.l * corr + warp_sum(p);
#pragma unroll
  for (int c = 0; c < VEC; ++c) st.acc[c] *= corr;
  const float pr = round_to<T>(p);  // p in q's type, as attend_tile's
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pj = __shfl_sync(kFullMask, pr, j);
    float vf[VEC] = {};
    if (dims) load_vec<P, VEC>(v + tl.row(j), vf);
    if constexpr (kInt8) {
      const float sj = __shfl_sync(kFullMask, tl.v_sc, j);
#pragma unroll
      for (int c = 0; c < VEC; ++c) vf[c] = round_to<T>(vf[c] * sj);
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c) st.acc[c] = fmaf(pj, vf[c], st.acc[c]);
  }
  st.m = m_new;
}

constexpr int kBlockWarps = 4;

// Block b, warp w: the (row, head) pair and the span it walks. Spans of
// one pair share a block where they fit (spans <= 4: 4 / spans pairs a
// block), else a pair has spans / 4 blocks of 4 spans each.
struct SpanSlot {
  int pair, span, lead, group;  // lead: the warp of the block's first
                                // span of this pair; group: the block's
                                // index among its pair's blocks
};

__device__ __forceinline__ SpanSlot span_slot(int spans, int warp) {
  const int w_pair = spans < kBlockWarps ? spans : kBlockWarps;
  SpanSlot s;
  if (spans <= kBlockWarps) {
    s.pair = blockIdx.x * (kBlockWarps / w_pair) + warp / w_pair;
    s.span = warp % w_pair;
    s.group = 0;
  } else {
    const int groups = spans / kBlockWarps;
    s.pair = blockIdx.x / groups;
    s.group = blockIdx.x % groups;
    s.span = s.group * kBlockWarps + warp;
  }
  s.lead = warp - warp % w_pair;
  return s;
}

// (m, l, acc) of partials i = 0 .. n - 1 (m_i, l_i at m[i * stride], ...)
// merged in order into st: the lane's VEC values of acc
template <int VEC>
__device__ __forceinline__ void merge_partials(const float* m, const float* l,
                                               const float* acc, int n,
                                               int stride, int acc_stride,
                                               RowState<VEC>& st, int lane) {
  float mx = kNegInf;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, m[i * stride]);
  st.m = mx;
  st.l = 0.f;
#pragma unroll
  for (int c = 0; c < VEC; ++c) st.acc[c] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float f = exp2f(m[i * stride] - mx);  // 0 for an empty partial
    st.l = fmaf(l[i * stride], f, st.l);
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      st.acc[c] = fmaf(acc[i * acc_stride + lane * VEC + c], f, st.acc[c]);
  }
}

template <typename T, int VEC, class Keys>
__global__ void __launch_bounds__(128) decode_split_kernel(
    const T* __restrict__ q, int64_t q_row_stride, int64_t q_head_stride,
    Keys keys, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ row_slot, int rows, int heads, int num_slots,
    int capacity, float q_mul, int spans, int span_len,
    T* __restrict__ o, float* __restrict__ lse, float* __restrict__ ws,
    int hd) {
  constexpr int D = 32 * VEC;  // the width; o's rows are hd long
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool dims = lane * VEC < hd;  // this lane's dims inside the head
  const SpanSlot sl = span_slot(spans, warp);
  const bool live_pair = sl.pair < rows * heads;  // uniform per warp
  const int r = sl.pair / heads;
  const int h = sl.pair - r * heads;

  RowState<VEC> st;
  st.init();
  if (live_pair) {
    const int slot = row_slot != nullptr ? row_slot[r] : r;
    int bound = 0;
    if (slot >= 0 && slot < num_slots)
      bound = min(max(kv_len[slot], 0), capacity);
    const int lo = sl.span * span_len;
    const int hi = min(bound, lo + span_len);
    if (lo < hi) {
      float qf[VEC] = {};
      if (dims)
        load_vec<T, VEC>(
            q + r * q_row_stride + h * q_head_stride + lane * VEC, qf);
#pragma unroll
      for (int c = 0; c < VEC; ++c) qf[c] = round_to<T>(qf[c] * q_mul);
      // this lane's key in the tile at t0 (past the span's end: the last)
      auto key = [&](int t0) {
        return t0 + min(lane, min(32, hi - t0) - 1);
      };
      auto w = keys.walk(slot, h, key(lo));
      for (int t0 = lo; t0 < hi; t0 += 32) {
        const int n = min(32, hi - t0);
        const uint32_t live = n == 32 ? kFullMask : ((1u << n) - 1u);
        const auto tl =
            w.tile(t0, n, key(t0), t0 + 32 < hi ? key(t0 + 32) : -1);
        attend_rows_tile<T, VEC>(tl.k + lane * VEC, tl.v + lane * VEC, tl,
                                 live, qf, st, lane, dims);
      }
    }
  }
  if (spans == 1) {  // uniform per launch: the warp's row is whole
    if (live_pair)
      finish_row<T, VEC>(st, o + (static_cast<int64_t>(r) * heads + h) * hd,
                         lse != nullptr ? lse + r * heads + h : nullptr,
                         lane, dims);
    return;
  }
  __shared__ float sm_ml[2][kBlockWarps];
  __shared__ __align__(16) float sm_acc[kBlockWarps][D];
  if (lane == 0) {
    sm_ml[0][warp] = st.m;
    sm_ml[1][warp] = st.l;
  }
#pragma unroll
  for (int c = 0; c < VEC; ++c) sm_acc[warp][lane * VEC + c] = st.acc[c];
  __syncthreads();
  if (!live_pair || warp != sl.lead) return;
  const int n = spans < kBlockWarps ? spans : kBlockWarps;
  merge_partials<VEC>(&sm_ml[0][warp], &sm_ml[1][warp], &sm_acc[warp][0], n,
                      1, D, st, lane);
  if (spans <= kBlockWarps) {
    finish_row<T, VEC>(st, o + (static_cast<int64_t>(r) * heads + h) * hd,
                       lse != nullptr ? lse + r * heads + h : nullptr, lane,
                       dims);
    return;
  }
  // this block's partial: ws holds acc (pairs, groups, D) then (m, l)
  // (pairs, groups, 2)
  const int groups = spans / kBlockWarps;
  const int64_t pg = static_cast<int64_t>(sl.pair) * groups + sl.group;
  float* wacc = ws + pg * D;
  float* wml = ws + static_cast<int64_t>(rows) * heads * groups * D + pg * 2;
#pragma unroll
  for (int c = 0; c < VEC; ++c) wacc[lane * VEC + c] = st.acc[c];
  if (lane == 0) {
    wml[0] = st.m;
    wml[1] = st.l;
  }
}

// The blocks' partials of each (row, head) merged in block order: a warp
// a pair.
template <typename T, int VEC>
__global__ void __launch_bounds__(128) decode_merge_kernel(
    const float* __restrict__ ws, int rows, int heads, int groups,
    T* __restrict__ o, float* __restrict__ lse, int hd) {
  constexpr int D = 32 * VEC;
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= rows * heads) return;  // uniform per warp
  const int64_t pg = static_cast<int64_t>(pair) * groups;
  const float* wml = ws + static_cast<int64_t>(rows) * heads * groups * D;
  RowState<VEC> st;
  merge_partials<VEC>(wml + pg * 2, wml + pg * 2 + 1, ws + pg * D, groups, 2,
                      D, st, lane);
  finish_row<T, VEC>(st, o + static_cast<int64_t>(pair) * hd,
                     lse != nullptr ? lse + pair : nullptr, lane,
                     lane * VEC < hd);
}

// What both forms pass besides their keys. q: (rows, heads, head_dim)
// with unit dim stride; kv_len: (num_slots,) int32; row_slot: (rows,)
// int32 or null (row r reads slot r); capacity: the slots' key range;
// spans, span_len: the key split (a power of two times a multiple of 32
// covering the capacity); o: contiguous (rows, heads, head_dim) in q's
// dtype; lse: contiguous (rows, heads) fp32 or null; ws: fp32 workspace
// of rows * heads * (spans / 4) * (width + 2) when spans > 4, else null
// (the width: the smallest of 32, 64, 128, 256 at or above head_dim).
struct SplitArgs {
  const void* q;
  int64_t q_rs, q_hs;
  int hd;
  const int32_t* kv_len;
  const int32_t* row_slot;
  int rows, heads, num_slots, capacity;
  float q_mul;
  int spans, span_len;
  void* o;
  float* lse;
  float* ws;
  cudaStream_t stream;
};

// a power of two of spans, every key of the capacity in one span, a
// workspace where the blocks' partials need one
inline bool split_args_ok(const SplitArgs& a) {
  const bool pow2 = a.spans > 0 && (a.spans & (a.spans - 1)) == 0;
  return pow2 && a.hd >= 8 && a.hd <= 256 && a.hd % 8 == 0 &&
         a.span_len > 0 && a.span_len % 32 == 0 &&
         a.capacity >= 0 &&
         static_cast<int64_t>(a.spans) * a.span_len >= a.capacity &&
         (a.spans <= kBlockWarps || a.ws != nullptr);
}

template <typename T, int VEC, class Keys>
static void launch_split(const SplitArgs& a, const Keys& keys) {
  const int threads = 32 * kBlockWarps;
  const int64_t warps = static_cast<int64_t>(a.rows) * a.heads * a.spans;
  const int blocks = static_cast<int>((warps + kBlockWarps - 1) / kBlockWarps);
  decode_split_kernel<T, VEC, Keys><<<blocks, threads, 0, a.stream>>>(
      static_cast<const T*>(a.q), a.q_rs, a.q_hs, keys, a.kv_len, a.row_slot,
      a.rows, a.heads, a.num_slots, a.capacity, a.q_mul, a.spans,
      a.span_len, static_cast<T*>(a.o), a.lse, a.ws, a.hd);
  note_launch("decode_split_kernel");
  if (a.spans > kBlockWarps) {
    const int pairs = a.rows * a.heads;
    decode_merge_kernel<T, VEC>
        <<<(pairs + kBlockWarps - 1) / kBlockWarps, threads, 0, a.stream>>>(
            a.ws, a.rows, a.heads, a.spans / kBlockWarps,
            static_cast<T*>(a.o), a.lse, a.hd);
    note_launch("decode_merge_kernel");
  }
}

}  // namespace apex_port
