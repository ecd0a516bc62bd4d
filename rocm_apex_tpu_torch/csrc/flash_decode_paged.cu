// Paged-cache decode read with lse, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:950 `_decode_paged_kernel`.
// The cache is a pool of pages per layer, (num_pages, heads, page_size,
// head_dim), and a (num_slots, pages_per_slot) int32 table maps each
// slot's positions onto pool pages. Each query row reads the prefix
// [0, kv_len[slot]) of ONE slot (the chunked-prefill piece B passes a
// slot id per chunk token; the decode grid reads slot r for row r),
// walking the slot's page list through the table. Rows whose slot is out
// of range (chunk padding) or whose prefix is empty emit zeros and
// lse = -1e30. Two pool forms: the query's own dtype (bf16 or fp32), or
// int8 with one fp32 scale per (page, head); an int8 key or value is
// dequantized as the TPU kernel does it, (float(x) * scale) rounded to
// the query's dtype, then accumulated in fp32.
//
// Bound: bytes. A decode row does 4 * head_dim FLOPs per key against
// 2 * head_dim K/V elements: one FLOP per byte in bf16, two in int8, far
// below the ~295 FLOP/byte where Hopper's tensor cores would bind, so the
// design reads each live key row once per (row, head) and never touches
// a page past the row's bound. What held it back was latency, not
// bytes: one warp walked a (row, head)'s whole prefix, 32 keys a tile,
// so the decode grid (8 rows x 8 heads) was 64 warps on 132
// multiprocessors walking up to 32 tiles each, one after the other.
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
// row and writes o and lse itself, as before.
//
// Within a span, keys go in tiles of 32 as in attention_row.cuh; a tile
// may span pages (page_size 16 puts two in a tile), so lane j resolves
// key j's pool row (its table entry, clamped into the pool: a dead row's
// bound may reach unmapped sentinel entries, a live row's never does).
// Keys past the span's end within its last tile load the last live
// key's row and weigh 0. Every key's row reaches the warp by shuffles
// BEFORE the tile's loads, so the 32 loads depend on no shuffle and go
// out back to back; the next tile's table entry is loaded while the
// current tile is read. An int8 page's scales are shuffled per key
// beside the dequantization, which no load waits on.
#include <type_traits>

#include "attention_row.cuh"

namespace apex_port {

// One tile of up to 32 keys. Lane j holds `row`, the pool row
// ((page * heads + head) * page_size + offset) of key j (keys past the
// tile's last live key hold that key's row), and for int8 pools the
// scales of key j's page. `live` as in attend_tile.
template <typename T, typename P, int VEC>
__device__ __forceinline__ void attend_paged_tile(
    const P* __restrict__ k, const P* __restrict__ v, int row, float k_sc,
    float v_sc, uint32_t live, const float (&q)[VEC], RowState<VEC>& st,
    int lane) {
  constexpr int D = 32 * VEC;
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  int rows[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) rows[j] = __shfl_sync(kFullMask, row, j);
  float part[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float kf[VEC];
    load_vec<P, VEC>(k + static_cast<int64_t>(rows[j]) * D + lane * VEC, kf);
    if constexpr (kInt8) {
      const float sj = __shfl_sync(kFullMask, k_sc, j);
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
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pj = __shfl_sync(kFullMask, p, j);
    float vf[VEC];
    load_vec<P, VEC>(v + static_cast<int64_t>(rows[j]) * D + lane * VEC, vf);
    if constexpr (kInt8) {
      const float sj = __shfl_sync(kFullMask, v_sc, j);
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

template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(128) decode_paged_kernel(
    const T* __restrict__ q, int64_t q_row_stride, int64_t q_head_stride,
    const P* __restrict__ k, const P* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int32_t* __restrict__ table, const int32_t* __restrict__ kv_len,
    const int32_t* __restrict__ row_slot, int rows, int heads, int num_slots,
    int pages_per_slot, int page_size, int num_pages, float q_scale,
    int spans, int span_len, T* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ ws) {
  constexpr int D = 32 * VEC;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
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
      bound = min(max(kv_len[slot], 0), pages_per_slot * page_size);
    const int lo = sl.span * span_len;
    const int hi = min(bound, lo + span_len);
    if (lo < hi) {
      float qf[VEC];
      load_vec<T, VEC>(q + r * q_row_stride + h * q_head_stride + lane * VEC,
                       qf);
#pragma unroll
      for (int c = 0; c < VEC; ++c) qf[c] *= q_scale;
      const int32_t* pages =
          table + static_cast<int64_t>(slot) * pages_per_slot;
      // this lane's key in the tile at t0 (past the span's end: the last)
      auto key = [&](int t0) {
        return t0 + min(lane, min(32, hi - t0) - 1);
      };
      int entry = pages[key(lo) / page_size];
      for (int t0 = lo; t0 < hi; t0 += 32) {
        const int n = min(32, hi - t0);
        const uint32_t live = n == 32 ? kFullMask : ((1u << n) - 1u);
        const int t = key(t0);
        const int next = t0 + 32 < hi ? pages[key(t0 + 32) / page_size] : 0;
        const int page = min(max(entry, 0), num_pages - 1);
        const int ph = page * heads + h;
        const int row = ph * page_size + t % page_size;
        float ks = 1.f, vs = 1.f;
        if constexpr (std::is_same<P, int8_t>::value) {
          ks = k_scale[ph];
          vs = v_scale[ph];
        }
        attend_paged_tile<T, P, VEC>(k, v, row, ks, vs, live, qf, st, lane);
        entry = next;
      }
    }
  }
  if (spans == 1) {  // uniform per launch: the warp's row is whole
    if (live_pair)
      finish_row<T, VEC>(st, o + (static_cast<int64_t>(r) * heads + h) * D,
                         lse != nullptr ? lse + r * heads + h : nullptr,
                         lane);
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
    finish_row<T, VEC>(st, o + (static_cast<int64_t>(r) * heads + h) * D,
                       lse != nullptr ? lse + r * heads + h : nullptr, lane);
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
    T* __restrict__ o, float* __restrict__ lse) {
  constexpr int D = 32 * VEC;
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= rows * heads) return;  // uniform per warp
  const int64_t pg = static_cast<int64_t>(pair) * groups;
  const float* wml = ws + static_cast<int64_t>(rows) * heads * groups * D;
  RowState<VEC> st;
  merge_partials<VEC>(wml + pg * 2, wml + pg * 2 + 1, ws + pg * D, groups, 2,
                      D, st, lane);
  finish_row<T, VEC>(st, o + static_cast<int64_t>(pair) * D,
                     lse != nullptr ? lse + pair : nullptr, lane);
}

struct PagedArgs {
  const void* q;
  int64_t q_rs, q_hs;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* table;
  const int32_t* kv_len;
  const int32_t* row_slot;
  int rows, heads, num_slots, pages_per_slot, page_size, num_pages;
  float q_scale;
  int spans, span_len;
  void* o;
  float* lse;
  float* ws;
  cudaStream_t stream;
};

template <typename T, typename P, int VEC>
static void launch(const PagedArgs& a) {
  const int threads = 32 * kBlockWarps;
  const int64_t warps = static_cast<int64_t>(a.rows) * a.heads * a.spans;
  const int blocks = static_cast<int>((warps + kBlockWarps - 1) / kBlockWarps);
  decode_paged_kernel<T, P, VEC><<<blocks, threads, 0, a.stream>>>(
      static_cast<const T*>(a.q), a.q_rs, a.q_hs, static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), a.k_scale, a.v_scale, a.table, a.kv_len,
      a.row_slot, a.rows, a.heads, a.num_slots, a.pages_per_slot,
      a.page_size, a.num_pages, a.q_scale, a.spans, a.span_len,
      static_cast<T*>(a.o), a.lse, a.ws);
  if (a.spans > kBlockWarps) {
    const int pairs = a.rows * a.heads;
    decode_merge_kernel<T, VEC>
        <<<(pairs + kBlockWarps - 1) / kBlockWarps, threads, 0, a.stream>>>(
            a.ws, a.rows, a.heads, a.spans / kBlockWarps,
            static_cast<T*>(a.o), a.lse);
  }
}

template <typename T, typename P>
static int dispatch_dim(int head_dim, const PagedArgs& a) {
  switch (head_dim) {
    case 32: launch<T, P, 1>(a); return 0;
    case 64: launch<T, P, 2>(a); return 0;
    case 128: launch<T, P, 4>(a); return 0;
    case 256: launch<T, P, 8>(a); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P is the pool element type: T itself, or int8_t.
template <bool kInt8>
static int run(int dtype, int head_dim, const PagedArgs& a) {
  // spans: a power of two, every key of the capacity in one span, a
  // workspace where the blocks' partials need one
  const bool pow2 = a.spans > 0 && (a.spans & (a.spans - 1)) == 0;
  if (!pow2 || a.span_len <= 0 || a.span_len % 32 != 0 ||
      static_cast<int64_t>(a.spans) * a.span_len <
          static_cast<int64_t>(a.pages_per_slot) * a.page_size ||
      (a.spans > kBlockWarps && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kFloat32)
    rc = dispatch_dim<float, std::conditional_t<kInt8, int8_t, float>>(
        head_dim, a);
  else if (dtype == kBFloat16)
    rc = dispatch_dim<__nv_bfloat16,
                      std::conditional_t<kInt8, int8_t, __nv_bfloat16>>(
        head_dim, a);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

static PagedArgs make_args(const void* q, int64_t q_rs, int64_t q_hs,
                           const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const void* table,
                           const void* kv_len, const void* row_slot, int rows,
                           int heads, int num_slots, int pages_per_slot,
                           int page_size, int num_pages, float scale,
                           int spans, int span_len, void* o, void* lse,
                           void* ws, void* stream) {
  return PagedArgs{q, q_rs, q_hs, k, v,
                   static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale),
                   static_cast<const int32_t*>(table),
                   static_cast<const int32_t*>(kv_len),
                   static_cast<const int32_t*>(row_slot), rows, heads,
                   num_slots, pages_per_slot, page_size, num_pages,
                   scale * kLog2e, spans, span_len, o,
                   static_cast<float*>(lse), static_cast<float*>(ws),
                   static_cast<cudaStream_t>(stream)};
}

}  // namespace apex_port

// q: (rows, heads, head_dim) with unit dim stride; k/v: contiguous pools
// (num_pages, heads, page_size, head_dim) in q's dtype; table: contiguous
// (num_slots, pages_per_slot) int32; kv_len: (num_slots,) int32;
// row_slot: (rows,) int32 or null (row r reads slot r); spans, span_len:
// the key split (a power of two times a multiple of 32 covering
// pages_per_slot * page_size); o: contiguous (rows, heads, head_dim) in
// q's dtype; lse: contiguous (rows, heads) fp32 or null; ws: fp32
// workspace of rows * heads * (spans / 4) * (head_dim + 2) when spans > 4,
// else null. num_pages * heads * page_size must fit in an int.
extern "C" int flash_decode_paged(const void* q, int64_t q_row_stride,
                                  int64_t q_head_stride, const void* k,
                                  const void* v, const void* table,
                                  const void* kv_len, const void* row_slot,
                                  int rows, int heads, int head_dim,
                                  int num_slots, int pages_per_slot,
                                  int page_size, int num_pages, float scale,
                                  int spans, int span_len, int dtype, void* o,
                                  void* lse, void* ws, void* stream) {
  using namespace apex_port;
  return run<false>(
      dtype, head_dim,
      make_args(q, q_row_stride, q_head_stride, k, v, nullptr, nullptr,
                table, kv_len, row_slot, rows, heads, num_slots,
                pages_per_slot, page_size, num_pages, scale, spans, span_len,
                o, lse, ws, stream));
}

// As flash_decode_paged, with int8 pools and their contiguous
// (num_pages, heads) fp32 scales.
extern "C" int flash_decode_paged_int8(
    const void* q, int64_t q_row_stride, int64_t q_head_stride,
    const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* table, const void* kv_len, const void* row_slot, int rows,
    int heads, int head_dim, int num_slots, int pages_per_slot,
    int page_size, int num_pages, float scale, int spans, int span_len,
    int dtype, void* o, void* lse, void* ws, void* stream) {
  using namespace apex_port;
  return run<true>(
      dtype, head_dim,
      make_args(q, q_row_stride, q_head_stride, k, v, k_scale, v_scale,
                table, kv_len, row_slot, rows, heads, num_slots,
                pages_per_slot, page_size, num_pages, scale, spans, span_len,
                o, lse, ws, stream));
}
