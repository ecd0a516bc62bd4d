// Paged-cache decode read with lse, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:950 `_decode_paged_kernel`.
// The cache is a pool of pages per layer, (num_pages, heads, page_size,
// head_dim), and a (num_slots, pages_per_slot) int32 table maps each
// slot's positions onto pool pages. Each query row reads the prefix
// [0, kv_len[slot]) of ONE slot, bounded by the slots' key range (at
// most pages_per_slot * page_size), walking the slot's page list through
// the table. Two pool forms: the query's own dtype (fp32, bf16 or fp16), or
// int8 with one fp32 scale per (page, head).
//
// Bound: bytes (one FLOP per byte in bf16, two in int8). The read is the
// split-KV kernel of decode_split.cuh over `PagedKeys`; the contiguous
// read (flash_decode.cu) runs the same kernel over its cache, so under
// one plan the two give the same bits on the same keys.
#include "decode_split.cuh"

namespace apex_port {

struct PagedPools {
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* table;
  int pages_per_slot, page_size, num_pages, heads, hd;

  template <typename P, int D>
  PagedKeys<P, D> keys() const {
    return PagedKeys<P, D>{static_cast<const P*>(k),
                           static_cast<const P*>(v),
                           k_scale,
                           v_scale,
                           table,
                           pages_per_slot,
                           page_size,
                           num_pages,
                           heads,
                           hd};
  }
};

// P is the pool element type: T itself, or int8_t.
// on the width at or above the head dim, as flash_decode.cu's
template <typename T, typename P>
static int dispatch_dim(int head_dim, const SplitArgs& a,
                        const PagedPools& pp) {
  if (head_dim <= 32)
    launch_split<T, 1>(a, pp.keys<P, 32>());
  else if (head_dim <= 64)
    launch_split<T, 2>(a, pp.keys<P, 64>());
  else if (head_dim <= 128)
    launch_split<T, 4>(a, pp.keys<P, 128>());
  else
    launch_split<T, 8>(a, pp.keys<P, 256>());
  return 0;
}

template <bool kInt8>
static int run(int dtype, int head_dim, const SplitArgs& a,
               const PagedPools& pp) {
  if (!split_args_ok(a) ||
      a.capacity > static_cast<int64_t>(pp.pages_per_slot) * pp.page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == kFloat32)
    rc = dispatch_dim<float, std::conditional_t<kInt8, int8_t, float>>(
        head_dim, a, pp);
  else if (dtype == kBFloat16)
    rc = dispatch_dim<__nv_bfloat16,
                      std::conditional_t<kInt8, int8_t, __nv_bfloat16>>(
        head_dim, a, pp);
  else if (dtype == kFloat16)
    rc = dispatch_dim<__half, std::conditional_t<kInt8, int8_t, __half>>(
        head_dim, a, pp);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

static SplitArgs split_args(const void* q, int64_t q_rs, int64_t q_hs,
                            int hd, const void* kv_len, const void* row_slot,
                            int rows, int heads, int num_slots, int capacity,
                            float q_mul, int spans, int span_len, void* o,
                            void* lse, void* ws, void* stream) {
  return SplitArgs{q,         q_rs,
                   q_hs,      hd,
                   static_cast<const int32_t*>(kv_len),
                   static_cast<const int32_t*>(row_slot),
                   rows,      heads,
                   num_slots, capacity,
                   q_mul,
                   spans,     span_len,
                   o,         static_cast<float*>(lse),
                   static_cast<float*>(ws),
                   static_cast<cudaStream_t>(stream)};
}

}  // namespace apex_port

// q: (rows, heads, head_dim) with unit dim stride; k/v: contiguous pools
// (num_pages, heads, page_size, head_dim) in q's dtype; table: contiguous
// (num_slots, pages_per_slot) int32; kv_len: (num_slots,) int32;
// row_slot: (rows,) int32 or null (row r reads slot r); capacity: the
// slots' key range, at most pages_per_slot * page_size (bounds clamp to
// it); spans, span_len: the key split (a power of two times a multiple of
// 32 covering the capacity); o: contiguous (rows, heads, head_dim) in q's
// dtype; lse: contiguous (rows, heads) fp32 or null; ws: fp32 workspace
// of rows * heads * (spans / 4) * (head_dim + 2) when spans > 4, else
// null. q_mul is scale * log2(e) rounded to q's dtype (as for
// flash_decode). num_pages * heads * page_size must fit in an int.
extern "C" int flash_decode_paged(const void* q, int64_t q_row_stride,
                                  int64_t q_head_stride, const void* k,
                                  const void* v, const void* table,
                                  const void* kv_len, const void* row_slot,
                                  int rows, int heads, int head_dim,
                                  int num_slots, int pages_per_slot,
                                  int page_size, int num_pages, int capacity,
                                  float q_mul, int spans, int span_len,
                                  int dtype, void* o, void* lse, void* ws,
                                  void* stream) {
  using namespace apex_port;
  return run<false>(
      dtype, head_dim,
      split_args(q, q_row_stride, q_head_stride, head_dim, kv_len, row_slot,
                 rows, heads, num_slots, capacity, q_mul, spans, span_len, o,
                 lse, ws, stream),
      PagedPools{k, v, nullptr, nullptr, static_cast<const int32_t*>(table),
                 pages_per_slot, page_size, num_pages, heads, head_dim});
}

// As flash_decode_paged, with int8 pools and their contiguous
// (num_pages, heads) fp32 scales.
extern "C" int flash_decode_paged_int8(
    const void* q, int64_t q_row_stride, int64_t q_head_stride,
    const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* table, const void* kv_len, const void* row_slot, int rows,
    int heads, int head_dim, int num_slots, int pages_per_slot,
    int page_size, int num_pages, int capacity, float q_mul, int spans,
    int span_len, int dtype, void* o, void* lse, void* ws, void* stream) {
  using namespace apex_port;
  return run<true>(
      dtype, head_dim,
      split_args(q, q_row_stride, q_head_stride, head_dim, kv_len, row_slot,
                 rows, heads, num_slots, capacity, q_mul, spans, span_len, o,
                 lse, ws, stream),
      PagedPools{k, v, static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int32_t*>(table), pages_per_slot,
                 page_size, num_pages, heads, head_dim});
}
