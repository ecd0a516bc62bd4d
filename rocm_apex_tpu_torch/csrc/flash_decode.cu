// Cache-prefix decode read with lse, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:813 `_decode_kernel`.
// Each query row reads the K/V prefix [0, kv_len[slot]) of ONE cache
// slot, in place, from the cache's (num_slots, capacity, heads, head_dim)
// layout through strides: no transposed copy of the cache, and a row
// reads only its own slot (the chunked-prefill piece B passes a slot id
// per chunk token; the decode grid reads slot r for row r). Rows whose
// slot is out of range (chunk padding) or whose prefix is empty emit
// zeros and lse = -1e30.
//
// Bound: bytes (2 FLOPs per K/V byte). The read is the split-KV kernel
// of decode_split.cuh over `CacheKeys`, the paged read's own code
// (flash_decode_paged.cu): the host plans the same split for both
// (`decode_span_plan`), so a contiguous and a paged cache holding the
// same keys give the same bits. With one span (piece B) a warp walks its
// (row, head)'s whole prefix, 32 keys a tile.
#include "decode_split.cuh"

namespace apex_port {

// the warp's width: the smallest of 32, 64, 128, 256 at or above the head
// dim (split_args_ok has checked it: a multiple of 8 up to 256)
template <typename T>
static int dispatch_dim(int head_dim, const SplitArgs& a,
                        const CacheKeys<T>& keys) {
  if (head_dim <= 32)
    launch_split<T, 1>(a, keys);
  else if (head_dim <= 64)
    launch_split<T, 2>(a, keys);
  else if (head_dim <= 128)
    launch_split<T, 4>(a, keys);
  else
    launch_split<T, 8>(a, keys);
  return 0;
}

}  // namespace apex_port

// q: (rows, heads, head_dim) with unit dim stride; k/v: the cache buffers
// (num_slots, capacity, heads, head_dim) with unit dim stride and one
// layout; kv_len: (num_slots,) int32; row_slot: (rows,) int32 or null
// (row r reads slot r); spans, span_len, ws: the key split and its
// workspace, as flash_decode_paged takes them; o: contiguous (rows,
// heads, head_dim) in q's dtype; lse: contiguous (rows, heads) fp32 or
// null. q_mul is scale * log2(e) rounded to q's dtype: each row of q is
// multiplied by it and rounded to that dtype as it is loaded.
extern "C" int flash_decode(const void* q, int64_t q_row_stride,
                            int64_t q_head_stride, const void* k,
                            const void* v, int64_t c_slot_stride,
                            int64_t c_pos_stride, int64_t c_head_stride,
                            const void* kv_len, const void* row_slot,
                            int rows, int heads, int head_dim, int num_slots,
                            int capacity, float q_mul, int spans,
                            int span_len, int dtype, void* o, void* lse,
                            void* ws, void* stream) {
  using namespace apex_port;
  const SplitArgs a{q,
                    q_row_stride,
                    q_head_stride,
                    head_dim,
                    static_cast<const int32_t*>(kv_len),
                    static_cast<const int32_t*>(row_slot),
                    rows,
                    heads,
                    num_slots,
                    capacity,
                    q_mul,
                    spans,
                    span_len,
                    o,
                    static_cast<float*>(lse),
                    static_cast<float*>(ws),
                    static_cast<cudaStream_t>(stream)};
  if (!split_args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pos = c_pos_stride;
  int rc;
  if (dtype == kFloat32)
    rc = dispatch_dim<float>(
        head_dim, a,
        CacheKeys<float>{static_cast<const float*>(k),
                         static_cast<const float*>(v), c_slot_stride, pos,
                         c_head_stride});
  else if (dtype == kBFloat16)
    rc = dispatch_dim<__nv_bfloat16>(
        head_dim, a,
        CacheKeys<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(k),
                                 static_cast<const __nv_bfloat16*>(v),
                                 c_slot_stride, pos, c_head_stride});
  else if (dtype == kFloat16)
    rc = dispatch_dim<__half>(
        head_dim, a,
        CacheKeys<__half>{static_cast<const __half*>(k),
                          static_cast<const __half*>(v), c_slot_stride, pos,
                          c_head_stride});
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
