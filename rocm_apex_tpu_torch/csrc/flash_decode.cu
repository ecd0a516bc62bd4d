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
// Bound: bytes. A decode row does 2 FLOPs per byte of K/V it reads, far
// below the ~295 FLOP/byte where Hopper's tensor cores would bind, so the
// design reads each live key row once per (row, head) with coalesced
// 32*VEC-element warp loads and never touches the capacity tail past the
// row's bound. One warp per (row, head); keys in tiles of 32 (see
// attention_row.cuh).
#include "attention_row.cuh"

namespace apex_port {

template <typename T, int VEC>
__global__ void __launch_bounds__(128)
    decode_kernel(const T* __restrict__ q, int64_t q_row_stride,
                  int64_t q_head_stride, const T* __restrict__ k,
                  const T* __restrict__ v, int64_t c_slot_stride,
                  int64_t c_pos_stride, int64_t c_head_stride,
                  const int32_t* __restrict__ kv_len,
                  const int32_t* __restrict__ row_slot, int rows, int heads,
                  int num_slots, int capacity, float q_scale,
                  T* __restrict__ o, float* __restrict__ lse) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * heads) return;  // uniform per warp
  const int r = warp / heads;
  const int h = warp - r * heads;
  constexpr int D = 32 * VEC;

  const int slot = row_slot != nullptr ? row_slot[r] : r;
  int bound = 0;
  if (slot >= 0 && slot < num_slots)
    bound = min(max(kv_len[slot], 0), capacity);

  float qf[VEC];
  load_vec<T, VEC>(q + r * q_row_stride + h * q_head_stride + lane * VEC, qf);
#pragma unroll
  for (int c = 0; c < VEC; ++c) qf[c] *= q_scale;

  RowState<VEC> st;
  st.init();
  if (bound > 0) {
    const int64_t base = static_cast<int64_t>(slot) * c_slot_stride +
                         static_cast<int64_t>(h) * c_head_stride + lane * VEC;
    for (int t0 = 0; t0 < bound; t0 += 32) {
      const int n = min(32, bound - t0);
      const uint32_t live = n == 32 ? kFullMask : ((1u << n) - 1u);
      const int64_t off = base + static_cast<int64_t>(t0) * c_pos_stride;
      attend_tile<T, VEC>(k + off, c_pos_stride, v + off, c_pos_stride, live,
                          n - 1, qf, st, lane);
    }
  }
  finish_row<T, VEC>(st, o + (static_cast<int64_t>(r) * heads + h) * D,
                     lse != nullptr ? lse + r * heads + h : nullptr, lane);
}

template <typename T, int VEC>
static void launch(const void* q, int64_t q_rs, int64_t q_hs, const void* k,
                   const void* v, int64_t c_ss, int64_t c_ps, int64_t c_hs,
                   const int32_t* kv_len, const int32_t* row_slot, int rows,
                   int heads, int num_slots, int capacity, float q_scale,
                   void* o, float* lse, cudaStream_t stream) {
  const int warps = rows * heads;
  const int threads = 128;
  const int blocks = (warps * 32 + threads - 1) / threads;
  decode_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(q), q_rs, q_hs, static_cast<const T*>(k),
      static_cast<const T*>(v), c_ss, c_ps, c_hs, kv_len, row_slot, rows,
      heads, num_slots, capacity, q_scale, static_cast<T*>(o), lse);
}

template <typename T>
static int dispatch_dim(int head_dim, const void* q, int64_t q_rs,
                        int64_t q_hs, const void* k, const void* v,
                        int64_t c_ss, int64_t c_ps, int64_t c_hs,
                        const int32_t* kv_len, const int32_t* row_slot,
                        int rows, int heads, int num_slots, int capacity,
                        float q_scale, void* o, float* lse,
                        cudaStream_t stream) {
  switch (head_dim) {
#define APEX_DECODE_CASE(V)                                                  \
  case 32 * V:                                                               \
    launch<T, V>(q, q_rs, q_hs, k, v, c_ss, c_ps, c_hs, kv_len, row_slot,    \
                 rows, heads, num_slots, capacity, q_scale, o, lse, stream); \
    return 0;
    APEX_DECODE_CASE(1)
    APEX_DECODE_CASE(2)
    APEX_DECODE_CASE(4)
    APEX_DECODE_CASE(8)
#undef APEX_DECODE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace apex_port

// q: (rows, heads, head_dim) with unit dim stride; k/v: the cache buffers
// (num_slots, capacity, heads, head_dim) with unit dim stride; kv_len:
// (num_slots,) int32; row_slot: (rows,) int32 or null (row r reads slot
// r); o: contiguous (rows, heads, head_dim) in q's dtype; lse: contiguous
// (rows, heads) fp32 or null.
extern "C" int flash_decode(const void* q, int64_t q_row_stride,
                            int64_t q_head_stride, const void* k,
                            const void* v, int64_t c_slot_stride,
                            int64_t c_pos_stride, int64_t c_head_stride,
                            const void* kv_len, const void* row_slot,
                            int rows, int heads, int head_dim, int num_slots,
                            int capacity, float scale, int dtype, void* o,
                            void* lse, void* stream) {
  using namespace apex_port;
  const float q_scale = scale * kLog2e;
  const auto* lens = static_cast<const int32_t*>(kv_len);
  const auto* slots = static_cast<const int32_t*>(row_slot);
  auto* lse_f = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kFloat32)
    rc = dispatch_dim<float>(head_dim, q, q_row_stride, q_head_stride, k, v,
                             c_slot_stride, c_pos_stride, c_head_stride, lens,
                             slots, rows, heads, num_slots, capacity, q_scale,
                             o, lse_f, s);
  else if (dtype == kBFloat16)
    rc = dispatch_dim<__nv_bfloat16>(
        head_dim, q, q_row_stride, q_head_stride, k, v, c_slot_stride,
        c_pos_stride, c_head_stride, lens, slots, rows, heads, num_slots,
        capacity, q_scale, o, lse_f, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
