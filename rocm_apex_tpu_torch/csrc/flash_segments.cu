// Segment-masked packed attention with lse, for Hopper (sm_90a).
//
// Replaces rocm_apex_tpu/ops/flash_attention_segments.py:70
// `_seg_fwd_kernel`. q/k/v are (heads, total, head_dim) views over the
// packed token stream (any head/token strides, unit dim stride, so the
// chunk's slices of the fused QKV projection are read without a copy);
// token i attends token j iff seg[i] == seg[j] (and j <= i when causal).
// Outputs o (heads, total, head_dim) in q's dtype and the natural-log
// lse (heads, total). The scores are `_masked_scores`' (rocm_apex_tpu/ops/
// flash_attention.py:122): q times q_mul = scale * log2(e) in q's dtype,
// the product rounded to that dtype as the row is loaded, then the fp32
// product with k.
//
// Bound: at the serving chunk (8 heads x 256 tokens x 128 dims) the
// whole call moves under 2 MB and does under 0.3 GFLOP, so launch
// latency and the per-row serial key walk bound it, not bytes or the
// tensor cores. One warp per (head, query row); keys in tiles of 32 (see
// attention_row.cuh). The skip is exact per (row, tile): a warp ballots
// the tile's segment ids against its own and skips a tile with no match
// without loading its K/V; within a tile every key is read and the
// other segments' keys are masked.
// The test is on the ids themselves, so it holds for any order of the
// ids: the engine packs slot pieces in scheduler order and pads carry
// the id num_slots.
#include "attention_row.cuh"

namespace apex_port {

template <typename T, int VEC>
__global__ void __launch_bounds__(128)
    segments_kernel(const T* __restrict__ q, int64_t q_hs, int64_t q_ts,
                    const T* __restrict__ k, int64_t k_hs, int64_t k_ts,
                    const T* __restrict__ v, int64_t v_hs, int64_t v_ts,
                    const int32_t* __restrict__ seg, int heads, int total,
                    int causal, float q_mul, T* __restrict__ o,
                    float* __restrict__ lse, int hd) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= heads * total) return;  // uniform per warp
  const int h = warp / total;
  const int i = warp - h * total;
  const bool dims = lane * VEC < hd;  // this lane's dims inside the head

  float qf[VEC] = {};
  if (dims) load_vec<T, VEC>(q + h * q_hs + i * q_ts + lane * VEC, qf);
#pragma unroll
  for (int c = 0; c < VEC; ++c) qf[c] = round_to<T>(qf[c] * q_mul);

  const int my_seg = seg[i];
  const int kend = causal ? i + 1 : total;
  const T* k_head = k + h * k_hs + lane * VEC;
  const T* v_head = v + h * v_hs + lane * VEC;

  RowState<VEC> st;
  st.init();
  for (int t0 = 0; t0 < kend; t0 += 32) {
    const int j = t0 + lane;
    const bool hit = j < kend && seg[j] == my_seg;
    const uint32_t live = __ballot_sync(kFullMask, hit);
    if (live == 0u) continue;
    attend_tile<T, VEC>(k_head + t0 * k_ts, k_ts, v_head + t0 * v_ts, v_ts,
                        live, min(31, kend - 1 - t0), qf, st, lane, dims);
  }
  finish_row<T, VEC>(st, o + (static_cast<int64_t>(h) * total + i) * hd,
                     lse + static_cast<int64_t>(h) * total + i, lane, dims);
}

template <typename T, int VEC>
static void launch(const void* q, int64_t q_hs, int64_t q_ts, const void* k,
                   int64_t k_hs, int64_t k_ts, const void* v, int64_t v_hs,
                   int64_t v_ts, const int32_t* seg, int heads, int total,
                   int causal, float q_mul, void* o, float* lse, int hd,
                   cudaStream_t stream) {
  const int warps = heads * total;
  const int threads = 128;
  const int blocks = (warps * 32 + threads - 1) / threads;
  segments_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(q), q_hs, q_ts, static_cast<const T*>(k), k_hs,
      k_ts, static_cast<const T*>(v), v_hs, v_ts, seg, heads, total, causal,
      q_mul, static_cast<T*>(o), lse, hd);
  note_launch("segments_kernel");
}

template <typename T>
static int dispatch_dim(int head_dim, const void* q, int64_t q_hs,
                        int64_t q_ts, const void* k, int64_t k_hs,
                        int64_t k_ts, const void* v, int64_t v_hs,
                        int64_t v_ts, const int32_t* seg, int heads,
                        int total, int causal, float q_mul, void* o,
                        float* lse, cudaStream_t stream) {
  // the warp's width: the smallest of 32, 64, 128, 256 at or above it
  if (head_dim < 8 || head_dim > 256 || head_dim % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define APEX_SEG_LAUNCH(V)                                                  \
  launch<T, V>(q, q_hs, q_ts, k, k_hs, k_ts, v, v_hs, v_ts, seg, heads,     \
               total, causal, q_mul, o, lse, head_dim, stream)
  if (head_dim <= 32)
    APEX_SEG_LAUNCH(1);
  else if (head_dim <= 64)
    APEX_SEG_LAUNCH(2);
  else if (head_dim <= 128)
    APEX_SEG_LAUNCH(4);
  else
    APEX_SEG_LAUNCH(8);
#undef APEX_SEG_LAUNCH
  return 0;
}

}  // namespace apex_port

// q/k/v: (heads, total, head_dim) views, unit dim stride; seg: (total,)
// int32; o: contiguous (heads, total, head_dim) in q's dtype; lse:
// contiguous (heads, total) fp32. q_mul is scale * log2(e) rounded to q's
// dtype.
extern "C" int flash_segments(const void* q, int64_t q_hs, int64_t q_ts,
                              const void* k, int64_t k_hs, int64_t k_ts,
                              const void* v, int64_t v_hs, int64_t v_ts,
                              const void* seg, int heads, int total,
                              int head_dim, int causal, float q_mul,
                              int dtype, void* o, void* lse, void* stream) {
  using namespace apex_port;
  const auto* ids = static_cast<const int32_t*>(seg);
  auto* lse_f = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kFloat32)
    rc = dispatch_dim<float>(head_dim, q, q_hs, q_ts, k, k_hs, k_ts, v, v_hs,
                             v_ts, ids, heads, total, causal, q_mul, o,
                             lse_f, s);
  else if (dtype == kBFloat16)
    rc = dispatch_dim<__nv_bfloat16>(head_dim, q, q_hs, q_ts, k, k_hs, k_ts,
                                     v, v_hs, v_ts, ids, heads, total,
                                     causal, q_mul, o, lse_f, s);
  else if (dtype == kFloat16)
    rc = dispatch_dim<__half>(head_dim, q, q_hs, q_ts, k, k_hs, k_ts, v, v_hs,
                              v_ts, ids, heads, total, causal, q_mul, o,
                              lse_f, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
