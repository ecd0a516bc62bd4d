// Segment-masked flash attention over a packed token stream, the training
// forward, for Hopper (sm_90a): o and the natural-log lse, for the backward
// of flash_segments_bwd.cu.
//
// Replaces rocm_apex_tpu/ops/flash_attention_segments.py:70
// `_seg_fwd_kernel` as `_seg_fwd` (:247) runs it for the differentiable
// `flash_attention_segments` (contrib/fmha's packed path). It is the
// unpacked forward (flash_unpacked_fwd.cuh) with kSeg: B = 1, the H heads of
// (H, total, D) operands, and the score rule of `_masked_scores` (:122)
// with its `seg` branch, flash_unpacked.cuh's `masked_score`: q * (scale *
// log2 e) rounded in q's dtype, an fp32 product, and a key of another
// segment than the query's, or past it when causal, masked. Before the
// forward, one warp per 32 tokens writes the (min, max) id of its tokens
// (`ranges`, the `_prepare` ranges of :219); a 64-query block then visits
// only the key tiles whose range meets its own (`_overlap`, :61) and that
// the causal triangle keeps. The test never skips a tile that holds a live
// pair, so ids in any order give the exact result; sorted ids (fmha's)
// make it exact coverage.
//
// The serving path keeps its own per-row kernel (flash_segments.cu), which
// folds the scale in fp32.
#include "flash_unpacked_fwd.cuh"

// q, k, v, o: (H, total, hd) through the element strides st[0..11] =
// (unused, head, token) of q, k, v, o (unit stride on hd; every stride and
// base 16-byte aligned); lse: contiguous (H, total) fp32; seg: (total,)
// int32; ranges: an int32 workspace of 2 * ceil(total / 32). hd is 64 or
// 128; q_mul is scale * log2(e) rounded to the operand dtype.
extern "C" int flash_segments_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const int64_t* st,
                                  const void* seg, void* ranges, int H,
                                  int total, int hd, int causal, float q_mul,
                                  float scale, int dtype, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  Problem pb = make_problem(1, H, total, total, causal, nullptr, nullptr, 0,
                            0, 0u, 0u, 1.f, q_mul, scale);
  pb.seg = static_cast<const int*>(seg);
  pb.ranges = static_cast<const int2*>(ranges);
  if (!grid_ok(pb)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int rc = launch_seg_ranges(seg, total, ranges, s);
  if (rc != 0) return rc;
  rc = launch_fwd<true>(q, k, v, o, lse, st, pb, hd, dtype, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
