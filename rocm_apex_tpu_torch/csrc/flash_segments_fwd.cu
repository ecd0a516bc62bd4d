// Segment-masked flash attention over a packed token stream, the training
// forward, for Hopper (sm_90a): o and the natural-log lse, for the backward
// of flash_segments_bwd.cu.
//
// Replaces rocm_apex_tpu/ops/flash_attention_segments.py:70
// `_seg_fwd_kernel` as `_seg_fwd` (:247) runs it for the differentiable
// `flash_attention_segments` (contrib/fmha's packed path): B = 1, the H
// heads of (H, total, D) operands, and the score rule of `_masked_scores`
// (:122) with its `seg` branch: q * (scale * log2 e) rounded in q's dtype,
// an fp32 product, and a key of another segment than the query's, or past
// it when causal, masked.
//
// bf16 runs on the forward pipe (flash_fwd_pipe.cuh) with kSeg, one split
// (the work of a query tile is set by the ids, which no plan reads): three
// pre-passes (flash_unpacked.cuh) write the (min, max) id of each 32-token
// tile (`ranges`, the `_prepare` ranges of :219), each 64-token tile's
// first and last meeting tile and the lengths of its walks (`tiles`) and
// the units' order, longest walk first (`order`); a unit then
// walks, in ascending order, the key tiles of [lo, hi] whose range meets
// its own (`_overlap`, :61) and that the causal triangle keeps. The test
// never skips a tile that holds a live pair, so ids in any order give the
// exact result; sorted ids (fmha's) make the walk visit no dead tile.
// fp32 runs on the CUDA-core body of flash_unpacked_fwd.cuh with kSeg.
//
// The serving path keeps its own per-row kernel (flash_segments.cu), which
// folds the scale in fp32.
#include "flash_fwd_pipe.cuh"
#include "flash_unpacked_fwd.cuh"

// q, k, v, o: (H, total, hd) through the element strides st[0..11] =
// (unused, head, token) of q, k, v, o (unit stride on hd; every stride and
// base 16-byte aligned); lse: contiguous (H, total) fp32; seg: (total,)
// int32; ws: an int32 workspace of 6 ceil(total / 64) + 2 ceil(total /
// 32) words (16-byte aligned). hd is a multiple of 8 up to 256 (on
// `at_width`'s width); q_mul is scale * log2(e)
// rounded to the operand dtype.
extern "C" int flash_segments_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const int64_t* st,
                                  const void* seg, void* ws, int H, int total,
                                  int hd, int causal, float q_mul,
                                  float scale, int dtype, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  Problem pb = make_problem(1, H, total, total, causal, nullptr, nullptr, 0,
                            0, 0u, 0u, 1.f, q_mul, scale, hd);
  pb.seg = static_cast<const int*>(seg);
  seg_workspace(pb, ws);
  if (!grid_ok(pb)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (is_half_code(dtype)) {
    rc = launch_seg_tiles(pb, s);
    if (rc != 0) return rc;
    const Strides sts[4] = {strides_at(st, 0), strides_at(st, 1),
                            strides_at(st, 2), strides_at(st, 3)};
    const int nt = (total + kTile - 1) / kTile;
    rc = with_half(dtype, [&](auto h) {
      return launch_pipe_fwd_hd<decltype(h), true>(
          q, k, v, o, lse, sts, pb, 1, nt > 0 ? nt : 1, nullptr, s);
    });
  } else {
    rc = launch_seg_ranges(seg, total, const_cast<int2*>(pb.ranges), s);
    if (rc != 0) return rc;
    rc = launch_fwd<true>(q, k, v, o, lse, st, pb, dtype, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
