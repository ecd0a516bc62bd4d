// Segment-masked flash attention over a packed token stream, the backward,
// for Hopper (sm_90a): dq, dk and dv for the forward of
// flash_segments_fwd.cu.
//
// Replaces rocm_apex_tpu/ops/flash_attention_segments.py:173
// `_seg_dq_kernel` (the dq pass) and :120 `_seg_dkv_kernel` (the dk/dv
// pass) as `_seg_bwd` (:281) runs them. It is the unpacked backward
// (flash_unpacked_bwd.cuh) with kSeg: the dq pass forms delta = rowsum(do *
// o) in fp32 and, per live key tile, p = exp2(s - lse log2 e), dp = do v^T,
// ds = p (dp - delta), dq += ds k; the dk/dv pass, per live 32-query tile
// (64 in fp32), dv += p^T do and dk += ds^T q with the unscaled q. dq and
// dk take the scale once at the end, as the JAX kernels do. s is the
// forward's score (`masked_score`, q * q_mul staged as the forward staged
// it), the tiles visited are those whose id ranges meet (recomputed here
// into `ranges`, as the forward does). A row or key past the stream
// scores -inf and adds exactly 0; nothing is padded.
#include "flash_unpacked_bwd.cuh"

// q, k, v, o, lse, seg as flash_segments_fwd took and wrote them; dout: the
// cotangent of o (H, total, hd); dq, dk, dv: outputs in the operand dtype;
// delta: an fp32 (H, total) workspace; ranges: the forward's workspace
// size. st[0..23]: the (unused, head, token) element strides of q, k, v, o,
// dout, dq, dk, dv (so dq/dk/dv may be views of one (total, 3, H, hd)
// gradient of a fused projection).
extern "C" int flash_segments_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* lse,
                                  const void* dout, void* dq, void* dk,
                                  void* dv, void* delta, const int64_t* st,
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
  const void* p[11] = {q, k, v, o, lse, dout, nullptr, dq, dk, dv, delta};
  rc = launch_bwd<true>(p, st, pb, hd, dtype, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
