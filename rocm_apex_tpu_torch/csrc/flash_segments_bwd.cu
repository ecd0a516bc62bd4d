// Segment-masked flash attention over a packed token stream, the backward,
// for Hopper (sm_90a): dq, dk and dv for the forward of
// flash_segments_fwd.cu.
//
// Replaces rocm_apex_tpu/ops/flash_attention_segments.py:173
// `_seg_dq_kernel` (the dq pass) and :120 `_seg_dkv_kernel` (the dk/dv
// pass) as `_seg_bwd` (:281) runs them: the dq pass forms delta =
// rowsum(do * o) in fp32 and, per live key tile, p = exp2(s - lse log2 e),
// dp = do v^T, ds = p (dp - delta), dq += ds k; the dk/dv pass, per live
// query tile, dv += p^T do and dk += ds^T q with the unscaled q. dq and dk
// take the scale once at the end, as the JAX kernels do. s is the
// forward's score (q * q_mul staged as the forward staged it). A row or key
// past the stream scores -inf and adds exactly 0; nothing is padded.
//
// bf16 runs on the backward pipe (flash_bwd_pipe.cuh) with kSeg: the
// forward's pre-passes, recomputed here, then the dq pass, which hands the
// dk/dv pass each row's (lse log2 e, delta), and the dk/dv pass, each
// walking the live tiles of [lo, hi] as the forward walks them (the dk/dv
// pass from the causal bound on). fp32 runs on the CUDA-core bodies of
// flash_unpacked_bwd.cuh with kSeg.
#include "flash_bwd_pipe.cuh"
#include "flash_unpacked_bwd.cuh"

// q, k, v, o, lse, seg as flash_segments_fwd took and wrote them; dout: the
// cotangent of o (H, total, hd); dq, dk, dv: outputs in the operand dtype;
// stats: bf16, an fp32 scratch of (H, 64 ceil(total / 64), 2) (lse log2 e,
// delta) pairs; fp32, one of (H, total), delta alone; ws: the forward's
// workspace size. st[0..23]: the (unused, head, token) element strides of
// q, k, v, o, dout, dq, dk, dv (so dq/dk/dv may be views of one (total,
// 3, H, hd) gradient of a fused projection).
extern "C" int flash_segments_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* lse,
                                  const void* dout, void* dq, void* dk,
                                  void* dv, void* stats, const int64_t* st,
                                  const void* seg, void* ws, int H, int total,
                                  int hd, int causal, float q_mul,
                                  float scale, int dtype, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  Problem pb = make_problem(1, H, total, total, causal, nullptr, nullptr, 0,
                            0, 0u, 0u, 1.f, q_mul, scale, hd);
  pb.seg = static_cast<const int*>(seg);
  seg_workspace(pb, ws);
  if (!grid_ok(pb) || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (is_half_code(dtype)) {
    rc = launch_seg_tiles(pb, s);
    if (rc != 0) return rc;
    rc = with_half(dtype, [&](auto h) {
      using T = decltype(h);
      const BwdArgs<T> a{static_cast<const T*>(q),
                         static_cast<const T*>(k),
                         static_cast<const T*>(v),
                         static_cast<const T*>(o),
                         static_cast<const T*>(dout),
                         static_cast<const float*>(lse),
                         static_cast<float*>(stats),
                         static_cast<T*>(dq),
                         static_cast<T*>(dk),
                         static_cast<T*>(dv),
                         nullptr,
                         strides_at(st, 0),
                         strides_at(st, 1),
                         strides_at(st, 2),
                         strides_at(st, 3),
                         strides_at(st, 4),
                         strides_at(st, 5),
                         strides_at(st, 6),
                         strides_at(st, 7),
                         Strides{0, 0, 0}};
      return launch_pipe_bwd_hd<false, true>(a, pb, s);
    });
  } else {
    rc = launch_seg_ranges(seg, total, const_cast<int2*>(pb.ranges), s);
    if (rc != 0) return rc;
    const void* p[11] = {q, k, v, o, lse, dout, nullptr, dq, dk, dv, stats};
    rc = launch_bwd<true>(p, st, pb, dtype, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
