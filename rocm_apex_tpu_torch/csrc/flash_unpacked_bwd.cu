// Unpacked flash-attention backward for Hopper (sm_90a): the gradients of
// q, k and v for the forward of flash_unpacked_fwd.cu. bf16 and fp16 run
// on the wgmma backward pipe (flash_bwd_pipe.cuh, the pipe of the packed
// backward, with the fp32 score bias and the lse cotangent), fp32 on the
// CUDA cores (flash_unpacked_bwd.cuh). The host plan is
// `flash_unpacked_bwd_plan` (ops/flash_attention.py).
#include "flash_bwd_pipe.cuh"
#include "flash_unpacked_bwd.cuh"

namespace apex_port {
namespace unpacked {

template <typename T>
int launch_unpacked_pipe(const BwdArgs<T>& a, const Problem& pb,
                                cudaStream_t stream) {
  return pb.bias != nullptr ? launch_pipe_bwd_hd<true>(a, pb, stream)
                            : launch_pipe_bwd_hd<false>(a, pb, stream);
}

}  // namespace unpacked
}  // namespace apex_port

// q, k, v, o, lse as flash_unpacked_fwd took and wrote them; dout: the
// cotangent of o; dlse: the (B*H, Sq) fp32 cotangent of lse, or null; dq,
// dk, dv: outputs in the operand dtype. stats: bf16, an fp32 scratch of
// (B*H, 64 ceil(Sq/64), 2) (lse log2 e, delta) pairs the dq pass hands the
// dk/dv pass; fp32, one of (B*H, Sq), delta = rowsum(do * o) - dlse
// alone, which flash_dbias then reads. delta: bf16, null or an fp32 (B*H,
// Sq) output of delta (for flash_dbias); fp32, null (the stats are
// delta). st[0..23]: the (batch, head, row) element strides of q, k, v,
// o, dout, dq, dk, dv. The rest as flash_unpacked_fwd.
extern "C" int flash_unpacked_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, const void* dlse, void* dq, void* dk,
    void* dv, void* stats, void* delta, const int64_t* st, const void* bias,
    int nb, const void* lens, int B, int H, int Sq, int Sk, int hd,
    int causal, int dropout, unsigned seed, unsigned thr, float keep_scale,
    float q_mul, float scale, int dtype, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  const Problem pb = make_problem(B, H, Sq, Sk, causal, lens, bias, nb,
                                  dropout, seed, thr, keep_scale, q_mul,
                                  scale, hd);
  if (!grid_ok(pb) || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (is_half_code(dtype)) {
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
                         Strides{0, 0, 0},
                         static_cast<const float*>(dlse),
                         static_cast<float*>(delta)};
      return launch_unpacked_pipe(a, pb, s);
    });
  } else if (dtype == kFloat32 && delta == nullptr) {
    const void* p[11] = {q, k, v, o, lse, dout, dlse, dq, dk, dv, stats};
    rc = launch_bwd<false>(p, st, pb, dtype, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
