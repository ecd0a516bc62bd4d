// Unpacked flash-attention backward for Hopper (sm_90a): the gradients of
// q, k and v for the forward of flash_unpacked_fwd.cu. The kernels are in
// flash_unpacked_bwd.cuh.
#include "flash_unpacked_bwd.cuh"

// q, k, v, o, lse as flash_unpacked_fwd took and wrote them; dout: the
// cotangent of o; dlse: the (B*H, Sq) fp32 cotangent of lse, or null; dq,
// dk, dv: outputs in the operand dtype; delta: an fp32 (B*H, Sq) output
// (rowsum(do * o) - dlse, read by the dk/dv pass and flash_dbias).
// st[0..23]: the (batch, head, row) element strides of q, k, v, o, dout,
// dq, dk, dv. The rest as flash_unpacked_fwd.
extern "C" int flash_unpacked_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, const void* dlse, void* dq, void* dk,
    void* dv, void* delta, const int64_t* st, const void* bias, int nb,
    const void* lens, int B, int H, int Sq, int Sk, int hd, int causal,
    int dropout, unsigned seed, unsigned thr, float keep_scale, float q_mul,
    float scale, int dtype, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  const Problem pb = make_problem(B, H, Sq, Sk, causal, lens, bias, nb,
                                  dropout, seed, thr, keep_scale, q_mul,
                                  scale);
  if (!grid_ok(pb)) return static_cast<int>(cudaErrorInvalidValue);
  const void* p[11] = {q, k, v, o, lse, dout, dlse, dq, dk, dv, delta};
  const int rc = launch_bwd<false>(p, st, pb, hd, dtype,
                                   static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
