// Unpacked flash-attention forward for Hopper (sm_90a): (B*H, S, D)
// operands, an additive fp32 bias, per-row key lengths, causal masking and
// in-kernel dropout. The kernels are in flash_unpacked_fwd.cuh.
#include "flash_unpacked_fwd.cuh"

// q (B, H, Sq, hd), k/v (B, H, Sk, hd), o (B, H, Sq, hd) through the
// element strides st[0..11] = (batch, head, row) of q, k, v, o (unit
// stride on hd; every stride and base 16-byte aligned); lse: contiguous
// (B*H, Sq) fp32. bias: contiguous (nb, Sq, Sk) fp32 or null; lens: (B*H,)
// int32 or null. hd is 64 or 128. dropout != 0 drops p with keep bit
// hash(seed, b*H + h, query, key) >= thr and scale keep_scale. q_mul is
// scale * log2(e) rounded to the operand dtype.
extern "C" int flash_unpacked_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const int64_t* st,
                                  const void* bias, int nb, const void* lens,
                                  int B, int H, int Sq, int Sk, int hd,
                                  int causal, int dropout, unsigned seed,
                                  unsigned thr, float keep_scale, float q_mul,
                                  float scale, int dtype, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  const Problem pb = make_problem(B, H, Sq, Sk, causal, lens, bias, nb,
                                  dropout, seed, thr, keep_scale, q_mul,
                                  scale);
  if (!grid_ok(pb)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_fwd<false>(q, k, v, o, lse, st, pb, hd, dtype,
                                   static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
