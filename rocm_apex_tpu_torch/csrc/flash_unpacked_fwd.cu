// Unpacked flash-attention forward for Hopper (sm_90a): (B*H, S, D)
// operands, an additive fp32 bias, per-row key lengths, causal masking and
// in-kernel dropout. bf16 and fp16 run on the wgmma pipe
// (flash_fwd_pipe.cuh), fp32 on the CUDA cores (flash_unpacked_fwd.cuh).
#include "flash_fwd_pipe.cuh"
#include "flash_unpacked_fwd.cuh"

// q (B, H, Sq, hd), k/v (B, H, Sk, hd), o (B, H, Sq, hd) through the
// element strides st[0..11] = (batch, head, row) of q, k, v, o (unit
// stride on hd; every stride and base 16-byte aligned); lse: contiguous
// (B*H, Sq) fp32. bias: contiguous (nb, Sq, Sk) fp32 or null; lens: (B*H,)
// int32 or null. hd is a multiple of 8 up to 256 (the wrapper pads
// another; `head_dim_plan`). dropout != 0 drops p with keep bit
// hash(seed, b*H + h, query, key) >= thr and scale keep_scale. q_mul is
// scale * log2(e) rounded to the operand dtype. bf16: splits and
// split_tiles are the plan's key split (flash_fwd_plan), ws its fp32
// workspace when splits > 1, else null; fp32 ignores them.
extern "C" int flash_unpacked_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const int64_t* st,
                                  const void* bias, int nb, const void* lens,
                                  int B, int H, int Sq, int Sk, int hd,
                                  int causal, int dropout, unsigned seed,
                                  unsigned thr, float keep_scale, float q_mul,
                                  float scale, int splits, int split_tiles,
                                  void* ws, int dtype, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  const Problem pb = make_problem(B, H, Sq, Sk, causal, lens, bias, nb,
                                  dropout, seed, thr, keep_scale, q_mul,
                                  scale, hd);
  if (B * H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (is_half_code(dtype)) {
    const Strides sts[4] = {strides_at(st, 0), strides_at(st, 1),
                            strides_at(st, 2), strides_at(st, 3)};
    rc = with_half(dtype, [&](auto h) {
      return launch_pipe_fwd_hd<decltype(h)>(q, k, v, o, lse, sts, pb, splits,
                                             split_tiles, ws, s);
    });
  } else {
    if (!grid_ok(pb)) return static_cast<int>(cudaErrorInvalidValue);
    rc = launch_fwd<false>(q, k, v, o, lse, st, pb, dtype, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
