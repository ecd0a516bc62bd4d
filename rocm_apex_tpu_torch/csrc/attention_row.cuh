// One warp, one query row: the online-softmax core shared by the
// split decode read (decode_split.cuh, which resolves its keys' rows
// itself) and the segment-masked chunk attention (flash_segments.cu).
//
// Lane l owns head dims [l*VEC, (l+1)*VEC) of the query, the
// accumulator and every key/value row it reads, so a warp reads one
// key row as one contiguous 32*VEC-element span (coalesced). Keys are
// visited in tiles of 32. For a tile, each lane first forms its partial
// dot products against all 32 keys (independent loads and FMAs), then a
// five-step butterfly hands lane j the full score of key j with 31
// shuffles in all (instead of 32 separate warp reductions). The softmax
// runs in the base-2 domain, like the TPU kernels: the query is
// pre-scaled by scale*log2(e). Each p is rounded to the operand type
// before it weighs its value row, against the running max after its
// tile, as the TPU kernels round p after each key block (`p.astype(
// v.dtype)`); l sums the unrounded p.
//
// `live` (warp-uniform) says which keys of the tile the row attends;
// keys past `last` (the tile's last in-range key) are not part of the
// row. Every key of the tile is LOADED, those past `last` clamped onto
// key `last`, and the dead ones are masked in the scores: with no
// branch around them the 32 loads are independent, so the warp sends
// them back to back and waits on memory about once per tile. (Behind a
// per-key branch each load went out only after the previous key's FMAs,
// that is after its data arrived: one memory latency per key, measured
// at ~23 us per 32-key tile on the H100.) A tile with no live key must
// not be passed in (the callers skip it), so after the first call the
// running max is a real score. Dead keys weigh exactly 0, so the values
// they load must be finite: they are rows of the same live operands.
#pragma once

#include "common.cuh"

namespace apex_port {

template <int VEC>
struct RowState {
  float m;
  float l;
  float acc[VEC];

  __device__ __forceinline__ void init() {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
  }
};

// One butterfly step: lanes with bit W set keep the upper half of the
// W-wide window, the others the lower half; each adds its partner's copy.
template <int W>
__device__ __forceinline__ void transpose_reduce_step(float (&part)[32],
                                                      int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? part[i] : part[i + W];
    const float keep = upper ? part[i + W] : part[i];
    part[i] = keep + __shfl_xor_sync(kFullMask, send, W);
  }
}

// After the five steps part[0] on lane j is the sum over all lanes of
// the original part[j].
__device__ __forceinline__ float transpose_reduce(float (&part)[32],
                                                  int lane) {
  transpose_reduce_step<16>(part, lane);
  transpose_reduce_step<8>(part, lane);
  transpose_reduce_step<4>(part, lane);
  transpose_reduce_step<2>(part, lane);
  transpose_reduce_step<1>(part, lane);
  return part[0];
}

// Attend one tile of up to 32 keys. k_tile/v_tile point at key 0 of the
// tile, already offset to this lane's dims; consecutive keys are
// k_stride/v_stride elements apart; keys (last, 31] are clamped onto
// key `last`.
template <typename T, int VEC>
__device__ __forceinline__ void attend_tile(const T* __restrict__ k_tile,
                                            int64_t k_stride,
                                            const T* __restrict__ v_tile,
                                            int64_t v_stride, uint32_t live,
                                            int last, const float (&q)[VEC],
                                            RowState<VEC>& st, int lane) {
  float part[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float kf[VEC];
    load_vec<T, VEC>(k_tile + min(j, last) * k_stride, kf);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < VEC; ++c) dot = fmaf(q[c], kf[c], dot);
    part[j] = dot;
  }
  const float s_full = transpose_reduce(part, lane);
  const float s = ((live >> lane) & 1u) ? s_full : kNegInf;
  const float m_new = fmaxf(st.m, warp_max(s));
  const float p = exp2f(s - m_new);        // 0 for dead keys
  const float corr = exp2f(st.m - m_new);  // 0 on the first live tile
  st.l = st.l * corr + warp_sum(p);
#pragma unroll
  for (int c = 0; c < VEC; ++c) st.acc[c] *= corr;
  const float pr = round_to<T>(p);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pj = __shfl_sync(kFullMask, pr, j);
    float vf[VEC];
    load_vec<T, VEC>(v_tile + min(j, last) * v_stride, vf);
#pragma unroll
    for (int c = 0; c < VEC; ++c) st.acc[c] = fmaf(pj, vf[c], st.acc[c]);
  }
  st.m = m_new;
}

// o = acc / l and the natural-log lse; a row that attended nothing
// emits zeros and lse = -1e30 (the TPU decode kernel's empty-row rule).
template <typename T, int VEC>
__device__ __forceinline__ void finish_row(const RowState<VEC>& st,
                                           T* __restrict__ o_row,
                                           float* __restrict__ lse,
                                           int lane) {
  const bool empty = !(st.l > 0.f);
  float out[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) out[c] = empty ? 0.f : st.acc[c] / st.l;
  store_vec<T, VEC>(o_row + lane * VEC, out);
  if (lse != nullptr && lane == 0)
    *lse = empty ? kNegInf : (st.m + log2f(st.l)) * kLn2;
}

}  // namespace apex_port
