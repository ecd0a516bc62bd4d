// The optimizer updates over packed (rows, 1024) buffers, for Hopper
// (sm_90a): one elementwise kernel, templated on the update's functor.
//
// Replaces the TPU kernels of rocm_apex_tpu/ops/optim_kernels.py:
//   `adam_update`      :114 _adam_kernel      Adam / AdamW, optional skip
//   `sgd_update`       :166 _sgd_kernel       SGD, momentum, nesterov
//   `adagrad_update`   :203 _adagrad_kernel   Adagrad
//   `novograd_update`  :233 _novograd_kernel  NovoGrad (per-row norm column)
//   `lamb_stage1`      :273 _lamb1_kernel     LAMB direction u + moments
//   `lamb_stage2`      :305 _lamb2_kernel     delta = -lr * ratio * u
// Per element, in fp32 whatever the storage dtypes, the JAX kernel's
// arithmetic in its order, each product, sum and quotient rounded once
// (the _rn intrinsics: no fused multiply-add), as the plain version's
// separate tensor ops round them. Outputs are new buffers: the fp32 delta
// (u for LAMB stage 1) and the state buffers in the state's dtype.
//
// The scalars (learning rate, bias corrections, clip, skip, ...) are one
// fp32 vector in device memory, read by every thread: the step count and
// the overflow flag they depend on never go to the host. The per-tensor
// values (weight decay, trust ratio, NovoGrad's norm) are fp32 (rows, 1)
// columns: a row never straddles two tensors, so a chunk's one row reads
// one value. Adam's skip (scalars[9] >= 0.5) selects the old m, v and a
// zero delta, never blends: a skipped step's values may be inf or nan.
//
// Bound: bytes (Adam and LAMB stage 1 read p, g, m, v and write three
// buffers: 28 B an element at fp32; stage 2 8 B). A thread takes chunks of
// 4 consecutive elements (a 16-byte access of an fp32 buffer, 8 of a bf16
// one), neighbouring threads on neighbouring chunks, so each warp-wide
// access covers 128 contiguous elements, in a grid-stride loop. A packed
// buffer has rows % 64 == 0 and 16-byte-aligned starts: no tail.
#include "common.cuh"

namespace apex_port {

constexpr int kPoWidth = 1024;
constexpr int kPoThreads = 256;
constexpr int kPoChunk = 4;  // elements a thread takes at once
constexpr int kPoChunksPerRow = kPoWidth / kPoChunk;

// each operation rounded once, never contracted into a fused multiply-add
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

// Flag bits, one meaning per functor
enum : int { kFlag0 = 1, kFlag1 = 2, kFlag2 = 4 };

// Every functor: kScalars scalars, kStates state buffers (m, v, buf, h),
// kCols columns, kHasG whether it reads a gradient; apply() maps one
// element's x (the master, or u), g, states and columns to its delta and
// new states.

// [lr, b1, 1-b1, b2, 1-b2, eps, bc1, bc2, gs, (skip)]; flag0 AdamW, flag1
// the skip slot is present
struct AdamOp {
  static constexpr int kScalars = 10, kStates = 2, kCols = 1;
  static constexpr bool kHasG = true;
  __device__ static void apply(const float* s, int flags, const float* col,
                               float p, float g, float (&st)[2], float& d) {
    const bool adam_w = flags & kFlag0;
    const float wd = col[0];
    g = mul_rn(g, s[8]);
    if (!adam_w) g = add_rn(g, mul_rn(wd, p));
    const float m = add_rn(mul_rn(s[1], st[0]), mul_rn(s[2], g));
    const float v = add_rn(mul_rn(s[3], st[1]), mul_rn(mul_rn(s[4], g), g));
    float u = div_rn(div_rn(m, s[6]), add_rn(sqrt_rn(div_rn(v, s[7])), s[5]));
    if (adam_w) u = add_rn(u, mul_rn(wd, p));
    // a select: the skipped step's d, m, v may be inf or nan
    const bool on = !(flags & kFlag1) || s[9] < 0.5f;
    d = on ? mul_rn(-s[0], u) : 0.f;
    if (on) {
      st[0] = m;
      st[1] = v;
    }
  }
};

// [lr, momentum, dampening, first_run, gs]; flag0 nesterov, flag1
// wd_after_momentum, flag2 momentum on
struct SgdOp {
  static constexpr int kScalars = 5, kStates = 1, kCols = 1;
  static constexpr bool kHasG = true;
  __device__ static void apply(const float* s, int flags, const float* col,
                               float p, float g, float (&st)[2], float& d) {
    const bool nesterov = flags & kFlag0, wd_after = flags & kFlag1;
    const float wd = col[0];
    g = mul_rn(g, s[4]);
    if (!wd_after) g = add_rn(g, mul_rn(wd, p));
    float dd;
    if (flags & kFlag2) {
      const float buf =
          s[3] > 0.5f
              ? g
              : add_rn(mul_rn(s[1], st[0]), mul_rn(sub_rn(1.f, s[2]), g));
      dd = nesterov ? add_rn(g, mul_rn(s[1], buf)) : buf;
      st[0] = buf;
    } else {
      dd = g;
    }
    if (wd_after) dd = add_rn(dd, mul_rn(wd, p));
    d = mul_rn(-s[0], dd);
  }
};

// [lr, eps, gs]; flag0 decoupled decay (adagrad_w_mode)
struct AdagradOp {
  static constexpr int kScalars = 3, kStates = 1, kCols = 1;
  static constexpr bool kHasG = true;
  __device__ static void apply(const float* s, int flags, const float* col,
                               float p, float g, float (&st)[2], float& d) {
    const bool w_mode = flags & kFlag0;
    const float wd = col[0];
    g = mul_rn(g, s[2]);
    if (!w_mode) g = add_rn(g, mul_rn(wd, p));
    const float h = add_rn(st[0], mul_rn(g, g));
    float u = div_rn(g, add_rn(sqrt_rn(h), s[1]));
    if (w_mode) u = add_rn(u, mul_rn(wd, p));
    d = mul_rn(-s[0], u);
    st[0] = h;
  }
};

// [lr, b1, b3, eps, bc1, bc2, gs]; columns wd, v (the blended norm);
// flag0 reg_inside_moment
struct NovogradOp {
  static constexpr int kScalars = 7, kStates = 1, kCols = 2;
  static constexpr bool kHasG = true;
  __device__ static void apply(const float* s, int flags, const float* col,
                               float p, float g, float (&st)[2], float& d) {
    const float wd = col[0];
    g = mul_rn(g, s[6]);
    const float denom = add_rn(div_rn(col[1], s[5]), s[3]);
    float m;
    if (flags & kFlag0) {
      m = add_rn(mul_rn(s[1], st[0]),
                 mul_rn(s[2], add_rn(div_rn(g, denom), mul_rn(wd, p))));
      d = mul_rn(-s[0], div_rn(m, s[4]));
    } else {
      m = add_rn(mul_rn(s[1], st[0]), mul_rn(s[2], g));
      d = mul_rn(-s[0],
                 add_rn(div_rn(div_rn(m, s[4]), denom), mul_rn(wd, p)));
    }
    st[0] = m;
  }
};

// [b1, b2, 1-b2, b3, eps, bc1, bc2, gs, clip]; flag0 AdamW; d is u
struct Lamb1Op {
  static constexpr int kScalars = 9, kStates = 2, kCols = 1;
  static constexpr bool kHasG = true;
  __device__ static void apply(const float* s, int flags, const float* col,
                               float p, float g, float (&st)[2], float& d) {
    const bool adam_w = flags & kFlag0;
    const float wd = col[0];
    g = mul_rn(mul_rn(g, s[7]), s[8]);
    if (!adam_w) g = add_rn(g, mul_rn(wd, p));
    const float m = add_rn(mul_rn(s[0], st[0]), mul_rn(s[3], g));
    const float v = add_rn(mul_rn(s[1], st[1]), mul_rn(mul_rn(s[2], g), g));
    float u = div_rn(div_rn(m, s[5]), add_rn(sqrt_rn(div_rn(v, s[6])), s[4]));
    if (adam_w) u = add_rn(u, mul_rn(wd, p));
    d = u;
    st[0] = m;
    st[1] = v;
  }
};

// [lr]; column: the trust ratio; x is u
struct Lamb2Op {
  static constexpr int kScalars = 1, kStates = 0, kCols = 1;
  static constexpr bool kHasG = false;
  __device__ static void apply(const float* s, int, const float* col,
                               float u, float, float (&)[2], float& d) {
    d = mul_rn(mul_rn(-s[0], col[0]), u);
  }
};

struct UpdateArgs {
  const void* x;   // the master (u for LAMB stage 2), dtype X
  const void* g;   // the gradient, dtype G
  const void* s0;  // the state buffers, dtype M
  const void* s1;
  const float* c0;  // (rows, 1) columns
  const float* c1;
  const float* scalars;
  float* d;  // outputs: the fp32 delta, the new states (dtype M)
  void* s0_out;
  void* s1_out;
  long long rows;
  int flags;
};

template <class Op, typename X, typename G, typename M>
__global__ void __launch_bounds__(kPoThreads)
    packed_update_kernel(const UpdateArgs a) {
  float s[Op::kScalars];
#pragma unroll
  for (int i = 0; i < Op::kScalars; ++i) {
    // Adam's skip slot exists only with flag1
    s[i] = (Op::kScalars == 10 && i == 9 && !(a.flags & kFlag1))
               ? 0.f
               : a.scalars[i];
  }
  const int64_t chunks = a.rows * kPoChunksPerRow;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kPoThreads + threadIdx.x;
       c < chunks; c += static_cast<int64_t>(gridDim.x) * kPoThreads) {
    const int64_t e = c * kPoChunk;
    const int64_t row = c / kPoChunksPerRow;
    float col[2];
    col[0] = a.c0[row];
    col[1] = Op::kCols > 1 ? a.c1[row] : 0.f;
    float x[kPoChunk], g[kPoChunk], s0[kPoChunk], s1[kPoChunk], d[kPoChunk];
    load_vec<X, kPoChunk>(static_cast<const X*>(a.x) + e, x);
    if constexpr (Op::kHasG)
      load_vec<G, kPoChunk>(static_cast<const G*>(a.g) + e, g);
    if constexpr (Op::kStates > 0)
      load_vec<M, kPoChunk>(static_cast<const M*>(a.s0) + e, s0);
    if constexpr (Op::kStates > 1)
      load_vec<M, kPoChunk>(static_cast<const M*>(a.s1) + e, s1);
#pragma unroll
    for (int k = 0; k < kPoChunk; ++k) {
      float st[2] = {Op::kStates > 0 ? s0[k] : 0.f,
                     Op::kStates > 1 ? s1[k] : 0.f};
      Op::apply(s, a.flags, col, x[k], Op::kHasG ? g[k] : 0.f, st, d[k]);
      if constexpr (Op::kStates > 0) s0[k] = st[0];
      if constexpr (Op::kStates > 1) s1[k] = st[1];
    }
    store_vec_packed<float, kPoChunk>(a.d + e, d);
    if constexpr (Op::kStates > 0)
      store_vec_packed<M, kPoChunk>(static_cast<M*>(a.s0_out) + e, s0);
    if constexpr (Op::kStates > 1)
      store_vec_packed<M, kPoChunk>(static_cast<M*>(a.s1_out) + e, s1);
  }
}

template <class Op, typename X, typename G, typename M>
int launch_update(const UpdateArgs& a, cudaStream_t stream) {
  const long long chunks = a.rows * kPoChunksPerRow;
  if (chunks > 0) {
    // enough blocks for every SM several times over; each thread then
    // walks its chunks a grid apart
    const long long want = (chunks + kPoThreads - 1) / kPoThreads;
    const unsigned grid = static_cast<unsigned>(want < 132 * 16 ? want
                                                                : 132 * 16);
    packed_update_kernel<Op, X, G, M><<<grid, kPoThreads, 0, stream>>>(a);
    note_launch("packed_update_kernel");
  }
  return static_cast<int>(cudaGetLastError());
}

// x, g and the state buffers each fp32 or the call's one 2-byte type
// (bf16 or fp16; half_family refuses a mix)
template <class Op>
int dispatch(const UpdateArgs& a, int x_dt, int g_dt, int m_dt, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return with_half(half_family(x_dt, g_dt, m_dt), [&](auto h) {
    using H = decltype(h);
    switch ((x_dt != kFloat32) * 4 + (g_dt != kFloat32) * 2 +
            (m_dt != kFloat32)) {
      case 0: return launch_update<Op, float, float, float>(a, st);
      case 1: return launch_update<Op, float, float, H>(a, st);
      case 2: return launch_update<Op, float, H, float>(a, st);
      case 3: return launch_update<Op, float, H, H>(a, st);
      case 4: return launch_update<Op, H, float, float>(a, st);
      case 5: return launch_update<Op, H, float, H>(a, st);
      case 6: return launch_update<Op, H, H, float>(a, st);
      default: return launch_update<Op, H, H, H>(a, st);
    }
  });
}

}  // namespace apex_port

using namespace apex_port;

extern "C" {

// One entry a functor, one argument list for all: x, g, s0, s1, c0, c1
// may be NULL where the functor reads none.
#define PACKED_ENTRY(NAME, OP)                                                 \
  int NAME(long long rows, const void* x, int x_dt, const void* g, int g_dt,  \
           const void* s0, const void* s1, int m_dt, const float* c0,         \
           const float* c1, const float* scalars, int flags, float* d,        \
           void* s0_out, void* s1_out, void* stream) {                        \
    const UpdateArgs a{x,  g,       s0, s1,     c0,     c1,  scalars,         \
                       d,  s0_out,  s1_out,     rows,   flags};               \
    return dispatch<OP>(a, x_dt, g_dt, m_dt, stream);                         \
  }

PACKED_ENTRY(packed_adam, AdamOp)
PACKED_ENTRY(packed_sgd, SgdOp)
PACKED_ENTRY(packed_adagrad, AdagradOp)
PACKED_ENTRY(packed_novograd, NovogradOp)
PACKED_ENTRY(packed_lamb1, Lamb1Op)

// stage 2 reads u (fp32, bf16 or fp16) alone: one instance per u dtype
int packed_lamb2(long long rows, const void* u, int u_dt, const float* ratio,
                 const float* scalars, float* d, void* stream) {
  const UpdateArgs a{u, nullptr, nullptr, nullptr, ratio, nullptr, scalars,
                     d, nullptr, nullptr, rows,    0};
  auto st = static_cast<cudaStream_t>(stream);
  if (u_dt == kFloat32)
    return launch_update<Lamb2Op, float, float, float>(a, st);
  return with_half(half_family(u_dt), [&](auto h) {
    return launch_update<Lamb2Op, decltype(h), float, float>(a, st);
  });
}

}  // extern "C"
