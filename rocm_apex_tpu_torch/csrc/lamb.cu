// The LAMB update pair of the mixed-precision optimizer over parameter
// leaves, for Hopper (sm_90a).
//
// Stage 1 replaces rocm_apex_tpu/ops/optim_kernels.py:355
// `_lamb_leaf1_kernel`. Per element of each parameter leaf, in fp32:
//   g  = grad * gs_clip                      (+ wd * p in L2 mode)
//   m2 = b1 * m + b3 * g
//   v2 = b2 * v + (1 - b2) * g * g
//   u  = (m2 / bc1) / (sqrt(v2 / bc2) + eps) (+ wd * p in AdamW mode)
// m and v are rewritten in place in their storage dtype (fp32, bf16 or fp16)
// where live > 0 and left bit-identical otherwise; u is never stored.
// Each leaf's sum p^2 and sum u^2 (u from the fp32 m2/v2, before any
// rounding to the storage dtype) go to its row of `out`.
//
// Stage 2 replaces :427 `_lamb_leaf2_kernel`: it recomputes u from the
// master and the STORED m2/v2 (so a reloaded state reproduces the step)
// and writes p - lr_ratio * u into the master in place where live > 0,
// and the same value rounded to the compute dtype into `c` when asked.
//
// bc1, bc2, gs_clip, live and lr_ratio depend on the step count, the
// global gradient norm and the trust ratio, which live on the device: the
// kernels read them from device memory, so the host never waits for them.
// `live` selects, never blends: a skipped step's provisional values may
// be inf or nan.
//
// Bound: bytes (stage 1 reads p, g, m, v and writes m, v; stage 2 reads
// p, m, v and writes p and maybe c). The JAX package launches the pair
// once per leaf; here one call takes ALL the leaves of a step: their
// pointers, sizes and decay ride in a table passed by value as the kernel
// argument, up to 32 leaves a table. Stage 1 launches two kernels a table
// (the update, then `lamb_reduce_kernel`) and stage 2 one, so 100 leaves
// take 8 + 4 device launches a step. On this card a launch per leaf costs
// the host more than the device spends on the leaf. A block covers 4096 consecutive elements
// of one leaf with 16-byte accesses of the fp32 master; it finds its leaf
// in the table's prefix sums of block counts. The two sums are reduced in
// a fixed order: per-thread partials, warp shuffles, the warps in index
// order, one partial pair per block, then `lamb_reduce_kernel` (one block
// a leaf) adds that leaf's blocks in a fixed order. No atomics, so a run
// reproduces bit for bit.
#include "common.cuh"

namespace apex_port {

constexpr int kLambThreads = 256;
constexpr int kLambWarps = kLambThreads / 32;
// elements one block covers: 4 iterations of 4 elements a thread
constexpr int kLambBlockElems = kLambThreads * 4 * 4;
// leaves one launch takes: the table is a kernel argument (4 KB at most)
constexpr int kLambMaxLeaves = 32;

// One launch's leaves. `a`..`d` are p, g, m, v for stage 1 and p, m, v, c
// for stage 2; block_end[i] is the number of blocks of leaves 0..i.
struct LeafTable {
  void* a[kLambMaxLeaves];
  void* b[kLambMaxLeaves];
  void* c[kLambMaxLeaves];
  void* d[kLambMaxLeaves];
  long long n[kLambMaxLeaves];
  float wd[kLambMaxLeaves];
  int block_end[kLambMaxLeaves];
  int leaves;
};

// The leaf of this block and the element range [start, end) it covers.
__device__ __forceinline__ int find_leaf(const LeafTable& t, int64_t& start,
                                         int64_t& end) {
  int leaf = 0;
  while (static_cast<int>(blockIdx.x) >= t.block_end[leaf]) ++leaf;
  const int first = leaf > 0 ? t.block_end[leaf - 1] : 0;
  start = static_cast<int64_t>(blockIdx.x - first) * kLambBlockElems;
  end = min(start + kLambBlockElems, static_cast<int64_t>(t.n[leaf]));
  return leaf;
}

// Sums (a, b) over the block in a fixed order; valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float red[2][kLambWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = red[0][0];
    b = red[1][0];
    for (int w = 1; w < kLambWarps; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
  }
}

template <typename G, typename M, int VEC>
__global__ void __launch_bounds__(kLambThreads)
    lamb_stage1_kernel(const __grid_constant__ LeafTable t,
                       const float* __restrict__ scalars,
                       float* __restrict__ part, int adam_w_mode) {
  const float b1 = scalars[0], b2 = scalars[1], b3 = scalars[2];
  const float eps = scalars[3], bc1 = scalars[4], bc2 = scalars[5];
  const float gs_clip = scalars[6];
  const bool on = scalars[7] > 0.f;
  const float omb2 = 1.f - b2;
  int64_t start, end;
  const int leaf = find_leaf(t, start, end);
  const float* __restrict__ p = static_cast<const float*>(t.a[leaf]);
  const G* __restrict__ g = static_cast<const G*>(t.b[leaf]);
  M* m = static_cast<M*>(t.c[leaf]);
  M* v = static_cast<M*>(t.d[leaf]);
  // AdamW mode decays in u, L2 mode in the gradient
  const float wd_u = adam_w_mode ? t.wd[leaf] : 0.f;
  const float wd_g = adam_w_mode ? 0.f : t.wd[leaf];
  float psq = 0.f, usq = 0.f;
  for (int64_t i = start + threadIdx.x * VEC; i < end;
       i += kLambThreads * VEC) {
    float pv[VEC], gv[VEC], mv[VEC], vv[VEC];
    load_vec<float, VEC>(p + i, pv);
    load_vec<G, VEC>(g + i, gv);
    load_vec<M, VEC>(m + i, mv);
    load_vec<M, VEC>(v + i, vv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float gf = gv[k] * gs_clip;
      if (wd_g != 0.f) gf += wd_g * pv[k];
      const float m2 = b1 * mv[k] + b3 * gf;
      const float v2 = b2 * vv[k] + omb2 * gf * gf;
      float u = (m2 / bc1) / (sqrtf(v2 / bc2) + eps);
      if (wd_u != 0.f) u += wd_u * pv[k];
      psq += pv[k] * pv[k];
      usq += u * u;
      mv[k] = m2;
      vv[k] = v2;
    }
    if (on) {
      store_vec_packed<M, VEC>(m + i, mv);
      store_vec_packed<M, VEC>(v + i, vv);
    }
  }
  block_sum2(psq, usq);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = psq;
    part[2 * blockIdx.x + 1] = usq;
  }
}

// One block a leaf: out[2 * leaf], out[2 * leaf + 1] = the sums of the
// leaf's block partials, in a fixed order
__global__ void __launch_bounds__(kLambThreads)
    lamb_reduce_kernel(const __grid_constant__ LeafTable t,
                       const float* __restrict__ part,
                       float* __restrict__ out) {
  const int leaf = blockIdx.x;
  const int first = leaf > 0 ? t.block_end[leaf - 1] : 0;
  float a = 0.f, b = 0.f;
  for (int k = first + static_cast<int>(threadIdx.x); k < t.block_end[leaf];
       k += kLambThreads) {
    a += part[2 * k];
    b += part[2 * k + 1];
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    out[2 * leaf] = a;
    out[2 * leaf + 1] = b;
  }
}

template <typename M, typename C, int VEC>
__global__ void __launch_bounds__(kLambThreads)
    lamb_stage2_kernel(const __grid_constant__ LeafTable t,
                       const float* __restrict__ scalars,
                       const float* __restrict__ lr_ratios,
                       int adam_w_mode) {
  const float eps = scalars[0], bc1 = scalars[1], bc2 = scalars[2];
  const bool on = scalars[3] > 0.f;
  int64_t start, end;
  const int leaf = find_leaf(t, start, end);
  float* p = static_cast<float*>(t.a[leaf]);
  const M* __restrict__ m = static_cast<const M*>(t.b[leaf]);
  const M* __restrict__ v = static_cast<const M*>(t.c[leaf]);
  C* __restrict__ c = static_cast<C*>(t.d[leaf]);
  const float wd_u = adam_w_mode ? t.wd[leaf] : 0.f;
  const float lr_ratio = lr_ratios[leaf];
  for (int64_t i = start + threadIdx.x * VEC; i < end;
       i += kLambThreads * VEC) {
    float pv[VEC], mv[VEC], vv[VEC];
    load_vec<float, VEC>(p + i, pv);
    load_vec<M, VEC>(m + i, mv);
    load_vec<M, VEC>(v + i, vv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float u = (mv[k] / bc1) / (sqrtf(vv[k] / bc2) + eps);
      if (wd_u != 0.f) u += wd_u * pv[k];
      if (on) pv[k] = pv[k] - lr_ratio * u;
    }
    if (on) store_vec_packed<float, VEC>(p + i, pv);
    if (c != nullptr) store_vec_packed<C, VEC>(c + i, pv);
  }
}

static bool aligned16(const void* a) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// What the C entries are given: host arrays over all the leaves.
struct Leaves {
  int count;
  void* const* a;
  void* const* b;
  void* const* c;
  void* const* d;  // stage 2: null for no compute copies
  const long long* n;
  const float* wd;
};

// Fills `t` with leaves [first, first + t.leaves) and returns its blocks;
// `vec` is cleared if a leaf cannot take 16-byte accesses.
static int fill_table(const Leaves& l, int first, LeafTable& t, bool& vec) {
  int blocks = 0;
  for (int i = 0; i < t.leaves; ++i) {
    const int j = first + i;
    t.a[i] = l.a[j];
    t.b[i] = l.b[j];
    t.c[i] = l.c[j];
    t.d[i] = l.d != nullptr ? l.d[j] : nullptr;
    t.n[i] = l.n[j];
    t.wd[i] = l.wd[j];
    blocks += static_cast<int>((l.n[j] + kLambBlockElems - 1) /
                               kLambBlockElems);
    t.block_end[i] = blocks;
    vec = vec && l.n[j] % 4 == 0 && aligned16(t.a[i]) && aligned16(t.b[i]) &&
          aligned16(t.c[i]) && aligned16(t.d[i]);
  }
  return blocks;
}

template <typename G, typename M>
static void launch_stage1(const Leaves& l, const float* scalars, float* part,
                          float* out, int adam_w_mode, cudaStream_t stream) {
  for (int first = 0; first < l.count; first += kLambMaxLeaves) {
    LeafTable t;
    t.leaves = min(kLambMaxLeaves, l.count - first);
    bool vec = true;
    const int blocks = fill_table(l, first, t, vec);
    if (blocks == 0) continue;
    auto kernel =
        vec ? lamb_stage1_kernel<G, M, 4> : lamb_stage1_kernel<G, M, 1>;
    kernel<<<blocks, kLambThreads, 0, stream>>>(t, scalars, part,
                                                adam_w_mode);
    note_launch("lamb_stage1_kernel");
    lamb_reduce_kernel<<<t.leaves, kLambThreads, 0, stream>>>(
        t, part, out + 2 * first);
    note_launch("lamb_reduce_kernel");
    part += 2 * blocks;
  }
}

template <typename M, typename C>
static void launch_stage2(const Leaves& l, const float* scalars,
                          const float* lr_ratios, int adam_w_mode,
                          cudaStream_t stream) {
  for (int first = 0; first < l.count; first += kLambMaxLeaves) {
    LeafTable t;
    t.leaves = min(kLambMaxLeaves, l.count - first);
    bool vec = true;
    const int blocks = fill_table(l, first, t, vec);
    if (blocks == 0) continue;
    auto kernel =
        vec ? lamb_stage2_kernel<M, C, 4> : lamb_stage2_kernel<M, C, 1>;
    kernel<<<blocks, kLambThreads, 0, stream>>>(t, scalars,
                                                lr_ratios + first,
                                                adam_w_mode);
    note_launch("lamb_stage2_kernel");
  }
}

}  // namespace apex_port

// `leaves` parameter leaves, each a contiguous run of n[i] > 0 elements:
// p[i] the fp32 master, g[i] the gradient in g_dtype, m[i] and v[i] the
// moments in m_dtype (updated in place); wd[i] the leaf's weight decay,
// added to u in AdamW mode and to the gradient in L2 mode. scalars: 8
// fp32 on the device [b1, b2, b3, eps, bc1, bc2, gs * clip, live]; part:
// fp32 scratch of 2 * sum ceil(n[i] / 4096); out: (leaves, 2) fp32 on the
// device, written with each leaf's sum p^2 and sum u^2. The pointer, size
// and decay arrays live on the host.
extern "C" int lamb_stage1(int leaves, void* const* p, void* const* g,
                           void* const* m, void* const* v,
                           const long long* n, const float* wd,
                           const void* scalars, void* part, void* out,
                           int adam_w_mode, int g_dtype, int m_dtype,
                           void* stream) {
  using namespace apex_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Leaves l{leaves, p, g, m, v, n, wd};
#define APEX_LAMB1(GG, MM)                                              \
  launch_stage1<GG, MM>(l, static_cast<const float*>(scalars),          \
                        static_cast<float*>(part), static_cast<float*>(out), \
                        adam_w_mode, s)
  // g and the moments each fp32 or the call's one 2-byte type
  const int rc = with_half(half_family(g_dtype, m_dtype), [&](auto h) {
    using H = decltype(h);
    if (g_dtype == kFloat32 && m_dtype == kFloat32) {
      APEX_LAMB1(float, float);
    } else if (g_dtype == kFloat32) {
      APEX_LAMB1(float, H);
    } else if (m_dtype == kFloat32) {
      APEX_LAMB1(H, float);
    } else {
      APEX_LAMB1(H, H);
    }
    return 0;
  });
  if (rc != 0) return rc;
#undef APEX_LAMB1
  return static_cast<int>(cudaGetLastError());
}

// p[i]: the fp32 masters, updated in place; m[i], v[i]: the stored moments
// in m_dtype; c: null, or the compute-dtype copies c[i] in c_dtype; wd[i]
// as for stage 1; scalars: 4 fp32 on the device [eps, bc1, bc2, live];
// lr_ratios: `leaves` fp32 on the device (lr times each leaf's trust
// ratio).
extern "C" int lamb_stage2(int leaves, void* const* p, void* const* m,
                           void* const* v, void* const* c,
                           const long long* n, const float* wd,
                           const void* scalars, const void* lr_ratios,
                           int adam_w_mode, int m_dtype, int c_dtype,
                           void* stream) {
  using namespace apex_port;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Leaves l{leaves, p, m, v, c, n, wd};
#define APEX_LAMB2(MM, CC)                                              \
  launch_stage2<MM, CC>(l, static_cast<const float*>(scalars),          \
                        static_cast<const float*>(lr_ratios), adam_w_mode, s)
  // the moments and the copies each fp32 or the call's one 2-byte type
  const int rc = with_half(half_family(m_dtype, c_dtype), [&](auto h) {
    using H = decltype(h);
    if (m_dtype == kFloat32 && c_dtype == kFloat32) {
      APEX_LAMB2(float, float);
    } else if (m_dtype == kFloat32) {
      APEX_LAMB2(float, H);
    } else if (c_dtype == kFloat32) {
      APEX_LAMB2(H, float);
    } else {
      APEX_LAMB2(H, H);
    }
    return 0;
  });
  if (rc != 0) return rc;
#undef APEX_LAMB2
  return static_cast<int>(cudaGetLastError());
}
