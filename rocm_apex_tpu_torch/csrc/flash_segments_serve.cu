// Segment-masked packed attention with lse, the serving read on the tensor
// cores, for Hopper (sm_90a): the "tiles" route of
// `flash_segments_serve_plan` (ops/flash_attention_segments.py), bf16 or
// fp16 (T) at a head_dim up to 128 (a multiple of 8, on the pipe's width 64
// or 128 with zero columns past it, as flash_fwd_pipe.cuh forms them) over
// a stream of at most kServeMaxTokens tokens.
//
// Replaces rocm_apex_tpu/ops/flash_attention_segments.py:70
// `_seg_fwd_kernel` as the chunked-prefill serve runs it
// (`flash_attention_segments_with_lse`): q, k and v are (heads, total,
// head_dim) views of the chunk's fused QKV projection, read in place
// through their (head, token) strides; token i attends token j iff
// seg[i] == seg[j] (and j <= i when causal); o (heads, total, head_dim)
// in T and the natural-log lse (heads, total). The scores are
// `_masked_scores`' (rocm_apex_tpu/ops/flash_attention.py:122): q times
// q_mul = scale * log2(e), rounded to T, then the fp32 product with k.
//
// Bound: latency. At the serve chunk (8 heads x 256 tokens x 128 dims,
// causal) the call does ~35 MFLOP over ~2 MB: well under a microsecond of
// either at the card's rates, so the time is the launch and the serial
// steps of the longest walk. The warp-a-row kernel (flash_segments.cu)
// walked each row's keys 32 at a time on the CUDA cores and read every
// live K/V row once per query row. Here:
//
// - One block, one warpgroup, per (head, 64-query tile): the forward
//   pipe's tile step (flash_fwd_pipe.cuh) on K/V tiles in its 128-byte
//   swizzle through a two-stage cp.async ring, S = T(q q_mul) k^T and
//   O += p v on wgmma, p rounded to T against the running max after
//   each 64-key tile, the running max from -1e30.
// - The tile walk is formed in the block, with no pre-pass launch (at
//   this size a launch costs as much as the work): the block reads the
//   stream's ids into shared memory, forms each 64-token tile's [min, max]
//   id range, and walks the key tiles whose range meets its own
//   (`_overlap`, flash_attention_segments.py:61) within the causal bound,
//   as a 32-bit mask, in ascending order, as the JAX kernel and the
//   segment pipe walk them, so p is rounded in the frame of
//   `flash_attention_segments_plain` at 64 keys. A range test never skips
//   a tile that holds a live pair, so ids in any order are exact (the
//   engine packs slot pieces in scheduler order; pads carry the id
//   num_slots); within a tile each key is masked by its own id. A row
//   whose first tiles mask all its keys keeps p = 0 there (m from -1e30,
//   a masked score -inf). The diagonal tile (every row of the query tile
//   attends itself there) is loaded into a buffer of its own with q,
//   before the ids are read, so its copy runs under them; the other tiles
//   go through the ring, the first issued as soon as the walk is known.
// - Shared memory is reached through offsets from the block's array, so
//   the compiler keeps the ids' and q's accesses in the shared space (an
//   address aligned through an integer made them generic `LD.E` loads in
//   the SASS, each behind a branch of the mask's tests); the mask tests a
//   thread's 16 key ids, loaded first, without branches.
#include "flash_fwd_pipe.cuh"

namespace apex_port {
namespace unpacked {

constexpr int kServeMaxTiles = 32;  // a walk is a 32-bit mask of tiles
constexpr int kServeMaxTokens = kServeMaxTiles * kTile;

template <int HD>
struct ServeCfg {
  static constexpr int kThreads = 128;  // one warpgroup
  static constexpr int kStages = 2;
  static constexpr int kTileBytes = PipeCfg<HD>::kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  // q, the diagonal's K and V, the ring, the ids, the tiles' id ranges,
  // + 1024 for the alignment
  static constexpr int kSmemBytes = kTileBytes + (kStages + 1) * kStageBytes +
                                    kServeMaxTokens * 4 +
                                    kServeMaxTiles * 8 + 1024;
};

template <typename T, int HD>
__global__ void __launch_bounds__(128)
    serve_tiles_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, Strides qs, Strides ks,
                       Strides vs, const int* __restrict__ seg, int total,
                       int causal, float q_mul, T* __restrict__ o,
                       float* __restrict__ lse, int hd) {
  using C = ServeCfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = smem_base_1024(smem_raw);
  unsigned char* sdiag = sq + C::kTileBytes;
  unsigned char* ring = sdiag + C::kStageBytes;
  int* sid = reinterpret_cast<int*>(ring + C::kStages * C::kStageBytes);
  int2* srange = reinterpret_cast<int2*>(sid + kServeMaxTokens);
  const int nqt = (total + kTile - 1) / kTile;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int hh = blockIdx.y;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* kh = k + static_cast<int64_t>(hh) * ks.h;
  const T* vh = v + static_cast<int64_t>(hh) * vs.h;
  auto stage = [&](int i) { return ring + (i % C::kStages) * C::kStageBytes; };
  auto load = [&](unsigned char* to, int kt) {  // key tile kt's K, then V
    copy_tile<HD, C::kThreads>(to, kh, ks.s, kt * kTile, total, tid, hd);
    copy_tile<HD, C::kThreads>(to + C::kTileBytes, vh, vs.s, kt * kTile,
                               total, tid, hd);
  };

  // q and the diagonal tile in flight first (groups Q and D)
  copy_tile<HD, C::kThreads>(sq, q + static_cast<int64_t>(hh) * qs.h, qs.s,
                             q0, total, tid, hd);
  cp_async_commit();
  load(sdiag, qt);
  cp_async_commit();

  // the ids of each 64-token tile into shared memory (the keys' masks) and
  // its [min, max] range, a warp a tile
  for (int tt = warp; tt < nqt; tt += C::kThreads / 32) {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = tt * kTile + 32 * h2 + lane;
      if (i < total) {
        const int id = __ldg(seg + i);
        sid[i] = id;
        lo = min(lo, id);
        hi = max(hi, id);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFullMask, lo, off));
      hi = max(hi, __shfl_xor_sync(kFullMask, hi, off));
    }
    if (lane == 0) srange[tt] = make_int2(lo, hi);
  }
  __syncthreads();  // the ids and the ranges

  // the walk, one bit a tile (lane kt tests tile kt, every warp alike): the
  // tiles up to the diagonal (all of them without causal masking) whose id
  // range meets the query tile's, the diagonal among them
  const int2 qr = srange[qt];
  const int kmax = causal ? qt : nqt - 1;
  uint32_t to_walk =
      __ballot_sync(kFullMask, lane <= kmax && ranges_meet(qr, srange[lane]));
  // the ring's tiles, lowest first; the first one's copy (group R0, empty
  // when the diagonal is the whole walk) starts now
  uint32_t to_load = to_walk & ~(1u << qt);
  if (to_load != 0u) {
    load(stage(0), __ffs(to_load) - 1);
    to_load &= to_load - 1;
  }
  cp_async_commit();
  const int rseg[2] = {row[0] < total ? sid[row[0]] : 0,
                       row[1] < total ? sid[row[1]] : 0};
  // the last key a row may attend (-1 past the stream)
  const int lim[2] = {row[0] < total ? (causal ? row[0] : total - 1) : -1,
                      row[1] < total ? (causal ? row[1] : total - 1) : -1};

  // q landed (D and R0 may still be on their way): q <- T(q q_mul)
  cp_async_wait<2>();
  __syncthreads();
  fold_tile<HD, C::kThreads, T>(sq, q_mul, tid);
  fence_proxy_async();
  __syncthreads();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  // the groups so far: Q, D, R0, then one a ring step: R(i + 1) issued at
  // ring step i (the walk's i-th tile off the diagonal) once R(i) landed
  for (int i = 0; to_walk != 0u;) {
    const int kt = __ffs(to_walk) - 1;
    to_walk &= to_walk - 1;
    const unsigned char* skt;
    if (kt == qt) {
      cp_async_wait<1>();  // D landed; R(i), the next ring tile, may not
      fence_proxy_async();
      __syncthreads();
      skt = sdiag;
    } else {
      cp_async_wait<0>();  // R(i) landed
      fence_proxy_async();
      __syncthreads();  // ... and every warp is done with ring tile i - 1
      if (to_load != 0u) {  // R(i + 1), into i - 1's stage
        load(stage(i + 1), __ffs(to_load) - 1);
        to_load &= to_load - 1;
      }
      cp_async_commit();
      skt = stage(i);
      ++i;
    }
    const unsigned char* svt = skt + C::kTileBytes;

    // s = (q q_mul) k^T: 64 rows x 64 keys, d[4 j + e] of 8-key block j
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    reg_fence(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      if (kstep_live(kk, hd))
        wgmma_m64n64k16<T, 0, 0>(s, kmajor_desc(sq, kk),
                                 kmajor_desc(skt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // online softmax over the tile; e < 2 is row 0, e >= 2 row 1. Only a
    // tile on the causal diagonal, past the stream's end or with more
    // than one id needs the mask (uniform per block)
    const int kbase = kt * kTile;
    const bool edge = kbase + kTile > total || q0 + kTile > total ||
                      (causal && kbase + kTile - 1 > q0) ||
                      !one_segment(qr, srange[kt]);
    if (edge) {  // the thread's 16 keys' ids first, then the tests
      int kid[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          kid[2 * j + u] = sid[kbase + j * 8 + 2 * t + u];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = kbase + j * 8 + 2 * t + (e & 1);
          const bool live = (col <= lim[r]) &
                            (kid[2 * j + (e & 1)] == rseg[r]);
          s[4 * j + e] = live ? s[4 * j + e] : masked();
        }
    }
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[4 * j + e]);
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(kFullMask, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * j + e] - m[e >> 1]);  // 0 if masked
        psum[e >> 1] += p;
        s[4 * j + e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(kFullMask, psum[r], 1);
      psum[r] += __shfl_xor_sync(kFullMask, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      acc[4 * nb] *= corr[0];
      acc[4 * nb + 1] *= corr[0];
      acc[4 * nb + 2] *= corr[1];
      acc[4 * nb + 3] *= corr[1];
    }

    // o += p v over 4 steps of 16 keys, p rounded to T as the A fragments
    uint32_t pa[4][4];
    c_to_a_tile<T>(s, pa);
    reg_fence(pa);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pv_mma<HD, T>(acc, pa[j], mnmajor_desc(svt, j));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
  }

  // o = acc / l (0 where l = 0) and lse = (m + log2 l) ln 2 of the
  // thread's two rows (no row of a segment stream is empty: a token
  // attends itself)
  T* oh = o + static_cast<int64_t>(hh) * total * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= total) continue;
    const float safe_l = l[r] > 0.f ? l[r] : 1.f;
    const float inv = 1.f / safe_l;
    T* orow = oh + static_cast<int64_t>(row[r]) * hd;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      if (nb * 8 < hd)
        *reinterpret_cast<uint32_t*>(orow + nb * 8 + 2 * t) = pack2<T>(
            acc[4 * nb + 2 * r] * inv, acc[4 * nb + 2 * r + 1] * inv);
    if (t == 0)
      lse[static_cast<int64_t>(hh) * total + row[r]] =
          (m[r] + log2f(safe_l)) * kLn2;
  }
}

template <typename T, int HD>
int launch_serve_tiles(const void* q, const void* k, const void* v,
                       const int64_t* st, const int* seg, int H, int total,
                       int hd, int causal, float q_mul, void* o, void* lse,
                       cudaStream_t stream) {
  using C = ServeCfg<HD>;
  // every call, as launch_pipe_fwd sets its own
  const cudaError_t e = cudaFuncSetAttribute(
      serve_tiles_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides qs{0, st[0], st[1]}, ks{0, st[2], st[3]}, vs{0, st[4], st[5]};
  serve_tiles_kernel<T, HD>
      <<<dim3((total + kTile - 1) / kTile, H), C::kThreads, C::kSmemBytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), qs, ks, vs, seg, total,
                   causal, q_mul, static_cast<T*>(o),
                   static_cast<float*>(lse), hd);
  note_launch("serve_tiles_kernel");
  return static_cast<int>(cudaGetLastError());
}

}  // namespace unpacked
}  // namespace apex_port

// q, k, v: (H, total, hd) views in dtype (bf16 or fp16) through the
// element strides st[0..5] = (head, token) of q, k, v (unit stride on hd;
// every stride and base 16-byte aligned); seg: (total,) int32; o:
// contiguous (H, total, hd) in dtype; lse: contiguous (H, total) fp32. hd
// is a multiple of 8 up to 128 (on width 64 or 128), total 1 to
// kServeMaxTokens; q_mul is scale * log2(e) rounded to dtype.
extern "C" int flash_segments_serve(const void* q, const void* k,
                                    const void* v, const int64_t* st,
                                    const void* seg, int H, int total,
                                    int hd, int causal, float q_mul,
                                    void* o, void* lse, int dtype,
                                    void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  if (total < 1 || total > kServeMaxTokens || H < 1 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* ids = static_cast<const int*>(seg);
  auto s = static_cast<cudaStream_t>(stream);
  if (hd < 8 || hd > 128 || hd % 8 != 0 || !is_half_code(dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = with_half(dtype, [&](auto h) {
    using T = decltype(h);
    return hd > 64 ? launch_serve_tiles<T, 128>(q, k, v, st, ids, H, total,
                                                hd, causal, q_mul, o, lse, s)
                   : launch_serve_tiles<T, 64>(q, k, v, st, ids, H, total, hd,
                                               causal, q_mul, o, lse, s);
  });
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
