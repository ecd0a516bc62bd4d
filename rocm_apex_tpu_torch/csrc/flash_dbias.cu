// Gradient of the additive attention bias for Hopper (sm_90a):
// dbias[n] = sum over the hp heads sharing bias row n of
// ds = p (keep dp / (1 - rate) - delta), fp32 (nb, Sq, Sk).
//
// Replaces rocm_apex_tpu/ops/flash_attention.py:440 `_bwd_dbias_kernel`
// (`flash_attention(..., compute_dbias=True)`, `flash_attention_with_lse`
// with a learned bias: ALiBi slopes, relative positions). The TPU kernel
// keeps the head-group dimension innermost in its sequential grid, so one
// VMEM tile accumulates across heads; here a warpgroup per (bias row n,
// query tile of 64, key tile of 64) loops over the hp heads itself, keeps
// its 64 x 64 sum in registers, adds the heads in ascending order and
// writes the sum once: no atomics, two launches give the same bits, no
// (B*H, Sq, Sk) intermediate. p and dp are recomputed per head from the
// saved lse and from delta (written by flash_unpacked_bwd's dq pass), with
// the forward's masking rule (flash_unpacked.cuh `masked_score`: the score,
// then the bias times log2 e added), so a masked key has ds = 0. The route
// is `flash_dbias_plan`'s (ops/flash_attention.py).
//
// Bound: bytes from L2, then operations. Each (head, tile) pair
// recomputes s = q k^T and dp = do v^T (4 D FLOP a score, the work of the
// dq pass without its third product) from 64 rows each of q, do, k and v.
//   bf16 ("wgmma"): two warpgroups a block, one a key tile of a pair,
//     sharing the query tile's q and do (6 tiles a head where two
//     one-warpgroup blocks read 8: the call is bound by its L2 reads). A
//     cp.async ring over the heads lands the next heads' tiles (the
//     forward pipe's 128-byte swizzle) while head hh multiplies: two
//     stages at hd 128 (192 KB), three at 64; S = bf16(q q_mul)
//     k^T and dP = do v^T are wgmma m64n64k16 with both operands K-major,
//     as in the backward pipe's dq pass. The bias tile (times log2 e) and
//     the block's causal and ragged tests are formed once a block, not
//     once a head; each head's lse and delta are loaded before its wait so
//     that they land under it, and under dropout its keep bits are hashed
//     while its products run; shared memory is reached through offsets
//     from the block's array (`smem_base_1024`), so q's fold stays in the
//     shared space. The mma.sync body it replaces staged the four tiles
//     with plain loads and a barrier, then multiplied: 8 serial
//     load-then-compute rounds a block, the bias read from device memory
//     for every element and head.
//   fp32 ("cuda_cores"): CUDA cores (4 x 4 scores a thread).
// Head dims: widths 64, 128 and 256 (`at_width`), the columns past pb.hd
// zero-filled as they are staged. S and dP are the only products, so at
// width 256 both routes stage each head in two 128-column parts and sum
// the products over them in order: on the ring a stage is one (head,
// part), the width-128 stage (two stages, 192 KB), s and dP kept across
// a head's two parts; on the CUDA cores the four tiles of a part (132
// KB where one pass over 256 would take 263).
#include "flash_bwd_pipe.cuh"

namespace apex_port {
namespace unpacked {

// ---- bf16 and fp16 (T): the wgmma ring over the heads ---------------------

template <int HD>  // HD: the staged width, 64 or 128
struct DbiasCfg {
  // two warpgroups a block, each a key tile, sharing the query tile's q
  // and do: a head's tiles are 6 where two blocks of one warpgroup read 8
  static constexpr int kWarpgroups = 2;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kTileBytes = PipeCfg<HD>::kTileBytes;
  // q, do, then each key tile's k and v
  static constexpr int kStageBytes = (2 + 2 * kWarpgroups) * kTileBytes;
  // heads in the ring: two at hd 128 (192 KB), three at 64 (144 KB); one
  // block a multiprocessor either way (its registers)
  static constexpr int kStages = HD == 128 ? 2 : 3;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
};

// HD: the width; a head is staged in kParts stages of kW columns
template <typename T, int HD>
__global__ void __launch_bounds__(256, 1)
    dbias_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ lse,
                       const T* __restrict__ dout,
                       const float* __restrict__ delta,
                       float* __restrict__ dbias, Strides qs, Strides ks,
                       Strides vs, Strides dos, Problem pb) {
  constexpr int kW = HD > 128 ? 128 : HD;
  constexpr int kParts = HD / kW;
  using C = DbiasCfg<kW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_base_1024(smem_raw);
  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;  // the thread in its warpgroup
  const int kt = blockIdx.x * C::kWarpgroups + wg;
  const int qt = blockIdx.y;
  const int n = blockIdx.z;
  const int warp = wt >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kTile;
  const int k0 = kt * kTile;  // past Sk for the second of an odd count
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float db[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) db[e] = 0.f;

  // the block's key tiles wholly past the causal bound of its query tile
  // are 0: such a block runs no head
  const int nh = pb.causal && blockIdx.x * C::kWarpgroups * kTile >
                                  min(q0 + kTile, pb.Sq) - 1
                     ? 0
                     : pb.hp;
  auto stage = [&](int i) { return ring + (i % C::kStages) * C::kStageBytes; };
  auto load = [&](int i) {  // part i % kParts of head i / kParts of row n
    const int bh = n * pb.hp + i / kParts;
    const int c0 = (i % kParts) * kW;
    const int cw = pb.hd - c0;  // the part's live columns
    unsigned char* st = stage(i);
    copy_tile<kW, C::kThreads>(st, head(q, qs, bh, pb.H) + c0, qs.s, q0,
                               pb.Sq, threadIdx.x, cw);
    copy_tile<kW, C::kThreads>(st + C::kTileBytes,
                               head(dout, dos, bh, pb.H) + c0, dos.s, q0,
                               pb.Sq, threadIdx.x, cw);
    unsigned char* kv = st + (2 + 2 * wg) * C::kTileBytes;
    copy_tile<kW, 128>(kv, head(k, ks, bh, pb.H) + c0, ks.s, k0, pb.Sk, wt,
                       cw);
    copy_tile<kW, 128>(kv + C::kTileBytes, head(v, vs, bh, pb.H) + c0, vs.s,
                       k0, pb.Sk, wt, cw);
  };
  const int units = nh * kParts;
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < units) load(i);
    cp_async_commit();
  }

  // the bias terms (bias log2 e, masked_score's rounding) of this thread's
  // positions, once for every head; the tile's ragged and causal tests
  float bl[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = k0 + j * 8 + 2 * t + (e & 1);
      bl[4 * j + e] =
          nh > 0 && row[r] < pb.Sq && col < pb.Sk
              ? __fmul_rn(__ldg(pb.bias + (static_cast<int64_t>(n) * pb.Sq +
                                           row[r]) * pb.Sk + col),
                          kLog2e)
              : 0.f;
    }
  const bool tile_edge = q0 + kTile > pb.Sq || k0 + kTile > pb.Sk ||
                         (pb.causal && k0 + kTile - 1 > q0);

  float s[32], dp[32];
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  for (int i = 0; i < units; ++i) {
    const int bh = n * pb.hp + i / kParts;
    const int part = i % kParts;
    const int cw = pb.hd - part * kW;  // the part's live columns
    // this head's lse log2 e and delta of the thread's two rows, issued
    // before the wait so that they land under it
    if (part == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] < pb.Sq) {
          const int64_t at = static_cast<int64_t>(bh) * pb.Sq + row[r];
          lse2[r] = ldg_pinned(lse + at);
          dl[r] = ldg_pinned(delta + at);
        }
      }
    }
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // unit i landed; every warp is done with unit i - 1
    if (i + C::kStages - 1 < units) load(i + C::kStages - 1);
    cp_async_commit();
    unsigned char* sqt = stage(i);
    const unsigned char* sdot = sqt + C::kTileBytes;
    const unsigned char* skt = sqt + (2 + 2 * wg) * C::kTileBytes;
    const unsigned char* svt = skt + C::kTileBytes;
    fold_tile<kW, C::kThreads, T>(sqt, pb.q_mul, threadIdx.x);  // T(q q_mul)
    fence_proxy_async();  // the folded q and the tiles, for wgmma
    __syncthreads();

    // S = (q q_mul) k^T and dP = do v^T: 64 rows x 64 keys each, summed
    // over the head's parts
    if (part == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    }
    reg_fence(s);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk)
      if (kstep_live(kk, cw))
        wgmma_m64n64k16<T, 0, 0>(s, kmajor_desc(sqt, kk),
                                 kmajor_desc(skt, kk));
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk)
      if (kstep_live(kk, cw))
        wgmma_m64n64k16<T, 0, 0>(dp, kmajor_desc(sdot, kk),
                                 kmajor_desc(svt, kk));
    wgmma_commit();
    if (part != kParts - 1) {  // the head's next part adds to s and dp
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
      continue;
    }
    // the keep bits of the thread's 32 positions while the products run
    // (a bit 4 j + e each; the hash is integer work the tensor cores do
    // not wait for)
    uint32_t keep = ~0u;
    if (pb.drop) {
      const uint32_t rkey[2] = {dropout_row_key(pb.seed, bh, row[0]),
                                dropout_row_key(pb.seed, bh, row[1])};
      keep = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep |= static_cast<uint32_t>(keep_bit(
                      rkey[e >> 1], k0 + j * 8 + 2 * t + (e & 1), pb.thr))
                  << (4 * j + e);
    }
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // db += p (keep dp / (1 - rate) - delta); e < 2 is row 0
    const int len = kv_len(pb, bh);
    const bool edge = tile_edge || k0 + kTile > len;
#pragma unroll
    // lse log2 e rounded apart, as the plain version's and the old body's
    // (left to the compiler, it fused it into an FMA with s + bias log2 e)
    for (int r = 0; r < 2; ++r) lse2[r] = __fmul_rn(lse2[r], kLog2e);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        if (edge && !key_live(pb, len, row[r], col)) continue;
        const float p = exp2f(s[4 * j + e] + bl[4 * j + e] - lse2[r]);
        float dpd = dp[4 * j + e];
        if (pb.drop)
          dpd = (keep >> (4 * j + e)) & 1u ? dpd * pb.keep_scale : 0.f;
        db[4 * j + e] += p * (dpd - dl[r]);
      }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= pb.Sq) continue;
    float* out = dbias + (static_cast<int64_t>(n) * pb.Sq + row[r]) * pb.Sk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + j * 8 + 2 * t;
      const float a = db[4 * j + 2 * r], b = db[4 * j + 2 * r + 1];
      if (col + 1 < pb.Sk && (pb.Sk & 1) == 0) {
        *reinterpret_cast<float2*>(out + col) = make_float2(a, b);
      } else {
        if (col < pb.Sk) out[col] = a;
        if (col + 1 < pb.Sk) out[col + 1] = b;
      }
    }
  }
}

template <typename T, int HD>
int launch_wgmma(const void* const* p, const int64_t* st, const Problem& pb,
                 int nb, int key_tiles, int stages, cudaStream_t stream) {
  using C = DbiasCfg<(HD > 128 ? 128 : HD)>;
  if (key_tiles != C::kWarpgroups || stages != C::kStages)
    return static_cast<int>(cudaErrorInvalidValue);  // not this plan
  // every call, as launch_pipe_fwd sets its own
  const cudaError_t e = cudaFuncSetAttribute(
      dbias_wgmma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nkt = (pb.Sk + kTile - 1) / kTile;
  const dim3 grid((nkt + C::kWarpgroups - 1) / C::kWarpgroups,
                  (pb.Sq + kTile - 1) / kTile, nb);
  dbias_wgmma_kernel<T, HD><<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<float*>(const_cast<void*>(p[6])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), pb);
  note_launch("dbias_wgmma_kernel");
  return 0;
}

// ---- fp32: CUDA cores ------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
    dbias_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout,
                     const float* __restrict__ delta,
                     float* __restrict__ dbias, Strides qs, Strides ks,
                     Strides vs, Strides dos, Problem pb) {
  constexpr int kW = HD > 128 ? 128 : HD;  // columns staged at a time
  constexpr int kParts = HD / kW;
  constexpr int kLd = kW + 1;
  extern __shared__ float sm[];
  float* sq = sm;                  // 64 x kLd, q * q_mul
  float* sdo = sq + kTile * kLd;   // 64 x kLd
  float* sk = sdo + kTile * kLd;   // 64 x kLd
  float* sv = sk + kTile * kLd;    // 64 x kLd
  float* slse = sv + kTile * kLd;  // 64, x log2 e
  float* sdelta = slse + kTile;    // 64
  const int kt = blockIdx.x;
  const int qt = blockIdx.y;
  const int n = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qt * kTile;
  const int k0 = kt * kTile;
  float db[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) db[i][j] = 0.f;

  const bool live = !(pb.causal && k0 > min(q0 + kTile, pb.Sq) - 1);
  for (int hh = 0; live && hh < pb.hp; ++hh) {
    const int bh = n * pb.hp + hh;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int c0 = part * kW;
      __syncthreads();
      stage_f32<kW>(sq, kLd, head(q, qs, bh, pb.H) + c0, qs.s, q0, pb.Sq,
                    pb.q_mul, pb.hd - c0);
      stage_f32<kW>(sdo, kLd, head(dout, dos, bh, pb.H) + c0, dos.s, q0,
                    pb.Sq, 1.f, pb.hd - c0);
      stage_f32<kW>(sk, kLd, head(k, ks, bh, pb.H) + c0, ks.s, k0, pb.Sk,
                    1.f, pb.hd - c0);
      stage_f32<kW>(sv, kLd, head(v, vs, bh, pb.H) + c0, vs.s, k0, pb.Sk,
                    1.f, pb.hd - c0);
      if (part == 0 && threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        const int64_t at = static_cast<int64_t>(bh) * pb.Sq + r;
        slse[threadIdx.x] = r < pb.Sq ? lse[at] * kLog2e : 0.f;
        sdelta[threadIdx.x] = r < pb.Sq ? delta[at] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kW; ++d) {
        float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = sq[(ty + 16 * i) * kLd + d];
          dov[i] = sdo[(ty + 16 * i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sk[(tx + 16 * j) * kLd + d];
          vv[j] = sv[(tx + 16 * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
    }
    const int len = kv_len(pb, bh);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
      const float* brow = bias_row(pb, bh, row);
      const uint32_t rk = dropout_row_key(pb.seed, bh, row);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float sc = masked_score(pb, len, brow, s[i][j], row, col);
        const float p = exp2f(sc - slse[r]);
        float dpd = dp[i][j];
        if (pb.drop)
          dpd = keep_bit(rk, col, pb.thr) ? dpd * pb.keep_scale : 0.f;
        db[i][j] += p * (dpd - sdelta[r]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= pb.Sq) continue;
    float* out = dbias + (static_cast<int64_t>(n) * pb.Sq + row) * pb.Sk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < pb.Sk) out[col] = db[i][j];
    }
  }
}

template <int HD>
int launch_f32(const void* const* p, const int64_t* st, const Problem& pb,
               int nb, int key_tiles, int stages, cudaStream_t stream) {
  if (key_tiles != 1 || stages != 1)
    return static_cast<int>(cudaErrorInvalidValue);  // not this plan
  const size_t smem =
      sizeof(float) * (4 * kTile * ((HD > 128 ? 128 : HD) + 1) + 2 * kTile);
  const cudaError_t e = cudaFuncSetAttribute(
      dbias_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((pb.Sk + kTile - 1) / kTile, (pb.Sq + kTile - 1) / kTile,
                  nb);
  dbias_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(p[0]), static_cast<const float*>(p[1]),
      static_cast<const float*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<float*>(const_cast<void*>(p[6])), strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), pb);
  note_launch("dbias_f32_kernel");
  return 0;
}

}  // namespace unpacked
}  // namespace apex_port

// q, k, v, lse, dout as flash_unpacked_bwd took them; delta: the fp32
// (B*H, Sq) rowsum(do * o) - dlse its dq pass wrote; dbias: the fp32
// contiguous (nb, Sq, Sk) output. st[0..11]: the (batch, head, row)
// element strides of q, k, v, dout. bias (the forward's, needed for p) is
// required. key_tiles and stages: `flash_dbias_plan`'s, which must be the
// route's own (DbiasCfg on "wgmma", 1 and 1 on "cuda_cores"). The rest as
// flash_unpacked_fwd.
extern "C" int flash_dbias(const void* q, const void* k, const void* v,
                           const void* lse, const void* dout,
                           const void* delta, void* dbias, const int64_t* st,
                           const void* bias, int nb, const void* lens, int B,
                           int H, int Sq, int Sk, int hd, int causal,
                           int dropout, unsigned seed, unsigned thr,
                           float keep_scale, float q_mul, int dtype,
                           int key_tiles, int stages, void* stream) {
  using namespace apex_port;
  using namespace apex_port::unpacked;
  const Problem pb = make_problem(B, H, Sq, Sk, causal, lens, bias, nb,
                                  dropout, seed, thr, keep_scale, q_mul, 1.f,
                                  hd);
  if (bias == nullptr || nb <= 0 || nb > 65535 || (B * H) % nb != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* p[7] = {q, k, v, lse, dout, delta, dbias};
  auto s = static_cast<cudaStream_t>(stream);
  int rc;
  if (is_half_code(dtype))
    rc = with_half(dtype, [&](auto h) {
      return at_width(hd, [&](auto w) {
        return launch_wgmma<decltype(h), decltype(w)::value>(
            p, st, pb, nb, key_tiles, stages, s);
      });
    });
  else if (dtype == kFloat32)
    rc = at_width(hd, [&](auto w) {
      return launch_f32<decltype(w)::value>(p, st, pb, nb, key_tiles, stages,
                                            s);
    });
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
