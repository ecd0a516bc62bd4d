"""Segment-masked attention over a packed token stream: the serving
forward with lse, the differentiable training form, and the paged chunk
read, each a hand-written CUDA kernel beside its plain PyTorch version.

Token i attends token j iff ``segment_ids[i] == segment_ids[j]`` and,
with ``causal``, ``j <= i`` in packed order (within-segment causality when
segments are contiguous).

**Serving** (``flash_attention_segments_with_lse``, port of the JAX
function of that name). Its kernel (``csrc/flash_segments.cu``) replaces
the TPU kernel ``_seg_fwd_kernel``
(rocm_apex_tpu/ops/flash_attention_segments.py:70) on the chunked-prefill
path. At the serving chunk's size it is bound by launch latency and the
per-row serial walk over keys, not by bytes or tensor-core work; its skip
of key tiles that share no segment with a row is exact per row and tile,
so it holds for segment ids in any order (the engine packs slot pieces in
scheduler order, pads carry the id num_slots). Its scores are those of
``_masked_scores`` (rocm_apex_tpu/ops/flash_attention.py:122): q times
scale * log2(e) rounded in q's dtype, then the fp32 product with k.
Forward only.

**Training** (``flash_attention_segments``, the JAX function with its
custom vjp, :342-486; contrib/fmha's packed path). The forward
(``csrc/flash_segments_fwd.cu``) replaces ``_seg_fwd_kernel`` as
``_seg_fwd`` (:247) runs it, the backward (``csrc/flash_segments_bwd.cu``,
a dq pass and a dk/dv pass) replaces ``_seg_dq_kernel`` (:173) and
``_seg_dkv_kernel`` (:120) as ``_seg_bwd`` (:281) runs them. All three
passes form the score of ``_masked_scores``
(rocm_apex_tpu/ops/flash_attention.py:122): q times scale * log2(e)
rounded in q's dtype, an fp32 product, another segment's key or a later
key under ``causal`` masked, the running max from -1e30; the backward
rebuilds p = exp2(s - lse log2 e) from the forward's natural-log lse,
with delta = sum(do * o) and ds = p (dp - delta), and dq and dk take the
scale at the end. Query and key tiles of 64 tokens; a pair is visited only
if the tiles' [min, max] id ranges meet (``_overlap``, :61) and the causal
triangle keeps it, so the work follows the sum of squared lengths. A
range test never skips a live pair, so ids in any order are exact. Tokens
past the stream in a ragged last tile add exactly 0 (nothing is padded).
bf16 runs on the wgmma pipes of the flash kernels
(``csrc/flash_fwd_pipe.cuh``, ``csrc/flash_bwd_pipe.cuh``) with their
segment flag, planned by `flash_segments_plan`; fp32 on the CUDA-core
bodies of ``csrc/flash_unpacked_{fwd,bwd}.cuh``; head_dim 64 or 128
(others raise on CUDA).

`flash_attention_chunk_paged` (port of the JAX function of that name) is
the chunked-prefill read against a paged cache: the serving kernel within
the chunk (piece A) and the paged decode kernel over each token's own
slot's pre-chunk prefix (piece B), merged by lse.
"""

import ctypes
import math
from typing import Optional

import torch

from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr
from rocm_apex_tpu_torch.ops.flash_attention import (
    _FWD_TILE,
    _SPAN_TILE,
    _UNPACKED_HEAD_DIMS,
    _aligned,
    _q_mul,
    _strides,
    _unpacked_common,
    check_head_dim,
    flash_attention_decode_paged,
    flash_unpacked_bwd_plain,
    flash_unpacked_fwd_plain,
)

__all__ = [
    "FLASH_SEGMENTS",
    "FLASH_SEGMENTS_FWD",
    "FLASH_SEGMENTS_BWD",
    "DEFAULT_BLOCK",
    "SERVE_FRAME",
    "flash_attention_segments",
    "flash_attention_segments_with_lse",
    "flash_attention_segments_plain",
    "flash_attention_segments_bwd_plain",
    "flash_attention_chunk_paged",
    "flash_segments_plan",
    "flash_segments_tables_plain",
    "merge_by_lse",
]

DEFAULT_BLOCK = 512  # the JAX default of block_q and block_k
# the keys a step of the serving read's warp walk (csrc/attention_row.cuh,
# the decode reads' tile too), the frame its p is rounded in
SERVE_FRAME = _SPAN_TILE
# the tokens of a segment range (csrc/flash_unpacked.cuh kRangeRows), and
# the most 64-token tiles the bf16 kernels take: their grids carry the tiles
# on y
_RANGE_ROWS = 32
_SEG_PIPE_TILES = 65535

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
FLASH_SEGMENTS = Kernel(
    name="flash_attention_segments_with_lse",
    source="flash_segments.cu",
    symbol="flash_segments",
    argtypes=[_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _P, _I, _I, _I,
              _I, ctypes.c_float, _I, _P, _P, _P],
    replaces="rocm_apex_tpu/ops/flash_attention_segments.py:70 _seg_fwd_kernel",
)


FLASH_SEGMENTS_FWD = Kernel(
    name="flash_segments_fwd",
    source="flash_segments_fwd.cu",
    symbol="flash_segments_fwd",
    argtypes=[_P] * 5 + [ctypes.POINTER(_I64), _P, _P] + [_I] * 4
    + [ctypes.c_float, ctypes.c_float, _I, _P],
    replaces="rocm_apex_tpu/ops/flash_attention_segments.py:70 "
             "_seg_fwd_kernel (via _seg_fwd, training)",
)
FLASH_SEGMENTS_BWD = Kernel(
    name="flash_segments_bwd",
    source="flash_segments_bwd.cu",
    symbol="flash_segments_bwd",
    argtypes=[_P] * 10 + [ctypes.POINTER(_I64), _P, _P] + [_I] * 4
    + [ctypes.c_float, ctypes.c_float, _I, _P],
    replaces="rocm_apex_tpu/ops/flash_attention_segments.py:173 "
             "_seg_dq_kernel, :120 _seg_dkv_kernel (via _seg_bwd)",
)


def _segment_bias(segment_ids, device):
    """The segment mask as the unpacked plain versions' additive bias:
    (1, total, total) fp32, 0 where two tokens share a segment, -inf
    elsewhere (a masked score, as the kernels' `masked_score` gives)."""
    seg = segment_ids.to(device=device, dtype=torch.long)
    return torch.where(seg[:, None] == seg[None, :], 0.0,
                       float("-inf"))[None]


def flash_attention_segments_plain(q, k, v, segment_ids, causal, scale,
                                   frame=None):
    """The plain PyTorch version of the segment forward, serving and
    training: returns (o, lse), o (heads, total, head_dim) in q's dtype,
    lse (heads, total) natural-log fp32. It is the unpacked plain version
    with the segment mask as a bias, so its scores follow the JAX rule: q
    times scale * log2(e) rounded in q's dtype, then the fp32 product; p
    is rounded to v's dtype in the frame of ``frame``-key tiles (the
    training kernel's 64 by default; the serving read's is `SERVE_FRAME`)."""
    return flash_unpacked_fwd_plain(
        q, k, v, _segment_bias(segment_ids, q.device), causal, scale,
        frame=frame)


def flash_attention_segments_bwd_plain(q, k, v, segment_ids, o, lse, do,
                                       causal, scale):
    """The plain PyTorch version of the segment backward (`_seg_bwd`):
    dq, dk, dv in the operands' dtype, from the forward's o and lse by the
    kernels' formulas (the unpacked plain backward with the segment mask
    as a bias), not by differentiating the plain forward."""
    dq, dk, dv, _ = flash_unpacked_bwd_plain(
        q, k, v, _segment_bias(segment_ids, q.device), o, lse, do, causal,
        scale)
    return dq, dk, dv


def flash_attention_segments_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
):
    """Packed attention over (heads, total, head_dim) q/k/v with
    (total,) int32 segment ids; returns ``(o, lse)``: o (heads, total,
    head_dim) in q's dtype, lse (heads, total) natural-log fp32."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q/k/v must all be (heads, total, head_dim)")
    h, total, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if segment_ids.shape != (total,):
        raise ValueError(f"segment_ids must be ({total},)")
    if q.device.type == "cpu":
        return flash_attention_segments_plain(q, k, v, segment_ids, causal,
                                              scale, SERVE_FRAME)
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q/k/v must share one dtype")
    for t in (k, v, segment_ids):
        if t.device != q.device:
            raise ValueError("all operands must be on q's device")
    if segment_ids.dtype != torch.int32 or not segment_ids.is_contiguous():
        raise TypeError("segment_ids must be contiguous int32")
    check_head_dim(q, k, v)
    o = torch.empty((h, total, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((h, total), dtype=torch.float32, device=q.device)
    if h * total > 0:
        FLASH_SEGMENTS(
            ptr(q), q.stride(0), q.stride(1), ptr(k), k.stride(0),
            k.stride(1), ptr(v), v.stride(0), v.stride(1), ptr(segment_ids),
            h, total, d, int(bool(causal)), _q_mul(scale, q.dtype),
            dtype_code(q.dtype), ptr(o), ptr(lse), stream_ptr(q.device),
        )
    return o, lse


def _seg_check(q, k, v, segment_ids):
    """Checks shared by the training wrappers on (heads, total, head_dim)
    q/k/v (the unpacked kernels' checks, batch 1); returns the ids, int32
    on q's device for the kernels."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("q/k/v must all be (heads, total, head_dim)")
    if segment_ids.shape != q.shape[1:2]:
        raise ValueError(f"segment_ids must be ({q.shape[1]},)")
    _unpacked_common(q[None], k[None], v[None], None, None)
    if q.device.type == "cpu":
        return segment_ids
    return segment_ids.to(device=q.device, dtype=torch.int32).contiguous()


def flash_segments_plan(h: int, total: int, hd: int,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """The training segment kernels' route, grids and buffers, from the
    shape alone.

    ``route``: ``"wgmma"`` for bf16 (the forward and backward pipes,
    ``csrc/flash_fwd_pipe.cuh`` and ``csrc/flash_bwd_pipe.cuh``, with
    their segment flag) and ``"cuda_cores"`` for fp32 (the bodies of
    ``csrc/flash_unpacked_{fwd,bwd}.cuh``); head_dim 64 or 128, any other
    raises. ``splits`` is 1: the key tiles of a query tile are set by the
    ids, which a plan does not read, so the forward has no key split and
    p keeps the unsplit 64-key frame. Each pass is a grid of (head,
    64-token tile) units, ``tiles`` a head: (h, tiles) on the pipes, in the
    order of the device's pre-pass (the longest walk first), so at most
    `_SEG_PIPE_TILES` tiles (a longer bf16 stream raises), and (tiles, h)
    on the CUDA cores. ``stats``: the fp32 scratch the dq pass hands the
    dk/dv pass, (h, 64 tiles, 2) pairs of (lse log2 e, delta) on the pipe,
    delta alone, (h, total), on the CUDA cores. ``workspace``: the int32
    words of the segment tables, `flash_segments_tables_plain`'s."""
    if hd not in _UNPACKED_HEAD_DIMS:
        raise ValueError(f"the segment attention kernels take head_dim in "
                         f"{_UNPACKED_HEAD_DIMS}, got {hd}")
    tiles = -(-total // _FWD_TILE)
    workspace = 6 * tiles + 2 * -(-total // _RANGE_ROWS)
    if dtype != torch.bfloat16:
        return dict(route="cuda_cores", rows=_FWD_TILE, splits=1,
                    tiles=tiles, grid=(tiles, h), stats=(h, total),
                    workspace=workspace)
    if tiles > _SEG_PIPE_TILES:
        raise ValueError(
            f"the bf16 segment kernels take at most {_SEG_PIPE_TILES} "
            f"tiles of {_FWD_TILE} tokens (a grid's y), got {tiles} "
            f"({total} tokens)")
    return dict(route="wgmma", rows=_FWD_TILE, splits=1, tiles=tiles,
                grid=(h, tiles), stats=(h, tiles * _FWD_TILE, 2),
                workspace=workspace)


def flash_segments_tables_plain(segment_ids: torch.Tensor,
                                causal: bool) -> torch.Tensor:
    """The plain version of the segment pre-passes (csrc/flash_unpacked.cuh
    `seg_ranges_kernel`, `seg_tiles_kernel`, `seg_order_kernel`): the
    int32 workspace words they write, in `flash_segments_plan`'s layout.
    First each 64-token tile t's (lo, hi, cq, ck): lo and hi the first and
    the last tile whose [min, max] id range meets t's, cq and ck the tiles
    a pipe unit of t walks as a query tile ([lo, t] when causal, else [lo,
    hi]) and as a key tile ([t, hi], else [lo, hi]). Then the units' order:
    the query tiles by cq, longest first (ties: the later tile first, as
    the pipes' index order counts query tiles down), then the key tiles by
    ck (ties: the earlier tile first). Last the (min, max) id of each 32
    tokens (the last of them over the tokens there are)."""
    seg = segment_ids.to(device="cpu", dtype=torch.int64).flatten()
    total = seg.numel()
    if total == 0:
        return torch.zeros((0,), dtype=torch.int32)
    n32, nt = -(-total // _RANGE_ROWS), -(-total // _FWD_TILE)
    pad = n32 * _RANGE_ROWS - total
    lo32 = torch.cat([seg, seg.new_full((pad,), 2 ** 40)])
    hi32 = torch.cat([seg, seg.new_full((pad,), -2 ** 40)])
    lo32, hi32 = lo32.view(n32, _RANGE_ROWS), hi32.view(n32, _RANGE_ROWS)
    ranges = torch.stack([lo32.amin(1), hi32.amax(1)], dim=1)
    per = _FWD_TILE // _RANGE_ROWS
    pad = nt * per - n32
    rlo = torch.cat([ranges[:, 0], ranges.new_full((pad,), 2 ** 40)])
    rhi = torch.cat([ranges[:, 1], ranges.new_full((pad,), -2 ** 40)])
    rlo, rhi = rlo.view(nt, per).amin(1), rhi.view(nt, per).amax(1)
    meet = (rlo[:, None] <= rhi[None, :]) & (rhi[:, None] >= rlo[None, :])
    t = torch.arange(nt)
    lo = meet.int().argmax(1)
    hi = nt - 1 - meet.flip(1).int().argmax(1)
    cq = (t if causal else hi) - lo + 1
    ck = hi - (t if causal else lo) + 1
    down = t.flip(0)
    order_q = down[torch.sort(-cq[down], stable=True).indices]
    order_k = torch.sort(-ck, stable=True).indices
    return torch.cat([torch.stack([lo, hi, cq, ck], dim=1).flatten(),
                      order_q, order_k, ranges.flatten()]).to(torch.int32)


def _seg_workspace(plan, device):
    return torch.empty((plan["workspace"],), dtype=torch.int32,
                       device=device)


def _seg_fwd(q, k, v, segment_ids, causal, scale, token_major=False):
    """The training forward on (heads, total, head_dim) q/k/v (views, read
    through their strides): returns o (heads, total, head_dim) in q's
    dtype and lse (heads, total) fp32. With ``token_major`` o's memory is
    (total, heads, head_dim), fmha's output layout."""
    seg = _seg_check(q, k, v, segment_ids)
    h, total, d = q.shape
    if q.device.type == "cpu":
        return flash_attention_segments_plain(q, k, v, seg, causal, scale)
    plan = flash_segments_plan(h, total, d, q.dtype)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if token_major:
        o = torch.empty((total, h, d), dtype=q.dtype,
                        device=q.device).transpose(0, 1)
    else:
        o = torch.empty((h, total, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((h, total), dtype=torch.float32, device=q.device)
    if o.numel() > 0:
        FLASH_SEGMENTS_FWD(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
            _strides(q[None], k[None], v[None], o[None]), ptr(seg),
            ptr(_seg_workspace(plan, q.device)), h, total, d,
            int(bool(causal)), _q_mul(scale, q.dtype), float(scale),
            dtype_code(q.dtype), stream_ptr(q.device),
        )
    return o, lse


def _seg_bwd(q, k, v, segment_ids, o, lse, do, causal, scale, dqkv=None):
    """The training backward: dq, dk, dv (heads, total, head_dim) in the
    operands' dtype. With ``dqkv``, a (total, 3, heads, head_dim) buffer,
    they are written into its three (heads, total, head_dim) views, the
    layout of the fused projection they came from."""
    seg = _seg_check(q, k, v, segment_ids)
    h, total, d = q.shape
    if dqkv is not None:
        dq, dk, dv = (dqkv[:, i].transpose(0, 1) for i in range(3))
    if q.device.type == "cpu":
        grads = flash_attention_segments_bwd_plain(q, k, v, seg, o, lse, do,
                                                   causal, scale)
        if dqkv is None:
            return grads
        for out, g in zip((dq, dk, dv), grads):
            out.copy_(g)
        return dq, dk, dv
    plan = flash_segments_plan(h, total, d, q.dtype)
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do.to(q.dtype)))
    if dqkv is None:
        dq, dk, dv = (torch.empty((h, total, d), dtype=q.dtype,
                                  device=q.device) for _ in range(3))
    stats = torch.empty(plan["stats"], dtype=torch.float32, device=q.device)
    if total * h > 0:
        FLASH_SEGMENTS_BWD(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse.contiguous()), ptr(do),
            ptr(dq), ptr(dk), ptr(dv), ptr(stats),
            _strides(*(t[None] for t in (q, k, v, o, do, dq, dk, dv))),
            ptr(seg), ptr(_seg_workspace(plan, q.device)), h, total, d,
            int(bool(causal)), _q_mul(scale, q.dtype), float(scale),
            dtype_code(q.dtype), stream_ptr(q.device),
        )
    return dq, dk, dv


class _FlashSegments(torch.autograd.Function):
    """`flash_attention_segments` over q, k, v: returns o."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        o, lse = _seg_fwd(q, k, v, segment_ids, causal, scale)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.args = (causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_ids, o, lse = ctx.saved_tensors
        dq, dk, dv = _seg_bwd(q, k, v, segment_ids, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_segments(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK,
    block_k: int = DEFAULT_BLOCK,
) -> torch.Tensor:
    """Flash attention over a packed token stream, differentiable in
    q/k/v.

    ``q/k/v``: (heads, total, head_dim), any head and token strides;
    ``segment_ids``: (total,) int, one id per sequence. Token i attends
    token j iff their ids match (and, with ``causal``, j <= i). ``scale``
    defaults to 1/sqrt(head_dim). ``block_q``/``block_k`` are accepted for
    the JAX signature; the kernels choose their own tiles (64 tokens).
    Every allocation is O(total)."""
    del block_q, block_k
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashSegments.apply(q, k, v, segment_ids, bool(causal),
                                float(scale))


def merge_by_lse(o_a, lse_a, o_b, lse_b):
    """Two attention pieces over disjoint key sets, (tokens, heads,
    head_dim) with (tokens, heads) lse, merged in fp32."""
    m = torch.maximum(lse_a, lse_b)
    w_a = torch.exp(lse_a - m)[..., None]
    w_b = torch.exp(lse_b - m)[..., None]
    return (w_a * o_a.float() + w_b * o_b.float()) / (w_a + w_b)


def flash_attention_chunk_paged(
    q: torch.Tensor,
    k_chunk: torch.Tensor,
    v_chunk: torch.Tensor,
    segment_ids: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
) -> torch.Tensor:
    """A packed chunk against a paged cache prefix.

    ``q``/``k_chunk``/``v_chunk``: (heads, budget, head_dim), the chunk's
    fresh projections; ``segment_ids``: (budget,) int32 slot ids,
    ``num_slots`` marking padding. Pools, table, pre-chunk lengths,
    scales and capacity as in `flash_attention_decode_paged`. Piece A:
    segment-causal attention within the chunk. Piece B: each token
    against its OWN slot's prefix only (a pad reads nothing), not the
    JAX function's broadcast of the chunk to every slot. Returns fp32
    (budget, heads, head_dim).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o_a, lse_a = flash_attention_segments_with_lse(
        q, k_chunk, v_chunk, segment_ids, causal=True, scale=scale
    )
    o_b, lse_b = flash_attention_decode_paged(
        q.transpose(0, 1), k_pool, v_pool, page_table, kv_lengths, scale,
        k_scale, v_scale, return_lse=True, slot_ids=segment_ids,
        capacity=capacity,
    )
    return merge_by_lse(o_a.transpose(0, 1), lse_a.transpose(0, 1), o_b,
                        lse_b)
