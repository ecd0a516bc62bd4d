"""Segment-masked packed attention with lse: the hand-written CUDA kernel
and its plain PyTorch version.

Port of ``flash_attention_segments_with_lse``
(rocm_apex_tpu/ops/flash_attention_segments.py). The kernel
(``csrc/flash_segments.cu``) replaces the TPU kernel ``_seg_fwd_kernel``
(rocm_apex_tpu/ops/flash_attention_segments.py:70). At the serving
chunk's size it is bound by launch latency and the per-row serial walk
over keys, not by bytes or tensor-core work; its skip of key tiles that
share no segment with a row is exact per row and tile, so it holds for
segment ids in any order (the engine packs slot pieces in scheduler
order, pads carry the id num_slots).

Token i attends token j iff ``segment_ids[i] == segment_ids[j]`` and,
with ``causal``, ``j <= i`` in packed order. Forward only.

`flash_attention_chunk_paged` (port of the JAX function of that name) is
the chunked-prefill read against a paged cache: this kernel within the
chunk (piece A) and the paged decode kernel over each token's own slot's
pre-chunk prefix (piece B), merged by lse.
"""

import ctypes
import math
from typing import Optional

import torch

from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr
from rocm_apex_tpu_torch.ops.flash_attention import (
    NEG_INF,
    check_head_dim,
    flash_attention_decode_paged,
)

__all__ = [
    "FLASH_SEGMENTS",
    "flash_attention_segments_with_lse",
    "flash_attention_segments_plain",
    "flash_attention_chunk_paged",
    "merge_by_lse",
]

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


def flash_attention_segments_plain(q, k, v, segment_ids, causal, scale):
    """The plain PyTorch version: returns (o, lse), o in q's dtype."""
    h, total, d = q.shape
    seg = segment_ids.to(device=q.device, dtype=torch.long)
    mask = seg[:, None] == seg[None, :]
    if causal:
        mask = mask & torch.ones(
            (total, total), dtype=torch.bool, device=q.device
        ).tril()
    scores = torch.einsum("hid,hjd->hij", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[None], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    empty = torch.isneginf(lse)
    p = torch.exp(scores - torch.where(empty, 0.0, lse)[..., None])
    o = torch.einsum("hij,hjd->hid", p, v.float())
    lse = torch.where(empty, NEG_INF, lse)
    return o.to(q.dtype), lse


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
        return flash_attention_segments_plain(
            q, k, v, segment_ids, causal, scale
        )
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
            h, total, d, int(bool(causal)), float(scale),
            dtype_code(q.dtype), ptr(o), ptr(lse), stream_ptr(q.device),
        )
    return o, lse


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
) -> torch.Tensor:
    """A packed chunk against a paged cache prefix.

    ``q``/``k_chunk``/``v_chunk``: (heads, budget, head_dim), the chunk's
    fresh projections; ``segment_ids``: (budget,) int32 slot ids,
    ``num_slots`` marking padding. Pools, table, pre-chunk lengths and
    scales as in `flash_attention_decode_paged`. Piece A: segment-causal
    attention within the chunk. Piece B: each token against its OWN
    slot's prefix only (a pad reads nothing), not the JAX function's
    broadcast of the chunk to every slot. Returns fp32 (budget, heads,
    head_dim).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o_a, lse_a = flash_attention_segments_with_lse(
        q, k_chunk, v_chunk, segment_ids, causal=True, scale=scale
    )
    o_b, lse_b = flash_attention_decode_paged(
        q.transpose(0, 1), k_pool, v_pool, page_table, kv_lengths, scale,
        k_scale, v_scale, return_lse=True, slot_ids=segment_ids,
    )
    return merge_by_lse(o_a.transpose(0, 1), lse_a.transpose(0, 1), o_b,
                        lse_b)
