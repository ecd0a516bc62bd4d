"""Packed variable-length attention over cumulative sequence offsets.

Port of ``rocm_apex_tpu/contrib/fmha/fmha.py``: qkv ``(total, 3, h, d)``
packed along the token axis, ``cu_seqlens`` (b+1,) int32 prefix offsets,
returns ``(total, h, d)``.

``packed=True`` (the default) runs segment attention straight over the
token stream (`flash_attention_segments`' kernels): q, k and v are
strided (h, total, d) views of qkv, read in place; the context is written
in (total, h, d) memory, and the backward writes dq, dk and dv straight
into one (total, 3, h, d) gradient, the fused projection's layout. Every
allocation is O(total): nothing of size b * max_s or total².

``packed=False`` keeps the padded-batch path: qkv is scattered into a
zero (b, max_s, 3, h, d) batch, `flash_attention_varlen` runs over it
with per-row key bounds, and the real tokens are gathered back.
"""

import math
from typing import Optional

import torch
from torch import nn

from rocm_apex_tpu_torch.ops.flash_attention import flash_attention_varlen
from rocm_apex_tpu_torch.ops.flash_attention_segments import (
    _seg_bwd,
    _seg_fwd,
)

__all__ = ["fmha", "FMHA"]


def _unpack_ids(cu_seqlens: torch.Tensor, total: int, max_s: int):
    """token -> (sequence, offset within the sequence) for packed
    layouts. A zero-length sequence owns no token."""
    del max_s
    cu = cu_seqlens.to(torch.long)
    tok = torch.arange(total, device=cu.device)
    seq_id = torch.searchsorted(cu[1:], tok, right=True)
    return seq_id, tok - cu[seq_id]


class _PackedFMHA(torch.autograd.Function):
    """Segment attention over the views of a fused (total, 3, h, d) qkv:
    the context (total, h, d) and the gradient dqkv in qkv's layout."""

    @staticmethod
    def forward(ctx, qkv, seg, causal, scale):
        q, k, v = (qkv[:, i].transpose(0, 1) for i in range(3))
        o, lse = _seg_fwd(q, k, v, seg, causal, scale, token_major=True)
        ctx.save_for_backward(qkv, seg, o, lse)
        ctx.args = (causal, scale)
        return o.transpose(0, 1)

    @staticmethod
    def backward(ctx, do):
        qkv, seg, o, lse = ctx.saved_tensors
        q, k, v = (qkv[:, i].transpose(0, 1) for i in range(3))
        dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
        _seg_bwd(q, k, v, seg, o, lse, do.transpose(0, 1), *ctx.args,
                 dqkv=dqkv)
        return dqkv, None, None, None


def fmha(
    qkv: torch.Tensor,
    cu_seqlens: torch.Tensor,
    max_s: int,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    packed: bool = True,
) -> torch.Tensor:
    """Packed-varlen attention: ``qkv (total, 3, h, d)`` -> ``(total, h,
    d)``, differentiable in qkv.

    ``cu_seqlens`` is the (b+1,) int32 prefix sum of the sequence lengths
    (zero lengths allowed) and ``max_s`` the padding length of the padded
    path. ``scale`` defaults to 1/sqrt(d). ``packed`` selects segment
    attention over the token stream (default) or the padded batch."""
    total, three, h, d = qkv.shape
    if three != 3:
        raise ValueError(f"qkv must be (total, 3, heads, head_dim), got "
                         f"{tuple(qkv.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    cu_seqlens = cu_seqlens.to(qkv.device)
    b = cu_seqlens.shape[0] - 1
    seq_id, offset = _unpack_ids(cu_seqlens, total, max_s)
    if packed:
        return _PackedFMHA.apply(qkv, seq_id.to(torch.int32), bool(causal),
                                 scale)
    # scatter the packed tokens into the padded (b, max_s, 3, h, d) batch
    padded = qkv.new_zeros((b, max_s, 3, h, d)).index_put(
        (seq_id, offset), qkv)
    q, k, v = (padded[:, :, i].transpose(1, 2).reshape(b * h, max_s, d)
               for i in range(3))
    # per-(batch*heads)-row key bound, in the kernel: a row of a
    # zero-length sequence has unspecified output, and no token gathers it
    lengths = (cu_seqlens[1:] - cu_seqlens[:-1]).to(torch.int32)
    kv_lengths = lengths.repeat_interleave(h)
    ctx = flash_attention_varlen(q, k, v, kv_lengths, causal, scale)
    ctx = ctx.reshape(b, h, max_s, d).transpose(1, 2)  # (b, s, h, d)
    return ctx[seq_id, offset]


class FMHA(nn.Module):
    """Module facade (the JAX `FMHA`): packed qkv in, context out; the
    projections belong to the caller. Holds no parameters."""

    def __init__(self, causal: bool = False):
        super().__init__()
        self.causal = causal

    def forward(self, qkv, cu_seqlens, max_s):
        return fmha(qkv, cu_seqlens, max_s, causal=self.causal)
