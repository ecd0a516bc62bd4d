"""Context parallelism: ring attention and Ulysses all-to-all.

Port of ``rocm_apex_tpu/transformer/context_parallel.py`` over
`torch.distributed`: a long sequence sharded contiguously over the ranks
of a process group (rank r holds tokens [r * s_local, (r + 1) * s_local)),
named by a process group or by an axis name bound in `parallel_state`.

* `ring_flash_attention`: the K/V shards travel the ring (rank r sends
  to r + 1 and receives from r - 1); each hop is the unpacked flash
  forward with lse (`flash_attention_with_lse`, rows 7b and 9b) of the
  local queries against the resident block: full attention for a block
  from an earlier rank, causal for its own, nothing (no launch) for a
  later one under ``causal``; the partials merge by log-sum-exp
  (`_merge`, JAX's, safe where both are empty). The JAX ring
  differentiates through ``ppermute``, whose transpose is the reverse
  ``ppermute``; here `_RingKV` makes every hop's block in one autograd
  node, whose backward shifts the blocks' gradients back along the ring,
  so every rank takes part in every exchange of the backward whatever
  hops it used. Each hop's lse cotangent reaches the flash backward's
  ``dlse``.
* `ulysses_attention`: an all-to-all swaps the sharded dimension from
  the sequence to the heads, flash attention runs over the whole
  sequence for h / n heads, and a second all-to-all swaps back; the
  backward of each is the reverse all-to-all (`_AllToAll`).

Over a gloo group, whose point-to-point and all-to-all take CPU tensors
only, the exchanges copy CUDA tensors through host memory
(`parallel_state.exchange`); the kernels stay on the card. Collectives
need every rank to call them in one order, so every rank must call
these functions (and their backward) the same number of times.
"""

from typing import Optional, Union

import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.ops.flash_attention import (
    flash_attention_heads,
    flash_attention_with_lse,
)
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["ring_flash_attention", "ulysses_attention"]

GroupOrAxis = Union[str, "dist.ProcessGroup"]


def _merge(o1, lse1, o2, lse2):
    """Two partials over disjoint keys by the online-softmax rule, in
    fp32. Where both are empty (lse -inf) the weights are 0, not NaN."""
    lse = torch.logaddexp(lse1, lse2)
    safe = torch.where(torch.isneginf(lse), 0.0, lse)
    w1 = torch.exp(lse1 - safe)[..., None]
    w2 = torch.exp(lse2 - safe)[..., None]
    return o1.float() * w1 + o2.float() * w2, lse


class _RingKV(torch.autograd.Function):
    """The stacked (2, ...) K/V block every hop of the ring holds: output
    i is the block of rank r - i. The backward adds the hops' gradients
    back along the ring (the reverse shift of each hop), so each rank's
    own block gets every hop's gradient of it."""

    @staticmethod
    def forward(ctx, kv, group, n):
        ctx.group, ctx.n = group, n
        hops = [kv]
        for _ in range(n - 1):
            hops.append(parallel_state.shift(hops[-1], group, 1))
        return tuple(hops)

    @staticmethod
    def backward(ctx, *grads):
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = parallel_state.shift(acc, ctx.group, -1) + g
        return acc, None, None


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group_or_axis: GroupOrAxis = parallel_state.CONTEXT_AXIS,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over a sequence sharded on the group: q, k, v are
    this rank's (batch*heads, s_local, head_dim) shards; returns its
    output shard in q's dtype. Differentiable in q, k and v."""
    group = parallel_state.resolve_group(group_or_axis)
    n, my = dist.get_world_size(group), dist.get_rank(group)
    bh, s_loc, dh = q.shape
    hops = _RingKV.apply(torch.stack([k, v]), group, n)
    o = torch.zeros((bh, s_loc, dh), dtype=torch.float32, device=q.device)
    lse = torch.full((bh, s_loc), float("-inf"), dtype=torch.float32,
                     device=q.device)
    for i, kv in enumerate(hops):
        src = (my - i) % n  # whose block is resident at this hop
        if causal and src > my:
            continue  # the future: contributes nothing
        o_i, lse_i = flash_attention_with_lse(
            q, kv[0], kv[1], None, causal and src == my, scale)
        o, lse = _merge(o, lse, o_i, lse_i)
    return o.to(q.dtype)


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: chunk j of x along ``split_dim`` goes to
    rank j; the chunks received concatenate along ``concat_dim`` in rank
    order."""
    n = dist.get_world_size(group)

    def swap(send, g):
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=g)
        return recv

    recv = parallel_state.exchange(
        "all_to_all", swap, torch.stack(x.detach().chunk(n, split_dim)),
        group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group_or_axis: GroupOrAxis = parallel_state.CONTEXT_AXIS,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """All-to-all sequence parallelism: q, k, v are this rank's (b,
    s_local, heads, head_dim) shards with every head; heads must divide
    by the group's size. Returns the (b, s_local, heads, head_dim) output
    shard. Differentiable in q, k and v."""
    group = parallel_state.resolve_group(group_or_axis)
    n = dist.get_world_size(group)
    b, s_loc, h, dh = q.shape
    if h % n:
        raise ValueError(f"num heads {h} not divisible by axis size {n}")
    # one exchange for the three: (3, b, s_loc, h, d) -> (3, b, s, h/n, d)
    qkv = _AllToAll.apply(torch.stack([q, k, v]), group, 3, 2)
    qg, kg, vg = (t.permute(0, 2, 1, 3) for t in qkv.unbind(0))
    o = flash_attention_heads(qg, kg, vg, None, causal, scale)
    o = o.view(b, n * s_loc, h // n, dh)
    return _AllToAll.apply(o, group, 1, 2)
