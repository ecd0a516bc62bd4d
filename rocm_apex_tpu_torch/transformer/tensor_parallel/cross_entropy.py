"""Vocab-parallel softmax cross-entropy.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/cross_entropy.py``:
the per-token loss of logits whose last dim is this rank's block of the
vocabulary, in fp32 whatever the logits' dtype:

    1. the local max, reduced to the global max over the tensor group;
    2. the local sum of exp(logit - max) and the target logit (masked
       to 0 outside this rank's vocabulary range), summed over the
       group (one all-reduce of both);
    loss = log(sum_exp) - target logit.

The backward is JAX's ``custom_vjp`` rule: the probabilities recomputed
in fp32 from the saved logits and row statistics, minus the local
one-hot, times the cotangent; no exchange. The plain PyTorch ops are
JAX's XLA code (no Pallas kernel). Label smoothing and ``ignore_index``
are not taken here (the GPT model refuses them at tp > 1 with the
materialized head, as JAX's does).
"""

from typing import Optional

import torch

from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, group):
        lf = logits.float()
        v_local = lf.shape[-1]
        start = parallel_state.axis_rank(group) * v_local
        logits_max = parallel_state.all_reduce(lf.max(dim=-1).values,
                                               group, op="max")
        shifted = lf - logits_max[..., None]
        local = target.long() - start
        in_range = (local >= 0) & (local < v_local)
        clamped = local.clamp(0, v_local - 1)
        predicted = torch.where(
            in_range, shifted.gather(-1, clamped[..., None])[..., 0], 0.0)
        sums = parallel_state.all_reduce(
            torch.stack([predicted, shifted.exp().sum(dim=-1)]), group)
        predicted, sum_exp = sums[0], sums[1]
        ctx.save_for_backward(logits, logits_max, sum_exp, in_range,
                              clamped)
        return sum_exp.log() - predicted

    @staticmethod
    def backward(ctx, g):
        logits, logits_max, sum_exp, in_range, clamped = ctx.saved_tensors
        sm = (logits.float() - logits_max[..., None]).exp() / sum_exp[
            ..., None]
        sm.scatter_add_(-1, clamped[..., None],
                        -in_range.float()[..., None])
        return (sm * g.float()[..., None]).to(logits.dtype), None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 axis_name: Optional[str] = None
                                 ) -> torch.Tensor:
    """Per-token fp32 losses, shape ``target.shape`` (not reduced), of
    ``(..., vocab / tp)`` logits of this rank's vocabulary block and
    global target ids, over the group bound to ``axis_name`` (None: the
    tensor axis)."""
    axis_name = parallel_state.TENSOR_AXIS if axis_name is None else axis_name
    return _VocabParallelCE.apply(vocab_parallel_logits, target,
                                  parallel_state.resolve_group(axis_name))
