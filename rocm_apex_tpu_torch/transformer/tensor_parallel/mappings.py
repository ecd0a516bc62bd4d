"""The tensor-parallel and sequence-parallel region mappings.

Port of ``rocm_apex_tpu/transformer/tensor_parallel/mappings.py``: each
is a `torch.autograd.Function` whose backward is the JAX function's
``custom_vjp`` rule, over the process group bound to an axis name
(`parallel_state`; None is ``TENSOR_AXIS``) or a group itself:

    copy    : identity fwd / all-reduce bwd
    reduce  : all-reduce fwd / identity bwd
    scatter : this rank's block of the last dim fwd / all-gather bwd
    gather  : all-gather of the last dim fwd / this rank's block bwd

and, along a sequence dimension ``dim`` (0 by default, as JAX):

    scatter_to_sequence_parallel_region      : block fwd / all-gather bwd
    gather_from_sequence_parallel_region     : all-gather fwd /
        reduce-scatter bwd (``tensor_parallel_output_grad``), else block
    reduce_scatter_to_sequence_parallel_region : reduce-scatter fwd /
        all-gather bwd

The exchanges are `parallel_state`'s (host-staged over gloo for tensors
on a card). Every rank of the group must call a mapping, and its
backward, in the same order.
"""

import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
]


def _group(axis_name):
    return parallel_state.resolve_group(
        parallel_state.TENSOR_AXIS if axis_name is None else axis_name)


def _block(x, group, dim):
    """This rank's block of x along ``dim`` (JAX's ``_split_dim``)."""
    dim = dim % x.dim()
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible "
                         f"by axis size {n}")
    return x.chunk(n, dim)[dist.get_rank(group)]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return parallel_state.all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return parallel_state.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Block(torch.autograd.Function):
    """This rank's block along ``dim`` / the all-gather back."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim % x.dim()
        return _block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return parallel_state.all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """The all-gather along ``dim`` / the reduce-scatter back (``rs``),
    else this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim, rs):
        ctx.group, ctx.dim, ctx.rs = group, dim % x.dim(), rs
        return parallel_state.all_gather(x, group, dim % x.dim())

    @staticmethod
    def backward(ctx, g):
        if ctx.rs:
            g = parallel_state.reduce_scatter(g, ctx.group, ctx.dim)
        else:
            g = _block(g, ctx.group, ctx.dim)
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim % x.dim()
        return parallel_state.reduce_scatter(x, group, dim % x.dim())

    @staticmethod
    def backward(ctx, g):
        return parallel_state.all_gather(g, ctx.group, ctx.dim), None, None


def copy_to_tensor_model_parallel_region(x, axis_name=None):
    """Input to a column-parallel layer: identity forward, the gradient
    all-reduced in the backward."""
    return _Copy.apply(x, _group(axis_name))


def reduce_from_tensor_model_parallel_region(x, axis_name=None):
    """Output of a row-parallel layer: all-reduce forward, identity
    backward."""
    return _Reduce.apply(x, _group(axis_name))


def scatter_to_tensor_model_parallel_region(x, axis_name=None):
    """This rank's block of the last dim."""
    return _Block.apply(x, _group(axis_name), -1)


def gather_from_tensor_model_parallel_region(x, axis_name=None):
    """The last dim all-gathered in rank order."""
    return _Gather.apply(x, _group(axis_name), -1, False)


def scatter_to_sequence_parallel_region(x, axis_name=None, dim=0):
    return _Block.apply(x, _group(axis_name), dim)


def gather_from_sequence_parallel_region(x, axis_name=None, dim=0,
                                         tensor_parallel_output_grad=True):
    """All-gather the sequence shards. ``tensor_parallel_output_grad``
    picks the backward by what consumes the gathered tensor: True for
    tensor-parallel computation (each rank's cotangent is a partial, so
    it reduce-scatters), False for the replicated stream (the LM-head
    input: the cotangent is already whole, so it takes this rank's
    block)."""
    return _Gather.apply(x, _group(axis_name), dim,
                         tensor_parallel_output_grad)


def reduce_scatter_to_sequence_parallel_region(x, axis_name=None, dim=0):
    return _ReduceScatter.apply(x, _group(axis_name), dim)
