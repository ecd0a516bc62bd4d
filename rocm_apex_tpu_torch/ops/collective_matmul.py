"""The collective matmuls at the sequence-parallel edges, as rings.

Port of ``rocm_apex_tpu/ops/collective_matmul.py`` (the JAX module has no
Pallas kernel: its rings are ``ppermute`` hops beside ``jnp`` dots, so the
port's are `parallel_state.shift` hops beside ``torch.matmul``):

* `all_gather_matmul(x, w, axis)`: ``all_gather(x, rows) @ w`` for the
  local rows shard ``x`` (..., rows_local, k). At hop i the resident
  shard, rank ``idx + i``'s, multiplies into its output slot, piece by
  piece, each piece shifted onward (to rank - 1) for hop i + 1.
* `matmul_reduce_scatter(x, w, axis)`: ``psum_scatter(x @ w, rows)`` for
  full rows ``x`` (..., rows, k_local). A rotating fp32 accumulator per
  piece picks up this rank's partial product of one row block a hop and
  lands on the block's owner after the last hop (shifted to rank + 1).

The rows axis is -2, the contraction the last axis against ``w``'s
first; ``chunk`` rows a piece (None: one piece a shard), and a chunk
that does not tile the shard falls back to the plain collective and one
matmul, as JAX's `_ring_chunks`. An axis with no group bound, or a group
of one, is the plain matmul. The gather ring's partial products are
``torch.matmul`` in the inputs' dtype (JAX's fp32 product cast once to
it); the reduce-scatter ring's are fp32 products of the inputs' values,
summed in fp32 and cast once at the end, as JAX's.

Each is a `torch.autograd.Function` whose backward is JAX's
``custom_vjp`` rule (``_ag_mm_bwd``, ``_mm_rs_bwd``), the transposed ring
of the same chunk form: dx of the gather-matmul is the reduce-scatter
ring with ``wᵀ`` and dx of the reduce-scatter the gather ring with
``wᵀ``; dW re-rotates the saved shard (``_ring_dw_from_gather``) or the
cotangent block (``_ring_dw_from_scatter``) against the matching row
slice of the other operand, in fp32, cast once to w's dtype. A chunk
that does not tile takes the plain transposed collectives.

``comm_dtype="int8"`` (JAX :112-137, 291-330) quantizes the ring hops'
payloads (`ops.quantized_collectives`): a gather ring quantizes each
rotating piece once, the local one included, and every hop's piece
lands dequantized for its product, so the int8 gather-matmul is
``dequant(int8(x)) @ w`` slot for slot; the reduce-scatter ring
quantizes its rotating fp32 accumulator again at each hop and adds the
local partial product in fp32. The backward rings run at the same comm
dtype (the dW rings rotate quantized pieces too). A hop's int8 body and
fp32 scale column travel as one staged exchange (`shift_pair`), where
JAX sends two ``ppermute``s: the same bits, one exchange a hop as in
fp32. The fallbacks (no group, a group of one, a chunk that does not
tile) stay full precision, as JAX's.
"""

from typing import Optional

import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.ops.linear_xentropy import _mm_f32
from rocm_apex_tpu_torch.ops.quantized_collectives import (
    bound_group,
    check_comm_dtype,
    gather_ring,
    ring_chunks,
    scatter_ring,
)
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["all_gather_matmul", "matmul_reduce_scatter",
           "check_comm_dtype"]


def _ring_ag_mm(x, w, group, m, comm_dtype="fp32"):
    rows = x.shape[-2]
    chunk = rows // m
    n = dist.get_world_size(group)
    out = x.new_empty(x.shape[:-2] + (n * rows, w.shape[-1]))
    for at, piece in gather_ring(x, group, m, -2, comm_dtype, x.dtype):
        out[..., at:at + chunk, :] = torch.matmul(piece, w)
    return out


def _ring_mm_rs(x, w, group, m, comm_dtype="fp32"):
    wf = w.float()
    rows = x.shape[-2] // dist.get_world_size(group)
    return scatter_ring(
        lambda at, chunk: torch.matmul(x[..., at:at + chunk, :].float(), wf),
        rows, m, -2, group, comm_dtype).to(x.dtype)


def _plain_ag_mm(x, w, group, m):
    return torch.matmul(parallel_state.all_gather(x, group, x.dim() - 2), w)


def _plain_mm_rs(x, w, group, m):
    y = torch.matmul(x.float(), w.float())
    return parallel_state.reduce_scatter(y, group, y.dim() - 2).to(x.dtype)


def _dw(x, dy):
    """``einsum("...rk,...rn->kn", x, dy)`` with an fp32 result."""
    return _mm_f32(x.reshape(-1, x.shape[-1]).t(),
                   dy.reshape(-1, dy.shape[-1]))


def _ring_dw(rot, fixed, group, m, rot_is_x, comm_dtype="fp32"):
    """dW without the gather: this rank's shard ``rot`` re-rotates (to
    rank - 1 each hop, as the gather ring, quantized once under int8)
    and each hop contracts against the matching row slice of ``fixed``
    (full rows): JAX's ``_ring_dw_from_gather`` (rot x, fixed dy) and
    ``_ring_dw_from_scatter`` (rot dy, fixed x)."""
    chunk = rot.shape[-2] // m
    dw = None
    for at, piece in gather_ring(rot, group, m, -2, comm_dtype, rot.dtype):
        other = fixed[..., at:at + chunk, :]
        part = _dw(piece, other) if rot_is_x else _dw(other, piece)
        dw = part if dw is None else dw + part
    return dw


class _AgMm(torch.autograd.Function):
    """`all_gather_matmul` on a bound group: the ring (``m`` pieces a
    shard) or, with ``m`` None, the plain gather and one matmul."""

    @staticmethod
    def forward(ctx, x, w, group, m, comm_dtype):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.m, ctx.comm_dtype = group, m, comm_dtype
        if m is None:
            return _plain_ag_mm(x, w, group, m)
        return _ring_ag_mm(x, w, group, m, comm_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        group, m = ctx.group, ctx.m
        dy = dy.contiguous()
        wt = w.t()
        if m is None:
            # the plain transposed collectives, no ring
            dx = parallel_state.reduce_scatter(
                torch.matmul(dy.float(), wt.float()), group,
                dy.dim() - 2).to(x.dtype)
            xg = parallel_state.all_gather(x, group, x.dim() - 2)
            dw = _dw(xg, dy)
        else:
            # the transposed gather IS a matmul-reduce-scatter with wᵀ,
            # at the same comm dtype
            dx = _ring_mm_rs(dy, wt, group, m, ctx.comm_dtype).to(x.dtype)
            dw = _ring_dw(x, dy, group, m, True, ctx.comm_dtype)
        return dx, dw.to(w.dtype), None, None, None


class _MmRs(torch.autograd.Function):
    """`matmul_reduce_scatter` on a bound group: the ring or, with ``m``
    None, one matmul and the plain reduce-scatter."""

    @staticmethod
    def forward(ctx, x, w, group, m, comm_dtype):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.m, ctx.comm_dtype = group, m, comm_dtype
        if m is None:
            return _plain_mm_rs(x, w, group, m)
        return _ring_mm_rs(x, w, group, m, comm_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        group, m = ctx.group, ctx.m
        dy = dy.contiguous()
        wt = w.t()
        if m is None:
            dyg = parallel_state.all_gather(dy, group, dy.dim() - 2)
            dx = torch.matmul(dyg, wt).to(x.dtype)
            dw = _dw(x, dyg)
        else:
            # the transposed scatter IS an all-gather-matmul with wᵀ,
            # at the same comm dtype
            dx = _ring_ag_mm(dy, wt, group, m, ctx.comm_dtype).to(x.dtype)
            dw = _ring_dw(dy, x, group, m, False, ctx.comm_dtype)
        return dx, dw.to(w.dtype), None, None, None


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, axis_name,
                      chunk: Optional[int] = None,
                      comm_dtype: str = "fp32") -> torch.Tensor:
    """``all_gather(x, -2) @ w``: x the local rows shard (..., rows, k), w
    this rank's (k, n) column shard; returns (..., size * rows, n) in x's
    dtype. The gathered x never exists whole on the ring path."""
    check_comm_dtype(comm_dtype)
    group = bound_group(axis_name)
    if group is None:
        return torch.matmul(x, w)
    return _AgMm.apply(x, w, group, ring_chunks(x.shape[-2], chunk),
                       comm_dtype)


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axis_name,
                          chunk: Optional[int] = None,
                          comm_dtype: str = "fp32") -> torch.Tensor:
    """``psum_scatter(x @ w, -2)``: x full rows (..., rows, k_local), w
    this rank's (k_local, n) row shard; returns this rank's block of
    rows / size rows, summed over the group, in x's dtype. The full
    pre-reduce product never exists on the ring path."""
    check_comm_dtype(comm_dtype)
    group = bound_group(axis_name)
    if group is None:
        return torch.matmul(x, w)
    n = dist.get_world_size(group)
    if x.shape[-2] % n:
        raise ValueError(f"rows {x.shape[-2]} not divisible by axis size {n}")
    return _MmRs.apply(x, w, group, ring_chunks(x.shape[-2] // n, chunk),
                       comm_dtype)
