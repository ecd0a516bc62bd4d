"""Data-parallel gradient synchronization.

Port of ``rocm_apex_tpu/parallel/distributed.py`` (JAX :51-238), the
counterpart of the reference DDP's semantics (apex/parallel/
distributed.py:129-640): a gradient tree is summed over the data axis's
process group (`parallel_state`), with the reference's policy knobs:

* ``gradient_average``: divide by the group's size after the sum
  (reference distributed.py:443-455);
* ``gradient_predivide_factor``: scale by ``1/f`` before the sum and by
  ``f/world`` after (reference distributed.py:148-151, 454-455);
* ``allreduce_always_fp32``: sum in fp32, cast back to each leaf's dtype
  (reference distributed.py:146, 443-448);
* ``axis_index_groups``: sum within subsets of the axis (the reference's
  process-group subsets, JAX's replica groups);
* `broadcast_params`: the mean of each parameter over the axis in at
  least fp32, so drifted replicas agree bit for bit.

JAX runs one ``psum`` a leaf and leaves bucketing to XLA. Here every
floating leaf of one payload dtype rides ONE exchange: the leaves are
flattened into one buffer, scaled, summed over the group, scaled back
and split (the reference's dtype buckets, with no size cap); each
element's sum is the one a psum of its leaf gives. A tree of bf16 and
fp32 gradients takes two exchanges, one with ``allreduce_always_fp32``,
none over a group of one rank. Integer leaves pass through.

A subset sum (`group_psum`) is JAX's: an all-gather over the axis and a
static membership row, one exchange. A process group per subset would
need every rank of the default group to create every data group's
subsets in one order (`new_group` is collective over the world), which
a rank of a dp x tp layout cannot do from its own axis alone.

A tree is a dict of name -> tensor, a list or tuple of tensors, or one
tensor; None entries pass through.
"""

from typing import Any, Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = [
    "sync_gradients",
    "broadcast_params",
    "group_psum",
    "DistributedDataParallel",
    "Reducer",
]


def _flatten(tree):
    """``(leaves, rebuild)`` of a flat tree (see the module doc)."""
    if tree is None or torch.is_tensor(tree):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, Mapping):
        keys = list(tree)
        return [tree[k] for k in keys], lambda ls: dict(zip(keys, ls))
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda ls: type(tree)(ls)
    raise TypeError(f"a tree is a dict, list, tuple or tensor, got "
                    f"{type(tree).__name__}")


def _is_float(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


def _group_of(axis_name):
    return parallel_state.resolve_group(
        axis_name if axis_name is not None else parallel_state.DATA_AXIS)


def _membership(axis_index_groups, world: int) -> np.ndarray:
    """The (world, world) 0/1 mask of who sums with whom; the groups must
    partition the axis's ranks (JAX `group_psum`)."""
    mask = np.zeros((world, world), np.float32)
    seen = set()
    for grp in axis_index_groups:
        for r in grp:
            if r in seen:
                raise ValueError(f"rank {r} appears in two groups")
            seen.add(r)
            for s in grp:
                mask[r, s] = 1.0
    if seen != set(range(world)):
        raise ValueError(f"axis_index_groups must partition all {world} "
                         f"ranks, got {sorted(seen)}")
    return mask


def group_psum(x: torch.Tensor, axis_name,
               axis_index_groups: Sequence[Sequence[int]]) -> torch.Tensor:
    """The sum of ``x`` within this rank's subset of the axis (JAX
    distributed.py:55): the axis's all-gather, then this rank's row of
    the membership mask contracted with it. One exchange."""
    group = _group_of(axis_name)
    world = dist.get_world_size(group)
    mask = _membership(axis_index_groups, world)
    row = torch.from_numpy(mask[dist.get_rank(group)]).to(
        device=x.device, dtype=x.dtype)
    gathered = parallel_state.all_gather(x.unsqueeze(0), group, 0)
    return torch.tensordot(row, gathered, dims=1)


def axis_sum(x: torch.Tensor, axis_name,
             axis_index_groups: Optional[Sequence[Sequence[int]]] = None
             ) -> torch.Tensor:
    """``psum(x, axis_name)``, or `group_psum` within subsets; a group of
    one rank sums nothing and exchanges nothing."""
    if axis_index_groups is not None:
        return group_psum(x, axis_name, axis_index_groups)
    group = _group_of(axis_name)
    if dist.get_world_size(group) == 1:
        return x
    return parallel_state.all_reduce(x, group)


def _bucketed(leaves: List[Any], payload: Callable,
              reduce: Callable) -> List[Any]:
    """Each floating leaf through ``reduce`` on one flat buffer a payload
    dtype (``payload(leaf)``), in order of first appearance; the results
    cast back to each leaf's dtype, the other leaves as they were."""
    buckets = {}
    for i, leaf in enumerate(leaves):
        if _is_float(leaf):
            buckets.setdefault(payload(leaf), []).append(i)
    out = list(leaves)
    for dtype, idx in buckets.items():
        flat = torch.cat([leaves[i].detach().reshape(-1).to(dtype)
                          for i in idx])
        red = reduce(flat, dtype)
        at = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = red[at:at + n].view(leaves[i].shape).to(leaves[i].dtype)
            at += n
    return out


def sync_gradients(
    grads: Any,
    axis_name: Optional[str] = None,
    *,
    gradient_average: bool = True,
    allreduce_always_fp32: bool = False,
    gradient_predivide_factor: float = 1.0,
    axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
) -> Any:
    """The gradient tree summed over the data axis (``axis_name``,
    default `parallel_state.DATA_AXIS`): optional fp32 upcast, predivide,
    sum, post-divide by ``world / predivide``, cast back (JAX
    distributed.py:85, reference `allreduce_bucket`). Every rank of the
    axis calls it with a tree of the same names, shapes and dtypes."""
    group = _group_of(axis_name)
    if axis_index_groups is not None:
        # averaging is over the subset (the reference's per-group world)
        sizes = {len(g) for g in axis_index_groups}
        if len(sizes) != 1:
            raise ValueError("axis_index_groups must have uniform sizes")
        world = sizes.pop()
    else:
        world = dist.get_world_size(group)
    pre = 1.0 / gradient_predivide_factor
    post = gradient_predivide_factor / world if gradient_average else 1.0

    def reduce(flat, dtype):
        # the factors in the payload dtype, as JAX multiplies a weak
        # scalar; filled on the device (no host copy waits for the stream)
        if gradient_predivide_factor != 1.0:
            flat = flat * torch.full((), pre, dtype=dtype, device=flat.device)
        flat = axis_sum(flat, group, axis_index_groups)
        if post != 1.0:
            flat = flat * torch.full((), post, dtype=dtype,
                                     device=flat.device)
        return flat

    leaves, rebuild = _flatten(grads)
    return rebuild(_bucketed(
        leaves, (lambda g: torch.float32) if allreduce_always_fp32
        else (lambda g: g.dtype), reduce))


def broadcast_params(params: Any, axis_name: Optional[str] = None) -> Any:
    """Each parameter's mean over the axis, accumulated in at least fp32
    and cast back (JAX distributed.py:136, the reference's rank-0
    broadcast at wrap time, distributed.py:254-259): an exact no-op on
    agreeing replicas, and agreement restored on drifted ones."""
    group = _group_of(axis_name)
    world = dist.get_world_size(group)

    def reduce(flat, dtype):
        return axis_sum(flat, group) / world

    leaves, rebuild = _flatten(params)
    return rebuild(_bucketed(
        leaves, lambda p: (p.dtype if torch.finfo(p.dtype).bits >= 32
                           else torch.float32), reduce))


class DistributedDataParallel:
    """The data-parallel sync policy, applied to gradient trees (JAX
    distributed.py:157, the reference module wrapper's semantics,
    distributed.py:129-254). The train step computes the gradients and
    calls `sync_gradients` (``ddp(grads)``)::

        ddp = DistributedDataParallel(gradient_predivide_factor=2.0)
        grads = ddp.sync_gradients(grads)

    ``message_size``, ``delay_allreduce`` and ``num_allreduce_streams``
    are accepted and ignored, as in JAX: the sync is one exchange a
    dtype bucket after the backward."""

    def __init__(
        self,
        axis_name: Optional[str] = None,
        *,
        gradient_average: bool = True,
        allreduce_always_fp32: bool = False,
        gradient_predivide_factor: float = 1.0,
        axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
        message_size: int = 10_000_000,
        delay_allreduce: bool = False,
        num_allreduce_streams: int = 1,
    ):
        self.axis_name = axis_name or parallel_state.DATA_AXIS
        self.gradient_average = gradient_average
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_predivide_factor = gradient_predivide_factor
        self.axis_index_groups = axis_index_groups
        del message_size, delay_allreduce, num_allreduce_streams

    def sync_gradients(self, grads: Any) -> Any:
        return sync_gradients(
            grads, self.axis_name, gradient_average=self.gradient_average,
            allreduce_always_fp32=self.allreduce_always_fp32,
            gradient_predivide_factor=self.gradient_predivide_factor,
            axis_index_groups=self.axis_index_groups)

    def __call__(self, grads: Any) -> Any:
        return self.sync_gradients(grads)

    def broadcast_params(self, params: Any) -> Any:
        return broadcast_params(params, self.axis_name)


class Reducer:
    """The reference's manual allreduce helper (distributed.py:89-127):
    `sync_gradients` with averaging, on any tree (JAX
    distributed.py:213)."""

    def __init__(self, axis_name: Optional[str] = None,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None):
        self.axis_name = axis_name or parallel_state.DATA_AXIS
        self.axis_index_groups = axis_index_groups

    def reduce(self, tree: Any) -> Any:
        return sync_gradients(tree, self.axis_name, gradient_average=True,
                              axis_index_groups=self.axis_index_groups)

    __call__ = reduce
