"""The axis names, the process groups behind them, and their exchanges.

The part of ``rocm_apex_tpu/transformer/parallel_state.py`` that context
parallelism, tensor- and data-parallel training, tensor-parallel serving
and the transformer GradScaler need: the ``CONTEXT_AXIS``,
``TENSOR_AXIS``, ``DATA_AXIS`` and ``PIPE_AXIS`` names, and a registry
that maps an axis name to a `torch.distributed` process group, where the
JAX package binds the name to a mesh axis inside `shard_map`. The caller
creates the groups (`torch.distributed.init_process_group`, `new_group`)
and registers them, or has `initialize_model_parallel` make and register
the tensor and data groups; the collectives over an axis look their
group up here by name.

`initialize_model_parallel(tp)` lays the default process group out as
JAX lays its mesh (JAX parallel_state.py:74-150): ``world = dp x tp``
ranks, the tensor axis innermost, so global rank ``d * tp + t`` is data
index d and tensor index t; each tensor group is ``tp`` consecutive
ranks, each data group the ranks ``tp`` apart. When the world is one
tensor group the tensor axis stays the default group. Pipeline
parallelism and virtual pipelining are ROADMAP Queue 1 item 10, part
10d's pipeline half, and raise. The getters read the groups: their
sizes, this process's rank in each, the axis names.

Every exchange of the port's parallel modules (`tensor_parallel.
mappings`, `ops.collective_matmul`, `context_parallel`, `parallel`, the
ZeRO optimizers) goes through `exchange`. Over a gloo group with tensors
on a card it copies them through host memory: gloo's all-gather,
reduce-scatter, all-to-all and point-to-point take CPU tensors only, so
every collective is staged the same way, its all-reduce too. `shift`,
`all_reduce`, `broadcast`, `all_gather` and `reduce_scatter` are the
plain collectives the modules build on.
"""

from typing import Callable, Dict, Optional, Union

import torch
import torch.distributed as dist

__all__ = [
    "CONTEXT_AXIS",
    "DATA_AXIS",
    "PIPE_AXIS",
    "TENSOR_AXIS",
    "set_axis_group",
    "get_axis_group",
    "clear_axis_groups",
    "resolve_group",
    "axis_rank",
    "initialize_model_parallel",
    "model_parallel_is_initialized",
    "destroy_model_parallel",
    "get_tensor_model_parallel_axis_name",
    "get_tensor_model_parallel_world_size",
    "get_tensor_model_parallel_rank",
    "get_data_parallel_axis_name",
    "get_data_parallel_world_size",
    "get_data_parallel_rank",
    "get_rank_info",
    "resolve_tensor_parallel_size",
    "exchange",
    "shift",
    "all_reduce",
    "broadcast",
    "all_gather",
    "reduce_scatter",
]

CONTEXT_AXIS = "context"
DATA_AXIS = "data"
PIPE_AXIS = "pipe"
TENSOR_AXIS = "tensor"

_GROUPS: Dict[str, "dist.ProcessGroup"] = {}
# set by initialize_model_parallel, None until then (and after destroy)
_TENSOR_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None
_DATA_PARALLEL_WORLD_SIZE: Optional[int] = None

GroupOrAxis = Union[str, "dist.ProcessGroup"]


def set_axis_group(axis: str,
                   group: Optional["dist.ProcessGroup"] = None) -> None:
    """Bind ``axis`` to ``group`` (None: the default group of
    `torch.distributed.init_process_group`)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group before binding an axis")
    _GROUPS[axis] = group if group is not None else dist.group.WORLD


def get_axis_group(axis: str) -> "dist.ProcessGroup":
    """The process group bound to ``axis``; raises if none is."""
    if axis not in _GROUPS:
        raise KeyError(f"no process group is bound to axis {axis!r} "
                       f"(set_axis_group)")
    return _GROUPS[axis]


def clear_axis_groups() -> None:
    """Forget every binding (tests, and a group's teardown)."""
    _GROUPS.clear()


def resolve_group(group_or_axis: GroupOrAxis) -> "dist.ProcessGroup":
    """A process group, or the one bound to an axis name."""
    if isinstance(group_or_axis, str):
        return get_axis_group(group_or_axis)
    return group_or_axis


def axis_rank(group_or_axis: GroupOrAxis) -> int:
    """This process's index along the axis (its rank in the group)."""
    return dist.get_rank(resolve_group(group_or_axis))



def initialize_model_parallel(
        tensor_model_parallel_size_: int = 1,
        pipeline_model_parallel_size_: int = 1,
        virtual_pipeline_model_parallel_size_: Optional[int] = None,
        pipeline_model_parallel_split_rank_: Optional[int] = None) -> None:
    """Lay the default process group out as ``dp x tp`` (JAX
    parallel_state.py:74-150 over a mesh, the tensor axis innermost: rank
    ``d * tp + t``) and bind ``TENSOR_AXIS`` and ``DATA_AXIS`` to this
    rank's groups. Every rank creates every group, in one order (tensor
    groups by d, then data groups by t), as `new_group` requires. A world
    that is one tensor group keeps the default group as its tensor axis
    (each data group one rank), and a world that is one data group keeps
    it as its data axis. Pipeline parallelism and virtual pipelining
    raise (ROADMAP Queue 1 item 10, part 10d, its pipeline half); the
    split rank, which only a pipeline reads, is accepted and unused."""
    global _TENSOR_MODEL_PARALLEL_WORLD_SIZE, _DATA_PARALLEL_WORLD_SIZE
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group before "
                           "initialize_model_parallel")
    tp, pp = tensor_model_parallel_size_, pipeline_model_parallel_size_
    world = dist.get_world_size()
    if world % (tp * pp):
        raise RuntimeError(
            f"world size ({world}) is not divisible by tensor parallel "
            f"size ({tp}) x pipeline parallel size ({pp})")
    del pipeline_model_parallel_split_rank_
    if pp != 1 or virtual_pipeline_model_parallel_size_ is not None:
        raise NotImplementedError(
            f"pipeline parallelism (pp {pp}, virtual "
            f"{virtual_pipeline_model_parallel_size_}) is not ported yet "
            f"(ROADMAP Queue 1 item 10, part 10d, its pipeline half)")
    dp, rank = world // tp, dist.get_rank()
    tensor_groups = ([dist.group.WORLD] if dp == 1 else
                     [dist.new_group([d * tp + t for t in range(tp)])
                      for d in range(dp)])
    data_groups = ([dist.group.WORLD] if tp == 1 else
                   [dist.new_group([d * tp + t for d in range(dp)])
                    for t in range(tp)])
    set_axis_group(TENSOR_AXIS, tensor_groups[rank // tp if dp > 1 else 0])
    set_axis_group(DATA_AXIS, data_groups[rank % tp])
    _TENSOR_MODEL_PARALLEL_WORLD_SIZE = tp
    _DATA_PARALLEL_WORLD_SIZE = dp


def model_parallel_is_initialized() -> bool:
    return _TENSOR_MODEL_PARALLEL_WORLD_SIZE is not None


def destroy_model_parallel() -> None:
    """Forget the tensor and data groups (the process group stays the
    caller's)."""
    global _TENSOR_MODEL_PARALLEL_WORLD_SIZE, _DATA_PARALLEL_WORLD_SIZE
    _TENSOR_MODEL_PARALLEL_WORLD_SIZE = None
    _DATA_PARALLEL_WORLD_SIZE = None
    _GROUPS.pop(TENSOR_AXIS, None)
    _GROUPS.pop(DATA_AXIS, None)


def _require_init() -> None:
    if _TENSOR_MODEL_PARALLEL_WORLD_SIZE is None:
        raise RuntimeError(
            "model parallel state is not initialized; call "
            "parallel_state.initialize_model_parallel(...) first")


def get_tensor_model_parallel_axis_name() -> str:
    return TENSOR_AXIS


def get_tensor_model_parallel_world_size() -> int:
    _require_init()
    return _TENSOR_MODEL_PARALLEL_WORLD_SIZE


def get_tensor_model_parallel_rank() -> int:
    """This process's rank in the tensor group."""
    _require_init()
    return axis_rank(TENSOR_AXIS)


def get_data_parallel_axis_name() -> str:
    return DATA_AXIS


def get_data_parallel_world_size() -> int:
    _require_init()
    return _DATA_PARALLEL_WORLD_SIZE


def get_data_parallel_rank() -> int:
    """This process's rank in the data group."""
    _require_init()
    return axis_rank(DATA_AXIS)


def get_rank_info() -> str:
    """The tp, pp and dp sizes and the process's global rank, for
    rank-aware logging (JAX parallel_state.py, reference
    parallel_state.py:169-186)."""
    if model_parallel_is_initialized():
        return (f"tp{_TENSOR_MODEL_PARALLEL_WORLD_SIZE}-pp1-"
                f"dp{_DATA_PARALLEL_WORLD_SIZE}-proc{dist.get_rank()}")
    return "(-, -, -)"


def resolve_tensor_parallel_size(explicit: Optional[int]) -> int:
    """A tensor-parallel size: ``explicit`` where given, else the tensor
    group's once initialized, else 1 (JAX gpt.py:176-181 `_resolve_tp`,
    layers.py's ``world_size=None``)."""
    if explicit is not None:
        return explicit
    return (_TENSOR_MODEL_PARALLEL_WORLD_SIZE
            if model_parallel_is_initialized() else 1)


def exchange(kind: str, fn: Callable, t: torch.Tensor, group
             ) -> torch.Tensor:
    """``fn(send, group)``, the collective named ``kind``, on ``t``'s
    values: ``send`` is t detached and contiguous (maybe t itself, so
    ``fn`` writes into a copy), on the host when t lies on a card and the
    group is gloo's, and the result comes back to ``t``'s device. Every
    exchange of the parallel modules is one call here (a sync audit wraps
    this function and counts the calls by ``kind``)."""
    host = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    send = t.detach().contiguous()
    out = fn(send.cpu() if host else send, group)
    return out.to(t.device) if host else out


def _shift(send, group, step):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """x of rank r - step, received while x goes to rank r + step."""
    return exchange("shift", lambda s, g: _shift(s, g, step), x, group)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(send, group, op="sum"):
    out = send.clone()  # send may be the caller's own tensor
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
    return out


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the elementwise max) of x over the group (a
    new tensor; every rank the same bits)."""
    return exchange("all_reduce", lambda s, g: _all_reduce(s, g, op), x,
                    group)


def _broadcast(send, group, src):
    out = send.clone()
    dist.broadcast(out, dist.get_global_rank(group, src), group=group)
    return out


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s x on every rank (a new tensor)."""
    return exchange("broadcast", lambda s, g: _broadcast(s, g, src), x,
                    group)


def _all_gather(send, group, dim):
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in rank order (JAX's tiled
    ``all_gather``)."""
    return exchange("all_gather", lambda s, g: _all_gather(s, g, dim), x,
                    group)


def _reduce_scatter(send, group, dim):
    # the sum on every rank, then this rank's block: gloo has no
    # reduce-scatter on every torch release, and every rank's sum has
    # the same bits
    total = _all_reduce(send, group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return total.chunk(n, dim)[r].contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of x over the group
    (JAX's tiled ``psum_scatter``); ``dim`` must divide by the group's
    size."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible "
                         f"by axis size {n}")
    return exchange("reduce_scatter",
                    lambda s, g: _reduce_scatter(s, g, dim), x, group)
