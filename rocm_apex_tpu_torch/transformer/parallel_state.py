"""The context axis's name and the process groups behind axis names.

The part of ``rocm_apex_tpu/transformer/parallel_state.py`` that context
parallelism needs: ``CONTEXT_AXIS``, and a registry that maps an axis
name to a `torch.distributed` process group, where the JAX package binds
the name to a mesh axis inside `shard_map`. The caller creates the groups
(`torch.distributed.init_process_group`, `new_group`) and registers
them; the collectives over an axis (`transformer.context_parallel`) look
their group up here by name.
"""

from typing import Dict, Optional, Union

import torch.distributed as dist

__all__ = [
    "CONTEXT_AXIS",
    "set_axis_group",
    "get_axis_group",
    "clear_axis_groups",
    "resolve_group",
    "axis_rank",
]

CONTEXT_AXIS = "context"

_GROUPS: Dict[str, "dist.ProcessGroup"] = {}


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


def resolve_group(group_or_axis: Union[str, "dist.ProcessGroup"]
                  ) -> "dist.ProcessGroup":
    """A process group, or the one bound to an axis name."""
    if isinstance(group_or_axis, str):
        return get_axis_group(group_or_axis)
    return group_or_axis


def axis_rank(group_or_axis: Union[str, "dist.ProcessGroup"]) -> int:
    """This process's index along the axis (its rank in the group)."""
    return dist.get_rank(resolve_group(group_or_axis))
