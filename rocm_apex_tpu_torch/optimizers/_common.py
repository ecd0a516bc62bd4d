"""Shared plumbing of the optimizers: the subset of
``rocm_apex_tpu/optimizers/_common.py`` that the mixed-precision
optimizers read, and the gradient-norm pass of `MixedPrecisionLamb`."""

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

__all__ = ["ScalarOrSchedule", "foreach_norm_f32", "resolve_lr", "wd_tree"]

ScalarOrSchedule = Union[float, torch.Tensor, Callable]


def resolve_lr(lr: ScalarOrSchedule, count):
    """A constant, or a schedule called with the step count."""
    return lr(count) if callable(lr) else lr


def wd_tree(params: Mapping[str, torch.Tensor], weight_decay: float,
            mask: Optional[Mapping[str, bool]] = None) -> Dict[str, float]:
    """Per-parameter weight decay (True in ``mask`` = decayed): the
    stand-in for torch param groups. ``mask`` names every parameter."""
    if mask is None:
        return {k: weight_decay for k in params}
    if set(mask) != set(params):
        raise ValueError(
            f"weight_decay mask names {sorted(set(mask) ^ set(params))} "
            f"differently from the params"
        )
    return {k: weight_decay if mask[k] else 0.0 for k in params}


def foreach_norm_f32(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's L2 norm as an fp32 scalar, accumulated in fp32
    whatever the storage dtype (a bf16 gradient's norm must not round to
    bf16: it scales the clip of every leaf)."""
    if all(t.dtype == torch.float32 for t in tensors):
        return list(torch._foreach_norm(list(tensors)))
    return list(torch._foreach_norm(list(tensors), 2, dtype=torch.float32))
