"""Shared plumbing of the optimizers: the subset of
``rocm_apex_tpu/optimizers/_common.py`` that `MixedPrecisionAdam` reads."""

from typing import Callable, Dict, Mapping, Optional, Union

import torch

__all__ = ["ScalarOrSchedule", "resolve_lr", "wd_tree"]

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
