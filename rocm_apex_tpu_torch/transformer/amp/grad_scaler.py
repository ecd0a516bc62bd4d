"""Loss scaler whose overflow flag is agreed across model-parallel ranks.

Port of ``rocm_apex_tpu/transformer/amp/grad_scaler.py`` (the reference's
transformer GradScaler, apex/transformer/amp/grad_scaler.py:8-106, which
all-reduces ``found_inf`` with MAX over the model-parallel group). If any
tensor- or pipeline-parallel rank overflows, every rank must skip the
same step and back off the same scale, or the ranks' replicas diverge.

`sync_found_inf` MAX-reduces the flag over the process group bound to
each of the ``"tensor"`` and ``"pipe"`` axes in `parallel_state`'s
registry; an axis with no group bound is skipped, as the JAX function
skips an axis the mesh does not bind. The flag stays a device tensor.
"""

from typing import Sequence

import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = ["GradScaler", "sync_found_inf"]

_MODEL_AXES = (parallel_state.TENSOR_AXIS, parallel_state.PIPE_AXIS)


def sync_found_inf(found_inf, axis_names: Sequence[str] = _MODEL_AXES
                   ) -> torch.Tensor:
    """The overflow flag, true on every rank of the bound axes' groups if
    it is true on any (a bool tensor on the flag's device)."""
    out = torch.as_tensor(found_inf)
    for ax in axis_names:
        try:
            group = parallel_state.get_axis_group(ax)
        except KeyError:
            continue
        flag = out.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        out = flag > 0
    return out


class GradScaler(LossScaler):
    """A dynamic `LossScaler` whose update first syncs ``found_inf`` over
    the model axes. The constructor takes the reference's vocabulary
    (init_scale, growth_factor, backoff_factor, growth_interval) and maps
    it onto the base scaler's one symmetric factor, so
    ``backoff_factor * growth_factor`` must be 1."""

    def __init__(
        self,
        init_scale: float = 2.0**16,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        growth_interval: int = 2000,
        enabled: bool = True,
        axis_names: Sequence[str] = _MODEL_AXES,
    ):
        if growth_factor <= 1.0:
            raise ValueError("growth_factor must be > 1.0")
        if not 0.0 < backoff_factor < 1.0:
            raise ValueError("backoff_factor must be in (0, 1)")
        if abs(backoff_factor * growth_factor - 1.0) > 1e-6:
            raise ValueError(
                "GradScaler requires backoff_factor == 1/growth_factor "
                f"(got {backoff_factor} vs 1/{growth_factor})")
        super().__init__(
            loss_scale="dynamic" if enabled else 1.0, init_scale=init_scale,
            scale_factor=growth_factor, scale_window=growth_interval)
        self.axis_names = tuple(axis_names)

    def update(self, state: ScalerState, found_inf):
        return super().update(state,
                              sync_found_inf(found_inf, self.axis_names))
