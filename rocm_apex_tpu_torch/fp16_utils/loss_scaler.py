"""Legacy static and dynamic loss scalers.

Port of ``rocm_apex_tpu/fp16_utils/loss_scaler.py`` (the reference's
loss_scaler.py: `LossScaler:10`, `DynamicLossScaler:47`): the amp
scaler under the legacy constructor names. The dynamic scaler's
``init_scale`` of 2^32 is clamped to the base scaler's ``max_loss_scale``
(2^24), as in the JAX package.
"""

import torch

from rocm_apex_tpu_torch.amp._tree import tree_leaves
from rocm_apex_tpu_torch.amp.scaler import LossScaler as _AmpScaler
from rocm_apex_tpu_torch.amp.scaler import ScalerState, all_finite

__all__ = ["LossScaler", "DynamicLossScaler"]


class LossScaler(_AmpScaler):
    """Static scaler (loss_scaler.py:10-44)."""

    def __init__(self, scale: float = 1.0):
        super().__init__(loss_scale=float(scale))

    @staticmethod
    def has_overflow(grads) -> torch.Tensor:
        """A device bool: an inf or nan in any gradient of the tree."""
        return torch.logical_not(all_finite(tree_leaves(grads)))

    def update_scale_legacy(self, state: ScalerState, overflow):
        state, _ = self.update(state, overflow)
        return state


class DynamicLossScaler(_AmpScaler):
    """Dynamic scaler (loss_scaler.py:47-119)."""

    def __init__(self, init_scale: float = 2.0**32, scale_factor: float = 2.0,
                 scale_window: int = 1000):
        super().__init__(loss_scale="dynamic", init_scale=init_scale,
                         scale_factor=scale_factor, scale_window=scale_window)

    has_overflow = staticmethod(LossScaler.has_overflow)
