"""LAMB over mixed fp32/bf16/fp16 params with the loss scaler in its step.

Port of ``rocm_apex_tpu/optimizers/fused_mixed_precision_lamb.py``: the
tree `fused_lamb` on params of any floating dtypes (fp32 moments, each
param updated in fp32 and stored back in its own dtype), with the
scaler's ``inv_scale`` fused into the update as ``grad_scale`` and its
``found_inf`` a device bool that makes the whole step a no-op: params,
moments and the step count stay as they were (the reference's
``_step_supports_amp_scaling`` contract, fused_mixed_precision_lamb.py:
140-256, advances ``step`` only when ``found_inf == 0``).
"""

from typing import Any, Optional, Tuple

import torch

from rocm_apex_tpu_torch.optimizers import _common as c
from rocm_apex_tpu_torch.optimizers.fused_lamb import (FusedLAMBState,
                                                       fused_lamb)

__all__ = ["FusedMixedPrecisionLamb"]


class FusedMixedPrecisionLamb:
    """The reference constructor's shape (:8-74); ``amsgrad`` refused."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        amsgrad: bool = False,
        adam_w_mode: bool = True,
        grad_averaging: bool = True,
        max_grad_norm: float = 1.0,
        use_nvlamb: bool = False,
        weight_decay_mask: Optional[Any] = None,
    ):
        if amsgrad:
            raise RuntimeError(
                "FusedMixedPrecisionLamb does not support the AMSGrad "
                "variant.")
        self._kw = dict(
            bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            adam_w_mode=adam_w_mode, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, weight_decay_mask=weight_decay_mask)
        self.lr = lr

    def init(self, params) -> FusedLAMBState:
        return fused_lamb(self.lr, **self._kw).init(params)

    def step(self, params, grads, state: FusedLAMBState, *, inv_scale=None,
             found_inf=None):
        """One step on gradients that may still carry the loss scale:
        ``(params, state)``. ``inv_scale`` (1 / loss scale) multiplies the
        gradients inside the update; with ``found_inf`` true the params
        and the whole state come back as they were."""
        gs = 1.0 if inv_scale is None else inv_scale
        opt = c.FusedOptimizer(fused_lamb(self.lr, grad_scale=gs, **self._kw))
        skip = (None if found_inf is None
                else torch.as_tensor(found_inf, device=state.count.device))
        return opt.step(params, grads, state, skip=skip)
