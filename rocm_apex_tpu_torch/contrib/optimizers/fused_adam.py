"""Deprecated contrib FusedAdam, with the scale-aware step.

Port of ``rocm_apex_tpu/contrib/optimizers/fused_adam.py``: the older
fused Adam of apex/contrib/optimizers/fused_adam.py, whose step takes the
gradients and a loss scale explicitly (for use with FP16_Optimizer). A
facade over `optimizers.fused_adam`; constructing it warns with a
`DeprecationWarning`, as the reference does.
"""

import warnings
from typing import Any, Optional, Tuple

from rocm_apex_tpu_torch.optimizers import _common as c
from rocm_apex_tpu_torch.optimizers.fused_adam import fused_adam

__all__ = ["FusedAdam"]


class FusedAdam(c.FusedOptimizer):
    """The reference contrib constructor; ``step_with_scale`` divides the
    gradients by ``scale`` inside the update (contrib fused_adam.py:64)."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        eps_inside_sqrt: bool = False,
        weight_decay: float = 0.0,
        max_grad_norm: float = 0.0,
        amsgrad: bool = False,
        use_mt: bool = False,
        amp_scale_adjustment: float = 1.0,
    ):
        warnings.warn(
            "contrib.optimizers.FusedAdam is deprecated: use "
            "rocm_apex_tpu_torch.optimizers.FusedAdam (the reference "
            "deprecates it the same way)", DeprecationWarning)
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        if eps_inside_sqrt:
            raise NotImplementedError("eps_inside_sqrt is not supported")
        del use_mt, amp_scale_adjustment, max_grad_norm
        self._kw = dict(bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        self._lr = lr
        super().__init__(fused_adam(lr, **self._kw))

    def step_with_scale(self, params, grads, state, scale: float = 1.0,
                        skip: Optional[Any] = None):
        """The deprecated explicit-scale step: ``(params, state)`` with the
        gradients divided by ``scale`` inside the update; with ``skip``
        (a device bool) both come back as they were."""
        tx = fused_adam(self._lr, grad_scale=1.0 / scale, **self._kw)
        return c.FusedOptimizer(tx).step(params, grads, state, skip=skip)
