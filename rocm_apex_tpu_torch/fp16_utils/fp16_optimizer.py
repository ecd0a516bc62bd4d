"""FP16_Optimizer: the legacy master-weight optimizer wrapper.

Port of ``rocm_apex_tpu/fp16_utils/fp16_optimizer.py`` (the reference's
fp16_optimizer.py:13-554): any optimizer (a gradient transformation, or
a class with ``init`` / ``update``) over fp32 masters of a low-precision
params dict, with static or dynamic loss scaling and the overflowed step
skipped on the device:

    opt = FP16_Optimizer(FusedAdam(1e-3), dynamic_loss_scale=True)
    state = opt.init(model_params_fp16)
    scaled = opt.scale_loss(loss, state)   # differentiate this
    state = opt.step(state, grads_fp16)    # params and moments frozen on
    model_params = state.model_params      # an overflow, the scale backs off
"""

from typing import Any, NamedTuple, Optional

import torch

from rocm_apex_tpu_torch.amp.handle import skip_step
from rocm_apex_tpu_torch.amp.scaler import LossScaler as _Scaler
from rocm_apex_tpu_torch.amp.scaler import ScalerState
from rocm_apex_tpu_torch.fp16_utils.loss_scaler import LossScaler
from rocm_apex_tpu_torch.optimizers._common import apply_updates

__all__ = ["FP16_Optimizer", "FP16OptimizerState"]


class FP16OptimizerState(NamedTuple):
    model_params: Any  # low-precision params, by name
    master_params: Any  # fp32, by name
    inner_state: Any
    scaler_state: ScalerState


class FP16_Optimizer:
    """The reference constructor (fp16_optimizer.py:13-90): a static loss
    scale, or ``dynamic_loss_scale`` with ``dynamic_loss_args``
    (init_scale, default 2^32, clamped to the scaler's 2^24;
    scale_factor 2; scale_window 1000)."""

    def __init__(self, tx, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        self.tx = tx
        if dynamic_loss_scale:
            args = dynamic_loss_args or {}
            self.scaler = _Scaler(
                loss_scale="dynamic",
                init_scale=args.get("init_scale", 2.0**32),
                scale_factor=args.get("scale_factor", 2.0),
                scale_window=args.get("scale_window", 1000))
        else:
            self.scaler = _Scaler(loss_scale=float(static_loss_scale))
        self.verbose = verbose

    def init(self, model_params) -> FP16OptimizerState:
        masters = {k: v.detach().to(torch.float32, copy=True)
                   for k, v in model_params.items()}
        device = next(iter(masters.values())).device
        return FP16OptimizerState(
            model_params=dict(model_params), master_params=masters,
            inner_state=self.tx.init(masters),
            scaler_state=self.scaler.init(device))

    def scale_loss(self, loss, state: FP16OptimizerState):
        """The scaled loss to differentiate (the reference's backward)."""
        return self.scaler.scale(state.scaler_state, loss)

    def step(self, state: FP16OptimizerState, grads) -> FP16OptimizerState:
        """Unscale and probe the gradients, update the masters, and cast
        them down to the model's dtypes; an overflow skips the update
        (masters and the inner state stay as they were) and backs the
        scale off."""
        grads, found_inf = self.scaler.unscale(state.scaler_state, grads)
        new_scaler, skip = self.scaler.update(state.scaler_state, found_inf)
        safe = {k: torch.where(torch.isfinite(g), g, 0.0)
                for k, g in grads.items()}
        updates, new_inner = self.tx.update(safe, state.inner_state,
                                            state.master_params)
        new_masters = apply_updates(state.master_params, updates)
        new_masters = skip_step(skip, new_masters, state.master_params)
        new_inner = skip_step(skip, new_inner, state.inner_state)
        new_model = {k: new_masters[k].to(v.dtype)
                     for k, v in state.model_params.items()}
        return FP16OptimizerState(
            model_params=new_model, master_params=new_masters,
            inner_state=new_inner, scaler_state=new_scaler)

    has_overflow = staticmethod(LossScaler.has_overflow)
