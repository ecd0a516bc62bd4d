"""Mixed-precision loss scaling."""

from rocm_apex_tpu_torch.amp.scaler import LossScaler, ScalerState, all_finite

__all__ = ["LossScaler", "ScalerState", "all_finite"]
