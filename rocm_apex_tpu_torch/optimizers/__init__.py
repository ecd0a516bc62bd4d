"""Optimizers over mixed-precision training state."""

from rocm_apex_tpu_torch.optimizers.mixed import (
    MixedPrecisionAdam,
    MixedPrecisionState,
)

__all__ = ["MixedPrecisionAdam", "MixedPrecisionState"]
