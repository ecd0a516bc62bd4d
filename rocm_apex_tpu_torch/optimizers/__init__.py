"""Optimizers over mixed-precision training state."""

from rocm_apex_tpu_torch.optimizers.mixed import (
    MixedPrecisionAdam,
    MixedPrecisionLamb,
    MixedPrecisionState,
)

__all__ = ["MixedPrecisionAdam", "MixedPrecisionLamb", "MixedPrecisionState"]
