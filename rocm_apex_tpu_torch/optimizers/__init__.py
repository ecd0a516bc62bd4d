"""Optimizers over mixed-precision training state, and the packed-buffer
optimizer step."""

from rocm_apex_tpu_torch.optimizers.mixed import (
    MixedPrecisionAdam,
    MixedPrecisionLamb,
    MixedPrecisionState,
)
from rocm_apex_tpu_torch.optimizers.packed import (
    PackedAdamState,
    PackedLAMBState,
    PackedOptimizerStep,
    PackedStepState,
    adam_phase,
    lamb_phase,
    packed_adam,
    packed_lamb,
)

__all__ = [
    "MixedPrecisionAdam",
    "MixedPrecisionLamb",
    "MixedPrecisionState",
    "PackedAdamState",
    "PackedLAMBState",
    "PackedOptimizerStep",
    "PackedStepState",
    "adam_phase",
    "lamb_phase",
    "packed_adam",
    "packed_lamb",
]
