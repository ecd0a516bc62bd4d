"""Optimizers over mixed-precision training state, the packed-buffer
optimizer step, and the tree-form `FusedAdam`."""

from rocm_apex_tpu_torch.optimizers._common import FusedOptimizer
from rocm_apex_tpu_torch.optimizers.fused_adam import (
    FusedAdam,
    FusedAdamState,
    fused_adam,
)
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
    "FusedAdam",
    "FusedAdamState",
    "FusedOptimizer",
    "MixedPrecisionAdam",
    "MixedPrecisionLamb",
    "MixedPrecisionState",
    "PackedAdamState",
    "PackedLAMBState",
    "PackedOptimizerStep",
    "PackedStepState",
    "adam_phase",
    "fused_adam",
    "lamb_phase",
    "packed_adam",
    "packed_lamb",
]
