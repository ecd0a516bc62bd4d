"""Fused optimizers over params dicts (the JAX package's
``optimizers/__init__.py`` names: Adam, Adagrad, LAMB, NovoGrad, SGD,
the scaler-aware mixed-precision LAMB and the packed step), and the
mixed-precision training states' `MixedPrecisionAdam` / `Lamb`."""

from rocm_apex_tpu_torch.optimizers._common import FusedOptimizer
from rocm_apex_tpu_torch.optimizers.fused_adagrad import (
    FusedAdagrad,
    FusedAdagradState,
    fused_adagrad,
)
from rocm_apex_tpu_torch.optimizers.fused_adam import (
    FusedAdam,
    FusedAdamState,
    fused_adam,
)
from rocm_apex_tpu_torch.optimizers.fused_lamb import (
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)
from rocm_apex_tpu_torch.optimizers.fused_mixed_precision_lamb import (
    FusedMixedPrecisionLamb,
)
from rocm_apex_tpu_torch.optimizers.fused_novograd import (
    FusedNovoGrad,
    FusedNovoGradState,
    fused_novograd,
)
from rocm_apex_tpu_torch.optimizers.fused_sgd import (
    FusedSGD,
    FusedSGDState,
    fused_sgd,
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
    "fused_adam",
    "FusedAdagrad",
    "FusedAdagradState",
    "fused_adagrad",
    "FusedLAMB",
    "FusedLAMBState",
    "fused_lamb",
    "FusedMixedPrecisionLamb",
    "FusedNovoGrad",
    "FusedNovoGradState",
    "fused_novograd",
    "FusedSGD",
    "FusedSGDState",
    "fused_sgd",
    "FusedOptimizer",
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
