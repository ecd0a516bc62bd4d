"""Mixed precision: the opt-level policies, the master-weight optimizer
wrapper, the loss-scaling flow and the loss scaler. The function-casting
levels (O1, O4) wait for ``amp/amp.py`` and ``amp/lists/``."""

from rocm_apex_tpu_torch.amp._process_optimizer import (
    MasterWeightsState,
    process_optimizer,
    with_master_weights,
)
from rocm_apex_tpu_torch.amp.frontend import (
    AmpError,
    Properties,
    build_policy,
    initialize,
    load_state_dict,
    opt_levels,
    state_dict,
)
from rocm_apex_tpu_torch.amp.handle import (
    AmpState,
    master_params,
    scale_loss,
    skip_step,
    unscale_grads,
    update_scale,
)
from rocm_apex_tpu_torch.amp.scaler import LossScaler, ScalerState, all_finite

__all__ = [
    "AmpError",
    "AmpState",
    "LossScaler",
    "MasterWeightsState",
    "Properties",
    "ScalerState",
    "all_finite",
    "build_policy",
    "initialize",
    "load_state_dict",
    "master_params",
    "opt_levels",
    "process_optimizer",
    "scale_loss",
    "skip_step",
    "state_dict",
    "unscale_grads",
    "update_scale",
    "with_master_weights",
]
