"""Mixed precision: the opt-level policies, the function-casting
decorators of O1/O4 (``amp/amp.py``, the cast lists of ``amp/lists/``),
the master-weight optimizer wrapper, the loss-scaling flow and the loss
scaler."""

from rocm_apex_tpu_torch.amp.amp import (
    bfloat16_function,
    current_policy,
    disable_casts,
    float_function,
    half_function,
    init,
    policy_function,
    promote_function,
    register_bfloat16_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
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
    "bfloat16_function",
    "build_policy",
    "current_policy",
    "disable_casts",
    "float_function",
    "half_function",
    "init",
    "initialize",
    "load_state_dict",
    "master_params",
    "opt_levels",
    "policy_function",
    "process_optimizer",
    "promote_function",
    "register_bfloat16_function",
    "register_float_function",
    "register_half_function",
    "register_promote_function",
    "scale_loss",
    "skip_step",
    "state_dict",
    "unscale_grads",
    "update_scale",
    "with_master_weights",
]
