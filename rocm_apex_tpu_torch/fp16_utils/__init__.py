"""Legacy manual mixed-precision helpers (fp16_utils).

Port of ``rocm_apex_tpu/fp16_utils`` (the reference's apex/fp16_utils:
fp16util.py, fp16_optimizer.py, loss_scaler.py), which the reference
deprecates in favour of amp: thin functional shims over the machinery
amp uses, on params dicts (name -> tensor).
"""

from rocm_apex_tpu_torch.fp16_utils.fp16_optimizer import (  # noqa: F401
    FP16_Optimizer,
    FP16OptimizerState,
)
from rocm_apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    BN_convert_float,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
)
from rocm_apex_tpu_torch.fp16_utils.loss_scaler import (  # noqa: F401
    DynamicLossScaler,
    LossScaler,
)

__all__ = [
    "network_to_half",
    "convert_network",
    "BN_convert_float",
    "prep_param_lists",
    "master_params_to_model_params",
    "model_grads_to_master_grads",
    "FP16_Optimizer",
    "FP16OptimizerState",
    "LossScaler",
    "DynamicLossScaler",
]
