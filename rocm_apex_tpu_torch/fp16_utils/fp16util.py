"""Manual precision conversion of a params dict.

Port of ``rocm_apex_tpu/fp16_utils/fp16util.py`` (the reference's
fp16util.py: `network_to_half:35`, `convert_network:60`,
`BN_convert_float:46`, `prep_param_lists:90`, the master and model
copies :136-175). The batch-norm exemption is amp's name rule
(`amp._tree.is_batchnorm_path`).
"""

from typing import Dict, Mapping, Tuple

import torch

from rocm_apex_tpu_torch.amp._tree import is_batchnorm_path, tree_cast

__all__ = [
    "network_to_half",
    "convert_network",
    "BN_convert_float",
    "prep_param_lists",
    "master_params_to_model_params",
    "model_grads_to_master_grads",
]

Params = Mapping[str, torch.Tensor]


def network_to_half(params: Params, dtype=torch.float16) -> Dict:
    """Every floating leaf in half (fp16util.py:35-44)."""
    return tree_cast(params, dtype)


def convert_network(params: Params, dtype=torch.float16) -> Dict:
    """Every floating leaf in half but the batch-norm ones, kept fp32
    (fp16util.py:60-74)."""
    return tree_cast(params, dtype, keep_fp32_predicate=is_batchnorm_path)


def BN_convert_float(params: Params) -> Dict:
    """The batch-norm leaves back in fp32 (fp16util.py:46-57)."""
    return {k: v.float() if is_batchnorm_path(k) and v.is_floating_point()
            else v for k, v in params.items()}


def prep_param_lists(params: Params) -> Tuple[Dict, Dict]:
    """``(model params, fp32 master copies)`` (fp16util.py:90-133)."""
    return dict(params), model_grads_to_master_grads(params)


def master_params_to_model_params(model_params: Params,
                                  master_params: Params) -> Dict:
    """The masters' values in the model's dtypes (fp16util.py:136-160)."""
    return {k: master_params[k].to(v.dtype) for k, v in model_params.items()}


def model_grads_to_master_grads(model_grads: Params) -> Dict:
    """fp32 copies (fp16util.py:162-175)."""
    return {k: g.detach().to(torch.float32, copy=True)
            for k, g in model_grads.items()}
