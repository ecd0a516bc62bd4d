"""The reference's per-namespace list module
(apex/amp/lists/functional_overrides.py). The port has one op namespace,
so this re-exports `torch_overrides`' lists."""

from rocm_apex_tpu_torch.amp.lists.torch_overrides import (  # noqa: F401
    BANNED_FUNCS,
    BFLOAT16_FUNCS,
    CASTS,
    FP16_FUNCS,
    FP32_FUNCS,
    SEQUENCE_CASTS,
    is_fp32_op,
    is_low_precision_op,
)
