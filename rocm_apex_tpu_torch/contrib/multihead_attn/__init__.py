"""Self and encoder-decoder multi-head attention.

Port of ``rocm_apex_tpu/contrib/multihead_attn``: `SelfMultiheadAttn`,
`EncdecMultiheadAttn` and `fast_mask_softmax_dropout`.
"""

from rocm_apex_tpu_torch.contrib.multihead_attn.attn import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    fast_mask_softmax_dropout,
)

__all__ = [
    "SelfMultiheadAttn",
    "EncdecMultiheadAttn",
    "fast_mask_softmax_dropout",
]
