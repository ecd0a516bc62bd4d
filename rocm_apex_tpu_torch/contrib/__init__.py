"""contrib: the port of the JAX package's ``rocm_apex_tpu.contrib``.

One subpackage per kernel family, each importable on its own, as the JAX
package lays them out. Ported so far: ``fmha`` (packed variable-length
attention), ``xentropy`` (label-smoothed softmax cross-entropy),
``bottleneck`` (the ResNet bottleneck, plain and fused) and
``multihead_attn`` (self and encoder-decoder attention).
"""

from rocm_apex_tpu_torch.contrib.multihead_attn import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    fast_mask_softmax_dropout,
)

__all__ = [
    "SelfMultiheadAttn",
    "EncdecMultiheadAttn",
    "fast_mask_softmax_dropout",
]
