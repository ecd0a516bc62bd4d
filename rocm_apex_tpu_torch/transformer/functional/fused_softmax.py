"""FusedScaleMaskSoftmax: kernel-eligibility dispatch and its fallback.

Port of ``rocm_apex_tpu/transformer/functional/fused_softmax.py``
(reference: apex/transformer/functional/fused_softmax.py —
`ScaledUpperTriangMaskedSoftmax:21`, `ScaledMaskedSoftmax:67` and
`FusedScaleMaskSoftmax:95`, whose `is_kernel_available:155-174` gates on
dtype and 16 < seq_k <= 2048 before `forward_torch_softmax:184`).

The kernels (`ops.softmax`) have no key-length ceiling, so eligibility
is "sk > 1 and fusion on", as in the JAX module. The fallback,
`forward_torch_softmax`, runs only when the caller turns fusion off (or
sk is 1); it is never taken because a kernel failed.
"""

from typing import Callable, Optional

import torch

from rocm_apex_tpu_torch.ops.softmax import (
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)
from rocm_apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = [
    "ScaledUpperTriangMaskedSoftmax",
    "ScaledMaskedSoftmax",
    "FusedScaleMaskSoftmax",
]


def ScaledUpperTriangMaskedSoftmax(x, scale: float = 1.0):
    """(b, sq, sk) causal scaled softmax (reference fused_softmax.py:21-64)."""
    return scaled_upper_triang_masked_softmax(x, scale)


def ScaledMaskedSoftmax(x, mask, scale: float = 1.0):
    """(b, n, sq, sk) scaled softmax with a bool padding mask (True =
    masked) (reference fused_softmax.py:67-92)."""
    return scaled_masked_softmax(x, mask, scale)


class FusedScaleMaskSoftmax:
    """Dispatching softmax (reference fused_softmax.py:95-199).

    The constructor mirrors the reference: input fp16|bf16 flags, the
    mask type, the masked-softmax fusion toggle, an optional
    ``mask_func(x, mask)`` for the fallback, ``softmax_in_fp32`` and
    ``scale``.
    """

    def __init__(
        self,
        input_in_fp16: bool = False,
        input_in_bf16: bool = True,
        attn_mask_type: AttnMaskType = AttnMaskType.causal,
        scaled_masked_softmax_fusion: bool = True,
        mask_func: Optional[Callable] = None,
        softmax_in_fp32: bool = True,
        scale: Optional[float] = None,
    ):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """The kernels need only the fusion toggle and more than one key."""
        return bool(self.scaled_masked_softmax_fusion and sk > 1)

    def __call__(self, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(b, np, sq, sk) scores -> probabilities in x's dtype; ``mask``
        bool, True = masked, broadcastable to (b, 1, sq, sk) (the causal
        kernel ignores it, as the reference's does)."""
        b, np_, sq, sk = x.shape
        scale = self.scale if self.scale is not None else 1.0
        if self.is_kernel_available(mask, b, np_, sq, sk):
            if self.attn_mask_type == AttnMaskType.causal:
                if sq != sk:
                    raise ValueError(
                        f"the causal mask is only for self attention (sq "
                        f"{sq} != sk {sk})")
                probs = scaled_upper_triang_masked_softmax(
                    x.reshape(-1, sq, sk), scale)
                return probs.reshape(b, np_, sq, sk)
            # no mask: the masked kernel with nothing masked
            return scaled_masked_softmax(x, mask, scale)
        return self.forward_torch_softmax(x, mask)

    def forward_torch_softmax(self, x: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference's fallback (fused_softmax.py:184-199): an fp32
        upcast of a 16-bit input under ``softmax_in_fp32``, the scale,
        ``mask_func`` (default: fill -10000.0 where masked), softmax, and
        the cast back."""
        orig = x.dtype
        upcast = self.input_in_float16 and self.softmax_in_fp32
        if upcast:
            x = x.float()
        if self.scale is not None:
            x = x * self.scale
        if self.attn_mask_type == AttnMaskType.causal:
            sq, sk = x.shape[-2:]
            causal = torch.ones(sq, sk, dtype=torch.bool,
                                device=x.device).triu(1)
            mask = causal if mask is None else (mask.to(torch.bool) | causal)
        if mask is not None:
            fill = self.mask_func or (
                lambda t, m: torch.where(m.to(torch.bool), -10000.0, t))
            x = fill(x, mask)
        probs = torch.softmax(x, dim=-1)
        if upcast:
            probs = probs.to(orig)
        return probs
