"""Functional fused ops for the transformer layer: port of
``rocm_apex_tpu/transformer/functional`` (fused_softmax.py)."""

from rocm_apex_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    FusedScaleMaskSoftmax,
    ScaledMaskedSoftmax,
    ScaledUpperTriangMaskedSoftmax,
)

__all__ = [
    "FusedScaleMaskSoftmax",
    "ScaledMaskedSoftmax",
    "ScaledUpperTriangMaskedSoftmax",
]
