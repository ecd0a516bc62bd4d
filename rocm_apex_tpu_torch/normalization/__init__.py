"""Fused normalization layers: the functional API and the modules."""

from rocm_apex_tpu_torch.normalization.fused_layer_norm import (
    FusedLayerNorm,
    MixedFusedLayerNorm,
    fused_layer_norm,
    fused_layer_norm_affine,
    mixed_dtype_fused_layer_norm_affine,
)

__all__ = [
    "FusedLayerNorm",
    "MixedFusedLayerNorm",
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "mixed_dtype_fused_layer_norm_affine",
]
