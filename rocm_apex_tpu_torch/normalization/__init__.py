"""Fused normalization layers."""

from rocm_apex_tpu_torch.normalization.fused_layer_norm import (
    MixedFusedLayerNorm,
)

__all__ = ["MixedFusedLayerNorm"]
