"""Transformer enums: a copy of ``rocm_apex_tpu/transformer/enums.py``
(reference: apex/transformer/enums.py:18-30)."""

import enum

__all__ = ["LayerType", "AttnType", "AttnMaskType"]


class LayerType(enum.Enum):
    encoder = 1
    decoder = 2


class AttnType(enum.Enum):
    self_attn = 1
    cross_attn = 2


class AttnMaskType(enum.Enum):
    padding = 1
    causal = 2
