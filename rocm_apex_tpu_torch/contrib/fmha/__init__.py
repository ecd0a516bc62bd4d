"""Packed variable-length fused multi-head attention.

Port of ``rocm_apex_tpu/contrib/fmha``: `fmha` and the `FMHA` module over
packed qkv and ``cu_seqlens``, with no sequence-length ceiling.
"""

from rocm_apex_tpu_torch.contrib.fmha.fmha import FMHA, fmha  # noqa: F401

__all__ = ["fmha", "FMHA"]
