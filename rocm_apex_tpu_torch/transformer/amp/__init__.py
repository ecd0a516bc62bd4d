"""Loss scaling that agrees across model-parallel ranks."""

from rocm_apex_tpu_torch.transformer.amp.grad_scaler import (  # noqa: F401
    GradScaler,
    sync_found_inf,
)

__all__ = ["GradScaler", "sync_found_inf"]
