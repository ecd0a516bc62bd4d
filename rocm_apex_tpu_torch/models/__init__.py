"""Models on the ported path."""

from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["GPTConfig", "GPTModel"]
