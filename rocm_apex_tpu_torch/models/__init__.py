"""Models on the ported path."""

from rocm_apex_tpu_torch.models.bert import BertConfig, BertModel
from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel

__all__ = ["BertConfig", "BertModel", "GPTConfig", "GPTModel"]
