"""Models on the ported path."""

from rocm_apex_tpu_torch.models.bert import BertConfig, BertModel
from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from rocm_apex_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    FoldedConvBN,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet_tiny,
)

__all__ = [
    "BasicBlock",
    "BertConfig",
    "BertModel",
    "Bottleneck",
    "FoldedConvBN",
    "GPTConfig",
    "GPTModel",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet_tiny",
]
