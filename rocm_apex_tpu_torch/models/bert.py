"""Megatron-style BERT in PyTorch: the masked-LM pre-training forward.

Port of ``rocm_apex_tpu/models/bert.py`` at tensor-parallel world size 1,
over the same blocks as ``models/gpt.py``: learned position and token-type
embeddings, the bidirectional `ParallelTransformer`
(``attn_mask_type="padding"``), the tied masked-LM head and the optional
binary (next-sentence) head.

With ``attention_mask=None`` (no padded positions) the attention runs the
packed flash kernels without the causal mask, as the JAX model does. A
(b, s) padding mask (1 = keep) becomes `bert_extended_attention_mask`'s
(b, 1, s, s) pair mask, then the additive fp32 bias of -1e30 that every
layer's unpacked flash kernels add to the scores (`models.gpt.
padding_bias`, built once per forward): a padded query row attends
nothing, so its attention output is 0, as the JAX kernel gives it. The
loss stays per token; a caller masks or averages it. `BertModel` has no
fused linear+CE head: with
``lm_labels`` the (b, s, vocab) logits of the tied projection go through
the cross-entropy kernel (`models.gpt._serial_cross_entropy`), which
writes the logits' gradient during its forward read.

Module and parameter names follow the JAX model's param tree
(``tokentype_embeddings``, ``lm_head.dense``, ``lm_head.layernorm``,
``pooler``, ``binary_head``; dense kernels are (in, out)), so its
flattened paths are this module's ``state_dict`` keys.
"""

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.models.gpt import (
    GPTConfig,
    ParallelTransformer,
    TransformerEmbedding,
    _draw_seed,
    _embedding_dropout,
    _serial_cross_entropy,
)
from rocm_apex_tpu_torch.normalization import MixedFusedLayerNorm

__all__ = ["BertConfig", "BertLMHead", "BertModel",
           "bert_extended_attention_mask"]


@dataclasses.dataclass(frozen=True)
class BertConfig(GPTConfig):
    """GPT hyperparameters + BERT extras."""

    num_token_types: int = 2
    add_binary_head: bool = True


def bert_extended_attention_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(b, s) padding mask (1 = keep) -> (b, 1, s, s), True = masked:
    a pair attends only where both positions are valid."""
    m = attention_mask.bool()
    return ~(m[:, None, :, None] & m[:, None, None, :])


class _Dense(nn.Module):
    """``x @ kernel + bias`` with a flax ``Dense``'s parameter names and
    its (in, out) kernel; the parameters are held in ``dtype`` (the
    training state rewrites them in its compute dtype) and the product
    is computed in ``compute_dtype``."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(
            torch.zeros(n_in, n_out, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=dtype,
                                             device=device))

    def forward(self, x):
        dt = self.compute_dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class BertLMHead(nn.Module):
    """Masked-LM head: dense -> gelu (the tanh approximation, flax's
    default) -> LayerNorm -> the tied vocabulary projection."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.dense = _Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype,
                            cfg.dtype, device)
        self.layernorm = MixedFusedLayerNorm(
            cfg.hidden_size, eps=cfg.layernorm_epsilon,
            params_dtype=cfg.params_dtype, device=device,
        )

    def forward(self, hidden, embedding: TransformerEmbedding):
        h = F.gelu(self.dense(hidden), approximate="tanh")
        h = self.layernorm(h).to(self.cfg.dtype)
        return embedding.attend(h)


class BertModel(nn.Module):
    """Embeddings -> bidirectional transformer -> (pooler, LM head,
    binary head). With ``lm_labels`` returns ``(per-token fp32 LM losses,
    binary_logits)``, otherwise ``(lm_logits, binary_logits)``;
    ``binary_logits`` (fp32) is None without the binary head.
    Differentiable; ``deterministic=False`` turns dropout on, seeded per
    site from ``dropout_generator`` (a CPU `torch.Generator`). Runs on
    CUDA unless ``device`` says otherwise."""

    def __init__(self, cfg: BertConfig,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embedding = TransformerEmbedding(cfg, self.device)
        self.tokentype_embeddings = nn.Parameter(
            torch.zeros(cfg.num_token_types, cfg.hidden_size,
                        dtype=cfg.dtype, device=self.device)
        )
        self.transformer = ParallelTransformer(cfg, self.device,
                                               attn_mask_type="padding")
        self.lm_head = BertLMHead(cfg, self.device)
        if cfg.add_binary_head:
            self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype,
                                 cfg.dtype, self.device)
            # the binary head computes in fp32 whatever the compute dtype
            self.binary_head = _Dense(cfg.hidden_size, 2, torch.float32,
                                      torch.float32, self.device)

    def forward(
        self,
        tokens: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        tokentype_ids: Optional[torch.Tensor] = None,
        lm_labels: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout_generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        # attention_mask=None means no padded positions: it stays None so
        # the attention takes the dense packed path
        ext_mask = (bert_extended_attention_mask(attention_mask)
                    if attention_mask is not None else None)
        seeds = None
        if not deterministic:
            seeds = dropout_generator or torch.default_generator
        position_ids = torch.arange(tokens.shape[1],
                                    device=tokens.device)[None, :]
        x = self.embedding(tokens, position_ids)
        if seeds is not None and cfg.hidden_dropout > 0.0:
            x = _embedding_dropout(x, _draw_seed(seeds), cfg.hidden_dropout)
        if tokentype_ids is not None:
            x = x + self.tokentype_embeddings[tokentype_ids].to(cfg.dtype)
        x = self.transformer(x, seeds=seeds, attention_mask=ext_mask)

        binary_logits = None
        if cfg.add_binary_head:
            pooled = torch.tanh(self.pooler(x[:, 0]))
            binary_logits = self.binary_head(pooled)

        lm_logits = self.lm_head(x, self.embedding)
        if lm_labels is None:
            return lm_logits, binary_logits
        return _serial_cross_entropy(lm_logits, lm_labels), binary_logits
