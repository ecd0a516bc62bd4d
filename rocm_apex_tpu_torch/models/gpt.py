"""Megatron-style GPT for KV-cached serving, in PyTorch.

Port of ``rocm_apex_tpu/models/gpt.py`` on the path the serving engine
runs: tensor-parallel world size 1, no dropout, and the two cached
branches of `ParallelAttention`:

* the packed chunk (``chunk=(slot_ids, positions)``,
  rocm_apex_tpu/models/gpt.py:509-753): the chunk's K/V scatter into
  the cache at per-token (slot, position) rows (pads dropped), then two
  pieces merged by log-sum-exp weights in fp32 — (A) segment-masked
  causal attention within the chunk
  (`flash_attention_segments_with_lse`) and (B) each token against its
  OWN slot's pre-chunk cache prefix (`flash_attention_decode` with a
  slot id per row, reading the cache in place);
* the single-token decode (rocm_apex_tpu/models/gpt.py:754-893): each
  slot writes its new K/V at its length and reads ``[0, length + 1)``.

Module and parameter names follow the JAX model's param tree, so its
flattened paths are this module's ``state_dict`` keys (see ``convert.py``).
Linear and embedding weights are stored in the compute dtype (the JAX
model casts them on every call; the values are the same); LayerNorm
parameters stay in ``params_dtype``. The uncached forward and the
whole-prompt prefill raise: they need the flash forward kernels of a
later slice.
"""

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.inference.kv_cache import (
    ChunkRows,
    chunk_rows,
    scatter_chunk,
    write_at_lengths,
)
from rocm_apex_tpu_torch.normalization import MixedFusedLayerNorm
from rocm_apex_tpu_torch.ops.flash_attention import flash_attention_decode
from rocm_apex_tpu_torch.ops.flash_attention_segments import (
    flash_attention_segments_with_lse,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)

__all__ = [
    "GPTConfig",
    "GPTModel",
    "ParallelMLP",
    "ParallelAttention",
    "ParallelTransformerLayer",
    "ParallelTransformer",
    "TransformerEmbedding",
]

_NOT_PORTED = (
    "{what} is not ported yet: it needs the flash forward kernels "
    "(_fwd_kernel/_fwd_single_kernel); ROADMAP Queue 1 item 1 (uncached "
    "GPT forward and whole-prompt prefill), Queue 2 items 2-3"
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model hyperparameters; the fields the serving path reads, with
    the JAX package's names and defaults."""

    vocab_size: int = 32000
    hidden_size: int = 1024
    num_layers: int = 12
    num_attention_heads: int = 16
    max_position_embeddings: int = 2048
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    layernorm_epsilon: float = 1e-5
    params_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.bfloat16
    tensor_parallel_size: Optional[int] = None
    init_method_std: float = 0.02

    def __post_init__(self):
        if self.tensor_parallel_size not in (None, 1):
            raise NotImplementedError(
                "tensor_parallel_size > 1 is not ported yet (ROADMAP "
                "Queue 1 item 6, tp>1 serving)"
            )
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


class ParallelMLP(nn.Module):
    """h -> ffn (column-parallel) -> gelu (tanh) -> h (row-parallel)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn_size, **kw
        )
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn_size, cfg.hidden_size, **kw
        )

    def forward(self, x):
        # the JAX model's nn.gelu defaults to the tanh approximation
        return self.dense_4h_to_h(
            F.gelu(self.dense_h_to_4h(x), approximate="tanh")
        )


class ParallelAttention(nn.Module):
    """Causal self-attention on the KV-cached serving branches."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, **kw
        )
        self.dense = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, **kw
        )

    def forward(self, x, cache=None, chunk: Optional[ChunkRows] = None):
        cfg = self.cfg
        if cache is None:
            raise NotImplementedError(
                _NOT_PORTED.format(what="uncached attention")
            )
        k_buf, v_buf, lengths = cache
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        scale = 1.0 / math.sqrt(hd)
        b, sq, _ = x.shape
        qkv = self.query_key_value(x)
        # the fused projection is interleaved PER HEAD: (b, s, nh, 3*hd)
        q, k, v = qkv.view(b, sq, nh, 3 * hd).split(hd, dim=-1)
        num_slots, capacity = k_buf.shape[0], k_buf.shape[1]
        if chunk is not None:
            if b != 1:
                raise ValueError(
                    f"chunked prefill takes one packed stream (batch 1), "
                    f"got batch {b}"
                )
            qq, kq, vq = q[0], k[0], v[0]  # (budget, nh, hd) views
            # in place: the chunk's rows land at their (slot, position)
            scatter_chunk(k_buf, chunk, kq)
            scatter_chunk(v_buf, chunk, vq)
            # (A) intra-chunk causal attention, segment-masked by slot
            o_a, lse_a = flash_attention_segments_with_lse(
                qq.transpose(0, 1), kq.transpose(0, 1), vq.transpose(0, 1),
                chunk.slots, causal=True, scale=scale,
            )
            # (B) each token against its own slot's pre-chunk prefix
            o_b, lse_b = flash_attention_decode(
                qq, k_buf, v_buf, lengths, scale, return_lse=True,
                slot_ids=chunk.slots,
            )
            o_a = o_a.transpose(0, 1).float()
            lse_a = lse_a.transpose(0, 1)
            m = torch.maximum(lse_a, lse_b)
            w_a = torch.exp(lse_a - m)[..., None]
            w_b = torch.exp(lse_b - m)[..., None]
            ctx = (w_a * o_a + w_b * o_b.float()) / (w_a + w_b)
            ctx = ctx.to(cfg.dtype).reshape(1, sq, nh * hd)
        else:
            if sq != 1:
                raise NotImplementedError(
                    _NOT_PORTED.format(what="whole-prompt prefill")
                )
            # in place: each slot's new row at its length, dead rows
            # included
            write_at_lengths(k_buf, lengths, k)
            write_at_lengths(v_buf, lengths, v)
            kv_len = torch.clamp(lengths + 1, max=capacity)
            ctx = flash_attention_decode(q[:, 0], k_buf, v_buf, kv_len, scale)
            ctx = ctx.reshape(b, 1, nh * hd)
        return self.dense(ctx)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: LN -> attention -> residual (fused into LN2) -> MLP
    -> residual. Cached paths never chain residuals across layers."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ln = dict(eps=cfg.layernorm_epsilon, params_dtype=cfg.params_dtype,
                  device=device)
        self.input_layernorm = MixedFusedLayerNorm(cfg.hidden_size, **ln)
        self.self_attention = ParallelAttention(cfg, device)
        self.post_attention_layernorm = MixedFusedLayerNorm(
            cfg.hidden_size, **ln
        )
        self.mlp = ParallelMLP(cfg, device)

    def forward(self, x, cache=None, chunk: Optional[ChunkRows] = None):
        ln1 = self.input_layernorm(x)
        attn = self.self_attention(ln1, cache, chunk)
        ln2, x = self.post_attention_layernorm(attn.to(x.dtype), residual=x)
        mlp = self.mlp(ln2)
        return (x + mlp.to(x.dtype)).to(self.cfg.dtype)


class ParallelTransformer(nn.Module):
    """``num_layers`` blocks (``layer_0`` ...) and the final LayerNorm."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layer_names = [f"layer_{i}" for i in range(cfg.num_layers)]
        for name in self.layer_names:
            self.add_module(name, ParallelTransformerLayer(cfg, device))
        self.final_layernorm = MixedFusedLayerNorm(
            cfg.hidden_size, eps=cfg.layernorm_epsilon,
            params_dtype=cfg.params_dtype, device=device,
        )

    def forward(self, x, cache, chunk: Optional[ChunkRows] = None):
        for i, name in enumerate(self.layer_names):
            layer_cache = (cache.k[i], cache.v[i], cache.lengths)
            x = getattr(self, name)(x, layer_cache, chunk)
        x = self.final_layernorm(x).to(self.cfg.dtype)
        if chunk is None:
            # every layer wrote at the same offsets: advance once, for
            # all slots (the engine pins inactive slots afterwards); the
            # chunk path leaves the cursors to the engine
            cache.lengths = torch.clamp(
                cache.lengths + x.shape[1], max=cache.capacity
            )
        return x


class TransformerEmbedding(nn.Module):
    """Word + learned position embeddings, summed in the compute dtype;
    ``attend`` is the tied LM head."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=device,
        )
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size,
                        dtype=cfg.dtype, device=device),
            requires_grad=False,
        )

    def forward(self, tokens, position_ids):
        words = self.word_embeddings(tokens)
        # a dead decode row may sit at the last position; clamp its read
        pos = self.position_embeddings[
            position_ids.clamp(0, self.cfg.max_position_embeddings - 1)
        ].to(self.cfg.dtype)
        return words + pos

    def attend(self, hidden):
        return self.word_embeddings.attend(hidden)


class GPTModel(nn.Module):
    """Embedding -> transformer -> tied LM head, on the KV-cached paths.

    ``cache`` is a `rocm_apex_tpu_torch.inference.KVCache` (duck-typed:
    ``.k``/``.v`` per-layer ``(num_slots, capacity, heads, head_dim)``
    buffers, ``.lengths``, ``.capacity``); the forward UPDATES IT IN
    PLACE and returns ``(logits, cache)``. ``tokens`` (num_slots, 1) is
    the single-token decode: positions default to each slot's length and
    ``lengths`` advance by one. ``chunk=(slot_ids, positions)`` with
    ``tokens`` (1, budget) is the packed chunk: padding tokens carry slot
    id ``num_slots``, and ``lengths`` (each slot's pre-chunk prefix) are
    not advanced. Runs on CUDA unless ``device`` says otherwise.
    """

    def __init__(self, cfg: GPTConfig,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embedding = TransformerEmbedding(cfg, self.device)
        self.transformer = ParallelTransformer(cfg, self.device)

    @torch.no_grad()
    def forward(
        self,
        tokens: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        cache=None,
        chunk: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        if cache is None:
            raise NotImplementedError(
                _NOT_PORTED.format(what="the uncached (training) forward")
            )
        rows = None
        if chunk is not None:
            if tokens.shape[0] != 1:
                raise ValueError("chunked prefill takes tokens of shape (1, budget)")
            slots, positions = chunk
            rows = chunk_rows(slots, positions, cache.num_slots, cache.capacity)
            if position_ids is None:
                position_ids = positions[None, :]
        else:
            if tokens.shape[1] != 1:
                raise NotImplementedError(
                    _NOT_PORTED.format(what="whole-prompt prefill")
                )
            if position_ids is None:
                position_ids = cache.lengths[:, None] + torch.arange(
                    tokens.shape[1], device=tokens.device
                )
        x = self.embedding(tokens, position_ids)
        x = self.transformer(x, cache, rows)
        return self.embedding.attend(x), cache
