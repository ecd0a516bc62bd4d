"""Self and encoder-decoder multi-head attention, flash-cored.

Port of ``rocm_apex_tpu/contrib/multihead_attn/attn.py``: one fused input
projection (``qkv_proj`` for self attention; ``q_proj`` and the packed
``kv_proj`` for encoder-decoder), the attention core and ``out_proj``,
with the options ``bias`` (projection biases), ``include_norm_add`` (a
`FusedLayerNorm` named ``lyr_norm`` on the query input and the original
query added to the output) and ``dtype`` (the compute dtype; parameters
stay fp32, cast on every call, as flax ``Dense`` does). The layout is
batch-first ``(b, s, hidden)``. The fused projections split into
contiguous column blocks, ``[q | k | v]`` and ``[k | v]``, each head the
next ``hidden / heads`` columns of its block (not the GPT's per-head
interleave). Weights are ``nn.Linear``'s (out, in); the JAX package's
flax kernels are (in, out) (`rocm_apex_tpu_torch.convert.mha_from_jax_params`
carries them across).

The core, as in JAX (attn.py:60-96):

* dropout 0 or ``deterministic``: the unpacked flash kernels
  (`flash_attention_heads`: rows 7b and 9b, one forward and one backward
  launch a call) on the (b, heads, s, d) column views of the projections,
  read in place, with the masks as one additive fp32 (nb, sq, sk) bias
  (`_combine_masks`, -1e30 where masked; nb = b with a key-padding mask,
  so operand row i reads bias row i // heads) and no bias gradient. A
  query row whose every key is masked gives 0;
* attention dropout in training: the JAX module's own materialized
  branch in plain PyTorch, no kernel: fp32 scores of the compute-dtype
  q and k, plus the bias, a plain fp32 softmax (a fully masked row is the
  uniform average of v over the keys), the probabilities in the compute
  dtype, dropout, then probs @ v in the compute dtype. The keep bits are
  `ops._dropout`'s counter hash of ``dropout_seed`` over the (b*heads,
  sq, sk) probabilities, or a draw from an explicit ``generator``; they
  cannot equal ``jax.random.bernoulli``'s.
"""

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.normalization import FusedLayerNorm
from rocm_apex_tpu_torch.ops import _dropout
from rocm_apex_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention_heads,
)
from rocm_apex_tpu_torch.ops.softmax import ScoresFp32

__all__ = [
    "SelfMultiheadAttn",
    "EncdecMultiheadAttn",
    "fast_mask_softmax_dropout",
]


def _keep(shape, rate: float, device, dropout_seed: Optional[int],
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """The bool keep mask of a (..., rows, cols) tensor: from
    ``generator`` where given, else `ops._dropout`'s hash of
    ``dropout_seed`` (drawn from torch's default CPU generator when
    None)."""
    if generator is not None:
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(device) >= rate
    if dropout_seed is None:
        dropout_seed = int(torch.randint(0, 2**31 - 1, (1,)))
    return _dropout.keep_mask(int(dropout_seed), rate, shape, device=device)


def fast_mask_softmax_dropout(
    scores: torch.Tensor,
    mask: Optional[torch.Tensor],
    dropout_rate: float,
    deterministic: bool,
    dropout_seed: Optional[int] = None,
    scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Masked softmax (+ dropout) on materialized scores, plain PyTorch:
    softmax(scores * scale, -1e30 where ``mask`` is True) in fp32, in the
    scores' dtype; with dropout in training, kept values scaled by
    1 / (1 - rate) (keep bits as `_keep` draws them)."""
    s = scores.float() * scale
    if mask is not None:
        s = s.masked_fill(mask.to(torch.bool), NEG_INF)
    p = torch.softmax(s, dim=-1).to(scores.dtype)
    if dropout_rate > 0.0 and not deterministic:
        keep = _keep(p.shape, dropout_rate, p.device, dropout_seed,
                     generator)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0).to(p.dtype)
    return p


def _combine_masks(b: int, sq: int, sk: int,
                   key_padding_mask: Optional[torch.Tensor],
                   attn_mask: Optional[torch.Tensor],
                   device) -> Optional[torch.Tensor]:
    """The additive fp32 bias of the masks, or None: (b, sq, sk) with a
    ``key_padding_mask`` ((b, sk), True = pad), else (1, sq, sk) from
    ``attn_mask`` alone (additive (sq, sk), or bool with True = masked,
    which becomes -1e30); their sum where both are given."""
    bias = None
    if key_padding_mask is not None:
        kp = key_padding_mask.to(device=device, dtype=torch.bool)
        bias = torch.where(kp[:, None, :], NEG_INF, 0.0).to(torch.float32)
        bias = bias.expand(b, sq, sk)
    if attn_mask is not None:
        am = attn_mask.to(device)
        if am.dtype == torch.bool:
            am = torch.where(am, NEG_INF, 0.0)
        am = am.to(torch.float32).expand(sq, sk)[None]
        bias = am if bias is None else bias + am
    return bias


def _attend(q, k, v, bias, heads: int, dropout: float, deterministic: bool,
            dropout_seed: Optional[int],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(b, s, hidden) projected operands (column views of the fused
    projections) -> the (b, sq, hidden) context in q's dtype."""
    b, sq, hidden = q.shape
    sk = k.shape[1]
    d = hidden // heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (t.view(t.shape[0], t.shape[1], heads, d).permute(0, 2, 1, 3)
                  for t in (q, k, v))
    if dropout == 0.0 or deterministic:
        # the bias is a mask, never learned: no bias gradient, no launch
        return flash_attention_heads(qh, kh, vh, bias, causal=False,
                                     scale=scale)
    # fp32 scores of the compute-dtype q and k (the einsum's
    # preferred_element_type=float32)
    s = ScoresFp32.apply(qh, kh) * scale  # (b, heads, sq, sk)
    if bias is not None:
        s = s + bias.reshape(bias.shape[0], -1, sq, sk)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    keep = _keep((b * heads, sq, sk), dropout, q.device, dropout_seed,
                 generator).view(b, heads, sq, sk)
    p = torch.where(keep, p / (1.0 - dropout), 0.0).to(q.dtype)
    ctx = torch.matmul(p, vh)
    return ctx.permute(0, 2, 1, 3).reshape(b, sq, hidden)


def _lecun_normal_(w: torch.Tensor) -> None:
    """flax ``Dense``'s default kernel init: a truncated normal of
    variance 1 / fan_in (fan_in = the weight's second dim here)."""
    std = 1.0 / math.sqrt(w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)


class _Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters, computed in ``dtype`` (weight
    and bias cast on every call, as flax ``Dense(dtype=...)``)."""

    def __init__(self, fan_in, fan_out, bias, dtype, device):
        super().__init__(fan_in, fan_out, bias=bias, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype
        with torch.no_grad():
            _lecun_normal_(self.weight)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class _MultiheadAttn(nn.Module):
    def __init__(self, num_heads, hidden_size, dropout, bias,
                 include_norm_add, dtype, device):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.dropout = dropout
        self.include_norm_add = include_norm_add
        self.dtype = dtype
        self.device = resolve_device(device)
        self.lyr_norm = (FusedLayerNorm(hidden_size, device=self.device)
                         if include_norm_add else None)

    def _core(self, q, k, v, key_padding_mask, attn_mask, deterministic,
              dropout_seed, generator, residual):
        b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        bias = _combine_masks(b, sq, sk, key_padding_mask, attn_mask,
                              q.device)
        ctx = _attend(q, k, v, bias, self.num_heads, self.dropout,
                      deterministic, dropout_seed, generator)
        out = self.out_proj(ctx)
        if self.include_norm_add:
            out = out + residual
        return out

    def _normed(self, query):
        if query.shape[-1] != self.hidden_size:
            raise ValueError(f"input width {query.shape[-1]} != hidden_size "
                             f"{self.hidden_size}")
        return self.lyr_norm(query) if self.include_norm_add else query


class SelfMultiheadAttn(_MultiheadAttn):
    """Self attention over ``query`` (b, s, hidden): ``qkv_proj`` (hidden
    -> 3 hidden, split ``[q | k | v]``), the core, ``out_proj``.
    Parameters fp32 on ``device`` (default the current CUDA device); the
    output is in ``dtype`` (promoted with the query's with
    ``include_norm_add``)."""

    def __init__(self, num_heads: int, hidden_size: int, dropout: float = 0.0,
                 bias: bool = True, include_norm_add: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(num_heads, hidden_size, dropout, bias,
                         include_norm_add, dtype, device)
        h = hidden_size
        self.qkv_proj = _Dense(h, 3 * h, bias, dtype, self.device)
        self.out_proj = _Dense(h, h, bias, dtype, self.device)

    def forward(self, query: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``key_padding_mask`` (b, s) True = pad; ``attn_mask`` additive
        (s, s) or bool (True = masked); with ``deterministic=False`` and
        dropout > 0, attention dropout keyed by ``dropout_seed`` (or
        drawn from ``generator``)."""
        qkv = self.qkv_proj(self._normed(query))
        q, k, v = qkv.split(self.hidden_size, dim=-1)
        return self._core(q, k, v, key_padding_mask, attn_mask,
                          deterministic, dropout_seed, generator, query)


class EncdecMultiheadAttn(_MultiheadAttn):
    """Encoder-decoder attention: ``q_proj`` on ``query`` (b, sq, hidden),
    ``kv_proj`` (hidden -> 2 hidden, split ``[k | v]``) on ``key`` (b, sk,
    hidden), the core, ``out_proj``; ``include_norm_add`` normalizes the
    query alone and adds it back."""

    def __init__(self, num_heads: int, hidden_size: int, dropout: float = 0.0,
                 bias: bool = True, include_norm_add: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(num_heads, hidden_size, dropout, bias,
                         include_norm_add, dtype, device)
        h = hidden_size
        self.q_proj = _Dense(h, h, bias, dtype, self.device)
        self.kv_proj = _Dense(h, 2 * h, bias, dtype, self.device)
        self.out_proj = _Dense(h, h, bias, dtype, self.device)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """As `SelfMultiheadAttn.forward`, ``key_padding_mask`` (b, sk)
        over the keys and ``attn_mask`` (sq, sk)."""
        q = self.q_proj(self._normed(query))
        k, v = self.kv_proj(key).split(self.hidden_size, dim=-1)
        return self._core(q, k, v, key_padding_mask, attn_mask,
                          deterministic, dropout_seed, generator, query)
