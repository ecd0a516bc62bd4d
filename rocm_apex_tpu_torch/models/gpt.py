"""Megatron-style GPT in PyTorch: the training forward and the
KV-cached serving branches.

Port of ``rocm_apex_tpu/models/gpt.py`` at tensor-parallel world size 1.

* The uncached forward (training, rocm_apex_tpu/models/gpt.py:1097-1188,
  1234-1336, 1573-1637) is the JAX model's pre-LN stack with CHAINED
  residuals: each layer returns its stream and its pending MLP delta, and
  the next layer's ln1 (or the final LN) adds the delta inside the
  LayerNorm kernel, so every residual add rides a kernel. Attention reads
  q/k/v straight out of the fused projection with its bias added on load
  (`flash_attention_qkv_bias{,_dropout}`). With dropout on
  (``deterministic=False``) hidden dropout runs inside the residual LN
  kernels and attention dropout inside the flash kernels, both with
  `ops._dropout`'s keep bits, and the embedding dropout as a plain op
  (a flax op, not a kernel, in the JAX package) on torch's generator.
  Each site's int32 seed is drawn per step from a CPU `torch.Generator`
  (``dropout_generator``, default torch's global CPU generator), so
  drawing it never waits on the device.
  Unlike the JAX package, which falls back to a materialized softmax off
  the TPU (gpt.py:419-425), the port always runs the in-kernel forms.
  ``labels=`` routes the last hidden state through the fused linear+CE
  head (`VocabParallelEmbedding.attend_loss`) or, with
  ``fused_lm_head=False``, through the materialized head: the tied
  projection's logits into the cross-entropy kernel
  (`_serial_cross_entropy`). The branch choice is the JAX model's
  (gpt.py:409-449): the packed kernels serve the causal type and the
  ``attn_mask_type="padding"`` type (the BERT stack) without a mask
  tensor, at a head_dim that is a multiple of 128. With a mask tensor,
  or another head_dim, the projection adds its own bias and the per-head
  q/k/v columns go to the unpacked flash kernels
  (`flash_attention_heads`, read in place through their strides): the
  padding type with the (b, sq, sk) fp32 bias of -1e30 that
  `padding_bias` builds from the mask (once per forward), the causal
  type with the in-kernel causal mask.
  ``attention_impl="fused_softmax"`` (gpt.py:1010-1053) materializes the
  scores instead, for either mask type and any head_dim: q·kᵀ in fp32
  from the compute-dtype projection, the scaled causal or padding-masked
  softmax kernel (`ops.softmax`; the padding type without a mask is a
  plain fp32 softmax, as in JAX), the probabilities cast to the compute
  dtype, their dropout as a plain op, then probs·v in the compute dtype.
  The padding type's masked keys there score -10000, so a fully masked
  query row (BERT's padded positions) attends every key uniformly, the
  JAX value, where the flash path gives 0.
* The cached branches serve the engine (rocm_apex_tpu/models/gpt.py:
  509-893), deterministic and under ``torch.no_grad``: the packed chunk
  (``chunk=(slot_ids, positions)``) scatters its K/V into the cache at
  per-token (slot, position) rows (pads dropped) and merges two pieces by
  log-sum-exp weights in fp32 — (A) segment-masked causal attention
  within the chunk (`flash_attention_segments_with_lse`) and (B) each
  token against its OWN slot's pre-chunk cache prefix
  (`flash_attention_decode` with a slot id per row, reading the cache in
  place); the single-token decode writes each slot's new K/V at its
  length and reads ``[0, length + 1)``. A paged cache
  (`rocm_apex_tpu_torch.inference.PagedKVCache`, duck-typed by its
  ``page_table``) gives each layer a 4-tuple view: the writes go through
  the table (`ops.paging`, destinations resolved once per forward; dead
  decode rows sit at capacity and drop; int8 pools raise their page
  scales), the chunk reads through `flash_attention_chunk_paged` and the
  decode through `flash_attention_decode_paged`. A cached window wider
  than one token with no ``chunk`` is the whole-prompt prefill
  (gpt.py:894-913): its K/V land at each slot's length and causal
  unpacked flash attention runs over the fresh window alone (the
  engine's slots start empty); a paged cache refuses it, as in JAX.
  These branches run the flash kernels under ``"fused_softmax"`` too, as
  the JAX model does (it tests for ``"jnp"`` only, gpt.py:820-900).
* ``attention_impl="jnp"`` is the JAX model's one-pass reference
  attention, in plain PyTorch: no attention kernel launches (the
  LayerNorm kernels do). Uncached, it is the materialized path with the
  softmax kernels off (gpt.py:488-490). The packed chunk, after its
  scatter, attends each token's own slot's cache rows ``[0, pos + 1)``
  in one bounded fp32 softmax, the slot picked by a one-hot contraction
  (gpt.py:589-640; a paged cache is read through `paged_view`,
  dequantized when int8); the decode reads a materialized softmax over
  ``[0, length + 1)`` (gpt.py:810-880) and the whole-prompt prefill a
  causal one (gpt.py:896-910).
* ``context_parallel_axis`` (gpt.py:114-119): the uncached model runs on
  this rank's contiguous shard of the sequence, over the process group
  bound to the axis (`transformer.parallel_state`). Each layer's causal
  attention is `ring_flash_attention` over the unpacked kernels, never
  the packed ones (gpt.py:958-966); default positions are offset by
  rank * s_local (gpt.py:1402-1407), and the hidden-dropout seeds fold
  the rank in, so the shards draw different masks (gpt.py:270-285). It
  takes attention_impl "flash", the causal type and no attention
  dropout in training, as the JAX model (gpt.py:476-486). The
  all-reduce of the replicated parameters' gradients over the group is
  the caller's.

Module and parameter names follow the JAX model's param tree, so its
flattened paths are this module's ``state_dict`` keys (see ``convert.py``).
Linear and embedding weights are stored in the compute dtype (the JAX
model casts them on every call; the values are the same); LayerNorm
parameters in ``params_dtype`` (the training state keeps them in the
compute dtype, as the JAX optimizer's model tree does).
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
from rocm_apex_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention_decode,
    flash_attention_decode_paged,
    flash_attention_heads,
    flash_attention_qkv_bias,
    flash_attention_qkv_bias_dropout,
)
from rocm_apex_tpu_torch.ops.flash_attention_segments import (
    flash_attention_chunk_paged,
    flash_attention_segments_with_lse,
    merge_by_lse,
)
from rocm_apex_tpu_torch.ops import _dropout as _keep_bits
from rocm_apex_tpu_torch.ops.paging import (
    PagedRows,
    paged_rows,
    paged_scatter,
    paged_view,
    quantized_paged_scatter,
)
from rocm_apex_tpu_torch.ops.softmax import (
    ScoresFp32,
    scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)
from rocm_apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss_fused
from rocm_apex_tpu_torch.transformer import parallel_state
from rocm_apex_tpu_torch.transformer.context_parallel import (
    ring_flash_attention,
)
from rocm_apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)

__all__ = [
    "GPTConfig",
    "hidden_dropout_seed",
    "GPTModel",
    "gpt_loss_fn",
    "ParallelMLP",
    "ParallelAttention",
    "ParallelTransformerLayer",
    "ParallelTransformer",
    "TransformerEmbedding",
    "padding_bias",
]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Model hyperparameters: the fields the ported paths read, with the
    JAX package's names and defaults. A value the port cannot run yet
    raises `NotImplementedError` naming its ROADMAP item."""

    vocab_size: int = 32000
    hidden_size: int = 1024
    num_layers: int = 12
    num_attention_heads: int = 16
    max_position_embeddings: int = 2048
    ffn_hidden_size: Optional[int] = None  # default 4*hidden
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layernorm_epsilon: float = 1e-5
    apply_residual_connection_post_layernorm: bool = False
    params_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.bfloat16
    tensor_parallel_size: Optional[int] = None
    init_method_std: float = 0.02
    # False: the fused-softmax path's softmax is plain, -inf fills for
    # both mask types (a fully masked row is NaN there, as in JAX)
    use_pallas_softmax: bool = True
    # "flash" (the flash kernels), "fused_softmax" (materialized scores
    # and the softmax kernels on the uncached path) or "jnp" (the one-pass
    # reference attention in plain PyTorch on every path)
    attention_impl: str = "flash"
    checkpoint_activations: bool = False
    label_smoothing: float = 0.0
    ignore_index: Optional[int] = None
    fused_lm_head: bool = True
    lm_head_chunk_size: Optional[int] = None
    # the uncached model on this rank's shard of the sequence, ring
    # attention over the process group bound to this axis name
    # (transformer.parallel_state)
    context_parallel_axis: Optional[str] = None
    sequence_parallel: bool = False

    def __post_init__(self):
        if self.sequence_parallel and self.context_parallel_axis is not None:
            raise ValueError(
                "sequence_parallel shards the sequence over the tensor "
                "axis and context_parallel_axis shards it over "
                f"{self.context_parallel_axis!r}: the axes collide on "
                "the sequence dimension — enable one or the other"
            )
        if self.attention_impl not in ("flash", "fused_softmax", "jnp"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}")
        unported = [
            (self.tensor_parallel_size not in (None, 1),
             "tensor_parallel_size > 1 (ROADMAP Queue 1 item 8, tp>1 "
             "serving)"),
            (self.sequence_parallel,
             "sequence_parallel=True (ROADMAP Queue 1 item 10, rest of the "
             "training stack)"),
            (self.checkpoint_activations,
             "checkpoint_activations=True (ROADMAP Queue 1 item 10, rest "
             "of the training stack)"),
            (self.apply_residual_connection_post_layernorm,
             "apply_residual_connection_post_layernorm=True (ROADMAP "
             "Queue 1 item 10, rest of the training stack)"),
        ]
        for bad, what in unported:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")

    @property
    def ffn_size(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _draw_seed(generator: torch.Generator) -> int:
    """One dropout site's int32 seed, drawn on the host from a CPU
    generator (no device sync)."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator))


def _cp_rank(cfg: GPTConfig) -> Optional[int]:
    """This process's rank along the context-parallel axis, or None."""
    if cfg.context_parallel_axis is None:
        return None
    return parallel_state.axis_rank(cfg.context_parallel_axis)


def hidden_dropout_seed(generator: torch.Generator, cfg: GPTConfig) -> int:
    """A hidden-dropout site's int32 seed: `_draw_seed`, with the
    context-parallel rank folded in (the hash of (seed, rank)), so every
    shard draws its own mask from one generator state (the JAX model's
    ``fold_in`` of the axis index, gpt.py:270-285)."""
    seed = _draw_seed(generator)
    rank = _cp_rank(cfg)
    if rank is None:
        return seed
    return int(_keep_bits.hash32(seed, rank, 0, 0)) & 0x7FFFFFFF


def _paged_write(k_buf, v_buf, paged, k_new, v_new) -> None:
    """K/V rows into a paged layer's pools (and int8 scales), in place,
    at the destinations resolved once for this forward."""
    rows, table = paged["rows"], paged["page_table"]
    if paged["k_scale"] is None:
        paged_scatter(k_buf, table, None, None, k_new, rows)
        paged_scatter(v_buf, table, None, None, v_new, rows)
    else:
        quantized_paged_scatter(k_buf, paged["k_scale"], table, None, None,
                                k_new, rows)
        quantized_paged_scatter(v_buf, paged["v_scale"], table, None, None,
                                v_new, rows)


def _dropout(x, seed: int, rate: float):
    """Dropout as a plain op, where the JAX package has a flax op and not a
    kernel: the embedding's (gpt.py:1420-1421) and the fused-softmax
    path's attention probabilities (`_Dropout`, gpt.py:201-222). Its mask
    comes from torch's generator on x's device, seeded with the site's
    seed: one random draw, where the kernels' counter hash would cost ~30
    int64 passes over the tensor. Kept elements are x / (1 - rate) in x's
    dtype; autograd keeps the mask for the backward."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


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
        h, _ = self.dense_h_to_4h(x)
        # the JAX model's nn.gelu defaults to the tanh approximation
        y, _ = self.dense_4h_to_h(F.gelu(h, approximate="tanh"))
        return y


def _check_mask_type(attn_mask_type: str) -> str:
    if attn_mask_type not in ("causal", "padding"):
        raise ValueError(f"unknown attn_mask_type {attn_mask_type!r}")
    return attn_mask_type


def padding_bias(attention_mask: torch.Tensor, b: int, sq: int
                 ) -> torch.Tensor:
    """A broadcastable (b|1, 1, sq|1, sk) padding mask (True = masked) as
    the additive fp32 (b, sq, sk) attention bias: -1e30 where masked, 0
    elsewhere (rocm_apex_tpu/models/gpt.py:978-990)."""
    mask = attention_mask.to(torch.bool).expand(b, 1, sq, sq)
    return torch.where(mask, NEG_INF, 0.0).to(torch.float32)[:, 0]


class ParallelAttention(nn.Module):
    """Self-attention: uncached, the packed flash path or the unpacked one
    (a mask tensor, or a head_dim that is not a multiple of 128), causal
    or, with ``attn_mask_type="padding"``, bidirectional; and the
    KV-cached serving branches (causal only)."""

    def __init__(self, cfg: GPTConfig, device=None,
                 attn_mask_type: str = "causal"):
        super().__init__()
        self.cfg = cfg
        self.attn_mask_type = _check_mask_type(attn_mask_type)
        kw = dict(dtype=cfg.dtype, device=device)
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, **kw
        )
        self.dense = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, **kw
        )

    def forward(self, x, cache=None,
                chunk: Optional[Union[ChunkRows, PagedRows]] = None,
                dropout_seed: Optional[int] = None,
                attention_mask: Optional[torch.Tensor] = None,
                kv_out: Optional[list] = None):
        """``attention_mask``: the uncached padding type's mask in the form
        its path reads, which the transformer builds once per forward: the
        additive fp32 (b, sq, sk) bias of `padding_bias` for the flash
        kernels, the bool (b|1, 1, sq|1, sk) mask itself (True = masked)
        for the fused softmax; None attends every key. ``cache``:
        the layer's view, ``(k, v, lengths)`` of a contiguous cache or
        ``(k, v, lengths, paged)`` of a paged one, ``paged`` holding
        ``page_table``, ``page_size``, the layer's ``k_scale``/``v_scale``
        (None unless int8) and ``rows``, this forward's write
        destinations. ``chunk``: the packed chunk's rows (their ``slots``
        are the segment ids; the rows that land in the cache are the
        commit destinations, which the speculative chunk splits from the
        segment ids), None for the decode and the whole-prompt prefill.
        ``kv_out``: a list the chunk path appends this layer's packed
        ``(kq, vq)`` to (the speculative chunk's deferred commit reads
        them)."""
        if cache is None:
            if self.cfg.context_parallel_axis is not None:
                return self._forward_ring(x, dropout_seed)
            mask = attention_mask if self.attn_mask_type == "padding" else None
            if self.cfg.attention_impl in ("fused_softmax", "jnp"):
                return self._forward_fused_softmax(x, dropout_seed, mask)
            if mask is None and self.cfg.head_dim % 128 == 0:
                return self._forward_packed(x, dropout_seed)
            return self._forward_unpacked(x, dropout_seed, mask)
        if self.attn_mask_type != "causal":
            raise ValueError(
                "KV-cached attention is causal-only "
                f"(got attn_mask_type={self.attn_mask_type!r})"
            )
        cfg = self.cfg
        k_buf, v_buf, lengths = cache[:3]
        paged = cache[3] if len(cache) > 3 else None
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        scale = 1.0 / math.sqrt(hd)
        b, sq, _ = x.shape
        qkv, _ = self.query_key_value(x)
        # the fused projection is interleaved PER HEAD: (b, s, nh, 3*hd)
        q, k, v = qkv.view(b, sq, nh, 3 * hd).split(hd, dim=-1)
        jnp_ref = cfg.attention_impl == "jnp"
        if chunk is not None:
            if b != 1:
                raise ValueError(
                    f"chunked prefill takes one packed stream (batch 1), "
                    f"got batch {b}"
                )
            qq, kq, vq = q[0], k[0], v[0]  # (budget, nh, hd) views
            qT, kT, vT = (t.transpose(0, 1) for t in (qq, kq, vq))
            if kv_out is not None:
                kv_out.append((kq, vq))
            if jnp_ref:
                # the chunk's K/V into the cache first; then each token
                # reads its slot's rows [0, pos + 1) back in one softmax
                if paged is not None:
                    _paged_write(k_buf, v_buf, paged, kq, vq)
                    table = paged["page_table"]
                    kc = paged_view(k_buf, table, paged["k_scale"])
                    vc = paged_view(v_buf, table, paged["v_scale"])
                else:
                    scatter_chunk(k_buf, chunk, kq)
                    scatter_chunk(v_buf, chunk, vq)
                    kc, vc = k_buf, v_buf
                if kv_out is None:
                    ctx = _reference_chunk(qq, kc, vc, chunk.slots,
                                           chunk.positions, scale)
                else:
                    # speculative rows are not in the cache (their write
                    # is the engine's deferred commit): the committed
                    # prefix [0, lengths) from the cache, the chunk's own
                    # rows from the projections (gpt.py:630-671)
                    quantized = paged is not None and (
                        paged["k_scale"] is not None)
                    ctx = _reference_chunk_spec(
                        qq, kq, vq, kc, vc, chunk.slots, chunk.positions,
                        lengths, scale, None if quantized else k_buf.dtype,
                    )
            elif paged is not None:
                # in place, through the table; then piece A within the
                # chunk and piece B over each token's own slot's pages
                _paged_write(k_buf, v_buf, paged, kq, vq)
                ctx = flash_attention_chunk_paged(
                    qT, kT, vT, chunk.slots, k_buf, v_buf,
                    paged["page_table"], lengths, scale,
                    paged["k_scale"], paged["v_scale"], paged["capacity"],
                )
            else:
                # in place: the chunk's rows land at their (slot, position)
                scatter_chunk(k_buf, chunk, kq)
                scatter_chunk(v_buf, chunk, vq)
                # (A) intra-chunk causal attention, segment-masked by slot
                o_a, lse_a = flash_attention_segments_with_lse(
                    qT, kT, vT, chunk.slots, causal=True, scale=scale,
                )
                # (B) each token against its own slot's pre-chunk prefix
                o_b, lse_b = flash_attention_decode(
                    qq, k_buf, v_buf, lengths, scale, return_lse=True,
                    slot_ids=chunk.slots,
                )
                ctx = merge_by_lse(o_a.transpose(0, 1),
                                   lse_a.transpose(0, 1), o_b, lse_b)
            ctx = ctx.to(cfg.dtype).reshape(1, sq, nh * hd)
        elif paged is not None:
            if sq != 1:
                raise ValueError(
                    "a paged cache serves single-token decode and "
                    "chunked prefill; whole-prompt prefill needs the "
                    "contiguous cache (or chunk=)"
                )
            # each slot's new row at its length, through the table; a
            # dead row sits at capacity and its write drops
            _paged_write(k_buf, v_buf, paged, k[:, 0], v[:, 0])
            table = paged["page_table"]
            capacity = table.shape[1] * paged["page_size"]
            kv_len = torch.clamp(lengths + 1, max=capacity)
            if jnp_ref:
                ctx = _reference_decode(
                    q[:, 0], paged_view(k_buf, table, paged["k_scale"]),
                    paged_view(v_buf, table, paged["v_scale"]), kv_len,
                    scale)
            else:
                ctx = flash_attention_decode_paged(
                    q[:, 0], k_buf, v_buf, table, kv_len, scale,
                    paged["k_scale"], paged["v_scale"],
                    capacity=paged["capacity"],
                )
            ctx = ctx.to(cfg.dtype).reshape(b, 1, nh * hd)
        else:
            # in place: each slot's new rows at its length, dead rows
            # included
            write_at_lengths(k_buf, lengths, k)
            write_at_lengths(v_buf, lengths, v)
            if sq != 1:
                # whole-prompt prefill: the slots start empty, so causal
                # attention over the fresh window is the whole history
                # (the cache is written, not read)
                if jnp_ref:
                    ctx = _reference_prefill(q, k, v, scale).to(cfg.dtype)
                else:
                    ctx = flash_attention_heads(
                        *(t.permute(0, 2, 1, 3) for t in (q, k, v)),
                        causal=True, scale=scale,
                    )
            else:
                kv_len = torch.clamp(lengths + 1, max=k_buf.shape[1])
                if jnp_ref:
                    ctx = _reference_decode(q[:, 0], k_buf, v_buf, kv_len,
                                            scale).to(cfg.dtype)
                else:
                    ctx = flash_attention_decode(q[:, 0], k_buf, v_buf,
                                                 kv_len, scale)
                ctx = ctx.reshape(b, 1, nh * hd)
        y, _ = self.dense(ctx)
        return y

    def _forward_packed(self, x, dropout_seed):
        """The packed path: the projection bias rides into the flash
        kernels (added on tile load; its gradient from fp32 partials)."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        qkv, bias = self.query_key_value(x, skip_bias_add=True)
        qkv = qkv.view(b, s, nh, 3 * hd)
        scale = 1.0 / math.sqrt(hd)
        causal = self.attn_mask_type == "causal"
        if dropout_seed is None:
            ctx = flash_attention_qkv_bias(qkv, bias, causal, scale)
        else:
            ctx = flash_attention_qkv_bias_dropout(
                qkv, bias, dropout_seed, cfg.attention_dropout, causal, scale,
            )
        y, _ = self.dense(ctx)
        return y

    def _forward_unpacked(self, x, dropout_seed, bias):
        """The unpacked path (gpt.py:952-1004): the projection adds its own
        bias; q/k/v are the per-head column blocks of its (b, s, nh, 3*hd)
        output, passed to the kernels as (b, nh, s, hd) views; the padding
        type adds ``bias`` (or none: full bidirectional), the causal type
        masks in-kernel. Attention dropout with a seed, in-kernel."""
        cfg = self.cfg
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        qkv, _ = self.query_key_value(x)
        q, k, v = (t.permute(0, 2, 1, 3) for t in
                   qkv.view(b, s, nh, 3 * hd).split(hd, dim=-1))
        ctx = flash_attention_heads(
            q, k, v, bias, causal=self.attn_mask_type == "causal",
            scale=1.0 / math.sqrt(hd), dropout_seed=dropout_seed,
            dropout_rate=cfg.attention_dropout,
        )
        y, _ = self.dense(ctx)
        return y

    def _forward_ring(self, x, dropout_seed):
        """Context parallelism (gpt.py:958-966): x is this rank's sequence
        shard; the causal attention of the per-head q/k/v column blocks,
        as contiguous (b*nh, s_local, hd) shards, is the ring over the
        unpacked kernels. The JAX model's refusals, with its message
        (gpt.py:476-486)."""
        cfg = self.cfg
        if (cfg.attention_impl != "flash" or self.attn_mask_type != "causal"
                or dropout_seed is not None):
            # attending within the local shard only would be a wrong
            # model; context parallelism rides the ring-flash path
            raise ValueError(
                "context_parallel_axis requires attention_impl='flash', "
                "causal masking, and attention_dropout=0 in training "
                f"(got impl={cfg.attention_impl!r}, "
                f"mask={self.attn_mask_type!r}, "
                f"attn_dropout={cfg.attention_dropout})"
            )
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        qkv, _ = self.query_key_value(x)
        q, k, v = (t.permute(0, 2, 1, 3).reshape(b * nh, s, hd) for t in
                   qkv.view(b, s, nh, 3 * hd).split(hd, dim=-1))
        ctx = ring_flash_attention(q, k, v, cfg.context_parallel_axis,
                                   causal=True, scale=1.0 / math.sqrt(hd))
        ctx = ctx.view(b, nh, s, hd).permute(0, 2, 1, 3).reshape(b, s, nh * hd)
        y, _ = self.dense(ctx)
        return y

    def _forward_fused_softmax(self, x, dropout_seed, mask):
        """The materialized path (gpt.py:1010-1053): fp32 scores of the
        per-head q/k column blocks (`ScoresFp32`), the scaled softmax
        (the causal kernel on (b*nh, s, s); the padding type's masked
        kernel with ``mask``, or a plain fp32 softmax without one; with
        ``use_pallas_softmax=False``, and always under ``"jnp"``, a plain
        softmax with -inf fills), the probabilities in the compute dtype,
        their dropout with a seed, then probs·v in the compute dtype."""
        cfg = self.cfg
        use_kernel = cfg.use_pallas_softmax and cfg.attention_impl != "jnp"
        b, s, _ = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        scale = 1.0 / math.sqrt(hd)
        qkv, _ = self.query_key_value(x)
        q, k, v = (t.permute(0, 2, 1, 3) for t in
                   qkv.view(b, s, nh, 3 * hd).split(hd, dim=-1))
        scores = ScoresFp32.apply(q, k)  # (b, nh, s, s) fp32
        if self.attn_mask_type == "causal":
            if use_kernel:
                probs = scaled_upper_triang_masked_softmax(
                    scores.view(b * nh, s, s), scale).view(b, nh, s, s)
            else:
                upper = torch.ones(s, s, dtype=torch.bool,
                                   device=x.device).triu(1)
                probs = torch.softmax(
                    (scores * scale).masked_fill(upper, float("-inf")), -1)
        elif mask is None:
            probs = torch.softmax(scores * scale, dim=-1)
        elif use_kernel:
            probs = scaled_masked_softmax(scores, mask, scale)
        else:
            probs = torch.softmax(
                (scores * scale).masked_fill(mask, float("-inf")), -1)
        probs = probs.to(cfg.dtype)
        if dropout_seed is not None:
            probs = _dropout(probs, dropout_seed, cfg.attention_dropout)
        ctx = torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(b, s, nh * hd)
        y, _ = self.dense(ctx)
        return y


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: LN -> attention -> residual (fused into LN2) -> MLP
    -> residual. The uncached path CHAINS layers: it takes the previous
    layer's pending MLP delta (added inside ln1) and returns
    ``(stream, pending delta)``; cached paths add eagerly."""

    def __init__(self, cfg: GPTConfig, device=None,
                 attn_mask_type: str = "causal"):
        super().__init__()
        self.cfg = cfg
        ln = dict(eps=cfg.layernorm_epsilon, params_dtype=cfg.params_dtype,
                  device=device)
        self.input_layernorm = MixedFusedLayerNorm(cfg.hidden_size, **ln)
        self.self_attention = ParallelAttention(cfg, device, attn_mask_type)
        self.post_attention_layernorm = MixedFusedLayerNorm(
            cfg.hidden_size, **ln
        )
        self.mlp = ParallelMLP(cfg, device)

    def forward(self, x, cache=None, chunk: Optional[ChunkRows] = None,
                kv_out: Optional[list] = None):
        ln1 = self.input_layernorm(x)
        attn = self.self_attention(ln1, cache, chunk, kv_out=kv_out)
        ln2, x = self.post_attention_layernorm(attn.to(x.dtype), residual=x)
        mlp = self.mlp(ln2)
        return (x + mlp.to(x.dtype)).to(self.cfg.dtype)

    def forward_chained(self, x, delta=None,
                        seeds: Optional[torch.Generator] = None,
                        attention_mask: Optional[torch.Tensor] = None):
        """One training layer: with a ``seeds`` generator, hidden dropout
        drops the attention output inside ln2 and the incoming delta
        inside ln1, and attention dropout runs in the flash kernels (on
        the probabilities, under ``"fused_softmax"``). ``attention_mask``
        as `ParallelAttention.forward` takes it."""
        cfg = self.cfg
        hrate = cfg.hidden_dropout if seeds is not None else 0.0

        def hseed():
            return hidden_dropout_seed(seeds, cfg) if hrate > 0.0 else 0

        if delta is None:
            ln1 = self.input_layernorm(x)
        else:
            ln1, x = self.input_layernorm(
                delta.to(x.dtype), residual=x, dropout_rate=hrate,
                dropout_seed=hseed(),
            )
        attn_seed = (_draw_seed(seeds) if seeds is not None
                     and cfg.attention_dropout > 0.0 else None)
        attn = self.self_attention(ln1, dropout_seed=attn_seed,
                                   attention_mask=attention_mask)
        ln2, x = self.post_attention_layernorm(
            attn.to(x.dtype), residual=x, dropout_rate=hrate,
            dropout_seed=hseed(),
        )
        mlp = self.mlp(ln2)
        return x.to(cfg.dtype), mlp.to(cfg.dtype)


class ParallelTransformer(nn.Module):
    """``num_layers`` blocks (``layer_0`` ...) and the final LayerNorm."""

    def __init__(self, cfg: GPTConfig, device=None,
                 attn_mask_type: str = "causal"):
        super().__init__()
        self.cfg = cfg
        self.attn_mask_type = _check_mask_type(attn_mask_type)
        self.layer_names = [f"layer_{i}" for i in range(cfg.num_layers)]
        for name in self.layer_names:
            self.add_module(name, ParallelTransformerLayer(cfg, device,
                                                           attn_mask_type))
        self.final_layernorm = MixedFusedLayerNorm(
            cfg.hidden_size, eps=cfg.layernorm_epsilon,
            params_dtype=cfg.params_dtype, device=device,
        )

    def forward(self, x, cache=None,
                chunk: Optional[Union[ChunkRows, PagedRows]] = None,
                seeds: Optional[torch.Generator] = None,
                rows: Optional[PagedRows] = None, attention_mask=None,
                kv_out: Optional[list] = None):
        """``rows``: a paged cache's write destinations for this forward
        (the chunk's, or the decode grid's). ``attention_mask``: the
        uncached path's padding mask, True = masked (read by the padding
        type only, as in the JAX model). ``kv_out``: collects each
        layer's packed chunk ``(kq, vq)``."""
        if cache is None:
            return self._forward_chained(x, seeds, attention_mask)
        if attention_mask is not None:
            raise ValueError("the KV-cached paths take no attention_mask")
        for i, name in enumerate(self.layer_names):
            layer_cache = (cache.k[i], cache.v[i], cache.lengths)
            if rows is not None:
                # a paged cache (duck-typed: .page_table, .page_size,
                # .host_capacity, .k_scale/.v_scale) adds the table view
                # per layer; its reads bound and split their keys on the
                # capacity the cache was made for, as the contiguous
                # cache's reads do on theirs
                layer_cache += (dict(
                    page_table=cache.page_table,
                    page_size=cache.page_size,
                    capacity=cache.host_capacity,
                    k_scale=(None if cache.k_scale is None
                             else cache.k_scale[i]),
                    v_scale=(None if cache.v_scale is None
                             else cache.v_scale[i]),
                    rows=rows,
                ),)
            x = getattr(self, name)(x, layer_cache, chunk, kv_out)
        x = self.final_layernorm(x).to(self.cfg.dtype)
        if chunk is None:
            # every layer wrote at the same offsets: advance once, for
            # all slots (the engine pins inactive slots afterwards); the
            # chunk path leaves the cursors to the engine
            cache.lengths = torch.clamp(
                cache.lengths + x.shape[1], max=cache.capacity
            )
        return x

    def _forward_chained(self, x, seeds, attention_mask=None):
        # the padding type's mask in the form its attention reads, built
        # once for every layer: the bool mask for the fused softmax, the
        # additive bias for the flash kernels
        mask = None
        if attention_mask is not None and self.attn_mask_type == "padding":
            mask = attention_mask.to(torch.bool)
            if self.cfg.attention_impl == "flash":
                mask = padding_bias(mask, x.shape[0], x.shape[1])
        delta = None
        for name in self.layer_names:
            x, delta = getattr(self, name).forward_chained(
                x, delta, seeds, mask)
        if delta is None:
            return self.final_layernorm(x).to(self.cfg.dtype)
        # the last layer's pending delta joins the stream (and takes its
        # hidden dropout) inside the final LN
        rate = self.cfg.hidden_dropout if seeds is not None else 0.0
        x, _ = self.final_layernorm(
            delta.to(x.dtype), residual=x, dropout_rate=rate,
            dropout_seed=hidden_dropout_seed(seeds, self.cfg)
            if rate > 0.0 else 0,
        )
        return x.to(self.cfg.dtype)


class TransformerEmbedding(nn.Module):
    """Word + learned position embeddings, summed in the compute dtype;
    ``attend`` is the tied LM head, ``attend_loss`` the tied head fused
    with the cross-entropy."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype, device=device,
        )
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size,
                        dtype=cfg.dtype, device=device)
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

    def attend_loss(self, hidden, labels, loss_mask=None, reduction=None):
        cfg = self.cfg
        return self.word_embeddings.attend_loss(
            hidden, labels, loss_mask, reduction, cfg.label_smoothing,
            cfg.ignore_index, cfg.lm_head_chunk_size,
        )


class GPTModel(nn.Module):
    """Embedding -> transformer -> tied LM head.

    Uncached (``cache=None``): ``tokens`` (b, s) -> logits (b, s, vocab),
    or with ``labels`` the per-token fp32 losses (times ``loss_mask``),
    or with ``loss_reduction="mean"`` their masked mean, whose head
    gradients finish in the forward (the training path). Differentiable;
    ``deterministic=False`` turns dropout on, seeded per site from
    ``dropout_generator`` (a CPU `torch.Generator`).

    Cached: ``cache`` is a `rocm_apex_tpu_torch.inference.KVCache`
    (duck-typed: ``.k``/``.v`` per-layer ``(num_slots, capacity, heads,
    head_dim)`` buffers, ``.lengths``, ``.capacity``) or a `PagedKVCache`
    (its pools, ``.page_table``, ``.page_size``, scales); the forward UPDATES
    IT IN PLACE and returns ``(logits, cache)``. ``tokens`` (num_slots, 1)
    is the single-token decode: positions default to each slot's length
    and ``lengths`` advance by one. ``chunk=(slot_ids, positions)`` with
    ``tokens`` (1, budget) is the packed chunk: padding tokens carry slot
    id ``num_slots``, and ``lengths`` (each slot's pre-chunk prefix) are
    not advanced. The speculative chunk ``chunk=(slot_ids, positions,
    commit_slots)`` (gpt.py:519-590) splits who attends from who
    commits: attention follows ``slot_ids``, the K/V writes follow
    ``commit_slots`` (a row carrying ``num_slots`` there is not written),
    and the forward returns ``(logits, cache, chunk_kv)``, ``chunk_kv``
    being ``(ks, vs)``, each layer's packed ``(budget, heads, head_dim)``
    chunk K and V, for the engine's commit of the accepted rows.
    ``rows``: the write destinations, resolved by the caller (the engine
    resolves them on the host, so the forward reads no device value):
    the chunk's (its ``slots`` the segment ids), or a paged cache's
    decode grid's; None resolves them here. Runs on CUDA unless
    ``device`` says otherwise.
    """

    def __init__(self, cfg: GPTConfig,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embedding = TransformerEmbedding(cfg, self.device)
        self.transformer = ParallelTransformer(cfg, self.device)

    def forward(
        self,
        tokens: torch.Tensor,
        position_ids: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        loss_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        cache=None,
        chunk: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        loss_reduction: Optional[str] = None,
        dropout_generator: Optional[torch.Generator] = None,
        rows: Optional[Union[ChunkRows, PagedRows]] = None,
    ):
        if cache is not None:
            if labels is not None:
                raise ValueError(
                    "KV-cached inference returns logits; pass labels only "
                    "on the training path"
                )
            if not deterministic:
                raise ValueError(
                    "KV-cached attention requires deterministic=True"
                )
            with torch.no_grad():
                return self._forward_cached(tokens, position_ids, cache,
                                            chunk, rows)
        if chunk is not None:
            raise ValueError(
                "chunked prefill writes into a KV cache; pass cache= "
                "alongside chunk="
            )
        if loss_reduction not in (None, "mean"):
            raise ValueError(f"unknown loss_reduction {loss_reduction!r}")
        cfg = self.cfg
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
            rank = _cp_rank(cfg)
            if rank is not None:
                # this rank's shard of the sequence starts here
                position_ids = position_ids + rank * tokens.shape[1]
        seeds = None
        if not deterministic:
            seeds = dropout_generator or torch.default_generator
        x = self.embedding(tokens, position_ids)
        if seeds is not None and cfg.hidden_dropout > 0.0:
            x = _dropout(x, hidden_dropout_seed(seeds, cfg),
                         cfg.hidden_dropout)
        x = self.transformer(x, seeds=seeds)
        if labels is None:
            return self.embedding.attend(x)
        if cfg.fused_lm_head:
            if loss_reduction == "mean":
                return self.embedding.attend_loss(x, labels, loss_mask,
                                                  "mean")
            losses = self.embedding.attend_loss(x, labels)
        else:
            # the materialized head: the logits stay in the compute dtype
            # and the kernel widens them row by row
            losses = _serial_cross_entropy(
                self.embedding.attend(x), labels, cfg.label_smoothing,
                cfg.ignore_index,
            )
            if loss_reduction == "mean":
                return gpt_loss_fn(losses, loss_mask)
        if loss_mask is not None:
            losses = losses * loss_mask
        return losses

    def _forward_cached(self, tokens, position_ids, cache, chunk, rows=None):
        paged = getattr(cache, "page_table", None) is not None
        kv_out = None
        if chunk is not None:
            if tokens.shape[0] != 1:
                raise ValueError("chunked prefill takes tokens of shape (1, budget)")
            slots, positions = chunk[0], chunk[1]
            commit = slots
            if len(chunk) == 3:
                commit, kv_out = chunk[2], []
            if rows is None:
                if paged:
                    rows = paged_rows(cache.page_table, commit, positions,
                                      cache.page_size, cache.num_pages)
                else:
                    rows = chunk_rows(commit, positions, cache.num_slots,
                                      cache.capacity)
                # the segment ids stay the attending slots
                rows = rows._replace(slots=slots)
            if position_ids is None:
                position_ids = positions[None, :]
        else:
            if tokens.shape[1] != 1 and paged:
                raise ValueError(
                    "a paged cache serves single-token decode and "
                    "chunked prefill; whole-prompt prefill needs the "
                    "contiguous cache (or chunk=)"
                )
            if position_ids is None:
                position_ids = cache.lengths[:, None] + torch.arange(
                    tokens.shape[1], device=tokens.device
                )
            if paged and rows is None:
                # every slot writes at its length; a dead row sits at
                # capacity and drops
                slots = torch.arange(cache.num_slots, dtype=torch.int32,
                                     device=tokens.device)
                rows = paged_rows(cache.page_table, slots, cache.lengths,
                                  cache.page_size, cache.num_pages)
        x = self.embedding(tokens, position_ids)
        x = self.transformer(x, cache, rows if chunk is not None else None,
                             rows=rows if paged else None, kv_out=kv_out)
        if kv_out is not None:
            chunk_kv = ([k for k, _ in kv_out], [v for _, v in kv_out])
            return self.embedding.attend(x), cache, chunk_kv
        return self.embedding.attend(x), cache


def _bounded_softmax(scores, live):
    """softmax over the last axis of fp32 scores, -inf where not live."""
    return torch.softmax(scores.masked_fill(~live, float("-inf")), dim=-1)


def _reference_chunk(qq, kc, vc, slots, positions, scale):
    """`attention_impl="jnp"` on the packed chunk (gpt.py:589-640): token
    t (query (budget, nh, hd)) attends its own slot's cache rows ``[0,
    pos + 1)`` (the chunk's rows already written) in one fp32 softmax.
    The slot rides a one-hot contraction over the (num_slots, capacity,
    nh, hd) cache, as in JAX: the product with every slot's rows, then
    the one-hot sum over slots (a pad's id clamps onto the last slot).
    Returns the (budget, nh, hd) fp32 context."""
    num_slots, capacity = kc.shape[0], kc.shape[1]
    slot_c = slots.long().clamp(0, num_slots - 1)
    onehot = (slot_c[:, None] == torch.arange(
        num_slots, device=qq.device)[None, :]).float()  # (budget, slots)
    prod = torch.einsum("tnd,scnd->tnsc", qq.float(), kc.float())
    scores = torch.einsum("tnsc,ts->tnc", prod, onehot) * scale
    col = torch.arange(capacity, device=qq.device)
    live = col[None, None, :] < (positions.long() + 1)[:, None, None]
    probs = _bounded_softmax(scores, live)
    spread = torch.einsum("tnc,ts->tnsc", probs, onehot)
    return torch.einsum("tnsc,scnd->tnd", spread, vc.float())


def _reference_chunk_spec(qq, kq, vq, kc, vc, slots, positions, lengths,
                          scale, cache_dtype):
    """`attention_impl="jnp"` on the speculative chunk (gpt.py:630-671):
    token t attends its slot's COMMITTED cache rows ``[0, lengths[slot])``
    and, from the packed projections, the chunk rows of its own slot at
    positions <= its own, under one fp32 softmax over the concatenated
    axis. ``cache_dtype``: the float cache's dtype, through which the
    chunk's K/V round-trip (their bytes as a read of scattered rows would
    give them); None for int8 pages, where the raw projection is read.
    Returns the (budget, nh, hd) fp32 context."""
    num_slots, capacity = kc.shape[0], kc.shape[1]
    slot_c = slots.long().clamp(0, num_slots - 1)
    onehot = (slot_c[:, None] == torch.arange(
        num_slots, device=qq.device)[None, :]).float()
    prod = torch.einsum("tnd,scnd->tnsc", qq.float(), kc.float())
    scores = torch.einsum("tnsc,ts->tnc", prod, onehot) * scale
    col = torch.arange(capacity, device=qq.device)
    bound = lengths.long()[slot_c]
    scores = scores.masked_fill(
        ~(col[None, None, :] < bound[:, None, None]), float("-inf"))
    if cache_dtype is not None:
        kb = kq.to(cache_dtype).float()
        vb = vq.to(cache_dtype).float()
    else:
        kb, vb = kq.float(), vq.float()
    scores_b = torch.einsum("tnd,jnd->tnj", qq.float(), kb) * scale
    intra = ((slots[None, :] == slots[:, None])
             & (positions[None, :] <= positions[:, None]))
    scores_b = scores_b.masked_fill(~intra[:, None, :], float("-inf"))
    probs = torch.softmax(torch.cat([scores, scores_b], dim=-1), dim=-1)
    spread = torch.einsum("tnc,ts->tnsc", probs[..., :capacity], onehot)
    return (torch.einsum("tnsc,scnd->tnd", spread, vc.float())
            + torch.einsum("tnj,jnd->tnd", probs[..., capacity:], vb))


def _reference_decode(q, kc, vc, kv_len, scale):
    """`attention_impl="jnp"` on the single-token decode (gpt.py:
    810-880): each slot's query (slots, nh, hd) over its cache rows
    ``[0, kv_len)`` (kc, vc (slots, capacity, nh, hd), contiguous or a
    paged view), one fp32 softmax; the (slots, nh, hd) fp32 context."""
    capacity = kc.shape[1]
    scores = torch.einsum("bnd,bcnd->bnc", q.float(), kc.float()) * scale
    col = torch.arange(capacity, device=q.device)
    live = col[None, None, :] < kv_len.long()[:, None, None]
    probs = _bounded_softmax(scores, live)
    return torch.einsum("bnc,bcnd->bnd", probs, vc.float())


def _reference_prefill(q, k, v, scale):
    """`attention_impl="jnp"` on the whole-prompt prefill (gpt.py:
    896-910): causal attention over the (b, s, nh, hd) window in one fp32
    softmax; the (b, s, nh * hd) fp32 context."""
    b, s, nh, hd = q.shape
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    live = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = _bounded_softmax(scores, live)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, v.float())
    return ctx.reshape(b, s, nh * hd)


def _serial_cross_entropy(logits, labels, smoothing=0.0, padding_idx=None):
    """The materialized head's loss: per-token fp32 losses of (b, s, vocab)
    logits through the cross-entropy kernel on the (b*s, vocab) view,
    with no fp32 copy of the logits. Differentiation emits the logits'
    gradient during the forward read (`softmax_cross_entropy_loss_fused`)."""
    b, s, v = logits.shape
    losses = softmax_cross_entropy_loss_fused(
        logits.reshape(b * s, v), labels.reshape(b * s), smoothing,
        padding_idx,
    )
    return losses.reshape(b, s)


def gpt_loss_fn(losses, loss_mask=None):
    """Mean per-token loss; with a mask, sum(losses * mask) / max(sum(mask), 1)."""
    if loss_mask is not None:
        return (losses * loss_mask).sum() / torch.clamp(loss_mask.sum(),
                                                        min=1)
    return losses.mean()
