"""Flash attention: the KV-cache decode read and the packed-QKV training
attention, each a hand-written CUDA kernel beside its plain PyTorch
version.

**Packed QKV** (``flash_attention_qkv{,_bias}{,_dropout}``, the forms
models/gpt.py:919-951 of the JAX package calls). The forward kernel
(``csrc/flash_fwd.cu``) replaces ``_fwd_single_kernel``
(rocm_apex_tpu/ops/flash_attention.py:1170) and the packed use of
``_fwd_kernel`` (:170); the backward (``csrc/flash_bwd.cu``, a dq pass and
a dk/dv pass) replaces ``_bwd_merged_kernel`` (:1324) and the packed use
of ``_bwd_dkv_kernel``/``_bwd_dq_kernel`` (:316, :384). q/k/v are read
straight out of the (B, S, nh, 3*hd) projection with the bias added on
load, the context is written in (B, S, nh*hd), and the backward writes
dq|dk|dv into the projection's own layout with fp32 bias partials summed
over batch in fp32. Dropout drops the normalized probabilities (softmax
-> dropout -> @ v, the normalizer from the undropped ones) with
``ops/_dropout``'s keep bits of (seed, b*nh + h, query, key), regenerated
in the backward. One forward and one backward kernel serve all four
entries: no bias is a null pointer, no dropout is rate 0. The kernels
take head_dim 128 (the packed path's hd % 128 rule at the model's
widths); they are bound by operations: bf16 runs the products on the
tensor cores (mma.sync, the computed operands split hi + lo so they keep
fp32-level precision), fp32 on the CUDA cores (see the sources).

**Decode** (``flash_attention_decode``).
The kernel (``csrc/flash_decode.cu``) replaces the TPU kernel
``_decode_kernel`` (rocm_apex_tpu/ops/flash_attention.py:813). It is
bound by bytes (2 FLOPs per K/V byte). Two departures from the JAX call
form, both to move fewer bytes:

* the cache is read IN PLACE from its ``(num_slots, capacity, heads,
  head_dim)`` layout through strides; the JAX model transposes the whole
  cache into ``(slots*heads, capacity, head_dim)`` every layer of every
  tick (models/gpt.py:716-723, 862-870);
* each query row names the slot it reads (``slot_ids``), so a chunk
  token reads only its own slot's prefix; the JAX model broadcasts the
  whole chunk against every slot and keeps one slot's answer per token
  (models/gpt.py:724-736), num_slots times the work.

The semantics per row are those of the JAX function: online softmax over
keys ``[0, kv_lengths[slot])`` (a row never reads past its bound), a
natural-log lse, and zeros with lse = -1e30 for a row with an empty
prefix, so an lse merge weighs it to zero.

**Paged decode** (``flash_attention_decode_paged``). The same read
through a block table over page pools (``inference/paging.py``): the
kernel (``csrc/flash_decode_paged.cu``) replaces ``_decode_paged_kernel``
(rocm_apex_tpu/ops/flash_attention.py:950), with two launch counters, one
for float pools (``FLASH_DECODE_PAGED``) and one for int8 pools with
per-(page, head) fp32 scales (``FLASH_DECODE_PAGED_INT8``). It keeps the
per-row slot read and the ``(rows, heads, head_dim)`` query layout of
``flash_attention_decode``, where the JAX function takes ``(slots*heads,
t, head_dim)`` and the chunk path broadcasts every token to every slot.
An int8 key or value is dequantized as the JAX kernel does it, ``(float(x)
* scale)`` rounded to q's dtype.
"""

import ctypes
import math
from typing import Optional

import torch

from rocm_apex_tpu_torch.ops import _dropout
from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr
from rocm_apex_tpu_torch.ops.paging import paged_view

__all__ = [
    "FLASH_DECODE",
    "FLASH_DECODE_PAGED",
    "FLASH_DECODE_PAGED_INT8",
    "FLASH_FWD",
    "FLASH_BWD",
    "NEG_INF",
    "flash_attention_decode",
    "flash_attention_decode_plain",
    "flash_attention_decode_paged",
    "flash_attention_decode_paged_plain",
    "flash_attention_qkv",
    "flash_attention_qkv_dropout",
    "flash_attention_qkv_bias",
    "flash_attention_qkv_bias_dropout",
    "flash_qkv_fwd_plain",
    "flash_qkv_bwd_plain",
    "check_head_dim",
]

NEG_INF = -1e30
_SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
FLASH_DECODE = Kernel(
    name="flash_attention_decode",
    source="flash_decode.cu",
    symbol="flash_decode",
    argtypes=[_P, _I64, _I64, _P, _P, _I64, _I64, _I64, _P, _P, _I, _I, _I,
              _I, _I, ctypes.c_float, _I, _P, _P, _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:813 _decode_kernel",
)
_PAGED_ARGS = [_I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P]
FLASH_DECODE_PAGED = Kernel(
    name="flash_attention_decode_paged",
    source="flash_decode_paged.cu",
    symbol="flash_decode_paged",
    argtypes=[_P, _I64, _I64, _P, _P, _P, _P, _P] + _PAGED_ARGS,
    replaces="rocm_apex_tpu/ops/flash_attention.py:950 _decode_paged_kernel",
)
FLASH_DECODE_PAGED_INT8 = Kernel(
    name="flash_attention_decode_paged_int8",
    source="flash_decode_paged.cu",
    symbol="flash_decode_paged_int8",
    argtypes=[_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P] + _PAGED_ARGS,
    replaces="rocm_apex_tpu/ops/flash_attention.py:950 _decode_paged_kernel",
)
_U = ctypes.c_uint32
_F = ctypes.c_float
FLASH_FWD = Kernel(
    name="flash_attention_qkv_fwd",
    source="flash_fwd.cu",
    symbol="flash_fwd",
    argtypes=[_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _U, _U, _F, _I,
              _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:1170 _fwd_single_kernel",
)
FLASH_BWD = Kernel(
    name="flash_attention_qkv_bwd",
    source="flash_bwd.cu",
    symbol="flash_bwd",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
              _U, _U, _F, _I, _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:1324 _bwd_merged_kernel",
)
_PACKED_HEAD_DIM = 128  # csrc/flash_tile.cuh kHd
_PACKED_TILE = 64  # csrc/flash_tile.cuh kTile


def check_head_dim(*tensors: torch.Tensor) -> None:
    """The kernels' layout contract: head_dim in 32/64/128/256, unit
    stride on the last dim, every other stride and the base address
    aligned to one lane's vector (head_dim/32 elements)."""
    d = tensors[0].shape[-1]
    if d not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"the CUDA attention kernels take head_dim in "
            f"{_SUPPORTED_HEAD_DIMS}, got {d}"
        )
    vec = d // 32
    for t in tensors:
        if t.stride(-1) != 1:
            raise ValueError("attention operands need a unit head_dim stride")
        if any(s % vec for s in t.stride()[:-1]) or (
            t.data_ptr() % (vec * t.element_size())
        ):
            raise ValueError(
                "attention operands must be aligned to head_dim/32 elements"
            )


def flash_attention_decode_plain(q, k_cache, v_cache, kv_lengths, scale,
                                 slot_ids=None):
    """The plain PyTorch version: returns (o, lse), o in q's dtype."""
    rows, heads, d = q.shape
    num_slots, capacity = k_cache.shape[:2]
    dev = q.device
    slots = (
        torch.arange(rows, device=dev) if slot_ids is None
        else slot_ids.to(device=dev, dtype=torch.long)
    )
    valid = (slots >= 0) & (slots < num_slots)
    bound = torch.where(
        valid,
        kv_lengths.to(device=dev, dtype=torch.long)[slots.clamp(0, num_slots - 1)]
        .clamp(0, capacity),
        0,
    )
    o = torch.zeros((rows, heads, d), dtype=torch.float32, device=dev)
    lse = torch.full((rows, heads), NEG_INF, dtype=torch.float32, device=dev)
    col = torch.arange(capacity, device=dev)
    for s in range(num_slots):
        idx = torch.nonzero((slots == s) & (bound > 0)).squeeze(1)
        if idx.numel() == 0:
            continue
        qs = q[idx].float()
        scores = torch.einsum(
            "nhd,chd->nhc", qs, k_cache[s].float()
        ) * scale
        live = col[None, None, :] < bound[idx][:, None, None]
        scores = scores.masked_fill(~live, float("-inf"))
        l = torch.logsumexp(scores, dim=-1)
        p = torch.exp(scores - l[..., None])
        o[idx] = torch.einsum("nhc,chd->nhd", p, v_cache[s].float())
        lse[idx] = l
    return o.to(q.dtype), lse


def flash_attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
    slot_ids: Optional[torch.Tensor] = None,
):
    """Query rows against a preallocated KV cache.

    ``q`` is (rows, heads, head_dim); ``k_cache``/``v_cache`` are
    (num_slots, capacity, heads, head_dim) cache buffers; ``kv_lengths``
    (num_slots,) int32 bounds each slot's live prefix. Row r reads slot
    ``slot_ids[r]`` (default: slot r — the decode grid); a slot id
    outside ``[0, num_slots)`` (chunk padding) reads nothing. Returns o
    (rows, heads, head_dim) in q's dtype, and with ``return_lse`` also
    the natural-log lse (rows, heads) in fp32. Forward only.
    """
    rows, heads, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("k/v caches must both be (slots, capacity, heads, dim)")
    num_slots, capacity, c_heads, c_d = k_cache.shape
    if (c_heads, c_d) != (heads, d):
        raise ValueError(
            f"cache heads/dim {(c_heads, c_d)} != query {(heads, d)}"
        )
    if slot_ids is None and rows != num_slots:
        raise ValueError("without slot_ids there is one query row per slot")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        o, lse = flash_attention_decode_plain(
            q, k_cache, v_cache, kv_lengths, scale, slot_ids
        )
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q and the cache must share one dtype")
    if k_cache.stride() != v_cache.stride():
        raise ValueError("k and v caches must share one layout")
    for t in (k_cache, v_cache, kv_lengths, slot_ids):
        if t is not None and t.device != q.device:
            raise ValueError("all operands must be on q's device")
    for t in (kv_lengths, slot_ids):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise TypeError("kv_lengths/slot_ids must be contiguous int32")
    if slot_ids is not None and slot_ids.shape != (rows,):
        raise ValueError("slot_ids must be (rows,)")
    if kv_lengths.shape != (num_slots,):
        raise ValueError("kv_lengths must be (num_slots,)")
    check_head_dim(q, k_cache, v_cache)
    o = torch.empty((rows, heads, d), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((rows, heads), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    if rows > 0:
        FLASH_DECODE(
            ptr(q), q.stride(0), q.stride(1), ptr(k_cache), ptr(v_cache),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            ptr(kv_lengths), ptr(slot_ids), rows, heads, d, num_slots,
            capacity, float(scale), dtype_code(q.dtype), ptr(o), ptr(lse),
            stream_ptr(q.device),
        )
    return (o, lse) if return_lse else o


def flash_attention_decode_paged_plain(q, k_pool, v_pool, page_table,
                                       kv_lengths, scale, k_scale=None,
                                       v_scale=None, slot_ids=None):
    """The plain PyTorch version: the pools gathered through the table
    (int8 dequantized and rounded to q's dtype), then
    `flash_attention_decode_plain`. Returns (o, lse)."""
    k = paged_view(k_pool, page_table, k_scale, out_dtype=q.dtype)
    v = paged_view(v_pool, page_table, v_scale, out_dtype=q.dtype)
    return flash_attention_decode_plain(q, k, v, kv_lengths, scale, slot_ids)


def flash_attention_decode_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    kv_lengths: torch.Tensor,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    return_lse: bool = False,
    slot_ids: Optional[torch.Tensor] = None,
):
    """`flash_attention_decode` reading through a block table.

    ``q`` is (rows, heads, head_dim); ``k_pool``/``v_pool`` are the page
    pools (num_pages, heads, page_size, head_dim); ``page_table`` is
    (num_slots, pages_per_slot) int32, unmapped entries holding the
    sentinel ``num_pages``; ``kv_lengths`` (num_slots,) int32 bounds each
    slot's prefix, at most ``pages_per_slot * page_size``. Row r reads
    slot ``slot_ids[r]`` (default: slot r); a slot id outside ``[0,
    num_slots)`` reads nothing. ``k_scale``/``v_scale`` ((num_pages,
    heads) fp32) mark int8 pools. Returns o (rows, heads, head_dim) in
    q's dtype, and with ``return_lse`` the natural-log lse (rows, heads)
    fp32. Forward only.
    """
    rows, heads, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            "k/v pools must both be (num_pages, heads, page_size, dim)"
        )
    num_pages, p_heads, page_size, p_d = k_pool.shape
    if (p_heads, p_d) != (heads, d):
        raise ValueError(f"pool heads/dim {(p_heads, p_d)} != query "
                         f"{(heads, d)}")
    num_slots, pages_per_slot = page_table.shape
    if slot_ids is None and rows != num_slots:
        raise ValueError("without slot_ids there is one query row per slot")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        o, lse = flash_attention_decode_paged_plain(
            q, k_pool, v_pool, page_table, kv_lengths, scale, k_scale,
            v_scale, slot_ids,
        )
        return (o, lse) if return_lse else o
    if q.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {q.device}")
    pool_dtype = torch.int8 if quantized else q.dtype
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(
            f"the pools must be {pool_dtype} for {q.dtype} queries"
            f"{' with scales' if quantized else ''}, got {k_pool.dtype}"
        )
    for t in (k_pool, v_pool, page_table, kv_lengths, slot_ids, k_scale,
              v_scale):
        if t is not None and t.device != q.device:
            raise ValueError("all operands must be on q's device")
        if t is not None and not t.is_contiguous():
            raise ValueError("pools, table, lengths, slot ids and scales "
                             "must be contiguous")
    for t in (page_table, kv_lengths, slot_ids):
        if t is not None and t.dtype != torch.int32:
            raise TypeError("page_table/kv_lengths/slot_ids must be int32")
    if quantized and any(
        s.dtype != torch.float32 or s.shape != (num_pages, heads)
        for s in (k_scale, v_scale)
    ):
        raise ValueError(f"k/v scales must be ({num_pages}, {heads}) fp32")
    if slot_ids is not None and slot_ids.shape != (rows,):
        raise ValueError("slot_ids must be (rows,)")
    if kv_lengths.shape != (num_slots,):
        raise ValueError("kv_lengths must be (num_slots,)")
    if num_pages * heads * page_size >= 2**31:
        raise ValueError("the kernel indexes pool rows with 32-bit ints")
    check_head_dim(q, k_pool, v_pool)
    o = torch.empty((rows, heads, d), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((rows, heads), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    if rows > 0:
        pools = (ptr(k_pool), ptr(v_pool))
        if quantized:
            kernel, pools = FLASH_DECODE_PAGED_INT8, pools + (
                ptr(k_scale), ptr(v_scale))
        else:
            kernel = FLASH_DECODE_PAGED
        kernel(
            ptr(q), q.stride(0), q.stride(1), *pools, ptr(page_table),
            ptr(kv_lengths), ptr(slot_ids), rows, heads, d, num_slots,
            pages_per_slot, page_size, num_pages, float(scale),
            dtype_code(q.dtype), ptr(o), ptr(lse), stream_ptr(q.device),
        )
    return (o, lse) if return_lse else o


# ---------------------------------------------------------------------------
# packed QKV: training attention
# ---------------------------------------------------------------------------


def _heads(qkv, bias):
    """Biased q, k, v as fp32 (B*nh, S, hd) from the (B, S, nh, 3*hd)
    projection; the biased values are rounded to qkv's dtype, as the JAX
    kernels' add in that dtype rounds them (and the kernels stage them)."""
    B, S, nh, three_hd = qkv.shape
    hd = three_hd // 3
    x = qkv.float()
    if bias is not None:
        x = (x + bias.float().view(nh, three_hd)).to(qkv.dtype).float()
    x = x.permute(0, 2, 1, 3).reshape(B * nh, S, three_hd)
    return x.split(hd, dim=-1)


def _probs(q, k, causal, scale, lse=None):
    """Masked scores and, from ``lse`` (or their own), the softmax."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(
            ~torch.ones(n, n, dtype=torch.bool, device=s.device).tril(),
            float("-inf"),
        )
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    return torch.exp(s - lse[..., None]), lse


def _to_rows(x, B, S, nh):
    """(B*nh, S, d) -> (B, S, nh, d)."""
    return x.reshape(B, nh, S, -1).permute(0, 2, 1, 3)


def flash_qkv_fwd_plain(qkv, bias, causal, scale, rate=0.0, seed=0):
    """The plain PyTorch version of the packed forward: returns o
    (B, S, nh*hd) in qkv's dtype and lse (B*nh, S) fp32."""
    B, S, nh, three_hd = qkv.shape
    q, k, v = _heads(qkv, bias)
    p, lse = _probs(q, k, causal, scale)
    if rate > 0.0:
        keep = _dropout.keep_mask(seed, rate, p.shape, device=p.device)
        p = torch.where(keep, p * _dropout.keep_scale(rate), 0.0)
    o = _to_rows(torch.einsum("bqk,bkd->bqd", p, v), B, S, nh)
    return o.reshape(B, S, -1).to(qkv.dtype), lse


def flash_qkv_bwd_plain(qkv, bias, o, lse, do, causal, scale, rate=0.0,
                        seed=0):
    """The plain PyTorch version of the packed backward: returns the
    (B, S, nh, 3*hd) cotangent in qkv's dtype and, with a bias, its
    (nh*3*hd,) fp32 cotangent (else None)."""
    B, S, nh, three_hd = qkv.shape
    hd = three_hd // 3
    q, k, v = _heads(qkv, bias)
    p, _ = _probs(q, k, causal, scale, lse)

    def heads(t):
        return t.float().reshape(B, S, nh, hd).permute(0, 2, 1, 3).reshape(
            B * nh, S, hd)

    do_h, o_h = heads(do), heads(o)
    dp = torch.einsum("bqd,bkd->bqk", do_h, v)
    pd = p
    if rate > 0.0:
        keep = _dropout.keep_mask(seed, rate, p.shape, device=p.device)
        sc = _dropout.keep_scale(rate)
        pd = torch.where(keep, p * sc, 0.0)
        dp = torch.where(keep, dp * sc, 0.0)
    delta = (do_h * o_h).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, k) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q) * scale
    dv = torch.einsum("bqk,bqd->bkd", pd, do_h)
    dqkv = _to_rows(torch.cat([dq, dk, dv], dim=-1), B, S, nh)
    dbias = None if bias is None else dqkv.sum(dim=(0, 1)).reshape(-1)
    return dqkv.to(qkv.dtype).contiguous(), dbias


def _check_packed(qkv, bias, *more):
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(
            f"qkv must be (B, S, nh, 3*hd), got {tuple(qkv.shape)}"
        )
    nh, three_hd = qkv.shape[2:]
    if bias is not None and (
        bias.shape != (nh * three_hd,) or bias.dtype != qkv.dtype
    ):
        raise ValueError(
            f"qkv_bias must be ({nh * three_hd},) in {qkv.dtype}, got "
            f"{tuple(bias.shape)} {bias.dtype}"
        )
    if qkv.device.type == "cpu":
        return
    if qkv.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {qkv.device}")
    if three_hd // 3 != _PACKED_HEAD_DIM:
        raise ValueError(
            f"the packed CUDA attention kernels take head_dim "
            f"{_PACKED_HEAD_DIM}, got {three_hd // 3}"
        )
    for t in (qkv, bias, *more):
        if t is not None and (t.device != qkv.device or not t.is_contiguous()
                              or t.dtype not in (qkv.dtype, torch.float32)
                              or t.data_ptr() % 16):
            raise ValueError(
                "packed attention operands must be contiguous, 16-byte "
                "aligned, on qkv's device, in qkv's dtype (lse fp32)"
            )


def _flash_fwd(qkv, bias, causal, scale, rate, seed):
    _check_packed(qkv, bias)
    if qkv.device.type == "cpu":
        return flash_qkv_fwd_plain(qkv, bias, causal, scale, rate, seed)
    B, S, nh, three_hd = qkv.shape
    hd = three_hd // 3
    o = torch.empty((B, S, nh * hd), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B * nh, S), dtype=torch.float32, device=qkv.device)
    if o.numel() > 0:
        FLASH_FWD(
            ptr(qkv), ptr(bias), ptr(o), ptr(lse), B, S, nh, hd,
            float(scale), int(bool(causal)), int(rate > 0.0),
            int(seed) & 0xFFFFFFFF, _dropout.threshold(rate),
            _dropout.keep_scale(rate), dtype_code(qkv.dtype),
            stream_ptr(qkv.device),
        )
    return o, lse


def _flash_bwd(qkv, bias, o, lse, do, causal, scale, rate, seed):
    do = do.contiguous()
    _check_packed(qkv, bias, o, lse, do)
    if qkv.device.type == "cpu":
        return flash_qkv_bwd_plain(qkv, bias, o, lse, do, causal, scale,
                                   rate, seed)
    B, S, nh, three_hd = qkv.shape
    hd = three_hd // 3
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B * nh, S), dtype=torch.float32, device=qkv.device)
    part = None
    if bias is not None:
        tiles = -(-S // _PACKED_TILE)
        part = torch.empty((B, tiles, nh, three_hd), dtype=torch.float32,
                           device=qkv.device)
    if dqkv.numel() > 0:
        FLASH_BWD(
            ptr(qkv), ptr(bias), ptr(o), ptr(lse), ptr(do), ptr(dqkv),
            ptr(delta), ptr(part), B, S, nh, hd, float(scale),
            int(bool(causal)), int(rate > 0.0), int(seed) & 0xFFFFFFFF,
            _dropout.threshold(rate), _dropout.keep_scale(rate),
            dtype_code(qkv.dtype), stream_ptr(qkv.device),
        )
    # the reduction across batch (and key/query tiles) in fp32
    dbias = None if part is None else part.sum(dim=(0, 1)).reshape(-1)
    return dqkv, dbias


class _FlashQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, seed, rate, causal, scale):
        o, lse = _flash_fwd(qkv, bias, causal, scale, rate, seed)
        ctx.save_for_backward(qkv, bias, o, lse)
        ctx.args = (causal, scale, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, bias, o, lse = ctx.saved_tensors
        dqkv, dbias = _flash_bwd(qkv, bias, o, lse, do, *ctx.args)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dqkv, dbias, None, None, None, None


def _scale(qkv, scale):
    return scale if scale is not None else 1.0 / math.sqrt(qkv.shape[-1] // 3)


def flash_attention_qkv(qkv: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Self attention on a fused projection output ``qkv`` (B, S, nh,
    3*hd), q|k|v contiguous per head; returns the (B, S, nh*hd) context,
    laid out for the output projection. Differentiable in ``qkv``."""
    return _FlashQKV.apply(qkv, None, 0, 0.0, causal, _scale(qkv, scale))


def flash_attention_qkv_dropout(qkv, dropout_seed, dropout_rate,
                                causal=False, scale=None):
    """`flash_attention_qkv` with in-kernel attention dropout;
    ``dropout_seed`` is an int32 value, one per site and step."""
    return _FlashQKV.apply(qkv, None, int(dropout_seed), float(dropout_rate),
                           causal, _scale(qkv, scale))


def flash_attention_qkv_bias(qkv, qkv_bias, causal=False, scale=None):
    """`flash_attention_qkv` on the bias-free projection output with its
    (nh*3*hd,) bias added on tile load; differentiable in both."""
    return _FlashQKV.apply(qkv, qkv_bias, 0, 0.0, causal, _scale(qkv, scale))


def flash_attention_qkv_bias_dropout(qkv, qkv_bias, dropout_seed,
                                     dropout_rate, causal=False, scale=None):
    """`flash_attention_qkv_bias` with in-kernel attention dropout."""
    return _FlashQKV.apply(qkv, qkv_bias, int(dropout_seed),
                           float(dropout_rate), causal, _scale(qkv, scale))
