"""KV-cache decode read: the hand-written CUDA kernel and its plain
PyTorch version.

Port of ``flash_attention_decode`` (rocm_apex_tpu/ops/flash_attention.py).
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
"""

import ctypes
import math
from typing import Optional

import torch

from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr

__all__ = [
    "FLASH_DECODE",
    "NEG_INF",
    "flash_attention_decode",
    "flash_attention_decode_plain",
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
