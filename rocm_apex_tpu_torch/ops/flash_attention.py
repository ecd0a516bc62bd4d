"""Flash attention: the KV-cache decode read, the packed-QKV training
attention and the unpacked attention over (batch*heads, seq, head_dim)
operands, each a hand-written CUDA kernel beside its plain PyTorch
version.

**Packed QKV** (``flash_attention_qkv{,_bias}{,_dropout}``, the forms
models/gpt.py:919-951 of the JAX package calls). The forward kernel
(``csrc/flash_fwd.cu``) replaces ``_fwd_single_kernel``
(rocm_apex_tpu/ops/flash_attention.py:1170) and the packed use of
``_fwd_kernel`` (:170); the backward (``csrc/flash_bwd.cu``, a dq pass and
a dk/dv pass) replaces ``_bwd_merged_kernel`` (:1324) and the packed use
of ``_bwd_dkv_kernel``/``_bwd_dq_kernel`` (:316, :384). q/k/v are read
straight out of the (B, S, nh, 3*hd) projection with the bias added (the
bf16 forward: by a pre-pass that writes the biased projection once), the
context is written in (B, S, nh*hd), and the backward writes dq|dk|dv
into the projection's own layout with fp32 bias partials summed over
batch in fp32. Dropout drops the normalized probabilities (softmax ->
dropout -> @ v, the normalizer from the undropped ones) with
``ops/_dropout``'s keep bits of (seed, b*nh + h, query, key), regenerated
in the backward. One forward and one backward kernel serve all four
entries: no bias is a null pointer, no dropout is rate 0. The kernels
take head_dim 128 (the packed path's hd % 128 rule at the model's
widths); they are bound by operations: the bf16 forward runs on the
wgmma pipe it shares with the unpacked forward
(``csrc/flash_fwd_pipe.cuh``, planned by `flash_fwd_plan`), the bf16
backward on a wgmma pipe built from its pieces
(``csrc/flash_bwd_pipe.cuh``, planned by `flash_bwd_plan`), p and ds
rounded to the operands' dtype before the products that consume them, as
every JAX kernel rounds them, and fp32 on the CUDA cores (see the
sources).

**p's rounding.** Every JAX attention kernel rounds p (times 1 / (1 -
rate) where dropout keeps it) to v's dtype before p @ v, p_drop to do's
before dv, and ds = p (dp - delta) to q's (k's) before dk (dq); the
products accumulate in fp32 and l sums the unrounded, undropped p. Every
kernel and plain version here does the same. In a forward p is formed
against the running max after each key tile, so o depends on the tiling:
a plain version rounds p in the frame of the kernel it stands for
(``frame``, `_frame_max`: 64 keys in the flash pipes, 32 in the decode
reads and the serving segment read), and JAX's
``block_k`` set to that frame gives the same o. The backward forms p
from the final lse and has no frame. In fp32 the rounding is the
identity.

**The score rule** of every kernel and plain version here is the JAX
kernels' (`_masked_scores`, rocm_apex_tpu/ops/flash_attention.py:122, and
the paged read's): q times ``scale * log2(e)`` in q's dtype (`_q_mul`),
rounded in that dtype (`_q_scaled`), then the fp32 product with k, in
base 2. In bf16 the constant itself rounds, so a fold in fp32 would
leave every score 0.3% off the reference.

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
prefix, so an lse merge weighs it to zero. The read is split over the
keys (`decode_span_plan`: spans of a (row, head)'s capacity, a warp
each, as many as fill the card), and the spans' partials are merged in
a fixed order (`merge_span_partials_plain` is that merge in plain
PyTorch, `decode_spans_plain` the whole split read).

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
* scale)`` rounded to q's dtype. Both reads are one kernel
(``csrc/decode_split.cuh``) over two ways of finding a key's row, and
both plan their split on the slots' key range: the contiguous cache's
capacity, and the paged cache's ``capacity`` argument (the capacity it
was made for, which its pages may round up). So the same keys in the
same dtype give the same bits from either cache, and the paged serve
reproduces the contiguous serve's greedy tokens
(`decode_paged_spans_plain` is the paged split read in plain PyTorch).

**Unpacked** (``flash_attention``, ``flash_attention_varlen``,
``flash_attention_with_lse``, ``flash_attention_dropout``, the JAX names,
argument order and defaults; ``flash_attention_heads`` is the models'
form). Three kernels replace the TPU kernels `_fwd` and `_bwd` run
(rocm_apex_tpu/ops/flash_attention.py:242, :502): the forward
(``csrc/flash_unpacked_fwd.cu``, `_fwd_kernel` :170), the backward's dq
and dk/dv passes (``csrc/flash_unpacked_bwd.cu``, `_bwd_dq_kernel` :384,
`_bwd_dkv_kernel` :316) and the bias gradient (``csrc/flash_dbias.cu``,
`_bwd_dbias_kernel` :440), all on one masked-score function
(``csrc/flash_unpacked.cuh``); the bf16 forward runs on the wgmma pipe
(``csrc/flash_fwd_pipe.cuh``), split over the keys and merged by lse
where `flash_fwd_plan` says the card is not filled (the whole-prompt
window), and the bf16 backward on the packed backward's wgmma pipe
(``csrc/flash_bwd_pipe.cuh``, with the score bias and the lse
cotangent), as `flash_unpacked_bwd_plan` says. Semantics are `_masked_scores`': base-2
scores with scale * log2(e) folded into q in q's dtype, an fp32 additive
bias (nb, sq, sk) with nb in {1, batch, batch*heads} added as bias *
log2(e), top-left causal masking, per-row key lengths, the ragged key
edge; dropout with the packed kernels' keep bits (stream = the operand
row b*nh + h). The running max starts at -1e30, so a row whose every live
score carries the -1e30 padding bias has o = 0 and lse = -1e30 * ln 2, as
the JAX kernel gives without causal masking. Under ``causal`` the JAX
kernel has no single value for such a row (its causally masked scores
equal that running max, so it averages v over the masked keys of the
blocks it visits, a value that changes with block_k); the port keeps o =
0 there, and the same lse. The kernels read and write (B, H, S, D) operands
through their strides: the models pass the per-head column blocks of the
fused projection as views (no copy) and take o and the gradients in (B,
S, H, D) memory, the output projection's layout. The backward's dq pass
also forms delta = rowsum(do * o) - dlse (the XLA code around `_bwd`'s
kernels) for the dk/dv pass and the dbias kernel. ``compute_dbias=False``
returns exact zeros for the bias gradient with no launch.
"""

import ctypes
import math
from typing import Optional

import torch

from rocm_apex_tpu_torch.ops import _dropout
from rocm_apex_tpu_torch.ops._build import (
    DTYPE_CODES,
    Kernel,
    dtype_code,
    ptr,
    sm_count,
    stream_ptr,
)
from rocm_apex_tpu_torch.ops.paging import paged_view

__all__ = [
    "FLASH_DECODE",
    "FLASH_DECODE_PAGED",
    "FLASH_DECODE_PAGED_INT8",
    "FLASH_FWD",
    "FLASH_BWD",
    "FLASH_UNPACKED_FWD",
    "FLASH_UNPACKED_BWD",
    "FLASH_DBIAS",
    "NEG_INF",
    "flash_attention",
    "flash_attention_dropout",
    "flash_attention_heads",
    "flash_attention_varlen",
    "flash_attention_with_lse",
    "flash_unpacked_fwd_plain",
    "flash_unpacked_bwd_plain",
    "flash_bwd_plan",
    "flash_fwd_plan",
    "flash_unpacked_bwd_plan",
    "flash_fwd_split_plain",
    "flash_attention_decode",
    "flash_attention_decode_plain",
    "flash_attention_decode_paged",
    "flash_attention_decode_paged_plain",
    "decode_paged_spans_plain",
    "decode_spans_plain",
    "decode_span_plan",
    "decode_span_workspace",
    "merge_span_partials_plain",
    "flash_attention_qkv",
    "flash_attention_qkv_dropout",
    "flash_attention_qkv_bias",
    "flash_attention_qkv_bias_dropout",
    "flash_qkv_fwd_plain",
    "flash_qkv_bwd_plain",
    "check_head_dim",
]

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
_SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)


def _q_mul(scale: float, dtype: torch.dtype) -> float:
    """scale * log2(e) rounded to the operands' dtype: every attention
    kernel and plain version folds it into q as the JAX kernels do, ``q *
    asarray(scale * LOG2E, q.dtype)`` rounded in q's dtype
    (`_masked_scores`, rocm_apex_tpu/ops/flash_attention.py:122)."""
    return float(torch.tensor(scale * LOG2E, dtype=dtype))


def _q_scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q times `_q_mul`, rounded in q's dtype: the q of the base-2 scores
    (q . k is then taken in fp32)."""
    return q * torch.tensor(_q_mul(scale, q.dtype), dtype=q.dtype,
                            device=q.device)


def _frame_max(s: torch.Tensor, frame: int) -> torch.Tensor:
    """The running max a kernel walking ``frame``-key tiles from key 0
    holds after the tile of each key of the base-2 scores ``s`` (..., sk):
    -1e30, then the max over every tile up to and including the key's
    own, as `_fwd_kernel`'s ``m_new`` after each key block (rocm_apex_tpu/
    ops/flash_attention.py:209)."""
    sk = s.shape[-1]
    nt = -(-sk // frame)
    t = torch.nn.functional.pad(s, (0, nt * frame - sk), value=float("-inf"))
    run = t.view(*s.shape[:-1], nt, frame).amax(-1).cummax(-1).values
    return run.clamp(min=NEG_INF).repeat_interleave(frame, -1)[..., :sk]


def _p_rounded(s, m, frame, dtype, keep=None, rate=0.0):
    """The weights of p @ v relative to the row max ``m`` (..., 1) of the
    base-2 scores ``s``: p formed against the running max of a walk over
    ``frame``-key tiles (`_frame_max`), times 1 / (1 - rate) where
    ``keep`` holds and 0 where it does not, rounded to ``dtype`` (v's) as
    JAX's kernels round it before p @ v, then carried to ``m`` in fp32.
    In fp32 the rounding is the identity and p is formed against ``m``
    itself."""
    mr = m if dtype == torch.float32 else _frame_max(s, frame)
    p = torch.exp2(s - mr)
    if keep is not None:
        p = torch.where(keep, p * _dropout.keep_scale(rate), 0.0)
    if dtype == torch.float32:
        return p
    return p.to(dtype).float() * torch.exp2(mr - m)


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
FLASH_DECODE = Kernel(
    name="flash_attention_decode",
    source="flash_decode.cu",
    symbol="flash_decode",
    argtypes=[_P, _I64, _I64, _P, _P, _I64, _I64, _I64, _P, _P, _I, _I, _I,
              _I, _I, ctypes.c_float, _I, _I, _I, _P, _P, _P, _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:813 _decode_kernel",
)
_PAGED_ARGS = [_I] * 8 + [ctypes.c_float, _I, _I, _I, _P, _P, _P, _P]
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
    argtypes=[_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _U, _U, _F, _I,
              _I, _P, _P, _I, _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:1170 _fwd_single_kernel",
)
FLASH_BWD = Kernel(
    name="flash_attention_qkv_bwd",
    source="flash_bwd.cu",
    symbol="flash_bwd",
    argtypes=[_P] * 9 + [_I, _I, _I, _I, _F, _F, _I, _I, _U, _U, _F, _I,
                         _P],
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
                                 slot_ids=None, frame=None):
    """The plain PyTorch version: returns (o, lse), o in q's dtype. The
    scores are `_masked_scores`': q times scale * log2(e), rounded in q's
    dtype, then the fp32 product with k, in base 2. p is rounded to v's
    dtype in the frame of a walk over ``frame``-key tiles (the row
    walk's 32 by default; JAX `flash_attention_decode` at that block_k
    gives the same o)."""
    frame = _SPAN_TILE if frame is None else frame
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
        qs = _q_scaled(q[idx], scale).float()
        scores = torch.einsum("nhd,chd->nhc", qs, k_cache[s].float())
        live = col[None, None, :] < bound[idx][:, None, None]
        scores = scores.masked_fill(~live, float("-inf"))
        m = scores.amax(dim=-1, keepdim=True)
        l = torch.exp2(scores - m).sum(dim=-1)
        p = _p_rounded(scores, m, frame, v_cache.dtype)
        o[idx] = torch.einsum("nhc,chd->nhd", p, v_cache[s].float()) / l[
            ..., None]
        lse[idx] = (m[..., 0] + torch.log2(l)) * LN2
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
        spans, span_len = decode_span_plan(rows, heads, capacity,
                                           sm_count(q.device))
        ws = _span_workspace(rows, heads, d, spans, q.device)
        FLASH_DECODE(
            ptr(q), q.stride(0), q.stride(1), ptr(k_cache), ptr(v_cache),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            ptr(kv_lengths), ptr(slot_ids), rows, heads, d, num_slots,
            capacity, _q_mul(scale, q.dtype), spans, span_len,
            dtype_code(q.dtype),
            ptr(o), ptr(lse), ptr(ws), stream_ptr(q.device),
        )
    return (o, lse) if return_lse else o


# the split decode read (csrc/decode_split.cuh): warps a block, keys a
# tile, at most 32 spans a (row, head), and the warps a multiprocessor
# the spans aim at (the decode grid's 8 rows x 8 heads take 32 spans of
# 32 keys at capacity 1024 on 132 multiprocessors)
_SPAN_BLOCK_WARPS = 4
_SPAN_TILE = 32
_SPAN_MAX = 32
_SPAN_WARPS_PER_SM = 16


def decode_span_plan(rows: int, heads: int, capacity: int,
                     sms: int) -> tuple:
    """``(spans, span_len)`` of the split decode read, contiguous or
    paged: each (row, head)'s key range ``[0, capacity)`` is cut into
    ``spans`` (a power of two, at most 32) ranges of ``span_len`` keys (a
    multiple of the 32-key tile, ``spans * span_len >= capacity`` and no
    span starting at or past the capacity), doubled while rows x heads x
    spans stays within `_SPAN_WARPS_PER_SM` warps for each of ``sms``
    multiprocessors. It reads no kv_len: a span past its row's bound
    exits at once on the card. Both reads call it with the slots' key
    range, so one cache and the other add the same keys in one order."""
    pairs = rows * heads
    spans = 1
    while (spans < _SPAN_MAX and pairs * spans * 2 <= _SPAN_WARPS_PER_SM * sms
           and capacity >= 2 * spans * _SPAN_TILE):
        spans *= 2
    while True:
        span_len = max(-(-capacity // (spans * _SPAN_TILE)) * _SPAN_TILE,
                       _SPAN_TILE)
        # tile rounding may leave the last spans past the capacity
        if spans == 1 or (spans - 1) * span_len < capacity:
            return spans, span_len
        spans //= 2


def decode_span_workspace(rows: int, heads: int, head_dim: int,
                          spans: int) -> int:
    """fp32 elements of the split read's workspace: each block's merged
    (acc, m, l) where a (row, head)'s spans take more than one block of
    `_SPAN_BLOCK_WARPS` warps, else 0."""
    if spans <= _SPAN_BLOCK_WARPS:
        return 0
    return rows * heads * (spans // _SPAN_BLOCK_WARPS) * (head_dim + 2)


def _span_workspace(rows, heads, head_dim, spans, device):
    n = decode_span_workspace(rows, heads, head_dim, spans)
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def merge_span_partials_plain(m, l, acc):
    """The split read's merge as plain PyTorch: partials along dim -1 of
    ``m`` and ``l`` (base-2 running maxima and sums, m = -1e30 and l = 0
    for a span that attended nothing) and dim -2 of ``acc`` (the
    unnormalized value sums), merged through their maxima in span order:
    o = sum_i acc_i 2^(m_i - M) / sum_i l_i 2^(m_i - M), M = max_i m_i,
    and the natural-log lse (M + log2 l) ln 2; zeros and lse = -1e30 where
    no span attended a key. Returns (o, lse)."""
    mx = m.max(dim=-1).values
    f = torch.exp2(m - mx[..., None])
    lsum = (l * f).sum(-1)
    o = (acc * f[..., None]).sum(-2)
    empty = ~(lsum > 0)
    o = torch.where(empty[..., None], 0.0, o / torch.where(empty, 1.0,
                                                           lsum)[..., None])
    lse = torch.where(empty, -1e30,
                      (mx + torch.log2(torch.where(empty, 1.0, lsum)))
                      * math.log(2.0))
    return o, lse


def decode_spans_plain(q, k_cache, v_cache, kv_lengths, scale, spans,
                       span_len, slot_ids=None):
    """The split read in plain PyTorch, in fp32: each (row, head)'s keys
    cut into ``spans`` ranges of ``span_len`` as the kernel cuts them,
    each range's base-2 (m, l, acc) partial formed alone (p rounded to v's
    dtype against the running max after each 32-key tile of the range, as
    the kernel's warp walks it), then `merge_span_partials_plain`. Returns
    (o, lse) as `flash_attention_decode_plain`."""
    k, v = k_cache.float(), v_cache.float()
    num_slots, cap = k.shape[0], k.shape[1]
    rows, heads, d = q.shape
    if slot_ids is None:
        slot_ids = torch.arange(rows, dtype=torch.int32, device=q.device)
    ok = (slot_ids >= 0) & (slot_ids < num_slots)
    sl = torch.where(ok, slot_ids, 0).long()
    bound = torch.where(ok, kv_lengths.long().clamp(0, cap)[sl], 0)
    qf = _q_scaled(q, scale).float()
    s = torch.einsum("rhd,rchd->rhc", qf, k[sl])  # (rows, heads, cap)
    pos = torch.arange(spans * span_len, device=q.device)
    live = (pos[None, :] < bound[:, None])[:, None, :]
    s = torch.nn.functional.pad(s, (0, spans * span_len - cap),
                                value=-1e30)
    s = torch.where(live, s, -1e30).reshape(rows, heads, spans, span_len)
    live = live.reshape(rows, 1, spans, span_len)
    m = torch.where(live.any(-1), s.max(-1).values, -1e30)
    l = torch.where(live, torch.exp2(s - m[..., None]), 0.0).sum(-1)
    p = torch.where(live, _p_rounded(s, m[..., None], _SPAN_TILE,
                                     v_cache.dtype), 0.0)
    vv = torch.nn.functional.pad(v[sl], (0, 0, 0, 0, 0, spans * span_len
                                         - cap))
    vv = vv.reshape(rows, spans, span_len, heads, d)
    acc = torch.einsum("rhsc,rschd->rhsd", p, vv)
    o, lse = merge_span_partials_plain(m, l, acc)
    return o.to(q.dtype), lse


def _paged_cache(pool, page_table, scale, dtype, capacity):
    """The pool gathered through the table, in ``dtype``, cut to the
    slots' key range."""
    return paged_view(pool, page_table, scale, out_dtype=dtype)[:, :capacity]


def decode_paged_spans_plain(q, k_pool, v_pool, page_table, kv_lengths,
                             scale, spans, span_len, k_scale=None,
                             v_scale=None, slot_ids=None, capacity=None):
    """The paged split read in plain PyTorch: the pools gathered through
    the table (int8 dequantized and rounded to q's dtype) and cut to
    ``capacity``, then `decode_spans_plain`. Returns (o, lse) as
    `flash_attention_decode_paged_plain`."""
    k = _paged_cache(k_pool, page_table, k_scale, q.dtype, capacity)
    v = _paged_cache(v_pool, page_table, v_scale, q.dtype, capacity)
    return decode_spans_plain(q, k, v, kv_lengths, scale, spans, span_len,
                              slot_ids)


def flash_attention_decode_paged_plain(q, k_pool, v_pool, page_table,
                                       kv_lengths, scale, k_scale=None,
                                       v_scale=None, slot_ids=None,
                                       capacity=None, frame=None):
    """The plain PyTorch version: the pools gathered through the table
    (int8 dequantized and rounded to q's dtype) and cut to ``capacity``,
    then `flash_attention_decode_plain` (``frame`` its frame: the kernel's
    32-key tile by default, where JAX's is the page). Returns (o, lse)."""
    k = _paged_cache(k_pool, page_table, k_scale, q.dtype, capacity)
    v = _paged_cache(v_pool, page_table, v_scale, q.dtype, capacity)
    return flash_attention_decode_plain(q, k, v, kv_lengths, scale, slot_ids,
                                        frame)


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
    capacity: Optional[int] = None,
):
    """`flash_attention_decode` reading through a block table.

    ``q`` is (rows, heads, head_dim); ``k_pool``/``v_pool`` are the page
    pools (num_pages, heads, page_size, head_dim); ``page_table`` is
    (num_slots, pages_per_slot) int32, unmapped entries holding the
    sentinel ``num_pages``; ``kv_lengths`` (num_slots,) int32 bounds each
    slot's prefix, at most ``pages_per_slot * page_size``. Row r reads
    slot ``slot_ids[r]`` (default: slot r); a slot id outside ``[0,
    num_slots)`` reads nothing. ``k_scale``/``v_scale`` ((num_pages,
    heads) fp32) mark int8 pools. ``capacity``: the slots' key range, at
    most (and by default) ``pages_per_slot * page_size``; bounds clamp to
    it and the key split is planned on it, so a paged cache made for a
    capacity that its pages round up reads as a contiguous cache of that
    capacity does, bit for bit. Returns o (rows, heads, head_dim) in q's
    dtype, and with ``return_lse`` the natural-log lse (rows, heads)
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
    if capacity is None:
        capacity = pages_per_slot * page_size
    if not 0 <= capacity <= pages_per_slot * page_size:
        raise ValueError(f"capacity {capacity} outside [0, "
                         f"{pages_per_slot * page_size}] (the table's rows)")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        o, lse = flash_attention_decode_paged_plain(
            q, k_pool, v_pool, page_table, kv_lengths, scale, k_scale,
            v_scale, slot_ids, capacity,
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
        spans, span_len = decode_span_plan(rows, heads, capacity,
                                           sm_count(q.device))
        ws = _span_workspace(rows, heads, d, spans, q.device)
        kernel(
            ptr(q), q.stride(0), q.stride(1), *pools, ptr(page_table),
            ptr(kv_lengths), ptr(slot_ids), rows, heads, d, num_slots,
            pages_per_slot, page_size, num_pages, capacity,
            _q_mul(scale, q.dtype), spans, span_len, dtype_code(q.dtype),
            ptr(o), ptr(lse), ptr(ws),
            stream_ptr(q.device),
        )
    return (o, lse) if return_lse else o


# ---------------------------------------------------------------------------
# packed QKV: training attention
# ---------------------------------------------------------------------------


def _heads(qkv, bias):
    """Biased q, k, v (B*nh, S, hd) in qkv's dtype from the (B, S, nh,
    3*hd) projection: the biased values are rounded to that dtype, as the
    JAX kernels' add in it rounds them (and the kernels stage them)."""
    B, S, nh, three_hd = qkv.shape
    x = qkv
    if bias is not None:
        x = (qkv.float() + bias.float().view(nh, three_hd)).to(qkv.dtype)
    x = x.permute(0, 2, 1, 3).reshape(B * nh, S, three_hd)
    return x.split(three_hd // 3, dim=-1)


def _to_rows(x, B, S, nh):
    """(B*nh, S, d) -> (B, S, nh, d)."""
    return x.reshape(B, nh, S, -1).permute(0, 2, 1, 3)


def flash_qkv_fwd_plain(qkv, bias, causal, scale, rate=0.0, seed=0,
                        frame=None):
    """The plain PyTorch version of the packed forward: returns o
    (B, S, nh*hd) in qkv's dtype and lse (B*nh, S) fp32. It is the
    unpacked plain forward on the biased heads: the same score rule
    (`_unpacked_scores`), dropout stream (b*nh + h) and ``frame``."""
    B, S, nh, _ = qkv.shape
    q, k, v = _heads(qkv, bias)
    o, lse = flash_unpacked_fwd_plain(q, k, v, None, causal, scale, None,
                                      rate, seed, frame)
    return _to_rows(o, B, S, nh).reshape(B, S, -1), lse


def flash_qkv_bwd_plain(qkv, bias, o, lse, do, causal, scale, rate=0.0,
                        seed=0):
    """The plain PyTorch version of the packed backward: returns the
    (B, S, nh, 3*hd) cotangent in qkv's dtype and, with a bias, its
    (nh*3*hd,) fp32 cotangent (else None), summed from the fp32 dqkv."""
    B, S, nh, three_hd = qkv.shape
    q, k, v = _heads(qkv, bias)

    def heads(t):
        return t.reshape(B, S, nh, -1).permute(0, 2, 1, 3).reshape(
            B * nh, S, -1)

    dq, dk, dv, _ = _unpacked_grads(q, k, v, None, heads(o), lse, heads(do),
                                    causal, scale, None, rate, seed)
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
        plan = flash_fwd_plan(B * nh, S, S, hd, causal, sm_count(qkv.device),
                              qkv.dtype)
        # bf16 with a bias: the biased projection, written once by a
        # pre-pass and read by the pipe
        scratch = (torch.empty_like(qkv) if bias is not None
                   and plan["route"] == "wgmma" else None)
        FLASH_FWD(
            ptr(qkv), ptr(bias), ptr(o), ptr(lse), B, S, nh, hd,
            float(scale), _q_mul(scale, qkv.dtype), int(bool(causal)),
            int(rate > 0.0), int(seed) & 0xFFFFFFFF,
            _dropout.threshold(rate), _dropout.keep_scale(rate),
            plan["splits"], plan["split_tiles"], ptr(scratch),
            ptr(_plan_workspace(plan, qkv.device)), dtype_code(qkv.dtype),
            stream_ptr(qkv.device),
        )
    return o, lse


def _bwd_tiles(nqt: int, nkt: int, causal: bool, dq_down: bool):
    """The tile lists of a backward's two passes, in launch order: each dq
    block's query tile and the key tiles [lo, hi) it walks (query tiles
    counted down where ``dq_down``, as the pipe's grid runs them, else up),
    each dk/dv block's key tile and the query tiles [lo, hi) it walks (key
    tiles counted up). Under ``causal`` (top-left aligned) a query tile
    walks the key tiles up to its own diagonal and a key tile the query
    tiles from its own on, so on the pipe the longest walks go first."""
    order = reversed(range(nqt)) if dq_down else range(nqt)
    dq = [(t, 0, min(nkt, t + 1) if causal else nkt) for t in order]
    dkv = [(t, min(t, nqt) if causal else 0, nqt) for t in range(nkt)]
    return dq, dkv


def flash_bwd_plan(batch: int, seq: int, heads: int, head_dim: int,
                   causal: bool, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The packed backward's route, grids and buffers, from the shape
    alone.

    ``route``: ``"wgmma"`` for bf16 (csrc/flash_bwd_pipe.cuh) and
    ``"cuda_cores"`` for fp32; the packed kernels take head_dim 128 (others
    raise). The pipe's two passes run on grids of (batch*heads, 64-row
    tiles): ``dq_tiles`` lists, in launch order, each dq block's query tile
    and the key tiles [lo, hi) it walks (query tiles counted down, the
    causal ones longest first), ``dkv_tiles`` each dk/dv block's key tile
    and its query tiles (key tiles counted up, the same; `_bwd_tiles`).
    ``stats`` is the fp32 scratch the dq pass hands the dk/dv pass: (lse
    log2 e, delta) pairs for every row of every query tile on the pipe,
    delta alone on the CUDA cores. ``parts``: the fp32 (batch, tiles,
    heads, 3 head_dim) column sums of dq|dk|dv a bias's cotangent sums, one
    a 64-row tile in either route; ``scratch``: the biased projection a
    bias pre-pass writes on the pipe (the wrapper allocates it where there
    is a bias)."""
    if head_dim != _PACKED_HEAD_DIM:
        raise ValueError(f"the packed CUDA attention kernels take head_dim "
                         f"{_PACKED_HEAD_DIM}, got {head_dim}")
    tiles = -(-seq // _PACKED_TILE)
    bh = batch * heads
    parts = (batch, tiles, heads, 3 * head_dim)
    pipe = dtype == torch.bfloat16
    dq_tiles, dkv_tiles = _bwd_tiles(tiles, tiles, causal, dq_down=pipe)
    if not pipe:
        return dict(route="cuda_cores", dq_grid=(tiles, bh),
                    dkv_grid=(tiles, bh), dq_tiles=dq_tiles,
                    dkv_tiles=dkv_tiles, stats=(bh, seq), parts=parts,
                    scratch=None)
    return dict(route="wgmma", dq_grid=(bh, tiles), dkv_grid=(bh, tiles),
                dq_tiles=dq_tiles, dkv_tiles=dkv_tiles,
                stats=(bh, tiles * _PACKED_TILE, 2), parts=parts,
                scratch=(batch, seq, heads, 3 * head_dim))


def _flash_bwd(qkv, bias, o, lse, do, causal, scale, rate, seed):
    do = do.contiguous()
    _check_packed(qkv, bias, o, lse, do)
    if qkv.device.type == "cpu":
        return flash_qkv_bwd_plain(qkv, bias, o, lse, do, causal, scale,
                                   rate, seed)
    B, S, nh, three_hd = qkv.shape
    hd = three_hd // 3
    plan = flash_bwd_plan(B, S, nh, hd, causal, qkv.dtype)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(plan["stats"], dtype=torch.float32,
                        device=qkv.device)
    part = scratch = None
    if bias is not None:
        part = torch.empty(plan["parts"], dtype=torch.float32,
                           device=qkv.device)
        if plan["route"] == "wgmma":
            # the biased projection, written once by the pre-pass
            scratch = torch.empty_like(qkv)
    if dqkv.numel() > 0:
        FLASH_BWD(
            ptr(qkv), ptr(bias), ptr(o), ptr(lse), ptr(do), ptr(dqkv),
            ptr(stats), ptr(part), ptr(scratch), B, S, nh, hd, float(scale),
            _q_mul(scale, qkv.dtype), int(bool(causal)), int(rate > 0.0),
            int(seed) & 0xFFFFFFFF,
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


# ---------------------------------------------------------------------------
# unpacked: (batch*heads, seq, head_dim) operands, an additive bias,
# per-row key lengths
# ---------------------------------------------------------------------------

_UNPACKED_HEAD_DIMS = (64, 128)  # the csrc/flash_unpacked.cuh instances


def _bias_groups(bias, bh: int) -> int:
    """Heads per bias row: row ``i`` of the (bh, ...) operands reads bias
    row ``i // (bh // nb)``."""
    nb = bias.shape[0]
    if nb == 0 or bh % nb != 0:
        raise ValueError(f"bias batch {nb} must divide batch*heads {bh}")
    return bh // nb


def _unpacked_scores(q, k, bias, causal, scale, kv_lengths):
    """The masked base-2 scores of ``_masked_scores`` (rocm_apex_tpu/ops/
    flash_attention.py:122), fp32 (bh, sq, sk): q times scale * log2(e)
    in q's dtype, the fp32 product with k, plus ``bias * log2(e)``; a key
    past ``kv_lengths[row]`` or, when causal, past the query's own index
    (top-left aligned) is -inf, so it adds nothing to the softmax."""
    bh, sq, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", _q_scaled(q, scale).float(), k.float())
    if bias is not None:
        hp = _bias_groups(bias, bh)
        s = (s.view(-1, hp, sq, sk) + bias.float()[:, None] * LOG2E).view(
            bh, sq, sk)
    col = torch.arange(sk, device=q.device)
    live = torch.ones((1, 1, sk), dtype=torch.bool, device=q.device)
    if kv_lengths is not None:
        live = col[None, None, :] < kv_lengths.to(q.device).long()[:, None,
                                                                    None]
    if causal:
        row = torch.arange(sq, device=q.device)
        live = live & (col[None, :] <= row[:, None])[None]
    return s.masked_fill(~live, float("-inf"))


def flash_unpacked_fwd_plain(q, k, v, bias, causal, scale, kv_lengths=None,
                             rate=0.0, seed=0, frame=None):
    """The plain PyTorch version of the unpacked forward (`_fwd` at
    rocm_apex_tpu/ops/flash_attention.py:242): returns o (bh, sq, d) in
    q's dtype and the natural-log lse (bh, sq) fp32.

    The running max starts at -1e30 as in `_fwd_kernel`, so a row whose
    every score carries the -1e30 padding bias (or that attends no key)
    has l = 0: its o is 0 and its lse -1e30 * ln 2, as the JAX kernel
    gives without causal masking (under ``causal`` the JAX value of such
    a row depends on its tiling; the port's o stays 0). The normalizer
    sums the undropped, unrounded probabilities; p @ v takes p rounded to
    v's dtype in the frame of ``frame``-key tiles (`_p_rounded`; the
    kernels' 64 by default)."""
    frame = _FWD_TILE if frame is None else frame
    s = _unpacked_scores(q, k, bias, causal, scale, kv_lengths)
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    l = torch.exp2(s - m).sum(dim=-1, keepdim=True)
    keep = (_dropout.keep_mask(seed, rate, s.shape, device=s.device)
            if rate > 0.0 else None)
    p = _p_rounded(s, m, frame, v.dtype, keep, rate)
    safe = torch.where(l > 0.0, l, 1.0)
    o = torch.einsum("bqk,bkd->bqd", p, v.float()) / safe
    lse = (m + torch.log2(safe)) * LN2
    return o.to(q.dtype), lse[..., 0]


def _unpacked_grads(q, k, v, bias, o, lse, do, causal, scale, kv_lengths,
                    rate, seed, dlse=None):
    """The backward's formulas in fp32: dq, dk, dv and the score gradient
    ds. p is rebuilt from the forward's lse by the forward's score rule;
    ``delta = sum(do * o) - dlse``, ds = p (dp - delta), and dq and dk
    take the scale at the end, dk from the unscaled q (as JAX's). As
    JAX's kernels round them, p_drop is rounded to do's dtype before dv
    and ds to q's (and k's) before dq and dk; the ds returned, the bias
    gradient's, is not rounded."""
    s = _unpacked_scores(q, k, bias, causal, scale, kv_lengths)
    p = torch.exp2(s - lse[..., None] * LOG2E)
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    pd = p
    if rate > 0.0:
        keep = _dropout.keep_mask(seed, rate, p.shape, device=p.device)
        sc = _dropout.keep_scale(rate)
        pd = torch.where(keep, p * sc, 0.0)
        dp = torch.where(keep, dp * sc, 0.0)
    ds = p * (dp - delta[..., None])
    dsr = ds.to(q.dtype).float()  # q and k share one dtype
    dq = torch.einsum("bqk,bkd->bqd", dsr, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", dsr, q.float()) * scale
    dv = torch.einsum("bqk,bqd->bkd", pd.to(do.dtype).float(), do.float())
    return dq, dk, dv, ds


def flash_unpacked_bwd_plain(q, k, v, bias, o, lse, do, causal, scale,
                             kv_lengths=None, rate=0.0, seed=0, dlse=None,
                             compute_dbias=False):
    """The plain PyTorch version of the unpacked backward (`_bwd`, :502):
    dq, dk, dv in the operands' dtype and, with ``compute_dbias``, the
    fp32 (nb, sq, sk) bias gradient (else None). ``delta = sum(do * o) -
    dlse`` folds the lse cotangent in, as `_bwd` does at :513-519."""
    dq, dk, dv, ds = _unpacked_grads(q, k, v, bias, o, lse, do, causal,
                                     scale, kv_lengths, rate, seed, dlse)
    dbias = None
    if compute_dbias:
        hp = _bias_groups(bias, q.shape[0])
        dbias = ds.view(-1, hp, *ds.shape[1:]).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# the bf16 forward's pipe (csrc/flash_fwd_pipe.cuh): query rows and keys
# a tile, the blocks a multiprocessor holds (81 KB of shared memory each
# at head_dim 128), and the key split's bounds
_FWD_TILE = 64
_FWD_BLOCKS_PER_SM = 2
_FWD_SPLIT_MAX = 16
_FWD_SPLIT_MIN_TILES = 2


def flash_fwd_plan(bh: int, sq: int, sk: int, hd: int, causal: bool,
                   sms: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The forward kernels' route and grid, from the shape alone, for the
    packed (``bh`` = B*nh, sq = sk = S) and the unpacked forward.

    ``route``: ``"wgmma"`` for bf16 (the pipe, head_dim 64 or 128: both
    are instantiated, so no head dim goes elsewhere) and ``"cuda_cores"``
    for fp32. A pipe unit is (operand row, query tile of 64, key split):
    where the bh x ceil(sq / 64) pairs cannot fill the card, each query
    tile's ceil(sk / 64) key tiles are cut into ``splits`` (a power of
    two, at most 16) runs of ``split_tiles`` tiles, doubled while twice
    the units stay within two waves of two blocks a multiprocessor and
    each split keeps at least two tiles; the partials are merged by lse in
    split order. It reads no lengths: a split past a row's last key exits
    at once. ``grid`` is the pipe's (bh, query tiles x splits), its query
    tiles counted down (longest first under ``causal``); ``workspace``
    the fp32 floats of the split partials (0 unsplit)."""
    nqt, ntk = -(-sq // _FWD_TILE), -(-sk // _FWD_TILE)
    if dtype != torch.bfloat16:
        return dict(route="cuda_cores", rows=_FWD_TILE, splits=1,
                    split_tiles=max(ntk, 1), grid=(nqt, bh), workspace=0)
    if hd not in _UNPACKED_HEAD_DIMS:
        raise ValueError(f"the bf16 forward takes head_dim in "
                         f"{_UNPACKED_HEAD_DIMS}, got {hd}")
    units = bh * nqt
    splits = 1
    while (splits < _FWD_SPLIT_MAX
           and units * splits * 2 <= 2 * _FWD_BLOCKS_PER_SM * sms
           and ntk >= 2 * splits * _FWD_SPLIT_MIN_TILES):
        splits *= 2
    split_tiles = max(-(-ntk // splits), 1)
    splits = max(-(-ntk // split_tiles), 1)  # no split past the last tile
    workspace = (bh * nqt * splits * _FWD_TILE * (hd + 2) if splits > 1
                 else 0)
    return dict(route="wgmma", rows=_FWD_TILE, splits=splits,
                split_tiles=split_tiles, grid=(bh, nqt * splits),
                workspace=workspace)


def flash_unpacked_bwd_plan(bh: int, sq: int, sk: int, hd: int,
                            causal: bool, dtype: torch.dtype = torch.bfloat16,
                            dbias: bool = False) -> dict:
    """The unpacked backward's route, grids and buffers, from the shape
    alone (it reads no lengths, as `flash_fwd_plan` reads none).

    ``route``: ``"wgmma"`` for bf16 (the packed backward's pipe,
    csrc/flash_bwd_pipe.cuh, head_dim 64 or 128) and ``"cuda_cores"`` for
    fp32 (csrc/flash_unpacked_bwd.cuh); any other head_dim raises. The two
    passes' grids and tile lists are `flash_bwd_plan`'s (`_bwd_tiles`), on
    ``sq`` query rows and ``sk`` keys: on the pipe, (bh, query tiles) for
    the dq pass, query tiles counted down, and (bh, key tiles) for the
    dk/dv pass. ``stats``: the fp32 scratch the dq pass hands the dk/dv
    pass, the (lse log2 e, delta) pairs of every row padded to whole query
    tiles on the pipe, delta alone, (bh, sq), on the CUDA cores.
    ``delta``: the (bh, sq) fp32 buffer the pipe's dq pass also writes
    delta into for the bias gradient (row 10), named only with ``dbias``
    (on the CUDA cores the stats are that delta, so it is never named)."""
    if hd not in _UNPACKED_HEAD_DIMS:
        raise ValueError(f"the unpacked CUDA attention kernels take head_dim "
                         f"in {_UNPACKED_HEAD_DIMS}, got {hd}")
    nqt, nkt = -(-sq // _FWD_TILE), -(-sk // _FWD_TILE)
    pipe = dtype == torch.bfloat16
    dq_tiles, dkv_tiles = _bwd_tiles(nqt, nkt, causal, dq_down=pipe)
    if not pipe:
        return dict(route="cuda_cores", dq_grid=(nqt, bh),
                    dkv_grid=(nkt, bh), dq_tiles=dq_tiles,
                    dkv_tiles=dkv_tiles, stats=(bh, sq), delta=None)
    return dict(route="wgmma", dq_grid=(bh, nqt), dkv_grid=(bh, nkt),
                dq_tiles=dq_tiles, dkv_tiles=dkv_tiles,
                stats=(bh, nqt * _FWD_TILE, 2),
                delta=(bh, sq) if dbias else None)


def _plan_workspace(plan, device):
    n = plan["workspace"]
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def flash_fwd_split_plain(q, k, v, bias, causal, scale, splits, split_tiles,
                          kv_lengths=None, rate=0.0, seed=0):
    """The pipe's split forward in plain PyTorch: each row's keys cut into
    ``splits`` runs of ``split_tiles`` 64-key tiles, each run's base-2
    (m, l, acc) partial formed alone (m from -1e30, l over the undropped
    p, acc over the dropped p rounded to v's dtype against the running max
    after each tile of the run), then merged in split order through their
    maxima: o = sum acc_i 2^(m_i - M) / sum l_i 2^(m_i - M), lse = (M +
    log2 l) ln 2, l = 0 giving o = 0 and M's lse, as the unsplit forward.
    Returns (o, lse) as `flash_unpacked_fwd_plain`."""
    s = _unpacked_scores(q, k, bias, causal, scale, kv_lengths)
    keep = (_dropout.keep_mask(seed, rate, s.shape, device=s.device)
            if rate > 0.0 else None)
    span = split_tiles * _FWD_TILE
    ms, ls, accs = [], [], []
    for i in range(splits):
        si = s[..., i * span:(i + 1) * span]
        m = si.amax(dim=-1, keepdim=True).clamp(min=NEG_INF) if si.shape[
            -1] else torch.full(s.shape[:-1] + (1,), NEG_INF)
        ls.append(torch.exp2(si - m).sum(dim=-1))
        p = _p_rounded(si, m, _FWD_TILE, v.dtype,
                       None if keep is None
                       else keep[..., i * span:(i + 1) * span], rate)
        accs.append(torch.einsum("bqk,bkd->bqd", p,
                                 v[:, i * span:(i + 1) * span].float()))
        ms.append(m[..., 0])
    m, l = torch.stack(ms, -1), torch.stack(ls, -1)
    mx = m.amax(dim=-1)
    f = torch.exp2(m - mx[..., None])
    lsum = (l * f).sum(dim=-1)
    acc = (torch.stack(accs, -2) * f[..., None]).sum(dim=-2)
    safe = torch.where(lsum > 0.0, lsum, 1.0)
    return (acc / safe[..., None]).to(q.dtype), (mx + torch.log2(safe)) * LN2


FLASH_UNPACKED_FWD = Kernel(
    name="flash_unpacked_fwd",
    source="flash_unpacked_fwd.cu",
    symbol="flash_unpacked_fwd",
    argtypes=[_P] * 5 + [ctypes.POINTER(_I64), _P, _I, _P] + [_I] * 7
    + [_U, _U, _F, _F, _F, _I, _I, _P, _I, _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:170 _fwd_kernel (via "
             "_fwd)",
)
FLASH_UNPACKED_BWD = Kernel(
    name="flash_unpacked_bwd",
    source="flash_unpacked_bwd.cu",
    symbol="flash_unpacked_bwd",
    argtypes=[_P] * 12 + [ctypes.POINTER(_I64), _P, _I, _P] + [_I] * 7
    + [_U, _U, _F, _F, _F, _I, _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:316 _bwd_dkv_kernel, "
             ":384 _bwd_dq_kernel (via _bwd)",
)
FLASH_DBIAS = Kernel(
    name="flash_dbias",
    source="flash_dbias.cu",
    symbol="flash_dbias",
    argtypes=[_P] * 7 + [ctypes.POINTER(_I64), _P, _I, _P] + [_I] * 7
    + [_U, _U, _F, _F, _I, _P],
    replaces="rocm_apex_tpu/ops/flash_attention.py:440 _bwd_dbias_kernel",
)


def _strides(*ts):
    """(batch, head, row) element strides of 4-d (B, H, S, D) operands,
    flattened for the kernels' int64 table."""
    vals = [s for t in ts for s in t.stride()[:3]]
    return (_I64 * len(vals))(*vals)


def _aligned(t):
    """``t`` as the kernels read it: unit stride on head_dim, every other
    stride and the base 16-byte aligned (a copy only where it is not)."""
    vec = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        return t.contiguous()
    return t


def _rows_layout(B, H, S, D, dtype, device, bshd):
    """An output (B, H, S, D) view; with ``bshd`` its memory is (B, S, H,
    D), the layout the output projection reads without a copy."""
    if bshd:
        return torch.empty((B, S, H, D), dtype=dtype,
                           device=device).permute(0, 2, 1, 3)
    return torch.empty((B, H, S, D), dtype=dtype, device=device)


def _unpacked_common(q, k, v, bias, kv_lengths):
    """Checks shared by the forward and backward wrappers on 4-d (B, H,
    S, D) operands; returns (nb, fp32 contiguous bias, int32 lengths)."""
    B, H, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[-1] != d:
        raise ValueError(f"q/k/v shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match")
    nb = 0
    if bias is not None:
        if bias.dim() != 3 or bias.shape[1:] != (sq, k.shape[2]):
            raise ValueError(f"bias must be (nb, {sq}, {k.shape[2]}), got "
                             f"{tuple(bias.shape)}")
        _bias_groups(bias, B * H)
        nb = bias.shape[0]
    if q.device.type != "cuda":
        if q.device.type != "cpu":
            raise RuntimeError(f"no kernel for device {q.device}")
        return nb, bias, kv_lengths
    if d not in _UNPACKED_HEAD_DIMS:
        raise ValueError(f"the unpacked CUDA attention kernels take head_dim "
                         f"in {_UNPACKED_HEAD_DIMS}, got {d}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of "
                        f"{tuple(DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    if kv_lengths is not None:
        if kv_lengths.shape != (B * H,):
            raise ValueError(f"kv_lengths must be ({B * H},)")
        kv_lengths = kv_lengths.to(device=q.device,
                                   dtype=torch.int32).contiguous()
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("the kernels index rows with 32-bit ints")
    return nb, bias, kv_lengths


def _flat(t):
    """(B, H, S, D) -> (B*H, S, D) for the plain versions."""
    return t.reshape(-1, *t.shape[2:])


def _unpacked_fwd(q, k, v, bias, causal, scale, kv_lengths, rate, seed,
                  bshd=False):
    """The forward wrapper on (B, H, S, D) operands read by strides:
    returns o (B, H, Sq, D) in q's dtype and lse (B*H, Sq) fp32."""
    nb, bias, kv_lengths = _unpacked_common(q, k, v, bias, kv_lengths)
    B, H, sq, d = q.shape
    sk = k.shape[2]
    if q.device.type == "cpu":
        o, lse = flash_unpacked_fwd_plain(_flat(q), _flat(k), _flat(v), bias,
                                          causal, scale, kv_lengths, rate,
                                          seed)
        return o.view(B, H, sq, d), lse
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = _rows_layout(B, H, sq, d, q.dtype, q.device, bshd)
    lse = torch.empty((B * H, sq), dtype=torch.float32, device=q.device)
    if o.numel() > 0:
        plan = flash_fwd_plan(B * H, sq, sk, d, causal, sm_count(q.device),
                              q.dtype)
        FLASH_UNPACKED_FWD(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), _strides(q, k, v, o),
            ptr(bias), nb, ptr(kv_lengths), B, H, sq, sk, d,
            int(bool(causal)), int(rate > 0.0), int(seed) & 0xFFFFFFFF,
            _dropout.threshold(rate), _dropout.keep_scale(rate),
            _q_mul(scale, q.dtype), float(scale), plan["splits"],
            plan["split_tiles"], ptr(_plan_workspace(plan, q.device)),
            dtype_code(q.dtype), stream_ptr(q.device),
        )
    return o, lse


def _unpacked_bwd(q, k, v, bias, o, lse, do, dlse, causal, scale,
                  kv_lengths, rate, seed, compute_dbias, bshd=False):
    """The backward wrapper: dq, dk, dv as (B, H, S, D) in the operands'
    dtype and, with ``compute_dbias``, the fp32 (nb, Sq, Sk) bias
    gradient (the dbias kernel, after the dq pass has written delta). The
    buffers are those `flash_unpacked_bwd_plan` names."""
    nb, bias, kv_lengths = _unpacked_common(q, k, v, bias, kv_lengths)
    B, H, sq, d = q.shape
    sk = k.shape[2]
    if q.device.type == "cpu":
        dq, dk, dv, dbias = flash_unpacked_bwd_plain(
            _flat(q), _flat(k), _flat(v), bias, _flat(o), lse, _flat(do),
            causal, scale, kv_lengths, rate, seed, dlse, compute_dbias)
        return (dq.view(q.shape), dk.view(k.shape), dv.view(v.shape), dbias)
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do.to(q.dtype)))
    lse = lse.contiguous()
    if dlse is not None:
        dlse = dlse.to(torch.float32).contiguous()
    dq = _rows_layout(B, H, sq, d, q.dtype, q.device, bshd)
    dk = _rows_layout(B, H, sk, d, q.dtype, q.device, bshd)
    dv = _rows_layout(B, H, sk, d, q.dtype, q.device, bshd)
    plan = flash_unpacked_bwd_plan(B * H, sq, sk, d, causal, q.dtype,
                                   compute_dbias)
    stats = torch.empty(plan["stats"], dtype=torch.float32, device=q.device)
    delta = (torch.empty(plan["delta"], dtype=torch.float32,
                         device=q.device)
             if plan["delta"] is not None else None)
    flags = (B, H, sq, sk, d, int(bool(causal)), int(rate > 0.0),
             int(seed) & 0xFFFFFFFF, _dropout.threshold(rate),
             _dropout.keep_scale(rate), _q_mul(scale, q.dtype))
    if dq.numel() > 0 or dk.numel() > 0:
        FLASH_UNPACKED_BWD(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(do), ptr(dlse),
            ptr(dq), ptr(dk), ptr(dv), ptr(stats), ptr(delta),
            _strides(q, k, v, o, do, dq, dk, dv), ptr(bias), nb,
            ptr(kv_lengths), *flags, float(scale), dtype_code(q.dtype),
            stream_ptr(q.device),
        )
    dbias = None
    if compute_dbias:
        # on the CUDA cores the stats are delta itself
        dbias = _flash_dbias(q, k, v, bias, lse, do,
                             stats if delta is None else delta, causal,
                             scale, kv_lengths, rate, seed)
    return dq, dk, dv, dbias


def _flash_dbias(q, k, v, bias, lse, do, delta, causal, scale, kv_lengths,
                 rate, seed):
    """The dbias kernel on card operands as `_unpacked_bwd` prepares them,
    ``delta`` (B*H, Sq) fp32 = rowsum(do * o) - dlse: the fp32 (nb, Sq,
    Sk) gradient of the bias."""
    B, H, sq, d = q.shape
    nb, sk = bias.shape[0], k.shape[2]
    dbias = torch.empty((nb, sq, sk), dtype=torch.float32, device=q.device)
    if dbias.numel() > 0:
        FLASH_DBIAS(
            ptr(q), ptr(k), ptr(v), ptr(lse), ptr(do), ptr(delta),
            ptr(dbias), _strides(q, k, v, do), ptr(bias), nb,
            ptr(kv_lengths), B, H, sq, sk, d, int(bool(causal)),
            int(rate > 0.0), int(seed) & 0xFFFFFFFF,
            _dropout.threshold(rate), _dropout.keep_scale(rate),
            _q_mul(scale, q.dtype), dtype_code(q.dtype),
            stream_ptr(q.device),
        )
    return dbias


class _FlashUnpacked(torch.autograd.Function):
    """Attention over (B, H, S, D) operands: returns (o, lse); the lse
    cotangent folds into delta. ``bshd`` lays o and the gradients out as
    (B, S, H, D) memory."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_lengths, seed, rate, causal, scale,
                compute_dbias, bshd):
        o, lse = _unpacked_fwd(q, k, v, bias, causal, scale, kv_lengths,
                               rate, seed, bshd)
        ctx.save_for_backward(q, k, v, bias, kv_lengths, o, lse)
        ctx.args = (causal, scale, rate, seed, compute_dbias, bshd)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, kv_lengths, o, lse = ctx.saved_tensors
        causal, scale, rate, seed, compute_dbias, bshd = ctx.args
        if do is None:
            do = torch.zeros_like(o)
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = _unpacked_bwd(
            q, k, v, bias, o, lse, do, dlse, causal, scale, kv_lengths, rate,
            seed, want_dbias and compute_dbias, bshd)
        if want_dbias:
            # compute_dbias=False (a constant mask): exact zeros, no launch
            dbias = (torch.zeros_like(bias) if dbias is None
                     else dbias.to(bias.dtype))
        return (dq, dk, dv, dbias) + (None,) * 7


def _unpacked(q, k, v, bias, kv_lengths, seed, rate, causal, scale,
              compute_dbias):
    """The public (bh, s, d) form over `_FlashUnpacked`."""
    if q.dim() != 3:
        raise ValueError(f"q/k/v must be (batch*heads, seq, head_dim), got "
                         f"{tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    o, lse = _FlashUnpacked.apply(
        q[None], k[None], v[None], bias, kv_lengths, int(seed), float(rate),
        bool(causal), float(scale), bool(compute_dbias), False)
    return o[0], lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, causal: bool = False,
                    scale: Optional[float] = None,
                    compute_dbias: bool = False) -> torch.Tensor:
    """Flash attention over (batch*heads, seq, head_dim) operands.

    ``bias`` is an additive (nb, sq, sk) tensor, nb in {1, batch,
    batch*heads} (row i uses bias row ``i // (bh // nb)``), added in fp32
    after the q.k scaling; -1e30 masks. ``causal`` masks keys past the
    query's own index (top-left aligned when sq != sk). ``scale``
    defaults to 1/sqrt(head_dim). Differentiable in q/k/v, and in bias
    with ``compute_dbias=True`` (the dbias kernel); otherwise the bias
    gradient is exact zeros, with no launch.

    A row whose every live score carries the -1e30 bias gives o = 0 and
    lse = -1e30 * ln 2. So does the JAX kernel without ``causal``; with
    it, the JAX value of such a row is the mean of v over the causally
    masked keys of the key blocks it visits, which changes with block_k
    (no model reaches that case)."""
    return _unpacked(q, k, v, bias, None, 0, 0.0, causal, scale,
                     compute_dbias)[0]


def flash_attention_varlen(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lengths: torch.Tensor, causal: bool = False,
                           scale: Optional[float] = None) -> torch.Tensor:
    """`flash_attention` with a per-row real key length: row b attends
    keys ``[0, kv_lengths[b])`` (``kv_lengths`` (batch*heads,) int32). A
    row of length 0 has unspecified output. Differentiable in q/k/v."""
    return _unpacked(q, k, v, None, kv_lengths, 0, 0.0, causal, scale,
                     False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             compute_dbias: bool = False):
    """`flash_attention` also returning the per-row natural-log
    log-sum-exp (bh, sq) fp32, the mergeable partial form; the lse
    cotangent folds into the backward's delta."""
    return _unpacked(q, k, v, bias, None, 0, 0.0, causal, scale,
                     compute_dbias)


def flash_attention_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: Optional[torch.Tensor], dropout_seed,
                            dropout_rate: float, causal: bool = False,
                            scale: Optional[float] = None,
                            compute_dbias: bool = False) -> torch.Tensor:
    """`flash_attention` with in-kernel attention dropout (softmax ->
    dropout -> @ v; the normalizer from the undropped probabilities).
    Element (row, col) of operand row i is kept iff `ops._dropout`'s hash
    of (dropout_seed, i, row, col) clears the rate: the packed kernels'
    bits, stream = batch*heads + head."""
    return _unpacked(q, k, v, bias, None, dropout_seed, dropout_rate, causal,
                     scale, compute_dbias)[0]


def flash_attention_heads(q, k, v, bias=None, causal=False, scale=None,
                          dropout_seed=None, dropout_rate=0.0):
    """The model's form: q/k/v as (B, H, S, D) views (the per-head
    columns of the fused projection, read in place through their
    strides, no copy); returns the (B, S, H*D) context, whose memory the
    kernel wrote in that layout. ``bias`` and dropout as in
    `flash_attention_dropout` (no dropout without a seed)."""
    B, H, sq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    o, _ = _FlashUnpacked.apply(
        q, k, v, bias, None, int(dropout_seed or 0), rate, bool(causal),
        float(scale), False, True)
    return o.permute(0, 2, 1, 3).reshape(B, sq, H * d)
