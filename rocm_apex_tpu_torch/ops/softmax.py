"""Scaled causal and padding-masked softmax over materialized attention
scores, and its backward: the hand-written CUDA kernels, their plain
PyTorch versions, and the autograd functions over them.

Port of ``rocm_apex_tpu/ops/softmax.py``. The kernels (``csrc/softmax.cu``)
replace the TPU kernels ``_causal_fwd_kernel`` (rocm_apex_tpu/ops/
softmax.py:46), ``_masked_fwd_kernel`` (:139) and ``_softmax_bwd_kernel``
(:62). Per row of the last axis, all in fp32 whatever the storage dtype,
the output rounded once to the input's dtype (fp16 thus takes the JAX
wrapper's fp32 upcast):

    causal:  y = softmax(scale * x), column > row set to -inf
    masked:  y = softmax(where(mask, MASK_FILL, scale * x))
    both:    dx = scale * y * (dy - sum(y * dy))

The causal form masks with -inf, so the upper triangle is exactly 0 (in
dx too). The masked form fills with the finite -10000 after scaling, so
a fully masked row comes out as the uniform average over its keys (BERT's
padded query rows): that is the value the JAX kernel gives, where the
flash kernels give 0. The mask is bool, True = masked, broadcastable to
(b, 1, sq, sk): one mask for every head. It gets no gradient. There is no
key-length ceiling (the JAX kernels keep up to ~16K fp32 keys resident).
Both forwards' rows of up to 2048 keys are held in registers, read once
(the causal form: only the columns at or left of the diagonal) and
written once; longer rows are read twice, the second time from L2
(`softmax_fwd_plan` names the route).

For a CUDA tensor the wrappers launch the kernel (or raise); for a CPU
tensor they run the plain version.
"""

import ctypes
import functools
from typing import Optional

import torch

from rocm_apex_tpu_torch.ops._build import DTYPE_CODES, Kernel, ptr, stream_ptr

__all__ = [
    "MASK_FILL",
    "ScoresFp32",
    "SOFTMAX_CAUSAL_FWD",
    "SOFTMAX_MASKED_FWD",
    "SOFTMAX_BWD",
    "causal_softmax_fwd_plain",
    "masked_softmax_fwd_plain",
    "softmax_bwd_plain",
    "softmax_causal_fwd",
    "softmax_masked_fwd",
    "softmax_bwd",
    "scaled_upper_triang_masked_softmax",
    "scaled_masked_softmax",
    "softmax_fwd_plan",
]

MASK_FILL = -10000.0  # the padding-masked form's fill, after scaling

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SOFTMAX_CAUSAL_FWD = Kernel(
    name="softmax_causal_fwd",
    source="softmax.cu",
    symbol="softmax_causal_fwd",
    argtypes=[_P, _P, _L, _I, _I, _F, _I, _I, _I, _P],
    replaces="rocm_apex_tpu/ops/softmax.py:46 _causal_fwd_kernel",
)
SOFTMAX_MASKED_FWD = Kernel(
    name="softmax_masked_fwd",
    source="softmax.cu",
    symbol="softmax_masked_fwd",
    argtypes=[_P, _P, _P, _L, _I, _I, _I, _L, _L, _L, _F, _I, _I, _I, _I,
              _P],
    replaces="rocm_apex_tpu/ops/softmax.py:139 _masked_fwd_kernel",
)
SOFTMAX_BWD = Kernel(
    name="softmax_bwd",
    source="softmax.cu",
    symbol="softmax_bwd",
    argtypes=[_P, _P, _P, _L, _I, _F, _I, _P],
    replaces="rocm_apex_tpu/ops/softmax.py:62 _softmax_bwd_kernel",
)

# these kernels also take fp16 (csrc/common.cuh kFloat16)
_CODES = {**DTYPE_CODES, torch.float16: 2}
# rows up to this many keys take the forwards' register row
# (csrc/softmax.cu kWarpRowMax)
_WARP_ROW_MAX = 2048
_ROWS_PER_BLOCK = 8  # csrc/softmax.cu kSoftmaxWarps


@functools.lru_cache(maxsize=None)
def softmax_fwd_plan(rows: int, sk: int, dtype: torch.dtype, masked: bool,
                     mask_sk: Optional[int], aligned: bool = True,
                     mask_aligned: bool = True) -> dict:
    """The route of the masked (``masked``, row 12 K2) or the causal
    forward (K1) for ``rows`` rows of ``sk`` keys in ``dtype``: ``route``,
    ``vec`` (elements a load), ``vectors`` (loads a lane), ``mask`` (how
    the mask is read) and ``grid``.

    ``"register"`` for rows of up to `_WARP_ROW_MAX` keys: a warp a row,
    8 rows a block, each lane holding ``vectors`` (a power of two) vectors
    of ``vec`` in registers. ``vec`` is 16 bytes of elements where the
    row's bytes are a multiple of 16 and x and y are 16-byte ``aligned``,
    else 1. The mask (``mask_sk``, its last stride; None: no mask) is
    read as ``"vector"``s of ``vec`` bytes where ``vec`` > 1, ``mask_sk``
    is 1 and its rows are ``vec``-byte aligned (``mask_aligned``), else
    ``"strided"``, a byte a column. Longer rows take ``"streaming"`` (a
    block a row, two passes, the mask strided). The causal forward takes
    the same routes with no mask (``mask_sk`` None): its register row
    loads only the vectors at or left of the diagonal. The backward (K3)
    keeps its one layout. A shape rule, decided here before any launch;
    cached, so a call pays a lookup (the dict is shared: read it, do not
    change it)."""
    if not masked:
        mask_sk = None
    kvec = 16 // torch.empty((), dtype=dtype).element_size()
    vec = kvec if aligned and sk % kvec == 0 else 1
    form = None if mask_sk is None else "strided"
    if sk > _WARP_ROW_MAX:
        return dict(route="streaming", vec=vec, vectors=0, mask=form,
                    grid=rows)
    if form is not None and vec > 1 and mask_sk == 1 and mask_aligned:
        form = "vector"
    vectors = 1 << max(0, -(-sk // (32 * vec)) - 1).bit_length()
    return dict(route="register", vec=vec, vectors=vectors, mask=form,
                grid=-(-rows // _ROWS_PER_BLOCK))


def _max_sub_softmax(x: torch.Tensor) -> torch.Tensor:
    x = x - x.amax(dim=-1, keepdim=True)
    e = torch.exp(x)
    return e / e.sum(dim=-1, keepdim=True)


def causal_softmax_fwd_plain(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain PyTorch version of the causal forward: (..., sq, sk) ->
    y in x's dtype, column > row at -inf, fp32 inside."""
    sq, sk = x.shape[-2:]
    upper = torch.ones(sq, sk, dtype=torch.bool, device=x.device).triu(1)
    xf = (x.float() * scale).masked_fill(upper, float("-inf"))
    return _max_sub_softmax(xf).to(x.dtype)


def masked_softmax_fwd_plain(x: torch.Tensor, mask: Optional[torch.Tensor],
                             scale: float) -> torch.Tensor:
    """The plain PyTorch version of the masked forward: (b, h, sq, sk) and
    a bool mask broadcastable to (b, 1, sq, sk) (None: nothing masked) ->
    y in x's dtype, masked scores at `MASK_FILL` after scaling."""
    xf = x.float() * scale
    if mask is not None:
        xf = torch.where(mask.to(torch.bool), MASK_FILL, xf)
    return _max_sub_softmax(xf).to(x.dtype)


def softmax_bwd_plain(y: torch.Tensor, dy: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """The plain PyTorch version of the backward: dx = scale * y * (dy -
    sum(y * dy)) over the last axis in fp32, in y's dtype."""
    yf, dyf = y.float(), dy.float()
    s = (yf * dyf).sum(dim=-1, keepdim=True)
    return (scale * yf * (dyf - s)).to(y.dtype)


def _code(x: torch.Tensor) -> int:
    if x.dtype not in _CODES:
        raise TypeError(f"the softmax kernels take float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    return _CODES[x.dtype]


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")


def softmax_causal_fwd(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The causal forward on (b, sq, sk) scores; not differentiable."""
    if x.dim() != 3:
        raise ValueError(f"expected (b, sq, sk) scores, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return causal_softmax_fwd_plain(x, scale)
    _require_cuda(x)
    code = _code(x)
    x = x.contiguous()
    b, sq, sk = x.shape
    y = torch.empty_like(x)
    if y.numel():
        plan = softmax_fwd_plan(b * sq, sk, x.dtype, False, None,
                                aligned=x.data_ptr() % 16 == 0)
        SOFTMAX_CAUSAL_FWD(ptr(x), ptr(y), b * sq, sq, sk, float(scale),
                           plan["vec"], plan["vectors"], code,
                           stream_ptr(x.device))
    return y


def _expand_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    b, _, sq, sk = x.shape
    if mask.dim() != 4:
        raise ValueError(f"expected a (b|1, 1, sq|1, sk) mask, got "
                         f"{tuple(mask.shape)}")
    return mask.to(torch.bool).expand(b, 1, sq, sk)


def _masked_plan_of(x: torch.Tensor, mask: Optional[torch.Tensor]) -> dict:
    """`softmax_fwd_plan` for the masked forward on contiguous (b, h, sq,
    sk) CUDA scores and the mask expanded to (b, 1, sq, sk) (y is a new
    allocation, 16-byte aligned)."""
    b, h, sq, sk = x.shape
    kvec = 16 // x.element_size()
    return softmax_fwd_plan(
        b * h * sq, sk, x.dtype, True,
        None if mask is None else mask.stride(3),
        aligned=x.data_ptr() % 16 == 0,
        mask_aligned=mask is not None and all(
            v % kvec == 0
            for v in (mask.data_ptr(), mask.stride(0), mask.stride(2))))


def softmax_masked_fwd(x: torch.Tensor, mask: Optional[torch.Tensor],
                       scale: float) -> torch.Tensor:
    """The padding-masked forward on (b, h, sq, sk) scores; the mask is
    read in place through its broadcast strides. Not differentiable."""
    if x.dim() != 4:
        raise ValueError(f"expected (b, h, sq, sk) scores, got "
                         f"{tuple(x.shape)}")
    if mask is not None:
        mask = _expand_mask(mask, x)
    if x.device.type == "cpu":
        return masked_softmax_fwd_plain(x, mask, scale)
    _require_cuda(x)
    code = _code(x)
    x = x.contiguous()
    b, h, sq, sk = x.shape
    strides = (0, 0, 0)
    if mask is not None:
        if mask.device != x.device:
            raise ValueError("the mask must lie on the scores' device")
        strides = (mask.stride(0), mask.stride(2), mask.stride(3))
    y = torch.empty_like(x)
    if y.numel():
        plan = _masked_plan_of(x, mask)
        SOFTMAX_MASKED_FWD(ptr(x), ptr(mask), ptr(y), b * h * sq, h, sq, sk,
                           *strides, float(scale), plan["vec"],
                           plan["vectors"], int(plan["mask"] == "vector"),
                           code, stream_ptr(x.device))
    return y


def softmax_bwd(y: torch.Tensor, dy: torch.Tensor,
                scale: float) -> torch.Tensor:
    """dx of either forward from its output ``y`` and the cotangent ``dy``
    (taken in y's dtype), in y's dtype."""
    if dy.shape != y.shape:
        raise ValueError(f"y {tuple(y.shape)} and dy {tuple(dy.shape)} differ")
    if y.device.type == "cpu":
        return softmax_bwd_plain(y, dy, scale)
    _require_cuda(y)
    code = _code(y)
    y = y.contiguous()
    dy = dy.to(device=y.device, dtype=y.dtype).contiguous()
    dx = torch.empty_like(y)
    if dx.numel():
        sk = y.shape[-1]
        SOFTMAX_BWD(ptr(y), ptr(dy), ptr(dx), y.numel() // sk, sk,
                    float(scale), code, stream_ptr(y.device))
    return dx


class _CausalSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        y = softmax_causal_fwd(x, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return softmax_bwd(y, dy, ctx.scale), None


class _MaskedSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, scale):
        y = softmax_masked_fwd(x, mask, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return softmax_bwd(y, dy, ctx.scale), None, None


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float) -> torch.Tensor:
    """softmax(scale * x) with causal masking on (b, sq, sk) scores, in x's
    dtype; the JAX function of this name. Differentiable in x."""
    return _CausalSoftmax.apply(x, float(scale))


def scaled_masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """softmax(scale * x masked_fill mask) on (b, h, sq, sk) scores, in x's
    dtype; the JAX function of this name. ``mask`` is bool, True = masked,
    broadcast over heads from (b|1, 1, sq|1, sk); None masks nothing (the
    all-False mask). Differentiable in x; the mask gets no gradient."""
    return _MaskedSoftmax.apply(x, mask, float(scale))


class ScoresFp32(torch.autograd.Function):
    """q·kᵀ over the last axis as fp32 scores from q, k in the compute
    dtype: the JAX einsum's ``preferred_element_type=float32``
    (rocm_apex_tpu/models/gpt.py:1012-1014): the scores that the GPT's
    materialized paths and the multi-head attention's dropout branch feed
    the softmax. A 16-bit matmul would round the scores to 16 bits before
    the softmax; here the products of the 16-bit values are summed in
    fp32 and never rounded: on CUDA by cuBLAS with a 16-bit input and
    fp32 output (``torch.bmm(..., out_dtype=torch.float32)``), on the CPU
    by an fp32 product of the widened inputs (exact products, fp32 sums).
    The backward takes the fp32 cotangent to q's dtype and multiplies in
    it (one rounding of each fp32-accumulated gradient); in fp32 compute
    that is the exact transpose."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        kt = k.transpose(-1, -2)
        if q.dtype == torch.float32:
            return torch.matmul(q, kt)
        if q.device.type != "cuda":
            return torch.matmul(q.float(), kt.float())
        lead, (sq, hd), sk = q.shape[:-2], q.shape[-2:], k.shape[-2]
        return torch.bmm(q.reshape(-1, sq, hd), kt.reshape(-1, hd, sk),
                         out_dtype=torch.float32).view(*lead, sq, sk)

    @staticmethod
    def backward(ctx, ds):
        q, k = ctx.saved_tensors
        ds = ds.to(q.dtype)
        return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q)
