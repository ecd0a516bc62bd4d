"""Row LayerNorm forward and backward: the hand-written CUDA kernels,
their plain PyTorch versions, and the autograd functions over them.

Port of ``rocm_apex_tpu/ops/layer_norm.py``. The kernels
(``csrc/layer_norm.cu``) replace the TPU kernels ``_ln_fwd_kernel``
(rocm_apex_tpu/ops/layer_norm.py:78), plain, residual and with in-kernel
dropout on the residual delta, and ``_ln_bwd_kernel`` (:204). Both are
bound by bytes. The forward's layout is `ln_fwd_plan`'s, by shape: the
row held in registers (read, hashed and written once; a warp a row when
the rows fill the card, a block a row when they are few), or, for widths
off the 16-byte vector grid or past the register cap, the three-pass row
(one warp a row, re-read from L1 for the later passes). The backward
takes the same layouts (`ln_bwd_plan`): the row in registers, read and
written once, its grid walking the rows with two or three blocks a
multiprocessor, or off the vector grid the old warp-a-row form; it
reduces dgamma/dbeta in two fixed-order fp32 stages (a partial row a
block, then a column reduction). Without a weight (the non-affine form,
``layer_norm``) it reduces nothing: g = dy, dx alone.

For a CUDA tensor the wrappers launch the kernels (or raise); for a CPU
tensor they run the plain versions. Statistics are fp32 whatever the
storage dtype; the residual forms return ``(LN(x + delta), x + delta)``
with the stream in x's dtype and the normalization computed from the
fp32 sum, as the TPU kernel does. Dropout keeps element (row, col) of
the delta iff ``ops/_dropout``'s hash of (seed, 0, row, col) clears the
rate's threshold; the backward regenerates the same bits.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rocm_apex_tpu_torch.ops import _dropout
from rocm_apex_tpu_torch.ops._build import (
    Kernel,
    dtype_code,
    ptr,
    sm_count,
    stream_ptr,
)

__all__ = [
    "LN_FWD",
    "LN_FWD_DROPOUT",
    "LN_BWD",
    "LN_BWD_NOAFFINE",
    "layer_norm",
    "layer_norm_fwd",
    "layer_norm_affine",
    "layer_norm_residual_affine",
    "layer_norm_residual_dropout_affine",
    "layer_norm_fwd_plain",
    "layer_norm_bwd_plain",
    "ln_fwd_plan",
    "ln_bwd_plan",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_FWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _U, _U, _F,
             _I, _I, _I, _I, _I, _P]
LN_FWD = Kernel(
    name="layer_norm_fwd",
    source="layer_norm.cu",
    symbol="ln_fwd",
    argtypes=_FWD_ARGS,
    replaces="rocm_apex_tpu/ops/layer_norm.py:78 _ln_fwd_kernel",
)
# the same kernel with dropout on the delta: counted apart, so a run
# shows how many of its LayerNorms took the dropout form
LN_FWD_DROPOUT = Kernel(
    name="layer_norm_fwd_dropout",
    source="layer_norm.cu",
    symbol="ln_fwd",
    argtypes=_FWD_ARGS,
    replaces="rocm_apex_tpu/ops/layer_norm.py:78 _ln_fwd_kernel",
)
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U,
             _U, _F, _I, _I, _I, _I, _I, _I, _P]
LN_BWD = Kernel(
    name="layer_norm_bwd",
    source="layer_norm.cu",
    symbol="ln_bwd",
    argtypes=_BWD_ARGS,
    replaces="rocm_apex_tpu/ops/layer_norm.py:204 _ln_bwd_kernel",
)
# the same kernel without a weight (affine=False): no dgamma/dbeta and
# no reduction launch; counted apart
LN_BWD_NOAFFINE = Kernel(
    name="layer_norm_bwd_noaffine",
    source="layer_norm.cu",
    symbol="ln_bwd",
    argtypes=_BWD_ARGS,
    replaces="rocm_apex_tpu/ops/layer_norm.py:204 _ln_bwd_kernel "
             "(affine=False)",
)
_BWD_ROWS_PER_BLOCK = 32  # csrc/layer_norm.cu kBwdRowsPerBlock (old form)
# the register backward's grid: blocks a multiprocessor by the element
# size of x (csrc/layer_norm.cu ln_bwd_blocks_per_sm)
_LN_BWD_BLOCKS_PER_SM = {2: 3, 4: 2}
# the register row (csrc/layer_norm.cu): at most kLnMaxValues fp32 values
# a thread, kLnMaxRowWarps warps a row, kLnWarpRowThreads threads a block
# of warp rows
_LN_MAX_VALUES = 32
_LN_MAX_ROW_WARPS = 8
_LN_WARP_ROW_THREADS = 128
# rows fill the card, a warp each, from this many a multiprocessor
_LN_FILL_ROWS_PER_SM = 8


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=None)
def ln_fwd_plan(rows: int, hidden: int, dtype: torch.dtype, sms: int,
                aligned: bool = True) -> dict:
    """How the LN forward launches on ``sms`` multiprocessors for a (rows,
    hidden) input of ``dtype``: its ``route``, ``row_warps`` (warps a row),
    ``vectors`` (16-byte vectors of x a thread), ``threads`` (a block) and
    ``grid`` (blocks).

    The register row holds each thread's columns, ``vectors`` vectors of
    16 bytes, in registers: at most `_LN_MAX_VALUES` values a thread,
    ``vectors`` a power of two. ``"warp"``, a warp a row, four rows a
    block, when the rows fill the card (`_LN_FILL_ROWS_PER_SM` a
    multiprocessor: the training and BERT shapes), unless the row needs
    more warps to keep under the cap; ``"block"``, a block of
    ``row_warps`` warps a row, when they are fewer (the serve's 8-row
    decode tick, its 264-row mixed tick), as many warps as give one
    vector a thread, at most `_LN_MAX_ROW_WARPS`. Widths that are not a
    whole number of vectors, rows past the cap at `_LN_MAX_ROW_WARPS`
    warps, and inputs not 16-byte ``aligned`` take ``"three_pass"`` (a
    warp a row, three strided passes, any width). A shape rule, decided
    here before any launch; cached, so a call pays a lookup (the dict is
    shared: read it, do not change it)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    need = -(-hidden // vec)  # vectors a row

    def vectors_at(warps):
        return _pow2_at_least(-(-need // (32 * warps)))

    if hidden % vec == 0 and aligned and need > 0:
        if rows >= _LN_FILL_ROWS_PER_SM * sms:
            warps = next((w for w in range(1, _LN_MAX_ROW_WARPS + 1)
                          if vectors_at(w) * vec <= _LN_MAX_VALUES), None)
        else:
            warps = min(_LN_MAX_ROW_WARPS, -(-need // 32))
            if vectors_at(warps) * vec > _LN_MAX_VALUES:
                warps = None
        if warps == 1:
            rows_per_block = _LN_WARP_ROW_THREADS // 32
            return dict(route="warp", row_warps=1, vectors=vectors_at(1),
                        threads=_LN_WARP_ROW_THREADS,
                        grid=-(-rows // rows_per_block))
        if warps is not None:
            return dict(route="block", row_warps=warps,
                        vectors=vectors_at(warps), threads=32 * warps,
                        grid=rows)
    return dict(route="three_pass", row_warps=0, vectors=0, threads=128,
                grid=-(-rows // 4))


@functools.lru_cache(maxsize=None)
def ln_bwd_plan(rows: int, hidden: int, dtype: torch.dtype, sms: int,
                aligned: bool = True) -> dict:
    """How the LN backward launches: `ln_fwd_plan`'s layout for the same
    shape (``route``, ``row_warps``, ``vectors``, ``threads``), its grid
    cut to walk the rows, and ``parts``, the rows of the (parts, 2,
    hidden) fp32 partials of dgamma/dbeta (one a block).

    ``"warp"`` (a warp a row, four a block) and ``"block"`` (a block of
    ``row_warps`` warps a row): ``grid`` = at most
    `_LN_BWD_BLOCKS_PER_SM` blocks a multiprocessor (three for a bf16 x,
    two for fp32, whose registers allow fewer), each row group
    walking rows g, g + groups, ...; ``"three_pass"`` (widths off the
    16-byte vector grid, past the register cap, or unaligned inputs) keeps
    the old form, a warp a row in blocks of 32 rows. ``aligned``: x, dy,
    ds, gamma (and the new dx, dd) at 16-byte addresses. Cached; read the
    dict, do not change it."""
    f = ln_fwd_plan(rows, hidden, dtype, sms, aligned)
    if f["route"] == "three_pass":
        blocks = -(-rows // _BWD_ROWS_PER_BLOCK)
        return dict(route="three_pass", row_warps=0, vectors=0, threads=128,
                    grid=blocks, parts=blocks)
    groups = -(-rows // (f["threads"] // (32 * f["row_warps"])))
    per_sm = _LN_BWD_BLOCKS_PER_SM[torch.empty((), dtype=dtype)
                                   .element_size()]
    grid = max(1, min(groups, per_sm * sms))
    return dict(route=f["route"], row_warps=f["row_warps"],
                vectors=f["vectors"], threads=f["threads"], grid=grid,
                parts=grid)


def _dropped(delta2d, rate, seed):
    d = delta2d.float()
    if rate > 0.0:
        keep = _dropout.keep_mask(seed, rate, d.shape, device=d.device)
        d = torch.where(keep, d * _dropout.keep_scale(rate), 0.0)
    return d


def layer_norm_fwd_plain(x2d, delta2d, weight, bias, eps, out_dtype,
                         rate=0.0, seed=0):
    """The plain PyTorch version: returns (y, s, mean, rsigma); s is None
    without a delta."""
    x = x2d.float()
    s = None
    if delta2d is not None:
        x = x + _dropped(delta2d, rate, seed)
        s = x.to(x2d.dtype)
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    rs = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rs
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(out_dtype), s, mu[:, 0], rs[:, 0]


def _check_device(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    for t in tensors:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("the LayerNorm kernels take contiguous tensors "
                             "on one device")


def _plan_of(x2d, delta2d, weight, bias) -> dict:
    """`ln_fwd_plan` for a call on these CUDA tensors (its outputs are new
    allocations, 16-byte aligned)."""
    rows, hidden = x2d.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2d, delta2d, weight, bias)
                  if t is not None)
    return ln_fwd_plan(rows, hidden, x2d.dtype, sm_count(x2d.device),
                       aligned)


def _ln_fwd_impl(x2d, delta2d, weight, bias, eps, out_dtype,
                 rate=0.0, seed=0):
    if x2d.dim() != 2:
        raise ValueError(f"expected a (rows, hidden) view, got {tuple(x2d.shape)}")
    rows, hidden = x2d.shape
    out_dtype = out_dtype or x2d.dtype
    if delta2d is not None and (
        delta2d.shape != x2d.shape or delta2d.dtype != x2d.dtype
    ):
        raise ValueError(
            f"delta {tuple(delta2d.shape)}/{delta2d.dtype} must match the "
            f"stream {tuple(x2d.shape)}/{x2d.dtype}"
        )
    if (weight is None) != (bias is None):
        raise ValueError("pass both weight and bias, or neither")
    if rate > 0.0 and delta2d is None:
        raise ValueError("in-kernel dropout rides the residual form")
    if x2d.device.type == "cpu":
        return layer_norm_fwd_plain(x2d, delta2d, weight, bias, eps,
                                    out_dtype, rate, seed)
    _check_device(x2d, delta2d, weight, bias)
    if weight is not None and (
        weight.shape != (hidden,) or bias.shape != (hidden,)
        or bias.dtype != weight.dtype
    ):
        raise ValueError("weight/bias must both be (hidden,) of one dtype")
    y = torch.empty((rows, hidden), dtype=out_dtype, device=x2d.device)
    s = torch.empty_like(x2d) if delta2d is not None else None
    mean = torch.empty((rows,), dtype=torch.float32, device=x2d.device)
    rsigma = torch.empty_like(mean)
    if rows > 0:
        w_code = dtype_code(weight.dtype) if weight is not None else 0
        plan = _plan_of(x2d, delta2d, weight, bias)
        kernel = LN_FWD_DROPOUT if rate > 0.0 else LN_FWD
        kernel(
            ptr(x2d), ptr(delta2d), ptr(weight), ptr(bias), ptr(y), ptr(s),
            ptr(mean), ptr(rsigma), rows, hidden, float(eps),
            int(rate > 0.0), int(seed) & 0xFFFFFFFF,
            _dropout.threshold(rate), _dropout.keep_scale(rate),
            dtype_code(x2d.dtype), w_code, dtype_code(out_dtype),
            plan["row_warps"], plan["vectors"], stream_ptr(x2d.device),
        )
    return y, s, mean, rsigma


def layer_norm_bwd_plain(x2d, dy, ds, mean, rsigma, weight, rate=0.0,
                         seed=0):
    """The plain PyTorch version of the backward: returns (dx, dd, dgamma,
    dbeta); dd is None without dropout, dgamma and dbeta None without a
    ``weight`` (the non-affine form, g = dy)."""
    xh = (x2d.float() - mean[:, None]) * rsigma[:, None]
    g = dy.float()
    gg = g * weight.float() if weight is not None else g
    c1 = gg.mean(dim=1, keepdim=True)
    c2 = (gg * xh).mean(dim=1, keepdim=True)
    dx = rsigma[:, None] * (gg - c1 - xh * c2)
    if ds is not None:
        dx = dx + ds.float()
    dd = None
    if rate > 0.0:
        keep = _dropout.keep_mask(seed, rate, dx.shape, device=dx.device)
        dd = torch.where(keep, dx * _dropout.keep_scale(rate), 0.0)
        dd = dd.to(x2d.dtype)
    if weight is None:
        return dx.to(x2d.dtype), dd, None, None
    return (dx.to(x2d.dtype), dd, (g * xh).sum(dim=0).to(weight.dtype),
            g.sum(dim=0).to(weight.dtype))


def _layer_norm_bwd(x2d, dy, ds, mean, rsigma, weight, rate=0.0, seed=0):
    """LN backward on (rows, hidden): x2d is the forward's LN input (the
    stream s of the residual forms), ds the stream's cotangent or None,
    ``weight`` None for the non-affine form. Returns (dx, dd, dgamma,
    dbeta), dd None without dropout, dgamma/dbeta None without a
    weight."""
    if x2d.device.type == "cpu":
        return layer_norm_bwd_plain(x2d, dy, ds, mean, rsigma, weight,
                                    rate, seed)
    dy = dy.contiguous()
    ds = ds.contiguous() if ds is not None else None
    _check_device(x2d, dy, ds, mean, rsigma, weight)
    if ds is not None and ds.dtype != x2d.dtype:
        raise TypeError("the stream cotangent must be in the stream's dtype")
    rows, hidden = x2d.shape
    affine = weight is not None
    dx = torch.empty_like(x2d)
    dd = torch.empty_like(x2d) if rate > 0.0 else None
    dgamma = dbeta = None
    if affine:
        dgamma = torch.empty((hidden,), dtype=weight.dtype,
                             device=x2d.device)
        dbeta = torch.empty_like(dgamma)
    if rows == 0:
        if affine:
            dgamma.zero_(), dbeta.zero_()
        return dx, dd, dgamma, dbeta
    plan = ln_bwd_plan(rows, hidden, x2d.dtype, sm_count(x2d.device),
                       all(t.data_ptr() % 16 == 0
                           for t in (x2d, dy, ds, weight) if t is not None))
    part = (torch.empty((plan["parts"], 2, hidden), dtype=torch.float32,
                        device=x2d.device) if affine else None)
    kernel = LN_BWD if affine else LN_BWD_NOAFFINE
    kernel(
        ptr(x2d), ptr(dy), ptr(ds), ptr(mean), ptr(rsigma), ptr(weight),
        ptr(dx), ptr(dd), ptr(part), ptr(dgamma), ptr(dbeta), rows, hidden,
        int(rate > 0.0), int(seed) & 0xFFFFFFFF, _dropout.threshold(rate),
        _dropout.keep_scale(rate), dtype_code(x2d.dtype),
        dtype_code((weight if affine else x2d).dtype), dtype_code(dy.dtype),
        plan["row_warps"], plan["vectors"], plan["grid"],
        stream_ptr(x2d.device),
    )
    return dx, dd, dgamma, dbeta


class _LayerNorm(torch.autograd.Function):
    """Non-affine LN (rocm_apex_tpu/ops/layer_norm.py:360-378): the
    forward with no weight, the backward without dgamma/dbeta."""

    @staticmethod
    def forward(ctx, x2d, eps):
        y, _, mu, rs = _ln_fwd_impl(x2d, None, None, None, eps, None)
        ctx.save_for_backward(x2d, mu, rs)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, mu, rs = ctx.saved_tensors
        dx, _, _, _ = _layer_norm_bwd(x2d, dy, None, mu, rs, None)
        return dx, None


class _LayerNormAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, out_dtype):
        y, _, mu, rs = _ln_fwd_impl(x2d, None, weight, bias, eps, out_dtype)
        ctx.save_for_backward(x2d, weight, mu, rs)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, weight, mu, rs = ctx.saved_tensors
        dx, _, dg, db = _layer_norm_bwd(x2d, dy, None, mu, rs, weight)
        return dx, dg, db, None, None


class _LayerNormResidual(torch.autograd.Function):
    """(LN(x + dropout(delta)), x + dropout(delta)); the backward folds
    the stream cotangent into dx and regenerates the keep bits."""

    @staticmethod
    def forward(ctx, x2d, delta2d, weight, bias, seed, rate, eps, out_dtype):
        y, s, mu, rs = _ln_fwd_impl(x2d, delta2d, weight, bias, eps,
                                    out_dtype, rate, seed)
        ctx.save_for_backward(s, weight, mu, rs)
        ctx.rate, ctx.seed = rate, seed
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        s, weight, mu, rs = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(s.shape, dtype=weight.dtype, device=s.device)
        dx, dd, dg, db = _layer_norm_bwd(s, dy, ds, mu, rs, weight,
                                         ctx.rate, ctx.seed)
        return (dx, dx if dd is None else dd, dg, db, None, None, None, None)


def layer_norm_fwd(
    x2d: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LN forward on a (rows, hidden) view; returns (y, mean, rsigma).
    Not differentiable: the autograd forms are the ``*_affine`` ones."""
    y, _, mu, rs = _ln_fwd_impl(x2d, None, weight, bias, eps, out_dtype)
    return y, mu, rs


def layer_norm(x2d, eps):
    """Non-affine LN on (rows, hidden) with the fused backward; output in
    x's dtype."""
    return _LayerNorm.apply(x2d, eps)


def layer_norm_affine(x2d, weight, bias, eps, out_dtype=None):
    """Affine LN on (rows, hidden) with the fused backward; output in
    ``out_dtype`` (default x's)."""
    return _LayerNormAffine.apply(x2d, weight, bias, eps, out_dtype)


def layer_norm_residual_affine(x2d, delta2d, weight, bias, eps,
                               out_dtype=None):
    """(LN(x + delta), x + delta) in one kernel on (rows, hidden) views:
    ``y`` in ``out_dtype`` (default x's), the stream ``s`` in x's. The
    backward folds the stream cotangent into the dx pass; dx == ddelta."""
    return _LayerNormResidual.apply(x2d, delta2d, weight, bias, 0, 0.0, eps,
                                    out_dtype)


def layer_norm_residual_dropout_affine(x2d, delta2d, weight, bias, seed,
                                       rate, eps, out_dtype=None):
    """`layer_norm_residual_affine` with dropout on the delta inside the
    kernel (keep probability 1 - rate, kept values scaled by 1/(1-rate));
    ``seed`` is an int32 value, one per dropout site and step."""
    return _LayerNormResidual.apply(x2d, delta2d, weight, bias, int(seed),
                                    float(rate), eps, out_dtype)
