"""Fused ResNet-bottleneck convolutions: BN-apply prologue + conv + BN
statistics epilogue, forward and backward, and the whole training-mode
block as one autograd function.

Port of ``rocm_apex_tpu/ops/fused_bottleneck.py``. The kernels
(``csrc/bottleneck_fwd.cu``, ``csrc/bottleneck_bwd.cu``) replace the TPU
kernels ``_mm_fwd_kernel`` (:112), ``_conv3_fwd_kernel`` (:301),
``_mm_bwd_kernel`` (:445) and ``_conv3_bwd_kernel`` (:624):

    conv1x1_bn_act      y = relu(x * a + b) @ w, with (Σy, Σy²) of the
                        fp32 product; the prologue optional
    conv3x3_bn_act      the same for a 3x3 stride-1 SAME conv on NHWC
    conv1x1_bn_act_bwd  pre-mask e by z > 0, finalize dz = k1 e + k2 y +
                        k0, dgrad g = dz w^T masked by s = x a + b > 0
                        (fp32), wgrad dw = relu(s)^T dz, and the upstream
                        BN's reductions (Σg, Σg x̂)
    conv3x3_bn_act_bwd  the same for the 3x3 (no pre-mask; the ReLU mask
                        from u = relu(x a + b) computed in e's dtype)

Each keeps its TPU kernel's rounding: the forward prologue in the input's
dtype (the product and the sum each rounded), the 1x1 backward's
recompute in fp32 then u cast, the 3x3 backward's in the input's dtype,
the finalize in the cotangent's dtype. The statistics are single-pass:
var = E[y²] - E[y]², clamped at 0 (`bn_coeffs`). Weights keep the JAX
layout: (K, N) for a 1x1, (3, 3, Cin, Cout) for the 3x3. The TPU's VMEM
knobs (block sizes, halo slivers, tap bits) are how Mosaic cuts blocks,
not what the functions compute, and have no counterpart here.

The bf16 and fp16 backwards first write dz and u once (a pre-pass:
`conv3_bwd_prepass_plain` and `mm_bwd_prepass_plain` its plain forms,
each with its own rounding), then run their dgrad and their wgrad (for
the 3x3 the taps folded into the output rows) as pipelined wgmma
products over them; `conv3_bwd_plan` and `mm_bwd_plan` say how they
launch and what they allocate. The bf16 and fp16 forwards do the same:
under a prologue a pre-pass writes u (`conv3_fwd_prepass_plain`), and the
product reads u's rows (for the 3x3 shifted by each tap, zero-filled past
the image: the padding is of u), as `mm_fwd_plan` and `conv3_fwd_plan`
say. A kernel whose channel counts are not multiples of 64 runs on the staged
core (the plans' rule), as does fp32.

For CUDA tensors the wrappers launch the kernels (bf16, fp16 or fp32) or
raise; for CPU tensors they run the plain versions (``*_plain``), which
the card compares the kernels with. Any channel count: a count that is
not a multiple of 8 goes through a zero-padded copy on either device
(`channel_plan`), so the CPU runs the padding the card runs.
`bottleneck_fused` chains them as the JAX custom VJP does; the bn3 and
downsample-BN reductions, the residual tail and ``dx = dx_main + dx_res``
are plain PyTorch there, as they are plain XLA in JAX.
"""

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rocm_apex_tpu_torch.ops._build import (
    DTYPE_CODES,
    Kernel,
    dtype_code,
    half_float,
    ptr,
    sm_count,
    stream_ptr,
)

__all__ = [
    "BNECK_MM_FWD",
    "BNECK_CONV3_FWD",
    "BNECK_MM_BWD",
    "BNECK_CONV3_BWD",
    "bn_coeffs",
    "bn_finalize_coeffs",
    "bottleneck_fused",
    "conv1x1_bn_act",
    "conv1x1_bn_act_plain",
    "conv1x1_bn_act_bwd",
    "conv1x1_bn_act_bwd_plain",
    "conv3x3_bn_act",
    "conv3x3_bn_act_plain",
    "conv3x3_bn_act_bwd",
    "conv3x3_bn_act_bwd_plain",
    "conv3_bwd_plan",
    "conv3_bwd_prepass_plain",
    "conv3_fwd_plan",
    "conv3_fwd_prepass_plain",
    "mm_bwd_plan",
    "mm_bwd_prepass_plain",
    "mm_fwd_plan",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
BNECK_MM_FWD = Kernel(
    name="bneck_mm_fwd",
    source="bottleneck_fwd.cu",
    symbol="bneck_mm_fwd",
    argtypes=[_P] * 9 + [_L, _I, _I, _I, _I, _I, _P],
    replaces="rocm_apex_tpu/ops/fused_bottleneck.py:112 _mm_fwd_kernel",
)
BNECK_CONV3_FWD = Kernel(
    name="bneck_conv3_fwd",
    source="bottleneck_fwd.cu",
    symbol="bneck_conv3_fwd",
    argtypes=[_P] * 9 + [_I] * 8 + [_P],
    replaces="rocm_apex_tpu/ops/fused_bottleneck.py:301 _conv3_fwd_kernel",
)
BNECK_MM_BWD = Kernel(
    name="bneck_mm_bwd",
    source="bottleneck_bwd.cu",
    symbol="bneck_mm_bwd",
    argtypes=[_P] * 20 + [_L, _I, _I, _L, _I, _I, _I, _I, _P],
    replaces="rocm_apex_tpu/ops/fused_bottleneck.py:445 _mm_bwd_kernel",
)
BNECK_CONV3_BWD = Kernel(
    name="bneck_conv3_bwd",
    source="bottleneck_bwd.cu",
    symbol="bneck_conv3_bwd",
    argtypes=[_P] * 19 + [_I] * 5 + [_L, _I, _I, _I, _P],
    replaces="rocm_apex_tpu/ops/fused_bottleneck.py:624 _conv3_bwd_kernel",
)

# the kernels' tiles (csrc/bottleneck.cuh Cfg<T>): rows and columns of an
# output tile and the depth of a staged reduction chunk, one layout for
# the 2-byte types (bf16, fp16: mma.sync) and one for fp32
_TILE_M = {dt: 128 if half_float(dt) else 64 for dt in DTYPE_CODES}
_TILE_N = {dt: 64 for dt in DTYPE_CODES}
_CHUNK = {dt: 32 if half_float(dt) else 16 for dt in DTYPE_CODES}
# the channel grain of the kernels: a 16-byte row segment of a 2-byte type
# (csrc/bottleneck.cuh `load8`; a tile's channel tail past the count is
# zero-filled in shared memory at this grain); `channel_plan` pads other
# counts up to it
_CHANNEL_GRAIN = 8
_RED_CHUNK = 256  # parts a reduction block sums (kRedChunk)
# the pipe's tiles (csrc/bottleneck_pipe.cuh PCfg): 128 output rows, 128
# columns where the count divides by 128 (else 64), 64-deep chunks; a bf16
# kernel takes the pipe where its channel counts divide by the chunk
# (every ResNet-50 width), else the staged core
_PIPE_TILE_M, _PIPE_CHUNK = 128, 64


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def _apply_dt(x: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """relu(x * a + b) in x's dtype, the product and the sum each rounded
    (the forward's and the 3x3 backward's prologue)."""
    dt = x.dtype
    return torch.clamp_min(x * a.to(dt) + b.to(dt), 0)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def conv1x1_bn_act_plain(x2d, w, scale=None, bias=None, stats=True):
    """The plain PyTorch version of `conv1x1_bn_act`: the product in fp32
    from the dtype's values, y rounded, the sums of the fp32 product."""
    u = x2d if scale is None else _apply_dt(x2d, scale, bias)
    acc = u.float() @ w.to(x2d.dtype).float()
    y = acc.to(x2d.dtype)
    if stats:
        return y, (acc.sum(0), (acc * acc).sum(0))
    return y, None


def conv3x3_bn_act_plain(x, w, scale=None, bias=None, stats=True):
    """The plain PyTorch version of `conv3x3_bn_act` (an fp32
    ``F.conv2d`` of the activated input, zero-padded after the prologue)."""
    u = x if scale is None else _apply_dt(x, scale, bias)
    acc = F.conv2d(_nchw(u.float()), _oihw(w.to(x.dtype).float()),
                   padding=1).permute(0, 2, 3, 1)
    y = acc.to(x.dtype)
    if stats:
        return y, (acc.sum((0, 1, 2)), (acc * acc).sum((0, 1, 2)))
    return y, None


def _finalized(e, z, y_fin):
    """e pre-masked by z > 0 (z given) and finalized k1 e + k2 y + k0 in
    e's dtype (y_fin = (y, k1, k2, k0) given)."""
    dt = e.dtype
    if z is not None:
        e = torch.where(z.float() > 0, e, torch.zeros((), dtype=dt,
                                                      device=e.device))
    if y_fin is None:
        return e
    y, k1, k2, k0 = y_fin
    return k1.to(dt) * e + k2.to(dt) * y + k0.to(dt)


def _prologue_ops(x, a, b):
    """relu(x a + b) as the pre-passes write it, op for op: each product
    and sum taken in fp32 and rounded to x's dtype, the coefficients
    rounded first; equal bit for bit to `_apply_dt`."""
    dt = x.dtype

    def rnd(t):
        return t.to(dt).float()

    return torch.clamp_min(rnd(rnd(x.float() * rnd(a)) + rnd(b)), 0.0).to(dt)


def conv3_fwd_prepass_plain(x, scale, bias):
    """The bf16 3x3 forward's pre-pass (``conv3_fwd_prepass_kernel`` in
    csrc/bottleneck_fwd.cu): u = relu(x scale + bias) in x's dtype, the
    rows the pipe's product reads, zero-padded by its loads (the padding
    is of u); `conv3x3_bn_act_plain` on u with no prologue is the prologue
    form's y and sums bit for bit."""
    return _prologue_ops(x, scale, bias)


def conv3_bwd_prepass_plain(e, y_fin, x, prologue):
    """The 3x3 backward's pre-pass (``conv3_prepass_kernel`` in
    csrc/bottleneck_bwd.cu) op for op: dz = k1 e + k2 y + k0 (None
    without ``y_fin``) and u = relu(x a + b), every product and sum taken
    in fp32 and rounded to e's dtype, the coefficients rounded first: the
    rows the bf16 products read, equal bit for bit to `_finalized` and
    `_apply_dt`."""
    dt = e.dtype

    def rnd(t):
        return t.to(dt).float()

    dz = None
    if y_fin is not None:
        y, k1, k2, k0 = y_fin
        t = rnd(rnd(rnd(k1) * e.float()) + rnd(rnd(k2) * y.float()))
        dz = (t + rnd(k0)).to(dt)
    return dz, _prologue_ops(x, *prologue)


def mm_bwd_prepass_plain(e, z, y_fin, x, prologue):
    """The bf16 1x1 backward's pre-pass (``mm_prepass_kernel`` in
    csrc/bottleneck_bwd.cu): dz = `_finalized` (e pre-masked by z > 0,
    then k1 e + k2 y + k0 in e's dtype; None with neither z nor y_fin) and
    u = relu(s) with s = x a + b in fp32, rounded once to e's dtype (None
    without a prologue: the wgrad reads x). The rows the products read,
    equal bit for bit to what `conv1x1_bn_act_bwd_plain` forms. (The 3x3's
    pre-pass rounds each op of its prologue instead.)"""
    dz = None if z is None and y_fin is None else _finalized(e, z, y_fin)
    u = None
    if prologue is not None:
        a, b = prologue
        u = torch.clamp_min(x.float() * a.float() + b.float(),
                            0.0).to(e.dtype)
    return dz, u


def _reductions(g, x, reduce_stats, dims):
    mu, rs = reduce_stats
    xhat = (x.float() - mu) * rs
    return g.sum(dims), (g * xhat).sum(dims)


def conv1x1_bn_act_bwd_plain(e, w, x, z=None, y_fin=None, prologue=None,
                             reduce_stats=None, wgrad=True, dgrad=True):
    """The plain PyTorch version of `conv1x1_bn_act_bwd`."""
    dt = e.dtype
    dz = _finalized(e, z, y_fin)
    s = None
    if prologue is not None:
        a, b = prologue
        s = x.float() * a.float() + b.float()
        u = torch.clamp_min(s, 0.0).to(dt)
    else:
        u = x
    dw = u.float().t() @ dz.float() if wgrad else None
    g = r1 = r2 = None
    if dgrad:
        gf = dz.float() @ w.to(dt).float().t()
        if s is not None:
            gf = torch.where(s > 0, gf, 0.0)
        g = gf.to(dt)
        if reduce_stats is not None:
            r1, r2 = _reductions(gf, x, reduce_stats, 0)
    return g, dw, r1, r2


def _conv3_wgrad(u: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """dw (3, 3, Cin, Cout) = sum over the pixels p of u[p + off_t]^T
    dz[p], fp32, as one product over the unfolded taps: a tap whose terms
    are all 0 sums to exactly 0 (a transform-based cuDNN wgrad does not)."""
    n, h, wid, cin = u.shape
    cout = dz.shape[-1]
    cols = F.unfold(_nchw(u.float()), 3, padding=1)  # (n, cin * 9, h * w)
    cols = cols.transpose(0, 1).reshape(cin * 9, n * h * wid)
    dw = cols @ dz.float().reshape(n * h * wid, cout)
    return dw.reshape(cin, 3, 3, cout).permute(1, 2, 0, 3)


def conv3x3_bn_act_bwd_plain(e, w, x, y_fin, prologue, reduce_stats):
    """The plain PyTorch version of `conv3x3_bn_act_bwd` (fp32 products:
    the dgrad by ``torch.nn.grad.conv2d_input``, the wgrad over the
    unfolded taps)."""
    dt = e.dtype
    dzh = _finalized(e, None, y_fin)
    u = _apply_dt(x, *prologue)
    dw = _conv3_wgrad(u, dzh)
    gf = torch.nn.grad.conv2d_input(_nchw(x).shape, _oihw(w.to(dt).float()),
                                    _nchw(dzh.float()),
                                    padding=1).permute(0, 2, 3, 1)
    gf = torch.where(u.float() > 0, gf, 0.0)
    r1, r2 = _reductions(gf, x, reduce_stats, (0, 1, 2))
    return gf.to(dt), dw, r1, r2


# ---------------------------------------------------------------------------
# BN coefficient plumbing (per-channel PyTorch math between the kernels)
# ---------------------------------------------------------------------------


def bn_coeffs(sums, count, gamma, beta, eps):
    """(mean, rs, scale, bias) from a kernel's (sum, sum_sq) epilogue:
    the prologue form u = relu(y * scale + bias) of gamma * x_hat + beta."""
    s1, s2 = sums
    mean = s1 / count
    var = torch.clamp_min(s2 / count - mean * mean, 0.0)
    rs = torch.rsqrt(var + eps)
    scale = gamma * rs
    bias = beta - mean * scale
    return mean, rs, scale, bias


def bn_finalize_coeffs(r1, r2, mean, rs, gamma, count):
    """(k1, k2, k0) of dy = k1 * e + k2 * y + k0 (the BN backward from
    the reductions r1 = Σe, r2 = Σe x̂)."""
    k1 = gamma * rs
    k2 = -k1 * rs * r2 / count
    k0 = -k1 * r1 / count - k2 * mean
    return k1, k2, k0


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")


def _dense(t: Optional[torch.Tensor], dtype=None) -> Optional[torch.Tensor]:
    """``t`` contiguous, in ``dtype``, at a 16-byte-aligned address (the
    kernels load 16 bytes at a time)."""
    if t is None:
        return None
    t = t.to(dtype=dtype or t.dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _vec(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else _dense(t.reshape(-1), torch.float32)


def _check_channels(dt, *counts, pixels=0):
    dtype_code(dt)
    if pixels >= 2 ** 31:
        raise ValueError(f"the bottleneck kernels index pixels in 32 bits, "
                         f"got {pixels}")
    if any(c < 1 for c in counts):
        raise ValueError(f"the bottleneck kernels take channel counts of at "
                         f"least 1, got {counts}")


def channel_plan(counts, m: int = 0, dt=torch.bfloat16) -> dict:
    """How the kernels take a call's channel counts, from the counts
    alone. ``route``: ``"native"`` where every count is a multiple of
    `_CHANNEL_GRAIN` (8): the staged core's tiles predicate their channel
    tail at that grain and zero-fill it in shared memory, and the pipe
    takes multiples of `_PIPE_CHUNK` (64) as `mm_fwd_plan` says;
    ``"padded"`` for any other count: the wrapper copies the operands with
    zero channels up to the next multiple of 8 (``kernel_counts``), the
    BN coefficients (scale, bias, k1, k2, k0, mu, rs) padded with 0, so a
    pad channel is exactly 0 in every output and sum, and slices the
    outputs back. ``pad_bytes``: the bytes the padded copies of ``m``
    pixels add over the call's maps (one extra channel a map per pad
    channel), as the head dims' `pad_bytes` counts them."""
    kernel = tuple(-(-c // _CHANNEL_GRAIN) * _CHANNEL_GRAIN for c in counts)
    extra = sum(kc - c for kc, c in zip(kernel, counts))
    route = "native" if kernel == tuple(counts) else "padded"
    return dict(route=route, kernel_counts=kernel,
                pad_bytes=m * extra * torch.empty((), dtype=dt).element_size())


def _pad(t: Optional[torch.Tensor], *sizes) -> Optional[torch.Tensor]:
    """t zero-padded at the end of its last len(sizes) axes to ``sizes``
    (None stays None)."""
    if t is None:
        return None
    pad = []
    for ax, to in zip(range(t.dim() - 1, -1, -1), reversed(sizes)):
        pad += [0, to - t.shape[ax]]
    return F.pad(t, pad) if any(pad) else t


def _parts(rows: int, width: int, dt, device):
    """The per-tile partial buffer (tiles, width) and, past one reduction
    block's chunk, the scratch of the two-level reduction."""
    tiles = -(-rows // _TILE_M[dt])
    if tiles > _RED_CHUNK ** 2:
        raise ValueError(f"{rows} pixels exceed the reduction's "
                         f"{_RED_CHUNK ** 2} tiles")
    part = torch.empty(tiles, width, dtype=torch.float32, device=device)
    scratch = (torch.empty(-(-tiles // _RED_CHUNK), width,
                           dtype=torch.float32, device=device)
               if tiles > _RED_CHUNK else None)
    return part, scratch


# wgrad blocks a multiprocessor: four are resident at once (registers),
# so two rounds of them; each block walks its pixel range one staged
# chunk at a time, so more, shorter ranges hide more of each chunk's
# load latency (on the H100, 8 rather than 2 took the fused ResNet-50
# step's wgrad device time from 36 to 24.5 ms: PERF.md, PR 9)
_WGRAD_BLOCKS_PER_SM = 8


def _wgrad_splits(m: int, out_tiles: int, dt, sms: int) -> Tuple[int, int]:
    """``(split_len, splits)``: the pixel ranges a wgrad sums separately,
    so that ``out_tiles`` output tiles x splits give about
    `_WGRAD_BLOCKS_PER_SM` blocks for each of ``sms`` multiprocessors (at
    most 256 ranges, each a multiple of the staged chunk)."""
    bk = _CHUNK[dt]
    chunks = max(1, -(-m // bk))
    splits = min(max(1, -(-_WGRAD_BLOCKS_PER_SM * sms // out_tiles)),
                 _RED_CHUNK, chunks)
    split_len = -(-chunks // splits) * bk
    return split_len, max(1, -(-m // split_len))


# the pipelined wgrad's blocks a multiprocessor: two are resident at once
# (256 threads, 97 KB of shared memory each), so 2 fill one wave; more
# give shorter pixel walks against more partials to sum. 3 and 4 came
# out alike over ResNet-50's five 3x3 shapes on the H100, both ahead of
# 2; 3 sums fewer partials.
_PIPE_WGRAD_BLOCKS_PER_SM = 3


def _pipe_cols(n: int) -> int:
    return 128 if n % 128 == 0 else 64


def _pipe_splits(m: int, out_tiles: int, sms: int) -> Tuple[int, int]:
    """``(split_len, splits)`` of a pipelined wgrad: pixel ranges of
    whole chunks, so that ``out_tiles`` x splits give about
    `_PIPE_WGRAD_BLOCKS_PER_SM` blocks a multiprocessor (at most
    `_RED_CHUNK` ranges: the cap binds where few output tiles leave the
    splits all the parallelism, as the 1x1's 64 x 64 dw at layer1)."""
    chunks = max(1, -(-m // _PIPE_CHUNK))
    splits = min(max(1, -(-_PIPE_WGRAD_BLOCKS_PER_SM * sms // out_tiles)),
                 _RED_CHUNK, chunks)
    split_len = -(-chunks // splits) * _PIPE_CHUNK
    return split_len, max(1, -(-m // split_len))


def _fwd_plan(m: int, k: int, n: int, dt, prologue: bool) -> dict:
    """The forwards' shared plan over ``m`` pixels of ``k`` channels in
    and ``n`` out: the pipe for bf16 with k and n multiples of 64, tiles
    of 128 pixels x ``bn`` = 128 channels where n divides by 128, else 64;
    otherwise the staged core (``bn`` 0). ``parts``: one (Σy, Σy²)
    partial row a pixel tile; ``u``: the pre-pass's rows, on the pipe
    under a ``prologue``."""
    if half_float(dt) and k % _PIPE_CHUNK == 0 and n % _PIPE_CHUNK == 0:
        bn = _pipe_cols(n)
        tiles = -(-m // _PIPE_TILE_M)
        return dict(route="pipe", bn=bn, grid=(tiles, n // bn, 1),
                    parts=(tiles, 2 * n), u=(m, k) if prologue else None)
    tiles = -(-m // _TILE_M[dt])
    return dict(route="staged", bn=0, grid=(tiles, -(-n // _TILE_N[dt]), 1),
                parts=(tiles, 2 * n), u=None)


def mm_fwd_plan(m: int, k: int, n: int, dt, sms: int,
                prologue: bool = True) -> dict:
    """How `conv1x1_bn_act` launches on ``sms`` multiprocessors for ``m``
    pixels, w (k, n): its ``route``, the tile width ``bn``, the product's
    ``grid`` (pixel tiles x N tiles), the shape of the tile partials
    ``parts`` (summed into the statistics) and of the pre-pass's bf16 ``u``
    (named on the pipe only for a call with a ``prologue``; the wrapper
    allocates what is named).

    ``"pipe"`` (csrc/bottleneck_pipe.cuh, `conv3_fwd_plan`'s product with
    one tap) takes bf16 with k and n multiples of 64 (`mm_bwd_plan`'s
    rule), in tiles of 128 pixels x ``bn`` = 128 channels where n divides
    by 128 (layer4's conv1, n 512: 49 x 4 = 196 blocks of the 264 a wave
    of two a multiprocessor holds on 132), else 64. Other widths, and
    fp32, take ``"staged"`` (csrc/bottleneck.cuh, ``bn`` 0). A shape rule,
    decided here before any launch; ``sms`` (the pre-pass's grid, which
    the kernel sizes) changes none of it."""
    return _fwd_plan(m, k, n, dt, prologue)


def conv3_fwd_plan(m: int, cin: int, cout: int, dt, sms: int,
                   prologue: bool = True) -> dict:
    """How `conv3x3_bn_act` launches on ``sms`` multiprocessors for ``m``
    pixels: its ``route``, the tile width ``bn``, the product's ``grid``
    (pixel tiles x Cout tiles), the shape of the tile partials ``parts``
    (summed into the statistics) and of the pre-pass's bf16 ``u`` (named
    on the pipe only for a call with a ``prologue``; the wrapper allocates
    what is named).

    ``"pipe"`` (csrc/bottleneck_pipe.cuh, as the 3x3 backward's dgrad)
    takes bf16 with cin and cout multiples of 64 (`mm_bwd_plan`'s rule:
    the chunks are 64 channels deep, the tiles 64 or 128 wide), in tiles
    of 128 pixels x ``bn`` = 128 channels where cout divides by 128 (at
    layer4, 49 x 4 = 196 blocks of the 264 a wave of two a
    multiprocessor holds on 132), else 64. Other widths, and fp32, take
    ``"staged"`` (csrc/bottleneck.cuh, ``bn`` 0). A shape rule, decided
    here before any launch; ``sms`` (the pre-pass's grid, which the
    kernel sizes) changes none of it."""
    return _fwd_plan(m, cin, cout, dt, prologue)


def conv3_bwd_plan(m: int, cin: int, cout: int, dt, sms: int) -> dict:
    """How `conv3x3_bn_act_bwd` launches on ``sms`` multiprocessors for
    ``m`` pixels: the wgrad's pixel ranges (``split_len``, ``splits``),
    the grids of the dgrad (pixel tiles x Cin tiles) and of the wgrad
    (output-row tiles x Cout tiles x splits), and the shapes of the
    buffers the wrapper allocates: the wgrad's fp32 partials ``ws``
    (summed over its first axis into dw) and, in bf16, the pre-pass's
    ``dz`` and ``u``.

    bf16 (csrc/bottleneck_pipe.cuh): the wgrad's output rows are the 9 Cin
    (tap, cin) pairs; the splits give `_PIPE_WGRAD_BLOCKS_PER_SM` blocks a
    multiprocessor. fp32 (the staged core): a tap per grid slice, sized
    as the 1x1's by `_wgrad_splits`."""
    if half_float(dt):
        rows = 9 * cin
        row_tiles = -(-rows // _PIPE_TILE_M)
        col_tiles = -(-cout // _pipe_cols(cout))
        split_len, splits = _pipe_splits(m, row_tiles * col_tiles, sms)
        return dict(
            split_len=split_len, splits=splits,
            dgrad_grid=(-(-m // _PIPE_TILE_M), -(-cin // _pipe_cols(cin)), 1),
            wgrad_grid=(row_tiles, col_tiles, splits),
            ws=(splits, rows, cout), dz=(m, cout), u=(m, cin))
    tiles = -(-cin // _TILE_M[dt]) * -(-cout // _TILE_N[dt])
    split_len, splits = _wgrad_splits(m, 9 * tiles, dt, sms)
    return dict(
        split_len=split_len, splits=splits,
        dgrad_grid=(-(-m // _TILE_M[dt]), -(-cin // _TILE_N[dt]), 1),
        wgrad_grid=(-(-cin // _TILE_M[dt]), -(-cout // _TILE_N[dt]),
                    9 * splits),
        ws=(splits, 9 * cin, cout), dz=None, u=None)


def mm_bwd_plan(m: int, k: int, n: int, dt, sms: int) -> dict:
    """How `conv1x1_bn_act_bwd` launches on ``sms`` multiprocessors for
    ``m`` pixels, w (k, n): its ``route``, the grids of the dgrad (pixel
    tiles x K tiles) and of the wgrad (K tiles x N tiles x splits), the
    wgrad's pixel ranges (``split_len``, ``splits``) and the shapes of
    the buffers the wrapper allocates: the wgrad's fp32 partials ``ws``
    (summed over its first axis into dw) and, on the pipe, the pre-pass's
    bf16 ``dz`` and ``u`` (each allocated only where the call needs it).

    ``"pipe"`` (csrc/bottleneck_pipe.cuh) takes bf16 with k and n
    multiples of 64: its chunks are 64 channels deep and its tiles 64 or
    128 wide, so a width with a 16-, 32- or 48-channel tail would run
    part-empty chunks and tiles everywhere; such a width, and fp32, take
    ``"staged"`` (csrc/bottleneck.cuh, 32-deep chunks), sized by
    `_wgrad_splits`. A shape rule, decided here before any launch."""
    if half_float(dt) and k % _PIPE_CHUNK == 0 and n % _PIPE_CHUNK == 0:
        row_tiles = -(-k // _PIPE_TILE_M)
        col_tiles = -(-n // _pipe_cols(n))
        split_len, splits = _pipe_splits(m, row_tiles * col_tiles, sms)
        return dict(
            route="pipe", split_len=split_len, splits=splits,
            dgrad_grid=(-(-m // _PIPE_TILE_M), -(-k // _pipe_cols(k)), 1),
            wgrad_grid=(row_tiles, col_tiles, splits),
            ws=(splits, k, n), dz=(m, n), u=(m, k))
    row_tiles, col_tiles = -(-k // _TILE_M[dt]), -(-n // _TILE_N[dt])
    split_len, splits = _wgrad_splits(m, row_tiles * col_tiles, dt, sms)
    return dict(
        route="staged", split_len=split_len, splits=splits,
        dgrad_grid=(-(-m // _TILE_M[dt]), -(-k // _TILE_N[dt]), 1),
        wgrad_grid=(row_tiles, col_tiles, splits),
        ws=(splits, k, n), dz=None, u=None)


def conv1x1_bn_act(
    x2d: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stats: bool = True,
):
    """y = relu(x * scale + bias) @ w over the flattened pixel stream.

    x2d: (M, K) raw upstream conv output (or the block input, with
    scale/bias None: no activation); w: (K, N). Returns y (M, N) in x's
    dtype and, with ``stats``, the per-channel (sum, sum_sq) of y in fp32
    from the unrounded product. On the card it runs on the route
    `mm_fwd_plan` gives its shape."""
    dt = x2d.dtype
    m, k = x2d.shape
    n = w.shape[1]
    cp = channel_plan((k, n), m, dt)
    if cp["route"] == "padded":
        kp, np_ = cp["kernel_counts"]
        y, st = conv1x1_bn_act(_pad(x2d, kp), _pad(w, kp, np_),
                               _pad(scale, kp), _pad(bias, kp),
                               stats)
        return (y[:, :n].contiguous(),
                (st[0][:n], st[1][:n]) if stats else None)
    if x2d.device.type == "cpu":
        return conv1x1_bn_act_plain(x2d, w, scale, bias, stats)
    _require_cuda(x2d)
    _check_channels(dt, k, n)
    # the kernels read w^T straight: rows of K contiguous values
    x2d, wt = _dense(x2d), _dense(w.t(), dt)
    sms = sm_count(x2d.device)
    plan = mm_fwd_plan(m, k, n, dt, sms, prologue=scale is not None)
    y = torch.empty(m, n, dtype=dt, device=x2d.device)
    part = scratch = sums = None
    if stats:
        part, scratch = _parts(m, 2 * n, dt, x2d.device)
        sums = torch.empty(2, n, dtype=torch.float32, device=x2d.device)
    # the pipe's pre-pass output under a prologue: transient
    ubuf = (torch.empty(plan["u"], dtype=dt, device=x2d.device)
            if plan["u"] is not None else None)
    if m:
        BNECK_MM_FWD(ptr(x2d), ptr(_vec(scale)), ptr(_vec(bias)), ptr(wt),
                     ptr(y), ptr(part), ptr(scratch), ptr(sums), ptr(ubuf),
                     m, k, n, plan["bn"], sms, dtype_code(dt),
                     stream_ptr(x2d.device))
    return y, ((sums[0], sums[1]) if stats else None)


def conv3x3_bn_act(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stats: bool = True,
):
    """3x3 stride-1 SAME conv with the BN-apply + ReLU prologue and the
    statistics epilogue. x: (N, H, W, C) raw upstream output; w: (3, 3,
    C, Cout). Returns y (N, H, W, Cout) and the sums as
    `conv1x1_bn_act`. On the card it runs on the route `conv3_fwd_plan`
    gives its shape."""
    dt = x.dtype
    nimg, hgt, wid, cin = x.shape
    cout = w.shape[-1]
    cp = channel_plan((cin, cout), nimg * hgt * wid, dt)
    if cp["route"] == "padded":
        cip, cop = cp["kernel_counts"]
        y, st = conv3x3_bn_act(_pad(x, cip), _pad(w, cip, cop),
                               _pad(scale, cip), _pad(bias, cip),
                               stats)
        return (y[..., :cout].contiguous(),
                (st[0][:cout], st[1][:cout]) if stats else None)
    if x.device.type == "cpu":
        return conv3x3_bn_act_plain(x, w, scale, bias, stats)
    _require_cuda(x)
    _check_channels(dt, cin, cout, pixels=nimg * hgt * wid)
    x = _dense(x)
    wt = _dense(w.reshape(9, cin, cout).transpose(1, 2), dt)  # (9, Cout, Cin)
    m = nimg * hgt * wid
    sms = sm_count(x.device)
    plan = conv3_fwd_plan(m, cin, cout, dt, sms, prologue=scale is not None)
    y = torch.empty(nimg, hgt, wid, cout, dtype=dt, device=x.device)
    part = scratch = sums = None
    if stats:
        part, scratch = _parts(m, 2 * cout, dt, x.device)
        sums = torch.empty(2, cout, dtype=torch.float32, device=x.device)
    # the pipe's pre-pass output under a prologue: transient
    ubuf = (torch.empty(plan["u"], dtype=dt, device=x.device)
            if plan["u"] is not None else None)
    if m:
        BNECK_CONV3_FWD(ptr(x), ptr(_vec(scale)), ptr(_vec(bias)), ptr(wt),
                        ptr(y), ptr(part), ptr(scratch), ptr(sums),
                        ptr(ubuf), nimg, hgt, wid, cin, cout, plan["bn"],
                        sms, dtype_code(dt), stream_ptr(x.device))
    return y, ((sums[0], sums[1]) if stats else None)


def conv1x1_bn_act_bwd(
    e: torch.Tensor,
    w: torch.Tensor,
    x: Optional[torch.Tensor],
    z: Optional[torch.Tensor] = None,
    y_fin: Optional[Tuple] = None,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    reduce_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    wgrad: bool = True,
    dgrad: bool = True,
):
    """One fused backward pass of a 1x1 conv.

    e: (M, N); w: (K, N); x: (M, K) upstream raw output (the prologue
    recomputes u and the ReLU mask from it); z: (M, N) block output for
    the pre-mask; y_fin: (y_raw, k1, k2, k0) finalize inputs;
    reduce_stats: (mu, rs) of the upstream BN, enabling the r1/r2
    reductions (with ``dgrad``). Returns (g, dw, r1, r2), None for the
    parts switched off; dw, r1, r2 fp32. On the card it runs on the route
    `mm_bwd_plan` gives its shape."""
    dt = e.dtype
    m, n = e.shape
    k = w.shape[0]
    cp = channel_plan((k, n), m, dt)
    if cp["route"] == "padded":
        kp, np_ = cp["kernel_counts"]
        def each(ts, to):
            return None if ts is None else tuple(_pad(t, to) for t in ts)

        g, dw, r1, r2 = conv1x1_bn_act_bwd(
            _pad(e, np_), _pad(w, kp, np_), _pad(x, kp), _pad(z, np_),
            each(y_fin, np_), each(prologue, kp), each(reduce_stats, kp),
            wgrad, dgrad)
        return (None if g is None else g[:, :k].contiguous(),
                None if dw is None else dw[:k, :n].contiguous(),
                None if r1 is None else r1[:k],
                None if r2 is None else r2[:k])
    if e.device.type == "cpu":
        return conv1x1_bn_act_bwd_plain(e, w, x, z, y_fin, prologue,
                                        reduce_stats, wgrad, dgrad)
    _require_cuda(e)
    if reduce_stats is not None and not dgrad:
        raise ValueError("the reductions ride the dgrad: dgrad=False "
                         "leaves none")
    _check_channels(dt, k, n)
    pro, red = prologue is not None, reduce_stats is not None
    need_x = pro or red or wgrad
    if need_x and (x is None or x.dtype != dt):
        raise TypeError(f"x must be given in e's dtype {dt}")
    dev = e.device
    y_raw, k1, k2, k0 = y_fin if y_fin is not None else (None,) * 4
    a, b = prologue if pro else (None, None)
    mu, rs = reduce_stats if red else (None, None)
    g = torch.empty(m, k, dtype=dt, device=dev) if dgrad else None
    dw = (torch.empty(k, n, dtype=torch.float32, device=dev) if wgrad
          else None)
    part = scratch = r12 = wsw = None
    if red:
        part, scratch = _parts(m, 2 * k, dt, dev)
        r12 = torch.empty(2, k, dtype=torch.float32, device=dev)
    sms = sm_count(dev)
    plan = mm_bwd_plan(m, k, n, dt, sms)
    pipe = plan["route"] == "pipe"
    if wgrad:
        wsw = torch.empty(plan["ws"], dtype=torch.float32, device=dev)
    # the pipe's pre-pass outputs, where the call needs them: transient
    dzbuf = (torch.empty(plan["dz"], dtype=dt, device=dev)
             if pipe and (z is not None or y_fin is not None)
             and (dgrad or wgrad) else None)
    ubuf = (torch.empty(plan["u"], dtype=dt, device=dev)
            if pipe and pro and wgrad else None)
    if m:
        BNECK_MM_BWD(
            ptr(_dense(e)), ptr(_dense(z, dt)), ptr(_dense(y_raw, dt)),
            ptr(_vec(k1)), ptr(_vec(k2)), ptr(_vec(k0)),
            ptr(_dense(x) if need_x else None), ptr(_vec(a)), ptr(_vec(b)),
            ptr(_vec(mu)), ptr(_vec(rs)), ptr(_dense(w, dt)), ptr(g),
            ptr(dw), ptr(r12), ptr(part), ptr(wsw), ptr(scratch),
            ptr(dzbuf), ptr(ubuf), m, k, n, plan["split_len"],
            plan["splits"], int(pipe), sms, dtype_code(dt),
            stream_ptr(dev))
    elif wgrad:
        dw.zero_()
    r1, r2 = (r12[0], r12[1]) if red else (None, None)
    return g, dw, r1, r2


def conv3x3_bn_act_bwd(
    e: torch.Tensor,
    w: torch.Tensor,
    x: torch.Tensor,
    y_fin: Optional[Tuple],
    prologue: Tuple[torch.Tensor, torch.Tensor],
    reduce_stats: Tuple[torch.Tensor, torch.Tensor],
):
    """Fused backward of `conv3x3_bn_act`. e: (N, H, W, Cout) masked
    partial (finalized in the kernel when y_fin = (y_raw, k1, k2, k0) is
    given); x: the upstream raw (N, H, W, Cin). Returns (g, dw, r1, r2),
    dw (3, 3, Cin, Cout) fp32."""
    dt = e.dtype
    nimg, hgt, wid, cout = e.shape
    cin = w.shape[2]
    cp = channel_plan((cin, cout), nimg * hgt * wid, dt)
    if cp["route"] == "padded":
        cip, cop = cp["kernel_counts"]
        g, dw, r1, r2 = conv3x3_bn_act_bwd(
            _pad(e, cop), _pad(w, cip, cop), _pad(x, cip),
            None if y_fin is None else tuple(_pad(t, cop) for t in y_fin),
            tuple(_pad(t, cip) for t in prologue),
            tuple(_pad(t, cip) for t in reduce_stats))
        return (g[..., :cin].contiguous(), dw[:, :, :cin, :cout].contiguous(),
                r1[:cin], r2[:cin])
    if e.device.type == "cpu":
        return conv3x3_bn_act_bwd_plain(e, w, x, y_fin, prologue,
                                        reduce_stats)
    _require_cuda(e)
    _check_channels(dt, cin, cout, pixels=nimg * hgt * wid)
    if x.dtype != dt:
        raise TypeError(f"x must be given in e's dtype {dt}")
    dev = e.device
    m = nimg * hgt * wid
    y_raw, k1, k2, k0 = y_fin if y_fin is not None else (None,) * 4
    a, b = prologue
    mu, rs = reduce_stats
    g = torch.empty(nimg, hgt, wid, cin, dtype=dt, device=dev)
    dw = torch.empty(3, 3, cin, cout, dtype=torch.float32, device=dev)
    part, scratch = _parts(m, 2 * cin, dt, dev)
    r12 = torch.empty(2, cin, dtype=torch.float32, device=dev)
    sms = sm_count(dev)
    plan = conv3_bwd_plan(m, cin, cout, dt, sms)
    wsw = torch.empty(plan["ws"], dtype=torch.float32, device=dev)
    # the bf16 pre-pass's outputs: transient, freed on return
    dzbuf = (torch.empty(plan["dz"], dtype=dt, device=dev)
             if plan["dz"] is not None and y_raw is not None else None)
    ubuf = (torch.empty(plan["u"], dtype=dt, device=dev)
            if plan["u"] is not None else None)
    if m:
        BNECK_CONV3_BWD(
            ptr(_dense(e)), ptr(_dense(y_raw, dt)), ptr(_vec(k1)),
            ptr(_vec(k2)), ptr(_vec(k0)), ptr(_dense(x)), ptr(_vec(a)),
            ptr(_vec(b)), ptr(_vec(mu)), ptr(_vec(rs)), ptr(_dense(w, dt)),
            ptr(g), ptr(dw), ptr(r12), ptr(part), ptr(wsw), ptr(scratch),
            ptr(dzbuf), ptr(ubuf), nimg, hgt, wid, cin, cout,
            plan["split_len"], plan["splits"], sms, dtype_code(dt),
            stream_ptr(dev))
    else:
        dw.zero_()
    return g, dw, r12[0], r12[1]


# ---------------------------------------------------------------------------
# the whole block
# ---------------------------------------------------------------------------


def _var(sums, mu, m):
    return torch.clamp_min(sums[1] / m - mu * mu, 0.0)


class _BottleneckFused(torch.autograd.Function):
    """The fused block's forward and hand-chained backward (JAX
    ``_bneck_fwd_impl`` / ``_bneck_bwd_impl``). Outputs: z, then (mean,
    var) per BN, which carry no gradient."""

    @staticmethod
    def forward(ctx, eps, downsample, x, w1, g1, b1, w2, g2, b2, w3, g3, b3,
                wd, gd, bd):
        nimg, hgt, wid, cin = x.shape
        m = nimg * hgt * wid
        cmid = w1.shape[-1]
        cout = w3.shape[-1]
        x2 = x.reshape(m, cin)

        y1, s1 = conv1x1_bn_act(x2, w1, stats=True)
        mu1, rs1, a1, c1 = bn_coeffs(s1, m, g1, b1, eps)
        y2, s2 = conv3x3_bn_act(y1.reshape(nimg, hgt, wid, cmid), w2, a1, c1,
                                stats=True)
        mu2, rs2, a2, c2 = bn_coeffs(s2, m, g2, b2, eps)
        y2f = y2.reshape(m, cmid)
        y3, s3 = conv1x1_bn_act(y2f, w3, a2, c2, stats=True)
        mu3, rs3, a3, c3 = bn_coeffs(s3, m, g3, b3, eps)
        stats = [mu1, _var(s1, mu1, m), mu2, _var(s2, mu2, m), mu3,
                 _var(s3, mu3, m)]
        # the tail relu(y3 a3 + c3 + r) in fp32, r = yd ad + cd or x: each
        # product and sum rounded once in fp32 as the JAX tail's, in place
        # on one fp32 buffer (a bf16 operand is promoted exactly)
        t = y3 * a3
        t += c3
        if downsample:
            yd, sd = conv1x1_bn_act(x2, wd, stats=True)
            mud, rsd, ad, cd = bn_coeffs(sd, m, gd, bd, eps)
            r = yd * ad
            r += cd
            t += r
            del r
            stats += [mud, _var(sd, mud, m)]
        else:
            yd = mud = rsd = None
            t += x2
        z = t.clamp_min_(0.0).to(x.dtype)
        del t

        ctx.downsample = downsample
        ctx.shape = (nimg, hgt, wid)
        ctx.save_for_backward(x2, y1, y2f, y3, yd, z, mu1, rs1, mu2, rs2,
                              mu3, rs3, mud, rsd, a1, c1, a2, c2, w1, g1, w2,
                              g2, w3, g3, wd, gd)
        ctx.mark_non_differentiable(*stats)
        return (z.reshape(nimg, hgt, wid, cout), *stats)

    @staticmethod
    def backward(ctx, dz_out, *_):
        (x2, y1, y2f, y3, yd, z, mu1, rs1, mu2, rs2, mu3, rs3, mud, rsd, a1,
         c1, a2, c2, w1, g1, w2, g2, w3, g3, wd, gd) = ctx.saved_tensors
        nimg, hgt, wid = ctx.shape
        m = x2.shape[0]
        cmid = w1.shape[-1]

        dzz = dz_out.reshape(m, -1).to(z.dtype)
        # the bn3 (and bn_d) reductions over the masked cotangent
        p = torch.where(z > 0, dzz.float(), 0.0)
        r1_3 = p.sum(0)
        xhat3 = (y3.float() - mu3) * rs3
        r2_3 = (p * xhat3).sum(0)
        k3 = bn_finalize_coeffs(r1_3, r2_3, mu3, rs3, g3, m)

        e2, dw3, r1_2, r2_2 = conv1x1_bn_act_bwd(
            dzz, w3, y2f, z=z, y_fin=(y3, *k3), prologue=(a2, c2),
            reduce_stats=(mu2, rs2))
        k2 = bn_finalize_coeffs(r1_2, r2_2, mu2, rs2, g2, m)

        e1, dw2, r1_1, r2_1 = conv3x3_bn_act_bwd(
            e2.reshape(nimg, hgt, wid, cmid), w2,
            y1.reshape(nimg, hgt, wid, cmid),
            y_fin=(y2f.reshape(nimg, hgt, wid, cmid), *k2),
            prologue=(a1, c1), reduce_stats=(mu1, rs1))
        k1 = bn_finalize_coeffs(r1_1, r2_1, mu1, rs1, g1, m)

        dx_main, dw1, _, _ = conv1x1_bn_act_bwd(
            e1.reshape(m, cmid), w1, x2, y_fin=(y1, *k1))

        if ctx.downsample:
            xhatd = (yd.float() - mud) * rsd
            r2_d = (p * xhatd).sum(0)
            kd = bn_finalize_coeffs(r1_3, r2_d, mud, rsd, gd, m)
            dx_res, dwd, _, _ = conv1x1_bn_act_bwd(
                dzz, wd, x2, z=z, y_fin=(yd, *kd))
            dgd, dbd = r2_d, r1_3
        else:
            dx_res = p.to(dx_main.dtype)
            dwd = dgd = dbd = None

        # fp32 sum rounded once to the dtype: what a same-dtype add does
        dx = (dx_main + dx_res.to(dx_main.dtype)).reshape(nimg, hgt, wid, -1)
        return (None, None, dx.to(dz_out.dtype),
                dw1, r2_1, r1_1, dw2, r2_2, r1_2, dw3, r2_3, r1_3,
                dwd, dgd, dbd)


def bottleneck_fused(eps, downsample, x, w1, g1, b1, w2, g2, b2, w3, g3, b3,
                     wd=None, gd=None, bd=None):
    """Training-mode fused bottleneck: z = relu(bn3(conv3(relu(bn2(
    conv2(relu(bn1(conv1(x)))))))) + residual), all convs stride 1.

    x: (N, H, W, Cin) NHWC; w1 (Cin, Cmid), w2 (3, 3, Cmid, Cmid), w3
    (Cmid, Cout); g*/b* the BN scale/offset vectors; (wd, gd, bd) the
    optional 1x1 downsample projection. Returns (z, batch_stats),
    batch_stats ((mean, var) per BN, biased var; None for a missing
    downsample) for the running averages: no gradient flows through it.
    """
    outs = _BottleneckFused.apply(eps, bool(downsample), x, w1, g1, b1, w2,
                                  g2, b2, w3, g3, b3, wd, gd, bd)
    st = outs[1:]
    stats = tuple((st[i], st[i + 1]) for i in range(0, 6, 2)) + (
        (st[6], st[7]) if downsample else None,)
    return outs[0], stats

