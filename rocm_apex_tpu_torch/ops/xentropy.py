"""Label-smoothed softmax cross-entropy over materialized logits: the
hand-written CUDA kernels, their plain PyTorch versions, and the autograd
functions over them.

Port of ``rocm_apex_tpu/ops/xentropy.py``. The kernels
(``csrc/xentropy.cu``) replace the TPU kernels ``_fwd_dg_kernel``
(rocm_apex_tpu/ops/xentropy.py:155: loss and ``dg = softmax - target``
from one forward over the logits), ``_fwd_kernel`` (:53: loss and lse)
and ``_bwd_kernel`` (:61: ``dx = dl * (exp(x - lse) - target)`` from the
logits and the forward's lse). All are bound by bytes: one block per
row; the forward reads the row twice (the second time from L2) because a
vocabulary does not fit registers, every reduction in a fixed order.

Per row with label y, smoothing eps and vocab V (all fp32 inside):

    loss = lse - (1 - eps) * x[y] - (eps / V) * sum(x)
    dg_j = softmax_j - ((1 - eps) * [j == y] + eps / V)

A label outside [0, V) selects no column. Rows whose label equals
``padding_idx`` get zero loss and zero gradient, applied outside the
kernel as the JAX wrapper does; ``padding_idx=None`` disables that.

`softmax_cross_entropy_loss_fused` is the training form: when a gradient
is asked, its forward also writes ``dg`` in the logits dtype and the
backward is ``dloss[:, None] * dg`` (plain PyTorch: XLA code in the JAX
package, not a kernel); when none is asked it is the plain forward and
writes no ``dg``. `softmax_cross_entropy_loss` is the JAX function's
two-pass form (its custom vjp, :98-147): the plain forward saves the
logits and lse, and the backward zeroes the cotangent of padded rows and
runs ``_bwd_kernel``'s form over the logits again.

For a CUDA tensor the wrappers launch the kernel (or raise); for a CPU
tensor they run the plain version.
"""

import ctypes
from typing import Optional, Tuple

import torch

from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr

__all__ = [
    "XENT_FWD",
    "XENT_FWD_DG",
    "XENT_BWD",
    "softmax_cross_entropy_loss",
    "softmax_cross_entropy_loss_fused",
    "xent_fwd",
    "xent_fwd_dg",
    "xent_bwd",
    "xent_fwd_reference",
    "xent_fwd_dg_reference",
    "xent_bwd_reference",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P]
# one C entry serves both forms; counted apart, so a run shows which of
# its losses were differentiated
XENT_FWD_DG = Kernel(
    name="xent_fwd_dg",
    source="xentropy.cu",
    symbol="xent_fwd",
    argtypes=_ARGS,
    replaces="rocm_apex_tpu/ops/xentropy.py:155 _fwd_dg_kernel",
)
XENT_FWD = Kernel(
    name="xent_fwd",
    source="xentropy.cu",
    symbol="xent_fwd",
    argtypes=_ARGS,
    replaces="rocm_apex_tpu/ops/xentropy.py:53 _fwd_kernel",
)
XENT_BWD = Kernel(
    name="xent_bwd",
    source="xentropy.cu",
    symbol="xent_bwd",
    argtypes=[_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
    replaces="rocm_apex_tpu/ops/xentropy.py:61 _bwd_kernel",
)


def _loss_block(smoothing: float, x: torch.Tensor, lbl: torch.Tensor):
    """(loss, lse, col == label, p, ssum) of one fp32 (rows, V) tile: the
    TPU kernels' `_loss_block`, p the unnormalized exp(x - rowmax)."""
    vocab = x.shape[1]
    m = x.max(dim=1, keepdim=True).values
    p = torch.exp(x - m)
    ssum = p.sum(dim=1, keepdim=True)
    lse = m + torch.log(ssum)
    hit = torch.arange(vocab, device=x.device)[None, :] == lbl[:, None]
    xt = torch.where(hit, x, 0.0).sum(dim=1, keepdim=True)
    loss = lse - (1.0 - smoothing) * xt
    if smoothing > 0.0:
        loss = loss - (smoothing / vocab) * x.sum(dim=1, keepdim=True)
    return loss[:, 0], lse[:, 0], hit, p, ssum


def xent_fwd_reference(logits, labels, smoothing):
    """The plain PyTorch version of the plain forward: (loss, lse), fp32."""
    loss, lse, _, _, _ = _loss_block(smoothing, logits.float(), labels)
    return loss, lse


def xent_fwd_dg_reference(logits, labels, smoothing):
    """The plain PyTorch version of the differentiated forward: (fp32
    loss, dg = softmax - target in the logits dtype)."""
    x = logits.float()
    loss, _, hit, p, ssum = _loss_block(smoothing, x, labels)
    target = torch.where(hit, 1.0 - smoothing, 0.0) + smoothing / x.shape[1]
    return loss, (p * (1.0 / ssum) - target).to(logits.dtype)


def xent_bwd_reference(logits, labels, lse, dl, smoothing):
    """The plain PyTorch version of the backward: dx = dl * (exp(x - lse)
    - target) in fp32, returned in the logits dtype."""
    x = logits.float()
    hit = (torch.arange(x.shape[1], device=x.device)[None, :]
           == labels[:, None])
    target = torch.where(hit, 1.0 - smoothing, 0.0) + smoothing / x.shape[1]
    dx = dl.float()[:, None] * (torch.exp(x - lse[:, None]) - target)
    return dx.to(logits.dtype)


def _check(logits, labels):
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(
            f"expected (rows, vocab) logits and (rows,) labels, got "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}"
        )
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")


def _launch(kernel, logits, labels, smoothing, with_lse, with_dg):
    if logits.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {logits.device}")
    if labels.device != logits.device or not logits.is_contiguous():
        raise ValueError("the xentropy kernel takes contiguous logits and "
                         "labels on one device")
    rows, vocab = logits.shape
    labels = labels.to(torch.int64).contiguous()
    loss = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss) if with_lse else None
    dg = torch.empty_like(logits) if with_dg else None
    if rows > 0:
        kernel(ptr(logits), ptr(labels), ptr(loss), ptr(lse), ptr(dg), rows,
               vocab, float(smoothing), dtype_code(logits.dtype),
               stream_ptr(logits.device))
    return loss, lse, dg


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor,
             smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse) per row of (rows, vocab) logits, both fp32; no
    padding rule, not differentiable."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return xent_fwd_reference(logits, labels, smoothing)
    loss, lse, _ = _launch(XENT_FWD, logits, labels, smoothing, True, False)
    return loss, lse


def xent_fwd_dg(logits: torch.Tensor, labels: torch.Tensor,
                smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fp32 loss, dg in the logits dtype) per row; no padding rule."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return xent_fwd_dg_reference(logits, labels, smoothing)
    loss, _, dg = _launch(XENT_FWD_DG, logits, labels, smoothing, False, True)
    return loss, dg


def xent_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
             dl: torch.Tensor, smoothing: float = 0.0) -> torch.Tensor:
    """dx (rows, vocab) in the logits dtype from the logits, the plain
    forward's lse and the fp32 loss cotangent ``dl`` (padded rows already
    zeroed); no padding rule."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return xent_bwd_reference(logits, labels, lse, dl, smoothing)
    if logits.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {logits.device}")
    if (labels.device != logits.device or lse.device != logits.device
            or dl.device != logits.device or not logits.is_contiguous()):
        raise ValueError("the xentropy kernel takes contiguous logits and "
                         "labels, lse and dl on one device")
    rows, vocab = logits.shape
    dx = torch.empty_like(logits)
    if rows > 0:
        XENT_BWD(ptr(logits), ptr(labels.to(torch.int64).contiguous()),
                 ptr(lse.to(torch.float32).contiguous()),
                 ptr(dl.to(torch.float32).contiguous()), ptr(dx), rows,
                 vocab, float(smoothing), dtype_code(logits.dtype),
                 stream_ptr(logits.device))
    return dx


def _zero_padding(values, labels, padding_idx):
    if padding_idx is None:
        return values
    return torch.where(labels == padding_idx, 0.0, values)


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx):
        ctx.set_materialize_grads(False)
        loss, dg = xent_fwd_dg(logits, labels, smoothing)
        ctx.save_for_backward(labels, dg)
        ctx.padding_idx = padding_idx
        return _zero_padding(loss, labels, padding_idx)

    @staticmethod
    def backward(ctx, dloss):
        if dloss is None:
            return None, None, None, None
        labels, dg = ctx.saved_tensors
        dl = _zero_padding(dloss.float(), labels, ctx.padding_idx)
        # one pass: the product is formed in fp32 and rounded on the store
        dx = torch.mul(dg, dl[:, None], out=torch.empty_like(dg))
        return dx, None, None, None


def softmax_cross_entropy_loss_fused(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smoothing: float = 0.0,
    padding_idx: Optional[int] = 0,
) -> torch.Tensor:
    """Per-row smoothed CE losses (fp32) on (rows, vocab) logits with a
    one-pass backward: differentiation writes ``dg = softmax - target``
    during the forward (one extra (rows, vocab) write in the logits
    dtype) and the backward is a per-row scalar multiply, with no second
    read of the logits. Without a gradient to compute it is
    `softmax_cross_entropy_loss` and writes no ``dg``."""
    if not (torch.is_grad_enabled() and logits.requires_grad):
        loss, _ = xent_fwd(logits, labels, float(smoothing))
        return _zero_padding(loss, labels, padding_idx)
    return _FusedCE.apply(logits, labels, float(smoothing), padding_idx)


class _TwoPassCE(torch.autograd.Function):
    """The JAX custom vjp (`_vjp_fwd`/`_vjp_bwd`): the forward saves the
    logits and lse, the backward reads the logits again."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx):
        ctx.set_materialize_grads(False)
        loss, lse = xent_fwd(logits, labels, smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.args = (smoothing, padding_idx)
        return _zero_padding(loss, labels, padding_idx)

    @staticmethod
    def backward(ctx, dloss):
        if dloss is None:
            return None, None, None, None
        logits, labels, lse = ctx.saved_tensors
        smoothing, padding_idx = ctx.args
        dl = _zero_padding(dloss.float(), labels, padding_idx)
        return xent_bwd(logits, labels, lse, dl, smoothing), None, None, None


def softmax_cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smoothing: float = 0.0,
    padding_idx: Optional[int] = 0,
) -> torch.Tensor:
    """Per-row smoothed CE losses (fp32) on (rows, vocab) logits, the JAX
    function of this name: rows whose label equals ``padding_idx`` get
    zero loss and zero gradient (``None`` disables that). Differentiable
    in the logits by the two-pass backward (`xent_bwd`)."""
    return _TwoPassCE.apply(logits, labels, float(smoothing), padding_idx)
