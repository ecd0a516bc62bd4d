"""Label-smoothed softmax cross-entropy over materialized logits: the
hand-written CUDA kernel, its plain PyTorch version, and the autograd
function over them.

Port of ``rocm_apex_tpu/ops/xentropy.py``. The kernel
(``csrc/xentropy.cu``) replaces the TPU kernels ``_fwd_dg_kernel``
(rocm_apex_tpu/ops/xentropy.py:155: loss and ``dg = softmax - target``
from one forward over the logits) and ``_fwd_kernel`` (:53: loss and
lse). Both are bound by bytes: one block per row, the row read twice
(the second time from L2) because a vocabulary does not fit registers,
every reduction in a fixed order.

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
writes no ``dg``. `softmax_cross_entropy_loss` is that plain forward;
its two-pass backward (``_bwd_kernel``, :61) is not ported yet.

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
    "softmax_cross_entropy_loss",
    "softmax_cross_entropy_loss_fused",
    "xent_fwd",
    "xent_fwd_dg",
    "xent_fwd_reference",
    "xent_fwd_dg_reference",
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


def softmax_cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    smoothing: float = 0.0,
    padding_idx: Optional[int] = 0,
) -> torch.Tensor:
    """Per-row smoothed CE losses (fp32) on (rows, vocab) logits, the
    forward of the JAX function of this name. Its backward is the
    two-pass ``_bwd_kernel``, which is not ported yet: differentiate
    `softmax_cross_entropy_loss_fused` instead."""
    if torch.is_grad_enabled() and logits.requires_grad:
        raise NotImplementedError(
            "the backward of softmax_cross_entropy_loss (_bwd_kernel, "
            "rocm_apex_tpu/ops/xentropy.py:61) is not ported yet (ROADMAP "
            "Queue 2, contrib xentropy); use "
            "softmax_cross_entropy_loss_fused"
        )
    loss, _ = xent_fwd(logits, labels, float(smoothing))
    return _zero_padding(loss, labels, padding_idx)
