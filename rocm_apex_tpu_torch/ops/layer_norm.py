"""Row LayerNorm forward: the hand-written CUDA kernel and its plain
PyTorch version.

Port of ``rocm_apex_tpu/ops/layer_norm.py`` (forward only; the
backward and the in-kernel dropout belong to the training slice). The
kernel (``csrc/layer_norm.cu``) replaces the TPU kernel
``_ln_fwd_kernel`` (rocm_apex_tpu/ops/layer_norm.py:78). It is bound by
bytes: one warp per row, every pass a coalesced warp load, the row
re-read from L1 for the second and third passes.

For a CUDA tensor the wrappers launch the kernel (or raise); for a CPU
tensor they run the plain version. Statistics are fp32 whatever the
storage dtype; the residual form returns ``(LN(x + delta), x + delta)``
with the stream in x's dtype and the normalization computed from the
fp32 sum, as the TPU kernel does.
"""

import ctypes
from typing import Optional, Tuple

import torch

from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr

__all__ = [
    "LN_FWD",
    "layer_norm_fwd",
    "layer_norm_affine",
    "layer_norm_residual_affine",
    "layer_norm_fwd_plain",
]

_P = ctypes.c_void_p
LN_FWD = Kernel(
    name="layer_norm_fwd",
    source="layer_norm.cu",
    symbol="ln_fwd",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    replaces="rocm_apex_tpu/ops/layer_norm.py:78 _ln_fwd_kernel",
)


def layer_norm_fwd_plain(x2d, delta2d, weight, bias, eps, out_dtype):
    """The plain PyTorch version: returns (y, s, mean, rsigma); s is None
    without a delta."""
    x = x2d.float()
    s = None
    if delta2d is not None:
        x = x + delta2d.float()
        s = x.to(x2d.dtype)
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    rs = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rs
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(out_dtype), s, mu[:, 0], rs[:, 0]


def _ln_fwd_impl(x2d, delta2d, weight, bias, eps, out_dtype):
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
    if x2d.device.type == "cpu":
        return layer_norm_fwd_plain(x2d, delta2d, weight, bias, eps, out_dtype)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x2d.device}")
    tensors = [x2d, delta2d, weight, bias]
    for t in tensors:
        if t is not None and (t.device != x2d.device or not t.is_contiguous()):
            raise ValueError(
                "layer_norm_fwd takes contiguous tensors on one device"
            )
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
        LN_FWD(
            ptr(x2d), ptr(delta2d), ptr(weight), ptr(bias), ptr(y), ptr(s),
            ptr(mean), ptr(rsigma), rows, hidden, float(eps),
            dtype_code(x2d.dtype), w_code, dtype_code(out_dtype),
            stream_ptr(x2d.device),
        )
    return y, s, mean, rsigma


def layer_norm_fwd(
    x2d: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LN forward on a (rows, hidden) view; returns (y, mean, rsigma)."""
    y, _, mu, rs = _ln_fwd_impl(x2d, None, weight, bias, eps, out_dtype)
    return y, mu, rs


def layer_norm_affine(x2d, weight, bias, eps):
    """Affine LN on (rows, hidden); output in x's dtype."""
    return _ln_fwd_impl(x2d, None, weight, bias, eps, None)[0]


def layer_norm_residual_affine(x2d, delta2d, weight, bias, eps, out_dtype=None):
    """(LN(x + delta), x + delta) in one kernel on (rows, hidden) views:
    ``y`` in ``out_dtype`` (default x's), the stream ``s`` in x's."""
    y, s, _, _ = _ln_fwd_impl(x2d, delta2d, weight, bias, eps, out_dtype)
    return y, s
