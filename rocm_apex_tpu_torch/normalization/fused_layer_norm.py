"""Fused LayerNorm: the functional API and the modules.

Port of ``rocm_apex_tpu/normalization/fused_layer_norm.py``, over the
LayerNorm kernels (`ops.layer_norm`); statistics are fp32 whatever the
storage dtype, and a multi-dim ``normalized_shape`` normalizes over the
product of its dims (the input viewed as (rows, prod(shape))).

* `fused_layer_norm`: non-affine, output in x's dtype;
* `fused_layer_norm_affine`: affine, output in x's dtype;
* `mixed_dtype_fused_layer_norm_affine`: x cast to the weight's dtype,
  output in the weight's dtype, eps 1e-6 by default;
* `FusedLayerNorm`: the module over the first two, ``weight``/``bias``
  of ``normalized_shape`` in ``params_dtype`` when ``elementwise_affine``;
* `MixedFusedLayerNorm`: the LayerNorm module of the GPT stack. Always
  affine; the output dtype follows the parameters (fp32 when serving, the
compute dtype in training, where the optimizer keeps the whole model in
it), statistics are fp32. With ``residual`` the add fuses into the
kernel and the call returns ``(LN(residual + x), residual + x)``, the
stream in the residual's dtype; ``dropout_rate``/``dropout_seed``
additionally drop ``x`` (the delta) inside the kernel before the add.
Differentiable in the input, the delta and both parameters.
``grad_sync_axis`` (sequence parallelism, JAX fused_layer_norm.py:
195-209): the rows are this rank's shard of the sequence, so each
rank's parameter gradients are partial row sums; the backward sums
them over the group bound to the axis (one exchange for both), the
forward is unchanged.
"""

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from rocm_apex_tpu_torch._device import resolve_device
from rocm_apex_tpu_torch.ops import layer_norm as _ln_ops
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = [
    "FusedLayerNorm",
    "MixedFusedLayerNorm",
    "fused_layer_norm",
    "fused_layer_norm_affine",
    "mixed_dtype_fused_layer_norm_affine",
]

Shape = Union[int, Sequence[int]]


def _normalize_shape(normalized_shape: Shape) -> Tuple[int, ...]:
    if isinstance(normalized_shape, int):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


def _to_2d(x: torch.Tensor, normalized_shape: Shape):
    """x as (rows, prod(normalized_shape)), after checking its trailing
    dims; and prod(normalized_shape)."""
    shape = _normalize_shape(normalized_shape)
    n = len(shape)
    if tuple(x.shape[-n:]) != shape:
        raise ValueError(f"input trailing dims {tuple(x.shape[-n:])} != "
                         f"normalized_shape {shape}")
    hidden = math.prod(shape)
    return x.reshape(-1, hidden), hidden


def fused_layer_norm(x: torch.Tensor, normalized_shape: Shape,
                     eps: float = 1e-5) -> torch.Tensor:
    """Non-affine LN over the trailing ``normalized_shape`` dims; output
    in x's dtype."""
    x2d, _ = _to_2d(x, normalized_shape)
    return _ln_ops.layer_norm(x2d.contiguous(), eps).reshape(x.shape)


def fused_layer_norm_affine(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, normalized_shape: Shape,
                            eps: float = 1e-5) -> torch.Tensor:
    """Affine LN; the output is in x's dtype."""
    x2d, hidden = _to_2d(x, normalized_shape)
    y = _ln_ops.layer_norm_affine(x2d.contiguous(), weight.reshape(hidden),
                                  bias.reshape(hidden), eps, x.dtype)
    return y.reshape(x.shape)


def mixed_dtype_fused_layer_norm_affine(x: torch.Tensor,
                                        weight: torch.Tensor,
                                        bias: torch.Tensor,
                                        normalized_shape: Shape,
                                        eps: float = 1e-6) -> torch.Tensor:
    """Affine LN of x cast to the weight's dtype; the output is in the
    weight's dtype."""
    x2d, hidden = _to_2d(x, normalized_shape)
    y = _ln_ops.layer_norm_affine(x2d.to(weight.dtype).contiguous(),
                                  weight.reshape(hidden),
                                  bias.reshape(hidden), eps, weight.dtype)
    return y.reshape(x.shape)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims, output in
    the input's dtype; ``elementwise_affine`` adds ``weight`` (ones) and
    ``bias`` (zeros) of that shape in ``params_dtype``, on ``device``
    (default the current CUDA device)."""

    def __init__(
        self,
        normalized_shape: Shape,
        eps: float = 1e-5,
        elementwise_affine: bool = True,
        params_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        self.normalized_shape = _normalize_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        device = resolve_device(device)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=params_dtype, device=device))
            self.bias = nn.Parameter(torch.zeros(
                self.normalized_shape, dtype=params_dtype, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.elementwise_affine:
            return fused_layer_norm_affine(x, self.weight, self.bias,
                                           self.normalized_shape, self.eps)
        return fused_layer_norm(x, self.normalized_shape, self.eps)

    def extra_repr(self) -> str:
        return (f"{self.normalized_shape}, eps={self.eps}, "
                f"elementwise_affine={self.elementwise_affine}")


class _SumGrads(torch.autograd.Function):
    """Identity forward on (weight, bias); the backward sums both
    gradients over the group in one all-reduce (JAX `_psum_grad`, the
    functional form of Megatron's sequence-parallel gradient
    all-reduce)."""

    @staticmethod
    def forward(ctx, weight, bias, group):
        ctx.group = group
        return weight.view_as(weight), bias.view_as(bias)

    @staticmethod
    def backward(ctx, gw, gb):
        n = gw.numel()
        both = parallel_state.all_reduce(torch.cat([gw.reshape(-1),
                                                    gb.reshape(-1)]),
                                         ctx.group)
        return (both[:n].view_as(gw), both[n:].view_as(gb), None)


class MixedFusedLayerNorm(nn.Module):
    def __init__(
        self,
        normalized_shape: int,
        eps: float = 1e-5,
        params_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        grad_sync_axis: Optional[str] = None,
    ):
        super().__init__()
        self.hidden = int(normalized_shape)
        self.eps = eps
        self.grad_sync_axis = grad_sync_axis
        self.weight = nn.Parameter(
            torch.ones(self.hidden, dtype=params_dtype, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(self.hidden, dtype=params_dtype, device=device)
        )

    def forward(
        self,
        x: torch.Tensor,
        residual: Optional[torch.Tensor] = None,
        dropout_rate: float = 0.0,
        dropout_seed: int = 0,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        if x.shape[-1] != self.hidden:
            raise ValueError(
                f"input trailing dim {x.shape[-1]} != normalized_shape "
                f"{self.hidden}"
            )
        w, b = self.weight, self.bias
        if self.grad_sync_axis is not None:
            w, b = _SumGrads.apply(
                w, b, parallel_state.resolve_group(self.grad_sync_axis))
        if residual is not None:
            if residual.shape != x.shape:
                raise ValueError(
                    f"residual/delta shapes differ: {tuple(residual.shape)} "
                    f"vs {tuple(x.shape)}"
                )
            y, s = _ln_ops.layer_norm_residual_dropout_affine(
                residual.reshape(-1, self.hidden),
                x.reshape(-1, self.hidden),
                w, b, dropout_seed, dropout_rate, self.eps, w.dtype,
            )
            return y.reshape(x.shape), s.reshape(x.shape)
        if dropout_rate > 0.0:
            raise ValueError(
                "in-kernel dropout rides the residual form; pass residual="
            )
        x2d = x.reshape(-1, self.hidden)
        if torch.finfo(x2d.dtype).bits > torch.finfo(w.dtype).bits:
            # the mixed contract normalizes the input AS the weight dtype;
            # a narrower input widens exactly inside the kernel instead
            x2d = x2d.to(w.dtype)
        y = _ln_ops.layer_norm_affine(x2d, w, b, self.eps, w.dtype)
        return y.reshape(x.shape)
