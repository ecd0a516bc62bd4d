"""`MixedFusedLayerNorm`: the LayerNorm module of the GPT stack.

Port of ``rocm_apex_tpu/normalization/fused_layer_norm.py``. Always
affine; the output dtype follows the parameters (fp32 when serving, the
compute dtype in training, where the optimizer keeps the whole model in
it), statistics are fp32. With ``residual`` the add fuses into the
kernel and the call returns ``(LN(residual + x), residual + x)``, the
stream in the residual's dtype; ``dropout_rate``/``dropout_seed``
additionally drop ``x`` (the delta) inside the kernel before the add.
Differentiable in the input, the delta and both parameters.
"""

from typing import Optional, Tuple, Union

import torch
from torch import nn

from rocm_apex_tpu_torch.ops import layer_norm as _ln_ops

__all__ = ["MixedFusedLayerNorm"]


class MixedFusedLayerNorm(nn.Module):
    def __init__(
        self,
        normalized_shape: int,
        eps: float = 1e-5,
        params_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__()
        self.hidden = int(normalized_shape)
        self.eps = eps
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
        w = self.weight
        if residual is not None:
            if residual.shape != x.shape:
                raise ValueError(
                    f"residual/delta shapes differ: {tuple(residual.shape)} "
                    f"vs {tuple(x.shape)}"
                )
            y, s = _ln_ops.layer_norm_residual_dropout_affine(
                residual.reshape(-1, self.hidden),
                x.reshape(-1, self.hidden),
                w, self.bias, dropout_seed, dropout_rate, self.eps, w.dtype,
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
        y = _ln_ops.layer_norm_affine(x2d, w, self.bias, self.eps, w.dtype)
        return y.reshape(x.shape)
