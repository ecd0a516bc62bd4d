"""Fused NovoGrad over a params dict.

Port of ``rocm_apex_tpu/optimizers/fused_novograd.py``. The second moment
is one fp32 scalar a leaf: the blended gradient norm, not its square
(apex/optimizers/fused_novograd.py:158-177). Per leaf, in fp32:

    n = ||grad|| * grad_scale (L2, norm_type 2; max |grad|, norm_type 0)
    v = n on the first step unless init_zero, else the blend of v and n:
        sqrt(beta2 v^2 + (1 - beta2) n^2) for L2 (in squared space),
        beta2 v + (1 - beta2) n for the max norm
    g = grad * grad_scale;  denom = v / bc2 + eps, bc2 = sqrt(1 - beta2^t)
    reg_inside_moment: m = beta1 m + beta3 (g / denom + wd p),
                       update = -lr m / bc1
    else:              m = beta1 m + beta3 g,
                       update = -lr (m / bc1 / denom + wd p)

with beta3 = 1 - beta1 under grad averaging, else 1. The first-step
choice is a device `torch.where` on the count. The JAX package's tree
form has no kernel: plain PyTorch, the norms by ``torch._foreach_norm``
(the L2 norms through `_common.foreach_norm_f32`).
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = ["FusedNovoGrad", "FusedNovoGradState", "fused_novograd"]


class FusedNovoGradState(NamedTuple):
    count: torch.Tensor  # int32 step count
    m: Any  # fp32 first moments, by name
    v: Any  # fp32 scalar a leaf: the blended gradient norm, by name


def fused_novograd(
    learning_rate: c.ScalarOrSchedule = 1e-3,
    *,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.95, 0.98),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_averaging: bool = True,
    reg_inside_moment: bool = False,
    norm_type: int = 2,
    init_zero: bool = False,
    weight_decay_mask: Optional[Any] = None,
    grad_scale: Optional[Any] = None,
) -> c.GradientTransformation:
    """The fused NovoGrad transformation (updates fp32 deltas by name)."""
    if norm_type not in (0, 2):
        raise RuntimeError(
            "FusedNovoGrad only supports l2 (2) / inf (0) norm")
    beta1, beta2 = betas
    beta3 = 1.0 - beta1 if grad_averaging else 1.0

    def init_fn(params):
        device = next(iter(params.values())).device
        return FusedNovoGradState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m=c.zeros_like_f32(params),
            v={k: torch.zeros((), dtype=torch.float32, device=device)
               for k in params})

    def blend(old, new):
        if norm_type == 2:
            return torch.sqrt(beta2 * old * old + (1.0 - beta2) * new * new)
        return beta2 * old + (1.0 - beta2) * new

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("fused_novograd requires params in update()")
        names = list(params)
        count = state.count + 1
        lr = c.resolve_lr(learning_rate, count)
        t = count.float()
        if bias_correction:
            bc1 = 1.0 - beta1 ** t
            # the reference's launcher takes the square root here
            # (csrc/multi_tensor_novograd.cu:151)
            bc2 = torch.sqrt(1.0 - beta2 ** t)
        else:
            bc1 = bc2 = torch.ones((), device=t.device)
        wd = c.wd_tree(params, weight_decay, weight_decay_mask)
        wds = [wd[k] for k in names]
        pf = [params[k].float() for k in names]
        gf = [grads[k].float() for k in names]
        norms = (c.foreach_norm_f32(gf) if norm_type == 2
                 else torch._foreach_norm(gf, float("inf")))
        if grad_scale is not None:
            gs = torch.as_tensor(grad_scale, dtype=torch.float32,
                                 device=t.device)
            norms = torch._foreach_mul(norms, gs)
            gf = torch._foreach_mul(gf, gs)
        first = count == 1
        v2 = [blend(state.v[k], n) if init_zero
              else torch.where(first, n, blend(state.v[k], n))
              for k, n in zip(names, norms)]
        denom = [v / bc2 + eps for v in v2]
        m = torch._foreach_mul([state.m[k] for k in names], beta1)
        if reg_inside_moment:
            inner = torch._foreach_add(
                [g / dn for g, dn in zip(gf, denom)],
                torch._foreach_mul(pf, wds))
            m2 = torch._foreach_add(m, torch._foreach_mul(inner, beta3))
            u = torch._foreach_div(m2, bc1)
        else:
            m2 = torch._foreach_add(m, torch._foreach_mul(gf, beta3))
            u = torch._foreach_add(
                [x / dn for x, dn in zip(torch._foreach_div(m2, bc1), denom)],
                torch._foreach_mul(pf, wds))
        upd = torch._foreach_mul(u, -lr)
        return (dict(zip(names, upd)),
                FusedNovoGradState(count=count, m=dict(zip(names, m2)),
                                   v=dict(zip(names, v2))))

    return c.GradientTransformation(init_fn, update_fn)


class FusedNovoGrad(c.FusedOptimizer):
    """The reference constructor's shape over `fused_novograd`
    (apex/optimizers/fused_novograd.py:66-90); ``amsgrad`` is refused."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.95, 0.98),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        reg_inside_moment: bool = False,
        grad_averaging: bool = True,
        norm_type: int = 2,
        init_zero: bool = False,
        weight_decay_mask: Optional[Any] = None,
    ):
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        super().__init__(fused_novograd(
            lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            reg_inside_moment=reg_inside_moment, norm_type=norm_type,
            init_zero=init_zero, weight_decay_mask=weight_decay_mask))
