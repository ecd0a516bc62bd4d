"""Fused Adam/AdamW over a params dict.

Port of ``rocm_apex_tpu/optimizers/fused_adam.py``: `fused_adam`, the
gradient transformation (AdamW or L2 decay, optional bias correction,
``grad_scale``, a per-name ``weight_decay_mask``), and the `FusedAdam`
class (it refuses AMSGrad, as the reference does). The math is fp32
whatever the storage dtype, element for element the JAX update:

    g = grad * grad_scale (+ wd * p in L2 mode)
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
    u = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd * p in AdamW mode)
    update = -lr * u

The JAX package leaves this tree form to XLA's fusion and has no kernel
here, so it is plain PyTorch: ``torch._foreach_*`` ops over the leaves,
the step count and the bias corrections device tensors (no host read).
``packed=True`` routes to `optimizers.packed.packed_adam` (the packed
buffers and the row-15 kernel).
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam"]


class FusedAdamState(NamedTuple):
    count: torch.Tensor  # int32 step count
    m: Any  # fp32 first moments, by name
    v: Any  # fp32 second moments, by name


def fused_adam(
    learning_rate: c.ScalarOrSchedule = 1e-3,
    *,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    adam_w_mode: bool = True,
    weight_decay: float = 0.0,
    weight_decay_mask: Optional[Any] = None,
    grad_scale: Optional[Any] = None,
    packed: bool = False,
) -> c.GradientTransformation:
    """The fused Adam transformation: ``update(grads, state, params) ->
    (updates, state)``, the updates fp32 deltas by name."""
    if packed:
        from rocm_apex_tpu_torch.optimizers.packed import packed_adam

        return packed_adam(
            learning_rate, bias_correction=bias_correction, betas=betas,
            eps=eps, adam_w_mode=adam_w_mode, weight_decay=weight_decay,
            weight_decay_mask=weight_decay_mask, grad_scale=grad_scale)
    beta1, beta2 = betas

    def init_fn(params):
        device = next(iter(params.values())).device
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m=c.zeros_like_f32(params), v=c.zeros_like_f32(params))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("fused_adam requires params in update()")
        names = list(params)
        count = state.count + 1
        lr = c.resolve_lr(learning_rate, count)
        t = count.float()
        if bias_correction:
            bc1 = 1.0 - beta1 ** t
            bc2 = 1.0 - beta2 ** t
        else:
            bc1 = bc2 = torch.ones((), device=t.device)
        wd = c.wd_tree(params, weight_decay, weight_decay_mask)
        wds = [wd[k] for k in names]
        pf = [params[k].float() for k in names]
        gf = c.scaled_grads_f32(grads, names, grad_scale, t.device)
        if not adam_w_mode:
            gf = torch._foreach_add(gf, torch._foreach_mul(pf, wds))
        m2 = torch._foreach_add(
            torch._foreach_mul([state.m[k] for k in names], beta1),
            torch._foreach_mul(gf, 1.0 - beta1))
        v2 = torch._foreach_add(
            torch._foreach_mul([state.v[k] for k in names], beta2),
            torch._foreach_mul(torch._foreach_mul(gf, 1.0 - beta2), gf))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v2, bc2)), eps)
        u = torch._foreach_div(torch._foreach_div(m2, bc1), denom)
        if adam_w_mode:
            u = torch._foreach_add(u, torch._foreach_mul(pf, wds))
        upd = torch._foreach_mul(u, -lr)
        return (dict(zip(names, upd)),
                FusedAdamState(count=count, m=dict(zip(names, m2)),
                               v=dict(zip(names, v2))))

    return c.GradientTransformation(init_fn, update_fn)


class FusedAdam(c.FusedOptimizer):
    """The reference constructor's shape over `fused_adam`; ``amsgrad`` is
    refused."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        adam_w_mode: bool = True,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        weight_decay_mask: Optional[Any] = None,
    ):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        super().__init__(fused_adam(
            lr, bias_correction=bias_correction, betas=betas, eps=eps,
            adam_w_mode=adam_w_mode, weight_decay=weight_decay,
            weight_decay_mask=weight_decay_mask))
