"""Fused Adagrad over a params dict.

Port of ``rocm_apex_tpu/optimizers/fused_adagrad.py``: per leaf in fp32,

    g = grad * grad_scale (+ wd * p, L2 mode)
    h = h + g g;  update = -lr * (g / (sqrt(h) + eps) (+ wd * p, w mode))

``adagrad_w_mode`` decouples the weight decay from the accumulator
(apex/optimizers/fused_adagrad.py:30-36). The JAX package's tree form has
no kernel, so this is plain PyTorch (``torch._foreach_*``).
"""

from typing import Any, NamedTuple, Optional

import torch

from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = ["FusedAdagrad", "FusedAdagradState", "fused_adagrad"]


class FusedAdagradState(NamedTuple):
    count: torch.Tensor  # int32 step count
    sum: Any  # fp32 accumulators, by name ("sum" in torch's Adagrad)


def fused_adagrad(
    learning_rate: c.ScalarOrSchedule = 1e-2,
    *,
    eps: float = 1e-10,
    weight_decay: float = 0.0,
    adagrad_w_mode: bool = False,
    weight_decay_mask: Optional[Any] = None,
    grad_scale: Optional[Any] = None,
) -> c.GradientTransformation:
    """The fused Adagrad transformation (updates fp32 deltas by name)."""

    def init_fn(params):
        device = next(iter(params.values())).device
        return FusedAdagradState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            sum=c.zeros_like_f32(params))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("fused_adagrad requires params in update()")
        names = list(params)
        count = state.count + 1
        lr = c.resolve_lr(learning_rate, count)
        wd = c.wd_tree(params, weight_decay, weight_decay_mask)
        wds = [wd[k] for k in names]
        pf = [params[k].float() for k in names]
        gf = c.scaled_grads_f32(grads, names, grad_scale, count.device)
        if not adagrad_w_mode:
            gf = torch._foreach_add(gf, torch._foreach_mul(pf, wds))
        h2 = torch._foreach_add([state.sum[k] for k in names],
                                torch._foreach_mul(gf, gf))
        u = torch._foreach_div(
            gf, torch._foreach_add(torch._foreach_sqrt(h2), eps))
        if adagrad_w_mode:
            u = torch._foreach_add(u, torch._foreach_mul(pf, wds))
        upd = torch._foreach_mul(u, -lr)
        return (dict(zip(names, upd)),
                FusedAdagradState(count=count, sum=dict(zip(names, h2))))

    return c.GradientTransformation(init_fn, update_fn)


class FusedAdagrad(c.FusedOptimizer):
    """The reference constructor's shape over `fused_adagrad`
    (apex/optimizers/fused_adagrad.py:5-60)."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-2,
        eps: float = 1e-10,
        weight_decay: float = 0.0,
        adagrad_w_mode: bool = False,
        weight_decay_mask: Optional[Any] = None,
    ):
        super().__init__(fused_adagrad(
            lr, eps=eps, weight_decay=weight_decay,
            adagrad_w_mode=adagrad_w_mode,
            weight_decay_mask=weight_decay_mask))
