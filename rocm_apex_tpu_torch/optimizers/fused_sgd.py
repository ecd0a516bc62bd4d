"""Fused SGD over a params dict.

Port of ``rocm_apex_tpu/optimizers/fused_sgd.py``: momentum, dampening,
nesterov, weight decay before or after the momentum
(``wd_after_momentum``), a per-name ``weight_decay_mask`` and
``grad_scale``. The first momentum step sets the buffer to the step's
direction (buf = d), as the reference's sgd functor does
(csrc/multi_tensor_sgd_kernel.cu); the choice is a device `torch.where`
on ``count == 0``, so no step reads the count back to the host. Per leaf
in fp32 (the JAX package's tree form, which has no kernel and no packed
form):

    g = grad * grad_scale (+ wd * p unless wd_after_momentum)
    buf = g on the first step, else momentum buf + (1 - dampening) g
    d = g + momentum buf (nesterov), buf (momentum), g (none)
    update = -lr * (d (+ wd * p with wd_after_momentum))
"""

from typing import Any, NamedTuple, Optional

import torch

from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = ["FusedSGD", "FusedSGDState", "fused_sgd"]


class FusedSGDState(NamedTuple):
    count: torch.Tensor  # int32 step count
    momentum_buffer: Any  # fp32, by name


def fused_sgd(
    learning_rate: c.ScalarOrSchedule = 1e-3,
    *,
    momentum: float = 0.0,
    dampening: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    wd_after_momentum: bool = False,
    weight_decay_mask: Optional[Any] = None,
    grad_scale: Optional[Any] = None,
) -> c.GradientTransformation:
    """The fused SGD transformation: ``update(grads, state, params) ->
    (updates, state)``, the updates fp32 deltas by name."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError(
            "Nesterov momentum requires a momentum and zero dampening")

    def init_fn(params):
        device = next(iter(params.values())).device
        return FusedSGDState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            momentum_buffer=c.zeros_like_f32(params))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("fused_sgd requires params in update()")
        names = list(params)
        count = state.count + 1
        lr = c.resolve_lr(learning_rate, count)
        wd = c.wd_tree(params, weight_decay, weight_decay_mask)
        wds = [wd[k] for k in names]
        pf = [params[k].float() for k in names]
        gf = c.scaled_grads_f32(grads, names, grad_scale, count.device)
        if not wd_after_momentum:
            gf = torch._foreach_add(gf, torch._foreach_mul(pf, wds))
        buf = [state.momentum_buffer[k] for k in names]
        if momentum != 0.0:
            blend = torch._foreach_add(
                torch._foreach_mul(buf, momentum),
                torch._foreach_mul(gf, 1.0 - dampening))
            first = state.count == 0
            buf = [torch.where(first, g, b) for g, b in zip(gf, blend)]
            d = (torch._foreach_add(gf, torch._foreach_mul(buf, momentum))
                 if nesterov else buf)
        else:
            d = gf
        if wd_after_momentum:
            d = torch._foreach_add(d, torch._foreach_mul(pf, wds))
        upd = torch._foreach_mul(d, -lr)
        return (dict(zip(names, upd)),
                FusedSGDState(count=count,
                              momentum_buffer=dict(zip(names, buf))))

    return c.GradientTransformation(init_fn, update_fn)


class FusedSGD(c.FusedOptimizer):
    """The reference constructor's shape over `fused_sgd`
    (apex/optimizers/fused_sgd.py:6-91)."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule,
        momentum: float = 0.0,
        dampening: float = 0.0,
        weight_decay: float = 0.0,
        nesterov: bool = False,
        wd_after_momentum: bool = False,
        weight_decay_mask: Optional[Any] = None,
    ):
        super().__init__(fused_sgd(
            lr, momentum=momentum, dampening=dampening,
            weight_decay=weight_decay, nesterov=nesterov,
            wd_after_momentum=wd_after_momentum,
            weight_decay_mask=weight_decay_mask))
