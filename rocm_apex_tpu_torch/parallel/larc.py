"""LARC: layer-wise adaptive rate control.

Port of ``rocm_apex_tpu/parallel/larc.py`` (JAX :31-122), the reference
LARC wrapper's rewrite (apex/parallel/LARC.py:5-107): per parameter,
``adaptive_lr = trust_coefficient * ||p|| / (||g|| + wd * ||p|| +
eps)``; in clip mode the rate is capped at the inner optimizer's LR
(``min(adaptive_lr / lr, 1)``), in scale mode applied as it is; the
weight decay folds into the gradient, ``(g + wd * p) * adaptive_lr``.
A parameter or gradient of norm 0 passes through unchanged
(LARC.py:88).

`larc` is a `GradientTransformation` chained before the inner
optimizer (its ``update`` rewrites the gradients); `LARC` wraps an
optimizer object with ``init`` and ``update`` (the port's fused
optimizer classes, or a transformation) and applies the rewrite before
delegating. A tree is a dict of name -> tensor; the norms are fp32 sums
of squares (`optimizers._common.foreach_norm_f32`).
"""

from typing import Optional

import torch

from rocm_apex_tpu_torch.optimizers._common import (
    GradientTransformation,
    foreach_norm_f32,
)

__all__ = ["larc", "LARC"]


def larc(lr: float = 1.0, trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8, weight_decay: float = 0.0
         ) -> GradientTransformation:
    """The reference LARC.step's gradient rewrite (LARC.py:69-107).
    ``lr`` is read in clip mode only (the reference reads the group's
    ``lr``). ``update(grads, state, params)`` returns the rewritten
    gradients in their dtypes; integer leaves pass through."""

    def init_fn(params):
        del params
        return ()

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("larc requires params")
        names = [k for k, g in updates.items()
                 if torch.is_tensor(g) and g.is_floating_point()]
        gf = [updates[k].float() for k in names]
        pf = [params[k].float() for k in names]
        out = dict(updates)
        for k, g, p, g_norm, p_norm in zip(names, gf, pf,
                                           foreach_norm_f32(gf),
                                           foreach_norm_f32(pf)):
            rate = trust_coefficient * p_norm / (
                g_norm + p_norm * weight_decay + eps)
            if clip:
                rate = torch.clamp_max(rate / lr, 1.0)
            new_g = (g + weight_decay * p) * rate
            ok = (p_norm != 0) & (g_norm != 0)
            out[k] = torch.where(ok, new_g, g).to(updates[k].dtype)
        return out, state

    return GradientTransformation(init_fn, update_fn)


class LARC:
    """The reference's optimizer wrapper (LARC.py:5-67): ``optimizer``
    has ``init(params)`` and ``update(grads, state, params)``; its LR
    comes from ``lr`` or its ``lr`` attribute, and clip mode needs one (a
    schedule cannot be read: chain `larc` instead)."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 lr: Optional[float] = None, weight_decay: float = 0.0):
        self.optimizer = optimizer
        inferred = lr if lr is not None else getattr(optimizer, "lr", None)
        if clip and (inferred is None or callable(inferred)):
            raise ValueError(
                "LARC in clip mode needs the inner optimizer's learning "
                "rate: pass lr= explicitly (schedules are not supported "
                "by the class wrapper; chain the larc() transformation "
                "instead)")
        self._tx = larc(
            lr=(float(inferred) if inferred is not None
                and not callable(inferred) else 1.0),
            trust_coefficient=trust_coefficient, clip=clip, eps=eps,
            weight_decay=weight_decay)

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, state, params=None):
        grads, _ = self._tx.update(grads, (), params)
        return self.optimizer.update(grads, state, params)
