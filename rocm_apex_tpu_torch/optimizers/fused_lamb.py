"""Fused LAMB over a params dict.

Port of ``rocm_apex_tpu/optimizers/fused_lamb.py``. The tree form, per
leaf in fp32 (the JAX package leaves it to XLA's fusion and has no
kernel there, so it is plain PyTorch, ``torch._foreach_*``):

    ||g|| = the global gradient norm * grad_scale;
    clip = max_grad_norm / ||g|| where ||g|| > max_grad_norm, else 1
    g = grad * grad_scale * clip (+ wd * p, L2 mode)
    m = beta1 m + beta3 g;  v = beta2 v + (1 - beta2) g g
    u = (m / bc1) / (sqrt(v / bc2) + eps) (+ wd * p, AdamW mode)
    ratio = ||p|| / ||u|| where both are > 0, else 1; 1 for a leaf with
            no decay unless use_nvlamb (whether a leaf has decay is a host
            float a leaf, as in the JAX package)
    update = -lr * ratio * u

``packed=True`` runs the same step over packed dtype-group buffers:
`optimizers.packed.packed_lamb` (the multi-tensor pass and the LAMB
stage pair of ``ops/optim_kernels.py``), which matches the tree form to
the summation order of its norms.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = ["FusedLAMB", "FusedLAMBState", "fused_lamb"]


class FusedLAMBState(NamedTuple):
    count: torch.Tensor  # int32 step count
    m: Any  # fp32 first moments, by name
    v: Any  # fp32 second moments, by name


def fused_lamb(
    learning_rate: c.ScalarOrSchedule = 1e-3,
    *,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    grad_averaging: bool = True,
    adam_w_mode: bool = True,
    max_grad_norm: float = 1.0,
    use_nvlamb: bool = False,
    weight_decay_mask: Optional[Any] = None,
    grad_scale: Optional[Any] = None,
    packed: bool = False,
) -> c.GradientTransformation:
    """The fused LAMB transformation (updates fp32 deltas by name)."""
    if packed:
        from rocm_apex_tpu_torch.optimizers.packed import packed_lamb

        return packed_lamb(
            learning_rate, bias_correction=bias_correction, betas=betas,
            eps=eps, weight_decay=weight_decay,
            grad_averaging=grad_averaging, adam_w_mode=adam_w_mode,
            max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb,
            weight_decay_mask=weight_decay_mask, grad_scale=grad_scale)
    beta1, beta2 = betas
    beta3 = 1.0 - beta1 if grad_averaging else 1.0

    def init_fn(params):
        device = next(iter(params.values())).device
        return FusedLAMBState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            m=c.zeros_like_f32(params), v=c.zeros_like_f32(params))

    def update_fn(grads, state, params=None):
        if params is None:
            raise ValueError("fused_lamb requires params in update()")
        names = list(params)
        count = state.count + 1
        lr = c.resolve_lr(learning_rate, count)
        t = count.float()
        if bias_correction:
            bc1 = 1.0 - beta1 ** t
            bc2 = 1.0 - beta2 ** t
        else:
            bc1 = bc2 = torch.ones((), device=t.device)
        gs = torch.as_tensor(1.0 if grad_scale is None else grad_scale,
                             dtype=torch.float32, device=t.device)
        # the global norm and its clip factor (reference lamb.cu:66 divides
        # by max(||g|| / max_grad_norm, 1): this is its reciprocal)
        gnorm = torch.linalg.vector_norm(torch.stack(
            c.foreach_norm_f32([grads[k] for k in names]))) * gs
        if max_grad_norm and max_grad_norm > 0:
            clip = torch.where(gnorm > max_grad_norm, max_grad_norm / gnorm,
                               1.0)
        else:
            clip = torch.ones((), device=t.device)
        wd = c.wd_tree(params, weight_decay, weight_decay_mask)
        wds = [wd[k] for k in names]
        pf = [params[k].float() for k in names]
        gf = torch._foreach_mul([grads[k].float() for k in names], gs * clip)
        if not adam_w_mode:
            gf = torch._foreach_add(gf, torch._foreach_mul(pf, wds))
        m2 = torch._foreach_add(
            torch._foreach_mul([state.m[k] for k in names], beta1),
            torch._foreach_mul(gf, beta3))
        v2 = torch._foreach_add(
            torch._foreach_mul([state.v[k] for k in names], beta2),
            torch._foreach_mul(torch._foreach_mul(gf, 1.0 - beta2), gf))
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(v2, bc2)), eps)
        u = torch._foreach_div(torch._foreach_div(m2, bc1), denom)
        if adam_w_mode:
            u = torch._foreach_add(u, torch._foreach_mul(pf, wds))
        # the per-leaf trust ratio (reference lamb.cu:243-262), on the
        # leaves that take one: the decayed ones, or all under use_nvlamb
        upd = list(torch._foreach_mul(u, -lr))
        trust = [i for i, w in enumerate(wds) if use_nvlamb or w != 0.0]
        if trust:
            p_norm = torch.stack(c.foreach_norm_f32([pf[i] for i in trust]))
            u_norm = torch.stack(c.foreach_norm_f32([u[i] for i in trust]))
            ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                                p_norm / u_norm, 1.0)
            for i, s in zip(trust, (ratio * -lr).unbind()):
                upd[i] = u[i] * s
        return (dict(zip(names, upd)),
                FusedLAMBState(count=count, m=dict(zip(names, m2)),
                               v=dict(zip(names, v2))))

    return c.GradientTransformation(init_fn, update_fn)


class FusedLAMB(c.FusedOptimizer):
    """The reference constructor's shape over `fused_lamb`
    (apex/optimizers/fused_lamb.py:24-87); ``amsgrad`` is refused, and
    ``packed`` selects the packed form."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        amsgrad: bool = False,
        adam_w_mode: bool = True,
        grad_averaging: bool = True,
        max_grad_norm: float = 1.0,
        use_nvlamb: bool = False,
        weight_decay_mask: Optional[Any] = None,
        packed: bool = False,
    ):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        super().__init__(fused_lamb(
            lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            adam_w_mode=adam_w_mode, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, weight_decay_mask=weight_decay_mask,
            packed=packed))
