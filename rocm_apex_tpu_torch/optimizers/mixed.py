"""Mixed-precision training state: compute-dtype model params + fp32
masters, with a fused Adam/AdamW update.

Port of `MixedPrecisionAdam` (rocm_apex_tpu/optimizers/mixed.py:61-251).
The JAX state is functional; here the state holds the masters and
moments as dicts of fp32 tensors keyed by parameter name, and ``model``
as the model's own parameters, which every step rewrites IN PLACE from
the masters (cast to the compute dtype) — the model is the compute copy,
as the JAX state's ``model`` tree is. Like that tree it holds EVERY
parameter in the compute dtype, LayerNorm weights included (so in
training the LN output is in the compute dtype too).

The update is plain PyTorch (`torch._foreach_*` over the parameter list):
the JAX package leaves it to XLA, not a Pallas kernel. The overflow skip
is a `torch.where` select, so a skipped step leaves masters, moments and
count bit-identical, and the probe is the JAX one: the fp32 sum of each
unscaled gradient, whose total is non-finite iff some element is.
Nothing here reads a value back to the host.
"""

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = ["MixedPrecisionAdam", "MixedPrecisionState"]


class MixedPrecisionState(NamedTuple):
    count: torch.Tensor  # int32 scalar on the device: applied steps
    model: Dict[str, torch.Tensor]  # compute-dtype params (updated in place)
    master: Dict[str, torch.Tensor]  # fp32
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


class MixedPrecisionAdam:
    """Fused Adam/AdamW over mixed-precision train state; the JAX
    package's hyperparameters and defaults. ``weight_decay_mask`` maps
    each parameter name to True (decayed) or False."""

    def __init__(
        self,
        learning_rate: c.ScalarOrSchedule = 1e-3,
        *,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        adam_w_mode: bool = True,
        weight_decay: float = 0.0,
        weight_decay_mask: Optional[Mapping[str, bool]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        self.learning_rate = learning_rate
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.weight_decay_mask = weight_decay_mask
        self.compute_dtype = compute_dtype

    def init(self, params: Mapping[str, torch.Tensor],
             model: Optional[nn.Module] = None) -> MixedPrecisionState:
        """Masters are fp32 copies of ``params`` (preferably fp32 values:
        they seed the masters exactly). With ``model``, its parameters of
        the same names become the compute copy: each is set to its
        master cast to the compute dtype. Without, the compute copy is a
        dict of new tensors."""
        master = {k: torch.as_tensor(p).detach().to(torch.float32).clone()
                  for k, p in params.items()}
        if model is not None:
            named = dict(model.named_parameters())
            missing = sorted(set(master) - set(named))
            if missing:
                raise KeyError(f"the model has no parameters {missing}")
            for k, p in master.items():
                named[k].data = p.to(device=named[k].device,
                                     dtype=self.compute_dtype)
                master[k] = p.to(named[k].device)
            compute = {k: named[k] for k in master}
        else:
            compute = {k: p.to(self.compute_dtype) for k, p in master.items()}
        device = next(iter(master.values())).device
        return MixedPrecisionState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            model=compute,
            master=master,
            m={k: torch.zeros_like(p) for k, p in master.items()},
            v={k: torch.zeros_like(p) for k, p in master.items()},
        )

    def _provisional(self, state, grads, grad_scale):
        """The unselected update: (names, new masters, new m, new v,
        probe) with probe the fp32 sum of the unscaled gradients."""
        names = list(state.master)
        b1, b2 = self.beta1, self.beta2
        t = (state.count + 1).to(torch.float32)
        lr = c.resolve_lr(self.learning_rate, state.count + 1)
        p = [state.master[k] for k in names]
        gs = torch.as_tensor(1.0 if grad_scale is None else grad_scale,
                             dtype=torch.float32, device=t.device)
        # a new fp32 list: the callers' gradients are left as they are
        g = torch._foreach_mul([
            grads[k].float() if grads.get(k) is not None
            else torch.zeros_like(state.master[k])
            for k in names
        ], gs)
        probe = torch.stack([x.sum() for x in g]).sum()
        wd_map = c.wd_tree(state.master, self.weight_decay,
                           self.weight_decay_mask)
        wd = [wd_map[k] for k in names]
        if not self.adam_w_mode:  # L2: decay into the gradient
            torch._foreach_add_(g, torch._foreach_mul(p, wd))
        m2 = torch._foreach_mul([state.m[k] for k in names], b1)
        torch._foreach_add_(m2, g, alpha=1.0 - b1)
        v2 = torch._foreach_mul([state.v[k] for k in names], b2)
        torch._foreach_addcmul_(v2, g, g, value=1.0 - b2)
        if self.bias_correction:
            inv_bc1 = 1.0 / (1.0 - torch.pow(b1, t))
            inv_bc2 = 1.0 / (1.0 - torch.pow(b2, t))
            den = torch._foreach_mul(v2, inv_bc2)
            u = torch._foreach_mul(m2, inv_bc1)
        else:
            den = [x.clone() for x in v2]
            u = [x.clone() for x in m2]
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        if self.adam_w_mode:  # AdamW: decoupled decay
            torch._foreach_add_(u, torch._foreach_mul(p, wd))
        torch._foreach_mul_(u, lr)
        return names, torch._foreach_sub(p, u), m2, v2, probe

    def _commit(self, state, names, p2, m2, v2, live):
        """Select new (live) or old values and write the compute copy."""
        for k, pn, mn, vn in zip(names, p2, m2, v2):
            # where, not a blend: a skipped step's provisional values may
            # be inf/nan, and inf * 0 would poison the kept ones
            state.master[k] = torch.where(live, pn, state.master[k])
            state.m[k] = torch.where(live, mn, state.m[k])
            state.v[k] = torch.where(live, vn, state.v[k])
        torch._foreach_copy_([state.model[k] for k in names],
                             [state.master[k] for k in names])
        return state._replace(count=state.count + live.to(torch.int32))

    @torch.no_grad()
    def step(self, state: MixedPrecisionState, grads: Mapping[str, torch.Tensor],
             *, grad_scale=None, skip=None) -> MixedPrecisionState:
        """One update. ``grads`` are w.r.t. the compute-dtype params, by
        name; ``grad_scale`` (1/loss_scale) fuses the unscale; ``skip``
        (a device bool) freezes every buffer when True."""
        names, p2, m2, v2, _ = self._provisional(state, grads, grad_scale)
        live = (torch.ones((), dtype=torch.bool, device=state.count.device)
                if skip is None else ~torch.as_tensor(skip))
        return self._commit(state, names, p2, m2, v2, live)

    @torch.no_grad()
    def step_and_probe(self, state: MixedPrecisionState,
                       grads: Mapping[str, torch.Tensor], *, grad_scale=None):
        """`step` with the overflow probe taken from the same gradient
        pass; returns ``(state, found_inf)`` and skips (bit-frozen state)
        when found_inf."""
        names, p2, m2, v2, probe = self._provisional(state, grads, grad_scale)
        found_inf = ~torch.isfinite(probe)
        return self._commit(state, names, p2, m2, v2, ~found_inf), found_inf
