"""Mixed-precision training state: compute-dtype model params + fp32
masters, with a fused Adam/AdamW update and a fused LAMB update.

Port of `MixedPrecisionAdam` (rocm_apex_tpu/optimizers/mixed.py:61-251)
and `MixedPrecisionLamb` (:254-543).
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
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from rocm_apex_tpu_torch.ops import optim_kernels as _ok
from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = [
    "MixedPrecisionAdam",
    "MixedPrecisionLamb",
    "MixedPrecisionState",
    "takes_leaf_kernels",
]


class MixedPrecisionState(NamedTuple):
    count: torch.Tensor  # int32 scalar on the device: applied steps
    # compute-dtype params (updated in place); None for a LAMB state with
    # store_model=False
    model: Optional[Dict[str, torch.Tensor]]
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
        master, compute = c.masters_and_compute(params, model,
                                               self.compute_dtype)
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


def takes_leaf_kernels(x: torch.Tensor) -> bool:
    """The JAX class's leaf routing (mixed.py:427-435 there): a leaf of at
    least 65536 elements whose last dim is a multiple of 128 takes the
    per-leaf kernel pair; the rest keep plain tensor math."""
    return x.dim() > 0 and x.numel() >= (1 << 16) and x.shape[-1] % 128 == 0


class _LambPlan(NamedTuple):
    """What one parameter set fixes for every step, built on first use."""
    kernel: Tuple[str, ...]  # leaves on the kernel pair, in order
    tree: Tuple[str, ...]  # leaves on plain tensor math, in order
    wd: Dict[str, float]
    consts: torch.Tensor  # fp32 [b1, b2, b3, eps] on the device
    decayed: torch.Tensor  # bool per leaf, kernel leaves then tree leaves
    sizes: Tuple[int, ...]  # elements of each tree leaf
    segment: Optional[torch.Tensor]  # tree leaf index of each flat element
    wd_flat: Optional[torch.Tensor]  # weight decay of each flat element


class MixedPrecisionLamb:
    """Fused LAMB over mixed-precision train state, the BERT-Large
    recipe; the JAX class's hyperparameters and defaults.

    The same state as `MixedPrecisionAdam` (compute-dtype model copy,
    fp32 masters, moments), arranged for memory bandwidth as in the JAX
    class:

    * the overflow probe IS the global gradient-norm pass LAMB needs for
      its clip: a non-finite sum of squares is the overflow;
    * the update direction ``u`` is never stored: stage 1 updates the
      moments and emits the trust-ratio sums, stage 2 recomputes ``u``
      from (master, m2, v2) and applies ``p - lr * ratio * u``;
    * ``moment_dtype=torch.bfloat16`` halves the moments' traffic and
      state. Stage 1 takes ``sum u^2`` from the fp32 moments before
      rounding while stage 2 recomputes ``u`` from the stored, rounded
      ones, so the applied direction and the ratio scaling it differ at
      the 2^-9 tier, as designed in the JAX class (a reloaded state
      reproduces the step from its stored moments).

    ``store_model=True`` writes the compute copy from stage 2;
    ``store_model=False`` leaves ``state.model`` None and `model_params`
    casts it from the masters on demand (the JAX class saves a carried
    copy that way; here the module holds its parameters either way, and
    the option only chooses which pass writes them).

    Trust ratio: ||master|| / ||u|| for decayed tensors (all tensors
    with ``use_nvlamb``), 1 otherwise; the clip divides the gradients by
    max(||g|| / max_grad_norm, 1). ``weight_decay_mask`` maps each
    parameter name to True (decayed) or False.
    """

    def __init__(
        self,
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
        weight_decay_mask: Optional[Mapping[str, bool]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        moment_dtype: torch.dtype = torch.float32,
        store_model: bool = True,
    ):
        self.learning_rate = learning_rate
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.beta3 = 1.0 - self.beta1 if grad_averaging else 1.0
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.weight_decay_mask = weight_decay_mask
        self.compute_dtype = compute_dtype
        self.moment_dtype = moment_dtype
        self.store_model = store_model
        self._plans: Dict[tuple, _LambPlan] = {}

    def init(self, params: Mapping[str, torch.Tensor],
             model: Optional[nn.Module] = None) -> MixedPrecisionState:
        """Masters are fp32 copies of ``params``; with ``model`` its
        parameters of the same names are set to the masters cast to the
        compute dtype (and are ``state.model`` when ``store_model``)."""
        master, compute = c.masters_and_compute(params, model,
                                               self.compute_dtype)
        device = next(iter(master.values())).device
        return MixedPrecisionState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            model=compute if self.store_model else None,
            master=master,
            m={k: torch.zeros_like(p, dtype=self.moment_dtype)
               for k, p in master.items()},
            v={k: torch.zeros_like(p, dtype=self.moment_dtype)
               for k, p in master.items()},
        )

    @torch.no_grad()
    def model_params(self, state: MixedPrecisionState,
                     model: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
        """The compute-dtype parameters by name: ``state.model`` when it
        is stored; otherwise cast from the masters, into ``model``'s own
        parameters (in place) when a module is given."""
        if state.model is not None:
            return state.model
        names = list(state.master)
        if model is None:
            return {k: state.master[k].to(self.compute_dtype) for k in names}
        named = dict(model.named_parameters())
        torch._foreach_copy_([named[k] for k in names],
                             [state.master[k] for k in names])
        return {k: named[k] for k in names}

    def _plan(self, state: MixedPrecisionState) -> _LambPlan:
        device = state.count.device
        key = (device, tuple((k, p.shape) for k, p in state.master.items()))
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        wd = c.wd_tree(state.master, self.weight_decay,
                       self.weight_decay_mask)
        kernel = tuple(k for k, p in state.master.items()
                       if takes_leaf_kernels(p))
        tree = tuple(k for k in state.master if k not in set(kernel))
        sizes = tuple(state.master[k].numel() for k in tree)
        segment = wd_flat = None
        if tree:
            counts = torch.tensor(sizes, device=device)
            segment = torch.repeat_interleave(
                torch.arange(len(tree), device=device), counts)
            wd_flat = torch.tensor([wd[k] for k in tree], dtype=torch.float32,
                                   device=device)[segment]
        plan = _LambPlan(
            kernel=kernel, tree=tree, wd=wd,
            consts=torch.tensor(
                [self.beta1, self.beta2, self.beta3, self.eps],
                dtype=torch.float32, device=device),
            decayed=torch.tensor([wd[k] != 0.0 for k in kernel + tree],
                                 dtype=torch.bool, device=device),
            sizes=sizes, segment=segment, wd_flat=wd_flat,
        )
        self._plans[key] = plan
        return plan

    def _u(self, m2, v2, p, wd, inv_bc1, inv_bc2):
        u = (m2 * inv_bc1) / (torch.sqrt(v2 * inv_bc2) + self.eps)
        if self.adam_w_mode:
            u = u + wd * p
        return u

    @torch.no_grad()
    def step_and_probe(self, state: MixedPrecisionState,
                       grads: Mapping[str, torch.Tensor], *, grad_scale=None):
        """One fused update; returns ``(state, found_inf)``. ``grads``
        are w.r.t. the compute-dtype params, by name (a missing or None
        entry is a zero gradient); ``grad_scale`` (1/loss_scale) fuses
        the unscale. On overflow every buffer and the count stay bit for
        bit as they were."""
        plan = self._plan(state)
        b1, b2, b3 = self.beta1, self.beta2, self.beta3
        device = state.count.device
        t = (state.count + 1).to(torch.float32)
        lr = c.resolve_lr(self.learning_rate, state.count + 1)
        one = torch.ones((), dtype=torch.float32, device=device)
        if self.bias_correction:
            bc1 = 1.0 - torch.pow(b1, t)
            bc2 = 1.0 - torch.pow(b2, t)
        else:
            bc1 = bc2 = one
        gs = (one if grad_scale is None else
              torch.as_tensor(grad_scale, dtype=torch.float32, device=device))
        names = plan.kernel + plan.tree
        g = {k: grads[k] if grads.get(k) is not None
             else torch.zeros_like(state.master[k], dtype=self.compute_dtype)
             for k in names}

        # the global gradient norm = the overflow probe (one read of g)
        norms = torch.stack(c.foreach_norm_f32([g[k] for k in names]))
        gsq = ((norms * gs) ** 2).sum()
        found_inf = ~torch.isfinite(gsq)
        ok = ~found_inf
        live = ok.to(torch.float32)
        clip = one
        if self.max_grad_norm and self.max_grad_norm > 0:
            gnorm = torch.sqrt(gsq)
            clip = torch.where(gnorm > self.max_grad_norm,
                               self.max_grad_norm / gnorm, one)
        gs_clip = gs * clip
        nk = len(plan.kernel)
        # per leaf (sum p^2, sum u^2), kernel leaves then tree leaves
        sums = torch.empty((len(names), 2), dtype=torch.float32,
                           device=device)

        # pass A: moments in place + the trust-ratio sums, u in registers
        scalars_a = torch.cat(
            [plan.consts, torch.stack([bc1, bc2, gs_clip, live])])
        kp = [state.master[k] for k in plan.kernel]
        km = [state.m[k] for k in plan.kernel]
        kv = [state.v[k] for k in plan.kernel]
        kwd = [plan.wd[k] for k in plan.kernel]
        if plan.kernel:
            _ok.lamb_leaves_stage1(
                kp, [g[k].contiguous() for k in plan.kernel], km, kv,
                scalars_a, kwd, self.adam_w_mode, out=sums[:nk])
        inv_bc1, inv_bc2 = 1.0 / bc1, 1.0 / bc2
        if plan.tree:
            # the small leaves as one flat buffer: a dozen launches for
            # all of them instead of a dozen per leaf
            def flat(d):
                return _flatten_dense_tensors([d[k] for k in plan.tree])

            tp = [state.master[k] for k in plan.tree]
            p_t = flat(state.master)
            m_old, v_old = flat(state.m).float(), flat(state.v).float()
            gf = flat(g).float() * gs_clip
            if not self.adam_w_mode:
                gf = gf + plan.wd_flat * p_t
            m2 = b1 * m_old + b3 * gf
            v2 = b2 * v_old + (1.0 - b2) * gf * gf
            u = self._u(m2, v2, p_t, plan.wd_flat, inv_bc1, inv_bc2)
            # where, not a blend: a skipped step's values may be inf/nan
            m_t = torch.where(ok, m2, m_old).to(self.moment_dtype)
            v_t = torch.where(ok, v2, v_old).to(self.moment_dtype)
            for d, new in ((state.m, m_t), (state.v, v_t)):
                torch._foreach_copy_([d[k] for k in plan.tree],
                                     _unflatten_dense_tensors(new, tp))
            sums[nk:, 0] = torch.stack(
                torch._foreach_norm(list(p_t.split(plan.sizes)))) ** 2
            sums[nk:, 1] = torch.stack(
                torch._foreach_norm(list(u.split(plan.sizes)))) ** 2

        # per-tensor trust ratio (scalar math on the reduction results)
        psq, usq = sums[:, 0], sums[:, 1]
        ratio = torch.where((psq > 0.0) & (usq > 0.0),
                            torch.sqrt(psq) / torch.sqrt(usq), one)
        if not self.use_nvlamb:
            ratio = torch.where(plan.decayed, ratio, one)
        lr_ratio = (lr * ratio).to(torch.float32)

        # pass B: recompute u from the STORED moments and apply; the
        # compute copy rides the same pass when it is stored
        scalars_b = torch.cat(
            [plan.consts[3:], torch.stack([bc1, bc2, live])])
        if plan.kernel:
            _ok.lamb_leaves_stage2(
                kp, km, kv, scalars_b, lr_ratio[:nk], kwd, self.adam_w_mode,
                model_outs=(None if state.model is None
                            else [state.model[k] for k in plan.kernel]))
        if plan.tree:
            u = self._u(m_t.float(), v_t.float(), p_t, plan.wd_flat,
                        inv_bc1, inv_bc2)
            p2 = torch.where(ok, p_t - lr_ratio[nk:][plan.segment] * u, p_t)
            new = _unflatten_dense_tensors(p2, tp)
            torch._foreach_copy_(tp, new)
            if state.model is not None:
                torch._foreach_copy_([state.model[k] for k in plan.tree], new)
        return (state._replace(count=state.count + ok.to(torch.int32)),
                found_inf)
