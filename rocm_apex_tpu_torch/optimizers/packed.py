"""The packed-buffer optimizer step: unscale, probe, clip and Adam or LAMB
as a few kernels a dtype group.

Port of ``rocm_apex_tpu/optimizers/packed.py``. A step over buffers packed
by ops/packing.py:

    pack the grads once -> one fused unscale + isfinite probe + row-sumsq
    pass (`scale_sumsq_packed`) -> global grad norm and clip factor ->
    one Adam kernel (`adam_update`), or LAMB stage 1, the trust ratios from
    segmented row sums and stage 2 ... per dtype group -> unpack once

The overflow skip is folded into the Adam kernel's writes (its skip
slot): a skipped step leaves masters, moments and count bit for bit as
they were. LAMB's stage 1 has no skip slot, so `lamb_phase` freezes with
a `torch.where` after it, as the JAX phase does. The step count, the bias
corrections, the clip factor and the skip are device values the kernels
read: nothing goes back to the host.

Entry points: `packed_adam` / `packed_lamb` (init/update transforms over
a tree of parameters), the buffer-level `adam_phase` / `lamb_phase`, and
`PackedOptimizerStep`, the mixed-precision train-step wrapper with the
surface of `MixedPrecisionAdam` (``init`` / ``model_params`` /
``step`` / ``step_and_probe``): its masters and moments stay packed, and
its ``model`` is the compute copy, rewritten in place after each step
(the module's own parameters when ``init`` is given the module).
"""

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rocm_apex_tpu_torch.ops.multi_tensor import scale_sumsq_packed
from rocm_apex_tpu_torch.ops.optim_kernels import (
    adam_update,
    lamb_stage1,
    lamb_stage2,
)
from rocm_apex_tpu_torch.ops.packing import (
    PackedTree,
    build_pack_spec,
    pack_tree,
    respec,
    tree_flatten,
    unpack_tree,
)
from rocm_apex_tpu_torch.optimizers import _common as c

__all__ = [
    "PackedAdamState",
    "PackedLAMBState",
    "PackedStepState",
    "PackedOptimizerStep",
    "packed_adam",
    "packed_lamb",
    "adam_phase",
    "lamb_phase",
]


class PackedAdamState(NamedTuple):
    count: torch.Tensor  # int32 step counter on the device
    m: Tuple[torch.Tensor, ...]  # packed fp32 exp_avg buffers, per group
    v: Tuple[torch.Tensor, ...]  # packed fp32 exp_avg_sq buffers


class PackedLAMBState(NamedTuple):
    count: torch.Tensor
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


def _bias_corrections(bias_correction, beta1, beta2, count):
    t = count.to(torch.float32)
    if bias_correction:
        return 1.0 - torch.pow(beta1, t), 1.0 - torch.pow(beta2, t)
    one = torch.ones((), dtype=torch.float32, device=count.device)
    return one, one


def _clip_factor(rsqs, max_grad_norm):
    """The global norm's clip factor from the per-group row sums of
    squares (reference lamb.cu:66 divides by max(||g|| / max, 1): this is
    its reciprocal); 1.0 with no clip, and then no norm is formed."""
    if not (max_grad_norm and max_grad_norm > 0):
        return 1.0
    gnorm = torch.sqrt(sum(rsq[:, 0].sum() for rsq in rsqs))
    return torch.where(gnorm > max_grad_norm, max_grad_norm / gnorm, 1.0)


def _skip_flag(found_inf, skip):
    if skip is None:
        return found_inf
    return found_inf | torch.as_tensor(skip, device=found_inf.device)


# ---------------------------------------------------------------------------
# the phases: buffers in, buffers out, no pack or unpack inside
# ---------------------------------------------------------------------------


def adam_phase(pp: PackedTree, pg: PackedTree, m, v, wd_cols, *, lr,
               beta1: float, beta2: float, eps: float, bc1, bc2, grad_scale,
               adam_w_mode: bool = True, max_grad_norm: float = 0.0,
               skip=None):
    """Unscale + probe (+ optional global-norm clip) + Adam: 2 kernels a
    dtype group, `scale_sumsq_packed` then `adam_update` with the skip
    slot. Returns ``(delta_bufs, new_m, new_v, found_inf)``; with
    found_inf (or ``skip``) every output is frozen and the deltas 0."""
    pgs, found_inf, rsqs = scale_sumsq_packed(pg, grad_scale, torch.float32)
    skip_flag = _skip_flag(found_inf, skip)
    clip = _clip_factor(rsqs, max_grad_norm)
    skip_f = skip_flag.to(torch.float32)
    deltas, new_m, new_v = [], [], []
    for pb, gb, mb, vb, wdc in zip(pp.buffers, pgs.buffers, m, v, wd_cols):
        # grad_scale is applied by the fused pass; the kernel's gs slot
        # carries the clip factor (x * 1.0 is exact when it is off)
        d, nm, nv = adam_update(
            pb, gb, mb, vb, wdc,
            [lr, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps, bc1, bc2, clip,
             skip_f],
            adam_w_mode,
        )
        deltas.append(d)
        new_m.append(nm)
        new_v.append(nv)
    return tuple(deltas), tuple(new_m), tuple(new_v), skip_flag


@functools.lru_cache(maxsize=64)
def _decayed(wd_bytes: bytes, device: torch.device) -> torch.Tensor:
    """Which tensors of a group are decayed, on the device (built once)."""
    return torch.from_numpy(np.frombuffer(wd_bytes, np.float32) != 0.0) \
        .to(device)


def lamb_phase(pp: PackedTree, pg: PackedTree, m, v, wd_cols, wd_vals, *,
               lr, beta1: float, beta2: float, beta3: float, eps: float, bc1,
               bc2, grad_scale, adam_w_mode: bool = True,
               max_grad_norm: float = 1.0, use_nvlamb: bool = False,
               skip=None):
    """Unscale + probe + global-norm clip + LAMB: stage 1 per group, the
    trust ratios ||p|| / ||u|| from segmented row sums (decayed tensors
    only unless ``use_nvlamb``, by the static ``wd_vals``), stage 2
    -lr * ratio * u. Returns ``(delta_bufs, new_m, new_v, found_inf)``."""
    pgs, found_inf, rsqs = scale_sumsq_packed(pg, grad_scale, torch.float32)
    skip_flag = _skip_flag(found_inf, skip)
    clip = _clip_factor(rsqs, max_grad_norm)
    ok = ~skip_flag
    deltas, new_m, new_v = [], [], []
    for group, pb, gb, mb, vb, wdc, wdv in zip(
            pp.spec.groups, pp.buffers, pgs.buffers, m, v, wd_cols, wd_vals):
        u, nm, nv = lamb_stage1(
            pb, gb, mb, vb, wdc,
            [beta1, beta2, 1.0 - beta2, beta3, eps, bc1, bc2, 1.0, clip],
            adam_w_mode,
        )
        p_norm = torch.sqrt(c.per_tensor_sumsq(group, pb))
        u_norm = torch.sqrt(c.per_tensor_sumsq(group, u))
        ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                            p_norm / u_norm, 1.0)
        if not use_nvlamb:
            wd_bytes = np.asarray(wdv, np.float32).tobytes()
            ratio = torch.where(_decayed(wd_bytes, ratio.device), ratio, 1.0)
        (d,) = lamb_stage2(u, c.per_tensor_to_columns(group, ratio), [lr])
        # stage 1 has no skip slot: freeze by a select (never a blend: an
        # overflowed step's values are inf/nan)
        deltas.append(torch.where(ok, d, 0.0))
        new_m.append(torch.where(ok, nm, mb))
        new_v.append(torch.where(ok, nv, vb))
    return tuple(deltas), tuple(new_m), tuple(new_v), skip_flag


# ---------------------------------------------------------------------------
# init/update transforms over a tree of parameters
# ---------------------------------------------------------------------------


def _device_of(tree) -> torch.device:
    leaves, _ = tree_flatten(tree)
    return leaves[0].device


def _transform(phase, learning_rate, bias_correction, beta1, beta2,
               grad_scale, weight_decay, weight_decay_mask, state_cls,
               **phase_kw):
    cols = {}  # (spec, device) -> the weight-decay columns, built once

    def init_fn(params):
        spec = build_pack_spec(params)
        dev = _device_of(params)
        return state_cls(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            m=c.zero_group_buffers(spec, device=dev),
            v=c.zero_group_buffers(spec, device=dev),
        )

    def update_fn(grads, state, params=None, *, skip=None):
        if params is None:
            raise ValueError("the packed transforms need params in update()")
        spec, pp, pg = c.pack_params_and_grads(params, grads)
        dev = state.count.device
        if (spec, dev) not in cols:
            cols[spec, dev] = c.wd_columns(spec, weight_decay,
                                           weight_decay_mask, dev)
        count_live = state.count + 1
        bc1, bc2 = _bias_corrections(bias_correction, beta1, beta2,
                                     count_live)
        extra = {}
        if phase is lamb_phase:
            extra["wd_vals"] = c.wd_per_tensor(spec, weight_decay,
                                               weight_decay_mask)
        deltas, m2, v2, skipped = phase(
            pp, pg, state.m, state.v, cols[spec, dev], **extra,
            lr=c.resolve_lr(learning_rate, count_live), beta1=beta1,
            beta2=beta2, bc1=bc1, bc2=bc2,
            grad_scale=1.0 if grad_scale is None else grad_scale,
            skip=skip, **phase_kw,
        )
        count = state.count + (~skipped).to(torch.int32)
        return (c.deltas_to_updates(spec, deltas),
                state_cls(count=count, m=m2, v=v2))

    update_fn.kernel_skip = True  # the skip rides the update's kernels
    return c.GradientTransformation(init_fn, update_fn)


def packed_adam(
    learning_rate: c.ScalarOrSchedule = 1e-3,
    *,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    adam_w_mode: bool = True,
    weight_decay: float = 0.0,
    weight_decay_mask: Optional[Any] = None,
    grad_scale: Optional[Any] = None,
    max_grad_norm: float = 0.0,
) -> c.GradientTransformation:
    """Fused Adam over packed buffers: ``update(grads, state, params,
    skip=None) -> (updates, state)``, the updates fp32 deltas by name;
    moments packed in `PackedAdamState`; an overflowed (or skipped) step
    freezes moments and count in the kernel and gives zero updates."""
    return _transform(adam_phase, learning_rate, bias_correction, *betas,
                      grad_scale, weight_decay, weight_decay_mask,
                      PackedAdamState, eps=eps, adam_w_mode=adam_w_mode,
                      max_grad_norm=max_grad_norm)


def packed_lamb(
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
) -> c.GradientTransformation:
    """Fused LAMB over packed buffers; the global grad norm comes from the
    unscale pass, the trust-ratio norms from segmented row sums."""
    return _transform(lamb_phase, learning_rate, bias_correction, *betas,
                      grad_scale, weight_decay, weight_decay_mask,
                      PackedLAMBState,
                      beta3=1.0 - betas[0] if grad_averaging else 1.0,
                      eps=eps, adam_w_mode=adam_w_mode,
                      max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)


# ---------------------------------------------------------------------------
# PackedOptimizerStep: the mixed-precision train-step wrapper
# ---------------------------------------------------------------------------


class PackedStepState(NamedTuple):
    count: torch.Tensor
    model: Dict[str, torch.Tensor]  # the compute copy, rewritten in place
    master: Tuple[torch.Tensor, ...]  # packed fp32 masters, per group
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


class _Plan(NamedTuple):
    spec: Any  # the model tree's PackSpec
    wd_cols: Tuple[torch.Tensor, ...]
    wd_vals: Tuple[np.ndarray, ...]


class PackedOptimizerStep:
    """Mixed-precision packed train step (Adam or LAMB math), with the
    JAX class's hyperparameters and defaults and `MixedPrecisionAdam`'s
    surface. Each step packs the grads once (in their own dtype), runs
    `adam_phase` / `lamb_phase` on the resident packed masters and
    moments, forms the new masters as master + delta, and writes the
    compute copy from them. ``weight_decay_mask`` maps each parameter
    name to True (decayed) or False."""

    def __init__(
        self,
        optimizer: str = "adam",
        learning_rate: c.ScalarOrSchedule = 1e-3,
        *,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: Optional[float] = None,
        adam_w_mode: bool = True,
        weight_decay: float = 0.0,
        weight_decay_mask: Optional[Any] = None,
        max_grad_norm: float = 0.0,
        grad_averaging: bool = True,
        use_nvlamb: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        if optimizer not in ("adam", "lamb"):
            raise ValueError(
                f"optimizer must be 'adam' or 'lamb', got {optimizer!r}")
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.beta3 = 1.0 - self.beta1 if grad_averaging else 1.0
        self.eps = eps if eps is not None else (
            1e-8 if optimizer == "adam" else 1e-6)
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.weight_decay_mask = weight_decay_mask
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.compute_dtype = compute_dtype
        self._plans: Dict[tuple, _Plan] = {}

    def _plan(self, model: Dict[str, torch.Tensor]) -> _Plan:
        dev = next(iter(model.values())).device
        key = (dev, tuple((k, t.shape, t.dtype) for k, t in model.items()))
        plan = self._plans.get(key)
        if plan is None:
            spec = build_pack_spec(model)
            plan = self._plans[key] = _Plan(
                spec=spec,
                wd_cols=tuple(c.wd_columns(spec, self.weight_decay,
                                           self.weight_decay_mask, dev)),
                wd_vals=tuple(c.wd_per_tensor(spec, self.weight_decay,
                                              self.weight_decay_mask)),
            )
        return plan

    def init(self, params: Dict[str, torch.Tensor],
             model: Optional[nn.Module] = None) -> PackedStepState:
        """Masters are fp32 copies of ``params`` (preferably fp32 values:
        they seed the masters exactly), packed. With ``model``, its
        parameters of the same names become the compute copy, each set to
        its master cast to the compute dtype; without, the copy is a dict
        of new tensors."""
        master, compute = c.masters_and_compute(params, model,
                                                self.compute_dtype)
        spec = self._plan(compute).spec
        dev = next(iter(compute.values())).device
        return PackedStepState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            model=compute,
            master=pack_tree(master, respec(spec, torch.float32)).buffers,
            m=c.zero_group_buffers(spec, device=dev),
            v=c.zero_group_buffers(spec, device=dev),
        )

    def model_params(self, state: PackedStepState) -> Dict[str, torch.Tensor]:
        """The compute-dtype parameters by name (``state.model``)."""
        return state.model

    def masters(self, state: PackedStepState) -> Dict[str, torch.Tensor]:
        """The fp32 masters by name (views of the packed buffers)."""
        spec = self._plan(state.model).spec
        return unpack_tree(PackedTree(state.master,
                                      respec(spec, torch.float32)))

    @torch.no_grad()
    def write_model(self, state: PackedStepState) -> None:
        """Set the compute copy to the masters cast to the compute dtype:
        one cast of each packed buffer, then one copy into the leaves."""
        spec = self._plan(state.model).spec
        cast = PackedTree(
            [b.to(self.compute_dtype) for b in state.master],
            respec(spec, self.compute_dtype))
        src = unpack_tree(cast)
        names = list(state.model)
        torch._foreach_copy_([state.model[k] for k in names],
                             [src[k] for k in names])

    @torch.no_grad()
    def _step(self, state, grads, *, grad_scale=None, skip=None):
        plan = self._plan(state.model)
        spec = plan.spec
        grads = {k: grads[k] if grads.get(k) is not None
                 else torch.zeros_like(t) for k, t in state.model.items()}
        pg = pack_tree(grads, spec)  # in the grads' dtype: the pass casts
        pm = PackedTree(state.master, respec(spec, torch.float32))
        gs = 1.0 if grad_scale is None else grad_scale
        count_live = state.count + 1
        lr = c.resolve_lr(self.learning_rate, count_live)
        bc1, bc2 = _bias_corrections(self.bias_correction, self.beta1,
                                     self.beta2, count_live)
        kw = dict(lr=lr, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                  bc1=bc1, bc2=bc2, grad_scale=gs,
                  adam_w_mode=self.adam_w_mode,
                  max_grad_norm=self.max_grad_norm, skip=skip)
        if self.optimizer == "adam":
            deltas, m2, v2, skipped = adam_phase(
                pm, pg, state.m, state.v, plan.wd_cols, **kw)
        else:
            deltas, m2, v2, skipped = lamb_phase(
                pm, pg, state.m, state.v, plan.wd_cols, plan.wd_vals,
                beta3=self.beta3, use_nvlamb=self.use_nvlamb, **kw)
        # the deltas are exactly 0 on a skipped step: master + 0 == master
        new_state = PackedStepState(
            count=state.count + (~skipped).to(torch.int32),
            model=state.model,
            master=tuple(mb + d for mb, d in zip(state.master, deltas)),
            m=m2,
            v=v2,
        )
        self.write_model(new_state)
        return new_state, skipped

    def step(self, state: PackedStepState, grads, *, grad_scale=None,
             skip=None) -> PackedStepState:
        """One update. ``grads`` are w.r.t. the compute-dtype params, by
        name (a missing or None entry is a zero gradient);
        ``grad_scale`` (1/loss_scale) fuses the unscale; ``skip`` (a
        device bool) ORs into the found_inf freeze."""
        new_state, _ = self._step(state, grads, grad_scale=grad_scale,
                                  skip=skip)
        return new_state

    def step_and_probe(self, state: PackedStepState, grads, *,
                       grad_scale=None):
        """`step` with the overflow probe of the unscale pass; returns
        ``(state, found_inf)`` — `MixedPrecisionAdam`'s contract."""
        return self._step(state, grads, grad_scale=grad_scale)
