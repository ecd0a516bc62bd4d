"""One mixed-precision training step, for GPT, for BERT and for ResNet.

`make_train_step` is the counterpart of ``make_one_step(opt)`` in the
JAX package's bench.py (bench.py:2533-2578): the model's fused-head mean
loss, scaled by the dynamic loss scale; backward; ``opt.step_and_probe``
with ``grad_scale = 1 / loss_scale`` (the unscale and the overflow probe
ride the update), ``opt`` a `MixedPrecisionAdam` or a
`PackedOptimizerStep` (bench.py's ``--packed-update``);
`LossScaler.update`. `make_bert_train_step` is the counterpart of
``one_step`` in ``build_bert_train`` (bench.py:270-284): the mean of
`BertModel`'s per-token masked-LM losses; backward;
`MixedPrecisionLamb.step_and_probe` with no loss scaler (the global
gradient norm is the overflow probe). Each step returns the unscaled
loss as a device tensor and never reads a value back to the host.
`make_rn50_train_step` is the counterpart of ``one_step`` in bench.py's
`bench_rn50` (bench.py:160-184): the mean softmax cross-entropy of the
ResNet's fp32 logits, `amp.scale_loss`, backward, `amp.unscale_grads`,
`amp.update_scale`, the optimizer's update on the params dict (through
`amp.with_master_weights` under O5) and `amp.skip_step`; the batch
statistics move in the model's buffers.

Data parallelism: `make_train_step` and `make_rn50_train_step` take a
``grad_sync`` (e.g. `parallel.sync_gradients` or a
`parallel.DistributedDataParallel`) applied to the gradients by name
right after the backward, as ``__graft_entry__.py`` part A averages them
over the data axis before the unscale. `make_zero_train_step` is the
counterpart of bench.py's ``--dist-opt`` step (``local_runN_zero.one``,
bench.py:2395-2411): the mean loss, backward, the ZeRO optimizer's
update on this rank's UNREDUCED gradients (its reduce-scatter is the
averaging), and the params set to params + updates.
"""

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from rocm_apex_tpu_torch import amp
from rocm_apex_tpu_torch.amp import LossScaler, ScalerState
from rocm_apex_tpu_torch.optimizers import (
    MixedPrecisionAdam,
    MixedPrecisionLamb,
    MixedPrecisionState,
    PackedOptimizerStep,
)
from rocm_apex_tpu_torch.optimizers._common import apply_updates

__all__ = ["make_bert_train_step", "make_rn50_train_step", "make_train_step",
           "make_zero_train_step"]


def make_train_step(model, opt: Union[MixedPrecisionAdam, PackedOptimizerStep],
                    scaler: LossScaler,
                    grad_sync: Optional[Callable] = None) -> Callable:
    """``step(state, sstate, tokens, labels, loss_mask=None,
    dropout_generator=None) -> (state, sstate, loss)``.

    ``state`` is the optimizer's state over ``model`` (see
    `convert.train_state_from_jax_params`), ``sstate`` the scaler's; the
    state's ``model`` holds the module's own parameters, so the gradients
    are read by parameter name.
    Inputs move to the model's device (the one `resolve_device` chose
    when the model was built). With ``dropout_generator`` (a CPU
    `torch.Generator`) dropout is on, seeded per site from it; without,
    the step is deterministic. ``grad_sync`` maps the gradients by name
    to the ones the optimizer takes (the data-parallel sync).
    """
    device = model.device
    params = [p for p in model.parameters()]

    def step(state, sstate: ScalerState,
             tokens: torch.Tensor, labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             dropout_generator: Optional[torch.Generator] = None):
        for p in params:
            p.grad = None
        tokens = tokens.to(device)
        labels = labels.to(device)
        if loss_mask is not None:
            loss_mask = loss_mask.to(device)
        mean = model(
            tokens, labels=labels, loss_mask=loss_mask,
            loss_reduction="mean", deterministic=dropout_generator is None,
            dropout_generator=dropout_generator,
        )
        scaled = scaler.scale(sstate, mean)
        scaled.backward()
        grads = {k: p.grad for k, p in state.model.items()}
        if grad_sync is not None:
            grads = grad_sync(grads)
        inv_scale = 1.0 / scaler.loss_scale(sstate)
        state, found_inf = opt.step_and_probe(state, grads,
                                              grad_scale=inv_scale)
        sstate2, _ = scaler.update(sstate, found_inf)
        return state, sstate2, scaled.detach() * inv_scale

    return step


def make_zero_train_step(model, opt) -> Callable:
    """``step(state, tokens, labels, loss_mask=None, dropout_generator=None)
    -> (state, loss)``.

    ``opt`` is a ZeRO optimizer (`contrib.optimizers.
    DistributedFusedAdam` or `DistributedFusedLAMB`, or their transforms)
    and ``state`` its state over ``model``'s parameters (``opt.init(fp32
    params by name, model)``, e.g. `convert.train_state_from_jax_params`:
    the masters the tree's fp32 values, the module's parameters in their
    stored dtypes). Each rank feeds its own batch; the gradients go to
    ``opt.update`` unreduced, and every parameter becomes parameter +
    update, cast to its dtype (its wire-dtype master). Dropout as in
    `make_train_step`; the loss is this rank's mean loss, a device
    tensor."""
    device = model.device
    named = dict(model.named_parameters())

    def step(state, tokens: torch.Tensor, labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             dropout_generator: Optional[torch.Generator] = None):
        for p in named.values():
            p.grad = None
        loss = model(
            tokens.to(device), labels=labels.to(device),
            loss_mask=None if loss_mask is None else loss_mask.to(device),
            loss_reduction="mean", deterministic=dropout_generator is None,
            dropout_generator=dropout_generator,
        )
        loss.backward()
        params = {k: p.detach() for k, p in named.items()}
        updates, state = opt.update({k: p.grad for k, p in named.items()},
                                    state, params)
        new = apply_updates(params, updates)
        with torch.no_grad():
            torch._foreach_copy_(list(params.values()),
                                 [new[k] for k in params])
        return state, loss.detach()

    return step


def make_bert_train_step(model, opt: MixedPrecisionLamb) -> Callable:
    """``step(state, tokens, lm_labels, tokentype_ids=None,
    dropout_generator=None, attention_mask=None) -> (state, loss,
    found_inf)``.

    ``model`` is a `BertModel`, ``state`` the optimizer's state over it
    (see `convert.train_state_from_jax_params`). ``attention_mask`` is
    the (b, s) padding mask (1 = keep) the model turns into its attention
    bias; the loss stays the mean of all per-token losses, as bench.py's
    step writes it (bench.py:274-280). The compute copy comes
    from `opt.model_params` at the start of each step (a cast from the
    masters when the optimizer does not store it). ``found_inf`` is a
    device bool: the step was skipped and the state left as it was.
    """
    device = model.device
    named = dict(model.named_parameters())

    def step(state: MixedPrecisionState, tokens: torch.Tensor,
             lm_labels: torch.Tensor,
             tokentype_ids: Optional[torch.Tensor] = None,
             dropout_generator: Optional[torch.Generator] = None,
             attention_mask: Optional[torch.Tensor] = None):
        opt.model_params(state, model)
        for p in named.values():
            p.grad = None
        if tokentype_ids is not None:
            tokentype_ids = tokentype_ids.to(device)
        if attention_mask is not None:
            attention_mask = attention_mask.to(device)
        losses, _ = model(
            tokens.to(device), attention_mask=attention_mask,
            tokentype_ids=tokentype_ids,
            lm_labels=lm_labels.to(device),
            deterministic=dropout_generator is None,
            dropout_generator=dropout_generator,
        )
        loss = losses.mean()
        loss.backward()
        grads = {k: named[k].grad for k in state.master}
        state, found_inf = opt.step_and_probe(state, grads)
        return state, loss.detach(), found_inf

    return step


def make_rn50_train_step(model, optimizer, amp_state,
                         grad_sync: Optional[Callable] = None) -> Callable:
    """``step(params, opt_state, scaler_states, x, y) -> (params,
    opt_state, scaler_states, loss)``.

    ``model`` is a `ResNet`; ``params`` the dict `amp.initialize` returned
    for its parameters (names as ``model.named_parameters()``), run
    through the model with ``torch.func.functional_call``; ``optimizer``
    the processed optimizer and ``opt_state`` its state; ``amp_state``
    supplies the policy and the scaler, ``scaler_states`` its current
    states. ``x`` (NHWC images) is cast to the model's dtype on its
    device, ``y`` holds class ids. The running statistics are the model's
    buffers, moved in place by the training-mode forward (as bench.py
    keeps the batch statistics of every step, skipped or not). A static
    loss scale (O5's 1) never skips, so its `amp.skip_step` selects are
    left out: they would return the new tree leaf for leaf.
    ``grad_sync`` maps the (scaled) gradients by name before the
    unscale (the data-parallel sync)."""
    device = model.device
    dynamic = amp_state.scaler.dynamic

    def step(params, opt_state, scaler_states, x, y):
        st = amp_state.replace(scaler_states=scaler_states)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = torch.func.functional_call(
            model, p, (x.to(device=device, dtype=model.dtype),),
            strict=False)
        ce = F.cross_entropy(logits.float(), y.to(device))
        scaled = amp.scale_loss(ce, st)
        names = list(p)
        grads = dict(zip(names, torch.autograd.grad(
            scaled, [p[k] for k in names])))
        if grad_sync is not None:
            grads = grad_sync(grads)
        grads, found_inf = amp.unscale_grads(grads, st)
        st2, skip = amp.update_scale(st, found_inf)
        updates, opt2 = optimizer.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        if dynamic:
            new_params = amp.skip_step(skip, new_params, params)
            opt2 = amp.skip_step(skip, opt2, opt_state)
        return new_params, opt2, st2.scaler_states, ce.detach()

    return step
