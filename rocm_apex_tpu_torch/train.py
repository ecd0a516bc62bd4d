"""One mixed-precision training step, for GPT and for BERT.

`make_train_step` is the counterpart of ``make_one_step`` in the JAX package's bench.py
(bench.py:2533-2578): the model's fused-head mean loss, scaled by the
dynamic loss scale; backward; `MixedPrecisionAdam.step_and_probe` with
``grad_scale = 1 / loss_scale`` (the unscale and the overflow probe ride
the update); `LossScaler.update`. `make_bert_train_step` is the
counterpart of ``one_step`` in ``build_bert_train`` (bench.py:270-284):
the mean of `BertModel`'s per-token masked-LM losses; backward;
`MixedPrecisionLamb.step_and_probe` with no loss scaler (the global
gradient norm is the overflow probe). Each step returns the unscaled
loss as a device tensor and never reads a value back to the host.
"""

from typing import Callable, Optional

import torch

from rocm_apex_tpu_torch.amp import LossScaler, ScalerState
from rocm_apex_tpu_torch.optimizers import (
    MixedPrecisionAdam,
    MixedPrecisionLamb,
    MixedPrecisionState,
)

__all__ = ["make_bert_train_step", "make_train_step"]


def make_train_step(model, opt: MixedPrecisionAdam,
                    scaler: LossScaler) -> Callable:
    """``step(state, sstate, tokens, labels, loss_mask=None,
    dropout_generator=None) -> (state, sstate, loss)``.

    ``state`` is the optimizer's state over ``model`` (see
    `convert.train_state_from_jax_params`), ``sstate`` the scaler's.
    Inputs move to the model's device (the one `resolve_device` chose
    when the model was built). With ``dropout_generator`` (a CPU
    `torch.Generator`) dropout is on, seeded per site from it; without,
    the step is deterministic.
    """
    device = model.device
    params = [p for p in model.parameters()]

    def step(state: MixedPrecisionState, sstate: ScalerState,
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
        inv_scale = 1.0 / scaler.loss_scale(sstate)
        state, found_inf = opt.step_and_probe(state, grads,
                                              grad_scale=inv_scale)
        sstate2, _ = scaler.update(sstate, found_inf)
        return state, sstate2, scaled.detach() * inv_scale

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
