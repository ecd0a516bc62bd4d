"""Amp state and the loss-scaling training flow.

Port of ``rocm_apex_tpu/amp/handle.py``. The flow is dataflow, every
value a device tensor (no read to the host):

    scaled = amp.scale_loss(loss, amp_state)
    grads = torch.autograd.grad(scaled, params)
    grads, found_inf = amp.unscale_grads(grads, amp_state)
    amp_state, skip = amp.update_scale(amp_state, found_inf)
    new = amp.skip_step(skip, new_tree, old_tree)
"""

from typing import Any

import torch

from rocm_apex_tpu_torch.amp._tree import tree_leaves, tree_map

__all__ = [
    "AmpState",
    "master_params",
    "scale_loss",
    "skip_step",
    "unscale_grads",
    "update_scale",
]


class AmpState:
    """The policy, the scaler's config and the per-loss scaler states."""

    def __init__(self, policy, scaler, scaler_states):
        self.policy = policy
        self.scaler = scaler
        self.scaler_states = tuple(scaler_states)

    def replace(self, **kw):
        d = dict(policy=self.policy, scaler=self.scaler,
                 scaler_states=self.scaler_states)
        d.update(kw)
        return AmpState(**d)

    @property
    def loss_scale(self):
        return self.scaler_states[0].loss_scale

    def __repr__(self):
        return (f"AmpState(opt_level={self.policy.opt_level}, "
                f"num_losses={len(self.scaler_states)})")


def scale_loss(loss: torch.Tensor, amp_state: AmpState, loss_id: int = 0):
    """``loss.float() * loss_scale``; the loss itself when amp is off."""
    if not amp_state.policy.enabled:
        return loss
    return amp_state.scaler.scale(amp_state.scaler_states[loss_id], loss)


def unscale_grads(grads, amp_state: AmpState, loss_id: int = 0,
                  stashed=None):
    """``(fp32 grads / loss_scale, found_inf)``; with ``stashed`` (fp32
    grads of an earlier backward) their sum with the unscaled grads."""
    scaler, state = amp_state.scaler, amp_state.scaler_states[loss_id]
    if stashed is not None:
        return scaler.unscale_with_stashed(state, stashed, grads)
    return scaler.unscale(state, grads)


def update_scale(amp_state: AmpState, found_inf, loss_id: int = 0):
    """Advance the loss scale: ``(amp_state, should_skip)``."""
    states = list(amp_state.scaler_states)
    states[loss_id], should_skip = amp_state.scaler.update(states[loss_id],
                                                           found_inf)
    return amp_state.replace(scaler_states=tuple(states)), should_skip


def skip_step(should_skip, new_tree: Any, old_tree: Any) -> Any:
    """The old tree where the step must be skipped, leaf by leaf
    (``torch.where`` on the device bool)."""
    return tree_map(lambda n, o: torch.where(should_skip, o, n), new_tree,
                    old_tree)


def master_params(opt_state):
    """The fp32 master params held in a processed optimizer state."""
    from rocm_apex_tpu_torch.amp._process_optimizer import MasterWeightsState

    found = []

    def visit(s):
        if isinstance(s, MasterWeightsState):
            found.append(s)
        elif isinstance(s, dict):
            for v in s.values():
                visit(v)
        elif isinstance(s, (tuple, list)):
            for v in s:
                visit(v)

    visit(opt_state)
    for s in found:
        yield from tree_leaves(s.master)
