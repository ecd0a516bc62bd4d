"""Master-weight optimizer wrapping.

Port of ``rocm_apex_tpu/amp/_process_optimizer.py``. `with_master_weights`
wraps a gradient transformation (``init(params)``, ``update(grads, state,
params) -> (updates, state)``, updates fp32 deltas by name): its state
holds an fp32 master copy of the params, the incoming gradients are cast
to fp32, the inner transformation updates the masters, and the emitted
updates are ``cast(new_master, param dtype) - params`` in fp32, so that
`apply_updates` gives each param its rounded master.
"""

from typing import Any, NamedTuple

import torch

from rocm_apex_tpu_torch.optimizers._common import (GradientTransformation,
                                                    apply_updates)

__all__ = ["MasterWeightsState", "process_optimizer", "with_master_weights"]


class MasterWeightsState(NamedTuple):
    master: Any  # fp32 master params, by name
    inner: Any  # the inner transformation's state


def _to_f32(tree):
    return {k: v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


def with_master_weights(tx) -> GradientTransformation:
    """``tx`` over fp32 masters; the params receive the rounded masters."""

    def init_fn(params):
        master = {k: v.detach().to(torch.float32, copy=True)
                  for k, v in params.items()}
        return MasterWeightsState(master=master, inner=tx.init(master))

    def update_fn(updates, state, params=None):
        if params is None:
            raise ValueError("with_master_weights requires params in "
                             "update()")
        inner_updates, inner = tx.update(_to_f32(updates), state.inner,
                                         state.master)
        master = apply_updates(state.master, inner_updates)
        delta = {k: (master[k].to(p.dtype).float() - p.float()
                     if p.is_floating_point() else master[k] - p)
                 for k, p in params.items()}
        return delta, MasterWeightsState(master=master, inner=inner)

    return GradientTransformation(init_fn, update_fn)


def process_optimizer(tx, policy):
    """``tx`` wrapped with fp32 masters under ``policy.master_weights``."""
    if policy.master_weights:
        return with_master_weights(tx)
    return tx
