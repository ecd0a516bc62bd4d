"""Shared plumbing of the optimizers: the port of
``rocm_apex_tpu/optimizers/_common.py`` (its packed-layout helpers, the
per-tensor weight decay, the learning-rate schedule hook), the masters
and compute copy of the mixed-precision states, and the gradient-norm
pass of `MixedPrecisionLamb`.

A tree is a dict of name -> tensor (ops/packing.py); a ``weight_decay_mask``
maps each name to True (decayed) or False.
"""

import functools
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Union)

import numpy as np
import torch

from rocm_apex_tpu_torch.ops.multi_tensor import row_sumsq, segment_sums
from rocm_apex_tpu_torch.ops.packing import (
    WIDTH,
    GroupSpec,
    PackSpec,
    PackedTree,
    build_pack_spec,
    group_segment_ids,
    pack_like,
    pack_tree,
    respec,
    tree_flatten,
    unpack_tree,
)

__all__ = [
    "FusedOptimizer",
    "GradientTransformation",
    "apply_updates",
    "ScalarOrSchedule",
    "deltas_to_updates",
    "foreach_norm_f32",
    "masters_and_compute",
    "pack_params_and_grads",
    "per_tensor_sumsq",
    "per_tensor_to_columns",
    "resolve_lr",
    "scaled_grads_f32",
    "tree_where",
    "wd_columns",
    "wd_per_tensor",
    "wd_tree",
    "zero_group_buffers",
    "zeros_like_f32",
]

ScalarOrSchedule = Union[float, torch.Tensor, Callable]


class GradientTransformation(NamedTuple):
    """``init(params) -> state``, ``update(grads, state, params) ->
    (updates, state)``: the shape of optax's, which the JAX packed
    transforms return."""

    init: Callable
    update: Callable


def apply_updates(params: Mapping[str, torch.Tensor],
                  updates: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``params + updates`` leaf by leaf, added in the promoted dtype (fp32
    for a bf16 param and an fp32 delta) and cast back to each param's
    dtype (optax's ``apply_updates``)."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def zeros_like_f32(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An fp32 zero tensor shaped like each param (moment state)."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def resolve_lr(lr: ScalarOrSchedule, count):
    """A constant, or a schedule called with the step count."""
    return lr(count) if callable(lr) else lr


def scaled_grads_f32(grads: Mapping[str, torch.Tensor], names, grad_scale,
                     device) -> List[torch.Tensor]:
    """The gradients of ``names`` in fp32, times ``grad_scale`` (a float
    or a device scalar) unless it is None."""
    gf = [grads[k].float() for k in names]
    if grad_scale is None:
        return gf
    return torch._foreach_mul(gf, torch.as_tensor(
        grad_scale, dtype=torch.float32, device=device))


def wd_tree(params: Mapping[str, torch.Tensor], weight_decay: float,
            mask: Optional[Mapping[str, bool]] = None) -> Dict[str, float]:
    """Per-parameter weight decay (True in ``mask`` = decayed): the
    stand-in for torch param groups. ``mask`` names every parameter."""
    if mask is None:
        return {k: weight_decay for k in params}
    if set(mask) != set(params):
        raise ValueError(
            f"weight_decay mask names {sorted(set(mask) ^ set(params))} "
            f"differently from the params"
        )
    return {k: weight_decay if mask[k] else 0.0 for k in params}


def foreach_norm_f32(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's L2 norm as an fp32 scalar, accumulated in fp32
    whatever the storage dtype (a bf16 gradient's norm must not round to
    bf16: it scales the clip of every leaf). On the CPU it is the square
    root of the sum of squares, the JAX package's formula: torch's CPU
    norm kernel is 2e-3 off over the 3.1e7 values of BERT's embedding,
    its cascaded sum within 1e-7."""
    tensors = list(tensors)
    if tensors and tensors[0].device.type == "cpu":
        return [torch.sqrt(torch.sum(torch.square(t.float())))
                for t in tensors]
    if all(t.dtype == torch.float32 for t in tensors):
        return list(torch._foreach_norm(tensors))
    return list(torch._foreach_norm(tensors, 2, dtype=torch.float32))


def masters_and_compute(params, model, compute_dtype):
    """``(master, compute)``: fp32 copies of ``params`` and their compute
    copy. With ``model`` (an `nn.Module`), its parameters of the same
    names are the compute copy, each set to its master cast to the
    compute dtype; without, the copy is a dict of new tensors."""
    master = {k: torch.as_tensor(p).detach().to(torch.float32).clone()
              for k, p in params.items()}
    if model is None:
        return master, {k: p.to(compute_dtype) for k, p in master.items()}
    named = dict(model.named_parameters())
    missing = sorted(set(master) - set(named))
    if missing:
        raise KeyError(f"the model has no parameters {missing}")
    for k, p in master.items():
        named[k].data = p.to(device=named[k].device, dtype=compute_dtype)
        master[k] = p.to(named[k].device)
    return master, {k: named[k] for k in master}


# ---------------------------------------------------------------------------
# the packed layout's helpers
# ---------------------------------------------------------------------------


def pack_params_and_grads(params: Any, grads: Any):
    """``(spec, packed params in their dtypes, packed fp32 grads)``."""
    spec = build_pack_spec(params)
    pp = pack_tree(params, spec)
    pg = pack_like(respec(spec, torch.float32), grads)
    return spec, pp, pg


def _mask_leaves(spec: PackSpec, mask):
    """The mask's values in the spec's leaf order (None: all decayed)."""
    if mask is None:
        return [True] * spec.n_leaves
    leaves, treedef = tree_flatten(mask)
    if len(leaves) != spec.n_leaves or (
            isinstance(treedef, tuple) and isinstance(spec.treedef, tuple)
            and treedef != spec.treedef):
        raise ValueError(
            f"weight_decay mask has {len(leaves)} leaves "
            f"{'' if not isinstance(treedef, tuple) else 'named otherwise '}"
            f"than the {spec.n_leaves} params"
        )
    return [bool(x) for x in leaves]


def wd_columns(spec: PackSpec, weight_decay, mask=None,
               device=None) -> List[torch.Tensor]:
    """Per-group (rows, 1) fp32 weight-decay columns on ``device``: the
    decay on a decayed tensor's rows, 0 on the others' and the padding's."""
    on = _mask_leaves(spec, mask)
    cols = []
    for g in spec.groups:
        col = np.zeros((g.rows, 1), np.float32)
        for i, ls in zip(g.leaf_indices, g.leaf_specs):
            if on[i]:
                col[ls.row_start:ls.row_start + ls.nrows] = 1.0
        cols.append(torch.from_numpy(col).to(device) * weight_decay)
    return cols


def wd_per_tensor(spec: PackSpec, weight_decay: float,
                  mask=None) -> List[np.ndarray]:
    """Per group, each tensor's decay (numpy, static): the trust-ratio
    rule reads whether a tensor is decayed."""
    on = _mask_leaves(spec, mask)
    return [np.array([weight_decay if on[i] else 0.0 for i in g.leaf_indices],
                     np.float32) for g in spec.groups]


@functools.lru_cache(maxsize=64)
def _segment_ids(group: GroupSpec, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(group_segment_ids(group).astype(np.int64)) \
        .to(device)


def per_tensor_to_columns(group: GroupSpec,
                          values: torch.Tensor) -> torch.Tensor:
    """Spread per-tensor values (n_tensors,) to a (rows, 1) column (0 on
    the padding rows)."""
    padded = torch.cat([values, values.new_zeros((1,))])
    return padded[_segment_ids(group, values.device)][:, None].contiguous()


def per_tensor_sumsq(group: GroupSpec, buf: torch.Tensor) -> torch.Tensor:
    """Per-tensor sums of squares of a group buffer: segmented row sums."""
    return segment_sums(group, row_sumsq(buf)[:, 0])


def deltas_to_updates(spec: PackSpec, deltas) -> Any:
    """fp32 delta buffers -> an updates tree (fp32 views of the buffers)."""
    return unpack_tree(PackedTree(deltas, respec(spec, torch.float32)))


def zero_group_buffers(spec: PackSpec, dtype=torch.float32, device=None):
    return tuple(torch.zeros((g.rows, WIDTH), dtype=dtype, device=device)
                 for g in spec.groups)


def tree_where(pred, new, old):
    """``torch.where(pred, new, old)`` leaf by leaf."""
    if isinstance(new, Mapping):
        return {k: torch.where(pred, new[k], old[k]) for k in new}
    return type(new)(torch.where(pred, n, o) for n, o in zip(new, old))



class FusedOptimizer:
    """Class facade over a gradient transformation: ``state =
    opt.init(params)``, ``params, state = opt.step(params, grads, state,
    skip=)``; ``update`` is the transformation's. With ``skip`` (a device
    bool) the params and the state stay as they were: a transformation
    that takes ``skip`` itself (`packed_adam`, `packed_lamb`) folds it
    into its update kernels, any other is selected leaf by leaf."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, params, *args):
        """``tx.init(params, *args)`` (the ZeRO transforms take the module
        whose parameters the updates apply to)."""
        return self.tx.init(params, *args)

    def step(self, params, grads, state, *, skip=None):
        if skip is not None and getattr(self.tx.update, "kernel_skip",
                                        False):
            updates, new_state = self.tx.update(grads, state, params,
                                                skip=skip)
            return apply_updates(params, updates), new_state
        updates, new_state = self.tx.update(grads, state, params)
        new_params = apply_updates(params, updates)
        if skip is None:
            return new_params, new_state
        from rocm_apex_tpu_torch.amp.handle import skip_step

        return (skip_step(skip, new_params, params),
                skip_step(skip, new_state, state))

    @property
    def update(self):
        return self.tx.update
