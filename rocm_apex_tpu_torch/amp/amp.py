"""Function-level precision casting: the decorators and their registry.

Port of ``rocm_apex_tpu/amp/amp.py``. The reference patches ``torch``,
``torch.Tensor`` and ``torch.nn.functional`` in place to insert casts
(apex/amp/amp.py:75-198) and offers decorators for user functions
(amp.py:29-44). The port keeps the decorator half, driven by the active
policy, as the JAX package does:

* `half_function(fn)`     fn's floating tensor arguments cast to fp16;
* `bfloat16_function(fn)` ... to bf16;
* `float_function(fn)`    ... to fp32;
* `policy_function(fn)`   ... to the active policy's
  ``cast_functions_dtype`` (fp16 under O1, bf16 under O4);
* `promote_function(fn)`  ... to the widest floating dtype among them.

A decorated function runs uncast until a policy with ``cast_functions``
(O1, O4) is activated by `init` or `amp.initialize`, and inside a
`disable_casts()` scope. The casts reach tensors at any depth of the
arguments (lists, tuples, dicts: `torch.utils._pytree`). A cast is an
autograd op, so the gradient of an fp32 leaf cast to bf16 reaches the
leaf in fp32: bf16 compute over fp32 weights (O4).
"""

import contextlib
import functools
from typing import Optional

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "init",
    "current_policy",
    "disable_casts",
    "half_function",
    "bfloat16_function",
    "float_function",
    "policy_function",
    "promote_function",
    "register_half_function",
    "register_bfloat16_function",
    "register_float_function",
    "register_promote_function",
]

# the active policy (the reference's `_amp_state` singleton): static
# configuration, read when a decorated function is called
_active_policy = None
_casts_disabled = False


def init(policy=None, enabled: bool = True):
    """Activate ``policy`` for the decorators (None clears it); called by
    `amp.initialize` with the O1/O4 policy, and with None otherwise."""
    global _active_policy
    _active_policy = policy if enabled else None
    return policy


def current_policy():
    return _active_policy


@contextlib.contextmanager
def disable_casts():
    """A scope in which decorated functions run uncast
    (apex/amp/handle.py:163-167)."""
    global _casts_disabled
    prev = _casts_disabled
    _casts_disabled = True
    try:
        yield
    finally:
        _casts_disabled = prev


def _casting_active():
    p = _active_policy
    return (p is not None and p.enabled and p.cast_functions
            and not _casts_disabled)


def _is_float(x):
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast_args(dtype, args, kwargs):
    return pytree.tree_map(lambda x: x.to(dtype) if _is_float(x) else x,
                           (args, kwargs))


def _make_cast_decorator(target_dtype: Optional[torch.dtype]):
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _casting_active():
                return fn(*args, **kwargs)
            dtype = (_active_policy.cast_functions_dtype
                     if target_dtype is None else target_dtype)
            cargs, ckwargs = _cast_args(dtype, args, kwargs)
            return fn(*cargs, **ckwargs)

        return wrapper

    return decorator


# `half_function` casts to fp16 under every casting level, as the
# reference's hard-coded `utils.maybe_half` (apex/amp/amp.py:29-31); only
# `policy_function` follows the level's dtype
half_function = _make_cast_decorator(torch.float16)
bfloat16_function = _make_cast_decorator(torch.bfloat16)
float_function = _make_cast_decorator(torch.float32)
policy_function = _make_cast_decorator(None)


def promote_function(fn):
    """Every floating argument promoted to the widest floating dtype among
    them (`torch.promote_types`: bf16 with fp16 gives fp32, as in jnp)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _casting_active():
            return fn(*args, **kwargs)
        dtypes = [x.dtype for x in pytree.tree_leaves((args, kwargs))
                  if _is_float(x)]
        if not dtypes:
            return fn(*args, **kwargs)
        widest = functools.reduce(torch.promote_types, dtypes)
        cargs, ckwargs = _cast_args(widest, args, kwargs)
        return fn(*cargs, **ckwargs)

    return wrapper


# the reference's module-function registry (apex/amp/amp.py:48-71):
# ``module.name`` replaced by its decorated form
def register_half_function(module, name):
    setattr(module, name, half_function(getattr(module, name)))


def register_bfloat16_function(module, name):
    setattr(module, name, bfloat16_function(getattr(module, name)))


def register_float_function(module, name):
    setattr(module, name, float_function(getattr(module, name)))


def register_promote_function(module, name):
    setattr(module, name, promote_function(getattr(module, name)))
