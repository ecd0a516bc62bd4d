"""Precision-policy frontend: opt-levels O0-O5.

Port of ``rocm_apex_tpu/amp/frontend.py``. A `Properties` policy is data
that threads through functions (the dtypes are torch's):

* ``cast_model_dtype``     the dtype model params are stored in (O2/O3
  fp16, O5 bf16);
* ``cast_functions``       compute-level casting around functions (O1,
  O4), with ``cast_functions_dtype`` its dtype;
* ``keep_batchnorm_fp32``  exempt batch-norm leaves from the model cast;
* ``master_weights``       keep fp32 master params in the optimizer state;
* ``loss_scale``           a float or "dynamic" (bf16 levels: 1).

`initialize` casts a params dict, wraps an optimizer and activates the
policy for the function decorators of ``amp/amp.py`` (O1, O4), or clears
them at a level that does not cast around functions.
"""

import logging
import warnings
from typing import Any, Callable, Mapping, Optional

import torch

from rocm_apex_tpu_torch.amp._tree import is_batchnorm_path, tree_cast

__all__ = [
    "AmpError",
    "Properties",
    "build_policy",
    "initialize",
    "load_state_dict",
    "opt_levels",
    "state_dict",
]

_log = logging.getLogger(__name__)


class AmpError(ValueError):
    pass


def warn_or_err(msg, strict=True):
    if strict:
        raise AmpError(msg)
    warnings.warn(msg)


class Properties:
    """Policy options with per-option consistency checks: inconsistent
    combinations (master_weights with O1/O4, ...) raise."""

    def __init__(self):
        self.__dict__["options"] = {
            "enabled": False,
            "opt_level": None,
            "cast_model_dtype": None,
            "cast_functions": False,
            "cast_functions_dtype": None,
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
        }

    def __getattr__(self, name):
        options = self.__dict__.get("options")
        if options is not None and name in options:
            return options[name]
        raise AttributeError(f"'Properties' object has no attribute '{name}'")

    def __setattr__(self, name, value):
        if name not in self.options:
            super().__setattr__(name, value)
            return
        casting = self.opt_level in ("O1", "O4")
        if name == "cast_model_dtype":
            if casting and value not in (None, False) \
                    and value != torch.float32:
                warn_or_err(
                    "O1/O4 insert casts around functions rather than model "
                    "weights; with O1/O4 the model weights should remain "
                    "FP32. Use opt_level='O2'/'O3' (fp16) or 'O5' (bf16) "
                    f"to cast the model. cast_model_dtype was {value}")
            self.options[name] = value
        elif name == "cast_functions":
            if not casting and value:
                warn_or_err("cast_functions=True should only be set by "
                            "selecting opt_level='O1' or 'O4'.")
            self.options[name] = value
        elif name == "cast_functions_dtype":
            if not casting and value is not None:
                warn_or_err("cast_functions_dtype should only be set by "
                            "selecting opt_level='O1' or 'O4'.")
            elif self.opt_level == "O1" and value != torch.float16:
                warn_or_err("cast_functions_dtype must be float16 for "
                            "opt_level='O1'.")
            elif self.opt_level == "O4" and value != torch.bfloat16:
                warn_or_err("cast_functions_dtype must be bfloat16 for "
                            "opt_level='O4'.")
            else:
                self.options[name] = value
        elif name == "keep_batchnorm_fp32":
            if casting and value is not None:
                warn_or_err(
                    "With opt_level O1/O4 batch-norm runs in FP32 via the "
                    "policy cast lists, so keep_batchnorm_fp32 should be "
                    f"None. keep_batchnorm_fp32 was {value}")
            value = {"False": False, "True": True}.get(value, value)
            if value not in (True, False, None):
                raise AmpError(
                    "keep_batchnorm_fp32 must be a bool, the string 'True' "
                    f"or 'False', or None; found {value}")
            self.options[name] = value
        elif name == "master_weights":
            if casting and value is not None:
                warn_or_err("master_weights does not make sense with O1/O4 "
                            "— model weights are already FP32.")
            self.options[name] = value
        elif name == "loss_scale":
            self.options[name] = value if value == "dynamic" else float(value)
        else:
            self.options[name] = value

    @property
    def compute_dtype(self):
        """The dtype matmul-heavy compute runs in under this policy."""
        if self.cast_functions and self.cast_functions_dtype is not None:
            return self.cast_functions_dtype
        if self.cast_model_dtype not in (None, False):
            return self.cast_model_dtype
        return torch.float32

    @property
    def param_dtype(self):
        """The dtype model params are stored in under this policy."""
        if self.cast_model_dtype not in (None, False):
            return self.cast_model_dtype
        return torch.float32

    def __repr__(self):
        opts = ", ".join(f"{k}={v!r}" for k, v in self.options.items())
        return f"Properties({opts})"


def _level(name, model_dtype, functions_dtype, keep_bn, master, scale):
    def apply(p: Properties) -> Properties:
        p.enabled = True
        p.opt_level = name
        p.cast_model_dtype = model_dtype
        p.cast_functions = functions_dtype is not None
        p.cast_functions_dtype = functions_dtype
        p.keep_batchnorm_fp32 = keep_bn
        p.master_weights = master
        p.loss_scale = scale
        return p

    return apply


opt_levels = {
    # name: (cast_model_dtype, cast_functions_dtype, keep_batchnorm_fp32,
    #        master_weights, loss_scale)
    "O0": _level("O0", torch.float32, None, None, False, 1.0),
    "O1": _level("O1", None, torch.float16, None, None, "dynamic"),
    "O2": _level("O2", torch.float16, None, True, True, "dynamic"),
    "O3": _level("O3", torch.float16, None, False, False, 1.0),
    "O4": _level("O4", None, torch.bfloat16, None, None, 1),
    "O5": _level("O5", torch.bfloat16, None, True, True, 1),
}


def build_policy(opt_level: str = "O1", cast_model_dtype=None,
                 cast_functions=None, cast_functions_dtype=None,
                 keep_batchnorm_fp32=None, master_weights=None,
                 loss_scale=None) -> Properties:
    """An opt-level's defaults, then each explicit override through the
    consistency checks."""
    if opt_level not in opt_levels:
        raise AmpError(
            f"Unexpected optimization level {opt_level}. Options are 'O0', "
            "'O1', 'O2', 'O3', 'O4', 'O5'. Note the use of the letter O, "
            "not the number zero.")
    p = opt_levels[opt_level](Properties())
    overrides = {
        "cast_model_dtype": cast_model_dtype,
        "cast_functions": cast_functions,
        "cast_functions_dtype": cast_functions_dtype,
        "keep_batchnorm_fp32": keep_batchnorm_fp32,
        "master_weights": master_weights,
        "loss_scale": loss_scale,
    }
    for k, v in overrides.items():
        if v is not None:
            setattr(p, k, v)
    return p


def initialize(params: Mapping[str, torch.Tensor], optimizer=None,
               opt_level: str = "O1", num_losses: int = 1,
               is_batchnorm: Optional[Callable[[str], bool]] = None,
               verbosity: int = 1, **overrides):
    """Apply an amp policy to a params dict (name -> tensor) and an
    optimizer: ``(params, optimizer, amp_state)``.

    The params are cast to ``cast_model_dtype``, batch-norm leaves (by
    name, `is_batchnorm_path` unless ``is_batchnorm`` is given) kept fp32
    under ``keep_batchnorm_fp32``; the optimizer (a gradient
    transformation) is wrapped with fp32 masters under
    ``master_weights``; the decorators of ``amp/amp.py`` cast under the
    policy when it casts around functions (O1, O4); ``amp_state`` holds
    the policy and ``num_losses`` loss-scaler states on the params'
    device."""
    from rocm_apex_tpu_torch.amp._process_optimizer import process_optimizer
    from rocm_apex_tpu_torch.amp.handle import AmpState
    from rocm_apex_tpu_torch.amp.scaler import LossScaler

    from rocm_apex_tpu_torch.amp import amp as _amp

    policy = build_policy(opt_level, **overrides)
    if verbosity:
        _log.info("amp.initialize: opt_level=%s -> %r", opt_level, policy)
    if policy.cast_model_dtype not in (None, False):
        keep = None
        if policy.keep_batchnorm_fp32:
            keep = is_batchnorm or is_batchnorm_path
        params = tree_cast(params, policy.cast_model_dtype,
                           keep_fp32_predicate=keep)
    # unconditional: initializing again at a level that does not cast
    # around functions clears an earlier O1/O4 policy
    _amp.init(policy if policy.cast_functions else None)
    device = next((t.device for t in params.values()
                   if isinstance(t, torch.Tensor)), None)
    scaler = LossScaler(policy.loss_scale)
    amp_state = AmpState(policy, scaler,
                         tuple(scaler.init(device) for _ in range(num_losses)))
    if optimizer is not None:
        optimizer = process_optimizer(optimizer, policy)
    return dict(params), optimizer, amp_state


def state_dict(amp_state) -> dict:
    """``{loss_scaler<i>: {loss_scale, unskipped}}`` (reads the device)."""
    return {
        f"loss_scaler{i}": {"loss_scale": float(s.loss_scale),
                            "unskipped": int(s.unskipped)}
        for i, s in enumerate(amp_state.scaler_states)
    }


def load_state_dict(amp_state, state: dict):
    """The scaler states of a `state_dict` put back into ``amp_state``."""
    if len(state) != len(amp_state.scaler_states):
        warnings.warn(
            f"Loading state_dict containing {len(state)} entries, but "
            f"AmpState has {len(amp_state.scaler_states)} scalers")
    new_states = list(amp_state.scaler_states)
    for key, value in state.items():
        i = int(key.replace("loss_scaler", ""))
        if i < len(new_states):
            s = new_states[i]
            new_states[i] = s._replace(
                loss_scale=torch.full_like(s.loss_scale,
                                           float(value["loss_scale"])),
                unskipped=torch.full_like(s.unskipped,
                                          int(value["unskipped"])))
    return amp_state.replace(scaler_states=tuple(new_states))
