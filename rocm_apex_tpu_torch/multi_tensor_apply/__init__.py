"""multi_tensor_applier: the reference's kernel-glue entry point.

Port of ``rocm_apex_tpu/multi_tensor_apply/__init__.py``:
``multi_tensor_applier(op, noop_flag_buffer, tensor_lists, *args)``
dispatches ``op``, one of the packed ops of ops/multi_tensor.py (one
kernel over each dtype group's whole buffer: no chunking), and the
overflow flag is returned by the op as a device bool instead of written
into the caller's buffer. A tensor list is a list of tensors or a dict of
name -> tensor. The ops return new tensors, as the JAX ones do.
"""

from typing import Any, Sequence

from rocm_apex_tpu_torch.ops import multi_tensor as _mt
from rocm_apex_tpu_torch.ops.packing import tree_flatten

__all__ = [
    "multi_tensor_applier",
    "MultiTensorApply",
    "multi_tensor_scale",
    "multi_tensor_axpby",
    "multi_tensor_l2norm",
    "available",
]

available = True  # the kernels are built from the package's sources


def multi_tensor_scale(tensor_lists: Sequence[Any], scale):
    """``[src_list, dst_list] -> (scaled src in dst's dtype, overflow)``."""
    src, dst = tensor_lists
    leaves, _ = tree_flatten(dst)
    out_dtype = leaves[0].dtype if leaves else None
    return _mt.scale(src, scale, out_dtype=out_dtype)


def multi_tensor_axpby(tensor_lists: Sequence[Any], a, b):
    """``[x_list, y_list, out_list] -> (a * x + b * y, overflow)``."""
    x, y, _ = tensor_lists
    return _mt.axpby(x, y, a, b)


def multi_tensor_l2norm(tensor_lists: Sequence[Any], per_tensor: bool = False):
    """``[list] -> (global norm, per-tensor norms or None)``."""
    (xs,) = tensor_lists
    return _mt.l2norm(xs, per_tensor=per_tensor)


def multi_tensor_applier(op, noop_flag_buffer, tensor_lists, *args):
    """Dispatch ``op`` over the tensor lists (the reference's signature;
    ``noop_flag_buffer`` is ignored: the op returns the overflow flag)."""
    del noop_flag_buffer
    return op(tensor_lists, *args)


class MultiTensorApply:
    """The class form; ``chunk_size`` is accepted and unused (one kernel
    takes a whole packed buffer)."""

    available = True

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag_buffer, tensor_lists, *args):
        return multi_tensor_applier(op, noop_flag_buffer, tensor_lists, *args)
