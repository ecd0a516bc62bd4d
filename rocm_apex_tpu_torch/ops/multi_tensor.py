"""The multi-tensor ops over packed buffers (scale, axpby, L2 norm): the
hand-written CUDA kernels and their plain PyTorch versions.

Port of ``rocm_apex_tpu/ops/multi_tensor.py``, with its signatures and
return tuples. The kernels (``csrc/multi_tensor.cu``) replace the TPU
kernels ``_scale_kernel`` (:78), ``_scale_sumsq_kernel`` (:144),
``_axpby_kernel`` (:215) and ``_rowsum_sq_kernel`` (:290): one pass over
each dtype group's buffer, one warp a row. The values are formed in fp32
and probed for inf/nan before they are rounded to the output dtype; the
probe of all groups lands in one device int32, and ``found_inf`` is a
device bool made from it: nothing is read back to the host. Per-tensor
sums are segmented sums of the row sums (a row never straddles two
tensors, ops/packing.py).

For CUDA tensors the wrappers launch the kernels (or raise); for CPU
tensors they run the plain versions.
"""

import ctypes
import functools
from typing import Any, Optional, Tuple

import torch

from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr
from rocm_apex_tpu_torch.ops.packing import (
    ALIGN_ROWS,
    GroupSpec,
    PackedTree,
    check_packed_buffer,
    pack_tree,
    respec,
    tree_unflatten,
    unpack_tree,
)

__all__ = [
    "BLOCK_ROWS",
    "SCALE",
    "SCALE_SUMSQ",
    "AXPBY",
    "ROW_SUMSQ",
    "scale_plain",
    "axpby_plain",
    "row_sumsq_plain",
    "scale_packed",
    "scale",
    "scale_sumsq_packed",
    "axpby_packed",
    "axpby",
    "l2norm_packed",
    "l2norm",
    "row_sumsq",
    "segment_sums",
]

BLOCK_ROWS = ALIGN_ROWS  # a packed buffer's rows are a multiple of this

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
SCALE = Kernel(
    name="scale", source="multi_tensor.cu", symbol="mt_scale",
    argtypes=[_L, _P, _I, _P, _P, _I, _P, _P],
    replaces="rocm_apex_tpu/ops/multi_tensor.py:78 _scale_kernel",
)
SCALE_SUMSQ = Kernel(
    name="scale_sumsq", source="multi_tensor.cu", symbol="mt_scale_sumsq",
    argtypes=[_L, _P, _I, _P, _P, _I, _P, _P, _P],
    replaces="rocm_apex_tpu/ops/multi_tensor.py:144 _scale_sumsq_kernel",
)
AXPBY = Kernel(
    name="axpby", source="multi_tensor.cu", symbol="mt_axpby",
    argtypes=[_L, _P, _I, _P, _I, _P, _P, _P, _I, _P, _P],
    replaces="rocm_apex_tpu/ops/multi_tensor.py:215 _axpby_kernel",
)
ROW_SUMSQ = Kernel(
    name="row_sumsq", source="multi_tensor.cu", symbol="mt_row_sumsq",
    argtypes=[_L, _P, _I, _P, _P],
    replaces="rocm_apex_tpu/ops/multi_tensor.py:290 _rowsum_sq_kernel",
)


# ---------------------------------------------------------------------------
# the plain versions: one buffer, the JAX kernel bodies
# ---------------------------------------------------------------------------


def scale_plain(x, s, out_dtype, sumsq=False):
    """``(x * s in out_dtype, nonfinite as a 0-d bool[, (rows, 1) fp32 row
    sums of (x * s)^2])``; ``s`` an fp32 scalar tensor."""
    y = x.float() * s
    bad = ~torch.isfinite(y).all()
    if sumsq:
        return y.to(out_dtype), bad, (y * y).sum(1, keepdim=True)
    return y.to(out_dtype), bad


def axpby_plain(x, y, a, b, out_dtype):
    """``(a * x + b * y in out_dtype, nonfinite as a 0-d bool)``."""
    out = x.float() * a + y.float() * b
    return out.to(out_dtype), ~torch.isfinite(out).all()


def row_sumsq_plain(x):
    xf = x.float()
    return (xf * xf).sum(1, keepdim=True)


# ---------------------------------------------------------------------------
# one buffer: the kernel for a CUDA tensor, the plain version for a CPU one
# ---------------------------------------------------------------------------


def _device(buf: torch.Tensor) -> str:
    if buf.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {buf.device}")
    return buf.device.type


def _scalar(val, device) -> torch.Tensor:
    """``val`` (a number or a tensor) as one fp32 value on ``device``; a
    number is filled there, so no host copy waits for the stream."""
    if torch.is_tensor(val):
        return val.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(val), dtype=torch.float32, device=device)


def _new_flag(device) -> torch.Tensor:
    return torch.zeros((1,), dtype=torch.int32, device=device)


def _raise_flag(flag: torch.Tensor, bad: torch.Tensor) -> None:
    flag.bitwise_or_(bad.to(torch.int32).reshape(1))


def _scale_buffer(buf, s, out_dtype, flag, sumsq):
    """``out`` (and the row sums with ``sumsq``); nonfinite values raise
    ``flag``."""
    check_packed_buffer(buf)
    if _device(buf) == "cpu":
        res = scale_plain(buf, s, out_dtype, sumsq)
        _raise_flag(flag, res[1])
        return (res[0], res[2]) if sumsq else (res[0], None)
    out = torch.empty(buf.shape, dtype=out_dtype, device=buf.device)
    rsq = (torch.empty((buf.shape[0], 1), dtype=torch.float32,
                       device=buf.device) if sumsq else None)
    args = [buf.shape[0], ptr(buf), dtype_code(buf.dtype), ptr(s), ptr(out),
            dtype_code(out_dtype), ptr(flag)]
    if sumsq:
        SCALE_SUMSQ(*args, ptr(rsq), stream_ptr(buf.device))
    else:
        SCALE(*args, stream_ptr(buf.device))
    return out, rsq


def row_sumsq(buf: torch.Tensor) -> torch.Tensor:
    """(rows, 1) fp32 sums of each row's squares."""
    check_packed_buffer(buf)
    if _device(buf) == "cpu":
        return row_sumsq_plain(buf)
    out = torch.empty((buf.shape[0], 1), dtype=torch.float32,
                      device=buf.device)
    ROW_SUMSQ(buf.shape[0], ptr(buf), dtype_code(buf.dtype), ptr(out),
              stream_ptr(buf.device))
    return out


# ---------------------------------------------------------------------------
# the packed ops
# ---------------------------------------------------------------------------


def _out_dtype(out_dtype, group: GroupSpec) -> torch.dtype:
    return out_dtype if out_dtype is not None else getattr(torch, group.dtype)


def _scale_groups(packed, scale_val, out_dtype, sumsq):
    if not packed.buffers:
        return [], torch.zeros((), dtype=torch.bool), []
    device = packed.buffers[0].device
    s = _scalar(scale_val, device)
    flag = _new_flag(device)
    outs, rsqs = [], []
    for buf, g in zip(packed.buffers, packed.spec.groups):
        out, rsq = _scale_buffer(buf, s, _out_dtype(out_dtype, g), flag,
                                 sumsq)
        outs.append(out)
        rsqs.append(rsq)
    return outs, flag[0] != 0, rsqs


def scale_packed(packed: PackedTree, scale_val, out_dtype=None
                 ) -> Tuple[PackedTree, torch.Tensor]:
    """``packed * scale``; returns ``(out, found_inf)``, found_inf a device
    bool that trips on any nonfinite scaled value."""
    outs, found_inf, _ = _scale_groups(packed, scale_val, out_dtype, False)
    return PackedTree(outs, respec(packed.spec, out_dtype)), found_inf


def scale(tree: Any, scale_val, out_dtype=None) -> Tuple[Any, torch.Tensor]:
    """Tree-level `scale_packed`: ``(scaled tree, found_inf)``."""
    packed, found_inf = scale_packed(pack_tree(tree), scale_val, out_dtype)
    return unpack_tree(packed), found_inf


def scale_sumsq_packed(packed: PackedTree, scale_val, out_dtype=None):
    """``packed * scale`` in one read of each buffer; returns ``(out,
    found_inf, per-group (rows, 1) fp32 row sums of the scaled values'
    squares)``: the unscale, overflow probe and gradient-norm pass of the
    packed optimizer step."""
    outs, found_inf, rsqs = _scale_groups(packed, scale_val, out_dtype, True)
    return (PackedTree(outs, respec(packed.spec, out_dtype)), found_inf,
            tuple(rsqs))


def axpby_packed(x: PackedTree, y: PackedTree, a, b, out_dtype=None
                 ) -> Tuple[PackedTree, torch.Tensor]:
    """``a * x + b * y`` over buffers packed under one spec; returns
    ``(out, found_inf)``."""
    if [(g.leaf_specs, g.rows) for g in x.spec.groups] != [
            (g.leaf_specs, g.rows) for g in y.spec.groups]:
        raise ValueError(
            "axpby_packed requires x and y packed under the same spec; got "
            f"{x.spec.groups} vs {y.spec.groups}"
        )
    if not x.buffers:
        return PackedTree([], x.spec), torch.zeros((), dtype=torch.bool)
    device = x.buffers[0].device
    a_t, b_t = _scalar(a, device), _scalar(b, device)
    flag = _new_flag(device)
    outs = []
    for xb, yb, g in zip(x.buffers, y.buffers, x.spec.groups):
        od = _out_dtype(out_dtype, g)
        check_packed_buffer(xb)
        check_packed_buffer(yb)
        if xb.shape != yb.shape or xb.device != yb.device:
            raise ValueError("x and y buffers differ in shape or device")
        if _device(xb) == "cpu":
            out, bad = axpby_plain(xb, yb, a_t, b_t, od)
            _raise_flag(flag, bad)
        else:
            out = torch.empty(xb.shape, dtype=od, device=device)
            AXPBY(xb.shape[0], ptr(xb), dtype_code(xb.dtype), ptr(yb),
                  dtype_code(yb.dtype), ptr(a_t), ptr(b_t), ptr(out),
                  dtype_code(od), ptr(flag), stream_ptr(device))
        outs.append(out)
    return PackedTree(outs, respec(x.spec, out_dtype)), flag[0] != 0


def axpby(x: Any, y: Any, a, b) -> Tuple[Any, torch.Tensor]:
    """Tree-level axpby: ``(a * x + b * y, found_inf)``."""
    px = pack_tree(x)
    py = pack_tree(y, px.spec)
    packed, found_inf = axpby_packed(px, py, a, b)
    return unpack_tree(packed), found_inf


@functools.lru_cache(maxsize=64)
def _segment_lengths(group: GroupSpec, device: torch.device) -> torch.Tensor:
    """Rows of each leaf of ``group``, then of the padding, on ``device``
    (built once: the step never copies it from the host)."""
    lens = [ls.nrows for ls in group.leaf_specs]
    return torch.tensor(lens + [group.rows - sum(lens)], device=device)


def segment_sums(group: GroupSpec, row_values: torch.Tensor) -> torch.Tensor:
    """Per-leaf sums of a group's (rows,) per-row values, in leaf order
    (the padding rows dropped)."""
    sums = torch.segment_reduce(
        row_values, "sum",
        lengths=_segment_lengths(group, row_values.device))
    return sums[:len(group.leaf_specs)]


def l2norm_packed(packed: PackedTree, per_tensor: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """Global L2 norm of a packed tree and, with ``per_tensor``, each
    group's per-tensor norms (in ``leaf_specs`` order)."""
    total = None
    per_group = []
    for buf, group in zip(packed.buffers, packed.spec.groups):
        row_sq = row_sumsq(buf)[:, 0]
        total = row_sq.sum() if total is None else total + row_sq.sum()
        if per_tensor:
            per_group.append(torch.sqrt(segment_sums(group, row_sq)))
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total), tuple(per_group) if per_tensor else None


def l2norm(tree: Any, per_tensor: bool = False):
    """Tree-level L2 norm; with ``per_tensor`` the norms as a tree shaped
    like ``tree`` (0-d tensors)."""
    packed = pack_tree(tree)
    global_norm, per_group = l2norm_packed(packed, per_tensor=per_tensor)
    if not per_tensor:
        return global_norm, None
    leaves = [None] * packed.spec.n_leaves
    for norms, group in zip(per_group, packed.spec.groups):
        for j, i in enumerate(group.leaf_indices):
            leaves[i] = norms[j]
    return global_norm, tree_unflatten(packed.spec.treedef, leaves)

