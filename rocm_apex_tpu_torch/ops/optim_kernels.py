"""The LAMB update pair over parameter leaves: the hand-written CUDA
kernels and their plain PyTorch versions.

Port of ``lamb_leaf_stage1`` / ``lamb_leaf_stage2``
(rocm_apex_tpu/ops/optim_kernels.py:339-485). The kernels
(``csrc/lamb.cu``) replace the TPU kernels ``_lamb_leaf1_kernel`` (:355)
and ``_lamb_leaf2_kernel`` (:427). Both are bound by bytes: elementwise
passes with 16-byte accesses, the two norms of stage 1 reduced in a fixed
order. The Pallas row blocks, the (8, 128) partial tiles and the row
padding are the TPU compiler's needs; here a leaf is a flat run of
elements of any length.

The JAX package launches the pair once per leaf. On this card a launch
per leaf costs the host more than the device spends on the leaf, so
`lamb_stage1` / `lamb_stage2` take ALL the leaves of a step in one call
(a table of pointers rides as the kernel argument, 32 leaves a table;
stage 1 launches the update and the reduction of the sums for each table,
stage 2 one kernel: 8 + 4 device launches a step for 100 leaves, each
call counted once);
`lamb_leaf_stage1` / `lamb_leaf_stage2` are the same calls on one leaf.

* Stage 1 updates the moments IN PLACE (in their storage dtype, fp32 or
  bf16) and writes each leaf's ``sum p^2`` and ``sum u^2``, with the
  update direction ``u`` held in registers and never stored. ``u`` comes
  from the fp32 moments BEFORE they are rounded to the storage dtype.
* Stage 2 recomputes ``u`` from the master and the STORED moments and
  writes ``p - lr_ratio * u`` into the master IN PLACE, and the same
  value in the compute dtype into the leaf's ``model_out`` when given.

The step count's bias corrections, the clip factor, ``live`` and the
trust ratios are device values: ``scalars`` and ``lr_ratios`` are device
tensors the kernels read, so nothing waits on the host. ``live <= 0``
freezes every output bit for bit (a select, never a blend).

For CUDA tensors the wrappers launch the kernels (or raise); for CPU
tensors they run the plain versions.
"""

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from rocm_apex_tpu_torch.ops._build import Kernel, dtype_code, ptr, stream_ptr

__all__ = [
    "LAMB_STAGE1",
    "LAMB_STAGE2",
    "lamb_stage1",
    "lamb_stage2",
    "lamb_leaf_stage1",
    "lamb_leaf_stage2",
    "lamb_leaf_stage1_reference",
    "lamb_leaf_stage2_reference",
]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_NP = ctypes.POINTER(ctypes.c_longlong)
_FP = ctypes.POINTER(ctypes.c_float)
LAMB_STAGE1 = Kernel(
    name="lamb_leaf_stage1",
    source="lamb.cu",
    symbol="lamb_stage1",
    argtypes=[_I, _PP, _PP, _PP, _PP, _NP, _FP, _P, _P, _P, _I, _I, _I, _P],
    replaces="rocm_apex_tpu/ops/optim_kernels.py:355 _lamb_leaf1_kernel",
)
LAMB_STAGE2 = Kernel(
    name="lamb_leaf_stage2",
    source="lamb.cu",
    symbol="lamb_stage2",
    argtypes=[_I, _PP, _PP, _PP, _PP, _NP, _FP, _P, _P, _I, _I, _I, _P],
    replaces="rocm_apex_tpu/ops/optim_kernels.py:427 _lamb_leaf2_kernel",
)
_BLOCK_ELEMS = 4096  # csrc/lamb.cu kLambBlockElems


def _u(m2, v2, p, eps, bc1, bc2, wd, adam_w_mode):
    u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    if adam_w_mode and wd != 0.0:
        u = u + wd * p
    return u


def lamb_leaf_stage1_reference(p, g, m, v, scalars, wd, adam_w_mode, out):
    """The plain PyTorch version of stage 1: the kernel's arithmetic in
    the kernel's order; m, v and ``out`` are written in place."""
    b1, b2, b3, eps, bc1, bc2, gs_clip, live = scalars.unbind()
    gf = g.float() * gs_clip
    if not adam_w_mode and wd != 0.0:
        gf = gf + wd * p
    m2 = b1 * m.float() + b3 * gf
    v2 = b2 * v.float() + (1.0 - b2) * gf * gf
    u = _u(m2, v2, p, eps, bc1, bc2, wd, adam_w_mode)
    on = live > 0.0
    # where, not a blend: a skipped step's m2/v2 may be inf or nan
    m.copy_(torch.where(on, m2, m.float()))
    v.copy_(torch.where(on, v2, v.float()))
    out[0] = (p * p).sum()
    out[1] = (u * u).sum()


def lamb_leaf_stage2_reference(p, m, v, scalars, lr_ratio, wd, adam_w_mode,
                               model_out):
    """The plain PyTorch version of stage 2; p and ``model_out`` are
    written in place."""
    eps, bc1, bc2, live = scalars.unbind()
    u = _u(m.float(), v.float(), p, eps, bc1, bc2, wd, adam_w_mode)
    p.copy_(torch.where(live > 0.0, p - lr_ratio.reshape(()) * u, p))
    if model_out is not None:
        model_out.copy_(p)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _check_leaves(ps, scalars, n_scalars, *others):
    """One device, fp32 contiguous masters, ``scalars`` of the right
    length on it; every list in ``others`` (entries may be None) matches
    the masters in length, shape and device, is contiguous and of one
    dtype. Returns the device."""
    if not ps:
        raise ValueError("no leaves")
    dev = ps[0].device
    if scalars.dtype != torch.float32 or scalars.shape != (n_scalars,) or (
            scalars.device != dev) or not scalars.is_contiguous():
        raise ValueError(
            f"scalars must be {n_scalars} contiguous float32 values on the "
            f"masters' device, got {tuple(scalars.shape)} {scalars.dtype} "
            f"on {scalars.device}"
        )
    for p in ps:
        if p.dtype != torch.float32:
            raise TypeError(f"the masters must be float32, got {p.dtype}")
        if p.device != dev or not p.is_contiguous():
            raise ValueError("the masters must be contiguous on one device")
    for ts in others:
        if len(ts) != len(ps):
            raise ValueError("every list must name every leaf")
        dtypes = {t.dtype for t in ts if t is not None}
        if len(dtypes) > 1:
            raise TypeError(f"one dtype per list of buffers, got {dtypes}")
        for t, p in zip(ts, ps):
            if t is not None and (t.shape != p.shape or t.device != dev
                                  or not t.is_contiguous()):
                raise ValueError(
                    "every buffer of a leaf must be contiguous, of the "
                    "master's shape and on its device"
                )
    return dev


def lamb_stage1(
    ps: Sequence[torch.Tensor],
    gs: Sequence[torch.Tensor],
    ms: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    scalars: torch.Tensor,
    wds: Sequence[float],
    adam_w_mode: bool,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stage 1 on every leaf in one call: ``ps`` the fp32 masters, ``gs``
    their gradients (fp32 or bf16, one dtype), ``ms``/``vs`` the moments
    (fp32 or bf16, one dtype), updated in place; ``wds`` each leaf's
    weight decay. ``scalars`` = fp32 ``[b1, b2, b3, eps, bc1, bc2,
    gs * clip, live]`` on the device. Returns ``out``, (leaves, 2) fp32 on
    the device (allocated when not given): each leaf's ``sum p^2`` and
    ``sum u^2``."""
    dev = _check_leaves(ps, scalars, 8, gs, ms, vs)
    if ms[0].dtype != vs[0].dtype:
        raise TypeError("m and v must share a dtype")
    if len(wds) != len(ps):
        raise ValueError("every list must name every leaf")
    if out is None:
        out = torch.empty((len(ps), 2), dtype=torch.float32, device=dev)
    elif out.shape != (len(ps), 2) or out.dtype != torch.float32 or (
            out.device != dev) or not out.is_contiguous():
        raise ValueError("out must be (leaves, 2) contiguous float32 on the "
                         "masters' device")
    if dev.type == "cpu":
        for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
            lamb_leaf_stage1_reference(p, g, m, v, scalars, wds[i],
                                       adam_w_mode, out[i])
        return out
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    sizes = [p.numel() for p in ps]
    if 0 in sizes:
        out.zero_()
    blocks = sum(-(-n // _BLOCK_ELEMS) for n in sizes)
    if blocks == 0:
        return out
    part = torch.empty((2 * blocks,), dtype=torch.float32, device=dev)
    LAMB_STAGE1(
        len(ps), _pointers(ps), _pointers(gs), _pointers(ms), _pointers(vs),
        (ctypes.c_longlong * len(ps))(*sizes),
        (ctypes.c_float * len(ps))(*wds), ptr(scalars), ptr(part), ptr(out),
        int(bool(adam_w_mode)), dtype_code(gs[0].dtype),
        dtype_code(ms[0].dtype), stream_ptr(dev),
    )
    return out


def lamb_stage2(
    ps: Sequence[torch.Tensor],
    ms: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    scalars: torch.Tensor,
    lr_ratios: torch.Tensor,
    wds: Sequence[float],
    adam_w_mode: bool,
    model_outs: Optional[Sequence[torch.Tensor]] = None,
) -> None:
    """Stage 2 on every leaf in one call: recompute ``u`` from each
    master and its stored moments and apply ``p -= lr_ratio * u`` in
    place; with ``model_outs`` (fp32 or bf16, one dtype, the masters'
    shapes) also write each new master into its copy in that dtype.
    ``scalars`` = fp32 ``[eps, bc1, bc2, live]`` and ``lr_ratios`` one
    fp32 value per leaf, both on the device."""
    lists = (ms, vs) if model_outs is None else (ms, vs, model_outs)
    dev = _check_leaves(ps, scalars, 4, *lists)
    if ms[0].dtype != vs[0].dtype:
        raise TypeError("m and v must share a dtype")
    if len(wds) != len(ps):
        raise ValueError("every list must name every leaf")
    if lr_ratios.shape != (len(ps),) or lr_ratios.dtype != torch.float32 or (
            lr_ratios.device != dev) or not lr_ratios.is_contiguous():
        raise ValueError("lr_ratios must be one contiguous float32 value "
                         "per leaf on the masters' device")
    if dev.type == "cpu":
        for i, (p, m, v) in enumerate(zip(ps, ms, vs)):
            lamb_leaf_stage2_reference(
                p, m, v, scalars, lr_ratios[i], wds[i], adam_w_mode,
                None if model_outs is None else model_outs[i])
        return
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    sizes = [p.numel() for p in ps]
    if not any(sizes):
        return
    LAMB_STAGE2(
        len(ps), _pointers(ps), _pointers(ms), _pointers(vs),
        None if model_outs is None else _pointers(model_outs),
        (ctypes.c_longlong * len(ps))(*sizes),
        (ctypes.c_float * len(ps))(*wds), ptr(scalars), ptr(lr_ratios),
        int(bool(adam_w_mode)), dtype_code(ms[0].dtype),
        0 if model_outs is None else dtype_code(model_outs[0].dtype),
        stream_ptr(dev),
    )


def lamb_leaf_stage1(
    p: torch.Tensor,
    g: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    scalars: torch.Tensor,
    wd: float,
    adam_w_mode: bool,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lamb_stage1` on one leaf; returns ``(sum p^2, sum u^2)`` as views
    of ``out`` (2 fp32 on the device; allocated when not given)."""
    if out is not None:
        if out.shape != (2,):
            raise ValueError("out must be 2 float32 values")
        out = out[None]
    out = lamb_stage1([p], [g], [m], [v], scalars, [wd], adam_w_mode, out)
    return out[0, 0], out[0, 1]


def lamb_leaf_stage2(
    p: torch.Tensor,
    m: torch.Tensor,
    v: torch.Tensor,
    scalars: torch.Tensor,
    lr_ratio: torch.Tensor,
    wd: float,
    adam_w_mode: bool,
    model_out: Optional[torch.Tensor] = None,
) -> None:
    """`lamb_stage2` on one leaf; ``lr_ratio`` is one fp32 value on the
    device."""
    lamb_stage2([p], [m], [v], scalars, lr_ratio.reshape(1), [wd],
                adam_w_mode, None if model_out is None else [model_out])
