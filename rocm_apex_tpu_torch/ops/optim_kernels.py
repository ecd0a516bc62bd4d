"""The optimizer updates of the JAX package's ``ops/optim_kernels.py``:
the hand-written CUDA kernels and their plain PyTorch versions.

Two families, as in the JAX module:

* the packed-buffer updates (``csrc/packed_optim.cu``), with the JAX
  signatures: `adam_update`, `sgd_update`, `adagrad_update`,
  `novograd_update`, `lamb_stage1`, `lamb_stage2`, replacing
  ``_adam_kernel`` (rocm_apex_tpu/ops/optim_kernels.py:114),
  ``_sgd_kernel`` (:166), ``_adagrad_kernel`` (:203),
  ``_novograd_kernel`` (:233), ``_lamb1_kernel`` (:273) and
  ``_lamb2_kernel`` (:305). Each takes (rows, 1024) buffers of one dtype
  group (ops/packing.py), (rows, 1) fp32 per-tensor columns and
  ``scalars``, the hyperparameters as ONE fp32 vector on the device (a
  list of numbers and 0-d tensors is assembled into one), in the layouts
  documented beside each function; it returns new buffers: the fp32
  delta (LAMB stage 1: the direction ``u``) and the new state in the
  state's dtype. The ``1 - beta`` slots are the caller's, computed in
  Python double precision as the JAX callers do. All math is fp32.
* the per-leaf LAMB pair (``csrc/lamb.cu``), the port of
  ``lamb_leaf_stage1`` / ``lamb_leaf_stage2`` (:339-485), replacing
  ``_lamb_leaf1_kernel`` (:355) and ``_lamb_leaf2_kernel`` (:427); see
  below.

The LAMB leaf pair. Both are bound by bytes: elementwise
passes with 16-byte accesses, the two norms of stage 1 reduced in a fixed
order. The Pallas row blocks, the (8, 128) partial tiles and the row
padding are the TPU compiler's needs; here a leaf is a flat run of
elements of any length.

The JAX package launches the pair once per leaf. On this card a launch
per leaf costs the host more than the device spends on the leaf, so
`lamb_leaves_stage1` / `lamb_leaves_stage2` take ALL the leaves of a step
in one call (a table of pointers rides as the kernel argument, 32 leaves
a table; stage 1 launches the update and the reduction of the sums for
each table, stage 2 one kernel: 8 + 4 device launches a step for 100
leaves, each call counted once);
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
from rocm_apex_tpu_torch.ops.packing import check_packed_buffer

__all__ = [
    "ADAM_UPDATE",
    "SGD_UPDATE",
    "ADAGRAD_UPDATE",
    "NOVOGRAD_UPDATE",
    "LAMB_STAGE1",
    "LAMB_STAGE2",
    "LAMB_LEAVES_STAGE1",
    "LAMB_LEAVES_STAGE2",
    "adam_update",
    "sgd_update",
    "adagrad_update",
    "novograd_update",
    "lamb_stage1",
    "lamb_stage2",
    "adam_plain",
    "sgd_plain",
    "adagrad_plain",
    "novograd_plain",
    "lamb1_plain",
    "lamb2_plain",
    "scalar_vector",
    "lamb_leaves_stage1",
    "lamb_leaves_stage2",
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
LAMB_LEAVES_STAGE1 = Kernel(
    name="lamb_leaf_stage1",
    source="lamb.cu",
    symbol="lamb_stage1",
    argtypes=[_I, _PP, _PP, _PP, _PP, _NP, _FP, _P, _P, _P, _I, _I, _I, _P],
    replaces="rocm_apex_tpu/ops/optim_kernels.py:355 _lamb_leaf1_kernel",
)
LAMB_LEAVES_STAGE2 = Kernel(
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


def lamb_leaves_stage1(
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
    their gradients (fp32, bf16 or fp16, one dtype), ``ms``/``vs`` the
    moments (fp32, bf16 or fp16, one dtype), updated in place; ``wds``
    each leaf's weight decay. ``scalars`` = fp32 ``[b1, b2, b3, eps, bc1, bc2,
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
    LAMB_LEAVES_STAGE1(
        len(ps), _pointers(ps), _pointers(gs), _pointers(ms), _pointers(vs),
        (ctypes.c_longlong * len(ps))(*sizes),
        (ctypes.c_float * len(ps))(*wds), ptr(scalars), ptr(part), ptr(out),
        int(bool(adam_w_mode)), dtype_code(gs[0].dtype),
        dtype_code(ms[0].dtype), stream_ptr(dev),
    )
    return out


def lamb_leaves_stage2(
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
    place; with ``model_outs`` (fp32, bf16 or fp16, one dtype, the masters'
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
    LAMB_LEAVES_STAGE2(
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
    """`lamb_leaves_stage1` on one leaf; returns ``(sum p^2, sum u^2)`` as
    views of ``out`` (2 fp32 on the device; allocated when not given)."""
    if out is not None:
        if out.shape != (2,):
            raise ValueError("out must be 2 float32 values")
        out = out[None]
    out = lamb_leaves_stage1([p], [g], [m], [v], scalars, [wd], adam_w_mode,
                             out)
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
    """`lamb_leaves_stage2` on one leaf; ``lr_ratio`` is one fp32 value on the
    device."""
    lamb_leaves_stage2([p], [m], [v], scalars, lr_ratio.reshape(1), [wd],
                adam_w_mode, None if model_out is None else [model_out])


# ---------------------------------------------------------------------------
# the packed-buffer updates (csrc/packed_optim.cu)
# ---------------------------------------------------------------------------

_L = ctypes.c_longlong
# rows, x, x dtype, g, g dtype, state 0, state 1, state dtype, column 0,
# column 1, scalars, flags, delta, new state 0, new state 1, stream
_PACKED_ARGS = [_L, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P,
                _P]


def _packed_kernel(name, symbol, where):
    return Kernel(name=name, source="packed_optim.cu", symbol=symbol,
                  argtypes=_PACKED_ARGS,
                  replaces=f"rocm_apex_tpu/ops/optim_kernels.py:{where}")


ADAM_UPDATE = _packed_kernel("adam_update", "packed_adam",
                             "114 _adam_kernel")
SGD_UPDATE = _packed_kernel("sgd_update", "packed_sgd", "166 _sgd_kernel")
ADAGRAD_UPDATE = _packed_kernel("adagrad_update", "packed_adagrad",
                                "203 _adagrad_kernel")
NOVOGRAD_UPDATE = _packed_kernel("novograd_update", "packed_novograd",
                                 "233 _novograd_kernel")
LAMB_STAGE1 = _packed_kernel("lamb_stage1", "packed_lamb1",
                             "273 _lamb1_kernel")
LAMB_STAGE2 = Kernel(
    name="lamb_stage2", source="packed_optim.cu", symbol="packed_lamb2",
    argtypes=[_L, _P, _I, _P, _P, _P, _P],
    replaces="rocm_apex_tpu/ops/optim_kernels.py:305 _lamb2_kernel",
)


def scalar_vector(scalars, device) -> torch.Tensor:
    """``scalars`` (a tensor, or a list of numbers and 0-d tensors) as one
    contiguous fp32 vector on ``device``. Numbers are filled there: no
    host copy waits for the stream."""
    if torch.is_tensor(scalars):
        return scalars.to(device=device, dtype=torch.float32).reshape(-1) \
            .contiguous()
    return torch.stack([
        s.to(device=device, dtype=torch.float32).reshape(())
        if torch.is_tensor(s) else
        torch.full((), float(s), dtype=torch.float32, device=device)
        for s in scalars
    ])


# The plain versions: the JAX kernel bodies, on whole buffers; ``s`` is the
# fp32 scalar vector, the columns (rows, 1) fp32.


def adam_plain(p, g, m, v, wd, s, adam_w_mode):
    lr, b1, omb1, b2, omb2, eps, bc1, bc2, gs = s[:9].unbind()
    pf = p.float()
    gf = g.float() * gs
    if not adam_w_mode:  # L2: decay into the gradient
        gf = gf + wd * pf
    m2 = b1 * m.float() + omb1 * gf
    v2 = b2 * v.float() + omb2 * gf * gf
    u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    if adam_w_mode:  # AdamW: decoupled decay
        u = u + wd * pf
    d = -lr * u
    if s.numel() > 9:
        # the skip slot: a select, never a blend (d, m2, v2 may be inf/nan)
        on = s[9] < 0.5
        d = torch.where(on, d, 0.0)
        m2 = torch.where(on, m2, m.float())
        v2 = torch.where(on, v2, v.float())
    return d, m2.to(m.dtype), v2.to(v.dtype)


def sgd_plain(p, g, buf, wd, s, nesterov, wd_after_momentum, momentum_on):
    lr, mom, damp, first, gs = s.unbind()
    pf = p.float()
    gf = g.float() * gs
    if not wd_after_momentum:
        gf = gf + wd * pf
    if momentum_on:
        b2 = torch.where(first > 0.5, gf,
                         mom * buf.float() + (1.0 - damp) * gf)
        d = gf + mom * b2 if nesterov else b2
    else:
        b2, d = buf.float(), gf
    if wd_after_momentum:
        d = d + wd * pf
    return -lr * d, b2.to(buf.dtype)


def adagrad_plain(p, g, h, wd, s, adagrad_w_mode):
    lr, eps, gs = s.unbind()
    pf = p.float()
    gf = g.float() * gs
    if not adagrad_w_mode:
        gf = gf + wd * pf
    h2 = h.float() + gf * gf
    u = gf / (torch.sqrt(h2) + eps)
    if adagrad_w_mode:
        u = u + wd * pf
    return -lr * u, h2.to(h.dtype)


def novograd_plain(p, g, m, v_col, wd, s, reg_inside_moment):
    lr, b1, b3, eps, bc1, bc2, gs = s.unbind()
    pf = p.float()
    gf = g.float() * gs
    denom = v_col / bc2 + eps  # v is the blended norm, not its square
    if reg_inside_moment:
        m2 = b1 * m.float() + b3 * (gf / denom + wd * pf)
        d = -lr * (m2 / bc1)
    else:
        m2 = b1 * m.float() + b3 * gf
        d = -lr * ((m2 / bc1) / denom + wd * pf)
    return d, m2.to(m.dtype)


def lamb1_plain(p, g, m, v, wd, s, adam_w_mode):
    b1, b2, omb2, b3, eps, bc1, bc2, gs, clip = s.unbind()
    pf = p.float()
    gf = g.float() * gs * clip
    if not adam_w_mode:
        gf = gf + wd * pf
    m2 = b1 * m.float() + b3 * gf
    v2 = b2 * v.float() + omb2 * gf * gf
    u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    if adam_w_mode:
        u = u + wd * pf
    return u, m2.to(m.dtype), v2.to(v.dtype)


def lamb2_plain(u, ratio, s):
    return (-s[0] * ratio * u.float(),)


def _check_update(bufs, cols, s, n_scalars):
    """Every buffer a packed buffer of one shape on one device, every
    column (rows, 1) fp32 contiguous there, ``n_scalars`` scalars."""
    x = bufs[0]
    for b in bufs:
        check_packed_buffer(b)
        if b.shape != x.shape or b.device != x.device:
            raise ValueError("every buffer of an update must have one shape "
                             "and one device")
    for c in cols:
        if (c.shape != (x.shape[0], 1) or c.dtype != torch.float32
                or c.device != x.device or not c.is_contiguous()):
            raise ValueError(
                f"a column is a contiguous ({x.shape[0]}, 1) float32 tensor "
                f"on the buffers' device, got {tuple(c.shape)} {c.dtype} on "
                f"{c.device}"
            )
    if s.numel() not in n_scalars:
        raise ValueError(f"expected {' or '.join(map(str, n_scalars))} "
                         f"scalars, got {s.numel()}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")


def _launch(kernel, x, g, states, cols, s, flags):
    """``(delta, *new states)`` from ``kernel`` on the card."""
    if len(states) == 2 and states[0].dtype != states[1].dtype:
        raise TypeError("the two state buffers must share a dtype")
    dev = x.device
    d = torch.empty(x.shape, dtype=torch.float32, device=dev)
    outs = [torch.empty_like(t) for t in states]
    pad = [None, None]
    st, ot, cl = (list(t) + pad for t in (states, outs, cols))
    kernel(
        x.shape[0], ptr(x), dtype_code(x.dtype), ptr(g),
        dtype_code(g.dtype) if g is not None else 0, ptr(st[0]), ptr(st[1]),
        dtype_code(states[0].dtype) if states else 0, ptr(cl[0]), ptr(cl[1]),
        ptr(s), flags, ptr(d), ptr(ot[0]), ptr(ot[1]), stream_ptr(dev),
    )
    return (d, *outs)


def adam_update(p, g, m, v, wd_col, scalars, adam_w_mode: bool) -> Tuple:
    """One fused Adam/AdamW step over a group buffer. ``scalars``: [lr,
    beta1, 1-beta1, beta2, 1-beta2, eps, bc1, bc2, grad_scale] and an
    optional 10th skip flag (>= 0.5 freezes: delta 0, m and v as they
    were). Returns ``(delta_f32, new_m, new_v)``."""
    s = scalar_vector(scalars, p.device)
    _check_update([p, g, m, v], [wd_col], s, (9, 10))
    if p.device.type == "cpu":
        return adam_plain(p, g, m, v, wd_col, s, adam_w_mode)
    flags = int(bool(adam_w_mode)) | (2 if s.numel() > 9 else 0)
    return _launch(ADAM_UPDATE, p, g, [m, v], [wd_col], s, flags)


def sgd_update(p, g, buf, wd_col, scalars, nesterov: bool,
               wd_after_momentum: bool, momentum_on: bool) -> Tuple:
    """Fused SGD with momentum, nesterov, dampening and the decay's place;
    the first momentum step sets buf = the gradient. ``scalars``: [lr,
    momentum, dampening, first_run, grad_scale]. Returns ``(delta_f32,
    new_buf)``."""
    s = scalar_vector(scalars, p.device)
    _check_update([p, g, buf], [wd_col], s, (5,))
    if p.device.type == "cpu":
        return sgd_plain(p, g, buf, wd_col, s, nesterov, wd_after_momentum,
                         momentum_on)
    flags = (int(bool(nesterov)) | (2 if wd_after_momentum else 0)
             | (4 if momentum_on else 0))
    return _launch(SGD_UPDATE, p, g, [buf], [wd_col], s, flags)


def adagrad_update(p, g, h, wd_col, scalars, adagrad_w_mode: bool) -> Tuple:
    """Fused Adagrad. ``scalars``: [lr, eps, grad_scale]. Returns
    ``(delta_f32, new_h)``."""
    s = scalar_vector(scalars, p.device)
    _check_update([p, g, h], [wd_col], s, (3,))
    if p.device.type == "cpu":
        return adagrad_plain(p, g, h, wd_col, s, adagrad_w_mode)
    return _launch(ADAGRAD_UPDATE, p, g, [h], [wd_col], s,
                   int(bool(adagrad_w_mode)))


def novograd_update(p, g, m, v_col, wd_col, scalars,
                    reg_inside_moment: bool) -> Tuple:
    """Fused NovoGrad given the blended per-tensor norm column ``v_col``.
    ``scalars``: [lr, beta1, beta3, eps, bc1, bc2, grad_scale]. Returns
    ``(delta_f32, new_m)``."""
    s = scalar_vector(scalars, p.device)
    _check_update([p, g, m], [v_col, wd_col], s, (7,))
    if p.device.type == "cpu":
        return novograd_plain(p, g, m, v_col, wd_col, s, reg_inside_moment)
    return _launch(NOVOGRAD_UPDATE, p, g, [m], [wd_col, v_col], s,
                   int(bool(reg_inside_moment)))


def lamb_stage1(p, g, m, v, wd_col, scalars, adam_w_mode: bool) -> Tuple:
    """LAMB stage 1 over a group buffer: the un-trust-scaled direction and
    the new moments. ``scalars``: [beta1, beta2, 1-beta2, beta3, eps, bc1,
    bc2, grad_scale, clip] (clip: the global norm's factor max/||g||).
    Returns ``(u_f32, new_m, new_v)``."""
    s = scalar_vector(scalars, p.device)
    _check_update([p, g, m, v], [wd_col], s, (9,))
    if p.device.type == "cpu":
        return lamb1_plain(p, g, m, v, wd_col, s, adam_w_mode)
    return _launch(LAMB_STAGE1, p, g, [m, v], [wd_col], s,
                   int(bool(adam_w_mode)))


def lamb_stage2(u, ratio_col, scalars) -> Tuple:
    """LAMB stage 2: ``delta = -lr * trust_ratio * u``. ``scalars``: [lr].
    Returns ``(delta_f32,)``."""
    s = scalar_vector(scalars, u.device)
    _check_update([u], [ratio_col], s, (1,))
    if u.device.type == "cpu":
        return lamb2_plain(u, ratio_col, s)
    d = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    LAMB_STAGE2(u.shape[0], ptr(u), dtype_code(u.dtype), ptr(ratio_col),
                ptr(s), ptr(d), stream_ptr(u.device))
    return (d,)
