"""ZeRO-style distributed fused optimizers over the data axis.

Port of ``rocm_apex_tpu/contrib/optimizers/distributed.py`` (JAX
:116-718), the counterpart of the reference's sharded optimizers
(apex/contrib/optimizers/distributed_fused_adam.py:9-636,
distributed_fused_lamb.py:6-910). Every rank passes its FULL, unreduced
local gradients; the step runs on the packed dtype-group buffers of
`ops.packing`:

    grads --reduce-scatter--> this rank's grad shard
    shard update: `adam_update`, or `lamb_stage1`, the sharded per-tensor
        norms (`row_sumsq`, segment sums, one sum over the axis) and
        `lamb_stage2`, on the rank's shard of fp32 masters and moments
        (rows 14 and 15, csrc/multi_tensor.cu and csrc/packed_optim.cu)
    new master shards --cast to the wire dtype--> all-gather --> updates

Each group buffer is padded to a multiple of 64 rows times the axis's
size, so every shard is a whole number of the kernels' 64-row blocks.
The updates are master-driven deltas: `apply_updates` makes each param
its wire-dtype master (one fp32 re-round for an fp32 param). The wire
(``allgather_dtype``): "fp32" (the params equal the masters), "bf16",
or "e5m2"; a low wire clips the masters to its finite range before the
cast (e5m2 tops out at 57344) and moves as uint8 bytes (gloo has no
float8), the bits of JAX's ``clip(...).astype(float8_e5m2)``.

``comm_dtype="int8"`` puts both collectives on the quantized rings
(`ops.quantized_collectives`): the gradients' ring reduce-scatter, and a
ring all-gather of the DELTA master - param shard, whose int8 grid is
lr-fine and whose rounding the next step's delta carries (JAX
:204-258). It excludes a low ``allgather_dtype``.

``predivide``: divide the gradients by the axis's size before the
reduce-scatter, else fold 1 / size into the kernel's gradient scale.
``max_grad_norm > 0`` (Adam) clips by the global gradient norm, from the
shards' row sums of squares summed over the axis (`_global_grad_sumsq`);
LAMB always forms it and clips with ``max_grad_norm``.

**Loss scaling.** ``update(grads, state, params, inv_scale=1 /
loss_scale, with_info=True)`` unscales the local packed gradients with
the fused nonfinite probe (`ops.multi_tensor.scale_packed`) before the
reduce-scatter, takes the flag's max over the axis and
``probe_sync_axes`` (one exchange each), so every rank skips together,
and folds the skip into the update: Adam's kernel skip slot, LAMB's
select after stage 1; masters, moments and count stay bit for bit. JAX
leaves the gather out of a skipped step (``lax.cond``); the port reads
the flag on the host where its last exchange lands it there (a staged
exchange copies it to host memory anyway) and returns zero updates
without the gather. A skipped step takes the probe's exchanges, the
reduce-scatters and the sums of the norms, and no gather.

Exchanges a step over a data axis of more than one rank (G dtype
groups): fp32 comm, G reduce-scatters (`parallel_state.reduce_scatter`:
an all-reduce of the whole buffer, then this rank's block) and G
all-gathers; int8, size - 1 ring hops a group each way; plus one for
the Adam clip's norm, one for LAMB's global norm and one a group for its
per-tensor norms, and one a synced axis for the probe.

The transforms take the `parallel_state` axis name (or a process
group). ``init(params, model=None)``: with ``model``, the module whose
parameters the updates will be applied to (`GPTModel`'s or
`BertModel`'s, in their stored dtypes), the layout is that of its
parameters of the same names, and the masters start from ``params``'
values in fp32, as `MixedPrecisionAdam.init` takes them.
"""

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rocm_apex_tpu_torch.ops import optim_kernels
from rocm_apex_tpu_torch.ops.multi_tensor import row_sumsq, scale_packed
from rocm_apex_tpu_torch.ops.packing import (
    ALIGN_ROWS,
    WIDTH,
    build_pack_spec,
    group_segment_ids,
    pack_like,
    respec,
)
from rocm_apex_tpu_torch.ops.quantized_collectives import (
    check_comm_dtype,
    ring_all_gather,
    ring_reduce_scatter,
)
from rocm_apex_tpu_torch.optimizers import _common as c
from rocm_apex_tpu_torch.optimizers.packed import _bias_corrections, _decayed
from rocm_apex_tpu_torch.transformer import parallel_state

__all__ = [
    "distributed_fused_adam",
    "distributed_fused_lamb",
    "DistributedFusedAdam",
    "DistributedFusedLAMB",
    "DistributedAdamState",
    "DistributedLAMBState",
]


class DistributedAdamState(NamedTuple):
    count: torch.Tensor  # int32 on the device
    master: Tuple[torch.Tensor, ...]  # fp32 (rows_pad / size, WIDTH) shards
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


class DistributedLAMBState(NamedTuple):
    count: torch.Tensor
    master: Tuple[torch.Tensor, ...]
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


_WIRE_DTYPES = {"fp32": None, "bf16": torch.bfloat16,
                "e5m2": torch.float8_e5m2}


def _wire_dtype(allgather_dtype):
    try:
        return _WIRE_DTYPES[allgather_dtype]
    except KeyError:
        raise ValueError(
            f"allgather_dtype must be one of {sorted(_WIRE_DTYPES)}, "
            f"got {allgather_dtype!r}") from None


def _check_wires(allgather_dtype, comm_dtype):
    wire = _wire_dtype(allgather_dtype)
    check_comm_dtype(comm_dtype)
    if comm_dtype == "int8" and wire is not None:
        raise ValueError(
            "comm_dtype='int8' already compresses the param gather; "
            f"combine it with allgather_dtype='fp32', not {allgather_dtype!r}")
    return wire


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _shard_meta(spec, group):
    """(size, rank, [(rows_padded, shard_rows) a group])."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    dims = []
    for g in spec.groups:
        rows_pad = _round_up(g.rows, ALIGN_ROWS * world)
        dims.append((rows_pad, rows_pad // world))
    return world, rank, dims


def _pad_rows_to(buf, rows_pad):
    if buf.shape[0] == rows_pad:
        return buf
    return torch.cat([buf, buf.new_zeros((rows_pad - buf.shape[0],
                                          buf.shape[1]))])


def _slice_shard(buf, rank, shard_rows):
    return buf[rank * shard_rows:(rank + 1) * shard_rows]


def _layout(params, model):
    """The pack spec of the tree the updates apply to: ``params``, or
    with ``model`` its parameters of ``params``' names."""
    if model is None:
        return build_pack_spec(params)
    named = dict(model.named_parameters())
    return build_pack_spec({k: named[k] for k in params})


def _init(params, model, group, state_cls):
    spec = _layout(params, model)
    _, rank, dims = _shard_meta(spec, group)
    masters = pack_like(respec(spec, torch.float32), params).buffers
    dev = masters[0].device
    shards = tuple(_slice_shard(_pad_rows_to(b, rows_pad), rank, rows)
                   .clone() for b, (rows_pad, rows) in zip(masters, dims))
    zeros = tuple(torch.zeros((rows, WIDTH), dtype=torch.float32, device=dev)
                  for _, rows in dims)
    return state_cls(count=torch.zeros((), dtype=torch.int32, device=dev),
                     master=shards, m=zeros, v=tuple(z.clone()
                                                     for z in zeros))


def _scatter_grads(pg, dims, group, world, predivide, comm_dtype="fp32"):
    """Each fp32 gradient buffer reduce-scattered into this rank's shard
    (JAX :167): the plain reduce-scatter, or under int8 the quantized
    ring (the padding tiles the ring)."""
    shards = []
    for gbuf, (rows_pad, _) in zip(pg.buffers, dims):
        g = _pad_rows_to(gbuf, rows_pad)
        if predivide:
            g = g / world
        if comm_dtype == "int8":
            shards.append(ring_reduce_scatter(g, group, dim=0,
                                              comm_dtype="int8"))
        else:
            shards.append(parallel_state.reduce_scatter(g, group, 0))
    return shards


def _gather_deltas(spec, pp, new_masters, dims, group, rank, wire,
                   comm_dtype):
    """The new master shards gathered in the wire dtype, as deltas from
    the params (JAX `_emit_updates`, :204-258)."""
    deltas = []
    for pbuf, master, (rows_pad, rows) in zip(pp.buffers, new_masters, dims):
        pf = pbuf.float()
        if comm_dtype == "int8":
            pshard = _slice_shard(_pad_rows_to(pf, rows_pad), rank, rows)
            full = ring_all_gather(master - pshard, group, dim=0,
                                   comm_dtype="int8")
            deltas.append(full[:pbuf.shape[0]].float())
            continue
        if wire is None:
            full = parallel_state.all_gather(master, group, 0)
        else:
            # clip to the wire's finite range: a plain cast overflows to
            # inf past it (e5m2 at 57344) and would poison the param
            fin = torch.finfo(wire).max
            send = torch.clamp(master, -fin, fin).to(wire)
            full = parallel_state.all_gather(send.view(torch.uint8), group,
                                             0).view(wire)
        deltas.append(full[:pbuf.shape[0]].float() - pf)
    return c.deltas_to_updates(spec, deltas)


def _frozen_updates(spec, pp):
    return c.deltas_to_updates(spec, [
        torch.zeros((b.shape[0], WIDTH), dtype=torch.float32,
                    device=b.device) for b in pp.buffers])


def _max_on_host(flag, groups) -> bool:
    """The int32 flag's max over each group in turn (one exchange a group
    of more than one rank), read on the host: where the last exchange is
    staged through host memory, from the copy it lands there."""
    landed = [flag]

    def fn(send, g):
        out = send.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
        landed.append(out)
        return out

    for g in groups:
        if dist.get_world_size(g) > 1:
            flag = parallel_state.exchange("all_reduce", fn, flag, g)
    return bool(landed[-1].reshape(-1)[0] > 0)


def _unscale_probe(pg, inv_scale, group, probe_sync_axes):
    """The fused unscale and nonfinite probe over the FULL local packed
    gradients, before the reduce-scatter (JAX :298): the wire carries
    unscaled fp32, and the int8 wire, which saturates inf, cannot hide an
    overflow. The flag's max over the axis and ``probe_sync_axes``, on
    the host."""
    pg, local_inf = scale_packed(pg, inv_scale, torch.float32)
    groups = [group] + [parallel_state.resolve_group(a)
                        for a in probe_sync_axes]
    return pg, _max_on_host(local_inf.to(torch.int32).reshape(1), groups)


def _global_grad_sumsq(grad_shards, group):
    """The shards are disjoint after the reduce-scatter: the global sum of
    squares is the sum over the axis of the shards' row sums (JAX
    :317)."""
    local = sum(row_sumsq(g).sum() for g in grad_shards).reshape(1)
    if dist.get_world_size(group) == 1:
        return local[0]
    return parallel_state.all_reduce(local, group)[0]


@functools.lru_cache(maxsize=64)
def _wd_shard_cols(spec, weight_decay, mask_key, dims, rank, device):
    mask = None if mask_key is None else dict(mask_key)
    cols = c.wd_columns(spec, weight_decay, mask, device)
    return tuple(_slice_shard(_pad_rows_to(col, rows_pad), rank, rows)
                 .contiguous() for col, (rows_pad, rows) in zip(cols, dims))


def _mask_key(mask):
    return None if mask is None else tuple(sorted(mask.items()))


@functools.lru_cache(maxsize=64)
def _shard_ids(group_spec, rows_pad, rank, rows, device):
    """This rank's rows' tensor index in the group (the padding rows the
    index past the last tensor), on the device."""
    n_t = len(group_spec.leaf_specs)
    ids = np.concatenate([group_segment_ids(group_spec),
                          np.full((rows_pad - group_spec.rows,), n_t,
                                  np.int32)]).astype(np.int64)
    return torch.from_numpy(ids[rank * rows:(rank + 1) * rows]).to(device)


class _Step(NamedTuple):
    """What both updates share before the shard kernels: the layout, this
    rank's place, the overflow flag (None without ``inv_scale``), the
    step's scalars and the gradient shards."""
    group: Any
    spec: Any
    pp: Any
    rank: int
    dims: list
    found_inf: Optional[bool]
    lr: Any
    bc1: Any
    bc2: Any
    gs: Any
    g_shards: list


def _begin(grads, state, params, inv_scale, learning_rate, bias_correction,
           betas, grad_scale, predivide, comm_dtype, axis_name,
           probe_sync_axes):
    """Pack, unscale and probe (with ``inv_scale``), reduce-scatter; the
    learning rate, bias corrections and gradient scale of the step (JAX
    :361-378, :497-517)."""
    group = parallel_state.resolve_group(axis_name)
    spec, pp, pg = c.pack_params_and_grads(params, grads)
    world, rank, dims = _shard_meta(spec, group)
    found_inf = None
    if inv_scale is not None:
        pg, found_inf = _unscale_probe(pg, inv_scale, group, probe_sync_axes)
    count_live = state.count + 1
    bc1, bc2 = _bias_corrections(bias_correction, *betas, count_live)
    gs = 1.0 if grad_scale is None else grad_scale
    if not predivide:
        gs = gs / world
    return _Step(group, spec, pp, rank, dims, found_inf,
                 c.resolve_lr(learning_rate, count_live), bc1, bc2, gs,
                 _scatter_grads(pg, dims, group, world, predivide,
                                comm_dtype))


def _finish(st, state, state_cls, new_master, new_m, new_v, wire,
            comm_dtype, with_info):
    """The count, the gathered updates (none gathered on a skipped step),
    the new state, and with ``with_info`` the flag (JAX :402-421)."""
    skipped = bool(st.found_inf)
    updates = (_frozen_updates(st.spec, st.pp) if skipped else
               _gather_deltas(st.spec, st.pp, new_master, st.dims, st.group,
                              st.rank, wire, comm_dtype))
    new_state = state_cls(count=state.count + (0 if skipped else 1),
                          master=tuple(new_master), m=tuple(new_m),
                          v=tuple(new_v))
    if not with_info:
        return updates, new_state
    return updates, new_state, {"found_inf": torch.full(
        (), skipped, dtype=torch.bool, device=state.count.device)}


def distributed_fused_adam(
    learning_rate: c.ScalarOrSchedule = 1e-3,
    *,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    adam_w_mode: bool = True,
    weight_decay: float = 0.0,
    weight_decay_mask: Optional[Dict[str, bool]] = None,
    grad_scale: Optional[Any] = None,
    max_grad_norm: float = 0.0,
    predivide: bool = True,
    allgather_dtype: str = "fp32",
    comm_dtype: str = "fp32",
    axis_name: Any = parallel_state.DATA_AXIS,
    probe_sync_axes: Tuple[str, ...] = (),
) -> c.GradientTransformation:
    """ZeRO-sharded fused Adam over ``axis_name`` (JAX :328): the
    `fused_adam` hyperparameters, ``max_grad_norm > 0`` the global-norm
    clip, ``update(grads, state, params, *, inv_scale=None,
    with_info=False)`` (see the module doc)."""
    beta1, beta2 = betas
    wire = _check_wires(allgather_dtype, comm_dtype)

    def init_fn(params, model=None):
        return _init(params, model, parallel_state.resolve_group(axis_name),
                     DistributedAdamState)

    def update_fn(grads, state, params=None, *, inv_scale=None,
                  with_info=False):
        if params is None:
            raise ValueError("distributed_fused_adam requires params in "
                             "update()")
        st = _begin(grads, state, params, inv_scale, learning_rate,
                    bias_correction, betas, grad_scale, predivide,
                    comm_dtype, axis_name, probe_sync_axes)
        gs = st.gs
        if max_grad_norm and max_grad_norm > 0:
            gnorm = torch.sqrt(_global_grad_sumsq(st.g_shards, st.group)) * gs
            gs = gs * torch.where(gnorm > max_grad_norm,
                                  max_grad_norm / gnorm, 1.0)
        wd_cols = _wd_shard_cols(st.spec, weight_decay,
                                 _mask_key(weight_decay_mask),
                                 tuple(st.dims), st.rank, state.count.device)
        scalars = [st.lr, beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
                   st.bc1, st.bc2, gs]
        if st.found_inf is not None:
            # the kernel's skip slot: deltas 0, moments frozen
            scalars.append(float(st.found_inf))
        new_master, new_m, new_v = [], [], []
        for mast, gsh, mb, vb, wd in zip(state.master, st.g_shards, state.m,
                                         state.v, wd_cols):
            d, m2, v2 = optim_kernels.adam_update(mast, gsh, mb, vb, wd,
                                                  scalars, adam_w_mode)
            new_master.append(mast + d)
            new_m.append(m2)
            new_v.append(v2)
        return _finish(st, state, DistributedAdamState, new_master, new_m,
                       new_v, wire, comm_dtype, with_info)

    return c.GradientTransformation(init_fn, update_fn)


def distributed_fused_lamb(
    learning_rate: c.ScalarOrSchedule = 1e-3,
    *,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    grad_averaging: bool = True,
    adam_w_mode: bool = True,
    max_grad_norm: float = 1.0,
    use_nvlamb: bool = False,
    weight_decay_mask: Optional[Dict[str, bool]] = None,
    grad_scale: Optional[Any] = None,
    predivide: bool = True,
    allgather_dtype: str = "fp32",
    comm_dtype: str = "fp32",
    axis_name: Any = parallel_state.DATA_AXIS,
    probe_sync_axes: Tuple[str, ...] = (),
) -> c.GradientTransformation:
    """ZeRO-sharded fused LAMB over ``axis_name`` (JAX :461): the trust
    ratios ||p|| / ||u|| from the shards' segmented row sums, summed over
    the axis (one exchange a group for both norms), which are the
    unsharded `fused_lamb`'s; the rest as `distributed_fused_adam`."""
    beta1, beta2 = betas
    beta3 = 1.0 - beta1 if grad_averaging else 1.0
    wire = _check_wires(allgather_dtype, comm_dtype)

    def init_fn(params, model=None):
        return _init(params, model, parallel_state.resolve_group(axis_name),
                     DistributedLAMBState)

    def update_fn(grads, state, params=None, *, inv_scale=None,
                  with_info=False):
        if params is None:
            raise ValueError("distributed_fused_lamb requires params in "
                             "update()")
        st = _begin(grads, state, params, inv_scale, learning_rate,
                    bias_correction, betas, grad_scale, predivide,
                    comm_dtype, axis_name, probe_sync_axes)
        dev = state.count.device
        world = dist.get_world_size(st.group)
        gnorm = torch.sqrt(_global_grad_sumsq(st.g_shards, st.group)) * st.gs
        clip = (torch.where(gnorm > max_grad_norm, max_grad_norm / gnorm, 1.0)
                if max_grad_norm and max_grad_norm > 0 else 1.0)
        wd_cols = _wd_shard_cols(st.spec, weight_decay,
                                 _mask_key(weight_decay_mask),
                                 tuple(st.dims), st.rank, dev)
        wd_vals = c.wd_per_tensor(st.spec, weight_decay, weight_decay_mask)
        new_master, new_m, new_v = [], [], []
        for mast, gsh, mb, vb, wd, wdv, gspec, (rows_pad, rows) in zip(
                state.master, st.g_shards, state.m, state.v, wd_cols,
                wd_vals, st.spec.groups, st.dims):
            u, m2, v2 = optim_kernels.lamb_stage1(
                mast, gsh, mb, vb, wd,
                [beta1, beta2, 1.0 - beta2, beta3, eps, st.bc1, st.bc2,
                 st.gs, clip], adam_w_mode)
            # the sharded per-tensor norms: the shard's segmented row sums
            # of ||p||^2 and ||u||^2, summed over the axis in one exchange
            n_t = len(gspec.leaf_specs)
            ids = _shard_ids(gspec, rows_pad, st.rank, rows, dev)
            parts = torch.zeros((2, n_t + 1), dtype=torch.float32,
                                device=dev)
            parts[0].index_add_(0, ids, row_sumsq(mast)[:, 0])
            parts[1].index_add_(0, ids, row_sumsq(u)[:, 0])
            parts = parts[:, :n_t].contiguous()
            if world > 1:
                parts = parallel_state.all_reduce(parts, st.group)
            p_norm, u_norm = torch.sqrt(parts[0]), torch.sqrt(parts[1])
            ratio = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                                p_norm / u_norm, 1.0)
            if not use_nvlamb:
                # the trust ratio for decayed tensors only (reference
                # multi_tensor_lamb.cu:255-262)
                ratio = torch.where(_decayed(
                    np.asarray(wdv, np.float32).tobytes(), dev), ratio, 1.0)
            padded = torch.cat([ratio, ratio.new_ones((1,))])
            (d,) = optim_kernels.lamb_stage2(
                u, padded[ids][:, None].contiguous(), [st.lr])
            if st.found_inf:
                # stage 1 has no skip slot: a select, never a blend
                d, m2, v2 = torch.zeros_like(d), mb, vb
            new_master.append(mast + d)
            new_m.append(m2)
            new_v.append(v2)
        return _finish(st, state, DistributedLAMBState, new_master, new_m,
                       new_v, wire, comm_dtype, with_info)

    return c.GradientTransformation(init_fn, update_fn)


class DistributedFusedAdam(c.FusedOptimizer):
    """The reference constructor (distributed_fused_adam.py:9-127; its
    overlap knobs have no counterpart) over `distributed_fused_adam`."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        adam_w_mode: bool = True,
        max_grad_norm: float = 0.0,
        predivide: bool = True,
        allgather_dtype: str = "fp32",
        comm_dtype: str = "fp32",
        weight_decay_mask: Optional[Dict[str, bool]] = None,
        axis_name: Any = parallel_state.DATA_AXIS,
        probe_sync_axes: Tuple[str, ...] = (),
    ):
        if amsgrad:
            raise RuntimeError(
                "DistributedFusedAdam does not support the AMSGrad variant.")
        super().__init__(distributed_fused_adam(
            lr, bias_correction=bias_correction, betas=betas, eps=eps,
            adam_w_mode=adam_w_mode, weight_decay=weight_decay,
            weight_decay_mask=weight_decay_mask, max_grad_norm=max_grad_norm,
            predivide=predivide, allgather_dtype=allgather_dtype,
            comm_dtype=comm_dtype, axis_name=axis_name,
            probe_sync_axes=probe_sync_axes))


class DistributedFusedLAMB(c.FusedOptimizer):
    """The reference constructor (distributed_fused_lamb.py:6-910) over
    `distributed_fused_lamb`."""

    def __init__(
        self,
        lr: c.ScalarOrSchedule = 1e-3,
        bias_correction: bool = True,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-6,
        weight_decay: float = 0.01,
        amsgrad: bool = False,
        adam_w_mode: bool = True,
        grad_averaging: bool = True,
        max_grad_norm: float = 1.0,
        use_nvlamb: bool = False,
        predivide: bool = True,
        allgather_dtype: str = "fp32",
        comm_dtype: str = "fp32",
        weight_decay_mask: Optional[Dict[str, bool]] = None,
        axis_name: Any = parallel_state.DATA_AXIS,
        probe_sync_axes: Tuple[str, ...] = (),
    ):
        if amsgrad:
            raise RuntimeError(
                "DistributedFusedLAMB does not support the AMSGrad variant.")
        super().__init__(distributed_fused_lamb(
            lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            adam_w_mode=adam_w_mode, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, predivide=predivide,
            allgather_dtype=allgather_dtype, comm_dtype=comm_dtype,
            weight_decay_mask=weight_decay_mask, axis_name=axis_name,
            probe_sync_axes=probe_sync_axes))
