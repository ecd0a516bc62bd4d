"""The ranks of the data-parallel test modules (tests/test_torch_parallel.py,
test_torch_distributed_optimizers.py, test_torch_data_parallel_train.py):
one process each of a gloo group on the CPU, spawned once per suite.

This module imports torch and the port only: a spawned rank re-imports
the module that defines its entry point, and the test modules import
JAX. Each rank lays the world out with `initialize_model_parallel(tp)`
(``world = dp x tp``, rank ``d * tp + t``), binds ``"spatial"`` to the
default group, reads the inputs the test wrote (numpy arrays in an
.npz), runs its suite and writes what it computed to ``rank<r>.pt``
beside them (an ``error`` entry if the suite raised).

Suite ``"parallel"`` (2 ranks): `sync_gradients` in every mode, a mixed
tree's exchanges, `DistributedDataParallel`, `Reducer`,
`broadcast_params`, `SyncBatchNorm` (NHWC and NCHW forward, running
statistics and every gradient, ``fuse_relu``, evaluation on the running
statistics, bf16 output, `convert_syncbn_model`) and its exchanges.
Suite ``"subsets"`` (4 ranks): the same with ``axis_index_groups``.
Suite ``"zero"`` (2 ranks): the ZeRO optimizers' 3-step trajectories in
every configuration of `ZERO_CONFIGS`, e5m2 saturation, the loss
scaler's overflow round trip, the exchanges a step and a skipped step.
Suite ``"dp_train"`` (2 ranks): the ZeRO GPT step (`make_zero_train_step`)
at fp32 and int8 comm, the tiny ResNet under ``sync_bn_axis="data"`` (O0
and O5 steps after `sync_gradients`), `SpatialBottleneck` H-sharded.
Suite ``"dp_tp"`` (4 ranks, tp=2): the layout's ranks and the refusal of
pipeline parallelism, then the GPT step at dp=2 x tp=2 with the
gradients synced over the data axis (`make_train_step(grad_sync=)`).
"""

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from _torch_tp_ranks import gpt_config, tree_of

TIMEOUT = datetime.timedelta(seconds=60)
LR = 1e-2
ZERO_STEPS = 3
# name -> (optimizer, keyword arguments) of the ZeRO trajectories
ZERO_CONFIGS = {
    "adam_predivide": ("adam", dict(weight_decay=0.01, predivide=True)),
    "adam_postdivide": ("adam", dict(weight_decay=0.01, predivide=False)),
    "adam_l2": ("adam", dict(weight_decay=0.01, adam_w_mode=False)),
    "adam_clip": ("adam", dict(weight_decay=0.01, max_grad_norm=0.5)),
    "adam_bf16": ("adam", dict(weight_decay=0.01, allgather_dtype="bf16")),
    "adam_e5m2": ("adam", dict(weight_decay=0.01, allgather_dtype="e5m2")),
    "adam_int8": ("adam", dict(weight_decay=0.01, comm_dtype="int8")),
    "lamb": ("lamb", dict(weight_decay=0.01)),
    "lamb_postdivide": ("lamb", dict(weight_decay=0.01, predivide=False)),
    "lamb_nvlamb": ("lamb", dict(weight_decay=0.01, use_nvlamb=True)),
    "lamb_mask": ("lamb", dict(weight_decay=0.01, weight_decay_mask={
        "b": False, "emb": True, "w": True})),
    "lamb_bf16": ("lamb", dict(weight_decay=0.01, allgather_dtype="bf16")),
    "lamb_e5m2": ("lamb", dict(weight_decay=0.01, allgather_dtype="e5m2")),
    "lamb_int8": ("lamb", dict(weight_decay=0.01, comm_dtype="int8")),
}
ZERO_NAMES = ("w", "b", "emb")
SCALE = 1024.0  # the overflow run's loss scale: scaled grads unscale exactly
OVERFLOW_STEP, OVERFLOW_RANK = 1, 1
SUBSETS = [[0, 1], [2, 3]]
# the ZeRO GPT step and the dp x tp step: B 4 (2 a data rank) x S 16
DP_BATCH, DP_SEQ = 4, 16
DP_GPT = dict(hidden_size=64)  # the tiny GPT at hidden 64
# the GPT steps' Adam eps: the key projection's bias has a zero gradient
# in exact arithmetic, so its fp32 gradient is summation noise, which
# Adam's normalized step at eps 1e-8 turns into lr-sized steps of either
# sign (tests/_torch_tp_ranks.py's trajectory takes 1e-4 for the same)
DP_EPS = 1e-4
DP_STEPS = 3
DP_COMMS = ("fp32", "int8")
RN50_LR, RN50_EPS = 1e-3, 1e-3
SPATIAL = dict(cin=16, cmid=8, cout=32)


def _t(inputs, key, rank=None, dtype=torch.float32):
    a = inputs[key] if rank is None else inputs[key][rank]
    return torch.from_numpy(np.array(a)).to(dtype)


class _Counter:
    """Counts `parallel_state.exchange` calls by kind while open."""

    def __enter__(self):
        from rocm_apex_tpu_torch.transformer import parallel_state

        self.ps, self.inner, self.counts = (parallel_state,
                                            parallel_state.exchange, {})

        def counted(kind, fn, t, group):
            self.counts[kind] = self.counts.get(kind, 0) + 1
            return self.inner(kind, fn, t, group)

        parallel_state.exchange = counted
        return self.counts

    def __exit__(self, *exc):
        self.ps.exchange = self.inner
        return False


def _bn_run(bn, x, w, train=True):
    """``(y, d(sum(y * w)) / d(x, scale, bias))`` of one forward."""
    x = x.clone().requires_grad_(True)
    y = bn(x, train)
    params = [x] + [p for p in (bn.scale, bn.bias) if p is not None]
    grads = torch.autograd.grad((y.float() * w).sum(), params)
    return y.detach(), [g.detach() for g in grads]


def _syncbn_cases(inputs, rank, out, groups=None):
    from rocm_apex_tpu_torch.parallel import SyncBatchNorm

    def bn(c, **kw):
        m = SyncBatchNorm(c, axis_index_groups=groups, device="cpu", **kw)
        with torch.no_grad():
            m.scale.copy_(_t(inputs, "bn_scale")[:c])
            m.bias.copy_(_t(inputs, "bn_bias")[:c])
        return m

    x, w = _t(inputs, "bn_x", rank), _t(inputs, "bn_w", rank)
    m = bn(x.shape[-1], channel_last=True)
    with _Counter() as counts:
        y, grads = _bn_run(m, x, w)
    out["bn_nhwc"] = dict(y=y, grads=grads, mean=m.mean.clone(),
                          var=m.var.clone(), exchanges=dict(counts))
    out["bn_eval"] = m(x, False).detach()
    xc, wc = _t(inputs, "bn_xc", rank), _t(inputs, "bn_wc", rank)
    m = bn(xc.shape[1], channel_last=False)
    y, grads = _bn_run(m, xc, wc)
    out["bn_nchw"] = dict(y=y, grads=grads, mean=m.mean.clone(),
                          var=m.var.clone())
    m = bn(x.shape[-1], channel_last=True, fuse_relu=True)
    out["bn_relu"] = _bn_run(m, x, w)[0]
    if groups is not None:
        return
    m = bn(x.shape[-1], channel_last=True, dtype=torch.bfloat16)
    out["bn_bf16"] = m(x, True).detach()


def _sync_cases(inputs, rank, out, groups=None):
    from rocm_apex_tpu_torch.parallel import (
        DistributedDataParallel,
        Reducer,
        broadcast_params,
        sync_gradients,
    )

    g = _t(inputs, "g", rank)
    kw = dict(axis_index_groups=groups)
    out["mean"] = sync_gradients({"w": g}, **kw)["w"]
    out["sum"] = sync_gradients(g, gradient_average=False, **kw)
    out["predivide"] = sync_gradients(g, gradient_predivide_factor=4.0, **kw)
    gb = _t(inputs, "g", rank).to(torch.bfloat16)
    out["bf16"] = sync_gradients(gb, **kw)
    out["bf16_fp32"] = sync_gradients(gb, allreduce_always_fp32=True, **kw)
    out["ddp"] = DistributedDataParallel(allreduce_always_fp32=True,
                                         axis_index_groups=groups)(g)
    out["reducer"] = Reducer(axis_index_groups=groups)(g)
    if groups is not None:
        return
    out["bcast"] = broadcast_params({"w": _t(inputs, "p", rank)})["w"]
    step = torch.arange(8, dtype=torch.int32) + rank
    out["int"] = sync_gradients({"step": step})["step"]
    tree = {"a": _t(inputs, "g", rank), "b": gb,
            "c": _t(inputs, "g", rank)[:2], "step": step, "none": None}
    for fp32 in (False, True):
        with _Counter() as counts:
            res = sync_gradients(tree, allreduce_always_fp32=fp32)
        out[f"tree_fp32_{fp32}"] = dict(
            res={k: v for k, v in res.items() if v is not None},
            exchanges=dict(counts))


def _parallel_suite(inputs, rank, out):
    _sync_cases(inputs, rank, out)
    _syncbn_cases(inputs, rank, out)
    from rocm_apex_tpu_torch.models._layers import BatchNorm
    from rocm_apex_tpu_torch.parallel import (SyncBatchNorm,
                                              convert_syncbn_model)

    net = torch.nn.Module()
    net.bn = BatchNorm(4, momentum=0.99, device="cpu")
    with torch.no_grad():
        net.bn.scale.copy_(_t(inputs, "bn_scale")[:4])
    conv = convert_syncbn_model(net)
    x = _t(inputs, "bn_x", rank)
    out["convert"] = dict(is_sync=isinstance(conv.bn, SyncBatchNorm),
                          momentum=conv.bn.momentum,
                          channel_last=conv.bn.channel_last,
                          y=conv.bn(x, True).detach(),
                          mean=conv.bn.mean.clone(), var=conv.bn.var.clone())


def _subsets_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.parallel.distributed import group_psum

    _sync_cases(inputs, rank, out, SUBSETS)
    _syncbn_cases(inputs, rank, out, SUBSETS)
    out["group_psum"] = group_psum(_t(inputs, "g", rank), "data", SUBSETS)


def _zero_params(inputs, prefix="zp."):
    return {k: _t(inputs, prefix + k) for k in ZERO_NAMES}


def _zero_opt(kind, kw):
    from rocm_apex_tpu_torch.contrib.optimizers import (
        distributed_fused_adam,
        distributed_fused_lamb,
    )

    return (distributed_fused_adam if kind == "adam"
            else distributed_fused_lamb)(LR, **kw)


def _zero_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.optimizers._common import apply_updates

    grads = {k: _t(inputs, "zg." + k, rank) for k in ZERO_NAMES}
    for name, (kind, kw) in ZERO_CONFIGS.items():
        tx = _zero_opt(kind, kw)
        params = _zero_params(inputs)
        state = tx.init(params)
        counts = []
        for _ in range(ZERO_STEPS):
            with _Counter() as c:
                updates, state = tx.update(grads, state, params)
            counts.append(dict(c))
            params = apply_updates(params, updates)
        out[f"zero_{name}"] = dict(params=params, master=state.master,
                                   count=int(state.count), exchanges=counts)
    # e5m2 saturation: masters past the wire's range land at its max
    tx = _zero_opt("adam", dict(allgather_dtype="e5m2"))
    params = {"w": torch.full((8, 8), 1e6)}
    state = tx.init(params)
    updates, state = tx.update({"w": torch.zeros(8, 8)}, state, params)
    out["e5m2_saturation"] = apply_updates(params, updates)["w"]
    # the loss scaler round trip: step OVERFLOW_STEP overflows on rank
    # OVERFLOW_RANK only; every rank skips it, bit-frozen
    for kind in ("adam", "lamb"):
        tx = _zero_opt(kind, dict(weight_decay=0.01))
        params = _zero_params(inputs)
        state = tx.init(params)
        flags, states, counts = [], [], []
        for t in range(ZERO_STEPS):
            g = {k: _t(inputs, f"hg.{k}")[t, rank] * SCALE
                 for k in ZERO_NAMES}
            with _Counter() as c:
                updates, state, info = tx.update(
                    g, state, params, inv_scale=1.0 / SCALE, with_info=True)
            counts.append(dict(c))
            params = apply_updates(params, updates)
            flags.append(bool(info["found_inf"]))
            states.append(dict(params=params, master=state.master,
                               m=state.m, v=state.v,
                               count=int(state.count)))
        out[f"overflow_{kind}"] = dict(flags=flags, states=states,
                                       exchanges=counts)
    # the port's own replicated packed Adam on the rank-order mean
    from rocm_apex_tpu_torch.optimizers import packed_adam

    ref = packed_adam(LR, weight_decay=0.01)
    params = _zero_params(inputs)
    rstate = ref.init(params)
    for t in range(ZERO_STEPS):
        mean = {k: _t(inputs, f"hg.{k}")[t, 0] / 2 + _t(inputs, f"hg.{k}")[
            t, 1] / 2 for k in ZERO_NAMES}
        updates, rstate = ref.update(mean, rstate, params)
        params = apply_updates(params, updates)
    out["overflow_replicated"] = dict(params=params, count=int(rstate.count))


def _gpt_batch(inputs, d, n_data):
    rows = DP_BATCH // n_data
    sl = slice(d * rows, (d + 1) * rows)
    return (_t(inputs, "tokens", dtype=torch.int64)[sl],
            _t(inputs, "labels", dtype=torch.int64)[sl])


def _zero_gpt(inputs, rank, out):
    from rocm_apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from rocm_apex_tpu_torch.convert import train_state_from_jax_params
    from rocm_apex_tpu_torch.train import make_zero_train_step

    tokens, labels = _gpt_batch(inputs, rank, 2)
    for comm in DP_COMMS:
        opt = DistributedFusedAdam(LR, weight_decay=0.01, eps=DP_EPS,
                                   allgather_dtype="fp32", comm_dtype=comm)
        model, state = train_state_from_jax_params(
            tree_of(inputs), gpt_config(1, **DP_GPT), opt, device="cpu")
        step = make_zero_train_step(model, opt)
        losses, counts = [], []
        for _ in range(DP_STEPS):
            with _Counter() as c:
                state, loss = step(state, tokens, labels)
            counts.append(dict(c))
            losses.append(float(loss))
        out[f"zero_gpt_{comm}"] = dict(
            losses=losses, exchanges=counts,
            params={k: p.detach().clone()
                    for k, p in model.named_parameters()})


def _resnet(inputs, dtype=torch.float32):
    from rocm_apex_tpu_torch.convert import resnet_from_jax_variables
    from rocm_apex_tpu_torch.models import resnet as tr

    m = tr.resnet_tiny(sync_bn_axis="data", num_classes=10, dtype=dtype,
                       device="cpu")
    resnet_from_jax_variables(tree_of(inputs, "rp.")["params"],
                              tree_of(inputs, "rs.")["params"], m)
    return m


def _resnet_steps(inputs, rank, out):
    from rocm_apex_tpu_torch import amp
    from rocm_apex_tpu_torch.optimizers import FusedAdam
    from rocm_apex_tpu_torch.parallel import sync_gradients
    from rocm_apex_tpu_torch.train import make_rn50_train_step

    x = _t(inputs, "rx", rank)
    y = _t(inputs, "ry", rank, torch.int64)
    for level, dtype, steps in (("O0", torch.float32, 2),
                                ("O5", torch.bfloat16, 1)):
        m = _resnet(inputs, dtype)
        params, opt, st = amp.initialize(
            {k: v.detach() for k, v in m.named_parameters()},
            FusedAdam(RN50_LR, weight_decay=1e-4, eps=RN50_EPS),
            opt_level=level)
        opt_state = opt.init(params)
        step = make_rn50_train_step(m, opt, st, grad_sync=sync_gradients)
        sstates, losses = st.scaler_states, []
        with _Counter() as c:
            for _ in range(steps):
                params, opt_state, sstates, loss = step(
                    params, opt_state, sstates, x, y)
                losses.append(float(loss))
        out[f"resnet_{level}"] = dict(
            losses=losses, exchanges=dict(c),
            params={k: v.detach().float() for k, v in params.items()},
            stats={k: b.clone() for k, b in m.named_buffers()})


def _spatial(inputs, rank, out):
    from rocm_apex_tpu_torch.contrib.bottleneck import (
        Bottleneck,
        SpatialBottleneck,
        halo_exchange,
    )
    from rocm_apex_tpu_torch.convert import resnet_from_jax_variables

    x = _t(inputs, "sx")
    h = x.shape[1] // 2
    xs = x[:, rank * h:(rank + 1) * h]
    w = _t(inputs, "sw")[:, rank * h:(rank + 1) * h]
    out["halo"] = halo_exchange(xs, "spatial")
    variables = (tree_of(inputs, "sp.")["params"],
                 tree_of(inputs, "ss.")["params"])
    res = {}
    for form, sync in (("eval", None), ("train", "spatial")):
        blocks = {}
        for name, cls, kw in (("spatial", SpatialBottleneck,
                               dict(spatial_axis="spatial")),
                              ("dense", Bottleneck, {})):
            b = cls(SPATIAL["cin"], SPATIAL["cmid"], SPATIAL["cout"],
                    sync_bn_axis=sync if name == "spatial" else None,
                    device="cpu", **kw)
            resnet_from_jax_variables(*variables, b)
            blocks[name] = b
        train = form == "train"
        xr = xs.clone().requires_grad_(True)
        y = blocks["spatial"](xr, train)
        params = dict(blocks["spatial"].named_parameters())
        grads = torch.autograd.grad((y * w).sum(), [xr, *params.values()])
        # the unsharded block on the gathered input, once a rank
        xd = x.clone().requires_grad_(True)
        yd = blocks["dense"](xd, train)
        dparams = dict(blocks["dense"].named_parameters())
        dgrads = torch.autograd.grad((yd * _t(inputs, "sw")).sum(),
                                     [xd, *dparams.values()])
        res[form] = dict(
            y=y.detach(), dx=grads[0],
            dparams={k: g for k, g in zip(params, grads[1:])},
            dense_y=yd.detach()[:, rank * h:(rank + 1) * h],
            dense_dx=dgrads[0][:, rank * h:(rank + 1) * h],
            dense_dparams={k: g for k, g in zip(dparams, dgrads[1:])})
    out["spatial"] = res


def _dp_train_suite(inputs, rank, out):
    _zero_gpt(inputs, rank, out)
    _resnet_steps(inputs, rank, out)
    _spatial(inputs, rank, out)


def _dp_tp_suite(inputs, rank, out):
    from rocm_apex_tpu_torch.amp import LossScaler
    from rocm_apex_tpu_torch.convert import train_state_from_jax_params
    from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
    from rocm_apex_tpu_torch.parallel import DistributedDataParallel
    from rocm_apex_tpu_torch.train import make_train_step
    from rocm_apex_tpu_torch.transformer import parallel_state

    d = parallel_state.get_data_parallel_rank()
    out["ranks"] = dict(data=d, tensor=parallel_state.
                        get_tensor_model_parallel_rank(),
                        info=parallel_state.get_rank_info(),
                        dp=parallel_state.get_data_parallel_world_size())
    out["refusals"] = []
    for kw in (dict(pipeline_model_parallel_size_=2),
               dict(virtual_pipeline_model_parallel_size_=2)):
        try:
            parallel_state.initialize_model_parallel(1, **kw)
        except NotImplementedError as e:
            out["refusals"].append(str(e))
    tokens, labels = _gpt_batch(inputs, d, 2)
    opt = MixedPrecisionAdam(LR, weight_decay=0.01, eps=DP_EPS,
                             compute_dtype=torch.float32)
    scaler = LossScaler("dynamic")
    model, state = train_state_from_jax_params(
        tree_of(inputs), gpt_config(2, **DP_GPT), opt, device="cpu")
    ddp = DistributedDataParallel()
    synced = {}

    def grad_sync(grads):
        synced.update(ddp(grads))
        return synced

    step = make_train_step(model, opt, scaler, grad_sync=grad_sync)
    sstate = scaler.init("cpu")
    scale = float(scaler.loss_scale(sstate))
    with _Counter() as c:
        state, sstate, loss = step(state, sstate, tokens, labels)
    out["loss"] = float(loss)
    out["grads"] = {k: v / scale for k, v in synced.items()}
    out["master"] = {k: v.clone() for k, v in state.master.items()}
    out["exchanges"] = dict(c)


SUITES = {"parallel": _parallel_suite, "subsets": _subsets_suite,
          "zero": _zero_suite, "dp_train": _dp_train_suite,
          "dp_tp": _dp_tp_suite}


def run(rank, n, workdir, suite, tp):
    """One rank: init the group (a file store under ``workdir``), lay out
    ``dp x tp``, bind ``"spatial"`` to the world, run ``suite``, write
    rank<r>.pt."""
    torch.set_num_threads(1)
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=n, timeout=TIMEOUT)
    from rocm_apex_tpu_torch.transformer import parallel_state

    try:
        parallel_state.initialize_model_parallel(tp)
        parallel_state.set_axis_group("spatial")
        inputs = np.load(os.path.join(workdir, "inputs.npz"))
        SUITES[suite](inputs, rank, out)
    except Exception:  # noqa: BLE001 - the test reports it
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    parallel_state.destroy_model_parallel()
    parallel_state.clear_axis_groups()
    dist.destroy_process_group()


def spawn(workdir, suite, inputs, n=2, tp=1, join_s=120):
    """Write ``inputs``, run ``suite`` on ``n`` spawned ranks (tensor
    parallel size ``tp``) and return their outputs; fails on a rank that
    hangs, dies or raised."""
    import multiprocessing

    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, n, str(workdir), suite, tp))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(join_s)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish in {join_s} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    outs = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]
    for r, o in enumerate(outs):
        assert "error" not in o, f"rank {r}:\n{o['error']}"
    return outs
