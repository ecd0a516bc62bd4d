"""The data-parallel slice as a whole against the JAX package, on the
CPU: the ZeRO GPT step, the dp x tp DDP GPT step, the ResNet under
SyncBatchNorm and the spatially partitioned bottleneck.

Gloo ranks (`_torch_dp_ranks`, suites ``"dp_train"`` on two ranks and
``"dp_tp"`` on four, each spawned once for the module, 60 s timeouts):

* `train.make_zero_train_step` with `DistributedFusedAdam(1e-2, wd 0.01,
  eps 1e-4, allgather fp32)` at fp32 and int8 comm, three steps of the
  tiny fp32 GPT (2 layers, hidden 64, 4 heads, vocab 96, dropout 0) on
  each rank's half of a B 4 x S 16 batch, against bench.py's
  ``--dist-opt`` step
  (bench.py:2360-2420: ``value_and_grad``, ``dist.update``,
  ``optax.apply_updates``) in ``shard_map`` over two devices: each
  rank's losses and the replicated params;
* `train.make_train_step(grad_sync=DistributedDataParallel())` at dp=2 x
  tp=2 on four ranks (__graft_entry__.py part A's data side): the layout
  (data rank r // 2, tensor rank r % 2), the data ranks' mean loss and
  the synced gradients (gathered over the tensor ranks) against JAX's
  tp=1 step on the whole batch, and the two data replicas' synced
  gradients and masters bit-equal;
* `resnet_tiny(sync_bn_axis="data")` under `make_rn50_train_step(grad_sync=
  sync_gradients)`: two O0 steps (fp32) against JAX's in ``shard_map``
  (losses, params, running statistics; the statistics bit-equal on both
  ranks), the exchanges of a step (one a SyncBatchNorm forward and
  backward, one a gradient bucket); one O5 step (bf16), finite, the ranks
  bit-equal, its loss within a bf16 forward of JAX's fp32 one;
* `SpatialBottleneck` H-sharded over two ranks (`halo_exchange`'s rows;
  evaluation against JAX's unsharded `Bottleneck`, tests/L0/
  test_contrib.py:304; training with SyncBatchNorm over the spatial axis
  against JAX's `SpatialBottleneck` there and against the port's
  unsharded `Bottleneck` on the gathered input, output and every
  gradient).

Tolerance: fp32 1e-5 relative to each tensor's largest entry; the ZeRO
GPT's params after three steps of Adam at eps 1e-4 (``R.DP_EPS``: the
key bias's gradient is fp32 noise, as in tests/test_torch_train_tp.py)
within 1e-5 of their value plus 1e-2 of the leaf's largest step (the
optimizer parity rule: Adam's normalized step moves a near-zero
gradient element by a share of lr), int8 comm within `INT8_TWIN_FACTOR` times
the int8 wire's own effect, its losses 1e-4; the ResNet's optimizer at
eps 1e-3 (tests/test_torch_amp_rn50.py's `BENCH_EPS`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dp_ranks as R
from rocm_apex_tpu import amp as jamp
from rocm_apex_tpu.contrib.bottleneck import (
    Bottleneck as JaxBottleneck,
    SpatialBottleneck as JaxSpatial,
)
from rocm_apex_tpu.contrib.optimizers import distributed_fused_adam
from rocm_apex_tpu.models import resnet as jr
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from rocm_apex_tpu.parallel import sync_gradients as jax_sync
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    gather_tp_params,
    random_params,
)

from _torch_tp_ranks import GPT_SHAPE, gpt_config

RTOL = 1e-5
# the optimizer parity rule (ROADMAP "Parity rules", chip_smoke.py
# `_param_err`): within 1e-5 of |param| plus OPTIM_STEP_SHARE of the
# largest step the reference took on that leaf
OPTIM_STEP_SHARE = 1e-2
# int8 comm, port against JAX: a gradient or delta element whose fp32
# value lies within the two sides' rounding of a half step rounds to
# neighbouring int8 values and moves what follows it, as chip_smoke.py's
# int8 twin (phase train_tp) found on the card; held to this many times
# the int8 wire's own effect (JAX's int8 run against its fp32 run),
# losses to 1e-4
INT8_TWIN_FACTOR = 4.0
RX_SHAPE = (2, 16, 16, 3)  # a rank's images


def _mesh(name="data", n=2):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} simulated devices")
    return Mesh(np.array(devs[:n]), (name,))


def _draw(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _perturb(tree, rng, scale, positive=False):
    def one(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        d = _draw(rng, *a.shape, scale=scale)
        return a + (np.abs(d) if positive else d)

    return jax.tree_util.tree_map(one, tree)


def _prefixed(prefix, tree):
    return {prefix + k: np.asarray(v) for k, v in flatten_params(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_gpt_cfg():
    return JaxGPTConfig(**{**GPT_SHAPE, **R.DP_GPT}, tensor_parallel_size=1,
                        hidden_dropout=0.0, attention_dropout=0.0,
                        params_dtype=jnp.float32, dtype=jnp.float32)


def _inputs():
    rng = np.random.default_rng(0)
    tree = random_params(gpt_config(1, **R.DP_GPT, init_method_std=0.3),
                         seed=2)
    inputs = _prefixed("p.", tree["params"])
    vocab = GPT_SHAPE["vocab_size"]
    inputs.update(tokens=rng.integers(0, vocab, (R.DP_BATCH, R.DP_SEQ)),
                  labels=rng.integers(0, vocab, (R.DP_BATCH, R.DP_SEQ)))
    # the tiny ResNet under SyncBatchNorm, perturbed BN leaves
    jres = jr.resnet_tiny(sync_bn_axis="data", num_classes=10,
                          dtype=jnp.float32)
    rx = _draw(rng, 2, *RX_SHAPE)
    vs = jres.init(jax.random.PRNGKey(1), jnp.asarray(rx[0]))
    rparams = _perturb(vs["params"], rng, 0.1)
    rstats = _perturb(vs["batch_stats"], rng, 0.1, positive=True)
    inputs.update(_prefixed("rp.", rparams))
    inputs.update(_prefixed("rs.", rstats))
    inputs.update(rx=rx, ry=rng.integers(0, 10, (2, RX_SHAPE[0])))
    # the bottleneck: 16 -> 8 -> 32, H 16 split 8 + 8
    sp = R.SPATIAL
    sx = _draw(rng, 2, 16, 8, sp["cin"])
    dense = JaxBottleneck(sp["cin"], sp["cmid"], sp["cout"])
    svs = dense.init(jax.random.PRNGKey(3), jnp.asarray(sx), train=False)
    sparams = _perturb(svs["params"], rng, 0.1)
    sstats = _perturb(svs["batch_stats"], rng, 0.1, positive=True)
    inputs.update(_prefixed("sp.", sparams))
    inputs.update(_prefixed("ss.", sstats))
    inputs.update(sx=sx, sw=_draw(rng, 2, 16, 8, sp["cout"]))
    return tree, inputs, dict(rparams=rparams, rstats=rstats,
                              sparams=sparams, sstats=sstats)


def _jax_zero_gpt(tree, inputs, comm):
    """bench.py's --dist-opt step, three times, in shard_map over two
    devices: each rank's losses, the replicated params."""
    mesh = _mesh()
    model = JaxGPTModel(_jax_gpt_cfg())
    dist = distributed_fused_adam(R.LR, weight_decay=0.01, eps=R.DP_EPS,
                                  allgather_dtype="fp32", axis_name="data",
                                  comm_dtype=comm)

    def local(params, tok, lab):
        state = dist.init(params)
        losses = []
        for _ in range(R.DP_STEPS):
            loss, grads = jax.value_and_grad(lambda p: model.apply(
                p, tok, labels=lab, loss_reduction="mean"))(params)
            updates, state = dist.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            losses.append(loss)
        return jnp.stack(losses)[None], params

    losses, params = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P("data"), P("data")),
        out_specs=(P("data"), P()), check_rep=False))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["labels"]))
    return np.asarray(losses), flatten_params(
        jax.tree_util.tree_map(np.asarray, params["params"]))


def _jax_tp1_step(tree, inputs):
    model = JaxGPTModel(_jax_gpt_cfg())
    loss, grads = jax.value_and_grad(lambda p: model.apply(
        p, jnp.asarray(inputs["tokens"]), labels=jnp.asarray(inputs["labels"]),
        loss_reduction="mean"))(jax.tree_util.tree_map(jnp.asarray, tree))
    return float(loss), flatten_params(jax.tree_util.tree_map(
        np.asarray, grads["params"]))


def _jax_resnet(ref, inputs):
    """bench.py's rn50 one_step at O0 with the gradients averaged over
    the data axis, twice, in shard_map: losses a rank, params, stats."""
    mesh = _mesh()
    jm = jr.resnet_tiny(sync_bn_axis="data", num_classes=10,
                        dtype=jnp.float32)
    opt0 = JaxFusedAdam(R.RN50_LR, weight_decay=1e-4, eps=R.RN50_EPS)

    def local(params, stats, x, y):
        params, opt, st = jamp.initialize(params, opt0, opt_level="O0",
                                          verbosity=0)
        opt_state = opt.init(params)
        losses = []
        for _ in range(2):
            def loss_fn(p, stats=stats):
                logits, mut = jm.apply({"params": p, "batch_stats": stats},
                                       x[0], mutable=["batch_stats"])
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits.astype(jnp.float32), y[0]).mean()
                return jamp.scale_loss(ce, st), (mut["batch_stats"], ce)

            (_, (stats, ce)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            grads = jax_sync(grads, "data")
            grads, found_inf = jamp.unscale_grads(grads, st)
            st, skip = jamp.update_scale(st, found_inf)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            losses.append(ce)
        return jnp.stack(losses)[None], params, stats

    losses, params, stats = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
        out_specs=(P("data"), P(), P()), check_rep=False))(
        ref["rparams"], ref["rstats"], jnp.asarray(inputs["rx"]),
        jnp.asarray(inputs["ry"]))
    return (np.asarray(losses), _prefixed("", params),
            _prefixed("", stats))


def _jax_spatial(ref, inputs):
    """The unsharded block in evaluation; the H-sharded block in training
    with SyncBatchNorm over "spatial" (y, and the input gradient of the
    summed sum(y * w))."""
    sp = R.SPATIAL
    x = jnp.asarray(inputs["sx"])
    w = jnp.asarray(inputs["sw"])
    variables = {"params": ref["sparams"], "batch_stats": ref["sstats"]}
    dense = JaxBottleneck(sp["cin"], sp["cmid"], sp["cout"])
    y_eval = dense.apply(variables, x, train=False)
    spatial = JaxSpatial(sp["cin"], sp["cmid"], sp["cout"],
                         spatial_axis="spatial", sync_bn_axis="spatial")
    mesh = _mesh("spatial")

    def local(xs):
        y, _ = spatial.apply(variables, xs, train=True,
                             mutable=["batch_stats"])
        return y

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=P(None, "spatial"),
                          out_specs=P(None, "spatial"), check_rep=False))
    y = f(x)
    dx = jax.grad(lambda xx: jnp.sum(f(xx) * w))(x)
    return dict(y_eval=np.asarray(y_eval), y=np.asarray(y),
                dx=np.asarray(dx))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tree, inputs, ref = _inputs()
    want = {f"zero_gpt_{c}": _jax_zero_gpt(tree, inputs, c)
            for c in R.DP_COMMS}
    want["tp1"] = _jax_tp1_step(tree, inputs)
    want["resnet"] = _jax_resnet(ref, inputs)
    want["spatial"] = _jax_spatial(ref, inputs)
    outs = R.spawn(tmp_path_factory.mktemp("dp_train"), "dp_train", inputs)
    outs4 = R.spawn(tmp_path_factory.mktemp("dp_tp"), "dp_tp", inputs, n=4,
                    tp=2)
    return dict(tree=tree, inputs=inputs, want=want, outs=outs, outs4=outs4)


def _close(got, want, rtol=RTOL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3e} of the scale {scale:.3e}"


@pytest.mark.parametrize("comm", R.DP_COMMS)
def test_zero_gpt_step_matches_bench_dist_opt(run, comm):
    """Each rank's three losses against JAX's, the params replicated bit
    for bit and against JAX's; one reduce-scatter and one all-gather a
    step at fp32 comm, two ring hops at int8 (the model's one fp32
    group)."""
    jl, jp = run["want"][f"zero_gpt_{comm}"]
    outs = [o[f"zero_gpt_{comm}"] for o in run["outs"]]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["losses"], jl[r],
                                   rtol=RTOL if comm == "fp32" else 1e-4)
        want_ex = ({"shift": 2} if comm == "int8" else
                   {"reduce_scatter": 1, "all_gather": 1})
        assert o["exchanges"] == [want_ex] * R.DP_STEPS
    assert outs[0]["losses"] != outs[1]["losses"]
    for k in jp:
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k
    if comm == "fp32":
        p0 = flatten_params(run["tree"]["params"])
        for k, v in jp.items():
            step = float(np.abs(v - p0[k]).max())
            np.testing.assert_allclose(
                outs[0]["params"][k].numpy(), v, rtol=RTOL,
                atol=OPTIM_STEP_SHARE * step, err_msg=k)
        return
    _, jp32 = run["want"]["zero_gpt_fp32"]
    wire = max(float(np.abs(jp[k] - jp32[k]).max()) for k in jp)
    worst = max(float(np.abs(outs[0]["params"][k].numpy() - jp[k]).max())
                for k in jp)
    assert 0.0 < wire and worst <= INT8_TWIN_FACTOR * wire, (worst, wire)


def test_dp_by_tp_layout(run):
    """World 4 at tp=2: global rank d * 2 + t, each data group two ranks
    apart (JAX's mesh with the tensor axis innermost)."""
    for r, o in enumerate(run["outs4"]):
        assert o["ranks"]["data"] == r // 2
        assert o["ranks"]["tensor"] == r % 2
        assert o["ranks"]["dp"] == 2
        assert o["ranks"]["info"] == f"tp2-pp1-dp2-proc{r}"


def test_pipeline_parallelism_is_refused_naming_its_half(run):
    """pp > 1 and virtual pipelining still raise, naming ROADMAP Queue 1
    item 10, part 10d's pipeline half (the data half is this slice)."""
    for o in run["outs4"]:
        assert len(o["refusals"]) == 2
        for msg in o["refusals"]:
            assert "part 10d, its pipeline half" in msg, msg


def test_dp_by_tp_step_matches_tp1_replay(run):
    """__graft_entry__.py part A's data side: the data ranks' mean loss
    and the gradients averaged over the data axis, gathered over the
    tensor ranks, against JAX's tp=1 step on the whole batch."""
    jloss, jgrads = run["want"]["tp1"]
    outs = run["outs4"]
    np.testing.assert_allclose((outs[0]["loss"] + outs[2]["loss"]) / 2,
                               jloss, rtol=RTOL)
    for d in (0, 1):
        full = gather_tp_params(gpt_config(2, **R.DP_GPT),
                                [outs[2 * d]["grads"],
                                 outs[2 * d + 1]["grads"]])
        assert set(full) == set(jgrads)
        for k, v in jgrads.items():
            _close(full[k], v, what=k)


def test_dp_by_tp_data_replicas_agree(run):
    """After the step each tensor rank's two data replicas hold the same
    synced gradients and masters bit for bit; the per-rank losses of the
    two data ranks differ (their own batches)."""
    outs = run["outs4"]
    for t in (0, 1):
        a, b = outs[t], outs[2 + t]
        for k in a["grads"]:
            assert torch.equal(a["grads"][k], b["grads"][k]), k
            assert torch.equal(a["master"][k], b["master"][k]), k
    assert outs[0]["loss"] != outs[2]["loss"]


def test_resnet_sync_bn_o0_steps_match_jax(run):
    """Two O0 steps: each rank's losses, the params and the running
    statistics against JAX's; the statistics bit-equal on both ranks; a
    step's exchanges: one a SyncBatchNorm forward and backward (six
    norms) and one gradient bucket."""
    jl, jp, js = run["want"]["resnet"]
    outs = [o["resnet_O0"] for o in run["outs"]]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["losses"], jl[r], rtol=RTOL)
        assert o["exchanges"] == {"all_reduce": 2 * (2 * 6 + 1)}
    for k, v in js.items():
        assert torch.equal(outs[0]["stats"][k], outs[1]["stats"][k]), k
        np.testing.assert_allclose(outs[0]["stats"][k].numpy(), v,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in jp.items():
        got = outs[0]["params"][k]
        if got.dim() == 4:
            got = got.permute(2, 3, 1, 0)  # OIHW -> HWIO
        elif k == "fc.kernel":
            got = got.t()
        np.testing.assert_allclose(got.numpy(), v, err_msg=k, rtol=1e-5,
                                   atol=2e-6)
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k]), k


def test_resnet_sync_bn_o5_step(run):
    """One O5 step in bf16: finite, both ranks' params and statistics bit
    for bit, two gradient buckets (bf16 convs, fp32 norms and head), the
    loss within a bf16 forward (2e-2) of JAX's fp32 first loss."""
    jl = run["want"]["resnet"][0]
    outs = [o["resnet_O5"] for o in run["outs"]]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["losses"][0], jl[r][0], rtol=2e-2)
        assert o["exchanges"] == {"all_reduce": 2 * 6 + 2}
    for k, v in outs[0]["params"].items():
        assert torch.isfinite(v).all(), k
        assert torch.equal(v, outs[1]["params"][k]), k
    for k, v in outs[0]["stats"].items():
        assert torch.equal(v, outs[1]["stats"][k]), k


def test_halo_exchange_rows(run):
    """Each rank's rows with its neighbour's boundary row either side,
    zero rows at the edges."""
    x = torch.from_numpy(run["inputs"]["sx"])
    a, b = (o["halo"] for o in run["outs"])
    assert torch.equal(a, torch.cat([torch.zeros_like(x[:, :1]), x[:, :9]],
                                    1))
    assert torch.equal(b, torch.cat([x[:, 7:], torch.zeros_like(x[:, :1])],
                                    1))


def test_spatial_bottleneck_eval_matches_unsharded_jax(run):
    """Evaluation on the running statistics: each rank's rows equal JAX's
    unsharded block's (tests/L0/test_contrib.py:304) and the port's."""
    want = run["want"]["spatial"]["y_eval"]
    for r, o in enumerate(run["outs"]):
        res = o["spatial"]["eval"]
        _close(res["y"], want[:, 8 * r:8 * (r + 1)])
        _close(res["y"], res["dense_y"])


def test_spatial_bottleneck_training_matches(run):
    """Training with SyncBatchNorm over the spatial axis: each rank's
    rows and input gradient against JAX's SpatialBottleneck and the
    port's unsharded block; the ranks' parameter gradients sum to the
    unsharded block's."""
    want = run["want"]["spatial"]
    outs = [o["spatial"]["train"] for o in run["outs"]]
    for r, res in enumerate(outs):
        _close(res["y"], want["y"][:, 8 * r:8 * (r + 1)])
        _close(res["dx"], want["dx"][:, 8 * r:8 * (r + 1)])
        _close(res["y"], res["dense_y"], 1e-4)
        _close(res["dx"], res["dense_dx"], 1e-4)
    for k, g in outs[0]["dense_dparams"].items():
        _close(outs[0]["dparams"][k] + outs[1]["dparams"][k], g, 1e-4,
               what=k)
