"""The port's data-parallel layer (`rocm_apex_tpu_torch.parallel`)
against the JAX package's (`rocm_apex_tpu.parallel`), on the CPU.

Two gloo ranks (spawned once for the module, `_torch_dp_ranks`'s
``"parallel"`` suite, 60 s timeouts) and four for the subsets
(``"subsets"``, ``axis_index_groups`` [[0, 1], [2, 3]]) run
`sync_gradients` in every mode, `DistributedDataParallel`, `Reducer`,
`broadcast_params`, `group_psum` and `SyncBatchNorm` (NHWC and NCHW:
output, running statistics, the gradients of sum(y * w) in the input,
scale and bias; ``fuse_relu``; evaluation on the running statistics; a
bf16 output; `convert_syncbn_model`) on per-rank numpy-drawn inputs. The
JAX side runs in ``shard_map`` over as many devices of the conftest's
host mesh; its gradients are those of the summed loss (`jax.grad`
outside the map), the port's parameter gradients each rank's share of
that sum. These mirror tests/L0/test_parallel.py:36-346. `larc` and
`LARC` run without ranks; `multiproc.main` starts a tiny gloo script.

Tolerance: fp32 within 1e-5 relative to each tensor's largest entry
(summation order: gloo's sum against XLA's psum, torch's mean against
XLA's), the bf16 outputs within one bf16 step (2^-7 of the largest
entry). The bucketed tree's leaves equal their one-leaf syncs bit for
bit, and the exchanges are counted: one a dtype bucket, one a SyncBN
forward and one its backward.
"""

import subprocess
import sys
import textwrap

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dp_ranks as R
from rocm_apex_tpu.parallel import (
    DistributedDataParallel as JaxDDP,
    Reducer as JaxReducer,
    SyncBatchNorm as JaxSyncBN,
    broadcast_params as jax_broadcast_params,
    larc as jax_larc,
    sync_gradients as jax_sync,
)
from rocm_apex_tpu.parallel.distributed import group_psum as jax_group_psum
from rocm_apex_tpu_torch.parallel import LARC, larc
from rocm_apex_tpu_torch.parallel import multiproc

RTOL = 1e-5
BF16_STEP = 2.0 ** -7


def _mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} simulated devices")
    return Mesh(np.array(devs[:n]), ("data",))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(g=draw(n, 8, 4), p=draw(n, 8, 3),
                bn_x=draw(n, 4, 6, 5, 4) * 2 + 0.5, bn_w=draw(n, 4, 6, 5, 4),
                bn_xc=draw(n, 4, 4, 3, 5) - 0.3, bn_wc=draw(n, 4, 4, 3, 5),
                bn_scale=1.0 + 0.3 * draw(8), bn_bias=0.2 * draw(8))


def _flat(a):
    """(n, k, ...) stacked per-rank arrays as the global (n * k, ...)."""
    return jnp.asarray(a.reshape((-1,) + a.shape[2:]))


def _per_rank(mesh, fn, *args, dtype=None):
    """``fn`` on each device's row of the stacked ``args`` (P("data")),
    its outputs stacked back."""
    def local(*xs):
        out = fn(*[x[0] if dtype is None else x[0].astype(dtype)
                   for x in xs])
        return jax.tree_util.tree_map(lambda t: t[None], out)

    return jax.jit(shard_map(local, mesh=mesh, in_specs=P("data"),
                             out_specs=P("data"), check_rep=False))(*args)


def _jax_sync(mesh, inputs, groups=None):
    g = jnp.asarray(inputs["g"])
    kw = dict(axis_index_groups=groups)
    want = dict(
        mean=_per_rank(mesh, lambda t: jax_sync({"w": t}, "data", **kw)["w"],
                       g),
        sum=_per_rank(mesh, lambda t: jax_sync(
            t, "data", gradient_average=False, **kw), g),
        predivide=_per_rank(mesh, lambda t: jax_sync(
            t, "data", gradient_predivide_factor=4.0, **kw), g),
        bf16=_per_rank(mesh, lambda t: jax_sync(t, "data", **kw), g,
                       dtype=jnp.bfloat16),
        bf16_fp32=_per_rank(mesh, lambda t: jax_sync(
            t, "data", allreduce_always_fp32=True, **kw), g,
            dtype=jnp.bfloat16),
        ddp=_per_rank(mesh, JaxDDP(allreduce_always_fp32=True,
                                   axis_index_groups=groups), g),
        reducer=_per_rank(mesh, JaxReducer(axis_index_groups=groups), g))
    if groups is None:
        want["bcast"] = _per_rank(mesh, lambda t: jax_broadcast_params(
            {"w": t})["w"], jnp.asarray(inputs["p"]))
    else:
        want["group_psum"] = _per_rank(
            mesh, lambda t: jax_group_psum(t, "data", groups), g)
    return {k: np.asarray(v, np.float32) for k, v in want.items()}


def _jax_bn(mesh, inputs, key, channel_last, groups=None, **kw):
    """JAX SyncBatchNorm over the global batch: y, the running
    statistics a rank, the gradients of the summed sum(y * w) in x,
    scale and bias, and y in evaluation on the new statistics."""
    x = _flat(inputs[f"bn_{key}"])
    w = _flat(inputs[f"bn_w{key[1:]}"])
    c = x.shape[-1] if channel_last else x.shape[1]
    bn = JaxSyncBN(channel_last=channel_last, axis_name="data",
                   axis_index_groups=groups, **kw)
    stats0 = bn.init(jax.random.PRNGKey(1), x[:2],
                     use_running_average=False)["batch_stats"]
    params = {"scale": jnp.asarray(inputs["bn_scale"][:c]),
              "bias": jnp.asarray(inputs["bn_bias"][:c])}

    def local(params, xs):
        y, upd = bn.apply({"params": params, "batch_stats": stats0}, xs,
                          use_running_average=False, mutable=["batch_stats"])
        stats = jax.tree_util.tree_map(lambda t: t[None], upd["batch_stats"])
        y_eval = bn.apply({"params": params, "batch_stats":
                           upd["batch_stats"]}, xs, use_running_average=True)
        return y, stats, y_eval

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P("data")),
                          out_specs=(P("data"), P("data"), P("data")),
                          check_rep=False))
    y, stats, y_eval = f(params, x)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(
        f(p, xx)[0].astype(jnp.float32) * w), argnums=(0, 1))(params, x)
    n = mesh.devices.size
    split = lambda a: np.asarray(a, np.float32).reshape(  # noqa: E731
        (n, -1) + a.shape[1:])
    return dict(y=split(y), y_eval=split(y_eval), dx=split(gx),
                dscale=np.asarray(gp["scale"]), dbias=np.asarray(gp["bias"]),
                mean=np.asarray(stats["mean"]), var=np.asarray(stats["var"]))


def _close(got, want, rtol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{err:.3e} of the scale {scale:.3e}"


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    inputs = _inputs(2, 0)
    mesh = _mesh(2)
    want = _jax_sync(mesh, inputs)
    for key, cl in (("x", True), ("xc", False)):
        want[f"bn_{key}"] = _jax_bn(mesh, inputs, key, cl)
    want["bn_relu"] = _jax_bn(mesh, inputs, "x", True, fuse_relu=True)["y"]
    want["bn_bf16"] = _jax_bn(mesh, inputs, "x", True,
                              dtype=jnp.bfloat16)["y"]
    want["convert"] = _jax_bn(mesh, inputs, "x", True, momentum=0.01)
    outs = R.spawn(tmp_path_factory.mktemp("parallel"), "parallel", inputs)
    return dict(inputs=inputs, want=want, outs=outs)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    inputs = _inputs(4, 1)
    mesh = _mesh(4)
    want = _jax_sync(mesh, inputs, R.SUBSETS)
    for key, cl in (("x", True), ("xc", False)):
        want[f"bn_{key}"] = _jax_bn(mesh, inputs, key, cl, R.SUBSETS)
    want["bn_relu"] = _jax_bn(mesh, inputs, "x", True, R.SUBSETS,
                              fuse_relu=True)["y"]
    outs = R.spawn(tmp_path_factory.mktemp("subsets"), "subsets", inputs,
                   n=4)
    return dict(inputs=inputs, want=want, outs=outs)


SYNC_MODES = ("mean", "sum", "predivide", "ddp", "reducer")


@pytest.mark.parametrize("mode", SYNC_MODES)
def test_sync_gradients_matches_jax(two, mode):
    """`sync_gradients` (mean, sum, predivide 4), the DDP wrapper (fp32
    allreduce) and `Reducer` on each rank against JAX's in shard_map."""
    for r, o in enumerate(two["outs"]):
        _close(o[mode], two["want"][mode][r])
    assert torch.equal(two["outs"][0][mode], two["outs"][1][mode])


@pytest.mark.parametrize("mode", ("bf16", "bf16_fp32"))
def test_sync_gradients_bf16_matches_jax(two, mode):
    """A bf16 tree summed in bf16, or in fp32 with one rounding back
    (``allreduce_always_fp32``): bf16 out, within one bf16 step of
    JAX's."""
    for r, o in enumerate(two["outs"]):
        assert o[mode].dtype == torch.bfloat16
        _close(o[mode], two["want"][mode][r], BF16_STEP)


def test_broadcast_params_restores_agreement(two):
    """Drifted replicas end bit-equal, at JAX's mean."""
    a, b = (o["bcast"] for o in two["outs"])
    assert torch.equal(a, b)
    _close(a, two["want"]["bcast"][0])


def test_int_leaves_pass_through(two):
    for r, o in enumerate(two["outs"]):
        assert torch.equal(o["int"], torch.arange(8, dtype=torch.int32) + r)


@pytest.mark.parametrize("fp32", (False, True))
def test_one_exchange_a_dtype_bucket(two, fp32):
    """A tree of fp32 and bf16 leaves, an int and a None: one exchange a
    payload dtype (two, or one under ``allreduce_always_fp32``), each
    leaf bit-equal to its own sync, the int and the None through."""
    for r, o in enumerate(two["outs"]):
        got = o[f"tree_fp32_{fp32}"]
        assert got["exchanges"] == {"all_reduce": 1 if fp32 else 2}
        assert torch.equal(got["res"]["a"], o["mean"])
        assert torch.equal(got["res"]["c"], o["mean"][:2])
        assert torch.equal(got["res"]["b"],
                           o["bf16_fp32" if fp32 else "bf16"])
        assert torch.equal(got["res"]["step"],
                           torch.arange(8, dtype=torch.int32) + r)
        assert set(got["res"]) == {"a", "b", "c", "step"}


def _bn_checks(outs, want, key):
    for r, o in enumerate(outs):
        got = o[f"bn_{'nhwc' if key == 'x' else 'nchw'}"]
        _close(got["y"], want["y"][r])
        _close(got["grads"][0], want["dx"][r])
        _close(got["mean"], want["mean"][r])
        _close(got["var"], want["var"][r])
    for i, name in ((1, "dscale"), (2, "dbias")):
        _close(sum(o[f"bn_{'nhwc' if key == 'x' else 'nchw'}"]["grads"][i]
                   for o in outs), want[name])


@pytest.mark.parametrize("key", ("x", "xc"))
def test_sync_batchnorm_matches_jax(two, key):
    """NHWC and NCHW: each rank's output, running statistics (torch's
    momentum, the unbiased variance) and input gradient against JAX's
    over the global batch; the ranks' scale and bias gradients sum to
    JAX's; one exchange forward and one backward."""
    _bn_checks(two["outs"], two["want"][f"bn_{key}"], key)
    for o in two["outs"]:
        assert o["bn_nhwc"]["exchanges"] == {"all_reduce": 2}


def test_sync_batchnorm_gradients_are_full_batch_bn(two):
    """The input gradient equals plain BN's over the concatenated batch
    (tests/L0/test_parallel.py:247), not a rank-local BN's."""
    x = np.concatenate(two["inputs"]["bn_x"])
    w = np.concatenate(two["inputs"]["bn_w"])
    c = x.shape[-1]
    xt = torch.from_numpy(x).requires_grad_(True)
    mean = xt.mean((0, 1, 2))
    var = ((xt - mean) ** 2).mean((0, 1, 2))
    y = (xt - mean) * torch.rsqrt(var + 1e-5)
    y = y * torch.from_numpy(two["inputs"]["bn_scale"][:c]) + \
        torch.from_numpy(two["inputs"]["bn_bias"][:c])
    (gx,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [xt])
    got = torch.cat([o["bn_nhwc"]["grads"][0] for o in two["outs"]])
    _close(got, gx.numpy())


def test_sync_batchnorm_fuse_relu_eval_and_bf16(two):
    """``fuse_relu`` (>= 0, JAX's values), evaluation on the updated
    running statistics, and a bf16 output within one bf16 step."""
    for r, o in enumerate(two["outs"]):
        assert (o["bn_relu"] >= 0).all()
        _close(o["bn_relu"], two["want"]["bn_relu"][r])
        _close(o["bn_eval"], two["want"]["bn_x"]["y_eval"][r])
        assert o["bn_bf16"].dtype == torch.bfloat16
        _close(o["bn_bf16"], two["want"]["bn_bf16"][r], BF16_STEP)


def test_convert_syncbn_model(two):
    """A port BatchNorm (flax momentum 0.99) becomes a channel-last
    SyncBatchNorm of torch momentum 0.01 with its scale, and computes
    JAX's SyncBatchNorm(momentum=0.01) over the global batch."""
    want = two["want"]["convert"]
    inputs = two["inputs"]
    for r, o in enumerate(two["outs"]):
        got = o["convert"]
        assert got["is_sync"] and got["channel_last"]
        assert abs(got["momentum"] - 0.01) < 1e-9
        # the converted module keeps bias 0 (the BatchNorm's), JAX's run
        # has the drawn bias: compare around it
        bias = inputs["bn_bias"][:4]
        _close(got["y"], want["y"][r] - bias)
        _close(got["mean"], want["mean"][r])
        _close(got["var"], want["var"][r])


@pytest.mark.parametrize("mode", SYNC_MODES + ("bf16", "bf16_fp32"))
def test_sync_gradients_subsets_match_jax(four, mode):
    """Within ``axis_index_groups`` [[0, 1], [2, 3]] on four ranks: each
    subset's mean (sum, predivide, bf16, DDP, Reducer) against JAX's
    `group_psum` form."""
    for r, o in enumerate(four["outs"]):
        _close(o[mode], four["want"][mode][r],
               BF16_STEP if mode.startswith("bf16") else RTOL)
    assert torch.equal(four["outs"][0][mode], four["outs"][1][mode])
    assert torch.equal(four["outs"][2][mode], four["outs"][3][mode])
    assert not torch.equal(four["outs"][0][mode], four["outs"][2][mode])


def test_group_psum_matches_jax(four):
    for r, o in enumerate(four["outs"]):
        _close(o["group_psum"], four["want"]["group_psum"][r])


@pytest.mark.parametrize("key", ("x", "xc"))
def test_sync_batchnorm_subsets_match_jax(four, key):
    """Two subsets of two ranks normalize independently (reference
    tests/distributed/synced_batchnorm/test_groups.py): outputs,
    statistics and gradients against JAX's."""
    _bn_checks(four["outs"], four["want"][f"bn_{key}"], key)
    for r, o in enumerate(four["outs"]):
        _close(o["bn_relu"], four["want"]["bn_relu"][r])


def test_larc_clip_mode_matches_jax():
    """The rewrite at clip mode (LARC.py:69-107), a zero-gradient leaf
    through unchanged."""
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32),
         "z": rng.standard_normal(3).astype(np.float32)}
    g = {"w": 0.1 * rng.standard_normal((6, 5)).astype(np.float32),
         "b": 3.0 * rng.standard_normal(5).astype(np.float32),
         "z": np.zeros(3, np.float32)}
    for kw in (dict(lr=0.1, trust_coefficient=0.02),
               dict(trust_coefficient=0.02, clip=False, weight_decay=0.01),
               dict(lr=0.5, trust_coefficient=0.5, weight_decay=0.1)):
        jtx = jax_larc(**kw)
        want, _ = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                             jtx.init(p), jax.tree_util.tree_map(
                                 jnp.asarray, p))
        tx = larc(**kw)
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        got, _ = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                           tx.init(tp), tp)
        for k in p:
            _close(got[k], want[k], 1e-6)
        assert torch.equal(got["z"], torch.zeros(3))


def test_larc_manual_formula_and_bf16():
    """||p|| 5, ||g|| 1: the clip and scale modes' closed forms; a bf16
    gradient comes back bf16."""
    p = {"w": torch.tensor([3.0, 4.0])}
    g = {"w": torch.tensor([0.6, 0.8])}
    out, _ = larc(lr=0.1, trust_coefficient=0.02).update(g, (), p)
    torch.testing.assert_close(out["w"], g["w"] * min(0.02 * 5.0 / (1.0 +
                                                      1e-8) / 0.1, 1.0))
    out, _ = larc(trust_coefficient=0.02, clip=False,
                  weight_decay=0.01).update(g, (), p)
    torch.testing.assert_close(
        out["w"], (g["w"] + 0.01 * p["w"]) * 0.02 * 5.0 / (1.0 + 0.05 + 1e-8))
    out, _ = larc().update({"w": g["w"].bfloat16()}, (), p)
    assert out["w"].dtype == torch.bfloat16


def test_larc_class_wrapper_matches_jax():
    """`LARC(inner, lr=)` rewrites, then delegates (an SGD transform on
    both sides); clip mode without a readable LR is refused."""
    from rocm_apex_tpu_torch.optimizers import FusedSGD

    p = {"w": np.array([3.0, 4.0, -1.0], np.float32)}
    g = {"w": np.array([0.6, 0.8, 0.1], np.float32)}
    from rocm_apex_tpu.parallel import LARC as JaxLARC

    jopt = JaxLARC(optax.sgd(0.1), trust_coefficient=0.02, lr=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                          jopt.init(jp), jp)
    opt = LARC(FusedSGD(0.1), trust_coefficient=0.02, lr=0.1)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, _ = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                        opt.init(tp), tp)
    _close(got["w"], want["w"], 1e-6)
    with pytest.raises(ValueError, match="clip mode"):
        LARC(FusedSGD(0.1))


SCRIPT = textwrap.dedent('''
    import os, sys
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    with open(os.path.join(sys.argv[1], f"rank{rank}"), "w") as f:
        f.write(f"{os.environ['LOCAL_RANK']} {dist.get_world_size()} "
                f"{t.item()}")
    dist.destroy_process_group()
    sys.exit(3 if len(sys.argv) > 2 and rank == 1 else 0)
''')


def test_multiproc_starts_one_process_a_rank(tmp_path):
    """`multiproc.main` runs ``--nproc`` copies with the rendezvous
    environment (each joins one gloo group: the all-reduce sees both),
    and returns the first non-zero exit code."""
    script = tmp_path / "job.py"
    script.write_text(SCRIPT)
    assert multiproc.main(["--nproc", "2", str(script), str(tmp_path)]) == 0
    for r in range(2):
        assert (tmp_path / f"rank{r}").read_text() == f"{r} 2 3.0"
    assert multiproc.main(["--nproc", "2", str(script), str(tmp_path),
                           "fail"]) == 3


def test_multiproc_as_a_module(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(SCRIPT)
    res = subprocess.run([sys.executable, "-m",
                          "rocm_apex_tpu_torch.parallel.multiproc",
                          "--nproc", "2", str(script), str(tmp_path)],
                         timeout=120)
    assert res.returncode == 0
    assert (tmp_path / "rank1").read_text() == "1 2 3.0"


def test_flax_batchnorm_is_not_a_port_module():
    """`convert_syncbn_model` rewrites the port's BatchNorm only (a
    torch module tree); JAX's rewrites flax's (kept as JAX has it)."""
    from rocm_apex_tpu.parallel import convert_syncbn_model as jconv
    from rocm_apex_tpu_torch.parallel import convert_syncbn_model

    class Net(fnn.Module):
        bn: fnn.Module = fnn.BatchNorm(use_running_average=False)

        @fnn.compact
        def __call__(self, x):
            return self.bn(x)

    assert isinstance(jconv(Net(), axis_name=None).bn, JaxSyncBN)
    lin = torch.nn.Linear(2, 2)
    assert convert_syncbn_model(lin) is lin
