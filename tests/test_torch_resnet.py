"""The port's ResNet (`models.resnet`) against the JAX package's flax
ResNet, on the CPU.

Each configuration is built on both sides from the same variables (the
flax init, its BN scales and biases and running statistics perturbed from
1 and 0 by numpy draws) carried over by `convert.resnet_from_jax_variables`;
the fused blocks run the JAX kernels in interpret mode and the port's
plain versions. Checked: the logits of a training-mode forward, the
running statistics it leaves, every parameter's gradient of sum(logits *
c) for a numpy-drawn c, and the eval-mode logits on the updated
statistics. fp32 throughout; the two differ in summation order: logits
rtol 1e-5 (atol 1e-5), running statistics rtol 1e-5 (atol 1e-6),
gradients within 1e-4 of each leaf's largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.models import resnet as jr
from rocm_apex_tpu_torch.convert import flatten_params, resnet_from_jax_variables
from rocm_apex_tpu_torch.models import resnet as tr
from rocm_apex_tpu_torch.models._layers import Conv

X_SHAPE = (2, 32, 32, 3)
CLASSES = 10


def _draw(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _configs():
    bneck = dict(stage_sizes=(2, 2), block_name="Bottleneck", num_filters=8)
    return {
        # layer1_0 fused with a downsample, layer1_1 fused without,
        # layer2_0 stride 2 (unfused), layer2_1 fused
        "bottleneck_fused": dict(bneck, fused=True),
        "bottleneck_unfused": dict(bneck, fused=False),
        "tiny_basic": dict(stage_sizes=(1, 1), block_name="BasicBlock",
                           num_filters=8),
        "tiny_basic_fold": dict(stage_sizes=(1, 1), block_name="BasicBlock",
                                num_filters=8, fold_downsample=True),
        "bottleneck_fold": dict(bneck, fold_downsample=True),
        # SyncBatchNorm with no process group bound: each side's local
        # statistics; fused and the fold are off under it, as in JAX
        "tiny_basic_sync": dict(stage_sizes=(1, 1), block_name="BasicBlock",
                                num_filters=8, sync_bn_axis="data"),
        "bottleneck_sync": dict(bneck, fused=True, fold_downsample=True,
                                sync_bn_axis="data"),
    }


def _perturb(tree, seed, scale):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = [np.asarray(a) + _draw(np.shape(a), seed + i, scale)
           if a.ndim == 1 else np.asarray(a) for i, a in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, out)


def _jax_layout(model, name, t):
    owner, _, leaf = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    if isinstance(mod, Conv) and leaf == "kernel":
        return t.permute(2, 3, 1, 0)
    if owner == "fc" and leaf == "kernel":
        return t.t()
    return t


@pytest.fixture(scope="module", params=list(_configs()))
def case(request):
    cfg = dict(_configs()[request.param])
    block = cfg.pop("block_name")
    jmodel = jr.ResNet(block=getattr(jr, block), num_classes=CLASSES,
                       dtype=jnp.float32, **cfg)
    x = _draw(X_SHAPE, 0)
    vs = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = _perturb(vs["params"], 100, 0.1)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.abs(_draw(a.shape, 7, 0.1)),
        vs["batch_stats"])
    cot = _draw((X_SHAPE[0], CLASSES), 3)

    def loss(p):
        logits, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(logits * cot), (logits, mut["batch_stats"])

    (_, (logits, new_stats)), grads = jax.value_and_grad(
        loss, has_aux=True)(params)
    eval_logits = jmodel.apply({"params": params, "batch_stats": new_stats},
                               jnp.asarray(x), train=False)

    tmodel = tr.ResNet(block=getattr(tr, block), num_classes=CLASSES,
                       dtype=torch.float32, device="cpu", **cfg)
    resnet_from_jax_variables(params, stats, tmodel)
    tx = torch.from_numpy(x)
    tlogits = tmodel(tx, train=True)
    (tlogits * torch.from_numpy(cot)).sum().backward()
    with torch.no_grad():
        teval = tmodel(tx, train=False)
    return dict(jax=dict(logits=logits, stats=new_stats, grads=grads,
                         eval=eval_logits),
                port=dict(model=tmodel, logits=tlogits, eval=teval))


def test_logits(case):
    np.testing.assert_allclose(case["port"]["logits"].detach().numpy(),
                               np.asarray(case["jax"]["logits"]),
                               rtol=1e-5, atol=1e-5)


def test_running_stats(case):
    model = case["port"]["model"]
    bufs = dict(model.named_buffers())
    ref = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                case["jax"]["stats"]))
    assert set(bufs) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(bufs[k].numpy(), v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_gradients(case):
    model = case["port"]["model"]
    ref = flatten_params(jax.tree_util.tree_map(np.asarray,
                                                case["jax"]["grads"]))
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for k, g in ref.items():
        got = _jax_layout(model, k, named[k].grad).numpy()
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(got, g, rtol=0.0, atol=1e-4 * scale,
                                   err_msg=k)


def test_eval_logits(case):
    np.testing.assert_allclose(case["port"]["eval"].numpy(),
                               np.asarray(case["jax"]["eval"]),
                               rtol=1e-5, atol=1e-5)


def test_fused_layout():
    """Stride-1 Bottleneck blocks fuse, the stride-2 one stays unfused."""
    model = tr.ResNet(stage_sizes=(2, 2), block=tr.Bottleneck,
                      num_filters=8, num_classes=CLASSES, fused=True,
                      device="cpu")
    names = dict(model.named_parameters())
    assert "layer1_0.conv1_kernel" in names
    assert "layer1_0.downsample_kernel" in names
    assert "layer1_1.conv1_kernel" in names
    assert "layer1_1.downsample_kernel" not in names
    assert "layer2_0.conv1.kernel" in names
    assert "layer2_1.conv1_kernel" in names
    basic = tr.ResNet(stage_sizes=(1, 1), block=tr.BasicBlock,
                      num_filters=8, fused=True, device="cpu")
    assert not basic.fused


def test_sync_bn_refused():
    """``sync_bn_axis`` was refused until SyncBatchNorm was ported; it now
    builds every norm as `parallel.SyncBatchNorm` (torch momentum 0.1,
    channel-last, over the named axis) with ``fused`` and the fold off,
    as JAX's `_norm` and `_is_plain_bn` do (the configs ``*_sync`` hold
    its values to JAX's; tests/test_torch_data_parallel_train.py runs it
    over two ranks)."""
    from rocm_apex_tpu_torch.parallel import SyncBatchNorm

    model = tr.ResNet(stage_sizes=(2, 2), block=tr.Bottleneck,
                      num_filters=8, num_classes=CLASSES, fused=True,
                      fold_downsample=True, sync_bn_axis="data",
                      device="cpu")
    assert not model.fused
    norms = [m for m in model.modules() if isinstance(m, SyncBatchNorm)]
    assert len(norms) == 1 + 4 * 3 + 2  # the stem, 3 a block, 2 downsamples
    assert all(m.momentum == 0.1 and m.channel_last and m.axis_name == "data"
               for m in norms)
    assert not any(hasattr(getattr(model, b), "downsample_fold")
                   for b in model.block_names)
