"""The port's GPT training step under `PackedOptimizerStep` against the JAX
package, on the CPU.

bench.py's ``--packed-update`` step (``make_one_step(popt)``, bench.py:
2533-2578 and 2694-2708) at the small fp32 config of
tests/test_torch_train.py: vocab 512, hidden 256, 2 heads of 128, 2
layers, S 64, B 2, dropout 0, the same numpy-drawn weights and tokens. The
JAX side runs its Pallas kernels through their CPU paths, the port its
kernels' plain versions. Tolerances as in tests/test_torch_train.py: the
loss 1e-5 relative and each gradient 1e-5 of its largest entry (fp32
sums in two orders), masters 1e-5 relative plus 2e-5 absolute (2% of an
lr step: that gradient noise through Adam's eps 1e-6 over the steps);
LAMB's trust ratio scales each step by its tensor's norm, so the same
noise gives the same relative bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.optimizers.packed import (
    PackedOptimizerStep as JaxPackedStep,
)
from rocm_apex_tpu_torch.amp import LossScaler
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    random_params,
    train_state_from_jax_params,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops import packing as tpk
from rocm_apex_tpu_torch.optimizers import PackedOptimizerStep
from rocm_apex_tpu_torch.train import make_train_step

SHAPE = dict(vocab_size=512, hidden_size=256, num_layers=2,
             num_attention_heads=2, max_position_embeddings=64,
             tensor_parallel_size=1, hidden_dropout=0.0,
             attention_dropout=0.0)
BATCH, SEQ = 2, 64
LR, WD, EPS = 1e-3, 0.01, 1e-6
STEPS = 3
OPTS = {"adam": dict(weight_decay=WD, eps=EPS),
        "lamb": dict(weight_decay=WD, eps=EPS, max_grad_norm=1.0)}


def jax_cfg():
    return JaxGPTConfig(**SHAPE, params_dtype=jnp.float32, dtype=jnp.float32)


def torch_cfg():
    return GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32)


def _batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, SHAPE["vocab_size"], (BATCH, SEQ))
    return tokens.astype(np.int32), np.roll(tokens, -1, 1).astype(np.int32)


def _np_flat(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray, tree["params"]))


def _jax_opt(optimizer):
    return JaxPackedStep(optimizer, LR, compute_dtype=jnp.float32,
                         **OPTS[optimizer])


def _opt(optimizer):
    return PackedOptimizerStep(optimizer, LR, compute_dtype=torch.float32,
                               **OPTS[optimizer])


@pytest.fixture(scope="module", params=["adam", "lamb"])
def jax_run(request):
    """STEPS JAX steps of bench.py's ``one_step`` under the packed
    optimizer, recording each step's loss, the first step's gradients,
    the state after STEPS - 1 steps and the final masters and moments."""
    optimizer = request.param
    tree = random_params(torch_cfg(), seed=0)
    model = JaxGPTModel(jax_cfg())
    tokens, labels = _batch()
    opt = _jax_opt(optimizer)
    scaler = JaxLossScaler("dynamic")
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, tree))
    sstate = scaler.init()
    losses, grads, before_last = [], None, None
    for t in range(STEPS):
        def loss_fn(params, sstate=sstate):
            return model.apply(
                params, jnp.asarray(tokens), labels=jnp.asarray(labels),
                loss_reduction="mean",
            ) * scaler.loss_scale(sstate)

        if t == STEPS - 1:
            before_last = state
        scaled, g = jax.value_and_grad(loss_fn)(state.model)
        inv = 1.0 / scaler.loss_scale(sstate)
        state, found_inf = opt.step_and_probe(state, g, grad_scale=inv)
        sstate, _ = scaler.update(sstate, found_inf)
        losses.append(float(scaled * inv))
        if grads is None:
            grads = {k: v * float(inv) for k, v in _np_flat(g).items()}
    return dict(optimizer=optimizer, tree=tree, losses=losses, grads=grads,
                before_last=before_last, state=state,
                masters=flatten_params(jax.tree_util.tree_map(
                    np.asarray, opt.masters(state)["params"])),
                loss_scale=float(sstate.loss_scale))


def _steps(model, opt, state, n):
    scaler = LossScaler("dynamic")
    sstate = scaler.init()
    step = make_train_step(model, opt, scaler)
    tokens, labels = (torch.from_numpy(x).long() for x in _batch())
    losses = []
    for _ in range(n):
        state, sstate, loss = step(state, sstate, tokens, labels)
        losses.append(float(loss))
    return state, sstate, losses


def test_pack_spec_of_the_model_is_the_jax_one(jax_run):
    """The port packs the GPT's parameters exactly as JAX packs its tree:
    the buffers carry across."""
    jspec = jax_run["state"].master
    model, state = train_state_from_jax_params(
        jax_run["tree"], torch_cfg(), _opt(jax_run["optimizer"]),
        device="cpu")
    assert [tuple(b.shape) for b in state.master] == \
        [tuple(np.shape(b)) for b in jspec]
    spec = tpk.build_pack_spec(state.model)
    names = list(spec.treedef)
    assert names.index("transformer.layer_0.mlp.dense_4h_to_h.bias") < \
        names.index("transformer.layer_1.input_layernorm.bias")


def test_loss_gradients_and_three_steps_match_jax(jax_run):
    opt = _opt(jax_run["optimizer"])
    model, state = train_state_from_jax_params(
        jax_run["tree"], torch_cfg(), opt, device="cpu")
    state, sstate, losses = _steps(model, opt, state, 1)
    named = dict(model.named_parameters())
    # the first step's gradients are still on the parameters
    for k, g in jax_run["grads"].items():
        got = named[k].grad.numpy() / float(sstate.loss_scale)
        err = np.abs(got - g).max() / (np.abs(g).max() + 1e-30)
        assert err < 1e-5, (k, err)
    state, sstate, more = _steps(model, opt, state, STEPS - 1)
    # _steps restarts the scaler: the scale stays 2^16 for 3 clean steps
    np.testing.assert_allclose(losses + more, jax_run["losses"], rtol=1e-5)
    assert int(state.count) == STEPS
    assert float(sstate.loss_scale) == jax_run["loss_scale"]
    masters = opt.masters(state)
    for k, m in jax_run["masters"].items():
        np.testing.assert_allclose(masters[k].numpy(), m, rtol=1e-5,
                                   atol=2e-5, err_msg=k)
        assert torch.equal(named[k].detach(), masters[k])


def test_a_carried_jax_state_gives_the_jax_next_step(jax_run):
    """The JAX state after STEPS - 1 steps carried across by `convert`:
    its packed buffers become the port's as they are, the model's
    parameters its masters; one more step lands where the JAX one did."""
    jstate = jax_run["before_last"]
    opt = _opt(jax_run["optimizer"])
    model, state = train_state_from_jax_params(
        jax_run["tree"], torch_cfg(), opt, device="cpu", opt_state=jstate)
    assert int(state.count) == STEPS - 1
    for name in ("master", "m", "v"):
        for b, jb in zip(getattr(state, name), getattr(jstate, name)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    jmasters = flatten_params(jax.tree_util.tree_map(
        np.asarray, _jax_opt(jax_run["optimizer"]).masters(jstate)["params"]))
    named = dict(model.named_parameters())
    for k, m in jmasters.items():
        np.testing.assert_array_equal(named[k].detach().numpy(), m)
    state, _, (loss,) = _steps(model, opt, state, 1)
    np.testing.assert_allclose(loss, jax_run["losses"][-1], rtol=1e-5)
    for name in ("master", "m", "v"):
        for b, jb in zip(getattr(state, name),
                         getattr(jax_run["state"], name)):
            scale = np.abs(np.asarray(jb)).max()
            np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                       atol=2e-5 * scale if name != "master"
                                       else 2e-5, err_msg=name)
    with pytest.raises(ValueError, match="layout"):
        train_state_from_jax_params(
            jax_run["tree"], torch_cfg(), opt, device="cpu",
            opt_state=dict(master=jstate.master[:0], m=(), v=(), count=0))
