"""Tensor-parallel GPT training at tp=2 against the JAX package, on the
CPU.

Two ranks of a gloo group (spawned once for the module,
`_torch_tp_ranks.run`'s ``"train"`` suite, 60 s timeouts) train the tiny
fp32 GPT of ``R.GPT_SHAPE`` (vocab 96, hidden 32, 2 layers, 4 heads) on
weights `convert.from_jax_params` slices from one tp=1 tree, on B 2 x S
16 tokens with a loss mask, dropout 0. The JAX side runs its tp=2 model
inside ``shard_map`` over two devices of the conftest's host mesh, each
device holding its rank's slice (JAX's `shard_tp1_params`): the loss and
every gradient of the mean loss in each form (plain tensor parallelism,
sequence parallelism, the collective-matmul rings; the fused head and
the materialized one), and a 3-step `MixedPrecisionAdam` trajectory
under a dynamic `LossScaler` (bench.py's `one_step`). Each rank's
gradient and master shards are held against JAX's for that rank, and
the gathered gradients (`convert.gather_tp_params`) against JAX's tp=1
step.

Tolerance: 1e-5 relative to each tensor's largest entry (the loss 1e-5
relative); the trajectory's masters 1e-5 relative plus 1e-6 absolute,
0.1% of one lr step. Both sides compute in fp32 and differ in summation
order: the row-parallel sums add two partial products where tp=1 adds
one.

Dropout cannot be bit-matched to JAX's PRNG; its tensor-parallel rules
are checked on the port: the attention seed differs between ranks, the
hidden seed is the same on both ranks without sequence parallelism (and
is then tp=1's: the tp=2 step with hidden dropout gives the tp=1 step's
loss and gradients) and differs under it, where each rank's LayerNorm
mask is checked three ways, as tests/test_torch_train_ops.py checks the
kernels' (keep fraction, kept values, the backward's mask).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_tp_ranks as R
from rocm_apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from rocm_apex_tpu.inference import shard_tp1_params as jax_shard_tp1_params
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionAdam as JaxAdam
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    gather_tp_params,
    random_params,
)
from rocm_apex_tpu_torch.models.gpt import _draw_seed

TP = 2
RTOL = 1e-5
MASTER_ATOL = 1e-6


def _mesh():
    devs = jax.devices()
    if len(devs) < TP:
        pytest.skip(f"needs {TP} simulated devices")
    return Mesh(np.array(devs[:TP]), ("tensor",))


def _jax_cfg(tp, **kw):
    return JaxGPTConfig(**R.GPT_SHAPE, tensor_parallel_size=tp,
                        hidden_dropout=0.0, attention_dropout=0.0,
                        params_dtype=jnp.float32, dtype=jnp.float32, **kw)


def _flat(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 tree.get("params", tree)))


def _inputs():
    # weights of std 0.3, so the losses and gradients are not flat
    tree = random_params(R.gpt_config(1, init_method_std=0.3), seed=2)
    rng = np.random.default_rng(3)
    shape = (R.TRAIN_BATCH, R.TRAIN_SEQ)
    vocab = R.GPT_SHAPE["vocab_size"]
    inputs = {f"p.{k}": v for k, v in flatten_params(tree["params"]).items()}
    inputs.update(
        train_tokens=rng.integers(0, vocab, shape),
        train_labels=rng.integers(0, vocab, shape),
        train_mask=(rng.random(shape) > 0.25).astype(np.float32),
        drop_residual=rng.standard_normal((64, 128)).astype(np.float32),
        drop_delta=rng.standard_normal((64, 128)).astype(np.float32))
    return tree, inputs


def _jax_runs(mesh, tree, inputs):
    """JAX's tp=2 step in shard_map for every form: (loss, per-rank
    gradients); the trajectories' losses and per-rank masters; and the
    tp=1 step's gradients."""
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens, labels, mask = (jnp.asarray(inputs[f"train_{k}"]) for k in (
        "tokens", "labels", "mask"))
    want = {}
    for form, kw in R.TRAIN_FORMS.items():
        model = JaxGPTModel(_jax_cfg(TP, **kw))
        params = jax_shard_tp1_params(model, jtree, mesh)

        def loss_grads(p, model=model):
            loss, g = jax.value_and_grad(lambda p: model.apply(
                p, tokens, labels=labels, loss_mask=mask,
                loss_reduction="mean"))(p)
            return loss[None], jax.tree_util.tree_map(lambda t: t[None], g)

        loss, grads = jax.jit(shard_map(
            loss_grads, mesh=mesh, in_specs=(P(),),
            out_specs=(P("tensor"), P("tensor")), check_rep=False))(params)
        want[f"grads_{form}"] = (np.asarray(loss), _flat(grads))
        if form not in R.TRAJECTORY_FORMS:
            continue
        opt = JaxAdam(R.LR, weight_decay=R.WD, eps=R.EPS,
                      compute_dtype=jnp.float32)
        scaler = JaxLossScaler("dynamic")

        def trajectory(p, model=model, opt=opt, scaler=scaler):
            state, sstate, losses = opt.init(p), scaler.init(), []
            for _ in range(R.TRAJECTORY_STEPS):
                def loss_fn(params, sstate=sstate):
                    return model.apply(
                        params, tokens, labels=labels, loss_mask=mask,
                        loss_reduction="mean") * scaler.loss_scale(sstate)

                scaled, g = jax.value_and_grad(loss_fn)(state.model)
                inv = 1.0 / scaler.loss_scale(sstate)
                state, found_inf = opt.step_and_probe(state, g,
                                                      grad_scale=inv)
                sstate, _ = scaler.update(sstate, found_inf)
                losses.append(scaled * inv)
            return (jnp.stack(losses)[None],
                    jax.tree_util.tree_map(lambda t: t[None], state.master))

        losses, master = jax.jit(shard_map(
            trajectory, mesh=mesh, in_specs=(P(),),
            out_specs=(P("tensor"), P("tensor")), check_rep=False))(params)
        want[f"trajectory_{form}"] = (np.asarray(losses), _flat(master))
    # one rank's overflow: JAX's step_and_probe on each rank's own
    # gradients, an inf in rank 0's shard of one leaf
    model = JaxGPTModel(_jax_cfg(TP))
    params = jax_shard_tp1_params(model, jtree, mesh)
    opt = JaxAdam(R.LR, weight_decay=R.WD, eps=R.EPS,
                  compute_dtype=jnp.float32)
    path = tuple(R.OVERFLOW_LEAF.split("."))

    def overflow(p):
        state = opt.init(p)
        rank = jax.lax.axis_index("tensor")

        def grad(kp, v):
            g = jnp.full_like(v, 1e-3)
            if tuple(k.key for k in kp)[-len(path):] == path:
                g = g.at[0, 0].set(jnp.where(rank == 0, jnp.inf, 1e-3))
            return g

        g = jax.tree_util.tree_map_with_path(grad, state.master)
        _, found_inf = opt.step_and_probe(state, g)
        return found_inf[None]

    want["overflow_found_inf"] = np.asarray(jax.jit(shard_map(
        overflow, mesh=mesh, in_specs=(P(),), out_specs=P("tensor"),
        check_rep=False))(params))
    model1 = JaxGPTModel(_jax_cfg(1))
    loss1, g1 = jax.value_and_grad(lambda p: model1.apply(
        p, tokens, labels=labels, loss_mask=mask,
        loss_reduction="mean"))(jtree)
    want["tp1"] = (float(loss1), _flat(g1))
    return want


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    mesh = _mesh()
    tree, inputs = _inputs()
    want = _jax_runs(mesh, tree, inputs)
    outs = R.spawn(tmp_path_factory.mktemp("train_tp"), "train", inputs)
    return dict(tree=tree, inputs=inputs, want=want, outs=outs)


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


@pytest.mark.parametrize("form", list(R.TRAIN_FORMS))
def test_loss_and_every_gradient_match_jax_tp2(trained, form):
    """Each rank's loss and every gradient shard against JAX's tp=2 step
    for that rank, in every head, sequence-parallel and ring form; both
    ranks' losses bit-equal."""
    jloss, jgrads = trained["want"][f"grads_{form}"]
    losses = [o[f"grads_{form}"][0] for o in trained["outs"]]
    assert torch.equal(losses[0], losses[1])
    for r, o in enumerate(trained["outs"]):
        loss, grads = o[f"grads_{form}"]
        np.testing.assert_allclose(float(loss), jloss[r], rtol=RTOL)
        assert set(grads) == set(jgrads)
        for k, g in grads.items():
            assert _rel(g, jgrads[k][r]) < RTOL, (form, r, k)


@pytest.mark.parametrize("form", list(R.TRAIN_FORMS))
def test_gathered_gradients_match_jax_tp1(trained, form):
    """The ranks' gradients gathered into the tp=1 layout against JAX's
    tp=1 step; the replicated leaves' gradients the same on both
    ranks (the sequence-parallel LayerNorms' summed over the group)."""
    jloss, jgrads = trained["want"]["tp1"]
    cfg = R.gpt_config(TP, **R.TRAIN_FORMS[form])
    shards = [o[f"grads_{form}"][1] for o in trained["outs"]]
    got = gather_tp_params(cfg, shards)
    assert set(got) == set(jgrads)
    for k, g in got.items():
        assert tuple(g.shape) == jgrads[k].shape, k
        assert _rel(g, jgrads[k]) < RTOL, (form, k)
        if shards[0][k].shape == g.shape:
            assert _rel(shards[1][k], shards[0][k].numpy()) < RTOL, k
    np.testing.assert_allclose(
        float(trained["outs"][0][f"grads_{form}"][0]), jloss, rtol=RTOL)


@pytest.mark.parametrize("form", R.TRAJECTORY_FORMS)
def test_three_step_adam_trajectory_matches_jax_tp2(trained, form):
    """`make_train_step` (the scaled fused-head mean loss,
    `MixedPrecisionAdam.step_and_probe`, the dynamic scaler) three times
    on each rank's shard: the losses and every final master shard
    against JAX's tp=2 trajectory in shard_map."""
    jlosses, jmaster = trained["want"][f"trajectory_{form}"]
    for r, o in enumerate(trained["outs"]):
        losses, master = o[f"trajectory_{form}"]
        np.testing.assert_allclose(losses, jlosses[r], rtol=RTOL)
        assert set(master) == set(jmaster)
        for k, m in master.items():
            # a bias starts at 0, so its masters are a few lr steps; 1e-6
            # absolute is 0.1% of one step (tests/test_torch_train.py
            # holds tp=1 to 2e-5 with eps 1e-6)
            np.testing.assert_allclose(m.numpy(), jmaster[k][r],
                                       rtol=RTOL, atol=MASTER_ATOL,
                                       err_msg=f"{form} {r} {k}")
    assert trained["outs"][0][f"trajectory_{form}"][0] == \
        trained["outs"][1][f"trajectory_{form}"][0]


def test_dropout_seeds_follow_the_rank_rules(trained):
    """From one generator state: the attention seed differs between the
    ranks (each rank's heads draw their own masks); the hidden seed is
    tp=1's on both ranks without sequence parallelism and differs
    between the ranks under it (each rank holds its own rows)."""
    o0, o1 = (o for o in trained["outs"])
    tp1 = _draw_seed(torch.Generator().manual_seed(R.DROPOUT_SEED))
    for sp in (0, 1):
        assert o0[f"seeds_sp{sp}"]["attention"] != \
            o1[f"seeds_sp{sp}"]["attention"]
    assert o0["seeds_sp0"]["hidden"] == o1["seeds_sp0"]["hidden"] == tp1
    assert o0["seeds_sp1"]["hidden"] != o1["seeds_sp1"]["hidden"]


def test_hidden_dropout_without_sp_is_the_tp1_mask(trained):
    """Hidden dropout at tp=2 without sequence parallelism (attention
    dropout 0): the replicated stream draws the tp=1 model's masks, so
    the loss and the gathered gradients are the tp=1 dropout step's
    (the backward regenerates the forward's masks on both ranks)."""
    tokens, labels, mask = R.train_batch(trained["inputs"])
    cfg1 = R.gpt_config(1, hidden_dropout=R.DROPOUT_RATE)
    model = from_jax_params(trained["tree"], cfg1, device="cpu")
    loss = model(tokens, labels=labels, loss_mask=mask, loss_reduction="mean",
                 deterministic=False,
                 dropout_generator=torch.Generator().manual_seed(
                     R.DROPOUT_SEED))
    loss.backward()
    loss = loss.detach()
    ref = {k: p.grad.numpy() for k, p in model.named_parameters()}
    outs = [o["dropout_hidden"] for o in trained["outs"]]
    nodrop = float(trained["outs"][0]["grads_plain_fused"][0])
    assert abs(float(loss) - nodrop) > 1e-3  # dropout moved the loss
    for got, _ in outs:
        np.testing.assert_allclose(float(got), float(loss), rtol=RTOL)
    got = gather_tp_params(R.gpt_config(TP), [g for _, g in outs])
    for k, g in got.items():
        assert _rel(g, ref[k]) < RTOL, k


def test_sequence_parallel_ln_masks_three_ways(trained):
    """Under sequence parallelism each rank's LayerNorm dropout at its
    own seed: the keep fraction within 0.02 of 1 - p, the kept deltas
    scaled by 1 / (1 - p), the delta's gradient the forward's mask
    times 1 / (1 - p); and the two ranks' masks differ."""
    delta = trained["inputs"]["drop_delta"]
    keeps = []
    rate = R.DROPOUT_RATE
    for o in trained["outs"]:
        dropped, ddelta = (t.numpy() for t in o["dropout_ln"])
        keep = dropped != 0
        assert abs(keep.mean() - (1 - rate)) < 0.02
        # (residual + kept) - residual: fp32 rounding of the two adds
        np.testing.assert_allclose(dropped[keep], delta[keep] / (1 - rate),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(ddelta, keep / np.float32(1 - rate))
        keeps.append(keep)
    assert (keeps[0] != keeps[1]).mean() > 0.1


def test_one_ranks_overflow_skips_that_rank_only_as_jax(trained):
    """`step_and_probe` reads each rank's own gradients, with no
    collective, as JAX's does: an inf in rank 0's shard of one leaf's
    gradient skips rank 0's step and not rank 1's, in both packages
    (ROADMAP Queue 3, not a fault)."""
    got = [o["overflow_found_inf"] for o in trained["outs"]]
    assert got == [True, False]
    assert list(trained["want"]["overflow_found_inf"]) == got
