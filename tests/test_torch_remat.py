"""Activation checkpointing and post-LN against the JAX package, on the
CPU.

The fp32 GPT and BERT of ``R.GPT_SHAPE``'s widths (vocab 96, hidden 32, 2
layers, 4 heads), B 2 x S 16, dropout 0, under
``checkpoint_activations`` (JAX ``nn.remat`` of each layer, the residual
chain off) and ``apply_residual_connection_post_layernorm`` (the
residuals taken from the LayerNorms' outputs): at tp=1 in this process
against JAX's model under ``jax.jit``, and at tp=2 on two gloo ranks
(`_torch_tp_ranks.run`'s ``"remat"`` suite; the GPT with sequence
parallelism and the collective-matmul rings, BERT without, since BERT
refuses it there) against JAX's tp=2 model in ``shard_map``: the loss
(BERT: the per-token losses) and every gradient. A checkpointed ring
step repeats each layer's forward hops in its backward: the exchanges a
step rise by the forward's ring hops, counted on the ranks.

`tensor_parallel.random.checkpoint` under each `CheckpointPolicy`
against ``jax.checkpoint`` under JAX's policy of the same name (values
and gradients), and the products each policy recomputes. With dropout
on, a checkpointed step draws every site's seed before the checkpointed
call: its recomputed masks are its forward's (the step equals the same
step with the recompute switched off) and its generator ends where the
chained step leaves it.

Tolerance: 1e-5 relative to each tensor's largest entry (losses 1e-5
relative); fp32 on both sides, summation orders apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_tp_ranks as R
import test_torch_bert_tp as B
from rocm_apex_tpu.inference import shard_tp1_params as jax_shard_tp1_params
from rocm_apex_tpu.models.bert import BertModel as JaxBertModel
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.transformer.tensor_parallel import random as jrandom
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
)
from rocm_apex_tpu_torch.models import gpt as tgpt
from rocm_apex_tpu_torch.transformer.tensor_parallel import random as trandom

TP = 2
RTOL = 1e-5
DROPOUT = 0.2
POLICIES = ("NOTHING_SAVEABLE", "DOTS_SAVEABLE", "DOTS_WITH_NO_BATCH_DIMS")
# the forward products of `_policy_fn_torch` (one mm, x @ w1, and one
# bmm) that the backward recomputes under each policy
RECOMPUTED = {"NOTHING_SAVEABLE": {"mm": 1, "bmm": 1},
              "DOTS_SAVEABLE": {"mm": 0, "bmm": 0},
              "DOTS_WITH_NO_BATCH_DIMS": {"mm": 0, "bmm": 1}}


def _mesh():
    devs = jax.devices()
    if len(devs) < TP:
        pytest.skip(f"needs {TP} simulated devices")
    return Mesh(np.array(devs[:TP]), ("tensor",))


def _jax_gpt_cfg(tp, **kw):
    return JaxGPTConfig(**R.GPT_SHAPE, tensor_parallel_size=tp,
                        hidden_dropout=0.0, attention_dropout=0.0,
                        params_dtype=jnp.float32, dtype=jnp.float32, **kw)


def _flat(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 tree.get("params", tree)))


def _inputs():
    gtree = random_params(R.gpt_config(1, init_method_std=0.3), seed=8)
    btree, binputs = B._inputs()
    rng = np.random.default_rng(9)
    shape = (R.TRAIN_BATCH, R.TRAIN_SEQ)
    vocab = R.GPT_SHAPE["vocab_size"]
    inputs = {f"p.{k}": v for k, v in flatten_params(gtree["params"]).items()}
    inputs.update({f"bp.{k}": v
                   for k, v in flatten_params(btree["params"]).items()})
    inputs.update({k: v for k, v in binputs.items() if k.startswith("bert_")})
    inputs.update(
        train_tokens=rng.integers(0, vocab, shape),
        train_labels=rng.integers(0, vocab, shape),
        train_mask=(rng.random(shape) > 0.25).astype(np.float32))
    return gtree, btree, inputs


def _jax_gpt_loss_grads(model, tokens, labels, mask):
    def loss_grads(p):
        return jax.value_and_grad(lambda p: model.apply(
            p, tokens, labels=labels, loss_mask=mask,
            loss_reduction="mean"))(p)
    return loss_grads


def _jax_runs(mesh, gtree, btree, inputs):
    tokens, labels, mask = (jnp.asarray(inputs[f"train_{k}"]) for k in (
        "tokens", "labels", "mask"))
    jg = jax.tree_util.tree_map(jnp.asarray, gtree)
    want = {}
    for form, (kind, kw) in R.REMAT_FORMS.items():
        if kind == "bert":
            want[form] = B.jax_bert_runs(mesh, btree, inputs,
                                         ["masked_types"], **kw)[
                                             "masked_types"]
            continue
        model = JaxGPTModel(_jax_gpt_cfg(TP, **kw))
        params = jax_shard_tp1_params(model, jg, mesh)
        body = _jax_gpt_loss_grads(model, tokens, labels, mask)
        loss, grads = jax.jit(shard_map(
            lambda p, body=body: B._stack(body(p)), mesh=mesh,
            in_specs=(P(),), out_specs=P("tensor"), check_rep=False))(params)
        want[form] = (np.asarray(loss), _flat(grads))
    # tp=1, each form's config without the parallel keywords
    for form, (kind, kw) in R.REMAT_FORMS.items():
        kw1 = {k: v for k, v in kw.items() if k in (
            "checkpoint_activations",
            "apply_residual_connection_post_layernorm")}
        if f"tp1_{kind}_{sorted(kw1)}" in want:
            continue
        if kind == "gpt":
            model = JaxGPTModel(_jax_gpt_cfg(1, **kw1))
            loss, g = jax.jit(_jax_gpt_loss_grads(model, tokens, labels,
                                                  mask))(jg)
            want[f"tp1_{kind}_{sorted(kw1)}"] = (float(loss), _flat(g))
        else:
            model = JaxBertModel(B._jax_cfg(1, **kw1))
            bt, bl, bty, bm = B._batch(inputs, "masked_types")
            w = jnp.asarray(inputs["bert_w"])

            def loss_fn(p, model=model, bt=bt, bl=bl, bty=bty, bm=bm):
                losses, b = model.apply(p, bt, attention_mask=bm,
                                        tokentype_ids=bty, lm_labels=bl)
                return jnp.mean(losses) + jnp.sum(b * w), losses

            (_, losses), g = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(jax.tree_util.tree_map(
                    jnp.asarray, btree))
            want[f"tp1_{kind}_{sorted(kw1)}"] = (np.asarray(losses),
                                                 _flat(g))
    return want


@pytest.fixture(scope="module")
def remat(tmp_path_factory):
    mesh = _mesh()
    gtree, btree, inputs = _inputs()
    want = _jax_runs(mesh, gtree, btree, inputs)
    outs = R.spawn(tmp_path_factory.mktemp("remat"), "remat", inputs)
    return dict(gtree=gtree, btree=btree, inputs=inputs, want=want,
                outs=outs)


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


@pytest.mark.parametrize("form", list(R.REMAT_FORMS))
def test_remat_and_post_ln_match_jax_tp2(remat, form):
    """Each rank's loss and every gradient shard against JAX's tp=2 model
    of the same config in shard_map; both ranks' losses bit-equal."""
    kind = R.REMAT_FORMS[form][0]
    want = remat["want"][form]
    outs = [o[form] for o in remat["outs"]]
    if kind == "gpt":
        assert torch.equal(outs[0][0], outs[1][0])
        for r, (loss, grads) in enumerate(outs):
            np.testing.assert_allclose(float(loss), want[0][r], rtol=RTOL)
            assert set(grads) == set(want[1])
            for k, g in grads.items():
                assert _rel(g, want[1][k][r]) < RTOL, (form, r, k)
        return
    assert torch.equal(outs[0]["losses"], outs[1]["losses"])
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got["losses"].numpy(), want["losses"][r],
                                   **B.LOSS_TOL)
        assert _rel(got["logits"], want["logits"][r]) < RTOL
        for k, g in got["grads"].items():
            assert _rel(g, want["grads"][k][r]) < RTOL, (form, r, k)


@pytest.mark.parametrize("form", list(R.REMAT_FORMS))
def test_remat_and_post_ln_match_jax_tp1(remat, form):
    """The same config at tp=1 in this process against JAX's tp=1 model:
    the loss (BERT: the per-token losses) and every gradient."""
    kind, kw = R.REMAT_FORMS[form]
    kw1 = {k: v for k, v in kw.items() if k in (
        "checkpoint_activations", "apply_residual_connection_post_layernorm")}
    want_loss, want_grads = remat["want"][f"tp1_{kind}_{sorted(kw1)}"]
    inputs = remat["inputs"]
    if kind == "gpt":
        model = from_jax_params(remat["gtree"], R.gpt_config(1, **kw1),
                                device="cpu")
        tokens, labels, mask = R.train_batch(inputs)
        loss = model(tokens, labels=labels, loss_mask=mask,
                     loss_reduction="mean")
        loss.backward()
        np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL)
        grads = {k: p.grad for k, p in model.named_parameters()}
    else:
        model = from_jax_params(remat["btree"], R.bert_config(1, **kw1),
                                device="cpu")
        got = R._bert_loss_grads(model, inputs, "masked_types")
        np.testing.assert_allclose(got["losses"].numpy(), want_loss,
                                   **B.LOSS_TOL)
        grads = got["grads"]
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        assert _rel(g, want_grads[k]) < RTOL, (form, k)


def test_remat_ring_step_repeats_the_forward_hops(remat):
    """A checkpointed tp=2 ring step: the forward's ring hops again in the
    backward (4 rings a layer, ``R.TRAIN_SEQ / tp / R.RING_CHUNK`` pieces
    a ring, one hop each at tp=2), on both ranks, every other exchange
    unchanged."""
    pieces = R.TRAIN_SEQ // TP // R.RING_CHUNK
    layers = R.GPT_SHAPE["num_layers"]
    for o in remat["outs"]:
        c = o["remat_exchanges"]
        assert c["ring_remat"] - c["ring"] == 4 * layers * pieces, c


def _policy_fn_torch(x, w1, w2):
    return torch.tanh(torch.bmm(torch.tanh(x @ w1), w2)).sum()


def _policy_fn_jax(x, w1, w2):
    return jnp.tanh(jnp.matmul(jnp.tanh(x @ w1), w2)).sum()


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoint_policies_match_jax_checkpoint(policy):
    """`checkpoint(f, *args, policy=...)` gives ``f``'s value and gradients,
    as ``jax.checkpoint`` under JAX's policy of that name does; the
    backward recomputes the products the policy does not save (on top
    of the backward's own two mm and two bmm), and a policy that is not
    one of the three raises."""
    rng = np.random.default_rng(11)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32) for s in (
        (3, 5, 4), (4, 6), (3, 6, 6)))
    jval, jgrads = jax.value_and_grad(
        lambda *a: jrandom.checkpoint(
            _policy_fn_jax, *a,
            policy=getattr(jrandom.CheckpointPolicy, policy)),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, w1, w2)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w1, w2)]
    y = trandom.checkpoint(_policy_fn_torch, *args,
                           distribute_saved_activations=True,
                           policy=getattr(trandom.CheckpointPolicy, policy))
    with _CountProducts() as count:
        y.backward()
    np.testing.assert_allclose(float(y), float(jval), rtol=RTOL)
    for a, g in zip(args, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=1e-6)
    # the backward's own products: mm for dw1 and dx, bmm for dh and dw2
    want = RECOMPUTED[policy]
    assert count.n == {"mm": 2 + want["mm"], "bmm": 2 + want["bmm"]}, count.n
    with pytest.raises(ValueError, match="CheckpointPolicy"):
        trandom.checkpoint(_policy_fn_torch, *args, policy="dots")


def _dropout_step(tree, cfg, gen, no_recompute=False, monkeypatch=None):
    model = from_jax_params(tree, cfg, device="cpu")
    tokens, labels, mask = (torch.from_numpy(a) for a in _dropout_batch())
    if no_recompute:
        monkeypatch.setattr(tgpt, "checkpoint", lambda f, *a: f(*a))
    loss = model(tokens, labels=labels, loss_mask=mask, loss_reduction="mean",
                 deterministic=False, dropout_generator=gen)
    loss.backward()
    if no_recompute:
        monkeypatch.undo()
    return loss.detach(), {k: p.grad for k, p in model.named_parameters()}


def _dropout_batch():
    rng = np.random.default_rng(13)
    shape = (R.TRAIN_BATCH, R.TRAIN_SEQ)
    vocab = R.GPT_SHAPE["vocab_size"]
    return (rng.integers(0, vocab, shape), rng.integers(0, vocab, shape),
            (rng.random(shape) > 0.25).astype(np.float32))


def test_dropout_remat_replays_its_masks(monkeypatch):
    """A checkpointed step with hidden and attention dropout 0.2: the same
    loss and gradients as the step whose layers are not recomputed (the
    recompute drew no new seed, so its masks were the forward's); its
    generator ends where the chained, uncheckpointed step leaves it; and
    the dropout moved the loss."""
    tree = random_params(R.gpt_config(1, init_method_std=0.3), seed=8)
    cfg = R.gpt_config(1, hidden_dropout=DROPOUT, attention_dropout=DROPOUT,
                       checkpoint_activations=True)
    gens = [torch.Generator().manual_seed(R.DROPOUT_SEED) for _ in range(3)]
    loss, grads = _dropout_step(tree, cfg, gens[0])
    loss_plain, grads_plain = _dropout_step(tree, cfg, gens[1], True,
                                            monkeypatch)
    assert torch.equal(loss, loss_plain)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_plain[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    chained = dataclasses.replace(cfg, checkpoint_activations=False)
    loss_chained, _ = _dropout_step(tree, chained, gens[2])
    assert torch.equal(gens[0].get_state(), gens[2].get_state())
    nodrop = dataclasses.replace(cfg, hidden_dropout=0.0,
                                 attention_dropout=0.0)
    loss0, _ = _dropout_step(tree, nodrop, None)
    assert abs(float(loss) - float(loss0)) > 1e-3
    assert abs(float(loss_chained) - float(loss0)) > 1e-3
