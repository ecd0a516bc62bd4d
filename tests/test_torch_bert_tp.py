"""Tensor-parallel BERT at tp=2 against the JAX package, on the CPU.

Two ranks of a gloo group (spawned once for the module,
`_torch_tp_ranks.run`'s ``"bert"`` suite, 60 s timeouts) run the fp32
`BertModel` of ``R.GPT_SHAPE``'s widths (vocab 96, hidden 32, 2 layers, 4
heads, the binary head) on weights `convert.from_jax_params` slices from
one tp=1 tree, B 2 x S 16, dropout 0, in four forms: with and without a
padding mask (lengths 16 and 11), with and without token types. The JAX
side runs its tp=2 `BertModel` inside ``shard_map`` over two devices of
the conftest's host mesh, each holding its rank's slice (JAX's
`shard_tp1_params`): the rank's vocabulary columns of the logits, the
binary logits, the per-token losses and every gradient of
``mean(losses) + sum(binary * W)``; a 3-step `MixedPrecisionLamb`
trajectory (bench.py's BERT ``one_step``); one LAMB step from given
gradients. The gathered gradients (`convert.gather_tp_params`) are also
held to JAX's tp=1 model.

LAMB at tp>1 reads each rank's shards only: JAX's has no collective, so
in ``shard_map`` a sharded leaf's trust ratio comes from the rank's
shard norms. The port keeps that, pinned as JAX behaves (ROADMAP, not
faults). Sequence parallelism at tp=2 is refused (JAX does not compute
it); at tp=1 it is a no-op, as in JAX.

Tolerance: 1e-5 relative to each tensor's largest entry (losses and
logits 1e-5 relative plus 1e-6 absolute); the trajectory's masters 1e-5
relative plus 2e-6 absolute (tests/test_torch_bert_masked.py's). Both
sides compute in fp32 and differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_tp_ranks as R
from rocm_apex_tpu.inference import shard_tp1_params as jax_shard_tp1_params
from rocm_apex_tpu.models.bert import BertConfig as JaxBertConfig
from rocm_apex_tpu.models.bert import BertModel as JaxBertModel
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionLamb as JaxLamb
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    gather_tp_params,
    random_params,
)
from rocm_apex_tpu_torch.models.bert import SP_REFUSAL, BertConfig

TP = 2
RTOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MASTER_TOL = dict(rtol=1e-5, atol=2e-6)
# the given gradients of the one-step case: small enough that no rank's
# norm and not tp=1's reaches LAMB's clip (max_grad_norm 1)
GRAD_SCALE = 1e-3
# the forms held to JAX's tp=1 model as well (all four to its tp=2 one)
TP1_FORMS = ("unmasked", "masked_types")


def _mesh():
    devs = jax.devices()
    if len(devs) < TP:
        pytest.skip(f"needs {TP} simulated devices")
    return Mesh(np.array(devs[:TP]), ("tensor",))


def _jax_cfg(tp, **kw):
    return JaxBertConfig(**R.GPT_SHAPE, tensor_parallel_size=tp,
                         hidden_dropout=0.0, attention_dropout=0.0,
                         params_dtype=jnp.float32, dtype=jnp.float32, **kw)


def _flat(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 tree.get("params", tree)))


def _mask_tree(tree, prefix=""):
    return {k: (_mask_tree(v, f"{prefix}{k}.") if isinstance(v, dict)
                else R.decay_mask([prefix + k])[prefix + k])
            for k, v in tree.items()}


def _inputs():
    tree = random_params(R.bert_config(1, init_method_std=0.3), seed=4)
    rng = np.random.default_rng(6)
    shape = (R.TRAIN_BATCH, R.TRAIN_SEQ)
    vocab = R.GPT_SHAPE["vocab_size"]
    mask = np.arange(R.TRAIN_SEQ)[None, :] < np.array(R.BERT_LENGTHS)[:, None]
    inputs = {f"p.{k}": v for k, v in flatten_params(tree["params"]).items()}
    grads = {k: (rng.standard_normal(v.shape) * GRAD_SCALE).astype(np.float32)
             for k, v in flatten_params(tree["params"]).items()}
    inputs.update({f"g.{k}": v for k, v in grads.items()})
    inputs.update(
        bert_tokens=rng.integers(0, vocab, shape),
        bert_labels=rng.integers(0, vocab, shape),
        bert_types=rng.integers(0, 2, shape),
        bert_mask=mask.astype(np.int64),
        bert_w=rng.standard_normal((R.TRAIN_BATCH, 2)).astype(np.float32))
    return tree, inputs


def _batch(inputs, form):
    masked, types = R.BERT_FORMS[form]
    return (jnp.asarray(inputs["bert_tokens"]),
            jnp.asarray(inputs["bert_labels"]),
            jnp.asarray(inputs["bert_types"]) if types else None,
            jnp.asarray(inputs["bert_mask"]) if masked else None)


def _stack(tree):
    return jax.tree_util.tree_map(lambda t: t[None], tree)


def _sharded(mesh, body, params):
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),),
                             out_specs=P("tensor"), check_rep=False))(params)


def jax_bert_runs(mesh, tree, inputs, forms, **kw):
    """JAX's tp=2 BERT (config keywords ``kw``) in shard_map, a dict a
    form: the rank-stacked logits, binary logits, losses and gradients
    of mean(losses) + sum(binary * W)."""
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    model = JaxBertModel(_jax_cfg(TP, **kw))
    params = jax_shard_tp1_params(model, jtree, mesh)
    w = jnp.asarray(inputs["bert_w"])
    want = {}
    for form in forms:
        tokens, labels, types, mask = _batch(inputs, form)

        def body(p, tokens=tokens, labels=labels, types=types, mask=mask):
            logits, binary = model.apply(p, tokens, attention_mask=mask,
                                         tokentype_ids=types)

            def loss_fn(p):
                losses, b = model.apply(p, tokens, attention_mask=mask,
                                        tokentype_ids=types, lm_labels=labels)
                return jnp.mean(losses) + jnp.sum(b * w), losses

            (_, losses), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            return _stack((logits, binary, losses, g))

        logits, binary, losses, grads = _sharded(mesh, body, params)
        want[form] = dict(logits=np.asarray(logits), binary=np.asarray(binary),
                          losses=np.asarray(losses), grads=_flat(grads))
    return want


def _jax_runs(mesh, tree, inputs):
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    want = {f"bert_{f}": v for f, v in jax_bert_runs(
        mesh, tree, inputs, R.BERT_FORMS).items()}
    model = JaxBertModel(_jax_cfg(TP))
    params = jax_shard_tp1_params(model, jtree, mesh)

    def lamb():
        return JaxLamb(R.LAMB_LR, weight_decay=R.LAMB_WD, eps=R.LAMB_EPS,
                       weight_decay_mask={"params": _mask_tree(
                           tree["params"])},
                       compute_dtype=jnp.float32, moment_dtype=jnp.float32,
                       store_model=False)

    for form in R.BERT_TRAJECTORY_FORMS:
        tokens, labels, types, mask = _batch(inputs, form)
        opt = lamb()

        def trajectory(p, tokens=tokens, labels=labels, types=types,
                       mask=mask, opt=opt):
            def one(state, _):
                def step_loss(params):
                    step_losses, _ = model.apply(
                        params, tokens, attention_mask=mask,
                        tokentype_ids=types, lm_labels=labels)
                    return jnp.mean(step_losses)

                loss, g = jax.value_and_grad(step_loss)(
                    opt.model_params(state))
                state, _ = opt.step_and_probe(state, g)
                return state, loss

            state, losses = jax.lax.scan(one, opt.init(p), None,
                                         R.TRAJECTORY_STEPS)
            return _stack((losses, state.master))

        losses, master = _sharded(mesh, trajectory, params)
        want[f"bert_trajectory_{form}"] = (np.asarray(losses), _flat(master))
    gtree = {"params": {}}
    for k in flatten_params(tree["params"]):
        node = gtree["params"]
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(inputs[f"g.{k}"])
    gparams = jax_shard_tp1_params(model, gtree, mesh)
    opt = lamb()

    def one_step(p, g):
        state, _ = opt.step_and_probe(opt.init(p), g)
        return _stack(state.master)

    want["bert_lamb_step"] = _flat(jax.jit(shard_map(
        one_step, mesh=mesh, in_specs=(P(), P()), out_specs=P("tensor"),
        check_rep=False))(params, gparams))
    # tp=1: the gradients and the one LAMB step
    model1 = JaxBertModel(_jax_cfg(1))
    w = jnp.asarray(inputs["bert_w"])
    for form in TP1_FORMS:
        tokens, labels, types, mask = _batch(inputs, form)

        def loss_fn(p, tokens=tokens, labels=labels, types=types, mask=mask):
            losses, b = model1.apply(p, tokens, attention_mask=mask,
                                     tokentype_ids=types, lm_labels=labels)
            return jnp.mean(losses) + jnp.sum(b * w), losses

        (_, losses), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jtree)
        want[f"tp1_{form}"] = (np.asarray(losses), _flat(g))
    opt = lamb()
    state, _ = jax.jit(lambda p, g: opt.step_and_probe(opt.init(p), g))(
        jtree, gtree)
    want["tp1_lamb_step"] = _flat(state.master)
    # sequence_parallel=True at tp=1: a no-op in JAX
    model_sp = JaxBertModel(_jax_cfg(1, sequence_parallel=True))
    tokens, labels, types, mask = _batch(inputs, "masked_types")
    want["tp1_sp"] = np.asarray(jax.jit(lambda p: model_sp.apply(
        p, tokens, attention_mask=mask, tokentype_ids=types,
        lm_labels=labels)[0])(jtree))
    return want


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    mesh = _mesh()
    tree, inputs = _inputs()
    want = _jax_runs(mesh, tree, inputs)
    outs = R.spawn(tmp_path_factory.mktemp("bert_tp"), "bert", inputs)
    return dict(tree=tree, inputs=inputs, want=want, outs=outs)


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


@pytest.mark.parametrize("form", list(R.BERT_FORMS))
def test_bert_tp2_matches_jax_tp2(bert, form):
    """Each rank's vocabulary columns of the logits, the binary logits,
    the per-token losses and every gradient shard against JAX's tp=2
    model for that rank; the replicated outputs bit-equal across ranks."""
    want = bert["want"][f"bert_{form}"]
    outs = [o[f"bert_{form}"] for o in bert["outs"]]
    for key in ("binary", "losses"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    for r, got in enumerate(outs):
        np.testing.assert_allclose(got["losses"].numpy(), want["losses"][r],
                                   **LOSS_TOL)
        for key in ("logits", "binary"):
            assert _rel(got[key], want[key][r]) < RTOL, (form, r, key)
        assert set(got["grads"]) == set(want["grads"])
        for k, g in got["grads"].items():
            assert _rel(g, want["grads"][k][r]) < RTOL, (form, r, k)


@pytest.mark.parametrize("form", TP1_FORMS)
def test_bert_tp2_gathered_gradients_match_jax_tp1(bert, form):
    """The ranks' gradients in the tp=1 layout against JAX's tp=1 model;
    the replicated leaves' gradients (BERT's own leaves among them) the
    same on both ranks."""
    losses1, grads1 = bert["want"][f"tp1_{form}"]
    shards = [o[f"bert_{form}"]["grads"] for o in bert["outs"]]
    got = gather_tp_params(R.bert_config(TP), shards)
    assert set(got) == set(grads1)
    for k, g in got.items():
        assert tuple(g.shape) == grads1[k].shape, k
        assert _rel(g, grads1[k]) < RTOL, (form, k)
        if shards[0][k].shape == g.shape:
            assert _rel(shards[1][k], shards[0][k].numpy()) < RTOL, k
    np.testing.assert_allclose(
        bert["outs"][0][f"bert_{form}"]["losses"].numpy(), losses1,
        **LOSS_TOL)


@pytest.mark.parametrize("form", R.BERT_TRAJECTORY_FORMS)
def test_three_step_lamb_trajectory_matches_jax_tp2(bert, form):
    """`make_bert_train_step` three times on each rank's shards (token
    types, with and without the padding mask): the losses and every
    final master shard against JAX's tp=2 trajectory in shard_map."""
    jlosses, jmaster = bert["want"][f"bert_trajectory_{form}"]
    for r, o in enumerate(bert["outs"]):
        losses, master = o[f"bert_trajectory_{form}"]
        assert not any(found for _, found in losses)
        np.testing.assert_allclose([x for x, _ in losses], jlosses[r],
                                   rtol=RTOL)
        assert set(master) == set(jmaster)
        for k, m in master.items():
            np.testing.assert_allclose(m.numpy(), jmaster[k][r],
                                       err_msg=f"{form} {r} {k}",
                                       **MASTER_TOL)
    assert bert["outs"][0][f"bert_trajectory_{form}"][0] == \
        bert["outs"][1][f"bert_trajectory_{form}"][0]


def test_lamb_trust_ratio_is_per_shard_as_jax(bert):
    """One LAMB step from the same gradients, below the clip: each rank's
    masters equal JAX's in shard_map; a sharded leaf's update is the tp=1
    update scaled by one factor a shard (its trust ratio from the shard's
    norms), not the same factor on both shards; a replicated leaf's
    update is tp=1's."""
    want = bert["want"]["bert_lamb_step"]
    before = flatten_params(bert["tree"]["params"])
    for r, o in enumerate(bert["outs"]):
        for k, m in o["bert_lamb_step"].items():
            np.testing.assert_allclose(m.numpy(), want[k][r], err_msg=k,
                                       **MASTER_TOL)
    cfg = R.bert_config(TP)
    got = gather_tp_params(cfg, [o["bert_lamb_step"] for o in bert["outs"]])
    tp1 = bert["want"]["tp1_lamb_step"]
    leaf = "transformer.layer_0.mlp.dense_h_to_4h.kernel"  # column shards
    d2 = np.split(got[leaf].numpy() - before[leaf], TP, axis=1)
    d1 = np.split(tp1[leaf] - before[leaf], TP, axis=1)
    factors = []
    for a, b in zip(d2, d1):
        f = float(np.median(a / b))
        # the updates are differences of masters of |x| < 2: their fp32
        # rounding is a few 1e-7
        np.testing.assert_allclose(a, f * b, rtol=1e-4, atol=1e-6)
        factors.append(f)
    assert abs(factors[0] - factors[1]) > 1e-2, factors
    replicated = "lm_head.dense.kernel"
    np.testing.assert_allclose(got[replicated].numpy(), tp1[replicated],
                               **MASTER_TOL)


def test_sequence_parallel_at_tp2_is_refused_as_jax_cannot_run_it(bert):
    """``BertConfig(sequence_parallel=True)`` at tp=2 raises, by the config
    (an explicit size) and by the model (the bound group's size), naming
    what JAX does there; in this process too."""
    for o in bert["outs"]:
        assert o["bert_sp_config"] == SP_REFUSAL
        assert o["bert_sp_model"] == SP_REFUSAL
    assert "pooler" in SP_REFUSAL and "token types" in SP_REFUSAL
    with pytest.raises(ValueError, match="JAX BertModel does not compute"):
        BertConfig(**R.GPT_SHAPE, tensor_parallel_size=2,
                   sequence_parallel=True)


def test_sequence_parallel_at_tp1_is_the_plain_model(bert):
    """``BertConfig(sequence_parallel=True)`` at tp=1 constructs and gives
    the plain config's losses, and JAX's for the same config (JAX
    `_sp_active` is false at tp=1)."""
    tokens, labels, types, mask = R.bert_batch(bert["inputs"], "masked_types")
    got = {}
    for sp in (False, True):
        model = from_jax_params(bert["tree"],
                                R.bert_config(1, sequence_parallel=sp),
                                device="cpu")
        with torch.no_grad():
            got[sp] = model(tokens, attention_mask=mask, tokentype_ids=types,
                            lm_labels=labels)[0]
    assert torch.equal(got[True], got[False])
    np.testing.assert_allclose(got[True].numpy(), bert["want"]["tp1_sp"],
                               **LOSS_TOL)
