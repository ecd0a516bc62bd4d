"""The port's `BertModel`, its LAMB training step and the materialized
GPT head against the JAX package, on the CPU.

One tiny fp32 config: 2 layers, hidden 128, 4 heads, ffn 512, vocab 1024,
S 64, B 2, dropout 0, no attention mask. The same numpy-drawn weights
(`convert.random_params`) and tokens go into both models; the JAX side
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions. At hidden 128 the word embeddings and both MLP matrices take
the LAMB kernel route on both sides (65536 elements or more, last dim a
multiple of 128); biases, LayerNorm parameters, the 128 x 128 and
128 x 384 matrices and the small embeddings take plain tensor math.

Tolerances are stated per test; the base is fp32 ~1e-5 relative: both
sides compute in fp32 and differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.models.bert import BertConfig as JaxBertConfig
from rocm_apex_tpu.models.bert import BertModel as JaxBertModel
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionLamb as JaxLamb
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
    train_state_from_jax_params,
)
from rocm_apex_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_extended_attention_mask,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.optimizers import MixedPrecisionLamb
from rocm_apex_tpu_torch.optimizers.mixed import takes_leaf_kernels
from rocm_apex_tpu_torch.train import make_bert_train_step

SHAPE = dict(vocab_size=1024, hidden_size=128, num_layers=2,
             num_attention_heads=4, ffn_hidden_size=512,
             max_position_embeddings=64, tensor_parallel_size=1,
             hidden_dropout=0.0, attention_dropout=0.0)
BATCH, SEQ = 2, 64
LR, WD = 1e-3, 0.01
STEPS = 3
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # as the GPT tests hold logits


def jax_cfg(**kw):
    return JaxBertConfig(**SHAPE, params_dtype=jnp.float32,
                         dtype=jnp.float32, **kw)


def torch_cfg(**kw):
    return BertConfig(**{**SHAPE, **kw}, params_dtype=torch.float32,
                      dtype=torch.float32)


def _batch():
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, SHAPE["vocab_size"], (BATCH, SEQ))
    types = rng.integers(0, 2, (BATCH, SEQ))
    return (tokens.astype(np.int32), np.roll(tokens, 1, 1).astype(np.int32),
            types.astype(np.int32))


def _np_tree(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 tree.get("params", tree)))


def _decay_mask(names):
    """bench.py's rule: everything but biases and LayerNorm parameters."""
    return {k: not (k.endswith("bias") or "layernorm" in k.lower())
            for k in names}


def _mask_tree(tree, prefix=""):
    """`_decay_mask` shaped like the nested param tree."""
    return {k: (_mask_tree(v, f"{prefix}{k}.") if isinstance(v, dict)
                else _decay_mask([prefix + k])[prefix + k])
            for k, v in tree.items()}


BINARY_W = np.random.default_rng(9).standard_normal((BATCH, 2)).astype(
    np.float32)


@pytest.fixture(scope="module")
def jax_run():
    tree = random_params(torch_cfg(), seed=0)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    model = JaxBertModel(jax_cfg())
    tokens, labels, types = _batch()
    jt, jl, jty = (jnp.asarray(a) for a in (tokens, labels, types))
    out = dict(tree=tree)
    out["logits"], out["binary"] = (
        np.asarray(a) for a in model.apply(jtree, jt, tokentype_ids=jty))
    out["logits_no_types"], _ = model.apply(jtree, jt)
    out["logits_no_types"] = np.asarray(out["logits_no_types"])

    def loss_fn(p):
        losses, binary = model.apply(p, jt, tokentype_ids=jty, lm_labels=jl)
        return jnp.mean(losses) + jnp.sum(binary * BINARY_W), losses

    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(jtree)
    out["losses"] = np.asarray(losses)
    out["grads"] = _np_tree(grads)

    # three steps of bench.py's `build_bert_train` one_step, run eagerly
    # at this file's config: the mean loss of model_params(state),
    # step_and_probe with no scaler, store_model=False
    flat = flatten_params(tree["params"])
    mask = {"params": _mask_tree(tree["params"])}
    opt = JaxLamb(LR, weight_decay=WD, weight_decay_mask=mask,
                  compute_dtype=jnp.float32, moment_dtype=jnp.float32,
                  store_model=False)
    state = opt.init(jtree)
    traj = []
    for _ in range(STEPS):
        def step_loss(p):
            step_losses, _ = model.apply(p, jt, lm_labels=jl)
            return jnp.mean(step_losses)

        loss, g = jax.value_and_grad(step_loss)(opt.model_params(state))
        state, found = opt.step_and_probe(state, g)
        assert not bool(found)
        traj.append(float(loss))
    out["traj"] = traj
    out["master"] = _np_tree(state.master)
    out["m"], out["v"] = _np_tree(state.m), _np_tree(state.v)
    assert set(out["master"]) == set(flat)
    return out


class TestForward:
    def test_logits_and_binary_logits_match_jax(self, jax_run):
        model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
        tokens, _, types = _batch()
        with torch.no_grad():
            logits, binary = model(torch.from_numpy(tokens).long(),
                                   tokentype_ids=torch.from_numpy(types).long())
            no_types, _ = model(torch.from_numpy(tokens).long())
        assert logits.shape == (BATCH, SEQ, SHAPE["vocab_size"])
        assert binary.shape == (BATCH, 2) and binary.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), jax_run["logits"],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(binary.numpy(), jax_run["binary"],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(no_types.numpy(),
                                   jax_run["logits_no_types"], **LOGIT_TOL)
        # token types really enter: the two runs differ
        assert float((logits - no_types).abs().max()) > 1e-3

    def test_losses_and_every_gradient_match_jax(self, jax_run):
        model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
        tokens, labels, types = _batch()
        losses, binary = model(torch.from_numpy(tokens).long(),
                               tokentype_ids=torch.from_numpy(types).long(),
                               lm_labels=torch.from_numpy(labels).long())
        assert losses.shape == (BATCH, SEQ) and losses.dtype == torch.float32
        np.testing.assert_allclose(losses.detach().numpy(),
                                   jax_run["losses"], rtol=1e-4, atol=1e-5)
        (losses.mean() + (binary * torch.from_numpy(BINARY_W)).sum()
         ).backward()
        named = dict(model.named_parameters())
        assert set(named) == set(jax_run["grads"])
        for k, g in jax_run["grads"].items():
            got = named[k].grad.numpy()
            # relative to each gradient's largest entry: fp32 sums over
            # the 128 rows (and 1024 vocab columns) in two orders
            err = np.abs(got - g).max() / (np.abs(g).max() + 1e-30)
            assert err < 2e-5, (k, err)

    def test_without_the_binary_head(self, jax_run):
        tree = {"params": {k: v for k, v in jax_run["tree"]["params"].items()
                           if k not in ("pooler", "binary_head")}}
        model = from_jax_params(tree, torch_cfg(add_binary_head=False),
                                device="cpu")
        jmodel = JaxBertModel(jax_cfg(add_binary_head=False))
        tokens, _, _ = _batch()
        jlogits, jbinary = jmodel.apply(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))
        with torch.no_grad():
            logits, binary = model(torch.from_numpy(tokens).long())
        assert binary is None and jbinary is None
        assert not hasattr(model, "pooler")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
        assert set(random_params(torch_cfg(add_binary_head=False))["params"]
                   ) == set(tree["params"])

    def test_the_masked_branch_raises_by_name(self, jax_run):
        """The masked branch runs (tests/test_torch_bert_masked.py holds
        it against the JAX model); context parallelism, which takes the
        causal type only, raises the JAX model's ValueError. The extended mask masks a pair unless both
        positions are valid."""
        model = from_jax_params(jax_run["tree"], torch_cfg(), device="cpu")
        tokens, _, _ = _batch()
        mask = torch.ones(BATCH, SEQ, dtype=torch.int64)
        mask[:, -3:] = 0
        with torch.no_grad():
            logits, _ = model(torch.from_numpy(tokens).long(),
                              attention_mask=mask)
        assert bool(torch.isfinite(logits).all())
        cp = from_jax_params(jax_run["tree"],
                             torch_cfg(context_parallel_axis="cp"),
                             device="cpu")
        with pytest.raises(ValueError, match="causal masking"):
            cp(torch.from_numpy(tokens).long(), attention_mask=mask)
        ext = bert_extended_attention_mask(mask)
        assert ext.shape == (BATCH, 1, SEQ, SEQ) and ext.dtype == torch.bool
        assert not bool(ext[0, 0, 0, 0]) and bool(ext[0, 0, 0, -1])
        assert bool(ext[0, 0, -1, 0])

    def test_dropout_is_seeded_and_reproducible(self, jax_run):
        cfg = torch_cfg(hidden_dropout=0.1, attention_dropout=0.1)
        model = from_jax_params(jax_run["tree"], cfg, device="cpu")
        tokens, labels, _ = _batch()
        args = (torch.from_numpy(tokens).long(),)
        kw = dict(lm_labels=torch.from_numpy(labels).long())
        with torch.no_grad():
            det = model(*args, **kw)[0].mean()
            a, b, c = (model(*args, **kw, deterministic=False,
                             dropout_generator=torch.Generator().manual_seed(s)
                             )[0].mean() for s in (1, 1, 2))
        assert a == b and a != det and a != c

    def test_entry_point_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BertModel(torch_cfg())


class TestTrainStep:
    def _trainer(self, jax_run, **kw):
        names = flatten_params(jax_run["tree"]["params"])
        opt = MixedPrecisionLamb(LR, weight_decay=WD,
                                 weight_decay_mask=_decay_mask(names),
                                 compute_dtype=torch.float32, **kw)
        model, state = train_state_from_jax_params(
            jax_run["tree"], torch_cfg(), opt, device="cpu")
        return opt, model, state, make_bert_train_step(model, opt)

    def test_both_lamb_routes_are_on_this_tree(self, jax_run):
        names = flatten_params(jax_run["tree"]["params"])
        routed = {k for k, v in names.items()
                  if takes_leaf_kernels(torch.empty(v.shape))}
        assert "embedding.word_embeddings.weight" in routed
        assert "transformer.layer_0.mlp.dense_h_to_4h.kernel" in routed
        assert "transformer.layer_1.mlp.dense_4h_to_h.kernel" in routed
        assert "transformer.layer_0.self_attention.dense.kernel" not in routed
        assert "lm_head.layernorm.weight" not in routed

    @pytest.mark.parametrize("store_model", [False, True],
                             ids=["no_model", "store_model"])
    def test_three_step_lamb_trajectory_matches_jax(self, jax_run,
                                                    store_model):
        opt, model, state, step = self._trainer(jax_run,
                                                store_model=store_model)
        tokens, labels, _ = _batch()
        losses = []
        for _ in range(STEPS):
            state, loss, found = step(state, torch.from_numpy(tokens).long(),
                                      torch.from_numpy(labels).long())
            assert not bool(found) and not loss.requires_grad
            losses.append(float(loss))
        np.testing.assert_allclose(losses, jax_run["traj"], rtol=1e-5)
        assert losses[-1] < losses[0]
        assert int(state.count) == STEPS
        for k, want in jax_run["master"].items():
            # 2e-6 absolute is 0.2% of one lr step of a unit-ratio leaf:
            # the gradients' fp32 summation noise through three
            # normalized steps
            np.testing.assert_allclose(state.master[k].numpy(), want,
                                       rtol=1e-5, atol=2e-6, err_msg=k)
            np.testing.assert_allclose(state.m[k].numpy(), jax_run["m"][k],
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        named = dict(model.named_parameters())
        got = opt.model_params(state, model)
        for k in jax_run["master"]:
            assert got[k] is named[k]
            assert torch.equal(named[k].detach(), state.master[k])

    def test_an_injected_inf_gradient_freezes_the_state(self, jax_run):
        opt, model, state, _ = self._trainer(jax_run)
        before = {n: {k: x.clone() for k, x in getattr(state, n).items()}
                  for n in ("master", "m", "v", "model")}
        grads = {k: torch.full_like(v, 1e-3) for k, v in state.master.items()}
        grads["transformer.layer_1.mlp.dense_4h_to_h.kernel"][3, 3] = float(
            "inf")
        state, found = opt.step_and_probe(state, grads)
        assert bool(found) and int(state.count) == 0
        for n, d in before.items():
            for k, x in d.items():
                assert torch.equal(getattr(state, n)[k], x), (n, k)

    def test_the_bridge_carries_a_lamb_state_across(self, jax_run):
        """`train_state_from_jax_params(opt_state=...)`: moments in the
        optimizer's moment dtype and the count, from JAX-shaped trees."""
        names = flatten_params(jax_run["tree"]["params"])
        opt = MixedPrecisionLamb(LR, compute_dtype=torch.float32,
                                 moment_dtype=torch.bfloat16)
        ones = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.5),
                                      jax_run["tree"])
        _, state = train_state_from_jax_params(
            jax_run["tree"], torch_cfg(), opt, device="cpu",
            opt_state=dict(m=ones, v=ones["params"], count=7))
        assert int(state.count) == 7 and set(state.m) == set(names)
        for k in names:
            assert state.m[k].dtype == torch.bfloat16
            assert torch.all(state.v[k] == 0.5)
        with pytest.raises(KeyError, match="differently"):
            train_state_from_jax_params(
                jax_run["tree"], torch_cfg(), opt, device="cpu",
                opt_state=dict(m={"x": np.zeros(1)}, v=ones, count=0))


class TestMaterializedGPTHead:
    """`GPTConfig(fused_lm_head=False)`: the tied projection's logits
    through the cross-entropy kernel, with smoothing and ignore_index."""

    GPT = {k: v for k, v in SHAPE.items()}

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(label_smoothing=0.1, ignore_index=5),
    ], ids=["plain", "smoothing_ignore"])
    def test_loss_and_gradients_match_jax(self, kw):
        tcfg = GPTConfig(**self.GPT, fused_lm_head=False,
                         params_dtype=torch.float32, dtype=torch.float32,
                         **kw)
        jcfg = JaxGPTConfig(**self.GPT, fused_lm_head=False,
                            params_dtype=jnp.float32, dtype=jnp.float32, **kw)
        tree = random_params(tcfg, seed=3)
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        tokens, labels, _ = _batch()
        labels = labels.copy()
        labels[0, :4] = 5  # ignored rows when ignore_index=5
        mask = np.ones((BATCH, SEQ), np.float32)
        mask[:, -5:] = 0.0
        jmodel = JaxGPTModel(jcfg)

        def jloss(p):
            return jmodel.apply(p, jnp.asarray(tokens),
                                labels=jnp.asarray(labels),
                                loss_mask=jnp.asarray(mask),
                                loss_reduction="mean")

        jmean, jgrads = jax.value_and_grad(jloss)(jtree)
        jlosses = jmodel.apply(jtree, jnp.asarray(tokens),
                               labels=jnp.asarray(labels),
                               loss_mask=jnp.asarray(mask))
        model = from_jax_params(tree, tcfg, device="cpu")
        t, lbl = torch.from_numpy(tokens).long(), torch.from_numpy(labels)
        mean = model(t, labels=lbl.long(), loss_mask=torch.from_numpy(mask),
                     loss_reduction="mean")
        mean.backward()
        with torch.no_grad():
            losses = model(t, labels=lbl.long(),
                           loss_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(float(mean.detach()), float(jmean),
                                   rtol=1e-5)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=1e-4, atol=1e-5)
        if "ignore_index" in kw:
            assert torch.all(losses[0, :4] == 0.0)
        named = dict(model.named_parameters())
        for k, g in _np_tree(jgrads).items():
            err = np.abs(named[k].grad.numpy() - g).max() / (
                np.abs(g).max() + 1e-30)
            assert err < 2e-5, (k, err)

    def test_it_agrees_with_the_fused_head(self):
        cfg = dict(**self.GPT, params_dtype=torch.float32,
                   dtype=torch.float32, label_smoothing=0.1)
        tree = random_params(GPTConfig(**cfg), seed=3)
        tokens, labels, _ = _batch()
        t, lbl = torch.from_numpy(tokens).long(), torch.from_numpy(labels)
        with torch.no_grad():
            a = from_jax_params(tree, GPTConfig(**cfg), device="cpu")(
                t, labels=lbl.long())
            b = from_jax_params(
                tree, GPTConfig(**cfg, fused_lm_head=False), device="cpu")(
                t, labels=lbl.long())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
