"""The fused-softmax attention path (``attention_impl="fused_softmax"``)
of the port's GPT and masked BERT against the JAX package, on the CPU.

Materialized fp32 scores, the scaled causal or padding-masked softmax
(JAX: its Pallas kernels in interpret mode; the port: the kernels' plain
versions through the same autograd functions the card runs), the
probabilities' dropout, probs·v. Tiny fp32 configs, the same numpy-drawn
weights (`convert.random_params`) and inputs on both sides, dropout 0
unless a test says otherwise; the tolerances are those of
tests/test_torch_train.py and tests/test_torch_bert_masked.py (rtol/atol
1e-4 on logits; gradients relative to each one's largest entry): both
sides compute in fp32 and differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.bert import BertConfig as JaxBertConfig
from rocm_apex_tpu.models.bert import BertModel as JaxBertModel
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.optimizers.mixed import MixedPrecisionAdam as JaxAdam
from rocm_apex_tpu_torch.amp import LossScaler
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
    train_state_from_jax_params,
)
from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams
from rocm_apex_tpu_torch.models import gpt as port_gpt
from rocm_apex_tpu_torch.models.bert import BertConfig
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops.softmax import ScoresFp32
from rocm_apex_tpu_torch.optimizers import MixedPrecisionAdam
from rocm_apex_tpu_torch.train import make_train_step

FUSED = dict(attention_impl="fused_softmax")
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
# GPT: head_dim 64, which the packed flash path does not take
GPT_SHAPE = dict(vocab_size=512, hidden_size=256, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 tensor_parallel_size=1, **NO_DROPOUT)
# BERT: tests/test_torch_bert_masked.py's config and lengths
BERT_SHAPE = dict(vocab_size=1024, hidden_size=128, num_layers=2,
                  num_attention_heads=4, ffn_hidden_size=512,
                  max_position_embeddings=64, tensor_parallel_size=1,
                  **NO_DROPOUT)
BATCH, SEQ = 2, 64
LENGTHS = (64, 41)
LR, WD, EPS = 1e-3, 0.01, 1e-6  # tests/test_torch_train.py's Adam
STEPS = 3
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _jcfg(cls, shape, **kw):
    return cls(**{**shape, **FUSED, **kw}, params_dtype=jnp.float32,
               dtype=jnp.float32)


def _tcfg(cls, shape, **kw):
    return cls(**{**shape, **FUSED, **kw}, params_dtype=torch.float32,
               dtype=torch.float32)


def _gpt_batch():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, GPT_SHAPE["vocab_size"], (BATCH, SEQ))
    return tokens.astype(np.int32), np.roll(tokens, -1, 1).astype(np.int32)


def _bert_batch():
    rng = np.random.default_rng(17)
    tokens = rng.integers(0, BERT_SHAPE["vocab_size"], (BATCH, SEQ))
    types = rng.integers(0, 2, (BATCH, SEQ))
    mask = np.arange(SEQ)[None, :] < np.array(LENGTHS)[:, None]
    return (tokens.astype(np.int32), np.roll(tokens, 1, 1).astype(np.int32),
            types.astype(np.int32), mask.astype(np.int32))


def _np_tree(tree):
    return flatten_params(jax.tree_util.tree_map(np.asarray,
                                                 tree.get("params", tree)))


def _assert_grads(named, grads, tol):
    assert set(named) == set(grads)
    for k, g in grads.items():
        got = named[k].grad.numpy()
        # relative to each gradient's largest entry
        err = np.abs(got - g).max() / (np.abs(g).max() + 1e-30)
        assert err < tol, (k, err)


def _long(*arrays):
    return tuple(torch.from_numpy(a).long() for a in arrays)


@pytest.fixture(scope="module")
def gpt_run():
    """JAX GPT under "fused_softmax": logits, the mean loss and every
    gradient, and three steps of bench.py's `one_step` (Adam under the
    dynamic scaler)."""
    tree = random_params(_tcfg(GPTConfig, GPT_SHAPE), seed=0)
    model = JaxGPTModel(_jcfg(JaxGPTConfig, GPT_SHAPE))
    tokens, labels = (jnp.asarray(a) for a in _gpt_batch())
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    out = dict(tree=tree, logits=np.asarray(model.apply(params, tokens)))

    def loss_fn(p):
        return model.apply(p, tokens, labels=labels, loss_reduction="mean")

    loss, grads = jax.value_and_grad(loss_fn)(params)
    out["loss"], out["grads"] = float(loss), _np_tree(grads)
    opt = JaxAdam(LR, weight_decay=WD, eps=EPS, compute_dtype=jnp.float32)
    scaler = JaxLossScaler("dynamic")
    state, sstate = opt.init(params), scaler.init()
    traj = []
    for _ in range(STEPS):
        def scaled(p, sstate=sstate):
            return loss_fn(p) * scaler.loss_scale(sstate)

        val, g = jax.value_and_grad(scaled)(state.model)
        inv = 1.0 / scaler.loss_scale(sstate)
        state, found = opt.step_and_probe(state, g, grad_scale=inv)
        sstate, _ = scaler.update(sstate, found)
        traj.append(float(val * inv))
    out["traj"], out["master"] = traj, _np_tree(state.master)
    return out


BINARY_W = np.random.default_rng(19).standard_normal((BATCH, 2)).astype(
    np.float32)


@pytest.fixture(scope="module")
def bert_run():
    """JAX masked BERT under "fused_softmax": logits, per-token losses,
    every gradient, and the first layer's attention output."""
    tree = random_params(_tcfg(BertConfig, BERT_SHAPE), seed=3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = JaxBertModel(_jcfg(JaxBertConfig, BERT_SHAPE))
    tokens, labels, types, mask = (jnp.asarray(a) for a in _bert_batch())
    (logits, binary), inter = model.apply(
        params, tokens, attention_mask=mask, tokentype_ids=types,
        capture_intermediates=True, mutable=["intermediates"])
    attn = inter["intermediates"]["transformer"]["layer_0"][
        "self_attention"]["__call__"][0]
    out = dict(tree=tree, logits=np.asarray(logits), binary=np.asarray(binary),
               attn0=np.asarray(attn))

    def loss_fn(p):
        losses, b = model.apply(p, tokens, attention_mask=mask,
                                tokentype_ids=types, lm_labels=labels)
        return jnp.mean(losses) + jnp.sum(b * BINARY_W), losses

    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    out["losses"], out["grads"] = np.asarray(losses), _np_tree(grads)
    return out


class TestGPT:
    def test_logits_loss_and_every_gradient_match_jax(self, gpt_run):
        model = from_jax_params(gpt_run["tree"], _tcfg(GPTConfig, GPT_SHAPE),
                                device="cpu")
        tokens, labels = _long(*_gpt_batch())
        with torch.no_grad():
            logits = model(tokens)
        np.testing.assert_allclose(logits.numpy(), gpt_run["logits"],
                                   **LOGIT_TOL)
        loss = model(tokens, labels=labels, loss_reduction="mean")
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), gpt_run["loss"],
                                   rtol=1e-5)
        _assert_grads(dict(model.named_parameters()), gpt_run["grads"], 1e-5)

    def test_three_step_adam_trajectory_matches_jax(self, gpt_run):
        opt = MixedPrecisionAdam(LR, weight_decay=WD, eps=EPS,
                                 compute_dtype=torch.float32)
        scaler = LossScaler("dynamic")
        model, state = train_state_from_jax_params(
            gpt_run["tree"], _tcfg(GPTConfig, GPT_SHAPE), opt, device="cpu")
        sstate = scaler.init()
        step = make_train_step(model, opt, scaler)
        tokens, labels = _long(*_gpt_batch())
        losses = []
        for _ in range(STEPS):
            state, sstate, loss = step(state, sstate, tokens, labels)
            losses.append(float(loss))
        np.testing.assert_allclose(losses, gpt_run["traj"], rtol=1e-5)
        assert losses[-1] < losses[0]
        for k, m in gpt_run["master"].items():
            # tests/test_torch_train.py's tolerance on the masters
            np.testing.assert_allclose(state.master[k].numpy(), m,
                                       rtol=1e-5, atol=2e-5, err_msg=k)

    def test_head_dim_32_matches_jax(self):
        """hd 32, which no flash kernel of the port takes on the card:
        this path has no attention kernel, only matmuls."""
        shape = {**GPT_SHAPE, "hidden_size": 128, "num_attention_heads": 4}
        tree = random_params(_tcfg(GPTConfig, shape), seed=5)
        jmodel = JaxGPTModel(_jcfg(JaxGPTConfig, shape))
        tokens, labels = _gpt_batch()
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        jloss, jgrads = jax.value_and_grad(
            lambda p: jmodel.apply(p, jnp.asarray(tokens),
                                   labels=jnp.asarray(labels),
                                   loss_reduction="mean"))(params)
        model = from_jax_params(tree, _tcfg(GPTConfig, shape), device="cpu")
        assert model.cfg.head_dim == 32
        t, lbl = _long(tokens, labels)
        loss = model(t, labels=lbl, loss_reduction="mean")
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        _assert_grads(dict(model.named_parameters()), _np_tree(jgrads), 1e-5)

    def test_the_path_runs_the_softmax_kernels_and_no_flash(self, gpt_run,
                                                            monkeypatch):
        """Each layer's forward calls the causal softmax once; no flash
        function is reached on the uncached path."""
        calls = []
        real = port_gpt.scaled_upper_triang_masked_softmax

        def counted(*a):
            calls.append(a[0].shape)
            return real(*a)

        def refuse(*a, **k):
            raise AssertionError("a flash kernel on the fused-softmax path")

        monkeypatch.setattr(port_gpt, "scaled_upper_triang_masked_softmax",
                            counted)
        for name in ("flash_attention_heads", "flash_attention_qkv_bias",
                     "flash_attention_qkv_bias_dropout"):
            monkeypatch.setattr(port_gpt, name, refuse)
        model = from_jax_params(gpt_run["tree"], _tcfg(GPTConfig, GPT_SHAPE),
                                device="cpu")
        tokens, labels = _long(*_gpt_batch())
        model(tokens, labels=labels, loss_reduction="mean").backward()
        heads = GPT_SHAPE["num_attention_heads"]
        assert calls == [(BATCH * heads, SEQ, SEQ)] * GPT_SHAPE["num_layers"]


def test_scores_are_fp32_sums_of_the_16bit_products():
    """bf16 q and k give fp32 scores that were never rounded to bf16: the
    exact products of the bf16 values summed in fp32 (JAX's
    preferred_element_type=float32), where a bf16 matmul would round
    them. The backward rounds the fp32 cotangent to bf16 once and returns
    bf16 gradients."""
    rng = np.random.default_rng(31)
    q, k = (torch.from_numpy(rng.standard_normal((2, 3, 16, 8)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
        for _ in range(2))
    scores = ScoresFp32.apply(q, k)
    assert scores.dtype == torch.float32
    exact = torch.matmul(q.detach().double(),
                         k.detach().double().transpose(-1, -2))
    # 8 exact products in fp32: within a few fp32 ulps of the exact sum
    torch.testing.assert_close(scores.double(), exact, rtol=1e-6, atol=1e-6)
    rounded = torch.matmul(q.detach(), k.detach().transpose(-1, -2))
    assert float((rounded.double() - exact).abs().max()) > 1e-3
    ds = torch.from_numpy(rng.standard_normal(scores.shape).astype(
        np.float32))
    scores.backward(ds)
    assert q.grad.dtype == k.grad.dtype == torch.bfloat16
    dsb = ds.to(torch.bfloat16)
    torch.testing.assert_close(q.grad, torch.matmul(dsb, k.detach()))
    torch.testing.assert_close(
        k.grad, torch.matmul(dsb.transpose(-1, -2), q.detach()))


class TestBertMasked:
    def test_logits_losses_and_every_gradient_match_jax(self, bert_run):
        model = from_jax_params(bert_run["tree"], _tcfg(BertConfig,
                                                        BERT_SHAPE),
                                device="cpu")
        tokens, labels, types, mask = _long(*_bert_batch())
        with torch.no_grad():
            logits, binary = model(tokens, attention_mask=mask,
                                   tokentype_ids=types)
        np.testing.assert_allclose(logits.numpy(), bert_run["logits"],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(binary.numpy(), bert_run["binary"],
                                   **LOGIT_TOL)
        losses, binary = model(tokens, attention_mask=mask,
                               tokentype_ids=types, lm_labels=labels)
        np.testing.assert_allclose(losses.detach().numpy(),
                                   bert_run["losses"], rtol=1e-4, atol=1e-5)
        (losses.mean() + (binary * torch.from_numpy(BINARY_W)).sum()
         ).backward()
        # tests/test_torch_bert_masked.py's gradient tolerance
        _assert_grads(dict(model.named_parameters()), bert_run["grads"], 2e-5)

    def test_padded_rows_attend_uniformly_as_in_jax(self, bert_run):
        """A padded query row has every key masked: under the masked
        softmax kernel (-10000 fill) it averages v over all keys, JAX's
        value on this path, where the flash path gives 0. The first
        layer's attention output (the dense projection of the context;
        the biases are 0) shows it."""
        tokens, _, types, mask = _long(*_bert_batch())
        got = {}
        for impl in ("fused_softmax", "flash"):
            cfg = _tcfg(BertConfig, BERT_SHAPE, attention_impl=impl)
            model = from_jax_params(bert_run["tree"], cfg, device="cpu")
            attn = model.transformer.layer_0.self_attention
            handle = attn.register_forward_hook(
                lambda mod, inp, out: got.__setitem__(impl, out.detach()))
            with torch.no_grad():
                model(tokens, attention_mask=mask, tokentype_ids=types)
            handle.remove()
        n = LENGTHS[1]
        fused, flash = got["fused_softmax"].numpy(), got["flash"].numpy()
        np.testing.assert_allclose(fused, bert_run["attn0"], **LOGIT_TOL)
        assert np.abs(fused[1, n:]).min(axis=-1).max() > 0.0
        assert np.abs(fused[1, n:]).max() > 1e-3
        assert np.all(flash[1, n:] == 0.0)
        # the live rows agree between the two paths
        np.testing.assert_allclose(fused[1, :n], flash[1, :n], rtol=1e-4,
                                   atol=1e-5)


class TestOptions:
    def test_use_pallas_softmax_false_matches_jax(self, gpt_run, bert_run):
        """Plain softmaxes with -inf fills for both mask types: GPT's
        logits as JAX's; BERT's padded query rows have every key at -inf,
        so they are NaN, and the NaN reaches the same logits on both
        sides, the unpadded sequence staying finite."""
        off = dict(use_pallas_softmax=False)
        tokens, _ = _gpt_batch()
        jlogits = JaxGPTModel(_jcfg(JaxGPTConfig, GPT_SHAPE, **off)).apply(
            jax.tree_util.tree_map(jnp.asarray, gpt_run["tree"]),
            jnp.asarray(tokens))
        model = from_jax_params(gpt_run["tree"],
                                _tcfg(GPTConfig, GPT_SHAPE, **off),
                                device="cpu")
        with torch.no_grad():
            logits = model(_long(tokens)[0])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(logits.numpy(), gpt_run["logits"],
                                   **LOGIT_TOL)

        btokens, _, _, mask = _bert_batch()
        jb, _ = JaxBertModel(_jcfg(JaxBertConfig, BERT_SHAPE, **off)).apply(
            jax.tree_util.tree_map(jnp.asarray, bert_run["tree"]),
            jnp.asarray(btokens), attention_mask=jnp.asarray(mask))
        bmodel = from_jax_params(bert_run["tree"],
                                 _tcfg(BertConfig, BERT_SHAPE, **off),
                                 device="cpu")
        with torch.no_grad():
            blogits, _ = bmodel(*_long(btokens), attention_mask=_long(mask)[0])
        blogits, jb = blogits.numpy(), np.asarray(jb)
        np.testing.assert_array_equal(np.isnan(blogits), np.isnan(jb))
        assert np.isnan(blogits[1]).any() and np.isfinite(blogits[0]).all()
        np.testing.assert_allclose(blogits[0], jb[0], **LOGIT_TOL)

    @pytest.mark.parametrize("field,value,item", [
        ("tensor_parallel_size", 2, 8),
        ("checkpoint_activations", True, 10),
        ("apply_residual_connection_post_layernorm", True, 10),
        ("sequence_parallel", True, 10),
    ])
    def test_unported_options_name_their_current_roadmap_item(
            self, field, value, item):
        """Each refusal names the ROADMAP Queue 1 item that holds it
        now."""
        with pytest.raises(NotImplementedError,
                           match=rf"{field}.*ROADMAP Queue 1 item {item}\b"):
            _tcfg(GPTConfig, GPT_SHAPE, **{field: value})


class TestProbabilityDropout:
    """The probabilities' dropout on this path (a plain op seeded per
    layer, `models.gpt._dropout`), tested the three ways of ROADMAP's
    parity rules: the keep fraction, kept elements equal to p / (1 - r),
    and a backward that uses the forward's mask."""

    RATE = 0.25

    def _attention(self, gpt_run):
        cfg = _tcfg(GPTConfig, GPT_SHAPE, attention_dropout=self.RATE)
        model = from_jax_params(gpt_run["tree"], cfg, device="cpu")
        x = torch.from_numpy(np.random.default_rng(23).standard_normal(
            (BATCH, SEQ, GPT_SHAPE["hidden_size"])).astype(np.float32))
        return model.transformer.layer_0.self_attention, x

    def test_keep_fraction_and_kept_values(self, gpt_run, monkeypatch):
        attn, x = self._attention(gpt_run)
        seen = []
        real = port_gpt._dropout

        def spy(p, seed, rate):
            out = real(p, seed, rate)
            seen.append((p.detach(), out.detach(), rate))
            return out

        monkeypatch.setattr(port_gpt, "_dropout", spy)
        with torch.no_grad():
            attn(x, dropout_seed=1234)
        (p, out, rate), = seen
        assert rate == self.RATE and p.shape == (BATCH, 4, SEQ, SEQ)
        # the causal upper triangle is 0 before and after; count the rest
        live = p > 0
        kept = (out != 0) & live
        frac = float(kept.sum()) / float(live.sum())
        n = float(live.sum())
        # within 5 binomial standard deviations of 1 - r
        assert abs(frac - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
        torch.testing.assert_close(out[kept], p[kept] / (1 - rate),
                                   rtol=0, atol=0)
        assert torch.all(out[live & ~kept] == 0)
        # the same seed draws the same mask, another seed another
        with torch.no_grad():
            attn(x, dropout_seed=1234)
            attn(x, dropout_seed=99)
        assert torch.equal(seen[1][1], out)
        assert not torch.equal(seen[2][1], out)

    def test_backward_uses_the_forward_mask(self, gpt_run, monkeypatch):
        """The VJP with dropout equals the VJP of the same attention with
        the mask recovered from the forward's output fixed in place."""
        attn, x = self._attention(gpt_run)
        seen = []
        real = port_gpt._dropout

        def spy(p, seed, rate):
            out = real(p, seed, rate)
            seen.append(out.detach() != 0)
            return out

        g = torch.from_numpy(np.random.default_rng(29).standard_normal(
            (BATCH, SEQ, GPT_SHAPE["hidden_size"])).astype(np.float32))

        def vjp():
            xg = x.clone().requires_grad_(True)
            for prm in attn.parameters():
                prm.grad = None
            y = attn(xg, dropout_seed=7)
            y.backward(g)
            return [y.detach(), xg.grad] + [prm.grad.clone()
                                            for prm in attn.parameters()]

        monkeypatch.setattr(port_gpt, "_dropout", spy)
        a = vjp()
        keep = seen[0]

        def fixed(p, seed, rate):
            return torch.where(keep, p / (1.0 - rate), 0.0).to(p.dtype)

        monkeypatch.setattr(port_gpt, "_dropout", fixed)
        b = vjp()
        for u, v in zip(a, b):
            torch.testing.assert_close(u, v, rtol=0, atol=0)


# tests/L0/test_inference.py's engine shapes (its JAX programs compile
# once for both files), under "fused_softmax"
ENGINE_SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
                    num_attention_heads=4, max_position_embeddings=32,
                    tensor_parallel_size=1)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(30, 48)), [10], [60, 61]]


def test_engine_greedy_tokens_match_jax():
    """The cached paths keep the flash kernels under "fused_softmax", as
    the JAX model does (it tests for "jnp" only): the engine serves such
    a model and its greedy tokens equal the JAX engine's."""
    tree = random_params(_tcfg(GPTConfig, ENGINE_SHAPE), seed=7)
    jeng = JaxEngine(
        JaxGPTModel(_jcfg(JaxGPTConfig, ENGINE_SHAPE, **NO_DROPOUT)),
        jax.tree_util.tree_map(jnp.asarray, tree),
        sampling=JaxSamplingParams(temperature=0.0), **ENGINE)
    eng = InferenceEngine(
        from_jax_params(tree, _tcfg(GPTConfig, ENGINE_SHAPE), device="cpu"),
        sampling=SamplingParams(temperature=0.0), **ENGINE)
    want = [(r.tokens, r.finish_reason)
            for r in jeng.generate(PROMPTS, max_new_tokens=6)]
    got = [(r.tokens, r.finish_reason)
           for r in eng.generate(PROMPTS, max_new_tokens=6)]
    assert got == want
