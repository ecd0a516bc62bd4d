"""The port's `attention_impl="jnp"` against the JAX package, on the CPU.

The one-pass reference attention on every path of the GPT: the uncached
materialized softmax (logits, the mean loss and every gradient), and the
serving engine's greedy tokens under "jnp" on the contiguous cache
(chunked prefill: the packed chunk's bounded softmax over its slot's
cache rows, then the decode's), on pages (fp32 and int8: `paged_view`,
dequantized) and on the whole-prompt path (the causal prefill), each
against the JAX engine under "jnp" on the same numpy-drawn weights.
The port reaches no attention kernel or plain version of one on these
paths (checked by replacing them with functions that raise). Both sides
compute in fp32 and differ in summation order only: logits to 1e-4,
gradients to 1e-5 relative; greedy tokens and finish reasons identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams
from rocm_apex_tpu_torch.models import gpt as port_gpt
from rocm_apex_tpu_torch.models.gpt import GPTConfig

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1, hidden_dropout=0.0,
             attention_dropout=0.0)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# slot reuse (5 requests through 2 slots), prompts of 1 to 18 tokens
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(30, 48)), [10], [60, 61]]
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4)
# the attention functions the "jnp" paths must not reach
ATTENTION_FNS = ("flash_attention_decode", "flash_attention_decode_paged",
                 "flash_attention_heads", "flash_attention_qkv_bias",
                 "flash_attention_qkv_bias_dropout",
                 "flash_attention_chunk_paged",
                 "flash_attention_segments_with_lse",
                 "scaled_masked_softmax",
                 "scaled_upper_triang_masked_softmax",
                 "ring_flash_attention")


def torch_cfg(**kw):
    return GPTConfig(**SHAPE, params_dtype=torch.float32,
                     dtype=torch.float32, attention_impl="jnp", **kw)


@pytest.fixture(scope="module")
def models():
    tree = random_params(torch_cfg(), seed=11)
    jmodel = JaxGPTModel(JaxGPTConfig(**SHAPE, params_dtype=jnp.float32,
                                      dtype=jnp.float32,
                                      attention_impl="jnp"))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jmodel, jparams, from_jax_params(tree, torch_cfg(), device="cpu")


@pytest.fixture
def no_attention_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an attention kernel on the jnp path")

    for name in ATTENTION_FNS:
        monkeypatch.setattr(port_gpt, name, refuse)


def _batch():
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, SHAPE["vocab_size"], (2, 20)).astype(np.int32)
    return tokens, np.roll(tokens, -1, 1)


def test_uncached_logits_loss_and_gradients_match_jax(models,
                                                      no_attention_kernel):
    jmodel, jparams, model = models
    tokens, labels = _batch()
    jlogits = jmodel.apply(jparams, jnp.asarray(tokens))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jnp.asarray(tokens),
                               labels=jnp.asarray(labels),
                               loss_reduction="mean"))(jparams)
    t, lbl = torch.from_numpy(tokens).long(), torch.from_numpy(labels).long()
    with torch.no_grad():
        logits = model(t)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    model.zero_grad()
    loss = model(t, labels=lbl, loss_reduction="mean")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(jgrads["params"])
    params = dict(model.named_parameters())
    assert set(flat) == set(params)
    for k, g in flat.items():
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _engines(models, jax_side, **kw):
    jmodel, jparams, model = models
    kw = {**ENGINE, **kw}
    if jax_side:
        if kw.get("kv_dtype") is torch.int8:
            kw["kv_dtype"] = jnp.int8
        return JaxEngine(jmodel, jparams,
                         sampling=JaxSamplingParams(temperature=0.0), **kw)
    return InferenceEngine(model, sampling=SamplingParams(temperature=0.0),
                           **kw)


def _run(eng, prompts, max_new):
    return [(r.tokens, r.finish_reason)
            for r in eng.generate(prompts, max_new_tokens=max_new)]


ENGINE_FORMS = {
    "contiguous": dict(),
    "paged": dict(paged=True, page_size=4),
    "paged_int8": dict(paged=True, page_size=4, kv_dtype=torch.int8),
    "whole_prompt": dict(prefill_token_budget=None, max_prompt_len=24),
}


@pytest.mark.parametrize("form", list(ENGINE_FORMS))
def test_engine_greedy_tokens_match_jax(models, form, no_attention_kernel):
    kw = ENGINE_FORMS[form]
    got = _run(_engines(models, False, **kw), PROMPTS, 5)
    want = _run(_engines(models, True, **kw), PROMPTS, 5)
    assert got == want
    assert all(reason == "length" for _, reason in got)


def test_chunk_attends_its_own_slot_prefix_only(models):
    """The packed chunk's reference read equals a per-token softmax over
    its own slot's rows [0, pos + 1) (the one-hot contraction picks the
    slot; a pad's id clamps onto the last slot)."""
    rng = np.random.default_rng(2)
    slots_n, cap, nh, hd, t = 3, 10, 2, 8, 7
    kc = torch.tensor(rng.standard_normal((slots_n, cap, nh, hd)),
                      dtype=torch.float32)
    vc = torch.tensor(rng.standard_normal((slots_n, cap, nh, hd)),
                      dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((t, nh, hd)), dtype=torch.float32)
    slots = torch.tensor([2, 0, 0, 1, 2, 3, 3], dtype=torch.int32)
    pos = torch.tensor([4, 0, 1, 6, 5, 0, 0], dtype=torch.int32)
    got = port_gpt._reference_chunk(q, kc, vc, slots, pos, 0.5)
    for i in range(t):
        s = min(int(slots[i]), slots_n - 1)
        n = int(pos[i]) + 1
        p = torch.softmax(torch.einsum("nd,cnd->nc", q[i], kc[s, :n]) * 0.5,
                          -1)
        want = torch.einsum("nc,cnd->nd", p, vc[s, :n])
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
