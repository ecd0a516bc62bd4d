"""The port's whole-prompt serving path against the JAX package, on the
CPU: the cached GPT on a window wider than one token (causal unpacked
flash attention over the fresh window), the cache's one-slot view, and
the engine's ``prefill_token_budget=None`` path.

The shapes are tests/L0/test_inference.py's (the tiny fp32 GPT, 2 slots,
capacity 24, the whole-prompt pad width 24), so the JAX engine's
programs are the ones that file compiles. Both sides get the same
numpy-drawn weights; the JAX side runs its Pallas kernels in interpret
mode, the port its kernels' plain versions. Logits agree to atol 1e-4
(fp32 on both sides, summation order only); greedy tokens and finish
reasons must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import KVCache as JaxKVCache
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    InferenceEngine,
    KVCache,
    SamplingParams,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=None,
              max_prompt_len=24)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# slot reuse (5 requests through 2 slots), prompts from 1 to 18 tokens
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(30, 48)), [10], [60, 61]]


def torch_cfg():
    return GPTConfig(**SHAPE, params_dtype=torch.float32,
                     dtype=torch.float32)


@pytest.fixture(scope="module")
def models():
    tree = random_params(torch_cfg(), seed=7)
    jmodel = JaxGPTModel(JaxGPTConfig(**SHAPE, **NO_DROPOUT,
                                      params_dtype=jnp.float32,
                                      dtype=jnp.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jmodel, jparams, from_jax_params(tree, torch_cfg(), device="cpu")


def _engines(models, jax_side, **kw):
    jmodel, jparams, model = models
    kw = {**ENGINE, **kw}
    if jax_side:
        return JaxEngine(jmodel, jparams,
                         sampling=JaxSamplingParams(temperature=0.0), **kw)
    return InferenceEngine(model, sampling=SamplingParams(temperature=0.0),
                           **kw)


def _run(eng, prompts, max_new):
    return [(r.tokens, r.finish_reason)
            for r in eng.generate(prompts, max_new_tokens=max_new)]


class TestCachedWindow:
    def test_whole_prompt_logits_and_cache_match_jax(self, models):
        """A (1, 12) window into an empty slot of a one-slot view (the
        engine's prefill unit): logits, the written K/V rows and the
        advanced length as JAX; then a decode step on top reads them."""
        jmodel, jparams, model = models
        rng = np.random.default_rng(3)
        toks = rng.integers(0, SHAPE["vocab_size"], (1, 12)).astype(np.int32)
        jcache = JaxKVCache.for_model(jmodel.cfg, 1, 24)
        cache = KVCache.for_model(torch_cfg(), 1, 24, device="cpu")
        jlog, jcache = jmodel.apply(jparams, jnp.asarray(toks), cache=jcache)
        tlog, cache = model(torch.from_numpy(toks).long(), cache=cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(cache.lengths.numpy(),
                                      np.asarray(jcache.lengths))
        for a, b in zip(cache.k + cache.v, jcache.k + jcache.v):
            np.testing.assert_allclose(a[:, :12].numpy(),
                                       np.asarray(b)[:, :12], **LOGIT_TOL)
        dec = np.array([[int(np.asarray(jlog)[0, -1].argmax())]], np.int32)
        jlog, jcache = jmodel.apply(jparams, jnp.asarray(dec), cache=jcache)
        tlog, cache = model(torch.from_numpy(dec).long(), cache=cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        assert int(cache.lengths[0]) == 13

    def test_slot_view_writes_in_place_and_write_back_commits(self):
        """The one-slot view's rows are the cache's own (a forward writes
        them in place); write_back commits its length."""
        cache = KVCache.create(1, 3, 8, 2, 4, dtype=torch.float32,
                               device="cpu")
        cache.lengths = torch.tensor([5, 0, 2], dtype=torch.int32)
        sub = cache.slot_view(1)
        assert sub.num_slots == 1 and int(sub.lengths[0]) == 0
        sub.k[0][0, 3] = 1.0
        assert bool((cache.k[0][1, 3] == 1.0).all())
        sub.lengths = torch.tensor([6], dtype=torch.int32)
        assert int(cache.lengths[1]) == 0  # not committed yet
        assert cache.write_back(1, sub) is cache
        assert cache.lengths.tolist() == [5, 6, 2]
        assert bool((cache.k[0][[0, 2]] == 0.0).all())


class TestWholePromptEngine:
    def test_tokens_match_jax_engine_and_the_chunked_engine(self, models):
        got = _run(_engines(models, False), PROMPTS, 5)
        want = _run(_engines(models, True), PROMPTS, 5)
        assert got == want
        assert all(reason == "length" for _, reason in got)
        chunked = _run(_engines(models, False, prefill_token_budget=4),
                       PROMPTS, 5)
        assert got == chunked

    def test_eos_and_capacity_finishes_match_jax_engine(self, models):
        """eos at the second request's third greedy token; a 21-token
        prompt in a 24-row cache emits 4 tokens."""
        ref = _run(_engines(models, False), PROMPTS[:2], 5)
        eos = ref[1][0][2]
        prompts = [PROMPTS[1], list(range(40, 61))]
        got = _run(_engines(models, False, eos_id=eos), prompts, 8)
        want = _run(_engines(models, True, eos_id=eos), prompts, 8)
        assert got == want
        assert got[0][1] == "eos" and got[0][0][-1] == eos
        assert got[1][1] == "capacity" and len(got[1][0]) == 4

    def test_a_narrow_pad_width_matches_jax_engine(self, models):
        """max_prompt_len 8: a prompt pads to 8 positions, decode
        overwrites the pads; a prompt longer than the pad width is
        refused, as in JAX."""
        prompts = [p for p in PROMPTS if len(p) <= 8]
        got = _run(_engines(models, False, max_prompt_len=8), prompts, 6)
        want = _run(_engines(models, True, max_prompt_len=8), prompts, 6)
        assert got == want
        eng = _engines(models, False, max_prompt_len=8)
        with pytest.raises(ValueError, match="max_prompt_len=8"):
            eng.add_request(list(range(9)), 4)

    def test_one_prefill_per_admit_then_the_decode_grid(self, models):
        """A tick admits into every free slot (a prefill each, the first
        token sampled there), then decodes the grid once: two tokens per
        admitted request in its first tick."""
        eng = _engines(models, False)
        for p in PROMPTS[:3]:
            eng.add_request(p, 6)
        eng.step()
        assert [len(s.generated) for s in eng._slots] == [2, 2]
        assert eng.num_queued == 1
        s = eng.stats()
        assert s["admitted"] == 2.0 and s["mixed_steps"] == 0.0
        assert s["decode_steps"] == s["decode_only_steps"] == 1.0
        assert s["prefill_ms_avg"] > 0.0
        assert s["prompt_tokens"] == len(PROMPTS[0]) + len(PROMPTS[1])

    def test_the_paged_cache_refuses_the_whole_prompt_path(self, models):
        with pytest.raises(ValueError, match="prefill_token_budget"):
            _engines(models, False, paged=True)
        with pytest.raises(ValueError, match="max_prompt_len"):
            _engines(models, False, max_prompt_len=25)
