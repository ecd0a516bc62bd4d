"""The port's paged serving engine against the JAX paged engine, on the CPU.

The geometry of tests/L0/test_paging.py (the tiny fp32 GPT, 2 slots,
capacity 24, budget 4), so the JAX engines run the programs that file
compiles. Both engines get the same numpy-drawn weights; under greedy
sampling their tokens, finish reasons and paging counters (pages in use,
prefix hits, copy-on-write forks, page stalls) must be identical, at a
page size that divides capacity and one that does not, with int8 pages,
with prefix sharing, and under pool pressure.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import InferenceEngine, SamplingParams
from rocm_apex_tpu_torch.models.gpt import GPTConfig

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(10, 18)),
           list(range(30, 48))]
SYS_PREFIX = list(range(40, 51))  # 11 tokens: not page-aligned at 4 or 5
COUNTERS = ("prefix_hits", "prefix_hit_tokens", "cow_forks", "page_stalls",
            "preemptions", "pages_used", "pages_total")


@pytest.fixture(scope="module")
def engines():
    tcfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(tcfg, seed=7)
    jmodel = JaxGPTModel(JaxGPTConfig(
        **SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
        params_dtype=jnp.float32, dtype=jnp.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(tree, tcfg, device="cpu")

    def make(jax_side, **kw):
        kw = {**ENGINE, **kw}
        if jax_side:
            if kw.get("kv_dtype") is torch.int8:
                kw["kv_dtype"] = jnp.int8
            return JaxEngine(jmodel, jparams,
                             sampling=JaxSamplingParams(temperature=0.0),
                             **kw)
        return InferenceEngine(model, sampling=SamplingParams(temperature=0.0),
                               **kw)

    return make


def _run(eng, prompts, max_new):
    return [(r.tokens, r.finish_reason)
            for r in eng.generate(prompts, max_new_tokens=max_new)]


def _counters(eng):
    s = eng.stats()
    return {k: s[k] for k in COUNTERS}


@pytest.mark.parametrize("page_size", [4, 5])
def test_tokens_match_jax_paged_engine_and_contiguous(engines, page_size):
    """Paged greedy tokens equal the JAX paged engine's and the port's
    contiguous engine's; the device capacity rounds up to whole pages
    (25 at page size 5) while the host bound stays 24."""
    eng = engines(False, paged=True, page_size=page_size)
    got = _run(eng, PROMPTS, 4)
    assert eng.cache.capacity == (24 if page_size == 4 else 25)
    assert got == _run(engines(True, paged=True, page_size=page_size),
                       PROMPTS, 4)
    assert got == _run(engines(False), PROMPTS, 4)
    assert all(reason == "length" for _, reason in got)
    assert eng.pages_used == 0
    eng._allocator.assert_consistent()


def test_int8_tokens_match_jax_int8_engine(engines):
    eng = engines(False, paged=True, page_size=4, kv_dtype=torch.int8)
    want_eng = engines(True, paged=True, page_size=4, kv_dtype=torch.int8)
    assert _run(eng, PROMPTS, 4) == _run(want_eng, PROMPTS, 4)
    assert eng.cache.k[0].dtype == torch.int8
    assert eng.cache_bytes() == want_eng.cache_bytes()


def test_prefix_sharing_matches_jax(engines):
    """A request, then two that share its non-page-aligned prefix (one
    diverging inside a shared page: a copy-on-write fork), then two in
    flight at once: the same tokens, hits, hit tokens and forks as the
    JAX engine, and the same tokens as the unshared engine."""
    p_a = SYS_PREFIX + [1, 2, 3]
    p_b = SYS_PREFIX + [7, 8]
    p_c = SYS_PREFIX[:6] + [9, 9, 9]
    waves = [[p_a], [p_b], [p_c], [SYS_PREFIX + [11, 12], SYS_PREFIX + [13]]]
    runs = {}
    for jax_side in (False, True):
        eng = engines(jax_side, paged=True, page_size=4, prefix_sharing=True)
        runs[jax_side] = ([_run(eng, w, 4) for w in waves], _counters(eng))
    assert runs[False] == runs[True]
    tokens, counters = runs[False]
    assert counters["prefix_hits"] > 0 and counters["cow_forks"] > 0
    unshared = engines(False, paged=True, page_size=4)
    assert tokens == [_run(unshared, w, 4) for w in waves]


def test_small_pool_stalls_like_jax(engines):
    """Three pages for two 8-token prompts: the same page stalls, tokens
    and drained pool as the JAX engine."""
    prompts = [list(range(1, 9)), list(range(9, 17))]
    runs = {}
    for jax_side in (False, True):
        eng = engines(jax_side, paged=True, page_size=4, num_pages=3)
        runs[jax_side] = (_run(eng, prompts, 3), _counters(eng))
    assert runs[False] == runs[True]
    assert runs[False][1]["page_stalls"] > 0
    assert runs[False][1]["pages_used"] == 0.0
    assert all(reason == "length" for _, reason in runs[False][0])


def test_preemption_keeps_tokens_like_jax(engines):
    """A pool that two growing requests cannot share: the youngest is
    preempted, requeued with its tokens and recomputed; the same tokens
    and preemptions as the JAX engine, and as the contiguous engine."""
    prompts = [list(range(1, 7)), list(range(20, 26))]
    runs = {}
    for jax_side in (False, True):
        eng = engines(jax_side, paged=True, page_size=4, num_pages=4)
        runs[jax_side] = (_run(eng, prompts, 6), _counters(eng))
    assert runs[False] == runs[True]
    assert runs[False][1]["preemptions"] > 0
    assert runs[False][0] == _run(engines(False), prompts, 6)


def test_unservable_pool_raises_deadlock(engines):
    eng = engines(False, paged=True, page_size=4, num_pages=1)
    eng.add_request(list(range(1, 9)), max_new_tokens=2)
    with pytest.raises(RuntimeError, match="deadlock"):
        for _ in range(4):
            eng.step()


def test_pages_used_per_step_match_jax(engines):
    """Pages follow live tokens: one page after the first 4-token chunk,
    two once the fifth token and the first decode row land, none after
    the drain; the same on both engines, step by step."""
    seen = {}
    for jax_side in (False, True):
        eng = engines(jax_side, paged=True, page_size=4)
        eng.add_request([1, 2, 3, 4, 5], max_new_tokens=4)
        used = []
        for _ in range(2):
            eng.step()
            used.append(eng.stats()["pages_used"])
        while eng.has_work():
            eng.step()
        used.append(eng.stats()["pages_used"])
        seen[jax_side] = used
    assert seen[False] == seen[True] == [1.0, 2.0, 0.0]


@pytest.mark.parametrize("kw, error, match", [
    (dict(paged=True, flight_recorder=object()), NotImplementedError,
     "not ported"),
    (dict(paged=True, timeseries=object()), NotImplementedError, "item 9"),
    (dict(paged=True, adapter_pool=object()), NotImplementedError,
     "not ported"),
    (dict(paged=True, tracer=object()), NotImplementedError, "not ported"),
    (dict(prefix_sharing=True), ValueError, "paged=True"),
    (dict(kv_dtype=torch.int8), ValueError, "paged=True"),
])
def test_unported_and_invalid_options_raise(engines, kw, error, match):
    with pytest.raises(error, match=match):
        engines(False, **kw)
