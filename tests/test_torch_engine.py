"""The port's serving engine and sampling against the JAX package, on
the CPU.

The engine shapes are those of tests/L0/test_inference.py (the tiny fp32
GPT, 2 slots, capacity 24, budget 4), so the JAX engine's programs are
the ones that file compiles. Both engines get the same numpy-drawn
weights; under greedy sampling their tokens and finish reasons must be
identical, through slot reuse, a prompt longer than the budget, and the
eos and capacity finishes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.inference import top_k_logits as jax_top_k
from rocm_apex_tpu.inference import top_p_logits as jax_top_p
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    InferenceEngine,
    SamplingParams,
    greedy,
    sample,
    top_k_logits,
    top_p_logits,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.monitor import (
    NULL_REGISTRY,
    NULL_TRACER,
    FlightRecorder,
    MetricRegistry,
    TimeSeriesStore,
    Tracer,
)

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
# the port's config has no dropout fields: its cached forward has none
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4)

# slot reuse (5 requests through 2 slots) and an 18-token prompt that
# streams through the 4-token budget in 5 ticks
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], list(range(30, 48)), [10], [60, 61]]


@pytest.fixture(scope="module")
def engines():
    tree = random_params(
        GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32),
        seed=7,
    )
    jmodel = JaxGPTModel(
        JaxGPTConfig(**SHAPE, **NO_DROPOUT, params_dtype=jnp.float32,
                     dtype=jnp.float32)
    )
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(
        tree,
        GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32),
        device="cpu",
    )

    def make(jax_side, **kw):
        kw = {**ENGINE, **kw}
        if jax_side:
            return JaxEngine(jmodel, jparams,
                             sampling=JaxSamplingParams(temperature=0.0),
                             **kw)
        return InferenceEngine(model, sampling=SamplingParams(temperature=0.0),
                               **kw)

    return make


def _run(eng, prompts, max_new):
    return [(r.tokens, r.finish_reason)
            for r in eng.generate(prompts, max_new_tokens=max_new)]


class TestGreedyParity:
    def test_tokens_match_jax_engine(self, engines):
        got = _run(engines(False), PROMPTS, 5)
        want = _run(engines(True), PROMPTS, 5)
        assert got == want
        assert all(reason == "length" for _, reason in got)

    def test_eos_and_capacity_finishes_match_jax_engine(self, engines):
        """eos: stop at the token the second request's greedy stream
        emits third. capacity: a 21-token prompt in a 24-row cache
        emits 4 tokens (its last decode writes row 23)."""
        ref = _run(engines(False), PROMPTS[:2], 5)
        eos = ref[1][0][2]
        prompts = [PROMPTS[1], list(range(40, 61))]
        got = _run(engines(False, eos_id=eos), prompts, 8)
        want = _run(engines(True, eos_id=eos), prompts, 8)
        assert got == want
        assert got[0][1] == "eos" and got[0][0][-1] == eos
        assert got[1][1] == "capacity" and len(got[1][0]) == 4

    def test_prefill_chunk_cap_matches_jax_engine(self, engines):
        """``prefill_chunk`` caps one request's share of the budget: the
        schedule changes, the greedy tokens do not."""
        got = _run(engines(False, prefill_chunk=2), PROMPTS[:3], 3)
        want = _run(engines(True, prefill_chunk=2), PROMPTS[:3], 3)
        assert got == want == _run(engines(False), PROMPTS[:3], 3)

    def test_decode_every_tick_while_a_long_prompt_streams(self, engines):
        eng = engines(False)
        eng.add_request([1, 2, 3], max_new_tokens=20)
        eng.step()  # prefill + fed-through decode: two tokens
        assert len(eng._slots[0].generated) == 2
        eng.add_request(list(range(5, 21)), max_new_tokens=4)
        for _ in range(4):
            before = len(eng._slots[0].generated)
            eng.step()
            assert len(eng._slots[0].generated) == before + 1
        assert len(eng._slots[1].generated) == 2


class TestEngineSurface:
    def test_stats_report_ttft_and_tokens(self, engines):
        eng = engines(False)
        assert eng.stats()["ttft_ms_p95"] == 0.0
        results = eng.generate(PROMPTS[:3], max_new_tokens=3)
        s = eng.stats()
        assert s["admitted"] == 3.0 and s["mixed_steps"] >= 1.0
        assert s["generated_tokens"] == sum(len(r.tokens) for r in results)
        assert s["prompt_tokens"] == sum(len(p) for p in PROMPTS[:3])
        assert s["ttft_ms_p95"] >= s["ttft_ms_p50"] > 0.0
        assert s["ttft_ms_p50"] >= s["queue_wait_ms_p50"] >= 0.0
        assert len(eng.completions) == 3
        eng.reset_stats()
        assert eng.stats()["generated_tokens"] == 0.0

    @pytest.mark.parametrize("kw", [
        dict(paged=True, registry=MetricRegistry(), retrace_policy="count"),
        dict(paged=True, tracer=Tracer(), retrace_policy="raise"),
        dict(flight_recorder=FlightRecorder(), retrace_policy="count"),
        dict(timeseries=TimeSeriesStore(MetricRegistry()),
             retrace_policy="count"),
        dict(registry=NULL_REGISTRY, tracer=NULL_TRACER,
             retrace_policy="raise"),
        dict(tracer=Tracer(), retrace_policy="count"),
        dict(registry=MetricRegistry(), retrace_policy="raise"),
    ])
    def test_unported_options_raise(self, engines, kw):
        """The monitor options are taken; the retrace sentinel
        (``retrace_policy``) is refused whatever comes with it."""
        with pytest.raises(NotImplementedError,
                           match="not ported.*item 9b"):
            engines(False, **kw)

    def test_request_validation(self, engines):
        eng = engines(False)
        with pytest.raises(ValueError, match="non-empty"):
            eng.add_request([], 4)
        with pytest.raises(ValueError, match="capacity"):
            eng.add_request(list(range(25)), 4)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.add_request([1], 0)


class TestSampling:
    def _logits(self, shape=(3, 64), seed=0):
        return (np.random.default_rng(seed).standard_normal(shape) * 3.0
                ).astype(np.float32)

    def test_filters_match_jax(self):
        x = self._logits()
        np.testing.assert_array_equal(
            top_k_logits(torch.from_numpy(x), 5).numpy(),
            np.asarray(jax_top_k(jnp.asarray(x), 5)),
        )
        np.testing.assert_allclose(
            top_p_logits(torch.from_numpy(x), 0.7).numpy(),
            np.asarray(jax_top_p(jnp.asarray(x), 0.7)),
        )

    def test_top_k_restricts_support(self):
        x = torch.from_numpy(self._logits((2, 64)))
        top = [set(torch.topk(x[r], 5).indices.tolist()) for r in range(2)]
        gen = torch.Generator().manual_seed(0)
        for _ in range(20):
            tok = sample(x, temperature=1.0, top_k=5, generator=gen)
            assert all(int(tok[r]) in top[r] for r in range(2))

    def test_top_p_keeps_minimal_nucleus(self):
        x = torch.tensor([[10.0, 1.0, 0.5, 0.0]])
        masked = top_p_logits(x, 0.5)
        assert masked[0, 0] == 10.0 and torch.all(masked[0, 1:] < -1e29)
        assert torch.equal(top_p_logits(x, 1.0), x)
        gen = torch.Generator().manual_seed(1)
        for _ in range(10):
            assert int(sample(x, top_p=0.5, generator=gen)[0]) == 0

    def test_greedy_and_seeded_replay(self):
        x = torch.from_numpy(self._logits())
        assert torch.equal(sample(x, temperature=0.0), greedy(x))
        a = sample(x, 0.8, 8, 0.9, generator=torch.Generator().manual_seed(3))
        b = sample(x, 0.8, 8, 0.9, generator=torch.Generator().manual_seed(3))
        assert torch.equal(a, b)

    def test_filter_validation(self):
        x = torch.from_numpy(self._logits())
        with pytest.raises(ValueError, match="top_k"):
            top_k_logits(x, 0)
        with pytest.raises(ValueError, match="top_p"):
            top_p_logits(x, 0.0)
