"""Tensor-parallel serving at tp=2 against the JAX package, on the CPU.

Mirrors JAX tests/L0/test_disagg.py's `TestMixedTP`, `test_ship_tp2`
and `TestDeadStepRepoint::test_dead_entries_never_fetched_per_shard_
heads`, and the tp>1 construction errors (JAX tests/L0/
test_inference.py:443-448 among them), at that file's shapes: the tiny
fp32 GPT (vocab 96, hidden 32, 2 layers, 4 heads), 2 slots, capacity 24,
budget 4, pages of 4. Two ranks of a gloo group (spawned once for the
module, `_torch_tp_ranks.run`'s ``"serve"`` suite, 60 s timeouts) serve
on weights `shard_tp1_params` slices from one tp=1 tree; the JAX tp=1
engine and the port's tp=1 engine run here on the same tree.

Tokens are compared for equality. Shipped payloads: their layout is a
tp=1 engine's (every head), both ranks hold the same bits, layer 0's
pools and scales equal the tp=1 engine's payload bit for bit, and later
layers within 1e-6 of their scale (one int8 step on int8 pools): from
layer 1 on the row-parallel sums add two partial products, where tp=1
adds one, so an fp32 value may move by an ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as R
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops.flash_attention import (
    flash_attention_decode_paged as jax_decode_paged,
)
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
)
from rocm_apex_tpu_torch.inference import InferenceEngine
from rocm_apex_tpu_torch.models.gpt import GPTModel
from rocm_apex_tpu_torch.ops.flash_attention import (
    flash_attention_decode_paged,
)

FORMS = {"float": {}, "int8": dict(kv_dtype=torch.int8)}
SHIP_RTOL = 1e-6
DECODE_TOL = dict(rtol=2e-5, atol=2e-5)  # JAX's, against its reference


def _jax_tokens(tree, **kw):
    if kw.get("kv_dtype") is torch.int8:
        kw["kv_dtype"] = jnp.int8
    model = JaxGPTModel(JaxGPTConfig(
        **R.GPT_SHAPE, tensor_parallel_size=1, hidden_dropout=0.0,
        attention_dropout=0.0, params_dtype=jnp.float32, dtype=jnp.float32))
    eng = JaxEngine(model, tree, sampling=JaxSamplingParams(temperature=0.0),
                    seed=0, **{**R.ENGINE, **kw})
    return [(r.tokens, r.finish_reason)
            for r in eng.generate(R.PROMPTS, max_new_tokens=R.MAX_NEW)], eng


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tree = random_params(R.gpt_config(1), seed=1)
    inputs = {f"p.{k}": v for k, v in flatten_params(tree["params"]).items()}
    outs = R.spawn(tmp_path_factory.mktemp("serve_tp"), "serve", inputs)
    tp1 = from_jax_params(tree, R.gpt_config(1), device="cpu")
    ref = {}
    for form, kw in FORMS.items():
        ref[f"{form}_jax"], jeng = _jax_tokens(tree, **kw)
        ref[f"{form}_jax_kv_bytes"] = jeng.per_chip_kv_bytes()
        eng = R._engine(tp1, **kw)
        ref[f"{form}_tp1"] = R._tokens(eng)
        ref[f"{form}_tp1_kv_bytes"] = eng.per_chip_kv_bytes()
        ref[f"{form}_tp1_base2"] = R._tokens(R._engine(tp1, **kw),
                                             R.PROMPTS[:2])
        ref[f"{form}_tp1_spec"] = R._tokens(R._engine(tp1, spec_k=R.SPEC_K,
                                                      **kw))
        recs, _ = R._evacuated(R._engine(tp1, **kw))
        ref[f"{form}_tp1_payload"] = [rec.get("pages") for rec in recs]
    return outs, ref, tree


@pytest.mark.parametrize("form", list(FORMS))
def test_tp2_greedy_tokens_match_jax_tp1_and_port_tp1(served, form):
    """Both ranks' tp=2 tokens equal the JAX tp=1 engine's and the port's
    tp=1 engine's (JAX TestMixedTP::test_tp2_matches_tp1_greedy)."""
    outs, ref, _ = served
    for o in outs:
        assert o[f"{form}_tokens"] == ref[f"{form}_jax"]
        assert o[f"{form}_tokens"] == ref[f"{form}_tp1"]
    assert all(reason == "length" for _, reason in ref[f"{form}_jax"])


@pytest.mark.parametrize("form", list(FORMS))
def test_per_chip_kv_bytes_halve_exactly(served, form):
    """Each rank's pools and scales are half the tp=1 engine's, which
    equal the JAX tp=1 engine's; a rank's pools hold 2 of the 4 heads."""
    outs, ref, _ = served
    assert ref[f"{form}_tp1_kv_bytes"] == ref[f"{form}_jax_kv_bytes"]
    for o in outs:
        assert o[f"{form}_kv_bytes"] * 2 == ref[f"{form}_tp1_kv_bytes"]
        assert o[f"{form}_heads"] == 2


def test_sampled_tokens_agree_across_ranks(served):
    """temperature 0.9, top_k 12, one seed: the vocab gather gives every
    rank the same logits, so the ranks' generators draw the same
    tokens."""
    outs, ref, _ = served
    assert outs[0]["sampled_tokens"] == outs[1]["sampled_tokens"]
    assert outs[0]["sampled_tokens"] != ref["float_tp1"]


@pytest.mark.parametrize("form", list(FORMS))
def test_speculative_tp2_equals_speculative_tp1(served, form):
    """spec_k=2 on head-sharded chunk K/V: the tp=1 speculative engine's
    tokens; on float pages also the plain greedy ones (JAX's)."""
    outs, ref, _ = served
    for o in outs:
        assert o[f"{form}_spec_drafted"] > 0
        assert o[f"{form}_spec_tokens"] == ref[f"{form}_tp1_spec"]
    if form == "float":
        assert ref["float_tp1_spec"] == ref["float_jax"]


@pytest.mark.parametrize("form", list(FORMS))
def test_ship_tp2_to_tp2_is_token_identical(served, form):
    """Evacuate with the pages from a tp=2 engine into a fresh tp=2
    engine: the undisturbed tp=2 run's tokens, every payload imported
    (JAX test_ship_tp2); the same payload into a tp=1 engine gives the
    tp=1 run's tokens."""
    outs, ref, _ = served
    for o in outs:
        ship = o[f"{form}_ship"]
        assert ship["ship_tokens"] == o[f"{form}_base2"]
        assert ship["ship_stats"]["page_ships"] >= 1
        assert ship["ship_stats"]["page_ship_fallbacks"] == 0
        assert ship["ship_to_tp1_tokens"] == ref[f"{form}_tp1_base2"]
        assert ship["ship_to_tp1_ships"] >= 1


@pytest.mark.parametrize("form", list(FORMS))
def test_ship_payload_is_laid_out_as_tp1(served, form):
    """The payload carries every head: the same keys, shapes and dtypes
    as the tp=1 engine's payload for the same requests, the same bits on
    both ranks, layer 0 bit for bit the tp=1 payload's, later layers
    within 1e-6 of their scale (int8 pools within one step)."""
    outs, ref, _ = served
    want = ref[f"{form}_tp1_payload"]
    keys = ("k", "v") + (("k_scale", "v_scale") if form == "int8" else ())
    got = [o[f"{form}_ship"]["ship_payload"] for o in outs]
    for rec, rec1, rec_tp1 in zip(got[0], got[1], want):
        assert set(rec) == set(rec_tp1)
        assert {k: rec[k] for k in ("rows", "page_size", "quantized",
                                    "dtype")} == {
            k: rec_tp1[k] for k in ("rows", "page_size", "quantized",
                                    "dtype")}
        for key in keys:
            for layer, (a, b, w) in enumerate(zip(rec[key], rec1[key],
                                                  rec_tp1[key])):
                assert a.shape == w.shape and a.dtype == w.dtype
                assert torch.equal(a, b)
                if layer == 0:
                    assert torch.equal(a, w), (key, layer)
                elif a.dtype == torch.int8:
                    assert (a.int() - w.int()).abs().max() <= 1
                else:
                    scale = float(w.abs().max()) or 1.0
                    np.testing.assert_allclose(
                        a.numpy(), w.numpy(), rtol=0,
                        atol=SHIP_RTOL * scale)


def test_paged_decode_per_shard_heads_equals_full_heads_slice():
    """A tp rank's paged decode read sees its 2 of 4 heads: per shard,
    with every dead table entry pointed at a poisoned page, the read
    equals the full-head read's slice bit for bit, and the full read
    equals JAX's (its reference tolerance) (JAX TestDeadStepRepoint)."""
    rng = np.random.default_rng(0)
    num_pages, nh, ps, d, slots = 8, 4, 8, 16, 2
    k_pool = rng.standard_normal((num_pages, nh, ps, d), dtype=np.float32)
    v_pool = rng.standard_normal((num_pages, nh, ps, d), dtype=np.float32)
    k_pool[5], v_pool[5] = 1e4, -1e4
    q = rng.standard_normal((slots, nh, d), dtype=np.float32)
    lengths = np.array([10, 5], np.int32)
    table = np.array([[0, 1, num_pages], [2, num_pages, num_pages]],
                     np.int32)
    poisoned = np.where(table == num_pages, 5, table)

    def read(q, k, v, tab):
        return flash_attention_decode_paged(
            torch.from_numpy(np.ascontiguousarray(q)),
            torch.from_numpy(np.ascontiguousarray(k)),
            torch.from_numpy(np.ascontiguousarray(v)),
            torch.from_numpy(tab), torch.from_numpy(lengths))

    full = read(q, k_pool, v_pool, table)
    assert torch.equal(full, read(q, k_pool, v_pool, poisoned))
    for lo in (0, 2):  # the two tp=2 shards
        shard = read(q[:, lo:lo + 2], k_pool[:, lo:lo + 2],
                     v_pool[:, lo:lo + 2], poisoned)
        assert torch.equal(shard, full[:, lo:lo + 2])
    want = jax_decode_paged(
        jnp.asarray(q.reshape(slots * nh, 1, d)), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(table), jnp.asarray(lengths))
    np.testing.assert_allclose(full.numpy(),
                               np.asarray(want).reshape(slots, nh, d),
                               **DECODE_TOL)


def test_tp_construction_errors_in_jax_order(served):
    """Without `initialize_model_parallel` a tp=2 model's engine raises
    "tp>1" (JAX test_inference.py:443-448); on the ranks each bad
    construction raises the first of JAX's checks it breaks: the group's
    size, paged, chunked, the budget, the heads, then the adapter
    pool."""
    model = GPTModel(R.gpt_config(2), device="cpu")
    with pytest.raises(ValueError, match="tp>1 serving needs parallel_state"):
        InferenceEngine(model, **R.ENGINE)
    want = {
        "world_size": "initialized tensor group has size 2",
        "paged": "tp>1 serving shards the PagedKVCache pools over heads",
        "chunked": "tp>1 serving rides the chunked mixed step",
        "budget": "prefill_token_budget=5 must divide by tp=2",
        "heads": "num_attention_heads=3 must divide by tp=2",
        "adapter_pool": "adapter_pool serving is tp=1 only for now",
    }
    for o in served[0]:
        assert set(o["errors"]) == set(want)
        for name, msg in want.items():
            assert msg in o["errors"][name], (name, o["errors"][name])


def test_router_over_tp2_engines_is_refused(served):
    """Over tp=2 engines the router refuses only what waits for the
    retrace sentinel (``retrace_policy``, `arm_retrace_sentinel`, ROADMAP
    Queue 1 item 9b), by name, on every rank; the fleet itself builds
    (tests/test_torch_router_tp.py serves with it against a JAX router
    over tp=2 engines)."""
    for o in served[0]:
        assert o["router"] == 2
        assert set(o["router_refusals"]) == {"retrace_policy",
                                             "arm_retrace_sentinel"}
        for name, msg in o["router_refusals"].items():
            assert name in msg and "item 9b" in msg, msg
