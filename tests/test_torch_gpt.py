"""The port's cached GPT against the JAX package, on the CPU.

One tiny fp32 config (the shapes of tests/L0/test_inference.py: hidden
32, 4 heads, 2 layers, vocab 96, 2 slots, capacity 24). The same
numpy-drawn weights (`convert.random_params`) go into both models; the
JAX chunk and decode steps run their Pallas kernels in interpret mode,
the port's its kernels' plain versions. Logits agree to atol 1e-4:
both sides compute in fp32 and differ in summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import KVCache as JaxKVCache
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import (
    flatten_params,
    from_jax_params,
    random_params,
)
from rocm_apex_tpu_torch.inference import KVCache, PagedKVCache
from rocm_apex_tpu_torch.models.gpt import GPTConfig, GPTModel
from rocm_apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
)

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
# the port's config has no dropout fields: its cached forward has none
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
SLOTS, CAPACITY = 2, 24
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_cfg():
    return JaxGPTConfig(**SHAPE, **NO_DROPOUT, params_dtype=jnp.float32,
                        dtype=jnp.float32)


def torch_cfg():
    return GPTConfig(**SHAPE, params_dtype=torch.float32,
                     dtype=torch.float32)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class TestWeightBridge:
    def test_jax_init_tree_round_trips(self):
        """A tree from the JAX model's own init loads leaf for leaf."""
        jmodel = JaxGPTModel(jax_cfg())
        tree = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
        model = from_jax_params(tree, torch_cfg(), device="cpu")
        state = model.state_dict()
        flat = flatten_params(tree["params"])
        assert set(state) == set(flat)
        for key, val in flat.items():
            np.testing.assert_array_equal(state[key].numpy(), val)

    def test_random_params_has_the_jax_tree_shape(self):
        jmodel = JaxGPTModel(jax_cfg())
        shapes = jax.eval_shape(
            jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
        )
        want = {k: tuple(v.shape) for k, v in
                flatten_params(jax.tree_util.tree_map(
                    lambda s: s, shapes["params"])).items()}
        tree = random_params(torch_cfg(), seed=0)
        got = {k: v.shape for k, v in flatten_params(tree["params"]).items()}
        assert got == want
        flat = flatten_params(tree["params"])
        # output projections carry the 1/sqrt(2 * layers) scaled init
        w_in = flat["transformer.layer_0.mlp.dense_h_to_4h.kernel"]
        w_out = flat["transformer.layer_0.mlp.dense_4h_to_h.kernel"]
        assert abs(w_in.std() - 0.02) < 2e-3
        assert abs(w_out.std() - 0.02 / np.sqrt(4.0)) < 1e-3
        assert np.all(flat["transformer.final_layernorm.weight"] == 1.0)

    def test_rejects_a_mismatched_tree(self):
        tree = random_params(torch_cfg(), seed=0)
        del tree["params"]["transformer"]["final_layernorm"]
        with pytest.raises(KeyError, match="final_layernorm"):
            from_jax_params(tree, torch_cfg(), device="cpu")


class TestKVCache:
    def test_writes_match_jax(self):
        """`write` at per-slot lengths (the start clamped at the end of
        the cache) and `write_at` with a pad row, against the JAX cache;
        both update in place and leave ``lengths`` alone."""
        rng = np.random.default_rng(9)
        jc = JaxKVCache.create(1, 3, 8, 2, 4, dtype=jnp.float32)
        tc = KVCache.create(1, 3, 8, 2, 4, dtype=torch.float32, device="cpu")
        lengths = np.array([0, 3, 7], np.int32)
        jc = jc.replace(lengths=jnp.asarray(lengths))
        tc.lengths = torch.from_numpy(lengths.copy())
        new = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
        jc = jc.write(0, jnp.asarray(new), jnp.asarray(2 * new))
        assert tc.write(0, torch.from_numpy(new),
                        torch.from_numpy(2 * new)) is tc
        slots = np.array([1, 3, 0, 2], np.int32)  # 3 = pad
        pos = np.array([5, 0, 7, 1], np.int32)
        chunk = rng.standard_normal((4, 2, 4)).astype(np.float32)
        jc = jc.write_at(0, jnp.asarray(slots), jnp.asarray(pos),
                         jnp.asarray(chunk), jnp.asarray(-chunk))
        tc.write_at(0, torch.from_numpy(slots), torch.from_numpy(pos),
                    torch.from_numpy(chunk), torch.from_numpy(-chunk))
        np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))
        np.testing.assert_array_equal(tc.v[0].numpy(), np.asarray(jc.v[0]))
        np.testing.assert_array_equal(tc.lengths.numpy(), lengths)


@pytest.fixture(scope="module")
def models():
    tree = random_params(torch_cfg(), seed=3)
    return (JaxGPTModel(jax_cfg()), _jax_tree(tree),
            from_jax_params(tree, torch_cfg(), device="cpu"))


def _chunk(pieces, budget):
    """Pack (slot, tokens, start) pieces in the given order; pads carry
    slot id SLOTS."""
    toks = np.zeros((budget,), np.int32)
    slots = np.full((budget,), SLOTS, np.int32)
    pos = np.zeros((budget,), np.int32)
    at = 0
    for slot, tk, start in pieces:
        n = len(tk)
        toks[at:at + n] = tk
        slots[at:at + n] = slot
        pos[at:at + n] = np.arange(start, start + n)
        at += n
    return toks, slots, pos, at


class TestCachedSteps:
    def test_chunk_then_decode_logits_match_jax(self, models):
        """Two chunks (the second with slot pieces out of slot order,
        both slots holding a prefix, and pads), then a decode step:
        per-row logits and the cache contents agree with the JAX model."""
        jmodel, jparams, model = models
        jcache = JaxKVCache.for_model(jax_cfg(), SLOTS, CAPACITY)
        cache = KVCache.for_model(torch_cfg(), SLOTS, CAPACITY, device="cpu")
        rng = np.random.default_rng(5)
        p0 = rng.integers(0, 96, 9).tolist()
        p1 = rng.integers(0, 96, 7).tolist()
        lengths = np.zeros((SLOTS,), np.int32)
        budget = 8
        for pieces in (
            [(0, p0[:5], 0), (1, p1[:2], 0)],
            [(1, p1[2:7], 2), (0, p0[5:7], 5)],
        ):
            toks, slots, pos, n = _chunk(pieces, budget)
            jcache = jcache.replace(lengths=jnp.asarray(lengths))
            jlog, jcache = jmodel.apply(
                jparams, jnp.asarray(toks)[None], cache=jcache,
                chunk=(jnp.asarray(slots), jnp.asarray(pos)),
            )
            cache.lengths = torch.from_numpy(lengths.copy())
            tlog, cache = model(
                torch.from_numpy(toks)[None], cache=cache,
                chunk=(torch.from_numpy(slots), torch.from_numpy(pos)),
            )
            # pad rows are never sampled: compare the packed rows
            np.testing.assert_allclose(
                tlog[0, :n].numpy(), np.asarray(jlog)[0, :n], **LOGIT_TOL
            )
            for slot, tk, start in pieces:
                lengths[slot] = start + len(tk)
        for i in range(SHAPE["num_layers"]):
            for s in range(SLOTS):
                live = slice(0, int(lengths[s]))
                np.testing.assert_allclose(
                    cache.k[i][s, live].numpy(),
                    np.asarray(jcache.k[i])[s, live], **LOGIT_TOL,
                )
        dec = np.array([p0[7], p1[6]], np.int32)[:, None]
        jcache = jcache.replace(lengths=jnp.asarray(lengths))
        cache.lengths = torch.from_numpy(lengths.copy())
        jlog, jcache = jmodel.apply(jparams, jnp.asarray(dec), cache=jcache)
        tlog, cache = model(torch.from_numpy(dec), cache=cache)
        np.testing.assert_allclose(
            tlog.numpy(), np.asarray(jlog), **LOGIT_TOL
        )
        np.testing.assert_array_equal(
            cache.lengths.numpy(), np.asarray(jcache.lengths)
        )

    def test_pad_rows_never_land_in_the_cache(self, models):
        _, _, model = models
        cache = KVCache.for_model(torch_cfg(), SLOTS, CAPACITY, device="cpu")
        toks, slots, pos, _ = _chunk([(1, [4, 5, 6], 0)], 6)
        model(torch.from_numpy(toks)[None], cache=cache,
              chunk=(torch.from_numpy(slots), torch.from_numpy(pos)))
        for buf in cache.k + cache.v:
            assert torch.all(buf[0] == 0)
            assert torch.all(buf[1, 3:] == 0)
            assert torch.all(buf[1, :3].abs().sum(dim=(-1, -2)) > 0)
        assert torch.all(cache.lengths == 0)  # the engine commits cursors


class TestEntryPoints:
    def test_unported_paths_raise(self, models):
        """tp > 1 and the GPT options the port cannot run yet raise,
        naming their ROADMAP item; "jnp" attention and context
        parallelism construct (tests/test_torch_gpt_jnp.py,
        tests/test_torch_context_parallel.py), an unknown impl and the
        sequence-parallel collision raise ValueError as in JAX;
        whole-prompt prefill runs on the contiguous cache (tests/
        test_torch_engine_whole.py) and a paged cache refuses it, as the
        JAX model does."""
        _, _, model = models
        assert GPTConfig(**SHAPE, attention_impl="jnp").attention_impl == "jnp"
        assert GPTConfig(**SHAPE, context_parallel_axis="cp")
        with pytest.raises(ValueError, match="attention_impl"):
            GPTConfig(**SHAPE, attention_impl="xla")
        with pytest.raises(ValueError, match="collide"):
            GPTConfig(**SHAPE, context_parallel_axis="cp",
                      sequence_parallel=True)
        with pytest.raises(NotImplementedError,
                           match="sequence_parallel.*ROADMAP"):
            GPTConfig(**SHAPE, sequence_parallel=True)
        # the materialized head runs now (tests/test_torch_bert.py)
        assert not GPTConfig(**SHAPE, fused_lm_head=False).fused_lm_head
        paged = PagedKVCache.for_model(torch_cfg(), 1, CAPACITY, page_size=8,
                                       device="cpu")
        with pytest.raises(ValueError, match="whole-prompt"):
            model(torch.zeros((1, 4), dtype=torch.int64), cache=paged)
        with pytest.raises(NotImplementedError, match="tensor_parallel"):
            GPTConfig(tensor_parallel_size=2)
        with pytest.raises(NotImplementedError, match="world_size=2"):
            ColumnParallelLinear(4, 4, world_size=2, device="cpu")

    def test_no_silent_cpu_fallback(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GPTModel(torch_cfg())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            KVCache.create(1, 1, 4, 1, 32)
