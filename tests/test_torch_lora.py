"""The port's multi-LoRA serving against the JAX package's.

The cases of tests/L0/test_adapters.py apart from TestTenantTelemetry
(the tenant series are in tests/test_torch_serve_monitor.py), at its
geometry: the tiny fp32 GPT (vocab 96, hidden 32, 2 layers, 4 heads, 32
positions), 2 slots, capacity 24, budget 4, the same numpy-drawn weights
and adapter factors on both sides. The segmented delta against JAX's
within 1e-5 (fp32, summation order only); `pad_rank` and the pool's
buffers bit for bit; the pool's slots and counters over one call
sequence equal to the JAX pool's; greedy tokens compared for equality
with the JAX engine's on the contiguous cache and on bf16 pages, adapter
0 against an engine without a pool, and under residency backpressure,
tier-aware shedding and tier preemption."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import AdapterPool as JaxAdapterPool
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu.ops import lora as jax_lora
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    BASE_ADAPTER_ID,
    AdapterPool,
    InferenceEngine,
    SamplingParams,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig
from rocm_apex_tpu_torch.ops.lora import (
    apply_lora,
    pad_rank,
    segmented_lora_delta,
)

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
L, H = SHAPE["num_layers"], SHAPE["hidden_size"]
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4, seed=0)
PROMPTS = [[3, 5, 7, 9], [11, 13], [2, 4, 6, 8, 10], [5, 5, 5]]
LAYOUTS = {
    "contiguous": {},
    "bf16_pages": dict(paged=True, page_size=4, kv_dtype=torch.bfloat16),
}
ADAPTER_KEYS = ("adapters_registered", "adapters_resident",
                "adapter_uploads", "adapter_evictions", "adapter_revivals",
                "adapter_stalls", "tier_preemptions", "tier_sheds")


def factors(rank=2, scale=0.6, seed=1):
    """One adapter's per-layer numpy factors (JAX test_adapters.py's
    `register`: scale 0.6 flips greedy argmax on the 32-wide model)."""
    rng = np.random.RandomState(seed)
    return [
        {"qkv": (scale * rng.randn(H, rank), scale * rng.randn(rank, 3 * H)),
         "dense": (scale * rng.randn(H, rank), scale * rng.randn(rank, H))}
        for _ in range(L)
    ]


def pools(max_resident=4, max_rank=4):
    """The same (empty) pool in both packages."""
    return (AdapterPool(L, H, max_resident=max_resident, max_rank=max_rank,
                        device="cpu"),
            JaxAdapterPool(L, H, max_resident=max_resident,
                           max_rank=max_rank))


def register_both(both, name, rank=2, tier=0, seed=1):
    ids = [p.register(name, factors(rank, seed=seed), rank=rank, tier=tier)
           for p in both]
    assert ids[0] == ids[1]
    return ids[0]


@pytest.fixture(scope="module")
def engines():
    tcfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(tcfg, seed=1)
    jmodel = JaxGPTModel(JaxGPTConfig(
        **SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
        params_dtype=jnp.float32, dtype=jnp.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(tree, tcfg, device="cpu")
    donors = []  # JAX engines whose compiled steps same-geometry ones adopt

    def make(jax_side=False, pool=None, **kw):
        kw = {**ENGINE, **kw}
        if not jax_side:
            return InferenceEngine(model, adapter_pool=pool,
                                   sampling=SamplingParams(temperature=0.0),
                                   **kw)
        if kw.get("kv_dtype") is torch.bfloat16:
            kw["kv_dtype"] = jnp.bfloat16
        kw["sampling"] = JaxSamplingParams(temperature=0.0)
        for donor in donors:
            try:
                return JaxEngine(jmodel, jparams, step_source=donor,
                                 adapter_pool=pool, **kw)
            except ValueError:
                continue
        eng = JaxEngine(jmodel, jparams, adapter_pool=pool, **kw)
        donors.append(eng)
        return eng

    return make


def drain(eng, max_ticks=300):
    out, ticks = {}, 0
    while eng.has_work():
        for r in eng.step():
            out[r.request_id] = r
        ticks += 1
        assert ticks < max_ticks, "engine failed to drain"
    return out


def results(out):
    return {i: (r.tokens, r.finish_reason) for i, r in out.items()}


# ---------------------------------------------------------------------------
# ops/lora.py
# ---------------------------------------------------------------------------


class TestSegmentedDelta:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_jax_and_dense(self, seed):
        """fp32 on both sides: within 1e-5 of JAX's delta and of the
        dense per-token reference x @ A_a @ B_a."""
        rng = np.random.RandomState(seed)
        t, h, o, P, r = 6, 8, 12, 3, 2
        x = rng.randn(t, h).astype(np.float32)
        A = rng.randn(P, h, r).astype(np.float32)
        B = rng.randn(P, r, o).astype(np.float32)
        ids = np.array([0, 1, 2, 1, 0, 2], np.int32)
        got = segmented_lora_delta(*(torch.from_numpy(a)
                                     for a in (x, A, B, ids))).numpy()
        want = np.asarray(jax_lora.segmented_lora_delta(
            *(jnp.asarray(a) for a in (x, A, B, ids))))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        dense = np.stack([x[i] @ A[ids[i]] @ B[ids[i]] for i in range(t)])
        np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)

    def test_base_slot_zeros_contribute_nothing(self):
        rng = np.random.RandomState(1)
        A = rng.randn(3, 8, 2).astype(np.float32)
        B = rng.randn(3, 2, 8).astype(np.float32)
        A[0] = 0.0
        B[0] = 0.0
        x = rng.randn(4, 8).astype(np.float32)
        d = segmented_lora_delta(torch.from_numpy(x), torch.from_numpy(A),
                                 torch.from_numpy(B),
                                 torch.tensor([0, 2, 0, 1])).numpy()
        assert np.all(d[0] == 0.0) and np.all(d[2] == 0.0)
        assert np.any(d[1] != 0.0) and np.any(d[3] != 0.0)

    def test_apply_lora_against_jax(self):
        """Active: JAX's apply_lora within 1e-6; inactive (the host
        flag): the same tensor back, nothing computed."""
        rng = np.random.RandomState(2)
        b, s, h, o = 1, 4, 8, 8
        y, x = (rng.randn(b, s, n).astype(np.float32) for n in (o, h))
        A = rng.randn(2, h, 2).astype(np.float32)
        B = rng.randn(2, 2, o).astype(np.float32)
        ids = np.array([1, 0, 1, 1], np.int32)
        ty = torch.from_numpy(y)
        got = apply_lora(ty, torch.from_numpy(x), (torch.from_numpy(A),
                         torch.from_numpy(B)), torch.from_numpy(ids), True)
        want = jax_lora.apply_lora(
            jnp.asarray(y), jnp.asarray(x), (jnp.asarray(A), jnp.asarray(B)),
            jnp.asarray(ids), jnp.asarray(True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert apply_lora(ty, torch.from_numpy(x), None, None, False) is ty

    def test_pad_rank_bitwise_and_errors_match_jax(self):
        rng = np.random.RandomState(3)
        a = rng.randn(8, 3).astype(np.float32)
        b = rng.randn(3, 5).astype(np.float32)
        for args in ((6, 6.0), (3, None)):
            mine, theirs = pad_rank(a, b, *args), jax_lora.pad_rank(a, b, *args)
            for m, t in zip(mine, theirs):
                assert m.dtype == t.dtype and np.array_equal(m, t)
        np.testing.assert_allclose(pad_rank(a, b, 6, 6.0)[0]
                                   @ pad_rank(a, b, 6, 6.0)[1],
                                   (a @ b) * 2.0, rtol=1e-5)
        for bad in ((a, b, 2), (a, rng.randn(4, 5), 6)):
            msgs = []
            for fn in (pad_rank, jax_lora.pad_rank):
                with pytest.raises(ValueError) as err:
                    fn(*bad)
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# AdapterPool
# ---------------------------------------------------------------------------


class TestAdapterPool:
    @pytest.mark.parametrize("args, kw", [
        ((L, H), dict(max_resident=1)),
        ((L, H), dict(max_rank=0)),
        ((0, H), {}),
    ])
    def test_constructor_validation_matches_jax(self, args, kw):
        msgs = []
        for cls in (AdapterPool, JaxAdapterPool):
            with pytest.raises(ValueError) as err:
                cls(*args, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]

    def test_register_validation_and_ids(self):
        both = pools()
        assert register_both(both, "t1", seed=1) == 1
        assert register_both(both, "t2", seed=2) == 2
        for p in both:
            assert p.num_registered == 2
            assert p.lookup("t2") == 2 and p.lookup("nope") is None
            assert p.tenant_of(1) == "t1"
            assert p.tenant_of(BASE_ADAPTER_ID) == "base"
            assert p.rank_of(1) == 2 and p.rank_of(0) == 0
            assert p.known(0) and p.known(1) and not p.known(99)
        bad = [
            (("t1", factors()), dict(rank=2)),
            (("base", factors()), dict(rank=2)),
            (("t3", []), dict(rank=2)),
            (("t3", [{"qkv": (np.zeros((5, 2)), np.zeros((2, 96)))}] * L),
             dict(rank=2)),
        ]
        for args, kw in bad:
            msgs = []
            for p in both:
                with pytest.raises(ValueError) as err:
                    p.register(*args, **kw)
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]

    def test_park_reclaim_revive_against_jax(self):
        """One call sequence on both pools: the same slots, None under
        pressure, the same snapshot after each step, the same errors."""
        both = pools(max_resident=3)  # base + 2 adapter slots
        a1, a2, a3 = (register_both(both, f"t{i}", seed=i) for i in (1, 2, 3))
        calls = [("acquire", 0), ("release", 0), ("acquire", a1),
                 ("acquire", a2), ("acquire", a3), ("release", a1),
                 ("acquire", a1), ("release", a1), ("acquire", a3),
                 ("release", a2), ("release", a3)]
        for op, aid in calls:
            got = [getattr(p, op)(aid) for p in both]
            assert got[0] == got[1], (op, aid, got)
            assert both[0].snapshot() == both[1].snapshot(), (op, aid)
            assert [p.resident(aid) for p in both] == [
                both[1].resident(aid)] * 2
        snap = both[0].snapshot()
        assert snap["revivals"] == 1 and snap["evictions"] == 1
        assert snap["uploads"] == 3 and snap["refs"] == 1
        for p in both:
            p.assert_consistent()
        for op, aid, exc in (("acquire", 99, KeyError),
                             ("release", a1, RuntimeError)):
            msgs = []
            for p in both:
                with pytest.raises(exc) as err:
                    getattr(p, op)(aid)
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]

    def test_buffer_setter_validation(self):
        pool = pools()[0]
        with pytest.raises(ValueError, match="keys"):
            pool.buffers = {"qkv": pool.buffers["qkv"]}

    def test_buffers_bitwise_equal_to_jax(self):
        """After the same registrations and acquires, every buffer
        equals JAX's bit for bit: the padded factors in their slots,
        zeros in slot 0 and in the rank padding, uploaded in place."""
        both = pools(max_rank=4)
        a1 = register_both(both, "t1", rank=2, seed=5)
        a2 = register_both(both, "t2", rank=3, seed=6)
        before = both[0].buffers["qkv"][0].data_ptr()
        for p in both:
            p.acquire(a1)
            p.acquire(a2)
        assert both[0].buffers["qkv"][0].data_ptr() == before
        for t in ("qkv", "dense"):
            for mine, theirs in zip(both[0].buffers[t], both[1].buffers[t]):
                assert np.array_equal(mine.numpy(), np.asarray(theirs))
        A = both[0].buffers["qkv"][0].numpy()
        slot = both[0].slot_of(a1)
        assert np.any(A[:, slot, :, :2] != 0.0)
        assert np.all(A[:, slot, :, 2:] == 0.0) and np.all(A[:, 0] == 0.0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class TestEngineLora:
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_mixed_batch_matches_jax(self, engines, layout):
        """Two adapters and the base in one batch: the JAX engine's
        greedy tokens, tenants and adapter counters; the adapters move
        the tokens off the base run's."""
        outs, stats = [], []
        for side, pool in enumerate(pools()):
            a1 = pool.register("t1", factors(seed=1), rank=2)
            a2 = pool.register("t2", factors(seed=2), rank=2)
            eng = engines(bool(side), pool, **LAYOUTS[layout])
            for p, a in zip(PROMPTS, [a1, a2, 0, a1]):
                eng.add_request(p, 5, adapter_id=a)
            outs.append(results(drain(eng)))
            stats.append(({k: eng.stats()[k] for k in ADAPTER_KEYS},
                          eng.tenant_stats(),
                          {c["request_id"]: c["tenant"]
                           for c in eng.completions}))
            pool.assert_consistent()
            assert pool.snapshot()["refs"] == 1
        assert outs[0] == outs[1]
        assert stats[0] == stats[1]
        base = results(drain_prompts(engines(False, **LAYOUTS[layout]), 5))
        assert outs[0][2] == base[2]
        assert outs[0][0] != base[0]

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_adapter0_bitwise_equals_no_pool(self, engines, layout):
        """Every request on adapter 0 with a pool registered: the same
        tokens as an engine without a pool (a pure-base tick computes
        no delta)."""
        pool = pools()[0]
        pool.register("t1", factors(seed=1), rank=2)
        with_pool = results(drain_prompts(
            engines(False, pool, **LAYOUTS[layout]), 5))
        assert with_pool == results(drain_prompts(
            engines(False, **LAYOUTS[layout]), 5))

    def test_churn_matches_jax_without_leaks(self, engines):
        """Four tenants through two adapter slots: park, reclaim and
        revive give the JAX engine's tokens and pool counters."""
        outs, snaps = [], []
        for side, pool in enumerate(pools(max_resident=3)):
            aids = [pool.register(f"t{i}", factors(seed=i), rank=2)
                    for i in (1, 2, 3, 4)]
            eng = engines(bool(side), pool)
            toks = []
            for aid in aids + [aids[0], aids[2]]:
                eng.add_request([1, 2, 3], 3, adapter_id=aid)
                toks.append([r.tokens for r in drain(eng).values()])
            outs.append(toks)
            snaps.append(pool.snapshot())
            pool.assert_consistent()
        assert outs[0] == outs[1]
        assert snaps[0] == snaps[1]
        assert snaps[0]["evictions"] > 0 and snaps[0]["refs"] == 1

    def test_tenant_stats_and_keys(self, engines):
        got = []
        for side, pool in enumerate(pools()):
            a1 = pool.register("t1", factors(seed=1), rank=2)
            a2 = pool.register("t2", factors(seed=2), rank=2)
            eng = engines(bool(side), pool)
            for p, a in zip(PROMPTS, [0, a1, a2, a1]):
                eng.add_request(p, 3, adapter_id=a)
            drain(eng)
            ts = eng.tenant_stats()
            assert sum(s["completed"] for s in ts.values()) == len(
                eng.completions)
            assert sum(s["generated_tokens"] for s in ts.values()) == sum(
                c["new_tokens"] for c in eng.completions)
            got.append((ts, {k: eng.stats()[k] for k in ADAPTER_KEYS}))
            eng.reset_stats()
            assert eng.tenant_stats() == {}
        assert got[0] == got[1]
        assert set(got[0][0]) == {"base", "t1", "t2"}
        assert got[0][1]["adapters_registered"] == 2.0

    def test_request_and_constructor_validation(self, engines):
        bare = engines(False)
        with pytest.raises(ValueError, match="adapter_pool"):
            bare.add_request([1, 2], 2, adapter_id=1)
        pool = pools()[0]
        pool.register("t1", factors(), rank=2)
        with pytest.raises(KeyError, match="unknown adapter_id"):
            engines(False, pool).add_request([1, 2], 2, adapter_id=42)
        cases = [
            dict(pool=AdapterPool(L, H + 4, device="cpu")),
            dict(pool=pool, prefill_token_budget=None, max_prompt_len=24),
        ]
        for kw in cases:
            msgs = []
            for side in (False, True):
                kw_side = dict(kw)
                if side:
                    p = kw_side.pop("pool")
                    kw_side["pool"] = JaxAdapterPool(p.num_layers, p.hidden)
                with pytest.raises(ValueError) as err:
                    engines(side, **kw_side)
                msgs.append(str(err.value))
            assert msgs[0] == msgs[1]


def drain_prompts(eng, max_new):
    for p in PROMPTS:
        eng.add_request(p, max_new)
    return drain(eng)


# ---------------------------------------------------------------------------
# admission: residency backpressure and the tiers
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_residency_backpressure_resolves(self, engines):
        """One adapter slot, two tenants: the second waits for the
        first's release, both finish, as in the JAX engine (same tokens,
        same stall count)."""
        got = []
        for side, pool in enumerate(pools(max_resident=2)):
            b1 = pool.register("x1", factors(seed=21), rank=2)
            b2 = pool.register("x2", factors(seed=22), rank=2)
            eng = engines(bool(side), pool)
            eng.add_request([1, 2], 6, adapter_id=b1)
            eng.add_request([3, 4], 6, adapter_id=b2)
            got.append((results(drain(eng)), eng.stats()["adapter_stalls"]))
            pool.assert_consistent()
            assert pool.snapshot()["refs"] == 1
        assert got[0] == got[1]
        assert all(r[1] == "length" for r in got[0][0].values())
        assert got[0][1] > 0

    def test_tier_aware_queue_shed(self, engines):
        """A full queue: the paid arrival sheds the newest free-tier
        request, not itself; results equal the JAX engine's."""
        got = []
        for side, pool in enumerate(pools()):
            lo = pool.register("free", factors(seed=31), rank=2, tier=0)
            hi = pool.register("paid", factors(seed=32), rank=2, tier=2)
            eng = engines(bool(side), pool, max_queue=2)
            for _ in range(2):
                eng.add_request([9] * 6, 8)
            eng.step()
            q = [eng.add_request([1, 2], 3, adapter_id=lo),
                 eng.add_request([3, 4], 3, adapter_id=lo),
                 eng.add_request([5, 6], 3, adapter_id=hi)]
            res = results(drain(eng))
            assert res[q[1]][1] == "queue_full"
            assert res[q[0]][1] == res[q[2]][1] == "length"
            got.append((res, eng.stats()["tier_sheds"], eng.tenant_stats()))
            pool.assert_consistent()
        assert got[0] == got[1]
        assert got[0][1] == 1.0

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    def test_tier_preemption_token_identical(self, engines, layout):
        """A tier-3 arrival preempts a running tier-0 request; every
        preempted request finishes in full with a calm run's tokens, and
        the JAX engine gives the same results."""
        got = []
        for side, pool in enumerate(pools()):
            lo = pool.register("lo", factors(seed=41), rank=2, tier=0)
            hi = pool.register("hi", factors(seed=42), rank=2, tier=3)
            eng = engines(bool(side), pool, tier_preemption=True,
                          **LAYOUTS[layout])
            busy = [eng.add_request([7] * 4, 8, adapter_id=lo)
                    for _ in range(3)]
            for _ in range(2):
                eng.step()
            vip = eng.add_request([8, 8], 3, adapter_id=hi)
            res = results(drain(eng))
            assert eng.stats()["tier_preemptions"] >= 1.0
            assert len(res[vip][0]) == 3
            assert all(len(res[b][0]) == 8 for b in busy)
            got.append((res, eng.stats()["tier_preemptions"]))
            pool.assert_consistent()
            assert pool.snapshot()["refs"] == 1
        assert got[0] == got[1]
        calm_pool = pools()[0]
        lo_c = calm_pool.register("lo", factors(seed=41), rank=2, tier=0)
        calm = engines(False, calm_pool, **LAYOUTS[layout])
        ids = [calm.add_request([7] * 4, 8, adapter_id=lo_c)
               for _ in range(3)]
        calm_res = results(drain(calm))
        assert [got[0][0][b] for b in range(3)] == [calm_res[i] for i in ids]
