"""The port's fault harness and request lifecycle against the JAX engine's.

The cases of tests/L0/test_robustness.py that do not need the monitor
layer (ROADMAP Queue 1 item 9), at its geometry: the tiny fp32 GPT
(vocab 96, hidden 32, 2 layers, 4 heads, 32 positions), 2 slots,
capacity 24, budget 4, the same numpy-drawn weights on both sides.
`FaultPlan` fires at the same calls as the JAX plan for the same seed;
deadlines, queue TTLs, cancel, the bounded queue, drain and the
watchdog behave as the JAX engine's; a NaN or Inf poisons one slot only;
a retried step gives the fault-free run's tokens bit for bit (the port
writes its cache in place inside the forward, so a retry rewrites rows
the failed attempt wrote: the generator's state is restored, and on
int8 pages the pools and scales equal a fault-free run's bit for bit);
and one seeded chaos plan with a mid-prefill cancel gives the JAX
engine's results on the contiguous cache, bf16 pages and int8 pages.
The half of JAX's ``test_inf_payload_and_flight_recorder`` that checks
the flight recorder waits for the monitor layer; its Inf half is here.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import Fault as JaxFault
from rocm_apex_tpu.inference import FaultPlan as JaxFaultPlan
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    FINISH_REASONS,
    NO_FAULTS,
    Fault,
    FaultInjected,
    FaultPlan,
    InferenceEngine,
    SamplingParams,
)
from rocm_apex_tpu_torch.inference.faults import SITES
from rocm_apex_tpu_torch.models.gpt import GPTConfig

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4)
PROMPTS = [
    [1, 2, 3, 1, 2],
    [7, 8, 9, 7, 8, 9, 7, 8, 9],
    [4, 5, 6, 4],
    [2, 4, 6, 8, 2, 4],
]
MAX_REF = 12  # the references' length; every run's max_new is <= it
MAX_NEW = 5  # the chaos runs' length
PAGED = dict(paged=True, page_size=4)
INT8 = dict(paged=True, page_size=4, kv_dtype=torch.int8)
COUNTERS = ("step_retries", "cancelled", "quarantined", "shed",
            "deadline_exceeded", "page_stalls", "preemptions",
            "generated_tokens", "prompt_tokens", "evicted", "admitted")


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

    def make(jax_side=False, sampling=None, **kw):
        kw = {**ENGINE, **kw}
        if not jax_side:
            return InferenceEngine(
                model, sampling=sampling or SamplingParams(temperature=0.0),
                **kw)
        if kw.get("kv_dtype") is torch.int8:
            kw["kv_dtype"] = jnp.int8
        kw["sampling"] = JaxSamplingParams(temperature=0.0)
        for donor in donors:
            try:
                return JaxEngine(jmodel, jparams, step_source=donor, **kw)
            except ValueError:
                continue
        eng = JaxEngine(jmodel, jparams, **kw)
        donors.append(eng)
        return eng

    return make


_REFS = {}


def _ref(engines, layout):
    """The port's fault-free greedy tokens by request id (ids follow the
    prompt order), shared across the file."""
    key = tuple(sorted((k, str(v)) for k, v in layout.items()))
    if key not in _REFS:
        eng = engines(**layout)
        _REFS[key] = {r.request_id: r.tokens
                      for r in eng.generate(PROMPTS, MAX_REF)}
    return _REFS[key]


def run_to_done(eng, max_ticks=400):
    out, ticks = {}, 0
    while eng.has_work():
        for r in eng.step():
            out[r.request_id] = r
        ticks += 1
        assert ticks < max_ticks, "engine failed to drain"
    return out


def _plan(side, faults, seed=0):
    """The same schedule as a port plan (side False) or a JAX plan."""
    fault, plan = (JaxFault, JaxFaultPlan) if side else (Fault, FaultPlan)
    return plan([fault(**f) for f in faults], seed=seed)


# ---------------------------------------------------------------------------
# FaultPlan scheduling
# ---------------------------------------------------------------------------


class TestFaultPlan:
    def test_validation(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            Fault(site="gpu_on_fire", tick=0)
        with pytest.raises(ValueError, match="no schedule"):
            Fault(site="device_step")
        with pytest.raises(ValueError, match="1-based"):
            Fault(site="logits", nth=0)
        with pytest.raises(ValueError, match="every"):
            Fault(site="logits", every=0)
        with pytest.raises(ValueError, match="p must be"):
            Fault(site="logits", p=1.5)

    def test_nth_every_times_and_tick(self):
        plan = FaultPlan([Fault(site="page_alloc", nth=2),
                          Fault(site="page_alloc", every=3, times=2)])
        hits = [plan.fire("page_alloc") is not None for _ in range(12)]
        assert hits == [False, True, True, False, False, True,
                        False, False, False, False, False, False]
        assert plan.calls("page_alloc") == 12
        assert plan.fires["page_alloc"] == 3
        plan = FaultPlan([Fault(site="device_step", tick=3)])
        assert plan.fire("device_step", tick=0) is None
        assert plan.fire("device_step", tick=3) is not None
        assert plan.fire("device_step", tick=3) is None  # times=1

    @pytest.mark.parametrize("seed", [0, 7, 12])
    def test_replays_and_fires_as_jax(self, seed):
        """The same plan and seed fire at the same calls as the JAX
        plan, over every site and a mix of schedules, and again after
        `reset`."""
        faults = [dict(site="host_fetch", p=0.3, times=None),
                  dict(site="device_step", p=0.5, times=3),
                  dict(site="page_alloc", every=4, times=None),
                  dict(site="logits", tick=5, payload={"slot": 1}),
                  dict(site="replica_kill", nth=2)]
        plans = [_plan(side, faults, seed) for side in (False, True)]
        rng = np.random.default_rng(seed)
        calls = [(SITES[i], int(t)) for i, t in zip(
            rng.integers(0, len(SITES), 300), rng.integers(0, 10, 300))]
        fired = [[None if (f := p.fire(site, tick=t)) is None else f.site
                  for site, t in calls] for p in plans]
        assert fired[0] == fired[1]
        assert any(fired[0]) and plans[0].fires == plans[1].fires
        plans[0].reset()
        again = [None if (f := plans[0].fire(site, tick=t)) is None
                 else f.site for site, t in calls]
        assert again == fired[0]

    def test_null_plan_and_reasons(self):
        assert NO_FAULTS.enabled is False
        assert FaultPlan([Fault(site="logits", tick=0)]).enabled
        from rocm_apex_tpu.inference import FINISH_REASONS as JAX_REASONS
        assert FINISH_REASONS == tuple(JAX_REASONS)


# ---------------------------------------------------------------------------
# deadlines and cancel
# ---------------------------------------------------------------------------


class TestDeadlinesAndCancel:
    def test_queue_ttl_expires_before_admission(self, engines):
        ref = _ref(engines, {})
        eng = engines()
        for p in PROMPTS[:2]:
            eng.add_request(p, 8)
        eng.step()  # both slots leased
        late = eng.add_request(PROMPTS[2], 8, queue_ttl=1e-3)
        time.sleep(5e-3)
        done = run_to_done(eng)
        assert done[late].finish_reason == "deadline"
        assert done[late].tokens == []
        assert done[0].tokens == ref[0][:8] and done[1].tokens == ref[1][:8]
        assert eng.stats()["deadline_exceeded"] == 1.0
        rec = [c for c in eng.completions if c["request_id"] == late][0]
        assert rec["finish_reason"] == "deadline" and rec["new_tokens"] == 0

    def test_e2e_deadline_expires_in_flight(self, engines):
        ref = _ref(engines, {})
        eng = engines()
        rid = eng.add_request(PROMPTS[0], MAX_REF, timeout=30.0)
        done = {}
        while not (eng._slots[0] is not None
                   and len(eng._slots[0].generated) >= 3):
            for r in eng.step():
                done[r.request_id] = r
        eng._slots[0].req.deadline = time.perf_counter() - 1.0
        done.update(run_to_done(eng))
        res = done[rid]
        assert res.finish_reason == "deadline"
        assert 3 <= len(res.tokens) < MAX_REF
        assert res.tokens == ref[0][:len(res.tokens)]
        assert eng.stats()["deadline_exceeded"] == 1.0
        assert eng.num_active == 0

    def test_cancel_in_queue(self, engines):
        eng = engines()
        for p in PROMPTS[:2]:
            eng.add_request(p, 6)
        eng.step()
        rid = eng.add_request(PROMPTS[2], 6)
        res = eng.cancel(rid)
        assert res is not None and res.finish_reason == "cancelled"
        assert res.tokens == [] and eng.num_queued == 0
        assert eng.cancel(rid) is None  # already finished
        assert eng.cancel(999) is None  # unknown id
        assert set(run_to_done(eng)) == {0, 1}
        assert eng.stats()["cancelled"] == 1.0

    @pytest.mark.parametrize("layout", [PAGED, INT8], ids=["paged", "int8"])
    def test_cancel_during_chunked_prefill_paged(self, engines, layout):
        ref = _ref(engines, layout)
        eng = engines(**layout)
        baseline = eng._allocator.snapshot()
        victim = eng.add_request(PROMPTS[1], 6)  # 9 tokens: 3 ticks
        eng.add_request(PROMPTS[0], 6)
        eng.step()
        assert eng._slots[0] is not None and eng._slots[0].prefilling
        res = eng.cancel(victim)
        assert res.finish_reason == "cancelled" and res.tokens == []
        eng._allocator.assert_consistent()
        done = run_to_done(eng)
        assert done[1].tokens == ref[0][:6]
        eng._allocator.assert_consistent()
        assert eng._allocator.snapshot() == baseline

    def test_cancel_during_decode(self, engines):
        ref = _ref(engines, {})
        eng = engines()
        a = eng.add_request(PROMPTS[0], MAX_REF)
        b = eng.add_request(PROMPTS[1], MAX_REF)
        done = {}
        while not (eng._slots[1] is not None
                   and len(eng._slots[1].generated) >= 3):
            for r in eng.step():
                done[r.request_id] = r
        res = eng.cancel(b)
        assert res.finish_reason == "cancelled"
        assert 3 <= len(res.tokens) < MAX_REF
        assert res.tokens == ref[1][:len(res.tokens)]
        done.update(run_to_done(eng))
        assert done[a].tokens == ref[0]
        assert len(eng.completions) == 2


# ---------------------------------------------------------------------------
# fault isolation, retries
# ---------------------------------------------------------------------------


class TestFaultIsolation:
    @pytest.mark.parametrize("value", [float("nan"), float("inf")],
                             ids=["nan", "inf"])
    def test_poison_quarantines_only_that_slot(self, engines, value):
        ref = _ref(engines, {})
        faults = [dict(site="logits", tick=4,
                       payload={"slot": 1, "value": value})]
        eng = engines(faults=_plan(False, faults))
        for p in PROMPTS[:2]:
            eng.add_request(p, 8)
        done = run_to_done(eng)
        assert done[1].finish_reason == "error" and len(done[1].tokens) < 8
        assert done[1].tokens == ref[1][:len(done[1].tokens)]
        assert done[0].finish_reason == "length"
        assert done[0].tokens == ref[0][:8]
        assert eng.stats()["quarantined"] == 1.0
        jeng = engines(True, faults=_plan(True, faults))
        for p in PROMPTS[:2]:
            jeng.add_request(p, 8)
        jdone = run_to_done(jeng)
        assert {i: (r.tokens, r.finish_reason) for i, r in done.items()} \
            == {i: (r.tokens, r.finish_reason) for i, r in jdone.items()}

    @pytest.mark.parametrize("layout", [{}, PAGED, INT8],
                             ids=["contig", "paged", "int8"])
    def test_step_retry_recovers_bitwise(self, engines, layout):
        """A device_step fault (nothing written yet) and a host_fetch
        fault (the forward already wrote its K/V in place) on the tick a
        5-token prompt completes mid-page and feeds its first decode row
        onto the page of its last chunk row: the same tokens as the
        fault-free run, the same cache bit for bit (pools, and on int8
        pages the scales), the same plan fires as on the JAX engine."""
        faults = [dict(site="device_step", tick=1),
                  dict(site="host_fetch", tick=1),
                  dict(site="host_fetch", tick=3)]
        clean, faulty = engines(**layout), engines(
            faults=_plan(False, faults), max_step_retries=2, **layout)
        for eng in (clean, faulty):
            for p in PROMPTS[:2]:
                eng.add_request(p, 6)
        done = {}
        while faulty.has_work():
            out = [eng.step() for eng in (clean, faulty)]
            assert [(r.request_id, r.tokens) for r in out[0]] == [
                (r.request_id, r.tokens) for r in out[1]]
            done.update({r.request_id: r.tokens for r in out[1]})
            c, f = clean.cache, faulty.cache
            scales = ("k_scale", "v_scale")
            for x, y in zip(
                (*c.k, *c.v, *(t for n in scales
                               for t in getattr(c, n, None) or ())),
                (*f.k, *f.v, *(t for n in scales
                               for t in getattr(f, n, None) or ())),
            ):
                assert torch.equal(x, y), f"tick {faulty.tick_count}"
        ref = _ref(engines, layout)
        assert done == {i: ref[i][:6] for i in (0, 1)}
        assert faulty.stats()["step_retries"] == 3.0
        jeng = engines(True, faults=_plan(True, faults), max_step_retries=2,
                       **layout)
        jdone = {r.request_id: r.tokens for r in jeng.generate(
            PROMPTS[:2], 6)}
        assert jdone == {i: ref[i][:6] for i in (0, 1)}
        assert jeng.stats()["step_retries"] == 3.0

    def test_sampled_retry_restores_the_generator(self, engines):
        """temperature > 0: a host_fetch fault after the sample drew from
        the engine's generator; the retry restores its state, so the
        tokens equal the fault-free run's with the same seed."""
        sp = SamplingParams(temperature=0.9, top_k=20)
        faults = [dict(site="host_fetch", tick=t) for t in (1, 3, 6)]
        runs = []
        for plan in (None, _plan(False, faults)):
            eng = engines(sampling=sp, seed=3, faults=plan)
            runs.append([r.tokens for r in eng.generate(PROMPTS[:2], 8)])
            if plan is not None:
                assert eng.stats()["step_retries"] == 3.0
        assert runs[0] == runs[1]
        assert any(len(set(t)) > 1 for t in runs[0])  # it really sampled

    def test_retry_exhaustion_requeues_then_recovers(self, engines):
        ref = _ref(engines, PAGED)
        eng = engines(faults=_plan(False, [dict(site="device_step", tick=2)]),
                      max_step_retries=0, **PAGED)
        baseline = eng._allocator.snapshot()
        for p in PROMPTS[:2]:
            eng.add_request(p, 6)
        done, raised = {}, 0
        while eng.has_work():
            try:
                for r in eng.step():
                    done[r.request_id] = r
            except FaultInjected:
                raised += 1
                assert eng.num_active == 0 and eng.num_queued == 2
                eng._allocator.assert_consistent()
        assert raised == 1
        assert done[0].tokens == ref[0][:6] and done[1].tokens == ref[1][:6]
        assert eng.stats()["preemptions"] >= 2.0
        eng._allocator.assert_consistent()
        assert eng._allocator.snapshot() == baseline

    def test_page_alloc_fault_defers_not_corrupts(self, engines):
        ref = _ref(engines, PAGED)
        faults = [dict(site="page_alloc", every=1, times=3)]
        plan = _plan(False, faults)
        eng = engines(faults=plan, **PAGED)
        done = {r.request_id: r for r in eng.generate(PROMPTS[:2], 6)}
        assert done[0].tokens == ref[0][:6] and done[1].tokens == ref[1][:6]
        s = eng.stats()
        assert s["page_stalls"] >= 1.0 and plan.fires["page_alloc"] == 3
        eng._allocator.assert_consistent()
        jeng = engines(True, faults=_plan(True, faults), **PAGED)
        jeng.generate(PROMPTS[:2], 6)
        assert s["page_stalls"] == jeng.stats()["page_stalls"]


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------


class TestGracefulDegradation:
    def test_bounded_queue_sheds_newest_never_silently(self, engines):
        eng = engines(max_queue=1)
        kept = eng.add_request(PROMPTS[0], 4)
        shed = eng.add_request(PROMPTS[1], 4)  # queue full: shed
        assert eng.has_work()
        done = run_to_done(eng)
        assert done[shed].finish_reason == "queue_full"
        assert done[shed].tokens == []
        assert done[kept].finish_reason == "length"
        assert eng.stats()["shed"] == 1.0
        assert sorted(c["finish_reason"] for c in eng.completions) == [
            "length", "queue_full"]

    def test_drain_finishes_everything_and_reopens(self, engines):
        ref = _ref(engines, {})
        eng = engines()
        for p in PROMPTS[:3]:
            eng.add_request(p, 5)
        eng.step()
        assert not eng.draining
        out = {r.request_id: r for r in eng.drain()}
        assert eng.draining and not eng.has_work()
        for rid in range(3):
            assert out[rid].tokens == ref[rid][:5]
        with pytest.raises(RuntimeError, match="draining"):
            eng.add_request(PROMPTS[0], 2)
        assert eng.drain() == []  # idempotent
        eng.reopen()
        assert not eng.draining
        assert eng.generate([PROMPTS[0]], 5)[0].tokens == ref[0][:5]

    def test_drain_shed_queue_cancels_only_queued(self, engines):
        eng = engines(**PAGED)
        baseline = eng._allocator.snapshot()
        for p in PROMPTS[:3]:
            eng.add_request(p, 5)
        eng.step()  # 2 slots leased, 1 queued
        out = {r.request_id: r for r in eng.drain(shed_queue=True)}
        assert out[2].finish_reason == "cancelled"
        assert out[0].finish_reason == out[1].finish_reason == "length"
        assert eng.stats()["cancelled"] == 1.0
        eng._allocator.assert_consistent()
        assert eng._allocator.snapshot() == baseline

    def test_reopen_refuses_a_dirty_engine(self, engines):
        eng = engines()
        eng.add_request(PROMPTS[0], 4)
        with pytest.raises(RuntimeError, match="queued"):
            eng.reopen()

    def test_watchdog_dumps_and_raises(self, engines, tmp_path):
        dump = str(tmp_path / "watchdog.json")
        eng = engines(watchdog_timeout=0.01, watchdog_dump_path=dump)
        eng.add_request(PROMPTS[0], 4)
        eng._last_progress -= 10.0  # a wedged device: no progress
        with pytest.raises(RuntimeError, match="serving watchdog"):
            eng.step()
        assert eng.stats()["watchdog_fires"] == 1.0
        with open(dump) as f:
            bundle = json.load(f)
        assert bundle["event"] == "watchdog"
        assert bundle["stalled_seconds"] > 0.01
        assert "queue_depth=1" in bundle["diagnosis"]
        assert bundle["stats"]["watchdog_fires"] == 1.0

    def test_watchdog_names_the_stuck_slot(self, engines, tmp_path):
        """A page_alloc fault on every call wedges a paged engine's
        prefill: the watchdog raises naming the stuck slot."""
        dump = str(tmp_path / "stuck.json")
        eng = engines(faults=_plan(False, [dict(site="page_alloc", every=1,
                                                times=None)]),
                      watchdog_timeout=0.05, watchdog_dump_path=dump,
                      **PAGED)
        eng.add_request(PROMPTS[0], 4)
        with pytest.raises(RuntimeError, match="slot 0: request 0 "
                           "prefilling"):
            for _ in range(10_000):
                eng.step()
                time.sleep(0.001)
        with open(dump) as f:
            assert "slot 0: request 0" in json.load(f)["diagnosis"]

    def test_generate_stall_bound_is_diagnostic(self, engines):
        eng = engines()
        eng._GENERATE_STALL_TICKS = 5
        eng._step_chunked = lambda: []  # wedge: ticks do nothing
        with pytest.raises(RuntimeError, match="generate"):
            eng.generate([PROMPTS[0]], 4)


# ---------------------------------------------------------------------------
# seeded chaos, against the JAX engine
# ---------------------------------------------------------------------------


CHAOS = [
    # consulted on paged layouts only; 0 fires on contiguous
    dict(site="page_alloc", nth=3),
    dict(site="device_step", tick=2),
    dict(site="logits", tick=4, payload={"slot": 1}),
    dict(site="host_fetch", p=0.3, times=2),
]


def _chaos_run(eng):
    for p in PROMPTS:
        eng.add_request(p, MAX_NEW)
    done = {}
    for _ in range(2):
        for r in eng.step():
            done[r.request_id] = r
    # request 1 (9-token prompt, budget 4) is still prefilling
    assert eng._slots[1] is not None and eng._slots[1].prefilling
    res = eng.cancel(1)
    assert res.finish_reason == "cancelled" and res.tokens == []
    done[1] = res
    done.update({r.request_id: r for r in eng.drain()})
    return done


@pytest.mark.parametrize("layout", [{}, PAGED, INT8],
                         ids=["contig", "paged-bf16", "paged-int8"])
def test_chaos_run_matches_jax_and_fault_free(engines, layout):
    """One seeded plan (an allocator failure, a device-step retry, a
    NaN-poisoned slot, two host-fetch retries) and a mid-prefill cancel:
    the JAX engine's results and counters, the surviving requests
    bitwise equal to the fault-free run, the accounting identity, and a
    drained paged engine holding no page."""
    ref = _ref(engines, layout)
    plans = [_plan(side, CHAOS, seed=12) for side in (False, True)]
    eng = engines(faults=plans[0], max_step_retries=2, **layout)
    baseline = eng._allocator.snapshot() if eng.paged else None
    done = _chaos_run(eng)
    jeng = engines(True, faults=plans[1], max_step_retries=2, **layout)
    jdone = _chaos_run(jeng)
    assert {i: (r.tokens, r.finish_reason) for i, r in done.items()} == {
        i: (r.tokens, r.finish_reason) for i, r in jdone.items()}
    s, js = eng.stats(), jeng.stats()
    assert {c: s[c] for c in COUNTERS} == {c: js[c] for c in COUNTERS}
    assert plans[0].fires == plans[1].fires
    assert sum(plans[0].fires.values()) >= 3
    assert s["step_retries"] >= 1.0 and s["cancelled"] == 1.0
    assert s["quarantined"] == 1.0
    errored = [i for i, r in done.items() if r.finish_reason == "error"]
    assert len(errored) == 1
    victim = errored[0]
    assert done[victim].tokens == ref[victim][:len(done[victim].tokens)]
    for rid in range(len(PROMPTS)):
        if rid not in (1, victim):
            assert done[rid].finish_reason == "length"
            assert done[rid].tokens == ref[rid][:MAX_NEW]
    reasons = [c["finish_reason"] for c in eng.completions]
    assert len(reasons) == len(PROMPTS)
    completed = sum(r in ("eos", "length", "capacity") for r in reasons)
    assert (completed + s["shed"] + s["quarantined"] + s["cancelled"]
            + s["deadline_exceeded"]) == len(PROMPTS)
    if eng.paged:
        assert plans[0].fires["page_alloc"] == 1
        eng._allocator.assert_consistent()
        assert eng._allocator.snapshot() == baseline
