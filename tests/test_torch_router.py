"""The port's `ReplicaRouter` and page shipping against the JAX package's.

The cases of tests/L0/test_router.py, of test_disagg.py's
TestPageShipping, TestReplicaClasses (tp=1) and TestSharedPrefixRegistry,
and of test_adapters.py's TestRouterAdapterAffinity that do not need the
monitor layer (ROADMAP Queue 1 item 9), at their geometry: the tiny fp32
GPT (vocab 96, hidden 32, 2 layers, 4 heads, 32 positions), 2 slots a
replica, capacity 24, budget 4, pages of 4, the same numpy-drawn weights
on both sides. Tokens are compared for equality: a fleet's with the
single engine's and with the JAX fleet's under the same fault plan;
shipped pages bit for bit (pool blocks and int8 scales) between the
source's pool, the payload and the destination's pool. The router's
retrace sentinel (``retrace_policy``, `arm_retrace_sentinel`) is refused
by name, naming item 9b; its tracer, time series and merges are held
against JAX's in test_torch_serve_monitor.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocm_apex_tpu.inference import AdapterPool as JaxAdapterPool
from rocm_apex_tpu.inference import Fault as JaxFault
from rocm_apex_tpu.inference import FaultPlan as JaxFaultPlan
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import ReplicaRouter as JaxRouter
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    REPLICA_CLASSES,
    REPLICA_STATES,
    AdapterPool,
    Fault,
    FaultPlan,
    InferenceEngine,
    PrefixStore,
    ReplicaRouter,
    SamplingParams,
    SharedPrefixRegistry,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
EKW = dict(num_slots=2, capacity=24, prefill_token_budget=4, seed=0)
PAGED = dict(paged=True, page_size=4)
POOLS = {
    "bf16": dict(paged=True, page_size=4, kv_dtype=torch.bfloat16),
    "int8": dict(paged=True, page_size=4, kv_dtype=torch.int8),
}
PROMPTS = [
    [1, 2, 3, 1, 2],
    [7, 8, 9, 7, 8, 9, 7, 8, 9],
    [4, 5, 6, 4],
    [2, 4, 6, 8, 2, 4],
]
MAX_REF = 12
MAX_NEW = 5
SHIP_PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]]
FLEET_PROMPTS = [
    [5, 6, 7, 8, 9, 10, 11],
    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
    [5, 6, 7, 8, 9, 10, 12],  # shares a page-4 prefix with #0
    [12, 13],
]
SHIP_NEW = 8


def _jax_kw(kw):
    kw = dict(kw)
    dt = kw.get("kv_dtype")
    if dt is torch.bfloat16:
        kw["kv_dtype"] = jnp.bfloat16
    elif dt is torch.int8:
        kw["kv_dtype"] = jnp.int8
    kw["sampling"] = JaxSamplingParams(temperature=0.0)
    return kw


@pytest.fixture(scope="module")
def sides():
    """``engine(jax_side, **kw)`` and ``router(jax_side, **kw)`` over the
    same weights; JAX engines adopt a same-geometry donor's steps."""
    tcfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(tcfg, seed=1)
    jmodel = JaxGPTModel(JaxGPTConfig(
        **SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
        params_dtype=jnp.float32, dtype=jnp.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(tree, tcfg, device="cpu")
    donors = []

    def engine(jax_side=False, **kw):
        kw = {**EKW, **kw}
        if not jax_side:
            return InferenceEngine(
                model, sampling=SamplingParams(temperature=0.0), **kw)
        kw = _jax_kw(kw)
        for donor in donors:
            try:
                return JaxEngine(jmodel, jparams, step_source=donor, **kw)
            except ValueError:
                continue
        eng = JaxEngine(jmodel, jparams, **kw)
        donors.append(eng)
        return eng

    def router(jax_side=False, engine_kwargs=None, replicas=2, **kw):
        ekw = dict(engine_kwargs or {})
        if "faults" in kw:
            ekw["faults"] = kw["faults"]
        engines = [engine(jax_side, **ekw) for _ in range(replicas)]
        cls = JaxRouter if jax_side else ReplicaRouter
        return cls(engines=engines, **kw)

    def built(**kw):
        """The port's router building its own replicas from the model."""
        return ReplicaRouter(
            model, engine_kwargs=dict(
                EKW, sampling=SamplingParams(temperature=0.0),
                **kw.pop("engine_kwargs", {})), **kw)

    return engine, router, built


@pytest.fixture(scope="module")
def refs(sides):
    """The port's single-engine greedy tokens at MAX_REF, per layout."""
    engine = sides[0]
    out = {}
    for name, kw in (("contiguous", {}), ("paged", PAGED)):
        eng = engine(**kw)
        out[name] = {r.request_id: r.tokens
                     for r in eng.generate(PROMPTS, MAX_REF)}
    return out


def run_to_done(router, max_ticks=400):
    out, ticks = {}, 0
    while router.has_work():
        for r in router.step():
            assert r.request_id not in out, "double delivery"
            out[r.request_id] = r
        ticks += 1
        assert ticks < max_ticks, "fleet failed to drain"
    return out


def assert_parity(results, ref, max_new):
    for i, r in enumerate(results):
        assert r.tokens == ref[i][:max_new], (i, r.tokens, ref[i])


def _plan(side, faults, seed=0):
    fault, plan = (JaxFault, JaxFaultPlan) if side else (Fault, FaultPlan)
    return plan([fault(**f) for f in faults], seed=seed)


KILL = [dict(site="replica_kill", tick=4, payload={"replica": 0})]


# ---------------------------------------------------------------------------
# placement parity and accounting
# ---------------------------------------------------------------------------


def test_single_vs_multi_parity(sides, refs):
    """The router building its replicas from the model (they share its
    weights): the single engine's tokens, both replicas served, and the
    JAX fleet's tokens and counters."""
    engine, router, built = sides
    fleet = built()
    results = fleet.generate(PROMPTS, MAX_NEW)
    assert_parity(results, refs["contiguous"], MAX_NEW)
    s = fleet.stats()
    assert s["submitted"] == s["completed"] == len(PROMPTS)
    assert s["migrations"] == s["replica_quarantines"] == 0
    assert all(fleet.replica(i).stats()["admitted"] > 0 for i in range(2))
    assert fleet.replica(0).model is fleet.replica(1).model
    jfleet = router(True)
    assert [r.tokens for r in jfleet.generate(PROMPTS, MAX_NEW)] == [
        r.tokens for r in results]
    assert jfleet.stats() == s
    assert "router_events_total" in fleet.registry.exposition()
    assert fleet.health()["healthy"] and len(
        fleet.varz()["replica_detail"]) == 2
    assert REPLICA_STATES == ("up", "quarantined", "drained")
    assert REPLICA_CLASSES == ("mixed", "prefill", "decode")


def test_fleet_accounting_identity(sides, refs):
    """Bounded global admission: the newest two shed, the identity
    closes, drain is idempotent and closes admission; as the JAX
    fleet's."""
    router = sides[1]
    got = []
    for side in (False, True):
        fleet = router(side, max_queue=2)
        results = fleet.generate(PROMPTS, MAX_NEW)
        assert_parity(results[:2], refs["contiguous"], MAX_NEW)
        assert all(r.finish_reason == "queue_full" and r.tokens == []
                   for r in results[2:])
        s = fleet.stats()
        assert s["submitted"] == s["completed"] == 4.0
        assert s["shed"] == s["finished_queue_full"] == 2.0
        fleet.drain()
        fleet.drain()
        with pytest.raises(RuntimeError, match="draining"):
            fleet.add_request(PROMPTS[0], 2)
        got.append(s)
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


def test_kill_mid_decode_recovery_parity(sides, refs):
    """A replica_kill at tick 4, mid-decode: recovery from the router's
    token mirror gives the undisturbed tokens, once each; the carcass is
    empty and probes back; the JAX fleet logs and counts the same."""
    router = sides[1]
    got = []
    for side in (False, True):
        plan = _plan(side, KILL)
        fleet = router(side, faults=plan, rejoin_after=4)
        for p in PROMPTS:
            fleet.add_request(p, MAX_NEW)
        done = run_to_done(fleet)
        assert plan.fires.get("replica_kill") == 1
        assert fleet.fault_log == [("replica_kill", 4, 0)]
        results = [done[i] for i in sorted(done)]
        assert_parity(results, refs["contiguous"], MAX_NEW)
        s = fleet.stats()
        assert s["replica_kills"] == s["replica_quarantines"] == 1.0
        assert s["migrations"] >= 1.0
        assert s["submitted"] == s["completed"] == len(PROMPTS)
        assert fleet.replica(0).num_active == fleet.replica(0).num_queued == 0
        for _ in range(fleet.rejoin_after + 2):
            if fleet.replica_state(0) == "up":
                break
            fleet.step()
        assert fleet.replica_state(0) == "up"
        got.append((fleet.stats(), [r.tokens for r in results]))
    assert got[0] == got[1]


@pytest.mark.parametrize("layout", ["paged", "bf16"])
def test_kill_paged_no_page_leak(sides, refs, layout):
    """The kill on pages: no page leaked on either replica, the
    allocators consistent, the JAX fleet's tokens."""
    router = sides[1]
    ekw = PAGED if layout == "paged" else POOLS["bf16"]
    toks = []
    for side in (False, True):
        plan = _plan(side, KILL)
        fleet = router(side, faults=plan, engine_kwargs=ekw)
        for p in PROMPTS:
            fleet.add_request(p, MAX_NEW)
        done = run_to_done(fleet)
        assert plan.fires.get("replica_kill") == 1
        for i in range(2):
            assert fleet.replica(i).pages_used == 0
            fleet.replica(i)._allocator.assert_consistent()
        toks.append([done[i].tokens for i in sorted(done)])
    assert toks[0] == toks[1]
    if layout == "paged":
        assert_parity([done[i] for i in sorted(done)], refs["paged"],
                      MAX_NEW)


def test_fault_plan_replay(sides):
    """reset() and a fresh fleet replay the same (site, tick, replica)
    sequence and tokens; the JAX fleet logs the same sequence."""
    router = sides[1]
    faults = [
        dict(site="replica_kill", tick=3, payload={"replica": 1}),
        dict(site="replica_stall", tick=1, payload={"replica": 0, "ticks": 2}),
        dict(site="replica_slow", tick=2,
             payload={"replica": 0, "seconds": 0.0}),
    ]
    logs = []
    for side in (False, True):
        plan = _plan(side, faults, seed=7)
        runs = []
        for _ in range(2):
            fleet = router(side, faults=plan)
            for p in PROMPTS[:2]:
                fleet.add_request(p, 3)
            done = run_to_done(fleet)
            runs.append((list(fleet.fault_log),
                         {i: done[i].tokens for i in done}))
            plan.reset()
        assert runs[0] == runs[1] and len(runs[0][0]) >= 3
        logs.append(runs[0])
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# prefix affinity, rolling drain, the engine's lifecycle
# ---------------------------------------------------------------------------


def test_prefix_affinity_accounting(sides):
    """Requests sharing a stored prefix land on the replica holding its
    chain (through the SharedPrefixRegistry the stores publish to)."""
    router = sides[1]
    fleet = router(engine_kwargs=dict(PAGED, prefix_sharing=True))
    base = [3, 1, 4, 1, 5, 9, 2, 6]  # two full pages
    fleet.generate([base + [50]], 3)
    owner = [i for i in range(2)
             if fleet.replica(i).prefix_match_tokens(base + [60]) > 0]
    assert len(owner) == 1
    assert fleet.stats()["shared_prefix_chains"] == 2.0
    assert len(fleet.generate([base + [60], base + [61]], 3)) == 2
    assert fleet.stats()["affinity_hits"] >= 2.0
    assert fleet.replica(owner[0]).stats()["prefix_hits"] >= 2.0
    for i in range(2):
        fleet.replica(i)._allocator.assert_consistent()


def test_rolling_drain_liveness(sides, refs):
    router = sides[1]
    fleet = router()
    ids = [fleet.add_request(p, MAX_NEW) for p in PROMPTS]
    done = {}
    for _ in range(3):
        for r in fleet.step():
            done[r.request_id] = r
    fleet.drain_replica(0)
    assert fleet.replica_state(0) == "drained"
    assert fleet.replica(0).num_active == 0
    done.update(run_to_done(fleet))
    assert_parity([done[i] for i in ids], refs["contiguous"], MAX_NEW)
    assert fleet.stats()["completed"] == len(PROMPTS)
    fleet.rejoin_replica(0)
    assert fleet.replica_state(0) == "up" and fleet.healthy_replicas == 2
    assert_parity(fleet.generate(PROMPTS[:2], 3), refs["contiguous"], 3)


def test_engine_drain_idempotent_and_reopen(sides, refs):
    """reopen() refuses a dirty engine; drain twice; then the migration
    format round-trips on one engine: evacuate and resume continue the
    tokens, the records carry adapter, tenant and trace id."""
    engine = sides[0]
    ref = refs["contiguous"]
    eng = engine()
    rid = eng.add_request(PROMPTS[0], 3, trace_id="t-fixed")
    with pytest.raises(RuntimeError, match="queued"):
        eng.reopen()
    assert eng.outstanding()[0]["trace_id"] == "t-fixed"
    done = {r.request_id: r for r in eng.drain()}
    assert done[rid].tokens == ref[0][:3]
    assert eng.drain() == [] and eng.draining
    eng.reopen()
    assert [r.tokens for r in eng.generate(PROMPTS[:2], 3)] == [
        ref[0][:3], ref[1][:3]]
    for p in PROMPTS[:2]:
        eng.add_request(p, MAX_NEW)
    for _ in range(4):
        eng.step()
    recs = eng.evacuate()
    assert len(recs) == 2 and eng.num_active == eng.num_queued == 0
    assert eng.stats()["evacuated"] == 2.0
    assert all(r["adapter_id"] == 0 and r["tenant"] is None
               and r["trace_id"] for r in recs)
    for rec in recs:
        eng.resume_request(
            rec["prompt"], rec["max_new_tokens"], rec["request_id"],
            generated=rec["generated"], enqueued_at=rec["enqueued_at"],
            deadline=rec["deadline"], queue_deadline=rec["queue_deadline"],
            first_token_at=rec["first_token_at"], chunks=rec["chunks"],
            trace_id=rec["trace_id"],
        )
    out = {}
    while eng.has_work():
        for r in eng.step():
            out[r.request_id] = r
    assert_parity([out[r["request_id"]] for r in recs], ref, MAX_NEW)
    assert eng.progress_marker == (eng._prompt_tokens,
                                   eng._generated_tokens, eng._evicted)


# ---------------------------------------------------------------------------
# page shipping
# ---------------------------------------------------------------------------


def _pages_of(eng, slot, n):
    return [int(p) for p in eng._table[slot, :n]]


def _blocks(cache, pages):
    idx = torch.tensor(pages)
    out = [x[idx] for x in (*cache.k, *cache.v)]
    if cache.quantized:
        out += [x[idx] for x in (*cache.k_scale, *cache.v_scale)]
    return out


def _payload_blocks(payload):
    out = [*payload["k"], *payload["v"]]
    if payload["quantized"]:
        out += [*payload["k_scale"], *payload["v_scale"]]
    return out


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8)
                                              if a.dtype != torch.int8
                                              else a, b.view(torch.uint8)
                                              if b.dtype != torch.int8
                                              else b)


def migrate(engine, ship, faults=None, checks=None, **layout):
    """Run SHIP_PROMPTS on a source until every live slot has two
    tokens, evacuate (shipping pages or not) and resume on a fresh
    destination. ``checks`` collects (source pool, payload, destination
    pool) block lists: the export is read before the source releases its
    pages, the import right after it lands."""
    src = engine(**layout)
    if checks is not None:
        export = src._export_slot_pages

        def export_checked(st, slot):
            payload = export(st, slot)
            n = len(payload["k"][0])
            checks[st.req.request_id] = [
                _blocks(src.cache, _pages_of(src, slot, n)),
                _payload_blocks(payload)]
            return payload

        src._export_slot_pages = export_checked
    for p in SHIP_PROMPTS:
        src.add_request(p, SHIP_NEW)
    out = {}
    for _ in range(40):
        for r in src.step():
            out[r.request_id] = (r.tokens, r.finish_reason)
        live = [s for s in src._slots if s is not None]
        if live and all(len(s.generated) >= 2 for s in live):
            break
    recs = src.evacuate(ship_pages=ship)
    src._allocator.assert_consistent()
    assert src._allocator.pages_used == 0
    if ship:
        assert any("pages" in r for r in recs)
    dst = engine(**layout, **({} if faults is None else dict(faults=faults)))
    if checks is not None:
        imp = dst._import_shipped_pages

        def import_checked(st, slot, payload):
            ok = imp(st, slot, payload)
            if ok:
                n = len(payload["k"][0])
                checks[st.req.request_id].append(
                    _blocks(dst.cache, _pages_of(dst, slot, n)))
            return ok

        dst._import_shipped_pages = import_checked
    for rec in recs:
        dst.resume_request(
            rec["prompt"], rec["max_new_tokens"], rec["request_id"],
            generated=rec["generated"], enqueued_at=rec["enqueued_at"],
            deadline=rec["deadline"], queue_deadline=rec["queue_deadline"],
            first_token_at=rec["first_token_at"], chunks=rec["chunks"],
            pages=rec.get("pages"),
        )
    while dst.has_work():
        for r in dst.step():
            out[r.request_id] = (r.tokens, r.finish_reason)
    dst._allocator.assert_consistent()
    assert dst._allocator.pages_used == 0
    return out, dst.stats()


class TestPageShipping:
    @pytest.mark.parametrize("pool", list(POOLS))
    def test_ship_token_identity(self, sides, pool):
        """Shipped-page resume gives the undisturbed run's and the
        replay's tokens, the import ran (no fallback), and every shipped
        page's blocks (and int8 scales) are the same bits in the
        source's pool, the payload and the destination's pool."""
        engine = sides[0]
        base = engine(**POOLS[pool])
        for p in SHIP_PROMPTS:
            base.add_request(p, SHIP_NEW)
        base = {r.request_id: (r.tokens, r.finish_reason)
                for r in base.drain()}
        replay, rst = migrate(engine, False, **POOLS[pool])
        checks = {}
        ship, sst = migrate(engine, True, checks=checks, **POOLS[pool])
        assert sst["page_ships"] >= 1 and sst["page_ship_fallbacks"] == 0
        assert rst["page_ships"] == 0
        assert base == replay == ship
        assert len(checks) == sst["page_ships"]
        for src_blocks, sent, landed in checks.values():
            for a, b, c in zip(src_blocks, sent, landed):
                assert _bits_equal(a, b) and _bits_equal(b, c)

    @pytest.mark.parametrize("pool", list(POOLS))
    def test_ship_matches_jax(self, sides, pool):
        """The same migration in the JAX engines: the same tokens and
        ship counters."""
        engine = sides[0]
        mine, mst = migrate(engine, True, **POOLS[pool])
        theirs, jst = migrate(lambda **kw: engine(True, **kw), True,
                              **POOLS[pool])
        assert mine == {i: (list(t), f) for i, (t, f) in theirs.items()}
        assert (mst["page_ships"], mst["page_ship_fallbacks"]) == (
            jst["page_ships"], jst["page_ship_fallbacks"])

    def test_ship_chaos_fallback(self, sides):
        """Every payload dropped at the page_ship site: the replay path,
        the same tokens, both allocators leak-free."""
        engine = sides[0]
        base, _ = migrate(engine, False, **POOLS["bf16"])
        plan = FaultPlan([Fault(site="page_ship", every=1, times=None)])
        chaos, cst = migrate(engine, True, faults=plan, **POOLS["bf16"])
        assert cst["page_ships"] == 0 and cst["page_ship_fallbacks"] >= 1
        assert base == chaos


# ---------------------------------------------------------------------------
# replica classes
# ---------------------------------------------------------------------------


class TestReplicaClasses:
    @pytest.mark.parametrize("pool", list(POOLS))
    def test_disagg_fleet_parity(self, sides, pool):
        """A prefill/decode fleet: the tokens of a uniform fleet and of
        the JAX disaggregated fleet, with handoffs that ship pages the
        decode replica imports."""
        router = sides[1]
        ekw = POOLS[pool]
        r_base = router(engine_kwargs=ekw).generate(FLEET_PROMPTS, SHIP_NEW)
        got = []
        for side in (False, True):
            dis = router(side, engine_kwargs=ekw,
                         replica_classes=["prefill", "decode"])
            r_dis = dis.generate(FLEET_PROMPTS, SHIP_NEW)
            st = dis.stats()
            assert st["handoffs"] >= 1 and st["page_migrations"] >= 1
            assert dis.replica(1).stats()["page_ships"] >= 1
            for i in range(2):
                dis.replica(i)._allocator.assert_consistent()
                assert dis.replica(i).pages_used == 0
            got.append(([(r.tokens, r.finish_reason) for r in r_dis], st))
        assert got[0] == got[1]
        assert got[0][0] == [(r.tokens, r.finish_reason) for r in r_base]

    def test_class_validation(self, sides):
        router = sides[1]
        with pytest.raises(ValueError, match="decode"):
            router(engine_kwargs=PAGED, replica_classes=["prefill"] * 2)
        with pytest.raises(ValueError, match="entries"):
            router(engine_kwargs=PAGED, replica_classes=["mixed"])
        with pytest.raises(ValueError, match="paged"):
            router(replica_classes=["prefill", "decode"])


# ---------------------------------------------------------------------------
# the shared prefix registry
# ---------------------------------------------------------------------------


class TestSharedPrefixRegistry:
    def test_publish_unpublish_best(self):
        reg = SharedPrefixRegistry(page_size=4)
        k1 = (None, (1, 2, 3, 4))
        k2 = (k1, (5, 6, 7, 8))
        reg.publish(0, k1)
        reg.publish(1, k1)
        reg.publish(1, k2)
        assert len(reg) == 2 and reg.holders(k1) == {0, 1}
        assert reg.best([1, 2, 3, 4, 5, 6, 7, 8, 9]) == {0: 4, 1: 8}
        assert reg.best([1, 2, 3, 4]) == {}
        reg.unpublish(1, k2)
        reg.unpublish(1, k1)
        assert reg.best([1, 2, 3, 4, 5, 6, 7, 8, 9]) == {0: 4}
        reg.unpublish(0, k1)
        assert len(reg) == 0 and reg.best([1, 2, 3, 4, 5]) == {}

    def test_store_hooks_feed_registry(self):
        """The port's PrefixStore hooks: registrations publish, the
        orphan cascade unpublishes, a duplicate chain publishes once."""
        store = PrefixStore(page_size=4)
        reg = SharedPrefixRegistry(page_size=4)
        seen = []
        store.on_register = lambda key, page: (reg.publish(7, key),
                                               seen.append(page))
        store.on_unregister = lambda key, page: reg.unpublish(7, key)
        k1 = store.register(None, [1, 2, 3, 4], page=10)
        k2 = store.register(k1, [5, 6, 7, 8], page=11)
        assert len(reg) == 2 and seen == [10, 11]
        assert reg.best([1, 2, 3, 4, 5, 6, 7, 8, 9]) == {7: 8}
        store.register(None, [1, 2, 3, 4], page=12)
        assert reg.holders(k1) == {7} and seen == [10, 11]
        store.unregister_page(10)
        assert len(reg) == 0 and k2 not in reg._holders


# ---------------------------------------------------------------------------
# adapter affinity and the refusals
# ---------------------------------------------------------------------------


def _adapter_engine(engine, side):
    cls = JaxAdapterPool if side else AdapterPool
    kw = {} if side else dict(device="cpu")
    pool = cls(SHAPE["num_layers"], SHAPE["hidden_size"], max_resident=4,
               max_rank=4, **kw)
    rng = np.random.RandomState(1)
    h = SHAPE["hidden_size"]
    ws = [{"qkv": (0.6 * rng.randn(h, 2), 0.6 * rng.randn(2, 3 * h)),
           "dense": (0.6 * rng.randn(h, 2), 0.6 * rng.randn(2, h))}
          for _ in range(SHAPE["num_layers"])]
    aid = pool.register("t1", ws, rank=2)
    return engine(side, adapter_pool=pool), aid


def test_router_adapter_affinity(sides):
    """Follow-up requests stick to the replica holding the adapter; an
    unknown adapter and a pool-less fleet refuse, as in JAX."""
    engine = sides[0]
    got = []
    for side in (False, True):
        (e0, aid), (e1, _) = (_adapter_engine(engine, side) for _ in range(2))
        fleet = (JaxRouter if side else ReplicaRouter)(engines=[e0, e1])
        fleet.add_request([1, 2, 3], 3, adapter_id=aid)
        out = run_to_done(fleet)
        for _ in range(3):
            fleet.add_request([4, 5], 3, adapter_id=aid)
        out.update(run_to_done(fleet))
        st = fleet.stats()
        assert st["adapter_affinity_hits"] >= 3.0
        assert all(r.finish_reason == "length" for r in out.values())
        with pytest.raises(KeyError, match="not registered"):
            fleet.add_request([1], 2, adapter_id=77)
        got.append((st, {i: r.tokens for i, r in out.items()}))
    assert got[0] == got[1]
    bare = ReplicaRouter(engines=[engine(), engine()])
    with pytest.raises(ValueError, match="AdapterPool"):
        bare.add_request([1], 2, adapter_id=1)


@pytest.mark.parametrize("option", ["retrace_policy"])
def test_monitor_options_refused(sides, option):
    with pytest.raises(NotImplementedError, match="item 9") as err:
        ReplicaRouter(engines=[sides[0]()], **{option: "on"})
    assert option in str(err.value)


@pytest.mark.parametrize("method, args", [
    ("arm_retrace_sentinel", ()),
])
def test_monitor_methods_refused(sides, method, args):
    fleet = ReplicaRouter(engines=[sides[0]()])
    with pytest.raises(NotImplementedError, match="item 9") as err:
        getattr(fleet, method)(*args)
    assert method in str(err.value)
