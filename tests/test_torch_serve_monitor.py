"""The port's engine and router with the monitor layer against JAX's.

The tiny fp32 GPT of the serving tests (vocab 96, hidden 32, 2 layers,
4 heads, 32 positions), 2 slots, capacity 24, budget 4, the same
numpy-drawn weights on both sides. Both engines (and both fleets) serve
the same prompts under the same trace ids; their clocks differ, so the
comparisons are structural: every tracer event's phase, name, track and
args in order with the timestamps dropped, the registry's families,
label sets, counter values and histogram counts, the flight recorder's
bundles, the ``stats()`` percentile source, and the router's merged
trace and merged registry. Within the port, a request's spans reproduce
its completion record's TTFT and queue wait.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_apex_tpu.monitor as jmon
import rocm_apex_tpu_torch.monitor as mon
from rocm_apex_tpu.inference import AdapterPool as JaxAdapterPool
from rocm_apex_tpu.inference import Fault as JaxFault
from rocm_apex_tpu.inference import FaultInjected as JaxFaultInjected
from rocm_apex_tpu.inference import FaultPlan as JaxFaultPlan
from rocm_apex_tpu.inference import InferenceEngine as JaxEngine
from rocm_apex_tpu.inference import ReplicaRouter as JaxRouter
from rocm_apex_tpu.inference import SamplingParams as JaxSamplingParams
from rocm_apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from rocm_apex_tpu.models.gpt import GPTModel as JaxGPTModel
from rocm_apex_tpu_torch.convert import from_jax_params, random_params
from rocm_apex_tpu_torch.inference import (
    AdapterPool,
    Fault,
    FaultInjected,
    FaultPlan,
    InferenceEngine,
    ReplicaRouter,
    SamplingParams,
)
from rocm_apex_tpu_torch.models.gpt import GPTConfig

SHAPE = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_position_embeddings=32,
             tensor_parallel_size=1)
ENGINE = dict(num_slots=2, capacity=24, prefill_token_budget=4, seed=0)
PAGED = dict(paged=True, page_size=4)
INT8 = dict(paged=True, page_size=4, kv_dtype=torch.int8)
PROMPTS = [
    [1, 2, 3, 1, 2],
    [7, 8, 9, 7, 8, 9, 7, 8, 9],
    [4, 5, 6, 4],
    [2, 4, 6, 8, 2, 4],
]
SHARED = [  # a 4-token page shared by three prompts
    [5, 6, 7, 8, 9, 10],
    [5, 6, 7, 8, 11],
    [5, 6, 7, 8, 9, 10, 12, 13],
    [3, 3],
]


def _jax_kw(kw):
    kw = dict(kw)
    dt = kw.get("kv_dtype")
    if dt is torch.int8:
        kw["kv_dtype"] = jnp.int8
    elif dt is torch.bfloat16:
        kw["kv_dtype"] = jnp.bfloat16
    kw["sampling"] = JaxSamplingParams(temperature=0.0)
    if "faults" in kw and kw["faults"] is not None:
        kw["faults"] = JaxFaultPlan(
            [JaxFault(**f) for f in kw["faults"]], seed=0)
    return kw


@pytest.fixture(scope="module")
def engine():
    """``engine(jax_side, **kw)`` over the same weights (``faults`` as a
    list of `Fault` dicts, built for the side); JAX engines adopt a
    same-geometry donor's compiled steps."""
    tcfg = GPTConfig(**SHAPE, params_dtype=torch.float32, dtype=torch.float32)
    tree = random_params(tcfg, seed=1)
    jmodel = JaxGPTModel(JaxGPTConfig(
        **SHAPE, hidden_dropout=0.0, attention_dropout=0.0,
        params_dtype=jnp.float32, dtype=jnp.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = from_jax_params(tree, tcfg, device="cpu")
    donors = []

    def make(jax_side=False, **kw):
        kw = {**ENGINE, **kw}
        if not jax_side:
            if kw.get("faults") is not None:
                kw["faults"] = FaultPlan([Fault(**f) for f in kw["faults"]],
                                         seed=0)
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

    return make


def _plain(x):
    """JSON-normal form: numpy scalars become Python ones."""
    return json.loads(json.dumps(
        x, default=lambda v: v.item() if hasattr(v, "item") else str(v)))


def timeline(tracer):
    """Every event as (phase, name, track, args), in order, timestamps
    and wall-clock args dropped."""
    ev = tracer.events()
    tracks = {e["tid"]: e["args"]["name"] for e in ev
              if e["ph"] == "M" and e["name"] == "thread_name"}
    out = []
    for e in ev:
        if e["ph"] == "M":
            continue
        args = {k: v for k, v in (e.get("args") or {}).items()
                if k != "stalled_seconds"}
        out.append((e["ph"], e["name"], tracks[e["tid"]], _plain(args)))
    return out


def families(registry, values=True):
    """Family -> (kind, help, sorted (labels, counter/gauge value or
    histogram count)) of a registry snapshot."""
    out = {}
    for name, e in registry.snapshot().items():
        series = sorted(
            (tuple(sorted(s["labels"].items())),
             (s["count"] if "buckets" in s else s["value"])
             if values else None)
            for s in e["series"])
        out[name] = (e["type"], e["help"], series)
    return out


def drive(eng, prompts, max_new, script=None, max_ticks=300):
    """Submit every prompt under trace id ``t<i>`` (``script(eng, tick,
    ids)`` may act before each tick), run dry catching injected faults,
    and return {request id: (tokens, finish reason)} and the raise
    count."""
    ids = [eng.add_request(p, max_new, trace_id=f"t{i}")
           for i, p in enumerate(prompts)]
    out, raised, ticks = {}, 0, 0
    while eng.has_work():
        if script is not None:
            for r in script(eng, ticks, ids) or ():
                out[r.request_id] = (r.tokens, r.finish_reason)
        try:
            for r in eng.step():
                out[r.request_id] = (r.tokens, r.finish_reason)
        except (FaultInjected, JaxFaultInjected):
            raised += 1
        ticks += 1
        assert ticks < max_ticks, "engine failed to drain"
    return out, raised


def _lifecycle(eng, tick, ids):
    """Sheds at submission (max_queue=3), an in-flight cancel at tick 2,
    a queued cancel at tick 3."""
    if tick == 2:
        r = eng.cancel(ids[0])
        return [r] if r is not None else []
    if tick == 3:
        r = eng.cancel(ids[3])
        return [r] if r is not None else []
    return []


SCENARIOS = {
    "contiguous": (dict(), PROMPTS, 6, None),
    "whole_prompt": (dict(prefill_token_budget=None, max_prompt_len=12),
                     PROMPTS, 5, None),
    "int8_pages": (INT8, PROMPTS, 6, None),
    "prefix_sharing": (dict(PAGED, prefix_sharing=True), SHARED, 6, None),
    "speculative": (dict(spec_k=2), [[1, 2, 1, 2, 1, 2], [3, 4, 3, 4]], 8,
                    None),
    "pool_pressure": (dict(PAGED, num_pages=6), PROMPTS, 8, None),
    "lifecycle": (dict(max_queue=3), PROMPTS, 6, _lifecycle),
    "faults": (dict(INT8, max_step_retries=1, faults=[
        dict(site="host_fetch", tick=1),
        dict(site="logits", tick=4, payload={"slot": 1,
                                             "value": float("inf")}),
        dict(site="device_step", tick=6, times=2),
    ]), PROMPTS, 6, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_traced_timelines_and_registry_match_jax(engine, name):
    """Same prompts, same plan: the port's tracer records the JAX
    engine's events (names, tracks, args, order), its registry the JAX
    registry's families, labels, counts and completion counters, its
    results the JAX results."""
    kw, prompts, max_new, script = SCENARIOS[name]
    got = []
    for side, pkg in ((False, mon), (True, jmon)):
        tr = pkg.Tracer(annotate_device=False)
        eng = engine(side, tracer=tr, **kw)
        if name == "lifecycle":
            eng.add_request([9, 9, 9], 3, trace_id="t-shed")  # fills queue
        out, raised = drive(eng, prompts, max_new, script)
        if name == "lifecycle":
            drained = eng.drain()
            eng.reopen()
            eng.add_request([1, 1], 2, trace_id="t-after")
            out.update({r.request_id: (r.tokens, r.finish_reason)
                        for r in drained + eng.drain()})
        got.append((out, raised, timeline(tr), families(eng.registry),
                    _plain(eng.completions and [
                        (c["request_id"], c["finish_reason"],
                         c["new_tokens"], c["prompt_tokens"])
                        for c in eng.completions])))
    port, ref = got
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert port[4] == ref[4]
    names = {e[1] for e in port[2]}
    assert {"enqueue", "finish", "decode"} <= names
    ends = sum(e[1] in ("finish", "shed") for e in port[2])
    assert ends == len(port[0])
    reasons = dict(port[3]["serve_completions_total"][2])
    assert sum(reasons.values()) == len(port[0])


@pytest.mark.parametrize("name", ["contiguous", "prefix_sharing"])
def test_spans_reproduce_ttft_and_queue_wait(engine, name, tmp_path):
    """From the exported Chrome trace alone: each request's decode span
    starts at its first token and its queue_wait span ends at its lease,
    so decode.ts - enqueue.ts and queue_wait.dur give the completion
    record's TTFT and queue wait (to a microsecond's rounding)."""
    kw, prompts, max_new, _ = SCENARIOS[name]
    tr = mon.Tracer()
    eng = engine(False, tracer=tr, **kw)
    drive(eng, prompts, max_new)
    path = tmp_path / "serve.json"
    tr.export_chrome_trace(str(path))
    body = json.loads(path.read_text())
    assert body["otherData"]["dropped_events"] == 0 and tr.dropped == 0
    by_req = {}
    for e in body["traceEvents"]:
        rid = (e.get("args") or {}).get("request_id")
        if rid is not None and e["name"] in ("enqueue", "decode",
                                             "queue_wait", "finish"):
            by_req.setdefault(rid, {}).setdefault(e["name"], []).append(e)
    recs = {c["request_id"]: c for c in eng.completions}
    assert set(by_req) == set(recs)
    for rid, ev in by_req.items():
        assert len(ev["finish"]) == 1
        ttft_us = ev["decode"][0]["ts"] - ev["enqueue"][0]["ts"]
        assert abs(ttft_us - 1e3 * recs[rid]["ttft_ms"]) <= 1.0
        assert abs(ev["queue_wait"][-1]["dur"]
                   - 1e3 * recs[rid]["queue_wait_ms"]) <= 1.0


def test_inf_payload_quarantine_dumps_the_flight_recorder(engine, tmp_path):
    """JAX tests/L0/test_robustness.py's flight-recorder case: an Inf on
    slot 0 at tick 3 quarantines that request, the other finishes, and
    the recorder dumps one ``nonfinite/slot0`` bundle, the JAX engine's
    bundle but for nothing (same tick, request, position, tokens)."""
    plan = [dict(site="logits", tick=3,
                 payload={"slot": 0, "value": float("inf")})]
    dumps = []
    for side, pkg in ((False, mon), (True, jmon)):
        path = tmp_path / f"{side}.jsonl"
        fr = pkg.FlightRecorder(last_k=8, path=str(path))
        eng = engine(side, faults=plan, flight_recorder=fr)
        done = {r.request_id: r for r in eng.generate(PROMPTS[:2], 8)}
        assert done[0].finish_reason == "error"
        assert done[1].finish_reason == "length"
        assert len(fr.dumps) == 1
        assert fr.dumps[0]["offending"] == ["slot0"]
        assert "nonfinite/slot0" in str(fr.dumps[0])
        dumps.append((_plain(fr.dumps), path.read_text()))
    assert dumps[0] == dumps[1]


@pytest.mark.parametrize("registry", ["private", "null"])
def test_stats_switch_to_histograms_after_retention(engine, registry):
    """stats_retention=2 over four requests: with a registry the
    percentiles come from its histograms once the rings wrapped (as the
    JAX engine's), with NULL_REGISTRY from the two newest samples."""
    got = []
    for side, pkg in ((False, mon), (True, jmon)):
        kw = dict(stats_retention=2)
        if registry == "null":
            kw["registry"] = pkg.NULL_REGISTRY
        eng = engine(side, **kw)
        eng.generate(PROMPTS, 3)
        st = eng.stats()
        assert len(eng.completions) == 2
        if registry == "private":
            assert eng._h_ttft.count() == 4
            assert st["ttft_ms_p50"] == eng._h_ttft.percentile(50)
            assert st["queue_wait_ms_p95"] == eng._h_queue_wait.percentile(
                95)
        else:
            assert st["ttft_ms_p50"] == pytest.approx(
                1e3 * float(np.percentile(list(eng._ttfts), 50)))
        got.append((families(eng.registry),
                    [c["request_id"] for c in eng.completions]))
    assert got[0] == got[1]


def test_reset_stats_clears_the_series_in_place(engine):
    """reset_stats zeroes the engine's families on a shared registry and
    leaves the registry's other families alone, as JAX's does."""
    got = []
    for side, pkg, tpkg in ((False, mon, mon.telemetry),
                            (True, jmon, jmon.telemetry)):
        reg = tpkg.MetricRegistry()
        other = reg.counter("other_total", "Not the engine's.")
        other.inc(5)
        eng = engine(side, registry=reg)
        eng.generate(PROMPTS[:2], 3)
        before = families(reg)
        eng.reset_stats()
        after = families(reg)
        assert after["other_total"][2] == [((), 5.0)]
        assert after["serve_completions_total"][2] == []
        got.append((before, after))
    assert got[0] == got[1]
    with pytest.raises(ValueError, match="stats_retention"):
        engine(False, stats_retention=0)


def test_timeseries_ticks_once_a_step_and_exporter_scrapes(engine):
    """A TimeSeriesStore(interval=1e-9) samples at every step, the
    exporter serves it live, and /metrics after the serve counts every
    completion."""
    import urllib.request

    eng = engine(False)
    store = mon.TimeSeriesStore(eng.registry, interval=1e-9, capacity=1000)
    eng.timeseries = store
    server = mon.start_exporter(eng.registry, engine=eng)
    try:
        for i, p in enumerate(PROMPTS):
            eng.add_request(p, 4, trace_id=f"t{i}")
        ticks, scrapes = 0, []
        while eng.has_work():
            eng.step()
            ticks += 1
            if ticks == 2:
                for path in ("/metrics", "/healthz", "/varz",
                             "/timeseries"):
                    with urllib.request.urlopen(server.url + path,
                                                timeout=10) as r:
                        scrapes.append((path, r.status, r.read()))
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
    finally:
        server.close()
    assert len(store) == ticks
    assert all(status == 200 for _, status, _ in scrapes)
    health = json.loads(scrapes[1][2])
    assert health["healthy"] and health["ticks"] == 2
    assert json.loads(scrapes[3][2])["t"] and store.delta(
        "serve_completions_total") == 4.0
    total = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("serve_completions_total{"))
    assert total == 4.0


def test_watchdog_dump_writes_the_trace_beside_it(engine, tmp_path):
    dump = tmp_path / "wd.json"
    tr = mon.Tracer(annotate_device=False)
    eng = engine(False, tracer=tr, watchdog_timeout=1e-3,
                 watchdog_dump_path=str(dump))
    eng.add_request(PROMPTS[0], 4, trace_id="t0")
    eng._last_progress = time.perf_counter() - 1.0
    with pytest.raises(RuntimeError, match="watchdog"):
        eng.step()
    assert json.loads(dump.read_text())["event"] == "watchdog"
    body = json.loads((tmp_path / "wd.json.trace.json").read_text())
    assert [e["name"] for e in body["traceEvents"]
            if e["ph"] == "i"] == ["enqueue", "watchdog"]


def test_tenant_series_and_slo_board_match_jax(engine):
    """With an adapter pool the engine labels TTFT and tokens by tenant
    under the registry's cardinality cap (``other`` past it), and a
    TenantSLOBoard syncs one monitor per label, as in JAX."""
    rng = np.random.RandomState(1)
    L, H = SHAPE["num_layers"], SHAPE["hidden_size"]
    fac = [{"qkv": (0.6 * rng.randn(H, 2), 0.6 * rng.randn(2, 3 * H)),
            "dense": (0.6 * rng.randn(H, 2), 0.6 * rng.randn(2, H))}
           for _ in range(L)]
    got = []
    for side, pkg, tpkg in (
            (False, mon, mon.telemetry), (True, jmon, jmon.telemetry)):
        pool = (JaxAdapterPool(L, H, max_resident=4, max_rank=4) if side
                else AdapterPool(L, H, max_resident=4, max_rank=4,
                                 device="cpu"))
        aids = [pool.register(f"t{i}", fac, rank=2) for i in range(3)]
        reg = tpkg.MetricRegistry(max_label_sets=7)
        eng = engine(side, adapter_pool=pool, registry=reg)
        for p, a in zip(PROMPTS, [aids[0], aids[1], aids[2], 0]):
            eng.add_request(p, 3, adapter_id=a)
        while eng.has_work():
            eng.step()
        board = pkg.TenantSLOBoard(eng._h_ttft, objective=0.9,
                                   threshold_ms=1e9)
        board.sync(eng)
        got.append((families(reg), sorted(board.monitors),
                    {t: eng._tenant_series(t) for t in eng.tenant_stats()},
                    eng.tenant_stats()))
    assert got[0] == got[1]
    assert "other" in got[0][2].values()


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def _fleet(engine, side, pkg, **kw):
    tracers = [pkg.Tracer(annotate_device=False) for _ in range(3)]
    engines = [engine(side, tracer=t, **kw) for t in tracers[1:]]
    cls = JaxRouter if side else ReplicaRouter
    return cls(engines=engines, tracer=tracers[0]), tracers


@pytest.mark.parametrize("layout", ["paged", "int8"])
def test_router_merged_trace_and_registry_match_jax(engine, layout,
                                                    tmp_path):
    """A two-replica fleet with tracers on the router and both replicas;
    replica 0 drains mid-serve, shipping its pages: the merged trace
    shows one finish per trace id, the migrated requests' lifelines span
    both replicas, and the merged registry counts every completion, the
    JAX fleet's event for event and family for family."""
    kw = PAGED if layout == "paged" else INT8
    got = []
    for side, pkg in ((False, mon), (True, jmon)):
        fleet, tracers = _fleet(engine, side, pkg, **kw)
        ids = [fleet.add_request(p, 6, trace_id=f"t{i}")
               for i, p in enumerate(PROMPTS)]
        out, ticks = {}, 0
        while fleet.has_work():
            if ticks == 2:
                fleet.drain_replica(0)
            for r in fleet.step():
                out[r.request_id] = (r.tokens, r.finish_reason)
            ticks += 1
            assert ticks < 300
        fleet.rejoin_replica(0)
        body = fleet.merged_trace()
        n = fleet.export_merged_trace(str(tmp_path / f"{side}.json"))
        assert n == len(body["traceEvents"])
        lines = pkg.trace_lifelines(body)
        merged = fleet.merged_registry()
        got.append((out, {k: (v["pids"], v["finishes"], v["names"])
                          for k, v in lines.items()},
                    [timeline(t) for t in tracers], families(merged),
                    fleet.stats()))
        assert sorted(lines) == [f"t{i}" for i in range(len(ids))]
        assert all(v["finishes"] == 1 for v in lines.values())
        assert any(len(v["pids"]) > 2 for v in lines.values())
        completions = dict(families(merged)["serve_completions_total"][2])
        assert sum(completions.values()) == len(PROMPTS)
    assert got[0] == got[1]


def test_router_timeseries_and_exporter(engine):
    """The router's time series ticks once a fleet step over its own
    registry, and start_exporter(router=) serves the fleet surface: the
    merged registry on /metrics, fleet health, per-replica /varz."""
    import urllib.request

    fleet, _ = _fleet(engine, False, mon, **PAGED)
    store = mon.TimeSeriesStore(fleet.registry, interval=1e-9)
    fleet.timeseries = store
    server = mon.start_exporter(router=fleet)
    try:
        fleet.generate(PROMPTS, 4)
        with urllib.request.urlopen(server.url + "/varz", timeout=10) as r:
            varz = json.loads(r.read())
        with urllib.request.urlopen(server.url + "/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
    finally:
        server.close()
    assert len(store) == fleet.tick_count
    assert store.gauge_over("router_healthy_replicas")["max"] == 2.0
    assert health["healthy"] and health["healthy_replicas"] == 2
    assert len(varz["replica_detail"]) == 2 and "timeseries" in varz
    total = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("serve_completions_total{"))
    assert total == 4.0
