"""The port's monitor modules against the JAX package's, on the CPU.

The host side of the monitor layer: `trace` (Tracer, merge_traces,
trace_lifelines), `timeseries`, `recorder`, `logger`, `flops`, `slo` and
`exporter`. Both packages are fed the same observations, snapshots and
timestamps (fake clocks where a query reads one), and every answer is
compared: query results to 1e-12, Prometheus text and jsonl dumps byte
for byte, trace bodies event for event (their producer strings aside).
"""

import io
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rocm_apex_tpu.monitor as jmon
import rocm_apex_tpu_torch.monitor as mon
from rocm_apex_tpu.monitor import telemetry as jtel
from rocm_apex_tpu_torch.monitor import telemetry as tel

SIDES = (mon, jmon)


def _both(fn):
    """fn(package) for the port, then for the JAX package."""
    return [fn(pkg) for pkg in SIDES]


def _feed(registry, seed=0, n=200, tenants=("a", "b")):
    """The same observations into a registry of either package."""
    rng = np.random.default_rng(seed)
    c = registry.counter("req_total", "Requests.", labelnames=("code",))
    h = registry.histogram("lat_ms", "Latency.", labelnames=("tenant",))
    g = registry.gauge("depth", "Queue depth.")
    for i in range(n):
        c.inc(code="200" if rng.random() < 0.9 else "500")
        h.observe(float(rng.lognormal(3.0, 1.0)),
                  tenant=tenants[i % len(tenants)])
        g.set(float(rng.integers(0, 50)))
    return c, h, g


# ---------------------------------------------------------------------------
# the exports
# ---------------------------------------------------------------------------


def test_exports_cover_the_ported_names():
    names = {"Tracer", "NULL_TRACER", "merge_traces", "export_merged_trace",
             "trace_lifelines", "TimeSeriesStore", "FlightRecorder",
             "group_nonfinite", "MetricsLogger", "JsonlWriter",
             "TensorBoardWriter", "RegistryWriter", "device_memory_stats",
             "transformer_train_flops", "model_flops",
             "resnet50_train_flops", "mfu", "peak_flops_per_chip", "SLO",
             "SLOMonitor", "BurnRule", "TenantSLOBoard", "TelemetryServer",
             "engine_health", "fleet_health", "start_exporter",
             "DEFAULT_BURN_RULES", "MetricRegistry", "NULL_REGISTRY"}
    assert names <= set(mon.__all__)
    assert names <= set(jmon.__all__)
    for name in mon.__all__:
        assert hasattr(mon, name)


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------


def _scripted(pkg, capacity=65536, registry=None):
    """A tracer of either package with its clock zero at 0 and a fixed
    script of retrospective events."""
    tr = pkg.Tracer(capacity=capacity, annotate_device=False,
                    registry=registry)
    tr._t0 = 0.0
    tr.instant("enqueue", ts=0.001, track="req0", request_id=0,
               trace_id="t-0", prompt_tokens=5)
    tr.add_span("queue_wait", 0.001, 0.0025, track="req0", slot=1)
    tr.add_span("mixed_step", 0.0025, 0.004, track="engine",
                chunk_tokens=4, decodes=0)
    tr.instant("enqueue", ts=0.002, track="req1", request_id=1,
               trace_id="t-1")
    tr.add_span("decode", 0.004, 0.009, track="req0", tokens=6,
                request_id=0, trace_id="t-0")
    tr.instant("finish", ts=0.009, track="req0", reason="length",
               request_id=0, trace_id="t-0")
    tr.instant("finish", ts=0.010, track="req1", reason="eos",
               request_id=1, trace_id="t-1")
    return tr


def test_tracer_events_and_export_match_jax(tmp_path):
    port, ref = _both(_scripted)
    assert port.events() == ref.events()
    bodies = []
    for tr, name in ((port, "p.json"), (ref, "j.json")):
        n = tr.export_chrome_trace(str(tmp_path / name))
        body = json.loads((tmp_path / name).read_text())
        assert n == len(body["traceEvents"])
        body["otherData"].pop("producer")
        bodies.append(body)
    assert bodies[0] == bodies[1]
    assert mon.trace_lifelines(bodies[0]) == jmon.trace_lifelines(bodies[1])


def test_ring_wrap_counts_drops_as_jax():
    regs = [tel.MetricRegistry(), jtel.MetricRegistry()]
    port, ref = (_scripted(pkg, capacity=3, registry=r)
                 for pkg, r in zip(SIDES, regs))
    assert port.dropped == ref.dropped == 4
    assert port.events() == ref.events()
    assert regs[0].exposition() == regs[1].exposition()
    port.clear()
    assert port.dropped == 4 and port.events() == []


def test_merge_traces_and_lifelines_match_jax(tmp_path):
    bodies = []
    for pkg in SIDES:
        a, b = _scripted(pkg), _scripted(pkg)
        b._t0 = -0.5  # created earlier: every event of a shifts by 0.5 s
        body = pkg.merge_traces([a, b], labels=["router", "replica0"])
        n = pkg.export_merged_trace(str(tmp_path / "m.json"), [a, b])
        assert n == len(body["traceEvents"])
        body["otherData"].pop("producer")
        bodies.append(body)
    assert bodies[0] == bodies[1]
    lines = mon.trace_lifelines(bodies[0])
    assert lines == jmon.trace_lifelines(bodies[1])
    assert all(line["finishes"] == 2 for line in lines.values())
    with pytest.raises(ValueError, match="at least one"):
        mon.merge_traces([])
    with pytest.raises(ValueError, match="labels"):
        mon.merge_traces([mon.Tracer()], labels=["a", "b"])


def test_null_tracer_and_live_spans():
    assert mon.NULL_TRACER.enabled is False
    with mon.NULL_TRACER.span("x") as s:
        assert s is mon.NULL_TRACER.span("y")
    mon.NULL_TRACER.add_span("x", 0.0, 1.0)
    mon.NULL_TRACER.instant("x")
    assert mon.NULL_TRACER.events() == []
    tr = mon.Tracer()  # annotate_device: a record_function scope
    with tr.span("prefill", tokens=3):
        torch.ones(2).sum()
    with tr.step_span(7):
        pass
    ev = [e for e in tr.events() if e["ph"] == "X"]
    assert [e["name"] for e in ev] == ["prefill", "train_step"]
    assert ev[0]["args"] == {"tokens": 3} and ev[1]["args"] == {"step": 7}
    assert all(e["dur"] >= 0 for e in ev)
    with pytest.raises(ValueError, match="capacity"):
        mon.Tracer(capacity=0)
    a, b = mon.mint_trace_id(), mon.mint_trace_id("r")
    assert a != b and b.startswith("r")


# ---------------------------------------------------------------------------
# timeseries
# ---------------------------------------------------------------------------


def test_timeseries_queries_match_jax_under_a_fake_clock():
    out = []
    for pkg, tpkg in ((mon, tel), (jmon, jtel)):
        reg = tpkg.MetricRegistry()
        store = pkg.TimeSeriesStore(reg, interval=1.0, capacity=8,
                                    clock=lambda: 0.0)
        sampled = []
        for t in range(12):
            _feed(reg, seed=t, n=20 + 5 * t)
            sampled.append(store.tick(now=float(t) + 0.25 * (t % 2)))
            sampled.append(store.tick(now=float(t) + 0.5))
        ans = {"sampled": sampled, "dropped": store.dropped,
               "len": len(store)}
        for w in (None, 2.0, 3.5, 100.0):
            ans[f"delta{w}"] = store.delta("req_total", window=w)
            ans[f"delta500{w}"] = store.delta("req_total", window=w,
                                              labels={"code": "500"})
            ans[f"rate{w}"] = store.rate("lat_ms", window=w)
            ans[f"q{w}"] = [store.quantile_over("lat_ms", q, window=w)
                            for q in (0.0, 0.5, 0.95, 1.0)]
            ans[f"qa{w}"] = store.quantile_over(
                "lat_ms", 0.9, window=w, labels={"tenant": "a"})
            ans[f"g{w}"] = store.gauge_over("depth", window=w)
        ans["head"] = store.head()
        ans["series"] = store.series_json()
        out.append(ans)
    port, ref = out
    assert port.keys() == ref.keys()
    for key in port:
        assert _close(port[key], ref[key]), key
    assert port["dropped"] > 0 and False in port["sampled"]


def _close(a, b, tol=1e-12):
    """Nested structures equal, floats within tol."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol)
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, tol)
                                        for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= tol * max(1.0, abs(b))
    return a == b


def test_timeseries_edges_and_validation():
    reg = tel.MetricRegistry()
    store = mon.TimeSeriesStore(reg, interval=0.5)
    assert store.delta("x") == 0.0 and store.rate("x") == 0.0
    assert store.quantile_over("x", 0.5) == 0.0
    assert store.gauge_over("x")["samples"] == 0
    assert store.series_json()["t"] == []
    for bad in (dict(interval=0), dict(capacity=1)):
        with pytest.raises(ValueError):
            mon.TimeSeriesStore(reg, **bad)
    with pytest.raises(ValueError, match="q must"):
        store.quantile_over("x", 1.5)
    assert mon.TimeSeriesStore(tel.NULL_REGISTRY).tick() is False


# ---------------------------------------------------------------------------
# telemetry text, logger, recorder, flops
# ---------------------------------------------------------------------------


def test_prometheus_text_of_equal_registries_is_byte_equal():
    texts, snaps = [], []
    for pkg, tpkg in ((mon, tel), (jmon, jtel)):
        reg = tpkg.MetricRegistry()
        _feed(reg, seed=3)
        w = pkg.RegistryWriter(reg)
        for step in range(3):
            w.write(step, {"loss": 2.5 - step, "step_time_ms": 10.0 + step,
                           "platform": "cpu", "grad/norm": 0.5})
        merged = tpkg.MetricRegistry()
        merged.merge_from(reg)
        merged.merge_from(reg)
        texts.append((reg.exposition(), merged.exposition()))
        snaps.append(reg.snapshot())
    assert texts[0] == texts[1]
    assert snaps[0] == snaps[1]


def test_metrics_logger_windows_match_jax(tmp_path):
    streams = []
    for pkg in SIDES:
        buf = io.StringIO()
        path = tmp_path / f"{pkg.__name__}.jsonl"
        sink = pkg.JsonlWriter(path=str(path))
        tb_rows = []

        class Summary:
            def add_scalar(self, tag, value, step):
                tb_rows.append((tag, value, step))

        logger = pkg.MetricsLogger(
            [pkg.JsonlWriter(stream=buf), sink,
             pkg.TensorBoardWriter(Summary())],
            window=3, memory_stats=False,
        )
        rng = np.random.default_rng(0)
        for it in range(8):
            logger.log_step(it, {"loss": float(rng.random()),
                                 "overflows": float(it // 2),
                                 "serve/admitted": float(it)},
                            lr=1e-3 * (it + 1))
        logger.emit({"event": "done", "n": 8})
        final = logger.close()
        streams.append((buf.getvalue(), path.read_text(), tb_rows, final))
    assert streams[0] == streams[1]


def test_metrics_logger_times_steps_and_syncs_on_a_tensor():
    recs = []
    logger = mon.MetricsLogger([mon.JsonlWriter(stream=io.StringIO())],
                               window=2, tokens_per_step=1000.0,
                               flops_per_step=2e12, peak_flops=1e13,
                               memory_stats=True)
    for it in range(2):
        logger.start_step()
        x = torch.ones(8).sum()
        logger.end_step(sync_on=x)
        rec = logger.log_step(it, {"loss": 1.0})
        recs.append(rec)
    assert recs[0] is None
    rec = recs[1]
    assert rec["step_time_ms"] > 0 and rec["tokens_per_sec"] > 0
    dt = rec["step_time_ms"] / 1e3
    assert rec["mfu"] == pytest.approx(2e12 / dt / 1e13, rel=1e-12)
    assert rec["platform"] == "cpu" and rec["mem_bytes_in_use"] == 0.0
    with pytest.raises(ValueError, match="window"):
        mon.MetricsLogger(window=0)


def test_device_memory_stats_schema_on_the_cpu():
    got = mon.device_memory_stats(torch.device("cpu"))
    assert got == {"platform": "cpu", "mem_bytes_in_use": 0.0,
                   "mem_peak_bytes_in_use": 0.0}
    assert set(got) == set(jmon.device_memory_stats())
    if not torch.cuda.is_available():
        assert mon.device_memory_stats() == got


def test_flight_recorder_dumps_match_jax(tmp_path):
    out = []
    for pkg in SIDES:
        path = tmp_path / f"{pkg.__name__}.jsonl"
        rec = pkg.FlightRecorder(last_k=3, path=str(path), max_dumps=2)
        bundles = []
        for step in range(7):
            m = {"loss": 1.0 / (step + 1), "loss_scale": 2.0 ** step,
                 "nonfinite/embedding": 1.0 if step in (3, 5) else 0.0,
                 "found_inf": 1.0 if step == 6 else 0.0}
            if step == 4:
                m["grad_norm"] = float("nan")
            bundles.append(rec.record(step, m, request_id=step))
        out.append((json.dumps(bundles), path.read_text(),
                    rec.offending({"step": 0, "x": float("inf")})))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="last_k"):
        mon.FlightRecorder(last_k=0)


@pytest.mark.parametrize("poison", [None, "nan", "inf", "neg_inf_pair"])
def test_group_nonfinite_matches_jax(poison):
    rng = np.random.default_rng(1)
    tree = {"params": {
        "embedding": {"wte": rng.standard_normal((6, 4)).astype(np.float32)},
        "transformer": {"h0": {"w": rng.standard_normal((4, 4)).astype(
            np.float32), "b": np.zeros((4,), np.float32)},
            "steps": np.arange(3, dtype=np.int32)},
        "head": [rng.standard_normal((3,)).astype(np.float32)],
    }}
    t = tree["params"]["transformer"]["h0"]["w"]
    if poison == "nan":
        t[1, 2] = np.nan
    elif poison == "inf":
        tree["params"]["head"][0][1] = np.inf
    elif poison == "neg_inf_pair":
        t[0, 0], t[0, 1] = np.inf, -np.inf

    def conv(x, f):
        if isinstance(x, dict):
            return {k: conv(v, f) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v, f) for v in x]
        return f(x)

    port = mon.group_nonfinite(conv(tree, torch.from_numpy))
    ref = jmon.group_nonfinite(conv(tree, jnp.asarray))
    assert sorted(port) == sorted(ref)
    for k in port:
        assert isinstance(port[k], torch.Tensor) and port[k].dim() == 0
        assert float(port[k]) == float(ref[k]), k
    assert float(port["nonfinite/embedding"]) == 0.0


def test_flops_match_jax():
    cases = [dict(batch=8, seq=1024, hidden_size=1024, num_layers=24,
                  vocab_size=50304, n_params=302_000_000),
             dict(batch=2, seq=128, hidden_size=64, num_layers=2,
                  vocab_size=96, raw_param_count=150_000,
                  include_head=False)]
    for kw in cases:
        a = mon.transformer_train_flops(**kw)
        b = jmon.transformer_train_flops(**kw)
        assert abs(a - b) <= 1e-12 * abs(b)

    class Cfg:
        hidden_size, num_layers, vocab_size = 768, 12, 50257

    a = mon.model_flops(Cfg, 4, 512, raw_param_count=124_000_000)
    b = jmon.model_flops(Cfg, 4, 512, raw_param_count=124_000_000)
    assert abs(a - b) <= 1e-12 * abs(b)
    assert mon.resnet50_train_flops(256) == jmon.resnet50_train_flops(256)
    for args in ((1e15, 2.0), (1e15, 0.0), (3e14, 0.5)):
        assert mon.mfu(*args, n_chips=4, peak=1e12) == pytest.approx(
            jmon.mfu(*args, n_chips=4, peak=1e12), rel=1e-12, abs=0.0)
    with pytest.raises(ValueError, match="exactly one"):
        mon.transformer_train_flops(batch=1, seq=1, hidden_size=1,
                                    num_layers=1, vocab_size=1)
    assert mon.peak_flops_per_chip("cpu") == jmon.peak_flops_per_chip(
        "cpu") == 1e12
    assert mon.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    if not torch.cuda.is_available():
        assert mon.peak_flops_per_chip() == 1e12


# ---------------------------------------------------------------------------
# slo
# ---------------------------------------------------------------------------


def test_slo_burn_rates_and_alerts_match_jax():
    out = []
    for pkg, tpkg in ((mon, tel), (jmon, jtel)):
        reg = tpkg.MetricRegistry()
        good = reg.counter("good_total", "Good.")
        total = reg.counter("all_total", "All.")
        lat = reg.histogram("ttft_ms", "TTFT.", labelnames=("tenant",))
        rules = [pkg.BurnRule(10.0, 2.0, 2.0), pkg.BurnRule(4.0, 1.0, 5.0)]
        tr = pkg.Tracer(annotate_device=False)
        tr._t0 = 0.0
        monitor = pkg.SLOMonitor(
            [pkg.SLO("avail", 0.99, good=good, total=total, windows=rules),
             pkg.SLO("ttft", 0.9, series=lat, threshold=200.0,
                     windows=rules, labels={"tenant": "a"})],
            registry=reg, tracer=tr, history=64)
        board = pkg.TenantSLOBoard(lat, objective=0.9, threshold_ms=200.0,
                                   windows=rules, history=64)
        board.ensure("a"), board.ensure("b")
        rng = np.random.default_rng(5)
        trace = []
        for t in range(30):
            bad = 0.3 if 10 <= t < 18 else 0.002
            for _ in range(50):
                total.inc()
                if rng.random() >= bad:
                    good.inc()
                lat.observe(float(rng.lognormal(4.0 + (t >= 12), 0.5)),
                            tenant="a" if rng.random() < 0.7 else "b")
            monitor.tick(now=float(t))
            board.tick(now=float(t))
            trace.append((monitor.alerts(now=float(t)),
                          board.alerts(now=float(t))))
        out.append((trace, monitor.events, monitor.status(now=29.0),
                    board.status(now=29.0), reg.exposition(),
                    [(e["name"], e.get("args")) for e in tr.events()
                     if e["ph"] == "i"]))
    port, ref = out

    def norm(x):
        return json.loads(json.dumps(x, default=repr))

    assert _close(norm(port), norm(ref))
    assert port[1], "no alert fired"


def test_slo_validation():
    reg = tel.MetricRegistry()
    c = reg.counter("c_total", "C.")
    h = reg.histogram("h", "H.")
    for kw, match in ((dict(good=c, total=c, objective=1.0), "objective"),
                      (dict(objective=0.9), "exactly one"),
                      (dict(objective=0.9, series=h), "threshold"),
                      (dict(objective=0.9, good=c), "total"),
                      (dict(objective=0.9, good=c, total=c,
                            labels={"a": "b"}), "labels"),
                      (dict(objective=0.9, good=c, total=c, windows=()),
                       "BurnRule")):
        with pytest.raises(ValueError, match=match):
            mon.SLO("x", **kw)
    with pytest.raises(ValueError):
        mon.BurnRule(1.0, 2.0, 1.0)
    with pytest.raises(ValueError, match="history"):
        mon.SLOMonitor(history=1)


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------


class _FakeEngine:
    _watchdog_fires = 0
    draining = False
    tick_count = 3
    num_queued = 2
    num_active = 1


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_exporter_routes_match_jax():
    out = []
    for pkg, tpkg in ((mon, tel), (jmon, jtel)):
        reg = tpkg.MetricRegistry()
        _feed(reg, seed=9)
        eng = _FakeEngine()
        store = pkg.TimeSeriesStore(reg, interval=1.0)
        store.sample(now=0.0)
        _feed(reg, seed=10, n=10)
        store.sample(now=2.0)
        eng.timeseries = store
        server = pkg.start_exporter(reg, engine=eng)
        try:
            got = {path: _get(server.url + path) for path in
                   ("/metrics", "/healthz", "/timeseries", "/nope")}
            varz = json.loads(_get(server.url + "/varz")[2])
            eng._watchdog_fires = 1
            got["/healthz-bad"] = _get(server.url + "/healthz")
        finally:
            server.close()
            server.close()
        assert server.port == 0
        out.append((got, {k: v for k, v in varz.items()
                          if k != "device_memory"}))
    assert out[0] == out[1]
    assert out[0][0]["/healthz-bad"][0] == 503
    assert out[0][0]["/nope"][0] == 404
    bare = mon.TelemetryServer(tel.MetricRegistry()).start()
    try:
        assert _get(bare.url + "/timeseries")[0] == 404
        varz = json.loads(_get(bare.url + "/varz")[2])
        assert varz["health"] == {"healthy": True}
        assert varz["device_memory"] == [
            mon.device_memory_stats(torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]
    finally:
        bare.close()
    with pytest.raises(ValueError, match="registry"):
        mon.start_exporter()
