"""Dependency-free HTTP exporter: /metrics, /healthz, /varz, /timeseries.

Port of ``rocm_apex_tpu/monitor/exporter.py``, on the stdlib
`http.server` only:

* ``GET /metrics``: Prometheus text exposition (version 0.0.4) of the
  attached registry (`MetricRegistry.exposition`).
* ``GET /healthz``: JSON liveness; with a ``health_fn`` (e.g.
  `engine_health(engine)`), an unhealthy report answers 503.
* ``GET /varz``: one JSON dump: the registry snapshot,
  `device_memory_stats` for every visible CUDA device, the SLO and
  per-tenant status when attached, the `TimeSeriesStore.head` summary,
  and whatever ``varz_fn`` adds.
* ``GET /timeseries``: the sensor ring (`TimeSeriesStore.series_json`)
  when a ``timeseries=`` store is attached; 404 otherwise.

Every route reads host state only: a scrape between two engine ticks
reads no device value and adds no sync.

**Security note:** the server binds ``127.0.0.1`` by default and serves
read-only GETs with no auth (telemetry leaks model shapes, traffic rates
and tenant labels); bind a routable address only behind your own auth or
scrape proxy. ``port=0`` takes an ephemeral port; read it back from
``server.port``. The server runs on a daemon thread
(`ThreadingHTTPServer`); `close()` is idempotent.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Union

import torch

from rocm_apex_tpu_torch.monitor.telemetry import MetricRegistry

__all__ = [
    "TelemetryServer",
    "engine_health",
    "fleet_health",
    "start_exporter",
    "PROMETHEUS_CONTENT_TYPE",
]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def engine_health(engine) -> Callable[[], Dict[str, Any]]:
    """Liveness report for an `inference.InferenceEngine`, fed by the
    request-lifecycle state: healthy means the stall watchdog
    has not fired and the engine is not wedged mid-drain. Draining
    itself is REPORTED but still healthy — a draining replica is alive
    and must keep answering probes until the last request leaves."""

    def _health() -> Dict[str, Any]:
        fires = int(getattr(engine, "_watchdog_fires", 0))
        return {
            "healthy": fires == 0,
            "draining": bool(getattr(engine, "draining", False)),
            "watchdog_fires": fires,
            "ticks": int(getattr(engine, "tick_count", 0)),
            "queue_depth": int(getattr(engine, "num_queued", 0)),
            "slots_active": int(getattr(engine, "num_active", 0)),
        }

    return _health


def fleet_health(router) -> Callable[[], Dict[str, Any]]:
    """Liveness report for an `inference.ReplicaRouter`: healthy —
    and therefore 200 on `/healthz` — while ANY replica remains in
    rotation. One quarantined replica is the fabric doing its job;
    zero healthy replicas is the outage a load balancer must see as
    503. Per-replica detail is deliberately kept OUT of the probe
    body (probes should stay tiny and fast) — it lives in `/varz`
    via ``router.varz``."""
    return router.health


class _Handler(BaseHTTPRequestHandler):
    # the server object carries the telemetry context (set by
    # TelemetryServer below); one handler class serves all routes
    server_version = "rocm-apex-telemetry/1.0"

    def log_message(self, fmt, *args):  # silence per-request stderr
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - http.server API
        ctx: "TelemetryServer" = self.server._telemetry  # type: ignore
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = ctx.registry.exposition().encode()
                self._send(200, body, PROMETHEUS_CONTENT_TYPE)
            elif path == "/healthz":
                report = ctx.health()
                code = 200 if report.get("healthy", True) else 503
                self._send(
                    code, json.dumps(report).encode(),
                    "application/json",
                )
            elif path == "/varz":
                self._send(
                    200, json.dumps(ctx.varz()).encode(),
                    "application/json",
                )
            elif path == "/timeseries":
                if ctx.timeseries is None:
                    self._send(
                        404, b"no timeseries store attached\n",
                        "text/plain",
                    )
                else:
                    self._send(
                        200,
                        json.dumps(
                            ctx.timeseries.series_json()
                        ).encode(),
                        "application/json",
                    )
            else:
                self._send(404, b"not found\n", "text/plain")
        except Exception as exc:  # noqa: BLE001 - scrape must not kill
            self._send(
                500, f"telemetry error: {exc}\n".encode(),
                "text/plain",
            )


class TelemetryServer:
    """Background scrape endpoint over one registry.

    ``registry`` is either a `MetricRegistry` or a ZERO-ARG PROVIDER
    returning one, resolved fresh on every scrape — the multi-replica
    hook: pass ``router.merged_registry`` (the method) and each
    `/metrics` hit serves a registry merged from the live fleet at
    that instant, so the scraped percentiles always reproduce the
    combined per-replica streams.

    ``port=0`` (default) binds an ephemeral port — read ``.port``
    after `start`. ``host`` defaults to loopback (see the module
    security note before changing it). Use as a context manager or
    call `close()`; both are idempotent."""

    def __init__(
        self,
        registry: Union[
            MetricRegistry, Callable[[], MetricRegistry]
        ],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        varz_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        slo_monitor=None,
        tenant_board=None,
        timeseries=None,
    ):
        self._registry_source = registry
        self.health_fn = health_fn
        self.varz_fn = varz_fn
        self.slo_monitor = slo_monitor
        self.tenant_board = tenant_board
        self.timeseries = timeseries
        self._host = host
        self._want_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- route bodies (handler calls back in) ---------------------------

    @property
    def registry(self) -> MetricRegistry:
        """The registry this scrape serves — resolved per access when
        constructed with a provider, so `/metrics` and `/varz` always
        see the freshest merge."""
        src = self._registry_source
        return src() if callable(src) else src

    def health(self) -> Dict[str, Any]:
        if self.health_fn is None:
            return {"healthy": True}
        return dict(self.health_fn())

    def varz(self) -> Dict[str, Any]:
        from rocm_apex_tpu_torch.monitor.logger import device_memory_stats

        out: Dict[str, Any] = {
            "metrics": self.registry.snapshot(),
            "health": self.health(),
        }
        # every visible CUDA device's allocator watermarks (host
        # bookkeeping: a scrape between two ticks reads no device value)
        out["device_memory"] = [
            device_memory_stats(torch.device("cuda", i))
            for i in range(torch.cuda.device_count())
        ] if torch.cuda.is_available() else []
        if self.slo_monitor is not None:
            out["slo"] = self.slo_monitor.status()
        if self.tenant_board is not None:
            out["tenants"] = self.tenant_board.status()
        if self.timeseries is not None:
            out["timeseries"] = self.timeseries.head()
        if self.varz_fn is not None:
            out.update(self.varz_fn())
        return out

    # -- lifecycle ------------------------------------------------------

    @property
    def port(self) -> int:
        """The bound port (the ephemeral answer when constructed with
        ``port=0``); 0 before `start`."""
        if self._httpd is None:
            return 0
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer(
            (self._host, self._want_port), _Handler
        )
        httpd.daemon_threads = True
        httpd._telemetry = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name="telemetry-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def start_exporter(
    registry=None, *, port: int = 0, engine=None, router=None, **kw
) -> TelemetryServer:
    """One-call convenience: start a `TelemetryServer`, wiring
    `engine_health` automatically when an engine is passed, or the
    whole fleet surface when a `ReplicaRouter` is passed — merged
    per-scrape registry (``router.merged_registry`` as the zero-arg
    provider), `fleet_health` on `/healthz` (503 only with no healthy
    replica), and per-replica detail on `/varz` (``router.varz``).
    A `TimeSeriesStore` hung off the engine/router (its
    ``timeseries=`` constructor arg) is picked up automatically for
    `/timeseries` and the `/varz` head sample; pass ``timeseries=`` /
    ``tenant_board=`` explicitly to override. Returns the started
    server (read ``.port`` / ``.url``)."""
    if router is not None:
        if registry is None:
            registry = router.merged_registry
        kw.setdefault("health_fn", fleet_health(router))
        kw.setdefault("varz_fn", router.varz)
    elif engine is not None and "health_fn" not in kw:
        kw["health_fn"] = engine_health(engine)
    for owner in (router, engine):
        if owner is None:
            continue
        ts = getattr(owner, "timeseries", None)
        if ts is not None:
            kw.setdefault("timeseries", ts)
            break
    if registry is None:
        raise ValueError("pass a registry/provider, or router=...")
    return TelemetryServer(registry, port=port, **kw).start()
