"""Declarative SLOs and Google-SRE multi-window burn-rate alerting.

Port of ``rocm_apex_tpu/monitor/slo.py`` (host-only Python, the port's
own copy). An `SLO` names a good/bad ratio over registry counters or a
latency threshold over a registry histogram; an `SLOMonitor` samples
those series into a bounded ring and computes error-budget burn rates
over paired (long, short) windows, the multiwindow, multi-burn-rate
alert of the SRE workbook (ch. 5):

* **burn rate** over a window = (bad / total events in the window) /
  (1 - objective): 1.0 spends the budget exactly over the SLO period;
* **two windows per rule**: the long window decides the alert is real,
  the short one that it is still happening; both must reach the rule's
  factor to fire;
* a window longer than the data collected so far is computed against
  the oldest sample inside it (graceful degradation while windows fill).

`SLOMonitor.tick()` is a handful of counter reads; `alerts()` returns
the firing set, appends rising edges to ``events`` and, when wired,
counts them in ``slo_alerts_total`` and marks a tracer instant.
`TenantSLOBoard` keeps one monitor per tenant over the engine's
``serve_ttft_ms{tenant=}`` family.
"""

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from rocm_apex_tpu_torch.monitor.telemetry import Histogram, MetricRegistry

__all__ = [
    "BurnRule",
    "SLO",
    "SLOMonitor",
    "TenantSLOBoard",
    "DEFAULT_BURN_RULES",
]


class BurnRule:
    """One (long window, short window, burn factor) alert rule.
    Windows are in the monitor's clock units (seconds when ticked with
    real time). Fires when BOTH windows burn at >= ``factor``."""

    __slots__ = ("long_s", "short_s", "factor")

    def __init__(self, long_s: float, short_s: float, factor: float):
        if not (0 < short_s <= long_s):
            raise ValueError(
                f"need 0 < short_s <= long_s, got {short_s}/{long_s}"
            )
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.factor = float(factor)

    def __repr__(self):
        return (
            f"BurnRule(long_s={self.long_s}, short_s={self.short_s}, "
            f"factor={self.factor})"
        )


# The SRE-workbook page/ticket ladder (hours-scale; bench and tests
# pass second-scale rules — the math is unit-agnostic).
DEFAULT_BURN_RULES: Tuple[BurnRule, ...] = (
    BurnRule(3600.0, 300.0, 14.4),
    BurnRule(21600.0, 1800.0, 6.0),
)


class SLO:
    """One objective over registry series.

    Two flavors:

    * **ratio**: ``SLO(name, objective, good=counter, total=counter)``
      — good/total event counters (e.g. non-error completions over all
      completions).
    * **latency**: ``SLO(name, objective, series=histogram,
      threshold=ms)`` — good events are observations ``<= threshold``
      (rounded UP to the histogram's nearest bucket bound; the
      effective threshold is what `good_below` documents), total is
      the observation count. This is the serving TTFT SLO.

    ``objective`` is the target good fraction in (0, 1); the error
    budget is ``1 - objective``. ``windows`` is a sequence of
    `BurnRule`.

    ``labels`` narrows a LATENCY SLO to one label series of its
    histogram (e.g. ``labels={"tenant": "acme"}`` over the engine's
    ``serve_ttft_ms{tenant=}`` family) — the per-tenant SLO feed
    `TenantSLOBoard` builds on. Without labels the reads aggregate
    across every series, exactly as before.
    """

    def __init__(
        self,
        name: str,
        objective: float,
        *,
        good: Any = None,
        total: Any = None,
        series: Optional[Histogram] = None,
        threshold: Optional[float] = None,
        windows: Sequence[BurnRule] = DEFAULT_BURN_RULES,
        labels: Optional[Dict[str, str]] = None,
    ):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}"
            )
        latency = series is not None
        ratio = good is not None
        if latency == ratio:
            raise ValueError(
                "pass exactly one of (series=histogram, threshold=...)"
                " or (good=counter, total=counter)"
            )
        if latency and threshold is None:
            raise ValueError("latency SLO needs threshold=")
        if ratio and total is None:
            raise ValueError("ratio SLO needs total=")
        if labels and not latency:
            raise ValueError(
                "labels= narrows a latency SLO's histogram series; "
                "ratio counters read unlabeled totals"
            )
        self.name = name
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.good = good
        self.total = total
        self.series = series
        self.threshold = (
            float(threshold) if threshold is not None else None
        )
        self.windows = tuple(windows)
        if not self.windows:
            raise ValueError("need at least one BurnRule")
        self.labels: Dict[str, str] = dict(labels) if labels else {}

    def read(self) -> Tuple[float, float]:
        """Current cumulative (good, total) event counts."""
        if self.series is not None:
            total = self.series.count(**self.labels)
            good = self.series.good_below(
                self.threshold, **self.labels
            )
            return float(good), float(total)
        return float(self.good.total()), float(self.total.total())


class SLOMonitor:
    """Samples every registered `SLO`'s (good, total) counters into a
    per-SLO snapshot ring and evaluates the burn rules against it.

    ``tick(now=None)`` appends one ``(now, good, total)`` sample
    (``time.monotonic`` when ``now`` is omitted; tests and benches
    pass a synthetic clock). The ring keeps ``history`` samples —
    size it to cover the longest window at your tick cadence.

    ``alerts(now=None)`` evaluates the rules on the samples collected
    so far and returns the firing list; each rising edge is appended
    to ``events`` (the permanent record), counted in
    ``slo_alerts_total{slo=...}`` when a registry is attached, and
    marked as a tracer instant when a tracer is attached.
    """

    def __init__(
        self,
        slos: Sequence[SLO] = (),
        *,
        registry: Optional[MetricRegistry] = None,
        tracer=None,
        history: int = 4096,
    ):
        if history < 2:
            raise ValueError(f"history must be >= 2, got {history}")
        self.slos: List[SLO] = list(slos)
        self.tracer = tracer
        self._alert_counter = (
            registry.counter(
                "slo_alerts_total",
                "Burn-rate alert rising edges, by SLO name.",
                labelnames=("slo",),
            )
            if registry is not None else None
        )
        self._history = int(history)
        self._samples: Dict[str, collections.deque] = {}
        self._firing: Dict[str, bool] = {}
        self.events: List[Dict[str, Any]] = []
        for slo in self.slos:
            self._register(slo)

    def _register(self, slo: SLO) -> None:
        self._samples[slo.name] = collections.deque(
            maxlen=self._history
        )
        self._firing[slo.name] = False

    def add(self, slo: SLO) -> SLO:
        self.slos.append(slo)
        self._register(slo)
        return slo

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return float(now)
        import time

        return time.monotonic()

    def tick(self, now: Optional[float] = None) -> None:
        """Sample every SLO's cumulative counters once."""
        t = self._now(now)
        for slo in self.slos:
            good, total = slo.read()
            self._samples[slo.name].append((t, good, total))

    # -- window math ----------------------------------------------------

    def _window_rate(
        self, samples, t_now: float, window: float
    ) -> Optional[float]:
        """Bad-event fraction over ``[t_now - window, t_now]``:
        difference the newest sample against the OLDEST sample inside
        the window (or the last one at/before its edge, so a window
        straddling sparse ticks still spans >= the window). None when
        no events or no second sample yet."""
        if len(samples) < 2:
            return None
        t_lo = t_now - window
        base = None
        for s in samples:  # oldest -> newest
            if s[0] <= t_lo:
                base = s  # last sample at/before the window edge
            else:
                if base is None:
                    base = s  # ring starts inside the window
                break
        if base is None:
            base = samples[0]
        _, good0, total0 = base
        _, good1, total1 = samples[-1]
        d_total = total1 - total0
        if d_total <= 0:
            return None
        d_bad = (total1 - good1) - (total0 - good0)
        return max(0.0, min(1.0, d_bad / d_total))

    def burn_rates(
        self, slo: SLO, now: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        """Per-rule burn rates for one SLO: ``bad_rate / budget`` over
        each rule's long and short windows (None where a window has no
        data yet)."""
        samples = self._samples[slo.name]
        if now is not None:
            t = float(now)
        elif samples:
            t = samples[-1][0]  # evaluate at the newest sample
        else:
            t = self._now(None)
        out = []
        for rule in slo.windows:
            rates = {}
            for tag, w in (("long", rule.long_s),
                           ("short", rule.short_s)):
                r = self._window_rate(samples, t, w)
                rates[tag] = (
                    None if r is None else r / slo.budget
                )
            out.append({
                "rule": rule,
                "burn_long": rates["long"],
                "burn_short": rates["short"],
                "firing": (
                    rates["long"] is not None
                    and rates["short"] is not None
                    and rates["long"] >= rule.factor
                    and rates["short"] >= rule.factor
                ),
            })
        return out

    def alerts(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Currently-firing alerts (one entry per SLO with at least
        one firing rule). Rising edges land in ``events`` + the
        ``slo_alerts_total`` counter + a tracer instant."""
        t = self._now(now)
        firing_now: List[Dict[str, Any]] = []
        for slo in self.slos:
            rates = self.burn_rates(slo, now=t)
            hot = [r for r in rates if r["firing"]]
            if hot:
                worst = max(
                    hot, key=lambda r: r["burn_long"] or 0.0
                )
                entry = {
                    "slo": slo.name,
                    "objective": slo.objective,
                    "burn_long": worst["burn_long"],
                    "burn_short": worst["burn_short"],
                    "factor": worst["rule"].factor,
                    "window_s": worst["rule"].long_s,
                    "at": t,
                }
                firing_now.append(entry)
                if not self._firing[slo.name]:
                    self._firing[slo.name] = True
                    self.events.append(dict(entry))
                    if self._alert_counter is not None:
                        self._alert_counter.inc(slo=slo.name)
                    if (
                        self.tracer is not None
                        and getattr(self.tracer, "enabled", False)
                    ):
                        self.tracer.instant(
                            f"slo_alert:{slo.name}",
                            burn=round(worst["burn_long"], 3),
                            factor=worst["rule"].factor,
                        )
            else:
                self._firing[slo.name] = False
        return firing_now

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """JSON-ready dump for ``/varz``: per-SLO burn rates, firing
        flags, and the rising-edge history."""
        t = self._now(now)
        per_slo = {}
        for slo in self.slos:
            good, total = slo.read()
            per_slo[slo.name] = {
                "objective": slo.objective,
                "good": good,
                "total": total,
                "rules": [
                    {
                        "long_s": r["rule"].long_s,
                        "short_s": r["rule"].short_s,
                        "factor": r["rule"].factor,
                        "burn_long": r["burn_long"],
                        "burn_short": r["burn_short"],
                        "firing": r["firing"],
                    }
                    for r in self.burn_rates(slo, now=t)
                ],
            }
        return {"slos": per_slo, "events": list(self.events)}


class TenantSLOBoard:
    """One `SLOMonitor` per tenant over a labeled latency family —
    the per-tenant burn-rate plane of multi-LoRA serving.

    Each tenant gets its OWN monitor holding one latency `SLO`
    narrowed to that tenant's label series (``labels={"tenant": t}``
    on the engine's ``serve_ttft_ms{tenant=}`` family), so one
    tenant's burst burns ONLY that tenant's budget: the isolation the
    chaos scenario asserts is structural, not statistical — the other
    monitors literally never read the bursting tenant's series.

    Tenants appear lazily (`ensure`) or in bulk from the engine's
    host accounting (`sync(engine)` walks `tenant_stats()` — tenants
    past the metric cardinality cap share the ``other`` overflow
    label and therefore one shared board entry, matching exactly what
    the metric plane can actually distinguish). `tick`/`alerts` fan
    out to every monitor; `alerts` returns entries tagged with their
    tenant. The board feeds ADMISSION as well as paging: the engine's
    tier scheduler is the actuator — a burning tenant's tier can be
    dropped by the operator loop reading `status()`.
    """

    def __init__(
        self,
        series: Histogram,
        *,
        objective: float = 0.99,
        threshold_ms: float = 500.0,
        windows: Sequence[BurnRule] = DEFAULT_BURN_RULES,
        registry: Optional[MetricRegistry] = None,
        tracer=None,
        history: int = 4096,
    ):
        self.series = series
        self.objective = float(objective)
        self.threshold_ms = float(threshold_ms)
        self.windows = tuple(windows)
        self._registry = registry
        self._tracer = tracer
        self._history = int(history)
        self.monitors: Dict[str, SLOMonitor] = {}

    def ensure(self, tenant: str) -> SLOMonitor:
        """The tenant's monitor, created on first sight."""
        mon = self.monitors.get(tenant)
        if mon is None:
            mon = SLOMonitor(
                [SLO(
                    f"ttft/{tenant}", self.objective,
                    series=self.series,
                    threshold=self.threshold_ms,
                    windows=self.windows,
                    labels={"tenant": tenant},
                )],
                registry=self._registry,
                tracer=self._tracer,
                history=self._history,
            )
            self.monitors[tenant] = mon
        return mon

    def sync(self, engine) -> None:
        """Create monitors for every tenant the engine has finished a
        request for (host accounting keys, mapped through the metric
        plane's overflow: tenants beyond the cardinality cap share
        the ``other`` board entry — per-label series is all a labeled
        read can distinguish)."""
        for tenant in engine.tenant_stats():
            label = engine._tenant_series(tenant)
            self.ensure(label)

    def tick(self, now: Optional[float] = None) -> None:
        for mon in self.monitors.values():
            mon.tick(now=now)

    def alerts(
        self, now: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        """Firing alerts across every tenant, each entry carrying its
        ``tenant`` key; rising edges accumulate in each monitor's
        ``events`` as usual."""
        out: List[Dict[str, Any]] = []
        for tenant, mon in self.monitors.items():
            for entry in mon.alerts(now=now):
                entry = dict(entry, tenant=tenant)
                out.append(entry)
        return out

    def status(
        self, now: Optional[float] = None
    ) -> Dict[str, Any]:
        return {
            tenant: mon.status(now=now)
            for tenant, mon in self.monitors.items()
        }
