"""Time-series sensor plane: windowed rates and quantiles over the
cumulative `MetricRegistry`.

Port of ``rocm_apex_tpu/monitor/timeseries.py`` (host-only Python, the
port's own copy). The registry is cumulative (counters only climb,
histograms only accumulate); `TimeSeriesStore` keeps a fixed-memory ring
of periodic ``registry.snapshot()`` samples and answers windowed queries
by differencing the two samples at the window's edges:

* `delta(name, window=)`: counter increase (histograms: count increase);
* `rate(name, window=)`: that delta per second;
* `quantile_over(name, q, window=)`: the q-quantile of only the
  observations inside the window (cumulative buckets differenced at the
  edges, interpolated as `telemetry.Histogram.quantile` does);
* `gauge_over(name, window=)`: min/mean/max of a gauge's samples.

Hang it off an engine or a router as ``timeseries=``: its `tick()` runs
once per step and samples only when ``interval`` has elapsed (one clock
read otherwise). The exporter serves the ring at ``/timeseries`` and
`head()` on ``/varz``. Clocks are injectable (``clock=``, `tick(now=)`).
Memory is bounded: ``capacity`` samples, the oldest dropped on wrap and
counted in `dropped`.
"""

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TimeSeriesStore"]


def _match(labels: Dict[str, str], want: Optional[Dict[str, str]]) -> bool:
    """Subset match: ``want=None`` aggregates every series; otherwise a
    series matches when it carries all the wanted label pairs."""
    if not want:
        return True
    return all(labels.get(k) == str(v) for k, v in want.items())


def _scalar_total(entry: Dict[str, Any],
                  labels: Optional[Dict[str, str]]) -> float:
    """Sum of matching series values (counter/gauge) or counts
    (histogram) in one snapshot entry."""
    total = 0.0
    for s in entry.get("series", ()):
        if not _match(s.get("labels", {}), labels):
            continue
        total += s["count"] if "buckets" in s else s["value"]
    return total


def _bucket_totals(entry: Dict[str, Any],
                   labels: Optional[Dict[str, str]]) -> List[float]:
    """Element-wise sum of matching histogram series' bucket counts
    (len(bounds)+1, overflow last)."""
    agg: List[float] = []
    for s in entry.get("series", ()):
        if "buckets" not in s or not _match(s.get("labels", {}), labels):
            continue
        if not agg:
            agg = [0.0] * len(s["buckets"])
        for i, c in enumerate(s["buckets"]):
            agg[i] += c
    return agg


def _quantile_from_buckets(counts: List[float], bounds: List[float],
                           q: float) -> float:
    """`telemetry.Histogram.quantile`'s interpolation, applied to a
    differenced (windowed) bucket vector instead of a live series."""
    n = sum(counts)
    if n <= 0:
        return 0.0
    target = q * n
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            if i >= len(bounds):
                return bounds[-1]  # overflow: clamp
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (target - cum) / c if c else 0.0
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return bounds[-1]


class TimeSeriesStore:
    """Fixed-memory ring of periodic registry snapshots with windowed
    rate/delta/quantile queries. See the module docstring for the
    design; the query convention throughout: ``window=None`` spans the
    whole retained ring, and every query needs at least two samples
    (one interval of history) before it reports anything but 0/None —
    mirroring slo.py's graceful degradation while burn windows fill.
    """

    def __init__(self, registry, *, interval: float = 1.0,
                 capacity: int = 600, clock=None):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.registry = registry
        self.interval = float(interval)
        self.capacity = int(capacity)
        self.clock = clock if clock is not None else time.perf_counter
        self.enabled = bool(registry is not None
                            and getattr(registry, "enabled", True))
        self._samples: "deque[Tuple[float, Dict[str, Any]]]" = deque(
            maxlen=self.capacity)
        self.dropped = 0
        self._last_t: Optional[float] = None

    # -- sampling ------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> bool:
        """Cheap per-step entry point: snapshot iff ``interval`` has
        elapsed since the last sample. Returns whether it sampled."""
        if not self.enabled:
            return False
        if now is None:
            now = self.clock()
        if self._last_t is not None and now - self._last_t < self.interval:
            return False
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> None:
        """Unconditional snapshot (benches force window edges with
        it)."""
        if not self.enabled:
            return
        if now is None:
            now = self.clock()
        if len(self._samples) == self._samples.maxlen:
            self.dropped += 1
        self._samples.append((now, self.registry.snapshot()))
        self._last_t = now

    def __len__(self) -> int:
        return len(self._samples)

    # -- window selection ----------------------------------------------

    def _edges(self, window: Optional[float]):
        """(old, new) samples bracketing the window: new is the latest
        sample, old the EARLIEST sample still inside ``window`` of it
        (slo.py's convention — a part-full window reports over what it
        has rather than nothing). None until two samples exist."""
        if len(self._samples) < 2:
            return None
        new_t, new_snap = self._samples[-1]
        old = None
        for t, snap in self._samples:
            if window is None or new_t - t <= window:
                old = (t, snap)
                break
        if old is None or old[0] >= new_t:
            old = self._samples[-2]
        return old, (new_t, new_snap)

    # -- queries -------------------------------------------------------

    def delta(self, name: str, *, window: Optional[float] = None,
              labels: Optional[Dict[str, str]] = None) -> float:
        """Counter increase (histogram: count increase) over the
        window, aggregated across matching label series."""
        edges = self._edges(window)
        if edges is None:
            return 0.0
        (_, old_snap), (_, new_snap) = edges
        new_e = new_snap.get(name)
        if new_e is None:
            return 0.0
        new_v = _scalar_total(new_e, labels)
        old_e = old_snap.get(name)
        old_v = _scalar_total(old_e, labels) if old_e else 0.0
        # A registry reset mid-window reads as a negative delta; clamp
        # like every rate() implementation does on counter resets.
        return max(new_v - old_v, 0.0)

    def rate(self, name: str, *, window: Optional[float] = None,
             labels: Optional[Dict[str, str]] = None) -> float:
        """`delta` per second over the actual span between the window's
        edge samples."""
        edges = self._edges(window)
        if edges is None:
            return 0.0
        (old_t, _), (new_t, _) = edges
        dt = new_t - old_t
        if dt <= 0:
            return 0.0
        return self.delta(name, window=window, labels=labels) / dt

    def quantile_over(self, name: str, q: float, *,
                      window: Optional[float] = None,
                      labels: Optional[Dict[str, str]] = None) -> float:
        """q-quantile of the observations that landed INSIDE the
        window (cumulative buckets differenced at the edges). 0.0
        while empty; requires a histogram family."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        edges = self._edges(window)
        if edges is None:
            return 0.0
        (_, old_snap), (_, new_snap) = edges
        new_e = new_snap.get(name)
        if new_e is None or "bounds" not in new_e:
            return 0.0
        new_b = _bucket_totals(new_e, labels)
        if not new_b:
            return 0.0
        old_e = old_snap.get(name)
        old_b = _bucket_totals(old_e, labels) if old_e else []
        if old_b and len(old_b) == len(new_b):
            diff = [max(n - o, 0.0) for n, o in zip(new_b, old_b)]
        else:
            diff = new_b
        return _quantile_from_buckets(diff, new_e["bounds"], q)

    def gauge_over(self, name: str, *, window: Optional[float] = None,
                   labels: Optional[Dict[str, str]] = None
                   ) -> Dict[str, float]:
        """min/mean/max of a gauge's sampled values across the window
        (all samples inside it, not just the edges)."""
        if not self._samples:
            return {"min": 0.0, "mean": 0.0, "max": 0.0, "samples": 0}
        new_t = self._samples[-1][0]
        vals: List[float] = []
        for t, snap in self._samples:
            if window is not None and new_t - t > window:
                continue
            entry = snap.get(name)
            if entry is not None:
                vals.append(_scalar_total(entry, labels))
        if not vals:
            return {"min": 0.0, "mean": 0.0, "max": 0.0, "samples": 0}
        return {
            "min": min(vals),
            "mean": sum(vals) / len(vals),
            "max": max(vals),
            "samples": len(vals),
        }

    # -- export --------------------------------------------------------

    def head(self) -> Dict[str, Any]:
        """Compact latest-state summary for ``/varz``: ring occupancy
        plus the last-interval rate of every counter family and the
        last sampled value of every gauge."""
        out: Dict[str, Any] = {
            "samples": len(self._samples),
            "capacity": self.capacity,
            "interval_s": self.interval,
            "dropped": self.dropped,
        }
        if not self._samples:
            return out
        new_t, new_snap = self._samples[-1]
        span = new_t - self._samples[0][0] if len(self._samples) > 1 else 0.0
        out["t"] = new_t
        out["span_s"] = span
        rates: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        for name, entry in new_snap.items():
            kind = entry.get("type")
            if kind == "counter" or "bounds" in entry:
                # last-interval rate: edge pair = last two samples
                rates[name] = round(
                    self.rate(name, window=self.interval), 6)
            elif kind == "gauge":
                gauges[name] = _scalar_total(entry, None)
        out["rates_per_s"] = rates
        out["gauges"] = gauges
        return out

    def series_json(self) -> Dict[str, Any]:
        """The full ring for the exporter's ``/timeseries`` endpoint:
        timestamps plus, per family, the per-sample cumulative total
        AND the per-sample rate (consistency is checkable in-band —
        the rates integrate back to the cumulative deltas), with
        per-sample windowed p50/p95 for histograms."""
        ts = [t for t, _ in self._samples]
        out: Dict[str, Any] = {
            "interval_s": self.interval,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "t": ts,
            "series": {},
        }
        if not self._samples:
            return out
        names: List[str] = []
        for _, snap in self._samples:
            for n in snap:
                if n not in names:
                    names.append(n)
        samples = list(self._samples)
        for name in names:
            kinds = [s.get(name, {}).get("type") for _, s in samples
                     if name in s]
            kind = kinds[-1] if kinds else "untyped"
            totals: List[float] = []
            rates: List[float] = []
            p50: List[float] = []
            p95: List[float] = []
            prev_t: Optional[float] = None
            prev_v: Optional[float] = None
            prev_b: Optional[List[float]] = None
            is_hist = False
            for t, snap in samples:
                entry = snap.get(name)
                if entry is None:
                    totals.append(0.0)
                    rates.append(0.0)
                    continue
                v = _scalar_total(entry, None)
                totals.append(v)
                if prev_t is not None and t > prev_t:
                    rates.append(max(v - (prev_v or 0.0), 0.0)
                                 / (t - prev_t))
                else:
                    rates.append(0.0)
                if "bounds" in entry:
                    is_hist = True
                    b = _bucket_totals(entry, None)
                    if prev_b and len(prev_b) == len(b):
                        diff = [max(n2 - o, 0.0)
                                for n2, o in zip(b, prev_b)]
                    else:
                        diff = b
                    p50.append(_quantile_from_buckets(
                        diff, entry["bounds"], 0.50))
                    p95.append(_quantile_from_buckets(
                        diff, entry["bounds"], 0.95))
                    prev_b = b
                prev_t, prev_v = t, v
            ser: Dict[str, Any] = {"type": kind, "total": totals}
            if kind != "gauge":
                ser["rate_per_s"] = rates
            if is_hist:
                ser["p50"] = p50
                ser["p95"] = p95
            out["series"][name] = ser
        return out
